"""The port's UNet, its building blocks and the weight converter against the
JAX package, on the CPU in fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twin import (NORM_IMPLS, TINY, jax_kernels, make_twins,
                        random_params)
from tpu_diffusion.models import nn as jax_nn
from tpu_diffusion.models.unet import UNetModel as JaxUNet
from tpu_diffusion_torch.convert import unet_state_dict_from_flax
from tpu_diffusion_torch.models import nn as port_nn
from tpu_diffusion_torch.models.unet import (UNetModel, attention_ds,
                                             create_model)

# fp32 on both sides; convolutions and softmax sum in another order
ATOL = RTOL = 1e-4


def _inputs(seed=1, b=2, c=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 16, 16, c)).astype(np.float32)
    return x, np.array([0.1, 0.7][:b], np.float32)


def _port(model, x, t, **kw):
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(t), **kw)


@pytest.mark.parametrize("norm_impl", ["xla", "fused"])
def test_unet_full_matches_jax(monkeypatch, norm_impl):
    x, t = _inputs()
    with jax_kernels(norm_impl, monkeypatch):
        jm, params, port = make_twins(norm_impl)
        want = np.asarray(jax.jit(jm.apply)(params, x, t))
    got = _port(port, x, t).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(want).max() > 0.1  # the re-drawn output conv is live
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("norm_impl", ["xla", "fused"])
def test_unet_encode_decode_matches_jax(monkeypatch, norm_impl):
    x, t = _inputs(2)
    t_dec = t + 0.05  # decode at a nearby step, as the cached sampler does
    with jax_kernels(norm_impl, monkeypatch):
        jm, params, port = make_twins(norm_impl, seed=3)
        h, skips = jax.jit(lambda p, x, t: jm.apply(p, x, t, mode="encode")
                           )(params, x, t)
        want = np.asarray(jax.jit(lambda p, x, t, c: jm.apply(
            p, x, t, mode="decode", cache=c))(params, x, t_dec, (h, skips)))
    ph, pskips = _port(port, x, t, mode="encode")
    np.testing.assert_allclose(ph.numpy(), np.asarray(h), atol=ATOL,
                               rtol=RTOL)
    assert len(pskips) == len(skips)
    for a, b in zip(pskips, skips):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)
    got = _port(port, x, t_dec, mode="decode", cache=(ph, pskips)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_unet_additive_updown_matches_jax(monkeypatch):
    """Additive time conditioning, ResBlock up/down and two levels of
    attention, with the plain norms."""
    x, t = _inputs(4)
    with jax_kernels("xla", monkeypatch):
        jm, params, port = make_twins(
            "xla", seed=5, use_scale_shift_norm=False, resblock_updown=True,
            attention_resolutions=(1, 2), num_res_blocks=2)
        want = np.asarray(jax.jit(jm.apply)(params, x, t))
    np.testing.assert_allclose(_port(port, x, t).numpy(), want, atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("overrides", [
    dict(norm_impl="xla"), dict(norm_impl="fused"),
    dict(norm_impl="xla", use_scale_shift_norm=False, resblock_updown=True,
         num_res_blocks=2)])
def test_converter_maps_every_flax_param(overrides):
    kw = {**TINY, **overrides}
    norm_impl = kw.pop("norm_impl")
    jm = JaxUNet(attention_impl="xla", norm_impl=norm_impl,
                 dtype=jnp.float32, **kw)
    params = random_params(jm, 0)
    leaves = jax.tree.leaves(params)
    sd = unet_state_dict_from_flax(params)
    port = UNetModel(norm_impl=NORM_IMPLS[norm_impl], dtype=torch.float32,
                     device="cpu", **kw)
    want = port.state_dict()
    assert len(sd) == len(leaves) == len(want)
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
    # values land in the port's layout: a conv kernel HWIO -> OIHW, a Dense
    # [in, out] -> [out, in], the 1-D qkv kernel (1, C, 3C) -> [3C, C]
    p = params["params"]
    np.testing.assert_array_equal(
        sd["conv_in.weight"].numpy(),
        np.asarray(p["conv_in"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["time_dense_0.weight"].numpy(),
        np.asarray(p["time_dense_0"]["kernel"]).T)
    np.testing.assert_array_equal(
        sd["mid_attn.qkv.weight"].numpy(),
        np.asarray(p["mid_attn"]["qkv"]["kernel"])[0].T)
    port.load_state_dict(sd)  # strict: no key missing or left over


def test_attention_decision_log_records_fused(monkeypatch):
    x, t = _inputs()
    with jax_kernels("xla", monkeypatch):
        _, _, port = make_twins("xla")
    _port(port, x, t)
    blocks = [n for n, _ in port.named_children() if "attn" in n]
    assert sorted(port.attn_decisions) == sorted(blocks)
    assert {d["impl"] for d in port.attn_decisions.values()} == {"fused"}
    assert port.attn_decisions["mid_attn"] == {"impl": "fused", "tokens": 64,
                                               "heads": 2}
    port.attn_decisions.clear()
    _port(port, x, t, mode="decode", cache=_port(port, x, t, mode="encode"))
    assert "mid_attn" in port.attn_decisions


def test_timestep_embedding_matches_jax():
    t = np.array([0.0, 0.3, 17.0, 999.0], np.float32)
    for dim in (16, 17):
        want = np.asarray(jax_nn.timestep_embedding(jnp.asarray(t), dim))
        got = port_nn.timestep_embedding(torch.from_numpy(t), dim).numpy()
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("channels,dtype", [(48, None), (40, "bf16")])
def test_groupnorm32_matches_jax(channels, dtype):
    """Both modes of GroupNorm32, with a group count reduced until it
    divides the channels (40 -> 20 groups)."""
    rng = np.random.default_rng(channels)
    x = (rng.standard_normal((2, 4, 4, channels)) * 3 + 1).astype(np.float32)
    jdtype = jnp.bfloat16 if dtype else None
    jm = jax_nn.GroupNorm32(dtype=jdtype)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(
            p.shape).astype(np.float32),
        jm.init(jax.random.PRNGKey(0), x))
    want = np.asarray(jm.apply(params, x).astype(jnp.float32))
    gn = port_nn.GroupNorm32(channels,
                             dtype=torch.bfloat16 if dtype else None)
    inner = params["params"]["GroupNorm_0"]
    gn.load_state_dict({"weight": torch.from_numpy(inner["scale"]),
                        "bias": torch.from_numpy(inner["bias"])})
    with torch.no_grad():
        got = gn(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == (torch.bfloat16 if dtype else torch.float32)
    # bf16: the same fp32 value rounded once on each side
    tol = 1e-2 if dtype else 1e-5
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(), want,
                               atol=tol, rtol=tol)


def test_resampling_matches_jax():
    x = np.random.default_rng(0).standard_normal(
        (2, 6, 6, 4)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(
        port_nn.nearest_upsample(xt).permute(0, 2, 3, 1).numpy(),
        np.asarray(jax_nn.nearest_upsample(jnp.asarray(x))))
    np.testing.assert_allclose(
        port_nn.avg_pool_2x(xt).permute(0, 2, 3, 1).numpy(),
        np.asarray(jax_nn.avg_pool_2x(jnp.asarray(x))), atol=1e-6)


def test_attention_ds_parsing():
    assert attention_ds(32, "16") == (2,)
    assert attention_ds(64, "16,8") == (4, 8)
    assert attention_ds(32, "") == ()


def test_cuda_entry_point_raises_without_card(monkeypatch):
    """No silent CPU fallback: device="cuda" (the default) without a card
    raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model(32, 16, 1, channel_mult=(1, 2), attention_resolutions="16")


def test_rejects_unknown_impls():
    with pytest.raises(ValueError, match="norm_impl"):
        UNetModel(3, 16, 3, channel_mult=(1,), norm_impl="xla", device="cpu")
    with pytest.raises(ValueError, match="attention impl"):
        UNetModel(3, 16, 3, channel_mult=(1,), attention_resolutions=(1,),
                  attention_impl="pallas", device="cpu")
