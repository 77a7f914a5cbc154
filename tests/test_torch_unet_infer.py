"""The port's fused-inference engine against the JAX package's and against
the port's own UNet, on the CPU in fp32.

`kernel_min_tokens=0` sends every ResBlock through `fused_resblock` on both
sides (the Pallas kernel in interpret mode there, the plain version here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twin import make_twins, one_torch_thread  # noqa: F401
from tpu_diffusion.core.schedules import DDPM as JaxDDPM
from tpu_diffusion.models.unet_infer import make_fused_apply as jax_fused_apply
from tpu_diffusion.sampling import ancestral as ja
from tpu_diffusion_torch.core.schedules import DDPM
from tpu_diffusion_torch.models.unet import UNetModel
from tpu_diffusion_torch.models.unet_infer import (FusedUNetInference,
                                                   make_fused_apply)
from tpu_diffusion_torch.sampling import ancestral as pa

# tests/test_kernels.py's engine model (8 channels, two levels, two blocks)
SMALL = dict(model_channels=8, num_res_blocks=2, channel_mult=(1, 2),
             attention_resolutions=(2,), num_heads=2)


@pytest.fixture(scope="module")
def twins():
    jm, params, port = make_twins("xla", seed=31, attention_impl="xla",
                                  **SMALL)
    rng = np.random.default_rng(32)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = rng.uniform(size=(2,)).astype(np.float32)
    return jm, params, port.eval(), x, t


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_engine_matches_jax_engine_and_own_model(twins):
    jm, params, port, x, t = twins
    jfn = jax_fused_apply(jm, params, resblock="pallas", interpret=True,
                          kernel_min_tokens=0)
    fn = make_fused_apply(port, kernel_min_tokens=0)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    got = fn(xt, tt)
    _close(got, jfn(jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        _close(got, port(xt, tt).numpy())
    blocks = [n for n, m in port.named_children()
              if type(m).__name__ == "ResBlock"]
    assert sorted(fn.res_decisions) == sorted(blocks) and len(blocks) == 12
    assert {d["impl"] for d in fn.res_decisions.values()} == {"kernel"}
    assert fn.layout_copies == 0


def test_engine_cache_modes_match_jax(twins):
    jm, params, port, x, t = twins
    jfn = jax_fused_apply(jm, params, resblock="pallas", interpret=True,
                          kernel_min_tokens=0)
    fn = make_fused_apply(port, kernel_min_tokens=0)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    h, skips = fn(xt, tt, mode="encode")
    hw, skipsw = jfn(jnp.asarray(x), jnp.asarray(t), mode="encode")
    _close(h, hw)
    assert len(skips) == len(skipsw)
    for a, b in zip(skips, skipsw):
        _close(a, b)
    # decode at another timestep from the reused cache
    t2 = np.float32(0.5) * t
    dec = fn(xt, torch.from_numpy(t2), mode="decode", cache=(h, skips))
    _close(dec, jfn(jnp.asarray(x), jnp.asarray(t2), mode="decode",
                    cache=(hw, skipsw)))
    with torch.no_grad():
        _close(dec, port(xt, torch.from_numpy(t2), mode="decode",
                         cache=port(xt, tt, mode="encode")).numpy())


def test_engine_sends_only_large_blocks_to_the_kernel(twins):
    _, _, port, x, t = twins
    fn = FusedUNetInference(port, kernel_min_tokens=256)
    out = fn(torch.from_numpy(x), torch.from_numpy(t))
    kernel = sorted(n for n, d in fn.res_decisions.items()
                    if d["impl"] == "kernel")
    # the 16x16 level: two encoder blocks, three decoder blocks
    assert kernel == ["dec_0_0", "dec_0_1", "dec_0_2", "enc_0_0", "enc_0_1"]
    assert all(fn.res_decisions[n]["tokens"] == 256 for n in kernel)
    plain = FusedUNetInference(port, resblock="plain")
    _close(out, plain(torch.from_numpy(x), torch.from_numpy(t)).numpy())
    assert {d["impl"] for d in plain.res_decisions.values()} == {"module"}


def test_engine_rejects_what_the_jax_engine_rejects():
    model = UNetModel(in_channels=3, out_channels=3, resblock_updown=True,
                      dtype=torch.float32, device="cpu", **SMALL)
    with pytest.raises(ValueError, match="up/down"):
        FusedUNetInference(model)
    with pytest.raises(ValueError, match="resblock must be"):
        FusedUNetInference(UNetModel(in_channels=3, out_channels=3,
                                     dtype=torch.float32, device="cpu",
                                     **SMALL), resblock="pallas")


@pytest.mark.parametrize("k", [1, 3])
def test_ddim_chain_through_the_engine_matches_the_plain_model(twins, k):
    """A 10-step DDIM chain through the engine against the chain through
    the plain model, in the port and in the JAX package."""
    jm, params, port, x, _ = twins
    fn = make_fused_apply(port, kernel_min_tokens=0)
    ddpm = DDPM.create(1000)
    xT = torch.from_numpy(x)

    def sampler(net):
        def call(xi, i, **kw):
            return net(xi, i.float() / 1000.0, **kw)
        if k == 1:
            return pa.make_ddim_sampler(call, ddpm, num_steps=10)
        return pa.make_cached_ddim_sampler(
            lambda xi, i: call(xi, i, mode="encode"),
            lambda xi, i, c: call(xi, i, mode="decode", cache=c), ddpm,
            num_steps=10, encoder_reuse=k)

    got = sampler(fn)(xT)
    with torch.no_grad():
        want = sampler(port)(xT)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=0)

    jd = JaxDDPM.create(1000)

    def jcall(xi, i, **kw):
        return jm.apply(params, xi, i.astype(jnp.float32) / 1000.0, **kw)
    if k == 1:
        jsampler = ja.make_ddim_sampler(jcall, jd, num_steps=10)
    else:
        jsampler = ja.make_cached_ddim_sampler(
            lambda xi, i: jcall(xi, i, mode="encode"),
            lambda xi, i, c: jcall(xi, i, mode="decode", cache=c), jd,
            num_steps=10, encoder_reuse=k)
    want = jax.jit(jsampler)(jax.random.PRNGKey(0), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)
