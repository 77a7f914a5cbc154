"""The port's conditional flow matching against the JAX package's, on the
CPU: the CFM UNet wrapper, the matchers and couplings, the ODE integrators,
one training step, and `train_cifar10` then `compute_fid` end to end.

Both sides take the same weights (numpy draws converted with
`wrapper_state_dict_from_flax`) and the same draws: the port's matchers and
loss take `t` and `eps` as arguments, which the tests compute by replaying
the JAX key tree. Dropout masks and OT pairs come from different generators
in the two packages, so the step is compared at dropout 0 on one fixed
paired batch."""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.cli import train_cifar10 as jax_cli
from tpu_diffusion.losses import cfm as jax_cfm
from tpu_diffusion.models.unet import UNetModelWrapper as JaxWrapper
from tpu_diffusion.sampling import ode as jax_ode
from tpu_diffusion.train import trainer as jax_trainer
from tpu_diffusion_torch.cli import compute_fid
from tpu_diffusion_torch.cli import train_cifar10 as cli
from tpu_diffusion_torch.convert import (load_flax_train_state,
                                         wrapper_state_dict_from_flax)
from tpu_diffusion_torch.eval import fid
from tpu_diffusion_torch.losses import cfm
from tpu_diffusion_torch.models.unet import UNetModelWrapper
from tpu_diffusion_torch.sampling import ode
from tpu_diffusion_torch.train import trainer

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
# a tiny CIFAR-style wrapper: attention at 8x8 (dense in both packages)
TINY = dict(dim=(16, 16, 3), num_channels=16, num_res_blocks=1,
            channel_mult=(1, 2), num_heads=2, attention_resolutions="8")


def _np(a):
    return torch.from_numpy(np.array(a))


def make_wrappers(seed, dropout=0.0):
    """(jax wrapper, flax params, port wrapper), fp32, same weights: kernels
    N(0, 1/fan_in) (the zero-initialised output conv too), norm scales
    1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    jm = JaxWrapper(dtype=jnp.float32, attention_impl="xla",
                    dropout=dropout, **TINY)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1,)),
                            jnp.zeros((1, 16, 16, 3)))
    rng = np.random.default_rng(seed)

    def draw(path, sd):
        leaf = path[-1].key
        if leaf == "kernel":
            v = rng.standard_normal(sd.shape) / np.sqrt(
                np.prod(sd.shape[:-1]))
        elif leaf == "scale":
            v = 1 + 0.1 * rng.standard_normal(sd.shape)
        else:
            v = 0.1 * rng.standard_normal(sd.shape)
        return v.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    port = UNetModelWrapper(dtype=torch.float32, attention_impl="dense",
                            dropout=dropout, device="cpu", **TINY)
    port.load_state_dict(wrapper_state_dict_from_flax(params))
    return jm, params, port.eval()


@pytest.fixture(scope="module")
def wrappers():
    return make_wrappers(0)


def _images(seed, shape=(4, 16, 16, 3)):
    return np.clip(np.random.default_rng(seed).standard_normal(shape), -1,
                   1).astype(np.float32)


# --- the wrapper -------------------------------------------------------------

def test_wrapper_forward_matches_jax(wrappers):
    """v(t, x) at t in (0, 1): the backbone embeds t * 1000 on both sides (a
    missing time scale still agrees at t = 0)."""
    jm, params, port = wrappers
    x = _images(1)
    t = np.array([0.13, 0.5, 0.77, 0.999], np.float32)
    apply = jax.jit(jm.apply)
    want = np.asarray(apply(params, jnp.asarray(t), jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(t), torch.from_numpy(x))
        scalar_t = port(torch.tensor(0.5), torch.from_numpy(x))
        port.net.time_scale = 1.0
        unscaled = port(torch.from_numpy(t), torch.from_numpy(x))
        port.net.time_scale = 1000.0
    assert got.shape == (4, 16, 16, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert (unscaled - got).abs().max() > 1e-2
    want_half = np.asarray(apply(params, jnp.full((4,), 0.5),
                                 jnp.asarray(x)))
    np.testing.assert_allclose(scalar_t.numpy(), want_half, rtol=0,
                               atol=1e-4)


def test_wrapper_config_matches_jax():
    """The CIFAR model of both CLIs: 128 channels, (1,2,2,2), FiLM, 4 heads at
    16x16, dropout 0.1, bf16 compute with fp32 parameters, t * 1000."""
    model = cli.build_model(device="meta")
    net = model.net
    assert net.model_channels == 128 and net.channel_mult == (1, 2, 2, 2)
    assert net.attention_resolutions == (2,) and net.time_scale == 1000.0
    assert net.dtype == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    blocks = {n: m for n, m in net.named_children() if "attn" in n}
    assert {b.heads for b in blocks.values()} == {4}
    assert all(b.resolved_impl(256) == "dense" for b in blocks.values())
    assert net.enc_0_0.use_scale_shift_norm and net.enc_0_0.dropout == 0.1
    jm = jax_cli.build_model()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1,)),
                            jnp.zeros((1, 32, 32, 3)))
    keys = set(wrapper_state_dict_from_flax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes)))
    assert keys == {k for k, _ in model.named_parameters()}


# --- matchers ----------------------------------------------------------------

MATCHER_CASES = {"icfm": dict(sigma=0.1), "fm": dict(sigma=0.1),
                 "si": dict(sigma=0.1), "sbcfm": dict(sigma=0.5),
                 "otcfm": dict(sigma=0.1)}


@pytest.mark.parametrize("name", sorted(MATCHER_CASES))
def test_matcher_paths_match_jax(name):
    """mu_t, sigma_t and u_t at fixed t and eps; where the coupling is
    deterministic (all but sbcfm's sampled sinkhorn plan), the whole
    sample_location_and_conditional_flow with the JAX key's t and eps."""
    kw = MATCHER_CASES[name]
    jmatch, pmatch = jax_cfm.get_matcher(name, **kw), cfm.get_matcher(
        name, **kw)
    assert type(pmatch).__name__ == type(jmatch).__name__
    rng = np.random.default_rng(2)
    x0, x1, eps = (rng.standard_normal((6, 4, 4, 2)).astype(np.float32)
                   for _ in range(3))
    t = np.array([0.05, 0.2, 0.4, 0.6, 0.8, 0.95], np.float32)
    xt = np.asarray(jmatch.compute_mu_t(x0, x1, jnp.asarray(t))
                    + jax_cfm._pad_t(jmatch.compute_sigma_t(jnp.asarray(t)),
                                     4) * eps)
    for got, want in (
            (pmatch.compute_mu_t(_np(x0), _np(x1), _np(t)),
             jmatch.compute_mu_t(x0, x1, jnp.asarray(t))),
            (pmatch.compute_sigma_t(_np(t)),
             jmatch.compute_sigma_t(jnp.asarray(t))),
            (pmatch.compute_conditional_flow(_np(x0), _np(x1), _np(t),
                                             _np(xt)),
             jmatch.compute_conditional_flow(x0, x1, jnp.asarray(t),
                                             jnp.asarray(xt))),
            (pmatch.sample_xt(None, _np(x0), _np(x1), _np(t), _np(eps)),
             xt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    if name == "sbcfm":
        return
    key = jax.random.PRNGKey(3)
    if name == "otcfm":  # the pairing takes the first split
        key = jax.random.split(key)[1]
    kt, kx = jax.random.split(key)
    jt = np.asarray(jax.random.uniform(kt, (6,)))
    jeps = np.asarray(jax.random.normal(kx, x0.shape))
    want = jmatch.sample_location_and_conditional_flow(
        jax.random.PRNGKey(3), jnp.asarray(x0), jnp.asarray(x1))
    got = pmatch.sample_location_and_conditional_flow(
        None, _np(x0), _np(x1), t=_np(jt), eps=_np(jeps))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_matchers_draw_from_their_generator():
    m = cfm.get_matcher("icfm", sigma=0.1)
    x0, x1 = torch.zeros(8, 3), torch.ones(8, 3)
    a, b, c = (m.sample_location_and_conditional_flow(
        torch.Generator().manual_seed(s), x0, x1) for s in (0, 0, 1))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[1], c[1])
    assert ((a[0] >= 0) & (a[0] < 1)).all()


def test_get_matcher_refusals():
    with pytest.raises(ValueError, match="sigma > 0"):
        cfm.get_matcher("sbcfm", sigma=0.0)
    with pytest.raises(NotImplementedError):
        cfm.get_matcher("rectified")
    assert cfm.get_matcher("otcfm", method="sinkhorn").method == "sinkhorn"
    assert float(cfm.cfm_loss(torch.ones(2, 3), torch.zeros(2, 3))) == 1.0


def test_exact_ot_permutations_match_jax():
    """numpy_ot_permutation and the in-step exact_ot_permutation give the
    JAX package's permutation exactly, and the sinkhorn plan's argmax its
    argmax."""
    rng = np.random.default_rng(4)
    x0 = rng.standard_normal((16, 4, 4, 1)).astype(np.float32)
    x1 = rng.standard_normal((16, 4, 4, 1)).astype(np.float32)
    want = np.asarray(jax_cfm.exact_ot_permutation(jnp.asarray(x0),
                                                   jnp.asarray(x1)))
    np.testing.assert_array_equal(cfm.numpy_ot_permutation(x0, x1), want)
    np.testing.assert_array_equal(
        cfm.exact_ot_permutation(_np(x0), _np(x1)).numpy(), want)
    np.testing.assert_array_equal(
        jax_cfm.numpy_ot_permutation(x0, x1), want)
    # near-identity pairs: the entropic plan's argmax recovers them
    x1n = x0 + 0.01 * rng.standard_normal(x0.shape).astype(np.float32)
    got = cfm.sinkhorn_assignment(_np(x0), _np(x1n)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_cfm.sinkhorn_assignment(jnp.asarray(x0),
                                                    jnp.asarray(x1n))))
    np.testing.assert_array_equal(got, np.arange(16))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_host_ot_pairs_match_jax(prefetch):
    rng = np.random.default_rng(5)
    batches = [rng.standard_normal((8, 4, 4, 1)).astype(np.float32)
               for _ in range(3)]
    got = list(cfm.host_ot_pairs(iter(batches), seed=7, prefetch=prefetch))
    want = list(jax_cfm.host_ot_pairs(iter(batches), seed=7, prefetch=0))
    assert len(got) == len(want) == 3
    for (g0, g1), (w0, w1) in zip(got, want):
        np.testing.assert_array_equal(g0, w0)
        np.testing.assert_array_equal(g1, w1)


def test_host_ot_pairs_worker_stops_when_abandoned():
    consumed = []

    def endless():
        rng = np.random.default_rng(1)
        while True:
            consumed.append(1)
            yield rng.standard_normal((8, 2, 2, 1)).astype(np.float32)

    before = threading.active_count()
    gen = cfm.host_ot_pairs(endless(), seed=3, prefetch=2)
    next(gen)
    gen.close()  # GeneratorExit -> stop flag
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    n = len(consumed)
    time.sleep(0.3)
    assert len(consumed) == n


# --- integrators -------------------------------------------------------------

A = np.array([[-1.0, 0.5], [-0.5, -0.2]], np.float32)


def _linear_fields():
    """dx/dt = x A^T + t (a time-dependent linear field) on both sides."""
    def jv(t, x):
        return x @ A.T + t

    def pv(t, x):
        return x @ torch.from_numpy(A).T + t

    return jv, pv, np.random.default_rng(6).standard_normal(
        (3, 2)).astype(np.float32)


# per method: the arguments of a short run of each field
RUNS = {"euler": dict(num_steps=7), "midpoint": dict(num_steps=5),
        "heun": dict(num_steps=5), "rk4": dict(num_steps=3),
        "dopri5": dict(rtol=1e-3, atol=1e-3, max_steps=40)}


@pytest.mark.parametrize("field", ["linear", "wrapper"])
@pytest.mark.parametrize("method", sorted(RUNS))
def test_integrators_match_jax(method, field, wrappers):
    """The path to t=1 within 1e-5 and the NFE exactly."""
    if field == "linear":
        jv, pv, x0 = _linear_fields()
        kw = RUNS[method]
    else:
        jm, params, port = wrappers
        x0 = _images(7, (2, 16, 16, 3))

        def jv(t, x):
            return jm.apply(params, t, x)

        def pv(t, x):
            return port(t, x)

        # the random field is rough in t: a budget that the adaptive run
        # uses up, so it is compared trip for trip
        kw = {**RUNS[method], "max_steps": 4} if method == "dopri5" else {
            "num_steps": 2}
    want, want_nfe = jax.jit(lambda x: jax_ode.odeint(
        jv, x, method=method, **kw))(jnp.asarray(x0))
    with torch.no_grad():
        got, nfe = ode.odeint(pv, torch.from_numpy(x0), method=method, **kw)
    assert nfe == int(want_nfe)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    if method == "dopri5":
        assert ode.dopri5_truncated(nfe, kw["max_steps"]) == \
            jax_ode.dopri5_truncated(want_nfe, kw["max_steps"])


def test_dopri5_converges_early_and_reports_truncation():
    jv, pv, x0 = _linear_fields()
    x, nfe = ode.odeint_dopri5(pv, torch.from_numpy(x0))
    want, _ = ode.odeint_rk4(pv, torch.from_numpy(x0), num_steps=400)
    np.testing.assert_allclose(x.numpy(), want.numpy(), atol=1e-4)
    assert 7 <= nfe < 6 * 1000 and not ode.dopri5_truncated(nfe, 1000)
    _, short = ode.odeint_dopri5(pv, torch.from_numpy(x0), rtol=1e-9,
                                 atol=1e-9, max_steps=3)
    assert short == 1 + 6 * 3 and ode.dopri5_truncated(short, 3)
    with pytest.raises(NotImplementedError):
        ode.odeint(pv, torch.from_numpy(x0), method="dopri8")


# --- training ----------------------------------------------------------------

def _jax_step(jm, params, batch, lr, warmup, clip):
    tx = jax_trainer.make_optimizer(lr, warmup=warmup, grad_clip=clip,
                                    schedule="warmup")
    state = jax_trainer.TrainState.create(params, tx, jax.random.PRNGKey(9))
    loss = jax_cli.make_cfm_loss_fn(jm, jax_cfm.get_matcher("icfm"),
                                    paired=True)
    key = jax.random.split(state.rng)[1]
    state, m = jax.jit(jax_trainer.make_train_step(loss, tx, ema_decay=0.99))(
        state, tuple(jnp.asarray(b) for b in batch))
    # the loss's draws: (k0, km, kd) = split(key, 3); (kt, kx) = split(km)
    kt, kx = jax.random.split(jax.random.split(key, 3)[1])
    draws = dict(t=_np(jax.random.uniform(kt, (batch[0].shape[0],))),
                 eps=_np(jax.random.normal(kx, batch[0].shape)))
    return state, {k: float(v) for k, v in m.items()}, draws


def test_one_cfm_adam_step_matches_jax():
    """One step of the paired (otcfm host-pairs) objective at dropout 0 on a
    fixed paired batch: loss within 1e-5, the gradient norm (before
    clipping, and above the clip) within 1e-5, parameters and EMA within
    1e-5 where the gradient is not rounding noise. Adam's first update is
    lr * sign(g), so an entry whose gradient is below 1e-4 of the largest
    (rounding noise: a bias that a one-channel-per-group GroupNorm removes,
    the key third of a qkv bias) may move the other way: 2 * lr. Fewer than
    5% of the entries are such."""
    jm, params, port = make_wrappers(10)
    lr, clip = 1e-3, 0.05
    x1 = _images(11)
    (x0, x1p), = cfm.host_ot_pairs(iter([x1]), seed=12, prefetch=0)
    jstate, want, draws = _jax_step(jm, params, (x0, x1p), lr, 2, clip)
    opt = trainer.make_optimizer(port.parameters(), lr, warmup=2,
                                 grad_clip=clip, schedule="warmup")
    state = load_flax_train_state(trainer.TrainState.create(port, opt),
                                  params)
    loss = cli.make_cfm_loss_fn(cfm.get_matcher("icfm"), paired=True)
    step = trainer.make_train_step(
        lambda model, gen, batch: loss(model, gen, batch, **draws),
        ema_decay=0.99)
    state, m = step(state, (torch.from_numpy(x0), torch.from_numpy(x1p)))
    assert float(m["loss"]) == pytest.approx(want["loss"], abs=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(want["grad_norm"],
                                                  abs=1e-5, rel=1e-5)
    assert float(m["grad_norm"]) > clip
    # the port's gradients (clipping scales them all alike)
    mag = {k: p.grad.abs().numpy() for k, p in state.params.items()}
    top = max(v.max() for v in mag.values())
    noise = {k: v < 1e-4 * top for k, v in mag.items()}
    assert sum(int(n.sum()) for n in noise.values()) < 0.05 * sum(
        n.size for n in noise.values())
    ref = wrapper_state_dict_from_flax(jax.tree.map(np.asarray,
                                                    jstate.params))
    ref_ema = wrapper_state_dict_from_flax(jax.tree.map(np.asarray,
                                                        jstate.ema.params))
    for name, p in state.params.items():
        assert p.dtype == torch.float32
        tol = np.where(noise[name], 2 * lr, 1e-5)
        for got, w in ((p.detach(), ref[name]),
                       (state.ema.params[name], ref_ema[name])):
            assert (np.abs(got.numpy() - w.numpy()) <= tol).all(), name
    assert state.step == int(jstate.step) == 1


def test_dropout_masks_follow_the_trainers_generator():
    """At dropout 0.1 the loss is a function of the generator: the same seed
    gives the same loss, another seed another one."""
    _, _, port = make_wrappers(13, dropout=0.1)
    port.train()
    loss = cli.make_cfm_loss_fn(cfm.get_matcher("icfm"), paired=False)
    x1 = torch.from_numpy(_images(14))
    with torch.no_grad():
        a, b, c = (float(loss(port, torch.Generator().manual_seed(s), x1))
                   for s in (0, 0, 1))
        # the masks alone: t and eps fixed, only dropout draws differ
        t, eps = torch.full((4,), 0.5), torch.zeros(4, 16, 16, 3)
        d, e = (float(loss(port, torch.Generator().manual_seed(s), x1, t=t,
                           eps=eps)) for s in (2, 3))
    assert a == b and a != c and np.isfinite(a)
    assert d != e


# --- the CLIs end to end -----------------------------------------------------

def _small_features(kind, channels, device):
    """A narrow RandomConv (16 features): the square root of a 2048-wide
    covariance takes ~20 s on the CPU."""
    assert kind == "random_conv"
    net = fid.RandomConvFeatures(channels, width=8, features=16)
    fid.flax_default_init_(net, torch.Generator().manual_seed(42))
    return fid.feature_fn(net.to(device).eval())


TRAIN_ARGS = ["--num_channel", "32", "--total_steps", "2", "--batch_size",
              "4", "--save_step", "1", "--warmup", "2", "--sample_grid", "4",
              "--sample_steps", "2", "--device", "cpu", "--data_root",
              os.path.join(FIXTURES, "cifar")]


@pytest.mark.parametrize("model,ot", [("icfm", "exact"),
                                      ("otcfm", "sinkhorn")])
def test_train_cifar10_unpaired_paths(tmp_path, model, ot):
    last = cli.main(["--model", model, "--ot_method", ot, "--output_dir",
                     str(tmp_path)] + TRAIN_ARGS)
    assert last["step"] == 2 and last["nfe"] == 2
    grid = last["grid"]
    assert grid.shape == (4, 32, 32, 3) and torch.isfinite(grid).all()
    assert os.path.exists(tmp_path / model / "config.yaml")


def test_train_cifar10_then_compute_fid(tmp_path, monkeypatch):
    """otcfm with host OT pairs (tuple batches through the trainer), its
    checkpoints, then compute_fid on them by Euler, by dopri5 and by the
    fixed-trip dopri5 in chunks."""
    out = str(tmp_path)
    last = cli.main(["--model", "otcfm", "--output_dir", out] + TRAIN_ARGS)
    ckpts = sorted(os.listdir(tmp_path / "otcfm" / "ckpt"))
    assert ckpts == ["ckpt_00000001.pt", "ckpt_00000002.pt"]
    saved = torch.load(tmp_path / "otcfm" / "ckpt" / ckpts[-1],
                       weights_only=True)
    assert saved["step"] == 2
    assert {v.dtype for v in saved["params"].values()} == {torch.float32}
    # the zero-initialised output conv has moved, and the EMA trails it
    assert not torch.equal(saved["params"]["net.conv_out.weight"],
                           saved["ema"]["net.conv_out.weight"])
    grid = last["grid"]
    assert torch.isfinite(grid).all() and grid.abs().max() <= 1.0
    assert any(f.startswith("otcfm_generated")
               for f in os.listdir(tmp_path / "otcfm" / "images"))

    fid_args = ["--model", "otcfm", "--input_dir", out, "--num_channel",
                "32", "--num_gen", "4", "--batch_size_fid", "4",
                "--device", "cpu", "--data_root",
                os.path.join(FIXTURES, "cifar")]
    monkeypatch.setattr(compute_fid, "make_feature_fn", _small_features)
    euler = compute_fid.main(fid_args + ["--integration_method", "euler",
                                         "--integration_steps", "2"])
    # the calibrated fixed-trip budget through Dopri5Chunked
    # (tests/test_cli_fid.py:test_compute_fid_cli_chunked_dopri5)
    chunked = compute_fid.main(fid_args + [
        "--integration_method", "dopri5", "--tol", "1e-2",
        "--dopri5_fixed_trip", "true", "--dopri5_chunk", "8"])
    assert chunked["dopri5_chunk"] == 8
    assert chunked["dopri5_trip_budget"] >= 16
    assert chunked["mean_nfe"] > 6 and np.isfinite(chunked["fid"])
    dopri = compute_fid.main(fid_args + ["--integration_method", "dopri5",
                                         "--tol", "1e-2"])
    assert euler["mean_nfe"] == 2 and euler["step"] == 2
    assert np.isfinite(euler["fid"]) and np.isfinite(dopri["fid"])
    assert dopri["mean_nfe"] > 6 and dopri["dopri5_truncated"] is False
    assert euler["fid_comparable_to_published"] is False
    written = json.loads((tmp_path / "otcfm" / "fid_random_conv.json")
                         .read_text())
    assert written == dopri
    assert os.path.exists(tmp_path / "real_stats_torch_cifar10_random_conv_"
                                     "32x32x3.npz")
    x = torch.linspace(-1.2, 1.2, 11)
    q = compute_fid.quantize_roundtrip(x.clamp(-1, 1))
    assert (q - x.clamp(-1, 1)).abs().max() <= 1 / 127.5
