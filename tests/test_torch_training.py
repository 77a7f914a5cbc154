"""The port's DDPM training path against the JAX package's, on the CPU:
losses, EMA, optimizer and train step, dropout, the trainer's loop.

Both sides take the same weights (tests/torch_twin.py), batches made with
numpy, and the same draws: the port's losses take their draws (`i`,
`noise`, `condition`, `use_cond`) as arguments, and the tests compute them
by replaying the JAX key tree (`make_train_step` splits (rng, key) per step;
`ddpm_loss` splits key into (ki, kq), `amortized_ddpm_loss` into (kc, kb,
ki, kq)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twin import (TINY, make_twins, one_torch_thread,  # noqa: F401
                        random_params)
from tpu_diffusion.conditioning import guidance as jg
from tpu_diffusion.conditioning import likelihoods as jl
from tpu_diffusion.core import ema as jax_ema
from tpu_diffusion.core.schedules import DDPM as JaxDDPM
from tpu_diffusion.losses import ddpm as jax_losses
from tpu_diffusion.models.unet import UNetModel as JaxUNet
from tpu_diffusion.train import trainer as jax_trainer
from tpu_diffusion_torch.conditioning import guidance as pg
from tpu_diffusion_torch.conditioning import likelihoods as pl
from tpu_diffusion_torch.convert import (load_flax_train_state,
                                         unet_state_dict_from_flax)
from tpu_diffusion_torch.core.ema import EMAState, ema_update
from tpu_diffusion_torch.core.schedules import DDPM
from tpu_diffusion_torch.losses import ddpm as losses
from tpu_diffusion_torch.models import nn as port_nn
from tpu_diffusion_torch.models.unet import UNetModel, create_model
from tpu_diffusion_torch.train import trainer
from tpu_diffusion_torch.train.actions import PeriodicCallback

STEPS = 25  # diffusion steps
PATCH = 6


def _np(a):
    return torch.from_numpy(np.array(a))


def _ddpm_draws(key, x):
    ki, kq = jax.random.split(key)
    return dict(i=_np(jax.random.randint(ki, (x.shape[0],), 0, STEPS)).long(),
                noise=_np(jax.random.normal(kq, x.shape, jnp.float32)))


def _amortized_draws(key, x, jlik, p_cond):
    kc, kb, ki, kq = jax.random.split(key, 4)
    return dict(
        condition=_np(jlik.sample(kc, jnp.asarray(x))),
        use_cond=bool(jax.random.uniform(kb, ()) < p_cond),
        i=_np(jax.random.randint(ki, (x.shape[0],), 0, STEPS)).long(),
        noise=_np(jax.random.normal(kq, x.shape, jnp.float32)))


@pytest.fixture(scope="module")
def setup():
    twins = {"uncond": make_twins("xla", seed=41, attention_impl="xla"),
             "amortized": make_twins("xla", seed=42, attention_impl="xla",
                                     in_channels=6)}
    rng = np.random.default_rng(43)
    batches = [np.clip(rng.standard_normal((2, 16, 16, 3)), -1, 1).astype(
        np.float32) for _ in range(5)]
    return twins, batches


# --- losses -----------------------------------------------------------------

def test_ddpm_loss_matches_jax(setup):
    twins, batches = setup
    jm, params, port = twins["uncond"]
    jd, pd = JaxDDPM.create(STEPS), DDPM.create(STEPS)
    for seed, x in enumerate(batches[:2]):
        key = jax.random.PRNGKey(seed)
        want = float(jax_losses.ddpm_loss(
            key, lambda xi, t: jm.apply(params, xi, t), jd, jnp.asarray(x)))
        with torch.no_grad():
            got = float(losses.ddpm_loss(None, port, pd, torch.from_numpy(x),
                                         **_ddpm_draws(key, x)))
        assert got == pytest.approx(want, abs=1e-5)


def test_amortized_loss_matches_jax_with_and_without_the_condition(setup):
    twins, batches = setup
    jm, params, port = twins["amortized"]
    jd, pd = JaxDDPM.create(STEPS), DDPM.create(STEPS)
    jlik, plik = jl.InPainting(patch_size=PATCH), pl.InPainting(
        patch_size=PATCH)
    x = batches[0]
    seen = set()
    for seed in range(8):  # p_cond 0.5: both branches of the per-batch draw
        key = jax.random.PRNGKey(seed)
        draws = _amortized_draws(key, x, jlik, 0.5)
        want = float(jax_losses.amortized_ddpm_loss(
            key, lambda xi, t: jm.apply(params, xi, t), jd,
            jg.Amortized(p_cond=0.5), jlik, jnp.asarray(x)))
        loss_fn, _ = losses.get_loss_function(port, pd,
                                              pg.Amortized(p_cond=0.5), plik)
        with torch.no_grad():
            got = float(loss_fn(None, torch.from_numpy(x), **draws))
        assert got == pytest.approx(want, abs=1e-5)
        seen.add(draws["use_cond"])
    assert seen == {True, False}


def test_losses_draw_from_their_generator(setup):
    twins, batches = setup
    _, _, port = twins["amortized"]
    pd, plik = DDPM.create(STEPS), pl.InPainting(patch_size=PATCH)
    loss_fn, _ = losses.get_loss_function(port, pd, pg.Amortized(), plik)
    x = torch.from_numpy(batches[0])
    with torch.no_grad():
        a, b, c = (float(loss_fn(torch.Generator().manual_seed(s), x))
                   for s in (0, 0, 1))
    assert a == b and a != c and np.isfinite(a)
    # i is drawn in [0, num_steps)
    i = torch.cat([losses._draw_steps(torch.Generator().manual_seed(s), pd,
                                      torch.zeros(64, 1)) for s in range(8)])
    assert i.min() == 0 and i.max() == STEPS - 1
    w = torch.tensor([1.0, 10.0])
    assert float(losses.weighted_mask_loss(torch.tensor([1.0, 2.0]),
                                           torch.zeros(2), w)) == 20.5


# --- EMA ---------------------------------------------------------------------

@pytest.mark.parametrize("update_after", [0, 3])
@pytest.mark.parametrize("warmup", [True, False])
def test_ema_matches_jax(update_after, warmup):
    rng = np.random.default_rng(5)
    p = {"a": rng.standard_normal((4, 3)).astype(np.float32),
         "b": rng.standard_normal((5,)).astype(np.float32)}
    jstate = jax_ema.EMAState.create({k: jnp.asarray(v) for k, v in p.items()})
    state = EMAState.create({k: torch.from_numpy(v) for k, v in p.items()})
    for _ in range(25):
        p = {k: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p.items()}
        jstate = jax_ema.ema_update(
            jstate, {k: jnp.asarray(v) for k, v in p.items()}, 0.995,
            update_every=10, update_after=update_after, warmup=warmup)
        ema_update(state, {k: torch.from_numpy(v) for k, v in p.items()},
                   0.995, update_every=10, update_after=update_after,
                   warmup=warmup)
        assert state.count == int(jstate.count)
        for k in p:
            np.testing.assert_allclose(state.params[k].numpy(),
                                       np.asarray(jstate.params[k]),
                                       atol=1e-6, rtol=0)


# --- optimizer and train step ------------------------------------------------

@pytest.mark.parametrize("schedule,warmup,total", [
    ("warmup", 3, None), ("warmup_cosine", 2, 8), ("warmup_cosine", 0, 8),
    ("constant", 3, None), ("warmup", 0, None)])
def test_schedules_match_optax(schedule, warmup, total):
    import optax
    if schedule == "warmup_cosine":
        want = optax.warmup_cosine_decay_schedule(
            1e-3 if warmup == 0 else 0.0, 1e-3, warmup,
            max(total, warmup + 1))
    elif schedule == "constant" or warmup == 0:
        want = optax.constant_schedule(1e-3)
    else:
        want = lambda s: 1e-3 * min((s + 1) / warmup, 1.0)  # noqa: E731
    got = trainer.make_schedule(1e-3, warmup, total, schedule)
    for step in range(12):
        # optax evaluates its schedules in fp32, the port in float64
        assert got(step) == pytest.approx(float(want(step)), rel=1e-5,
                                          abs=1e-12)


def _jax_run(jm, params, loss, batches, schedule, warmup, clip, lr):
    tx = jax_trainer.make_optimizer(lr, warmup=warmup, grad_clip=clip,
                                    total_steps=len(batches),
                                    schedule=schedule)
    state = jax_trainer.TrainState.create(params, tx, jax.random.PRNGKey(7))
    step = jax.jit(jax_trainer.make_train_step(
        loss, tx, ema_decay=0.995, ema_update_every=2))
    keys, metrics = [], []
    for x in batches:
        keys.append(jax.random.split(state.rng)[1])
        state, m = step(state, jnp.asarray(x))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, keys, metrics


def _port_state(port, params, lr, schedule, warmup, clip, total):
    opt = trainer.make_optimizer(port.parameters(), lr, warmup=warmup,
                                 grad_clip=clip, total_steps=total,
                                 schedule=schedule)
    return load_flax_train_state(trainer.TrainState.create(port, opt),
                                 params)


def _noise_mask(jloss, params, key, x):
    """{port parameter name: bool array}, true where the gradient at the
    initial state is below 1e-4 of the tree's largest entry: fp32 rounding
    noise (~1e-8 absolute here) is then a visible share of it."""
    g = jax.grad(jloss)(params, key, jnp.asarray(x))
    mag = {k: v.abs().numpy() for k, v in unet_state_dict_from_flax(
        jax.tree.map(np.asarray, g)).items()}
    top = max(v.max() for v in mag.values())
    return {k: v < 1e-4 * top for k, v in mag.items()}


def _check_state(state, jstate, atol, noise, lr=1e-4):
    """Parameters and EMA parameters against the JAX state's, within `atol`.
    Adam divides each gradient entry by its own running size, so where an
    entry is rounding noise (`_noise_mask`) the update is up to lr per step
    with a sign that the two frameworks' roundings decide. That holds for a
    few entries and for whole vectors whose gradient is zero in exact
    arithmetic: the bias of a ResBlock's first conv and every bias whose
    per-channel constant a later GroupNorm with one channel per group
    removes (all of them at these widths), and the key third of a qkv bias
    (softmax ignores a constant added to every key's logit). Those entries
    are held to 2 * steps * lr, all others (over 95%) to `atol`."""
    want = unet_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    want_ema = unet_state_dict_from_flax(
        jax.tree.map(np.asarray, jstate.ema.params))
    assert state.step == int(jstate.step)
    assert state.ema.count == int(jstate.ema.count)
    loose = max(atol, 2 * state.step * lr)
    total = sum(m.size for m in noise.values())
    assert sum(int(m.sum()) for m in noise.values()) < 0.05 * total
    for name, p in state.params.items():
        assert p.dtype == torch.float32
        tol = np.where(noise[name], loose, atol)
        for got, ref in ((p.detach(), want[name]),
                         (state.ema.params[name], want_ema[name])):
            diff = np.abs(got.numpy() - ref.numpy())
            assert (diff <= tol).all(), (name, diff.max())


@pytest.mark.parametrize("schedule,warmup", [
    ("warmup", 3), ("warmup_cosine", 2), ("constant", 0)])
def test_five_steps_match_jax(setup, schedule, warmup):
    twins, batches = setup
    jm, params, port = make_twins("xla", seed=41, attention_impl="xla")
    jd, pd = JaxDDPM.create(STEPS), DDPM.create(STEPS)
    clip, lr = 0.05, 1e-4

    def jloss(p, key, x):
        return jax_losses.ddpm_loss(key, lambda xi, t: jm.apply(p, xi, t),
                                    jd, x)

    jstate, keys, want = _jax_run(jm, params, jloss, batches, schedule,
                                  warmup, clip, lr)
    state = _port_state(port, params, lr, schedule, warmup, clip,
                        len(batches))
    draws = iter([_ddpm_draws(k, x) for k, x in zip(keys, batches)])
    step = trainer.make_train_step(
        lambda model, gen, x: losses.ddpm_loss(gen, model, pd, x,
                                               **next(draws)),
        ema_decay=0.995, ema_update_every=2)
    for x, w in zip(batches, want):
        state, m = step(state, torch.from_numpy(x))
        assert float(m["loss"]) == pytest.approx(w["loss"], abs=1e-5)
        # reported before clipping, and above the clip: the rule matters
        assert float(m["grad_norm"]) == pytest.approx(w["grad_norm"],
                                                      abs=1e-5, rel=1e-5)
        assert float(m["grad_norm"]) > clip
    _check_state(state, jstate, 1e-5,
                 _noise_mask(jloss, params, keys[0], batches[0]))
    assert state.optimizer.count == 5 and port.training


def test_amortized_steps_match_jax(setup):
    twins, batches = setup
    jm, params, port = make_twins("xla", seed=42, attention_impl="xla",
                                  in_channels=6)
    jd, pd = JaxDDPM.create(STEPS), DDPM.create(STEPS)
    jlik, plik = jl.InPainting(patch_size=PATCH), pl.InPainting(
        patch_size=PATCH)

    def jloss(p, key, x):
        return jax_losses.amortized_ddpm_loss(
            key, lambda xi, t: jm.apply(p, xi, t), jd, jg.Amortized(), jlik,
            x)

    jstate, keys, want = _jax_run(jm, params, jloss, batches[:3], "warmup",
                                  3, 1.0, 1e-4)
    state = _port_state(port, params, 1e-4, "warmup", 3, 1.0, 3)
    draws = iter([_amortized_draws(k, x, jlik, 0.9)
                  for k, x in zip(keys, batches)])
    def loss(model, gen, x):
        return losses.get_loss_function(model, pd, pg.Amortized(), plik)[0](
            gen, x, **next(draws))

    step = trainer.make_train_step(loss, ema_decay=0.995, ema_update_every=2)
    for x, w in zip(batches[:3], want):
        state, m = step(state, torch.from_numpy(x))
        assert float(m["loss"]) == pytest.approx(w["loss"], abs=1e-5)
    _check_state(state, jstate, 1e-5,
                 _noise_mask(jloss, params, keys[0], batches[0]))


def test_bf16_compute_trains_fp32_parameters(setup):
    """The forward runs in bf16 and the parameters stay fp32 on both sides:
    three steps agree with the JAX package's to bf16 accuracy. (Adam on
    bf16 parameters would lose updates of lr = 1e-4 below bf16's 2^-8
    relative spacing.)"""
    _, batches = setup
    kw = dict(TINY)
    jm = JaxUNet(attention_impl="xla", norm_impl="xla", dtype=jnp.bfloat16,
                 **kw)
    params = random_params(jm, 44)
    port = UNetModel(attention_impl="dense", dtype=torch.bfloat16,
                     device="cpu", **kw)
    jd, pd = JaxDDPM.create(STEPS), DDPM.create(STEPS)

    def jloss(p, key, x):
        return jax_losses.ddpm_loss(key, lambda xi, t: jm.apply(p, xi, t),
                                    jd, x)

    jstate, keys, want = _jax_run(jm, params, jloss, batches[:3], "constant",
                                  0, 1.0, 1e-4)
    assert all(v.dtype == jnp.float32
               for v in jax.tree.leaves(jstate.params))
    state = _port_state(port, params, 1e-4, "constant", 0, 1.0, 3)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    draws = iter([_ddpm_draws(k, x) for k, x in zip(keys, batches)])
    step = trainer.make_train_step(
        lambda model, gen, x: losses.ddpm_loss(gen, model, pd, x,
                                               **next(draws)),
        ema_decay=0.995, ema_update_every=2)
    for x, w in zip(batches[:3], want):
        state, m = step(state, torch.from_numpy(x))
        # bf16 forward on both sides, rounding at different places
        assert float(m["loss"]) == pytest.approx(w["loss"], rel=2e-2)
    # every parameter moved by at most 3 * lr and stayed fp32; a bf16
    # parameter of magnitude 1 could not have moved at all
    assert all(p.dtype == torch.float32 for p in state.params.values())
    moved = max((state.params[k] - before[k]).abs().max().item()
                for k in before)
    assert 0 < moved <= 3.01e-4
    # Adam's normalised update has size ~lr whatever the gradient's, so
    # where the two bf16 forwards round a small gradient to opposite signs
    # the parameters differ by up to 2 * 3 * lr; most agree far better
    # (this run: max 5.8e-4, 99th percentile 9.0e-5, mean 5.2e-6)
    nothing = {k: np.zeros(tuple(v.shape), bool)
               for k, v in state.params.items()}
    _check_state(state, jstate, 6.5e-4, nothing)
    diffs = torch.cat([
        (p.detach() - unet_state_dict_from_flax(
            jax.tree.map(np.asarray, jstate.params))[k]).abs().flatten()
        for k, p in state.params.items()])
    assert diffs.mean().item() < 2e-5


# --- dropout -----------------------------------------------------------------

def test_dropout_is_seeded_scaled_and_off_in_eval():
    kw = dict(image_size=16, num_channels=16, num_res_blocks=1,
              channel_mult=(1, 2), attention_resolutions="8", num_heads=2,
              use_scale_shift_norm=True, dtype=torch.float32, device="cpu",
              attention_impl="dense")
    torch.manual_seed(0)
    dropped = create_model(**kw, dropout=0.3)
    plain = create_model(**kw, dropout=0.0)
    plain.load_state_dict(dropped.state_dict())
    for m in (dropped, plain):  # nonzero output convs
        with torch.no_grad():
            for p in m.parameters():
                if p.abs().max() == 0:
                    p.normal_(0, 0.1, generator=torch.Generator()
                              .manual_seed(p.numel()))
    g = torch.Generator().manual_seed(1)
    x, t = torch.randn((2, 16, 16, 3), generator=g), torch.rand(2,
                                                                generator=g)
    with torch.no_grad():
        assert torch.equal(dropped.eval()(x, t), plain.eval()(x, t))
        dropped.train()
        a, b, c = (dropped(x, t, generator=torch.Generator().manual_seed(s))
                   for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, plain(x, t))
    # the mask itself: kept share within 3 sigma of 1 - p, kept entries
    # scaled by 1 / (1 - p)
    ones = torch.ones(200, 200)
    y = port_nn.dropout(ones, 0.3, torch.Generator().manual_seed(5))
    kept = (y != 0).float().mean().item()
    sigma = (0.3 * 0.7 / ones.numel()) ** 0.5
    assert abs(kept - 0.7) <= 3 * sigma
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0],
                                                          1 / 0.7))


# --- the loop ----------------------------------------------------------------

def test_fit_fires_callbacks_and_reads_metrics_only_then(setup):
    _, batches = setup
    _, params, port = make_twins("xla", seed=41, attention_impl="xla")
    pd = DDPM.create(STEPS)
    opt = trainer.make_optimizer(port.parameters(), 1e-4, warmup=2)
    state = trainer.TrainState.create(port, opt,
                                      torch.Generator().manual_seed(0))
    step = trainer.make_train_step(
        lambda model, gen, x: losses.ddpm_loss(gen, model, pd, x))
    fired, plain_calls = [], []
    periodic = PeriodicCallback(
        callback_fn=lambda step, state, metrics: fired.append(
            (step, metrics)), every_steps=2)

    def every_step(step, state, metrics):
        plain_calls.append((step, metrics))

    def forever():
        while True:
            yield from batches

    t = trainer.Trainer(step, state, forever(), callbacks=[periodic])
    out = t.fit(5)
    assert out is state and state.step == 5
    assert [s for s, _ in fired] == [2, 4]
    for _, m in fired:
        assert set(m) == {"loss", "grad_norm", "steps_per_sec"}
        assert all(isinstance(v, float) for v in m.values())
    # a callback without should_fire runs every step, with host metrics
    t = trainer.Trainer(step, state, forever(), callbacks=[every_step])
    t.fit(2)
    assert [s for s, _ in plain_calls] == [6, 7]
    assert isinstance(plain_calls[0][1]["loss"], float)
    # nothing fires: the hook-less loop leaves the metrics on the device
    seen = []
    quiet = PeriodicCallback(callback_fn=lambda **kw: seen.append(kw),
                             every_steps=100)
    trainer.Trainer(step, state, forever(), callbacks=[quiet]).fit(1)
    assert not seen and state.step == 8


# --- the port's own copies of the periodic actions and the writers -----------

def test_actions_and_writers_behave_like_the_jax_package(tmp_path):
    from tpu_diffusion.train import actions as jax_actions
    from tpu_diffusion.train import writers as jax_writers
    from tpu_diffusion_torch.train import actions, writers
    fired = {}
    for mod in (jax_actions, actions):
        steps = fired.setdefault(mod.__name__, [])
        cb = mod.PeriodicCallback(
            callback_fn=lambda step, steps=steps, **kw: steps.append(step),
            every_steps=3, on_steps=[1, 7])
        for step in range(1, 11):
            assert cb.should_fire(step) == cb(step, state=None)
        with pytest.raises(ValueError, match="every step"):
            cb(20)
    assert list(fired.values()) == [[1, 3, 6, 7, 9]] * 2
    images = np.linspace(-1, 1, 3 * 4 * 4, dtype=np.float32).reshape(
        3, 4, 4, 1)
    for name, mod in (("jax", jax_writers), ("port", writers)):
        w = mod.MultiWriter([mod.LocalWriter(str(tmp_path / name)),
                             mod.TensorBoardWriter(str(tmp_path / name /
                                                       "tb"))])
        w.log_hparams({"a": {"b": 1}, "c": (1, 2), "d": np.float32(0.5)})
        w.write_scalars(1, {"loss": 1.5})
        w.flush()
        w.write_scalars(2, {"loss": 1.0, "late": 3.0})  # widens the header
        w.write_images(2, {"samples": images})
        w.flush()
    for rel in ("metrics.csv", "config.yaml"):
        assert ((tmp_path / "port" / rel).read_text()
                == (tmp_path / "jax" / rel).read_text())
    assert "late" in (tmp_path / "port" / "metrics.csv").read_text()
    np.testing.assert_array_equal(writers._to_uint8_grid(images),
                                  jax_writers._to_uint8_grid(images))
