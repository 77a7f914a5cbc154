"""The training step as a graph (`train/graph.py`, `Trainer(graphed=True)`)
on the CPU, where its body runs as a plain call: against the JAX package's
jitted step, against the eager loop, the EMA body against the eager
branches, the declared eager routes, checkpointed models on the graphed
route, and C6 (the fused-QKV attention's
gradient through its autograd Function, the kernels without a backward
refusing a gradient)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_twin import make_twins, one_torch_thread  # noqa: F401
from tpu_diffusion.core.schedules import DDPM as JaxDDPM
from tpu_diffusion.kernels import attention as jax_attention
from tpu_diffusion.losses import ddpm as jax_losses
from tpu_diffusion.train import trainer as jax_trainer
from tpu_diffusion_torch.cli import train_cifar10
from tpu_diffusion_torch.convert import (load_flax_train_state,
                                         unet_state_dict_from_flax)
from tpu_diffusion_torch.core.ema import EMAState, ema_update
from tpu_diffusion_torch.core.schedules import DDPM
from tpu_diffusion_torch.kernels import attention, groupnorm, resblock
from tpu_diffusion_torch.losses import ddpm as losses
from tpu_diffusion_torch.losses.cfm import get_matcher
from tpu_diffusion_torch.models.unet import create_model, randomize_
from tpu_diffusion_torch.protein.denoiser import GVPDenoiser
from tpu_diffusion_torch.train import trainer

STEPS = 25  # diffusion steps
N = 5       # training steps
LR, CLIP = 1e-4, 0.05


def _np(a):
    return torch.from_numpy(np.array(a))


def _ddpm_draws(key, x):
    ki, kq = jax.random.split(key)
    return dict(i=_np(jax.random.randint(ki, (x.shape[0],), 0, STEPS)).long(),
                noise=_np(jax.random.normal(kq, x.shape, jnp.float32)))


def _batches(seed=43):
    rng = np.random.default_rng(seed)
    return [np.clip(rng.standard_normal((2, 16, 16, 3)), -1, 1).astype(
        np.float32) for _ in range(N)]


def _flat(tree):
    return unet_state_dict_from_flax(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("schedule,warmup,ema", [
    ("warmup", 3, dict(ema_update_every=2)),
    ("warmup_cosine", 2, dict(ema_update_after=2, ema_warmup=False)),
    ("constant", 0, dict(ema_update_every=3, ema_update_after=1))])
def test_graphed_body_matches_the_jax_jitted_step(schedule, warmup, ema):
    """Five steps through the graphed route's body against `jax.jit` of the
    JAX step, the JAX draws handed in: losses and gradient norms to 1e-5;
    per leaf Adam's moments and the five steps' update to 1e-4 of the
    leaf's largest. The update is read as the parameters' change, which
    also carries their own rounding (half an ulp of the parameter a step
    on each side: N ulp more). Where a gradient is rounding noise (below
    1e-4 of the tree's largest: biases a GroupNorm removes, the key third
    of the qkv bias) Adam's update of it is up to lr a step with a sign the
    rounding decides; those entries are held to 2 * N * lr, and their
    moments to the noise's size."""
    jm, params, port = make_twins("xla", seed=41, attention_impl="xla")
    jd, pd = JaxDDPM.create(STEPS), DDPM.create(STEPS)
    batches = _batches()

    def jloss(p, key, x):
        return jax_losses.ddpm_loss(key, lambda xi, t: jm.apply(p, xi, t),
                                    jd, x)

    tx = jax_trainer.make_optimizer(LR, warmup=warmup, grad_clip=CLIP,
                                    total_steps=N, schedule=schedule)
    jstate = jax_trainer.TrainState.create(params, tx, jax.random.PRNGKey(7))
    jstep = jax.jit(jax_trainer.make_train_step(jloss, tx, ema_decay=0.995,
                                                **ema))
    keys, want = [], []
    for x in batches:
        keys.append(jax.random.split(jstate.rng)[1])
        jstate, m = jstep(jstate, jnp.asarray(x))
        want.append({k: float(v) for k, v in m.items()})

    opt = trainer.make_optimizer(port.parameters(), LR, warmup=warmup,
                                 grad_clip=CLIP, total_steps=N,
                                 schedule=schedule)
    state = load_flax_train_state(trainer.TrainState.create(port, opt),
                                  params)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    draws = iter([_ddpm_draws(k, x) for k, x in zip(keys, batches)])
    step = trainer.make_train_step(
        lambda model, gen, x: losses.ddpm_loss(gen, model, pd, x,
                                               **next(draws)),
        ema_decay=0.995, **ema)
    tr = trainer.Trainer(step, state, iter(batches))
    assert tr.graphed and tr.eager_reason is None
    rows = []
    tr.fit(N, metrics_hook=lambda s, m: rows.append(m))
    for got, w in zip(rows, want):
        assert got["loss"] == pytest.approx(w["loss"], abs=1e-5)
        assert got["grad_norm"] == pytest.approx(w["grad_norm"], abs=1e-5,
                                                 rel=1e-5)
    assert state.step == N and state.optimizer.count == N
    assert state.ema.count == int(jstate.ema.count)

    adam, = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda s: isinstance(
            s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    mu, nu, new, ema_want = (_flat(adam.mu), _flat(adam.nu),
                             _flat(jstate.params), _flat(jstate.ema.params))
    g0 = _flat(jax.grad(jloss)(params, keys[0], jnp.asarray(batches[0])))
    top = max(float(v.abs().max()) for v in g0.values())
    for name, p in state.params.items():
        noise = (g0[name].abs() < 1e-4 * top).numpy()
        for key, want_m, floor in (("exp_avg", mu[name], 1e-4 * top),
                                   ("exp_avg_sq", nu[name], (1e-4 * top) ** 2)):
            got_m = state.optimizer.state[p][key]
            tol = np.where(noise, floor, 1e-4 * float(want_m.abs().max()))
            assert ((got_m - want_m).abs().numpy() <= tol).all(), (name, key)
        upd, upd_want = p.detach() - before[name], new[name] - before[name]
        ulp = np.spacing(np.abs(new[name].numpy()))
        tol = np.where(noise, 2 * N * LR,
                       1e-4 * float(upd_want.abs().max()) + N * ulp)
        assert ((upd - upd_want).abs().numpy() <= tol).all(), name
        ema_tol = np.where(noise, 2 * N * LR, 1e-5)
        assert ((state.ema.params[name] - ema_want[name]).abs().numpy()
                <= ema_tol).all(), name


def _tiny(seed=0, **kw):
    model = create_model(image_size=16, num_channels=16, num_res_blocks=1,
                         in_channels=3, channel_mult=(1, 2), num_heads=1,
                         attention_resolutions="8", dropout=0.1,
                         use_scale_shift_norm=True, dtype=torch.float32,
                         attention_impl="dense", device="cpu", **kw)
    randomize_(model, torch.Generator().manual_seed(seed))
    opt = trainer.make_optimizer(model.parameters(), 1e-3, warmup=2,
                                 grad_clip=1.0)
    return trainer.TrainState.create(model, opt,
                                     torch.Generator().manual_seed(seed + 1))


def _ddpm_step():
    pd = DDPM.create(STEPS)
    return trainer.make_train_step(
        lambda model, gen, x: losses.ddpm_loss(
            gen, lambda xi, t: model(xi, t, generator=gen), pd, x),
        ema_decay=0.9, ema_update_every=2)


def test_graphed_route_equals_the_eager_loop_bitwise():
    """The graphed route (static batch buffers, the host fill and the
    body) against the eager step, with dropout and the loss's draws from
    the state's generator: the metrics, parameters, Adam moments and EMA
    bitwise."""
    out = {}
    for graphed in (True, False):
        state, rows = _tiny(), []
        tr = trainer.Trainer(_ddpm_step(), state, iter(_batches()),
                             graphed=graphed)
        tr.fit(N, metrics_hook=lambda s, m: rows.append(
            (m["loss"], m["grad_norm"])))
        out[graphed] = (state, rows)
    (a, rows_a), (b, rows_b) = out[True], out[False]
    assert rows_a == rows_b
    for (name, p), q in zip(a.model.named_parameters(),
                            b.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(a.ema.params[name], b.ema.params[name]), name
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a.optimizer.state[p][key],
                               b.optimizer.state[q][key]), name


def _old_ema_update(state, new_params, decay, update_every, update_after,
                    warmup):
    """`core/ema.py:ema_update` as it was before the blend became one body
    over device weights: three host branches."""
    state.count += 1
    n = state.count
    if warmup:
        decay = min(decay, (1.0 + n) / (10.0 + n))
    if n <= update_after:
        for k, e in state.params.items():
            e.copy_(new_params[k])
    elif n % update_every == 0:
        names = list(state.params)
        ema = [state.params[k] for k in names]
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, [new_params[k] for k in names],
                            alpha=1.0 - decay)


@pytest.mark.parametrize("update_after,update_every,warmup", [
    (0, 1, True), (3, 2, False), (2, 3, True)])
def test_ema_body_equals_the_eager_branches_bitwise(update_after,
                                                    update_every, warmup):
    """d = 0 (copy through), d = 1 (skipped call) and the (warm-up) decay
    of the one blend body equal the old branches bitwise, over tensors
    whose sizes leave vector tails."""
    gen = torch.Generator().manual_seed(3)
    shapes = [(37,), (8, 16), (5,), (3, 3, 7, 11)]
    p = {f"p{i}": torch.randn(s, generator=gen) for i, s in enumerate(shapes)}
    new, old = EMAState(p), EMAState(p)
    for _ in range(12):
        p = {k: v + 0.1 * torch.randn(v.shape, generator=gen)
             for k, v in p.items()}
        ema_update(new, p, 0.9, update_every, update_after, warmup)
        _old_ema_update(old, p, 0.9, update_every, update_after, warmup)
        assert new.count == old.count
        for k in p:
            assert torch.equal(new.params[k].view(torch.int32),
                               old.params[k].view(torch.int32)), k


def test_declared_eager_routes_report_their_reason():
    """A loss that reads the host inside the step (exact OT's assignment)
    keeps the eager loop and says why; so do graphed=False and a step that
    is not make_train_step's. The eager route trains all the same."""
    torch.manual_seed(0)
    model = train_cifar10.build_model(num_channels=16, device="cpu")
    state = trainer.TrainState.create(
        model, trainer.make_optimizer(model.parameters(), 1e-3),
        torch.Generator().manual_seed(1))
    loss = train_cifar10.make_cfm_loss_fn(
        get_matcher("otcfm", sigma=0.0, method="exact"))
    assert "host" in loss.eager_reason
    rng = np.random.default_rng(2)
    batches = (rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
               for _ in range(2))
    tr = trainer.Trainer(trainer.make_train_step(loss), state, batches)
    assert not tr.graphed and tr.eager_reason == loss.eager_reason
    assert tr.eager_reason in tr.route()
    tr.fit(2)
    assert state.step == 2
    paired = train_cifar10.make_cfm_loss_fn(get_matcher("icfm", sigma=0.0),
                                            paired=True)
    assert getattr(paired, "eager_reason", None) is None
    assert trainer.Trainer(trainer.make_train_step(paired), _tiny(),
                           iter(())).graphed
    assert "graphed=False" in trainer.Trainer(
        _ddpm_step(), _tiny(), iter(()), graphed=False).eager_reason
    assert "make_train_step" in trainer.Trainer(
        lambda s, b: (s, {}), _tiny(), iter(())).eager_reason


def test_checkpointed_models_take_the_graphed_route():
    """The UNet's `use_checkpoint` and the protein denoiser's `remat`
    recompute under torch.utils.checkpoint with their dropout masks drawn
    first, so the recomputation draws nothing: both take the graphed
    route."""
    tr = trainer.Trainer(_ddpm_step(), _tiny(use_checkpoint=True), iter(()))
    assert tr.graphed and tr.eager_reason is None
    assert tr.graphs is not None and "graphed" in tr.route()
    model = GVPDenoiser(max_protein_length=8, n_h_node_feats=(8, 2),
                        n_h_edge_feats=(8, 2), n_conv_layers=1,
                        num_steps=10, remat=True, device="cpu")
    state = trainer.TrainState.create(
        model, trainer.make_optimizer(model.parameters(), 1e-3))
    tr = trainer.Trainer(_ddpm_step(), state, iter(()))
    assert tr.graphed and tr.eager_reason is None


# --- C6 -----------------------------------------------------------------------

def test_fused_attention_function_carries_the_jax_gradient(monkeypatch):
    """The card's route of `flash_attention_fused` (`_FusedAttention`) with
    its launch swapped for the plain function: its gradient is
    `dense_attention`'s and the JAX custom VJP's (`_faf_bwd`, the vjp of
    `_fused_ref`), fp32, to 1e-5."""
    monkeypatch.setattr(attention, "_launch", attention.dense_attention)
    rng = np.random.default_rng(5)
    qkv = rng.standard_normal((2, 16, 3 * 64)).astype(np.float32)
    g = rng.standard_normal((2, 16, 64)).astype(np.float32)
    x = torch.from_numpy(qkv).requires_grad_()
    out = attention._FusedAttention.apply(x, 2)
    assert out.grad_fn is not None
    got, = torch.autograd.grad(out, x, torch.from_numpy(g))
    x2 = torch.from_numpy(qkv).requires_grad_()
    want, = torch.autograd.grad(attention.dense_attention(x2, 2), x2,
                                torch.from_numpy(g))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    _, vjp = jax.vjp(lambda a: jax_attention._fused_ref(a, 2),
                     jnp.asarray(qkv))
    jax_want = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(got.numpy(), jax_want, rtol=0, atol=1e-5)


def test_kernels_without_a_backward_refuse_a_gradient():
    """The GroupNorm and ResBlock kernels have no backward (nor have the
    JAX ones): an input that needs a gradient raises before the launch,
    where the output would otherwise come back detached; under no_grad
    the launch goes on to its own checks (here: not a CUDA tensor)."""
    x = torch.randn(2, 4, 4, 32)
    gamma = torch.ones(32, requires_grad=True)
    beta = torch.zeros(32)
    with pytest.raises(RuntimeError, match="no backward"):
        groupnorm._launch(x, gamma, beta, None, None, 32, 1e-5, "silu")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        groupnorm._launch(x, gamma, beta, None, None, 32, 1e-5, "silu")
    w1 = torch.randn(3, 3, 32, 64, requires_grad=True)
    args = (x, torch.ones(32), torch.zeros(32), w1, torch.zeros(64),
            torch.ones(64), torch.zeros(64), None, torch.zeros(2, 64),
            torch.randn(3, 3, 64, 64), torch.zeros(64),
            torch.randn(32, 64), torch.zeros(64))
    with pytest.raises(RuntimeError, match="no backward"):
        resblock._launch(*args, eps=1e-5, groups=32)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        resblock._launch(*args, eps=1e-5, groups=32)
