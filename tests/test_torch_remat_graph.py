"""Rematerialised and data-parallel training steps on the graphed route
(`train/graph.py`, `Trainer(graphed=True)`), on the CPU, where the body
runs as a plain call; and C7: the protein denoiser's `remat` recomputes
each conv layer with the forward's dropout masks, as flax's `nn.remat`
replays the forward's keys, so rematerialised and plain training agree
bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.protein import denoiser as jden
from tpu_diffusion.protein import sde as jsde
from tpu_diffusion_torch.cli import train_protein
from tpu_diffusion_torch.convert import gvp_denoiser_state_dict_from_flax
from tpu_diffusion_torch.core.schedules import DDPM
from tpu_diffusion_torch.losses import ddpm as losses
from tpu_diffusion_torch.models.unet import create_model, randomize_
from tpu_diffusion_torch.parallel import distributed
from tpu_diffusion_torch.parallel.dryrun import free_port
from tpu_diffusion_torch.parallel.mesh import make_mesh
from tpu_diffusion_torch.protein import data as pdata
from tpu_diffusion_torch.protein import denoiser as pden
from tpu_diffusion_torch.protein import sde as psde
from tpu_diffusion_torch.train import trainer

N = 12
TINY = dict(max_protein_length=N, n_h_node_feats=(16, 4),
            n_h_edge_feats=(16, 4), n_conv_layers=2)
TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = 4  # training steps of each route


def _inputs(seed=0):
    """Positions and mask of 3 chains of ragged lengths, times, and the
    weights of the scalar objective sum(eps * w)."""
    ds = pdata.synthetic_ca_chains(3, max_len=N, min_len=8, seed=seed)
    mask = np.arange(N)[None] < ds.lengths[:, None]
    rng = np.random.default_rng(seed + 1)
    w = rng.standard_normal((3, N, 3)).astype(np.float32)
    return ds.positions, mask, np.array([0.1, 0.5, 0.9], np.float32), w


def _port_batch(pos, mask):
    return psde.ProteinBatch.from_positions(torch.from_numpy(pos),
                                            torch.from_numpy(mask))


def _port_grads(model, pos, mask, t, w, generator=None):
    """(eps, {name: gradient of sum(eps * w)}) of a training forward."""
    model.zero_grad()
    eps = model(_port_batch(pos, mask), torch.from_numpy(t), train=True,
                generator=generator)
    (eps * torch.from_numpy(w)).sum().backward()
    return eps.detach(), {k: p.grad.clone()
                          for k, p in model.named_parameters()}


def _jax_grad_fn(model, pos, mask, t, w):
    """(params, dropout key) -> the gradient of sum(eps * w), jitted."""
    batch = jsde.ProteinBatch.from_positions(jnp.asarray(pos),
                                             jnp.asarray(mask))

    def objective(p, key):
        eps = model.apply(p, batch, jnp.asarray(t), train=True,
                          rngs={"dropout": key})
        return (eps * w).sum()
    return jax.jit(jax.grad(objective))


# --- C7: remat reuses the forward's dropout masks -------------------------


def test_protein_remat_equals_the_plain_model_with_dropout():
    """drop_rate 0.3 in training, one seeded generator per run: the
    rematerialised model's output, every gradient and the generator's final
    state equal the plain model's bitwise (the recomputation used to redraw
    its masks: gradients up to 6.0e-2 apart here, the generator further
    along)."""
    pos, mask, t, w = _inputs()
    plain = pden.GVPDenoiser(**TINY, drop_rate=0.3)
    remat = pden.GVPDenoiser(**TINY, drop_rate=0.3, remat=True)
    remat.load_state_dict(plain.state_dict())
    out = []
    for model in (plain, remat):
        gen = torch.Generator().manual_seed(7)
        eps, grads = _port_grads(model, pos, mask, t, w, gen)
        out.append((eps, grads, gen.get_state()))
    (e0, g0, s0), (e1, g1, s1) = out
    assert torch.equal(e0, e1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert torch.equal(s0, s1)


def test_jax_remat_keeps_the_plain_gradients_with_dropout():
    """The behaviour the port copies: flax's `nn.remat` of the conv layers
    against the plain model, drop_rate 0.3 and one dropout key: the
    gradients agree, the recomputation using the forward's masks. Under
    `jax.jit` XLA fuses the rematerialised backward its own way, so they
    agree to rounding (TOL; 9e-8 here), where other masks move them by
    more than 1e-3 (another key)."""
    pos, mask, t, w = _inputs()
    plain = jden.GVPDenoiser(**TINY, drop_rate=0.3)
    remat = jden.GVPDenoiser(**TINY, drop_rate=0.3, remat=True)
    batch = jsde.ProteinBatch.from_positions(jnp.asarray(pos),
                                             jnp.asarray(mask))
    params = plain.init(jax.random.PRNGKey(0), batch, jnp.asarray(t))
    key = jax.random.PRNGKey(3)
    want = _jax_grad_fn(plain, pos, mask, t, w)(params, key)
    remat_grad = _jax_grad_fn(remat, pos, mask, t, w)
    got = remat_grad(params, key)
    other = remat_grad(params, jax.random.PRNGKey(4))
    moved = 0.0
    for a, b, c in zip(jax.tree_util.tree_leaves(got),
                       jax.tree_util.tree_leaves(want),
                       jax.tree_util.tree_leaves(other)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)
        moved = max(moved, float(np.abs(np.asarray(c) - b).max()))
    assert moved > 1e-3


def test_protein_remat_gradients_match_jax_remat():
    """Dropout 0: the port's rematerialised model against the JAX one
    (`nn.remat`), from the same flax weights: gradients within TOL."""
    pos, mask, t, w = _inputs()
    jm = jden.GVPDenoiser(**TINY, remat=True)
    batch = jsde.ProteinBatch.from_positions(jnp.asarray(pos),
                                             jnp.asarray(mask))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), batch,
                                              jnp.asarray(t)))
    want = gvp_denoiser_state_dict_from_flax(jax.tree.map(
        np.asarray, _jax_grad_fn(jm, pos, mask, t, w)(
            params, jax.random.PRNGKey(0))))
    pm = pden.GVPDenoiser(**TINY, remat=True)
    pm.load_state_dict(gvp_denoiser_state_dict_from_flax(params))
    _, got = _port_grads(pm, pos, mask, t, w)
    assert set(got) == set(want)
    assert max(float(np.abs(np.asarray(v)).max())
               for v in want.values()) > 1e-3
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


# --- the graphed route ------------------------------------------------------


def _unet_state(seed=0, dropout=0.1, mesh=None):
    model = create_model(image_size=16, num_channels=16, num_res_blocks=1,
                         in_channels=3, channel_mult=(1, 2), num_heads=1,
                         attention_resolutions="8", dropout=dropout,
                         use_scale_shift_norm=True, dtype=torch.float32,
                         attention_impl="dense", use_checkpoint=True,
                         device="cpu")
    randomize_(model, torch.Generator().manual_seed(seed))
    opt = trainer.make_optimizer(model.parameters(), 1e-3, warmup=2,
                                 grad_clip=1.0, mesh=mesh)
    return trainer.TrainState.create(model, opt,
                                     torch.Generator().manual_seed(seed + 1))


def _unet_step():
    pd = DDPM.create(25)
    return trainer.make_train_step(
        lambda model, gen, x: losses.ddpm_loss(
            gen, lambda xi, t: model(xi, t, generator=gen), pd, x),
        ema_decay=0.9, ema_update_every=2)


def _images(n=32, seed=3):
    return torch.from_numpy(np.clip(np.random.default_rng(seed)
                                    .standard_normal((n, 16, 16, 3)), -1, 1)
                            .astype(np.float32))


def _unet_batches(seed=3):
    return iter(_images(4 * STEPS, seed).split(4))


def _protein_state(seed=0):
    torch.manual_seed(seed)  # the layers' own initialisation
    model = pden.GVPDenoiser(**TINY, drop_rate=0.3, remat=True)
    opt = trainer.make_optimizer(model.parameters(), 1e-3, grad_clip=1.0)
    return trainer.TrainState.create(model, opt,
                                     torch.Generator().manual_seed(seed + 1))


def _protein_step():
    loss = train_protein.make_loss_fn(psde.HoogeboomGraphSDE(num_steps=20))
    return trainer.make_train_step(loss, ema_decay=0.9)


def _protein_batches(seed=0):
    pos, mask, _, _ = _inputs(seed)
    return iter([{"pos": np.roll(pos, i, 0), "mask": np.roll(mask, i, 0)}
                 for i in range(STEPS)])


def _same_state(a, b):
    for (name, p), q in zip(a.model.named_parameters(),
                            b.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(a.ema.params[name], b.ema.params[name]), name
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a.optimizer.state[p][key],
                               b.optimizer.state[q][key]), (name, key)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _fit(make_state, step, batches, graphed, **kw):
    state, rows = make_state(), []
    tr = trainer.Trainer(step(), state, batches(), graphed=graphed, **kw)
    tr.fit(STEPS, metrics_hook=lambda s, m: rows.append(
        (m["loss"], m["grad_norm"])))
    return tr, rows


MODELS = {"unet_use_checkpoint": (_unet_state, _unet_step, _unet_batches),
          "protein_remat": (_protein_state, _protein_step, _protein_batches)}


@pytest.mark.parametrize("name", list(MODELS))
def test_rematerialised_models_take_the_graphed_route(name):
    """A `use_checkpoint` UNet (dropout 0.1) and a `remat` GVP denoiser
    (drop_rate 0.3) take the graphed route, and its steps through `fit`
    equal the eager loop's bitwise: the metrics, parameters, Adam moments,
    EMA and the generator."""
    make_state, step, batches = MODELS[name]
    graphed, got = _fit(make_state, step, batches, True)
    eager, want = _fit(make_state, step, batches, False)
    assert graphed.graphed and graphed.eager_reason is None
    assert "graphed" in graphed.route() and not eager.graphed
    assert got == want
    _same_state(graphed.state, eager.state)


def _protein_sampler(gen):
    pos, mask, _, _ = _inputs()
    pos, mask = torch.from_numpy(pos), torch.from_numpy(mask)
    idx = torch.randint(0, 3, (3,), generator=gen)
    return {"pos": pos[idx], "mask": mask[idx]}


def _unet_sampler(gen, images=_images()):
    return images[torch.randint(0, len(images), (4,), generator=gen)]


SAMPLERS = {"unet_use_checkpoint": _unet_sampler,
            "protein_remat": _protein_sampler}


@pytest.mark.parametrize("name", list(MODELS))
def test_rematerialised_models_fit_scanned_graphed(name):
    """The same through `fit_scanned` (the sampler's draws inside the
    body): the graphed route at two chunkings equals the eager loop
    bitwise."""
    make_state, step, _ = MODELS[name]
    finals = []
    for graphed, chunk in ((False, STEPS), (True, STEPS), (True, 3)):
        rows = []
        tr = trainer.Trainer(step(), make_state(), iter(()),
                             graphed=graphed)
        assert tr.graphed == graphed
        tr.fit_scanned(STEPS, SAMPLERS[name], chunk=chunk, base_seed=5,
                       metrics_hook=lambda s, m: rows.extend(
                           zip(m["loss_trace"], m["grad_norm_trace"])))
        finals.append((tr.state, rows))
    for state, rows in finals[1:]:
        assert rows == finals[0][1]
        _same_state(state, finals[0][0])


# --- a one-rank process group -------------------------------------------------


@pytest.fixture
def one_rank_world():
    assert distributed.initialize_distributed(
        f"127.0.0.1:{free_port()}", 1, 0, device="cpu", timeout=120)
    yield
    dist.destroy_process_group()


def test_one_rank_world_takes_the_graphed_route(one_rank_world):
    """A Trainer over the mesh of a one-rank gloo world (a process group
    and a DeviceMesh: the gradients and the loss all-reduced over "data"
    in the body) takes the graphed route, and its steps equal the eager
    route's in the same world bitwise; its route line names the
    all-reduce."""
    runs = {}
    for graphed in (True, False):
        mesh = make_mesh()
        assert mesh.device_mesh is not None
        tr, rows = _fit(lambda: _unet_state(mesh=mesh), _unet_step,
                        _unet_batches, graphed, mesh=mesh)
        runs[graphed] = (tr, rows)
    (g, got), (e, want) = runs[True], runs[False]
    assert g.graphed and g.eager_reason is None
    assert "all-reduce over 1 'data' rank(s)" in g.route()
    assert got == want
    _same_state(g.state, e.state)


def test_a_model_axis_keeps_the_eager_route(one_rank_world):
    """A "model" axis of more than one rank (the tensor-parallel gathers,
    the sharded gradients' norm, the ring) keeps the eager route and says
    why: here the one-rank mesh with its "model" size set to 2, which
    only the Trainer's route decision reads."""
    mesh = make_mesh()
    mesh.shape = {**mesh.shape, "model": 2}
    tr = trainer.Trainer(_unet_step(), _unet_state(mesh=mesh), iter(()),
                         mesh=mesh)
    assert not tr.graphed and tr.graphs is None
    assert "'model' axis of 2 ranks" in tr.eager_reason
    assert "multi-card" in tr.route()
