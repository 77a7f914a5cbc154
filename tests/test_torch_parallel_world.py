"""A 2-rank gloo world (data 1 x model 2), spawned here, against the port's
replicated step and the JAX package's.

One spawn runs, on each rank (tests/torch_parallel_worker.py): the
super-resolution CFM train step at num_channels 8 through the CLI's builder
and loss with tensor parallelism (parameters, EMA and Adam moments sharded
over "model") and sequence parallelism (the ring), a checkpoint of its
state restored in place, the dry run (`parallel/dryrun.py`), the same step
on a (data 2 x model 1) mesh with each rank's slice of the draws handed in,
and the device-cache samplers on a (data 2) mesh. The JAX replicated step
on the same converted weights and draws runs here, as does the port's
replicated step. Both sides run in fp32, so the steps are held far tighter
than tests/test_sp_tp_surface.py:59-69's bf16 5e-3: the loss and gradient
norm to 1e-5, and each weight's first Adam moment and update per leaf
(`assert_step_matches`). The `slow` test runs the dry run on 4 ranks (data
2 x model 2), as the JAX package's slow multi-device tests do; the 2-rank
world is its fast counterpart.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_worker as worker
from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.cli import train_cfm_conditional as jax_cfmc
from tpu_diffusion.losses import cfm as jax_cfm
from tpu_diffusion.models import unet as jax_unet
from tpu_diffusion.train.trainer import make_optimizer as jax_optimizer
from tpu_diffusion_torch.convert import wrapper_state_dict_from_flax
from tpu_diffusion_torch.data.device_cache import (make_cfm_pair_sampler,
                                                   make_protein_sampler,
                                                   sample_batch)
from tpu_diffusion_torch.parallel import dryrun

SEED = 3
# the loss and the gradient norm, relative: fp32 on both sides (measured
# 2.1e-7 against the JAX step)
RTOL = 1e-5
# the first Adam moment (0.1 x the clipped gradient): 1e-4 of each leaf's
# largest entry, plus 1e-5 of the model's largest for the gradients that
# are zero in exact arithmetic and rounding noise here (the bias of a conv
# that feeds a GroupNorm of one-channel groups: measured 1.7e-6 of it)
MU_RTOL, MU_FLOOR = 1e-4, 1e-5
# the update (new - initial weights): 1e-4 of each leaf's largest update
# plus one fp32 spacing of its largest weight (the update is read as the
# difference of two fp32 weights), on the elements whose gradient stands
# clear of rounding noise: a first Adam step moves a weight by about
# lr * sign(g), so where g is noise, so is the update's sign
UPDATE_RTOL, CLEAR_OF_NOISE = 1e-4, 1e-4


def _flax_params(jm, init_args, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *init_args)

    def draw(path, sd):
        leaf = path[-1].key
        if leaf == "kernel":
            v = rng.standard_normal(sd.shape) / np.sqrt(np.prod(sd.shape[:-1]))
        elif leaf == "scale":
            v = 1 + 0.1 * rng.standard_normal(sd.shape)
        else:
            v = 0.1 * rng.standard_normal(sd.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _np(tree):
    return {k: v.numpy() for k, v in tree.items()}


@pytest.fixture(scope="module")
def world():
    """The world's per-rank results, the port's replicated step and the JAX
    replicated step (loss, grad norm, updated weights in the port's
    layout), on one set of weights, images and draws."""
    dim = worker.DIM
    jm = jax_unet.SuperResModelWrapper(dim=dim, num_channels=8,
                                       attention_resolutions="14",
                                       attention_impl="xla",
                                       dtype=jnp.float32)
    params = _flax_params(jm, (jnp.zeros((1,)), jnp.zeros((1,) + dim),
                               jnp.zeros((1,) + dim)), 1)
    x1 = np.clip(np.random.default_rng(2).standard_normal((8,) + dim),
                 -1, 1).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jcond = jax_cfmc.make_condition_fn("superres", dim, 14, worker.PAD)
    # the JAX loss's draws, handed to the port's loss
    k0, km, kc = jax.random.split(key, 3)
    kt, kx = jax.random.split(km)
    draws = {"x0": np.array(jax.random.normal(k0, x1.shape)),
             "t": np.array(jax.random.uniform(kt, (8,))),
             "eps": np.array(jax.random.normal(kx, x1.shape)),
             "cond": np.array(jcond(kc, jnp.asarray(x1)))}
    state_dict = _np(wrapper_state_dict_from_flax(params))
    # the ranks run while the JAX step compiles here
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(dryrun.run_world,
                            "torch_parallel_worker:two_rank_world", 2, "cpu",
                            (state_dict, x1, draws, SEED))
        loss = jax_cfmc.make_loss_fn(
            jm, jax_cfm.get_matcher("icfm", sigma=0.0), jcond, "superres",
            False, worker.PAD)
        jloss, grads = jax.jit(jax.value_and_grad(loss))(params, key,
                                                         jnp.asarray(x1))
        tx = jax_optimizer(1e-3, warmup=0, grad_clip=1.0)

        def update(p, g):
            upd, opt = tx.update(g, tx.init(p), p)
            adam, = [s for s in jax.tree_util.tree_leaves(
                opt, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
                if isinstance(s, optax.ScaleByAdamState)]
            return optax.apply_updates(p, upd), adam.mu

        new, mu = jax.jit(update)(params, grads)
        ranks = ranks.result()
    return {"ranks": ranks, "initial": state_dict,
            "replicated": worker.replicated_step(state_dict, x1, draws),
            "jax": {"loss": float(jloss),
                    "grad_norm": float(optax.global_norm(grads)),
                    "params": _np(wrapper_state_dict_from_flax(new)),
                    "mu": _np(wrapper_state_dict_from_flax(mu))}}


def assert_step_matches(got, want, initial):
    """One rank's step against a replicated step from the same weights:
    the loss and gradient norm, then per leaf the (gathered) first Adam
    moment and the update, at the tolerances above; the update is checked
    on at least 90% of all weights."""
    assert got["loss"] == pytest.approx(want["loss"], rel=RTOL)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=RTOL)
    assert got["params"].keys() == want["params"].keys() == want["mu"].keys()
    assert got["mu"].keys() == want["mu"].keys()
    scale = max(np.abs(mu).max() for mu in want["mu"].values())
    clear = total = 0
    for k, mu in want["mu"].items():
        np.testing.assert_allclose(
            got["mu"][k], mu, rtol=0,
            atol=MU_RTOL * np.abs(mu).max() + MU_FLOOR * scale, err_msg=k)
        update = got["params"][k] - initial[k]
        want_update = want["params"][k] - initial[k]
        mask = np.abs(mu) > CLEAR_OF_NOISE * scale
        np.testing.assert_allclose(
            update[mask], want_update[mask], rtol=0,
            atol=(UPDATE_RTOL * np.abs(want_update).max()
                  + np.spacing(np.abs(initial[k]).max())), err_msg=k)
        clear += mask.sum()
        total += mask.size
    assert clear >= 0.9 * total, (clear, total)


@pytest.mark.parametrize("reference", ["replicated", "jax"])
def test_tp_sp_step_matches_the_replicated_step(world, reference):
    """Both ranks of the (data 1 x model 2) TP+SP step: the loss, the
    gradient norm, and per leaf the gathered first Adam moment and update
    equal the replicated step's (`assert_step_matches`)."""
    for rank in world["ranks"]:
        assert_step_matches(rank, world[reference], world["initial"])


@pytest.mark.parametrize("reference", ["replicated", "jax"])
def test_data_parallel_step_matches_the_replicated_step(world, reference):
    """Both ranks of a (data 2 x model 1) step, each training on its half
    of the global batch with its half of the draws handed in: the averaged
    gradients make the replicated step on the whole batch."""
    for rank in world["ranks"]:
        got = rank["data_parallel"]
        assert got["mesh"] == {"data": 2, "model": 1}
        assert_step_matches(got, world[reference], world["initial"])


def test_ranks_agree_and_match_the_port_closely(world):
    """The two "model" ranks hold the same gathered weights, and the ring
    changes only the order of the sums: the loss within 1e-5 of the
    port's replicated step."""
    a, b = world["ranks"]
    assert a["loss"] == b["loss"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])
    assert a["loss"] == pytest.approx(world["replicated"]["loss"], rel=1e-5)


def test_tp_stores_under_0_8_of_a_replica(world):
    for rank in world["ranks"]:
        assert rank["mesh"] == {"data": 1, "model": 2}
        assert rank["n_sharded"] == rank["n_trainer_sharded"] > 0
        assert rank["stored_bytes"] < 0.8 * rank["replica_bytes"], rank


def test_restore_is_bitwise_and_still_sharded(world):
    for rank in world["ranks"]:
        assert rank["restore_step"] == 1
        assert rank["restore_bitwise"] and rank["restore_shapes_kept"]


def test_ring_engaged_wherever_the_tokens_divide(world):
    """The 14x14 blocks (196 tokens) run the ring; the middle block's 7x7
    (49 tokens, odd) runs its local attention, logged as the JAX package
    logs it."""
    for rank in world["ranks"]:
        decisions = rank["decisions"]
        assert {(d["tokens"], d["engaged"], d["reason"], d["axis_size"])
                for d in decisions} == {
            (196, True, "ring", 2),
            (49, False, "tokens not divisible by axis", 2)}


def test_dry_run_on_two_ranks(world):
    for rank in world["ranks"]:
        got = rank["dryrun"]
        assert got["mesh"] == {"data": 1, "model": 2}
        assert got["n_sharded"] == 43 and got["sp_engaged"] == 4
        assert got["restore_bitwise"] and np.isfinite(got["loss"])
        assert got["line"].startswith(
            "[dryrun_multichip] mesh={'data': 1, 'model': 2} "
            "tp_sharded_params=43 sp=ring(x4) steps=2 restore=bitwise "
            "scanned=4 loss=")
        assert got["line"].endswith(" ok")


def test_batch_draws_do_not_depend_on_the_rank_count(world):
    """The device-cache samplers on a (data 2) mesh: the ranks' slices put
    together are the one-process draws."""
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(rng.normal(size=(16, 4, 4, 2))
                              .astype(np.float32))
    g = torch.Generator().manual_seed(SEED)
    batch = sample_batch(images, g, 8, flip=True)
    x0, x1 = make_cfm_pair_sampler(images, 8)(g)
    protein = make_protein_sampler(rng.normal(size=(6, 5, 3)),
                                   rng.integers(2, 6, 6), 8, "cpu")(g)
    want = [t.numpy() for t in (batch, x0, x1, protein["pos"],
                                protein["mask"])]
    got = [np.concatenate(parts) for parts in
           zip(*(rank["samples"]["slices"] for rank in world["ranks"]))]
    assert all(g.shape[0] == 8 for g in got)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_host_local_to_global_assembles_the_batch(world):
    """Each rank's 4-image slice, assembled into one DTensor sharded over
    "data": the global [8, ...] batch on every rank."""
    for rank in world["ranks"]:
        got = rank["samples"]
        assert got["global_shape"] == (8, 4, 4, 2)
        np.testing.assert_array_equal(
            got["global"], np.concatenate([r["samples"]["slices"][0]
                                           for r in world["ranks"]]))


@pytest.mark.slow
def test_dry_run_on_four_ranks(capfd):
    ranks = dryrun.main(["--nproc", "4", "--device", "cpu"])
    assert [r["mesh"] for r in ranks] == [{"data": 2, "model": 2}] * 4
    assert all(r["n_sharded"] == 43 and r["sp_engaged"] == 4
               and r["restore_bitwise"] for r in ranks)
    assert len({r["line"] for r in ranks}) == 1
    assert "[dryrun_multichip] mesh={'data': 2, 'model': 2} " in \
        capfd.readouterr().out
