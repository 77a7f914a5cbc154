"""The port's parallelism (`tpu_diffusion_torch/parallel/`) against the JAX
package's, in one process.

The layout rule (`leaf_spec`) and its application through the converter's
layouts (`params_shardings` on converted weights selects the leaves and the
flax axes the JAX `params_shardings` selects); the ring attention with its
rotation simulated over 2, 4 and 8 shards against the JAX ring on the
8-device CPU mesh and against dense attention, values and gradients; the
refusals and their messages; the decision log; and a one-rank gloo world
in this process, whose meshed CLI run equals the plain run bitwise (the CPU
counterpart of `chip_smoke.py`'s `parallel` phase). The multi-rank worlds
are in tests/test_torch_parallel_world.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from torch_twin import TINY, one_torch_thread  # noqa: F401
from tpu_diffusion.models.unet import UNetModel as JaxUNet
from tpu_diffusion.models.unet import UNetModelWrapper as JaxWrapper
from tpu_diffusion.parallel import distributed as jax_distributed
from tpu_diffusion.parallel import mesh as jax_mesh
from tpu_diffusion.parallel import sp as jax_sp
from tpu_diffusion.parallel import tp as jax_tp
from tpu_diffusion_torch.cli import train_cfm_conditional as cfmc
from tpu_diffusion_torch.convert import (unet_state_dict_from_flax,
                                         wrapper_state_dict_from_flax)
from tpu_diffusion_torch.models.unet import UNetModel, UNetModelWrapper
from tpu_diffusion_torch.parallel import distributed, mesh, sp, tp
from tpu_diffusion_torch.parallel.dryrun import free_port

TOL = 1e-5  # fp32 on both sides; only the order of the sums differs


class FakeMesh(mesh.Mesh):
    """A mesh shape without a process group, for the layout rule and the
    refusals, which read only the shape (and this rank's index)."""

    def __init__(self, data=1, model=1, index=0):
        super().__init__()
        self.shape = {"data": data, "model": model}
        self._index = index

    def index(self, axis):
        return self._index if axis == "data" else 0


# --- tensor parallelism: the layout rule --------------------------------


@pytest.mark.parametrize("shape", [(3, 3, 16, 32), (3, 3, 32, 3), (16,),
                                   (1, 16, 48), (64, 10), (10, 64), (3, 5),
                                   (4, 4, 4, 4), (3, 3, 7, 9)])
@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("min_elems", [64, 1024])
def test_leaf_spec_matches_jax(shape, model_size, min_elems):
    assert tp.leaf_spec(shape, model_size, min_elems) == tuple(
        jax_tp.leaf_spec(shape, model_size, min_elems))


def _labelled_tree(shapes):
    """A flax tree whose leaf i is filled with i + 1: after conversion, a
    torch tensor's value names the flax leaf it came from."""
    paths = []

    def label(path, sd):
        paths.append(tuple(p.key for p in path))
        return np.full(sd.shape, len(paths), np.float32)

    return jax.tree_util.tree_map_with_path(label, shapes), paths


def _jax_spec_by_leaf(tree, model_size, min_elems):
    specs = jax_tp.params_shardings(
        jax_mesh.make_mesh(model=model_size), tree, min_elems)
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    return {tuple(p.key for p in path): tuple(s.spec) for path, s in flat}


# flax axis -> torch dim of a kernel, by its rank (convert.py's layouts)
TORCH_DIM = {4: {3: 0, 2: 1, 0: 2, 1: 3},   # HWIO -> OIHW
             3: {2: 0, 1: 1},               # (1, C, K) -> [K, C]
             2: {1: 0, 0: 1}}               # Dense [in, out] -> [out, in]


@pytest.mark.parametrize("kind", ["unet", "class_wrapper"])
@pytest.mark.parametrize("model_size,min_elems", [(2, 1024), (2, 64),
                                                  (4, 64)])
def test_params_shardings_select_the_jax_leaves_and_axes(kind, model_size,
                                                         min_elems):
    """Every converted parameter is sharded exactly where the JAX rule
    shards its flax leaf, on the torch dim of the flax axis JAX picks: the
    output conv [3,3,C,3] on its input channels (torch dim 1), the class
    embedding [10, 4C] on its columns (torch dim 1)."""
    if kind == "unet":
        jm = JaxUNet(dtype=jnp.float32, **TINY)
        init = (jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)))
        port = UNetModel(dtype=torch.float32, device="cpu", **TINY)
        convert = unet_state_dict_from_flax
    else:
        cfg = dict(dim=(16, 16, 3), num_channels=16, num_res_blocks=1,
                   channel_mult=(1, 2), attention_resolutions="8",
                   num_heads=2, num_classes=10)
        jm = JaxWrapper(dtype=jnp.float32, attention_impl="xla", **cfg)
        init = (jnp.zeros((1,)), jnp.zeros((1, 16, 16, 3)),
                jnp.zeros((1,), jnp.int32))
        port = UNetModelWrapper(dtype=torch.float32, device="cpu", **cfg)
        convert = wrapper_state_dict_from_flax
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *init)
    tree, paths = _labelled_tree(shapes)
    port.load_state_dict(convert(tree))
    want = _jax_spec_by_leaf(tree, model_size, min_elems)
    got = tp.params_shardings(FakeMesh(model=model_size), port, min_elems)
    seen = set()
    for name, p in port.named_parameters():
        path = paths[int(p.detach().flatten()[0]) - 1]
        seen.add(path)
        spec = want[path]
        if not spec:
            assert got[name] is None, (name, path)
            continue
        axis = spec.index("model")
        # an embedding table keeps its layout
        dims = ({0: 0, 1: 1} if path[-1] == "embedding"
                else TORCH_DIM[len(spec)])
        assert got[name] == dims[axis], (name, path, spec)
    assert seen == set(paths)
    n_sharded = sum(d is not None for d in got.values())
    assert n_sharded == sum(bool(s) for s in want.values()) > 0
    if min_elems == 64:
        assert got["conv_out.weight" if kind == "unet"
                   else "net.conv_out.weight"] == 1
        if kind == "class_wrapper":
            assert got["net.class_emb.weight"] == 1


# --- sequence parallelism: the ring ---------------------------------------


def _dense(q, k, v):
    s = torch.einsum("...qd,...kd->...qk", q * q.shape[-1] ** -0.5, k)
    return torch.softmax(s, -1) @ v


@pytest.mark.parametrize("n", [2, 4, 8])
def test_simulated_ring_matches_jax_ring_and_dense(n):
    """The port's ring over n shards (the rotation simulated on a list)
    against the JAX `sequence_parallel_attention` on an (8/n x n) mesh of
    the 8 CPU devices and against dense attention: the output and the
    gradients of <out, g> with respect to q, k and v, fp32, 1e-5."""
    rng = np.random.default_rng(n)
    q, k, v, g = (rng.standard_normal((2, 4, 64, 16)).astype(np.float32)
                  for _ in range(4))
    jmesh = jax_mesh.make_mesh(data=8 // n, model=n)

    def jax_objective(a, b, c):
        out = jax_sp.sequence_parallel_attention(a, b, c, jmesh)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jax_objective, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = sp.simulated_ring_attention(tq, tk, tv, n)
    (out * torch.from_numpy(g)).sum().backward()
    dq, dk, dv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    dense = _dense(dq, dk, dv)
    (dense * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out.detach().numpy(), dense.detach().numpy(),
                               atol=TOL, rtol=TOL)
    for got, want, plain in zip((tq, tk, tv), jgrads, (dq, dk, dv)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got.grad.numpy(), plain.grad.numpy(),
                                   atol=TOL, rtol=TOL)


def test_ring_keeps_bf16_inputs_type():
    """A bf16 ring accumulates in fp32 and returns bf16 (as the JAX ring
    returns q's type); it agrees with fp32 dense attention to bf16's
    rounding."""
    q, k, v = (torch.randn(2, 2, 32, 8, generator=torch.Generator()
                           .manual_seed(i)) for i in range(3))
    out = sp.simulated_ring_attention(*(x.bfloat16() for x in (q, k, v)), 4)
    assert out.dtype == torch.bfloat16
    want = _dense(*(x.bfloat16().float() for x in (q, k, v)))
    assert (out.float() - want).abs().max() <= 1e-2 * want.abs().max()


# --- refusals and the decision log ----------------------------------------


def test_indivisible_tokens_are_refused_and_logged_as_jax_does():
    q = torch.zeros(1, 2, 30, 8)
    with pytest.raises(ValueError, match="token count 30 not divisible by "
                                         "mesh axis model=4"):
        sp.sequence_parallel_attention(q, q, q, FakeMesh(model=4))
    with pytest.raises(ValueError):
        sp.simulated_ring_attention(q, q, q, 4)
    sp.reset_sp_decisions()
    jax_sp.reset_sp_decisions()
    jq = jnp.zeros((1, 2, 30, 8))
    jmesh = jax_mesh.make_mesh(data=2, model=4)
    for port_mesh, jm in ((FakeMesh(model=4), jmesh), (None, None),
                          (mesh.make_mesh(), jax_mesh.make_mesh(model=1))):
        assert sp.maybe_sequence_parallel(q, q, q, port_mesh) is None
        assert jax_sp.maybe_sequence_parallel(jq, jq, jq, jm) is None
    got, want = sp.sp_decisions(), jax_sp.sp_decisions()
    assert [sorted(d) for d in got] == [sorted(d) for d in want]
    assert [d["reason"] for d in got] == [d["reason"] for d in want] == [
        "tokens not divisible by axis", "no mesh axis", "no mesh axis"]
    assert [d["axis_size"] for d in got[:2]] == [4, 0]


def _message(fn, *args, **kw):
    with pytest.raises(ValueError) as err:
        fn(*args, **kw)
    return str(err.value)


@pytest.mark.parametrize("kw", [dict(model=2), dict(data=2),
                                dict(data=1, model=3), dict(devices=[0, 1])])
def test_make_mesh_errors_are_the_jax_ones(kw):
    """In one process the world is one rank, as the JAX call over one
    device."""
    jkw = dict(kw)
    if "devices" in jkw:
        jkw["devices"] = jax.devices()[:len(kw["devices"])]
        jkw["data"] = 3
        kw = {**kw, "data": 3}
    else:
        jkw["devices"] = jax.devices()[:1]
    assert _message(mesh.make_mesh, **kw) == _message(jax_mesh.make_mesh,
                                                      **jkw)


def test_one_process_mesh_needs_no_process_group():
    m = mesh.make_mesh()
    assert not dist.is_initialized()
    assert m.shape == {"data": 1, "model": 1} and m.group("model") is None
    batch = {"x": np.arange(6), "y": (np.ones(6), np.zeros(6))}
    assert mesh.shard_batch(m, batch) is batch
    assert mesh.replicate(m, batch) is batch
    assert distributed.host_local_to_global(m, batch) is batch
    assert distributed.process_batch_slice(6) == slice(0, 6)
    assert not distributed.initialize_distributed()
    assert mesh.batch_sharding(m) == [Shard(0), Replicate()]
    assert mesh.replicated(m) == [Replicate(), Replicate()]


def test_remainders_are_refused_with_the_jax_messages(monkeypatch):
    assert _message(mesh.local_batch_size, 7, FakeMesh(data=2)) == _message(
        jax_mesh.local_batch_size, 7, jax_mesh.make_mesh(data=2, model=4))
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    assert _message(distributed.process_batch_slice, 7,
                    FakeMesh(data=2)) == _message(
        jax_distributed.process_batch_slice, 7)
    assert mesh.local_batch_size(8, FakeMesh(data=2)) == 4
    assert distributed.process_batch_slice(8, FakeMesh(data=2, index=1)) \
        == slice(4, 8)
    sharded = mesh.shard_batch(FakeMesh(data=2, index=1),
                               (np.arange(8), np.arange(16).reshape(8, 2)))
    assert sharded[0].tolist() == [4, 5, 6, 7]
    assert sharded[1].shape == (4, 2)
    with pytest.raises(ValueError, match="not divisible by process_count=2"):
        mesh.shard_batch(FakeMesh(data=2), np.arange(7))


# --- a one-rank world in this process --------------------------------------


@pytest.fixture
def one_rank_world():
    assert distributed.initialize_distributed(
        f"127.0.0.1:{free_port()}", 1, 0, device="cpu", timeout=120)
    yield
    dist.destroy_process_group()


CFM_ARGS = ["--task", "superres", "--dataset", "mnist", "--model", "icfm",
            "--num_steps", "3", "--batch_size", "8", "--warmup", "1",
            "--eval_batches", "1", "--eval_batch_size", "8",
            "--eval_method", "euler", "--eval_every_div", "0",
            "--num_channels", "8", "--eval_ode_steps", "2", "--device", "cpu"]


def test_one_rank_world_runs_the_cli_as_the_plain_run(tmp_path,
                                                      one_rank_world,
                                                      monkeypatch):
    """`train_cfm_conditional --sequence_parallel --model_axis 1` in a
    one-rank gloo world (a process group, a DeviceMesh, every collective a
    one-rank call) against the same run with no process group: the losses,
    the gradient norms and the final parameters bitwise equal, and every
    attention call logged "no mesh axis"."""
    traces = {}

    class Traced(cfmc.Trainer):
        def fit(self, num_steps, metrics_hook=None):
            trace = traces.setdefault(self.mesh.device_mesh is not None, [])
            return super().fit(num_steps, metrics_hook=lambda s, m: trace
                               .append((m["loss"], m["grad_norm"])))

    monkeypatch.setattr(cfmc, "Trainer", Traced)
    sp.reset_sp_decisions()
    meshed = cfmc.main(CFM_ARGS + ["--output_dir", str(tmp_path / "mesh"),
                                   "--sequence_parallel", "--model_axis",
                                   "1"])
    decisions = sp.sp_decisions()
    dist.destroy_process_group()
    plain = cfmc.main(CFM_ARGS + ["--output_dir", str(tmp_path / "plain")])
    # the fixture's teardown destroys a group again
    distributed.initialize_distributed(
        f"127.0.0.1:{free_port()}", 1, 0, device="cpu", timeout=120)
    assert len(traces[True]) == 3 and traces[True] == traces[False]
    assert decisions and {d["reason"] for d in decisions} == {"no mesh axis"}
    for (name, a), b in zip(meshed["state"].params.items(),
                            plain["state"].params.values()):
        assert torch.equal(a, b), name
    assert meshed["results"] == plain["results"]
