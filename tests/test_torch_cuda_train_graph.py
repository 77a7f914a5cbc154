"""The training step as a captured CUDA graph (`train/graph.py`), its one
fused update launch (`kernels/adam.py`), and the fused-QKV attention's
gradient on the card, at a small size.

These tests need a CUDA card and skip without one (a capture has no CPU
mode, the kernels have none either). The file imports nothing of JAX, so
on a machine with a card and without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_train_graph.py
"""

import pytest
import torch

from tpu_diffusion_torch.core.schedules import DDPM
from tpu_diffusion_torch.kernels import adam, attention
from tpu_diffusion_torch.losses.ddpm import ddpm_loss
from tpu_diffusion_torch.models.unet import create_model, randomize_
from tpu_diffusion_torch.sampling import ancestral
from tpu_diffusion_torch.sampling.graph import WARMUP, GraphCache
from tpu_diffusion_torch.train import trainer

STEPS = 6


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def deterministic():
    """cuDNN's default backward algorithms sum with atomics even in fp32."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def _state(cuda, dtype=torch.float32, attention_impl="dense", seed=0,
           use_checkpoint=False):
    model = create_model(image_size=16, num_channels=32, num_res_blocks=1,
                         in_channels=3, channel_mult=(1, 2), num_heads=1,
                         attention_resolutions="8", dropout=0.1,
                         use_scale_shift_norm=True, dtype=dtype,
                         attention_impl=attention_impl,
                         use_checkpoint=use_checkpoint, device=cuda)
    randomize_(model, torch.Generator().manual_seed(seed))
    opt = trainer.make_optimizer(model.parameters(), 1e-3, warmup=2,
                                 grad_clip=1.0)
    return trainer.TrainState.create(
        model, opt, torch.Generator(cuda).manual_seed(seed + 1))


def _step(device):
    ddpm = DDPM.create(1000).to(device)

    def loss(model, gen, x):
        return ddpm_loss(gen, lambda xi, t: model(xi, t, generator=gen),
                         ddpm, x)
    return trainer.make_train_step(loss, ema_decay=0.9, ema_update_every=2)


def _batches(n, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((4, 16, 16, 3), generator=gen).numpy()
            for _ in range(n)]


def _fit(cuda, graphed, **kw):
    state = _state(cuda, **kw)
    rows = []
    tr = trainer.Trainer(_step(cuda), state, iter(_batches(STEPS)),
                         graphed=graphed)
    tr.fit(STEPS, metrics_hook=lambda s, m: rows.append(
        (m["loss"], m["grad_norm"])))
    return tr, rows


def _same_state(a, b):
    for (name, p), q in zip(a.model.named_parameters(),
                            b.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(a.ema.params[name], b.ema.params[name]), name
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a.optimizer.state[p][key],
                               b.optimizer.state[q][key]), (name, key)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.cuda
def test_cuda_graphed_fit_equals_eager_fp32(cuda, deterministic):
    """fp32: the graphed steps (the first WARMUP eager, then one replay a
    step) equal the eager loop bitwise: the metric traces, the parameters,
    the Adam moments and the EMA, dropout and the loss's draws included."""
    eager, want = _fit(cuda, graphed=False)
    graphed, got = _fit(cuda, graphed=True)
    assert graphed.graphed and not eager.graphed
    assert got == want
    _same_state(graphed.state, eager.state)
    entry, = graphed.graphs.captured().values()
    assert entry.replays == STEPS - WARMUP


@pytest.mark.cuda
def test_cuda_marked_step_equals_eager_and_its_splits_add_up(cuda,
                                                             deterministic):
    """The step graph holds the "forward" and "backward" markers; with the
    recorder on the graphed steps still equal the eager loop bitwise, and
    every replay (each step's metrics read on the host) is read back, its
    splits adding up to its event time within 20 us."""
    eager, want = _fit(cuda, graphed=False)
    rows = []
    tr = trainer.Trainer(_step(cuda), _state(cuda), iter(_batches(STEPS)))
    events = []
    tr.graphs.events = events
    tr.fit(STEPS, metrics_hook=lambda s, m: rows.append(
        (m["loss"], m["grad_norm"])))
    tr.graphs.events = None
    assert rows == want
    _same_state(tr.state, eager.state)
    entry, = tr.graphs.captured().values()
    assert [n for n, _ in entry.markers] == ["forward", "backward"]
    rec = tr.recorder
    assert len(events) == STEPS - WARMUP == len(rec.reads)
    assert not rec.unread
    replays = {t: (s, e) for t, _, _, s, e in rec.replays}
    for t, label, _, names, segs in rec.reads:
        s, e = replays[t]
        assert label == "step/1"
        assert names == ["forward", "backward", "end"] and min(segs) > 0
        assert abs(sum(segs) - s.elapsed_time(e)) <= 0.020
    steps = [r for n, *_, r, _ in rec.spans if n == "step"]
    assert steps == list(range(1, STEPS + 1))


@pytest.mark.cuda
def test_cuda_graphed_fit_scanned_equals_eager(cuda, deterministic):
    """fit_scanned's sampler and draws inside the graph: equal to the eager
    loop bitwise, and the same for any chunking."""
    images = torch.randn((32, 16, 16, 3), generator=torch.Generator()
                         .manual_seed(5)).to(cuda)

    def sample(gen):
        idx = torch.randint(0, 32, (4,), generator=gen, device=cuda)
        return images[idx]

    finals = []
    for graphed, chunk in ((False, 6), (True, 6), (True, 4)):
        rows = []
        tr = trainer.Trainer(_step(cuda), _state(cuda), iter(()),
                             graphed=graphed)
        tr.fit_scanned(STEPS, sample, chunk=chunk, base_seed=9,
                       metrics_hook=lambda s, m: rows.extend(m["loss_trace"]))
        finals.append((tr.state, rows))
    for state, rows in finals[1:]:
        assert rows == finals[0][1]
        _same_state(state, finals[0][0])


@pytest.mark.cuda
def test_cuda_live_model_sees_graphed_updates(cuda, deterministic):
    """A replay bumps the parameters' versions: a no-grad forward of the
    live bf16 model recasts its weights, and a sampler chain keyed on it is
    captured again; both equal the same after eager steps."""
    xT = torch.randn((4, 16, 16, 3), generator=torch.Generator()
                     .manual_seed(7)).to(cuda)
    out = {}
    for graphed in (False, True):
        state = _state(cuda, dtype=torch.bfloat16)
        model = state.model
        cache = GraphCache(model)
        sampler = ancestral.make_ddim_sampler(
            lambda x, i: model(x, i.float() / 1000.0), DDPM.create(1000),
            4, graphs=cache)
        model.eval()
        with torch.no_grad():
            model(xT, torch.full((4,), 0.5, device=cuda))  # cast copies
        sampler(xT)
        tr = trainer.Trainer(_step(cuda), state, iter(_batches(STEPS)),
                             graphed=graphed)
        tr.fit(STEPS)
        model.eval()
        with torch.no_grad():
            fwd = model(xT, torch.full((4,), 0.5, device=cuda))
        out[graphed] = (fwd, sampler(xT), cache.captures)
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    assert out[True][2] == out[False][2] == 2


@pytest.mark.cuda
def test_cuda_graphed_flash_training_replays_the_backward(cuda):
    """bf16 with the flash kernels at T=64: the replays launch the flash
    forward and backward, and the losses stay near the eager run's (the
    bf16 backward's atomic dq sums: not bitwise)."""
    from tpu_diffusion_torch.sampling.graph import executed_launches
    before = executed_launches()
    graphed, got = _fit(cuda, graphed=True, dtype=torch.bfloat16,
                        attention_impl="flash")
    ran = {k: v - before[k] for k, v in executed_launches().items()}
    entry, = graphed.graphs.captured().values()
    per_step = entry.launches["flash_attention_bwd"]
    assert per_step == entry.launches["flash_attention_fwd"] > 0
    assert ran["flash_attention_bwd"] == STEPS * per_step
    _, want = _fit(cuda, graphed=False, dtype=torch.bfloat16,
                   attention_impl="flash")
    for (lg, _), (lw, _) in zip(got, want):
        assert abs(lg - lw) <= 1e-2 * abs(lw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 2e-5)])
def test_cuda_fused_attention_gradient(cuda, dtype, tol):
    """C6: the gradient through `flash_attention_fused` on the card is the
    plain version's (the JAX custom VJP's recompute)."""
    gen = torch.Generator().manual_seed(11)
    qkv = torch.randn((4, 256, 3 * 128), generator=gen).to(cuda, dtype)
    g = torch.randn((4, 256, 128), generator=gen).to(cuda, dtype)
    x = qkv.clone().requires_grad_()
    before = attention.launches
    got, = torch.autograd.grad(attention.flash_attention_fused(x, 2), x, g)
    assert attention.launches == before + 1
    x = qkv.clone().requires_grad_()
    want, = torch.autograd.grad(attention.dense_attention(x, 2), x, g)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    assert (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.cuda
def test_cuda_fused_attention_training_moves_qkv(cuda):
    """A graphed training step of a model with `attention_impl="fused"`
    moves the qkv projection (before C6 its gradient was lost)."""
    state = _state(cuda, dtype=torch.bfloat16, attention_impl="fused")
    qkv = {n: p.detach().clone() for n, p in state.model.named_parameters()
           if ".qkv." in n}
    assert qkv
    trainer.Trainer(_step(cuda), state, iter(_batches(STEPS))).fit(STEPS)
    params = dict(state.model.named_parameters())
    for n, before in qkv.items():
        assert not torch.equal(params[n], before), n


@pytest.mark.cuda
def test_cuda_use_checkpoint_graphed_equals_eager(cuda, deterministic):
    """A `use_checkpoint` UNet with dropout 0.1, fp32: graphed (its
    ResBlocks recomputed inside the replayed backward) equals the eager
    loop bitwise, the generator included."""
    eager, want = _fit(cuda, graphed=False, use_checkpoint=True)
    graphed, got = _fit(cuda, graphed=True, use_checkpoint=True)
    assert graphed.graphed and not eager.graphed
    assert got == want
    _same_state(graphed.state, eager.state)
    entry, = graphed.graphs.captured().values()
    assert entry.replays == STEPS - WARMUP


@pytest.mark.cuda
def test_cuda_protein_remat_graphed_equals_eager(cuda, deterministic):
    """A tiny `remat` GVP denoiser with drop_rate 0.3, fp32: graphed
    equals the eager loop bitwise, the generator included."""
    from tpu_diffusion_torch.cli import train_protein
    from tpu_diffusion_torch.protein.data import (protein_batches,
                                                  synthetic_ca_chains)
    from tpu_diffusion_torch.protein.denoiser import GVPDenoiser
    from tpu_diffusion_torch.protein.sde import HoogeboomGraphSDE
    ds = synthetic_ca_chains(16, max_len=24, min_len=8, seed=0)
    runs = []
    for graphed in (False, True):
        torch.manual_seed(0)
        model = GVPDenoiser(max_protein_length=24, n_h_node_feats=(16, 4),
                            n_h_edge_feats=(16, 4), n_conv_layers=2,
                            num_steps=20, drop_rate=0.3, remat=True,
                            device=cuda)
        state = trainer.TrainState.create(
            model, trainer.make_optimizer(model.parameters(), 1e-3),
            torch.Generator(cuda).manual_seed(1))
        loss = train_protein.make_loss_fn(HoogeboomGraphSDE(num_steps=20,
                                                            device=cuda))
        rows = []
        tr = trainer.Trainer(trainer.make_train_step(loss, ema_decay=0.9),
                             state, protein_batches(ds, 4, seed=2),
                             graphed=graphed)
        tr.fit(STEPS, metrics_hook=lambda s, m: rows.append(
            (m["loss"], m["grad_norm"])))
        runs.append((tr, rows))
    (eager, want), (graphed, got) = runs
    assert graphed.graphed and not eager.graphed
    assert got == want
    _same_state(graphed.state, eager.state)


def _cli_trainer(cuda, dtype, graphed):
    """A Trainer as `cli.main --mode train` builds it for a cut-down
    `flowers,inpainting,amortized` config (32 channels, (1, 2), one
    ResBlock a level, FiLM, dense attention at 32x32, batch 4): its UNet
    from `cli.build` on the card, so its norms are the GroupNorm kernel."""
    from tpu_diffusion_torch.cli import main as cli
    from tpu_diffusion_torch.utils import config as config_mod
    config = config_mod.get_config("flowers,inpainting,amortized")
    config_mod.apply_overrides(config, [
        "network.num_channels=32", "network.channel_mult=1,2",
        "network.num_res_blocks=1", "network.num_head_channels=-1",
        "network.num_heads=2", "network.attention_resolutions=32",
        "network.attention_impl=dense", "training.batch_size=4",
        f"network.dtype={'bfloat16' if dtype == torch.bfloat16 else 'float32'}"])
    config.network.model_path = ""
    torch.manual_seed(0)
    parts = cli.build(config, cuda)
    state, _ = cli.init_state(config, parts)
    step = trainer.make_train_step(cli.make_loss(parts), ema_decay=0.9,
                                   ema_update_every=2)
    gen = torch.Generator().manual_seed(3)
    batches = [torch.rand((4, 64, 64, 3), generator=gen) * 2 - 1
               for _ in range(STEPS)]
    return trainer.Trainer(step, state, iter(batches), graphed=graphed)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_cli_step_runs_the_groupnorm_kernels(cuda, deterministic,
                                                  dtype):
    """The UNet that `cli.build` makes on the card runs every norm through
    the GroupNorm kernel and its backward: a replay of its graphed step
    launches each once per norm, and the graphed steps still equal the
    eager loop bitwise (the backward sums with no atomics)."""
    from tpu_diffusion_torch.kernels import groupnorm
    from tpu_diffusion_torch.models.nn import FusedNormAct, GroupNorm32
    runs = {}
    for graphed in (False, True):
        rows = []
        tr = _cli_trainer(cuda, dtype, graphed)
        b0 = groupnorm.backward_launches
        tr.fit(STEPS, metrics_hook=lambda s, m: rows.append(
            (m["loss"], m["grad_norm"])))
        runs[graphed] = (tr, rows, groupnorm.backward_launches - b0)
    (eager, want, eager_bwd), (graphed, got, _) = runs[False], runs[True]
    model = graphed.state.model
    norms = sum(isinstance(m, FusedNormAct) for m in model.modules())
    assert norms == 21
    assert not any(isinstance(m, GroupNorm32) for m in model.modules())
    assert eager_bwd == STEPS * norms
    entry, = graphed.graphs.captured().values()
    assert entry.launches["fused_groupnorm_silu"] == norms
    assert entry.launches["fused_groupnorm_silu_bwd"] == norms
    assert got == want
    _same_state(graphed.state, eager.state)


@pytest.mark.cuda
def test_cuda_no_grad_forwards_write_no_statistics(cuda, monkeypatch):
    """Under no_grad (the engine, the samplers) the GroupNorm kernel is the
    plain launch: no statistics pointer, one forward launch a norm, no
    backward; with the gradient on, the same model's forward asks for the
    statistics and its output is bitwise the same."""
    from tpu_diffusion_torch.kernels import groupnorm
    from tpu_diffusion_torch.models.nn import FusedNormAct
    from tpu_diffusion_torch.models.unet_infer import make_fused_apply
    model = create_model(image_size=32, num_channels=64, num_res_blocks=1,
                         in_channels=3, channel_mult=(1, 2), num_heads=2,
                         attention_resolutions="16",
                         use_scale_shift_norm=True, dtype=torch.bfloat16,
                         attention_impl="fused", norm_impl="fused",
                         device=cuda)
    randomize_(model, torch.Generator().manual_seed(0))
    engine = make_fused_apply(model.eval())
    seen = []
    real = groupnorm._launch

    def spy(*args, stats=None):
        seen.append(stats is None)
        return real(*args, stats=stats)

    monkeypatch.setattr(groupnorm, "_launch", spy)
    x = torch.randn((4, 32, 32, 3), generator=torch.Generator()
                    .manual_seed(1)).to(cuda)
    t = torch.full((4,), 0.5, device=cuda)
    norms = sum(isinstance(m, FusedNormAct) for m in model.modules())
    b0 = groupnorm.backward_launches
    with torch.no_grad():
        engine(x, t)
        n_engine = len(seen)
        want = model(x, t)
    assert seen and all(seen) and len(seen) - n_engine == norms
    assert groupnorm.backward_launches == b0
    seen.clear()
    got = model(x, t)
    assert len(seen) == norms and not any(seen)
    assert torch.equal(got.detach(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_graphed_64px_step_replays_one_fused_update(cuda, dtype):
    """The 64px step (fp32 parameters whatever the forward's type) takes
    the fused route: its eager steps launch the kernel once each, a replay
    of its graph once, and no foreach update runs."""
    tr = _cli_trainer(cuda, dtype, graphed=True)
    assert tr.state.optimizer.route == "fused"
    before = adam.launches
    tr.fit(6)
    entry, = tr.graphs.captured().values()
    assert entry.launches["fused_adam_ema"] == 1
    # two eager warm-ups and the capture call
    assert adam.launches - before == 3
    assert entry.replays == 4


@pytest.mark.cuda
def test_cuda_bf16_parameters_take_the_foreach_body(cuda):
    """bf16 parameters on the card: the "foreach" route, no kernel launch,
    and the parameters move."""
    params = [torch.randn(37, device=cuda, dtype=torch.bfloat16)
              .requires_grad_() for _ in range(3)]
    opt = trainer.make_optimizer(params, 1e-2)
    assert opt.route == "foreach"
    start = [p.detach().clone() for p in params]
    for p in params:
        p.grad = torch.ones_like(p)
    before = adam.launches
    opt.fill()
    opt.update()
    assert adam.launches == before
    assert all(not torch.equal(p, s) for p, s in zip(params, start))
