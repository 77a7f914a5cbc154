"""The fused clip + Adam + EMA kernel (`kernels/adam.py`,
`csrc/adam_ema.cu`) on the card: against its plain version on the 64px
UNet's parameter set and inside a captured graph with gradients that
moved (the training step's one update launch:
`tests/test_torch_cuda_train_graph.py`).

These tests need a CUDA card and skip without one (the kernel has no CPU
mode). The file imports nothing of JAX, so on a machine with a card and
without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_adam.py

Tolerance everywhere: bitwise, against the plain version run on copies on
the card. The kernel rounds each operation as torch's CUDA ops do (IEEE
division and square root, one fma for each alpha= add and addcmul, the
moments' two and the EMA's one). On the CPU torch's square root is not
correctly rounded, so a CPU copy differs in the last place.
"""

import pytest
import torch

from tpu_diffusion_torch.kernels import adam
from tpu_diffusion_torch.train import trainer

RAMP = 2.0 / 11.0  # ema_fill's warm-up ramp at its first call
Opt = trainer.Optimizer
B1, B2, EPS = Opt.B1, Opt.B2, Opt.EPS


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _scalars(step, dev, lr=2e-4):
    """lr, bc1, bc2 of update `step` (1 for the first), 0-d fp32 on dev."""
    return [torch.tensor(v, dtype=torch.float32, device=dev)
            for v in (lr, 1.0 - B1 ** step, 1.0 - B2 ** step)]


def _clip_factor(grads, clip=1.0):
    norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
    return clip / torch.clamp(norm, min=clip)


def _state(params):
    """Zero moments and an EMA, one each per parameter."""
    return ([torch.zeros_like(p) for p in params],
            [torch.zeros_like(p) for p in params],
            [p.clone() for p in params])


def _copy(ts):
    return [None if t is None else t.detach().clone() for t in ts]


def _equal(got, want, what):
    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), (what, k)


def _step(lists, ref_lists, grads, step, d, dev, tables):
    """One update by the kernel on `lists` and by the plain version on
    their copies `ref_lists`, with EMA weight `d`."""
    params, m, v, e = lists
    lr, bc1, bc2 = _scalars(step, dev)
    clip = _clip_factor(grads)
    decay = torch.tensor(d, device=dev)
    rest = torch.tensor(1.0 - d, device=dev)
    adam.fused_adam_ema(params, grads, m, v, e, lr, bc1, bc2, clip, decay,
                        rest, B1, B2, EPS, tables=tables)
    adam.adam_ema_reference(*ref_lists[:1], grads, *ref_lists[1:], lr, bc1,
                            bc2, clip, decay, rest, B1, B2, EPS)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_the_64px_parameter_set(cuda):
    """`cli.build`'s 64px UNet (93,347,587 fp32 parameters in 368 tensors)
    over three updates, the EMA kept (d = 1: the EMA's bits untouched),
    copied (d = 0) and blended (the ramp), the clip engaged on the first
    and last: p, m, v and e equal the plain version's bitwise."""
    from tpu_diffusion_torch.cli import main as cli
    from tpu_diffusion_torch.utils import config as config_mod
    config = config_mod.get_config("flowers,inpainting,amortized")
    config.network.model_path = ""
    torch.manual_seed(0)
    model = cli.build(config, cuda)["model"]
    params = [p.detach() for p in model.parameters()]
    assert len(params) == 368
    assert sum(p.numel() for p in params) == 93_347_587
    gen = torch.Generator(cuda).manual_seed(1)
    m, v, e = _state(params)
    e0 = _copy(e)
    lists = (params, m, v, e)
    ref_lists = tuple(_copy(ts) for ts in lists)
    before, tables = adam.launches, adam.Tables()
    for step, (d, scale) in enumerate(((1.0, 1.0), (0.0, 1e-6),
                                       (RAMP, 1.0)), start=1):
        grads = [torch.randn(p.shape, generator=gen, device=cuda) * scale
                 for p in params]
        engaged = float(_clip_factor(grads)) < 1.0
        assert engaged == (scale == 1.0)
        _step(lists, ref_lists, grads, step, d, cuda, tables)
        torch.cuda.synchronize()
        if step == 1:  # kept: the EMA's bits untouched
            _equal(e, e0, "kept EMA")
    assert adam.launches == before + 3
    for what, got, want in zip("pmve", lists, ref_lists):
        _equal(got, want, what)


@pytest.mark.cuda
def test_cuda_captured_update_with_moved_gradients(cuda):
    """Tensors of ragged lengths (under a chunk, a chunk and a tail, not a
    multiple of 4, one 4-byte misaligned so the scalar path runs, one
    without an EMA): one eager call, then a graph of two calls captured
    with gradients at new addresses (the pointer table copied in by the
    graph's memcpy node) and replayed with the EMA kept, copied and
    blended; equal to the plain version bitwise."""
    gen = torch.Generator(cuda).manual_seed(2)
    lengths = (1, 3, 5, 17, 4096, adam.CHUNK + 7, 3 * adam.CHUNK)
    params = [torch.randn(n, generator=gen, device=cuda) for n in lengths]
    slab = torch.randn(1001, generator=gen, device=cuda)
    params.append(slab[1:])  # contiguous, 4 bytes past an aligned address
    m, v, e = _state(params)
    e[2] = None
    lists = (params, m, v, e)
    ref_lists = tuple(_copy(ts) for ts in lists)

    def grads_of(step):
        g = torch.Generator(cuda).manual_seed(10 + step)
        return [torch.randn(p.shape, generator=g, device=cuda)
                for p in params]

    tables = adam.Tables()
    _step(lists, ref_lists, grads_of(0), 1, RAMP, cuda, tables)
    grads = grads_of(1)  # new addresses: the capture uploads a new table
    lr, bc1, bc2 = _scalars(2, cuda)
    clip = torch.empty((), device=cuda)
    decay = torch.empty((), device=cuda)
    rest = torch.empty((), device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    before = adam.launches
    with torch.cuda.graph(graph, stream=side):
        for _ in range(2):
            adam.fused_adam_ema(params, grads, m, v, e, lr, bc1, bc2, clip,
                                decay, rest, B1, B2, EPS, tables=tables)
    assert adam.launches == before + 2
    rp, rm, rv, re = ref_lists
    for d in (1.0, 0.0, RAMP):
        clip.copy_(_clip_factor(grads))
        decay.fill_(d)
        rest.fill_(1.0 - d)
        graph.replay()
        for _ in range(2):
            adam.adam_ema_reference(rp, grads, rm, rv, re, lr, bc1, bc2,
                                    clip, decay, rest, B1, B2, EPS)
    torch.cuda.synchronize()
    for what, got, want in zip("pmve", lists, ref_lists):
        _equal([t for t in got if t is not None],
               [t for t in want if t is not None], what)
