"""Adam after global-norm clipping, and the EMA blend: one hand-written CUDA
pass over every parameter tensor of a training step, and its plain version.

No TPU counterpart: the JAX package's update (optax's
`clip_by_global_norm` and `scale_by_adam` behind the schedule,
`tpu_diffusion/train/trainer.py:make_optimizer`) and its EMA
(`tpu_diffusion/core/ema.py`) are fused by XLA inside the jitted step. The
port ran them as fourteen `torch._foreach_*` passes
(`train/trainer.py:Optimizer.update`, `core/ema.py:ema_blend`), which the
training step's CUDA graph replays one by one. Bound on the H100: bytes
(the arithmetic is trivial). `csrc/adam_ema.cu` reads p, g, m and v once
and writes p, m and v once, and reads and writes the EMA only on a step
that blends it: 7 tensor sets an update, 9 when the EMA blends, where the
chain moved about 34. One launch covers every tensor through two device
tables (five base pointers per tensor; chunks of at most `CHUNK`
elements), walked by a persistent grid with 16-byte accesses.

`fused_adam_ema` takes lists of contiguous fp32 tensors on one CUDA device
and the step's 0-d fp32 device scalars, so a captured step replays the
launch with no host value in it. A CPU tensor goes to `adam_ema_reference`,
the plain version: the foreach body's ops in the kernel's order, which on
the card round as the kernel does. `adam_route` picks the kernel for fp32
on a CUDA device; the optimizer keeps the foreach body otherwise.

The tables are built outside any capture and cached on the tensors'
`data_ptr`s, in a `Tables` object that the caller keeps. A training step's capture sets the gradients to None first,
so that the backward allocates them in the graph's pool: inside a capture
the pointer table is copied from a pinned host buffer by a memcpy node
(`csrc/adam_ema.cu:adam_ema_upload`) that every replay runs before the
kernel. That buffer was allocated by the last call outside a capture, so
that none is allocated inside one; it and the device table live as long as
the `Tables`, and the capture's later calls with the same tensors share
them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from tpu_diffusion_torch.kernels.build import load_library

# Kernel launches made by `fused_adam_ema` since the count was last set to 0.
launches = 0

CHUNK = 16384  # elements of a chunk, at most; a multiple of 4 (float4)
STREAMS = ("params", "grads", "exp_avgs", "exp_avg_sqs", "emas")


def adam_route(device: torch.device, dtype: torch.dtype) -> str:
    """"fused" (the kernel) for fp32 tensors on a CUDA device, else
    "foreach" (the optimizer's `torch._foreach_*` body)."""
    if torch.device(device).type == "cuda" and dtype == torch.float32:
        return "fused"
    return "foreach"


def chunk_table(numels: Sequence[int],
                chunk: int = CHUNK) -> List[Tuple[int, int, int]]:
    """(tensor index, start, length) of every chunk of the tensors of
    `numels` elements: consecutive pieces of at most `chunk` elements, each
    element in exactly one, longest first (so that the persistent grid's
    last rounds take the short ones); an empty tensor has none."""
    if chunk <= 0 or chunk % 4:
        raise ValueError(f"chunk must be a positive multiple of 4, "
                         f"got {chunk}")
    rows = [(i, s, min(chunk, n - s)) for i, n in enumerate(numels)
            for s in range(0, n, chunk)]
    return sorted(rows, key=lambda r: -r[2])


def adam_foreach_(params, grads, exp_avgs, exp_avg_sqs, lr, bc1, bc2,
                  b1=0.9, b2=0.999, eps=1e-8) -> None:
    """optax's `scale_by_adam` and the step, in place over `torch._foreach_*`
    ops: m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2; p -= lr (m / bc1)
    / (sqrt(v / bc2) + eps), with `lr`, `bc1`, `bc2` 0-d tensors. The
    optimizer's "foreach" route, after clipping `grads` in place."""
    torch._foreach_mul_(exp_avgs, b1)
    torch._foreach_add_(exp_avgs, grads, alpha=1.0 - b1)
    torch._foreach_mul_(exp_avg_sqs, b2)
    torch._foreach_addcmul_(exp_avg_sqs, grads, grads, value=1.0 - b2)
    step = torch._foreach_div(exp_avgs, bc1)
    denom = torch._foreach_div(exp_avg_sqs, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(step, denom)
    torch._foreach_mul_(step, lr)
    torch._foreach_sub_(list(params), step)


@torch.no_grad()
def adam_ema_reference(params, grads, exp_avgs, exp_avg_sqs, emas, lr, bc1,
                       bc2, clip=None, decay=None, rest=None, b1=0.9,
                       b2=0.999, eps=1e-8) -> None:
    """Plain version of the kernel, in place: g' = g * clip, then
    `adam_foreach_` on g', then where `decay` is given e = d e + (1 - d) p
    with d = `decay` and 1 - d = `rest` (`core/ema.py:ema_blend`'s ops),
    skipped where d is 1 and a copy of p where d is 0. `emas` (or any entry
    of it) may be None, `clip` (the factor clip / max(norm, clip)) too. The
    gradients are left as they are, and d is read on the host, where the
    kernel branches on it. On the card these ops round as the kernel does;
    on the CPU torch's square root is not correctly rounded and its addcmul
    rounds (1 - b2) g' before the second product, so there the plain
    version differs from the kernel in the last place."""
    if not params:
        return
    g = list(grads) if clip is None else torch._foreach_mul(grads, clip)
    adam_foreach_(params, g, exp_avgs, exp_avg_sqs, lr, bc1, bc2, b1, b2, eps)
    d = None if decay is None else float(decay)
    pairs = [(e, p) for e, p in zip(emas or (), params) if e is not None]
    if not pairs or d is None or d == 1.0:
        return
    ema, new = [e for e, _ in pairs], [p for _, p in pairs]
    if d == 0.0:
        torch._foreach_copy_(ema, new)
    else:
        torch._foreach_mul_(ema, decay)
        torch._foreach_addcmul_(ema, new, [rest] * len(ema))


@functools.lru_cache(maxsize=None)
def _entries():
    lib = load_library("adam_ema")
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    run, upload = lib.adam_ema, lib.adam_ema_upload
    capture_id = lib.adam_ema_capture_id
    run.argtypes = [ptr, i, ptr, i] + [ptr] * 6 + [f] * 5 + [ptr]
    upload.argtypes = [ptr, ptr, ctypes.c_longlong, ptr]
    capture_id.argtypes = [ptr]
    run.restype = upload.restype = ctypes.c_int
    capture_id.restype = ctypes.c_ulonglong
    return run, upload, capture_id


class _Layout:
    """The tables of one list of tensor lengths on one device: the chunk
    table, the pointer table of the last call outside a capture (and its
    key), and a pinned host buffer for the next capture's pointer table."""

    def __init__(self, device: torch.device, numels: Tuple[int, ...]):
        rows = chunk_table(numels)
        self.n_chunks = len(rows)
        self.chunks = torch.tensor(rows, dtype=torch.int64).to(device)
        self.key: Optional[Tuple[int, ...]] = None
        self.ptrs: Optional[torch.Tensor] = None
        self.spare: Optional[torch.Tensor] = None


class Tables:
    """The kernel's device tables for one caller's tensors (an optimizer
    keeps one): a `_Layout` per device and list of lengths, and the pointer
    tables uploaded inside captures, by (capture id, pointers). A
    capture's replays copy each such pinned host table into its device
    table before the kernel reads it, so both live as long as this
    object."""

    def __init__(self):
        self.layouts: Dict[Tuple[torch.device, Tuple[int, ...]],
                           _Layout] = {}
        self.captured: Dict[Tuple[int, Tuple[int, ...]],
                            Tuple[torch.Tensor, torch.Tensor]] = {}

    def get(self, device: torch.device, numels: Tuple[int, ...],
            ptrs: Tuple[int, ...], stream: int):
        """(layout, device pointer table) for a call, built or reused. The
        calls of one capture with the same tensors share one table."""
        capture = _entries()[2](stream)
        lay = self.layouts.get((device, numels))
        if lay is None:
            if capture:
                raise RuntimeError(
                    "fused_adam_ema: first call for these tensors inside a "
                    "CUDA graph capture; make one outside it first (a "
                    "warm-up step), which builds the tables")
            lay = self.layouts[(device, numels)] = _Layout(device, numels)
        if capture:
            if (capture, ptrs) in self.captured:
                return lay, self.captured[(capture, ptrs)][1]
            if lay.spare is None:
                raise RuntimeError(
                    "fused_adam_ema: a second set of tensors to capture "
                    "with no call outside a capture since the first; make "
                    "a warm-up step in between")
            host, lay.spare = lay.spare, None
            host.copy_(torch.tensor(ptrs, dtype=torch.int64))
            table = torch.empty(len(ptrs), dtype=torch.int64, device=device)
            err = _entries()[1](table.data_ptr(), host.data_ptr(),
                                8 * len(ptrs), stream)
            if err:
                raise RuntimeError(f"adam_ema_upload failed: cudaError {err}")
            self.captured[(capture, ptrs)] = (host, table)
            return lay, table
        if lay.key != ptrs:
            lay.ptrs = torch.tensor(ptrs, dtype=torch.int64).to(device)
            lay.key = ptrs
        if lay.spare is None:
            lay.spare = torch.empty(len(ptrs), dtype=torch.int64,
                                    pin_memory=True)
        return lay, lay.ptrs


def _check(device, lists, scalars) -> None:
    numels = [p.numel() for p in lists[0]]
    for name, ts in zip(STREAMS, lists):
        if len(ts) != len(numels):
            raise ValueError(f"{name}: {len(ts)} tensors for "
                             f"{len(numels)} parameters")
        for t, n in zip(ts, numels):
            if t is None and name == "emas":
                continue
            if (t.device != device or t.dtype != torch.float32
                    or not t.is_contiguous() or t.numel() != n):
                raise ValueError(
                    f"{name} must be contiguous fp32 tensors on {device} of "
                    f"their parameters' lengths, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
    for name, t in scalars.items():
        if t is not None and (t.device != device or t.dtype != torch.float32
                              or t.numel() != 1):
            raise ValueError(f"{name} must be a 0-d fp32 tensor on {device}")


@torch.no_grad()
def fused_adam_ema(params, grads, exp_avgs, exp_avg_sqs, emas, lr, bc1, bc2,
                   clip=None, decay=None, rest=None, b1=0.9, b2=0.999,
                   eps=1e-8, tables: Optional[Tables] = None) -> None:
    """Clip, Adam and the EMA blend of every tensor in place, in one launch
    on the current stream (arguments as `adam_ema_reference`'s; the EMA
    blends only with `decay` and `rest` given), through the caller's
    `tables`. CPU tensors go to the plain version."""
    global launches
    if not params:
        return
    device = params[0].device
    if device.type == "cpu":
        adam_ema_reference(params, grads, exp_avgs, exp_avg_sqs, emas, lr,
                           bc1, bc2, clip, decay, rest, b1, b2, eps)
        return
    if tables is None:
        raise ValueError("fused_adam_ema needs the caller's Tables on a "
                         "CUDA device")
    if (decay is None) != (rest is None):
        raise ValueError("decay and rest come together")
    if emas is None or decay is None:
        emas = [None] * len(params)
    lists = (params, grads, exp_avgs, exp_avg_sqs, emas)
    _check(device, lists, dict(lr=lr, bc1=bc1, bc2=bc2, clip=clip,
                               decay=decay, rest=rest))
    ptrs = tuple(0 if t is None else t.data_ptr() for ts in lists
                 for t in ts)
    numels = tuple(p.numel() for p in params)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        lay, table = tables.get(device, numels, ptrs, stream)
        err = _entries()[0](
            table.data_ptr(), len(params), lay.chunks.data_ptr(),
            lay.n_chunks, lr.data_ptr(), bc1.data_ptr(), bc2.data_ptr(),
            None if clip is None else clip.data_ptr(),
            None if decay is None else decay.data_ptr(),
            None if rest is None else rest.data_ptr(), b1, 1.0 - b1, b2,
            1.0 - b2, eps, stream)
    if err:
        raise RuntimeError(f"adam_ema launch failed: cudaError {err}")
    launches += 1
    # the kernel writes through raw pointers: bump the version counters of
    # what it wrote, as an in-place op would, so that readers keyed on them
    # (the models' cast copies, the sampler chains) see the change
    for ts in (params, exp_avgs, exp_avg_sqs, emas):
        for t in ts:
            if t is not None:
                torch.autograd.graph.increment_version(t)
