"""Sequence parallelism: ring attention over the token axis of a mesh axis.

Counterpart of `tpu_diffusion/parallel/sp.py`. Each "model" rank holds a
T/n-token slice of q, k and v; it attends its q slice to its own k/v block
with an fp32 online-softmax accumulator, then passes the k/v block to the
next rank and receives the previous rank's, n - 1 times, so every query
sees every key. The pass is `ring_permute`, a `batch_isend_irecv` pair
whose backward is the inverse pass, so autograd differentiates the ring as
JAX differentiates through `ppermute`. No T^2 matrix is formed, locally or
globally: a score block is [T/n, T/n]. The ring is plain torch, as the JAX
ring is plain jnp.

`sequence_parallel_attention` takes q, k and v replicated over the axis (as
the UNet computes them), takes this rank's token slice, runs the ring and
gathers the output tokens again. `simulated_ring_attention` runs the same
per-rank arithmetic for n ranks in one process, the rotation done on a list
of shards; the tests and the card's check use it.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from tpu_diffusion_torch.parallel.mesh import MODEL_AXIS, Mesh

Tensor = torch.Tensor


def _shift(x: Tensor, group, shift: int) -> Tensor:
    """x sent `shift` ranks on around the group's ring; returns what
    arrives from `shift` ranks back."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingPermute(torch.autograd.Function):
    """Forward: each rank's block to the next rank. Backward: each block's
    gradient back to the rank it came from."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def ring_permute(x: Tensor, group) -> Tensor:
    return _RingPermute.apply(x, group)


def _attend(acc, qf: Tensor, kv: Tensor):
    """One block of the online softmax: (o, m, l) updated with the scores of
    qf (scaled, fp32) against the block kv = stack([k, v]). The running max
    m only keeps exp() in range; the result does not depend on it, so it
    carries no gradient."""
    k, v = kv[0].float(), kv[1].float()
    s = torch.einsum("...qd,...kd->...qk", qf, k)
    with torch.no_grad():
        m_blk = s.amax(-1)
    if acc is None:
        p = torch.exp(s - m_blk[..., None])
        return (torch.einsum("...qk,...kd->...qd", p, v), m_blk,
                p.sum(-1))
    o, m, l = acc
    m_new = torch.maximum(m, m_blk)
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    return (o * alpha[..., None] + torch.einsum("...qk,...kd->...qd", p, v),
            m_new, l * alpha + p.sum(-1))


def _ring(qs: List[Tensor], kvs: List[Tensor], n: int,
          rotate: Callable[[List[Tensor]], List[Tensor]]) -> List[Tensor]:
    """The ring of n ranks on the q slices and k/v blocks of the ranks held
    here (lists in rank order): the local block first, then n - 1
    rotations, each attended after it arrives (no pass after the last)."""
    qfs = [q.float() * q.shape[-1] ** -0.5 for q in qs]
    accs = [_attend(None, qf, kv) for qf, kv in zip(qfs, kvs)]
    for _ in range(n - 1):
        kvs = rotate(kvs)
        accs = [_attend(acc, qf, kv) for acc, qf, kv in zip(accs, qfs, kvs)]
    return [(o / l[..., None]).to(q.dtype) for (o, _, l), q in zip(accs, qs)]


def ring_attention(q: Tensor, k: Tensor, v: Tensor, group) -> Tensor:
    """Exact self-attention with q, k, v sharded on the token (second to
    last) axis over the ranks of `group`; per-rank shapes [..., T_local, d].
    Every rank of the group must call it."""
    return _ring([q], [torch.stack([k, v])], dist.get_world_size(group),
                 lambda kvs: [ring_permute(kvs[0], group)])[0]


def simulated_ring_attention(q: Tensor, k: Tensor, v: Tensor,
                             n: int) -> Tensor:
    """`ring_attention` of n ranks run in one process on full [..., T, d]
    tensors: the token axis split into n shards, the rotation a shift of
    the list of k/v blocks (rank i receives rank i - 1's)."""
    if q.shape[-2] % n:
        raise ValueError(f"token count {q.shape[-2]} not divisible by {n} "
                         "shards")
    qs = list(q.chunk(n, -2))
    kvs = [torch.stack(kv) for kv in zip(k.chunk(n, -2), v.chunk(n, -2))]
    return torch.cat(_ring(qs, kvs, n, lambda b: b[-1:] + b[:-1]), -2)


class _TokenSlice(torch.autograd.Function):
    """Forward: this rank's token slice of a tensor replicated over the
    group. Backward: the slices' gradients gathered from every rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return x.chunk(n, -2)[r].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather_tokens(grad, ctx.group), None


class _TokenGather(torch.autograd.Function):
    """Forward: the full token axis from every rank's slice. Backward: this
    rank's slice of the gradient, which every rank holds alike; nothing is
    summed."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_tokens(x, group)

    @staticmethod
    def backward(ctx, grad):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return grad.chunk(n, -2)[r].contiguous(), None


def _gather_tokens(x: Tensor, group) -> Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, -2)


def sequence_parallel_attention(q: Tensor, k: Tensor, v: Tensor, mesh: Mesh,
                                axis: str = MODEL_AXIS) -> Tensor:
    """Dense-equivalent attention with the token axis sharded over
    `mesh[axis]`. q, k, v: [..., T, d], the same on every rank of the
    axis; T must divide by the axis size. Returns the full [..., T, d]
    output on every rank."""
    size = mesh.shape[axis]
    t = q.shape[-2]
    if t % size:
        raise ValueError(f"token count {t} not divisible by mesh axis "
                         f"{axis}={size}")
    group = mesh.group(axis)
    qs, ks, vs = _TokenSlice.apply(torch.stack([q, k, v]), group).unbind(0)
    return _TokenGather.apply(ring_attention(qs, ks, vs, group), group)


# Every maybe_sequence_parallel decision, in call order, so that callers
# (the dry run, the tests) can assert that the ring engaged instead of
# falling back to local attention.
_DECISIONS: list = []


def reset_sp_decisions() -> None:
    _DECISIONS.clear()


def sp_decisions() -> list:
    """List of dicts {engaged, tokens, axis_size, reason} in call order."""
    return list(_DECISIONS)


def maybe_sequence_parallel(q: Tensor, k: Tensor, v: Tensor,
                            mesh: Optional[Mesh], axis: str = MODEL_AXIS):
    """Ring attention when a mesh with a >1 `axis` is given and the token
    count divides; None otherwise (the caller runs its local attention).
    Every decision is recorded in `sp_decisions()`."""
    if mesh is None or axis not in mesh.shape or mesh.shape[axis] <= 1:
        _DECISIONS.append({"engaged": False, "tokens": int(q.shape[-2]),
                           "axis_size": 0 if mesh is None
                           else int(mesh.shape.get(axis, 0)),
                           "reason": "no mesh axis"})
        return None
    if q.shape[-2] % mesh.shape[axis]:
        _DECISIONS.append({"engaged": False, "tokens": int(q.shape[-2]),
                           "axis_size": int(mesh.shape[axis]),
                           "reason": "tokens not divisible by axis"})
        return None
    _DECISIONS.append({"engaged": True, "tokens": int(q.shape[-2]),
                       "axis_size": int(mesh.shape[axis]),
                       "reason": "ring"})
    return sequence_parallel_attention(q, k, v, mesh, axis)
