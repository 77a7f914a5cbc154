"""The least time one H100 could take for a cross-attention call
(`flash_cross_attention`, kernel `flash_xattn_fwd_kernel`): the larger of
its operations over the bf16 tensor-core peak and its bytes over the HBM
bandwidth (`counts/bounds.py`'s peaks), q, k and v read once and o written
once."""

from __future__ import annotations

from benchmark.counts.bounds import BF16_FLOPS, bound_s


def xattn(bh: int, tq: int, tk: int, d: int, itemsize: int = 2) -> float:
    """Seconds for one call on q [bh, tq, d], k and v [bh, tk, d]: 4 tq tk
    d operations a slice (s and p.v)."""
    nbytes = itemsize * bh * d * (2 * tq + 2 * tk)
    return bound_s(nbytes, 4 * bh * tq * tk * d, BF16_FLOPS)
