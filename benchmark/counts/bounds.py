"""The least time one H100 could take for a kernel call: the larger of its
operations over the peak rate and its bytes over the peak bandwidth, each
input read once and each output written once.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit):
989 TFLOP/s bf16, 67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s of
HBM3. Each function returns seconds for one call at the given shapes.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, ops: float, op_rate: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / op_rate)


def resblock(b: int, h: int, w: int, cin: int, cout: int,
             itemsize: int = 2) -> float:
    """A whole ResBlock forward: read x and the weights, write the output;
    the operations of its two 3x3 convs and, where cin != cout, the 1x1
    skip."""
    weights = 9 * cin * cout + 9 * cout * cout + (cin * cout
                                                  if cin != cout else 0)
    nbytes = itemsize * (b * h * w * (cin + cout) + weights)
    return bound_s(nbytes, 2 * b * h * w * weights, BF16_FLOPS)


def gn_silu(b: int, h: int, w: int, c: int, film: bool,
            itemsize: int = 2) -> float:
    """GroupNorm(+FiLM)+SiLU: read x, write y, read the fp32 scale and
    bias and, with FiLM, the [B, C] scale and shift; about 8 fp32
    operations an element (3 for the sums, 1 multiply-add, 4 for SiLU)."""
    n = b * h * w * c
    nbytes = 2 * n * itemsize + 2 * c * 4 + (2 * b * c * itemsize
                                             if film else 0)
    return bound_s(nbytes, 8 * n, FP32_FLOPS)


def flash_fwd(bh: int, t: int, d: int, itemsize: int = 2) -> float:
    """The flash forward on [BH, T, d]: read q, k, v, write o and the fp32
    lse; 4 T^2 d operations a slice."""
    n = bh * t * d
    return bound_s(4 * n * itemsize + bh * t * 4, 4 * bh * t * t * d,
                   BF16_FLOPS if itemsize == 2 else FP32_FLOPS)


def flash_bwd(bh: int, t: int, d: int, itemsize: int = 2) -> float:
    """The flash backward: read q, k, v, g and the fp32 lse and delta,
    write dq, dk, dv; the 10 T^2 d operations a slice that s, dp, dq, dk
    and dv need."""
    n = bh * t * d
    return bound_s(7 * n * itemsize + 2 * bh * t * 4, 10 * bh * t * t * d,
                   BF16_FLOPS if itemsize == 2 else FP32_FLOPS)
