"""The lower precision of the control: fp8 (e4m3) operands.

The configurations compute their products in bfloat16; the nearest lower
precision is fp8. `fp8(x)` rounds a tensor to float8_e4m3fn under one
per-tensor scale (its largest magnitude onto e4m3's largest finite value,
448) and returns it in fp32, so a product of two such operands accumulates
in fp32 as an fp8 tensor-core product does. The backward passes the
gradient through unchanged (straight through), and the saved operands are
the rounded ones.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    scale = E4M3_MAX / x.detach().abs().amax().clamp(min=1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach()
