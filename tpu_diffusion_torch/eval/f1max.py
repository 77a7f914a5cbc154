"""F1Max metric (protein function prediction).

Counterpart of `tpu_diffusion/eval/f1max.py` (rebuilds `amortised
diffusion/src/metrics/f1_max.py:8-59`, torchmetrics style): the maximum
micro-averaged protein-centric F1 over score thresholds, as used by
DeepFRI/GearNet evaluations. The thresholds are `torch.linspace(0, 1, n)`
in fp32, which may differ from `jnp.linspace`'s in the last bit: a score
that close to a threshold can fall on either side of it in the two
packages.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def f1_max(preds: Tensor, targets: Tensor, thresholds: int = 101) -> Tensor:
    """preds: [N, C] scores in [0, 1]; targets: [N, C] binary.

    For each threshold: precision averaged over samples with >=1 prediction,
    recall averaged over all samples; F1 = 2pr/(p+r); return the max.
    """
    preds = torch.as_tensor(preds, dtype=torch.float32)
    targets = torch.as_tensor(targets, dtype=torch.float32,
                              device=preds.device)
    ts = torch.linspace(0.0, 1.0, thresholds, device=preds.device)
    sel = (preds[None] >= ts[:, None, None]).to(torch.float32)  # [T, N, C]
    tp = (sel * targets).sum(-1)                                 # [T, N]
    n_pred = sel.sum(-1)
    n_true = torch.clamp(targets.sum(-1), min=1e-9)
    has_pred = (n_pred > 0).to(torch.float32)
    precision_i = tp / torch.clamp(n_pred, min=1e-9)
    precision = (precision_i * has_pred).sum(-1) / torch.clamp(
        has_pred.sum(-1), min=1e-9)
    recall = (tp / n_true).mean(-1)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-9)
    return f1.max()


class F1Max:
    """Accumulating wrapper with the torchmetrics update/compute API."""

    def __init__(self, thresholds: int = 101):
        self.thresholds = thresholds
        self._preds = []
        self._targets = []

    def update(self, preds, targets):
        self._preds.append(torch.as_tensor(preds))
        self._targets.append(torch.as_tensor(targets))

    def compute(self) -> float:
        return float(f1_max(torch.cat(self._preds),
                            torch.cat(self._targets), self.thresholds))
