"""Geometric Vector Perceptron layers on padded dense graphs.

Counterpart of `tpu_diffusion/protein/gvp.py`. A fully connected graph on a
padded [B, N] batch is a dense [B, N, N] pairwise computation with an edge
mask (diagonal and padding removed). Feature convention: scalars s
[..., ds], vectors v [..., dv, 3]; vectors mix over channels only, by a
`Linear` on the transposed [..., 3, dv]. Submodule names follow the flax
tree one to one (`wh`, `ws`, `wv`, `wsv`; `GVP_k`, `GVPLayerNorm_k`,
`LayerNorm_0`), so `convert.gvp_denoiser_state_dict_from_flax` maps a
path to a key. Unlike flax, a torch layer is built knowing its input widths,
so each module here takes them.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

Tensor = torch.Tensor
Dims = Tuple[int, int]   # (scalar channels, vector channels)


def norm_no_nan(x: Tensor, axis: int = -1, keepdims: bool = False,
                eps: float = 1e-8, sqrt: bool = True) -> Tensor:
    """Clamped L2 norm."""
    out = torch.clamp((x * x).sum(dim=axis, keepdim=keepdims), min=eps)
    return torch.sqrt(out) if sqrt else out


class GVP(nn.Module):
    """Geometric vector perceptron with optional vector gating.

    in_dims (si, vi) -> out_dims (so, vo). Called on (s, v), or on s alone
    when vi == 0; returns (s, v), or s alone when vo == 0."""

    def __init__(self, in_dims: Dims, out_dims: Dims,
                 h_dim: Optional[int] = None,
                 scalar_act: Optional[Callable] = torch.relu,
                 vector_act: Optional[Callable] = torch.sigmoid,
                 vector_gate: bool = False):
        super().__init__()
        si, vi = in_dims
        so, vo = out_dims
        self.vi, self.vo = vi, vo
        self.scalar_act, self.vector_act = scalar_act, vector_act
        self.vector_gate = vector_gate
        if vi:
            h = h_dim or max(vi, vo)
            self.wh = nn.Linear(vi, h, bias=False)
            self.ws = nn.Linear(si + h, so)
            if vo:
                self.wv = nn.Linear(h, vo, bias=False)
                if vector_gate:
                    self.wsv = nn.Linear(so, vo)
        else:
            self.ws = nn.Linear(si, so)

    def forward(self, x):
        if isinstance(x, tuple):
            s, v = x
        else:
            s, v = x, None
        if self.vi:
            # vectors mix across channels only (equivariance): [.., 3, vi],
            # made contiguous so that the Linear is one GEMM over all rows
            # (on a strided view, matmul's batching depends on whether the
            # weights require grad: twice the time when they do not)
            vh = self.wh(v.transpose(-1, -2).contiguous())
            vn = norm_no_nan(vh, axis=-2)
            s = self.ws(torch.cat([s, vn], -1))
            if self.vo:
                vout = self.wv(vh).transpose(-1, -2)     # [..., vo, 3]
                if self.vector_gate:
                    gate_in = self.vector_act(s) if self.vector_act else s
                    vout = vout * torch.sigmoid(self.wsv(gate_in))[..., None]
                elif self.vector_act is not None:
                    vout = vout * self.vector_act(
                        norm_no_nan(vout, axis=-1, keepdims=True))
        else:
            s = self.ws(s)
            if self.vo:
                vout = s.new_zeros(s.shape[:-1] + (self.vo, 3))
        if self.scalar_act is not None:
            s = self.scalar_act(s)
        return (s, vout) if self.vo else s


class GVPLayerNorm(nn.Module):
    """LayerNorm on scalars (flax's eps 1e-6, not torch's 1e-5); vectors
    scaled by their RMS norm."""

    def __init__(self, scalar_dim: int):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(scalar_dim, eps=1e-6)

    def forward(self, x):
        s, v = x
        s = self.LayerNorm_0(s)
        vn = norm_no_nan(v, axis=-1, keepdims=True, sqrt=False)
        vn = torch.sqrt(vn.mean(dim=-2, keepdim=True) + 1e-8)
        return s, v / vn


class GVPDropout(nn.Module):
    """Scalar dropout + whole-vector-channel dropout, drawn from an
    explicit generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def masks(self, x, train: bool,
              generator: Optional[torch.Generator]):
        """The (scalar, vector) keep masks that `forward(x, ...)` would
        draw, drawn now; None where it draws none."""
        s, v = x
        if self.rate == 0.0 or not train:
            return None
        if generator is None:
            raise ValueError("GVPDropout in training needs a generator")
        keep = 1.0 - self.rate
        ms = torch.rand(s.shape, generator=generator, device=s.device) < keep
        mv = torch.rand(v.shape[:-1] + (1,), generator=generator,
                        device=v.device) < keep
        return ms, mv

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None, masks=None):
        """`masks` (`self.masks`) hands in masks drawn before."""
        s, v = x
        if self.rate == 0.0 or not train:
            return x
        ms, mv = masks or self.masks(x, train, generator)
        keep = 1.0 - self.rate
        return s * ms / keep, v * mv / keep


def _feedforward_dims(node_dims: Dims, n: int):
    """(in, out, last) of each feedforward GVP."""
    if n == 1:
        return [(node_dims, node_dims, True)]
    hid = (4 * node_dims[0], 2 * node_dims[1])
    dims = [(node_dims, hid, False)]
    dims += [(hid, hid, False)] * (n - 2)
    return dims + [(hid, node_dims, True)]


class DenseGVPConvLayer(nn.Module):
    """GVPConv (mean aggregation) + residual + feedforward, on dense pairs.

    The message of each directed edge (i <- j) is computed from the concat
    of (s_j, v_j), the edge features and (s_i, v_i), in that order.
    Children: GVP_0 .. GVP_{n_message-1} (messages, the last linear), then
    the feedforward GVPs, GVPLayerNorm_0 (after the messages) and
    GVPLayerNorm_1 (after the feedforward)."""

    def __init__(self, node_dims: Dims, edge_dims: Dims, n_message: int = 3,
                 n_feedforward: int = 1, drop_rate: float = 0.0,
                 vector_gate: bool = True,
                 scalar_act: Optional[Callable] = torch.relu,
                 vector_act: Optional[Callable] = None):
        super().__init__()
        ns, nv = node_dims
        msg_in = (2 * ns + edge_dims[0], 2 * nv + edge_dims[1])
        k = 0
        for i in range(n_message):
            last = i == n_message - 1
            setattr(self, f"GVP_{k}", GVP(
                msg_in if i == 0 else node_dims, node_dims,
                scalar_act=None if last else scalar_act,
                vector_act=None if last else vector_act,
                vector_gate=vector_gate))
            k += 1
        self.n_message = n_message
        self.n_feedforward = n_feedforward
        for d_in, d_out, last in _feedforward_dims(node_dims, n_feedforward):
            setattr(self, f"GVP_{k}", GVP(
                d_in, d_out, scalar_act=None if last else scalar_act,
                vector_act=None if last else vector_act,
                vector_gate=vector_gate))
            k += 1
        self.dropout_0 = GVPDropout(drop_rate)
        self.dropout_1 = GVPDropout(drop_rate)
        self.GVPLayerNorm_0 = GVPLayerNorm(ns)
        self.GVPLayerNorm_1 = GVPLayerNorm(ns)

    def dropout_masks(self, x, train: bool,
                      generator: Optional[torch.Generator]):
        """The masks of `dropout_0` and `dropout_1` that `forward(x, ...)`
        would draw, drawn now in its order (each drops a tensor of x's
        shapes)."""
        return (self.dropout_0.masks(x, train, generator),
                self.dropout_1.masks(x, train, generator))

    def forward(self, x, edge_attr, pair_mask: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                masks=(None, None)):
        """x: (s [B,N,ds], v [B,N,dv,3]); edge_attr: (se [B,N,N,de],
        ve [B,N,N,dve,3]); pair_mask [B,N,N] (True = real edge i<-j).
        `masks` (`dropout_masks`) hands in the dropout masks."""
        s, v = x
        b, n, ds = s.shape
        dv = v.shape[-2]
        s_i = s[:, :, None, :].expand(b, n, n, ds)
        s_j = s[:, None, :, :].expand(b, n, n, ds)
        v_i = v[:, :, None].expand(b, n, n, dv, 3)
        v_j = v[:, None, :].expand(b, n, n, dv, 3)
        h = (torch.cat([s_j, edge_attr[0], s_i], dim=-1),
             torch.cat([v_j, edge_attr[1], v_i], dim=-2))
        for k in range(self.n_message):
            h = getattr(self, f"GVP_{k}")(h)
        msg_s, msg_v = h
        w = pair_mask[..., None].to(msg_s.dtype)
        denom = torch.clamp(w.sum(dim=2), min=1.0)         # [B, N, 1]
        agg_s = (msg_s * w).sum(dim=2) / denom
        agg_v = (msg_v * w[..., None]).sum(dim=2) / denom[..., None]

        d_s, d_v = self.dropout_0((agg_s, agg_v), train, generator,
                                  masks[0])
        s, v = self.GVPLayerNorm_0((s + d_s, v + d_v))

        h = (s, v)
        for k in range(self.n_message, self.n_message + self.n_feedforward):
            h = getattr(self, f"GVP_{k}")(h)
        dh = self.dropout_1(h, train, generator, masks[1])
        return self.GVPLayerNorm_1((s + dh[0], v + dh[1]))
