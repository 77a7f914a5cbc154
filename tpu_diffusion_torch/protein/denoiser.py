"""SE(3)-equivariant GVP-GNN denoiser on padded dense protein batches.

Counterpart of `tpu_diffusion/protein/denoiser.py`: RBF edge scalars
(D_max 6, 16 bins) and unit direction edge vectors, sinusoidal chain-order
embeddings with the time appended to the node scalars (or sin-encoded),
5 GVPConv layers at (256, 64), one output vector channel mean-centred per
graph -> an equivariant eps_hat. fp32 throughout, as the JAX model.

Children carry the flax names: `W_v`, `W_e`, `W_e_norm`, `conv_{i}`,
`out_norm`, `W_out`. `remat=True` recomputes each conv layer in the
backward (`torch.utils.checkpoint`), the JAX `nn.remat`: the dense
[B, N, N, ...] message tensors dominate training memory. The
recomputation reuses the forward's dropout masks, so rematerialised and
plain training give the same outputs, gradients and generator state.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_diffusion_torch.protein.geometry import masked_mean
from tpu_diffusion_torch.protein.gvp import (GVP, DenseGVPConvLayer,
                                             GVPLayerNorm, norm_no_nan)
from tpu_diffusion_torch.protein.sde import ProteinBatch

Tensor = torch.Tensor


def sinusoidal_encoding(x: Tensor, embed_dim: int,
                        max_steps: int = 10_000) -> Tensor:
    """Transformer sin/cos encoding of integer (or float) ids."""
    half = embed_dim // 2
    freqs = torch.exp(-math.log(max_steps) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    args = x.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def rbf(d: Tensor, d_min: float = 0.0, d_max: float = 6.0,
        num_rbf: int = 16) -> Tensor:
    """Gaussian radial basis expansion of distances."""
    mu = torch.linspace(d_min, d_max, num_rbf, dtype=d.dtype,
                        device=d.device)
    sigma = (d_max - d_min) / num_rbf
    return torch.exp(-((d[..., None] - mu) / sigma) ** 2)


def edge_features(pos: Tensor, mask: Tensor, d_max: float = 6.0,
                  num_rbf: int = 16) -> Tuple[Tensor, Tensor, Tensor]:
    """Dense pairwise edge features: (edge_s [B,N,N,num_rbf], edge_v
    [B,N,N,1,3], pair_mask [B,N,N]), self loops removed."""
    n = pos.shape[1]
    diff = pos[:, None, :, :] - pos[:, :, None, :]   # j - i per (i, j)
    dist = norm_no_nan(diff, axis=-1)
    edge_s = rbf(dist, d_max=d_max, num_rbf=num_rbf)
    unit = diff / dist[..., None]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    pair_mask = (mask[:, :, None] & mask[:, None, :]) & ~eye
    return edge_s, unit[..., None, :], pair_mask


class GVPDenoiser(nn.Module):
    """eps_hat = GVPDenoiser(batch, t), t: [B] normalized times (appended to
    the node scalars when sin_temp_enc=False)."""

    def __init__(self, max_protein_length: int = 112,
                 n_lookup_feats: int = 16,
                 n_h_node_feats: Tuple[int, int] = (256, 64),
                 n_h_edge_feats: Tuple[int, int] = (256, 64),
                 n_conv_layers: int = 5, n_msg_layers: int = 3,
                 n_ff_layers: int = 1, drop_rate: float = 0.0,
                 sin_temp_enc: bool = False, num_steps: int = 250,
                 d_max: float = 6.0, num_rbf: int = 16, remat: bool = False,
                 device=None):
        super().__init__()
        self.max_protein_length = max_protein_length
        self.n_lookup_feats = n_lookup_feats
        self.sin_temp_enc = sin_temp_enc
        self.num_steps = num_steps
        self.d_max, self.num_rbf = d_max, num_rbf
        self.remat = remat
        node_in = n_lookup_feats + (0 if sin_temp_enc else 1)
        self.W_v = GVP((node_in, 1), n_h_node_feats, scalar_act=None,
                       vector_act=None, vector_gate=True)
        self.W_e = GVP((num_rbf, 1), n_h_edge_feats, scalar_act=None,
                       vector_act=None, vector_gate=True)
        self.W_e_norm = GVPLayerNorm(n_h_edge_feats[0])
        self.n_conv_layers = n_conv_layers
        for i in range(n_conv_layers):
            setattr(self, f"conv_{i}", DenseGVPConvLayer(
                n_h_node_feats, n_h_edge_feats, n_message=n_msg_layers,
                n_feedforward=n_ff_layers, drop_rate=drop_rate,
                vector_gate=True, scalar_act=torch.relu, vector_act=None))
        self.out_norm = GVPLayerNorm(n_h_node_feats[0])
        self.W_out = GVP(n_h_node_feats, (n_h_node_feats[0], 1),
                         scalar_act=torch.relu, vector_act=None,
                         vector_gate=True)
        if device is not None:
            self.to(device)

    def forward(self, batch: ProteinBatch, t: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        pos, mask = batch.pos, batch.mask
        b, n, _ = pos.shape
        edge_s, edge_v, pair_mask = edge_features(pos, mask, self.d_max,
                                                  self.num_rbf)
        # node scalars: sinusoidal chain-position embedding (+ time)
        x_s = sinusoidal_encoding(batch.node_order, self.n_lookup_feats,
                                  self.max_protein_length)
        if self.sin_temp_enc:
            x_s = x_s + sinusoidal_encoding(t * self.num_steps,
                                            self.n_lookup_feats,
                                            self.num_steps)[:, None, :]
        else:
            x_s = torch.cat([x_s, t[:, None, None].expand(b, n, 1)], -1)
        # node vectors: the position itself as one vector channel
        h_v = self.W_v((x_s, pos[..., None, :]))
        h_e = self.W_e_norm(self.W_e((edge_s, edge_v)))
        for i in range(self.n_conv_layers):
            layer = getattr(self, f"conv_{i}")
            if self.remat and torch.is_grad_enabled():
                # the masks drawn first, as the layer would draw them, so
                # the recomputation reuses the forward's (flax's nn.remat
                # replays the forward's keys) and draws nothing
                masks = layer.dropout_masks(h_v, train, generator)
                h_v = checkpoint(layer, h_v, h_e, pair_mask, train, None,
                                 masks, use_reentrant=False,
                                 preserve_rng_state=False)
            else:
                h_v = layer(h_v, h_e, pair_mask, train, generator)
        _, out_v = self.W_out(self.out_norm(h_v))
        m = mask[..., None].to(pos.dtype)
        eps = out_v[..., 0, :] * m                    # [B, N, 3]
        # mean-centre per graph -> stays in the COM-free subspace
        return (eps - masked_mean(eps, mask, axis=-2)) * m


class MLPDenoiser(nn.Module):
    """Toy per-node MLP denoiser: positions + chain order + time -> eps,
    mean-centred. Not equivariant: the baseline the GVP model is compared
    against. Children `Dense_0` .. `Dense_{depth}`, as in flax."""

    def __init__(self, hidden: int = 128, depth: int = 3, device=None):
        super().__init__()
        self.depth = depth
        widths = [3 + 8 + 1] + [hidden] * depth
        for i in range(depth):
            setattr(self, f"Dense_{i}", nn.Linear(widths[i], widths[i + 1]))
        setattr(self, f"Dense_{depth}", nn.Linear(hidden, 3))
        if device is not None:
            self.to(device)

    def forward(self, batch: ProteinBatch, t: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        b, n, _ = batch.pos.shape
        h = torch.cat([batch.pos,
                       sinusoidal_encoding(batch.node_order, 8, n or 1),
                       t[:, None, None].expand(b, n, 1)], dim=-1)
        for i in range(self.depth):
            h = torch.relu(getattr(self, f"Dense_{i}")(h))
        m = batch.mask[..., None].to(h.dtype)
        eps = getattr(self, f"Dense_{self.depth}")(h) * m
        return (eps - masked_mean(eps, batch.mask, axis=-2)) * m
