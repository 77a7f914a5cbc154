"""CA-only ProteinMPNN (inverse folding) in PyTorch.

Counterpart of `tpu_diffusion/protein/mpnn.py`: the published CA-ProteinMPNN
architecture (Dauparas et al., Science 2022: k-NN message passing over
RBF-encoded CA-frame distances, 3 encoder + 3 decoder layers, random
decoding order), one structure at a time ([L, 3] coordinates), fp32.

  * The k-NN graph, the features and the message passing are dense ops on
    one [L, K] neighbourhood per structure. Chains tie by construction (the
    two bonded neighbours of a residue sit 3.8 A away), and
    `jax.lax.top_k` puts the lower index first among equal distances, where
    `torch.topk` promises no order; a stable sort keeps the JAX rule on
    every device. Only the SET of the K neighbours changes the outputs
    (every use sums over K), the order only the order of those sums.
  * Designing a sequence (`make_mpnn_fns`' `sample`) runs the encoder once,
    then one teacher-forced decode pass per position of the decoding order:
    the causal mask hides every token not yet written. The loop runs on the
    host over an order the host knows; the tokens stay on the device, and
    no step reads anything back. A step's draw is a Gumbel-max,
    argmax(lp[p] / T + g_t), which is what `jax.random.categorical` does, so
    the JAX draws can be handed in (`noise=`).
  * `MPNNScorer._order` draws the decoding order with `torch.randperm` from
    a CPU generator seeded by `seed`: the permutation differs from
    `jax.random.permutation`'s for the same seed.

Submodules carry the public checkpoint's names (`features.edge_embedding`,
`encoder_layers.{i}.W1`, ...), so the released `ca_model_weights` state
dict loads by name (`load_mpnn_state_dict`), and
`convert.mpnn_state_dict_from_flax` maps the JAX package's parameter tree
or its flat npz onto them. Random weights come from a `torch.Generator`
(flax's default scales; not the published model, and not the JAX
package's random draw).
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_diffusion_torch.protein.self_consistency import (ALPHABET,
                                                          ProteinMPNNScorer)
from tpu_diffusion_torch.sampling.graph import GraphCache, row_at, scan

Tensor = torch.Tensor

# 16 radial basis functions spanning 2-22 A (the published featurization).
RBF_MIN, RBF_MAX, NUM_RBF = 2.0, 22.0, 16
# relative sequence offset clipped to +-32 -> one-hot(66) (65 positions +
# the different-chain bucket, unused here: single chains)
MAX_REL_OFFSET = 32
# the 9 (node-shift, neighbour-shift) pairs whose CA-CA distances are
# RBF-encoded; (0, 0) is the plain CA_i - CA_j distance
SHIFT_PAIRS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1),
               (-1, -1), (-1, 1), (1, -1), (1, 1))


def _rbf(d: Tensor) -> Tensor:
    """[...] -> [..., NUM_RBF] Gaussian radial basis encoding."""
    mu = torch.linspace(RBF_MIN, RBF_MAX, NUM_RBF, dtype=d.dtype,
                        device=d.device)
    sigma = (RBF_MAX - RBF_MIN) / NUM_RBF
    return torch.exp(-(((d[..., None] - mu) / sigma) ** 2))


def _shift(x: Tensor, offset: int) -> Tensor:
    """Chain-shifted copy of [L, 3] coords, edge-replicated at the ends
    (the public featurizer zero-pads; the JAX package replicates, which keeps
    every feature a pure inter-atom distance)."""
    if offset == 0:
        return x
    if offset < 0:
        pad = x[:1].expand(-offset, x.shape[-1])
        return torch.cat([pad, x[:offset]], 0)
    pad = x[-1:].expand(offset, x.shape[-1])
    return torch.cat([x[offset:], pad], 0)


def knn_graph(coords: Tensor, mask: Tensor, k: int
              ) -> Tuple[Tensor, Tensor]:
    """[L, 3], [L] -> (E_idx [L, K] neighbour indices, mask_attend [L, K]).

    Nearest neighbours by CA distance; padded positions are pushed to the
    far end so they are never selected while any valid neighbour remains.
    """
    L = coords.shape[0]
    d2 = ((coords[:, None] - coords[None]) ** 2).sum(-1)
    big = 1e9
    eye = torch.eye(L, dtype=d2.dtype, device=d2.device)
    # exclude self and padded columns
    d2 = d2 + big * (1.0 - mask)[None, :] + big * eye
    # ascending and stable: equal distances keep the lower index first, as
    # jax.lax.top_k(-d2) orders them
    d2, e_idx = torch.sort(d2, dim=-1, stable=True)
    k = min(k, L - 1)
    d2, e_idx = d2[:, :k], e_idx[:, :k]
    mask_attend = mask[:, None] * mask[e_idx]
    # neighbours that are only padding-fill (distance >= big) contribute 0
    return e_idx, mask_attend * (d2 < big / 2).to(coords.dtype)


def gather_nodes(h: Tensor, e_idx: Tensor) -> Tensor:
    """[L, C], [L, K] -> [L, K, C] neighbour features."""
    return h[e_idx]


class PositionWiseFeedForward(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.W_in = nn.Linear(hidden, 4 * hidden)
        self.W_out = nn.Linear(4 * hidden, hidden)

    def forward(self, x: Tensor) -> Tensor:
        return self.W_out(F.gelu(self.W_in(x)))


def _mlp3(w1: nn.Linear, w2: nn.Linear, w3: nn.Linear, x: Tensor) -> Tensor:
    return w3(F.gelu(w2(F.gelu(w1(x)))))


class EncLayer(nn.Module):
    """Node + edge update (the published EncLayer): 3-linear GELU message
    MLP over [h_V_i | h_E | h_V_j], sum over neighbours / scale (30
    whatever K, as published), residual + LayerNorm, position-wise FFN,
    then the mirrored edge update (W11-W13)."""

    def __init__(self, hidden: int, scale: float = 30.0):
        super().__init__()
        self.scale = scale
        self.W1 = nn.Linear(3 * hidden, hidden)
        self.W2 = nn.Linear(hidden, hidden)
        self.W3 = nn.Linear(hidden, hidden)
        self.W11 = nn.Linear(3 * hidden, hidden)
        self.W12 = nn.Linear(hidden, hidden)
        self.W13 = nn.Linear(hidden, hidden)
        self.norm1 = nn.LayerNorm(hidden)
        self.norm2 = nn.LayerNorm(hidden)
        self.norm3 = nn.LayerNorm(hidden)
        self.dense = PositionWiseFeedForward(hidden)

    def forward(self, h_v: Tensor, h_e: Tensor, e_idx: Tensor, mask: Tensor,
                mask_attend: Tensor) -> Tuple[Tensor, Tensor]:
        def edge_input(h):
            h_vj = gather_nodes(h, e_idx)
            return torch.cat([h[:, None].expand_as(h_vj), h_e, h_vj], -1)

        m = _mlp3(self.W1, self.W2, self.W3, edge_input(h_v))
        m = m * mask_attend[..., None]
        h_v = self.norm1(h_v + m.sum(-2) / self.scale)
        h_v = self.norm2(h_v + self.dense(h_v))
        h_v = h_v * mask[:, None]

        me = _mlp3(self.W11, self.W12, self.W13, edge_input(h_v))
        h_e = self.norm3(h_e + me) * mask_attend[..., None]
        return h_v, h_e


class DecLayer(nn.Module):
    """Decoder node update over pre-mixed causal edge context
    [h_E | h_S_or_0 | h_V_j] (the published DecLayer)."""

    def __init__(self, hidden: int, scale: float = 30.0):
        super().__init__()
        self.scale = scale
        self.W1 = nn.Linear(4 * hidden, hidden)
        self.W2 = nn.Linear(hidden, hidden)
        self.W3 = nn.Linear(hidden, hidden)
        self.norm1 = nn.LayerNorm(hidden)
        self.norm2 = nn.LayerNorm(hidden)
        self.dense = PositionWiseFeedForward(hidden)

    def forward(self, h_v: Tensor, h_esv: Tensor, mask: Tensor,
                mask_attend: Tensor) -> Tensor:
        h_vi = h_v[:, None].expand(*h_esv.shape[:-1], h_v.shape[-1])
        m = _mlp3(self.W1, self.W2, self.W3, torch.cat([h_vi, h_esv], -1))
        m = m * mask_attend[..., None]
        h_v = self.norm1(h_v + m.sum(-2) / self.scale)
        h_v = self.norm2(h_v + self.dense(h_v))
        return h_v * mask[:, None]


class _PositionalEncodings(nn.Module):
    def __init__(self):
        super().__init__()
        self.linear = nn.Linear(2 * MAX_REL_OFFSET + 2, 16)


class _Features(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.embeddings = _PositionalEncodings()
        self.edge_embedding = nn.Linear(16 + len(SHIFT_PAIRS) * NUM_RBF,
                                        hidden, bias=False)
        self.norm_edges = nn.LayerNorm(hidden)


class CAProteinMPNN(nn.Module):
    """CA-only ProteinMPNN: featurize -> encode -> causal decode.

    Unbatched ([L, 3] coords). Every method takes a decoding `order` ([L]
    permutation): scoring conditions each position on the positions earlier
    in the order, the published order-agnostic autoregression.
    """

    def __init__(self, hidden: int = 128, k: int = 48, n_enc: int = 3,
                 n_dec: int = 3, vocab: int = len(ALPHABET),
                 device=None):
        super().__init__()
        self.hidden, self.k = hidden, k
        self.features = _Features(hidden)
        self.W_e = nn.Linear(hidden, hidden)
        self.W_s = nn.Embedding(vocab, hidden)
        self.encoder_layers = nn.ModuleList(EncLayer(hidden)
                                            for _ in range(n_enc))
        self.decoder_layers = nn.ModuleList(DecLayer(hidden)
                                            for _ in range(n_dec))
        self.W_out = nn.Linear(hidden, vocab)
        self.to(device)

    @torch.no_grad()
    def randomize_(self, generator: torch.Generator) -> "CAProteinMPNN":
        """Random weights at flax's default scales, drawn from `generator`
        (on the parameters' device): Linear weights N(0, 1/fan_in), biases
        0, LayerNorms 1 and 0, the token embedding N(0, 1/hidden)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.normal_(m.weight, 0.0, m.in_features ** -0.5,
                                generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, 0.0, m.embedding_dim ** -0.5,
                                generator=generator)
        return self

    def _features(self, coords: Tensor, mask: Tensor
                  ) -> Tuple[Tensor, Tensor, Tensor]:
        e_idx, mask_attend = knn_graph(coords, mask, self.k)

        def shifted_coords(s):
            # neighbour-in-chain coords; where the chain ends (array edge
            # or a masked/padded position) fall back to the residue itself
            if s == 0:
                return coords
            xs = _shift(coords, s)
            pad = torch.zeros(abs(s), dtype=mask.dtype, device=mask.device)
            ms = torch.cat([pad, mask[:s]] if s < 0 else [mask[s:], pad], 0)
            return torch.where((ms > 0)[:, None], xs, coords)

        shifted = {s: shifted_coords(s) for s in (-1, 0, 1)}
        rbfs = []
        for si, sj in SHIFT_PAIRS:
            a = shifted[si]                       # [L, 3] at node i
            b = shifted[sj][e_idx]                # [L, K, 3] at neighbour j
            rbfs.append(_rbf(torch.sqrt(
                ((a[:, None] - b) ** 2).sum(-1) + 1e-8)))
        L = coords.shape[0]
        rows = torch.arange(L, device=coords.device)[:, None]
        offset = torch.clamp(e_idx - rows, -MAX_REL_OFFSET,
                             MAX_REL_OFFSET) + MAX_REL_OFFSET
        onehot = F.one_hot(offset, 2 * MAX_REL_OFFSET + 2).to(coords.dtype)
        f = self.features
        e = torch.cat([f.embeddings.linear(onehot)] + rbfs, -1)
        e = f.norm_edges(f.edge_embedding(e))
        return self.W_e(e), e_idx, mask_attend

    def encode(self, coords: Tensor, mask: Tensor
               ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        h_e, e_idx, mask_attend = self._features(coords, mask)
        h_v = coords.new_zeros(coords.shape[0], self.hidden)
        for layer in self.encoder_layers:
            h_v, h_e = layer(h_v, h_e, e_idx, mask, mask_attend)
        return h_v, h_e, e_idx, mask_attend

    def forward(self, coords: Tensor, tokens: Tensor, order: Tensor,
                mask: Optional[Tensor] = None) -> Tensor:
        """Teacher-forced conditional log-probs: [L, vocab] log-softmax
        rows, row i conditioned on the true tokens at positions earlier
        than i in `order` (a position never sees its own token)."""
        if mask is None:
            mask = coords.new_ones(coords.shape[0])
        h_v, h_e, e_idx, mask_attend = self.encode(coords, mask)
        return self.decode(h_v, h_e, e_idx, mask, mask_attend, tokens, order)

    def decode(self, h_v: Tensor, h_e: Tensor, e_idx: Tensor, mask: Tensor,
               mask_attend: Tensor, tokens: Tensor, order: Tensor) -> Tensor:
        L = h_v.shape[0]
        rank = torch.empty_like(order)
        rank[order] = torch.arange(L, dtype=order.dtype, device=order.device)
        # neighbour j visible to i iff decoded strictly earlier
        mask_bw = (rank[e_idx] < rank[:, None]).to(h_v.dtype) * mask_attend
        h_s = self.W_s(tokens)
        h_es = torch.cat([h_e, h_s[e_idx]], -1)
        # future/unknown neighbours contribute their ENCODER state, no seq
        h_exv_enc = torch.cat(
            [h_e, torch.zeros_like(h_s[e_idx]), gather_nodes(h_v, e_idx)],
            -1) * (1.0 - mask_bw)[..., None] * mask_attend[..., None]
        for layer in self.decoder_layers:
            h_esv = torch.cat([h_es, gather_nodes(h_v, e_idx)], -1) \
                * mask_bw[..., None] + h_exv_enc
            h_v = layer(h_v, h_esv, mask, mask_attend)
        return F.log_softmax(self.W_out(h_v), -1)


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device) -> Tensor:
    """-log(-log(u)), u uniform in [tiny, 1), as `jax.random.gumbel`
    draws it."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(
        u, min=torch.finfo(u.dtype).tiny)))


def make_mpnn_fns(model: CAProteinMPNN,
                  graphs: Optional[GraphCache] = None):
    """(score, sample) over `model`, as the JAX closures.

    score(coords, tokens, order, mask) -> [L, vocab] log-probs.
    sample(coords, order, mask, init_tokens, fixed_mask, temperature=0.1,
           *, generator=None, noise=None) -> [L] tokens on the device,
    decoded along `order` (a sequence the host holds, or a tensor, read
    once) by one teacher-forced decode pass per step; the encoder runs
    once. Step t draws argmax(lp[order[t]] / temperature + noise[t]), noise
    [L, vocab] standard Gumbel (drawn from `generator` when not given); a
    position with fixed_mask > 0 keeps its token from `init_tokens`.

    With `graphs`, the decode loop is a graphed chain, one graph per
    length L: the encoder's outputs, the order, the Gumbel noise, the
    tokens and the fixed mask are static buffers, and step t reads its
    position on the device (order[t]), so one graph serves every design of
    length L whatever its order; bitwise equal to the loop.
    """

    @torch.no_grad()
    def score(coords, tokens, order, mask):
        return model(coords, tokens, order, mask)

    @torch.no_grad()
    def sample(coords, order, mask, init_tokens, fixed_mask,
               temperature=0.1, *, generator=None, noise=None):
        dev = coords.device
        steps = [int(p) for p in (order.tolist() if isinstance(order, Tensor)
                                  else order)]
        order_d = torch.as_tensor(steps, dtype=torch.long, device=dev)
        h_v, h_e, e_idx, mask_attend = model.encode(coords, mask)
        if noise is None:
            noise = gumbel_noise((len(steps), model.W_out.out_features),
                                 generator, dev)
        noise = noise.to(dev, torch.float32)
        fixed = fixed_mask.to(dev) > 0
        tokens = init_tokens.to(dev, torch.long).clone()
        if graphs is not None:
            return _graphed_decode(graphs, model, temperature, tokens, dict(
                h_v=h_v, h_e=h_e, e_idx=e_idx, mask=mask,
                mask_attend=mask_attend, order=order_d, noise=noise,
                fixed=fixed))
        for t, p in enumerate(steps):
            lp = model.decode(h_v, h_e, e_idx, mask, mask_attend, tokens,
                              order_d)
            tok = torch.argmax(lp[p] / temperature + noise[t])
            # fixed (motif) positions keep their given identity
            tokens[p] = torch.where(fixed[p], tokens[p], tok)
        return tokens

    return score, sample


def _graphed_decode(graphs: GraphCache, model: CAProteinMPNN,
                    temperature: float, tokens: Tensor, inputs: dict
                    ) -> Tensor:
    """The decode loop through `graph.scan`: one step a replay."""
    def make_step(buf):
        def step(scratch, tokens, t, j, sig, noise):
            p = buf["order"].index_select(0, t.view(1))
            lp = model.decode(buf["h_v"], buf["h_e"], buf["e_idx"],
                              buf["mask"], buf["mask_attend"], tokens,
                              buf["order"])
            tok = torch.argmax(lp.index_select(0, p)[0] / temperature
                               + row_at(buf["noise"], t))
            keep = torch.where(buf["fixed"].index_select(0, p),
                               tokens.index_select(0, p), tok.view(1))
            return tokens.index_copy(0, p, keep)
        return step

    return scan(graphs, ("mpnn_decode", temperature), model, tokens,
                [[t] for t in range(tokens.shape[0])], make_step,
                inputs=inputs)


class MPNNScorer(ProteinMPNNScorer):
    """`ProteinMPNNScorer` adapter: numpy in and out, seed -> decoding order
    and Gumbel generator, the model on its device. Drop-in for the
    self-consistency stage (reference evaluation_pipeline.py:452-513)."""

    def __init__(self, model: CAProteinMPNN, temperature: float = 0.1):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.temperature = float(temperature)
        # the decode loop graphed, one graph per chain length
        self.graphs = GraphCache(self.model)
        self._score, self._sample = make_mpnn_fns(self.model, self.graphs)

    def _order(self, length: int, seed: int,
               fixed_mask: Optional[np.ndarray] = None) -> np.ndarray:
        perm = torch.randperm(length, generator=torch.Generator()
                              .manual_seed(seed)).numpy()
        if fixed_mask is None:
            return perm
        # fixed (motif) positions decode first -> every designed position
        # conditions on the whole motif (reference create_backbone
        # res_mask semantics, evaluation_pipeline.py:434-449)
        fixed = np.asarray(fixed_mask)[perm] > 0
        return np.concatenate([perm[fixed], perm[~fixed]])

    def _coords(self, coords) -> Tensor:
        return torch.as_tensor(np.asarray(coords, np.float32),
                               device=self.device)

    def sample(self, coords: np.ndarray, seed: int = 0,
               fixed_tokens: Optional[np.ndarray] = None,
               fixed_mask: Optional[np.ndarray] = None) -> np.ndarray:
        x = self._coords(coords)
        L = x.shape[0]
        if fixed_mask is None:
            fixed_mask = np.zeros(L, np.float32)
        init = np.zeros(L, np.int64)
        if fixed_tokens is not None:
            init = np.where(np.asarray(fixed_mask) > 0,
                            np.asarray(fixed_tokens, np.int64), init)
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        tokens = self._sample(
            x, self._order(L, seed, fixed_mask), x.new_ones(L),
            torch.as_tensor(init), torch.as_tensor(
                np.asarray(fixed_mask, np.float32)),
            self.temperature, generator=gen)
        return tokens.cpu().numpy()

    def log_probs(self, coords: np.ndarray, tokens: np.ndarray,
                  seed: int = 0) -> np.ndarray:
        x = self._coords(coords)
        L = x.shape[0]
        lp = self._score(
            x, torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device),
            torch.as_tensor(self._order(L, seed), device=self.device),
            x.new_ones(L))
        return lp.cpu().numpy()


@torch.no_grad()
def load_mpnn_state_dict(model: CAProteinMPNN,
                         state_dict: Mapping) -> CAProteinMPNN:
    """A state dict with the public checkpoint's names (arrays or tensors;
    `convert.mpnn_state_dict_from_flax` gives one from the JAX package's
    weights) into `model`, as fp32. An unknown or missing name raises
    KeyError, a shape that differs from the model's ValueError."""
    own = model.state_dict()
    unknown = sorted(set(state_dict) - set(own))
    if unknown:
        raise KeyError(f"unmapped state-dict entries: {unknown[:5]} "
                       f"(+{max(0, len(unknown) - 5)} more)")
    missing = sorted(set(own) - set(state_dict))
    if missing:
        raise KeyError(f"mpnn weights missing {len(missing)} entries, e.g. "
                       f"{missing[:3]}")
    loaded = {}
    for name, value in own.items():
        arr = torch.as_tensor(np.asarray(state_dict[name], np.float32))
        if tuple(arr.shape) != tuple(value.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != model "
                             f"{tuple(value.shape)}")
        loaded[name] = arr
    model.load_state_dict(loaded, strict=True)
    return model


def load_mpnn_scorer(npz_path: Optional[str] = None, hidden: int = 128,
                     k: int = 48, seed: int = 0, temperature: float = 0.1,
                     device="cuda") -> MPNNScorer:
    """The CA ProteinMPNN scorer on `device`: random weights from a
    generator seeded by `seed` (NOT the published model: results are
    self-consistent only), or the JAX package's converted-weights .npz
    (flat `params/enc_0/W1/kernel`-style entries, as its
    `load_mpnn_scorer` reads them)."""
    model = CAProteinMPNN(hidden=hidden, k=k, device=device)
    model.randomize_(torch.Generator(device=model.W_out.weight.device)
                     .manual_seed(seed))
    if npz_path is not None:
        from tpu_diffusion_torch.convert import mpnn_state_dict_from_flax
        with np.load(npz_path) as loaded:
            load_mpnn_state_dict(model, mpnn_state_dict_from_flax(
                {name: loaded[name] for name in loaded.files}))
    return MPNNScorer(model, temperature=temperature)
