"""Weights from the JAX package's flax trees into the port's state_dicts.

The UNet (`unet_state_dict_from_flax`), its CFM wrappers
(`wrapper_state_dict_from_flax`: the same tree under `net/`, for
`UNetModelWrapper`, `InPaintModelWrapper` and `SuperResModelWrapper`), a
dict of such wrappers (`heads_state_dict_from_flax`: SF2M's
`{"flow": ..., "score": ...}` onto an `nn.ModuleDict`), and the
evaluation feature networks (`feature_state_dict_from_flax`, `load_flax_npz`:
`eval/fid.py:RandomConvFeatures`, `eval/lpips.py:VGGFeaturePyramid`,
`eval/inception.py:InceptionV3Features`, whose port modules carry the flax
names, so a path maps to a key one to one), and the protein GVP denoiser
(`gvp_denoiser_state_dict_from_flax`: `protein/denoiser.py:GVPDenoiser`,
whose children carry the flax names too).

The flax tree (`tpu_diffusion/models/unet.py`, as nested dicts of numpy
arrays) names its blocks as the port does (`enc_{l}_{i}`, `mid_attn`,
`down_{l}`, ...); only the children differ:

  ResBlock        Conv_0 -> in_conv, Dense_0 -> emb_dense, Conv_1 -> out_conv,
                  Conv_2 -> skip, GroupNorm32_0/GroupNorm_0 or FusedNormAct_0
                  -> in_norm, GroupNorm32_1/GroupNorm_0 or FusedNormAct_1
                  -> out_norm
  AttentionBlock  GroupNorm32_0/GroupNorm_0 or FusedNormAct_0 -> norm,
                  qkv -> qkv, Conv_0 -> proj
  Down/Upsample   Conv_0 -> conv
  out_norm        GroupNorm_0/{scale,bias} or {scale,bias} -> out_norm
  class_emb       embedding -> weight ([num_classes, 4C], same layout)

Layouts: conv kernels HWIO -> OIHW, Dense [in, out] -> [out, in], the 1-D
attention kernels (1, C, K) -> [K, C] (qkv channel order kept), norm
`scale` -> `weight`; Inception's BatchNorm `batch_stats` (`mean`, `var`)
keep their names.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_RES_CHILDREN = {"Conv_0": "in_conv", "Dense_0": "emb_dense",
                 "Conv_1": "out_conv", "Conv_2": "skip",
                 "GroupNorm32_0": "in_norm", "FusedNormAct_0": "in_norm",
                 "GroupNorm32_1": "out_norm", "FusedNormAct_1": "out_norm"}
_ATTN_CHILDREN = {"GroupNorm32_0": "norm", "FusedNormAct_0": "norm",
                  "qkv": "qkv", "Conv_0": "proj"}
_RESAMPLE_CHILDREN = {"Conv_0": "conv"}


def _flatten(tree: Mapping, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _leaf(leaf: str, value: np.ndarray) -> tuple:
    """(port parameter name, value in the port's layout)."""
    if leaf == "scale":
        return "weight", value
    if leaf == "bias":
        return "bias", value
    if leaf == "embedding":
        return "weight", value
    if leaf != "kernel":
        raise KeyError(f"unknown flax leaf {leaf!r}")
    if value.ndim == 4:                      # conv HWIO -> OIHW
        return "weight", value.transpose(3, 2, 0, 1)
    if value.ndim == 3:                      # 1-D conv (1, C, K) -> [K, C]
        return "weight", value[0].T
    return "weight", value.T                 # Dense [in, out] -> [out, in]


def unet_state_dict_from_flax(params: Mapping) -> dict:
    """Nested dict of arrays (with or without the top "params" level) ->
    {port state_dict key: float32 tensor}. Every leaf maps to one key."""
    if set(params) == {"params"}:
        params = params["params"]
    children_of = {}
    for path in _flatten(params):
        children_of.setdefault(path[0], set()).add(path[1])
    out = {}
    for path, value in _flatten(params).items():
        block = path[0]
        if block in ("time_dense_0", "time_dense_1", "conv_in", "conv_out",
                     "class_emb"):
            names = [block]
            leaf = path[1]
        elif block == "out_norm":
            names = [block]
            leaf = path[-1]  # GroupNorm_0/{scale,bias} or {scale,bias}
        else:
            children = children_of[block]
            if "Dense_0" in children:
                table = _RES_CHILDREN
            elif "qkv" in children:
                table = _ATTN_CHILDREN
            else:
                table = _RESAMPLE_CHILDREN
            names = [block, table[path[1]]]
            leaf = path[-1]
        name, arr = _leaf(leaf, value)
        key = ".".join(names + [name])
        if key in out:
            raise KeyError(f"two flax leaves map to {key}")
        out[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    return out


def wrapper_state_dict_from_flax(params: Mapping) -> dict:
    """The flax tree of `models/unet.py:UNetModelWrapper` (the UNet under
    `net/`, with or without the top "params" level) -> the port wrapper's
    state_dict."""
    if set(params) == {"params"}:
        params = params["params"]
    return {f"net.{k}": v
            for k, v in unet_state_dict_from_flax(params["net"]).items()}


def heads_state_dict_from_flax(params: Mapping) -> dict:
    """A dict of wrapper trees ({head: flax tree}, e.g. SF2M's flow and
    score) -> the state_dict of an `nn.ModuleDict` of port wrappers."""
    return {f"{head}.{k}": v for head, tree in params.items()
            for k, v in wrapper_state_dict_from_flax(tree).items()}


def feature_state_dict_from_flax(variables: Mapping) -> dict:
    """A feature network's flax variables ({"params": ..., "batch_stats":
    ...}, or the params alone) -> {port state_dict key: float32 tensor}."""
    out = {}
    for path, value in _flatten(variables).items():
        if path[0] in ("params", "batch_stats"):
            path = path[1:]
        *names, leaf = path
        name, arr = ((leaf, value) if leaf in ("mean", "var")
                     else _leaf(leaf, value))
        out[".".join(names + [name])] = torch.from_numpy(
            np.array(arr, np.float32, order="C"))
    return out


# the GVP denoiser's parameter paths: a GVP's four Dense layers, and the
# LayerNorm inside each GVPLayerNorm
_GVP_BLOCK = r"(W_v|W_e|W_out|conv_\d+\.GVP_\d+)"
_GVP_NAMES = re.compile(
    _GVP_BLOCK + r"\.(wh\.weight|wv\.weight|ws\.(weight|bias)"
    r"|wsv\.(weight|bias))$")
_GVP_NORM_NAMES = re.compile(
    r"(W_e_norm|out_norm|conv_\d+\.GVPLayerNorm_[01])\.LayerNorm_0\."
    r"(weight|bias)$")


def gvp_denoiser_state_dict_from_flax(params: Mapping) -> dict:
    """The flax tree of `tpu_diffusion/protein/denoiser.py:GVPDenoiser`
    (with or without the top "params" level) -> the port's state_dict:
    Dense `kernel` [in, out] -> `weight` [out, in], `bias` kept, LayerNorm
    `scale` -> `weight`. A name the port's model does not have, or a
    missing one (a GVP without `ws`, a norm without its scale or bias, a
    conv layer without its two norms, or one of `W_v`, `W_e`, `W_e_norm`,
    `out_norm`, `W_out` absent), raises KeyError."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, value in _flatten(params).items():
        name, arr = _leaf(path[-1], value)
        key = ".".join(list(path[:-1]) + [name])
        if not (_GVP_NAMES.match(key) or _GVP_NORM_NAMES.match(key)):
            raise KeyError(f"{'/'.join(path)} has no counterpart in the "
                           f"port's GVPDenoiser")
        out[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    gvps = {"W_v", "W_e", "W_out"} | {
        m.group(1) for m in map(_GVP_NAMES.match, out) if m}
    norms = {"W_e_norm", "out_norm"} | {
        m.group(1) for m in map(_GVP_NORM_NAMES.match, out) if m} | {
        f"{k.split('.')[0]}.GVPLayerNorm_{i}" for k in out
        if k.startswith("conv_") for i in (0, 1)}
    missing = sorted(
        [f"{b}.ws.{leaf}" for b in gvps for leaf in ("weight", "bias")]
        + [f"{b}.LayerNorm_0.{leaf}" for b in norms
           for leaf in ("weight", "bias")])
    missing = [k for k in missing if k not in out]
    if missing:
        raise KeyError(f"the flax tree lacks {missing}")
    return out


@torch.no_grad()
def load_flax_npz(module: torch.nn.Module, arrays: Mapping) -> None:
    """Load the `params/...` and `batch_stats/...` entries of an .npz of a
    flax variable tree (path parts joined by "/", as the JAX package's
    loaders read it) into `module`, one of the feature networks; other
    entries are ignored. A missing entry raises KeyError, a shape mismatch
    ValueError, as in the JAX package."""
    tree: dict = {}
    for key, arr in arrays.items():
        parts = key.split("/")
        if parts[0] not in ("params", "batch_stats"):
            continue
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    loaded = feature_state_dict_from_flax(tree)
    own = module.state_dict()
    missing = sorted(set(own) - set(loaded))
    if missing:
        raise KeyError(f"weights missing {len(missing)} entries, e.g. "
                       f"{missing[:3]}")
    for key, value in own.items():
        if tuple(loaded[key].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(loaded[key].shape)} vs "
                             f"{tuple(value.shape)}")
        value.copy_(loaded[key])


@torch.no_grad()
def load_flax_train_state(state, params: Mapping,
                          ema_params: Mapping | None = None, step: int = 0,
                          ema_count: int = 0):
    """A JAX `TrainState`'s `params` and `ema.params` (flax trees of numpy
    arrays), its `step` and its EMA counter into the port's train state
    (`train/trainer.py:TrainState`), in place, so that both packages take
    the same step from the same state. The optimizer's moments are not
    carried: the state must be fresh on both sides. A tree with a `net`
    level is a CFM wrapper's; a tree without `params` or `net` at its top,
    a dict of wrappers' (`heads_state_dict_from_flax`)."""
    if state.optimizer.count:
        raise ValueError("the optimizer has taken steps: its moments cannot "
                         "be carried over")
    tree = params.get("params", params)
    if "net" in tree:
        convert = wrapper_state_dict_from_flax
    elif all(isinstance(v, Mapping) and ("net" in v.get("params", v))
             for v in tree.values()):
        convert = heads_state_dict_from_flax
    else:
        convert = unet_state_dict_from_flax
    state.model.load_state_dict(convert(params))
    ema = convert(params if ema_params is None else ema_params)
    for name, value in state.ema.params.items():
        value.copy_(ema[name])
    state.step = step
    state.ema.count = ema_count
    return state
