"""Weights from the JAX package's UNet param tree into the port's state_dict.

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

Layouts: conv kernels HWIO -> OIHW, Dense [in, out] -> [out, in], the 1-D
attention kernels (1, C, K) -> [K, C] (qkv channel order kept), norm
`scale` -> `weight`.
"""

from __future__ import annotations

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
        if block in ("time_dense_0", "time_dense_1", "conv_in", "conv_out"):
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


@torch.no_grad()
def load_flax_train_state(state, params: Mapping,
                          ema_params: Mapping | None = None, step: int = 0,
                          ema_count: int = 0):
    """A JAX `TrainState`'s `params` and `ema.params` (flax trees of numpy
    arrays), its `step` and its EMA counter into the port's train state
    (`train/trainer.py:TrainState`), in place, so that both packages take
    the same step from the same state. The optimizer's moments are not
    carried: the state must be fresh on both sides."""
    if state.optimizer.count:
        raise ValueError("the optimizer has taken steps: its moments cannot "
                         "be carried over")
    state.model.load_state_dict(unet_state_dict_from_flax(params))
    ema = unet_state_dict_from_flax(params if ema_params is None
                                    else ema_params)
    for name, value in state.ema.params.items():
        value.copy_(ema[name])
    state.step = step
    state.ema.count = ema_count
    return state
