"""Build the same tiny UNet in the JAX package and in the port, from one seed.

The flax param tree takes its shapes from `jax.eval_shape` of the JAX
model's init and its values from numpy (N(0, 1/fan_in) for kernels, so the
zero-initialised output convs are nonzero and eps is not identically 0);
the port loads it through `unet_state_dict_from_flax`. Both models run in
fp32.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpu_diffusion.models.unet import UNetModel as JaxUNet
from tpu_diffusion_torch.convert import unet_state_dict_from_flax
from tpu_diffusion_torch.models.unet import UNetModel

# tests/test_kernels.py's tiny UNet, widened to 16 channels with 3 image
# channels; attention at the 8x8 level (ds=2) and in the middle block
TINY = dict(in_channels=3, model_channels=16, out_channels=3,
            num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(2,),
            num_heads=2, use_scale_shift_norm=True)

# the port's name for each JAX norm_impl
NORM_IMPLS = {"xla": "plain", "fused": "fused"}


@contextlib.contextmanager
def jax_kernels(norm_impl, monkeypatch):
    """Pallas kernels in interpret mode; FusedNormAct forced onto its kernel
    off the TPU for norm_impl="fused"."""
    from jax.experimental.pallas import tpu as pltpu
    if norm_impl == "fused":
        monkeypatch.setenv("TPU_DIFFUSION_FORCE_FUSED", "1")
    with pltpu.force_tpu_interpret_mode():
        yield


def random_params(jax_model, seed, in_channels=3):
    """A flax param tree for `jax_model`, drawn with numpy."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        jax_model.init, jax.random.PRNGKey(0),
        jnp.zeros((1, 16, 16, in_channels)), jnp.zeros((1,)))

    def draw(path, sd):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = int(np.prod(sd.shape[:-1]))
            v = rng.standard_normal(sd.shape) / np.sqrt(fan_in)
        elif leaf == "scale":
            v = 1 + 0.1 * rng.standard_normal(sd.shape)
        else:
            v = 0.1 * rng.standard_normal(sd.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def make_twins(norm_impl="xla", seed=0, **overrides):
    """(jax model, flax params, port model) with the same weights."""
    kw = {**TINY, **overrides}
    jax_model = JaxUNet(attention_impl="pallas_fused", norm_impl=norm_impl,
                        dtype=jnp.float32, **kw)
    params = random_params(jax_model, seed, kw["in_channels"])
    port = UNetModel(attention_impl="fused", norm_impl=NORM_IMPLS[norm_impl],
                     dtype=torch.float32, device="cpu", **kw)
    port.load_state_dict(unet_state_dict_from_flax(params))
    return jax_model, params, port
