"""PyTorch/CUDA port of `tpu_diffusion` for one NVIDIA H100.

This slice holds the DDIM sampling path of the CIFAR-10 UNet: the DDPM
tables, the UNet (full / encode / decode), the plain and encoder-reuse DDIM
samplers, the flax weight converter, and two hand-written Hopper kernels
(fused-QKV attention, GroupNorm+FiLM+SiLU) in `kernels/`.
"""

from tpu_diffusion_torch.convert import unet_state_dict_from_flax
from tpu_diffusion_torch.core.schedules import DDPM
from tpu_diffusion_torch.models.unet import create_model
from tpu_diffusion_torch.sampling.ancestral import (make_cached_ddim_sampler,
                                                   make_ddim_sampler)

__all__ = ["DDPM", "create_model", "make_cached_ddim_sampler",
           "make_ddim_sampler", "unet_state_dict_from_flax"]
