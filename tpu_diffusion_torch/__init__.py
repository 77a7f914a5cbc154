"""PyTorch/CUDA port of `tpu_diffusion` for one NVIDIA H100.

Ported so far: the DDPM process, the UNet (full / encode / decode; attention
by the fused-QKV kernel, the flash kernels or plain einsums), the flax
weight converter, the DDIM samplers, and the conditional-generation path of
`cli/main.py --mode eval`: likelihoods, conditioning mechanisms, the prior,
amortized (plain and encoder-reuse), reconstruction-guidance and replacement
ancestral samplers, MSE/PSNR/SSIM, the experiment config and the dataset
registry; the fused-inference engine (`models/unet_infer.py`) with the
whole-ResBlock kernel; DDPM training (`losses/ddpm.py`, `core/ema.py`,
`train/`) through `cli/main.py --mode train|all`; LPIPS and FID
(`eval/lpips.py`, `eval/fid.py`, `eval/inception.py`) in `run_eval`; and
CIFAR-10 conditional flow matching (`losses/cfm.py`, `sampling/ode.py`,
`UNetModelWrapper`, `cli/train_cifar10.py`, `cli/compute_fid.py`); the
conditional CFM CLIs and the VP-SDE samplers; and the protein backbone
diffusion stack (`protein/`, `cli/train_protein.py`,
`cli/sample_protein.py`) with `Trainer.fit_scanned` and the
device-resident batch samplers (`data/device_cache.py`).
Hand-written Hopper kernels are in `kernels/`.
"""

from tpu_diffusion_torch.conditioning import (Amortized, HyperResolution,
                                              InPainting, OutPainting,
                                              ReconstructionGuidance,
                                              Replacement, get_conditioning,
                                              get_likelihood)
from tpu_diffusion_torch.convert import (load_flax_train_state,
                                         unet_state_dict_from_flax)
from tpu_diffusion_torch.core.schedules import DDPM
from tpu_diffusion_torch.eval.metrics import eval_statistics
from tpu_diffusion_torch.losses.ddpm import make_eps_model
from tpu_diffusion_torch.models.unet import create_model
from tpu_diffusion_torch.models.unet_infer import (FusedUNetInference,
                                                   make_fused_apply)
from tpu_diffusion_torch.sampling.ancestral import (
    make_cached_amortized_sampler, make_cached_ddim_sampler,
    make_conditional_sampler, make_ddim_sampler, make_prior_sampler)
from tpu_diffusion_torch.utils.config import apply_overrides, get_config

__all__ = ["Amortized", "DDPM", "FusedUNetInference", "HyperResolution",
           "InPainting", "load_flax_train_state", "make_fused_apply",
           "OutPainting", "ReconstructionGuidance", "Replacement",
           "apply_overrides", "create_model", "eval_statistics",
           "get_conditioning", "get_config", "get_likelihood",
           "make_cached_amortized_sampler", "make_cached_ddim_sampler",
           "make_conditional_sampler", "make_ddim_sampler", "make_eps_model",
           "make_prior_sampler", "unet_state_dict_from_flax"]
