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
device-resident batch samplers (`data/device_cache.py`); the protein
evaluation (`protein/evaluate.py`, the novelty scan over
`native/novelty.cpp`, the self-consistency stage with the CA-ProteinMPNN),
the SO(3)/SE(3) diffusers, the storage layer, `eval/f1max.py`,
`utils/debug.py` and `utils/logging.py`; and parallelism over
`torch.distributed` (`parallel/`: the ("data", "model") mesh, tensor and
ring-attention sequence parallelism) in the UNet, the Trainer and the CLIs.
Hand-written Hopper kernels are in `kernels/`.

The names below load on first use, so importing a submodule that needs no
torch (`protein.evaluate`, `protein.novelty`) loads none: a spawned worker
that unpickles a function from one starts in a fraction of a second.
"""

import importlib

# name -> the module that defines it
_LAZY = {
    "Amortized": "conditioning", "HyperResolution": "conditioning",
    "InPainting": "conditioning", "OutPainting": "conditioning",
    "ReconstructionGuidance": "conditioning", "Replacement": "conditioning",
    "get_conditioning": "conditioning", "get_likelihood": "conditioning",
    "load_flax_train_state": "convert",
    "unet_state_dict_from_flax": "convert",
    "DDPM": "core.schedules",
    "eval_statistics": "eval.metrics",
    "make_eps_model": "losses.ddpm",
    "create_model": "models.unet",
    "FusedUNetInference": "models.unet_infer",
    "make_fused_apply": "models.unet_infer",
    "make_cached_amortized_sampler": "sampling.ancestral",
    "make_cached_ddim_sampler": "sampling.ancestral",
    "make_conditional_sampler": "sampling.ancestral",
    "make_ddim_sampler": "sampling.ancestral",
    "make_prior_sampler": "sampling.ancestral",
    "apply_overrides": "utils.config", "get_config": "utils.config",
}

__all__ = ["Amortized", "DDPM", "FusedUNetInference", "HyperResolution",
           "InPainting", "load_flax_train_state", "make_fused_apply",
           "OutPainting", "ReconstructionGuidance", "Replacement",
           "apply_overrides", "create_model", "eval_statistics",
           "get_conditioning", "get_config", "get_likelihood",
           "make_cached_amortized_sampler", "make_cached_ddim_sampler",
           "make_conditional_sampler", "make_ddim_sampler", "make_eps_model",
           "make_prior_sampler", "unet_state_dict_from_flax"]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"),
                    name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
