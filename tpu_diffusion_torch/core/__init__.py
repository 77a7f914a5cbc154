from tpu_diffusion_torch.core.ema import EMAState, ema_update
from tpu_diffusion_torch.core.schedules import (
    DDPM, VPSDE, bcast_right, betas_from_alphas_cumprod,
    cosine_alphas_cumprod, hoogeboom_alphas_cumprod, linear_betas,
    linear_vpsde_betas, quadratic_betas, sigmoid_betas)

__all__ = ["DDPM", "EMAState", "VPSDE", "bcast_right",
           "betas_from_alphas_cumprod", "cosine_alphas_cumprod",
           "ema_update", "hoogeboom_alphas_cumprod", "linear_betas",
           "linear_vpsde_betas", "quadratic_betas", "sigmoid_betas"]
