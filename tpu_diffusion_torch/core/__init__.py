from tpu_diffusion_torch.core.ema import EMAState, ema_update
from tpu_diffusion_torch.core.schedules import (DDPM, VPSDE, bcast_right,
                                                linear_vpsde_betas)

__all__ = ["DDPM", "EMAState", "VPSDE", "bcast_right", "ema_update",
           "linear_vpsde_betas"]
