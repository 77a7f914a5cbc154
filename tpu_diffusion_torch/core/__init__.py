from tpu_diffusion_torch.core.schedules import (DDPM, bcast_right,
                                                linear_vpsde_betas)

__all__ = ["DDPM", "bcast_right", "linear_vpsde_betas"]
