from tpu_diffusion_torch.losses.ddpm import (amortized_ddpm_loss, ddpm_loss,
                                             get_loss_function,
                                             make_eps_model,
                                             weighted_mask_loss)

__all__ = ["amortized_ddpm_loss", "ddpm_loss", "get_loss_function",
           "make_eps_model", "weighted_mask_loss"]
