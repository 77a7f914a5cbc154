from tpu_diffusion_torch.losses.cfm import (cfm_loss, get_matcher,
                                            host_ot_pairs)
from tpu_diffusion_torch.losses.ddpm import (amortized_ddpm_loss, ddpm_loss,
                                             get_loss_function,
                                             make_eps_model,
                                             weighted_mask_loss)

__all__ = ["amortized_ddpm_loss", "cfm_loss", "ddpm_loss",
           "get_loss_function", "get_matcher", "host_ot_pairs",
           "make_eps_model", "weighted_mask_loss"]
