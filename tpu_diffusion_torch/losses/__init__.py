from tpu_diffusion_torch.losses.ddpm import get_loss_function, make_eps_model

__all__ = ["get_loss_function", "make_eps_model"]
