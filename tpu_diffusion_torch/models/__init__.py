from tpu_diffusion_torch.models.unet import UNetModel, create_model

__all__ = ["UNetModel", "create_model"]
