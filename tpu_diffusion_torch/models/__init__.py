from tpu_diffusion_torch.models.unet import (UNetModel, UNetModelWrapper,
                                             create_model)

__all__ = ["UNetModel", "UNetModelWrapper", "create_model"]
