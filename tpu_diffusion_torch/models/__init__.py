from tpu_diffusion_torch.models.unet import (InPaintModelWrapper,
                                             SuperResModelWrapper, UNetModel,
                                             UNetModelWrapper, create_model)

__all__ = ["InPaintModelWrapper", "SuperResModelWrapper", "UNetModel",
           "UNetModelWrapper", "create_model"]
