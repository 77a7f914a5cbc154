from tpu_diffusion_torch.utils.config import (ConfigDict, apply_overrides,
                                              get_config)

__all__ = ["ConfigDict", "apply_overrides", "get_config"]
