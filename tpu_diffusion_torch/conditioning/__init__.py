from tpu_diffusion_torch.conditioning.guidance import (CONDITIONINGS,
                                                       Amortized,
                                                       Conditioning,
                                                       ReconstructionGuidance,
                                                       Replacement,
                                                       get_conditioning)
from tpu_diffusion_torch.conditioning.likelihoods import (LIKELIHOODS,
                                                          HyperResolution,
                                                          InPainting,
                                                          Likelihood,
                                                          OutPainting,
                                                          Painting,
                                                          get_likelihood)

__all__ = ["Amortized", "CONDITIONINGS", "Conditioning", "HyperResolution",
           "InPainting", "LIKELIHOODS", "Likelihood", "OutPainting",
           "Painting", "ReconstructionGuidance", "Replacement",
           "get_conditioning", "get_likelihood"]
