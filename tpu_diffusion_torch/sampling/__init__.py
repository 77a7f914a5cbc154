from tpu_diffusion_torch.sampling.ancestral import (make_cached_ddim_sampler,
                                                   make_ddim_sampler,
                                                   process_x0)

__all__ = ["make_cached_ddim_sampler", "make_ddim_sampler", "process_x0"]
