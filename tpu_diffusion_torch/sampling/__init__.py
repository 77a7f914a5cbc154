from tpu_diffusion_torch.sampling.ancestral import (
    make_cached_amortized_sampler, make_cached_ddim_sampler,
    make_conditional_sampler, make_ddim_sampler, make_prior_sampler,
    process_x0, randn_noise)
from tpu_diffusion_torch.sampling.ode import odeint

__all__ = ["make_cached_amortized_sampler", "make_cached_ddim_sampler",
           "make_conditional_sampler", "make_ddim_sampler",
           "make_prior_sampler", "odeint", "process_x0", "randn_noise"]
