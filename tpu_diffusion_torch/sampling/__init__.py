from tpu_diffusion_torch.sampling.ancestral import (
    make_cached_amortized_sampler, make_cached_ddim_sampler,
    make_conditional_sampler, make_ddim_sampler, make_prior_sampler,
    process_x0, randn_noise)
from tpu_diffusion_torch.sampling.ode import odeint
from tpu_diffusion_torch.sampling.sde import (euler_maruyama,
                                              predictor_corrector,
                                              probability_flow,
                                              reverse_sde_sampler_from_eps)

__all__ = ["euler_maruyama", "make_cached_amortized_sampler",
           "make_cached_ddim_sampler", "make_conditional_sampler",
           "make_ddim_sampler", "make_prior_sampler", "odeint",
           "predictor_corrector", "probability_flow", "process_x0",
           "randn_noise", "reverse_sde_sampler_from_eps"]
