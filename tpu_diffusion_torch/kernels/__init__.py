"""Hand-written Hopper kernels, each beside its plain PyTorch version."""


def refuse_grad(name: str, *tensors,
                hint: str = "or differentiate its plain version") -> None:
    """Raise where autograd would need the gradient of a launch that has
    none. The JAX package's counterpart raises too: `jax.grad` through a
    Pallas call without a custom VJP fails. The kernel writes its output
    through a raw pointer, so it would otherwise come back detached and
    the gradient would be silently lost."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: call it under "
                           f"torch.no_grad(), {hint}")
