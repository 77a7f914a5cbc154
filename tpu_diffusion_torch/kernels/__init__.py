"""Hand-written Hopper kernels, each beside its plain PyTorch version."""


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would need the gradient of a kernel that has
    none. The JAX package's counterpart raises too: `jax.grad` through a
    Pallas call without a custom VJP fails. The kernel writes its output
    through a raw pointer, so it would otherwise come back detached and
    the gradient would be silently lost."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (nor has the JAX package's kernel): "
            f"call it under torch.no_grad(), or train with the plain "
            f"version (norm_impl='plain')")
