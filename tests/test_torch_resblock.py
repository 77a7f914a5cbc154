"""The port's whole-ResBlock function against the JAX package's, on the CPU.

On a CPU tensor `fused_resblock` takes its plain version,
`resblock_reference`; it is held against the Pallas kernel in interpret mode
and against the JAX package's jnp mirror, on the same numpy inputs, in fp32.
The CUDA kernel itself runs only on the card (tests/test_torch_cuda_kernels.py
and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.kernels import resblock as jax_resblock
from tpu_diffusion_torch.kernels import resblock


def _args(rng, b, h, w, cin, cout, scale_shift):
    def mk(*shape, scale=0.1):
        return rng.normal(size=shape, scale=scale).astype(np.float32)

    skip = cin != cout
    return (mk(b, h, w, cin, scale=1.0), 1 + mk(cin), mk(cin),
            mk(3, 3, cin, cout), mk(cout), 1 + mk(cout), mk(cout),
            1.0 + mk(b, cout) if scale_shift else None, mk(b, cout),
            mk(3, 3, cout, cout), mk(cout),
            mk(cin, cout) if skip else None, mk(cout) if skip else None)


def _torch(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


# tests/test_kernels.py's three cases, and 48 channels: 24 groups, not 32
@pytest.mark.parametrize("cin,cout,scale_shift", [
    (32, 32, True), (32, 64, True), (64, 32, False), (48, 48, True)])
def test_resblock_matches_pallas_kernel_and_jnp_mirror(cin, cout, scale_shift):
    args = _args(np.random.default_rng(0), 4, 8, 8, cin, cout, scale_shift)
    got = resblock.fused_resblock(*_torch(args)).numpy()
    assert got.shape == (4, 8, 8, cout)
    mirror = np.asarray(jax_resblock.resblock_reference(*_jax(args)))
    kernel = np.asarray(jax_resblock.fused_resblock(*_jax(args),
                                                    interpret=True))
    # fp32 on both sides: the order of the sums
    np.testing.assert_allclose(got, mirror, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, kernel, atol=2e-5, rtol=1e-4)


def test_group_counts_follow_the_jax_package():
    for c in (8, 32, 48, 100, 128, 384):
        assert resblock._num_groups(c) == jax_resblock._num_groups(c)
    assert resblock._num_groups(48) == 24


def test_resblock_rounds_activations_to_bf16_like_the_jnp_mirror():
    """In bf16 the plain version rounds where the JAX mirror rounds (after
    each SiLU, the weights, the output), so the two agree to a few bf16
    ulps of the output (2^-8 relative each)."""
    args = _args(np.random.default_rng(1), 2, 8, 8, 32, 64, True)
    targs = [None if a is None else a.bfloat16() if a.ndim > 1 else a
             for a in _torch(args)]
    jargs = [None if a is None else
             jnp.asarray(a.float().numpy()).astype(
                 jnp.bfloat16 if a.dtype == torch.bfloat16 else jnp.float32)
             for a in targs]
    got = resblock.fused_resblock(*targs)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_resblock.resblock_reference(*jargs).astype(
        jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2,
                               rtol=2e-2)


def test_wrapper_checks_its_arguments():
    args = _torch(_args(np.random.default_rng(2), 2, 8, 8, 32, 32, True))
    with pytest.raises(ValueError, match="HWIO"):
        resblock.fused_resblock(*args[:3], args[3].permute(3, 2, 0, 1),
                                *args[4:])
    with pytest.raises(ValueError, match="identity skip"):
        bad = _torch(_args(np.random.default_rng(2), 2, 8, 8, 32, 64, True))
        resblock.fused_resblock(*bad[:11])
    with pytest.raises(ValueError, match="come together"):
        resblock.fused_resblock(*args[:11], torch.zeros(32, 32), None)
    with pytest.raises(ValueError, match="CUDA tensor"):
        resblock._launch(*args, eps=1e-5, groups=32)
