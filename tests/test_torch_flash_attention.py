"""The port's flash attention against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain versions; they are held against the
JAX `flash_attention` (forward, `_flash_attention_3d`'s lse, and its custom
VJP) with the Pallas kernels in interpret mode, on inputs made with numpy.
The hand-written CUDA kernels against the plain versions are in
`test_torch_cuda_kernels.py` (skipped without a card) and `chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.kernels.attention import (_flash_attention_3d,
                                             flash_attention as jax_flash)
from tpu_diffusion_torch.kernels import attention


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


def _qkvg(seed, shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(4))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# (B, H, T, d, Pallas block_q): tests/test_kernels.py's shapes (t=128 and the
# uneven t=96, d=32), and the 64px UNet's token count T=1024
FWD_CASES = [(2, 4, 128, 32, 64), (1, 2, 96, 32, 64), (1, 2, 1024, 32, 256)]


@pytest.mark.parametrize("b,h,t,d,bq", FWD_CASES)
def test_forward_matches_jax_kernel(interpret, b, h, t, d, bq):
    q, k, v, _ = _qkvg(t + d, (b, h, t, d))
    want = np.asarray(jax_flash(q, k, v, bq))
    _, want_lse = _flash_attention_3d(
        *(jnp.asarray(x).reshape(b * h, t, d) for x in (q, k, v)), bq)
    before = attention.flash_fwd_launches
    o, lse = attention.flash_attention_fwd(
        *(x.reshape(b * h, t, d) for x in _t(q, k, v)))
    # fp32 logits and softmax on both sides; sums taken in another order
    np.testing.assert_allclose(o.reshape(b, h, t, d).numpy(), want,
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want_lse)[:, 0, :], atol=2e-5,
                               rtol=2e-5)
    assert lse.dtype == torch.float32 and lse.shape == (b * h, t)
    # a CPU tensor takes the plain version: no kernel launch
    assert attention.flash_fwd_launches == before
    got = attention.flash_attention(*_t(q, k, v))
    assert torch.equal(got, o.reshape(b, h, t, d))


# the last four: the shapes at which the card holds the one-pass kernel
# against `flash_attention_bwd_ref` (T=16, an uneven T at d=64 over two key
# blocks of 128, d=128, one 64-row tile at d=64)
@pytest.mark.parametrize("b,h,t,d,bq", [(1, 2, 64, 32, 32),
                                        (1, 2, 96, 32, 64),
                                        (1, 2, 16, 32, 16),
                                        (1, 2, 200, 64, 64),
                                        (1, 1, 96, 128, 32),
                                        (2, 1, 64, 64, 64)])
def test_backward_matches_jax_grad(interpret, b, h, t, d, bq):
    """The recompute formulas of the plain backward, and the autograd
    Function built on them, against `jax.grad` through the Pallas custom
    VJP (as tests/test_kernels.py:45-58)."""
    q, k, v, _ = _qkvg(7 * t, (b, h, t, d))

    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, bq) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (x.reshape(b * h, t, d) for x in _t(q, k, v))
    o, lse = attention.flash_attention_fwd_ref(qt, kt, vt)
    g = 2 * o
    delta = (g * o).sum(-1)
    before = attention.flash_bwd_launches
    direct = attention.flash_attention_bwd(qt, kt, vt, g, lse, delta)
    leaves = tuple(x.clone().requires_grad_(True) for x in _t(q, k, v))
    via_autograd = torch.autograd.grad(
        (attention.flash_attention(*leaves) ** 2).sum(), leaves)
    assert attention.flash_bwd_launches == before
    for a, c, w in zip(direct, via_autograd, want):
        # fp32 on both sides; the JAX kernel sums T-long products in another
        # order
        np.testing.assert_allclose(a.reshape(b, h, t, d).numpy(),
                                   np.asarray(w), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(c.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("shape", [(3, 100, 32), (2, 2, 64, 64)])
def test_function_matches_autograd_of_dense_reference(shape):
    q, k, v, g = _t(*_qkvg(shape[-2], shape))
    leaves = tuple(x.clone().requires_grad_(True) for x in (q, k, v))
    o = attention.flash_attention(*leaves)
    got = torch.autograd.grad((o * g).sum(), leaves)
    ref_leaves = tuple(x.clone().requires_grad_(True) for x in (q, k, v))
    ref = attention.flash_attention_fwd_ref(*(
        x.reshape(-1, *shape[-2:]) for x in ref_leaves))[0]
    want = torch.autograd.grad((ref.reshape(shape) * g).sum(), ref_leaves)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-5, rtol=1e-5)


def test_plain_versions_keep_bf16_types():
    q, k, v, g = (x.to(torch.bfloat16) for x in _t(*_qkvg(0, (2, 64, 32))))
    o, lse = attention.flash_attention_fwd(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    delta = (g.float() * o.float()).sum(-1)
    grads = attention.flash_attention_bwd(q, k, v, g, lse, delta)
    assert all(x.dtype == torch.bfloat16 for x in grads)


def test_wrapper_checks_raise():
    q = torch.zeros((2, 16, 64))
    check = attention._check_flash
    with pytest.raises(ValueError, match="head_dim"):
        check("fwd", torch.zeros((2, 16, 48)))
    with pytest.raises(ValueError, match="head_dim"):
        check("fwd", torch.zeros((2, 2, 16, 64)))  # 4-D reaches the Function
    with pytest.raises(ValueError, match="bf16 or fp32"):
        check("fwd", q.half())
    with pytest.raises(ValueError, match="unsupported shape"):
        check("fwd", torch.zeros((0, 16, 64)))
    # a well-formed CPU tensor is refused by the kernel path: it has none
    with pytest.raises(ValueError, match="CUDA"):
        check("fwd", q, q=q)
