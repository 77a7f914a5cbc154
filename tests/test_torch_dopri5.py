"""The port's dopri5 integrators against the JAX package's, on the CPU.

The fixed-trip-count masked scan, `Dopri5Chunked`, `calibrate_dopri5_steps`
and `dopri5_platform_kwargs` against their JAX counterparts on a linear
field, and the graphed early exit (`graphs=`: replays of a one-trip
masked body) bitwise against the eager loop on a tiny CFM UNet.

The field: dx/dt = x A^T + t with A = 4 [[-1, 0.5], [-0.5, -0.2]], at
rtol = atol = 1e-4 (six trips). On a smooth field at a tight tolerance the
error estimate x5 - x4 is mostly rounding, which XLA's fused arithmetic
and the port's op-by-op arithmetic round differently, and the controllers
then take other steps (the JAX test's sin field at 1e-6: 85 NFE under
`jax.jit`, 73 op by op and in the port); here the truncation error
dominates and both take the same steps (x within 1e-7).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.sampling import ode as jax_ode
from tpu_diffusion_torch.models.unet import UNetModelWrapper, randomize_
from tpu_diffusion_torch.sampling import ode
from tpu_diffusion_torch.sampling.graph import GraphCache

A = (4.0 * np.array([[-1.0, 0.5], [-0.5, -0.2]])).astype(np.float32)
TOL = dict(rtol=1e-4, atol=1e-4)
X_ATOL = 1e-6


def _fields():
    def jv(t, x):
        return x @ A.T + t

    def pv(t, x):
        return x @ torch.from_numpy(A).T + t

    x0 = np.random.default_rng(6).standard_normal((3, 2)).astype(np.float32)
    return jv, pv, x0


@pytest.mark.parametrize("max_steps", [64, 3])
def test_fixed_trip_count_matches_jax_and_the_early_exit(max_steps):
    """`max_steps` masked trips: the early exit's x bitwise and its NFE,
    and JAX's fixed-trip scan's NFE and x to 1e-6. A budget of 3 trips
    truncates both; its x is compared with JAX's by NFE only, since the
    first steps' error estimates are rounding (the first step is 1/100 of
    the interval) and the two sides stop at other times short of t1."""
    jv, pv, x0 = _fields()
    want, want_nfe = jax.jit(lambda x: jax_ode.odeint_dopri5(
        jv, x, max_steps=max_steps, fixed_trip_count=True, **TOL))(
            jnp.asarray(x0))
    got, nfe = ode.odeint_dopri5(pv, torch.from_numpy(x0),
                                 max_steps=max_steps, fixed_trip_count=True,
                                 **TOL)
    early, early_nfe = ode.odeint_dopri5(pv, torch.from_numpy(x0),
                                         max_steps=max_steps, **TOL)
    assert nfe == early_nfe == int(want_nfe)
    assert nfe == (37 if max_steps == 64 else 1 + 6 * 3)
    assert torch.equal(got, early)
    if max_steps == 64:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=X_ATOL)


@pytest.mark.parametrize("budget,chunk", [(64, 16), (64, 64), (64, 7),
                                          (10, 64)])
def test_chunked_equals_one_masked_scan_and_jax(budget, chunk):
    """JAX's four (budget, chunk) pairs: segments that divide the budget,
    exceed it and straddle it; bitwise the port's single masked scan of
    `total_steps` trips with its NFE, and JAX's `Dopri5Chunked` to 1e-6."""
    jv, pv, x0 = _fields()
    chunked = ode.Dopri5Chunked(pv, max_steps=budget, chunk_steps=chunk,
                                **TOL)
    assert chunked.n_segments == -(-budget // chunk)
    assert chunked.total_steps == chunked.n_segments * chunk >= budget
    got, nfe = chunked(torch.from_numpy(x0))
    want, want_nfe = ode.odeint_dopri5(
        pv, torch.from_numpy(x0), max_steps=chunked.total_steps,
        fixed_trip_count=True, **TOL)
    assert nfe == want_nfe and torch.equal(got, want)
    jx, jnfe = jax_ode.Dopri5Chunked(jv, max_steps=budget, chunk_steps=chunk,
                                     **TOL)(jnp.asarray(x0))
    assert nfe == int(jnfe)
    np.testing.assert_allclose(got.numpy(), np.asarray(jx), rtol=0,
                               atol=X_ATOL)
    again, _ = chunked(torch.from_numpy(x0), sync=False)
    assert torch.equal(again, got) and chunked.graphs.captures == 1


def test_calibrate_and_platform_kwargs_match_jax():
    """The calibrated budget from one early-exit run, and the platform's
    kwargs off a TPU ({}: the early exit)."""
    jv, pv, x0 = _fields()
    for margin, min_steps in ((1.5, 16), (1.5, 2), (2.5, 2)):
        want = jax_ode.calibrate_dopri5_steps(
            jv, jnp.asarray(x0), margin=margin, min_steps=min_steps, **TOL)
        got = ode.calibrate_dopri5_steps(pv, torch.from_numpy(x0),
                                         margin=margin, min_steps=min_steps,
                                         **TOL)
        assert got == want
    assert ode.calibrate_dopri5_steps(pv, torch.from_numpy(x0),
                                      min_steps=2, **TOL) == 11
    assert ode.dopri5_platform_kwargs() == {} == \
        jax_ode.dopri5_platform_kwargs()


@pytest.fixture(scope="module")
def cfm_unet():
    v = UNetModelWrapper((16, 16, 3), num_channels=16, num_res_blocks=1,
                         channel_mult=(1, 2), num_heads=2,
                         attention_resolutions="8", dtype=torch.float32,
                         device="cpu")
    randomize_(v, torch.Generator().manual_seed(8)).eval()
    x0 = torch.randn((2, 16, 16, 3), generator=torch.Generator()
                     .manual_seed(9))
    return v.requires_grad_(False), x0


@pytest.mark.parametrize("max_steps,fixed_trip_count",
                         [(40, False), (5, False), (40, True), (5, True)])
def test_graphed_early_exit_equals_the_eager_loop(cfm_unet, max_steps,
                                                  fixed_trip_count):
    """A width-16 CFM UNet: replays of the one-trip body under a budget
    the run finishes within or (5 trips) one it uses up, ending at the
    first `done` or running every trip: x bitwise and the NFE of the
    eager loop; a second call replays the same chain."""
    v, x0 = cfm_unet
    kw = dict(rtol=1e-2, atol=1e-2, max_steps=max_steps)
    with torch.no_grad():
        want, want_nfe = ode.odeint_dopri5(v, x0, **kw)
        graphs = GraphCache(v)
        got, nfe = ode.odeint(v, x0, "dopri5", graphs=graphs,
                              fixed_trip_count=fixed_trip_count, **kw)
        again, _ = ode.odeint_dopri5(v, x0, graphs=graphs,
                                     fixed_trip_count=fixed_trip_count, **kw)
    assert nfe == want_nfe and torch.equal(got, want)
    assert torch.equal(again, got) and graphs.captures == 1
    assert ode.dopri5_truncated(nfe, max_steps) == (max_steps == 5)
    chain, = graphs.chains.values()
    assert set(chain.bodies) == {"init", 1}
    trips = (nfe - 1) // 6
    assert chain.replays[1] == 2 * (max_steps if fixed_trip_count
                                    else trips)


def test_chunked_cache_follows_the_module_field(cfm_unet):
    """`Dopri5Chunked` given no cache keys its own on the field's
    parameters: an in-place update recaptures, and the result is a fresh
    integrator's on the updated field."""
    v, x0 = cfm_unet
    v = copy.deepcopy(v)
    kw = dict(rtol=1e-2, atol=1e-2, max_steps=8, chunk_steps=3)
    chunked = ode.Dopri5Chunked(v, **kw)
    with torch.no_grad():
        before, _ = chunked(x0)
        next(v.parameters()).mul_(0.5)
        got, nfe = chunked(x0)
        want, want_nfe = ode.Dopri5Chunked(v, **kw)(x0)
    assert chunked.graphs.captures == 2
    assert nfe == want_nfe and torch.equal(got, want)
    assert not torch.equal(got, before)
