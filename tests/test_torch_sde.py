"""The port's VP-SDE, SDE samplers, analytic Gaussian conditioning and sweep
tooling against the JAX package's, on the CPU in fp32.

The samplers' noise source replays the JAX key tree: Euler-Maruyama splits
(key, nk) per step and draws the step's noise from nk; predictor-corrector
splits (key, nk, ck) and draws the corrector's j-th noise from
fold_in(ck, j)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.cli import sweep as jax_sweep
from tpu_diffusion.core import analytic as jax_analytic
from tpu_diffusion.core.schedules import DDPM as JaxDDPM
from tpu_diffusion.core.schedules import VPSDE as JaxVPSDE
from tpu_diffusion.sampling import sde as jax_sde
from tpu_diffusion_torch.cli import sweep
from tpu_diffusion_torch.core import analytic
from tpu_diffusion_torch.core.schedules import DDPM, VPSDE
from tpu_diffusion_torch.sampling import sde

TOL = dict(rtol=1e-6, atol=1e-6)


def _np(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


# --- VPSDE -------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(beta_min=0.5, beta_max=10.0,
                                          tmin=1e-3, tmax=0.9)])
def test_vpsde_matches_jax(kw):
    js, ps = JaxVPSDE(**kw), VPSDE(**kw)
    rng = np.random.default_rng(0)
    t = np.linspace(0.05, 1.0, 5).astype(np.float32)
    x0, xt, score = (rng.standard_normal((5, 3, 2)).astype(np.float32)
                     for _ in range(3))
    jt, pt = jnp.asarray(t), _np(t)
    for name in ("int_beta", "beta", "scale", "sigma", "diffusion"):
        _close(getattr(ps, name)(pt), getattr(js, name)(jt))
    _close(ps.scale(0.3), js.scale(0.3))  # a number for t
    for got, want in zip(ps.marginal_prob(_np(x0), pt),
                         js.marginal_prob(x0, jt)):
        _close(got, want)
    _close(ps.drift(_np(xt), pt), js.drift(xt, jt))
    _close(ps.backward_drift(_np(score), _np(xt), pt),
           js.backward_drift(score, xt, jt))
    _close(ps.probability_flow_drift(_np(score), _np(xt), pt),
           js.probability_flow_drift(score, xt, jt))
    _close(ps.noise_score(_np(xt), _np(x0), pt), js.noise_score(xt, x0, jt),
           rtol=1e-6, atol=1e-5)  # up to ~400 at t = 0.05
    _close(ps.denoise_input(_np(score), _np(xt), pt),
           js.denoise_input(score, xt, jt))
    key = jax.random.PRNGKey(1)
    want_xt, want_eps = js.noise_input(key, x0, jt)
    got_xt, got_eps = ps.noise_input(None, _np(x0), pt, eps=_np(want_eps))
    _close(got_xt, want_xt)
    drawn, eps = ps.noise_input(torch.Generator().manual_seed(0), _np(x0),
                                pt)
    _close(drawn, ps.marginal_prob(_np(x0), pt)[0]
           + ps.marginal_prob(_np(x0), pt)[1] * eps)
    assert (ps.tmin, ps.tmax) == (js.tmin, js.tmax)


# --- the samplers ------------------------------------------------------------

MU0, VAR0 = 0.8, 0.05 ** 2


def _scores(nan_below=None):
    """The exact score of p_t for p0 = N(MU0, VAR0) in both packages
    (`core/analytic.py:marginal_score`, t broadcast over the batch); with
    `nan_below`, NaN in the first entry at t < nan_below."""
    def jscore(x, t):
        s = jax_analytic.marginal_score(JaxVPSDE(), MU0, VAR0, x,
                                        t.reshape(-1, 1))
        if nan_below is not None:
            s = s.at[0, 0].set(jnp.where(t[0] < nan_below, jnp.nan,
                                         s[0, 0]))
        return s

    def pscore(x, t):
        s = analytic.marginal_score(VPSDE(), MU0, VAR0, x, t.reshape(-1, 1))
        if nan_below is not None:
            s = s.clone()
            s[0, 0] = torch.where(t[0] < nan_below, torch.nan, s[0, 0])
        return s

    return jscore, pscore


def em_noise(key, num_steps):
    """Euler-Maruyama's draws: per step, key, nk = split(key)."""
    keys = []
    for _ in range(num_steps):
        key, nk = jax.random.split(key)
        keys.append(nk)

    def draw(like, kind, k, j=0):
        assert kind == "predictor" and k < num_steps - 1
        return _np(jax.random.normal(keys[k], tuple(like.shape)))
    return draw


def pc_noise(key, num_steps):
    """Predictor-corrector's draws: per step, key, nk, ck = split(key, 3);
    the corrector's j-th noise from fold_in(ck, j)."""
    keys = []
    for _ in range(num_steps):
        key, nk, ck = jax.random.split(key, 3)
        keys.append((nk, ck))

    def draw(like, kind, k, j=0):
        nk, ck = keys[k]
        assert kind == "corrector" or k < num_steps - 1
        k_ = nk if kind == "predictor" else jax.random.fold_in(ck, j)
        return _np(jax.random.normal(k_, tuple(like.shape)))
    return draw


XT = np.random.default_rng(2).standard_normal((16, 2)).astype(np.float32)
STEPS = 20


@pytest.mark.parametrize("nan_below", [None, 0.5])
def test_euler_maruyama_matches_jax(nan_below):
    """The chain within 1e-5 with the JAX noise replayed, and the NaN flag:
    False on a clean chain; True, with the NaN zeroed and the chain run
    on, when the score turns NaN halfway."""
    jscore, pscore = _scores(nan_below)
    key = jax.random.PRNGKey(3)
    want, want_bad = jax.jit(lambda k, x: jax_sde.euler_maruyama(
        k, jscore, JaxVPSDE(), x, STEPS, return_nan_flag=True))(
            key, jnp.asarray(XT))
    got, bad = sde.euler_maruyama(None, pscore, VPSDE(), _np(XT), STEPS,
                                  return_nan_flag=True,
                                  noise=em_noise(key, STEPS))
    _close(got, want, rtol=0, atol=1e-5)
    assert bool(bad) == bool(want_bad) == (nan_below is not None)
    assert torch.isfinite(got).all()
    plain = sde.euler_maruyama(None, pscore, VPSDE(), _np(XT), STEPS,
                               noise=em_noise(key, STEPS))
    assert torch.equal(plain, got)


def test_predictor_corrector_matches_jax():
    jscore, pscore = _scores()
    key = jax.random.PRNGKey(4)
    want, want_bad = jax.jit(lambda k, x: jax_sde.predictor_corrector(
        k, jscore, JaxVPSDE(), x, STEPS, n_corrector=2,
        return_nan_flag=True))(key, jnp.asarray(XT))
    got, bad = sde.predictor_corrector(None, pscore, VPSDE(), _np(XT),
                                       STEPS, n_corrector=2,
                                       return_nan_flag=True,
                                       noise=pc_noise(key, STEPS))
    _close(got, want, rtol=0, atol=1e-5)
    assert not bool(bad) and not bool(want_bad)


def test_probability_flow_matches_jax():
    jscore, pscore = _scores()
    want = jax.jit(lambda x: jax_sde.probability_flow(
        jscore, JaxVPSDE(), x, 50))(jnp.asarray(XT))
    got = sde.probability_flow(pscore, VPSDE(), _np(XT), 50)
    _close(got, want, rtol=0, atol=1e-5)
    # the flow carries N(0, 1) to p0: every sample lands near MU0
    assert (got - MU0).abs().max() < 0.3


def test_samplers_draw_from_their_generator():
    _, pscore = _scores()
    runs = [sde.euler_maruyama(torch.Generator().manual_seed(s), pscore,
                               VPSDE(), _np(XT), 5) for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0],
                                                             runs[2])


def test_reverse_sde_sampler_from_eps_matches_jax():
    """The eps model as a score at t on and off the grid (0.8999999 rounds
    to step 90 of 100, t = 1 clips to 99)."""
    jd, pd = JaxDDPM.create(100), DDPM.create(100)
    x = np.random.default_rng(5).standard_normal((5, 3)).astype(np.float32)
    t = np.array([0.0, 0.3, 0.8999999, 0.955, 1.0], np.float32)

    def jeps(x, i):
        return jnp.sin(x) * (i[:, None] + 1.0) / 100.0

    def peps(x, i):
        return torch.sin(x) * (i[:, None] + 1.0) / 100.0

    want = jax_sde.reverse_sde_sampler_from_eps(jeps, jd)(
        jnp.asarray(x), jnp.asarray(t))
    got = sde.reverse_sde_sampler_from_eps(peps, pd)(_np(x), _np(t))
    _close(got, want, rtol=0, atol=1e-5)
    assert np.abs(np.asarray(want)).max() > 0.1


# --- analytic Gaussian conditioning ----------------------------------------

def test_analytic_matches_jax():
    js, ps = JaxVPSDE(), VPSDE()
    rng = np.random.default_rng(6)
    t = np.linspace(0.05, 1.0, 6).astype(np.float32)
    mu0, var0, y, obs_var, xt = (
        rng.standard_normal(6).astype(np.float32) for _ in range(5))
    var0, obs_var = var0**2 + 0.1, obs_var**2 + 0.05
    jargs = [jnp.asarray(a) for a in (mu0, var0, y, obs_var, xt, t)]
    pargs = [_np(a) for a in (mu0, var0, y, obs_var, xt, t)]
    for name, idx in (("marginal_params", (0, 1, 5)),
                      ("marginal_score", (0, 1, 4, 5)),
                      ("posterior_x0_given_xt", (0, 1, 4, 5)),
                      ("conditional_score", (0, 1, 2, 3, 4, 5)),
                      ("guidance_term", (0, 1, 2, 3, 4, 5))):
        want = getattr(jax_analytic, name)(js, *(jargs[i] for i in idx))
        got = getattr(analytic, name)(ps, *(pargs[i] for i in idx))
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                _close(g, w)
        else:
            _close(got, want)
    # numbers for the arguments, as the JAX tests pass them
    _close(analytic.guidance_term(ps, 0.7, 0.3, 0.2, 0.05, -0.1, 0.5),
           jax_analytic.guidance_term(js, 0.7, 0.3, 0.2, 0.05, -0.1,
                                      jnp.asarray(0.5)))


# --- sweep tooling ------------------------------------------------------------

def test_commands_builder_matches_jax():
    grids = [("a", [1, 2]), ("b", ["x", "y", "z"]), ("c", [0.5])]
    got, want = sweep.CommandsBuilder("python run.py"), \
        jax_sweep.CommandsBuilder("python run.py")
    for key, values in grids:
        got.add(key, values)
        want.add(key, values)
    assert got.build() == want.build()
    assert len(got.build()) == 6
    assert got.build()[0] == "python run.py --override a=1 --override b=x " \
                             "--override c=0.5"


def test_sweep_gen_and_agg_match_jax(tmp_path):
    """`gen` writes the JAX module's commands file, and `agg` its table and
    CSV, on the same experiment tree (2 gammas x 3 seeds, one run without
    the gamma key)."""
    out = {}
    for name, mod in (("port", sweep), ("jax", jax_sweep)):
        path = tmp_path / f"commands_{name}.txt"
        mod.main(["gen", "--base", "python -m x", "--grid", "g=1,2",
                  "--grid", "s=0,1,2", "--out", str(path)])
        out[name] = path.read_text()
    assert out["port"] == out["jax"] and len(out["port"].split("\n")) == 7
    rng = np.random.default_rng(7)
    logs = tmp_path / "logs"
    for g in (1.0, 10.0, None):
        for s in range(3 if g else 1):
            d = logs / f"exp_g{g}_s{s}"
            os.makedirs(d)
            cfg = {"seed": s, **({"conditioning": {"gamma": g}} if g
                                 else {})}
            (d / "config.yaml").write_text(yaml.safe_dump(cfg))
            (d / "results.json").write_text(json.dumps(
                {"mse": float((g or 5.0) + rng.normal(0, 0.01)),
                 "nfe": 100}))
    rows = sweep.collect_results(str(logs))
    assert sorted(rows, key=lambda r: r["dir"]) == sorted(
        jax_sweep.collect_results(str(logs)), key=lambda r: r["dir"])
    table = sweep.aggregate(rows, ["conditioning.gamma"])
    want = jax_sweep.aggregate(rows, ["conditioning.gamma"])
    assert table.equals(want) and len(table) == 3
    assert "result.mse_ci95" in table.columns
    for name, mod in (("port", sweep), ("jax", jax_sweep)):
        mod.main(["agg", "--logdir", str(logs), "--groupby",
                  "conditioning.gamma", "--out",
                  str(tmp_path / f"agg_{name}.csv")])
    assert (tmp_path / "agg_port.csv").read_text() == \
        (tmp_path / "agg_jax.csv").read_text()
