"""The port's protein stack against the JAX package's, on the CPU in fp32:
geometry, the graph SDEs, the GVP denoiser (flax weights converted by
`gvp_denoiser_state_dict_from_flax`), the ResDiff loss and its gradients,
the motif conditioner, the guided reverse chain, and the copied numpy-only
modules. Tiny models: 24 residues, (16, 4) widths, 1-2 conv layers, 20
steps; inputs from numpy seeds, ragged lengths."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.protein import conditioner as jcond
from tpu_diffusion.protein import data as jdata
from tpu_diffusion.protein import denoiser as jden
from tpu_diffusion.protein import geometry as jgeo
from tpu_diffusion.protein import pdb as jpdb
from tpu_diffusion.protein import resdiff as jres
from tpu_diffusion.protein import sde as jsde
from tpu_diffusion_torch.convert import gvp_denoiser_state_dict_from_flax
from tpu_diffusion_torch.protein import conditioner as pcond
from tpu_diffusion_torch.protein import data as pdata
from tpu_diffusion_torch.protein import denoiser as pden
from tpu_diffusion_torch.protein import geometry as pgeo
from tpu_diffusion_torch.protein import pdb as ppdb
from tpu_diffusion_torch.protein import resdiff as pres
from tpu_diffusion_torch.protein import sde as psde

N = 24
TINY = dict(max_protein_length=N, n_h_node_feats=(16, 4),
            n_h_edge_feats=(16, 4), n_conv_layers=2)
TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _chains(b=3, seed=0):
    """(positions [b, N, 3], mask [b, N]) of synthetic chains of ragged
    lengths in [8, N]."""
    ds = pdata.synthetic_ca_chains(b, max_len=N, min_len=8, seed=seed)
    mask = np.arange(N)[None] < ds.lengths[:, None]
    return ds.positions, mask


def _batches(pos, mask):
    return (jsde.ProteinBatch.from_positions(jnp.asarray(pos),
                                             jnp.asarray(mask)),
            psde.ProteinBatch.from_positions(_t(pos), _t(mask)))


def random_params(jax_model, batch, seed):
    """A flax param tree for `jax_model`, drawn with numpy (N(0, 1/fan_in)
    kernels, nonzero biases, scales near 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), batch,
                            jnp.zeros((batch.pos.shape[0],)))

    def draw(path, sd):
        leaf = path[-1].key
        if leaf == "kernel":
            v = rng.standard_normal(sd.shape) / np.sqrt(sd.shape[0])
        elif leaf == "scale":
            v = 1 + 0.1 * rng.standard_normal(sd.shape)
        else:
            v = 0.1 * rng.standard_normal(sd.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def twins():
    """(jax model, flax params, port model, positions, mask, t)."""
    pos, mask = _chains()
    jb, _ = _batches(pos, mask)
    jm = jden.GVPDenoiser(**TINY)
    params = random_params(jm, jb, seed=1)
    pm = pden.GVPDenoiser(**TINY)
    pm.load_state_dict(gvp_denoiser_state_dict_from_flax(params))
    t = np.array([0.1, 0.5, 0.9], np.float32)
    return jm, params, pm, pos, mask, t


# --- geometry ----------------------------------------------------------------

def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 10, 3)).astype(np.float32)
    y = rng.standard_normal((4, 10, 3)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (4, 10)).astype(np.float32)
    mask = np.arange(10)[None] < np.array([[10], [7], [4], [1]])
    _close(pgeo.masked_mean(_t(x), _t(mask), axis=-2),
           jgeo.masked_mean(x, mask, axis=-2))
    _close(pgeo.masked_mean(_t(x), None, axis=1, keepdims=False),
           jgeo.masked_mean(x, None, axis=1, keepdims=False))
    _close(pgeo.center(_t(x), _t(mask)), jgeo.center(x, mask))
    # the port's kabsch is batched; the JAX one is vmapped
    for weights in (None, w):
        rot, trans = pgeo.kabsch(_t(x), _t(y),
                                 None if weights is None else _t(weights))
        jrot, jtrans = jax.jit(jax.vmap(jgeo.kabsch))(x, y, weights) \
            if weights is not None else jax.jit(jax.vmap(jgeo.kabsch))(x, y)
        _close(rot, jrot, rtol=1e-4, atol=1e-5)
        _close(trans, jtrans, rtol=1e-4, atol=1e-5)
    _close(pgeo.kabsch_align(_t(x), _t(y)),
           jax.jit(jax.vmap(jgeo.kabsch_align))(x, y), rtol=1e-4,
           atol=1e-5)
    _close(pgeo.rmsd(_t(x), _t(y)), jax.vmap(jgeo.rmsd)(x, y))
    _close(pgeo.aligned_rmsd(_t(x), _t(y)),
           jax.jit(jax.vmap(jgeo.aligned_rmsd))(x, y), rtol=1e-4,
           atol=1e-5)
    rot = np.asarray(jgeo.random_rotation_matrix(jax.random.PRNGKey(3)))
    trans = np.array([1.0, -2.0, 0.5], np.float32)
    _close(pgeo.rototranslate(_t(x), _t(rot), _t(trans)),
           jgeo.rototranslate(x, rot, trans))
    # a mirrored target still gives a proper rotation
    mirrored = x * np.array([-1.0, 1.0, 1.0], np.float32)
    rot, _ = pgeo.kabsch(_t(x), _t(mirrored))
    _close(torch.linalg.det(rot), np.ones(4), atol=1e-5)
    # random_rotation_matrix draws from its own generator: orthonormal,
    # det +1, and recovered by kabsch as the JAX test recovers its own
    r = pgeo.random_rotation_matrix(torch.Generator().manual_seed(7))
    _close(r @ r.T, np.eye(3), atol=1e-5)
    _close(torch.linalg.det(r), 1.0, atol=1e-5)
    moved = pgeo.rototranslate(_t(x[0]), r, _t(trans))
    got_rot, got_trans = pgeo.kabsch(_t(x[0]), moved)
    _close(got_rot, r, atol=1e-4)
    _close(got_trans, trans, atol=1e-4)


def test_kabsch_align_gradient_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((12, 3)).astype(np.float32)
    y = rng.standard_normal((12, 3)).astype(np.float32)

    def jloss(y_):
        return jnp.sum((jgeo.kabsch_align(x, y_) - y_) ** 2)

    want = jax.jit(jax.grad(jloss))(y)
    yt = _t(y).requires_grad_(True)
    ((pgeo.kabsch_align(_t(x), yt) - yt) ** 2).sum().backward()
    assert torch.isfinite(yt.grad).all()
    _close(yt.grad, want, rtol=1e-4, atol=1e-5)


# --- SDE -----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["hoogeboom", "vp"])
def test_sde_tables_match_jax(kind):
    if kind == "vp":
        js, ps = jsde.VPGraphSDE(num_steps=100), psde.VPGraphSDE(num_steps=100)
    else:
        js, ps = jsde.HoogeboomGraphSDE(), psde.HoogeboomGraphSDE()
    for name in ("ts", "alphas_cumprod", "discrete_betas", "alphas"):
        got = getattr(ps, name)
        assert got.dtype == torch.float32
        _close(got, getattr(js, name), rtol=0, atol=1e-6)
    t = np.linspace(0.05, 0.95, 7).astype(np.float32)
    _close(ps.beta_fn(_t(t)), js.beta_fn(jnp.asarray(t)), rtol=1e-5)
    for got, want in zip(ps.marginal_prob(_t(t)),
                         js.marginal_prob(jnp.asarray(t))):
        _close(got, want)


def test_noising_and_denoising_match_jax():
    pos, mask = _chains()
    jb, pb = _batches(pos, mask)
    js, ps = jsde.HoogeboomGraphSDE(), psde.HoogeboomGraphSDE()
    t = np.array([0.2, 0.6, 0.95], np.float32)
    jn, eps = js.noising(jax.random.PRNGKey(0), jb, jnp.asarray(t))
    pn, peps = ps.noising(None, pb, _t(t), eps=_t(eps))
    assert peps is not None
    _close(pn.pos, jn.pos)
    _close(ps.denoising(pn, _t(eps), _t(t)).pos,
           js.denoising(jn, eps, jnp.asarray(t)).pos, rtol=1e-5, atol=1e-5)
    # drawn noise is COM-free and zero on padding
    drawn, z = ps.noising(torch.Generator().manual_seed(0), pb, _t(t))
    _close(z.sum(1), np.zeros((3, 3)), atol=1e-5)
    assert (z[~_t(mask)] == 0).all()


def test_sample_blob_and_com_free_noise():
    ps = psde.HoogeboomGraphSDE()
    gen = torch.Generator().manual_seed(0)
    blob = ps.sample_blob(gen, 4, 32, lengths=torch.tensor([10, 20, 30, 32]))
    _close(blob.pos.sum(1), np.zeros((4, 3)), atol=1e-4)
    assert blob.mask.sum(1).tolist() == [10, 20, 30, 32]
    assert (blob.pos[~blob.mask] == 0).all()
    pos, mask = _chains()
    z = psde.com_free_noise(gen, _t(pos), _t(mask))
    _close(pgeo.masked_mean(z, _t(mask), axis=-2), np.zeros((3, 1, 3)),
           atol=1e-6)
    assert (z[~_t(mask)] == 0).all()


# --- GVP denoiser ----------------------------------------------------------------

@pytest.mark.parametrize("sin_temp_enc", [False, True])
def test_denoiser_matches_jax(twins, sin_temp_enc):
    jm, params, pm, pos, mask, t = twins
    if sin_temp_enc:
        kw = dict(TINY, n_conv_layers=1, sin_temp_enc=True)
        jm = jden.GVPDenoiser(**kw)
        params = random_params(jm, _batches(pos, mask)[0], seed=2)
        pm = pden.GVPDenoiser(**kw)
        pm.load_state_dict(gvp_denoiser_state_dict_from_flax(params))
    jb, pb = _batches(pos, mask)
    want = jax.jit(jm.apply)(params, jb, jnp.asarray(t))
    with torch.no_grad():
        got = pm(pb, _t(t))
    assert float(jnp.abs(want).max()) > 1e-2
    _close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_gvp_layer_norm_matches_flax(scale):
    """flax's LayerNorm eps is 1e-6 (torch's 1e-5): at small scalar
    variance the eps decides the output."""
    from tpu_diffusion.protein import gvp as jgvp
    from tpu_diffusion_torch.protein import gvp as pgvp
    rng = np.random.default_rng(4)
    s = (scale * rng.standard_normal((3, 5, 16))).astype(np.float32)
    v = rng.standard_normal((3, 5, 4, 3)).astype(np.float32)
    jn = jgvp.GVPLayerNorm()
    params = jn.init(jax.random.PRNGKey(0), (s, v))
    want_s, want_v = jn.apply(params, (s, v))
    pn = pgvp.GVPLayerNorm(16)
    got_s, got_v = pn((_t(s), _t(v)))
    _close(got_s, want_s, rtol=1e-5, atol=1e-5)
    _close(got_v, want_v)


def test_mlp_denoiser_matches_jax():
    pos, mask = _chains()
    jb, pb = _batches(pos, mask)
    jm = jden.MLPDenoiser(hidden=16, depth=2)
    params = random_params(jm, jb, seed=3)
    pm = pden.MLPDenoiser(hidden=16, depth=2)
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    pm.load_state_dict({
        f"{p[0].key}.{'weight' if p[1].key == 'kernel' else 'bias'}":
            _t(np.asarray(v).T if p[1].key == "kernel" else v)
        for p, v in flat})
    t = np.array([0.1, 0.5, 0.9], np.float32)
    _close(pm(pb, _t(t)), jm.apply(params, jb, jnp.asarray(t)))


def test_denoiser_remat_equals_plain(twins):
    _, _, pm, pos, mask, t = twins
    rm = pden.GVPDenoiser(**TINY, remat=True)
    rm.load_state_dict(pm.state_dict())
    _, pb = _batches(pos, mask)
    outs, grads = [], []
    for m in (pm, rm):
        m.zero_grad()
        out = m(pb, _t(t))
        (out ** 2).sum().backward()
        outs.append(out.detach())
        grads.append({k: p.grad.clone() for k, p in m.named_parameters()})
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-6)
    for k in grads[0]:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=1e-5,
                                   atol=1e-6)


def test_denoiser_se3_equivariance_and_padding_invariance(twins):
    _, _, pm, pos, mask, t = twins
    _, pb = _batches(pos, mask)
    with torch.no_grad():
        eps = pm(pb, _t(t))
        rot = pgeo.random_rotation_matrix(torch.Generator().manual_seed(7))
        eps_rot = pm(pb._replace(pos=pb.pos @ rot.T), _t(t))
        _close(eps_rot, (eps @ rot.T).numpy(), atol=2e-5)
        # translations are killed by the relative vectors and centring
        # only for centred inputs; junk in padding rows changes nothing
        junk = torch.where(pb.mask[..., None], pb.pos,
                           torch.full_like(pb.pos, 77.0))
        eps2 = pm(pb._replace(pos=junk), _t(t))
    m = _t(mask)
    _close(eps2[m], eps[m].numpy(), atol=1e-5)
    _close(eps.sum(1), np.zeros((3, 3)), atol=1e-5)


def test_default_parameter_count_matches_jax():
    pos, mask = _chains(b=1)
    jb = jsde.ProteinBatch.from_positions(jnp.zeros((1, 112, 3)))
    shapes = jax.eval_shape(jden.GVPDenoiser().init, jax.random.PRNGKey(0),
                            jb, jnp.zeros((1,)))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    with torch.device("meta"):
        got = sum(p.numel() for p in pden.GVPDenoiser().parameters())
    assert got == want == 3_336_001


def test_converter_rejects_missing_and_extra_names(twins):
    _, params, pm, *_ = twins
    tree = jax.tree.map(np.asarray, params["params"])
    sd = gvp_denoiser_state_dict_from_flax(tree)
    assert set(sd) == set(pm.state_dict())
    extra = dict(tree, W_extra={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="W_extra"):
        gvp_denoiser_state_dict_from_flax(extra)
    missing = {k: v for k, v in tree.items() if k != "out_norm"}
    with pytest.raises(KeyError, match="out_norm"):
        gvp_denoiser_state_dict_from_flax(missing)
    conv = dict(tree["conv_0"])
    del conv["GVPLayerNorm_1"]
    with pytest.raises(KeyError, match="conv_0.GVPLayerNorm_1"):
        gvp_denoiser_state_dict_from_flax(dict(tree, conv_0=conv))


# --- loss ------------------------------------------------------------------------

@pytest.mark.parametrize("distogram", ["sequential", "dense"])
def test_resdiff_loss_and_gradients_match_jax(twins, distogram):
    jm, params, pm, pos, mask, _ = twins
    jb, pb = _batches(pos, mask)
    js, ps = jsde.HoogeboomGraphSDE(num_steps=50), \
        psde.HoogeboomGraphSDE(num_steps=50)
    key = jax.random.PRNGKey(3)
    # the draws inside the JAX loss, replayed into the port's
    kt, kn = jax.random.split(key)
    t = jax.random.uniform(kt, (3,), minval=1e-3, maxval=1.0 - 1e-3)
    eps = jsde.com_free_noise(kn, jb.pos, jb.mask)
    gate = np.asarray(t) <= 0.25
    assert gate.any() and not gate.all()   # both sides of the aux gate

    def jloss(p):
        return jres.resdiff_loss(key, lambda b, tt: jm.apply(p, b, tt), js,
                                 jb, distogram=distogram)

    (jtotal, jmetrics), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    pm.zero_grad()
    total, metrics = pres.resdiff_loss(None, pm, ps, pb, distogram=distogram,
                                       t=_t(t), eps=_t(eps))
    total.backward()
    for k in ("dsm", "backbone_mse", "distogram_mse", "loss"):
        _close(metrics[k], jmetrics[k], rtol=1e-5, atol=1e-7)
    _close(total, jtotal, rtol=1e-5)
    want = gvp_denoiser_state_dict_from_flax(jax.tree.map(np.asarray, jgrads))
    for name, p in pm.named_parameters():
        scale = float(np.abs(want[name].numpy()).max()) + 1e-6
        _close(p.grad, want[name], rtol=0, atol=2e-5 * scale)


def test_resdiff_loss_draws_from_its_generator(twins):
    _, _, pm, pos, mask, _ = twins
    _, pb = _batches(pos, mask)
    ps = psde.HoogeboomGraphSDE(num_steps=50)
    with torch.no_grad():
        a = pres.resdiff_loss(torch.Generator().manual_seed(1), pm, ps, pb)[0]
        b = pres.resdiff_loss(torch.Generator().manual_seed(1), pm, ps, pb)[0]
        c = pres.resdiff_loss(torch.Generator().manual_seed(2), pm, ps, pb)[0]
    assert a == b and a != c and torch.isfinite(a)


# --- conditioner --------------------------------------------------------------------

def _conditioners(pos, gs):
    motif = pos[0, 3:9] - pos[0, 3:9].mean(0)
    idx = np.arange(6) + 9
    return (jcond.Structconditioner(motif_pos=jnp.asarray(motif),
                                    motif_indices=jnp.asarray(idx),
                                    guidance_scale=gs),
            pcond.Structconditioner(motif_pos=_t(motif),
                                    motif_indices=_t(idx).long(),
                                    guidance_scale=gs))


def test_conditioner_update_matches_jax(twins):
    jm, params, pm, pos, mask, _ = twins
    jb, pb = _batches(pos, mask)
    js, ps = jsde.HoogeboomGraphSDE(num_steps=20), \
        psde.HoogeboomGraphSDE(num_steps=20)
    jc, pc = _conditioners(pos, 1500.0)
    pm.zero_grad()
    japply = jax.jit(lambda step: jc.apply(
        jb, lambda b, t: jm.apply(params, b, t), step, js))
    for step in (3, 9):
        want = japply(jnp.int32(step))
        got, eps_hat = pc.guide(pb, pm, step, ps)
        assert float(jnp.abs(want).max()) > 1e-3
        _close(got, want, rtol=1e-4, atol=1e-4 * float(jnp.abs(want).max()))
        _close(pc.apply(pb, pm, step, ps), got.numpy(), rtol=0, atol=0)
        # the guide's eps_hat is the plain forward's
        t = torch.full((3,), float(step)) / 20
        with torch.no_grad():
            _close(eps_hat, pm(pb, t).numpy(), rtol=0, atol=0)
    assert all(p.grad is None for p in pm.parameters())
    _close(pc.final_loss(pb), jc.final_loss(jb), rtol=1e-4, atol=1e-7)
    l1 = jcond.Structconditioner(motif_pos=jc.motif_pos,
                                 motif_indices=jc.motif_indices,
                                 loss_type="l1", align=False)
    pl1 = pcond.Structconditioner(motif_pos=pc.motif_pos,
                                  motif_indices=pc.motif_indices,
                                  loss_type="l1", align=False)
    _close(pl1.final_loss(pb), l1.final_loss(jb))


def test_place_indices_block_matches_jax():
    for idx, length, at in (([50, 51, 52, 53], 20, None),
                            ([3, 4, 5], 30, 7), ([0, 1, 2, 3, 4], 5, None)):
        got = pcond.place_indices_block_within_bounds(torch.tensor(idx),
                                                      length, at)
        want = jcond.place_indices_block_within_bounds(jnp.asarray(idx),
                                                       length, at)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_guided_chain_lowers_motif_loss():
    """A zero-eps model: the conditioner at the shipped gs 1500 and
    cond_start_step Ns/2 pulls the motif residues toward the motif."""
    ps = psde.HoogeboomGraphSDE(num_steps=40)
    motif = torch.randn((4, 3), generator=torch.Generator().manual_seed(0))
    cond = pcond.Structconditioner(motif_pos=motif * 0.3,
                                   motif_indices=torch.arange(4) + 6)
    blob = ps.sample_blob(torch.Generator().manual_seed(2), 2, 16)

    def model(batch, t):
        return torch.zeros_like(batch.pos)

    outs = [ps.reverse_diffusion_sampling(
        torch.Generator().manual_seed(3), blob, model, conditioner=c,
        cond_start_step=20) for c in (cond, None)]
    assert cond.final_loss(outs[0]).mean() < cond.final_loss(outs[1]).mean()


@functools.lru_cache(maxsize=None)
def _jax_chain(js, steps):
    """The JAX guided chain, jitted once: the conditioner (whose guidance
    scale is a traced leaf) and the params are arguments."""
    jm = jden.GVPDenoiser(**TINY)
    return jax.jit(lambda params, cond, key, blob:
                   js.reverse_diffusion_sampling(
                       key, blob, lambda bb, tt: jm.apply(params, bb, tt),
                       conditioner=cond, cond_start_step=10,
                       no_noise_steps=steps, save_trajectory=True))


# gs 1500 amplifies the two packages' fp32 rounding (1e-7 per forward) to
# ~4e-4 on this chain, whose positions grow to ~180 under the random
# model (2e-6 of max |pos|); at gs 10 they reach ~12 and differ by ~2e-6
# (1.4e-7 of it). Tolerances relative to max |pos| of the JAX chain:
CHAIN_TOL = {1500.0: 5e-5, 10.0: 1e-6}


@pytest.mark.parametrize("gs", sorted(CHAIN_TOL))
def test_guided_reverse_chain_matches_jax(twins, gs):
    """The tiny denoiser with the conditioner on for step < 10 of 20 and no
    noise added at any step (no_noise_steps = num_steps): both packages
    still draw z, but the chain is a function of the blob."""
    jm, params, pm, pos, mask, _ = twins
    steps = 20
    js, ps = jsde.HoogeboomGraphSDE(num_steps=steps), \
        psde.HoogeboomGraphSDE(num_steps=steps)
    jc, pc = _conditioners(pos, gs)
    lengths = jnp.asarray(mask.sum(1))
    blob = js.sample_blob(jax.random.PRNGKey(1), 3, N, lengths=lengths)
    jtraj, jout = _jax_chain(js, steps)(params, jc, jax.random.PRNGKey(2),
                                        blob)
    pblob = psde.ProteinBatch.from_positions(_t(blob.pos), _t(blob.mask))
    pm.zero_grad()
    ptraj, pout = ps.reverse_diffusion_sampling(
        torch.Generator().manual_seed(0), pblob, pm, conditioner=pc,
        cond_start_step=10, no_noise_steps=steps, save_trajectory=True)
    assert tuple(ptraj.shape) == (steps, 3, N, 3)
    scale = float(jnp.abs(jtraj).max())
    _close(ptraj, jtraj, rtol=0, atol=CHAIN_TOL[gs] * scale)
    _close(pout.pos, jout.pos, rtol=0, atol=CHAIN_TOL[gs] * scale)
    _close(pc.final_loss(pout), jc.final_loss(jout), rtol=1e-4, atol=1e-6)
    assert all(p.grad is None for p in pm.parameters())


# --- the copied numpy modules ---------------------------------------------------------

def test_copied_data_and_pdb_match_jax(tmp_path):
    for kw in (dict(n=5, max_len=N, min_len=8, seed=3),
               dict(n=4, max_len=64, seed=0)):
        a, b = (m.synthetic_ca_chains(**kw) for m in (pdata, jdata))
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.lengths, b.lengths)
    ds_p = pdata.get_protein_data(str(tmp_path / "none"), max_len=N,
                                  n_synthetic=12, seed=1)
    ds_j = jdata.get_protein_data(str(tmp_path / "none"), max_len=N,
                                  n_synthetic=12, seed=1)
    for bp, bj, _ in zip(pdata.protein_batches(ds_p, 5, seed=2),
                         jdata.protein_batches(ds_j, 5, seed=2), range(5)):
        np.testing.assert_array_equal(bp["pos"], bj["pos"])
        np.testing.assert_array_equal(bp["mask"], bj["mask"])
    npy = tmp_path / "npy"
    npy.mkdir()
    np.save(npy / "a.npy", ds_p.positions[0][:10] * 15)
    np.save(npy / "b.npy", ds_p.positions[1][:30] * 15)
    a, b = pdata.load_npy_dir(str(npy), N), jdata.load_npy_dir(str(npy), N)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    coords = ds_p.positions[0][:ds_p.lengths[0]] / pdata.COORD_SCALE
    ppdb.write_ca_pdb(coords, str(tmp_path / "p.pdb"))
    jpdb.write_ca_pdb(coords, str(tmp_path / "j.pdb"))
    assert (tmp_path / "p.pdb").read_text() == (tmp_path / "j.pdb").read_text()
    back = ppdb.parse_pdb(str(tmp_path / "p.pdb"))
    want = jpdb.parse_pdb(str(tmp_path / "p.pdb"))
    np.testing.assert_array_equal(back.ca_trace(), want.ca_trace())
    assert back.sequence() == want.sequence()
    np.testing.assert_allclose(back.ca_trace(), coords, atol=1e-3)
