"""The port's SO(3)/R3/SE(3) diffusers and structure transforms against the
JAX package.

The IGSO(3) tables are built in numpy float64 by both packages and held in
fp32, so they agree exactly; the lookups, Rodrigues maps and steps are fp32
on both sides (1e-6, or 1e-5 where a rotation composes several products).
Every draw of the JAX functions is recomputed from their keys as they split
them and handed to the port (`u=`, `axis=`, `z=`, `noise=`).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.protein import se3 as jax_se3
from tpu_diffusion.protein import so3 as jax_so3
from tpu_diffusion.protein import transforms as jax_tf
from tpu_diffusion_torch.protein import se3, so3
from tpu_diffusion_torch.protein import transforms as tf

SMALL = dict(num_sigma=50, num_omega=300, n_l=100)   # the JAX tests' size
KEY = jax.random.PRNGKey(0)


def close(got, want, tol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def pair():
    return jax_so3.SO3Diffuser(**SMALL), so3.SO3Diffuser(**SMALL,
                                                          device="cpu")


def test_igso3_tables_match_jax(pair):
    ref, port = pair
    for name in ("omega_grid", "sigma_grid", "cdf", "score_norm_table",
                 "score_scale_table"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)))


TS = np.array([0.0, 0.013, 0.25, 0.5, 0.77, 0.999, 1.0], np.float32)


def test_schedule_and_scores_match_jax(pair):
    ref, port = pair
    close(port.sigma(t(TS)), ref.sigma(jnp.asarray(TS)))
    np.testing.assert_array_equal(port._sigma_idx(port.sigma(t(TS))).numpy(),
                                  np.asarray(ref._sigma_idx(ref.sigma(TS))))
    close(port.score_scaling(t(TS)), ref.score_scaling(jnp.asarray(TS)))
    rng = np.random.default_rng(0)
    omega = rng.uniform(0.01, 3.1, (len(TS), 9)).astype(np.float32)
    close(port.score_norm(t(TS), t(omega)),
          ref.score_norm(jnp.asarray(TS), jnp.asarray(omega)))
    rv = (rng.normal(size=(len(TS), 9, 3)) * 0.7).astype(np.float32)
    close(port.score(t(TS), t(rv)), ref.score(jnp.asarray(TS),
                                              jnp.asarray(rv)), 1e-5)
    # scalar t against a batch of angles
    close(port.score_norm(t(np.float32(0.3)), t(omega)),
          ref.score_norm(jnp.float32(0.3), jnp.asarray(omega)))


def test_rodrigues_round_trip_matches_jax():
    rv = (np.random.default_rng(1).normal(size=(16, 3)) * 0.8) \
        .astype(np.float32)
    m = so3.rotvec_to_matrix(t(rv))
    close(m, jax_so3.rotvec_to_matrix(jnp.asarray(rv)))
    close(m @ m.transpose(-1, -2), np.broadcast_to(np.eye(3), (16, 3, 3)),
          1e-5)
    back = so3.matrix_to_rotvec(m)
    close(back, jax_so3.matrix_to_rotvec(jnp.asarray(m.numpy())), 1e-5)
    close(back, rv, 1e-4)


def so3_draws(key, shape):
    """(u, axis) as `jax_so3.SO3Diffuser.sample` draws them from `key`."""
    ka, kv = jax.random.split(key)
    return (np.asarray(jax.random.uniform(ka, shape)),
            np.asarray(jax.random.normal(kv, shape + (3,))))


def test_so3_sampling_replays_jax(pair):
    ref, port = pair
    tb = jnp.asarray(TS)
    u, axis = so3_draws(KEY, (len(TS), 11))
    close(port.sample_angle(None, t(TS), (len(TS), 11), u=t(u)),
          ref.sample_angle(jax.random.split(KEY)[0], tb, (len(TS), 11)))
    close(port.sample(None, t(TS), (len(TS), 11), u=t(u), axis=t(axis)),
          ref.sample(KEY, tb, (len(TS), 11)))
    rot0 = jax_so3.rotvec_to_matrix(jnp.asarray(
        np.random.default_rng(2).normal(size=(len(TS), 11, 3)) * 0.5))
    want_rot, want_rv = ref.forward_marginal(KEY, rot0, tb)
    got_rot, got_rv = port.forward_marginal(None, t(rot0), t(TS), u=t(u),
                                            axis=t(axis))
    close(got_rv, want_rv)
    close(got_rot, want_rot, 1e-5)
    # from the generator: the angles of one seed repeat, and lie on the grid
    a = port.sample_angle(torch.Generator().manual_seed(0), t(TS), (7, 5))
    b = port.sample_angle(torch.Generator().manual_seed(0), t(TS), (7, 5))
    assert torch.equal(a, b) and bool(torch.isin(a, port.omega_grid).all())


def test_so3_reverse_step_replays_jax(pair):
    ref, port = pair
    rng = np.random.default_rng(3)
    rot = jax_so3.rotvec_to_matrix(jnp.asarray(rng.normal(size=(4, 6, 3))))
    score = rng.normal(size=(4, 6, 3)).astype(np.float32)
    tb = np.array([0.9, 0.5, 0.2, 0.05], np.float32)
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.random.normal(key, score.shape))
    want = ref.reverse_step(key, rot, jnp.asarray(score), jnp.asarray(tb),
                            0.01, noise_scale=0.7)
    got = port.reverse_step(None, t(rot), t(score), t(tb), 0.01,
                            noise_scale=0.7, noise=t(noise))
    close(got, want, 1e-5)


def test_r3_replays_jax():
    ref, port = jax_se3.R3Diffuser(), se3.R3Diffuser()
    rng = np.random.default_rng(5)
    x0 = (rng.normal(size=(3, 8, 3)) * 10).astype(np.float32)
    tb = np.array([0.1, 0.5, 1.0], np.float32)
    z = np.asarray(jax.random.normal(KEY, x0.shape))
    want_x, want_s = ref.forward_marginal(KEY, jnp.asarray(x0),
                                          jnp.asarray(tb))
    got_x, got_s = port.forward_marginal(None, t(x0), t(tb), z=t(z))
    close(got_x, want_x, 1e-5)
    close(got_s, want_s, 1e-5)
    close(port.score(got_x, t(x0), t(tb)),
          ref.score(want_x, jnp.asarray(x0), jnp.asarray(tb)), 1e-5)
    close(port.score_scaling(t(tb)), ref.score_scaling(jnp.asarray(tb)))
    for center in (True, False):
        key = jax.random.PRNGKey(6)
        noise = np.asarray(jax.random.normal(key, x0.shape))
        want = ref.reverse_step(key, want_x, want_s, jnp.asarray(tb), 0.01,
                                center=center)
        got = port.reverse_step(None, got_x, got_s, t(tb), 0.01,
                                center=center, noise=t(noise))
        close(got, want, 1e-4)


@pytest.mark.parametrize("rot,trans", [(True, True), (False, True),
                                       (True, False)])
def test_se3_replays_jax(pair, rot, trans):
    ref_so3, port_so3 = pair
    ref = jax_se3.SE3Diffuser(so3=ref_so3, diffuse_rot=rot,
                              diffuse_trans=trans)
    port = se3.SE3Diffuser(so3=port_so3, diffuse_rot=rot,
                           diffuse_trans=trans)
    rng = np.random.default_rng(7)
    frames = jax_se3.Rigid(
        jax_so3.rotvec_to_matrix(jnp.asarray(rng.normal(size=(2, 5, 3)))),
        jnp.asarray(rng.normal(size=(2, 5, 3)) * 5, jnp.float32))
    pframes = se3.Rigid(t(frames.rots), t(frames.trans))
    tb = np.array([0.3, 0.8], np.float32)
    kr, kt = jax.random.split(KEY)
    u, axis = so3_draws(kr, (2, 5))
    z = np.asarray(jax.random.normal(kt, (2, 5, 3)))
    want = ref.forward_marginal(KEY, frames, jnp.asarray(tb))
    got = port.forward_marginal(None, pframes, t(tb), u=t(u), axis=t(axis),
                                z=t(z))
    for a, b in zip((*got[0], *got[1:]), (*want[0], *want[1:])):
        close(a, b, 1e-4)
    key = jax.random.PRNGKey(8)
    kr, kt = jax.random.split(key)
    want_step = ref.reverse_step(key, want[0], want[1], want[2],
                                 jnp.asarray(tb), 0.01)
    got_step = port.reverse_step(
        None, got[0], got[1], got[2], t(tb), 0.01,
        rot_noise=t(jax.random.normal(kr, (2, 5, 3))),
        trans_noise=t(jax.random.normal(kt, (2, 5, 3))))
    for a, b in zip(got_step, want_step):
        close(a, b, 1e-4)


def test_sample_ref_and_rigid_match_jax(pair):
    ref_so3, port_so3 = pair
    ref, port = (jax_se3.SE3Diffuser(so3=ref_so3),
                 se3.SE3Diffuser(so3=port_so3))
    kr, kt = jax.random.split(KEY)
    u, axis = so3_draws(kr, (3, 4))
    z = np.asarray(jax.random.normal(kt, (3, 4, 3)))
    want = ref.sample_ref(KEY, (3, 4))
    got = port.sample_ref(None, (3, 4), u=t(u), axis=t(axis), z=t(z))
    close(got.rots, want.rots, 1e-5)
    close(got.trans, want.trans, 1e-5)
    pts = np.random.default_rng(9).normal(size=(3, 4, 3)).astype(np.float32)
    close(got.apply(t(pts)), want.apply(jnp.asarray(pts)), 1e-4)
    rv = np.random.default_rng(10).normal(size=(3, 4, 3)).astype(np.float32)
    close(got.compose_rotvec(t(rv)).rots,
          want.compose_rotvec(jnp.asarray(rv)).rots, 1e-5)
    close(se3.Rigid.identity((4,)).apply(t(pts[0])), pts[0])


def test_so3_cache_file_shared_with_jax(tmp_path):
    """One cache file (same name, same table) serves both packages."""
    d = str(tmp_path / "cache")
    kw = dict(num_sigma=10, num_omega=50, n_l=20, cache_dir=d)
    ref = jax_so3.SO3Diffuser(**kw)
    assert len(os.listdir(d)) == 1
    port = so3.SO3Diffuser(**kw, device="cpu")
    assert len(os.listdir(d)) == 1
    np.testing.assert_array_equal(port.cdf.numpy(), np.asarray(ref.cdf))


# --- transforms ----------------------------------------------------------


@pytest.fixture(scope="module")
def graph_inputs():
    rng = np.random.default_rng(11)
    pos = rng.normal(size=(2, 10, 3)).astype(np.float32)
    mask = np.ones((2, 10), bool)
    mask[1, 7:] = False
    return pos, mask


def test_graph_builders_match_jax(graph_inputs):
    pos, mask = graph_inputs
    jp, jm = jnp.asarray(pos), jnp.asarray(mask)
    d, valid = tf.pairwise_dist(t(pos), t(mask))
    dj, vj = jax_tf.pairwise_dist(jp, jm)
    close(d, dj)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(tf.full_graph(t(mask)).numpy(),
                                  np.asarray(jax_tf.full_graph(jm)))
    for radius in (0.8, 1.5):
        np.testing.assert_array_equal(
            tf.radius_graph(t(pos), t(mask), radius).numpy(),
            np.asarray(jax_tf.radius_graph(jp, jm, radius)))
    for k in (1, 3, 12):
        np.testing.assert_array_equal(
            tf.knn_graph(t(pos), t(mask), k).numpy(),
            np.asarray(jax_tf.knn_graph(jp, jm, k)))


def test_encodings_match_jax():
    labels = np.array([0, 2, 1, 2])
    np.testing.assert_array_equal(
        tf.one_hot_encode(t(labels), 3).numpy(),
        np.asarray(jax_tf.one_hot_encode(jnp.asarray(labels), 3)))
    coords = (np.random.default_rng(12).normal(size=(5, 3)) * 15) \
        .astype(np.float32)
    close(tf.positions_to_graph(t(coords)),
          jax_tf.positions_to_graph(jnp.asarray(coords)))


@pytest.mark.parametrize("n", [2, 3, 9])
def test_frames_match_jax(n):
    rng = np.random.default_rng(13)
    ca = (rng.normal(size=(2, n, 3)) * 3).astype(np.float32)
    n_pos, c_pos = tf.ideal_backbone_from_ca(t(ca))
    jn, jc = jax_tf.ideal_backbone_from_ca(jnp.asarray(ca))
    close(n_pos, jn)
    close(c_pos, jc)
    frames = tf.OrientationFrames.from_backbone(n_pos, t(ca), c_pos)
    jframes = jax_tf.OrientationFrames.from_backbone(jn, jnp.asarray(ca), jc)
    close(frames.rotations, jframes.rotations, 1e-5)
    local = rng.normal(size=(2, n, 3)).astype(np.float32)
    close(frames.apply(t(local)), jframes.apply(jnp.asarray(local)), 1e-5)
    close(frames.invert_apply(t(local)),
          jframes.invert_apply(jnp.asarray(local)), 1e-5)
