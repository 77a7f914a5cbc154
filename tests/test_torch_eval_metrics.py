"""The port's evaluation metrics against the JAX package's, on the CPU:
Frechet distance and statistics, the RandomConv, VGG-LPIPS and Inception
feature networks through converted weights (and the .npz loaders), the FID
accumulator, and LPIPS and FID in `cli/main.py:run_eval`.

The feature networks' default weights are random and cannot be replayed
across the packages (flax keys against torch seeds), so each network is
held to the JAX one on the same converted weights; the defaults are checked
for being fixed."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.eval import fid as jax_fid
from tpu_diffusion.eval import inception as jax_inception
from tpu_diffusion.eval import lpips as jax_lpips
from tpu_diffusion_torch.cli import main as cli
from tpu_diffusion_torch.convert import (feature_state_dict_from_flax,
                                         load_flax_npz)
from tpu_diffusion_torch.eval import fid, inception, lpips

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _draw(shapes, seed):
    """Numpy values for a flax variable tree of shape structs: kernels
    N(0, 1/fan_in), biases N(0, 0.1^2); BatchNorm statistics randomised as
    tests/test_torch_crossval.py's `_randomize_bn` does (mean N(0, 0.1^2),
    var |N(0, 0.1^2)| + 0.9), so their mapping is exercised."""
    rng = np.random.default_rng(seed)

    def draw(path, sd):
        leaf = path[-1].key
        if leaf == "kernel":
            v = rng.standard_normal(sd.shape) / np.sqrt(
                np.prod(sd.shape[:-1]))
        elif leaf == "var":
            v = np.abs(0.1 * rng.standard_normal(sd.shape)) + 0.9
        else:
            v = 0.1 * rng.standard_normal(sd.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _images(seed, shape):
    return np.clip(np.random.default_rng(seed).normal(0, 0.5, shape), -1,
                   1).astype(np.float32)


# --- Frechet distance --------------------------------------------------------

def _feature_sets(case):
    rng = np.random.default_rng(0)
    if case == "identical":
        a = rng.normal(size=(300, 8))
        return a, a
    if case == "shifted":
        a = rng.normal(size=(300, 8))
        return a, 1.5 * rng.normal(size=(200, 8)) + 0.3
    # fewer samples than dimensions: singular covariances
    return rng.normal(size=(6, 16)), rng.normal(size=(5, 16))


@pytest.mark.parametrize("case", ["identical", "shifted", "singular"])
def test_frechet_distance_and_statistics_match_jax(case):
    a, b = _feature_sets(case)
    stats = [fid.compute_statistics(x) for x in (a, b)]
    want = [jax_fid.compute_statistics(x) for x in (a, b)]
    for (mu, s), (jmu, js) in zip(stats, want):
        np.testing.assert_allclose(mu, jmu, rtol=0, atol=1e-10)
        np.testing.assert_allclose(s, js, rtol=0, atol=1e-10)
    got = fid.frechet_distance(*stats[0], *stats[1])
    ref = jax_fid.frechet_distance(*want[0], *want[1])
    assert np.isfinite(got)
    assert got == pytest.approx(ref, abs=1e-10)
    if case == "identical":
        assert abs(got) < 1e-6


# --- feature networks --------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 3])
def test_random_conv_features_match_jax(channels):
    net = jax_fid.RandomConvFeatures()
    x = _images(1, (3, 32, 32, channels))
    variables = _draw(jax.eval_shape(net.init, jax.random.PRNGKey(0),
                                     jnp.zeros((1, 32, 32, channels))), 2)
    want = np.asarray(net.apply(variables, jnp.asarray(x)))
    port = fid.RandomConvFeatures(channels)
    port.load_state_dict(feature_state_dict_from_flax(variables))
    got = fid.feature_fn(port.eval())(x).numpy()
    assert got.shape == want.shape == (3, 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _vgg_twins(seed):
    net = jax_lpips.VGGFeaturePyramid()
    variables = _draw(jax.eval_shape(net.init, jax.random.PRNGKey(0),
                                     jnp.zeros((1, 32, 32, 3))), seed)
    port = lpips.VGGFeaturePyramid()
    port.load_state_dict(feature_state_dict_from_flax(variables))
    return net, variables, port.eval()


def test_vgg_pyramid_matches_jax():
    net, variables, port = _vgg_twins(3)
    x = _images(4, (2, 32, 32, 3))
    want = net.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=0, atol=1e-4)


def _lpips_npz(variables, path, seed):
    """An .npz as scripts/import_inception_weights.py writes it for
    `load_lpips_fn`: VGG weights, lin heads, the scaling layer."""
    rng = np.random.default_rng(seed)
    arrays = {f"params/{m}/{leaf}": np.asarray(v)
              for m, p in variables["params"].items() for leaf, v in p.items()}
    for layer, width in enumerate((64, 128, 256, 512, 512)):
        arrays[f"lin/{layer}"] = rng.uniform(0, 1, width).astype(np.float32)
    arrays["shift"] = np.array([-0.030, -0.088, -0.188], np.float32)
    arrays["scale"] = np.array([0.458, 0.448, 0.450], np.float32)
    np.savez(path, **arrays)
    return arrays


@pytest.mark.parametrize("case", ["gray", "rgb", "official"])
def test_lpips_distance_matches_jax(case, tmp_path):
    """The unweighted distance on the same pyramid weights (grayscale images
    repeated to three channels on both sides), and the official formula of
    `load_lpips_fn` (lin heads, scaling layer) read from an .npz."""
    net, variables, port = _vgg_twins(5)
    channels = 1 if case == "gray" else 3
    x = _images(6, (2, 32, 32, channels))
    y = _images(7, (2, 32, 32, channels))
    kw = {}
    if case == "official":
        path = str(tmp_path / "lpips.npz")
        arrays = _lpips_npz(variables, path, 8)
        kw = dict(lin_weights=[jnp.asarray(arrays[f"lin/{layer}"])
                               for layer in range(5)],
                  shift=jnp.asarray(arrays["shift"]),
                  scale=jnp.asarray(arrays["scale"]))
        dist = lpips.load_lpips_fn(path, device="cpu")
    else:
        dist = lpips.PerceptualDistance(feature_fn=port, device="cpu")
    want = np.asarray(jax_lpips.PerceptualDistance(
        feature_fn=lambda im: net.apply(variables, im), **kw)(
            jnp.asarray(x), jnp.asarray(y)))
    got = dist(x, y).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got > 0).all()
    np.testing.assert_allclose(dist(x, x).numpy(), 0.0, atol=1e-6)


def test_inception_features_match_jax(tmp_path):
    """The whole InceptionV3 graph (resize to 299, grayscale repeat) on
    random weights and randomised BatchNorm statistics, loaded into the port
    from an .npz of the JAX variables keyed as the JAX loader reads it."""
    net = jax_inception.InceptionV3Features()
    variables = _draw(jax.eval_shape(net.init, jax.random.PRNGKey(0),
                                     jnp.zeros((1, 299, 299, 3))), 12)
    path = str(tmp_path / "inception.npz")
    np.savez(path, **{"/".join(str(k.key) for k in kp): leaf for kp, leaf in
                      jax.tree_util.tree_flatten_with_path(variables)[0]})
    x = _images(13, (1, 32, 32, 1))
    want = np.asarray(jax.jit(net.apply)(variables, jnp.asarray(x)))
    got = inception.load_inception_fn(path, device="cpu")(x).numpy()
    assert got.shape == want.shape == (1, 2048)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-4, f"pool3 features: relative error {err:.2e}"


def test_npz_loader_refuses_missing_and_misshapen_entries():
    net = jax_fid.RandomConvFeatures()
    variables = _draw(jax.eval_shape(net.init, jax.random.PRNGKey(0),
                                     jnp.zeros((1, 16, 16, 3))), 14)
    arrays = {"/".join(str(k.key) for k in kp): leaf for kp, leaf in
              jax.tree_util.tree_flatten_with_path(variables)[0]}
    arrays["lin/0"] = np.zeros(3, np.float32)  # not a parameter: ignored
    port = fid.RandomConvFeatures(3)
    load_flax_npz(port, arrays)
    want = feature_state_dict_from_flax(variables)
    for k, v in port.state_dict().items():
        assert torch.equal(v, want[k]), k
    with pytest.raises(KeyError, match="missing"):
        load_flax_npz(port, {k: v for k, v in arrays.items()
                             if "Dense_0" not in k})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_flax_npz(fid.RandomConvFeatures(1), arrays)


def test_feature_kinds_and_their_defaults(monkeypatch):
    monkeypatch.delenv("INCEPTION_WEIGHTS_NPZ", raising=False)
    with pytest.raises(FileNotFoundError, match="INCEPTION_WEIGHTS_NPZ"):
        fid.make_feature_fn("inception", device="cpu")
    with pytest.raises(NotImplementedError):
        fid.make_feature_fn("clip", device="cpu")
    # the default random features are fixed by their seed, on any build
    x = _images(15, (4, 16, 16, 1))
    a = fid.make_feature_fn("random_conv", channels=1, device="cpu")(x)
    b = fid.make_feature_fn("random_conv", channels=1, device="cpu")(x)
    assert a.shape == (4, 2048) and torch.equal(a, b)
    assert a.std() > 0
    d1 = lpips.PerceptualDistance(device="cpu")
    d2 = lpips.PerceptualDistance(device="cpu")
    y = _images(16, (4, 16, 16, 1))
    assert torch.equal(d1(x, y), d2(x, y)) and (d1(x, y) > 0).all()


@pytest.mark.parametrize("features", ["random_conv", "inception"])
@pytest.mark.parametrize("synthetic", [False, True])
def test_fid_caveat_keys_match_jax(features, synthetic):
    got = fid.fid_caveat(features, synthetic_data=synthetic)
    want = jax_fid.fid_caveat(features, synthetic_data=synthetic)
    assert set(got) == set(want)
    assert got["fid_comparable_to_published"] == \
        want["fid_comparable_to_published"]
    if "fid_note" in got:
        assert "NOT comparable" in got["fid_note"]
        assert "torch seed" in got["fid_note"] or features == "inception"


def _small_features(channels=3, device="cpu"):
    """A narrow RandomConv (16 features): the square root of a 2048-wide
    covariance takes ~20 s on the CPU."""
    net = fid.RandomConvFeatures(channels, width=8, features=16)
    fid.flax_default_init_(net, torch.Generator().manual_seed(42))
    return fid.feature_fn(net.to(device).eval())


def test_fid_accumulator_and_compute_fid():
    fn = _small_features(1)
    rng = np.random.default_rng(17)
    real = rng.normal(size=(64, 16, 16, 1)).astype(np.float32) * 0.1
    close = real + 0.01
    far = rng.uniform(-1, 1, size=(64, 16, 16, 1)).astype(np.float32)
    a = fid.FID(fn)
    a.update(real, real=True)
    a.update(close, real=False)
    mu, sigma = a.real_statistics()
    b = fid.FID(fn)  # never sees real images
    b.set_real_statistics(mu, sigma)
    b.update(close, real=False)
    assert b.compute() == pytest.approx(a.compute(), rel=1e-12)
    assert a.compute() == pytest.approx(
        fid.compute_fid(iter([close[:32], close[32:]]),
                        iter([real[:32], real[32:]]), fn), rel=1e-9)
    assert a.compute() < 0.5 * fid.compute_fid(iter([far]), iter([real]), fn)


# --- cli/main.py:run_eval ----------------------------------------------------

METRIC_OVERRIDES = [f"dataset.root={os.path.join(FIXTURES, 'mnist')}",
                    "testing.num_test=2", "testing.batch_size=2",
                    "diffusion.num_steps=25", "network.dtype=float32",
                    "network.num_channels=16",
                    "network.num_head_channels=16", "testing.lpips=true",
                    "testing.fid=true"]


def test_run_eval_reports_lpips_and_fid(tmp_path, monkeypatch):
    """LPIPS per batch and the FID against the train set's features, keyed
    as in the JAX package, finite, and equal across two calls (the second
    reads the cached real-set statistics)."""
    seen = []

    def features(kind, channels, device):
        seen.append((kind, channels))
        return _small_features(channels, device)

    monkeypatch.setattr(cli, "make_feature_fn", features)
    monkeypatch.setattr(cli, "_FID_REAL_CACHE", {})
    cfg = cli.get_config("mnist,inpainting,amortized")
    cli.apply_overrides(cfg, METRIC_OVERRIDES)
    torch.manual_seed(0)
    parts = cli.build(cfg, device="cpu")
    runs = []
    for name in ("a", "b"):
        (tmp_path / name).mkdir()
        runs.append(cli.run_eval(cfg, parts, parts["model"].eval(),
                                 str(tmp_path / name)))
        assert json.loads((tmp_path / name / "results.json").read_text()) \
            == runs[-1]
    assert runs[0] == runs[1]
    assert seen == [("random_conv", 1)]  # real-set statistics cached
    res = runs[0]
    assert res["num_images"] == 2 and res["fid_features"] == "random_conv"
    assert np.isfinite(res["lpips"]) and res["lpips"] > 0
    assert np.isfinite(res["fid"])
    assert set(fid.fid_caveat("random_conv")) <= set(res)
    assert res["fid_comparable_to_published"] is False
