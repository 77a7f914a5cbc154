"""The port's conditional flow matching against the JAX package's, on the
CPU: the class-conditional, inpainting and super-resolution wrappers, the
class embedding and two-head trees in the converter, the matchers' SF2M and
label-guided methods, the losses and samplers of
`cli/train_cfm_conditional.py` and `cli/train_conditional_mnist.py`, and
both CLIs end to end.

Both sides take the same weights (numpy draws converted with
`wrapper_state_dict_from_flax`) and the same draws: the port's losses,
matchers and samplers take x0, t, eps, the condition or a noise source as
arguments, which the tests compute by replaying the JAX key tree; a
sampled sinkhorn plan is replayed by standing in for the port's
`sinkhorn_assignment`. fp32 on both sides."""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.cli import train_cfm_conditional as jax_cfmc
from tpu_diffusion.cli import train_conditional_mnist as jax_cm
from tpu_diffusion.losses import cfm as jax_cfm
from tpu_diffusion.models import unet as jax_unet
from tpu_diffusion_torch.cli import train_cfm_conditional as cfmc
from tpu_diffusion_torch.cli import train_conditional_mnist as cm
from tpu_diffusion_torch.convert import (heads_state_dict_from_flax,
                                         load_flax_train_state,
                                         wrapper_state_dict_from_flax)
from tpu_diffusion_torch.losses import cfm
from tpu_diffusion_torch.models import unet
from tpu_diffusion_torch.train import trainer
from tpu_diffusion_torch.train.checkpoint import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4  # a forward: fp32, convolutions and softmax summed in another order
# the 28px models of the CLIs' mnist configs, at 8 channels
MNIST = dict(num_channels=8, attention_resolutions="14")
INPAINT, PAD = 14, -2.0
# `train_conditional_mnist.build_model(8)`, the class-conditional model
CLASS_CFG = dict(dim=(28, 28, 1), num_channels=8, num_heads=4,
                 attention_resolutions="14", num_classes=10)


def _np(a):
    return torch.from_numpy(np.array(a))


def _images(seed, shape):
    return np.clip(np.random.default_rng(seed).standard_normal(shape), -1,
                   1).astype(np.float32)


def draw_params(jax_model, init_args, seed, scales=None):
    """A flax param tree for `jax_model` drawn with numpy: kernels (the
    zero-initialised output conv too) N(0, 1/fan_in), norm scales
    1 + N(0, 0.1^2), biases N(0, 0.1^2), class embeddings N(0, 1). The
    kernels of the blocks named in `scales` are multiplied by their
    value."""
    scales = scales or {}
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            *init_args)
    rng = np.random.default_rng(seed)

    def draw(path, sd):
        leaf = path[-1].key
        if leaf == "kernel":
            v = rng.standard_normal(sd.shape) / np.sqrt(
                np.prod(sd.shape[:-1]))
            v *= scales.get(path[-2].key, 1.0)
        elif leaf == "scale":
            v = 1 + 0.1 * rng.standard_normal(sd.shape)
        elif leaf == "embedding":
            v = rng.standard_normal(sd.shape)
        else:
            v = 0.1 * rng.standard_normal(sd.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


class Twins:
    """A JAX wrapper with its flax params (fp32, dense attention) and the
    port's wrapper (in eval mode, `attention_impl="auto"`) on the same
    weights. `kind` is "class", "inpaint" or "superres". `apply` is the
    JAX model's jitted apply, compiled once per input shape, and `jax`
    stands in for the JAX model where a JAX function calls
    `model.apply`."""

    def __init__(self, kind, seed=0, dim=(28, 28, 1), scales=None, **kw):
        jcls, pcls, cond = {
            "class": (jax_unet.UNetModelWrapper, unet.UNetModelWrapper,
                      jnp.zeros((1,), jnp.int32)),
            "inpaint": (jax_unet.InPaintModelWrapper,
                        unet.InPaintModelWrapper, jnp.zeros((1,) + dim)),
            "superres": (jax_unet.SuperResModelWrapper,
                         unet.SuperResModelWrapper,
                         jnp.zeros((1,) + dim))}[kind]
        if kind == "class":
            kw = {"num_classes": 10, **kw}
        self.jm = jcls(dim=dim, dtype=jnp.float32, attention_impl="xla",
                       **kw)
        self.params = draw_params(
            self.jm, (jnp.zeros((1,)), jnp.zeros((1,) + dim), cond), seed,
            scales)
        self.apply = jax.jit(self.jm.apply)
        self.jax = type("Jitted", (), {"apply": staticmethod(self.apply)})
        port = pcls(dim=dim, dtype=torch.float32, attention_impl="auto",
                    device="cpu", **kw)
        port.load_state_dict(wrapper_state_dict_from_flax(self.params))
        self.port = port.eval()


@pytest.fixture(scope="module")
def models():
    """The mnist-sized class-conditional, inpainting and super-resolution
    twins (8 channels, attention at 14x14)."""
    return {kind: Twins(kind, seed=seed, **MNIST)
            for kind, seed in (("class", 1), ("inpaint", 3),
                               ("superres", 5))}


T4 = np.array([0.13, 0.5, 0.77, 0.999], np.float32)


# --- the wrappers ------------------------------------------------------------

def test_class_conditional_wrapper_matches_jax(models):
    """v(t, x, y) with 10 classes at 28px: the labels move the output, and
    both packages embed them alike."""
    m = models["class"]
    x = _images(2, (4, 28, 28, 1))
    y = np.array([0, 3, 9, 3], np.int32)
    want = np.asarray(m.apply(m.params, T4, x, y))
    with torch.no_grad():
        got = m.port(_np(T4), _np(x), _np(y).long())
        other = m.port(_np(T4), _np(x), _np((y + 1) % 10).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert (other - got).abs().max() > 1e-2
    assert m.port.net.class_emb.weight.shape == (10, 4 * 8)
    assert m.port.net.class_emb.weight.dtype == torch.float32


@pytest.mark.parametrize("kind", ["inpaint", "superres"])
def test_conditioned_wrappers_match_jax(kind, models):
    """The inpainting wrapper on a masked image, the super-resolution
    wrapper on a quarter-size low-res image (its bilinear upsample runs on
    both sides)."""
    m = models[kind]
    x = _images(4, (4, 28, 28, 1))
    cond = _images(6, (4, 7, 7, 1) if kind == "superres" else x.shape)
    want = np.asarray(m.apply(m.params, T4, x, cond))
    with torch.no_grad():
        got = m.port(_np(T4), _np(x), _np(cond))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert m.port.net.conv_in.in_channels == 2


def test_wrapper_with_1024_token_attention_matches_jax():
    """A 32x32 super-resolution wrapper with attention at 32x32 (T=1024):
    the port's "auto" puts those blocks on the flash path (its plain
    version here), as on the synthetic256 path; the JAX side runs dense."""
    m = Twins("superres", seed=7, dim=(32, 32, 3), num_channels=8,
              channel_mult=(1, 2), num_res_blocks=1,
              attention_resolutions="32")
    x = _images(8, (2, 32, 32, 3))
    low = _images(9, (2, 8, 8, 3))
    t = T4[:2]
    want = np.asarray(m.apply(m.params, t, x, low))
    with torch.no_grad():
        got = m.port(_np(t), _np(x), _np(low))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    decisions = m.port.net.attn_decisions
    flash = sorted(n for n, d in decisions.items() if d["impl"] == "flash")
    assert flash == ["dec_attn_0_0", "dec_attn_0_1", "enc_attn_0_0"]
    assert all(decisions[n]["tokens"] == 1024 for n in flash)


def _chip_smoke_constant(name):
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def test_sr256_config_parameter_count_matches_jax():
    """The full synthetic256 super-resolution model (128 channels,
    (1,1,2,2,4,4), attention at 32/16/8 with 4 heads): the JAX model's
    parameter count (`jax.eval_shape`), the port's on the meta device, and
    the count `chip_smoke.py` holds the card's model to are one number;
    the tree maps key for key. At 32x32 the blocks have 256 channels, 4
    heads of 64: T=1024, the flash path."""
    jm, dim = jax_cfmc.build("superres", "synthetic256")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1,)),
                            jnp.zeros((1,) + dim),
                            jnp.zeros((1, 64, 64, 3)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    port, pdim = cfmc.build("superres", "synthetic256", device="meta")
    assert pdim == dim == (256, 256, 3)
    got = sum(p.numel() for p in port.parameters())
    assert got == want == _chip_smoke_constant("SR256_PARAMS")
    keys = set(wrapper_state_dict_from_flax(jax.tree.map(
        lambda s: np.zeros((), np.float32), shapes)))
    assert keys == {k for k, _ in port.named_parameters()}
    net = port.net
    assert net.channel_mult == (1, 1, 2, 2, 4, 4)
    assert net.attention_resolutions == (8, 16, 32)
    blocks = {n: m for n, m in net.named_children() if "attn" in n}
    at32 = sorted(n for n in blocks if n.split("_")[-2] == "3")
    assert at32 == ["dec_attn_3_0", "dec_attn_3_1", "dec_attn_3_2",
                    "enc_attn_3_0", "enc_attn_3_1"]
    assert all(blocks[n].qkv.in_features == 256 and blocks[n].heads == 4
               and blocks[n].resolved_impl(32 * 32) == "flash"
               for n in at32)
    assert net.dtype == torch.bfloat16


def test_cli_configs_match_jax(models):
    """Every dataset's wrapper of `train_cfm_conditional.build` (at width
    8: the structure is the dataset's) and the class-conditional model of
    `train_conditional_mnist.build_model` map key for key onto the JAX
    package's."""
    for task, dataset, low in (("inpaint", "mnist", None),
                               ("superres", "flowers", 16)):
        jm, dim = jax_cfmc.build(task, dataset, num_channels=8)
        cond = jnp.zeros((1, low, low, 3) if low else (1,) + dim)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((1,)), jnp.zeros((1,) + dim), cond)
        port, _ = cfmc.build(task, dataset, num_channels=8, device="meta")
        keys = {k: tuple(v.shape) for k, v in wrapper_state_dict_from_flax(
            jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         shapes)).items()}
        assert keys == {k: tuple(p.shape)
                        for k, p in port.named_parameters()}, dataset
    # the class-conditional twins are build_model(8)'s config in fp32
    assert jax_cm.build_model(8) == jax_unet.UNetModelWrapper(**CLASS_CFG)
    port = cm.build_model(8, device="meta")
    assert {k: p.shape for k, p in port.named_parameters()} == {
        k: p.shape for k, p in models["class"].port.named_parameters()}
    assert port.net.dtype == torch.bfloat16


def _second_tree(params):
    """Another head's weights: a fixed affine map of `params`."""
    return jax.tree.map(lambda a: 0.5 * a + 0.01, params)


def test_heads_tree_converts_and_loads_into_a_train_state(models):
    """SF2M's {"flow": ..., "score": ...} tree onto a ModuleDict of two
    wrappers, through `load_flax_train_state`."""
    params = models["class"].params
    tree = {"flow": params, "score": _second_tree(params)}
    model = nn.ModuleDict({h: cm.build_model(8, device="cpu")
                           for h in ("flow", "score")})
    sd = heads_state_dict_from_flax(tree)
    assert set(sd) == set(model.state_dict())
    opt = trainer.make_optimizer(model.parameters(), 1e-3)
    state = load_flax_train_state(trainer.TrainState.create(model, opt),
                                  tree, step=3)
    assert state.step == 3
    for name, p in state.params.items():
        assert torch.equal(p.detach(), sd[name])
        assert torch.equal(state.ema.params[name], sd[name])
    assert not torch.equal(sd["flow.net.conv_in.weight"],
                           sd["score.net.conv_in.weight"])


# --- matchers ----------------------------------------------------------------

def _pairs(seed, b=8):
    rng = np.random.default_rng(seed)
    x0, x1 = (rng.standard_normal((b, 4, 4, 2)).astype(np.float32)
              for _ in range(2))
    return x0, x1, np.arange(b, dtype=np.int32)


def _draws(key, shape):
    """t and eps of a matcher's (kt, kx) split of `key`."""
    kt, kx = jax.random.split(key)
    return (_np(jax.random.uniform(kt, (shape[0],))),
            _np(jax.random.normal(kx, shape)))


def _close(got, want, atol=1e-6):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=atol)


class ReplaySinkhorn:
    """Stands in for the port's `sinkhorn_assignment`: returns the JAX
    package's sampled plan from `key` and records the regularisation."""

    def __init__(self, key):
        self.key, self.regs = key, []

    def __call__(self, x0, x1, reg=0.05, num_iters=50, generator=None):
        self.regs.append(reg)
        return _np(jax_cfm.sinkhorn_assignment(
            jnp.asarray(x0.numpy()), jnp.asarray(x1.numpy()), reg=reg,
            num_iters=num_iters, key=self.key)).long()


@pytest.mark.parametrize("name", ["icfm", "fm", "si", "sbcfm"])
def test_with_eps_and_guided_match_jax(name, monkeypatch):
    """`sample_location_and_conditional_flow_with_eps` (t, x_t, u_t, eps)
    and the base `guided_*` (labels passed through) with the JAX draws;
    for sbcfm both go through the sinkhorn coupling at reg 2 sigma^2."""
    sigma = 0.5 if name == "sbcfm" else 0.1
    jm, pm = (m.get_matcher(name, sigma=sigma) for m in (jax_cfm, cfm))
    x0, x1, y1 = _pairs(20)
    key = jax.random.PRNGKey(21)
    replay = ReplaySinkhorn(jax.random.split(key)[0])
    monkeypatch.setattr(cfm, "sinkhorn_assignment", replay)
    inner = jax.random.split(key)[1] if name == "sbcfm" else key
    t, eps = _draws(inner, x0.shape)
    want = jm.sample_location_and_conditional_flow_with_eps(
        key, jnp.asarray(x0), jnp.asarray(x1))
    got = pm.sample_location_and_conditional_flow_with_eps(
        None, _np(x0), _np(x1), t=t, eps=eps)
    _close(got, want)
    want = jm.guided_sample_location_and_conditional_flow(
        key, jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(y1))
    got = pm.guided_sample_location_and_conditional_flow(
        None, _np(x0), _np(x1), _np(y1), t=t, eps=eps)
    _close(got, want)
    assert replay.regs == ([2 * sigma**2] * 2 if name == "sbcfm" else [])


@pytest.mark.parametrize("method", ["exact", "sinkhorn"])
def test_ot_guided_permutes_labels_with_x1(method, monkeypatch):
    """OT-CFM's guided method: the plan (exact, or the JAX package's
    sampled sinkhorn plan) reorders x1 and y1 identically; every output
    within 1e-6 of the JAX package's."""
    jm = jax_cfm.get_matcher("otcfm", sigma=0.0, method=method)
    pm = cfm.get_matcher("otcfm", sigma=0.0, method=method)
    x0, x1, y1 = _pairs(22)
    key = jax.random.PRNGKey(23)
    kp, kr = jax.random.split(key)
    replay = ReplaySinkhorn(kp)
    monkeypatch.setattr(cfm, "sinkhorn_assignment", replay)
    t, eps = _draws(kr, x0.shape)
    want = jm.guided_sample_location_and_conditional_flow(
        key, jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(y1))
    got = pm.guided_sample_location_and_conditional_flow(
        None, _np(x0), _np(x1), _np(y1), t=t, eps=eps)
    _close(got, want)
    perm = got[3].numpy()
    assert not np.array_equal(perm, y1)  # the plan is not the identity
    # at sigma 0, u_t = x1[perm] - x0: the labels follow their images
    np.testing.assert_allclose(got[2].numpy(), x1[perm] - x0, atol=1e-6)
    assert replay.regs == ([0.05] if method == "sinkhorn" else [])


def test_compute_lambda_matches_jax():
    t = np.linspace(0.01, 0.99, 7).astype(np.float32)
    for sigma in (0.1, 1.0):
        want = jax_cfm.SchrodingerBridgeConditionalFlowMatcher(
            sigma=sigma).compute_lambda(jnp.asarray(t))
        got = cfm.SchrodingerBridgeConditionalFlowMatcher(
            sigma=sigma).compute_lambda(_np(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


# --- losses ------------------------------------------------------------------

LOSS_CASES = [("inpaint", False), ("inpaint", True), ("superres", False)]


@pytest.mark.parametrize("task,weighted", LOSS_CASES)
def test_conditional_loss_matches_jax(task, weighted, models):
    """`make_loss_fn` of the CFM conditional CLI on the JAX loss's x0, t and
    condition (the JAX condition function's draw): within 1e-5. The
    weighted inpainting loss differs from the unweighted one; the port's
    own condition is a patch of pad_value, or the quarter-size image."""
    m = models[task]
    dim = (28, 28, 1)
    x1 = _images(31, (4,) + dim)
    key = jax.random.PRNGKey(32)
    matcher = jax_cfm.get_matcher("icfm", sigma=0.0)
    jcond = jax_cfmc.make_condition_fn(task, dim, INPAINT, PAD)
    loss = jax_cfmc.make_loss_fn(m.jax, matcher, jcond, task, weighted, PAD)
    want = float(loss(m.params, key, jnp.asarray(x1)))
    k0, km, kc = jax.random.split(key, 3)
    cond = _np(jcond(kc, jnp.asarray(x1)))
    t, eps = _draws(km, x1.shape)
    x0 = _np(jax.random.normal(k0, x1.shape))
    pcond = cfmc.make_condition_fn(task, dim, INPAINT, PAD)
    draws = dict(x0=x0, t=t, eps=eps, cond=cond)
    with torch.no_grad():
        got, plain = (float(cfmc.make_loss_fn(
            cfm.get_matcher("icfm", sigma=0.0), pcond, task, w, PAD)(
                m.port, None, _np(x1), **draws)) for w in (weighted, False))
        own = pcond(torch.Generator().manual_seed(0), _np(x1))
    assert got == pytest.approx(want, abs=1e-5, rel=1e-5)
    assert (got != plain) == (task == "inpaint" and weighted)
    if task == "inpaint":
        assert ((own == PAD).sum(dim=(1, 2, 3)) == INPAINT**2).all()
        assert torch.equal(torch.where(own == PAD, _np(x1), own), _np(x1))
    else:
        np.testing.assert_allclose(own.numpy(), np.asarray(cond), rtol=0,
                                   atol=1e-6)


def test_sf2m_loss_matches_jax(models, monkeypatch):
    """The two-head SF2M objective of `train_conditional_mnist`: the flow
    loss plus mean((lambda_t s + eps)^2), computed on the JAX side as the
    JAX CLI's loss does, with its x0, t, eps and sinkhorn plan."""
    m = models["class"]
    tree = {"flow": m.params, "score": _second_tree(m.params)}
    model = _fp32_heads(tree)
    sigma = 0.3
    matcher = jax_cfm.SchrodingerBridgeConditionalFlowMatcher(sigma=sigma)
    x1 = _images(42, (4, 28, 28, 1))
    y1 = np.array([0, 1, 2, 5], np.int32)
    key = jax.random.PRNGKey(43)
    # train_conditional_mnist.py's loss_fn, sf2m branch
    k0, km = jax.random.split(key)
    x0 = jax.random.normal(k0, x1.shape, jnp.float32)
    t, xt, ut, eps = matcher.sample_location_and_conditional_flow_with_eps(
        km, x0, jnp.asarray(x1))
    vt = m.apply(tree["flow"], t, xt, y1)
    lam = matcher.compute_lambda(t)
    st = m.apply(tree["score"], t, xt, y1)
    want = float(jax_cfm.cfm_loss(vt, ut) + jnp.mean(
        (lam.reshape(-1, 1, 1, 1) * st + eps) ** 2))

    kp, kr = jax.random.split(km)
    monkeypatch.setattr(cfm, "sinkhorn_assignment", ReplaySinkhorn(kp))
    t, eps = _draws(kr, x1.shape)
    loss = cm.make_loss_fn(cfm.SchrodingerBridgeConditionalFlowMatcher(
        sigma=sigma), sf2m=True)
    with torch.no_grad():
        got = float(loss(model, None, {"x": _np(x1), "y": _np(y1).long()},
                         x0=_np(x0), t=t, eps=eps))
    assert got == pytest.approx(want, abs=1e-5, rel=1e-5)


def _fp32_heads(tree):
    """A ModuleDict of fp32 class-conditional wrappers (`build_model`'s
    config) carrying the flax trees' weights, head by head."""
    model = nn.ModuleDict({h: unet.UNetModelWrapper(
        dtype=torch.float32, device="cpu", **CLASS_CFG) for h in tree})
    model.load_state_dict(heads_state_dict_from_flax(tree))
    return model.eval()


# --- samplers ----------------------------------------------------------------

class LinearField:
    """A conditional velocity v(t, x; cond) = a x + t mean(cond), for the
    JAX sampler (`apply(params, t, x, cond)`, params = a) and the port's
    (`field(t, x, cond)`): cheap to compile, smooth enough for dopri5 at
    tol 1e-5 to take several steps."""

    @staticmethod
    def apply(a, t, x, cond):
        return a * x + t * jnp.mean(cond, axis=(1, 2, 3), keepdims=True)

    def __init__(self, a):
        self.a = a

    def __call__(self, t, x, cond):
        return self.a * x + t * cond.mean(dim=(1, 2, 3), keepdim=True)


@pytest.mark.parametrize("method", ["euler", "dopri5"])
def test_conditional_sampler_matches_jax(method):
    """`make_conditional_sampler` on the JAX sampler's noise, with the
    condition held fixed: x1 within 1e-5 and the NFE exactly."""
    shape = (3, 6, 6, 1)
    cond = _images(51, (3, 3, 3, 1))
    key = jax.random.PRNGKey(52)
    want, want_nfe = jax.jit(jax_cfmc.make_conditional_sampler(
        LinearField, method, 7), static_argnums=(2,))(-1.5, key, shape,
                                                      cond)
    got, nfe = cfmc.make_conditional_sampler(method, 7)(
        LinearField(-1.5), None, shape, _np(cond),
        x0=_np(jax.random.normal(key, shape)))
    assert nfe == int(want_nfe)
    assert nfe == 7 if method == "euler" else nfe > 13
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_sf2m_generative_sde_matches_jax():
    """The Euler-Maruyama generative SDE over label-dependent fields, with
    the JAX noise replayed (per step: key, nk = split(key)), no noise on
    the last step and the output clipped; within 1e-5."""
    steps, sigma = 6, 0.5
    x0 = 1.5 * _images(62, (3, 5, 5, 1))
    y = np.array([1, 4, 7], np.int32)
    key = jax.random.PRNGKey(63)

    def jflow(t, x, yy):
        return 1.5 * x + 0.1 * yy[:, None, None, None] * t[:, None, None, None]

    def jscore(t, x, yy):
        return -2.0 * x + 0.05 * yy[:, None, None, None]

    want = jax.jit(lambda k, x: jax_cm.sf2m_generative_sde(
        jflow, jscore, k, x, y, sigma, steps))(key, jnp.asarray(x0))
    keys = []
    for _ in range(steps):
        key, nk = jax.random.split(key)
        keys.append(nk)

    def noise(like, kind, k, j=0):
        assert kind == "sde" and k < steps - 1
        return _np(jax.random.normal(keys[k], tuple(like.shape)))

    def pflow(t, x, yy):
        return 1.5 * x + 0.1 * yy[:, None, None, None] * t[:, None, None, None]

    def pscore(t, x, yy):
        return -2.0 * x + 0.05 * yy[:, None, None, None]

    got = cm.sf2m_generative_sde(pflow, pscore, None, _np(x0), _np(y),
                                 sigma, steps, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert got.abs().max() <= 1.0 and (got.abs() == 1.0).any()


def test_class_consistency_matches_jax():
    from tpu_diffusion.data.registry import get_dataset as jax_dataset
    from tpu_diffusion_torch.data.registry import get_dataset
    jds, pds = (f("mnist")("data", train=False)
                for f in (jax_dataset, get_dataset))
    templates = cm.class_templates(pds)
    np.testing.assert_array_equal(templates, jax_cm.class_templates(jds))
    gen = _images(70, (20, 28, 28, 1))
    labels = np.arange(20) % 10
    assert cm.class_consistency(gen, labels, templates) == \
        jax_cm.class_consistency(gen, labels, templates)
    a, b = (next(f(ds, 16, seed=3)) for f, ds in
            ((cm.labeled_batches, pds), (jax_cm.labeled_batches, jds)))
    np.testing.assert_array_equal(a["x"], b["x"])
    np.testing.assert_array_equal(a["y"], b["y"])


# --- the trainer on dict batches and two heads -------------------------------

def test_trainer_takes_dict_batches_and_two_heads(tmp_path):
    """Two SF2M steps through `Trainer.fit`: {"x", "y"} batches reach the
    loss as tensors, both heads and their EMA move, and a checkpoint of
    the state reads back equal."""
    model = nn.ModuleDict({h: cm.build_model(8, device="cpu")
                           for h in ("flow", "score")})
    opt = trainer.make_optimizer(model.parameters(), 1e-3, warmup=1)
    state = trainer.TrainState.create(model, opt,
                                      torch.Generator().manual_seed(0))
    before = {k: v.detach().clone() for k, v in state.params.items()}
    seen = []
    loss = cm.make_loss_fn(cfm.SchrodingerBridgeConditionalFlowMatcher(0.1),
                           sf2m=True)

    def spy(model, gen, batch):
        seen.append({k: (type(v), v.dtype) for k, v in batch.items()})
        return loss(model, gen, batch)

    ds = type("DS", (), {"images": _images(80, (16, 28, 28, 1)),
                         "labels": np.arange(16, dtype=np.int32) % 10,
                         "__len__": lambda self: 16})()
    state = trainer.Trainer(
        trainer.make_train_step(spy, ema_decay=0.9), state,
        cm.labeled_batches(ds, 8)).fit(2)
    assert seen == [{"x": (torch.Tensor, torch.float32),
                     "y": (torch.Tensor, torch.int32)}] * 2
    for head in ("flow", "score"):
        name = f"{head}.net.conv_out.weight"
        assert not torch.equal(state.params[name], before[name])
        assert not torch.equal(state.ema.params[name], before[name])
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assets = {"params": state.params, "ema": state.ema.params,
              "step": state.step}
    ckpt.save(state.step, assets)
    loaded, step = ckpt.load(assets)
    assert step == 2 and loaded["step"] == 2
    assert all(torch.equal(loaded[t][k], v.detach())
               for t in ("params", "ema") for k, v in assets[t].items())


# --- the CLIs end to end -------------------------------------------------------

CFM_ARGS = ["--dataset", "mnist", "--model", "icfm", "--num_steps", "2",
            "--batch_size", "8", "--warmup", "1", "--eval_batches", "1",
            "--eval_batch_size", "8", "--eval_method", "euler",
            "--eval_every_div", "1", "--num_channels", "8",
            "--eval_ode_steps", "2", "--device", "cpu"]


@pytest.mark.parametrize("extra", [["--task", "inpaint", "--weighted_loss"],
                                   ["--task", "superres"]])
def test_train_cfm_conditional_cli(tmp_path, extra):
    """The JAX test's tiny runs (tests/test_cfm_conditional.py:16-21) plus
    --device cpu: results.json has the JAX CLI's keys with finite values,
    the per-step results, image grids and checkpoints {params, ema,
    step}."""
    out = cfmc.main(["--output_dir", str(tmp_path)] + CFM_ARGS + extra)
    d = out["output_dir"]
    assert d == os.path.join(str(tmp_path), f"mnist_{extra[1]}_icfm")
    res = json.load(open(os.path.join(d, "results.json")))
    assert sorted(res) == ["mse", "nfe", "num_batches", "psnr", "ssim"]
    assert all(np.isfinite(v) for v in res.values())
    assert res["nfe"] == 2 and res["num_batches"] == 1
    per = json.load(open(os.path.join(d, "results_per_step.json")))
    assert [r["step"] for r in per] == [2, 2]
    imgs = os.listdir(os.path.join(d, "images"))
    assert any(f.startswith("generated") for f in imgs)
    assert any(f.startswith("ground_truth") for f in imgs)
    saved = torch.load(os.path.join(d, "ckpt", "ckpt_00000002.pt"),
                       weights_only=True)
    assert saved["step"] == 2 and set(saved) == {"params", "ema", "step"}
    assert set(saved["params"]) == set(out["state"].params)


def test_train_cfm_conditional_refuses_the_mesh(tmp_path):
    for flag in (["--model_axis", "2"], ["--sequence_parallel"]):
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
            cfmc.main(["--output_dir", str(tmp_path)] + CFM_ARGS + flag)


@pytest.mark.parametrize("variant", ["cfm", "otcfm", "sf2m"])
def test_train_conditional_mnist_cli(tmp_path, variant):
    """Each variant at a tiny size: the class grid finite in [-1, 1], the
    class-consistency trend, the images and the checkpoint's heads."""
    last = cm.main(["--variant", variant, "--output_dir", str(tmp_path),
                    "--num_channel", "8", "--num_steps", "2",
                    "--batch_size", "16", "--warmup", "1",
                    "--sample_steps", "2", "--sample_grid_per_class", "1",
                    "--save_every", "1000", "--device", "cpu"])
    grid = last["grid"]
    assert grid.shape == (10, 28, 28, 1) and torch.isfinite(grid).all()
    assert grid.abs().max() <= 1.0 and last["step"] == 2
    trend = json.load(open(tmp_path / variant / "class_trend.json"))
    assert [r["step"] for r in trend] == [2]
    assert set(trend[0]) == {"step", "accuracy", "per_class_accuracy",
                             "psnr_to_own_template"}
    assert any(f.startswith(f"{variant}_classes")
               for f in os.listdir(tmp_path / variant / "images"))
    saved = torch.load(tmp_path / variant / "ckpt" / "ckpt_00000002.pt",
                       weights_only=True)
    heads = {k.split(".")[0] for k in saved["params"]}
    assert heads == ({"flow", "score"} if variant == "sf2m" else {"flow"})
