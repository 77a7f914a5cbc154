"""The port's repairs against the JAX package: the discrete schedule
builders and `DDPM.from_alphas_cumprod` (`core/schedules.py`),
`create_model(use_checkpoint=...)`, `CheckpointManager.close()`, and the
evaluation CLI's `--device` with `--self_consistency`. (The lazy package
root is held by tests/test_torch_isolation.py.)"""

import ast
import csv
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.core import schedules as jax_schedules
from tpu_diffusion.models.unet import create_model as jax_create_model
from tpu_diffusion.protein import mpnn as jax_mpnn
from tpu_diffusion_torch.core import schedules
from tpu_diffusion_torch.models.unet import create_model, randomize_
from tpu_diffusion_torch.protein import evaluate
from tpu_diffusion_torch.protein import self_consistency as sc
from tpu_diffusion_torch.train.checkpoint import CheckpointManager

BUILDERS = [("linear_betas", (1000,), {}),
            ("linear_betas", (37,), dict(beta_start=2e-4, beta_end=0.05)),
            ("cosine_alphas_cumprod", (1000,), {}),
            ("cosine_alphas_cumprod", (100,), dict(s=0.01)),
            ("hoogeboom_alphas_cumprod", (250,), {}),
            ("hoogeboom_alphas_cumprod", (50,),
             dict(s=1e-3, exponent=2.0, clip_value=0.05)),
            ("sigmoid_betas", (1000,), {}),
            ("sigmoid_betas", (64,), dict(tau=3.0)),
            ("quadratic_betas", (1000,), {}),
            ("quadratic_betas", (10,), dict(beta_start=1e-3))]


@pytest.mark.parametrize("name,args,kw", BUILDERS)
def test_schedule_builders_are_bitwise_the_jax_ones(name, args, kw):
    got = getattr(schedules, name)(*args, **kw)
    want = np.asarray(getattr(jax_schedules, name)(*args, **kw))
    assert got.dtype == np.float64 and want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["cosine_alphas_cumprod",
                                  "hoogeboom_alphas_cumprod"])
def test_betas_from_alphas_cumprod_are_bitwise_the_jax_ones(name):
    abar = getattr(schedules, name)(200)
    np.testing.assert_array_equal(
        schedules.betas_from_alphas_cumprod(abar, max_beta=0.5),
        np.asarray(jax_schedules.betas_from_alphas_cumprod(abar,
                                                           max_beta=0.5)))


def test_core_exports_the_builders():
    from tpu_diffusion_torch import core
    from tpu_diffusion import core as jax_core
    assert set(jax_core.__all__) <= set(core.__all__)


def test_ddpm_from_alphas_cumprod_matches_jax():
    """The tables of `test_ddpm_tables_match_jax`, at its tolerance, and the
    JAX round trip of tests/test_schedules.py."""
    from test_torch_schedules import TABLES
    abar = schedules.cosine_alphas_cumprod(100)
    port = schedules.DDPM.from_alphas_cumprod(abar)
    ref = jax_schedules.DDPM.from_alphas_cumprod(abar)
    assert port.num_steps == ref.num_steps == 100
    for name in TABLES:
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-7, rtol=0, err_msg=name)
    np.testing.assert_allclose(port.alphas_cumprod.numpy(), abar, rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_use_checkpoint_gives_the_same_loss_and_gradients(dropout):
    """A tiny UNet trained with and without rematerialised ResBlocks: the
    loss and every gradient equal (with dropout, the recomputation redraws
    the forward's masks), and the generator ends in the same state."""
    cfg = dict(image_size=16, num_channels=16, num_res_blocks=1,
               channel_mult=(1, 2), attention_resolutions="8", num_heads=2,
               use_scale_shift_norm=True, dropout=dropout,
               dtype=torch.float32, device="cpu")
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([0.2, 0.7])
    out = []
    for remat in (False, True):
        model = create_model(use_checkpoint=remat, **cfg).train()
        randomize_(model, torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(5)
        loss = model(x, t, generator=gen).square().mean()
        loss.backward()
        out.append((loss.detach(), {k: p.grad.clone() for k, p in
                                    model.named_parameters()},
                    torch.rand(1, generator=gen)))
    (l0, g0, r0), (l1, g1, r1) = out
    assert torch.equal(l0, l1) and torch.equal(r0, r1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-7,
                                   msg=k)
    assert create_model(use_checkpoint=True, **cfg).use_checkpoint


def test_create_model_takes_every_jax_argument():
    """`use_checkpoint` and `sp_mesh` were the JAX `create_model` arguments
    the port lacked; now only `device` is the port's own."""
    port = inspect.signature(create_model).parameters
    ref = inspect.signature(jax_create_model).parameters
    assert set(port) - set(ref) == {"device"}
    assert set(ref) <= set(port)
    assert [n for n in port if n in ref] == list(ref)


def test_checkpoint_manager_close_is_a_no_op(tmp_path):
    mgr = CheckpointManager(str(tmp_path), maximum=1)
    mgr.save(3, {"w": torch.ones(2), "step": 3})
    assert mgr.close() is None
    assets, step = CheckpointManager(str(tmp_path)).load(None)
    assert step == 3 and torch.equal(assets["w"], torch.ones(2))


def test_evaluate_cli_runs_self_consistency_on_the_cpu(tmp_path,
                                                       monkeypatch):
    """`--self_consistency --device cpu` with $TPU_DIFFUSION_MPNN_WEIGHTS
    naming a flat npz at the published width (random values drawn here):
    the scorer is built on the CPU, and sample_stats.csv carries each
    sample's designs (as long as the sample) and their scores."""
    shapes = jax.eval_shape(jax_mpnn.CAProteinMPNN().init,
                            jax.random.PRNGKey(0), jnp.zeros((8, 3)),
                            jnp.zeros(8, jnp.int32), jnp.arange(8),
                            jnp.ones(8))
    rng = np.random.default_rng(0)
    flat = {"/".join(str(p.key) for p in path):
            (0.1 * rng.standard_normal(sd.shape)).astype(np.float32)
            for path, sd in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    weights = tmp_path / "mpnn.npz"
    np.savez(weights, **flat)
    monkeypatch.setenv("TPU_DIFFUSION_MPNN_WEIGHTS", str(weights))
    loaded = []

    def load(**kw):
        scorer = load_scorer(**kw)
        loaded.append(next(scorer.model.parameters()).device)
        return scorer

    load_scorer = sc.load_proteinmpnn_scorer
    monkeypatch.setattr(sc, "load_proteinmpnn_scorer", load)
    sample_dir = tmp_path / "samples"
    sample_dir.mkdir()
    steps = np.random.default_rng(10).normal(0, 1, (50, 3))
    np.save(sample_dir / "sample_0000.npy",
            np.cumsum(3.8 * steps / np.linalg.norm(steps, axis=-1,
                                                   keepdims=True), 0))
    evaluate.main(["--sample_dir", str(sample_dir), "--self_consistency",
                   "--n_seq", "2", "--colabfold", "no-such-colabfold",
                   "--device", "cpu"])
    assert loaded == [torch.device("cpu")]
    with open(sample_dir / "sample_stats.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    seqs = ast.literal_eval(rows[0]["protein_mpnn_seqs"])
    scores = ast.literal_eval(rows[0]["protein_mpnn_scores"])
    assert len(seqs) == len(scores) == 2
    assert all(len(q) == 50 for q in seqs)
    assert all(0 < v <= 1 for v in scores)
    assert (sample_dir / "protein_mpnn_seqs.csv").exists()
