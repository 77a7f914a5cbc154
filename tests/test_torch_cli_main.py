"""The port's experiment config and `cli/main.py --mode eval` against the JAX
package, on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.eval.metrics import eval_statistics as jax_statistics
from tpu_diffusion.parallel.mesh import make_mesh as jax_make_mesh
from tpu_diffusion.utils import config as jax_config
from tpu_diffusion_torch.cli import main as cli
from tpu_diffusion_torch.conditioning import guidance, likelihoods
from tpu_diffusion_torch.models import unet
from tpu_diffusion_torch.parallel import sp
from tpu_diffusion_torch.parallel.mesh import make_mesh
from tpu_diffusion_torch.utils import config


@pytest.mark.parametrize("dataset", jax_config.DATASETS)
def test_get_config_matches_jax_for_every_spec(dataset):
    assert config.DATASETS == jax_config.DATASETS
    assert config.LIKELIHOODS == jax_config.LIKELIHOODS
    assert config.CONDITIONINGS == jax_config.CONDITIONINGS
    assert config.PRETRAINED_WEIGHTS == jax_config.PRETRAINED_WEIGHTS
    for lik in jax_config.LIKELIHOODS:
        for cond in jax_config.CONDITIONINGS:
            spec = f"{dataset},{lik},{cond}"
            assert (config.get_config(spec).to_dict()
                    == jax_config.get_config(spec).to_dict()), spec


def test_get_config_rejects_bad_specs():
    for spec in ("mnist,inpainting", "svhn,inpainting,amortized",
                 "mnist,deblur,amortized", "mnist,inpainting,cfg"):
        with pytest.raises(ValueError):
            config.get_config(spec)


def test_apply_overrides_matches_jax():
    overrides = ["training.batch_size=64", "testing.lpips=false",
                 "conditioning.gamma=2.5", "network.attention_impl=dense",
                 "testing.fid=1"]
    got = config.get_config("flowers,inpainting,reconstruction_guidance")
    want = jax_config.get_config("flowers,inpainting,reconstruction_guidance")
    config.apply_overrides(got, overrides)
    jax_config.apply_overrides(want, overrides)
    assert got.to_dict() == want.to_dict()
    assert got.training.batch_size == 64 and got.testing.lpips is False
    assert got.conditioning.gamma == 2.5 and got.testing.fid is True
    with pytest.raises(KeyError):
        config.apply_overrides(got, ["testing.nope=1"])


@pytest.mark.parametrize("spec,in_channels,lik,cond", [
    ("flowers,inpainting,amortized", 6, likelihoods.InPainting,
     guidance.Amortized),
    ("celeba,hyperresolution,reconstruction_guidance", 3,
     likelihoods.HyperResolution, guidance.ReconstructionGuidance),
    ("mnist,outpainting,replacement", 1, likelihoods.OutPainting,
     guidance.Replacement)])
def test_build_geometry(spec, in_channels, lik, cond):
    cfg = config.get_config(spec)
    parts = cli.build(cfg, device="meta")
    model = parts["model"]
    assert parts["in_channels"] == in_channels
    assert model.conv_in.in_channels == in_channels
    assert model.conv_out.out_channels == cfg.dataset.num_channels
    assert model.dtype == torch.bfloat16
    assert isinstance(parts["likelihood"], lik)
    assert isinstance(parts["conditioning"], cond)
    assert parts["ddpm"].num_steps == 1000
    attn = {n: m for n, m in model.named_children() if "attn" in n}
    assert {m.impl for m in attn.values()} == {"auto"}
    if cfg.dataset.image_size == 64:
        # the 64px network: 128 channels, (1,2,3,4), 64-channel heads,
        # attention at 32, 16 and 8; 5 blocks on the 32x32 grid
        assert model.channel_mult == (1, 2, 3, 4)
        assert model.attention_resolutions == (2, 4, 8)
        assert attn["enc_attn_1_0"].heads == 4
        assert attn["mid_attn"].heads == 8
        assert sorted(n for n in attn if n[-3] == "1") == [
            "dec_attn_1_0", "dec_attn_1_1", "dec_attn_1_2", "enc_attn_1_0",
            "enc_attn_1_1"]


def test_build_rejects_the_mesh(tmp_path, monkeypatch):
    """The mesh knobs reach the model and the Trainer (the JAX
    tests/test_sp_tp_surface.py:87-101): `network.sequence_parallel` hands
    the mesh to every attention block, which runs its local attention on a
    one-rank "model" axis; `main` passes the mesh and `tensor_parallel`
    (mesh.model_axis > 1) to the Trainer and the mesh to the optimizer; a
    `mesh.model_axis` that one process cannot hold is rejected with the JAX
    package's message."""
    cfg = config.get_config("mnist,inpainting,amortized")
    config.apply_overrides(cfg, ["network.sequence_parallel=True",
                                 "network.num_channels=16",
                                 "network.num_head_channels=16"])
    mesh = make_mesh(model=cfg.mesh.model_axis)
    parts = cli.build(cfg, device="cpu", mesh=mesh)
    blocks = [m for m in parts["model"].modules()
              if isinstance(m, unet.AttentionBlock)]
    assert blocks and all(b.sp_mesh is mesh for b in blocks)
    sp.reset_sp_decisions()
    with torch.no_grad():
        out = parts["model"](torch.zeros(4, 28, 28, parts["in_channels"]),
                             torch.zeros(4))
    assert out.shape == (4, 28, 28, 1)
    assert [d["reason"] for d in sp.sp_decisions()] == (
        ["no mesh axis"] * len(blocks))

    class Seen(Exception):
        pass

    def record(train_step, state, *args, mesh=None, tensor_parallel=False,
               **kw):
        raise Seen(mesh, tensor_parallel, state.optimizer.mesh)

    monkeypatch.setattr(cli, "Trainer", record)
    args = ["--config", "mnist,inpainting,amortized", "--mode", "train",
            "--device", "cpu", "--workdir", str(tmp_path)]
    for o in ["network.sequence_parallel=True", "network.num_channels=16",
              "network.num_head_channels=16", "training.num_steps=2",
              "diffusion.num_steps=25"]:
        args += ["--override", o]
    with pytest.raises(Seen) as seen:
        cli.main(args)
    got_mesh, tensor_parallel, optimizer_mesh = seen.value.args
    assert got_mesh.shape == {"data": 1, "model": 1}
    assert optimizer_mesh is got_mesh
    assert tensor_parallel is False
    with pytest.raises(ValueError) as err:
        cli.main(args + ["--override", "mesh.model_axis=2"])
    with pytest.raises(ValueError) as want:
        jax_make_mesh(model=2, devices=jax.devices()[:1])
    assert str(err.value) == str(want.value)


EVAL_OVERRIDES = ["testing.num_test=4", "testing.batch_size=2",
                  "diffusion.num_steps=25", "testing.lpips=false",
                  "network.dtype=float32"]


def test_run_eval_writes_the_jax_results(tmp_path, capsys):
    args = ["--config", "mnist,inpainting,amortized", "--mode", "eval",
            "--device", "cpu", "--workdir", str(tmp_path)]
    for o in EVAL_OVERRIDES:
        args += ["--override", o]
    results = cli.main(args)
    out = capsys.readouterr().out
    assert "RANDOM-INIT" in out
    written = json.loads((tmp_path / "results.json").read_text())
    assert written == results
    zeros = jnp.zeros((2, 4, 4, 1))
    want_keys = set(jax_statistics(zeros, zeros)) | {"num_images"}
    assert set(written) == want_keys
    assert written["num_images"] == 4
    assert all(np.isfinite(v) for v in written.values())


def test_run_eval_is_seeded_and_follows_the_conditioning(tmp_path):
    """Two runs of one config give one result; guidance and replacement run
    too (a 'none' likelihood writes the JAX package's skip record)."""
    runs = {}
    for name, spec in (("a", "mnist,inpainting,amortized"),
                       ("b", "mnist,inpainting,amortized"),
                       ("guidance", "mnist,outpainting,"
                                    "reconstruction_guidance"),
                       ("replacement", "mnist,inpainting,replacement"),
                       ("none", "mnist,none,none")):
        cfg = config.get_config(spec)
        config.apply_overrides(cfg, EVAL_OVERRIDES + ["testing.num_test=2"])
        torch.manual_seed(0)
        parts = cli.build(cfg, device="cpu")
        (tmp_path / name).mkdir()
        runs[name] = cli.run_eval(cfg, parts, parts["model"].eval(),
                                  str(tmp_path / name))
    assert runs["a"] == runs["b"]
    assert runs["guidance"]["num_images"] == 2
    assert runs["replacement"]["num_images"] == 2
    assert runs["none"] == {"skipped": "likelihood 'none': no conditional "
                                       "eval"}


def test_prior_sample_rides_the_none_condition():
    """The amortized model's prior sampler is the conditional chain with the
    likelihood's "none" pad channels as the condition."""
    cfg = config.get_config("mnist,inpainting,amortized")
    config.apply_overrides(cfg, EVAL_OVERRIDES + ["testing.encoder_reuse=1"])
    torch.manual_seed(0)
    parts = cli.build(cfg, device="cpu")
    model = parts["model"].eval()
    cond_sample, prior_sample = cli.make_samplers(cfg, parts)
    xT = torch.randn((2, 28, 28, 1), generator=torch.Generator().manual_seed(1))
    prior = prior_sample(model, xT, torch.Generator().manual_seed(2))
    none = parts["likelihood"].none_like(xT)
    assert torch.equal(prior, cond_sample(model, xT, none,
                                          torch.Generator().manual_seed(2)))
    assert torch.isfinite(prior).all() and prior.abs().max() <= 1.0


def test_main_eval_runs_with_lpips_on_by_default(tmp_path):
    """`cli.main --mode eval --device cpu` on the tiny config, with the
    config's own testing.lpips=True (LPIPS per eval batch)."""
    assert config.get_config("mnist,inpainting,amortized").testing.lpips
    args = ["--config", "mnist,inpainting,amortized", "--mode", "eval",
            "--device", "cpu", "--workdir", str(tmp_path)]
    for o in EVAL_OVERRIDES + ["network.num_channels=16",
                               "network.num_head_channels=16"]:
        if not o.startswith("testing.lpips"):
            args += ["--override", o]
    results = cli.main(args)
    assert np.isfinite(results["lpips"]) and results["lpips"] > 0
    assert "fid" not in results
    assert json.loads((tmp_path / "results.json").read_text()) == results


TRAIN_OVERRIDES = EVAL_OVERRIDES + [
    "diffusion.num_steps=22", "training.num_steps=4", "training.batch_size=2",
    "training.warmup=2", "network.num_channels=16",
    "network.num_head_channels=16", "testing.num_test=2"]


def _cli(mode, workdir, extra=()):
    args = ["--config", "mnist,inpainting,amortized", "--mode", mode,
            "--device", "cpu", "--workdir", str(workdir)]
    for o in list(TRAIN_OVERRIDES) + list(extra):
        args += ["--override", o]
    return cli.main(args)


def test_train_all_then_eval_restores_the_ema_parameters(
        tmp_path, capsys, monkeypatch):
    results = _cli("all", tmp_path)
    out = capsys.readouterr().out
    assert "steps=4" in out and "RANDOM-INIT" not in out
    # every = max(4 // 10, 1) = 1: a checkpoint per step, the newest three
    # kept, the final save on top of the last
    ckpts = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    assert ckpts == ["ckpt_00000002.pt", "ckpt_00000003.pt",
                     "ckpt_00000004.pt"]
    assert json.loads((tmp_path / "results.json").read_text()) == results
    per_epoch = json.loads((tmp_path / "results_per_epoch.json").read_text())
    assert [r["step"] for r in per_epoch] == [1, 2, 3, 4]
    assert per_epoch[-1]["results"] == results
    assert results["num_images"] == 2
    assert (tmp_path / "metrics.csv").exists()
    saved = torch.load(tmp_path / "ckpt" / "ckpt_00000004.pt",
                       weights_only=True)
    assert saved["step"] == 4
    assert all(v.dtype == torch.float32 for v in saved["params"].values())
    # training moved the parameters, and the EMA trails them
    moved = [k for k in saved["params"]
             if not torch.equal(saved["params"][k], saved["ema"][k])]
    assert len(moved) > len(saved["params"]) // 2

    # --mode eval on the workdir evaluates exactly those EMA parameters
    seen = {}
    real_run_eval = cli.run_eval

    def spy(config, parts, model, *a, **kw):
        seen.update({k: v.detach().clone()
                     for k, v in model.named_parameters()})
        return real_run_eval(config, parts, model, *a, **kw)

    monkeypatch.setattr(cli, "run_eval", spy)
    again = _cli("eval", tmp_path)
    out = capsys.readouterr().out
    assert "RANDOM-INIT" not in out and "warm-start" not in out
    assert sorted(seen) == sorted(saved["ema"])
    for k, v in saved["ema"].items():
        assert torch.equal(seen[k], v), k
    assert again == results  # same parameters, same testing.seed


def test_eval_messages_follow_the_jax_package(tmp_path, capsys):
    trained, fresh, other = (tmp_path / n for n in ("a", "b", "c"))
    _cli("train", trained)
    capsys.readouterr()
    # a foreign checkpoint through network.model_path: the warm-start message
    _cli("eval", fresh, [f"network.model_path={trained / 'ckpt'}"])
    out = capsys.readouterr().out
    assert "warm-start from" in out and "tensors copied, 0 skipped" in out
    assert "no local checkpoint; evaluating the" in out
    assert "RANDOM-INIT" not in out
    # a path with no checkpoint: from scratch, then the random-init warning
    _cli("eval", other, [f"network.model_path={tmp_path / 'nowhere'}"])
    out = capsys.readouterr().out
    assert "no pretrained weights at" in out and "RANDOM-INIT" in out


def test_num_steps_zero_is_derived_from_the_epochs(tmp_path, monkeypatch):
    fits = []
    monkeypatch.setattr(cli.Trainer, "fit",
                        lambda self, n: fits.append(n) or self.state)
    _cli("train", tmp_path, ["training.num_steps=0", "training.epochs=2",
                             "training.batch_size=64"])
    n_train = len(cli.get_dataset("mnist")("data", train=True))
    assert fits == [2 * n_train // 64]
