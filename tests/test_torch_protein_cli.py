"""The port's protein CLIs end to end on the CPU (train, resume, sample,
mirroring tests/test_protein_cli.py up to the evaluation, which is not
ported yet), and the port's copy of `eval/plotting.py` under the JAX
package's plotting tests (tests/test_plotting_debug.py)."""

import inspect
import json
import os
import re

import numpy as np
import pytest
import torch

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.cli import sample_protein as jax_sample
from tpu_diffusion.cli import train_protein as jax_train
from tpu_diffusion_torch.cli import sample_protein, train_protein
from tpu_diffusion_torch.protein.data import COORD_SCALE
from tpu_diffusion_torch.protein.sde import ProteinBatch

TINY = ["--max_len", "24", "--node_scalars", "16", "--node_vectors", "4",
        "--conv_layers", "1", "--diffusion_steps", "20"]


def _flags(module):
    """The --flags a CLI's main defines (from its source)."""
    src = inspect.getsource(module.main) + (
        inspect.getsource(module.parser) if hasattr(module, "parser")
        else "")
    return set(re.findall(r'"(--\w+)"', src))


def test_cli_flags_are_the_jax_clis_plus_device():
    for port, jax_cli in ((train_protein, jax_train),
                          (sample_protein, jax_sample)):
        assert _flags(port) == _flags(jax_cli) | {"--device"}


def test_train_resume_then_sample(tmp_path):
    out = str(tmp_path / "protein")
    train_args = ["--output_dir", out, "--num_steps", "3", "--batch_size",
                  "8", "--device", "cpu"] + TINY
    first = train_protein.main(train_args)
    gvp = os.path.join(out, "gvp")
    assert os.path.exists(os.path.join(gvp, "config.yaml"))
    assert first["state"].step == 3
    saved = torch.load(os.path.join(gvp, "ckpt", "ckpt_00000003.pt"),
                       weights_only=True)
    assert set(saved) == {"params", "ema", "step"} and saved["step"] == 3
    for k, v in first["state"].params.items():
        torch.testing.assert_close(saved["params"][k], v.detach(), rtol=0,
                                   atol=0)
        torch.testing.assert_close(saved["ema"][k],
                                   first["state"].ema.params[k], rtol=0,
                                   atol=0)

    # a second run restores params, EMA and step from the checkpoint
    second = train_protein.main(train_args[:2] + ["--num_steps", "4"]
                                + train_args[4:])
    assert second["state"].step == 4
    # --ckpt_every 0 -> every max(num_steps // 10, 1) steps; newest three
    assert sorted(os.listdir(os.path.join(gvp, "ckpt"))) == [
        "ckpt_00000002.pt", "ckpt_00000003.pt", "ckpt_00000004.pt"]
    ema4 = torch.load(os.path.join(gvp, "ckpt", "ckpt_00000004.pt"),
                      weights_only=True)["ema"]
    # one EMA step from the restored EMA (warmup decay 2/11 at count 1)
    k = "W_out.ws.bias"
    decay = min(0.999, 2 / 11)
    want = decay * saved["ema"][k] + (1 - decay) * \
        second["state"].params[k].detach()
    torch.testing.assert_close(ema4[k], want, rtol=1e-6, atol=1e-7)

    sample_dir = str(tmp_path / "samples")
    res = sample_protein.main([
        "--ckpt_dir", os.path.join(gvp, "ckpt"), "--output_dir",
        sample_dir, "--num_samples", "3", "--batch_size", "3",
        "--device", "cpu"] + TINY)
    files = sorted(os.listdir(sample_dir))
    assert files == ["cond_losses.npy", "sample_0000.npy", "sample_0000.pdb",
                     "sample_0001.npy", "sample_0001.pdb", "sample_0002.npy",
                     "sample_0002.pdb", "summary.json"]
    with open(os.path.join(sample_dir, "summary.json")) as f:
        summary = json.load(f)
    # the keys of tpu_diffusion/cli/sample_protein.py's summary
    assert set(summary) == {"num_samples", "ckpt_step", "guidance_scale",
                            "cond_loss_mean", "cond_loss_std"}
    assert summary["num_samples"] == 3 and summary["ckpt_step"] == 4
    assert np.isfinite(summary["cond_loss_mean"])
    losses = np.load(os.path.join(sample_dir, "cond_losses.npy"))
    assert losses.shape == (3,)
    pos, mask = res["pos"], res["mask"]
    assert torch.isfinite(pos).all()
    for i in range(3):
        coords = np.load(os.path.join(sample_dir, f"sample_{i:04d}.npy"))
        np.testing.assert_allclose(coords * COORD_SCALE,
                                   pos[i][mask[i]].numpy(), rtol=1e-6)
    # unguided: no losses file, guidance_scale None, and the samples stay
    # COM-free (the guided update is not projected, in either package)
    plain_dir = str(tmp_path / "plain")
    res = sample_protein.main([
        "--ckpt_dir", os.path.join(gvp, "ckpt"), "--output_dir", plain_dir,
        "--num_samples", "2", "--batch_size", "2", "--no_conditioner",
        "--device", "cpu"] + TINY)
    with open(os.path.join(plain_dir, "summary.json")) as f:
        assert json.load(f) == {"num_samples": 2, "ckpt_step": 4,
                                "guidance_scale": None}
    pos, mask = res["pos"], res["mask"]
    com = (pos * mask[..., None]).sum(1) / mask.sum(1, keepdim=True)
    torch.testing.assert_close(com, torch.zeros(2, 3), rtol=0, atol=1e-5)


def test_train_loss_is_the_resdiff_loss(tmp_path):
    """build_model + make_loss_fn: the CLI's objective is resdiff_loss with
    its aux weight, cutoff and distogram mode."""
    from tpu_diffusion_torch.protein.resdiff import resdiff_loss
    from tpu_diffusion_torch.protein.sde import HoogeboomGraphSDE
    args = train_protein.parser().parse_args(TINY + ["--distogram",
                                                     "dense"])
    model = train_protein.build_model(args, "cpu")
    assert sum(p.numel() for p in model.parameters()) > 0
    diffuser = HoogeboomGraphSDE(num_steps=20)
    loss_fn = train_protein.make_loss_fn(diffuser, 0.5, 0.3, "dense")
    pos = torch.randn((2, 24, 3), generator=torch.Generator().manual_seed(0))
    mask = torch.arange(24)[None] < torch.tensor([[24], [13]])
    with torch.no_grad():
        got = loss_fn(model, torch.Generator().manual_seed(1),
                      {"pos": pos, "mask": mask})
        want, _ = resdiff_loss(torch.Generator().manual_seed(1), model,
                               diffuser, ProteinBatch.from_positions(
                                   pos, mask),
                               aux_weight=0.5, aux_cutoff=0.3,
                               distogram="dense")
    assert got == want


def test_clis_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_protein.main(["--output_dir", str(tmp_path), "--num_steps",
                            "1"] + TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        sample_protein.main(["--ckpt_dir", str(tmp_path / "c"),
                             "--output_dir", str(tmp_path / "s")] + TINY)


# --- the port's eval/plotting.py, under tests/test_plotting_debug.py's tests


def _rows(n=10, seed=0):
    rng = np.random.default_rng(seed)
    return [{"id": f"s{i}", "ca_distance_mean": float(rng.normal(3.8, 0.1)),
             "radius_of_gyration": float(rng.normal(12, 2)),
             "hull_volume": float(rng.normal(5000, 300))}
            for i in range(n)]


def _protein_rows(n=12, seed=0):
    rng = np.random.default_rng(seed)
    return [{"id": f"s{i}",
             "ca_distance_mean": float(rng.normal(3.8, 0.1)),
             "ca_angle_mean": float(rng.normal(90, 8)),
             "helix_proportion": float(rng.uniform(0.2, 0.5)),
             "sheet_proportion": float(rng.uniform(0.1, 0.3)),
             "coil_proportion": float(rng.uniform(0.3, 0.6)),
             "radius_of_gyration": float(rng.normal(12, 2)),
             "shpericality": float(rng.uniform(0.3, 0.8)),
             "exceeds_canvas": float(rng.integers(0, 2)),
             "novelty_tm_score": float(rng.uniform(0.2, 0.9))}
            for i in range(n)]


def test_plot_pipeline_writes_figures(tmp_path):
    pytest.importorskip("matplotlib")
    from tpu_diffusion_torch.eval.plotting import run_plot_pipeline
    paths = run_plot_pipeline(_rows(), str(tmp_path), train_rows=_rows(8, 1),
                              summary={"ca_distance_mean": 3.8,
                                       "radius_of_gyration": 12.0})
    assert set(paths) == {"distributions", "radar", "parallel"}
    for p in paths.values():
        assert os.path.getsize(p) > 1000


def test_protein_plot_pipeline_named_figures(tmp_path):
    pytest.importorskip("matplotlib")
    from tpu_diffusion_torch.eval.plotting import run_protein_plot_pipeline
    loss_dir = tmp_path / "cond_loss_samples"
    loss_dir.mkdir()
    rng = np.random.default_rng(3)
    for i in range(4):
        np.save(loss_dir / f"condloss_{i}.npy",
                np.abs(rng.normal(0.02, 0.01, size=125)).cumsum()[::-1])
    paths = run_protein_plot_pipeline(
        _protein_rows(), str(tmp_path / "plots"),
        train_rows=_protein_rows(15, 1), cond_rows=_protein_rows(8, 2),
        cond_loss_dir=str(loss_dir))
    assert set(paths) == {"backbone_dist_mean", "backbone_angle_mean",
                          "secondary_structure_usage", "radius_of_gyration",
                          "sphericity", "radar", "novelty_tm_score",
                          "cond_loss_mse", "cond_loss_rmsd"}
    for p in paths.values():
        assert os.path.getsize(p) > 1000


def test_ks_similarity_extremes():
    from tpu_diffusion_torch.eval.plotting import ks_similarity
    a = [{"x": float(v)} for v in np.linspace(0, 1, 50)]
    b = [{"x": float(v)} for v in np.linspace(10, 11, 50)]
    assert ks_similarity(a, a, "x") == pytest.approx(1.0, abs=0.05)
    assert ks_similarity(a, b, "x") == pytest.approx(0.0, abs=1e-9)


def test_structure_plot_and_gif(tmp_path):
    pytest.importorskip("matplotlib")
    from tpu_diffusion_torch.eval.plotting import (plot_structure,
                                                   trajectory_gif)
    rng = np.random.default_rng(0)
    coords = rng.normal(size=(30, 3)).cumsum(0)
    assert plot_structure(coords, "test") is not None
    traj = np.stack([coords * (1 - k / 5) + rng.normal(size=(30, 3))
                     * (k / 5) for k in range(5)])
    gif = trajectory_gif(traj, str(tmp_path / "t.gif"), fps=2)
    assert os.path.getsize(gif) > 1000


def test_sample_protein_save_plots(tmp_path):
    pytest.importorskip("matplotlib")
    out = str(tmp_path / "protein")
    train_protein.main(["--output_dir", out, "--num_steps", "1",
                        "--batch_size", "4", "--device", "cpu"] + TINY)
    sample_dir = str(tmp_path / "samples")
    sample_protein.main([
        "--ckpt_dir", os.path.join(out, "gvp", "ckpt"), "--output_dir",
        sample_dir, "--num_samples", "2", "--batch_size", "2",
        "--save_plots", "--device", "cpu"] + TINY)
    for name in ("trajectory_0.gif", "sample_0000.png", "sample_0001.png"):
        assert os.path.getsize(os.path.join(sample_dir, name)) > 1000


def test_protein_plot_cli_reads_csvs(tmp_path):
    pytest.importorskip("matplotlib")
    import csv

    from tpu_diffusion_torch.eval.plotting import _protein_plot_main
    rows = _protein_rows()
    path = tmp_path / "samples.csv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    _protein_plot_main(["--sample_csv", str(path), "--plot_dir",
                        str(tmp_path / "plots")])
    assert os.listdir(tmp_path / "plots")
