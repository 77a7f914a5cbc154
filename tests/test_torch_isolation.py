"""The port and chip_smoke.py import nothing of JAX, flax, the JAX package or
its dependencies that the card machine does not have (ml_collections, optax,
orbax)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_diffusion", "ml_collections",
             "optax", "orbax"}
FILES = sorted((ROOT / "tpu_diffusion_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_has_modules():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for module in ("core/schedules.py", "kernels/build.py",
                   "kernels/attention.py", "kernels/groupnorm.py",
                   "models/nn.py", "models/unet.py",
                   "sampling/ancestral.py", "convert.py", "__init__.py",
                   "conditioning/likelihoods.py", "conditioning/guidance.py",
                   "losses/ddpm.py", "eval/metrics.py", "utils/config.py",
                   "data/registry.py", "cli/main.py", "kernels/resblock.py",
                   "models/unet_infer.py", "core/ema.py", "train/trainer.py",
                   "train/actions.py", "train/writers.py",
                   "train/checkpoint.py", "eval/fid.py", "eval/lpips.py",
                   "eval/inception.py", "losses/cfm.py", "sampling/ode.py",
                   "cli/train_cifar10.py", "cli/compute_fid.py",
                   "protein/geometry.py", "protein/sde.py",
                   "protein/gvp.py", "protein/denoiser.py",
                   "protein/resdiff.py", "protein/conditioner.py",
                   "protein/data.py", "protein/pdb.py",
                   "data/device_cache.py", "eval/plotting.py",
                   "cli/train_protein.py", "cli/sample_protein.py",
                   "protein/sync_probe.py", "protein/mpnn.py",
                   "protein/self_consistency.py", "protein/novelty.py",
                   "protein/evaluate.py", "protein/so3.py", "protein/se3.py",
                   "protein/transforms.py", "data/storage.py",
                   "data/minilmdb.py", "eval/f1max.py", "utils/debug.py",
                   "utils/logging.py", "parallel/mesh.py",
                   "parallel/distributed.py", "parallel/tp.py",
                   "parallel/sp.py", "parallel/dryrun.py"):
        assert f"tpu_diffusion_torch/{module}" in names
    assert (ROOT / "tpu_diffusion_torch" / "native" / "novelty.cpp").exists()


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT)
                         .as_posix())
def test_no_jax_imports(path):
    # exact roots: `tpu_diffusion_torch` is allowed, `tpu_diffusion` is not
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, tpu_diffusion_torch, tpu_diffusion_torch.kernels."
            "build, tpu_diffusion_torch.cli.main, tpu_diffusion_torch.models."
            "unet_infer, tpu_diffusion_torch.train.trainer, "
            "tpu_diffusion_torch.cli.compute_fid, "
            "tpu_diffusion_torch.eval.inception, "
            "tpu_diffusion_torch.cli.train_protein, "
            "tpu_diffusion_torch.cli.sample_protein, "
            "tpu_diffusion_torch.data.device_cache, "
            "tpu_diffusion_torch.eval.plotting, "
            "tpu_diffusion_torch.protein.evaluate, "
            "tpu_diffusion_torch.protein.mpnn, "
            "tpu_diffusion_torch.protein.se3, "
            "tpu_diffusion_torch.data.storage, "
            "tpu_diffusion_torch.eval.f1max, "
            "tpu_diffusion_torch.utils.debug, "
            "tpu_diffusion_torch.parallel.dryrun\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r})\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_evaluation_imports_leave_torch_unloaded():
    """The package root loads its names on first use, so the evaluation
    modules a spawned `eval_many` worker unpickles from load numpy only."""
    code = ("import sys, tpu_diffusion_torch.protein.evaluate, "
            "tpu_diffusion_torch.protein.novelty\n"
            "assert 'torch' not in sys.modules, sorted(sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_every_root_name_resolves():
    import tpu_diffusion_torch as root
    from tpu_diffusion_torch.core.schedules import DDPM
    assert root.DDPM is DDPM
    for name in root.__all__:
        assert getattr(root, name) is not None, name
    assert set(root.__all__) <= set(dir(root))
    with pytest.raises(AttributeError):
        root.not_a_name
