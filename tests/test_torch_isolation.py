"""The port and chip_smoke.py import nothing of JAX, flax or the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_diffusion"}
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
                   "sampling/ancestral.py", "convert.py", "__init__.py"):
        assert f"tpu_diffusion_torch/{module}" in names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT)
                         .as_posix())
def test_no_jax_imports(path):
    # exact roots: `tpu_diffusion_torch` is allowed, `tpu_diffusion` is not
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, tpu_diffusion_torch, tpu_diffusion_torch.kernels."
            "build\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r})\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
