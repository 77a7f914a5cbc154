"""What the benchmark's sources import, by an AST walk: no top-level name
of the JAX stack or the JAX package, compared whole (the system's package,
whose name begins with the JAX package's, passes); outside `reference/`
only the standard library, torch, numpy, the benchmark and the system;
inside it nothing of the system."""

import ast
import sys

import pytest

from benchmark.harness import BANNED, ROOT

SOURCES = sorted(p for p in (ROOT / "benchmark").rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


def test_whole_name_comparison():
    assert "tpu_diffusion_torch" not in BANNED
    assert "tpu_diffusion_torch".split(".")[0] != "tpu_diffusion"


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_imports(path):
    names = set(top_names(path))
    assert not names & BANNED
    allowed = set(sys.stdlib_module_names) | {"torch", "numpy", "pytest",
                                              "benchmark"}
    if "reference" not in path.relative_to(ROOT).parts:
        allowed.add("tpu_diffusion_torch")
    assert names <= allowed, names - allowed
