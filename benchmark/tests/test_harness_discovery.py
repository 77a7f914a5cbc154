"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as files and BENCHMARK.json entries only; the harness
finds them by name, and refuses a cell whose files are missing."""

import json
import shutil

import pytest

from benchmark import harness
from benchmark.harness import ROOT


@pytest.fixture
def copy(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    return tmp_path


def add(root, rel, obj):
    path = root / rel
    path.write_text(obj if isinstance(obj, str) else json.dumps(obj))


def test_cell_config_and_metric_added_as_files(copy):
    here = copy / "benchmark"
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    config = json.loads((here / "configs" / "cifar10-unet.json").read_text())
    config["name"] = "cifar10-unet-b"
    add(copy, "benchmark/configs/cifar10-unet-b.json", config)
    traffic = json.loads(
        (here / "traffic" / "ddim100-k1-b64.json").read_text())
    traffic["batch"] = 128
    add(copy, "benchmark/traffic/ddim100-k1-b128.json", traffic)
    add(copy, "benchmark/workloads/cifar10-b-ddim100-k1-b128.json",
        {"traced_units": 1, "checked_chains": 1,
         "limits": {"image_gap": 1.0}})
    add(copy, "benchmark/metrics/chains_per_s.py",
        "def read(run):\n    return len(run.units) / run.window_s\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cifar10-unet-b", "source": "x",
                             "file": "benchmark/configs/cifar10-unet-b.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "cifar10-b-ddim100-k1-b128",
                               "config": "cifar10-unet-b",
                               "traffic": "ddim100-k1-b128", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "cifar10-ddim100-k1" in m["workloads"]:
            m["workloads"].append("cifar10-b-ddim100-k1-b128")
    bench["per_layer"].append({"name": "chains_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "graphed chains",
                               "moves": "samples_per_s",
                               "workloads": ["cifar10-b-ddim100-k1-b128"]})
    add(copy, "BENCHMARK.json", bench)
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there changed

    cell = harness.load_cell("cifar10-b-ddim100-k1-b128", root=copy)
    assert cell.traffic["batch"] == 128
    assert cell.config["name"] == "cifar10-unet-b"
    assert "chains_per_s" in [m["name"] for m in cell.per_layer]
    assert harness.driver_class(cell.driver).__name__ == "Driver"
    run = harness.Run(setup_s=1.0, t_start=0.0, units=[(0.0, 2.0, 128)])
    assert harness.reader("chains_per_s", root=copy)(run) == 0.5
    # the cells that were there are found as before
    assert harness.load_cell("cifar10-ddim100-k3", root=copy).per_layer == \
        harness.load_cell("cifar10-ddim100-k3").per_layer


@pytest.mark.parametrize("missing", [
    "benchmark/traffic/ddim100-k3-b64.json",
    "benchmark/workloads/cifar10-ddim100-k3.json",
    "benchmark/configs/cifar10-unet.json",
    "benchmark/metrics/resblock_roofline.py",
    "benchmark/drivers/ddim_chain.py",
])
def test_a_missing_file_refuses_the_cell(copy, missing):
    (copy / missing).unlink()
    with pytest.raises(harness.CellError):
        harness.load_cell("cifar10-ddim100-k3", root=copy)


def test_an_unknown_cell_is_refused():
    with pytest.raises(harness.CellError):
        harness.load_cell("no-such-cell")
