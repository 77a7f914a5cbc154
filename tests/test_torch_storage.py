"""The port's storage layer, F1Max, debug utilities and logging against the
JAX package.

The storage modules are copies (numpy and the standard library): each
dataset class reads what the JAX package's writers wrote and the reverse,
and the two LMDB writers write the same bytes. `f1_max` is held to the JAX
one to 1e-6 on scores at least 1e-3 away from every threshold k/100: the
two packages' fp32 `linspace` may differ in a threshold's last bit, which
would move a score lying on it.
"""

import io
import logging
import os
import pickle
import tarfile
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.data import minilmdb as jax_minilmdb
from tpu_diffusion.data import storage as jax_storage
from tpu_diffusion.eval import f1max as jax_f1max
from tpu_diffusion.utils import debug as jax_debug
from tpu_diffusion.utils import logging as jax_logging
from tpu_diffusion_torch.data import minilmdb, storage
from tpu_diffusion_torch.eval import f1max
from tpu_diffusion_torch.utils import debug
from tpu_diffusion_torch.utils import logging as port_logging

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "lmdb")


def items(n=40):
    rng = np.random.default_rng(0)
    out = {f"key_{i:03d}": {"coords": rng.normal(size=(i % 7 + 1, 3)),
                            "name": f"p{i}"} for i in range(n)}
    out["key_big"] = {"coords": rng.normal(size=(600, 3)), "name": "big"}
    return out


def same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", ["pkl", "dill", "msgpack", "npy"])
def test_serializers_match_jax(name):
    obj = np.arange(12.0).reshape(3, 4) if name == "npy" else \
        {"a": 1, "b": [1.5, 2.5], "c": "x"}
    port, ref = storage.get_serializer(name), jax_storage.get_serializer(name)
    assert port.dumps(obj) == ref.dumps(obj)
    np.testing.assert_equal(port.loads(ref.dumps(obj)), obj)
    with pytest.raises(NotImplementedError):
        storage.get_serializer("yaml")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lmdb_dataset_reads_the_other_packages_file(tmp_path, writer):
    data = items()
    path = str(tmp_path / "db")
    (jax_storage if writer == "jax" else storage).LMDBDataset.write(
        path, data)
    reader = (storage if writer == "jax" else jax_storage).LMDBDataset(path)
    assert reader.keys() == sorted(data)
    for k in data:
        assert reader[k]["name"] == data[k]["name"]
        np.testing.assert_array_equal(reader[k]["coords"],
                                      data[k]["coords"])
    with pytest.raises(KeyError):
        storage.LMDBDataset(path).get("absent")


def test_minilmdb_writers_agree_bytewise(tmp_path):
    blobs = {k.encode(): pickle.dumps(v) for k, v in items(120).items()}
    a = minilmdb.write_minilmdb(str(tmp_path / "a.mdb"), blobs)
    b = jax_minilmdb.write_minilmdb(str(tmp_path / "b.mdb"), blobs)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    db = minilmdb.MiniLMDB(a)
    assert db.main_depth == 2 and db.keys() == sorted(blobs)
    assert all(db.get(k) == v for k, v in blobs.items())
    assert db.get(b"absent") is None
    (tmp_path / "junk.mdb").write_bytes(b"\0" * 9000)
    with pytest.raises(minilmdb.MiniLMDBError):
        minilmdb.MiniLMDB(str(tmp_path / "junk.mdb"))


def test_checked_in_fixture_reads_as_in_jax():
    port = storage.LMDBDataset(FIXTURE, serializer="pkl")
    ref = jax_storage.LMDBDataset(FIXTURE, serializer="pkl")
    assert port.keys() == ref.keys() == ["protein_000", "protein_001",
                                         "protein_002"]
    for got, want in zip(port, ref):
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(got["coords"], want["coords"])
        np.testing.assert_allclose(got["coords"].sum(), got["checksum"])


def test_file_dataset_reads_jax_files(tmp_path):
    data = {"a": np.ones((2, 3)), "b": np.arange(4.0)}
    jax_storage.FileDataset.write(str(tmp_path / "fs"), data)
    ds = storage.FileDataset(str(tmp_path / "fs"),
                             transform=lambda x: x * 2)
    assert ds.keys() == ["a", "b"] and len(ds) == 2
    np.testing.assert_array_equal(ds[1], data["b"] * 2)
    storage.FileDataset.write(str(tmp_path / "fs2"), data)
    same({k: jax_storage.FileDataset(str(tmp_path / "fs2"))[k] for k in data},
         data)


def test_tar_and_zip_datasets_match_jax(tmp_path):
    s = storage.get_serializer("npy")
    data = {"x.npy": np.arange(5.0), "y.npy": np.eye(2)}
    with tarfile.open(tmp_path / "d.tar", "w") as tfile:
        for k, v in data.items():
            raw = s.dumps(v)
            info = tarfile.TarInfo(k)
            info.size = len(raw)
            tfile.addfile(info, io.BytesIO(raw))
    with zipfile.ZipFile(tmp_path / "d.zip", "w") as zfile:
        for k, v in data.items():
            zfile.writestr(k, s.dumps(v))
    for cls in ("TarDataset", "ZipDataset"):
        path = str(tmp_path / ("d.tar" if cls == "TarDataset" else "d.zip"))
        port = getattr(storage, cls)(path)
        ref = getattr(jax_storage, cls)(path)
        assert port.keys() == ref.keys() == sorted(data)
        same({k: port[k] for k in data}, {k: ref[k] for k in data})


def test_memory_datasets_match_jax():
    import pandas as pd
    data = {"k2": {"a": 1, "b": 2}, "k1": {"a": 3, "b": 4}}
    port = storage.DictDataset(data, transform=storage.KeepFields(["a"]))
    ref = jax_storage.DictDataset(data,
                                  transform=jax_storage.KeepFields(["a"]))
    assert list(port) == list(ref) == [{"a": 3}, {"a": 1}]
    df = pd.DataFrame({"id": [10, 20], "v": [0.5, 1.5]})
    port = storage.DataFrameDataset(df, index_col="id")
    ref = jax_storage.DataFrameDataset(df, index_col="id")
    assert port.keys() == ref.keys() == ["10", "20"]
    assert port["20"] == ref["20"] == {"v": 1.5}


def clear_of_thresholds(x, gap=1e-3):
    """Scores at least `gap` away from every threshold k/100."""
    grid = np.round(x * 100) / 100
    return np.where(np.abs(x - grid) < gap, grid + 2 * gap, x)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f1max_matches_jax(seed):
    rng = np.random.default_rng(seed)
    targets = (rng.uniform(size=(24, 7)) < 0.3).astype(np.float32)
    preds = clear_of_thresholds(np.clip(
        0.6 * targets + rng.uniform(0, 0.6, targets.shape), 0, 0.995)) \
        .astype(np.float32)
    want = float(jax_f1max.f1_max(jnp.asarray(preds), jnp.asarray(targets)))
    got = f1max.f1_max(torch.from_numpy(preds), torch.from_numpy(targets))
    assert got.item() == pytest.approx(want, abs=1e-6)
    m = f1max.F1Max()
    m.update(preds[:10], targets[:10])
    m.update(preds[10:], targets[10:])
    assert m.compute() == pytest.approx(want, abs=1e-6)
    # perfect scores: 1 when every row has a target, as in the JAX test
    perfect = targets.copy()
    perfect[np.arange(24), np.arange(24) % 7] = 1
    assert f1max.f1_max(torch.from_numpy(perfect),
                        torch.from_numpy(perfect)).item() == \
        pytest.approx(1.0, abs=1e-6)


def test_debug_counterparts(tmp_path):
    with debug.trace("step"):
        _ = torch.ones(4) + 1
    with debug.profile(str(tmp_path / "prof")):
        with debug.trace("step"):
            _ = torch.ones(8) @ torch.ones(8)
    trace = (tmp_path / "prof" / "trace.json").read_text()
    assert '"step"' in trace
    a = torch.zeros(64, 64)
    assert debug.compiled_cost(lambda x, y: x @ y, a, a)["flops"] == \
        2 * 64 ** 3
    assert jax_debug.compiled_cost(lambda x, y: x @ y, jnp.zeros((64, 64)),
                                   jnp.zeros((64, 64)))["flops"] >= \
        0.9 * 2 * 64 ** 3
    with pytest.raises(FloatingPointError):
        debug.checkify_sampler(lambda x: x / torch.zeros_like(x))(
            torch.ones(3))
    out = debug.checkify_sampler(lambda x: (x * 2, x))(torch.ones(3))
    assert torch.equal(out[0], torch.full((3,), 2.0))
    debug.enable_debug_nans(True)
    try:
        assert torch.is_anomaly_enabled()
        assert torch.is_anomaly_check_nan_enabled()
    finally:
        debug.enable_debug_nans(False)
    assert not torch.is_anomaly_enabled()


def test_strip_checkpoint_keys_matches_jax():
    assets = {"params": {"w": 1, "schedule": {"betas": 2},
                         "schedule_v2": 5}, "schedule": 3, "step": 4,
              "opt": {"mu": {"w": 6}}}
    for prefixes in (["schedule"], ["params/schedule"], ["opt/mu", "step"]):
        assert debug.strip_checkpoint_keys(assets, prefixes) == \
            jax_debug.strip_checkpoint_keys(assets, prefixes)


def test_logging_matches_jax(tmp_path):
    loggers = {}
    for name, mod in (("jax_log", jax_logging), ("port_log", port_logging)):
        for _ in range(2):   # idempotent: no duplicated handlers
            loggers[name] = mod.setup_logging(name, str(tmp_path / name),
                                              level=logging.DEBUG)
        loggers[name].debug("hello")
        for h in loggers[name].handlers:
            h.flush()
    port, ref = loggers["port_log"], loggers["jax_log"]
    assert [type(h) for h in port.handlers] == \
        [type(h) for h in ref.handlers]
    assert port.level == ref.level and not port.propagate
    assert "hello" in (tmp_path / "port_log" / "port_log.log").read_text()
    for lg in loggers.values():
        for h in lg.handlers:
            h.close()
        lg.handlers.clear()
