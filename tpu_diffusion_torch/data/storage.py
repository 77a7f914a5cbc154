"""Generic storage-backed datasets.

The port's own copy of `tpu_diffusion/data/storage.py` (numpy only).

Rebuilds `amortised diffusion/src/utils/{lmdb_dataset,disk_datasets,
memory_datasets}.py`: keyed datasets over LMDB (when the lmdb module is
present — gated, it is absent in this environment), plain directories, tar
and zip archives, and in-memory pandas/dict stores, with pluggable
pickle / dill / msgpack / numpy serialization and an optional transform
applied on read (the reference's `transform=` convention).
"""

from __future__ import annotations

import io
import os
import pickle
import tarfile
import zipfile
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

Transform = Optional[Callable[[Any], Any]]


# ---------------------------------------------------------------------------
# Serializers (lmdb_dataset.py's pkl/dill/msgpack choices + npy)
# ---------------------------------------------------------------------------


class Serializer:
    name = "base"

    def dumps(self, obj) -> bytes:
        raise NotImplementedError

    def loads(self, data: bytes):
        raise NotImplementedError


class PickleSerializer(Serializer):
    name = "pkl"

    def dumps(self, obj) -> bytes:
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)

    def loads(self, data: bytes):
        return pickle.loads(data)


class DillSerializer(Serializer):
    name = "dill"

    def dumps(self, obj) -> bytes:
        import dill
        return dill.dumps(obj)

    def loads(self, data: bytes):
        import dill
        return dill.loads(data)


class MsgpackSerializer(Serializer):
    name = "msgpack"

    def dumps(self, obj) -> bytes:
        import msgpack
        return msgpack.packb(obj, use_bin_type=True)

    def loads(self, data: bytes):
        import msgpack
        return msgpack.unpackb(data, raw=False)


class NpySerializer(Serializer):
    name = "npy"

    def dumps(self, obj) -> bytes:
        buf = io.BytesIO()
        np.save(buf, np.asarray(obj), allow_pickle=False)
        return buf.getvalue()

    def loads(self, data: bytes):
        return np.load(io.BytesIO(data), allow_pickle=False)


SERIALIZERS = {s.name: s for s in (PickleSerializer(), DillSerializer(),
                                   MsgpackSerializer(), NpySerializer())}


def get_serializer(name: str) -> Serializer:
    if name not in SERIALIZERS:
        raise NotImplementedError(
            f"Unknown serializer {name!r}; choose {sorted(SERIALIZERS)}")
    return SERIALIZERS[name]


# ---------------------------------------------------------------------------
# Keyed dataset base
# ---------------------------------------------------------------------------


class KeyedDataset:
    """len / [i] / keys() protocol shared by all storage backends."""

    def __init__(self, transform: Transform = None):
        self.transform = transform

    def keys(self) -> Sequence[str]:
        raise NotImplementedError

    def get(self, key: str):
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.keys())

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            idx = self.keys()[idx]
        item = self.get(idx)
        return self.transform(item) if self.transform else item

    def __iter__(self) -> Iterable:
        for k in self.keys():
            yield self[k]


class LMDBDataset(KeyedDataset):
    """LMDB-backed dataset (lmdb_dataset.py:38-625).

    Uses the `lmdb` C module when installed; otherwise falls back to the
    pure-Python `tpu_diffusion_torch.data.minilmdb` parser of the standard LMDB
    on-disk format (read-only snapshot semantics — enough for the
    reference's keyed-blob dataset usage). `write` mirrors the choice."""

    def __init__(self, path: str, serializer: str = "pkl",
                 transform: Transform = None, readonly: bool = True,
                 map_size: int = 2**34):
        super().__init__(transform)
        self._ser = get_serializer(serializer)
        try:
            import lmdb
        except ImportError:
            lmdb = None
        if lmdb is not None:
            self._env = lmdb.open(path, readonly=readonly,
                                  lock=not readonly, map_size=map_size)
            with self._env.begin() as txn:
                self._keys = [k.decode() for k, _ in txn.cursor()]
        else:
            from tpu_diffusion_torch.data.minilmdb import MiniLMDB
            self._env = None
            self._mini = MiniLMDB(path)
            self._keys = [k.decode() for k in self._mini.keys()]

    def keys(self):
        return self._keys

    def get(self, key: str):
        if self._env is not None:
            with self._env.begin() as txn:
                blob = txn.get(key.encode())
        else:
            blob = self._mini.get(key.encode())
        if blob is None:  # both backends return None for absent keys
            raise KeyError(key)
        return self._ser.loads(blob)

    @classmethod
    def write(cls, path: str, items: Dict[str, Any],
              serializer: str = "pkl", map_size: int = 2**34):
        ser = get_serializer(serializer)
        blobs = {k.encode(): ser.dumps(v) for k, v in items.items()}
        try:
            import lmdb
        except ImportError:
            from tpu_diffusion_torch.data.minilmdb import write_minilmdb
            os.makedirs(path, exist_ok=True)
            write_minilmdb(os.path.join(path, "data.mdb"), blobs)
            return
        env = lmdb.open(path, map_size=map_size)
        with env.begin(write=True) as txn:
            for k, v in blobs.items():
                txn.put(k, v)
        env.close()


class FileDataset(KeyedDataset):
    """One file per item under a directory (disk_datasets.py:18-100)."""

    def __init__(self, root: str, serializer: str = "npy",
                 suffix: str = "", transform: Transform = None):
        super().__init__(transform)
        self.root = root
        self._ser = get_serializer(serializer)
        self.suffix = suffix or f".{self._ser.name}"
        self._keys = sorted(
            f[: -len(self.suffix)] for f in os.listdir(root)
            if f.endswith(self.suffix))

    def keys(self):
        return self._keys

    def get(self, key: str):
        with open(os.path.join(self.root, key + self.suffix), "rb") as f:
            return self._ser.loads(f.read())

    @classmethod
    def write(cls, root: str, items: Dict[str, Any],
              serializer: str = "npy"):
        os.makedirs(root, exist_ok=True)
        ser = get_serializer(serializer)
        for k, v in items.items():
            with open(os.path.join(root, f"{k}.{ser.name}"), "wb") as f:
                f.write(ser.dumps(v))


class TarDataset(KeyedDataset):
    """Items inside a .tar archive (disk_datasets.py tar variant)."""

    def __init__(self, path: str, serializer: str = "npy",
                 transform: Transform = None):
        super().__init__(transform)
        self._ser = get_serializer(serializer)
        self._tar = tarfile.open(path, "r")
        self._members = {m.name: m for m in self._tar.getmembers()
                         if m.isfile()}
        self._keys = sorted(self._members)

    def keys(self):
        return self._keys

    def get(self, key: str):
        f = self._tar.extractfile(self._members[key])
        return self._ser.loads(f.read())


class ZipDataset(KeyedDataset):
    """Items inside a .zip archive (disk_datasets.py zip variant)."""

    def __init__(self, path: str, serializer: str = "npy",
                 transform: Transform = None):
        super().__init__(transform)
        self._ser = get_serializer(serializer)
        self._zip = zipfile.ZipFile(path, "r")
        self._keys = sorted(n for n in self._zip.namelist()
                            if not n.endswith("/"))

    def keys(self):
        return self._keys

    def get(self, key: str):
        return self._ser.loads(self._zip.read(key))


class DictDataset(KeyedDataset):
    """In-memory dict store (memory_datasets.py)."""

    def __init__(self, items: Dict[str, Any], transform: Transform = None):
        super().__init__(transform)
        self._items = items
        self._keys = sorted(items)

    def keys(self):
        return self._keys

    def get(self, key: str):
        return self._items[key]


class DataFrameDataset(KeyedDataset):
    """Rows of a pandas DataFrame as dict items (memory_datasets.py)."""

    def __init__(self, df, index_col: Optional[str] = None,
                 transform: Transform = None):
        super().__init__(transform)
        self._df = df.set_index(index_col) if index_col else df
        self._keys = [str(k) for k in self._df.index]

    def keys(self):
        return self._keys

    def get(self, key: str):
        row = self._df.loc[type(self._df.index[0])(key)]
        return row.to_dict()


class KeepFields:
    """Transform keeping only the listed fields of a dict item
    (src/transforms/pandas_transforms.py)."""

    def __init__(self, fields: List[str]):
        self.fields = fields

    def __call__(self, item: Dict) -> Dict:
        return {k: item[k] for k in self.fields if k in item}
