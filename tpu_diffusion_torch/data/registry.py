"""Dataset registry, in numpy (the port's own copy).

Counterpart of `tpu_diffusion/data/registry.py`, which the port copies
rather than imports: each dataset loads from local raw files when present
under `root` and otherwise falls back to a deterministic synthetic dataset
with the same shapes and value range (the same splits as the JAX package's).
PIL is imported only by the loaders of image folders, and only when it is
installed. Images are NHWC float32 in [-1, 1], labels int32.
"""

from __future__ import annotations

import gzip
import os
import struct as pystruct
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

_DATASETS: Dict[str, Callable] = {}


def register_dataset(name: str):
    def deco(fn):
        _DATASETS[name] = fn
        return fn
    return deco


def get_dataset(name: str) -> Callable:
    if name not in _DATASETS:
        raise NotImplementedError(
            f"Unknown dataset {name!r}; registered: {sorted(_DATASETS)}")
    return _DATASETS[name]


@dataclass
class ArrayDataset:
    """Whole-dataset-in-host-RAM container (these datasets are <200 MB)."""

    images: np.ndarray  # [N, H, W, C] float32 in [-1, 1]
    labels: np.ndarray  # [N] int32
    name: str = ""
    synthetic: bool = False

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx):
        return self.images[idx], self.labels[idx]

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self.images.shape[1:]


# ---------------------------------------------------------------------------
# Synthetic procedural images (deterministic, structured enough to train on)
# ---------------------------------------------------------------------------


def synthetic_images(n: int, h: int, w: int, c: int, num_classes: int,
                     seed: int) -> ArrayDataset:
    """Class-dependent Gaussian blobs + sinusoidal textures in [-1, 1].

    Each class k places a blob at a class-specific position with a
    class-specific spatial frequency, so conditional models have real signal
    to learn and FID-style statistics are non-degenerate.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    images = np.empty((n, h, w, c), np.float32)
    for k in range(num_classes):
        idx = np.where(labels == k)[0]
        if idx.size == 0:
            continue
        ang = 2 * np.pi * k / num_classes
        cy, cx = (h / 2 + h / 4 * np.sin(ang)), (w / 2 + w / 4 * np.cos(ang))
        jit = rng.normal(0, h * 0.05, size=(idx.size, 2)).astype(np.float32)
        freq = 1.0 + k * 0.5
        for j, i0 in enumerate(idx):
            blob = np.exp(-(((yy - cy - jit[j, 0]) ** 2
                             + (xx - cx - jit[j, 1]) ** 2)
                            / (2 * (h / 6) ** 2)))
            tex = 0.3 * np.sin(freq * 2 * np.pi * xx / w
                               + rng.uniform(0, 2 * np.pi))
            img = 2.0 * np.clip(blob + 0.2 * tex + 0.1
                                * rng.normal(size=(h, w)), 0, 1) - 1.0
            images[i0] = img[..., None].repeat(c, axis=-1) if c > 1 \
                else img[..., None]
    return ArrayDataset(images, labels, synthetic=True)


# ---------------------------------------------------------------------------
# Raw-file loaders
# ---------------------------------------------------------------------------


def _load_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = pystruct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = pystruct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


def _find(root: str, names) -> Optional[str]:
    for name in names:
        for cand in (os.path.join(root, name),
                     os.path.join(root, "MNIST", "raw", name)):
            if os.path.exists(cand):
                return cand
    return None


@register_dataset("mnist")
def mnist(root: str = "data", train: bool = True,
          allow_synthetic: bool = True) -> ArrayDataset:
    """MNIST 28x28x1, Normalize(0.5, 0.5) -> [-1, 1] (data.py:41-49)."""
    prefix = "train" if train else "t10k"
    img_path = _find(root, [f"{prefix}-images-idx3-ubyte",
                            f"{prefix}-images-idx3-ubyte.gz"])
    lbl_path = _find(root, [f"{prefix}-labels-idx1-ubyte",
                            f"{prefix}-labels-idx1-ubyte.gz"])
    if img_path and lbl_path:
        imgs = _load_idx(img_path).astype(np.float32) / 255.0
        imgs = (imgs * 2.0 - 1.0)[..., None]
        labels = _load_idx(lbl_path).astype(np.int32)
        return ArrayDataset(imgs, labels, name="mnist")
    if not allow_synthetic:
        raise FileNotFoundError(f"MNIST raw files not found under {root}")
    return synthetic_images(8192 if train else 1024, 28, 28, 1, 10,
                            seed=0 if train else 1)


@register_dataset("cifar10")
def cifar10(root: str = "data", train: bool = True,
            allow_synthetic: bool = True) -> ArrayDataset:
    """CIFAR-10 32x32x3 in [-1, 1] (train_cifar10.py:69-87)."""
    base = None
    for cand in (os.path.join(root, "cifar-10-batches-bin"), root):
        if os.path.exists(os.path.join(cand, "data_batch_1.bin")):
            base = cand
            break
    if base:
        files = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
                 else ["test_batch.bin"])
        xs, ys = [], []
        for fn in files:
            raw = np.fromfile(os.path.join(base, fn), np.uint8)
            raw = raw.reshape(-1, 3073)
            ys.append(raw[:, 0].astype(np.int32))
            xs.append(raw[:, 1:].reshape(-1, 3, 32, 32)
                      .transpose(0, 2, 3, 1))
        imgs = np.concatenate(xs).astype(np.float32) / 255.0 * 2.0 - 1.0
        return ArrayDataset(imgs, np.concatenate(ys), name="cifar10")
    if not allow_synthetic:
        raise FileNotFoundError(f"CIFAR-10 binaries not found under {root}")
    return synthetic_images(8192 if train else 1024, 32, 32, 3, 10,
                            seed=2 if train else 3)


def _image_folder(root: str, size: int) -> Optional[np.ndarray]:
    """Load a directory of images, center-crop + resize to size x size."""
    try:
        from PIL import Image
    except ImportError:
        return None
    if not os.path.isdir(root):
        return None
    paths = [os.path.join(root, f) for f in sorted(os.listdir(root))
             if f.lower().endswith((".jpg", ".jpeg", ".png"))]
    if not paths:
        return None
    out = np.empty((len(paths), size, size, 3), np.float32)
    for i, p in enumerate(paths):
        im = Image.open(p).convert("RGB")
        s = min(im.size)
        left, top = (im.width - s) // 2, (im.height - s) // 2
        im = im.crop((left, top, left + s, top + s)).resize(
            (size, size), Image.BILINEAR)
        out[i] = np.asarray(im, np.float32) / 255.0 * 2.0 - 1.0
    return out


@register_dataset("flowers")
def flowers(root: str = "data", train: bool = True,
            allow_synthetic: bool = True) -> ArrayDataset:
    """Flowers102 center-crop -> 64x64 bilinear (data.py:60-74)."""
    imgs = _image_folder(os.path.join(root, "flowers-102", "jpg"), 64)
    if imgs is not None:
        n = len(imgs)
        cut = int(n * 0.9)
        sel = slice(0, cut) if train else slice(cut, n)
        return ArrayDataset(imgs[sel], np.zeros(len(imgs[sel]), np.int32),
                            name="flowers")
    if not allow_synthetic:
        raise FileNotFoundError(f"Flowers images not found under {root}")
    return synthetic_images(4096 if train else 512, 64, 64, 3, 102,
                            seed=4 if train else 5)


@register_dataset("celeba")
def celeba(root: str = "data", train: bool = True,
           allow_synthetic: bool = True) -> ArrayDataset:
    """CelebA DDIM crop (89, 121) -> 64x64 (data.py:77-97)."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    folder = os.path.join(root, "celeba", "img_align_celeba")
    if Image is not None and os.path.isdir(folder):
        paths = [os.path.join(folder, f) for f in sorted(os.listdir(folder))
                 if f.lower().endswith((".jpg", ".png"))]
        out = np.empty((len(paths), 64, 64, 3), np.float32)
        for i, p in enumerate(paths):
            im = Image.open(p).convert("RGB")
            # DDIM crop: cx=89, cy=121 on the 178x218 aligned images
            im = im.crop((89 - 64, 121 - 64, 89 + 64, 121 + 64)).resize(
                (64, 64), Image.BILINEAR)
            out[i] = np.asarray(im, np.float32) / 255.0 * 2.0 - 1.0
        n = len(out)
        cut = int(n * 0.9)
        sel = slice(0, cut) if train else slice(cut, n)
        return ArrayDataset(out[sel], np.zeros(len(out[sel]), np.int32),
                            name="celeba")
    if not allow_synthetic:
        raise FileNotFoundError(f"CelebA images not found under {root}")
    return synthetic_images(4096 if train else 512, 64, 64, 3, 16,
                            seed=6 if train else 7)


# ---------------------------------------------------------------------------
# Batch iteration (replaces `infiniteloop`, cifar10/utils_cifar.py:56-59)
# ---------------------------------------------------------------------------


def infinite_batches(ds: ArrayDataset, batch_size: int, seed: int = 0,
                     flip: bool = False) -> Iterator[np.ndarray]:
    """Shuffled epochs forever; optional random horizontal flip."""
    rng = np.random.default_rng(seed)
    n = len(ds)
    if batch_size > n:
        raise ValueError(
            f"batch_size={batch_size} exceeds dataset size {n} — the "
            f"epoch loop would yield nothing and spin forever")
    while True:
        perm = rng.permutation(n)
        for s in range(0, n - batch_size + 1, batch_size):
            batch = ds.images[perm[s:s + batch_size]]
            if flip:
                do = rng.random(batch_size) < 0.5
                batch = batch.copy()
                batch[do] = batch[do, :, ::-1]
            yield batch


def epoch_batches(ds: ArrayDataset, batch_size: int,
                  drop_last: bool = True) -> Iterator[np.ndarray]:
    n = len(ds)
    end = n - batch_size + 1 if drop_last else n
    for s in range(0, end, batch_size):
        yield ds.images[s:s + batch_size]


@register_dataset("synthetic256")
def synthetic256(root: str = "data", train: bool = True,
                 allow_synthetic: bool = True) -> ArrayDataset:
    """256x256x3 synthetic dataset for the 4x SR stretch config
    (BASELINE.json configs[4]); loads an image folder under
    `root/images256` when present."""
    imgs = _image_folder(os.path.join(root, "images256"), 256)
    if imgs is not None:
        n = len(imgs)
        cut = int(n * 0.9)
        sel = slice(0, cut) if train else slice(cut, n)
        return ArrayDataset(imgs[sel], np.zeros(len(imgs[sel]), np.int32),
                            name="synthetic256")
    return synthetic_images(256 if train else 64, 256, 256, 3, 8,
                            seed=8 if train else 9)
