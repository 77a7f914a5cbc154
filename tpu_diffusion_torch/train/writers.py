"""Metric writers: the port's own copy of `tpu_diffusion/train/writers.py`
(numpy only; the port imports nothing of the JAX package).

`MetricWriter` ABC with `log_hparams`,
`write_scalars`, `write_images`, `write_figures`, `flush`, `close`;
`LocalWriter` (CSV + config.yaml + PNG grids), `TensorBoardWriter`
(tensorboardX when available), `MultiWriter` fan-out. Writers auto-close at
exit (writers.py:82-94).
"""

from __future__ import annotations

import atexit
import os
from typing import Dict, List, Mapping

import numpy as np



def _to_uint8_grid(images: np.ndarray, nrow: int = 8, pad: int = 2
                   ) -> np.ndarray:
    """[N, H, W, C] in [-1, 1] -> one [H', W', C] uint8 grid image."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    ncol = int(np.ceil(n / nrow))
    grid = np.ones((ncol * (h + pad) + pad, nrow * (w + pad) + pad, c),
                   np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y:y + h, x:x + w] = images[i]
    return ((np.clip(grid, -1, 1) + 1) * 127.5).astype(np.uint8)


class MetricWriter:
    def __init__(self):
        # auto-close at exit (writers.py:82-94); atexit holds the only
        # extra reference — no global registry needed
        atexit.register(self.close)

    def log_hparams(self, hparams: Mapping): ...

    def write_scalars(self, step: int, scalars: Mapping[str, float]): ...

    def write_images(self, step: int, images: Mapping[str, np.ndarray]): ...

    def write_figures(self, step: int, figures: Mapping): ...

    def flush(self): ...

    def close(self):
        self.flush()


class MultiWriter(MetricWriter):
    """Fan-out to several writers (writers.py:136-164)."""

    def __init__(self, writers):
        super().__init__()
        self._writers = list(writers)

    def log_hparams(self, hparams):
        for w in self._writers:
            w.log_hparams(hparams)

    def write_scalars(self, step, scalars):
        for w in self._writers:
            w.write_scalars(step, scalars)

    def write_images(self, step, images):
        for w in self._writers:
            w.write_images(step, images)

    def write_figures(self, step, figures):
        for w in self._writers:
            w.write_figures(step, figures)

    def flush(self):
        for w in self._writers:
            w.flush()


class LocalWriter(MetricWriter):
    """CSV metrics + config.yaml + PNG sample grids under `logdir`
    (writers.py:291-368)."""

    def __init__(self, logdir: str, flush_every_n: int = 100):
        super().__init__()
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        os.makedirs(os.path.join(logdir, "images"), exist_ok=True)
        self._rows: List[Dict] = []
        self._flush_every_n = flush_every_n
        self._csv_path = os.path.join(logdir, "metrics.csv")
        self._columns: List[str] = ["step"]
        self._written_columns: List[str] = []  # header already on disk

    def log_hparams(self, hparams):
        try:
            import yaml
        except ImportError:  # no PyYAML: the same content as config.json
            import json
            with open(os.path.join(self.logdir, "config.json"), "w") as f:
                json.dump(_plain(hparams), f, indent=2)
            return
        with open(os.path.join(self.logdir, "config.yaml"), "w") as f:
            yaml.safe_dump(_plain(hparams), f)

    def write_scalars(self, step, scalars):
        row = {"step": int(step)}
        row.update({k: float(v) for k, v in scalars.items()})
        for k in row:
            if k not in self._columns:
                self._columns.append(k)
        self._rows.append(row)
        if len(self._rows) >= self._flush_every_n:
            self.flush()

    def write_images(self, step, images):
        try:
            from PIL import Image
        except ImportError:
            return
        for key, imgs in images.items():
            grid = _to_uint8_grid(np.asarray(imgs))
            if grid.shape[-1] == 1:
                grid = grid[..., 0]
            Image.fromarray(grid).save(os.path.join(
                self.logdir, "images", f"{key}_{step:08d}.png"))

    def write_figures(self, step, figures):
        for key, fig in figures.items():
            fig.savefig(os.path.join(self.logdir, "images",
                                     f"{key}_{step:08d}.png"))

    def flush(self):
        if not self._rows:
            return
        import csv
        if self._written_columns and \
                self._written_columns != self._columns:
            # a metric key first appeared after the header was written
            # (e.g. eval fid/lpips starting late): rewrite the file under
            # the widened header instead of appending rows with more
            # fields than the header names (structurally broken CSV)
            with open(self._csv_path, newline="") as f:
                old_rows = list(csv.DictReader(f))
            with open(self._csv_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._columns, restval="")
                w.writeheader()
                w.writerows(old_rows)
                w.writerows(self._rows)
        else:
            exists = os.path.exists(self._csv_path)
            with open(self._csv_path, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._columns, restval="")
                if not exists:
                    w.writeheader()
                w.writerows(self._rows)
        self._written_columns = list(self._columns)
        self._rows.clear()


class TensorBoardWriter(MetricWriter):
    """tensorboardX writer; exports scalars.json on close
    (writers.py:167-221). No-op when tensorboardX is unavailable."""

    def __init__(self, logdir: str):
        super().__init__()
        self.logdir = logdir
        try:
            from tensorboardX import SummaryWriter
            self._w = SummaryWriter(logdir)
        except ImportError:
            self._w = None

    def log_hparams(self, hparams):
        if self._w:
            self._w.add_text("hparams", str(_plain(hparams)))

    def write_scalars(self, step, scalars):
        if self._w:
            for k, v in scalars.items():
                self._w.add_scalar(k, float(v), step)

    def write_images(self, step, images):
        if self._w:
            for k, imgs in images.items():
                grid = _to_uint8_grid(np.asarray(imgs))
                self._w.add_image(k, grid, step, dataformats="HWC")

    def flush(self):
        if self._w:
            self._w.flush()

    def close(self):
        if self._w:
            import json
            try:
                self._w.export_scalars_to_json(
                    os.path.join(self.logdir, "scalars.json"))
            except Exception:
                pass
            self._w.close()
            self._w = None


def _plain(obj):
    """Recursively convert configs to yaml-safe plain python."""
    if isinstance(obj, Mapping):
        return {str(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


class AimWriter(MetricWriter):
    """Aim experiment tracker (writers.py:224-279). Gated: the `aim`
    package is not installed in this environment; construction raises
    unless it is available."""

    def __init__(self, repo: str, experiment: str = "default"):
        super().__init__()
        try:
            from aim import Run
        except ImportError as e:
            raise ImportError(
                "AimWriter requires the 'aim' package (not installed); "
                "use LocalWriter/TensorBoardWriter") from e
        self._run = Run(repo=repo, experiment=experiment)

    def log_hparams(self, hparams):
        self._run["hparams"] = _plain(hparams)

    def write_scalars(self, step, scalars):
        for k, v in scalars.items():
            self._run.track(float(v), name=k, step=step)

    def close(self):
        if getattr(self, "_run", None) is not None:
            self._run.close()
            self._run = None
