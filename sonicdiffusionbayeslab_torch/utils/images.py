"""Image conversion, grid and table helpers of the port.

Counterpart of ``sonicdiffusionbayeslab_tpu/utils/images.py``:
``to_uint8``, ``to_pil_image`` (PIL imported at the call, as there),
``save_image`` (an RGB image through ``data/imageio.py``'s PNG encoder,
so it needs no PIL; other channel counts through PIL), ``make_grid``,
``collate_x0_grid`` and ``save_table``, without pandas: a table is
written by the standard ``csv`` module with the text pandas'
``DataFrame(rows).to_csv(path, sep="\\t", index=False)`` gives (ints as
ints, floats by ``repr``, NaN as an empty field, minimal quoting).
"""

from __future__ import annotations

import csv
import math
import os
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np


def to_uint8(images: np.ndarray) -> np.ndarray:
    """[..., H, W, C] float in [0, 1] -> uint8."""
    images = np.asarray(images, dtype=np.float32)
    return np.clip(images * 255.0 + 0.5, 0, 255).astype(np.uint8)


def hwc_uint8(image) -> np.ndarray:
    """An image as PIL takes it: uint8 (``to_uint8`` of a float image), a
    [C, H, W] one moved to [H, W, C], one channel squeezed away."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
        arr = np.moveaxis(arr, 0, -1)  # CHW -> HWC
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    return arr


def to_pil_image(image) -> "PIL.Image.Image":  # noqa: F821
    from PIL import Image

    return Image.fromarray(hwc_uint8(image))


def save_image(image, path: str | os.PathLike) -> None:
    arr = hwc_uint8(image)
    if arr.ndim == 3 and arr.shape[-1] == 3:
        from sonicdiffusionbayeslab_torch.data.imageio import write_png

        write_png(path, arr)
        return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    to_pil_image(arr).save(path)


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2, pad_value: float = 0.0) -> np.ndarray:
    """Tile [N, H, W, C] into one [GH, GW, C] grid image."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = -(-n // ncol)
    grid = np.full(
        (nrows * (h + padding) + padding, ncol * (w + padding) + padding, c),
        pad_value,
        dtype=images.dtype,
    )
    for i in range(n):
        r, col = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y : y + h, x : x + w] = images[i]
    return grid


def collate_x0_grid(x0_preds: Iterable[np.ndarray], nrow: int = 8) -> np.ndarray:
    """Stack per-step x0 decodes ([S, H, W, C] or a list) into a grid image."""
    frames = np.stack([np.asarray(f) for f in x0_preds])
    return make_grid(frames, nrow=nrow)


def _is_number(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, (bool, np.bool_))


def _column_text(values: Sequence) -> list:
    """One column's fields as pandas writes them for the dtype it infers."""
    present = [v for v in values if v is not None]
    if present and all(isinstance(v, (bool, np.bool_)) for v in values):
        return [str(bool(v)) for v in values]
    if present and all(_is_number(v) for v in present):
        if len(present) == len(values) and all(isinstance(v, (int, np.integer)) for v in values):
            return [str(int(v)) for v in values]
        floats = [math.nan if v is None else float(v) for v in values]
        return ["" if math.isnan(f) else repr(f) for f in floats]
    return ["" if v is None else str(v) for v in values]


def write_table(rows: dict[str, Sequence], out: str | os.PathLike) -> Path:
    """Write ``{column: values}`` as a tab-separated table with a header."""
    out = Path(out)
    columns = [_column_text(list(v)) for v in rows.values()]
    with open(out, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(list(rows))
        w.writerows(zip(*columns))
    return out


def save_table(rows: dict[str, Sequence], path: str | os.PathLike, name: str) -> Path:
    """Write a metric table as ``<path>/<name>.tsv``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    return write_table(rows, path / f"{name}.tsv")
