"""Datasets of the port: a filename -> caption JSON, and a folder of the
images those filenames name.

Counterpart of ``load_prompts``, ``PromptDataset``,
``ImageDatasetWithPrompts`` and ``batched`` in
``sonicdiffusionbayeslab_tpu/data/dataset.py``.  Images are read by
``data/imageio.py::read_image`` (the port's native decoder and the
reference's resize + center crop), as NHWC float32 in [0, 1].

The prompt JSON format is {"<filename>": "<caption>", ...} (e.g.
``data/dataset/img2annotations_test.json``, 1000 entries); a COCO-style
{"<filename>": [{"caption": ...}, ...]} entry takes its first caption.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np


def load_prompts(prompts_file: str | Path) -> Dict[str, str]:
    with open(prompts_file) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"{prompts_file}: expected filename->caption mapping")
    out: Dict[str, str] = {}
    for fname, v in data.items():
        if isinstance(v, list) and v:
            v = v[0]
        if isinstance(v, dict):
            v = v.get("caption")
        if not isinstance(v, str):
            raise ValueError(
                f"{prompts_file}: caption for {fname!r} must be a string "
                f"(or COCO [{{'caption': ...}}] list), got {type(v).__name__}")
        out[fname] = v
    return out


class PromptDataset:
    """Captions only, in sorted filename order.  ``max_count`` keeps the
    first N files and must be positive (None keeps all)."""

    def __init__(self, prompts_file: str | Path, max_count: Optional[int] = None):
        self.img2prompt = load_prompts(prompts_file)
        self.files: List[str] = sorted(self.img2prompt)
        if max_count is not None:
            if int(max_count) <= 0:
                raise ValueError(f"dataset max_count must be positive, got {max_count}")
            self.files = self.files[: int(max_count)]

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> dict:
        f = self.files[i]
        return {"image_file": f, "prompt": self.img2prompt[f], "index": i}


class ImageDatasetWithPrompts(PromptDataset):
    """Images and captions, what validation (FID, ImageReward) needs.
    ``image_size``: images are resized (short side) and center-cropped to
    [image_size, image_size]; None keeps each image's size.  Raises at
    construction when a listed file is missing."""

    def __init__(self, image_dir: str | Path, prompts_file: str | Path,
                 image_size: Optional[int] = None, max_count: Optional[int] = None):
        super().__init__(prompts_file, max_count)
        self.image_dir = Path(image_dir)
        self.image_size = image_size
        missing = [f for f in self.files if not (self.image_dir / f).exists()]
        if missing:
            raise FileNotFoundError(
                f"{len(missing)} of {len(self.files)} dataset images missing under "
                f"{self.image_dir}, e.g. {missing[:3]}")

    def load_image(self, filename: str) -> np.ndarray:
        from sonicdiffusionbayeslab_torch.data.imageio import read_image

        return read_image(self.image_dir / filename, self.image_size)

    def __getitem__(self, i: int) -> dict:
        item = super().__getitem__(i)
        item["image"] = self.load_image(item["image_file"])
        return item


def batched(dataset, batch_size: int) -> Iterator[dict]:
    """Batches of ``batch_size`` items (the last one shorter) as dicts:
    arrays stacked, ints as an int array, anything else as a list, e.g.
    {"image_file": [...], "prompt": [...], "index": array, "image": [B, H, W, 3]}."""
    n = len(dataset)
    for s in range(0, n, batch_size):
        items = [dataset[i] for i in range(s, min(s + batch_size, n))]
        batch: dict = {}
        for k in items[0]:
            vals = [it[k] for it in items]
            if isinstance(vals[0], np.ndarray):
                batch[k] = np.stack(vals)
            elif isinstance(vals[0], (int, np.integer)):
                batch[k] = np.asarray(vals)
            else:
                batch[k] = vals
        yield batch
