"""Prompt datasets of the port: a filename -> caption JSON.

Counterpart of ``load_prompts``, ``PromptDataset`` and ``batched`` in
``sonicdiffusionbayeslab_tpu/data/dataset.py``.  The image dataset
(``ImageDatasetWithPrompts``) needs an image reader, which the port does
not have yet; the experiment raises when a config names an image directory
that exists.

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


def batched(dataset, batch_size: int) -> Iterator[dict]:
    """Batches of ``batch_size`` items (the last one shorter) as dicts of
    lists, ints as an int array: {"image_file": [...], "prompt": [...],
    "index": array}."""
    n = len(dataset)
    for s in range(0, n, batch_size):
        items = [dataset[i] for i in range(s, min(s + batch_size, n))]
        batch: dict = {}
        for k in items[0]:
            vals = [it[k] for it in items]
            batch[k] = np.asarray(vals) if isinstance(vals[0], (int, np.integer)) else vals
        yield batch
