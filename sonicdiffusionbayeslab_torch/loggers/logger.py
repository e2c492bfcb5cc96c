"""Experiment logging of the port: always a local run log, and wandb when
it is enabled.

Counterpart of ``sonicdiffusionbayeslab_tpu/loggers/logger.py``:
``LocalRunLogger`` writes ``<root>/<run_id>/`` (``events.jsonl``, TSV
tables under ``tables/``, PNG grids under ``images/``), relative to the
working directory; the ``Logger`` facade stacks wandb on it.  wandb is
imported only when ``wandb_enable`` is true; when it is missing there, the
facade logs a ``wandb_unavailable`` event and goes on locally, as the JAX
package's does.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from sonicdiffusionbayeslab_torch.data.imageio import write_png
from sonicdiffusionbayeslab_torch.utils.images import make_grid, to_uint8, write_table


class LocalRunLogger:
    """Filesystem logger: <root>/<run_id>/{events.jsonl, tables/, images/}."""

    def __init__(self, root: str = "outputs", run_name: str = "run", run_id: Optional[str] = None):
        self.run_id = run_id or f"{run_name}-{uuid.uuid4().hex[:8]}"
        self.dir = Path(root) / self.run_id
        self.dir.mkdir(parents=True, exist_ok=True)
        self._events = open(self.dir / "events.jsonl", "a")

    def log(self, data: Dict, step: Optional[int] = None) -> None:
        rec = {"t": time.time(), "step": step, **_jsonable(data)}
        self._events.write(json.dumps(rec) + "\n")
        self._events.flush()

    def log_table(self, name: str, rows: Dict[str, Sequence]) -> Path:
        tdir = self.dir / "tables"
        tdir.mkdir(exist_ok=True)
        return write_table(rows, tdir / f"{name}.tsv")

    def log_images(self, name: str, images: np.ndarray, captions: Optional[Sequence[str]] = None,
                   step: Optional[int] = None) -> Path:
        idir = self.dir / "images"
        idir.mkdir(exist_ok=True)
        grid = make_grid(to_uint8(np.asarray(images)), nrow=8)
        out = idir / f"{name}_{step if step is not None else 0}.png"
        write_png(out, grid)
        if captions:
            (idir / f"{name}_{step if step is not None else 0}.captions.json").write_text(
                json.dumps(list(captions))
            )
        return out

    def finish(self) -> None:
        self._events.close()


class WandbLogger:
    """Thin wandb wrapper: login via WANDB_KEY, init(resume='allow', id=...).
    Raises ImportError where wandb is not installed."""

    def __init__(self, project_name: str, run_name: str, run_id: Optional[str] = None,
                 config: Optional[dict] = None):
        import wandb

        if os.environ.get("WANDB_KEY"):
            wandb.login(key=os.environ["WANDB_KEY"])
        self.wandb = wandb
        self.run = wandb.init(
            project=project_name,
            name=run_name,
            id=run_id or wandb.util.generate_id(),
            resume="allow",
            config=config,
        )
        self.run_id = self.run.id

    def log(self, data: Dict, step: Optional[int] = None) -> None:
        self.wandb.log(data, step=step)

    def log_table(self, name: str, rows: Dict[str, Sequence]) -> None:
        table = self.wandb.Table(columns=list(rows), data=[list(r) for r in zip(*rows.values())])
        self.wandb.log({name: table})

    def log_images(self, name: str, images: np.ndarray, captions: Optional[Sequence[str]] = None,
                   step: Optional[int] = None) -> None:
        imgs = [
            self.wandb.Image(np.asarray(im), caption=captions[i] if captions else None)
            for i, im in enumerate(images)
        ]
        self.wandb.log({name: imgs}, step=step)

    def finish(self) -> None:
        self.run.finish()


class Logger:
    """Facade: local always, wandb stacked on when enabled and importable."""

    def __init__(
        self,
        config: Optional[dict] = None,
        wandb_enable: bool = True,
        project_name: str = "sonic-diffusion-tpu",
        run_name: str = "run",
        run_id: Optional[str] = None,
        output_root: str = "outputs",
    ):
        self.local = LocalRunLogger(output_root, run_name, run_id)
        self.wandb: Optional[WandbLogger] = None
        if wandb_enable:
            try:
                self.wandb = WandbLogger(project_name, run_name, run_id, config)
            except Exception as e:  # wandb missing, offline or refused: keep the local log
                self.local.log({"event": "wandb_unavailable", "error": repr(e)})
        self.run_id = self.wandb.run_id if self.wandb else self.local.run_id

    def log_metrics(self, metrics: Dict, step: Optional[int] = None) -> None:
        self.local.log(metrics, step)
        if self.wandb:
            self.wandb.log(metrics, step)

    def log_metrics_into_table(self, rows: Dict[str, Sequence], name: str = "metrics") -> None:
        self.local.log_table(name, rows)
        if self.wandb:
            self.wandb.log_table(name, rows)

    def log_batch_of_images(self, images, name: str = "images", captions=None, step=None) -> None:
        self.local.log_images(name, images, captions, step)
        if self.wandb:
            self.wandb.log_images(name, images, captions, step)

    def finish(self) -> None:
        self.local.finish()
        if self.wandb:
            self.wandb.finish()


def _jsonable(d: Dict) -> Dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, (np.floating, np.integer)):
            out[k] = v.item()
        elif isinstance(v, np.ndarray) and v.size == 1:
            out[k] = float(v)
        else:
            out[k] = v
    return out
