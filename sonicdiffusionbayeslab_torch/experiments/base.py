"""Experiment lifecycle of the port.

Counterpart of ``sonicdiffusionbayeslab_tpu/experiments/base.py``:
``BaseMethod(config).run_experiment()`` sweeps a parameter grid; each grid
point generates images for the prompt set and validates them with the
configured metrics, logging tables and images locally (and to wandb when
enabled).  Sweep progress is kept in ``sweep_state.json`` in the run
directory, so a run given the same ``logger.run_id`` resumes at the next
grid point.

The model runs on ``model.device`` (CUDA unless the config or the CLI's
``--device`` says otherwise) and the metrics on the model's device.
Grid point ``g`` samples with ``rng.grid_seed(seed, g)``, so a sample's
initial latents depend only on (seed, grid point, sample index).

Validation: every configured metric of the JAX package is ported
(``clip_score``, ``image_reward``, ``fid``, ``aesthetic_score``); when
``dataset.img_dataset`` names a directory that exists, the real images of
each validation batch are read (``ImageDatasetWithPrompts``) for FID and
ImageReward's win rate, and the table gains ``fid`` (from two images on)
and ``image_reward``, as in the JAX package.  ``inference.quant`` sets the
model's UNet int8 mode (``ops/quant.py``; the JAX package sets a process
global); ``inference.unet_microbatch`` its UNet chunking.  The metrics'
cross-process sums are not ported (one process).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Iterable, List

import numpy as np

from sonicdiffusionbayeslab_torch.config import ConfigNode
from sonicdiffusionbayeslab_torch.data.dataset import (
    ImageDatasetWithPrompts,
    PromptDataset,
    batched,
)
from sonicdiffusionbayeslab_torch.data.imageio import write_png
from sonicdiffusionbayeslab_torch.loggers import Logger
from sonicdiffusionbayeslab_torch.ops.quant import check_mode
from sonicdiffusionbayeslab_torch.registry import metrics_registry, models_registry, schedulers_registry
from sonicdiffusionbayeslab_torch.utils import rng as rng_util
from sonicdiffusionbayeslab_torch.utils.images import make_grid, save_table, to_uint8


class BaseMethod:
    def __init__(self, config: ConfigNode):
        self.config = config
        self.metric_dict: Dict[str, List] = {}
        self.setup()

    # ------------------------------------------------------------- setup
    def setup(self) -> None:
        self.setup_exp_params()
        self.setup_generator()
        self.setup_model()
        self.setup_scheduler()
        self.setup_dataset()
        self.setup_metrics()
        self.setup_loggers()

    def setup_exp_params(self) -> None:
        self.params = self.config.get("experiment_params", ConfigNode({}))

    def setup_generator(self) -> None:
        self.seed = rng_util.setup_seed(self.config.experiment.get("seed", 29))

    def setup_model(self) -> None:
        quant = self.config.inference.get("quant")
        if quant is not None:  # checked before the weights are built
            try:
                quant = check_mode(str(quant).lower() or None)
            except ValueError as e:
                raise ValueError(f"inference.quant: {e}") from None
        mcfg = self.config.model
        name = mcfg.model_name
        kw = dict(mcfg)
        kw.pop("model_name", None)
        kw.setdefault("image_size", self.config.dataset.get("image_size", 512))
        models_registry.validate_kwargs(name, kw, allow_missing=True)
        self.model = models_registry[name](**kw)
        mb = self.config.inference.get("unet_microbatch")
        if mb is not None:
            self.model.unet_microbatch = int(mb)
        if quant is not None:
            self.model.engine.set_quant_mode(quant)

    def setup_scheduler(self) -> None:
        scfg = self.config.get("scheduler")
        if scfg and "scheduler_name" in scfg:
            self.model.scheduler = self.build_scheduler(scfg.scheduler_name)

    def build_scheduler(self, name: str, **kw):
        # The model family's prediction target flows from experiment_params
        # to every scheduler unless the method set it.
        if "prediction_type" not in kw:
            pt = self.params.get("prediction_type")
            if pt:
                kw["prediction_type"] = str(pt)
        schedulers_registry.validate_kwargs(name, kw, allow_missing=True)
        return schedulers_registry[name](**kw)

    def setup_dataset(self) -> None:
        dcfg = self.config.dataset
        prompts = dcfg.get("prompts")
        img_dir = dcfg.get("img_dataset")
        max_count = dcfg.get("max_count")
        if img_dir and Path(img_dir).exists() and prompts:
            self.dataset = ImageDatasetWithPrompts(img_dir, prompts, dcfg.get("image_size", 512),
                                                   max_count=max_count)
            self.has_real_images = True
        elif prompts:
            self.dataset = PromptDataset(prompts, max_count=max_count)
            self.has_real_images = False
        else:
            raise ValueError("dataset config needs at least 'prompts'")

    def setup_metrics(self) -> None:
        q = self.config.get("quality_metrics", ConfigNode({}))
        tiny = bool(self.config.model.get("tiny", False))

        def build(name):
            if name not in q:
                return None
            kw = dict(q.get(name) or ConfigNode({}))
            if tiny:
                kw["tiny"] = True
            kw.setdefault("device", str(self.model.device))
            metrics_registry.validate_kwargs(name, kw, allow_missing=True)
            return metrics_registry[name](**kw)

        self.clip_score_metric = build("clip_score")
        self.image_reward_metric = build("image_reward")
        self.fid_metric = build("fid")
        self.aesthetic_metric = build("aesthetic_score")
        self.time_metric = metrics_registry["time_metric"]()

    def setup_loggers(self) -> None:
        lcfg = self.config.get("logger", ConfigNode({}))
        self.logger = Logger(
            config=self.config.to_dict(),
            wandb_enable=lcfg.get("wandb_enable", False),
            project_name=lcfg.get("project_name", "sonic-diffusion-tpu"),
            run_name=self.config.get("experiment_name", "run"),
            run_id=lcfg.get("run_id"),
        )
        self.log_images_step = lcfg.get("log_images_step", 0)
        self.save_images = lcfg.get("save", False)
        self.save_dir_tmpl = lcfg.get("save_dir", "outputs/{experiment}/{args}/")

    # ------------------------------------------------------------- sweep
    def grid(self) -> Iterable[Dict[str, Any]]:
        """Yield {label, call_kw} per grid point; subclasses define."""
        raise NotImplementedError

    def run_experiment(self) -> Dict[str, List]:
        state_file = self.logger.local.dir / "sweep_state.json"
        done = set()
        if state_file.exists():
            done = set(json.loads(state_file.read_text())["done"])
        for gi, point in enumerate(self.grid()):
            label = point["label"]
            if label in done:
                continue
            gen = self.generate(grid_index=gi, **point["call_kw"])
            self.validate(gen, label=label, grid_index=gi)
            done.add(label)
            state_file.write_text(json.dumps({"done": sorted(done)}))
        self.logger.log_metrics_into_table(self.metric_dict, name="final")
        self.save_table()
        return self.metric_dict

    # ---------------------------------------------------------- generate
    def generate(self, grid_index: int = 0, use_x0: bool = False, **call_kw) -> Dict[str, Any]:
        batch_size = self.config.inference.get("batch_size", 8)
        batch_count = self.config.inference.get("batch_count")
        # x0 capture: every batch by default; inference.x0_samples (samples
        # per batch) and inference.x0_batches (leading batches) narrow it.
        x0_samples = self.config.inference.get("x0_samples")
        x0_batches = self.config.inference.get("x0_batches")
        guidance = call_kw.pop("guidance_scale", self.config.inference.get("guidance_scale", 7.5))
        self.time_metric.reset()
        seed = rng_util.grid_seed(self.seed, grid_index)

        images, prompts, files = [], [], []
        x0_grids: List[np.ndarray] = []
        for bi, batch in enumerate(batched(self.dataset, batch_size)):
            if batch_count is not None and bi >= batch_count:
                break
            out_images, exec_time, x0 = self.model(
                batch["prompt"],
                guidance_scale=guidance,
                seed=seed,
                sample_indices=batch["index"],
                use_x0=use_x0 and (x0_batches is None or bi < int(x0_batches)),
                x0_samples=x0_samples,
                **call_kw,
            )
            self.time_metric.update(exec_time, len(batch["prompt"]))
            images.append(to_uint8(out_images))
            prompts.extend(batch["prompt"])
            files.extend(batch["image_file"])
            if x0 is not None:
                # x0: [steps, n, H, W, 3] -> grid rows = steps, cols = samples.
                n = x0.shape[1]
                x0_grids.append(make_grid(to_uint8(x0.reshape((-1,) + x0.shape[2:])), nrow=n))
        return {
            "images": np.concatenate(images) if images else np.zeros((0,)),
            "prompts": prompts,
            "files": files,
            "x0_grids": x0_grids,
            "nfe": self.model.num_timesteps,
        }

    # ---------------------------------------------------------- validate
    def validate(self, gen: Dict[str, Any], label: str, grid_index: int = 0) -> None:
        images01 = gen["images"].astype(np.float32) / 255.0
        batch_size = self.config.inference.get("batch_size", 8)
        n = len(gen["prompts"])
        for m in (self.clip_score_metric, self.image_reward_metric, self.fid_metric,
                  self.aesthetic_metric):
            if m is not None:
                m.reset()

        for s in range(0, n, batch_size):
            sl = slice(s, min(s + batch_size, n))
            prompts = gen["prompts"][sl]
            imgs = images01[sl]
            if self.clip_score_metric:
                self.clip_score_metric.update(imgs, prompts)
            if self.aesthetic_metric:
                self.aesthetic_metric.update(imgs)
            if self.has_real_images and (self.fid_metric or self.image_reward_metric):
                real = np.stack([self.dataset.load_image(f) for f in gen["files"][sl]])
                if self.fid_metric:
                    self.fid_metric.update(imgs, real=False)
                    self.fid_metric.update(real, real=True)
                if self.image_reward_metric:
                    self.image_reward_metric.update(prompts, real, imgs)

        row = {"exp": label, "nfe": gen["nfe"], "time": self.time_metric.compute()}
        if self.clip_score_metric:
            row["clip_score"] = self.clip_score_metric.compute()
        if self.has_real_images and self.fid_metric and n >= 2:
            row["fid"] = self.fid_metric.compute()
        if self.has_real_images and self.image_reward_metric:
            row["image_reward"] = self.image_reward_metric.compute()
        if self.aesthetic_metric:
            row["aesthetic_score"] = self.aesthetic_metric.compute()
        for k, v in row.items():
            self.metric_dict.setdefault(k, []).append(v)
        self.logger.log_metrics({f"metrics/{k}": v for k, v in row.items() if k != "exp"},
                                step=grid_index)

        if self.log_images_step:
            k = min(8, n)
            self.logger.log_batch_of_images(
                gen["images"][:k], name=f"samples/{label}", captions=gen["prompts"][:k],
                step=grid_index,
            )
        for i, g in enumerate(gen["x0_grids"]):
            self.logger.log_batch_of_images(g[None], name=f"x0/{label}_{i}", step=grid_index)
        if self.save_images:
            save_dir = Path(self.save_dir_tmpl.format(
                experiment=self.config.get("experiment_name", "exp"), args=label))
            for fname, img in zip(gen["files"], gen["images"]):
                write_png(save_dir / fname, img)

    def save_table(self) -> None:
        save_table(self.metric_dict, self.logger.local.dir, "metrics")
