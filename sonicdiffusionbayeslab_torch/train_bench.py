"""Training step rates on the card: the twin of the repo root's
``train_bench.py`` for the port, with its modes and JSON lines.

    python -m sonicdiffusionbayeslab_torch.train_bench full512           # full UNet, 512², remat, AdamW
    python -m sonicdiffusionbayeslab_torch.train_bench full512_noremat   # the same without remat
    python -m sonicdiffusionbayeslab_torch.train_bench full512_adafactor # factored optimizer state
    python -m sonicdiffusionbayeslab_torch.train_bench full512_adam8bit  # blockwise-int8 Adam moments
    python -m sonicdiffusionbayeslab_torch.train_bench lora512           # LoRA rank 8, 512²
    python -m sonicdiffusionbayeslab_torch.train_bench sd3_lora          # MMDiT LoRA rank 8, flow, 1024², remat
    python -m sonicdiffusionbayeslab_torch.train_bench prefetch          # run_training it/s, prefetch 2 vs 0

``--batch`` (default per mode: 8, sd3_lora 2), ``--steps`` (default 12),
``--tiny --device cpu`` for a CPU smoke run of the code path (its numbers
are no device measurement).  Random bf16 weights and random latents and
context run the same step as a real fine-tune.  The first step is timed
apart (``compile_s``: PyTorch compiles nothing, but cuBLAS, cuDNN and the
kernels' first launches set up there); ``sec_per_step`` is the median of
the following steps, the device synchronised before each clock read.
``peak_hbm_gb`` is ``torch.cuda.max_memory_allocated`` over the mode.  A
``torch.cuda.OutOfMemoryError`` is reported as ``"fits": false``.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from sonicdiffusionbayeslab_torch.utils.device import resolve_device, synchronize

DEFAULT_BATCH = {"full512": 8, "full512_noremat": 8, "full512_adafactor": 8,
                 "full512_adam8bit": 8, "lora512": 8, "sd3_lora": 2, "prefetch": 8}
UNET_MODES = {  # mode: (remat, lora_rank, optimizer)
    "full512": (True, 0, "adamw"),
    "full512_noremat": (False, 0, "adamw"),
    "full512_adafactor": (True, 0, "adafactor"),
    "full512_adam8bit": (True, 0, "adamw8bit"),
    "lora512": (False, 8, "adamw"),
}
MODES = (*UNET_MODES, "sd3_lora", "prefetch")


def _time_steps(step_once, n_steps, device):
    """(median seconds a step over ``n_steps``, the first step's seconds)."""
    t0 = time.perf_counter()
    step_once()
    synchronize(device)
    first = time.perf_counter() - t0
    times = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        step_once()
        synchronize(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times), first


def _step(pipe, config, lat, ctx, added):
    from sonicdiffusionbayeslab_torch.training.trainer import DiffusionTrainer

    trainer = DiffusionTrainer(pipe.engine, config)
    holder = {"state": trainer.init_state()}

    def once():
        holder["state"], _ = trainer.train_step(holder["state"], lat, ctx, added=added)

    return once


def _unet_step(mode, batch, tiny, device):
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
    from sonicdiffusionbayeslab_torch.training.trainer import TrainConfig

    remat, rank, optimizer = UNET_MODES[mode]
    pipe = StableDiffusionModel("x", image_size=512, dtype="bfloat16", tiny=tiny, device=device)
    dev = pipe.engine.device
    hw = 8 if tiny else 64
    rng = np.random.default_rng(0)
    lat = torch.from_numpy(rng.normal(size=(batch, hw, hw, 4)).astype(np.float32)).to(dev)
    cdim = pipe.engine.text_config.hidden_size
    ctx = torch.from_numpy(np.random.default_rng(1).normal(size=(batch, 77, cdim))
                           .astype(np.float32)).to(dev)
    return _step(pipe, TrainConfig(remat=remat, lora_rank=rank, optimizer=optimizer),
                 lat, ctx, None)


def _sd3_lora_step(batch, tiny, device):
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusion3Model
    from sonicdiffusionbayeslab_torch.training.lora import MMDIT_TARGETS
    from sonicdiffusionbayeslab_torch.training.trainer import TrainConfig

    pipe = StableDiffusion3Model("x", image_size=1024, dtype="bfloat16", tiny=tiny,
                                 device=device)
    eng = pipe.engine
    rng = np.random.default_rng(0)
    hw = 8 if tiny else 128
    cfg = eng.unet_config
    t_ctx = eng.text_config.max_length + eng.text2_config.max_length

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(eng.device)

    lat = rand(batch, hw, hw, cfg.in_channels)
    ctx = rand(batch, t_ctx, cfg.joint_attention_dim)
    added = {"text_embeds": rand(batch, cfg.pooled_projection_dim)}
    config = TrainConfig(objective="flow", lora_rank=8, lora_targets=MMDIT_TARGETS, remat=True)
    return _step(pipe, config, lat, ctx, added)


def make_step(mode: str, batch: int | None = None, tiny: bool = False, device=None):
    """A closure that takes one train step of ``mode`` (not ``prefetch``) on
    its own pipeline, trainer, latents and context."""
    batch = batch or DEFAULT_BATCH[mode]
    dev = resolve_device(device)
    if mode == "sd3_lora":
        return _sd3_lora_step(batch, tiny, dev)
    return _unet_step(mode, batch, tiny, dev)


def _prefetch_bench(batch, steps, tiny, device):
    """run_training's steady-state it/s with the prefetch thread (depth 2)
    and inline (0): PNG decode, VAE encode and CLIP encode each batch."""
    from sonicdiffusionbayeslab_torch.config import ConfigNode, validate_config
    from sonicdiffusionbayeslab_torch.data.imageio import write_png
    from sonicdiffusionbayeslab_torch.training.loop import run_training

    size = 16 if tiny else 512
    rates = {}
    with tempfile.TemporaryDirectory(prefix="sdbl_train_bench_") as tmp:
        tmp = Path(tmp)
        rng = np.random.default_rng(0)
        ann = {}
        for i in range(4 * batch):
            write_png(tmp / "imgs" / f"img_{i}.png",
                      rng.integers(0, 255, (size, size, 3), dtype=np.uint8))
            ann[f"img_{i}.png"] = f"a synthetic training image number {i}"
        (tmp / "ann.json").write_text(json.dumps(ann))
        for depth in (0, 2):
            cfg = {"experiment_name": "train_bench", "experiment": {"seed": 29},
                   "model": {"model_name": "stable_diffusion_model", "pretrained_model": "x",
                             "image_size": size, "dtype": "bfloat16", "tiny": tiny,
                             "device": str(device) if device is not None else None},
                   "dataset": {"img_dataset": str(tmp / "imgs"), "prompts": str(tmp / "ann.json"),
                               "image_size": size},
                   "training": {"num_steps": steps, "batch_size": batch, "log_every": steps,
                                "lora_rank": 8, "prefetch": depth}}
            rates[depth] = run_training(validate_config(ConfigNode(cfg)))["steps_per_sec"]
            gc.collect()
    return rates


def _card(device) -> str | None:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else None


def run_mode(mode: str, batch: int | None = None, steps: int = 12, tiny: bool = False,
             device=None) -> dict:
    """One mode's JSON record (printed by ``main``)."""
    if mode not in MODES:
        raise SystemExit(f"unknown mode {mode!r}; modes: {', '.join(MODES)}")
    dev = resolve_device(device)
    batch = batch or DEFAULT_BATCH[mode]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    peak = (lambda: round(torch.cuda.max_memory_allocated(dev) / 2**30, 2)  # noqa: E731
            if dev.type == "cuda" else None)
    if mode == "prefetch":
        rates = _prefetch_bench(batch, steps, tiny, dev)
        return {"metric": "train_prefetch_delta", "value": round(rates[2] / rates[0], 3),
                "unit": "x (prefetch 2 vs inline, steady-state steps 2..N)",
                "it_s_prefetch2": round(rates[2], 3), "it_s_inline": round(rates[0], 3),
                "batch": batch, "steps": steps, "peak_hbm_gb": peak(), "device": _card(dev)}
    oom = None
    try:
        sec, first = _time_steps(make_step(mode, batch, tiny, dev), steps, dev)
    except torch.cuda.OutOfMemoryError as e:
        oom = next((line.strip() for line in str(e).splitlines() if "memory" in line.lower()),
                   str(e))
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if oom is not None:
        return {"metric": f"train_{mode}", "value": 0.0, "unit": "steps/sec", "fits": False,
                "batch": batch, "sec_per_step": None, "compile_s": None,
                "peak_hbm_gb": peak(), "error": oom[:240], "device": _card(dev)}
    return {"metric": f"train_{mode}", "value": round(1.0 / sec, 3), "unit": "steps/sec",
            "fits": True, "batch": batch, "sec_per_step": round(sec, 4),
            "compile_s": round(first, 1), "peak_hbm_gb": peak(),
            "images_per_sec": round(batch / sec, 2), "device": _card(dev)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", nargs="?", default="lora512", choices=MODES)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--tiny", action="store_true", help="tiny configs (a CPU smoke run)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run_mode(args.mode, args.batch, args.steps, args.tiny, args.device)))


if __name__ == "__main__":
    main()
