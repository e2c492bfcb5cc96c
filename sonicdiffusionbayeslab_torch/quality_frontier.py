"""One-command speed-vs-quality frontier over the acceleration modes.

The port's counterpart of ``sonicdiffusionbayeslab_tpu/quality_frontier.py``:
every acceleration mode the port ships, scored in one run with the
reference's protocol (loop-only seconds per image, CLIP score on COCO test
captions, and each mode's deltas against the exact bf16 row):

    python -m sonicdiffusionbayeslab_torch.quality_frontier \\
        --sd15 /path/to/stable-diffusion-v1-5 \\
        [--clip /path/to/clip-vit-base-patch16] \\
        [--sd3 /path/to/stable-diffusion-3-medium] \\
        [--prompts 100 --batch 8 --steps 20] [--out outputs/frontier]

SD-1.5 modes (DPM-Solver++ order 2): exact bf16; ToMe 0.25 and 0.5;
int8_conv_only; turbo (int8_conv_only + ToMe 0.5); DeepCache interval 2, 3
and 5; max-stack (turbo + DeepCache 3).  SD3 modes (with ``--sd3``; flow
Euler, shift 3, CFG 7): exact; trunk-delta interval 2 and 3 (branch 2); ToMe
0.25 and 0.5; int8; max-stack (ToMe 0.5 + trunk-delta 3).  The snapshot
paths come from the flags, else ``SDBL_SD15_SNAPSHOT``, ``SDBL_CLIP_SNAPSHOT``
and ``SDBL_SD3_SNAPSHOT`` (as in the JAX package); a path that does not
exist gives the pipeline's random weights.  Each mode's int8
setting is the model's (``engine.set_quant_mode``) and is reset after its
row, so it never reaches the next one.  Output: ``<out>.tsv`` and
``<out>.jsonl`` with the reference's columns.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from sonicdiffusionbayeslab_torch.utils import env


@dataclasses.dataclass
class Mode:
    label: str
    family: str  # sd15 | sd3
    call_kw: dict = dataclasses.field(default_factory=dict)
    quant: Optional[str] = None
    cache_interval: int = 0
    cache_branch: int = 0


SD15_MODES = [
    Mode("exact_bf16", "sd15"),
    Mode("tome_0.25", "sd15", {"tome_ratio": 0.25}),
    Mode("tome_0.5", "sd15", {"tome_ratio": 0.5}),
    Mode("int8_conv_only", "sd15", quant="int8_conv_only"),
    Mode("turbo(int8+tome0.5)", "sd15", {"tome_ratio": 0.5}, quant="int8_conv_only"),
    Mode("deep_cache_2", "sd15", cache_interval=2),
    Mode("deep_cache_3", "sd15", cache_interval=3),
    Mode("deep_cache_5", "sd15", cache_interval=5),
    Mode("max_stack(turbo+dc3)", "sd15", {"tome_ratio": 0.5}, quant="int8_conv_only",
         cache_interval=3),
]

SD3_MODES = [
    Mode("sd3_exact_bf16", "sd3"),
    Mode("sd3_trunk_delta_2", "sd3", cache_interval=2, cache_branch=2),
    Mode("sd3_trunk_delta_3", "sd3", cache_interval=3, cache_branch=2),
    Mode("sd3_tome_0.25", "sd3", {"tome_ratio": 0.25}),
    Mode("sd3_tome_0.5", "sd3", {"tome_ratio": 0.5}),
    Mode("sd3_int8", "sd3", quant="int8"),
    Mode("sd3_max_stack(tome0.5+td3)", "sd3", {"tome_ratio": 0.5}, cache_interval=3,
         cache_branch=2),
]

SD3_GUIDANCE = 7.0
COLUMNS = ["mode", "family", "nfe", "sec_per_image", "images_per_hour", "clip_score",
           "speedup_vs_exact", "clip_delta_pct"]


def coco_prompts(n: int) -> List[str]:
    """The first ``n`` captions of the reference's COCO test annotations,
    in key order."""
    rel = "data/dataset/img2annotations_test.json"
    here = Path(__file__).resolve()
    p = next((d / rel for d in (here.parent, here.parents[1]) if (d / rel).exists()),
             here.parents[1] / rel)
    ann = json.loads(p.read_text())
    return [v for _, v in sorted(ann.items())][:n]


def build_pipe(family: str, snapshot: str, device=None, tiny: bool = False,
               dtype: str = "bfloat16"):
    """The family's registered pipeline on ``snapshot`` with the frontier's
    scheduler: DPM-Solver++ order 2 (SD-1.5) or flow Euler at shift 3 (SD3)."""
    from sonicdiffusionbayeslab_torch.registry import load_all_plugins, models_registry
    from sonicdiffusionbayeslab_torch.schedulers import (
        DPMSolverScheduler,
        FlowMatchEulerScheduler,
    )

    load_all_plugins()
    name = "stable_diffusion_3_model" if family == "sd3" else "stable_diffusion_model"
    pipe = models_registry[name](pretrained_model=snapshot, tiny=tiny, dtype=dtype, device=device)
    pipe.scheduler = (FlowMatchEulerScheduler(shift=3.0) if family == "sd3"
                      else DPMSolverScheduler(solver_order=2))
    return pipe


def run_mode(pipe, mode: Mode, prompts: Sequence[str], batch: int, steps: int,
             guidance: float, clip_metric) -> dict:
    """One row: the prompts in batches under ``mode``; the model's int8
    mode and DeepCache plan are set for the row and reset after it."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.models.sampler import CachePlan

    pipe.engine.set_quant_mode(mode.quant)
    pipe.cache_plan_fn = ((lambda n, m=mode: CachePlan.every(n, m.cache_interval,
                                                             m.cache_branch))
                          if mode.cache_interval >= 2 else None)
    try:
        total_time, n_img = 0.0, 0
        if clip_metric is not None:
            clip_metric.reset()
        for i in range(0, len(prompts), batch):
            chunk = list(prompts[i:i + batch])
            imgs, secs, _ = pipe(chunk, num_inference_steps=steps, guidance_scale=guidance,
                                 **mode.call_kw)
            total_time += float(secs)
            n_img += len(chunk)
            if clip_metric is not None:
                clip_metric.update(np.asarray(imgs, np.float32), chunk)
        sec_per_image = total_time / n_img
        return {
            "mode": mode.label,
            "family": mode.family,
            "nfe": int(pipe.num_timesteps),
            "sec_per_image": round(sec_per_image, 4),
            "images_per_hour": round(3600.0 / sec_per_image, 1),
            "clip_score": (round(float(clip_metric.compute()), 4)
                           if clip_metric is not None else None),
        }
    finally:
        pipe.engine.set_quant_mode(None)
        pipe.cache_plan_fn = None


def add_deltas(rows: List[dict]) -> List[dict]:
    """``speedup_vs_exact`` and ``clip_delta_pct`` of each row against its
    family's exact row."""
    base = {r["family"]: r for r in rows if r["mode"].endswith("exact_bf16")}
    for r in rows:
        b = base.get(r["family"])
        if b:
            r["speedup_vs_exact"] = round(b["sec_per_image"] / r["sec_per_image"], 3)
            if r["clip_score"] is not None and b["clip_score"]:
                r["clip_delta_pct"] = round(
                    100.0 * (r["clip_score"] - b["clip_score"]) / b["clip_score"], 3)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sd15", default=env.snapshot("sd15"),
                    help="local diffusers SD-1.5 snapshot dir")
    ap.add_argument("--clip", default=env.snapshot("clip"),
                    help="local clip-vit-base-patch16 snapshot (CLIP scoring; omit to measure "
                         "speed only)")
    ap.add_argument("--sd3", default=env.snapshot("sd3"),
                    help="local SD3-medium snapshot dir (adds the SD3 rows)")
    ap.add_argument("--prompts", type=int, default=100,
                    help="COCO test captions per mode (reference protocol: 1000)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--sd3-batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--guidance", type=float, default=7.5)
    ap.add_argument("--microbatch", type=int, default=None, help="unet_microbatch (None = off)")
    ap.add_argument("--out", default="outputs/frontier",
                    help="output prefix (.tsv + .jsonl written)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="tiny models (smoke runs)")
    ap.add_argument("--dtype", default="bfloat16", help="bfloat16 | float32")
    args = ap.parse_args(argv)

    if not args.sd15:
        ap.error("--sd15 (or SDBL_SD15_SNAPSHOT) is required: the frontier runs on a local "
                 "snapshot")

    prompts = coco_prompts(args.prompts)
    clip_metric = None
    if args.clip:
        from sonicdiffusionbayeslab_torch.metrics.metrics import ClipScoreMetric

        clip_metric = ClipScoreMetric(model_name_or_path=args.clip, tiny=args.tiny,
                                      device=args.device)

    rows = []
    for family, snapshot, modes, batch, guidance in (
            ("sd15", args.sd15, SD15_MODES, args.batch, args.guidance),
            ("sd3", args.sd3, SD3_MODES, args.sd3_batch, SD3_GUIDANCE)):
        if not snapshot:
            continue
        pipe = build_pipe(family, snapshot, args.device, args.tiny, args.dtype)
        if family == "sd15":
            pipe.unet_microbatch = args.microbatch
        for mode in modes:
            row = run_mode(pipe, mode, prompts, batch, args.steps, guidance, clip_metric)
            rows.append(row)
            print(json.dumps(row), flush=True)
        del pipe

    add_deltas(rows)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(f"{out}.tsv", "w") as f:
        f.write("\t".join(COLUMNS) + "\n")
        for r in rows:
            f.write("\t".join(str(r.get(c, "")) for c in COLUMNS) + "\n")
    with open(f"{out}.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print(f"frontier written: {out}.tsv / {out}.jsonl", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
