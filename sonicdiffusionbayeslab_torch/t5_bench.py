"""SD3 with T5-XXL on the card, staged or resident: the twin of the repo
root's ``t5_bench.py`` for the port, with its modes and JSON keys.

    python -m sonicdiffusionbayeslab_torch.t5_bench staged    # T5 in host memory, copied per batch
    python -m sonicdiffusionbayeslab_torch.t5_bench resident  # everything on the card at once

SD3-medium (MMDiT-medium, T5-XXL, both CLIP towers) at 1024², batch 4,
20 flow-Euler steps, CFG 5.0, ``unet_microbatch`` 2, through
``StableDiffusion3Model`` with ``use_t5`` and random weights from a seed.
One warm pass, then the encode phase alone (staged: the host-to-card copy
of T5 and the three towers' encodes, the copy freed after), then three
measured passes.  One JSON line: ``value`` is images/hour of the best
loop, ``img_per_hour_e2e`` of the best call, ``encode_phase_s_per_batch``
and ``init_s`` in seconds; ``peak_hbm_gb`` is
``torch.cuda.max_memory_allocated`` over the mode.  A
``torch.cuda.OutOfMemoryError`` is reported as ``"fits": false`` with its
class and first line; any other error propagates.

``--tiny --device cpu`` (with ``--steps``) runs the code path on the CPU
at the tiny configs; its numbers are no device measurement.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import numpy as np
import torch

from sonicdiffusionbayeslab_torch.utils.device import resolve_device, synchronize

MODES = ("staged", "resident")
PROMPT = "a man on a snowboard coming down a slope"


def run_mode(mode: str, tiny: bool = False, device=None, steps: int = 20,
             batch: int = 4) -> dict:
    """One mode's JSON record (printed by ``main``)."""
    from sonicdiffusionbayeslab_torch.registry import (
        load_all_plugins,
        models_registry,
        schedulers_registry,
    )

    if mode not in MODES:
        raise SystemExit(f"unknown mode {mode!r} (staged|resident)")
    dev = resolve_device(device)
    load_all_plugins()
    prompts = [PROMPT] * batch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    pipe = None
    t0 = time.perf_counter()
    try:
        pipe = models_registry["stable_diffusion_3_model"](
            pretrained_model="x", image_size=64 if tiny else 1024, tiny=tiny,
            dtype="float32" if tiny else "bfloat16", use_t5=True,
            t5_staged=(mode == "staged"), device=dev)
        pipe.scheduler = schedulers_registry["flow_match_euler_scheduler"]()
        pipe.unet_microbatch = 2
        init_s = time.perf_counter() - t0

        imgs, _, _ = pipe(prompts, num_inference_steps=steps, guidance_scale=5.0, seed=0)
        if not np.isfinite(np.asarray(imgs, np.float32)).all():
            raise AssertionError("t5_bench: the warm pass's images are not finite")

        # The encode phase alone: the staged mode copies T5 to the card for
        # the encodes and frees the copy after, as a call does before its loop.
        synchronize(dev)
        t0 = time.perf_counter()
        pipe._encode(prompts)
        synchronize(dev)
        encode_s = time.perf_counter() - t0
        pipe._pooled_queue.clear()
        pipe._t5_dev = None

        e2e, loop = [], []
        for r in range(3):
            t0 = time.perf_counter()
            imgs, exec_time, _ = pipe(prompts, num_inference_steps=steps, guidance_scale=5.0,
                                      seed=1 + r)
            np.asarray(imgs)
            e2e.append(time.perf_counter() - t0)
            loop.append(float(exec_time))
    except torch.cuda.OutOfMemoryError as e:
        return {"metric": f"t5_{mode}", "fits": False,
                "error": f"{type(e).__name__}: {str(e).splitlines()[0][:300]}",
                "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else None}
    finally:
        del pipe
        gc.collect()  # the engine and its graphed UNet hold each other
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    sec_img_loop, sec_img_e2e = min(loop) / batch, min(e2e) / batch
    return {
        "metric": f"t5_{mode}",
        "fits": True,
        "value": round(3600.0 / sec_img_loop, 1),
        "unit": "images/hour loop-only",
        "img_per_hour_e2e": round(3600.0 / sec_img_e2e, 1),
        "encode_phase_s_per_batch": round(encode_s, 2),
        "init_s": round(init_s, 1),
        "batch": batch,
        "steps": steps,
        "peak_hbm_gb": (round(torch.cuda.max_memory_allocated(dev) / 2**30, 2)
                        if dev.type == "cuda" else None),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else None,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", nargs="?", default="staged", choices=MODES)
    ap.add_argument("--tiny", action="store_true", help="tiny configs (a CPU smoke run)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    print(json.dumps(run_mode(args.mode, args.tiny, args.device, args.steps)), flush=True)


if __name__ == "__main__":
    main()
