"""End-to-end serving throughput of the port (the root ``serve_bench.py``'s
twin): ``InferenceServer`` with its defaults (pipeline_depth 2, uint8
round on the device), N concurrent requests, the wall clock from the first
submit to the last result.  Text encode, denoising loop, VAE decode and the
copy to the host are all in it.

    python -m sonicdiffusionbayeslab_torch.serve_bench hero        # SD-1.5 512^2 exact bf16
    python -m sonicdiffusionbayeslab_torch.serve_bench turbo       # + int8 conv + ToMe 0.5
    python -m sonicdiffusionbayeslab_torch.serve_bench deep_cache  # + DeepCache interval 3
    python -m sonicdiffusionbayeslab_torch.serve_bench max_stack   # turbo + DeepCache 3
    python -m sonicdiffusionbayeslab_torch.serve_bench sdxl        # SDXL-base 1024^2 exact
    python -m sonicdiffusionbayeslab_torch.serve_bench sd3         # SD3-medium 1024^2 flow
    python -m sonicdiffusionbayeslab_torch.serve_bench hero --tiny --device cpu

``--requests``, ``--max_batch`` and ``--depth`` override the mode's
defaults.  Protocol: one full batch first (CUDA-graph capture and cuDNN's
algorithm search; timed apart as ``warm_pass_s``), then the measured pass.
The weights are random from seed 0: the same shapes and kernels as a real
checkpoint's, which is what throughput depends on.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

PROMPT = "a man on a snowboard coming down a slope"
MODES = ("hero", "turbo", "deep_cache", "max_stack", "sdxl", "sd3")


def build_pipe(mode: str, tiny: bool = False, device=None):
    """(pipeline, max_batch, requests, steps) of a mode at its defaults."""
    from sonicdiffusionbayeslab_torch.models.sampler import CachePlan
    from sonicdiffusionbayeslab_torch.registry import (
        load_all_plugins,
        models_registry,
        schedulers_registry,
    )

    load_all_plugins()
    kw = dict(pretrained_model="x", dtype="bfloat16", tiny=tiny, device=device)
    if mode in ("hero", "turbo", "deep_cache", "max_stack"):
        pipe = models_registry["stable_diffusion_model"](image_size=512, **kw)
        pipe.scheduler = schedulers_registry["dpm_solver_scheduler"](solver_order=2)
        if not tiny:
            pipe.unet_microbatch = 4  # UNet batch 64 as 4 chunks of 16
        max_batch, requests, steps = 32, 128, 20
    elif mode == "sdxl":
        pipe = models_registry["stable_diffusion_xl_model"](image_size=1024, **kw)
        pipe.scheduler = schedulers_registry["dpm_solver_scheduler"](solver_order=2)
        max_batch, requests, steps = 4, 16, 20
    elif mode == "sd3":
        pipe = models_registry["stable_diffusion_3_model"](image_size=1024, **kw)
        pipe.scheduler = schedulers_registry["flow_match_euler_scheduler"]()
        if not tiny:
            pipe.unet_microbatch = 2
        max_batch, requests, steps = 4, 16, 20
    else:
        raise SystemExit(f"unknown mode {mode!r}; modes: {', '.join(MODES)}")
    if tiny:
        max_batch, requests, steps = 4, 8, 3
    if mode in ("turbo", "max_stack"):
        pipe.engine.set_quant_mode("int8_conv_only")
        pipe.tome_ratio = 0.5
    if mode in ("deep_cache", "max_stack"):
        pipe.cache_plan_fn = lambda n: CachePlan.every(n, 3, 0)
    return pipe, max_batch, requests, steps


def run(mode: str = "hero", requests=None, max_batch=None, depth: int = 2, tiny: bool = False,
        device=None) -> dict:
    """One mode's measurement; returns the JSON line's record."""
    from sonicdiffusionbayeslab_torch.serving import GenerateRequest, InferenceServer

    pipe, mb, nreq, steps = build_pipe(mode, tiny, device)
    max_batch = int(max_batch or mb)
    requests = int(requests or nreq)
    guidance = 5.0 if mode == "sd3" else 7.5
    srv = InferenceServer(pipe, max_batch=max_batch, max_wait_ms=25.0,
                          max_pending=max(256, 2 * requests), pipeline_depth=depth)
    try:
        # Warm pass: one full batch captures the graphs.
        warm = [srv.submit(GenerateRequest(PROMPT, num_inference_steps=steps,
                                           guidance_scale=guidance, seed=i))
                for i in range(max_batch)]
        t0 = time.perf_counter()
        for f in warm:
            f.result(timeout=3600)
        warm_s = time.perf_counter() - t0
        waited = srv.finisher_wait_s
        t0 = time.perf_counter()
        futs = [srv.submit(GenerateRequest(PROMPT, num_inference_steps=steps,
                                           guidance_scale=guidance, seed=1000 + i))
                for i in range(requests)]
        for f in futs:
            img = f.result(timeout=3600)["image"]
        elapsed = time.perf_counter() - t0
        if not np.isfinite(np.asarray(img, np.float32)).all():
            raise AssertionError("non-finite image")
    finally:
        srv.shutdown(drain=False)
    return {
        "metric": f"serve_{mode}",
        "value": round(requests / elapsed * 3600.0, 1),
        "unit": "images/hour e2e",
        "requests": requests,
        "max_batch": max_batch,
        "pipeline_depth": depth,
        "steps": steps,
        "elapsed_s": round(elapsed, 2),
        "warm_pass_s": round(warm_s, 1),
        "batches": srv.stats["batches"],
        "images_per_hour": requests / elapsed * 3600.0,
        "finisher_wait_s": srv.finisher_wait_s - waited,
        "captures": sum(pipe.engine.graphed_unet.captures.values()),
        "device": str(pipe.device),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="serving throughput of the PyTorch port")
    p.add_argument("mode", nargs="?", default="hero", choices=MODES)
    p.add_argument("--requests", type=int, default=None, help="measured requests")
    p.add_argument("--max_batch", type=int, default=None)
    p.add_argument("--depth", type=int, default=2, help="pipeline_depth")
    p.add_argument("--tiny", action="store_true", help="tiny random models (CPU smoke)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    rec = run(args.mode, args.requests, args.max_batch, args.depth, args.tiny, args.device)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
