"""The ``offline`` traffic kind: a closed loop of whole pipeline calls.

Each call takes ``batch`` captions drawn from the seed (without
replacement within a call) and a call seed drawn from it too, runs the
configuration's pipeline (``StableDiffusionModel.__call__`` or
``StableDiffusionXLModel.__call__``) with the mix's steps, guidance,
negative prompt and ``unet_microbatch``, rounds the images to uint8 on the
device (``serving/batcher.py::quantize_uint8``) and copies them to the
host.  Set-up builds the pipeline, loads the benchmark's weights and runs
one call of the same shapes; the window then starts calls until
``seconds`` have passed and counts whole calls.  After the window the
program is freed, and the plain reference recomputes a sample of the
window's images (the last call's first and last rows and more drawn from
the seed) from the same prompts, seeds and weights.

Mix parameters (``portbench/traffic/<mix>.json``): ``batch``, ``steps``,
``guidance``, ``negative_prompt``, ``unet_microbatch``, ``captions`` (a
file under ``portbench/data``), ``check_images`` (how many images the
reference recomputes), ``trace_seconds`` (how much of the window a
``--trace 1`` run profiles).
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from portbench.weights import stream_seed

ROOT = Path(__file__).resolve().parents[1]
SPAN = "portbench.call"
# A pixel channel this many levels off the reference counts against the
# image: bf16 rounding moves a few in ten thousand that far, int8 some in a hundred.
GAP_LEVELS = 8
WARM_CALL = 1 << 32  # the set-up call's index, apart from the window's


class CallPlan:
    """Call ``k``'s prompts and seed, from the run's seed alone."""

    def __init__(self, seed: int, captions: Sequence[str], batch: int):
        self.seed, self.captions, self.batch = seed, list(captions), int(batch)

    def __call__(self, k: int) -> Tuple[List[str], int]:
        rng = np.random.default_rng(stream_seed(self.seed, 0xCA11, k))
        idx = rng.choice(len(self.captions), size=self.batch, replace=False)
        return [self.captions[i] for i in idx], stream_seed(self.seed, 0x5EED, k)


def load_captions(name: str) -> List[str]:
    with open(ROOT / "data" / name, encoding="utf-8") as f:
        d = json.load(f)
    return [d[k] for k in sorted(d)]


def build_pipeline(config: Dict, device: str):
    """The configuration's pipeline of the port, its weights still the
    program's own initial ones."""
    from sonicdiffusionbayeslab_torch.models import pipelines

    p = config["pipeline"]
    cls = getattr(pipelines, p["class"])
    return cls(image_size=int(p["image_size"]), dtype=p["dtype"], device=device,
               **p.get("program_kwargs", {}))


def load_program_weights(pipe, config: Dict, weights: Dict[str, Dict]) -> None:
    """Load the benchmark's weights into the pipeline's engine (strict, so
    every name and shape must match), and check each attention's heads."""
    from portbench.reference.sample import build_nets
    from portbench.weights import program_state

    pipe.engine.load_state_dicts({name: program_state(sd) for name, sd in weights.items()})
    check_heads(pipe, build_nets(config, device="meta"))


def check_heads(pipe, models) -> None:
    """Raise where an attention of the program has another number of heads
    than the reference's module of the same name."""
    from portbench.reference import nets

    for name, ref in models.items():
        prog = dict(getattr(pipe.engine, name).named_modules())
        for mname, m in ref.named_modules():
            if isinstance(m, nets.Attention) and not isinstance(m, nets.VAEAttention):
                got = getattr(prog.get(mname), "num_heads", None)
                if got != m.heads:
                    raise ValueError(f"{name}.{mname}: the program has {got} heads, "
                                     f"the configuration {m.heads}")


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def synchronize(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def timed_call(pipe, plan: CallPlan, k: int, mix: Dict, device: str):
    """(uint8 images [B, H, W, 3] on the host, the call's record)."""
    from torch.profiler import record_function

    from sonicdiffusionbayeslab_torch.serving.batcher import quantize_uint8

    prompts, call_seed = plan(k)
    with record_function(SPAN):
        t0 = time.perf_counter()
        images, loop_s, _ = pipe(prompts, num_inference_steps=int(mix["steps"]),
                                 guidance_scale=float(mix["guidance"]), seed=call_seed,
                                 negative_prompt=[mix["negative_prompt"]] * len(prompts),
                                 unet_microbatch=int(mix["unet_microbatch"]),
                                 output_type="device")
        host = quantize_uint8(images).cpu()
        t1 = time.perf_counter()
    return host.numpy(), {"k": k, "t0": t0, "t1": t1, "images": len(prompts),
                          "loop_s": float(loop_s)}


def sample_checks(seed: int, calls: List[Dict], batch: int, n: int) -> List[Tuple[int, int]]:
    """(call k, row) pairs the reference recomputes: the last call's first
    and last rows, then others drawn from the seed over all the window's
    calls."""
    last = calls[-1]["k"]
    picks = [(last, 0), (last, batch - 1)][:max(n, 1)]
    pool = [(c["k"], r) for c in calls for r in range(batch) if (c["k"], r) not in picks]
    rng = np.random.default_rng(stream_seed(seed, 0xC4EC))
    extra = max(0, n - len(picks))
    for i in rng.choice(len(pool), size=min(extra, len(pool)), replace=False):
        picks.append(pool[int(i)])
    return picks


def reference_images(config: Dict, seed: int, device: str, plan: CallPlan, mix: Dict,
                     picks: List[Tuple[int, int]]) -> Dict[Tuple[int, int], np.ndarray]:
    """{(k, row): the reference's image [H, W, 3] in [0, 1]} for ``picks``,
    one call's rows at a time."""
    import torch

    from portbench.reference.sample import Pipeline, build_nets, fp32_exact
    from portbench.weights import make_weights

    dtype = getattr(torch, config["pipeline"]["dtype"])
    models = build_nets(config, device="meta")
    for name, sd in make_weights(config, seed, device, dtype).items():
        models[name].load_state_dict({k: v.float() for k, v in sd.items()}, strict=True,
                                     assign=True)
        models[name].eval()
    ref = Pipeline(config, models)
    out = {}
    with fp32_exact():
        for k in sorted({k for k, _ in picks}):
            rows = [r for kk, r in picks if kk == k]
            prompts, call_seed = plan(k)
            imgs = ref.images([prompts[r] for r in rows], call_seed, rows, int(mix["steps"]),
                              float(mix["guidance"]), mix["negative_prompt"])
            for r, img in zip(rows, imgs):
                out[(k, r)] = img.cpu().numpy()
    del models, ref
    return out


def image_gaps(program: Dict[Tuple[int, int], np.ndarray],
               reference: Dict[Tuple[int, int], np.ndarray]) -> Dict[str, float]:
    """The gaps |program - 255 * reference| in 8-bit levels of each image:
    ``worst_share_ge8``, the largest share over the images of pixel
    channels whose gap reaches GAP_LEVELS (in %), the number compared;
    ``worst_image_mae`` and ``mean_image_mae``, the largest and the mean
    of the images' mean gaps, printed beside it."""
    share, mae = [], []
    for key in reference:
        gap = np.abs(program[key].astype(np.float64) - 255.0 * reference[key])
        share.append(100.0 * float((gap >= GAP_LEVELS).mean()))
        mae.append(float(gap.mean()))
    return {"worst_share_ge8": max(share), "worst_image_mae": max(mae),
            "mean_image_mae": float(np.mean(mae))}


def run(spec: Dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> Dict:
    import torch

    from portbench.record import Record
    from portbench.trace import read as read_trace
    from portbench.weights import make_weights

    config, mix, cell = spec["config"], spec["mix"], spec["cell"]
    batch = int(mix["batch"])
    dtype = getattr(torch, config["pipeline"]["dtype"])
    pipe = build_pipeline(config, device)
    load_program_weights(pipe, config, make_weights(config, seed, device, dtype))
    plan = CallPlan(seed, load_captions(mix["captions"]), batch)
    timed_call(pipe, plan, WARM_CALL, mix, device)  # warm: the window's shapes, graph capture
    synchronize(torch, device)
    setup_s = time.perf_counter() - t_start

    record = Record()
    images: Dict[int, np.ndarray] = {}
    prof = None
    if trace:  # a traced run's window is the profiled stretch
        from torch.profiler import ProfilerActivity, profile

        seconds = min(seconds, float(mix.get("trace_seconds", seconds)))
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    w0 = time.perf_counter()
    k = 0
    while time.perf_counter() - w0 < seconds:
        imgs, rec = timed_call(pipe, plan, k, mix, device)
        rec["traced"] = trace
        images[k] = imgs
        record.calls.append(rec)
        k += 1
    if prof is not None:
        prof.__exit__(None, None, None)
        record.trace = read_trace(prof, SPAN)
    calls = record.calls
    record.window_s = calls[-1]["t1"] - calls[0]["t0"]
    n_images = sum(c["images"] for c in calls)
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    card = power_limit() if device == "cuda" else "cpu"
    print(f"portbench: {len(calls)} calls, {n_images} images in {record.window_s:.4f} s; "
          f"set-up {setup_s:.4f} s; card {card}", file=sys.stderr, flush=True)
    if record.trace is not None:
        print(f"portbench: top kernels {json.dumps(record.trace.top_kernels())}",
              file=sys.stderr, flush=True)

    del pipe
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    if trace:
        from portbench.reference.census import offline_call_census

        flops, parts = offline_call_census(config, batch, int(mix["steps"]),
                                           int(mix["unet_microbatch"]))
        record.work = {"flops_per_image": flops,
                       "parts": {"unet": parts[0], "vae": parts[1]}}
    picks = sample_checks(seed, calls, batch, int(mix["check_images"]))
    t_ref = time.perf_counter()
    ref = reference_images(config, seed, device, plan, mix, picks)
    gaps = image_gaps({key: images[key[0]][key[1]] for key in picks}, ref)
    print(f"portbench: reference of {len(picks)} images in {time.perf_counter() - t_ref:.2f} s; "
          f"gaps {json.dumps(gaps)}", file=sys.stderr, flush=True)
    limits = cell["limits"]
    checks = [{"name": name, "value": gaps[name], "limit": limits[name],
               "ok": bool(gaps[name] <= limits[name])} for name in sorted(limits)]
    return {"end_to_end": {"images_per_s": n_images / record.window_s, "setup_s": setup_s},
            "record": record, "checks": checks, "attempted": n_images, "failed": 0,
            "memory_peak_bytes": memory_peak}
