"""The ``serve`` traffic kind: an open loop of one-image requests into
``serving/batcher.py::InferenceServer``.

The arrivals are Poisson at the mix's ``rate``: the window's
``round(rate * seconds)`` gaps are the exponential distribution's
quantiles, in an order drawn from the mix's ``arrival_seed``, so every
run offers the same load at the same times (the order of the gaps moves a
tail by some 20% from one order to another).  Each request carries a
caption and a seed of its own, drawn from the run's seed.  The harness's thread submits each
request at its due time; a request is timed from that due time (not from
its submission) to its result, so a stall of the generator or of the
server counts against every request behind it, and the generator's own
lateness is printed.  Set-up builds the pipeline, loads the benchmark's
weights, starts the server and serves one full batch (the graphs'
capture).  After the window every request due in it is waited for (at
most ``drain_s`` past the close); one that fails or never comes counts as
missing.  The plain reference then recomputes a sample of the served
images (the last request's and more drawn from the seed).

Mix parameters (``portbench/traffic/<mix>.json``): ``rate`` (requests/s),
``arrival_seed``, ``max_batch``, ``max_wait_ms``, ``pipeline_depth``, ``steps``,
``guidance``, ``negative_prompt``, ``captions``, ``check_images``,
``drain_s``, ``trace_seconds``.
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time
from typing import Dict, List

import numpy as np

from portbench.weights import stream_seed

SPAN = "portbench.window"
SUBMIT = "portbench.submit"
WARM = 1 << 32  # the set-up batch's request indices, apart from the window's


def arrivals(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of ``round(rate * seconds)``
    requests: the first at 0, then the exponential gaps' quantiles at
    (j + 1/2) / n in an order drawn from ``seed``."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    rng = np.random.default_rng(stream_seed(seed, 0xA881))
    return np.concatenate([[0.0], np.cumsum(rng.permutation(gaps))[:-1]])


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile (0-100) with linear interpolation between
    order statistics (numpy's default); a missing request is +inf, and a
    percentile that reaches one is +inf (numpy would give nan there)."""
    v = sorted(values)
    k = (len(v) - 1) * q / 100.0
    lo = math.floor(k)
    hi, t = min(lo + 1, len(v) - 1), k - lo
    if t == 0 or v[hi] == v[lo]:
        return float(v[lo])
    if math.isinf(v[hi]):
        return math.inf
    return float(v[lo] + (v[hi] - v[lo]) * t)


class Requests:
    """Request ``j``'s caption and seed, from the run's seed alone."""

    def __init__(self, seed: int, captions: List[str]):
        self.seed, self.captions = seed, captions

    def __call__(self, j: int):
        rng = np.random.default_rng(stream_seed(self.seed, 0x4E0, j))
        return self.captions[int(rng.integers(len(self.captions)))], int(rng.integers(2**30))


def start_server(spec: Dict, seed: int, device: str):
    """(pipeline, server, requests) with the benchmark's weights, after one
    full batch of set-up requests."""
    import torch

    from portbench.traffic import offline
    from portbench.weights import make_weights
    from sonicdiffusionbayeslab_torch.serving.batcher import InferenceServer

    config, mix = spec["config"], spec["mix"]
    dtype = getattr(torch, config["pipeline"]["dtype"])
    pipe = offline.build_pipeline(config, device)
    offline.load_program_weights(pipe, config, make_weights(config, seed, device, dtype))
    server = InferenceServer(pipe, max_batch=int(mix["max_batch"]),
                             max_wait_ms=float(mix["max_wait_ms"]),
                             pipeline_depth=int(mix["pipeline_depth"]))
    requests = Requests(seed, offline.load_captions(mix["captions"]))
    warm = [server.submit(request(mix, requests, WARM + i)) for i in range(int(mix["max_batch"]))]
    for f in warm:
        f.result(timeout=600)
    offline.synchronize(torch, device)
    return pipe, server, requests


def request(mix: Dict, requests: Requests, j: int):
    from sonicdiffusionbayeslab_torch.serving.batcher import GenerateRequest

    prompt, rseed = requests(j)
    return GenerateRequest(prompt=prompt, num_inference_steps=int(mix["steps"]),
                           guidance_scale=float(mix["guidance"]),
                           negative_prompt=mix["negative_prompt"], seed=rseed)


def window(server, requests: Requests, mix: Dict, due: np.ndarray, device: str) -> Dict:
    """Submit request j at ``due[j]`` s after the start, wait for every
    one (``drain_s`` past the close at most) and return the latencies
    (inf: missing), the generator's lateness, the window's stats and the
    close's and the start's clocks."""
    import torch
    from torch.profiler import record_function

    from portbench.traffic import offline

    n = len(due)
    done = [math.inf] * n
    futures: List = [None] * n
    late = [0.0] * n
    stats0 = dict(server.stats)

    def finished(j):
        def callback(fut):
            if fut.exception() is None:
                done[j] = time.perf_counter()
        return callback

    with record_function(SPAN):
        w0 = time.perf_counter()
        for j in range(n):
            wait = w0 + due[j] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            with record_function(SUBMIT):
                late[j] = time.perf_counter() - (w0 + due[j])
                futures[j] = server.submit(request(mix, requests, j))
                futures[j].add_done_callback(finished(j))
        close = time.perf_counter()
        for f in futures:
            try:
                f.result(timeout=max(0.1, close + float(mix["drain_s"]) - time.perf_counter()))
            except Exception:  # a request that fails or never comes counts as missing
                pass
        offline.synchronize(torch, device)
    stats = {k: server.stats[k] - stats0[k] for k in ("images", "batches", "errors")}
    return {"latency": [d - (w0 + t) for d, t in zip(done, due)], "late": late,
            "stats": stats, "w0": w0, "close": close, "futures": futures}


def run(spec: Dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> Dict:
    import torch

    from portbench.record import Record
    from portbench.trace import read as read_trace
    from portbench.traffic import offline

    config, mix, cell = spec["config"], spec["mix"], spec["cell"]
    pipe, server, requests = start_server(spec, seed, device)
    setup_s = time.perf_counter() - t_start

    if trace:
        seconds = min(seconds, float(mix.get("trace_seconds", seconds)))
    due = arrivals(int(mix["arrival_seed"]), float(mix["rate"]), seconds)
    n = len(due)
    record = Record()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    w = window(server, requests, mix, due, device)
    if prof is not None:
        prof.__exit__(None, None, None)
        record.trace = read_trace(prof, SPAN)
    server.shutdown(wait=True)
    latency, stats = w["latency"], w["stats"]
    ok = [j for j in range(n) if math.isfinite(latency[j])]
    record.calls = [{"t0": w["w0"] + due[j], "t1": w["w0"] + due[j] + latency[j], "images": 1,
                     "traced": trace} for j in ok]
    record.window_s = w["close"] - w["w0"]
    record.counters.update(latency=latency, max_batch=int(mix["max_batch"]), **stats)
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    card = offline.power_limit() if device == "cuda" else "cpu"
    print(f"portbench: {n} requests due in {seconds:.1f} s at {mix['rate']}/s, {len(ok)} served "
          f"in {stats['batches']} batches; the generator late by p50 "
          f"{percentile(w['late'], 50):.6f} s, max {max(w['late']):.6f} s; set-up "
          f"{setup_s:.4f} s; card {card}", file=sys.stderr, flush=True)

    images = {j: w["futures"][j].result()["image"] for j in ok}
    del pipe, server, w
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng(stream_seed(seed, 0xC4EC))
    picks = ([ok[-1]] + [int(j) for j in rng.choice(ok[:-1], size=min(
        int(mix["check_images"]) - 1, len(ok) - 1), replace=False)]) if ok else []
    gaps = {name: math.inf for name in cell["limits"]}
    if picks:
        gaps = offline.image_gaps({j: images[j] for j in picks},
                                  served_reference(config, seed, device, mix, requests, picks))
    print(f"portbench: reference of {len(picks)} images; gaps {json.dumps(gaps)}",
          file=sys.stderr, flush=True)
    limits = cell["limits"]
    checks = [{"name": name, "value": gaps[name], "limit": limits[name],
               "ok": bool(gaps[name] <= limits[name])} for name in sorted(limits)]
    return {"end_to_end": {"request_p95_s": percentile(latency, 95), "setup_s": setup_s},
            "record": record, "checks": checks, "attempted": n, "failed": n - len(ok),
            "memory_peak_bytes": memory_peak}


def sweep(spec: Dict, seed: int, rates: List[float], seconds: float, device: str = "cuda"):
    """Yield, for each offered rate, the served rate, the latencies' p50
    and p95, the batches' fill and whether the backlog grew (the last
    tenth of the requests waited longer than the first tenth by more
    than a batch's time), from one server in one process."""
    pipe, server, requests = start_server(spec, seed, device)
    mix = spec["mix"]
    for rate in rates:
        due = arrivals(stream_seed(int(mix["arrival_seed"]), int(rate * 1000)), rate, seconds)
        w = window(server, requests, dict(mix, rate=rate), due, device)
        lat = w["latency"]
        tenth = max(1, len(lat) // 10)
        served = sum(math.isfinite(x) for x in lat)
        yield {"rate": rate, "requests": len(lat), "served": served,
               "served_per_s": served / (max(w["w0"] + due[j] + lat[j] for j in range(len(lat))
                                             if math.isfinite(lat[j])) - w["w0"]),
               "p50_s": percentile(lat, 50), "p95_s": percentile(lat, 95),
               "first_tenth_p50_s": percentile(lat[:tenth], 50),
               "last_tenth_p50_s": percentile(lat[-tenth:], 50),
               "batch_fill": 100.0 * w["stats"]["images"] / max(
                   1, w["stats"]["batches"] * int(mix["max_batch"])),
               "late_max_s": max(w["late"])}
    server.shutdown(wait=True)
    del pipe


def served_reference(config: Dict, seed: int, device: str, mix: Dict, requests: Requests,
                     picks: List[int]) -> Dict[int, np.ndarray]:
    """{j: the reference's image of request j}: its caption, and its own
    seed's stream (the batcher's sample index 2 * seed + 1 of seed 0)."""
    import torch

    from portbench.reference.sample import Pipeline, build_nets, fp32_exact
    from portbench.weights import make_weights

    dtype = getattr(torch, config["pipeline"]["dtype"])
    models = build_nets(config, device="meta")
    for name, sd in make_weights(config, seed, device, dtype).items():
        models[name].load_state_dict({k: v.float() for k, v in sd.items()}, strict=True,
                                     assign=True)
    ref = Pipeline(config, models)
    out = {}
    with fp32_exact():
        for j in picks:
            prompt, rseed = requests(j)
            img = ref.images([prompt], 0, [2 * rseed + 1], int(mix["steps"]),
                             float(mix["guidance"]), mix["negative_prompt"])
            out[j] = img[0].cpu().numpy()
    return out
