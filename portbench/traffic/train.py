"""The ``train`` traffic kind: LoRA fine-tuning steps through
``training/trainer.py::DiffusionTrainer.train_step``.

Every step takes a fresh batch made on the device from the seed and the
step's index: VAE-scaled latents and a text context (the cached-latent
fine-tune: encodes done beforehand, so neither tower runs), the noise and
the timesteps.  Set-up builds the engine, loads the benchmark's UNet
weights, gives the trainer the benchmark's adapters and takes the first
``checked_steps`` steps through the same call and feed as the window (the
warm-up); it keeps those steps' losses, the optimizer's first moment after
the first step and the adapters and their EMA after the last.  The window
then takes steps until ``seconds`` have passed, the device synchronised at
both ends.  After it, the program is freed and the plain reference
(``reference/train.py``) takes the same steps from the same weights,
adapters and batches.

Mix parameters (``portbench/traffic/<mix>.json``): ``batch``, ``train``
(the trainer's settings: learning_rate, weight_decay, betas, eps,
warmup_steps, max_grad_norm, prediction_type, snr_gamma, lora_rank,
ema_decay), ``checked_steps``, ``trace_seconds``.
"""

from __future__ import annotations

import gc
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SPAN = "portbench.step"
WINDOW = "portbench.window"  # the window's steps and its closing synchronise
MIN_LIVE = 1e-3  # a leaf whose first reference gradient is under this share of the median's


def feed(seed: int, k: int, batch: int, config: Dict, device) -> Dict:
    """Step ``k``'s batch: latents [B, h, w, C] and noise (standard normal),
    context [B, T, D] (standard normal), timesteps [B] uniform over the
    training schedule; the same for the program and the reference."""
    import torch

    from portbench.weights import stream_seed

    ucfg = config["modules"]["unet"]["config"]
    lat = int(config["pipeline"]["image_size"]) // 8
    T = config["modules"]["text"]["config"]["max_position_embeddings"]
    C = ucfg["in_channels"]
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 0xDA7A, k))
    kw = dict(generator=gen, device=device, dtype=torch.float32)
    return {"latents": torch.randn(batch, lat, lat, C, **kw),
            "context": torch.randn(batch, T, ucfg["cross_attention_dim"], **kw),
            "noise": torch.randn(batch, lat, lat, C, **kw),
            "timesteps": torch.randint(0, config["pipeline"]["scheduler"]["num_train_timesteps"],
                                       (batch,), generator=gen, device=device)}


def adapter_shapes(config: Dict) -> Dict[str, tuple]:
    from portbench.reference.sample import build_nets
    from portbench.reference.train import target_names

    unet = build_nets(config, device="meta")["unet"]
    params = dict(unet.named_parameters())
    return {n: tuple(params[f"{n}.weight"].shape) for n in target_names(unet)}


def first_moment(opt_state):
    """The Adam first moment {leaf: tensor} inside the optimizer's state."""
    if isinstance(opt_state, dict):
        if "mu" in opt_state:
            return opt_state["mu"]
        opt_state = list(opt_state.values())
    if isinstance(opt_state, (list, tuple)):
        for s in opt_state:
            found = first_moment(s)
            if found is not None:
                return found
    return None


def build_trainer(config: Dict, mix: Dict, seed: int, device: str):
    """(trainer, state): the port's engine with the benchmark's UNet weights,
    the trainer with the mix's settings, the benchmark's adapters."""
    import torch

    from portbench.traffic.offline import build_pipeline
    from portbench.weights import make_adapters, make_weights, program_state
    from sonicdiffusionbayeslab_torch.training.trainer import DiffusionTrainer, TrainConfig

    dtype = getattr(torch, config["pipeline"]["dtype"])
    engine = build_pipeline(config, device).engine
    unet_sd = make_weights(config, seed, device, dtype, names=("unet",))["unet"]
    engine.unet.load_state_dict(program_state(unet_sd), strict=True)
    engine.weights_changed()
    del unet_sd
    tr = dict(mix["train"])
    tr["betas"] = tuple(tr["betas"])
    trainer = DiffusionTrainer(engine, TrainConfig(**tr))
    adapters = make_adapters(adapter_shapes(config), tr["lora_rank"], seed, device)
    return trainer, trainer.init_state(adapters=adapters)


def program_step(trainer, state, seed: int, k: int, mix: Dict, config: Dict, device: str):
    from torch.profiler import record_function

    b = feed(seed, k, int(mix["batch"]), config, device)
    with record_function(SPAN):
        return trainer.train_step(state, b["latents"], b["context"], noise=b["noise"],
                                  timesteps=b["timesteps"])


def checked_program_steps(trainer, state, seed, mix, config, device):
    """Take the first ``checked_steps`` steps; keep what the reference
    compares: each step's loss, the first gradient as the optimizer got it
    (its first moment after one step over 1 - beta1), and the adapters and
    their EMA after the last step."""
    from sonicdiffusionbayeslab_torch.training.trainer import leaves

    b1 = float(mix["train"]["betas"][0])
    losses, out = [], {}
    for k in range(int(mix["checked_steps"])):
        state, m = program_step(trainer, state, seed, k, mix, config, device)
        losses.append(m["loss"])
        if k == 0:
            out["grad"] = {n: t.detach() / (1.0 - b1) for n, t in first_moment(
                state.opt_state).items()}
            out["grad"] = {n: t.clone() for n, t in out["grad"].items()}
    out["losses"] = [float(v) for v in losses]
    out["params"] = {n: t.detach().clone() for n, t in leaves(state.trainable).items()}
    out["ema"] = {n: t.detach().clone() for n, t in leaves(state.ema).items()}
    return state, out


def reference_steps(config: Dict, mix: Dict, seed: int, device: str, control=None) -> Dict:
    """The reference's ``checked_steps`` steps: losses, the first clipped
    gradient, adapters and EMA after the last (``control``: a function
    that changes the reference's UNet first, for the control runs)."""
    import torch

    from portbench.reference.sample import build_nets, fp32_exact
    from portbench.reference.train import LoRAStep
    from portbench.weights import make_adapters, make_weights

    dtype = getattr(torch, config["pipeline"]["dtype"])
    unet = build_nets(config, device="meta")["unet"]
    sd = make_weights(config, seed, device, dtype, names=("unet",))["unet"]
    unet.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True, assign=True)
    unet.requires_grad_(False).eval()
    del sd
    tr = mix["train"]
    adapters = make_adapters(adapter_shapes(config), tr["lora_rank"], seed, device)
    flat = {f"{n}/{ab}": t.clone() for n, d in adapters.items() for ab, t in d.items()}
    start = {k: v.clone() for k, v in flat.items()}
    stepper = LoRAStep(unet, config["pipeline"]["scheduler"], tr)
    if control is not None:
        control(stepper)
    losses, out = [], {"start": start}
    with fp32_exact():
        for k in range(int(mix["checked_steps"])):
            b = feed(seed, k, int(mix["batch"]), config, device)
            batch = {"latents": b["latents"].permute(0, 3, 1, 2),
                     "noise": b["noise"].permute(0, 3, 1, 2),
                     "context": b["context"], "timesteps": b["timesteps"]}
            loss, grads = stepper.step(flat, batch)
            losses.append(loss)
            if k == 0:
                out["grad"] = {n: g.clone() for n, g in grads.items()}
    out.update(losses=losses, params=flat, ema=stepper.ema)
    return out


def norm_gap(prog: Dict, ref: Dict, live: List[str]) -> float:
    """The worst leaf's |norm(prog) - norm(ref)| over max(norm(ref), the
    median leaf's norm), over the ``live`` leaves."""
    rn = {k: float(ref[k].norm()) for k in live}
    med = float(np.median(list(rn.values())))
    return max(abs(float(prog[k].norm()) - rn[k]) / max(rn[k], med) for k in live)


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers that decide ``correct``: ``loss_gap`` (the worst step's
    relative loss gap), ``grad_gap`` (the first gradient), ``change_gap``
    (the adapters' change over the checked steps) and ``ema_gap`` (the
    EMA's change), each by the worst live leaf."""
    gnorm = {k: float(g.norm()) for k, g in ref["grad"].items()}
    med = float(np.median(list(gnorm.values())))
    live = sorted(k for k, v in gnorm.items() if v >= MIN_LIVE * med)
    start = ref["start"]
    out = {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])),
           "grad_gap": norm_gap(prog["grad"], ref["grad"], live)}
    for name, key in (("change_gap", "params"), ("ema_gap", "ema")):
        out[name] = norm_gap({k: prog[key][k] - start[k] for k in live},
                             {k: ref[key][k] - start[k] for k in live}, live)
    out["live_leaves"] = len(live)
    out["leaves"] = len(gnorm)
    return out


def timed_steps(trainer, state, seed, k, seconds, mix, config, device, calls, traced=False):
    """Steps from index ``k`` until ``seconds`` have passed, the device
    synchronised at both ends, inside the span WINDOW; each step's host
    times go to ``calls``.  Returns (state, next k, start, end)."""
    import torch
    from torch.profiler import record_function

    from portbench.traffic.offline import synchronize

    synchronize(torch, device)
    with record_function(WINDOW):
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            t0 = time.perf_counter()
            state, _ = program_step(trainer, state, seed, k, mix, config, device)
            calls.append({"k": k, "t0": t0, "t1": time.perf_counter(),
                          "images": int(mix["batch"]), "traced": traced})
            k += 1
        synchronize(torch, device)
        w1 = time.perf_counter()
    return state, k, w0, w1


def run(spec: Dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> Dict:
    import torch

    from portbench.record import Record
    from portbench.trace import read as read_trace
    from portbench.traffic.offline import power_limit, synchronize

    config, mix, cell = spec["config"], spec["mix"], spec["cell"]
    batch = int(mix["batch"])
    trainer, state = build_trainer(config, mix, seed, device)
    state, prog = checked_program_steps(trainer, state, seed, mix, config, device)
    synchronize(torch, device)
    setup_s = time.perf_counter() - t_start

    record = Record()
    k = int(mix["checked_steps"])
    if trace:
        # The profiler slows the eager host path: the whole step's share of
        # the peak is timed over an untraced stretch first.
        seconds = min(seconds, float(mix.get("trace_seconds", seconds)))
        state, k, u0, u1 = timed_steps(trainer, state, seed, k, seconds, mix, config, device,
                                       [])
        record.counters.update(untraced_steps=k - int(mix["checked_steps"]),
                               untraced_s=u1 - u0)
    setup_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    state, k, w0, w1 = timed_steps(trainer, state, seed, k, seconds, mix, config, device,
                                   record.calls, trace)
    if prof is not None:
        prof.__exit__(None, None, None)
        record.trace = read_trace(prof, WINDOW)
    record.window_s = w1 - w0
    steps = len(record.calls)
    window_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    record.counters.update(steps=steps, window_peak_bytes=window_peak)
    memory_peak = max(setup_peak, window_peak)
    card = power_limit() if device == "cuda" else "cpu"
    print(f"portbench: {steps} steps of {batch} in {record.window_s:.4f} s; set-up "
          f"{setup_s:.4f} s; card {card}", file=sys.stderr, flush=True)
    if record.trace is not None:
        import json

        print(f"portbench: top kernels {json.dumps(record.trace.top_kernels())}",
              file=sys.stderr, flush=True)

    del trainer, state
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    if trace:
        from portbench.reference.census import train_step_census

        record.work = {"flops_per_step": train_step_census(config, mix)}
    t_ref = time.perf_counter()
    ref = reference_steps(config, mix, seed, device)
    gaps = compare(prog, ref)
    print(f"portbench: reference of {mix['checked_steps']} steps in "
          f"{time.perf_counter() - t_ref:.2f} s; gaps {gaps}", file=sys.stderr, flush=True)
    limits = cell["limits"]
    checks = [{"name": name, "value": gaps[name], "limit": limits[name],
               "ok": bool(gaps[name] <= limits[name])} for name in sorted(limits)]
    return {"end_to_end": {"train_images_per_s": steps * batch / record.window_s,
                           "setup_s": setup_s},
            "record": record, "checks": checks, "attempted": steps * batch, "failed": 0,
            "memory_peak_bytes": memory_peak}
