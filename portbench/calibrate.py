"""Readings that the limits of ``correct`` are set from, each one JSON
line on standard output, in one process.

An offline cell: the program's image gaps to the plain reference on each
of ``--seeds`` (one timed call each, the reference over the mix's
``check_images`` of it), then the same with the program's int8 path
switched on (``--control``: an ``ops/quant.py`` mode, the control of the
bf16 configuration) on ``--control-seeds``.

A train cell: the program's first steps against the reference's on each
of ``--seeds``; then, in the program's place, the reference computed with
int8 weights and activations (``--control int8``) and the reference with
half of each batch left out and the mean taken over the rest
(``--control half_batch``) on ``--control-seeds``.

A serving cell: a short window at the cell's rate a seed from one server,
the served images against the reference, the program's int8 path on for
the control.

    python3 -m portbench.calibrate --workload sd15-offline-b32 --seeds 1 2 3 \\
        --control int8_conv --control-seeds 4 5 6
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import run as harness
from portbench.traffic import offline


def readings(spec, seeds, mode, device="cuda"):
    """Yield one reading a seed: the image gaps of one timed call to the
    reference, with the program's int8 ``mode`` on where given."""
    import torch

    from portbench.weights import make_weights

    config, mix = spec["config"], spec["mix"]
    batch = int(mix["batch"])
    dtype = getattr(torch, config["pipeline"]["dtype"])
    pipe = offline.build_pipeline(config, device)
    if mode:
        pipe.engine.set_quant_mode(mode)
    captions = offline.load_captions(mix["captions"])
    for seed in seeds:
        offline.load_program_weights(pipe, config, make_weights(config, seed, device, dtype))
        plan = offline.CallPlan(seed, captions, batch)
        t0 = time.perf_counter()
        imgs, rec = offline.timed_call(pipe, plan, 0, mix, device)
        t1 = time.perf_counter()
        picks = offline.sample_checks(seed, [rec], batch, int(mix["check_images"]))
        ref = offline.reference_images(config, seed, device, plan, mix, picks)
        gaps = offline.image_gaps({key: imgs[key[1]] for key in picks}, ref)
        t2 = time.perf_counter()
        yield {"workload": spec["name"], "seed": seed, "mode": mode or "bf16", **gaps,
               "call_s": t1 - t0, "reference_s": t2 - t1}
        if device == "cuda":
            torch.cuda.empty_cache()
    del pipe


def fake_int8(stepper) -> None:
    """The control of a bf16 train step: every convolution's and linear's
    weight rounded to int8 a output channel (in place: the UNet is the
    control's own copy) and its input to int8 a row (a token, or a
    sample's map), straight through in the backward."""
    from torch import nn

    def quantize(x, dims):
        scale = x.detach().abs().amax(dim=dims, keepdim=True).clamp_min(1e-12) / 127.0
        return (x / scale).round().clamp(-127, 127) * scale

    def pre_hook(module, args):
        x = args[0]
        dims = (-1,) if isinstance(module, nn.Linear) else tuple(range(1, x.dim()))
        return (x + (quantize(x, dims) - x).detach(),) + tuple(args[1:])

    for m in stepper.unet.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            w = m.weight.data
            m.weight.data.copy_(quantize(w, tuple(range(1, w.dim()))))
            m.register_forward_pre_hook(pre_hook)


def half_batch(stepper) -> None:
    """A step that leaves out the second half of each batch and takes the
    mean over the rest."""
    whole = stepper.loss_and_grad

    def first_half(flat, batch):
        n = batch["latents"].shape[0] // 2
        return whole(flat, {k: v[:n] for k, v in batch.items()})

    stepper.loss_and_grad = first_half


TRAIN_CONTROLS = {"int8": fake_int8, "half_batch": half_batch}


def serve_readings(spec, seeds, mode, device="cuda", seconds=6.0):
    """Yield one reading a seed of a serving cell: a short window at the
    cell's rate from one server (the seed's weights loaded into its
    pipeline, ``mode`` its int8 path or None), the served images against
    the reference."""
    import numpy as np
    import torch

    from portbench.traffic import serve
    from portbench.weights import make_weights, stream_seed

    config, mix = spec["config"], spec["mix"]
    dtype = getattr(torch, config["pipeline"]["dtype"])
    pipe, server, _ = serve.start_server(spec, seeds[0], device)
    if mode:
        pipe.engine.set_quant_mode(mode)
    captions = offline.load_captions(mix["captions"])
    for seed in seeds:
        offline.load_program_weights(pipe, config, make_weights(config, seed, device, dtype))
        requests = serve.Requests(seed, captions)
        due = serve.arrivals(int(mix["arrival_seed"]), float(mix["rate"]), seconds)
        w = serve.window(server, requests, mix, due, device)
        ok = [j for j, x in enumerate(w["latency"]) if np.isfinite(x)]
        rng = np.random.default_rng(stream_seed(seed, 0xC4EC))
        picks = [ok[-1]] + [int(j) for j in rng.choice(ok[:-1], size=min(
            int(mix["check_images"]) - 1, len(ok) - 1), replace=False)]
        ref = serve.served_reference(config, seed, device, mix, requests, picks)
        gaps = offline.image_gaps({j: w["futures"][j].result()["image"] for j in picks}, ref)
        yield {"workload": spec["name"], "seed": seed, "mode": mode or "bf16", **gaps,
               "served": len(ok), "requests": len(due)}
        if device == "cuda":
            torch.cuda.empty_cache()
    server.shutdown(wait=True)
    del pipe


def train_readings(spec, seeds, mode, device="cuda"):
    """Yield one reading a seed of a train cell: the program's (``mode``
    None) or a control's (a name of TRAIN_CONTROLS) gaps to the reference."""
    import torch

    from portbench.traffic import train

    config, mix = spec["config"], spec["mix"]
    for seed in seeds:
        t0 = time.perf_counter()
        if mode is None:
            trainer, state = train.build_trainer(config, mix, seed, device)
            state, got = train.checked_program_steps(trainer, state, seed, mix, config, device)
            del trainer, state
        else:
            got = train.reference_steps(config, mix, seed, device, TRAIN_CONTROLS[mode])
        if device == "cuda":
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ref = train.reference_steps(config, mix, seed, device)
        gaps = train.compare(got, ref)
        yield {"workload": spec["name"], "seed": seed, "mode": mode or "bf16", **gaps,
               "program_s": t1 - t0, "reference_s": time.perf_counter() - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", default="int8_conv")
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    spec = harness.cell_spec(args.workload)
    read = {"train": train_readings, "serve": serve_readings}.get(spec["mix"]["kind"], readings)
    for seeds, mode in ((args.seeds, None), (args.control_seeds, args.control)):
        for reading in read(spec, seeds, mode):
            print(json.dumps(reading), flush=True)
    print(f"card: {offline.power_limit()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
