"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper GPU (sm_90a).

    python3 chip_smoke.py                      # every phase, as a CI gate
    python3 chip_smoke.py --profile --json smoke_report.json

Phases, in order; any failure raises, so the script exits non-zero and
prints no ``ok`` line:
  1. environment: Python/torch/CUDA versions, device capability 9.0, the
     card's name and power limit (nvidia-smi);
  2. build of the hand-written kernels (sonicdiffusionbayeslab_torch/ops/csrc),
     the counts of tensor-core (HGMMA, HMMA) and TMA-load (UTMALDG)
     instructions in the SASS of the bf16 and of the fp32 attention kernel
     (cuobjdump; each must have tensor-core instructions), and the
     GroupNorm kernel's launch plan at each main-path shape (channel range,
     cluster size, blocks, shared memory, clusters the card holds at once);
  3. each kernel against its plain PyTorch version, in bf16 and fp32 (TF32
     off), at every shape the main path's runs and the CLI runs of phases 6
     and 7 give it (found by running the SD-1.5 UNet, its DeepCache shallow
     call and the VAE decoder on the meta device), within stated
     tolerances, and in fp32 also at the tiny fp32 pipeline's shapes, at
     the CLIP score's vision-tower attention shapes (ViT-B/16 at the
     validate batches 8 and 4, and tiny, found on the meta device too) and
     at phase 9's metric towers' (BLIP ViT-L/16 8,197,197,16,64, its BERT
     cross-attention 8,35,197,12,64, ViT-L/14 8,257,257,16,64, and the tiny
     BLIP's): the fp32 attention kernel's paths; plus strided q/k/v views (bf16 goes to
     the wgmma/TMA attention kernel, fp32 to the split-TF32 mma.sync one);
     queries are scaled by 3 so that the softmax's running max moves
     across K/V tiles;
  4. device times at the whole-batch run's shapes (CUDA graphs timed with
     CUDA events), bf16 for every kernel and fp32 for attention (the
     split-TF32 kernel), and the fp32 kernel at the metric towers' shapes:
     the kernel, its plain version and one PyTorch library call as a
     yardstick, beside the bound from the work's bytes, products and
     exponentials (fp32 attention's products at the split-TF32 rate, with
     the plain-fp32 FMA-rate figure beside it);
  5. the main path: SD-1.5 text-to-image at full width on random bf16
     weights, 512x512, 20-step DPM-Solver++ (order 2), CFG 7.5, batch 2,
     through StableDiffusionModel, whole and with unet_microbatch=2, the
     UNet replayed from a CUDA graph as on every GPU (a tiny fp32 run on
     the card is held against the same run on the CPU first: it launches
     the fp32 attention kernel, whose launches it counts).  Each is run
     three times: first with the wrappers' launch counts set to 0 (they
     count the graph's warm-up and capture and the eager VAE decode, as a
     replay runs no wrapper), then timed, then under torch.profiler, whose
     trace counts every execution of each kernel on the card against the
     census.  One eager
     UNet call is held bit-equal to the graphed one, its wrapper counts
     and trace held to the census of one forward, and both are timed;
     with --profile, a torch.profiler breakdown of the denoising loop;
  6. the experiment CLI (sonicdiffusionbayeslab_torch.cli) on
     configs/smoke.yaml at SD-1.5 full width: bf16 512x512, one sweep point
     of 20 DPM-Solver++ steps, CFG 7.5, a batch of 8 prompts, x0 decodes
     of 2 samples, and the CLIP score on a random fp32 ViT-B/16 tower (its
     attention is the fp32 kernel's); its table, PNGs and each kernel's
     launches (wrappers over one run, a trace over a second) against the
     census, its wall clock, sec/image and the tower's device time;
  7. the reference's scheduler experiments through the CLI at SD-1.5 full
     width (bf16 512x512, batch 4, one sweep point each, CLIP score on the
     random ViT-B/16 tower): configs default_stable_diffusion (PNDM),
     ddim_config, deep_cache_config (interval 5, branch 0),
     consistency_model_config (LCM, 4 steps, guidance 0, a random rank-64
     kohya LoRA on every attention projection, written here and fused),
     two_schedulers_config, interliving_schedulers_config and
     skip_steps_config: each run's table row (label, nfe, time, clip_score),
     its 4 PNGs, one CUDA graph capture per UNet call variant and the
     kernels' launches against the census (the deep_cache run also by a
     trace); before them, a tiny fp32 DeepCache run (interval 2,
     unet_microbatch 2) and a tiny LCM run with given step noise on the card
     against the CPU, and the warm execution_time of 20-step DDIM and
     DeepCache (interval 5) at batch 2 at engine level, the memory their
     graphs keep reserved, and one full and one shallow UNet call's device
     time;
  8. the remaining samplers and Token Merging at SD-1.5 full width (bf16
     512x512, random weights): configs unipc_config (20 steps, bh2,
     corrector, order 2), tome_config (ratios 0.25 and 0.5 at 20 steps: two
     sweep points, two graph variants) and deep_cache_config with
     tome_ratio 0.5 (interval 5, branch 0) through the CLI at batch 4, each
     traced, checked as in phase 7 against the census at the merged
     attention shapes, with the memory the graphs keep reserved; through
     the pipeline at batch 2, CFG 7.5 (execution_time, median of 3 in
     turns): UniPC, DEIS, Euler and Euler-ancestral at 20 steps, Heun at 10 (19
     UNet calls), DPM++ with guidance_rescale 0.7, DPM++ with ToMe at 0.5
     and 0.25 beside plain DPM++, each run's wrapper launches against the
     census (with --profile, a torch.profiler breakdown of the ToMe 0.5
     loop); tiny fp32 ToMe (destinations given), Heun and Euler-ancestral
     (step noise given) runs on the card against the CPU; and the bf16
     attention kernel timed at ToMe's two 64x64 shapes;
  9. the reference's quality metrics: configs/ddim_config.yaml as shipped
     (clip_score on ViT-B/16, fid at feature 64 on FID-Inception,
     image_reward on BLIP) plus aesthetic_score (ViT-L/14 and the in-repo
     LAION head) through the CLI at SD-1.5 full width (bf16 512x512, 20 DDIM
     steps, batch 8), overriding only the image directory and its count, the
     batch, the checkpoints' paths and the sweep's length: a directory of 8
     real images (640x480 and 480x640 PNGs under the annotation file's .jpg
     names, each read back through the port's reader; a JPEG decoded or
     refused naming libjpeg), random full-width ImageReward (fp16) and
     pytorch-fid-layout Inception checkpoints written first; the run traced,
     its table (finite clip_score, fid, aesthetic_score; image_reward in
     [0, 1]), PNGs and launches against the census (108 fp32 attention
     launches a validate batch: 12 ViT-B/16, 2 x (24 BLIP ViT-L/16 + 12
     BERT cross-attention), 24 ViT-L/14; the masked BERT and causal text
     attentions take the plain path); FID at 2048 on the run's PNGs; the
     tiny and full ImageReward scorers, the ViT-L/14 tower and Inception at
     2048 card against CPU; each metric's device ms a validate batch;
 10. the card line, then one JSON ``kernels`` line (the fp32 attention
     kernel's entry is phase 9's metric towers: 108 launches a validate
     batch; each entry also lists its launches in each phase-7, phase-8
     and phase-9 run);
 11. the last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM, dense
# fp32 attention runs its products as split TF32: three TF32 tensor-core
# products (495 TFLOP/s dense) for each fp32-accurate one.
PEAK_TF32X3 = 495e12 / 3
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# Each kernel's symbol in a profiler trace: one kernel a call each.
SYMBOLS = {"attention": "flash_fwd_sm90_kernel", "group_norm": "gn_cluster_kernel",
           "attention_fp32": "flash_fwd_tf32x3_kernel"}
# bf16 attention is also held to max |err| <= ATTN_RMS_GATE * rms(plain)
# per shape: bf16 rounding of outputs up to ~4 stays near half of it, while
# a lost rescale of O or a P.V on the wrong K/V tile is many times the rms.
ATTN_RMS_GATE = 0.1
# Special-function unit rate for exp2: 16 per SM per clock (Hopper tuning
# guide's throughput table) x 132 SMs x ~1.83 GHz boost = ~3.9e12 a second.
PEAK_EXP = 3.9e12
BATCH, STEPS, GUIDANCE, SIZE = 2, 20, 7.5, 512
PROMPTS = ["a photograph of an astronaut riding a horse",
           "a lighthouse on a cliff at sunset, oil painting"]
# |kernel - plain| <= atol + rtol * |plain|, elementwise.  fp32: both sides
# compute in fp32 and differ in summation order and the kernel's fast exp;
# bf16: outputs round to bf16 (relative spacing 2^-8), and attention rounds
# P to bf16 before P.V at another point than the plain version (unnormalised
# in the kernel, normalised in the plain version).
TOL = {
    ("attention", torch.float32): (2e-5, 1e-4),
    ("attention", torch.bfloat16): (1e-2, 2e-2),
    ("group_norm", torch.float32): (1e-4, 1e-4),
    ("group_norm", torch.bfloat16): (2e-3, 1e-2),
}
# Keyed by kind, with "_fp32" for the fp32 attention kernel, which the bf16
# UNet and VAE never launch: the CLIP score's fp32 vision tower does (phase
# 6), and so does the fp32 pipeline (the tiny card-vs-CPU run of phase 5).
KERNELS = {
    "attention": dict(name="flash_attention_sm90", route="cuda", dtype="bfloat16",
                      source="sonicdiffusionbayeslab_torch/ops/csrc/flash_attention_sm90.cu",
                      replaces="sonicdiffusionbayeslab_tpu/ops/flash_attention.py:52"),
    "group_norm": dict(name="group_norm_silu", route="cuda", dtype="bfloat16",
                       source="sonicdiffusionbayeslab_torch/ops/csrc/groupnorm.cu",
                       replaces="sonicdiffusionbayeslab_tpu/ops/groupnorm.py:27"),
    "attention_fp32": dict(name="flash_attention_tf32x3", route="cuda", dtype="float32",
                           source="sonicdiffusionbayeslab_torch/ops/csrc/flash_attention.cu",
                           replaces="sonicdiffusionbayeslab_tpu/ops/flash_attention.py:52"),
}
MAIN = ("attention", "group_norm")  # the kernels of the bf16 main path
# The experiment CLI's run (phase 6): configs/smoke.yaml at full width.
CLI_BATCH, CLI_X0 = 8, 2
CLI_OVERRIDES = {"model.tiny": False, "model.image_size": SIZE, "dataset.image_size": SIZE,
                 "experiment_params.num_inference_steps": [STEPS],
                 "inference.batch_size": CLI_BATCH, "inference.batch_count": 1,
                 "inference.x0_samples": CLI_X0}
# Phase 7: the reference's scheduler experiments through the CLI at full
# width, one sweep point each, batch METHOD_BATCH: (config, its point,
# label, UNet evaluations, CFG factor of the UNet batch, x0 captured,
# DeepCache full steps or None).
METHOD_BATCH = 4
METHOD_OVERRIDES = {"model.tiny": False, "model.image_size": SIZE, "dataset.image_size": SIZE,
                    "inference.batch_size": METHOD_BATCH, "inference.batch_count": 1,
                    "inference.x0_samples": 1,
                    "quality_metrics": {"clip_score": {
                        "model_name_or_path": "openai/clip-vit-base-patch16"}}}
_P = "experiment_params."
METHOD_RUNS = [
    ("default_stable_diffusion", {_P + "num_inference_steps": [STEPS]}, "steps_20", 21, 2, True,
     None),
    ("ddim_config", {_P + "num_inference_steps": [STEPS]}, "steps_20", 20, 2, True, None),
    ("deep_cache_config", {_P + "cache_interval": [5], _P + "cache_branch_id": 0,
                           _P + "num_inference_steps": [STEPS]},
     "interval_5_steps_20", 20, 2, False, 4),
    ("consistency_model_config", {_P + "num_inference_steps": [4]}, "steps_4", 4, 1, False, None),
    ("two_schedulers_config", {_P + "num_inference_steps_first": [10],
                               _P + "num_inference_steps_second": [10],
                               _P + "num_step_switch": [3]},
     "first_10_second_10_switch_3", 11, 2, False, None),
    ("interliving_schedulers_config", {_P + "num_inference_steps": [STEPS],
                                       _P + "interliving_steps": [[2, 3]]},
     "steps_20_inter_2-3", 18, 2, False, None),
    ("skip_steps_config", {_P + "num_inference_steps": [STEPS], _P + "skip_steps": [[5]]},
     "steps_20_skip_5", 19, 2, True, None),
]
# Phase 8 through the CLI: (config, its points, [(label, ToMe ratio or None)]
# of the sweep, UNet evaluations a point, CFG factor, x0 captured,
# DeepCache full steps or None).
TOME_RATIOS = (0.25, 0.5)
SAMPLER_RUNS = [
    ("unipc_config", {_P + "num_inference_steps": [STEPS]}, [("steps_20", None)], 20, 2, True,
     None),
    ("tome_config", {_P + "tome_ratio": list(TOME_RATIOS), _P + "num_inference_steps": [STEPS]},
     [(f"ratio_{r}_steps_20", r) for r in TOME_RATIOS], 20, 2, True, None),
    ("deep_cache_config", {_P + "cache_interval": [5], _P + "cache_branch_id": 0,
                           _P + "num_inference_steps": [STEPS], _P + "tome_ratio": 0.5},
     [("interval_5_steps_20", 0.5)], 20, 2, False, 4),
]

# Phase 9: the reference's quality metrics through configs/ddim_config.yaml
# as shipped (clip_score, image_reward, fid at feature 64) plus
# aesthetic_score, with a real-image directory: SD-1.5 512^2, one sweep
# point of 20 DDIM steps, batch METRIC_BATCH.
METRIC_BATCH = 8
# Card against CPU (fp32, TF32 off, two images), |card - cpu| <= atol + rtol
# * |cpu|: unit-norm CLIP embeddings through 24 layers and Inception
# features through 94 convolutions summed in another order (cuDNN and the
# kernel against oneDNN and the plain path); ImageReward's z-scores, O(1)
# after 36 layers and an unnormalised head.
METRIC_TOL = {"clip_l14_embedding": (1e-4, 0.0), "inception_2048": (1e-4, 1e-4),
              "image_reward": (1e-3, 1e-3), "image_reward_tiny": (1e-4, 1e-4)}


_T0 = time.perf_counter()


def phase(name):
    """Opens a phase, with the script's wall clock so far."""
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def report_key(kind, dtype):
    """The report's key of ``kind`` at ``dtype``: "attention_fp32" etc."""
    return kind if dtype == torch.bfloat16 else f"{kind}_fp32"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ""


def cuda_ms(fn, reps=20) -> float:
    """Device milliseconds of one ``fn()``: ``reps`` calls captured in one
    CUDA graph, replayed between two CUDA events, median of 5 replays over
    ``reps``.  The graph takes the host's launch cost out, so a small
    kernel's time is its device time; inputs stay in L2 where they fit."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as graphs need
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(times)


def compare(kind, dtype, got, want, what):
    atol, rtol = TOL[(kind, dtype)]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (g - w).abs()
    excess = (err - (atol + rtol * w.abs())).max().item()
    max_abs = err.max().item()
    if excess > 0:
        raise AssertionError(f"{what}: max abs err {max_abs:.3e} exceeds atol {atol} + rtol {rtol}")
    if kind == "attention" and dtype == torch.bfloat16:
        rms = w.pow(2).mean().sqrt().item()
        if max_abs > ATTN_RMS_GATE * rms:
            raise AssertionError(f"{what}: max abs err {max_abs:.3e} exceeds "
                                 f"{ATTN_RMS_GATE} x rms {rms:.3e}")
    return max_abs


def print_gn_plans(shapes):
    """The GroupNorm launch plan of each main-path shape (bf16 and fp32), as
    the wrapper picks it on this card, with how many of its clusters the
    card holds at once (cudaOccupancyMaxActiveClusters); raises if a plan's
    cluster cannot be scheduled at all."""
    from sonicdiffusionbayeslab_torch.ops.groupnorm import card_active_clusters, card_plan

    for kind, shape in shapes:
        if kind != "group_norm":
            continue
        B, N, C, G = shape[:4]
        for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
            p = card_plan(B, N, C, G, code, True)
            active = card_active_clusters(code, p.vec, p.cluster, p.threads, p.smem)
            print(f"group_norm plan {str(dtype)[6:]} {B},{N},{C}: range {p.channels} channels "
                  f"({p.range_groups} groups), cluster {p.cluster}, {p.ctas} CTAs of "
                  f"{p.threads} threads ({p.row_lanes} row lanes x {p.channels // p.vec} "
                  f"slots of {p.vec}), {p.smem} B shared memory, rows "
                  f"{'cached' if p.cache else 're-read'}; {active} clusters active at once")
            if active < 1:
                raise AssertionError(f"group_norm {shape}: the plan's cluster cannot be scheduled")


def sass_counts(build):
    """Counts of tensor-core and TMA-load instructions in the SASS of each
    attention kernel (every instantiation), from cuobjdump; raises if either
    has no tensor-core instruction."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.build_library())],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    out = {}
    for kind in ("attention", "attention_fp32"):
        name = KERNELS[kind]["name"]
        counts = collections.Counter()
        for fn in sass.split("Function : ")[1:]:
            if SYMBOLS[kind] in fn.split("\n", 1)[0]:
                counts["functions"] += 1
                for op in ("HGMMA", "HMMA", "UTMALDG"):
                    counts[op] += len(re.findall(rf"\b{op}\.", fn))
        print(f"{name} SASS over {counts['functions']} instantiations: HGMMA {counts['HGMMA']}, "
              f"HMMA {counts['HMMA']}, UTMALDG {counts['UTMALDG']}")
        if not counts["functions"] or counts["HGMMA"] + counts["HMMA"] == 0:
            raise AssertionError(f"{name}: the kernel has no tensor-core instruction")
        out[kind] = dict(counts)
    if not out["attention_fp32"]["HMMA"]:
        raise AssertionError("the fp32 attention kernel has no HMMA (mma.sync) instruction")
    return out


# ------------------------------------------------------------------ census
def _kinds(calls):
    """{(kind, shape): n} -> {kind: n}."""
    out = collections.Counter()
    for (kind, _), n in calls.items():
        out[kind] += n
    return out


def module_census(unet_batch=None, vae_batch=None, tiny=False, shallow=False, tome=None):
    """{(kind, shape): launches} of one UNet call at ``unet_batch`` rows
    (DeepCache's shallow call at branch 0 with ``shallow``, else the plain
    or full call; with Token Merging at ratio ``tome``, whose merged
    self-attentions run at N = M = tokens - r) and one VAE decode of
    ``vae_batch`` latents, from the SD-1.5 UNet and VAE decoder (or, with
    ``tiny``, the tiny configs at StableDiffusionModel(tiny=True)'s 8x8
    latents) run on the meta device with the two kernel entry points
    replaced by shape recorders."""
    from sonicdiffusionbayeslab_torch.models import layers
    from sonicdiffusionbayeslab_torch.models.unet import UNet2DCondition, UNetConfig
    from sonicdiffusionbayeslab_torch.models.vae import AutoencoderKL, VAEConfig
    from sonicdiffusionbayeslab_torch.ops.attention import uses_kernel
    from sonicdiffusionbayeslab_torch.ops.groupnorm import resolve_groups
    from sonicdiffusionbayeslab_torch.ops.tome import TomeConfig

    calls = collections.Counter()

    def gn(x, weight, bias, groups=32, eps=1e-5, silu=True):
        B, C = x.shape[0], x.shape[-1]
        calls[("group_norm", (B, x.numel() // (B * C), C, resolve_groups(C, groups), eps, silu))] += 1
        return torch.empty_like(x)

    def attn(q, k, v, mask=None):
        if uses_kernel(q, mask):
            B, N, H, D = q.shape
            calls[("attention", (B, N, k.shape[1], H, D))] += 1
        return torch.empty_like(q)

    saved = layers.group_norm_silu, layers.dot_product_attention
    layers.group_norm_silu, layers.dot_product_attention = gn, attn
    unet_cfg, vae_cfg = (UNetConfig.tiny(), VAEConfig.tiny()) if tiny else (UNetConfig.sd15(),
                                                                            VAEConfig.sd15())
    lat = 8 if tiny else SIZE // 8
    try:
        with torch.device("meta"):
            if unet_batch:
                unet = UNet2DCondition(unet_cfg)
                b = unet_batch
                args = (torch.empty(b, lat, lat, 4), torch.empty(b),
                        torch.empty(b, 77, unet_cfg.cross_attention_dim))
                kw, dst = {}, None
                if tome:
                    kw["tome"] = cfg = TomeConfig(tome)
                    slots = unet.tome_slots(lat, lat, cfg, 0 if shallow else None)
                    dst = torch.zeros(len(slots), cfg.n_dst(lat, lat), dtype=torch.int64)
                if shallow:
                    unet(*args, torch.empty((b,) + unet.cache_shape(lat, lat, 0)), dst,
                         cache_branch_id=0, **kw)
                else:
                    unet(*args, None, dst, **kw)
            if vae_batch:
                AutoencoderKL(vae_cfg).decode(torch.empty(vae_batch, lat, lat, 4))
    finally:
        layers.group_norm_silu, layers.dot_product_attention = saved
    return calls


def census(unet_batch, tiny=False):
    """{(kind, shape): launches} of one main-path run whose UNet calls see
    ``unet_batch`` rows (STEPS UNet calls and one decode of BATCH latents),
    and the launches per UNet forward and per VAE decode."""
    unet_calls = module_census(unet_batch, tiny=tiny)
    vae_calls = module_census(vae_batch=BATCH, tiny=tiny)
    run = collections.Counter({k: STEPS * n for k, n in unet_calls.items()})
    run.update(vae_calls)
    return run, _kinds(unet_calls), _kinds(vae_calls)


def clip_census(batch, tiny=False):
    """{(kind, shape): launches} of the CLIP score's vision tower (ViT-B/16,
    or the tiny tower) on one validate batch, from ``CLIPVisionModel`` run
    on the meta device with the attention entry point replaced by a shape
    recorder; only unmasked calls the kernel takes are counted."""
    from sonicdiffusionbayeslab_torch.models import clip_text
    from sonicdiffusionbayeslab_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel
    from sonicdiffusionbayeslab_torch.ops.attention import uses_kernel

    calls = collections.Counter()

    def attn(q, k, v, mask=None):
        if uses_kernel(q, mask):
            B, N, H, D = q.shape
            calls[("attention", (B, N, k.shape[1], H, D))] += 1
        return torch.empty_like(q)

    cfg = CLIPVisionConfig.tiny() if tiny else CLIPVisionConfig()
    saved, clip_text.dot_product_attention = clip_text.dot_product_attention, attn
    try:
        with torch.device("meta"):
            CLIPVisionModel(cfg)(torch.empty(batch, 3, cfg.image_size, cfg.image_size))
    finally:
        clip_text.dot_product_attention = saved
    return calls


# ------------------------------------------------------------ inputs, work
def attn_inputs(shape, dtype, gen):
    """q, k, v with logits of standard deviation 3 (q scaled by 3)."""
    B, N, M, H, D = shape
    mk = lambda L, s=1: (torch.randn(B, L, H, D, generator=gen, device="cuda") * s).to(dtype)  # noqa: E731
    return mk(N, 3), mk(M), mk(M)


def gn_inputs(shape, dtype, gen):
    B, N, C = shape[:3]
    x = (torch.randn(B, N, C, generator=gen, device="cuda") * 3 + 1).to(dtype)
    w = (torch.randn(C, generator=gen, device="cuda") * 0.5 + 1).to(dtype)
    b = (torch.randn(C, generator=gen, device="cuda") * 0.5).to(dtype)
    return x, w, b


def bound(kind, shape, dtype):
    """(least ms, "operations" | "bytes") for the work at ``shape``: each
    input read once, each output written once, at HBM rate; operations at
    the peak rate for their type (attention's two products on the tensor
    cores, bf16 or split TF32 for fp32, and the special-function units for
    its B*H*N*M exponentials, whichever takes longer; plain fp32 for
    GroupNorm's ~10 operations per element)."""
    size = torch.tensor([], dtype=dtype).element_size()
    if kind == "attention":
        B, N, M, H, D = shape
        rate = PEAK_TF32X3 if dtype == torch.float32 else PEAK_FLOPS[dtype]
        t_ops = max(4 * B * H * N * M * D / rate, B * H * N * M / PEAK_EXP) * 1e3
        nbytes = (2 * B * N * H * D + 2 * B * M * H * D) * size
    else:
        B, N, C, _, _, silu = shape
        t_ops = (10 if silu else 6) * B * N * C / PEAK_FLOPS[torch.float32] * 1e3
        nbytes = (2 * B * N * C + 2 * C) * size
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def run_kernel(kind, shape, inputs):
    from sonicdiffusionbayeslab_torch.ops.attention import plain_attention
    from sonicdiffusionbayeslab_torch.ops.flash_attention import flash_attention
    from sonicdiffusionbayeslab_torch.ops.groupnorm import group_norm_silu, plain_group_norm

    if kind == "attention":
        q, k, v = inputs
        return (lambda: flash_attention(q, k, v)), (lambda: plain_attention(q, k, v))
    _, _, _, G, eps, silu = shape
    x, w, b = inputs
    return (lambda: group_norm_silu(x, w, b, G, eps, silu),
            lambda: plain_group_norm(x, w, b, G, eps, silu))


def library_call(kind, shape, inputs):
    """One PyTorch call computing the same function (yardstick only)."""
    import torch.nn.functional as F

    if kind == "attention":
        q, k, v = (t.transpose(1, 2) for t in inputs)
        return lambda: F.scaled_dot_product_attention(q, k, v)
    B, N, C, G, eps, silu = shape
    x, w, b = inputs
    xn = x.reshape(B, N, 1, C).permute(0, 3, 1, 2)  # NCHW view, channels_last strides
    if silu:
        return lambda: F.silu(F.group_norm(xn, G, w, b, eps))
    return lambda: F.group_norm(xn, G, w, b, eps)


def check_kernels(shapes, fp32_shapes, report):
    """Each kernel against its plain version at ``shapes`` in bf16 and fp32
    and, in fp32, at ``fp32_shapes`` ((kind, shape), label): the tiny fp32
    pipeline's, which the card-vs-CPU run of phase 5 launches, and the CLIP
    vision towers'; max errors into ``report["errs"]``."""
    from sonicdiffusionbayeslab_torch.ops.attention import plain_attention
    from sonicdiffusionbayeslab_torch.ops.flash_attention import flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        extra = fp32_shapes if dtype == torch.float32 else []
        for (kind, shape), label in [(s, "") for s in shapes] + extra:
            inputs = (attn_inputs if kind == "attention" else gn_inputs)(shape, dtype, gen)
            kern, plain = run_kernel(kind, shape, inputs)
            got = kern()
            torch.cuda.synchronize()
            err = compare(kind, dtype, got, plain(), f"{kind} {shape} {dtype}{label}")
            report["errs"][report_key(kind, dtype)].append(err)
            print(f"{kind} {str(dtype)[6:]} {shape}{label}: max abs err {err:.3e}")
            del inputs, got
        # Non-contiguous views of one fused [B, N, 3, H, D] projection with a
        # ragged N = M: the same bits as contiguous inputs.
        qkv = torch.randn(2, 1000, 3, 8, 40, generator=gen, device="cuda").to(dtype)
        q, k, v = qkv.unbind(2)
        q.mul_(3)
        got = flash_attention(q, k, v)
        if not torch.equal(got, flash_attention(q.contiguous(), k.contiguous(), v.contiguous())):
            raise AssertionError("attention: strided views differ from contiguous inputs")
        err = compare("attention", dtype, got, plain_attention(q, k, v), "strided attention")
        print(f"attention {str(dtype)[6:]} strided q/k/v views, N=M=1000: max abs err {err:.3e}")


def timing_row(kind, shape, dtype, path, launches, gen):
    """One kernel's timing row at ``shape``: the kernel, its plain version
    and the library call (``cuda_ms``), beside the bound; printed."""
    inputs = (attn_inputs if kind == "attention" else gn_inputs)(shape, dtype, gen)
    kern, plain = run_kernel(kind, shape, inputs)
    b_ms, b_by = bound(kind, shape, dtype)
    row = dict(kernel=kind, dtype=str(dtype)[6:], shape=list(shape), path=path,
               launches_per_run=launches,
               ms=cuda_ms(kern), plain_ms=cuda_ms(plain),
               library_ms=cuda_ms(library_call(kind, shape, inputs)),
               bound_ms=b_ms, bound_by=b_by)
    if kind == "attention" and dtype == torch.float32:
        B, N, M, H, D = shape
        row["bound_fma_ms"] = 4 * B * H * N * M * D / PEAK_FLOPS[torch.float32] * 1e3
    print("timing " + json.dumps(row), flush=True)
    return row


def time_kernels(shapes, run_counts, metric_counts, report):
    """Per-shape timing rows at the main path's shapes (``run_counts``
    launches a run) and, fp32 only, at the metric towers' (``metric_counts``
    launches a validate batch of phase 9), and totals (per-shape time x
    launches): bf16 into ``report[kind]``, fp32 at the UNet's shapes into
    ``report["attention_fp32_unet"]``, fp32 at the towers' into
    ``report["attention_fp32"]`` (the metrics path's).  fp32 attention's rows
    also give its products' time at the plain fp32 FMA rate
    (``bound_fma_ms``), the yardstick of the kernel it replaced."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    work = [(kind, shape, dtype, "unet", run_counts[(kind, shape)]) for kind, shape in shapes
            for dtype in ((torch.bfloat16, torch.float32) if kind == "attention"
                          else (torch.bfloat16,))]
    work += [(kind, shape, torch.float32, "metrics", n)
             for (kind, shape), n in sorted(metric_counts.items())]
    for kind, shape, dtype, path, launches in work:
        rows.append(timing_row(kind, shape, dtype, path, launches, gen))
    for r in rows:
        key = report_key(r["kernel"], getattr(torch, r["dtype"]))
        agg = report[key + "_unet" if key == "attention_fp32" and r["path"] == "unet" else key]
        for field in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_fma_ms"):
            agg[field] += r.get(field, 0.0) * r["launches_per_run"]
        agg["bound_by_ms"][r["bound_by"]] += r["bound_ms"] * r["launches_per_run"]
    return rows


# --------------------------------------------------------------- main path
def tiny_card_vs_cpu(per_unet, per_vae):
    """The tiny fp32 pipeline on the card (kernels) against the same weights
    and seed on the CPU (plain versions); returns the fp32 attention
    kernel's launches in the card's run (graph warm-up and capture, eager
    decode), which must be the tiny census's."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
    from sonicdiffusionbayeslab_torch.ops.flash_attention import flash_attention_tf32x3
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    cpu = StableDiffusionModel(tiny=True, dtype="float32", seed=0, device="cpu")
    card = StableDiffusionModel(tiny=True, dtype="float32", seed=0, device="cuda")
    card.engine.load_state_dicts({k: m.state_dict() for k, m in
                                  zip(("unet", "vae", "text"), cpu.engine.modules())})
    kw = dict(num_inference_steps=STEPS, guidance_scale=GUIDANCE, seed=29)
    a = cpu(["a lighthouse at dusk", "a red boat"], **kw)[0]
    flash_attention_tf32x3.launches = 0
    b = card(["a lighthouse at dusk", "a red boat"], **kw)[0]
    launches = flash_attention_tf32x3.launches
    err = float(np.abs(a - b).max())
    # fp32 both sides with TF32 off; 20 CFG-amplified steps of summation-order
    # differences (cuDNN vs oneDNN convs, kernels vs plain versions).
    print(f"tiny fp32 pipeline, card vs CPU: max abs image err {err:.3e} (tolerance 1e-3); "
          f"flash_attention_tf32x3 launches {launches}")
    if not err <= 1e-3:
        raise AssertionError("the tiny pipeline on the card disagrees with the CPU")
    want = (GraphedCall.WARMUP + 1) * per_unet["attention"] + per_vae["attention"]
    if launches != want or launches <= 0:
        raise AssertionError(f"the tiny fp32 pipeline launched the fp32 attention kernel "
                             f"{launches} times, expected {want}")
    return launches


def traced_launches(run):
    """``run()``'s result and the executions on the card of each kernel of
    ours (every key of SYMBOLS), by symbol, from a torch.profiler (CUPTI)
    trace of it: graph replays included, set-up excluded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # CUPTI has dropped the first kernels of work launched the moment
        # tracing started (an eager UNet forward lost its first 2 attention
        # and 4 GroupNorm executions); one traced kernel and a pause first.
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.1)
        out = run()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return out, {kind: sum(sym in n for n in names) for kind, sym in SYMBOLS.items()}


def wrapper_counts(reset=False):
    """Each kernel wrapper's launch count (every key of SYMBOLS)."""
    from sonicdiffusionbayeslab_torch.ops.flash_attention import (flash_attention_sm90,
                                                                   flash_attention_tf32x3)
    from sonicdiffusionbayeslab_torch.ops.groupnorm import group_norm_silu

    wrappers = {"attention": flash_attention_sm90, "group_norm": group_norm_silu,
                "attention_fp32": flash_attention_tf32x3}
    if reset:
        for w in wrappers.values():
            w.launches = 0
    return {kind: w.launches for kind, w in wrappers.items()}


def bf16_only(counts, what):
    """The MAIN kernels' counts of a bf16 run, which must not have launched
    the fp32 attention kernel."""
    if counts["attention_fp32"]:
        raise AssertionError(f"{what} launched the fp32 attention kernel "
                             f"{counts['attention_fp32']} times")
    return {kind: counts[kind] for kind in MAIN}


def check_images(imgs):
    import numpy as np

    if imgs.shape != (BATCH, SIZE, SIZE, 3) or not np.isfinite(imgs).all():
        raise AssertionError(f"bad images: shape {imgs.shape}")
    if imgs.min() < 0 or imgs.max() > 1:
        raise AssertionError("images outside [0, 1]")


def run_main_path(report, per_unet, per_vae, tiny_census, card, profile):
    import numpy as np

    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report["e2e"]["tiny_fp32_attention_launches"] = tiny_card_vs_cpu(*tiny_census)
    torch.backends.cudnn.allow_tf32 = True  # bf16 main path: TF32 is not used anyway

    t0 = time.perf_counter()
    model = StableDiffusionModel(image_size=SIZE, tiny=False, dtype="bfloat16", seed=0,
                                 device="cuda")
    torch.cuda.synchronize()
    report["e2e"]["init_s"] = time.perf_counter() - t0
    print(f"SD-1.5 random bf16 init on the card: {report['e2e']['init_s']:.2f} s")
    kw = dict(num_inference_steps=STEPS, guidance_scale=GUIDANCE, seed=29)

    images = {}
    for name, mb in (("whole_batch", None), ("microbatch_2", 2)):
        # The first run at this batch captures its UNet graph: the wrappers
        # launch each kernel in the two eager warm-up forwards and in the
        # captured one, then the replays run no wrapper; the VAE decodes
        # eagerly.  The run is also the warm-up of cuDNN/cuBLAS.
        wrapper_counts(reset=True)
        model(PROMPTS, unet_microbatch=mb, **kw)
        counts = bf16_only(wrapper_counts(), name)
        want = {k: (GraphedCall.WARMUP + 1) * per_unet[k] + per_vae[k] for k in MAIN}
        if counts != want or min(counts.values()) <= 0:
            raise AssertionError(f"{name}: wrapper launches {counts}, expected {want}")
        # The timed run.
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        imgs, exec_time, _ = model(PROMPTS, unet_microbatch=mb, **kw)
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        reserved_gb = torch.cuda.memory_reserved() / 1e9  # graph pools included
        check_images(imgs)
        images[name] = imgs
        # The same run again, traced: every kernel execution on the card is
        # the census of each UNet forward and of the decode.
        wrapper_counts(reset=True)
        (imgs_traced, _, _), traced = traced_launches(lambda: model(PROMPTS, unet_microbatch=mb, **kw))
        traced = bf16_only(traced, f"{name} (trace)")
        decode_counts = bf16_only(wrapper_counts(), name)
        print(f"main path {name} (unet_microbatch={mb}): execution_time {exec_time:.4f} s "
              f"({exec_time / BATCH:.4f} s/image, {3600 * BATCH / exec_time:.1f} images/hour, "
              f"denoising loop only); whole call {wall:.4f} s; peak memory {peak_gb:.2f} GB "
              f"allocated, {reserved_gb:.2f} GB reserved; "
              f"{card}; launches: first run's wrappers {counts}, traced run's kernel "
              f"executions {traced} and wrappers {decode_counts}")
        want = {k: STEPS * (mb or 1) * per_unet[k] + per_vae[k] for k in MAIN}
        if traced != want:
            raise AssertionError(f"{name}: traced kernel executions {traced}, expected {want}")
        if decode_counts != {k: per_vae[k] for k in MAIN}:
            raise AssertionError(f"{name}: a warm run's wrappers launched {decode_counts}, "
                                 f"expected the decode's {dict(per_vae)}")
        if not np.array_equal(imgs_traced, imgs):
            raise AssertionError(f"{name}: a second identical run gave other images")
        report["e2e"][name] = dict(execution_time_s=exec_time, sec_per_image=exec_time / BATCH,
                                   images_per_hour=3600 * BATCH / exec_time, call_s=wall,
                                   peak_gb=peak_gb, reserved_gb=reserved_gb,
                                   first_run_wrapper_launches=counts,
                                   traced_launches=traced)
        if name == "whole_batch":
            for kind in MAIN:
                report[kind].update(
                    launches=traced[kind], wrapper_launches=counts[kind],
                    launches_from="torch.profiler trace of a warm whole-batch run (graph "
                                  "replays run no wrapper); wrapper_launches: the wrappers' "
                                  "counts over the first whole-batch run (graph warm-up and "
                                  "capture, eager VAE decode)")
    # Chunking changes the batch of every conv and matmul, so cuDNN/cuBLAS
    # may pick other algorithms; bf16 over 20 steps differs by a few 1/255.
    diff = float(np.abs(images["whole_batch"] - images["microbatch_2"]).max())
    print(f"microbatch_2 vs whole_batch: max abs image diff {diff:.3e} (tolerance 5e-2)")
    if not diff <= 5e-2:
        raise AssertionError("microbatch_2 changed the images")
    report["e2e"]["microbatch_2_max_abs_diff"] = diff
    report["e2e"]["unet_forward"] = eager_vs_graphed_unet(model, per_unet)
    if profile:
        report["profile"] = profile_loop(model)


def eager_vs_graphed_unet(model, per_unet, reps=5):
    """One UNet forward at the whole batch's shapes, eager (``engine.unet``)
    and replayed (``engine.graphed_unet``): bit-equal outputs, the eager
    call's wrapper counts and trace equal to the census of one forward, and
    the wall clock of each (device synchronised), which shows the host cost
    the graph takes away."""
    eng = model.engine
    emb = eng.encode_prompts(model.tokenizer(PROMPTS))
    neg = eng.encode_prompts(model.tokenizer([""] * BATCH))
    embeds = torch.cat([neg, emb])  # as the sampler builds them
    gen = torch.Generator(device="cuda").manual_seed(3)
    lat = torch.randn(2 * BATCH, SIZE // 8, SIZE // 8, 4, generator=gen, device="cuda").to(eng.dtype)
    tb = torch.full((2 * BATCH,), 499.0, device="cuda")
    want = {k: per_unet[k] for k in MAIN}
    with torch.inference_mode():
        wrapper_counts(reset=True)
        eager, traced = traced_launches(lambda: eng.unet(lat, tb, embeds))
        traced = bf16_only(traced, "an eager UNet forward (trace)")
        counts = bf16_only(wrapper_counts(), "an eager UNet forward")
        if counts != want or traced != want:
            raise AssertionError(f"one eager UNet forward: wrapper launches {counts}, traced "
                                 f"{traced}, expected {want}")
        graphed = eng.graphed_unet(lat, tb, embeds)
        if not torch.equal(eager, graphed):
            raise AssertionError("the graphed UNet call differs from the eager one")
        out = {}
        for name, call in (("eager_ms", eng.unet), ("graphed_ms", eng.graphed_unet)):
            call(lat, tb, embeds)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                call(lat, tb, embeds)
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0) * 1e3 / reps
    print(f"one UNet forward at batch {2 * BATCH}: eager {out['eager_ms']:.2f} ms, graphed "
          f"{out['graphed_ms']:.2f} ms (wall clock, mean of {reps}); bit-equal; eager launches "
          f"{counts} (the census of one forward)")
    return out


def profile_loop(model, tome=None):
    """Device time by kernel group over one 20-step denoising loop (UNet
    forwards at the model batch, CFG combine, scheduler rows; no decode;
    with Token Merging at ratio ``tome``, whose sorts, gathers and scatters
    are a group of their own), from torch.profiler, per step, beside the
    loop's wall clock."""
    from torch.profiler import ProfilerActivity, profile

    eng = model.engine
    plan = model.build_plan(STEPS)
    emb = eng.encode_prompts(model.tokenizer(PROMPTS))
    neg = eng.encode_prompts(model.tokenizer([""] * BATCH))
    kw = dict(guidance_scale=GUIDANCE, latent_hw=(SIZE // 8, SIZE // 8), decode=False,
              tome=tome)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loop_s = eng.sample(plan, emb, neg, **kw).execution_time
    by_name = collections.Counter()
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if dev_us and e.key and not e.key.startswith(("aten::", "cuda", "Profiler")):
            by_name[e.key] += dev_us / 1e3 / STEPS
    groups = collections.Counter()
    for k, v in by_name.items():
        low = k.lower()
        if SYMBOLS["attention_fp32"] in k or SYMBOLS["attention"] in k:
            groups["flash_attention (ours)"] += v
        elif SYMBOLS["group_norm"] in k:
            groups["group_norm_silu (ours)"] += v
        elif "fprop" in low or "conv" in low:
            groups["convolutions (cuDNN)"] += v
        elif any(w in low for w in ("gemm", "nvjet", "cutlass", "cublas")):
            groups["matmuls (cuBLAS)"] += v
        elif "layer_norm" in low:
            groups["layer_norm"] += v
        elif tome and any(w in low for w in ("sort", "gather", "scatter", "indexselect",
                                                "index_select")):
            groups["tome sorts, gathers, scatters"] += v
        else:
            groups["elementwise and copies"] += v
    device_ms = sum(by_name.values())
    step_ms = loop_s * 1e3 / STEPS  # profiler on: the loop runs slower than unprofiled
    out = dict(step_wall_ms=step_ms, step_device_ms=device_ms,
               device_idle_share=max(0.0, 1 - device_ms / step_ms) if device_ms else None,
               groups_ms_per_step=dict(groups.most_common()),
               top_kernels_ms_per_step={k[:120]: v for k, v in by_name.most_common(12)})
    print(("profile" if tome is None else f"profile tome {tome}") + " " + json.dumps(out))
    if not device_ms:
        print("profile: torch.profiler reported no device time (not measured)")
    return out


def run_cli(report, per_unet, per_vae, clip_per_batch, card):
    """Phase 6: ``cli.run`` of configs/smoke.yaml at full width (CLI_OVERRIDES),
    in a temporary working directory, twice: first with the wrappers' counts
    set to 0 just before it and read just after, then under torch.profiler.
    Each run checks its table row, its PNGs and each kernel's launches
    against the census: the UNet's graph warm-up and capture (wrappers) or
    warm-up and replays (trace), one VAE decode of the batch and one x0
    decode a step, and the CLIP tower's launches for the one validate
    batch."""
    import csv

    import numpy as np

    from sonicdiffusionbayeslab_torch import cli
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    repo = Path(__file__).resolve().parent
    config = str(repo / "configs" / "smoke.yaml")
    decodes = 1 + STEPS
    want_wrappers = {k: (GraphedCall.WARMUP + 1) * per_unet[k] + decodes * per_vae[k] for k in MAIN}
    want_traced = {k: (GraphedCall.WARMUP + STEPS) * per_unet[k] + decodes * per_vae[k]
                   for k in MAIN}
    want_wrappers["attention_fp32"] = want_traced["attention_fp32"] = clip_per_batch
    label = f"steps_{STEPS}"
    out = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="sdbl_cli_") as tmp:
        os.chdir(tmp)
        try:
            for run in ("first", "traced"):
                overrides = {**CLI_OVERRIDES, "logger.run_id": run,
                             "dataset.prompts": str(repo / "data" / "dataset" / "prompts_sample.json")}
                wrapper_counts(reset=True)
                t0 = time.perf_counter()
                if run == "first":
                    metrics, traced = cli.run(config, overrides), None
                else:
                    metrics, traced = traced_launches(lambda: cli.run(config, overrides))
                wall = time.perf_counter() - t0
                counts = wrapper_counts()
                with open(Path(tmp) / "outputs" / run / "tables" / "final.tsv") as f:
                    rows = list(csv.DictReader(f, delimiter="\t"))
                pngs = sorted((Path(tmp) / "outputs" / "smoke" / label).glob("*.png"))
                sizes = {tuple(np.frombuffer(p.read_bytes()[16:24], ">u4")) for p in pngs}
                sec_img, score = float(rows[0]["time"]), float(rows[0]["clip_score"])
                print(f"experiment CLI {run} run (configs/smoke.yaml: SD-1.5 bf16 {SIZE}x{SIZE}, "
                      f"{STEPS}-step DPM-Solver++ order 2, CFG {GUIDANCE}, batch {CLI_BATCH}, "
                      f"x0 decodes of {CLI_X0}, CLIP score on a random fp32 ViT-B/16): whole CLI "
                      f"{wall:.3f} s, sweep {sec_img:.5f} s/image (the denoising loop, graph "
                      f"capture included), clip_score {score:.4f}; {card}; launches: wrappers "
                      f"{counts}, trace {traced}", flush=True)
                if len(rows) != 1 or rows[0]["exp"] != label or rows[0]["nfe"] != str(STEPS):
                    raise AssertionError(f"CLI table rows {rows}, expected one {label} of nfe {STEPS}")
                if metrics["exp"] != [label]:
                    raise AssertionError(f"CLI returned {metrics}")
                if not (np.isfinite(sec_img) and sec_img > 0):
                    raise AssertionError(f"CLI time {sec_img} s/image")
                if not (np.isfinite(score) and 0.0 <= score <= 100.0):
                    raise AssertionError(f"CLI clip_score {score}")
                if len(pngs) != CLI_BATCH or sizes != {(SIZE, SIZE)}:
                    raise AssertionError(f"CLI wrote {len(pngs)} PNGs of sizes {sizes}, expected "
                                         f"{CLI_BATCH} of {SIZE}x{SIZE}")
                if counts != want_wrappers:
                    raise AssertionError(f"CLI {run} run: wrapper launches {counts}, expected "
                                         f"{want_wrappers}")
                if traced is not None and traced != want_traced:
                    raise AssertionError(f"CLI traced run: kernel executions {traced}, expected "
                                         f"{want_traced}")
                out[run] = dict(wall_s=wall, sec_per_image=sec_img, clip_score=score,
                                wrapper_launches=counts, traced_launches=traced)
                for p in pngs:
                    p.unlink()
        finally:
            os.chdir(cwd)
    report["attention_fp32"]["phase6_launches"] = out["traced"]["traced_launches"][
        "attention_fp32"]

    report["e2e"]["cli"] = out


def clip_tower(card):
    """The CLI's CLIP tower (the metric's cached backend) at the validate
    batch: device ms of the image embedding (resize, 12 layers, projection)
    and of the whole score with the text tower; and, in fp32 with TF32 off,
    its image and text embeddings and raw cosines on the card (kernel)
    against a CPU copy (plain attention) on two images."""
    import copy

    import numpy as np

    from sonicdiffusionbayeslab_torch.metrics.metrics import ClipScoreMetric

    backend = ClipScoreMetric(device="cuda").backend
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.rand(CLI_BATCH, SIZE, SIZE, 3, generator=gen, device="cuda")
    ids = torch.as_tensor(np.asarray(backend.tokenizer(PROMPTS * (CLI_BATCH // 2))),
                          dtype=torch.long, device="cuda")
    with torch.inference_mode():
        out = {"clip_embed_image_ms": cuda_ms(lambda: backend.model.embed_image(x), reps=5),
               "clip_score_ms": cuda_ms(lambda: backend.model(x, ids), reps=5)}
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            cpu = copy.deepcopy(backend.model).cpu()
            got = [backend.model.embed_image(x[:2]), backend.model.embed_text(ids[:2])]
            want = [cpu.embed_image(x[:2].cpu()), cpu.embed_text(ids[:2].cpu())]
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    errs = [float((g.cpu() - w).abs().max()) for g, w in zip(got, want)]
    cos_err = float((100 * (got[0] * got[1]).sum(-1)).cpu().sub(
        100 * (want[0] * want[1]).sum(-1)).abs().max())
    out.update(card_vs_cpu_image_emb_err=errs[0], card_vs_cpu_text_emb_err=errs[1],
               card_vs_cpu_cosine_x100_err=cos_err)
    print(f"CLIP ViT-B/16 tower at the validate batch of {CLI_BATCH} (fp32, {SIZE}->224 resize, "
          f"12 layers, projection): {out['clip_embed_image_ms']:.3f} ms device time; with the text "
          f"tower, the whole score {out['clip_score_ms']:.3f} ms (CUDA graph between CUDA events, "
          f"median of 5); {card}; card vs CPU (TF32 off, 2 images): max abs err image embedding "
          f"{errs[0]:.3e}, text embedding {errs[1]:.3e} (tolerance 1e-4), 100 x cosine "
          f"{cos_err:.3e} (tolerance 1e-2)", flush=True)
    # Unit vectors in fp32 through 12 layers summed in another order (cuBLAS
    # and the kernel against the CPU's plain path).
    if not (max(errs) <= 1e-4 and cos_err <= 1e-2):
        raise AssertionError("the CLIP tower on the card disagrees with the CPU")
    return out


# ------------------------------------------------------- scheduler methods
def _png_size(path):
    import numpy as np

    return tuple(int(v) for v in np.frombuffer(path.read_bytes()[16:24], ">u4"))


def write_random_lora(path, rank=64, seed=0):
    """A random kohya-layout LoRA (rank ``rank``, alpha = rank) on every
    attention projection of the SD-1.5 UNet (to_q, to_k, to_v, to_out.0 of
    attn1 and attn2 in its 16 transformers): the modules an LCM-LoRA
    targets there; returns their names."""
    from sonicdiffusionbayeslab_torch.models.unet import UNet2DCondition, UNetConfig

    with torch.device("meta"):
        shapes = {k[: -len(".weight")]: tuple(v.shape)
                  for k, v in UNet2DCondition(UNetConfig.sd15()).state_dict().items()
                  if re.search(r"\.attn[12]\.(to_[qkv]|to_out\.0)\.weight$", k)}
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, (out_c, in_c) in shapes.items():
        p = "lora_unet_" + name.replace(".", "_")
        sd[f"{p}.lora_down.weight"] = torch.randn(rank, in_c, generator=gen) / in_c ** 0.5
        sd[f"{p}.lora_up.weight"] = torch.randn(out_c, rank, generator=gen) * 0.01
        sd[f"{p}.alpha"] = torch.tensor(float(rank))
    torch.save(sd, path)
    return sorted(shapes)


class _RecordingVariants:
    """Collects the engine's ``GraphedVariants`` while a CLI run builds its
    model, to read each variant's captures afterwards."""

    def __enter__(self):
        from sonicdiffusionbayeslab_torch.models import sampler
        from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedVariants

        self.made, self._saved, self._mod = [], sampler.GraphedVariants, sampler
        made = self.made

        class Recording(GraphedVariants):
            def __init__(self, fn):
                super().__init__(fn)
                made.append(self)

        sampler.GraphedVariants = Recording
        return self

    def __exit__(self, *exc):
        self._mod.GraphedVariants = self._saved

    def captures(self):
        """({variant: captures} of the run's one engine, the GB of device
        memory its graphs kept reserved); drops the graphs."""
        if len(self.made) != 1:
            raise AssertionError(f"the CLI run built {len(self.made)} engines, expected 1")
        caps = dict(self.made[0].captures)
        reserved = []
        for drop in (False, True):
            if drop:
                self.made[0].clear()
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved.append(torch.cuda.memory_reserved())
        self.made.clear()
        return caps, (reserved[0] - reserved[1]) / 1e9


def run_methods(card, runs, trace_all=False):
    """Each of ``runs`` (METHOD_RUNS' or SAMPLER_RUNS' form, see
    :func:`_as_points`) through ``cli.run`` at SD-1.5 512^2
    (METHOD_OVERRIDES), in a temporary working directory, with the
    wrappers' counts set to 0 just before each run and read just after;
    the DeepCache runs (or, with ``trace_all``, every run) under
    torch.profiler as well.  Each run checks its table rows, its PNGs, one
    capture per UNet call variant (a ToMe ratio is a variant of its own),
    and each kernel's launches against the census at the variant's shapes:
    per variant the graph's warm-ups and capture (wrappers) or warm-ups and
    replays (trace), the VAE decodes (each point's batch and one x0 decode
    of one sample a step where the method captures x0) and the CLIP
    tower's attention a validate batch; returns {run: results}."""
    import csv

    import numpy as np

    from sonicdiffusionbayeslab_torch import cli
    from sonicdiffusionbayeslab_torch.config import load_config
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    repo = Path(__file__).resolve().parent
    W = GraphedCall.WARMUP
    clip_per_batch = sum(clip_census(METHOD_BATCH).values())
    per_vae = {b: _kinds(module_census(vae_batch=b)) for b in (METHOD_BATCH, 1)}
    out = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="sdbl_methods_") as tmp:
        os.chdir(tmp)
        try:
            lora_modules = write_random_lora(Path(tmp) / "lora.bin")
            for name, point, points, nfe, cfg_batch, x0, full_steps in map(_as_points, runs):
                config = str(repo / "configs" / f"{name}.yaml")
                overrides = {**METHOD_OVERRIDES, **point, "logger.run_id": name,
                             "dataset.prompts": str(repo / "data" / "dataset" /
                                                    "prompts_sample.json")}
                if name == "consistency_model_config":
                    overrides["model.lora"] = str(Path(tmp) / "lora.bin")
                unet_batch = METHOD_BATCH * cfg_batch
                replays = {"full": nfe if full_steps is None else full_steps}
                if full_steps is not None:
                    replays["shallow"] = nfe - full_steps
                # Per point: its variants' census; a variant is captured at
                # its first point and replayed after.
                want = collections.Counter({"attention_fp32": clip_per_batch * len(points)})
                want_traced = collections.Counter(want)
                seen = set()
                for _, tome in points:
                    for v, n in replays.items():
                        c = _kinds(module_census(unet_batch, shallow=v == "shallow", tome=tome))
                        first = (v, tome) not in seen
                        seen.add((v, tome))
                        for k in MAIN:
                            want[k] += (W + 1) * c[k] * first
                            want_traced[k] += (W * first + n) * c[k]
                    for k in MAIN:
                        d = per_vae[METHOD_BATCH][k] + (nfe * per_vae[1][k] if x0 else 0)
                        want[k] += d
                        want_traced[k] += d
                merged = []
                fuse = None
                if name == "consistency_model_config":
                    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel

                    fuse = StableDiffusionModel.fuse_lora

                    def recording_fuse(self, scale=1.0):
                        res = fuse(self, scale)
                        merged.extend(self.lora_merged)
                        return res

                    StableDiffusionModel.fuse_lora = recording_fuse
                trace = trace_all or full_steps is not None
                wrapper_counts(reset=True)
                t0 = time.perf_counter()
                try:
                    with _RecordingVariants() as rec:
                        if not trace:
                            metrics, traced = cli.run(config, overrides), None
                        else:
                            metrics, traced = traced_launches(lambda: cli.run(config, overrides))
                finally:
                    if fuse is not None:
                        StableDiffusionModel.fuse_lora = fuse
                wall = time.perf_counter() - t0
                counts = wrapper_counts()
                caps, graphs_gb = rec.captures()
                labels = [label for label, _ in points]
                with open(Path(tmp) / "outputs" / name / "tables" / "final.tsv") as f:
                    rows = list(csv.DictReader(f, delimiter="\t"))
                exp_name = load_config(config).get("experiment_name")
                pngs = {lb: sorted((Path(tmp) / "outputs" / exp_name / lb).glob("*.png"))
                        for lb in labels}
                sizes = {_png_size(p) for ps in pngs.values() for p in ps}
                sec_img = [float(r["time"]) for r in rows]
                score = [float(r["clip_score"]) for r in rows]
                print(f"{name} ({', '.join(labels)}: {nfe} UNet evaluations at batch "
                      f"{unet_batch}, SD-1.5 bf16 {SIZE}x{SIZE}, batch {METHOD_BATCH}): whole CLI "
                      f"{wall:.3f} s, sweep {sec_img} s/image (graph captures inside the loop), "
                      f"clip_score {score}; {card}; graph captures {caps}, their pools keep "
                      f"{graphs_gb:.3f} GB reserved; launches: wrappers {dict(counts)}, trace "
                      f"{traced}", flush=True)
                if [(r["exp"], r["nfe"]) for r in rows] != [(lb, str(nfe)) for lb in labels]:
                    raise AssertionError(f"{name}: table rows {rows}, expected {labels} of "
                                         f"nfe {nfe}")
                if metrics["exp"] != labels:
                    raise AssertionError(f"{name}: CLI returned {metrics}")
                if not all(np.isfinite(v) and v > 0 for v in sec_img):
                    raise AssertionError(f"{name}: time {sec_img} s/image")
                if not all(np.isfinite(v) and 0.0 <= v <= 100.0 for v in score):
                    raise AssertionError(f"{name}: clip_score {score}")
                if [len(ps) for ps in pngs.values()] != [METHOD_BATCH] * len(labels) or \
                        sizes != {(SIZE, SIZE)}:
                    raise AssertionError(f"{name}: PNGs {[len(ps) for ps in pngs.values()]} of "
                                         f"sizes {sizes}, expected {METHOD_BATCH} of "
                                         f"{SIZE}x{SIZE} for each of {labels}")
                if sorted(caps.values()) != [1] * len(seen):
                    raise AssertionError(f"{name}: graph captures {caps}, expected one for each "
                                         f"of {len(seen)} UNet call variants")
                if counts != dict(want):
                    raise AssertionError(f"{name}: wrapper launches {counts}, expected "
                                         f"{dict(want)}")
                if traced is not None and traced != dict(want_traced):
                    raise AssertionError(f"{name}: traced kernel executions {traced}, "
                                         f"expected {dict(want_traced)}")
                if name == "consistency_model_config" and merged != lora_modules:
                    raise AssertionError(f"fuse_lora merged {len(merged)} modules, the file "
                                         f"names {len(lora_modules)}")
                caps = {", ".join(f"{k}={v}" for k, v in key) or "plain": n
                        for key, n in caps.items()}
                out[name] = dict(labels=labels, nfe=nfe, unet_batch=unet_batch, wall_s=wall,
                                sec_per_image=sec_img, clip_score=score, graph_captures=caps,
                                graph_reserved_gb=graphs_gb, wrapper_launches=counts,
                                traced_launches=traced)
                if merged:
                    out[name]["lora_modules_merged"] = len(merged)
                for p in (p for ps in pngs.values() for p in ps):
                    p.unlink()
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            os.chdir(cwd)
    return out


def _as_points(run):
    """(config, overrides, [(label, ToMe ratio or None)], nfe, CFG factor,
    x0, DeepCache full steps) of a METHOD_RUNS entry (one label) or a
    SAMPLER_RUNS entry."""
    name, point, labels, *rest = run
    return (name, point, [(labels, None)] if isinstance(labels, str) else labels, *rest)


def methods_tiny_card_vs_cpu():
    """A tiny fp32 DeepCache run (interval 2, unet_microbatch 2, CFG) and a
    tiny LCM run (4 steps, guidance 0, given step noise) on the card
    against the same runs on the CPU; returns the fp32 attention kernel's
    launches in each card run, which must be the tiny census's."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
    from sonicdiffusionbayeslab_torch.models.sampler import CachePlan
    from sonicdiffusionbayeslab_torch.ops.flash_attention import flash_attention_tf32x3
    from sonicdiffusionbayeslab_torch.schedulers import DDIMScheduler, LCMScheduler
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    W = GraphedCall.WARMUP
    cpu = StableDiffusionModel(tiny=True, dtype="float32", seed=0, device="cpu")
    card = StableDiffusionModel(tiny=True, dtype="float32", seed=0, device="cuda")
    card.engine.load_state_dicts({k: m.state_dict() for k, m in
                                  zip(("unet", "vae", "text"), cpu.engine.modules())})
    prompts = ["a lighthouse at dusk", "a red boat"]
    noise = torch.randn(4, 2, 8, 8, 4, generator=torch.Generator().manual_seed(5))
    runs = {
        "deep_cache": (DDIMScheduler().build_plan(STEPS), GUIDANCE,
                       dict(cache_plan=CachePlan.every(STEPS, 2, 0), microbatch=2),
                       ("full", "shallow")),
        "lcm": (LCMScheduler().build_plan(4), 0.0, dict(step_noise=noise), ("full",)),
    }
    per_vae = _kinds(module_census(vae_batch=BATCH, tiny=True))["attention"]
    out = {}
    for name, (plan, guidance, kw, variants) in runs.items():
        images = []
        for model in (cpu, card):
            eng = model.engine
            emb = eng.encode_prompts(model.tokenizer(prompts))
            neg = eng.encode_prompts(model.tokenizer([""] * 2)) if guidance > 1 else None
            flash_attention_tf32x3.launches = 0
            res = eng.sample(plan, emb, neg, seed=29, guidance_scale=guidance, latent_hw=(8, 8),
                             **kw)
            images.append(res.images.cpu().numpy())
        launches = flash_attention_tf32x3.launches
        # Both UNet batches are 2: microbatch 2 of the CFG batch 4, or LCM's 2.
        want = sum((W + 1) * _kinds(module_census(2, tiny=True, shallow=v == "shallow"))[
            "attention"] for v in variants) + per_vae
        err = float(np.abs(images[0] - images[1]).max())
        print(f"tiny fp32 {name} run, card vs CPU: max abs image err {err:.3e} (tolerance 1e-3); "
              f"flash_attention_tf32x3 launches {launches}", flush=True)
        if not err <= 1e-3:
            raise AssertionError(f"the tiny {name} run on the card disagrees with the CPU")
        if launches != want or launches <= 0:
            raise AssertionError(f"the tiny {name} run launched the fp32 attention kernel "
                                 f"{launches} times, expected {want}")
        out[name] = dict(max_abs_image_err=err, fp32_attention_launches=launches)
    return out


def engine_timings(card, reps=3):
    """Warm ``execution_time`` of 20-step DDIM and of DeepCache (interval
    5, branch 0) at batch 2, CFG 7.5, engine level, in turns after a
    capture run of each; the memory each capture run's graphs keep
    reserved; and the device ms of one full and one shallow UNet call at
    UNet batch 4 (CUDA graphs between CUDA events)."""
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
    from sonicdiffusionbayeslab_torch.models.sampler import CachePlan
    from sonicdiffusionbayeslab_torch.schedulers import DDIMScheduler

    gc.collect()
    torch.cuda.empty_cache()
    model = StableDiffusionModel(image_size=SIZE, tiny=False, dtype="bfloat16", seed=0,
                                 device="cuda")
    eng = model.engine
    emb = eng.encode_prompts(model.tokenizer(PROMPTS))
    neg = eng.encode_prompts(model.tokenizer([""] * BATCH))
    plan = DDIMScheduler().build_plan(STEPS)
    kw = dict(guidance_scale=GUIDANCE, latent_hw=(SIZE // 8, SIZE // 8), seed=29)
    cache = CachePlan.every(STEPS, 5, 0)
    runs = {"ddim": lambda: eng.sample(plan, emb, neg, **kw),
            "deep_cache_5": lambda: eng.sample(plan, emb, neg, cache_plan=cache, **kw)}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = {"weights": torch.cuda.memory_reserved()}
    for name, run in runs.items():  # the capture runs
        run()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved[name] = torch.cuda.memory_reserved()
    times = {name: [] for name in runs}
    for i in range(reps):
        for name in (runs if i % 2 == 0 else reversed(list(runs))):
            times[name].append(runs[name]().execution_time)
    graphs_gb = {"plain (ddim)": (reserved["ddim"] - reserved["weights"]) / 1e9,
                 "full + shallow (deep_cache_5)": (reserved["deep_cache_5"] - reserved["ddim"]) / 1e9}
    gen = torch.Generator(device="cuda").manual_seed(3)
    lat = torch.randn(2 * BATCH, SIZE // 8, SIZE // 8, 4, generator=gen, device="cuda").to(eng.dtype)
    tb = torch.full((2 * BATCH,), 499.0, device="cuda")
    ctx = torch.cat([neg, emb]).to(eng.dtype)
    with torch.inference_mode():
        feats = eng.unet(lat, tb, ctx, return_cache=True)[1]
        full_ms = cuda_ms(lambda: eng.unet(lat, tb, ctx), reps=5)
        shallow_ms = cuda_ms(lambda: eng.unet(lat, tb, ctx, feats), reps=5)
    out = dict(execution_time_s={k: v for k, v in times.items()},
               median_s={k: statistics.median(v) for k, v in times.items()},
               graph_reserved_gb=graphs_gb, unet_full_ms=full_ms, unet_shallow_ms=shallow_ms)
    print(f"engine level, SD-1.5 bf16 {SIZE}x{SIZE}, {STEPS} steps, batch {BATCH}, CFG {GUIDANCE} "
          f"(warm, in turns, {reps} each): DDIM execution_time {times['ddim']} s, DeepCache "
          f"(interval 5, branch 0) {times['deep_cache_5']} s; medians {out['median_s']}; graphs "
          f"reserve {graphs_gb} GB; one UNet call at batch {2 * BATCH}: full {full_ms:.3f} ms, "
          f"shallow {shallow_ms:.3f} ms device time; {card}", flush=True)
    del model, eng, feats
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------- samplers, Token Merging
def samplers_tiny_card_vs_cpu():
    """Tiny fp32 runs on the card against the same runs on the CPU, at
    batch 2 and CFG 7.5: 20-step DPM++ with ToMe at 0.5 (each step's
    destinations drawn once and given to both), 10-step Heun (19 UNet
    calls) and 20-step Euler-ancestral (step noise given); returns each
    card run's image error and fp32 attention launches, which must be the
    tiny census's (at the merged shapes for ToMe)."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
    from sonicdiffusionbayeslab_torch.ops.flash_attention import flash_attention_tf32x3
    from sonicdiffusionbayeslab_torch.ops.tome import TomeConfig
    from sonicdiffusionbayeslab_torch.schedulers import (DPMSolverScheduler,
                                                         EulerAncestralScheduler, HeunScheduler)
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall
    from sonicdiffusionbayeslab_torch.utils.rng import tome_destinations

    W = GraphedCall.WARMUP
    cpu = StableDiffusionModel(tiny=True, dtype="float32", seed=0, device="cpu")
    card = StableDiffusionModel(tiny=True, dtype="float32", seed=0, device="cuda")
    card.engine.load_state_dicts({k: m.state_dict() for k, m in
                                  zip(("unet", "vae", "text"), cpu.engine.modules())})
    prompts = ["a lighthouse at dusk", "a red boat"]
    tome = TomeConfig(0.5)
    dpm = DPMSolverScheduler(solver_order=2).build_plan(STEPS)
    slots = cpu.engine.unet.tome_slots(8, 8, tome)
    dst = torch.stack([tome_destinations(int(ts), slots, tome) for ts in dpm.timesteps])
    anc = EulerAncestralScheduler().build_plan(STEPS)
    noise = torch.randn((anc.num_steps, 2, 8, 8, 4), generator=torch.Generator().manual_seed(6))
    runs = {"tome_0.5": (dpm, dict(tome=tome, tome_dst=dst), 0.5),
            "heun": (HeunScheduler().build_plan(10), {}, None),
            "euler_ancestral": (anc, dict(step_noise=noise), None)}
    per_vae = _kinds(module_census(vae_batch=BATCH, tiny=True))["attention"]
    out, seen = {}, set()
    for name, (plan, kw, ratio) in runs.items():
        images = []
        for model in (cpu, card):
            eng = model.engine
            emb = eng.encode_prompts(model.tokenizer(prompts))
            neg = eng.encode_prompts(model.tokenizer([""] * 2))
            flash_attention_tf32x3.launches = 0
            res = eng.sample(plan, emb, neg, seed=29, guidance_scale=GUIDANCE, latent_hw=(8, 8),
                             **kw)
            images.append(res.images.cpu().numpy())
        launches = flash_attention_tf32x3.launches
        # A variant's first run captures its graph; Heun's plain graph
        # serves Euler-ancestral's run (the same shapes) as replays.
        census = _kinds(module_census(2 * BATCH, tiny=True, tome=ratio))["attention"]
        want = (W + 1) * census * (ratio not in seen) + per_vae
        seen.add(ratio)
        err = float(np.abs(images[0] - images[1]).max())
        print(f"tiny fp32 {name} run ({plan.nfe} UNet calls), card vs CPU: max abs image err "
              f"{err:.3e} (tolerance 1e-3); flash_attention_tf32x3 launches {launches}",
              flush=True)
        # fp32 both sides, TF32 off: summation order over the run's CFG steps.
        if not err <= 1e-3:
            raise AssertionError(f"the tiny {name} run on the card disagrees with the CPU")
        if launches != want or launches <= 0:
            raise AssertionError(f"the tiny {name} run launched the fp32 attention kernel "
                                 f"{launches} times, expected {want}")
        out[name] = dict(max_abs_image_err=err, fp32_attention_launches=launches, nfe=plan.nfe)
    return out


def sampler_pipeline_runs(card, per_vae, profile, reps=3):
    """The pipeline at SD-1.5 bf16 512^2, batch 2, CFG 7.5: DPM++, UniPC,
    DEIS, Euler, Euler-ancestral (20 steps), Heun (10 steps, 19 UNet calls),
    DPM++ with guidance_rescale 0.7 and DPM++ with ToMe at 0.5 and 0.25.
    A first run of each with the wrappers' counts set to 0 just before and
    read just after (a variant's first run captures its graph: its census
    at the merged shapes, W + 1 times; later runs of that variant replay;
    then the decode), the memory each ToMe variant's graph keeps reserved,
    and the warm execution_time, ``reps`` runs each in turns, median."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
    from sonicdiffusionbayeslab_torch.schedulers import (DEISScheduler, DPMSolverScheduler,
                                                         EulerAncestralScheduler, EulerScheduler,
                                                         HeunScheduler, UniPCScheduler)
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    W = GraphedCall.WARMUP
    gc.collect()
    torch.cuda.empty_cache()
    model = StableDiffusionModel(image_size=SIZE, tiny=False, dtype="bfloat16", seed=0,
                                 device="cuda")
    dpm = DPMSolverScheduler(solver_order=2)
    runs = {  # name: (scheduler, steps, UNet calls, guidance_rescale, ToMe ratio)
        "dpm_solver": (dpm, STEPS, STEPS, 0.0, None),
        "unipc": (UniPCScheduler(), STEPS, STEPS, 0.0, None),
        "deis": (DEISScheduler(), STEPS, STEPS, 0.0, None),
        "euler": (EulerScheduler(), STEPS, STEPS, 0.0, None),
        "euler_ancestral": (EulerAncestralScheduler(), STEPS, STEPS, 0.0, None),
        "heun": (HeunScheduler(), 10, 19, 0.0, None),
        "dpm_guidance_rescale_0.7": (dpm, STEPS, STEPS, 0.7, None),
        "dpm_tome_0.5": (dpm, STEPS, STEPS, 0.0, 0.5),
        "dpm_tome_0.25": (dpm, STEPS, STEPS, 0.0, 0.25),
    }

    def call(name):
        sched, steps, _, rescale, tome = runs[name]
        model.scheduler, model.guidance_rescale = sched, rescale
        return model(PROMPTS, num_inference_steps=steps, guidance_scale=GUIDANCE, seed=29,
                     tome_ratio=tome)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = {"weights": torch.cuda.memory_reserved()}
    out = {"first_run_wrapper_launches": {}, "graph_reserved_gb": {}}
    seen = set()
    for name, (_, _, calls, _, tome) in runs.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        wrapper_counts(reset=True)
        imgs = call(name)[0]
        counts = bf16_only(wrapper_counts(), name)
        check_images(imgs)
        if model.num_timesteps != calls:
            raise AssertionError(f"{name}: {model.num_timesteps} UNet calls, expected {calls}")
        census = _kinds(module_census(2 * BATCH, tome=tome))
        want = {k: (W + 1) * census[k] * (tome not in seen) + per_vae[k] for k in MAIN}
        if counts != want:
            raise AssertionError(f"{name}: first run's wrapper launches {counts}, expected {want}")
        out["first_run_wrapper_launches"][name] = counts
        if tome not in seen:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            out["graph_reserved_gb"]["plain" if tome is None else f"tome_{tome}"] = (
                torch.cuda.memory_reserved() - (before if tome else reserved["weights"])) / 1e9
        seen.add(tome)
    times = {name: [] for name in runs}
    for i in range(reps):
        for name in (runs if i % 2 == 0 else reversed(list(runs))):
            imgs, exec_time, _ = call(name)
            times[name].append(exec_time)
    out.update(execution_time_s=times,
               median_s={k: statistics.median(v) for k, v in times.items()},
               unet_calls={k: r[2] for k, r in runs.items()})
    if not np.isfinite(imgs).all():
        raise AssertionError("non-finite images")
    if profile:
        model.scheduler, model.guidance_rescale = dpm, 0.0
        out["profile_tome_0.5"] = profile_loop(model, tome=0.5)
    print(f"pipeline, SD-1.5 bf16 {SIZE}x{SIZE}, batch {BATCH}, CFG {GUIDANCE} (warm, in turns, "
          f"{reps} each): execution_time medians {out['median_s']} s over UNet calls "
          f"{out['unet_calls']}; graphs reserve {out['graph_reserved_gb']} GB; first runs' "
          f"wrapper launches {out['first_run_wrapper_launches']}; {card}", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_samplers(report, card, per_vae, profile):
    """Phase 8: the remaining samplers and Token Merging."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report["e2e"]["samplers_tiny_card_vs_cpu"] = samplers_tiny_card_vs_cpu()
    torch.backends.cudnn.allow_tf32 = True
    report["e2e"]["sampler_pipeline"] = sampler_pipeline_runs(card, per_vae, profile)
    report["e2e"]["samplers_cli"] = run_methods(card, SAMPLER_RUNS, trace_all=True)
    # The bf16 kernel at ToMe's merged 64x64 self-attention (UNet batch 8,
    # the CLI runs'), with its launches in one 20-step tome_config point.
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for ratio in TOME_RATIOS:
        calls = module_census(2 * METHOD_BATCH, tome=ratio)
        n = 4096 - int(4096 * ratio)
        shape = (2 * METHOD_BATCH, n, n, 8, 40)
        rows.append(timing_row("attention", shape, torch.bfloat16, f"tome_{ratio}",
                               STEPS * calls[("attention", shape)], gen))
    report["tome_timings"] = rows


# ------------------------------------------------------- quality metrics
def metric_census(batch, tiny=False):
    """{(kind, shape): launches} of one validate batch of phase 9's metric
    towers: the CLIP score's ViT-B/16 vision and text towers, ImageReward's
    BLIP twice (the real and the generated images), the aesthetic score's
    ViT-L/14 (``tiny``: the tiny towers); from the modules run on the meta
    device with the attention entry points replaced by shape recorders.
    Only unmasked calls the kernel takes are counted: BERT's masked
    self-attention and the CLIP text towers' causal one take the plain
    path."""
    from sonicdiffusionbayeslab_torch.metrics import image_reward_model as irm
    from sonicdiffusionbayeslab_torch.models import clip_text
    from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig, CLIPTextTransformer
    from sonicdiffusionbayeslab_torch.models.clip_vision import (CLIP_B16_TEXT, CLIPVisionConfig,
                                                                  CLIPVisionModel)
    from sonicdiffusionbayeslab_torch.ops.attention import uses_kernel

    calls = collections.Counter()

    def attn(q, k, v, mask=None):
        if uses_kernel(q, mask):
            B, N, H, D = q.shape
            calls[("attention", (B, N, k.shape[1], H, D))] += 1
        return torch.empty_like(q)

    if tiny:
        vision, text, blip = [CLIPVisionConfig.tiny()], CLIPTextConfig.tiny(), irm.BLIPConfig.tiny()
    else:
        vision = [CLIPVisionConfig(), CLIPVisionConfig.vit_l14()]
        text, blip = CLIP_B16_TEXT, irm.BLIPConfig()
    saved = clip_text.dot_product_attention, irm.dot_product_attention
    clip_text.dot_product_attention = irm.dot_product_attention = attn
    try:
        with torch.device("meta"):
            for cfg in vision:
                CLIPVisionModel(cfg)(torch.empty(batch, 3, cfg.image_size, cfg.image_size))
            CLIPTextTransformer(text)(torch.zeros(batch, 77, dtype=torch.long))
            model = irm.ImageRewardModel(blip)
            for _ in range(2):
                model(torch.empty(batch, 3, blip.image_size, blip.image_size),
                      torch.zeros(batch, blip.max_text_len, dtype=torch.long),
                      torch.ones(batch, blip.max_text_len))
    finally:
        clip_text.dot_product_attention, irm.dot_product_attention = saved
    return calls


def write_real_images(root):
    """METRIC_BATCH images at 640x480 and 480x640 named after the first keys
    of data/dataset/img2annotations_test.json (.jpg names, PNG content: the
    decoder goes by content), half by the port's writer and half by PIL
    where it is installed; each read back through ``read_image``, whole
    (bit-equal to its pixels) and at 512 (resize + center crop).  A JPEG
    (PIL) is read too: decoded where the image IO library has libjpeg,
    else the error must name libjpeg.  Returns the directory."""
    import io

    import numpy as np

    from sonicdiffusionbayeslab_torch.data import _dataio
    from sonicdiffusionbayeslab_torch.data.imageio import encode_png_bytes, read_image

    try:
        from PIL import Image
    except ImportError:
        Image = None
    repo = Path(__file__).resolve().parent
    names = sorted(json.loads((repo / "data" / "dataset" /
                               "img2annotations_test.json").read_text()))[:METRIC_BATCH]
    gen = np.random.default_rng(3)
    img_dir = Path(root) / "images"
    img_dir.mkdir()
    writers = collections.Counter()
    for i, name in enumerate(names):
        h, w = (480, 640) if i % 2 == 0 else (640, 480)
        ramp = np.linspace(0, 255, w)[None, :, None] * np.linspace(0.2, 1, h)[:, None, None]
        px = np.clip(ramp * gen.uniform(0.3, 1, 3) + gen.normal(0, 30, (h, w, 3)), 0,
                     255).astype(np.uint8)
        if Image is not None and i % 2:
            buf = io.BytesIO()
            Image.fromarray(px).save(buf, format="PNG")
            (img_dir / name).write_bytes(buf.getvalue())
            writers["PIL"] += 1
        else:
            (img_dir / name).write_bytes(encode_png_bytes(px))
            writers["port"] += 1
        whole, cropped = read_image(img_dir / name), read_image(img_dir / name, SIZE)
        if not np.array_equal(whole, px.astype(np.float32) / 255.0):
            raise AssertionError(f"read_image({name}) differs from the pixels written")
        if cropped.shape != (SIZE, SIZE, 3) or not np.isfinite(cropped).all():
            raise AssertionError(f"read_image({name}, {SIZE}) gave {cropped.shape}")
    has_jpeg = bool(_dataio.library().sdbl_has_jpeg())
    jpeg = "not written (no PIL)"
    if Image is not None:
        Image.fromarray(px).save(Path(root) / "probe.jpg", format="JPEG", quality=95)
        if has_jpeg:
            got = read_image(Path(root) / "probe.jpg")
            ref = np.asarray(Image.open(Path(root) / "probe.jpg").convert("RGB")) / 255.0
            err = float(np.abs(got - ref).mean())
            if got.shape != ref.shape or err > 2 / 255:
                raise AssertionError(f"JPEG decode: shape {got.shape}, mean abs err {err:.4f}")
            jpeg = f"decoded (mean abs diff from PIL's decode {err:.2e})"
        else:
            try:
                read_image(Path(root) / "probe.jpg")
            except RuntimeError as e:
                if "libjpeg" not in str(e):
                    raise
                jpeg = "refused, naming libjpeg (built without it)"
            else:
                raise AssertionError("a JPEG decoded by a library built without libjpeg")
    print(f"real images: {METRIC_BATCH} PNGs at 640x480 and 480x640 ({dict(writers)} writers), "
          f"each read back bit-equal and at {SIZE}^2; image IO library with libjpeg: {has_jpeg}; "
          f"a JPEG: {jpeg}", flush=True)
    return img_dir


def write_metric_checkpoints(root):
    """Random full-width checkpoints in the published layouts: ImageReward
    (BLIP ViT-L/16 + BERT + head, seeded, fp16 to halve the write) and
    FID-Inception in pytorch-fid's layout (random BatchNorm statistics,
    ``num_batches_tracked``, the 1008-way ``fc``).  Returns their paths."""
    from sonicdiffusionbayeslab_torch.metrics.image_reward_model import (BLIPConfig,
                                                                         ImageRewardModel)
    from sonicdiffusionbayeslab_torch.metrics.inception import InceptionBlocks
    from sonicdiffusionbayeslab_torch.models.sampler import init_module

    gen = torch.Generator(device="cuda").manual_seed(6)
    with torch.device("cuda"):
        reward, inception = ImageRewardModel(BLIPConfig()), InceptionBlocks(2048)
    with torch.no_grad():
        init_module(reward, gen)
        init_module(inception, gen)
        reward.blip.visual_encoder.pos_embed.normal_(0.0, 0.02, generator=gen)
        sd = {k: v.half().cpu() for k, v in reward.state_dict().items()}
        paths = {"image_reward": Path(root) / "ImageReward.pt",
                 "inception": Path(root) / "pt_inception.pth"}
        torch.save({"state_dict": sd}, paths["image_reward"])
        sd = {}
        for k, v in inception.state_dict().items():
            if k.endswith("running_var"):
                v = torch.rand(v.shape, generator=gen, device="cuda") + 0.5
            elif k.endswith(("running_mean", "bn.bias")):
                v = torch.randn(v.shape, generator=gen, device="cuda") * 0.1
            sd[k] = v.cpu()
            if k.endswith("running_var"):
                sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
        sd["fc.weight"], sd["fc.bias"] = torch.randn(1008, 2048) * 0.02, torch.zeros(1008)
        torch.save(sd, paths["inception"])
    n = sum(p.numel() for p in reward.parameters())
    print(f"checkpoints: ImageReward {n / 1e6:.1f} M parameters (fp16, "
          f"{paths['image_reward'].stat().st_size / 1e9:.2f} GB), FID-Inception "
          f"{paths['inception'].stat().st_size / 1e6:.1f} MB", flush=True)
    del reward, inception
    return paths


def metrics_card_vs_cpu(backend_l14, ckpts, images):
    """In fp32 with TF32 off, on two images: the tiny BLIP scorer (seeded
    random weights), the full ImageReward scorer from its checkpoint, the
    run's ViT-L/14 tower and FID-Inception at 2048 from its file, each on
    the card (the fp32 attention kernel, cuDNN) against a CPU copy (plain
    attention, oneDNN), within METRIC_TOL; returns the max errors."""
    import copy

    import numpy as np

    from sonicdiffusionbayeslab_torch.metrics.image_reward_model import ImageRewardScorer
    from sonicdiffusionbayeslab_torch.metrics.inception import InceptionFeatures
    from sonicdiffusionbayeslab_torch.ops.flash_attention import flash_attention_tf32x3

    x = images[:2]
    out, launches = {}, {}

    def check(name, card_fn, cpu_fn):
        n0 = flash_attention_tf32x3.launches
        got = np.asarray(card_fn(), np.float64)
        launches[name] = flash_attention_tf32x3.launches - n0
        want = np.asarray(cpu_fn(), np.float64)
        atol, rtol = METRIC_TOL[name]
        out[name] = float(np.abs(got - want).max())
        if not (np.abs(got - want) <= atol + rtol * np.abs(want)).all():
            raise AssertionError(f"{name}: card vs CPU max abs err {out[name]:.3e} exceeds "
                                 f"atol {atol} + rtol {rtol}")

    for name, kw in (("image_reward_tiny", dict(tiny=True)),
                     ("image_reward", dict(checkpoint=str(ckpts["image_reward"])))):
        card = ImageRewardScorer(device="cuda", **kw)
        cpu = copy.copy(card)
        cpu.model, cpu.device = copy.deepcopy(card.model).cpu(), torch.device("cpu")
        check(name, lambda: card(x, PROMPTS), lambda: cpu(x, PROMPTS))
        del card, cpu
    cpu_l14 = copy.deepcopy(backend_l14.model).cpu()
    with torch.inference_mode():
        check("clip_l14_embedding", lambda: backend_l14.image_features(x),
              lambda: cpu_l14.embed_image(torch.as_tensor(x)).numpy())
    del cpu_l14
    card = InceptionFeatures(2048, str(ckpts["inception"]), device="cuda")
    cpu = InceptionFeatures(2048, str(ckpts["inception"]), device="cpu")
    check("inception_2048", lambda: card(x), lambda: cpu(x))
    print(f"metric towers, card vs CPU (fp32, TF32 off, 2 images): max abs errors {out} "
          f"(tolerances {METRIC_TOL}); fp32 attention launches on the card {launches}",
          flush=True)
    if not (launches["image_reward_tiny"] > 0 and launches["image_reward"] == 36
            and launches["clip_l14_embedding"] == 24 and launches["inception_2048"] == 0):
        raise AssertionError(f"card runs launched the fp32 attention kernel {launches} times")
    return dict(max_abs_err=out, fp32_attention_launches=launches)


def metric_timings(card, backends, scorer, inception, images):
    """Device ms of each metric's work on one validate batch of METRIC_BATCH
    512^2 images (CUDA graph between CUDA events, median of 5, fp32 with
    TF32 off): the CLIP score (ViT-B/16 and its text tower), the aesthetic
    score (ViT-L/14 image embedding and the head), ImageReward (its scorer
    on the real and on the generated images: two calls) and FID (Inception
    at tap 64 on both: two calls; and at 2048, one call)."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.models.clip_vision import clip_pixels

    b16, l14, head = backends
    x = torch.as_tensor(images, device="cuda")
    ids = torch.as_tensor(np.asarray(b16.tokenizer(PROMPTS * (METRIC_BATCH // 2))),
                          dtype=torch.long, device="cuda")
    rids, rmask = (torch.as_tensor(a, device="cuda")
                   for a in scorer.tokenizer(PROMPTS * (METRIC_BATCH // 2)))
    rids = rids.long()
    px = clip_pixels(x, scorer.cfg.image_size)

    def aesthetic():
        e = l14.model.embed_image(x)
        return head.model(e / e.norm(dim=-1, keepdim=True))

    with torch.inference_mode():
        out = {"clip_score": cuda_ms(lambda: b16.model(x, ids), reps=5),
               "aesthetic_score": cuda_ms(aesthetic, reps=5),
               "image_reward": 2 * cuda_ms(lambda: scorer.model(px, rids, rmask), reps=5),
               "fid_64": 2 * cuda_ms(lambda: inception[64].features(x), reps=5),
               "fid_2048_one_call": cuda_ms(lambda: inception[2048].features(x), reps=5)}
    print(f"metric device ms per validate batch of {METRIC_BATCH} (fp32, TF32 off; CUDA graph "
          f"between CUDA events, median of 5): " + json.dumps(out) + f"; {card}", flush=True)
    return out


def run_metrics(report, card, metric_counts):
    """Phase 9: ``cli.run`` of configs/ddim_config.yaml as shipped, at SD-1.5
    512^2, with ``aesthetic_score`` added and only the image directory, its
    count, the batch, the checkpoints' paths and the sweep's length
    overridden, in a temporary working directory, traced: its table row
    (finite clip_score, fid, aesthetic_score; image_reward in [0, 1]), its
    PNGs, one graph capture, and each kernel's launches against the census
    (the metric towers' fp32 attention, the UNet's and VAE's bf16 kernels,
    by the wrappers and by the trace); then FID at 2048 on the run's PNGs
    and the real images, the towers card against CPU, and each metric's
    device time."""
    import csv

    import numpy as np

    from sonicdiffusionbayeslab_torch import cli
    from sonicdiffusionbayeslab_torch.data.imageio import read_image
    from sonicdiffusionbayeslab_torch.metrics.inception import InceptionFeatures
    from sonicdiffusionbayeslab_torch.metrics.metrics import FID, _clip_backend
    from sonicdiffusionbayeslab_torch.metrics.aesthetic import AestheticScorer
    from sonicdiffusionbayeslab_torch.metrics.image_reward_model import ImageRewardScorer
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    repo = Path(__file__).resolve().parent
    config = str(repo / "configs" / "ddim_config.yaml")
    nfe, label = STEPS, f"steps_{STEPS}"
    per_unet = _kinds(module_census(2 * METRIC_BATCH))
    per_vae = _kinds(module_census(vae_batch=METRIC_BATCH))
    W = GraphedCall.WARMUP
    fp32_per_batch = sum(metric_counts.values())
    want = {k: (W + 1) * per_unet[k] + (1 + nfe) * per_vae[k] for k in MAIN}
    want_traced = {k: (W + nfe) * per_unet[k] + (1 + nfe) * per_vae[k] for k in MAIN}
    want["attention_fp32"] = want_traced["attention_fp32"] = fp32_per_batch
    out = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="sdbl_metrics_") as tmp:
        img_dir = write_real_images(tmp)
        ckpts = write_metric_checkpoints(tmp)
        aesthetic_ckpt = str(repo / "data" / "models" / "aethetic_score_model.pth")
        overrides = {
            "dataset.img_dataset": str(img_dir), "dataset.max_count": METRIC_BATCH,
            "inference.batch_size": METRIC_BATCH,
            "quality_metrics.image_reward.checkpoint": str(ckpts["image_reward"]),
            "quality_metrics.fid.inception_checkpoint": str(ckpts["inception"]),
            "quality_metrics.aesthetic_score.checkpoint": aesthetic_ckpt,
            "experiment_params.num_inference_steps": [nfe], "logger.run_id": "metrics",
            "dataset.prompts": str(repo / "data" / "dataset" / "img2annotations_test.json")}
        os.chdir(tmp)
        try:
            wrapper_counts(reset=True)
            t0 = time.perf_counter()
            with _RecordingVariants() as rec:
                metrics, traced = traced_launches(lambda: cli.run(config, overrides))
            wall = time.perf_counter() - t0
            counts = wrapper_counts()
            caps, graphs_gb = rec.captures()
            with open(Path(tmp) / "outputs" / "metrics" / "tables" / "final.tsv") as f:
                rows = list(csv.DictReader(f, delimiter="	"))
            # save_dir keeps the dataset's file names: PNG content under .jpg names.
            pngs = sorted((Path(tmp) / "outputs" / "DDIM" / label).iterdir())
            gen_imgs = np.stack([read_image(p) for p in pngs]) if pngs else None
            real_imgs = np.stack([read_image(p, SIZE) for p in sorted(img_dir.iterdir())])
        finally:
            os.chdir(cwd)
        row = rows[0] if rows else {}
        vals = {k: float(row[k]) for k in ("clip_score", "fid", "image_reward", "aesthetic_score")
                if k in row}
        print(f"ddim_config as shipped with a real-image directory ({label}, SD-1.5 bf16 "
              f"{SIZE}x{SIZE}, batch {METRIC_BATCH}, x0 of every sample; clip_score on ViT-B/16, "
              f"fid at feature 64 on FID-Inception, image_reward on BLIP ViT-L/16 + BERT, "
              f"aesthetic_score on ViT-L/14, random towers): whole CLI {wall:.3f} s, sweep "
              f"{row.get('time')} s/image, {vals}; {card}; graph captures {dict(caps)}; "
              f"launches: wrappers {counts}, trace {traced}", flush=True)
        if list(row) != ["exp", "nfe", "time", "clip_score", "fid", "image_reward",
                         "aesthetic_score"] or len(rows) != 1 or row["exp"] != label:
            raise AssertionError(f"metrics run: table rows {rows}")
        if metrics["exp"] != [label] or row["nfe"] != str(nfe):
            raise AssertionError(f"metrics run: CLI returned {metrics}")
        if not all(np.isfinite(v) for v in vals.values()) or not 0 <= vals["image_reward"] <= 1:
            raise AssertionError(f"metrics run: values {vals}")
        if len(pngs) != METRIC_BATCH or {_png_size(p) for p in pngs} != {(SIZE, SIZE)}:
            raise AssertionError(f"metrics run: {len(pngs)} PNGs, expected {METRIC_BATCH} of "
                                 f"{SIZE}x{SIZE}")
        if sorted(caps.values()) != [1]:
            raise AssertionError(f"metrics run: graph captures {caps}")
        if counts != want or traced != want_traced:
            raise AssertionError(f"metrics run: launches wrappers {counts}, trace {traced}; "
                                 f"expected {want} and {want_traced}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        fid = FID(feature=2048, inception_checkpoint=str(ckpts["inception"]), device="cuda")
        fid.update(real_imgs, real=True)
        fid.update(gen_imgs, real=False)
        fid_2048 = fid.compute()
        print(f"FID at feature 2048 (the whole FID-Inception, random weights) on the run's "
              f"{len(pngs)} PNGs against the {len(real_imgs)} real images: {fid_2048:.6g}",
              flush=True)
        if not np.isfinite(fid_2048):
            raise AssertionError(f"FID at 2048: {fid_2048}")
        l14 = _clip_backend(None, False, "cuda", "l14")
        backends = (_clip_backend("openai/clip-vit-base-patch16", False, "cuda"), l14,
                    AestheticScorer(aesthetic_ckpt, device="cuda"))
        scorer = ImageRewardScorer(str(ckpts["image_reward"]), device="cuda")
        inception = {64: InceptionFeatures(64, str(ckpts["inception"]), device="cuda"),
                     2048: fid._inception}
        out["card_vs_cpu"] = metrics_card_vs_cpu(l14, ckpts, real_imgs)
        out["device_ms_per_batch"] = metric_timings(card, backends, scorer, inception, gen_imgs)
        torch.backends.cudnn.allow_tf32 = True
    fp32 = report["attention_fp32"]
    fp32.update(launches=traced["attention_fp32"], wrapper_launches=counts["attention_fp32"],
                launches_from="torch.profiler trace of phase 9's CLI run (one validate batch of "
                              "the metric towers); wrapper_launches: the wrapper's count over "
                              "the same run")
    out.update(wall_s=wall, sec_per_image=float(row["time"]), values=vals, fid_2048=fid_2048,
               graph_reserved_gb=graphs_gb, wrapper_launches=counts, traced_launches=traced)
    report["e2e"]["metrics"] = out
    del scorer, inception, fid
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the denoising loop with torch.profiler")
    ap.add_argument("--json", default=None, help="write the full report to this path")
    args = ap.parse_args()

    phase("1. environment")
    if not torch.cuda.is_available():
        print("no CUDA device: this script needs a GPU", file=sys.stderr)
        sys.exit(1)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    cap = torch.cuda.get_device_capability(0)
    print(f"device {torch.cuda.get_device_name(0)}, capability {cap}")
    if cap != (9, 0):
        raise AssertionError(f"the kernels are built for sm_90a; device capability is {cap}")
    card = card_line()
    print(card)

    phase("2. kernel build")
    from sonicdiffusionbayeslab_torch.ops import _build

    t0 = time.perf_counter()
    _build.kernels()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    report_sass = sass_counts(_build)

    # The whole-batch run's UNet sees the CFG-doubled batch; the
    # unet_microbatch=2 run sees chunks of BATCH rows.
    run_counts, per_unet, per_vae = census(2 * BATCH)
    chunk_counts = census(BATCH)[0]
    # The tiny fp32 pipeline of phase 5 runs BATCH (two) prompts with CFG.
    tiny_counts, *tiny_census = census(2 * BATCH, tiny=True)
    # The CLI's CLIP score runs its vision tower once a validate batch.
    clip_counts, clip_tiny_counts = clip_census(CLI_BATCH), clip_census(CLI_BATCH, tiny=True)
    # Phase 9's metric towers a validate batch (ViT-B/16, BLIP twice,
    # ViT-L/14), and the tiny BLIP of its card-vs-CPU check.
    metric_counts, metric_tiny_counts = metric_census(METRIC_BATCH), metric_census(2, tiny=True)
    # The CLI runs of phases 6 and 7: UNet batch 16 (phase 6), 8 and 4 (CFG
    # at batch 4, LCM's batch 4 without it) with DeepCache's shallow call at
    # 8 and, in phase 7's engine timings, at 4; VAE decodes of 8, 4 and 1
    # latents (x0 decodes of one sample); the tower at the validate batch 4.
    # Phase 8 adds ToMe's merged shapes: the CLI runs' at UNet batch 8
    # (ratios 0.25 and 0.5, the DeepCache run's full and shallow calls at
    # 0.5) and the pipeline runs' at 4.
    cli_counts = collections.Counter()
    for kw in (dict(unet_batch=2 * CLI_BATCH, vae_batch=CLI_BATCH),
               dict(unet_batch=2 * METHOD_BATCH, vae_batch=METHOD_BATCH),
               dict(unet_batch=2 * METHOD_BATCH, shallow=True),
               dict(unet_batch=METHOD_BATCH, vae_batch=1),
               dict(unet_batch=2 * BATCH, shallow=True),
               *(dict(unet_batch=b, tome=r) for b in (2 * METHOD_BATCH, 2 * BATCH)
                 for r in TOME_RATIOS),
               dict(unet_batch=2 * METHOD_BATCH, shallow=True, tome=0.5)):
        cli_counts.update(module_census(**kw))
    # The tiny fp32 ToMe run of phase 8.
    tiny_counts.update(module_census(2 * BATCH, tiny=True, tome=0.5))
    clip_method_counts = clip_census(METHOD_BATCH)
    order = lambda ks: (ks[0], [str(v) for v in ks[1]])  # noqa: E731
    shapes = sorted(run_counts, key=order)
    check_shapes = sorted(set(run_counts) | set(chunk_counts) | set(cli_counts), key=order)
    fp32_shapes = ([(k, " (tiny pipeline)") for k in sorted(tiny_counts, key=order)]
                   + [(k, " (CLIP ViT-B/16)") for k in sorted(clip_counts, key=order)]
                   + [(k, " (CLIP ViT-B/16, batch 4)") for k in sorted(clip_method_counts,
                                                                       key=order)]
                   + [(k, " (CLIP tiny)") for k in sorted(clip_tiny_counts, key=order)]
                   + [(k, " (metric towers)") for k in sorted(metric_counts, key=order)]
                   + [(k, " (metric towers, tiny)") for k in sorted(metric_tiny_counts, key=order)])
    clip_per_batch = sum(clip_counts.values())
    print(f"main path per UNet forward: {dict(per_unet)}; per VAE decode: {dict(per_vae)}; "
          f"{len(check_shapes)} distinct kernel shapes over the main path's two runs and the "
          f"CLI runs of phases 6 and 7; the tiny fp32 "
          f"pipeline's: {dict(tiny_census[0])} and {dict(tiny_census[1])}, "
          f"{len(tiny_counts)} shapes; the CLIP vision towers' attention a validate batch: "
          f"{dict(clip_counts)}, tiny {dict(clip_tiny_counts)}")
    if clip_per_batch != 12:
        raise AssertionError(f"the ViT-B/16 census gives {dict(clip_counts)}, not 12 kernel "
                             "launches (one a layer)")
    # ViT-B/16 12 + BLIP (24 ViT-L/16 layers + 12 cross-attentions) x 2 + ViT-L/14 24.
    print(f"metric towers' fp32 attention a validate batch of {METRIC_BATCH}: {dict(metric_counts)}")
    if sum(metric_counts.values()) != 12 + 2 * (24 + 12) + 24:
        raise AssertionError(f"the metric towers' census gives {dict(metric_counts)}, not 108 "
                             "kernel launches")
    print_gn_plans(shapes)
    report = {k: {"launches": None, "wrapper_launches": None, "launches_from": None,
                  "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                  "bound_fma_ms": 0.0, "bound_by_ms": collections.Counter()}
              for k in (*KERNELS, "attention_fp32_unet")}
    report["errs"] = collections.defaultdict(list)
    report["e2e"] = {}

    phase("3. kernels against their plain versions, at the shapes of the main path and the CLI "
          "runs (and the tiny fp32 pipeline's and the CLIP towers')")
    check_kernels(check_shapes, fp32_shapes, report)

    phase("4. timings (bf16, and fp32 attention at the UNet's and the CLIP tower's shapes; CUDA "
          "graph of 20 calls between CUDA events, median of 5)")
    rows = time_kernels(shapes, run_counts, metric_counts, report)
    fields = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_fma_ms")
    fp32_totals = {k: report["attention_fp32_unet"][k] for k in fields}
    print("attention fp32 (flash_attention_tf32x3) totals over one run at the main path's UNet "
          "shapes: " + json.dumps(fp32_totals))
    print("attention fp32 (flash_attention_tf32x3) totals over one validate batch of phase 9's "
          "metric towers: " + json.dumps({k: report["attention_fp32"][k] for k in fields}))

    phase(f"5. main path: SD-1.5 {SIZE}x{SIZE}, {STEPS}-step DPM-Solver++ (order 2), "
          f"CFG {GUIDANCE}, batch {BATCH}")
    run_main_path(report, per_unet, per_vae, tiny_census, card, args.profile)

    phase(f"6. experiment CLI: configs/smoke.yaml at SD-1.5 {SIZE}x{SIZE}, {STEPS} steps, "
          f"batch {CLI_BATCH}, CLIP score on ViT-B/16")
    run_cli(report, per_unet, per_vae, clip_per_batch, card)
    report["e2e"]["cli"].update(clip_tower(card))

    phase(f"7. scheduler methods through the CLI at SD-1.5 {SIZE}x{SIZE}, batch {METHOD_BATCH}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report["e2e"]["methods_tiny_card_vs_cpu"] = methods_tiny_card_vs_cpu()
    torch.backends.cudnn.allow_tf32 = True
    report["e2e"]["engine_timings"] = engine_timings(card)
    report["e2e"]["methods"] = run_methods(card, METHOD_RUNS)

    phase(f"8. the remaining samplers and Token Merging at SD-1.5 {SIZE}x{SIZE}")
    run_samplers(report, card, per_vae, args.profile)

    phase(f"9. quality metrics: configs/ddim_config.yaml as shipped with a real-image directory "
          f"and aesthetic_score, SD-1.5 {SIZE}x{SIZE}, batch {METRIC_BATCH}")
    run_metrics(report, card, metric_counts)

    phase("10. kernels")
    print(f"phases 1-9 took {time.perf_counter() - _T0:.1f} s; {card}")
    kernels = []
    for kind, meta in KERNELS.items():
        r = report[kind]
        kernels.append({
            **meta,
            "launches": r["launches"], "wrapper_launches": r["wrapper_launches"],
            "launches_from": r["launches_from"],
            "phase7_wrapper_launches": {n: m["wrapper_launches"][kind]
                                        for n, m in report["e2e"]["methods"].items()},
            "phase8_wrapper_launches": {
                **{n: m["wrapper_launches"][kind]
                   for n, m in report["e2e"]["samplers_cli"].items()},
                **{f"pipeline {n}": c.get(kind, 0) for n, c in
                   report["e2e"]["sampler_pipeline"]["first_run_wrapper_launches"].items()},
                **{f"tiny {n}": m["fp32_attention_launches"] for n, m in
                   report["e2e"]["samplers_tiny_card_vs_cpu"].items()
                   if kind == "attention_fp32"}},
            "phase9_wrapper_launches": report["e2e"]["metrics"]["wrapper_launches"][kind],
            **({"phase6_launches": r["phase6_launches"]} if "phase6_launches" in r else {}),
            "max_abs_err": max(report["errs"][kind]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": max(r["bound_by_ms"], key=r["bound_by_ms"].get),
            "library_ms": r["library_ms"],
            **({"sass": report_sass[kind]} if kind in report_sass else {}),
            "totals_over": (f"the main path's {kind} shapes in {meta['dtype']}: per-shape "
                            "median x launches at that shape in one run" if kind in MAIN else
                            "the metric towers' attention shapes in float32 (ViT-B/16, BLIP "
                            "ViT-L/16 and its BERT cross-attention, ViT-L/14): per-shape median "
                            "x its launches in one validate batch of phase 9's CLI run"),
        })
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
             "kernels": kernels, "timings": rows, "tome_timings": report["tome_timings"],
             "e2e": report["e2e"],
             "attention_fp32_totals": fp32_totals,
             "profile": report.get("profile")}, indent=1))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
