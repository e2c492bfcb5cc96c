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
     512x512, random weights): configs unipc_config (10 steps, bh2,
     corrector, order 2), tome_config (ratios 0.25 and 0.5 at 10 steps: two
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
     LAION head) through the CLI at SD-1.5 full width (bf16 512x512, 10 DDIM
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
 10. SD-2.1 (768-v) and SDXL-base: the census of their full-width UNets
     (32 bf16 attention launches a SD-2.1 forward, 140 a SDXL forward, all
     at head_dim 64) and VAE decoders (SDXL's GroupNorm at 1024 x 1024
     rows a sample), found on the meta device; each kernel against its
     plain version at every shape of this phase (bf16; the plain version
     over batch slices where its fp32 intermediates pass 8 GB) and at the
     tiny runs' (fp32), and timed at the CLI runs' shapes; the tiny fp32
     SD-2.1 (v-prediction) and SDXL (added conditioning) pipelines,
     graphed, on the card against the CPU; configs/sd21_config.yaml and
     configs/sdxl_config.yaml as shipped through the CLI at 768^2 and
     1024^2, batch 8 (the first sweep point at 4 DPM++ steps, one batch,
     phase 9's real images and checkpoints: clip_score, fid at 64,
     image_reward), each traced: table, PNGs, one capture, peak memory,
     launches against the census by the wrappers and by the trace; and
     each family's 10-step DPM++ loop at batch 2, CFG 7.5 (engine level,
     median of 3, peak memory, a torch.profiler breakdown a step);
 11. img2img, inpainting and int8: the GroupNorm kernel against its plain
     version and timed at the VAE encoders' shapes (SD-1.5 at 512^2, batch
     2; SDXL's at 1024^2, one image); cuBLASLt's int8 GEMM (torch._int_mm)
     at every int8 conv shape of the phase, bit-equal to exact sums, timed,
     and traced (one "gemm_s8" kernel a call); tiny fp32 img2img and inpainting
     on the card against the CPU (1e-3) and a tiny int8_conv_only run held
     to the CPU's quantization drift; the SDXL VAE encoder alone on one
     1024^2 image (launches by wrappers and trace); SD-1.5 512^2 img2img
     (20-step DPM++ at strength 0.8: 16 rows, batch 2, CFG 7.5, from a PNG
     written and read back) through the pipeline, first run and traced
     warm run against the census with the encoder's launches, inpainting
     with a half mask whose kept half ends as the source's latents, and
     generate.py --init_image --mask_image; engine loops at batch 2 of
     exact DPM++, int8_conv_only and the turbo stack (ToMe 0.5 +
     int8_conv_only), the exact loop bit-equal after them; then
     configs/turbo_config.yaml as shipped but for 10 steps through the CLI (batch 8, phase
     9's real images and checkpoints), traced: table, PNGs, one capture,
     launches against the census, 50 int8 GEMMs a UNet forward by the
     wrappers and by kernel name in the trace, no int8 dense call; and an
     exact run of the phase's model before and after it, bit-equal;
 12. SD3-medium (MMDiT depth 24, 24 heads of 64; the 16-channel VAE; CLIP-L
     and bigG; T5-XXL) on random bf16 weights: the census of the MMDiT (24
     joint attentions a forward, at 4096 + 77 tokens at 1024^2; 4429 with
     T5, 2125 and 3149 under ToMe 0.5 and 0.25, 1101 at 512^2; 287 int8
     dense calls) and the SD3 decoder, found on the meta device; each
     kernel against its plain version at every shape of the phase (bf16;
     the plain version over batch slices) and at the tiny runs' and the
     towers' (fp32), the bf16 kernel on views of one concatenated q/k/v
     projection bit-equal to contiguous copies, and timed (the joint
     attention a forward beside SDPA and the bound); tiny fp32 SD3
     pipelines (exact, trunk-delta, ToMe, T5, two-scheduler, skip) on the
     card against the CPU within 1e-3 and an int8 one below the CPU's
     drift; through the pipeline at 1024^2, 8-step flow Euler (shift 3),
     CFG 7, batch 2: a run at 512^2, then exact, trunk-delta (interval 3,
     branch 2), ToMe 0.5 and int8 loops (first runs' launches against the
     census, warm execution_time and peak memory, the exact run traced),
     and use_t5 staged and resident, bit-equal; random SD3 and SD-1.5
     snapshots written, configs/sd3_config.yaml, sd3_skip_steps_config.yaml
     and sd3_two_schedulers_config.yaml as shipped through the CLI on the
     SD3 snapshot (first sweep point, cut to 6 and 12 steps in the first
     two, batch 4, phase 9's real images and checkpoints; the first
     traced): table, PNGs, one capture, launches;
     quality_frontier's main on both snapshots (16 rows); and the exact
     run again after them, bit-equal; after its census the rank processes
     of phases 16-18 start, import and wait for their go files;
 13. serving and the conditioning families at SD-1.5 width (random bf16
     weights, 512^2, 20-step DPM++, CFG 7.5): the census of the ControlNet
     call (its encoder copy before the UNet) and of the UNet with
     IP-Adapter's 4 image tokens (16 decoupled crosses a forward at M = 4:
     4,4096,4,8,40; 4,1024,4,8,80; 4,256,4,8,160; 4,64,4,8,160), each new
     shape against the plain version (bf16; fp32 at the tiny runs') and the
     M = 4 crosses timed beside SDPA and the bound; tiny fp32 ControlNet,
     IP-Adapter and prompt-weighting pipelines on the card against the CPU
     (1e-3); the exact, ControlNet and IP-Adapter loops at batch 2, graphed
     (first run's wrappers and a traced run against the census, warm
     execution_time, repeats bit-equal); serving.server.serve on port 0
     (max_batch 8, pipeline_depth 2) answering one warm batch and then 24
     concurrent /generate requests (every PNG decodes; a request alone
     bit-equal to a direct call of its batch; the device's uint8 round
     equal to the host's; the counters; e2e images/hour, captures, the
     worker's wait on the finisher), and a request at row 0 among 7
     others bit-equal to it alone (at row 3 it may differ by rounding:
     the UNet's library matmuls or convolutions sum by row position); and
     serve_bench's hero mode (batch 32, 128 requests);
 14. training at SD-1.5 width: the kernels against their plain versions at
     the phase's new shapes (the VAE encode at batch 8, the SD3 bench's
     joint attention over 4096 + 154 tokens, the tiny UNet's at batch 2);
     gradients through FlashAttentionFn and GroupNormSiLUFn (the kernel
     forward, the JAX package's stock backward) at every attention shape
     of the UNet at batch 8 and of the MMDiT at batch 2, and every
     GroupNorm shape of the UNet with SiLU on and off, bf16 and fp32,
     against autograd through the plain version in fp32 (GRAD_TOL), one
     launch a forward and none a backward; three tiny fp32 LoRA and full
     steps on the card against the CPU (1e-3), every adapter's b with a
     gradient at step 0 and every a from step 1; configs/train_lora.yaml
     as shipped through training.loop.run_training (batch 8 at 512^2,
     random bf16 weights; overridden: the dataset, 16 real PNGs under the
     first 16 names of img2annotations_train.json, num_steps 8, log_every
     4, save_dir): finite losses, steps/s, peak memory, the wrappers'
     launches equal to the census (32 attentions and 61 GroupNorms a step,
     22 GroupNorms an encode), lora_peft.npz with every target's tensors,
     fused by merge_lora into a 512^2 sample that differs from the base's,
     and a 2-step run traced against the census; the port's train_bench
     lora512, full512 and sd3_lora at 8 steps (their JSON lines; launches
     against the census, remat's twice a step); with --profile a trace of
     each of those modes' steps by kernel group, backward and optimizer;
 15. LCM distillation and textual inversion at SD-1.5 width: dk and dv
     through FlashAttentionFn with only K and V requiring grad (textual
     inversion's first cross-attention) at the UNet's cross shapes, bf16,
     against autograd through the plain version (GRAD_TOL); one LCM-LoRA,
     one w-conditioned full distill step and one textual-inversion step
     of the tiny fp32 UNet on the card against the CPU (TINY_GRAD_REL);
     training.mode distill through run_training (configs/train_lora.yaml's
     model and dataset, LCM-LoRA rank 64 on a 50-node grid, batch 8, 12
     steps): finite losses, steps/s, peak memory, launches equal to the
     census (96 attentions and 183 GroupNorms a step: the teacher at 16
     rows, the EMA target and the student at 8; 22 GroupNorms an encode),
     the teacher bit-equal, lora_peft.npz fused by merge_lora into a
     4-step LCM sample at consistency_model_config.yaml's guidance that
     differs from the base model's, a 2-step run traced; the w-conditioned
     full student (cond_proj 256 wide, w in [3, 15]) at batch 4 for 6
     steps, loaded strictly into a UNet with time_cond_proj_dim 256, LCM
     samples at batch 2 through the CUDA graph at two embedded guidance
     scales (different images), an eager forward bit-equal to the graphed
     one; textual inversion of two rows at batch 8 for 12 steps (only
     those rows change; launches 32 attentions and 61 GroupNorms a step;
     the embeddings' npz); with --profile a trace of a distill and a TI
     step by kernel group, backward and span;
 16. multi-device: a one-rank NCCL group; SD-1.5 data-parallel sampling
     and train_lora.yaml on two gloo ranks sharing the card (this script
     with --dp-rank), against one process; profiling.trace,
     trace_analysis and flops_estimate;
 17. tensor and sequence parallel on gloo ranks sharing the card (this
     script with --tp-rank; every time is contention, not scaling): (a)
     the split GroupNorm pair (group_norm_partials, group_norm_apply) at
     every GroupNorm shape of the SD-1.5 UNet at batch 4 in 2 and 4 row
     slices, bf16 and fp32, the statistics the apply kernel merged against
     all rows' and merge_group_stats', the output against
     plain_group_norm, two launches on one input bit-equal, both timed at
     a mesh_seq=2 rank's shapes; (b) SD-1.5 at 512^2 on two ranks at mesh_model=2 and at
     mesh_seq=2: one fp32 (TF32 off) and one bf16 UNet forward, a 4-step
     fp32 and a 4-step bf16 run, each against one process, every rank's
     launches equal to the census restated for the mode; (c) four ranks at
     mesh_seq=2 x mesh_model=2: both forwards and a 4-step bf16 run; (d)
     SD3-medium at 1024^2: at mesh_model=2 T5-XXL's block 0 (bf16, fp32)
     and its fp32 encode, and at mesh_model=2 and mesh_seq=2 one bf16 and
     one fp32 MMDiT forward and a 2-step run against one process; (e)
     serving.server.serve at mesh_model=2 answering one request, its PNG
     bit-equal to a direct call on the same ranks;
 18. the T5 tokenizer.json reader, the t5_bench twin and what a mesh ran
     only in the JAX package, on gloo ranks sharing the card against one
     process (this script with --tp-rank): a 32,100-piece tokenizer.json
     written here (no ``tokenizers`` on the card's machine), its ids equal
     to the pinned ones, SD3-medium with T5-XXL through it for 2 steps,
     the t5_bench twin staged and resident (SD3-medium + T5-XXL, 1024^2,
     batch 4, 8 steps; its two JSON lines); at mesh_model=2 one bf16 LoRA
     step (batch 2) and fp32 LoRA, full-with-remat, ControlNet and
     LCM-LoRA steps (SD-1.5 512^2, batch 1) and SD3's LoRA step (8 of the
     MMDiT's 24 blocks, 1024^2), each against one process's gradients,
     launches a rank equal to one process's; train_lora.yaml through the
     loop at mesh_data 1, mesh_model 2 against one process's run and
     files; fuse_lora into split weights, bit-equal to one process's
     fused weights cut to the rank's share; 4-step bf16 SD-1.5 runs under
     int8 at mesh_model=2 and int8_conv at mesh_seq=2 (within one process's
     own int8 drift plus its own bf16 reordering drift) and with ToMe 0.5
     at mesh_seq=2, and a 2-step SD3 DiT-ToMe run at mesh_seq=2 (mean |diff|
     <= 5e-2); then the kernels at every shape those runs recorded against
     their plain versions;
 19. on phase 5's SD-1.5 weights (kept in host memory since phase 5): the
     CFG shared prefix (SDBL_CFG_PREFIX=1, the NaN sanitizer on), graphed:
     its census on the meta device (32 attention and 61 GroupNorm launches
     a forward, the first self-attention and three GroupNorms at B rows),
     each kernel against its plain version (bf16 and fp32) and timed at the
     shapes it adds, the capturing run's wrapper launches and a warm run's
     trace against the census, its images against the plain run's (mean
     |diff| <= 5e-2), an fp32 forward (TF32 off) against the plain one
     (relative L2 <= 1e-5), the loops in turns; a fused-q/k/v copy of the
     UNet from those weights: its fp32 forward (TF32 off) against the
     separate one's (relative L2 <= 1e-5), one eager forward traced beside the
     separate one's (the cuBLAS GEMMs drop by the projections fused), a
     20-step run (wrappers, images within 5e-2), the bf16 attention kernel
     on fused strided q/k/v views at every main-path shape; the sanitizer
     raising on the tiny fp32 dpmsolver + final_sigmas_type="zero" run;
 20. the card line, then one JSON ``kernels`` line (the fp32 attention
     kernel's entry is phase 9's metric towers: 108 launches a validate
     batch; each entry also lists its launches in each phase-7 to phase-19
     run, and its phase-10 and phase-12 sums over one forward and one
     decode; the split GroupNorm pair's entries are phase 17's mesh_seq=2
     run);
 21. the last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import base64
import collections
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

# Each kernel's symbol in a profiler trace (one kernel a call each),
# cuBLASLt's int8 GEMM kernels' (torch._int_mm), and the profiles' groups.
from sonicdiffusionbayeslab_torch.utils.trace_analysis import (INT8_GEMM_SYMBOL, SYMBOLS,
                                                               kernel_group)

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM, dense
# fp32 attention runs its products as split TF32: three TF32 tensor-core
# products (495 TFLOP/s dense) for each fp32-accurate one.
PEAK_TF32X3 = 495e12 / 3
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
PEAK_INT8 = 1979e12  # H100 SXM int8 tensor-core operations a second, dense
# Traced kernels before a traced run (traced_launches), in bursts of
# PAD_BURST, each burst PAD_GAP_S after the last one ended: ~0.14 s in all.
PAD_KERNELS, PAD_BURST, PAD_GAP_S = 1024, 32, 0.004
# Traces of one run that ``traced_exact`` takes at most (see there).
TRACE_ATTEMPTS = 3
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
# (SAMPLER_STEPS was 20 until phase 19 came: steps cut, never widths, to keep
# the script inside its time limit.)
TOME_RATIOS, SAMPLER_STEPS = (0.25, 0.5), 10
SAMPLER_RUNS = [
    ("unipc_config", {_P + "num_inference_steps": [SAMPLER_STEPS]},
     [(f"steps_{SAMPLER_STEPS}", None)], SAMPLER_STEPS, 2, True, None),
    ("tome_config", {_P + "tome_ratio": list(TOME_RATIOS),
                     _P + "num_inference_steps": [SAMPLER_STEPS]},
     [(f"ratio_{r}_steps_{SAMPLER_STEPS}", r) for r in TOME_RATIOS], SAMPLER_STEPS, 2, True, None),
    ("deep_cache_config", {_P + "cache_interval": [5], _P + "cache_branch_id": 0,
                           _P + "num_inference_steps": [SAMPLER_STEPS], _P + "tome_ratio": 0.5},
     [(f"interval_5_steps_{SAMPLER_STEPS}", 0.5)], SAMPLER_STEPS, 2, False, SAMPLER_STEPS // 5),
]

# Phase 9: the reference's quality metrics through configs/ddim_config.yaml
# as shipped (clip_score, image_reward, fid at feature 64) plus
# aesthetic_score, with a real-image directory: SD-1.5 512^2, one sweep
# point of 20 DDIM steps, batch METRIC_BATCH.
# (METRIC_STEPS was STEPS, 20, until phase 19 came: steps cut, never widths.)
METRIC_BATCH, METRIC_STEPS = 8, 10
# Card against CPU (fp32, TF32 off, two images), |card - cpu| <= atol + rtol
# * |cpu|: unit-norm CLIP embeddings through 24 layers and Inception
# features through 94 convolutions summed in another order (cuDNN and the
# kernel against oneDNN and the plain path); ImageReward's z-scores, O(1)
# after 36 layers and an unnormalised head.
METRIC_TOL = {"clip_l14_embedding": (1e-4, 0.0), "inception_2048": (1e-4, 1e-4),
              "image_reward": (1e-3, 1e-3), "image_reward_tiny": (1e-4, 1e-4)}
# Phase 10: SD-2.1 (768-v) and SDXL-base through their shipped configs at
# full width, batch FAMILY_BATCH (UNet batch 16 with CFG), the first sweep
# point of each and one batch of the prompt file; then their engines'
# ENGINE_STEPS-step DPM++ loops at batch BATCH, CFG GUIDANCE.
# (The CLI runs' steps were 10 and ENGINE_STEPS 20 until phase 19 came:
# steps cut, never widths, to keep the script inside its time limit.)
FAMILY_BATCH, ENGINE_STEPS = 8, 10
FAMILIES = {
    "sd21": dict(config="sd21_config", size=768, steps=4, pipeline="stable_diffusion_model",
                 kw={"variant": "sd21"}, prediction_type="v_prediction"),
    "sdxl": dict(config="sdxl_config", size=1024, steps=4, pipeline="stable_diffusion_xl_model",
                 kw={}, prediction_type="epsilon"),
}
# Phase 11: img2img and inpainting at SD-1.5 width (STEPS-step DPM++ at
# STRENGTH runs its last IMG2IMG_ROWS rows, batch BATCH, CFG GUIDANCE), the
# SDXL VAE's encoder alone at ENC_XL_SIZE^2 (one image), and
# configs/turbo_config.yaml as shipped through the CLI (ToMe TURBO_TOME and
# int8_conv_only, batch TURBO_BATCH).
STRENGTH, IMG2IMG_ROWS, ENC_XL_SIZE = 0.8, 16, 1024
# (TURBO_STEPS: the config's 20 until phase 19 came; steps cut, never widths.)
TURBO_BATCH, TURBO_TOME, TURBO_QUANT, TURBO_STEPS = 8, 0.5, "int8_conv_only", 10
# The int8 3x3 convs of one SD-1.5 UNet forward: 22 ResnetBlocks x 2, 3
# Downsample and 3 Upsample.
INT8_CONVS = 50
# Phase 12: SD3-medium (MMDiT of depth 24, 24 heads of 64; the 16-channel
# VAE; CLIP-L and bigG, optionally T5-XXL) on random bf16 weights at
# SD3_SIZE^2: SD3_STEPS-step flow Euler at shift SD3_SHIFT, CFG
# SD3_GUIDANCE, batch BATCH, exact, with the trunk-delta cache at
# (interval, branch) SD3_CACHE, ToMe at SD3_TOME and int8, and one run at
# SD3_SMALL^2; the three shipped SD3 configs through the CLI at batch
# SD3_CLI_BATCH, each at its first sweep point: (config, overrides, label,
# nfe, MMDiT rows a call (the configs' unet_microbatch), x0 captured); and
# the quality frontier at FRONTIER's prompts, batches and steps.
# (SD3_STEPS was 28 until phase 18 came, and 14 until the script first
# passed its time limit on a slow host: depth cut, never width.)
SD3_SIZE, SD3_STEPS, SD3_GUIDANCE, SD3_SHIFT = 1024, 8, 7.0, 3.0
SD3_CACHE, SD3_TOME, SD3_SMALL, SD3_CLI_BATCH = (3, 2), 0.5, 512, 4
# (sd3_config ran 14 steps and sd3_skip_steps_config 20 until phase 19 came:
# steps cut, never widths.)
SD3_CLI_RUNS = [
    ("sd3_config", {_P + "num_inference_steps": [6]}, "steps_6", 6, 8, True),
    ("sd3_skip_steps_config", {_P + "num_inference_steps": [12], _P + "skip_steps": [[5, 10]]},
     "steps_12_skip_5-10", 10, 2, True),
    ("sd3_two_schedulers_config", {_P + "num_inference_steps_first": [20],
                                   _P + "num_inference_steps_second": [20],
                                   _P + "num_step_switch": [5]},
     "first_20_second_20_switch_5", 21, 2, False),
]
FRONTIER = dict(prompts=2, batch=2, sd3_batch=2, steps=4)
# Phase 13: HTTP serving at max_batch SERVE_BATCH (SERVE_REQUESTS concurrent
# requests), serve_bench's hero mode (batch SERVE_BENCH_BATCH), and the
# ControlNet and IP-Adapter loops (IP_TOKENS image tokens) at batch BATCH.
SERVE_BATCH, SERVE_REQUESTS, SERVE_BENCH_BATCH, IP_TOKENS = 8, 24, 32, 4
# cuda_ms captures a call that takes this long (ms, its second call) alone.
LONG_CALL_MS = 2.0
# The plain versions' fp32 intermediates a call, at most: a larger call
# runs them over slices of the batch (the same function).
PLAIN_BYTES = 8e9


_T0 = time.perf_counter()
_IMPORTED_AT = time.time()  # a rank process's start-up ends here


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
    kernel's time is its device time; inputs stay in L2 where they fit.
    A call that takes LONG_CALL_MS or more (a plain version at a large
    shape) is captured alone: a graph's launch is ~10 us, under 1% of it,
    and the script's time goes elsewhere."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as graphs need
        fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        if a.elapsed_time(b) >= LONG_CALL_MS:
            reps = 1
        else:
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


def family_configs(family="sd15", tiny=False):
    """(UNetConfig, VAEConfig, latent size) of a family's pipeline at its
    full width and size (SD-1.5 at SIZE, SD-2.1 and SDXL at their
    configs' FAMILIES sizes), or with ``tiny`` its tiny configs at
    the tiny pipelines' 8x8 latents."""
    from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
    from sonicdiffusionbayeslab_torch.models.vae import VAEConfig

    unet = {"sd15": (UNetConfig.sd15, UNetConfig.tiny), "sd21": (UNetConfig.sd21, UNetConfig.tiny21),
            "sdxl": (UNetConfig.sdxl, UNetConfig.tiny_xl)}[family][int(tiny)]()
    vae = VAEConfig.tiny() if tiny else (VAEConfig.sdxl() if family == "sdxl" else VAEConfig.sd15())
    lat = 8 if tiny else (FAMILIES[family]["size"] if family in FAMILIES else SIZE) // 8
    return unet, vae, lat


def module_census(unet_batch=None, vae_batch=None, tiny=False, shallow=False, tome=None,
                  family="sd15", enc_batch=None, enc_size=None, quant=None, ip=False,
                  control=False, prefix=False):
    """{(kind, shape): launches} of one UNet call at ``unet_batch`` rows
    (DeepCache's shallow call at branch 0 with ``shallow``, else the plain
    or full call; with Token Merging at ratio ``tome``, whose merged
    self-attentions run at N = M = tokens - r; in the int8 mode ``quant``,
    whose int8 GEMMs are counted as ("int8_conv" or "int8_dense", (M, K,
    N))), one VAE decode of ``vae_batch`` latents and one VAE encode of
    ``enc_batch`` images of ``enc_size`` (default: the decode's image
    size), from the UNet and VAE of ``family`` (sd15, sd21 or sdxl:
    ``family_configs``; with ``tiny``, its tiny configs at the tiny
    pipelines' 8x8 latents) run on the meta device with the kernel entry
    points replaced by shape recorders.  ``ip``: the UNet call with
    IP-Adapter's 4 image tokens (a decoupled cross-attention beside each
    cross-attention); ``control``: the ControlNet's call before it;
    ``prefix``: the CFG shared prefix's call (``unet_batch`` is the
    CFG-doubled batch: the sample has half its rows)."""
    from sonicdiffusionbayeslab_torch.models import layers
    from sonicdiffusionbayeslab_torch.models.controlnet import ControlNet
    from sonicdiffusionbayeslab_torch.models.unet import UNet2DCondition
    from sonicdiffusionbayeslab_torch.models.vae import AutoencoderKL
    from sonicdiffusionbayeslab_torch.ops import quant as Q
    from sonicdiffusionbayeslab_torch.ops.attention import uses_kernel
    from sonicdiffusionbayeslab_torch.ops.groupnorm import resolve_groups
    from sonicdiffusionbayeslab_torch.ops.tome import TomeConfig

    calls = collections.Counter()

    def q_conv(conv, x, padding):
        y = layers.conv_nhwc(conv, x)
        B, Ho, Wo, O = y.shape
        calls[("int8_conv", (B * Ho * Wo, conv.weight[0].numel(), O))] += 1
        return y

    def q_dense(layer, x):
        calls[("int8_dense", (x.numel() // x.shape[-1], x.shape[-1], layer.weight.shape[0]))] += 1
        return torch.nn.functional.linear(x, layer.weight.flatten(1))

    def gn(x, weight, bias, groups=32, eps=1e-5, silu=True):
        B, C = x.shape[0], x.shape[-1]
        calls[("group_norm", (B, x.numel() // (B * C), C, resolve_groups(C, groups), eps, silu))] += 1
        return torch.empty_like(x)

    def attn(q, k, v, mask=None):
        if uses_kernel(q, mask):
            B, N, H, D = q.shape
            calls[("attention", (B, N, k.shape[1], H, D))] += 1
        return torch.empty_like(q)

    saved = layers.group_norm_silu, layers.dot_product_attention, Q.conv_int8, Q.linear_int8
    layers.group_norm_silu, layers.dot_product_attention = gn, attn
    Q.conv_int8, Q.linear_int8 = q_conv, q_dense
    unet_cfg, vae_cfg, lat = family_configs(family, tiny)
    try:
        with torch.device("meta"):
            if unet_batch:
                unet = Q.set_quant_mode(UNet2DCondition(unet_cfg), quant)
                b = unet_batch
                args = (torch.empty(b, lat, lat, 4), torch.empty(b),
                        torch.empty(b, 77, unet_cfg.cross_attention_dim))
                # SDXL's pooled text embeddings and time_ids.
                added = (() if unet_cfg.pooled_dim is None else
                         (torch.empty(b, unet_cfg.pooled_dim), torch.empty(b, 6)))
                kw, dst = {}, None
                if tome:
                    kw["tome"] = cfg = TomeConfig(tome)
                    slots = unet.tome_slots(lat, lat, cfg, 0 if shallow else None)
                    dst = torch.zeros(len(slots), cfg.n_dst(lat, lat), dtype=torch.int64)
                if control:
                    kw["control_residuals"] = ControlNet(unet_cfg)(
                        *args, torch.empty(b, 8 * lat, 8 * lat, 3), torch.empty(()), *added)
                if ip:
                    unet.add_ip_adapter()
                    added = (*(added or (None, None)),
                             torch.empty(b, 4, unet_cfg.cross_attention_dim), torch.empty(()))
                if shallow:
                    unet(*args, torch.empty((b,) + unet.cache_shape(lat, lat, 0)), dst, *added,
                         cache_branch_id=0, **kw)
                elif prefix:
                    unet(args[0][:b // 2], args[1][:b // 2], args[2], None, dst,
                         cfg_shared_prefix=True, **kw)
                else:
                    unet(*args, None, dst, *added, **kw)
            if vae_batch or enc_batch:
                vae = AutoencoderKL(vae_cfg)
            if vae_batch:
                vae.decode(torch.empty(vae_batch, lat, lat, 4))
            if enc_batch:
                size = enc_size or lat * 2 ** (len(vae_cfg.block_out_channels) - 1)
                vae.encode(torch.empty(enc_batch, size, size, 3))
    finally:
        (layers.group_norm_silu, layers.dot_product_attention, Q.conv_int8,
         Q.linear_int8) = saved
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


def plain_rows(kind, shape):
    """Batch rows one plain-version call takes: all of them unless its fp32
    intermediates (attention: logits, softmax and probabilities, 10 bytes
    a logit; GroupNorm: about four fp32 copies of x) pass PLAIN_BYTES."""
    if kind == "attention":
        B, N, M, H, _ = shape
        per_row = 10 * H * N * M
    else:
        B, N, C = shape[:3]
        per_row = 16 * N * C
    return max(1, min(B, int(PLAIN_BYTES // per_row)))


def run_kernel(kind, shape, inputs):
    """(kernel call, plain call) on ``inputs``; the plain call runs over
    slices of ``plain_rows`` batch rows (each row's math is independent)."""
    from sonicdiffusionbayeslab_torch.ops.attention import plain_attention
    from sonicdiffusionbayeslab_torch.ops.flash_attention import flash_attention
    from sonicdiffusionbayeslab_torch.ops.groupnorm import group_norm_silu, plain_group_norm

    rows = plain_rows(kind, shape)

    def sliced(fn, batched, *rest):
        B = batched[0].shape[0]
        if rows >= B:
            return fn(*batched, *rest)
        return torch.cat([fn(*(t[i:i + rows] for t in batched), *rest)
                          for i in range(0, B, rows)])

    if kind == "attention":
        q, k, v = inputs
        return (lambda: flash_attention(q, k, v)), (lambda: sliced(plain_attention, (q, k, v)))
    _, _, _, G, eps, silu = shape
    x, w, b = inputs
    return (lambda: group_norm_silu(x, w, b, G, eps, silu),
            lambda: sliced(plain_group_norm, (x,), w, b, G, eps, silu))


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
    and the library call (``cuda_ms``: graphs of 20 calls, or of 5 where
    the bound passes 1 ms, or of one where a call takes LONG_CALL_MS),
    beside the bound; printed."""
    inputs = (attn_inputs if kind == "attention" else gn_inputs)(shape, dtype, gen)
    kern, plain = run_kernel(kind, shape, inputs)
    b_ms, b_by = bound(kind, shape, dtype)
    reps = 20 if b_ms < 1.0 else 5
    row = dict(kernel=kind, dtype=str(dtype)[6:], shape=list(shape), path=path,
               launches_per_run=launches,
               ms=cuda_ms(kern, reps), plain_ms=cuda_ms(plain, reps),
               library_ms=cuda_ms(library_call(kind, shape, inputs), reps),
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


def _pads():
    """PAD_KERNELS spin kernels in bursts of PAD_BURST, PAD_GAP_S apart."""
    for i in range(PAD_KERNELS):
        torch.cuda._sleep(1000)
        if (i + 1) % PAD_BURST == 0:
            torch.cuda.synchronize()
            time.sleep(PAD_GAP_S)


class TraceLost(AssertionError):
    """A trace that recorded none of its leading or none of its trailing pads."""


def device_event_names(prof, device_type=None):
    """The names of a finished torch.profiler trace's device events (or
    its events on ``device_type``), in the order ``prof.events()`` gives
    them (by start, the longer first), read from the raw Kineto events it
    builds that list from: ``events()`` makes a Python object a CPU op or
    kernel and a tree of them, seconds for a traced CLI run, and only the
    kernels' names are needed."""
    from torch.autograd import DeviceType

    device_type = DeviceType.CUDA if device_type is None else device_type
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == device_type
           and not getattr(e, "is_hidden_event", lambda: False)()]
    evs.sort(key=lambda e: (e.start_ns(), -e.end_ns()))
    return [e.name() for e in evs]


def traced_launches(run, symbols=None):
    """``run()``'s result and the executions on the card of each kernel of
    ours (every key of SYMBOLS), by symbol, from a torch.profiler (CUPTI)
    trace of it: graph replays included, set-up excluded.  ``symbols``
    ({key: name substring, or a predicate of the name}) adds the
    executions of kernels whose names hold each substring (or pass the
    predicate) under each key."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # CUPTI drops the first kernels launched as tracing starts: how many
        # grows over a long process and does not depend on their spacing
        # (1-33 of 64 pads, back to back or 2 ms apart alike; on one machine
        # all 64).  So PAD_KERNELS spin kernels spread over ~0.14 s and a
        # pause come first; a pad recorded means the dropped prefix ended
        # before the run began.  A pause and as many pads come last, so a
        # loss at the end shows too.  Losses inside the run are left to
        # traced_exact.
        _pads()
        time.sleep(0.1)
        out = run()
        torch.cuda.synchronize()
        time.sleep(0.1)
        _pads()
        torch.cuda.synchronize()
    seen = device_event_names(prof)
    counts = {kind: sum(sym in n for n in seen) for kind, sym in SYMBOLS.items()}
    for key, sym in (symbols or {}).items():
        counts[key] = sum(sym(n) if callable(sym) else sym in n for n in seen)
    is_pad = ["spin_kernel" in n for n in seen]
    lead = next((i for i, p in enumerate(is_pad) if not p), len(seen))
    trail = next((i for i, p in enumerate(reversed(is_pad)) if not p), 0)
    among = sum(is_pad) - lead - trail
    if lead != PAD_KERNELS or trail != PAD_KERNELS or among:
        print(f"trace: CUPTI recorded {lead} of the {PAD_KERNELS} leading pad kernels and "
              f"{trail} of the trailing ones, {among} pads among the other device events, of "
              f"{len(seen)} device events", flush=True)
    if not lead or (not trail and lead < len(seen)):
        raise TraceLost(f"CUPTI dropped every {'leading' if not lead else 'trailing'} pad "
                        "kernel: the trace may have lost the run's kernels")
    return out, counts


def traced_exact(run, want, what, same=None, reset=None, symbols=None):
    """``traced_launches(run, symbols)`` whose counts must equal WANT ({kind:
    executions}) on every key of WANT: ``(out, counts, traces taken)``.
    CUPTI has lost records inside a trace's run as well: once every kernel
    after a CLI run's denoising loop, once one GroupNorm of a loop's 1760,
    each with its pads recorded.  So a trace short of WANT in some kind and
    over it in none, whose output passes ``same`` (where given: equal to an
    untraced run's), or one that lost all its leading or trailing pads
    (``TraceLost``), is printed and the run traced again, ``reset()``
    first (the state the run's checks read: wrapper counts, recorded
    engines, peak memory), up to TRACE_ATTEMPTS traces in all.  The run
    replays the same CUDA graphs each time: one that launched fewer kernels
    is short in every trace, and a trace over WANT raises at once."""
    history = []
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        if attempt > 1 and reset is not None:
            reset()
        try:
            out, counts = traced_launches(run, symbols)
        except TraceLost as e:
            history.append(f"none: {e}")
            print(f"trace {attempt} of {TRACE_ATTEMPTS} of {what}: {e}", flush=True)
            continue
        got = {k: counts[k] for k in want}
        if got == want:
            return out, counts, attempt
        history.append(got)
        short = all(got[k] <= n for k, n in want.items())
        kept = same is None or same(out)
        print(f"trace {attempt} of {TRACE_ATTEMPTS} of {what}: kernel executions {got}, "
              f"expected {want}; short in some kind and over in none: {short}; output equal "
              f"to an untraced run's: {kept}", flush=True)
        if not (short and kept):
            break
    raise AssertionError(f"{what}: traced kernel executions {history[-1]}, expected {want} "
                         f"(trace {attempt} of at most {TRACE_ATTEMPTS}; every trace's: "
                         f"{history})")


def retrace_reset(rec=None, int8=False, run_dir=None):
    """``traced_exact``'s ``reset`` for a run whose checks read the wrapper
    counts (and the int8 counts), the engines ``rec`` recorded and the peak
    memory: each anew, the earlier attempt's engine and graphs dropped.  For
    a CLI run, ``run_dir`` (its logger's directory) is removed: its
    sweep_state.json would make the retried sweep skip every point it has
    done, so the retrace would launch nothing."""
    def reset():
        if run_dir is not None:
            shutil.rmtree(run_dir, ignore_errors=True)
        if rec is not None:
            rec.made.clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        wrapper_counts(reset=True)
        if int8:
            int8_counts(reset=True)
    return reset


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
        (imgs_traced, _, _), traced, _ = traced_exact(
            lambda: model(PROMPTS, unet_microbatch=mb, **kw),
            {k: STEPS * (mb or 1) * per_unet[k] + per_vae[k] for k in MAIN}, f"the {name} run",
            same=lambda o: np.array_equal(o[0], imgs), reset=retrace_reset())
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
    return model


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
        eager, traced, _ = traced_exact(lambda: eng.unet(lat, tb, embeds), want,
                                        "an eager UNet forward", reset=retrace_reset())
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


def profile_loop(model, tome=None, size=SIZE, label=None):
    """Device time by kernel group over one 20-step denoising loop of the
    pipeline's plan (UNet forwards at the model batch, CFG combine,
    scheduler rows; no decode; with Token Merging at ratio ``tome``, whose
    sorts, gathers and scatters are a group of their own), from
    torch.profiler, per step, beside the loop's wall clock.  The prompts
    are encoded as the pipeline encodes them (with SDXL's added
    conditioning)."""
    from torch.profiler import ProfilerActivity, profile

    eng = model.engine
    plan = model.build_plan(STEPS)
    lat_hw = (size // 8, size // 8)
    emb, neg = model._encode(PROMPTS), model._encode([""] * BATCH)
    kw = dict(guidance_scale=GUIDANCE, latent_hw=lat_hw, decode=False, tome=tome,
              **model._extra_sample_kwargs(BATCH, lat_hw))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loop_s = eng.sample(plan, emb, neg, **kw).execution_time
    by_name = collections.Counter()
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if dev_us and e.key and not e.key.startswith(("aten::", "cuda", "Profiler")):
            by_name[e.key] += dev_us / 1e3 / STEPS
    groups = collections.Counter()
    for k, v in by_name.items():
        groups[kernel_group(k, tome=bool(tome))] += v
    device_ms = sum(by_name.values())
    step_ms = loop_s * 1e3 / STEPS  # profiler on: the loop runs slower than unprofiled
    out = dict(step_wall_ms=step_ms, step_device_ms=device_ms,
               device_idle_share=max(0.0, 1 - device_ms / step_ms) if device_ms else None,
               groups_ms_per_step=dict(groups.most_common()),
               top_kernels_ms_per_step={k[:120]: v for k, v in by_name.most_common(12)})
    name = label or ("profile" if tome is None else f"profile tome {tome}")
    print(f"{name} {json.dumps(out)}")
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
                    metrics, traced, _ = traced_exact(lambda: cli.run(config, overrides),
                                                      want_traced, "the CLI traced run",
                                                      reset=retrace_reset(
                                                          run_dir=Path(tmp) / "outputs" / run))
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
            def __init__(self, fn, **kw):
                super().__init__(fn, **kw)
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
                            metrics, traced, _ = traced_exact(
                                lambda: cli.run(config, overrides), dict(want_traced),
                                f"the {name} CLI run",
                                reset=lambda: (merged.clear(), retrace_reset(
                                    rec, run_dir=Path(tmp) / "outputs" / name)()))
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
    # the CLI runs'), with its launches in one SAMPLER_STEPS-step tome_config point.
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for ratio in TOME_RATIOS:
        calls = module_census(2 * METHOD_BATCH, tome=ratio)
        n = 4096 - int(4096 * ratio)
        shape = (2 * METHOD_BATCH, n, n, 8, 40)
        rows.append(timing_row("attention", shape, torch.bfloat16, f"tome_{ratio}",
                               SAMPLER_STEPS * calls[("attention", shape)], gen))
    report["tome_timings"] = rows


# ------------------------------------------------------- quality metrics
def metric_census(batch, tiny=False, aesthetic=True):
    """{(kind, shape): launches} of one validate batch of phase 9's metric
    towers: the CLIP score's ViT-B/16 vision and text towers, ImageReward's
    BLIP twice (the real and the generated images), the aesthetic score's
    ViT-L/14 unless not ``aesthetic`` (phase 10's configs have none;
    ``tiny``: the tiny towers); from the modules run on the meta
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
        vision = [CLIPVisionConfig()] + [CLIPVisionConfig.vit_l14()] * aesthetic
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


def run_metrics(report, card, metric_counts, tmp):
    """Phase 9: ``cli.run`` of configs/ddim_config.yaml as shipped, at SD-1.5
    512^2, with ``aesthetic_score`` added and only the image directory, its
    count, the batch, the checkpoints' paths and the sweep's length
    overridden, in the directory ``tmp`` (which keeps the real images and
    the checkpoints for phase 10: returned), traced: its table row
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
    nfe, label = METRIC_STEPS, f"steps_{METRIC_STEPS}"
    per_unet = _kinds(module_census(2 * METRIC_BATCH))
    per_vae = _kinds(module_census(vae_batch=METRIC_BATCH))
    W = GraphedCall.WARMUP
    fp32_per_batch = sum(metric_counts.values())
    want = {k: (W + 1) * per_unet[k] + (1 + nfe) * per_vae[k] for k in MAIN}
    want_traced = {k: (W + nfe) * per_unet[k] + (1 + nfe) * per_vae[k] for k in MAIN}
    want["attention_fp32"] = want_traced["attention_fp32"] = fp32_per_batch
    out = {}
    cwd = os.getcwd()
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
            metrics, traced, _ = traced_exact(lambda: cli.run(config, overrides), want_traced,
                                              "the metrics CLI run", reset=retrace_reset(
                                                  rec, run_dir=Path(tmp) / "outputs" / "metrics"))
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
    return dict(img_dir=img_dir, ckpts=ckpts)


# ------------------------------------------------- SD-2.1 and SDXL (phase 10)
def family_pipeline(family, **kw):
    """The family's registered pipeline (``FAMILIES``) with ``kw``; SD-2.1's
    scheduler predicts v, as its config's."""
    from sonicdiffusionbayeslab_torch.registry import load_all_plugins, models_registry
    from sonicdiffusionbayeslab_torch.schedulers import DPMSolverScheduler

    load_all_plugins()
    meta = FAMILIES[family]
    model = models_registry[meta["pipeline"]](**meta["kw"], **kw)
    model.scheduler = DPMSolverScheduler(solver_order=2, prediction_type=meta["prediction_type"])
    return model


def family_census():
    """Per family: {(kind, shape): launches} of one UNet forward at the CLI
    runs' UNet batch (2 x FAMILY_BATCH) and of one VAE decode of
    FAMILY_BATCH latents, and the shapes of every UNet and VAE call phase
    10 makes (also the engine timings' UNet batch 2 x BATCH) and of its
    tiny fp32 runs."""
    out = {}
    for family in FAMILIES:
        unet = module_census(2 * FAMILY_BATCH, family=family)
        vae = module_census(vae_batch=FAMILY_BATCH, family=family)
        engine = module_census(2 * BATCH, family=family)
        tiny_unet = module_census(2 * BATCH, tiny=True, family=family)
        tiny_vae = module_census(vae_batch=BATCH, tiny=True, family=family)
        out[family] = dict(unet=unet, vae=vae, engine=engine, tiny_unet=tiny_unet,
                           tiny_vae=tiny_vae)
    return out


def check_family_kernels(census, report):
    """Each kernel against its plain version at every phase-10 shape: bf16
    at the full-width runs' (the plain version over batch slices where its
    fp32 intermediates pass PLAIN_BYTES), fp32 at the tiny runs'; max
    errors into ``report["errs"]``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(10)
    work = sorted({(k, torch.bfloat16) for c in census.values()
                   for part in ("unet", "vae", "engine") for k in c[part]} |
                  {(k, torch.float32) for c in census.values()
                   for part in ("tiny_unet", "tiny_vae") for k in c[part]},
                  key=lambda w: (str(w[1]), w[0][0], [str(v) for v in w[0][1]]))
    for (kind, shape), dtype in work:
        inputs = (attn_inputs if kind == "attention" else gn_inputs)(shape, dtype, gen)
        kern, plain = run_kernel(kind, shape, inputs)
        got = kern()
        torch.cuda.synchronize()
        err = compare(kind, dtype, got, plain(), f"{kind} {shape} {dtype} (phase 10)")
        report["errs"][report_key(kind, dtype)].append(err)
        report["phase10_errs"][report_key(kind, dtype)].append(err)
        print(f"phase 10 {kind} {str(dtype)[6:]} {shape}: max abs err {err:.3e}")
        del inputs, got
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    return len(work)


def time_family_kernels(census, card):
    """Timing rows (``timing_row``) at each family's CLI-run shapes, bf16:
    a UNet forward's (launches a forward) and a VAE decode's (launches a
    decode); and per family and kernel the sums over one forward and one
    decode (per-shape median x launches)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows, totals = [], {}
    for family, c in census.items():
        for part in ("unet", "vae"):
            for (kind, shape), n in sorted(c[part].items(), key=lambda kv: (
                    kv[0][0], [str(v) for v in kv[0][1]])):
                r = timing_row(kind, shape, torch.bfloat16, f"{family} {part}", n, gen)
                rows.append(r)
                agg = totals.setdefault(family, {}).setdefault(part, {}).setdefault(
                    kind, dict(launches=0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0))
                agg["launches"] += n
                for field in ("ms", "plain_ms", "library_ms", "bound_ms"):
                    agg[field] += r[field] * n
        torch.cuda.empty_cache()
    print("phase 10 kernel totals (ms over one UNet forward at UNet batch "
          f"{2 * FAMILY_BATCH} and one VAE decode of {FAMILY_BATCH}; {card}): "
          + json.dumps(totals), flush=True)
    return rows, totals


def families_tiny_card_vs_cpu(census):
    """The tiny fp32 SD-2.1 (v-prediction) and SDXL (added conditioning)
    pipelines on the card, graphed, against the same weights on the CPU,
    20-step DPM++ at batch 2, CFG 7.5: the images within 1e-3 and the fp32
    attention kernel's launches the tiny census's."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.ops.flash_attention import flash_attention_tf32x3
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    out = {}
    for family in FAMILIES:
        cpu = family_pipeline(family, tiny=True, dtype="float32", seed=0, device="cpu")
        card = family_pipeline(family, tiny=True, dtype="float32", seed=0, device="cuda")
        eng = cpu.engine
        card.engine.load_state_dicts({k: m.state_dict() for k, m in
                                      zip(eng.MODULES, eng.modules())})
        kw = dict(num_inference_steps=ENGINE_STEPS, guidance_scale=GUIDANCE, seed=29)
        prompts = ["a lighthouse at dusk", "a red boat"]
        a = cpu(prompts, **kw)[0]
        flash_attention_tf32x3.launches = 0
        b = card(prompts, **kw)[0]
        launches = flash_attention_tf32x3.launches
        caps = card.engine.graphed_unet.captures
        err = float(np.abs(a - b).max())
        want = ((GraphedCall.WARMUP + 1) * _kinds(census[family]["tiny_unet"])["attention"]
                + _kinds(census[family]["tiny_vae"])["attention"])
        print(f"tiny fp32 {family} pipeline, card (graphed) vs CPU: max abs image err {err:.3e} "
              f"(tolerance 1e-3); flash_attention_tf32x3 launches {launches}; graph captures "
              f"{caps}", flush=True)
        if not err <= 1e-3:
            raise AssertionError(f"the tiny {family} pipeline on the card disagrees with the CPU")
        if launches != want or launches <= 0 or list(caps.values()) != [1]:
            raise AssertionError(f"the tiny {family} run launched the fp32 attention kernel "
                                 f"{launches} times (expected {want}), captures {caps}")
        out[family] = dict(max_abs_image_err=err, fp32_attention_launches=launches)
    return out


def run_family_cli(family, census, assets, card):
    """``cli.run`` of the family's shipped config at full width, overriding
    only the real-image directory (phase 9's) and its count, the
    checkpoints' paths, the prompt file's path and the sweep (its first
    point), in a working directory under ``assets``, traced: its table row
    (finite clip_score and fid, image_reward in [0, 1]), its PNGs, one
    graph capture, the peak memory, and each kernel's launches against the
    census by the wrappers and by the trace (the UNet's graph warm-up and
    capture or replays, FAMILY_BATCH-latent decodes of the final and each
    step's x0, the CLIP score's and ImageReward's fp32 attention of one
    validate batch)."""
    import csv

    import numpy as np

    from sonicdiffusionbayeslab_torch import cli
    from sonicdiffusionbayeslab_torch.config import load_config
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    repo = Path(__file__).resolve().parent
    meta = FAMILIES[family]
    config = str(repo / "configs" / f"{meta['config']}.yaml")
    nfe, size = meta["steps"], meta["size"]
    label = f"steps_{nfe}"
    per_unet, per_vae = _kinds(census[family]["unet"]), _kinds(census[family]["vae"])
    W = GraphedCall.WARMUP
    fp32 = sum(metric_census(FAMILY_BATCH, aesthetic=False).values())
    want = {k: (W + 1) * per_unet[k] + (1 + nfe) * per_vae[k] for k in MAIN}
    want_traced = {k: (W + nfe) * per_unet[k] + (1 + nfe) * per_vae[k] for k in MAIN}
    want["attention_fp32"] = want_traced["attention_fp32"] = fp32
    overrides = {
        "dataset.img_dataset": str(assets["img_dir"]), "dataset.max_count": FAMILY_BATCH,
        "quality_metrics.image_reward.checkpoint": str(assets["ckpts"]["image_reward"]),
        "quality_metrics.fid.inception_checkpoint": str(assets["ckpts"]["inception"]),
        "experiment_params.num_inference_steps": [nfe], "logger.run_id": family,
        "dataset.prompts": str(repo / "data" / "dataset" / "img2annotations_test.json")}
    work = Path(assets["root"]) / family
    work.mkdir()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        wrapper_counts(reset=True)
        t0 = time.perf_counter()
        with _RecordingVariants() as rec:
            metrics, traced, _ = traced_exact(lambda: cli.run(config, overrides), want_traced,
                                              f"the {family} CLI run", reset=retrace_reset(
                                                  rec, run_dir=work / "outputs" / family))
        wall = time.perf_counter() - t0
        counts = wrapper_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        caps, graphs_gb = rec.captures()
        with open(work / "outputs" / family / "tables" / "final.tsv") as f:
            rows = list(csv.DictReader(f, delimiter="\t"))
        pngs = sorted((work / "outputs" / load_config(config).get("experiment_name") /
                       label).iterdir())
    finally:
        os.chdir(cwd)
    row = rows[0] if rows else {}
    vals = {k: float(row[k]) for k in ("clip_score", "fid", "image_reward") if k in row}
    print(f"{meta['config']} as shipped ({label}, bf16 {size}x{size}, batch {FAMILY_BATCH}, x0 of "
          f"every sample, real-image directory; clip_score, fid at 64, image_reward on random "
          f"towers): whole CLI {wall:.3f} s, sweep {row.get('time')} s/image, {vals}; peak memory "
          f"{peak_gb:.2f} GB allocated; graph captures {dict(caps)} ({graphs_gb:.3f} GB); "
          f"launches: wrappers {counts}, trace {traced}; {card}", flush=True)
    if list(row) != ["exp", "nfe", "time", "clip_score", "fid", "image_reward"] or \
            len(rows) != 1 or row["exp"] != label or row["nfe"] != str(nfe):
        raise AssertionError(f"{family} run: table rows {rows}")
    if metrics["exp"] != [label]:
        raise AssertionError(f"{family} run: CLI returned {metrics}")
    if not all(np.isfinite(v) for v in vals.values()) or not 0 <= vals["image_reward"] <= 1:
        raise AssertionError(f"{family} run: values {vals}")
    if not (np.isfinite(float(row["time"])) and float(row["time"]) > 0):
        raise AssertionError(f"{family} run: time {row['time']}")
    if len(pngs) != FAMILY_BATCH or {_png_size(p) for p in pngs} != {(size, size)}:
        raise AssertionError(f"{family} run: {len(pngs)} PNGs, expected {FAMILY_BATCH} of "
                             f"{size}x{size}")
    if sorted(caps.values()) != [1]:
        raise AssertionError(f"{family} run: graph captures {caps}")
    if counts != want or traced != want_traced:
        raise AssertionError(f"{family} run: launches wrappers {counts}, trace {traced}; "
                             f"expected {want} and {want_traced}")
    return dict(wall_s=wall, sec_per_image=float(row["time"]), values=vals, peak_gb=peak_gb,
                graph_reserved_gb=graphs_gb, wrapper_launches=counts, traced_launches=traced)


def family_engine_timings(family, census, card, reps=3):
    """The family's pipeline at full width and size on random bf16
    weights: a first ENGINE_STEPS-step DPM++ loop at batch BATCH, CFG
    GUIDANCE (engine level, no decode) that captures the UNet's graph, with
    the wrappers' counts set to 0 just before and read just after; then
    ``reps`` warm loops (execution_time, median) with the peak memory over
    them, and a torch.profiler breakdown of one loop per step."""
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    gc.collect()
    torch.cuda.empty_cache()
    meta = FAMILIES[family]
    size = meta["size"]
    lat_hw = (size // 8, size // 8)
    t0 = time.perf_counter()
    model = family_pipeline(family, image_size=size, dtype="bfloat16", seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = model.engine
    plan = model.build_plan(ENGINE_STEPS)
    emb, neg = model._encode(PROMPTS), model._encode([""] * BATCH)
    kw = dict(guidance_scale=GUIDANCE, latent_hw=lat_hw, seed=29, decode=False,
              **model._extra_sample_kwargs(BATCH, lat_hw))
    wrapper_counts(reset=True)
    eng.sample(plan, emb, neg, **kw)
    counts = bf16_only(wrapper_counts(), f"{family} engine loop")
    per_unet = _kinds(census[family]["engine"])
    want = {k: (GraphedCall.WARMUP + 1) * per_unet[k] for k in MAIN}
    if counts != want:
        raise AssertionError(f"{family} engine loop: wrapper launches {counts}, expected {want}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = [eng.sample(plan, emb, neg, **kw).execution_time for _ in range(reps)]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.memory_reserved() / 1e9
    prof = profile_loop(model, size=size, label=f"profile {family}")
    n_params = {name: sum(p.numel() for p in m.parameters()) / 1e6
                for name, m in zip(eng.MODULES, eng.modules())}
    out = dict(execution_time_s=times, median_s=statistics.median(times),
               sec_per_image=statistics.median(times) / BATCH, peak_gb=peak_gb,
               reserved_gb=reserved_gb, init_s=init_s, params_m=n_params,
               first_run_wrapper_launches=counts, profile=prof)
    print(f"{family} engine, bf16 {size}x{size}, {ENGINE_STEPS}-step DPM++ ({meta['prediction_type']}"
          f"), batch {BATCH}, CFG {GUIDANCE} (warm, {reps} runs): execution_time {times} s, median "
          f"{out['median_s']:.4f} s; peak memory {peak_gb:.2f} GB allocated, {reserved_gb:.2f} GB "
          f"reserved; random init {init_s:.1f} s; parameters (M) {n_params}; first loop's "
          f"wrapper launches {counts}; {card}", flush=True)
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_families(report, card, assets):
    """Phase 10: SD-2.1 (768-v) and SDXL-base at full width."""
    census = family_census()
    for family, c in census.items():
        per_unet, per_vae = _kinds(c["unet"]), _kinds(c["vae"])
        print(f"{family}: per UNet forward at batch {2 * FAMILY_BATCH} {dict(per_unet)}, per VAE "
              f"decode of {FAMILY_BATCH} {dict(per_vae)}; {len(c['unet'])} and {len(c['vae'])} "
              f"distinct shapes", flush=True)
    want = {"sd21": 32, "sdxl": 140}
    got = {f: _kinds(c["unet"])["attention"] for f, c in census.items()}
    if got != want:
        raise AssertionError(f"bf16 attention launches a UNet forward {got}, expected {want}")
    print_gn_plans(sorted({k for c in census.values() for part in ("unet", "vae", "engine")
                           for k in c[part]}, key=lambda k: (k[0], [str(v) for v in k[1]])))
    out = {"checked_shapes": check_family_kernels(census, report)}
    out["timings"], out["kernel_totals"] = time_family_kernels(census, card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["tiny_card_vs_cpu"] = families_tiny_card_vs_cpu(census)
    torch.backends.cudnn.allow_tf32 = True
    for family in FAMILIES:
        out[f"{family}_cli"] = run_family_cli(family, census, assets, card)
        out[f"{family}_engine"] = family_engine_timings(family, census, card)
    out["census"] = {f: {part: {"attention": _kinds(c[part])["attention"],
                                "group_norm": _kinds(c[part])["group_norm"]}
                         for part in ("unet", "vae", "engine")} for f, c in census.items()}
    report["e2e"]["families"] = out


# ------------------------------ img2img, inpainting, int8 quant (phase 11)
def img2img_census():
    """{part: {(kind, shape): launches}} of phase 11: a UNet forward at the
    img2img runs' batch (2 x BATCH; also ToMe's and the int8 modes' for the
    loop timings), an encode and a decode of BATCH at SIZE, the SDXL VAE's
    encode of one image at ENC_XL_SIZE, the turbo CLI's UNet forward
    (2 x TURBO_BATCH, ToMe and int8_conv_only) and decode of TURBO_BATCH,
    and the tiny fp32 runs' UNet forward, encode and decode."""
    return dict(
        unet=module_census(2 * BATCH), enc=module_census(enc_batch=BATCH),
        vae=module_census(vae_batch=BATCH),
        unet_int8=module_census(2 * BATCH, quant=TURBO_QUANT),
        unet_turbo=module_census(2 * BATCH, tome=TURBO_TOME, quant=TURBO_QUANT),
        enc_xl=module_census(enc_batch=1, enc_size=ENC_XL_SIZE, family="sdxl"),
        turbo_unet=module_census(2 * TURBO_BATCH, tome=TURBO_TOME, quant=TURBO_QUANT),
        turbo_vae=module_census(vae_batch=TURBO_BATCH),
        tiny_unet=module_census(2 * BATCH, tiny=True),
        tiny_unet_int8=module_census(2 * BATCH, tiny=True, quant=TURBO_QUANT),
        tiny_enc=module_census(enc_batch=BATCH, tiny=True),
        tiny_vae=module_census(vae_batch=BATCH, tiny=True))


def int8_counts(reset=False):
    """The int8 wrappers' card counts: GEMMs, and the conv and dense calls."""
    from sonicdiffusionbayeslab_torch.ops import quant as Q

    fns = {"int8_gemm": Q.int8_matmul, "int8_conv": Q.int8_conv, "int8_dense": Q.int8_dense}
    if reset:
        for f in fns.values():
            f.launches = 0
    return {k: f.launches for k, f in fns.items()}


def check_int8_gemms(census):
    """cuBLASLt's int8 GEMM (``torch._int_mm`` through ``int8_matmul``) at
    every (M, K, N) of phase 11's int8 convs and at two small shapes that
    need the zero padding (M <= 16, K and N not multiples of 8): the int32
    sums bit-equal to a float64 product on the card (every partial sum an
    integer below 2^53) and to int64 sums on the CPU over the first 16
    rows; the device ms of each full-width shape; and a trace of one call
    at each, which must run one kernel named INT8_GEMM_SYMBOL a call (the
    count later traces are held to).  Returns the rows."""
    from sonicdiffusionbayeslab_torch.ops import quant as Q

    gen = torch.Generator(device="cuda").manual_seed(21)
    shapes = sorted({shape for c in census.values() for (kind, shape) in c
                     if kind == "int8_conv"})
    operands, rows = [], []
    for M, K, N in shapes + [(5, 37, 11), (16, 24, 8)]:
        a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
        got = Q.int8_matmul(a, w)
        exact = a.double() @ w.double().t()
        r = min(M, 16)
        ok = (torch.equal(got.double(), exact)
              and torch.equal(got[:r].cpu().long(), a[:r].cpu().long() @ w.cpu().long().t()))
        if not ok or got.dtype != torch.int32 or got.shape != (M, N):
            raise AssertionError(f"int8 GEMM {M}x{K}x{N}: the int32 sums differ from the exact ones")
        row = dict(shape=[M, K, N])
        if M > 16:
            row.update(ms=cuda_ms(lambda: Q.int8_matmul(a, w)),
                       bound_ms=max(2 * M * K * N / PEAK_INT8, (M * K + N * K + 4 * M * N)
                                    / PEAK_BYTES) * 1e3)
            operands.append((a, w))
        rows.append(row)
        del got, exact
    _, traced, _ = traced_exact(lambda: [Q.int8_matmul(a, w) for a, w in operands],
                                {"int8_gemm": len(operands)}, "the int8 GEMM calls",
                                symbols={"int8_gemm": INT8_GEMM_SYMBOL})
    print(f"int8 GEMMs at {len(shapes)} phase-11 conv shapes and 2 padded small ones: int32 sums "
          f"bit-equal to exact float64 (card) and int64 (CPU, 16 rows); one call at each "
          f"full-width shape traced: {traced['int8_gemm']} '{INT8_GEMM_SYMBOL}' kernels; "
          + json.dumps(rows), flush=True)
    if traced["int8_gemm"] != len(operands):
        raise AssertionError(f"{len(operands)} int8 GEMM calls ran {traced['int8_gemm']} kernels "
                             f"named '{INT8_GEMM_SYMBOL}', expected one each")
    return rows


def img2img_inputs(root):
    """A smooth random SIZE^2 image and a mask white on its right half,
    written as PNGs by the port's writer and read back by its reader:
    (image path, mask path, images [BATCH, SIZE, SIZE, 3], masks [BATCH,
    SIZE, SIZE])."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.data.imageio import read_image, write_png

    gen = np.random.default_rng(12)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE] / SIZE
    px = np.stack([0.5 + 0.4 * np.sin(6 * xx + 2 * yy), 0.5 + 0.4 * np.cos(5 * yy),
                   0.2 + 0.6 * xx * yy], -1) + gen.normal(0, 0.03, (SIZE, SIZE, 3))
    mask = np.zeros((SIZE, SIZE, 3), np.float32)
    mask[:, SIZE // 2:] = 1.0
    paths = Path(root) / "init.png", Path(root) / "mask.png"
    write_png(paths[0], np.clip(px, 0, 1))
    write_png(paths[1], mask)
    img = read_image(paths[0], SIZE)
    m = (read_image(paths[1], SIZE).mean(-1) > 0.5).astype(np.float32)
    return (*paths, np.stack([img] * BATCH), np.stack([m] * BATCH))


def img2img_tiny_card_vs_cpu(census):
    """The tiny fp32 pipeline on the card (graphed) against the CPU, batch
    BATCH, CFG GUIDANCE, STEPS-step DPM++: img2img at STRENGTH and
    inpainting (images within 1e-3, the fp32 attention kernel's launches
    the census's, the encoder's included); then int8_conv_only text-to-image
    runs, whose int8 rounding flips where the two devices' fp32 sums differ
    by an ulp at a rounding boundary: held to the CPU's drift from its exact
    run (the card's run nearer the CPU's quantized run than that is to the
    exact one), with the max error and the int8 GEMMs' launches (the
    census's) printed."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
    from sonicdiffusionbayeslab_torch.ops.flash_attention import flash_attention_tf32x3
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    W = GraphedCall.WARMUP
    cpu = StableDiffusionModel(tiny=True, dtype="float32", seed=0, device="cpu")
    card = StableDiffusionModel(tiny=True, dtype="float32", seed=0, device="cuda")
    card.engine.load_state_dicts({k: m.state_dict() for k, m in
                                  zip(cpu.engine.MODULES, cpu.engine.modules())})
    rng = np.random.default_rng(13)
    img = rng.random((BATCH, 16, 16, 3)).astype(np.float32)
    mask = np.zeros((BATCH, 16, 16), np.float32)
    mask[:, :, 8:] = 1.0
    prompts = ["a lighthouse at dusk", "a red boat"]
    kw = dict(num_inference_steps=STEPS, guidance_scale=GUIDANCE, seed=29)
    k = {part: _kinds(census[part])["attention"] for part in
         ("tiny_unet", "tiny_enc", "tiny_vae", "tiny_unet_int8")}
    out = {}
    for name, extra, first in (("img2img", dict(init_image=img, strength=STRENGTH), True),
                               ("inpaint", dict(init_image=img, strength=STRENGTH,
                                                mask_image=mask), False)):
        a = cpu(prompts, **kw, **extra)[0]
        flash_attention_tf32x3.launches = 0
        b = card(prompts, **kw, **extra)[0]
        launches = flash_attention_tf32x3.launches
        want = (W + 1) * k["tiny_unet"] * first + k["tiny_enc"] + k["tiny_vae"]
        err = float(np.abs(a - b).max())
        print(f"tiny fp32 {name} ({card.num_timesteps} rows), card vs CPU: max abs image err "
              f"{err:.3e} (tolerance 1e-3); flash_attention_tf32x3 launches {launches} "
              f"(expected {want})", flush=True)
        if not err <= 1e-3 or card.num_timesteps != IMG2IMG_ROWS:
            raise AssertionError(f"the tiny {name} run on the card disagrees with the CPU")
        if launches != want:
            raise AssertionError(f"the tiny {name} run launched the fp32 attention kernel "
                                 f"{launches} times, expected {want}")
        out[name] = dict(max_abs_image_err=err, fp32_attention_launches=launches)
    exact = cpu(prompts, **kw)[0]
    for m in (cpu, card):
        m.engine.set_quant_mode(TURBO_QUANT)
    a = cpu(prompts, **kw)[0]
    int8_counts(reset=True)
    b = card(prompts, **kw)[0]
    gemms = int8_counts()
    for m in (cpu, card):
        m.engine.set_quant_mode(None)
    rel = lambda x, y: float(np.linalg.norm(x - y) / np.linalg.norm(y))  # noqa: E731
    err, card_rel, drift = float(np.abs(a - b).max()), rel(b, a), rel(a, exact)
    want = (W + 1) * _kinds(census["tiny_unet_int8"])["int8_conv"]
    print(f"tiny fp32 {TURBO_QUANT} run, card vs CPU: max abs image err {err:.3e} (within 1e-3: "
          f"{err <= 1e-3}), relative {card_rel:.3e} against the CPU's quantized-vs-exact drift "
          f"{drift:.3e}; int8 launches {gemms} (expected {want} GEMMs)", flush=True)
    if not card_rel < drift or gemms["int8_gemm"] != want or gemms["int8_conv"] != want \
            or gemms["int8_dense"]:
        raise AssertionError(f"the tiny {TURBO_QUANT} run on the card: relative err "
                             f"{card_rel:.3e}, drift {drift:.3e}, int8 launches {gemms}")
    out[TURBO_QUANT] = dict(max_abs_image_err=err, relative_err=card_rel, cpu_drift=drift,
                            int8_launches=gemms)
    return out


def gn_encoder_kernels(census, report):
    """The GroupNorm kernel against its plain version (bf16) at the
    encoders' shapes (SD-1.5 at SIZE, batch BATCH; SDXL's at ENC_XL_SIZE,
    one image), their plans, and a timing row of each (launches an
    encode)."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    calls = collections.Counter(census["enc"])
    calls.update(census["enc_xl"])
    shapes = sorted(calls, key=lambda k: (k[0], [str(v) for v in k[1]]))
    print_gn_plans(shapes)
    rows = []
    for kind, shape in shapes:
        inputs = gn_inputs(shape, torch.bfloat16, gen)
        kern, plain = run_kernel(kind, shape, inputs)
        err = compare(kind, torch.bfloat16, kern(), plain(), f"{kind} {shape} (encoder)")
        report["errs"][kind].append(err)
        rows.append(dict(timing_row(kind, shape, torch.bfloat16, "encoder", calls[(kind, shape)],
                                    gen), max_abs_err=err))
        del inputs
    torch.cuda.empty_cache()
    return rows


def sdxl_encoder(census, card):
    """The SDXL VAE's encoder alone (random bf16 weights) on one
    ENC_XL_SIZE^2 image: the GroupNorm wrapper's launches and a trace's
    kernel executions against the census, finite latents of the expected
    shape, and its device ms."""
    from sonicdiffusionbayeslab_torch.models.sampler import init_module
    from sonicdiffusionbayeslab_torch.models.vae import AutoencoderKL, VAEConfig

    gc.collect()
    torch.cuda.empty_cache()
    with torch.device("cuda"):
        vae = AutoencoderKL(VAEConfig.sdxl())
    init_module(vae, torch.Generator(device="cuda").manual_seed(23))
    vae.requires_grad_(False).eval().to(dtype=torch.bfloat16, memory_format=torch.channels_last)
    gen = torch.Generator(device="cuda").manual_seed(24)
    x = torch.rand(1, ENC_XL_SIZE, ENC_XL_SIZE, 3, generator=gen, device="cuda") * 2 - 1
    noise = torch.randn(1, ENC_XL_SIZE // 8, ENC_XL_SIZE // 8, 4, generator=gen, device="cuda")
    want = {k: _kinds(census["enc_xl"])[k] for k in MAIN}
    with torch.inference_mode():
        wrapper_counts(reset=True)
        z = vae.encode_sample(x, noise)
        counts = bf16_only(wrapper_counts(), "the SDXL encoder")
        z2, traced, _ = traced_exact(lambda: vae.encode_sample(x, noise), want,
                                     "the SDXL encoder", same=lambda o: torch.equal(o, z))
        traced = bf16_only(traced, "the SDXL encoder (trace)")
        again = [traced_launches(lambda: vae.encode(x))[1]["group_norm"] for _ in range(2)]
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: vae.encode(x), reps=2)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for n, p in vae.named_parameters()
                   if n.startswith(("encoder.", "quant_conv."))) / 1e6
    print(f"SDXL VAE encoder ({n_params:.1f} M parameters with quant_conv), bf16 "
          f"{ENC_XL_SIZE}x{ENC_XL_SIZE}, one image: {ms:.3f} ms device "
          f"time (CUDA graph of 2 calls), peak {peak_gb:.2f} GB; latents {tuple(z.shape)}; "
          f"launches: wrappers {counts}, trace {traced} (two more traces' GroupNorm: {again}), "
          f"census {want}; {card}", flush=True)
    if tuple(z.shape) != (1, ENC_XL_SIZE // 8, ENC_XL_SIZE // 8, 4) or \
            not torch.isfinite(z).all() or not torch.equal(z, z2):
        raise AssertionError(f"SDXL encoder latents {tuple(z.shape)}")
    if counts != want or traced != want:
        raise AssertionError(f"SDXL encoder launches: wrappers {counts}, trace {traced}, "
                             f"expected {want}")
    del vae, x, z, z2
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ms=ms, peak_gb=peak_gb, params_m=n_params, wrapper_launches=counts,
                traced_launches=traced)


def img2img_pipeline(model, census, inputs, tmp, card):
    """SD-1.5 img2img and inpainting at full width through the pipeline and
    generate.py: the first img2img run (the wrappers' launches: the UNet
    graph's warm-up and capture, one encode, one decode), a traced warm run
    (IMG2IMG_ROWS replays, encode, decode; timed) with the same images; an
    inpainting run whose kept half's final latents are the encoder's
    latents of the source (the blend's last row is the clean source); and
    ``generate.py --init_image --mask_image`` (a new model: its capture)
    writing BATCH PNGs."""
    import numpy as np

    from sonicdiffusionbayeslab_torch import generate
    from sonicdiffusionbayeslab_torch.models.pipelines import resize_mask
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall
    from sonicdiffusionbayeslab_torch.utils.rng import ENCODE_NOISE_TAG, per_sample_noise

    W = GraphedCall.WARMUP
    png, mask_png, img, mask = inputs
    kw = dict(num_inference_steps=STEPS, guidance_scale=GUIDANCE, seed=29, init_image=img,
              strength=STRENGTH)
    k = {part: _kinds(census[part]) for part in ("unet", "enc", "vae")}
    first = {m: (W + 1) * k["unet"][m] + k["enc"][m] + k["vae"][m] for m in MAIN}
    warm = {m: IMG2IMG_ROWS * k["unet"][m] + k["enc"][m] + k["vae"][m] for m in MAIN}
    wrapper_counts(reset=True)
    imgs = model(PROMPTS, **kw)[0]
    counts = bf16_only(wrapper_counts(), "img2img")
    t0 = time.perf_counter()
    (imgs2, exec_time, _), traced, _ = traced_exact(
        lambda: model(PROMPTS, **kw), warm, "the img2img run",
        same=lambda o: np.array_equal(o[0], imgs))
    wall = time.perf_counter() - t0
    traced = bf16_only(traced, "img2img (trace)")
    check_images(imgs)
    print(f"img2img (SD-1.5 bf16 {SIZE}x{SIZE}, {STEPS}-step DPM++ at strength {STRENGTH}: "
          f"{model.num_timesteps} rows, batch {BATCH}, CFG {GUIDANCE}; a PNG read back): "
          f"traced warm run execution_time {exec_time:.4f} s, whole call {wall:.3f} s (traced); "
          f"launches: first run's wrappers {counts} (expected {first}), traced run {traced} "
          f"(expected {warm}); {card}", flush=True)
    if model.num_timesteps != IMG2IMG_ROWS or counts != first or traced != warm:
        raise AssertionError(f"img2img: {model.num_timesteps} rows, launches {counts} / {traced}")
    if not np.array_equal(imgs, imgs2):
        raise AssertionError("img2img: a second identical run gave other images")
    lat_shape = (SIZE // 8, SIZE // 8, 4)
    noise = per_sample_noise(29, range(BATCH), lat_shape, ENCODE_NOISE_TAG)
    wrapper_counts(reset=True)
    lat = model(PROMPTS, output_type="latent", mask_image=mask, encode_noise=noise, **kw)[0]
    inpaint_counts = bf16_only(wrapper_counts(), "inpaint")
    z = model.engine.encode_image(img, noise).cpu().numpy()
    keep = resize_mask(mask, lat_shape[:2]).numpy()[..., 0] == 0
    moved = float(np.abs(lat[~keep] - z[~keep]).mean())
    print(f"inpainting (mask white on the right half): kept half's final latents equal the "
          f"encoder's latents of the source: {np.array_equal(lat[keep], z[keep])}; the "
          f"regenerated half's mean |latent - source| {moved:.4f}; launches {inpaint_counts}",
          flush=True)
    if not (np.isfinite(lat).all() and np.array_equal(lat[keep], z[keep]) and moved > 0):
        raise AssertionError("inpainting: the kept half is not the source's latents")
    if inpaint_counts != {m: k["enc"][m] for m in MAIN}:  # eager: the encode alone
        raise AssertionError(f"inpainting launches {inpaint_counts}")
    out_png = Path(tmp) / "generate" / "img_{i:03d}.png"
    gc.collect()
    torch.cuda.empty_cache()
    wrapper_counts(reset=True)
    t0 = time.perf_counter()
    generate.main([a for p in PROMPTS for a in ("--prompt", p)]
                  + ["--steps", str(STEPS), "--init_image", str(png), "--mask_image",
                     str(mask_png), "--strength", str(STRENGTH), "--out", str(out_png)])
    gen_wall = time.perf_counter() - t0
    gen_counts = bf16_only(wrapper_counts(), "generate.py")
    pngs = sorted(out_png.parent.glob("*.png"))
    print(f"generate.py --init_image --mask_image (a new SD-1.5 model, {STEPS} steps at strength "
          f"{STRENGTH}): {len(pngs)} PNGs in {gen_wall:.2f} s (init and capture included); "
          f"wrapper launches {gen_counts}", flush=True)
    if len(pngs) != BATCH or {_png_size(p) for p in pngs} != {(SIZE, SIZE)} or gen_counts != first:
        raise AssertionError(f"generate.py wrote {len(pngs)} PNGs, launches {gen_counts}")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(execution_time_s=exec_time, call_s=wall, first_run_wrapper_launches=counts,
                traced_launches=traced, inpaint_wrapper_launches=inpaint_counts,
                inpaint_regenerated_mean_abs=moved, generate_s=gen_wall,
                generate_wrapper_launches=gen_counts)


def quant_loop_timings(model, census, card, profile, reps=3):
    """Engine-level STEPS-step DPM++ loops at batch BATCH, CFG GUIDANCE:
    exact, int8_conv_only, and the turbo stack (ToMe TURBO_TOME and
    int8_conv_only), each first run capturing its graph (int8 launches
    against the census), then ``reps`` warm runs in turns (execution_time,
    median); the quantized latents' drift from the exact ones; the exact
    run again after them, bit-equal to the first (the mode is the model's,
    switched off)."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    eng = model.engine
    plan = model.build_plan(STEPS)
    emb, neg = model._encode(PROMPTS), model._encode([""] * BATCH)
    kw = dict(guidance_scale=GUIDANCE, latent_hw=(SIZE // 8, SIZE // 8), seed=29, decode=False)
    runs = {"exact": (None, None, "unet"), TURBO_QUANT: (TURBO_QUANT, None, "unet_int8"),
            "turbo": (TURBO_QUANT, TURBO_TOME, "unet_turbo")}

    def run(name):
        mode, tome, _ = runs[name]
        eng.set_quant_mode(mode)
        try:
            return eng.sample(plan, emb, neg, tome=tome, **kw)
        finally:
            eng.set_quant_mode(None)

    first, launches = {}, {}
    for name, (_, _, part) in runs.items():
        int8_counts(reset=True)
        first[name] = run(name).latents
        launches[name] = int8_counts()
        n = (GraphedCall.WARMUP + 1) * _kinds(census[part]).get("int8_conv", 0)
        if launches[name] != {"int8_gemm": n, "int8_conv": n, "int8_dense": 0}:
            raise AssertionError(f"{name} loop: int8 launches {launches[name]}, expected {n}")
    times = {name: [] for name in runs}
    for i in range(reps):
        for name in (runs if i % 2 == 0 else reversed(list(runs))):
            times[name].append(run(name).execution_time)
    again = run("exact").latents
    drift = {name: float((first[name] - first["exact"]).norm() / first["exact"].norm())
             for name in runs if name != "exact"}
    out = dict(execution_time_s=times, median_s={k: statistics.median(v) for k, v in times.items()},
               drift=drift, first_run_int8_launches=launches)
    print(f"engine loops, SD-1.5 bf16 {SIZE}x{SIZE}, {STEPS}-step DPM++, batch {BATCH}, CFG "
          f"{GUIDANCE} (warm, in turns, {reps} each): execution_time medians {out['median_s']} s; "
          f"latents' relative drift from the exact run {drift}; first runs' int8 launches "
          f"{launches}; the exact run after them bit-equal: {torch.equal(again, first['exact'])}; "
          f"{card}", flush=True)
    if not torch.equal(again, first["exact"]):
        raise AssertionError("an exact loop after the int8 loops differs from the one before")
    if not all(0.0 < d < 1.0 for d in drift.values()) or \
            not all(torch.isfinite(v).all() for v in first.values()):
        raise AssertionError(f"int8 loops: drift {drift}")
    if profile:
        eng.set_quant_mode(TURBO_QUANT)
        try:
            out["profile_int8_conv_only"] = profile_loop(model, label=f"profile {TURBO_QUANT}")
        finally:
            eng.set_quant_mode(None)
    return out


def run_turbo_cli(census, assets, card):
    """``cli.run`` of configs/turbo_config.yaml as shipped (tome 0.5 +
    int8_conv_only, DPM++ 20 steps, batch 8, clip_score, image_reward, fid
    at 64), overriding only phase 9's real-image directory and its count,
    the checkpoints' paths, the prompt file's path and the run id, traced:
    its table row, PNGs, one capture of the (ToMe, int8) variant, and the
    launches against the census by the wrappers and by the trace: the
    GroupNorm and attention kernels, and the int8 GEMMs (INT8_CONVS a
    forward; by kernel name, INT8_GEMM_SYMBOL, in the trace); no int8 dense
    call."""
    import csv

    import numpy as np

    from sonicdiffusionbayeslab_torch import cli
    from sonicdiffusionbayeslab_torch.config import load_config
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    repo = Path(__file__).resolve().parent
    config = str(repo / "configs" / "turbo_config.yaml")
    nfe = TURBO_STEPS
    per_unet, per_vae = _kinds(census["turbo_unet"]), _kinds(census["turbo_vae"])
    W = GraphedCall.WARMUP
    fp32 = sum(metric_census(TURBO_BATCH, aesthetic=False).values())
    want = {k: (W + 1) * per_unet[k] + (1 + nfe) * per_vae[k] for k in MAIN}
    want_traced = {k: (W + nfe) * per_unet[k] + (1 + nfe) * per_vae[k] for k in MAIN}
    want["attention_fp32"] = want_traced["attention_fp32"] = fp32
    want_gemm_traced = (W + nfe) * per_unet["int8_conv"]  # one kernel a GEMM
    n_int8 = (W + 1) * per_unet["int8_conv"]
    overrides = {
        "dataset.img_dataset": str(assets["img_dir"]), "dataset.max_count": TURBO_BATCH,
        "quality_metrics.image_reward.checkpoint": str(assets["ckpts"]["image_reward"]),
        "quality_metrics.fid.inception_checkpoint": str(assets["ckpts"]["inception"]),
        "experiment_params.num_inference_steps": nfe, "logger.run_id": "turbo",
        "dataset.prompts": str(repo / "data" / "dataset" / "img2annotations_test.json")}
    work = Path(assets["root"]) / "turbo"
    work.mkdir()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        wrapper_counts(reset=True)
        int8_counts(reset=True)
        t0 = time.perf_counter()
        with _RecordingVariants() as rec:
            metrics, traced, _ = traced_exact(
                lambda: cli.run(config, overrides), {**want_traced, "int8_gemm": want_gemm_traced},
                "the turbo CLI run",
                reset=retrace_reset(rec, int8=True, run_dir=work / "outputs" / "turbo"),
                symbols={"int8_gemm": INT8_GEMM_SYMBOL})
        wall = time.perf_counter() - t0
        counts, q = wrapper_counts(), int8_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        caps, graphs_gb = rec.captures()
        with open(work / "outputs" / "turbo" / "tables" / "final.tsv") as f:
            rows = list(csv.DictReader(f, delimiter="\t"))
        label = rows[0]["exp"] if rows else ""
        pngs = sorted((work / "outputs" / load_config(config).get("experiment_name") /
                       label).iterdir()) if label else []
    finally:
        os.chdir(cwd)
    gemm_traced = traced.pop("int8_gemm")
    row = rows[0] if rows else {}
    vals = {k: float(row[k]) for k in ("clip_score", "fid", "image_reward") if k in row}
    print(f"turbo_config as shipped ({label}: ToMe {TURBO_TOME} + {TURBO_QUANT}, {nfe}-step DPM++, "
          f"bf16 {SIZE}x{SIZE}, batch {TURBO_BATCH}, x0 of every sample, real-image directory; "
          f"clip_score, fid at 64, image_reward on random towers): whole CLI {wall:.3f} s, sweep "
          f"{row.get('time')} s/image, {vals}; peak memory {peak_gb:.2f} GB; graph captures "
          f"{dict(caps)} ({graphs_gb:.3f} GB); launches: wrappers {counts} (expected {want}), "
          f"trace {traced} (expected {want_traced}); int8 wrappers {q} (expected {n_int8} GEMMs "
          f"and convs, no dense), int8 GEMM kernel executions in the trace {gemm_traced} "
          f"(expected {want_gemm_traced}); {card}", flush=True)
    if len(rows) != 1 or row["nfe"] != str(nfe) or metrics["exp"] != [label] or \
            list(row) != ["exp", "nfe", "time", "clip_score", "fid", "image_reward"]:
        raise AssertionError(f"turbo run: table rows {rows}, CLI returned {metrics}")
    if not all(np.isfinite(v) for v in vals.values()) or not 0 <= vals["image_reward"] <= 1:
        raise AssertionError(f"turbo run: values {vals}")
    if len(pngs) != TURBO_BATCH or {_png_size(p) for p in pngs} != {(SIZE, SIZE)}:
        raise AssertionError(f"turbo run: {len(pngs)} PNGs")
    if sorted(caps.values()) != [1] or not any(("quant", TURBO_QUANT) in key for key in caps):
        raise AssertionError(f"turbo run: graph captures {caps}")
    if counts != want or traced != want_traced:
        raise AssertionError(f"turbo run: launches wrappers {counts}, trace {traced}")
    if q != {"int8_gemm": n_int8, "int8_conv": n_int8, "int8_dense": 0} or \
            gemm_traced != want_gemm_traced:
        raise AssertionError(f"turbo run: int8 launches {q}, traced GEMM kernels {gemm_traced}")
    caps = {", ".join(f"{k}={v}" for k, v in key): n for key, n in caps.items()}
    return dict(wall_s=wall, sec_per_image=float(row["time"]), values=vals, peak_gb=peak_gb,
                graph_captures=caps, graph_reserved_gb=graphs_gb, wrapper_launches=counts,
                traced_launches=traced, int8_wrapper_launches=q,
                int8_gemm_traced_executions=gemm_traced)


def phase11_launches(out, kind):
    """A kernel's launches in each phase-11 run: wrappers over the first
    (capturing) runs, and traces."""
    pipe, turbo, tiny = out["pipeline"], out["turbo_cli"], out["tiny_card_vs_cpu"]
    if kind == "attention_fp32":
        return {**{f"tiny {n}": tiny[n]["fp32_attention_launches"] for n in ("img2img", "inpaint")},
                "turbo cli": turbo["wrapper_launches"][kind],
                "turbo cli trace": turbo["traced_launches"][kind]}
    return {"img2img first run": pipe["first_run_wrapper_launches"][kind],
            "img2img trace": pipe["traced_launches"][kind],
            "inpaint": pipe["inpaint_wrapper_launches"][kind],
            "generate.py inpaint": pipe["generate_wrapper_launches"][kind],
            "sdxl encoder 1024": out["sdxl_encoder"]["traced_launches"][kind],
            "turbo cli": turbo["wrapper_launches"][kind],
            "turbo cli trace": turbo["traced_launches"][kind]}


def run_img2img_quant(report, card, assets, profile):
    """Phase 11: img2img, inpainting and the int8 turbo stack."""
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel

    census = img2img_census()
    k = _kinds(census["turbo_unet"])
    print(f"phase 11 census: per UNet forward at batch {2 * BATCH} {dict(_kinds(census['unet']))}, "
          f"per encode of {BATCH} at {SIZE}^2 {dict(_kinds(census['enc']))}, per SDXL encode of "
          f"one {ENC_XL_SIZE}^2 image {dict(_kinds(census['enc_xl']))}, turbo forward at batch "
          f"{2 * TURBO_BATCH} {dict(k)}", flush=True)
    if k["int8_conv"] != INT8_CONVS or k.get("int8_dense", 0):
        raise AssertionError(f"the turbo UNet forward has {dict(k)} int8 calls, expected "
                             f"{INT8_CONVS} convs and no dense")
    out = {"census": {part: dict(_kinds(c)) for part, c in census.items()}}
    out["gn_encoder_timings"] = gn_encoder_kernels(census, report)
    out["int8_gemms"] = check_int8_gemms(census)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["tiny_card_vs_cpu"] = img2img_tiny_card_vs_cpu(census)
    torch.backends.cudnn.allow_tf32 = True
    out["sdxl_encoder"] = sdxl_encoder(census, card)
    gc.collect()
    torch.cuda.empty_cache()
    model = StableDiffusionModel(image_size=SIZE, tiny=False, dtype="bfloat16", seed=0,
                                 device="cuda")
    out["pipeline"] = img2img_pipeline(model, census, img2img_inputs(assets["root"]),
                                       assets["root"], card)
    out["loops"] = quant_loop_timings(model, census, card, profile)
    # The exact text-to-image run before the turbo CLI run, and after it.
    exact = dict(num_inference_steps=STEPS, guidance_scale=GUIDANCE, seed=29)
    before = model(PROMPTS, **exact)[0]
    _, bf16_traced = traced_launches(lambda: model(PROMPTS, **exact),
                                     symbols={"int8_gemm": INT8_GEMM_SYMBOL})
    if bf16_traced["int8_gemm"]:
        raise AssertionError(f"an exact run ran {bf16_traced['int8_gemm']} int8 GEMM kernels")
    out["turbo_cli"] = run_turbo_cli(census, assets, card)
    int8_counts(reset=True)
    after = model(PROMPTS, **exact)[0]
    leak = int8_counts()
    print(f"an exact SD-1.5 run after the turbo CLI run: bit-equal to the one before it "
          f"{bool((before == after).all())}, int8 launches {leak}", flush=True)
    if not (before == after).all() or any(leak.values()):
        raise AssertionError("the int8 mode leaked into a later exact run")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    report["e2e"]["img2img_quant"] = out


# ------------------------------------------------------ SD3-medium (phase 12)
def sd3_pipeline(name="stable_diffusion_3_model", **kw):
    """A registered SD3 pipeline (``kw`` to its constructor) with flow Euler
    at SD3_SHIFT, or the composing variant's own schedulers."""
    from sonicdiffusionbayeslab_torch.registry import load_all_plugins, models_registry
    from sonicdiffusionbayeslab_torch.schedulers import FlowMatchEulerScheduler

    load_all_plugins()
    pipe = models_registry[name](**kw)
    pipe.scheduler = FlowMatchEulerScheduler(shift=SD3_SHIFT)
    if name.endswith("two_schedulers"):
        pipe.scheduler_first = FlowMatchEulerScheduler(shift=SD3_SHIFT)
        pipe.scheduler_second = FlowMatchEulerScheduler(shift=SD3_SHIFT)
    return pipe


_META_MMDIT = {}  # the census's MMDiTs on the meta device, by tiny


def sd3_module_census(batch=None, size=SD3_SIZE, tome=None, ctx_len=77, vae_batch=None,
                      tiny=False, quant=None, branch=None):
    """{(kind, shape): launches} of one MMDiT call at ``batch`` rows (a full
    call, or with ``branch`` the trunk-delta cache's cached call: blocks
    0..branch-1; DiT-ToMe at ratio ``tome``; ``ctx_len`` context tokens,
    77 CLIP or 77 + 256 with T5; in the int8 mode ``quant``, whose dense
    calls are counted as ("int8_dense", (M, K, N))) and of one SD3 VAE
    decode of ``vae_batch`` latents, at ``size``^2 pixels (``tiny``: the
    tiny MMDiT and VAE at 8x8 latents), run on the meta device with the
    kernel entry points replaced by shape recorders."""
    from sonicdiffusionbayeslab_torch.models import layers, mmdit
    from sonicdiffusionbayeslab_torch.models.mmdit import MMDiT, MMDiTConfig
    from sonicdiffusionbayeslab_torch.models.vae import AutoencoderKL, VAEConfig
    from sonicdiffusionbayeslab_torch.ops import quant as Q
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

    def dense(x, weight, bias=None, out_dtype=None, weight_q=None):
        calls[("int8_dense", (x.numel() // x.shape[-1], x.shape[-1], weight.shape[0]))] += 1
        return torch.nn.functional.linear(x, weight, bias)

    saved = (layers.group_norm_silu, layers.dot_product_attention, mmdit.dot_product_attention,
             Q.int8_dense)
    layers.group_norm_silu, layers.dot_product_attention = gn, attn
    mmdit.dot_product_attention, Q.int8_dense = attn, dense
    cfg = MMDiTConfig.tiny() if tiny else MMDiTConfig.sd3_medium()
    lat = 8 if tiny else size // 8
    ctx_len = (77 + 16 if ctx_len > 77 else 77) if tiny else ctx_len
    try:
        with torch.device("meta"):
            if batch:
                m = _META_MMDIT.get(tiny) or _META_MMDIT.setdefault(tiny, MMDiT(cfg))
                Q.set_quant_mode(m, quant)
                kw, dst = {}, None
                if tome:
                    kw["tome"] = tc = TomeConfig(tome)
                    slots = m.tome_slots(lat, lat, tc, branch)
                    dst = torch.zeros(len(slots), tc.n_dst(lat // 2, lat // 2), dtype=torch.int64)
                cache = (None if branch is None else
                         torch.empty((batch,) + m.cache_shape(lat, lat, branch)))
                m(torch.empty(batch, lat, lat, 16), torch.empty(batch),
                  torch.empty(batch, ctx_len, cfg.joint_attention_dim), cache, dst,
                  torch.empty(batch, cfg.pooled_projection_dim), cache_branch_id=branch or 0, **kw)
            if vae_batch:
                AutoencoderKL(VAEConfig.tiny16() if tiny else VAEConfig.sd3()).decode(
                    torch.empty(vae_batch, lat, lat, 16))
    finally:
        (layers.group_norm_silu, layers.dot_product_attention, mmdit.dot_product_attention,
         Q.int8_dense) = saved
    return calls


def sd3_census():
    """{part: {(kind, shape): launches}} of every MMDiT call and SD3 decode
    phase 12 makes: the loops' forward at UNet batch 2 x BATCH (plain,
    trunk-delta's cached call at SD3_CACHE's branch, ToMe 0.5 and 0.25 --
    the frontier's too --, int8, T5's 333 context tokens, and at
    SD3_SMALL^2), the CLI runs' at 2 x SD3_CLI_BATCH and its chunk of
    microbatch 4, the decodes of BATCH (and at SD3_SMALL^2) and
    SD3_CLI_BATCH, and the tiny fp32 runs' (forward at 2 x BATCH, the
    trunk-delta cached call at branch 1, ToMe, int8, decode of BATCH)."""
    b = 2 * BATCH
    branch = SD3_CACHE[1]
    return dict(
        loop=sd3_module_census(b), shallow=sd3_module_census(b, branch=branch),
        tome=sd3_module_census(b, tome=SD3_TOME), tome_025=sd3_module_census(b, tome=0.25),
        tome_shallow=sd3_module_census(b, tome=SD3_TOME, branch=branch),
        int8=sd3_module_census(b, quant="int8"), t5=sd3_module_census(b, ctx_len=77 + 256),
        small=sd3_module_census(b, size=SD3_SMALL),
        cli=sd3_module_census(2 * SD3_CLI_BATCH), cli_chunk=sd3_module_census(2),
        vae=sd3_module_census(vae_batch=BATCH),
        vae_small=sd3_module_census(vae_batch=BATCH, size=SD3_SMALL),
        vae_cli=sd3_module_census(vae_batch=SD3_CLI_BATCH),
        tiny=sd3_module_census(b, tiny=True), tiny_shallow=sd3_module_census(b, tiny=True,
                                                                            branch=1),
        tiny_tome=sd3_module_census(b, tiny=True, tome=SD3_TOME),
        tiny_t5=sd3_module_census(b, tiny=True, ctx_len=77 + 256),
        tiny_int8=sd3_module_census(b, tiny=True, quant="int8"),
        tiny_vae=sd3_module_census(vae_batch=BATCH, tiny=True))


SD3_BF16_PARTS = ("loop", "shallow", "tome", "tome_025", "tome_shallow", "t5", "small", "cli",
                  "cli_chunk", "vae", "vae_small", "vae_cli")


def check_sd3_kernels(census, report):
    """Each kernel against its plain version at every phase-12 shape (the
    plain attention over batch slices where its fp32 intermediates pass
    PLAIN_BYTES): bf16 at the full-width runs' (the joint attention at
    4173, 4429, 2125, 3149 and 1101 tokens), fp32 at the tiny runs', the
    CLIP score's tower at the frontier's validate batch and the metric
    towers' at the CLI runs'; and the bf16 kernel on q, k and v as views of
    one concatenated [B, N, 3 x 1536] projection at the loops' joint shape,
    bit-equal to contiguous copies.  Max errors into ``report``."""
    from sonicdiffusionbayeslab_torch.ops.attention import plain_attention
    from sonicdiffusionbayeslab_torch.ops.flash_attention import flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(12)
    bf16 = {k for part in SD3_BF16_PARTS for k in census[part] if k[0] in MAIN}
    fp32 = {k for part, c in census.items() if part.startswith("tiny") for k in c if k[0] in MAIN}
    fp32 |= set(clip_census(FRONTIER["sd3_batch"])) | set(metric_census(SD3_CLI_BATCH,
                                                                        aesthetic=False))
    work = [(k, torch.bfloat16) for k in bf16] + [(k, torch.float32) for k in fp32]
    work.sort(key=lambda w: (str(w[1]), w[0][0], [str(v) for v in w[0][1]]))
    for (kind, shape), dtype in work:
        inputs = (attn_inputs if kind == "attention" else gn_inputs)(shape, dtype, gen)
        kern, plain = run_kernel(kind, shape, inputs)
        got = kern()
        torch.cuda.synchronize()
        err = compare(kind, dtype, got, plain(), f"{kind} {shape} {dtype} (phase 12)")
        report["errs"][report_key(kind, dtype)].append(err)
        report["phase12_errs"][report_key(kind, dtype)].append(err)
        print(f"phase 12 {kind} {str(dtype)[6:]} {shape}: max abs err {err:.3e}")
        del inputs, got
    (B, N, _, H, D), = [s for k, s in census["loop"] if k == "attention"]
    qkv = torch.randn(B, N, 3 * H * D, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv.view(B, N, 3, H, D).unbind(2)
    q = q * 3
    got = flash_attention(q, k, v)
    if not torch.equal(got, flash_attention(q.contiguous(), k.contiguous(), v.contiguous())):
        raise AssertionError("attention: projection views differ from contiguous inputs")
    err = compare("attention", torch.bfloat16, got,
                  torch.cat([plain_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1])
                             for i in range(B)]), "joint attention projection views")
    print(f"phase 12 attention bf16 views of one [{B}, {N}, 3 x {H * D}] projection: bit-equal "
          f"to contiguous, max abs err {err:.3e}")
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    return len(work)


def time_sd3_kernels(census, card):
    """Timing rows (``timing_row``, bf16) at the loops' shapes: the joint
    attention of the exact, ToMe 0.5 and 0.25, T5 and SD3_SMALL^2 forwards
    (launches a forward) and the GroupNorm of a decode of BATCH at 1024^2;
    totals of one MMDiT forward (the kernel's SD3 column: per-shape median x
    launches, beside SDPA's time for the same calls and the bound) and of
    one decode."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows, totals = [], {}
    for part, kinds in (("loop", ("attention",)), ("tome", ("attention",)),
                        ("tome_025", ("attention",)), ("t5", ("attention",)),
                        ("small", ("attention",)), ("vae", ("group_norm",))):
        for (kind, shape), n in sorted(census[part].items(), key=lambda kv: str(kv[0])):
            if kind not in kinds:
                continue
            r = timing_row(kind, shape, torch.bfloat16, f"sd3 {part}", n, gen)
            rows.append(r)
            agg = totals.setdefault(part, {}).setdefault(
                kind, dict(launches=0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0))
            agg["launches"] += n
            for field in ("ms", "plain_ms", "library_ms", "bound_ms"):
                agg[field] += r[field] * n
        torch.cuda.empty_cache()
    print(f"phase 12 kernel totals (ms over one MMDiT forward at UNet batch {2 * BATCH} and one "
          f"SD3 decode of {BATCH} at {SD3_SIZE}^2; {card}): " + json.dumps(totals), flush=True)
    return rows, totals


def sd3_tiny_card_vs_cpu(census):
    """Tiny fp32 SD3 pipelines on the card (graphed) against the same weights
    on the CPU, batch BATCH, CFG SD3_GUIDANCE, 8 flow Euler steps: exact,
    trunk-delta (interval 2, branch 1), ToMe 0.5 (the engine's own
    destinations, drawn on the host), with T5, the two-scheduler switch and
    step skipping; images within 1e-3, the exact run's fp32 attention
    launches the census's.  Then int8 runs, held to the CPU's drift from
    its exact run, with their int8 GEMMs the census's."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.models.sampler import CachePlan
    from sonicdiffusionbayeslab_torch.ops.flash_attention import flash_attention_tf32x3
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    W = GraphedCall.WARMUP
    prompts = ["a lighthouse at dusk", "a red boat"]
    kw = dict(num_inference_steps=8, guidance_scale=SD3_GUIDANCE, seed=29)
    out = {}

    def pair(name="stable_diffusion_3_model", **extra):
        cpu = sd3_pipeline(name, tiny=True, dtype="float32", seed=0, device="cpu", **extra)
        card = sd3_pipeline(name, tiny=True, dtype="float32", seed=0, device="cuda", **extra)
        card.engine.load_state_dicts({k: m.state_dict() for k, m in
                                      zip(cpu.engine.MODULES, cpu.engine.modules())})
        return cpu, card

    base = pair()
    cases = [("exact", base, {}, None), ("trunk_delta", base, {}, (2, 1)),
             ("tome", base, dict(tome_ratio=SD3_TOME), None),
             ("t5", pair(use_t5=True), {}, None),
             ("two_schedulers", pair("stable_diffusion_3_model_two_schedulers"),
              dict(num_step_switch=3), None),
             ("skip", pair("stable_diffusion_3_model_skip_timesteps"),
              dict(skip_timesteps=[2, 5]), None)]
    per = {p: _kinds(census[p])["attention"] for p in ("tiny", "tiny_vae")}
    for name, (cpu, card), extra, cache in cases:
        for m in (cpu, card):
            m.cache_plan_fn = (lambda n, c=cache: CachePlan.every(n, *c)) if cache else None
        a = cpu(prompts, **kw, **extra)[0]
        flash_attention_tf32x3.launches = 0
        b = card(prompts, **kw, **extra)[0]
        launches = flash_attention_tf32x3.launches
        for m in (cpu, card):
            m.cache_plan_fn = None
        err = float(np.abs(a - b).max())
        print(f"tiny fp32 SD3 {name} ({card.num_timesteps} rows), card vs CPU: max abs image err "
              f"{err:.3e} (tolerance 1e-3); flash_attention_tf32x3 launches {launches}; graph "
              f"captures {card.engine.graphed_unet.captures}", flush=True)
        if not err <= 1e-3 or not np.isfinite(b).all():
            raise AssertionError(f"the tiny SD3 {name} run on the card disagrees with the CPU")
        want = (W + 1) * per["tiny"] + per["tiny_vae"]
        if name == "exact" and launches != want:
            raise AssertionError(f"the tiny SD3 run launched the fp32 attention kernel "
                                 f"{launches} times, expected {want}")
        out[name] = dict(max_abs_image_err=err, fp32_attention_launches=launches)
    caps = base[1].engine.graphed_unet.captures
    if sorted(caps.values()) != [1] * 4:  # plain, trunk-delta's full and cached, ToMe
        raise AssertionError(f"the tiny SD3 runs captured {caps}")
    cpu, card = base
    exact = cpu(prompts, **kw)[0]
    for m in (cpu, card):
        m.engine.set_quant_mode("int8")
    try:
        a = cpu(prompts, **kw)[0]
        int8_counts(reset=True)
        b = card(prompts, **kw)[0]
        q = int8_counts()
    finally:
        for m in (cpu, card):
            m.engine.set_quant_mode(None)
    rel = lambda x, y: float(np.linalg.norm(x - y) / np.linalg.norm(y))  # noqa: E731
    err, card_rel, drift = float(np.abs(a - b).max()), rel(b, a), rel(a, exact)
    n = (W + 1) * _kinds(census["tiny_int8"])["int8_dense"]
    print(f"tiny fp32 SD3 int8 run, card vs CPU: max abs image err {err:.3e} (within 1e-3: "
          f"{err <= 1e-3}), relative {card_rel:.3e} against the CPU's quantized-vs-exact drift "
          f"{drift:.3e}; int8 launches {q} (expected {n} GEMMs and dense calls)", flush=True)
    if not card_rel < drift or q != {"int8_gemm": n, "int8_conv": 0, "int8_dense": n}:
        raise AssertionError(f"the tiny SD3 int8 run on the card: relative err {card_rel:.3e}, "
                             f"drift {drift:.3e}, int8 launches {q}")
    out["int8"] = dict(max_abs_image_err=err, relative_err=card_rel, cpu_drift=drift,
                       int8_launches=q)
    return out


def sd3_loops(model, census, card, reps=(2, 2, 2, 1)):
    """SD3-medium at SD3_SIZE^2 through the pipeline (random bf16 weights,
    SD3_STEPS-step flow Euler at shift SD3_SHIFT, CFG SD3_GUIDANCE, batch
    BATCH): one run at SD3_SMALL^2 first (its own capture); then exact,
    trunk-delta (interval and branch SD3_CACHE), ToMe SD3_TOME and int8,
    each first run capturing its graphs with the wrappers' counts set to 0
    just before and read just after (the census of each variant's warm-ups
    and capture and one decode; int8 dense calls and GEMMs too), then
    ``reps`` warm runs of each in turns (exact, trunk-delta, ToMe, int8;
    execution_time, peak memory); a warm exact
    run traced (24 joint attentions a forward, by kernel name); one
    capture per variant (the plain one's second, after SD3_SMALL's).
    Returns the results and the exact run's images."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.models.sampler import CachePlan
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    W = GraphedCall.WARMUP
    eng = model.engine
    kw = dict(num_inference_steps=SD3_STEPS, guidance_scale=SD3_GUIDANCE, seed=29)
    vae = _kinds(census["vae"])
    out = {}
    wrapper_counts(reset=True)
    imgs, secs, _ = model(PROMPTS, height=SD3_SMALL, width=SD3_SMALL, **kw)
    counts = bf16_only(wrapper_counts(), "sd3 512 run")
    want = {k: (W + 1) * _kinds(census["small"])[k] + _kinds(census["vae_small"])[k] for k in MAIN}
    print(f"SD3 {SD3_SMALL}x{SD3_SMALL}, {SD3_STEPS} steps, batch {BATCH}: execution_time "
          f"{secs:.4f} s (graph capture included); wrapper launches {counts} (expected {want})",
          flush=True)
    if counts != want or imgs.shape != (BATCH, SD3_SMALL, SD3_SMALL, 3) or \
            not np.isfinite(imgs).all():
        raise AssertionError(f"SD3 {SD3_SMALL} run: launches {counts}, images {imgs.shape}")
    out["small"] = dict(execution_time_s=secs, first_run_wrapper_launches=counts)
    full = SD3_STEPS // SD3_CACHE[0] + bool(SD3_STEPS % SD3_CACHE[0])
    runs = {"exact": ({}, None, None), "trunk_delta": ({}, SD3_CACHE, None),
            "tome": (dict(tome_ratio=SD3_TOME), None, None), "int8": ({}, None, "int8")}

    def run(name):
        extra, cache, quant = runs[name]
        model.cache_plan_fn = (lambda n: CachePlan.every(n, *cache)) if cache else None
        eng.set_quant_mode(quant)
        try:
            return model(PROMPTS, **kw, **extra)
        finally:
            eng.set_quant_mode(None)
            model.cache_plan_fn = None

    first, launches = {}, {}
    for name in runs:
        wrapper_counts(reset=True)
        int8_counts(reset=True)
        first[name] = run(name)[0]
        counts, q = bf16_only(wrapper_counts(), f"sd3 {name}"), int8_counts()
        launches[name] = counts
        parts = {"exact": ["loop"], "trunk_delta": ["loop", "shallow"], "tome": ["tome"],
                 "int8": ["int8"]}[name]
        want = {k: (W + 1) * sum(_kinds(census[p])[k] for p in parts) + vae[k] for k in MAIN}
        n8 = (W + 1) * _kinds(census["int8"])["int8_dense"] if name == "int8" else 0
        want_q = {"int8_gemm": n8, "int8_conv": 0, "int8_dense": n8}
        print(f"SD3 {name} first run: wrapper launches {counts} (expected {want}), int8 {q} "
              f"(expected {want_q})", flush=True)
        if counts != want or q != want_q or not np.isfinite(first[name]).all():
            raise AssertionError(f"SD3 {name} first run: launches {counts}, int8 {q}")
    times = {name: [] for name in runs}
    peak = {}
    left = dict(zip(runs, reps))
    for i in range(max(reps)):
        for name in (runs if i % 2 == 0 else reversed(list(runs))):
            if not left[name]:
                continue
            left[name] -= 1
            torch.cuda.reset_peak_memory_stats()
            imgs, secs, _ = run(name)
            times[name].append(secs)
            peak[name] = max(peak.get(name, 0.0), torch.cuda.max_memory_allocated() / 1e9)
            if name == "exact" and not np.array_equal(imgs, first["exact"]):
                raise AssertionError("SD3: a warm exact run gave other images")
    wrapper_counts(reset=True)
    want = {k: SD3_STEPS * _kinds(census["loop"])[k] + vae[k] for k in MAIN}
    (imgs, _, _), traced, _ = traced_exact(lambda: run("exact"), want, "the SD3 exact run",
                                           same=lambda o: np.array_equal(o[0], first["exact"]))
    traced = bf16_only(traced, "sd3 exact (trace)")
    caps = {", ".join(f"{k}={v}" for k, v in key) or "plain": n
            for key, n in eng.graphed_unet.captures.items()}
    drift = {name: float(np.linalg.norm(first[name] - first["exact"]) /
                         np.linalg.norm(first["exact"])) for name in runs if name != "exact"}
    out.update(execution_time_s=times, median_s={k: statistics.median(v) for k, v in times.items()},
               sec_per_image={k: statistics.median(v) / BATCH for k, v in times.items()},
               peak_gb=peak, image_drift=drift, traced_launches=traced, graph_captures=caps,
               first_run_wrapper_launches=launches, trunk_delta_full_steps=full)
    print(f"SD3 engine loops, bf16 {SD3_SIZE}x{SD3_SIZE}, {SD3_STEPS}-step flow Euler (shift "
          f"{SD3_SHIFT}), CFG {SD3_GUIDANCE}, batch {BATCH} (warm, in turns, {reps} runs): "
          f"execution_time medians {out['median_s']} s; peak memory {peak} GB; images' relative "
          f"drift from exact {drift}; traced exact run {traced} (expected {want}); graph captures "
          f"{caps}; {card}", flush=True)
    if traced != want or not np.array_equal(imgs, first["exact"]):
        raise AssertionError(f"SD3 exact traced run: {traced}, expected {want}")
    # The plain variant was captured at SD3_SMALL^2, then at SD3_SIZE^2.
    if sorted(eng.graphed_unet.captures.values()) != [1, 1, 1, 1, 2]:
        raise AssertionError(f"SD3 loops: graph captures {caps}")
    if not all(0.0 < d < 1.0 for d in drift.values()):
        raise AssertionError(f"SD3 loops: drift {drift}")
    return out, first["exact"]


def sd3_t5_runs(census, card):
    """``use_t5=True``: the pipeline resident (T5-XXL on the card) and
    staged (its weights in host memory, on the card only for the call's
    encodes), each built from seed 0 and run once like the exact loop; the
    images bit-equal, each run's launches the census's at 333 context
    tokens, the staged pipeline's T5 back in host memory, and each run's
    peak memory and the memory allocated after it."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    W = GraphedCall.WARMUP
    kw = dict(num_inference_steps=SD3_STEPS, guidance_scale=SD3_GUIDANCE, seed=29)
    want = {k: (W + 1) * _kinds(census["t5"])[k] + _kinds(census["vae"])[k] for k in MAIN}
    imgs, out = {}, {}
    for staged in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pipe = sd3_pipeline(image_size=SD3_SIZE, seed=0, device="cuda", use_t5=True,
                            t5_staged=staged)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        held_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        wrapper_counts(reset=True)
        t0 = time.perf_counter()
        imgs[staged], secs, _ = pipe(PROMPTS, **kw)
        wall = time.perf_counter() - t0
        counts = bf16_only(wrapper_counts(), "sd3 t5")
        name = "staged" if staged else "resident"
        t5_dev = pipe.engine.t5.shared.weight.device.type
        out[name] = dict(init_s=init_s, execution_time_s=secs, call_s=wall,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         allocated_before_gb=held_gb,
                         allocated_after_gb=torch.cuda.memory_allocated() / 1e9,
                         t5_device=t5_dev, wrapper_launches=counts)
        print(f"SD3 + T5-XXL {name}: {json.dumps(out[name])}; {card}", flush=True)
        if counts != want or t5_dev != ("cpu" if staged else "cuda") or pipe._t5_dev is not None:
            raise AssertionError(f"SD3 + T5 {name}: launches {counts} (expected {want}), T5 on "
                                 f"{t5_dev}")
        del pipe
    if not np.array_equal(imgs[False], imgs[True]) or not np.isfinite(imgs[True]).all():
        raise AssertionError("SD3 + T5: staged and resident images differ")
    return out


def write_sd3_snapshots(model, root):
    """The phase's SD3 weights (``model``'s, random from seed 0) and a
    random SD-1.5 model's as diffusers snapshots under ``root``; returns
    their paths and the seconds the writes took."""
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
    from sonicdiffusionbayeslab_torch.models.weights import write_snapshot

    t0 = time.perf_counter()
    sd3 = write_snapshot(model.engine, Path(root) / "sd3")
    sd15_pipe = StableDiffusionModel(image_size=SIZE, seed=0, device="cuda")
    sd15 = write_snapshot(sd15_pipe.engine, Path(root) / "sd15")
    del sd15_pipe
    secs = time.perf_counter() - t0
    gb = sum(f.stat().st_size for d in (sd3, sd15) for f in d.rglob("*") if f.is_file()) / 1e9
    print(f"random SD3-medium and SD-1.5 snapshots written: {gb:.2f} GB in {secs:.1f} s",
          flush=True)
    return dict(sd3=sd3, sd15=sd15, write_s=secs, gb=gb)


def run_sd3_cli(name, point, label, nfe, chunk, x0, census, assets, snapshots, card,
                trace=False):
    """``cli.run`` of configs/<name>.yaml as shipped at full width on the
    phase's SD3 snapshot (its first sweep point, one batch of
    SD3_CLI_BATCH prompts, phase 9's real images and checkpoints: clip_score,
    fid at 64, image_reward), in a working directory under ``assets``: its
    table row, PNGs, one graph capture, the peak memory, and each kernel's
    launches against the census by the wrappers (and, with ``trace``, by a
    trace): the MMDiT's warm-ups and capture at its chunk of ``chunk``
    rows, a decode of the batch and, where the method captures x0, one a
    step, the metric towers' fp32 attention of one validate batch."""
    import csv

    import numpy as np

    from sonicdiffusionbayeslab_torch import cli
    from sonicdiffusionbayeslab_torch.config import load_config
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    repo = Path(__file__).resolve().parent
    config = str(repo / "configs" / f"{name}.yaml")
    W = GraphedCall.WARMUP
    per = _kinds(census["cli" if chunk == 2 * SD3_CLI_BATCH else "cli_chunk"])
    per_vae = _kinds(census["vae_cli"])
    calls = 2 * SD3_CLI_BATCH // chunk  # MMDiT calls a step
    decodes = 1 + nfe * x0
    fp32 = sum(metric_census(SD3_CLI_BATCH, aesthetic=False).values())
    want = {k: (W + 1) * per[k] + decodes * per_vae[k] for k in MAIN}
    want_traced = {k: (W + nfe * calls) * per[k] + decodes * per_vae[k] for k in MAIN}
    want["attention_fp32"] = want_traced["attention_fp32"] = fp32
    overrides = {
        **point, "model.pretrained_model": str(snapshots["sd3"]),
        "dataset.img_dataset": str(assets["img_dir"]), "dataset.max_count": SD3_CLI_BATCH,
        "quality_metrics.image_reward.checkpoint": str(assets["ckpts"]["image_reward"]),
        "quality_metrics.fid.inception_checkpoint": str(assets["ckpts"]["inception"]),
        "logger.run_id": name,
        "dataset.prompts": str(repo / "data" / "dataset" / "img2annotations_test.json")}
    work = Path(assets["root"]) / name
    work.mkdir()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        wrapper_counts(reset=True)
        t0 = time.perf_counter()
        with _RecordingVariants() as rec:
            if trace:
                metrics, traced, _ = traced_exact(lambda: cli.run(config, overrides), want_traced,
                                                  f"the {name} CLI run", reset=retrace_reset(
                                                      rec, run_dir=work / "outputs" / name))
            else:
                metrics, traced = cli.run(config, overrides), None
        wall = time.perf_counter() - t0
        counts = wrapper_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        caps, graphs_gb = rec.captures()
        with open(work / "outputs" / name / "tables" / "final.tsv") as f:
            rows = list(csv.DictReader(f, delimiter="\t"))
        pngs = sorted((work / "outputs" / load_config(config).get("experiment_name") /
                       label).iterdir())
    finally:
        os.chdir(cwd)
    row = rows[0] if rows else {}
    vals = {k: float(row[k]) for k in ("clip_score", "fid", "image_reward") if k in row}
    print(f"{name} as shipped ({label}, nfe {nfe}, MMDiT chunk {chunk}, bf16 {SD3_SIZE}x{SD3_SIZE}, "
          f"batch {SD3_CLI_BATCH}, random snapshot, real-image directory; clip_score, fid at 64, "
          f"image_reward on random towers): whole CLI {wall:.3f} s, sweep {row.get('time')} "
          f"s/image, {vals}; peak memory {peak_gb:.2f} GB; graph captures {dict(caps)} "
          f"({graphs_gb:.3f} GB); launches: wrappers {counts} (expected {want}), trace {traced} "
          f"(expected {want_traced if trace else None}); {card}", flush=True)
    if list(row) != ["exp", "nfe", "time", "clip_score", "fid", "image_reward"] or \
            len(rows) != 1 or row["exp"] != label or row["nfe"] != str(nfe):
        raise AssertionError(f"{name} run: table rows {rows}")
    if metrics["exp"] != [label]:
        raise AssertionError(f"{name} run: CLI returned {metrics}")
    if not all(np.isfinite(v) for v in vals.values()) or not 0 <= vals["image_reward"] <= 1:
        raise AssertionError(f"{name} run: values {vals}")
    if not (np.isfinite(float(row["time"])) and float(row["time"]) > 0):
        raise AssertionError(f"{name} run: time {row['time']}")
    if len(pngs) != SD3_CLI_BATCH or {_png_size(p) for p in pngs} != {(SD3_SIZE, SD3_SIZE)}:
        raise AssertionError(f"{name} run: {len(pngs)} PNGs")
    if sorted(caps.values()) != [1]:
        raise AssertionError(f"{name} run: graph captures {caps}")
    if counts != want or (trace and traced != want_traced):
        raise AssertionError(f"{name} run: launches wrappers {counts}, trace {traced}")
    return dict(wall_s=wall, sec_per_image=float(row["time"]), values=vals, peak_gb=peak_gb,
                graph_reserved_gb=graphs_gb, wrapper_launches=counts, traced_launches=traced)


def run_frontier(snapshots, root, card):
    """``python -m sonicdiffusionbayeslab_torch.quality_frontier``'s ``main``
    on the phase's random SD-1.5 and SD3 snapshots and a random CLIP
    ViT-B/16 (FRONTIER: prompts, batches, steps): its 16 rows (9 SD-1.5, 7
    SD3) in the TSV and JSONL, each with the steps' NFE, a finite CLIP score
    and time, and the wrappers' launches over the run."""
    import csv

    import numpy as np

    from sonicdiffusionbayeslab_torch import quality_frontier

    out_prefix = Path(root) / "frontier" / "frontier"
    args = ["--sd15", str(snapshots["sd15"]), "--sd3", str(snapshots["sd3"]),
            "--clip", "openai/clip-vit-base-patch16", "--prompts", str(FRONTIER["prompts"]),
            "--batch", str(FRONTIER["batch"]), "--sd3-batch", str(FRONTIER["sd3_batch"]),
            "--steps", str(FRONTIER["steps"]), "--device", "cuda", "--out", str(out_prefix)]
    gc.collect()
    torch.cuda.empty_cache()
    wrapper_counts(reset=True)
    int8_counts(reset=True)
    t0 = time.perf_counter()
    rc = quality_frontier.main(args)
    wall = time.perf_counter() - t0
    counts, q = wrapper_counts(), int8_counts()
    with open(f"{out_prefix}.tsv") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    jsonl = [json.loads(line) for line in open(f"{out_prefix}.jsonl")]
    labels = [m.label for m in quality_frontier.SD15_MODES + quality_frontier.SD3_MODES]
    print(f"quality_frontier ({' '.join(args[:-2])}): {len(rows)} rows in {wall:.1f} s; "
          f"launches: wrappers {counts}, int8 {q}; {card}", flush=True)
    for r in rows:
        print("frontier " + json.dumps(r), flush=True)
    if rc != 0 or [r["mode"] for r in rows] != labels or [r["mode"] for r in jsonl] != labels:
        raise AssertionError(f"frontier: rc {rc}, rows {[r['mode'] for r in rows]}")
    if any(r["nfe"] != str(FRONTIER["steps"]) or not float(r["sec_per_image"]) > 0
           or not np.isfinite(float(r["clip_score"])) for r in rows):
        raise AssertionError(f"frontier rows {rows}")
    return dict(wall_s=wall, rows=rows, wrapper_launches=counts, int8_launches=q)


def phase12_launches(out, kind):
    """A kernel's launches in each phase-12 run: wrappers over each first
    (capturing) run, and the traces."""
    if kind == "attention_fp32":
        return {**{f"tiny {n}": r["fp32_attention_launches"]
                   for n, r in out["tiny_card_vs_cpu"].items() if "fp32_attention_launches" in r},
                **{f"{n} cli": r["wrapper_launches"][kind] for n, r in out["cli"].items()},
                "frontier": out["frontier"]["wrapper_launches"][kind]}
    loops = out["loops"]
    return {"512 first run": loops["small"]["first_run_wrapper_launches"][kind],
            **{f"{n} first run": c[kind] for n, c in loops["first_run_wrapper_launches"].items()},
            "exact trace": loops["traced_launches"][kind],
            **{f"t5 {n}": r["wrapper_launches"][kind] for n, r in out["t5"].items()},
            **{f"{n} cli": r["wrapper_launches"][kind] for n, r in out["cli"].items()},
            **{f"{n} cli trace": r["traced_launches"][kind] for n, r in out["cli"].items()
               if r["traced_launches"]},
            "frontier": out["frontier"]["wrapper_launches"][kind]}


def run_sd3(report, card, assets, profile):
    """Phase 12: SD3-medium at full width."""
    import numpy as np

    census = sd3_census()
    per = {part: dict(_kinds(c)) for part, c in census.items()}
    print(f"phase 12 census (launches a call): {json.dumps(per)}", flush=True)
    if per["loop"]["attention"] != 24 or per["tome"]["attention"] != 24 or \
            per["int8"]["int8_dense"] != 1 + 23 * 12 + 9 + 1 or "group_norm" in per["loop"]:
        raise AssertionError(f"the SD3-medium MMDiT census gives {per['loop']}, {per['tome']}, "
                             f"{per['int8']}: expected 24 joint attentions a forward, no "
                             f"GroupNorm, 287 int8 dense calls")
    joint = sorted({shape[1] for p in ("loop", "t5", "tome", "tome_025", "small")
                    for kind, shape in census[p] if kind == "attention"})
    print(f"phase 12 joint attention token counts: {joint}", flush=True)
    if joint != [1101, 2125, 3149, 4173, 4429]:
        raise AssertionError(f"joint sequence lengths {joint}")
    out = {"census": per}
    # The rest of the phase keeps the card busy and the host mostly idle:
    # the rank processes of phases 16-18 import now, then wait.
    prestart_ranks([("--dp-rank", None, r) for r in range(DP_RANKS)]
                   + [("--tp-rank", m, r) for m, n in TP_WORLD.items() for r in range(n)])
    out["checked_shapes"] = check_sd3_kernels(census, report)
    out["timings"], out["kernel_totals"] = time_sd3_kernels(census, card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["tiny_card_vs_cpu"] = sd3_tiny_card_vs_cpu(census)
    torch.backends.cudnn.allow_tf32 = True
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = sd3_pipeline(image_size=SD3_SIZE, seed=0, device="cuda")
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    eng = model.engine
    out["params_m"] = {n: sum(p.numel() for p in m.parameters()) / 1e6
                       for n, m in zip(eng.MODULES, eng.modules())}
    print(f"SD3-medium random bf16 init on the card: {out['init_s']:.1f} s; parameters (M) "
          f"{out['params_m']}", flush=True)
    out["loops"], before = sd3_loops(model, census, card)
    if profile:
        out["profile"] = profile_loop(model, size=SD3_SIZE, label="profile sd3")
        out["profile_tome"] = profile_loop(model, tome=SD3_TOME, size=SD3_SIZE,
                                           label=f"profile sd3 tome {SD3_TOME}")
        eng.set_quant_mode("int8")
        try:
            out["profile_int8"] = profile_loop(model, size=SD3_SIZE, label="profile sd3 int8")
        finally:
            eng.set_quant_mode(None)
    out["t5"] = sd3_t5_runs(census, card)
    snapshots = write_sd3_snapshots(model, assets["root"])
    out["snapshots"] = dict(write_s=snapshots["write_s"], gb=snapshots["gb"])
    out["cli"] = {}
    for i, (name, point, label, nfe, chunk, x0) in enumerate(SD3_CLI_RUNS):
        out["cli"][name] = run_sd3_cli(name, point, label, nfe, chunk, x0, census, assets,
                                       snapshots, card, trace=i == 0)
    out["frontier"] = run_frontier(snapshots, assets["root"], card)
    kw = dict(num_inference_steps=SD3_STEPS, guidance_scale=SD3_GUIDANCE, seed=29)
    int8_counts(reset=True)
    after = model(PROMPTS, **kw)[0]
    leak = int8_counts()
    print(f"an exact SD3 run after the int8, T5, CLI and frontier runs: bit-equal to the one "
          f"before them {np.array_equal(before, after)}, int8 launches {leak}", flush=True)
    if not np.array_equal(before, after) or any(leak.values()):
        raise AssertionError("the SD3 exact run changed after the int8 and frontier runs")
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()
    report["e2e"]["sd3"] = out


def cond_census():
    """Phase 13's {(kind, shape): launches} at full SD-1.5 width, by call:
    the loops' one call at UNet batch 2 x BATCH (the ControlNet before the
    UNet; the UNet with IP's tokens; the exact call), the served batches'
    UNet forward (UNet batch 2 x SERVE_BATCH, also serve_bench's chunks),
    VAE decodes of SERVE_BATCH and SERVE_BENCH_BATCH latents, and the tiny
    fp32 runs' ControlNet and IP calls."""
    return dict(
        control=module_census(2 * BATCH, control=True),
        ip=module_census(2 * BATCH, ip=True),
        exact=module_census(2 * BATCH),
        serve_unet=module_census(2 * SERVE_BATCH),
        serve_vae=module_census(vae_batch=SERVE_BATCH),
        bench_vae=module_census(vae_batch=SERVE_BENCH_BATCH),
        tiny_control=module_census(2 * BATCH, tiny=True, control=True),
        tiny_ip=module_census(2 * BATCH, tiny=True, ip=True))


def check_cond_kernels(census, report, checked):
    """Each kernel against its plain version at every phase-13 shape that
    phase 3 did not check (``checked``: the (kind, shape), dtype pairs it
    did): bf16 at the full-width calls' (the M = 4 crosses of IP-Adapter,
    serve_bench's VAE decodes of 32), fp32 at the tiny runs' (their M = 4
    crosses); max errors into ``report["errs"]`` and
    ``report["phase13_errs"]``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(13)
    full = ("control", "ip", "serve_unet", "serve_vae", "bench_vae")
    work = sorted(({(k, torch.bfloat16) for p in full for k in census[p]} |
                   {(k, torch.float32) for p in census if p.startswith("tiny")
                    for k in census[p]}) - checked,
                  key=lambda w: (str(w[1]), w[0][0], [str(v) for v in w[0][1]]))
    for (kind, shape), dtype in work:
        inputs = (attn_inputs if kind == "attention" else gn_inputs)(shape, dtype, gen)
        kern, plain = run_kernel(kind, shape, inputs)
        got = kern()
        torch.cuda.synchronize()
        err = compare(kind, dtype, got, plain(), f"{kind} {shape} {dtype} (phase 13)")
        report["errs"][report_key(kind, dtype)].append(err)
        report["phase13_errs"][report_key(kind, dtype)].append(err)
        print(f"phase 13 {kind} {str(dtype)[6:]} {shape}: max abs err {err:.3e}")
        del inputs, got
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    return len(work)


def time_ip_crosses(census, card):
    """Timing rows (``timing_row``: the kernel, its plain version, SDPA and
    the bound) at IP-Adapter's M = 4 crosses, bf16, with their launches in
    one UNet forward, and their sum over one forward."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = [timing_row(kind, shape, torch.bfloat16, "ip unet", n, gen)
            for (kind, shape), n in sorted(census["ip"].items(), key=lambda kv: str(kv[0]))
            if kind == "attention" and shape[2] == IP_TOKENS]
    total = {f: sum(r[f] * r["launches_per_run"] for r in rows)
             for f in ("ms", "plain_ms", "library_ms", "bound_ms")}
    total["launches"] = sum(r["launches_per_run"] for r in rows)
    print(f"phase 13 IP-Adapter M = {IP_TOKENS} crosses, sums over one UNet forward at UNet batch "
          f"{2 * BATCH} ({card}): {json.dumps(total)}", flush=True)
    if total["launches"] != 16:
        raise AssertionError(f"{total['launches']} IP crosses a SD-1.5 forward, expected 16")
    return rows, total


def cond_tiny_card_vs_cpu():
    """Tiny fp32 pipelines, card (graphed) against CPU on the same weights,
    20-step DPM++ at batch 2, CFG 7.5: ControlNet (random heads, a 64^2
    control image at scale 0.8), IP-Adapter (a random adapter at scale 1.0)
    and prompt weighting, each image within 1e-3; the fp32 attention
    kernel's launches in each card run."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.models.pipelines import (StableDiffusionControlNetModel,
                                                               StableDiffusionModel)
    from sonicdiffusionbayeslab_torch.ops.flash_attention import flash_attention_tf32x3

    def pair(cls, **kw):
        cpu = cls(tiny=True, image_size=64, dtype="float32", seed=0, device="cpu", **kw)
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            # The text tower's final LayerNorm with a bias, as a trained one
            # has: with the init's zero bias every token's states average to
            # 0, and prompt weighting's rescale by the ratio of two means
            # near 0 is ill-conditioned (in the JAX package alike).
            dict(cpu.engine.text.named_parameters())["text_model.final_layer_norm.bias"].normal_(
                0.0, 0.05, generator=gen)
            if cpu.engine.controlnet is not None:
                for conv in cpu.engine.controlnet.heads():
                    conv.weight.normal_(0.0, 0.05, generator=gen)
        card = cls(tiny=True, image_size=64, dtype="float32", seed=0, device="cuda", **kw)
        src, dst = cpu.engine, card.engine
        dst.load_state_dicts({**{k: m.state_dict() for k, m in zip(src.MODULES, src.modules())},
                              **({"image_proj": src.image_proj.state_dict()}
                                 if src.image_proj is not None else {})})
        if src.controlnet is not None:
            dst.controlnet.load_state_dict(src.controlnet.state_dict())
            dst.weights_changed()
        return cpu, card

    rng = np.random.default_rng(0)
    control = rng.random((BATCH, 64, 64, 3)).astype(np.float32)
    embeds = rng.standard_normal((BATCH, 1024)).astype(np.float32)
    kw = dict(num_inference_steps=STEPS, guidance_scale=GUIDANCE, seed=29)
    cn = pair(StableDiffusionControlNetModel)
    ipw = pair(StableDiffusionModel, ip_adapter="random.bin", prompt_weighting=True)
    runs = {"controlnet": (cn, ["a lighthouse at dusk", "a red boat"],
                           dict(control_image=control, controlnet_scale=0.8)),
            "ip_adapter": (ipw, ["a lighthouse at dusk", "a red boat"],
                           dict(ip_image_embeds=embeds, ip_scale=1.0)),
            "prompt_weighting": (ipw, ["a (lighthouse:1.4) at [dusk]", "a ((red)) boat"], {})}
    out = {}
    for name, ((cpu, card), prompts, extra) in runs.items():
        a = cpu(prompts, **kw, **extra)[0]
        flash_attention_tf32x3.launches = 0
        b = card(prompts, **kw, **extra)[0]
        launches = flash_attention_tf32x3.launches
        err = float(np.abs(a - b).max())
        print(f"tiny fp32 {name}, card (graphed) vs CPU: max abs image err {err:.3e} (tolerance "
              f"1e-3); flash_attention_tf32x3 launches {launches}; captures "
              f"{card.engine.graphed_unet.captures}", flush=True)
        if not err <= 1e-3 or launches <= 0:
            raise AssertionError(f"the tiny {name} run on the card disagrees with the CPU "
                                 f"({err:.3e}) or launched no fp32 attention kernel")
        out[name] = dict(max_abs_image_err=err, fp32_attention_launches=launches)
    plain = ipw[0](["a lighthouse at dusk", "a red boat"], **kw)[0]
    if not np.abs(plain - ipw[0](runs["prompt_weighting"][1], **kw)[0]).max() > 1e-4:
        raise AssertionError("prompt weighting left the tiny images as they were")
    return out


def cond_loops(census, card, reps=3):
    """SD-1.5 at full width on random bf16 weights, 20-step DPM++ at batch
    BATCH, CFG GUIDANCE (engine level, no decode), each loop's UNet call
    graphed: exact, ControlNet (random encoder copy, random heads, scale
    1.0) and IP-Adapter (a random adapter, scale 1.0).  Each: a first run
    with the wrappers' counts set to 0 just before and read just after
    (graph warm-up and capture: the census of one call x 3), ``reps`` warm
    runs (execution_time, median; their latents bit-equal), and a traced
    run whose kernel executions must be STEPS x the census of one call."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionControlNetModel
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = StableDiffusionControlNetModel(image_size=SIZE, dtype="bfloat16", seed=0,
                                           device="cuda", ip_adapter="random.bin")
    eng = model.engine
    gen = torch.Generator(device="cuda").manual_seed(2)
    with torch.no_grad():
        for conv in eng.controlnet.heads():
            conv.weight.normal_(0.0, 0.02, generator=gen)
    eng.weights_changed()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    plan = model.build_plan(STEPS)
    emb, neg = model._encode(PROMPTS), model._encode([""] * BATCH)
    rng = np.random.default_rng(1)
    hint = rng.random((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    embeds = rng.standard_normal((BATCH, model.ip_embed_dim)).astype(np.float32)
    loops = {"exact": ({}, "exact"),
             "controlnet": (dict(control={"image": hint, "scale": 1.0}), "control"),
             "ip_adapter": (dict(ip_adapter={"image_embeds": embeds, "scale": 1.0}), "ip")}
    kw = dict(guidance_scale=GUIDANCE, latent_hw=(SIZE // 8, SIZE // 8), seed=29, decode=False)
    out = {"init_s": init_s}
    latents = {}
    for name, (extra, part) in loops.items():
        per_call = {k: _kinds(census[part])[k] for k in MAIN}
        wrapper_counts(reset=True)
        eng.sample(plan, emb, neg, **kw, **extra)
        first = bf16_only(wrapper_counts(), f"{name} loop")
        want = {k: (GraphedCall.WARMUP + 1) * n for k, n in per_call.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = [eng.sample(plan, emb, neg, **kw, **extra) for _ in range(reps)]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        times = [r.execution_time for r in runs]
        same = all(torch.equal(r.latents, runs[0].latents) for r in runs)
        traced_out, traced, traces = traced_exact(
            lambda: eng.sample(plan, emb, neg, **kw, **extra),
            {k: STEPS * n for k, n in per_call.items()}, f"the {name} loop",
            same=lambda o: torch.equal(o.latents, runs[0].latents))
        traced = bf16_only(traced, f"{name} loop (trace)")
        same = same and torch.equal(traced_out.latents, runs[0].latents)
        latents[name] = runs[0].latents
        rec = dict(execution_time_s=times, median_s=statistics.median(times),
                   sec_per_image=statistics.median(times) / BATCH,
                   images_per_hour=3600 * BATCH / statistics.median(times), peak_gb=peak_gb,
                   first_run_wrapper_launches=first, traced_launches=traced, traces=traces,
                   launches_per_call=per_call, repeats_bit_equal=same)
        print(f"phase 13 {name} loop, SD-1.5 bf16 {SIZE}x{SIZE}, {STEPS}-step DPM++, batch "
              f"{BATCH}, CFG {GUIDANCE} (warm, {reps} runs): execution_time {times} s, median "
              f"{rec['median_s']:.4f} s ({rec['images_per_hour']:.1f} images/hour, loop only); "
              f"peak memory {peak_gb:.2f} GB; repeats bit-equal {same}; launches a call "
              f"{per_call}: first run's wrappers {first}, traced run {traced} (trace {traces}); "
              f"{card}",
              flush=True)
        if first != want:
            raise AssertionError(f"{name} loop: first run's wrapper launches {first}, expected "
                                 f"{want}")
        if not same:
            raise AssertionError(f"{name} loop: repeated runs gave other latents")
        out[name] = rec
    for name in ("controlnet", "ip_adapter"):
        diff = float((latents[name] - latents["exact"]).abs().max())
        out[name]["max_abs_latent_diff_vs_exact"] = diff
        out[name]["vs_exact"] = out[name]["median_s"] / out["exact"]["median_s"]
        print(f"phase 13 {name} loop / exact loop: {out[name]['vs_exact']:.4f}x; max abs latent "
              f"difference from the exact loop {diff:.3e}", flush=True)
        if not diff > 1e-3:
            raise AssertionError(f"the {name} loop gave the exact loop's latents")
    out["captures"] = {str(k): v for k, v in eng.graphed_unet.captures.items()}
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _decode_png(b64):
    import base64

    from sonicdiffusionbayeslab_torch.data.imageio import _decode

    return _decode(base64.b64decode(b64), "a served PNG")


def serve_http(census, card):
    """``serving.server.serve`` on port 0 (max_batch SERVE_BATCH,
    pipeline_depth 2) in front of SD-1.5 at full width (random bf16 weights,
    20-step DPM++, CFG 7.5): one warm batch, then SERVE_REQUESTS concurrent
    /generate requests (seeds 100..), then one of them alone.  Gates: every
    PNG decodes to a SIZE^2 image; the lone request's PNG equals the served
    pixels of a direct pipeline call with its batch, whose device round
    equals the host round of its float images; the counters count the
    requests, and the batches as sum(1 / batch_size); the wrappers launched
    the census of one UNet forward x 3 (warm-up and capture) and a decode a
    batch.  Then, through the same server's ``submit`` from one thread (so
    rows follow the order of submission), a request among 7 others at row
    0 is bit-equal to it alone; at row 3 it differs only by rounding (the
    UNet's library matmuls or convolutions sum a row at another position in
    another order; the kernels, text tower and decode do not), within the
    5e-2 of phase 5's chunked run."""
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
    from sonicdiffusionbayeslab_torch.serving.batcher import quantize_uint8
    from sonicdiffusionbayeslab_torch.serving.server import serve
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    gc.collect()
    torch.cuda.empty_cache()
    pipe = StableDiffusionModel(image_size=SIZE, dtype="bfloat16", seed=0, device="cuda")
    ready = threading.Event()
    wrapper_counts(reset=True)
    th = threading.Thread(target=serve, args=(pipe, "stable_diffusion_model"), daemon=True,
                          kwargs=dict(host="127.0.0.1", port=0, max_batch=SERVE_BATCH,
                                      max_wait_ms=25.0, pipeline_depth=2, ready_event=ready))
    th.start()
    if not ready.wait(timeout=60):
        raise AssertionError("the server did not start")
    base = f"http://127.0.0.1:{ready.httpd.server_address[1]}"
    srv = ready.inference

    def post(body):
        req = urllib.request.Request(f"{base}/generate", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    def body(i):
        return {"prompt": PROMPTS[i % len(PROMPTS)], "steps": STEPS, "guidance": GUIDANCE,
                "seed": 100 + i}

    try:
        with ThreadPoolExecutor(max_workers=SERVE_REQUESTS) as pool:
            t0 = time.perf_counter()
            list(pool.map(post, [body(1000 + i) for i in range(SERVE_BATCH)]))
            warm_s = time.perf_counter() - t0
            before = dict(srv.stats)
            wait0 = srv.finisher_wait_s
            t0 = time.perf_counter()
            outs = list(pool.map(post, [body(i) for i in range(SERVE_REQUESTS)]))
            elapsed = time.perf_counter() - t0
        stats = {k: srv.stats[k] - before[k] for k in ("requests", "images", "batches", "errors")}
        finisher_wait = srv.finisher_wait_s - wait0
        full = [i for i, o in enumerate(outs) if o["batch_size"] == SERVE_BATCH]
        if not full:
            raise AssertionError(f"no request was served in a full batch of {SERVE_BATCH}: "
                                 f"batch sizes {[o['batch_size'] for o in outs]}")
        k = full[0]
        lone = post(body(k))
        counts = bf16_only(wrapper_counts(), "the served batches")
        health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=30).read())
        rows = served_rows(srv)
    finally:
        ready.httpd.shutdown()
        srv.shutdown(wait=True)
        th.join(timeout=60)
    pngs = [_decode_png(o["image_png_base64"]) for o in outs]
    if any(p.shape != (SIZE, SIZE, 3) for p in pngs):
        raise AssertionError("a served PNG did not decode to a 512x512 RGB image")
    lone_px = _decode_png(lone["image_png_base64"])
    if lone["batch_size"] != 1:
        raise AssertionError(f"the lone request rode a batch of {lone['batch_size']}")
    # The lone request's batch, called directly: the device round against
    # the host round of the same float images, and against the served pixels.
    seed_idx = 2 * (100 + k) + 1
    imgs, _, _ = pipe([PROMPTS[k % len(PROMPTS)]] + [""] * (SERVE_BATCH - 1),
                      num_inference_steps=STEPS, guidance_scale=GUIDANCE,
                      negative_prompt=[""] * SERVE_BATCH,
                      sample_indices=[seed_idx] + [0] * (SERVE_BATCH - 1), seed=0,
                      output_type="device", time_loop=False)
    host = imgs.float().cpu().numpy()
    device_u8 = quantize_uint8(imgs).cpu().numpy()
    host_u8 = np.clip(host * 255.0 + 0.5, 0, 255).astype(np.uint8)
    round_equal = bool(np.array_equal(device_u8, host_u8))
    served_equal = bool(np.array_equal(device_u8[0], lone_px))
    batches = sum(1.0 / o["batch_size"] for o in outs)
    per_unet, per_vae = _kinds(census["serve_unet"]), _kinds(census["serve_vae"])
    n_batches = before["batches"] + stats["batches"] + 1
    want = {kd: (GraphedCall.WARMUP + 1) * per_unet[kd] + n_batches * per_vae[kd] for kd in MAIN}
    rec = dict(requests=SERVE_REQUESTS, max_batch=SERVE_BATCH, pipeline_depth=2,
               elapsed_s=elapsed, images_per_hour=SERVE_REQUESTS / elapsed * 3600,
               warm_batch_s=warm_s, stats=stats, batch_sizes=[o["batch_size"] for o in outs],
               execution_times_s=sorted({o["execution_time"] for o in outs}),
               finisher_wait_s=finisher_wait,
               captures=sum(pipe.engine.graphed_unet.captures.values()),
               rows=rows, device_round_equals_host=round_equal,
               served_equals_direct=served_equal, wrapper_launches=counts,
               devices=health["devices"])
    print(f"phase 13 HTTP serving, SD-1.5 bf16 {SIZE}x{SIZE}, {STEPS}-step DPM++, CFG {GUIDANCE}, "
          f"max_batch {SERVE_BATCH}, pipeline_depth 2: {SERVE_REQUESTS} concurrent requests in "
          f"{elapsed:.3f} s = {rec['images_per_hour']:.1f} images/hour e2e (after one warm batch "
          f"of {warm_s:.3f} s); batch sizes {rec['batch_sizes']}; batch wall clocks "
          f"{rec['execution_times_s']} s; counters {stats}; worker's wait on the finisher "
          f"{finisher_wait:.4f} s; graph captures {rec['captures']}; device round == host round "
          f"{round_equal}; served == direct {served_equal}; one request alone and among 7 "
          f"others {rows}; wrappers {counts} (want {want}); {card}", flush=True)
    if not (round_equal and served_equal):
        raise AssertionError("a served image differs (device vs host round, or served vs "
                             "direct)")
    if not rows["row0_equal"] or not rows["row3_max_abs_diff"] <= 5e-2:
        raise AssertionError(f"a request among 7 others: {rows}")
    if stats["requests"] != SERVE_REQUESTS or stats["errors"] or \
            abs(batches - stats["batches"]) > 1e-9:
        raise AssertionError(f"the counters {stats} do not count {SERVE_REQUESTS} requests in "
                             f"{batches} batches")
    if counts != want:
        raise AssertionError(f"served batches: wrapper launches {counts}, expected {want}")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def served_rows(srv):
    """One request (seed 77) served alone, then at row 0 and at row 3 of a
    batch of SERVE_BATCH distinct requests, through ``srv.submit`` from this
    thread: rows follow the order of submission.  (row 0 bit-equal to
    alone, row 3's max abs pixel difference / 255 from alone)."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.serving.batcher import GenerateRequest

    def req(i, seed):
        return GenerateRequest(PROMPTS[i % len(PROMPTS)], STEPS, GUIDANCE, seed=seed)

    def batch(row):
        reqs = [req(i + 1, 500 + i) for i in range(SERVE_BATCH - 1)]
        reqs.insert(row, req(0, 77))
        futs = [srv.submit(r) for r in reqs]
        outs = [f.result(timeout=300) for f in futs]
        if any(o["batch_size"] != SERVE_BATCH for o in outs):
            raise AssertionError(f"an ordered batch split: {[o['batch_size'] for o in outs]}")
        return outs[row]["image"]

    alone = srv.submit(req(0, 77)).result(timeout=300)["image"]
    row0, row3 = batch(0), batch(3)
    return dict(row0_equal=bool(np.array_equal(row0, alone)),
                row3_equal=bool(np.array_equal(row3, alone)),
                row3_max_abs_diff=float(np.abs(row3.astype(np.float32)
                                               - alone.astype(np.float32)).max()) / 255)


def serve_bench_hero(census, card):
    """``sonicdiffusionbayeslab_torch.serve_bench``'s hero mode with its
    defaults (SD-1.5 512^2 bf16, batch 32 with unet_microbatch 4, 128
    requests, 20 steps, pipeline_depth 2), wrappers counted over it."""
    from sonicdiffusionbayeslab_torch import serve_bench
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    gc.collect()
    torch.cuda.empty_cache()
    wrapper_counts(reset=True)
    rec = serve_bench.main(["hero"])
    counts = bf16_only(wrapper_counts(), "serve_bench hero")
    per_unet, per_vae = _kinds(census["serve_unet"]), _kinds(census["bench_vae"])
    want = {k: (GraphedCall.WARMUP + 1) * per_unet[k] + rec["batches"] * per_vae[k] for k in MAIN}
    rec["wrapper_launches"] = counts
    print(f"phase 13 serve_bench hero: {rec['images_per_hour']:.1f} images/hour e2e at batch "
          f"{rec['max_batch']} ({rec['requests']} requests, {rec['batches']} batches, worker's "
          f"wait on the finisher {rec['finisher_wait_s']:.4f} s) beside the loop-only 30428 images/hour "
          f"at batch 2 (PERF.md section 5); wrappers {counts} (want {want}); {card}", flush=True)
    if counts != want or rec["captures"] != 1:
        raise AssertionError(f"serve_bench hero: wrapper launches {counts}, expected {want}; "
                             f"captures {rec['captures']}")
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase13_launches(out, kind):
    """A kernel's launches in each phase-13 run."""
    if kind == "attention_fp32":
        return {f"tiny {n}": r["fp32_attention_launches"]
                for n, r in out["tiny_card_vs_cpu"].items()}
    return {"http serving": out["http"]["wrapper_launches"][kind],
            "serve_bench hero": out["serve_bench"]["wrapper_launches"][kind],
            **{f"{n} first run": out["loops"][n]["first_run_wrapper_launches"][kind]
               for n in ("exact", "controlnet", "ip_adapter")},
            **{f"{n} trace": out["loops"][n]["traced_launches"][kind]
               for n in ("exact", "controlnet", "ip_adapter")}}


def run_serving_conditioning(report, card, checked):
    """Phase 13: serving (HTTP and serve_bench hero) and the conditioning
    families (ControlNet, IP-Adapter, prompt weighting) at SD-1.5 width."""
    census = cond_census()
    per = {part: dict(_kinds(c)) for part, c in census.items()}
    print(f"phase 13 census (launches a call): {json.dumps(per)}", flush=True)
    ip_crosses = sorted(shape for kind, shape in census["ip"] if shape[2] == IP_TOKENS)
    print(f"phase 13 IP-Adapter cross shapes: {ip_crosses}", flush=True)
    if per["ip"]["attention"] != per["exact"]["attention"] + 16 or \
            per["ip"]["group_norm"] != per["exact"]["group_norm"] or \
            per["control"]["attention"] <= per["exact"]["attention"]:
        raise AssertionError(f"phase 13 census {per}: expected 16 more attentions a forward "
                             "with IP-Adapter and the ControlNet's own")
    out = {"census": per}
    t0 = time.perf_counter()
    out["checked_shapes"] = check_cond_kernels(census, report, checked)
    out["ip_timings"], out["ip_totals"] = time_ip_crosses(census, card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["tiny_card_vs_cpu"] = cond_tiny_card_vs_cpu()
    torch.backends.cudnn.allow_tf32 = True
    out["loops"] = cond_loops(census, card)
    out["http"] = serve_http(census, card)
    out["serve_bench"] = serve_bench_hero(census, card)
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 13 took {out['phase_s']:.1f} s", flush=True)
    report["e2e"]["serving_conditioning"] = out


# --------------------------------------------------------- training (phase 14)
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LOG, TRAIN_IMAGES, TRAIN_TRACE_STEPS = 8, 8, 4, 16, 2
TRAIN_BENCH_MODES = ("lora512", "full512", "sd3_lora")  # each at its default batch (8, 8, 2)
# The SD3 LoRA bench's context: CLIP-L's and bigG's 77 tokens side by side
# on the sequence axis (the root train_bench.py's T_ctx), so its joint
# attention runs over 4096 + 154 tokens at 1024^2.
SD3_TRAIN_CTX = 154
# Gradients through the Functions (the kernel forward, the stock backward)
# against autograd through the plain version in fp32 on the same inputs:
# |grad - ref| <= atol * max|ref| + rtol * |ref|.  fp32: the same fp32 math
# in another summation order.  bf16: each gradient is rounded to bf16 after
# the same fp32 math (half a step is 2^-9 relative); atol covers entries
# near 0 where the inputs' bf16 rounding dominates.
GRAD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (4e-3, 8e-3)}


def train_census():
    """Phase 14's {(kind, shape): launches} by call: one SD-1.5 UNet forward
    at TRAIN_BATCH rows (512^2: a train step's forward), one VAE encode of
    TRAIN_BATCH 512^2 images (the loop's prep), one MMDiT forward at batch
    2 with SD3_TRAIN_CTX context tokens (1024^2, the SD3 LoRA bench) and the
    tiny UNet's forward at batch 2 (the card-vs-CPU steps)."""
    return dict(unet=module_census(TRAIN_BATCH),
                encode=module_census(enc_batch=TRAIN_BATCH, enc_size=SIZE),
                sd3=sd3_module_census(batch=2, ctx_len=SD3_TRAIN_CTX),
                tiny=module_census(2, tiny=True))


def check_train_forward(census, report, checked):
    """Each kernel against its plain version at every phase-14 shape that
    phase 3 did not check (bf16 at the full-width calls, fp32 at the tiny
    UNet's); max errors into ``report["errs"]`` and ``report["phase14_errs"]``;
    adds them to ``checked``."""
    work = ({(k, torch.bfloat16) for p in ("unet", "encode", "sd3") for k in census[p]}
            | {(k, torch.float32) for k in census["tiny"]})
    return check_forward(work, report, checked, 14)


def check_forward(work, report, checked, phase):
    """Each ((kind, shape), dtype) of ``work`` that ``checked`` lacks: the
    kernel against its plain version, max errors into ``report["errs"]``
    and ``report[f"phase{phase}_errs"]``; adds them to ``checked``."""
    gen = torch.Generator(device="cuda").manual_seed(phase)
    work = sorted(set(work) - checked,
                  key=lambda w: (str(w[1]), w[0][0], [str(v) for v in w[0][1]]))
    for (kind, shape), dtype in work:
        inputs = (attn_inputs if kind == "attention" else gn_inputs)(shape, dtype, gen)
        kern, plain = run_kernel(kind, shape, inputs)
        got = kern()
        torch.cuda.synchronize()
        err = compare(kind, dtype, got, plain(), f"{kind} {shape} {dtype} (phase {phase})")
        report["errs"][report_key(kind, dtype)].append(err)
        report[f"phase{phase}_errs"][report_key(kind, dtype)].append(err)
        print(f"phase {phase} {kind} {str(dtype)[6:]} {shape}: max abs err {err:.3e}")
        del inputs, got
    torch.cuda.empty_cache()
    checked.update(work)
    return len(work)


def grad_close(got, want, dtype, what):
    """Max |got - want| within GRAD_TOL (raises otherwise)."""
    atol, rtol = GRAD_TOL[dtype]
    want = want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite gradient")
    err = (got.float() - want).abs()
    bound = atol * want.abs().max() + rtol * want.abs()
    if (err > bound).any():
        raise AssertionError(f"{what}: max abs err {err.max().item():.3e} exceeds "
                             f"{atol} x max|ref| {want.abs().max().item():.3e} + {rtol} x |ref|")
    return err.max().item()


def check_train_gradients(census, report):
    """dq/dk/dv through ``FlashAttentionFn`` (the kernel forward, the stock
    ``attention_vjp``) at every attention shape of the phase's UNet and
    MMDiT calls, and dx/dγ/dβ through ``GroupNormSiLUFn`` at every GroupNorm
    shape of the UNet's, SiLU on and off, in bf16 and fp32, against autograd
    through the plain version in fp32 on the same inputs (a few batch rows
    at a time); each forward launches its kernel once, no backward any.
    Max errors into ``report["phase14_grad_errs"]``."""
    from sonicdiffusionbayeslab_torch.ops import flash_attention as fa
    from sonicdiffusionbayeslab_torch.ops.attention import dot_product_attention, plain_attention
    from sonicdiffusionbayeslab_torch.ops.groupnorm import (GroupNormSiLUFn, group_norm_silu,
                                                             plain_group_norm)

    gen = torch.Generator(device="cuda").manual_seed(15)
    attn = sorted({s for p in ("unet", "sd3") for k, s in census[p] if k == "attention"})
    gns = sorted({s[:5] for k, s in census["unet"] if k == "group_norm"})
    out = collections.defaultdict(float)
    for dtype in (torch.bfloat16, torch.float32):
        for shape in attn:
            q, k, v = attn_inputs(shape, dtype, gen)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
            wrapper = fa._KERNELS[fa.kernel_for(dtype)]
            n0 = wrapper.launches
            o = dot_product_attention(*ins)
            if not isinstance(o.grad_fn, fa.FlashAttentionFn._backward_cls):
                raise AssertionError(f"attention {shape} with grad did not go through the Function")
            grads = torch.autograd.grad(o, ins, do)
            torch.cuda.synchronize()
            if wrapper.launches != n0 + 1:
                raise AssertionError(f"attention {shape}: {wrapper.launches - n0} launches for one "
                                     "forward and backward, not 1")
            B, N, M, H, _ = shape
            rows = max(1, min(B, int(PLAIN_BYTES // (30 * H * N * M))))
            errs = [0.0, 0.0, 0.0]
            for b in range(0, B, rows):
                ref_in = [x[b:b + rows].float().requires_grad_(True) for x in (q, k, v)]
                ref = torch.autograd.grad(plain_attention(*ref_in), ref_in,
                                          do[b:b + rows].float())
                for i, (g, r) in enumerate(zip(grads, ref)):
                    errs[i] = max(errs[i], grad_close(g[b:b + rows], r, dtype,
                                                      f"attention {shape} {dtype} d{'qkv'[i]}"))
                del ref_in, ref
            key = report_key("attention", dtype)
            out[key] = max(out[key], *errs)
            report["phase14_grad_errs"][key].append(max(errs))
            print(f"phase 14 attention {str(dtype)[6:]} {shape} gradients: max abs err dq "
                  f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}")
            del q, k, v, do, ins, o, grads
        for B, N, C, G, eps in gns:
            for silu in (True, False):
                x, w, b = gn_inputs((B, N, C), dtype, gen)
                dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
                ins = [t.clone().requires_grad_(True) for t in (x, w, b)]
                n0 = group_norm_silu.launches
                y = group_norm_silu(*ins, G, eps, silu)
                if not isinstance(y.grad_fn, GroupNormSiLUFn._backward_cls):
                    raise AssertionError(f"GroupNorm {(B, N, C)} with grad did not go through "
                                         "the Function")
                grads = torch.autograd.grad(y, ins, dy)
                torch.cuda.synchronize()
                if group_norm_silu.launches != n0 + 1:
                    raise AssertionError(f"GroupNorm {(B, N, C)}: "
                                         f"{group_norm_silu.launches - n0} launches, not 1")
                ref_in = [t.float().requires_grad_(True) for t in (x, w, b)]
                ref = torch.autograd.grad(plain_group_norm(*ref_in, G, eps, silu), ref_in,
                                          dy.float())
                errs = [grad_close(g, r, dtype, f"GroupNorm {(B, N, C, silu)} {dtype} d{n}")
                        for g, r, n in zip(grads, ref, ("x", "gamma", "beta"))]
                key = report_key("group_norm", dtype)
                out[key] = max(out[key], *errs)
                report["phase14_grad_errs"][key].append(max(errs))
                print(f"phase 14 group_norm {str(dtype)[6:]} {(B, N, C, G, eps, silu)} gradients: "
                      f"max abs err dx {errs[0]:.3e} dgamma {errs[1]:.3e} dbeta {errs[2]:.3e}")
    torch.cuda.empty_cache()
    print(f"phase 14 gradients at {len(attn)} attention and {len(gns)} x 2 GroupNorm shapes in bf16 "
          f"and fp32, max abs errs {json.dumps(out)} (GRAD_TOL {GRAD_TOL[torch.bfloat16]} bf16, "
          f"{GRAD_TOL[torch.float32]} fp32)", flush=True)
    return dict(out)


TINY_TRAIN_LR = 1e-4
# Card against CPU, each step's gradients at the card's state: every
# tensor's max |g_card - g_cpu| within this share of its max |g_cpu| (or of
# 1e-3 x the largest tensor's, for a tensor whose gradient is 0 up to
# rounding).  fp32 on both (TF32 off, the split-TF32 attention kernel)
# differs by summation order; a gradient that a backward drops or gets
# wrong is off by its own size.
TINY_GRAD_REL = 1e-3


def tiny_engine_pair():
    """The tiny fp32 SD-1.5 engine on the CPU and its twin on the card with
    the same weights: {"cpu": engine, "cuda": engine}."""
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel

    engines = {d: StableDiffusionModel("x", tiny=True, dtype="float32", device=d).engine
               for d in ("cpu", "cuda")}
    src = engines["cpu"]
    engines["cuda"].load_state_dicts({k: m.state_dict() for k, m in zip(src.MODULES,
                                                                          src.modules())})
    return engines


def tiny_grads_close(grads, want, what):
    """Each gradient on the card (``grads``) against the CPU's (``want``),
    both {name: tensor}: max |g_card - g_cpu| within TINY_GRAD_REL of the
    tensor's max |g_cpu|, or of 1e-3 x the largest tensor's where that is
    more; returns the largest share of it used."""
    tops = {k: w.abs().max().item() for k, w in want.items()}
    floor = 1e-3 * max(tops.values())
    rel = 0.0
    for k, w in want.items():
        top = max(tops[k], floor)
        diff = (grads[k].cpu() - w).abs().max().item()
        if not diff <= TINY_GRAD_REL * top:
            raise AssertionError(f"{what}: gradient of {k} card vs CPU {diff:.3e}, over "
                                 f"{TINY_GRAD_REL} x {top:.3e}")
        rel = max(rel, diff / top)
    return rel


def train_tiny_card_vs_cpu(tiny_census):
    """Three steps of the tiny fp32 UNet's LoRA (rank 4) and full fine-tune
    on the card (TF32 off) and on the CPU, from the same weights, adapters,
    latents, context, t and noise (``tiny_census``: the tiny UNet's
    launches a forward at batch 2).  Gates: each step's gradients on the
    card against the CPU's at the card's state, every tensor within
    TINY_GRAD_REL of its max |g| (step 0 of LoRA: every b has a gradient;
    from step 1 on every a); each step's loss and grad norm, and the
    trained tensors after, within 1e-3, with at most 0.1% of the entries
    more than 0.1 x lr apart; the card's launches are the forwards' alone.
    Adam's first updates are m/(sqrt(v) + eps) ~ sign(g): an entry whose
    gradient lies within the two devices' fp32 noise of 0 can step the
    other way, up to 2 x lr a step, so lr is TINY_TRAIN_LR, 3 steps of
    which stay inside 1e-3."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.training.trainer import (DiffusionTrainer, TrainConfig,
                                                               TrainState, leaves)

    def on_cpu(tree):
        return {k: (on_cpu(v) if isinstance(v, dict) else
                    v.detach().cpu().requires_grad_(True)) for k, v in tree.items()}

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    per = _kinds(tiny_census)
    rng = np.random.default_rng(14)
    lat = torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 77, 32)).astype(np.float32))
    draws = [(torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(np.float32)),
              torch.tensor([100 + 7 * s, 900 - 7 * s])) for s in range(3)]
    engines = tiny_engine_pair()
    out = {}
    try:
        for name, cfg in (("lora", TrainConfig(lora_rank=4, learning_rate=TINY_TRAIN_LR)),
                          ("full", TrainConfig(learning_rate=TINY_TRAIN_LR))):
            trainers = {d: DiffusionTrainer(e, cfg) for d, e in engines.items()}
            init = trainers["cpu"].init_state(generator=torch.Generator().manual_seed(0)).trainable
            states = {d: tr.init_state(adapters=init if name == "lora" else None)
                      for d, tr in trainers.items()}
            wrapper_counts(reset=True)
            err = grad_rel = 0.0
            for s, (noise, ts) in enumerate(draws):
                _, grads = trainers["cuda"].value_and_grad(states["cuda"], lat, ctx, noise=noise,
                                                           timesteps=ts)
                _, want = trainers["cpu"].value_and_grad(
                    TrainState(s, on_cpu(states["cuda"].trainable), None, None), lat, ctx,
                    noise=noise, timesteps=ts)
                if name == "lora":
                    silent = [k for k, g in grads.items()
                              if (k.endswith("/b") or s > 0) and not g.abs().max() > 0]
                    if silent:
                        raise AssertionError(f"tiny LoRA step {s} on the card: no gradient on "
                                             f"{silent}")
                grad_rel = max(grad_rel, tiny_grads_close(grads, want, f"tiny {name} step {s}"))
                m = {}
                for d, tr in trainers.items():
                    states[d], mm = tr.train_step(states[d], lat, ctx, noise=noise, timesteps=ts)
                    m[d] = (float(mm["loss"]), float(mm["grad_norm"]))
                err = max(err, *(abs(a - b) for a, b in zip(m["cuda"], m["cpu"])))
            got, want = leaves(states["cuda"].trainable), leaves(states["cpu"].trainable)
            diffs = torch.cat([(got[k].detach().cpu() - v.detach()).abs().flatten()
                               for k, v in want.items()])
            err = max(err, diffs.max().item())
            share = (diffs > 0.1 * TINY_TRAIN_LR).float().mean().item()
            counts = wrapper_counts()
            forwards = 3 * 2  # value_and_grad's and train_step's
            want_counts = {"attention_fp32": forwards * per["attention"],
                           "group_norm": forwards * per["group_norm"], "attention": 0}
            print(f"tiny fp32 {name} steps, card vs CPU: gradients at the card's state within "
                  f"{grad_rel:.2e} of each tensor's max|g| (at most {TINY_GRAD_REL}); max abs err "
                  f"{err:.3e} over losses, grad norms and the trained tensors (tolerance 1e-3), "
                  f"{share:.2e} of the tensors' entries beyond 0.1 x lr (at most 1e-3); launches "
                  f"{counts}, expected {want_counts}", flush=True)
            if not (err <= 1e-3 and share <= 1e-3) or counts != want_counts:
                raise AssertionError(f"the tiny {name} steps on the card disagree with the CPU "
                                     "or launched other than their forwards' kernels")
            out[name] = dict(max_abs_err=err, max_grad_rel_err=grad_rel,
                             share_beyond_tenth_lr=share,
                             fp32_attention_launches=counts["attention_fp32"],
                             group_norm_launches=counts["group_norm"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return out


def write_train_images(root):
    """TRAIN_IMAGES PNGs at 640x480 (PNG content under the .jpg names of
    the first TRAIN_IMAGES entries of data/dataset/img2annotations_train.json)
    and an annotation file holding those entries."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.data.imageio import encode_png_bytes

    repo = Path(__file__).resolve().parent
    entries = list(json.loads((repo / "data" / "dataset" /
                               "img2annotations_train.json").read_text()).items())[:TRAIN_IMAGES]
    img_dir = Path(root) / "train_images"
    img_dir.mkdir()
    gen = np.random.default_rng(14)
    for name, _ in entries:
        ramp = np.linspace(0, 255, 640)[None, :, None] * np.linspace(0.2, 1, 480)[:, None, None]
        px = np.clip(ramp * gen.uniform(0.3, 1, 3) + gen.normal(0, 30, (480, 640, 3)), 0, 255)
        (img_dir / name).write_bytes(encode_png_bytes(px.astype(np.uint8)))
    ann = Path(root) / "img2annotations_train_first16.json"
    ann.write_text(json.dumps(dict(entries)))
    return img_dir, ann


def run_train_lora_config(census, card, root):
    """configs/train_lora.yaml as shipped through the port's
    ``training.loop.run_training`` at full SD-1.5 width (random bf16
    weights, batch 8 at 512^2), overriding only the dataset (TRAIN_IMAGES
    real PNGs), num_steps, log_every and save_dir: every logged loss
    finite, steps/s and peak memory printed, the wrappers' launches equal
    to the census (a step's UNet forward and the prep's encode; no
    backward launches any), ``final/lora_peft.npz`` holding every target's
    three tensors, fused by ``merge_lora`` into the run's engine a 512^2
    sample that differs from the base engine's; then a TRAIN_TRACE_STEPS
    run traced, its kernel executions equal to the census."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.config import load_config
    from sonicdiffusionbayeslab_torch.models.unet import UNet2DCondition, UNetConfig
    from sonicdiffusionbayeslab_torch.models.weights import merge_lora
    from sonicdiffusionbayeslab_torch.training.lora import lora_targets
    from sonicdiffusionbayeslab_torch.training.loop import run_training

    repo = Path(__file__).resolve().parent
    img_dir, ann = write_train_images(root)
    overrides = {"dataset.img_dataset": str(img_dir), "dataset.prompts": str(ann),
                 "training.num_steps": TRAIN_STEPS, "training.log_every": TRAIN_LOG,
                 "training.save_dir": str(Path(root) / "lora_out")}
    print(f"configs/train_lora.yaml with overrides {json.dumps(overrides)}", flush=True)
    unet, enc = _kinds(census["unet"]), _kinds(census["encode"])
    per_step = {"attention": unet["attention"], "group_norm": unet["group_norm"] +
                enc["group_norm"]}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wrapper_counts(reset=True)
    t0 = time.perf_counter()
    out = run_training(load_config(repo / "configs" / "train_lora.yaml", overrides))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = bf16_only(wrapper_counts(), "the train_lora.yaml run")
    want = {k: TRAIN_STEPS * n for k, n in per_step.items()}
    losses = out["losses"]
    rec = dict(losses=losses, steps_per_sec=out["steps_per_sec"],
               images_per_sec=out["steps_per_sec"] * TRAIN_BATCH, wall_s=wall,
               peak_gb=peak, wrapper_launches=counts, census_launches=want)
    print(f"train_lora.yaml, SD-1.5 bf16 {SIZE}x{SIZE}, batch {TRAIN_BATCH}, {TRAIN_STEPS} steps "
          f"(LoRA rank 8, AdamW, warmup 100, min-SNR 5, EMA 0.999): losses {losses}, steady "
          f"{out['steps_per_sec']:.3f} steps/s ({rec['images_per_sec']:.2f} images/s), run wall "
          f"{wall:.1f} s, peak memory {peak:.2f} GB; wrapper launches {counts}, census {want} "
          f"({per_step} a step); {card}", flush=True)
    if len(losses) != TRAIN_STEPS // TRAIN_LOG or not all(np.isfinite(losses)):
        raise AssertionError(f"train_lora.yaml run: logged losses {losses}")
    if counts != want:
        raise AssertionError(f"train_lora.yaml run: wrapper launches {counts}, census {want}")
    with torch.device("meta"):
        targets = lora_targets(UNet2DCondition(UNetConfig.sd15()))
    npz = np.load(Path(root) / "lora_out" / "final" / "lora_peft.npz")
    keys = {f"unet.{m}.{s}" for m in targets for s in ("lora_A.weight", "lora_B.weight", "alpha")}
    if set(npz.files) != keys:
        raise AssertionError(f"lora_peft.npz holds {len(npz.files)} arrays, the census of "
                             f"{len(targets)} targets {len(keys)}")
    pipe, engine = out["pipeline"], out["engine"]
    kw = dict(num_inference_steps=STEPS, guidance_scale=GUIDANCE, seed=29)
    base = pipe(PROMPTS[:1], **kw)[0]
    sd, names = merge_lora(engine.unet.state_dict(),
                           {k: torch.from_numpy(npz[k]) for k in npz.files})
    changed = sum(int((sd[k] != v).sum()) for k, v in engine.unet.state_dict().items())
    engine.unet.load_state_dict(sd)
    engine.weights_changed()
    fused = pipe(PROMPTS[:1], **kw)[0]
    diff = float(np.abs(fused - base).max())
    rec.update(fused_modules=len(names), fused_entries_changed=changed, image_max_abs_diff=diff)
    print(f"lora_peft.npz: {len(npz.files)} arrays ({len(targets)} targets x 3); fused by "
          f"merge_lora into {len(names)} modules ({changed} bf16 entries changed); one "
          f"{SIZE}x{SIZE} sample, {STEPS}-step DPM++, after weights_changed(): max abs diff from "
          f"the base engine's {diff:.4f}", flush=True)
    if fused.shape != (1, SIZE, SIZE, 3) or not np.isfinite(fused).all() or not diff > 0:
        raise AssertionError(f"the fused LoRA's sample: shape {fused.shape}, max abs diff from "
                             f"the base engine's {diff}")
    del out, pipe, engine, sd, base, fused
    gc.collect()
    torch.cuda.empty_cache()
    short = load_config(repo / "configs" / "train_lora.yaml", {
        **overrides, "training.num_steps": TRAIN_TRACE_STEPS,
        "training.save_dir": str(Path(root) / "lora_trace")})
    want_trace = {k: TRAIN_TRACE_STEPS * n for k, n in per_step.items()}
    _, traced, attempts = traced_exact(lambda: run_training(short), want_trace,
                                       "the traced train_lora.yaml run", reset=retrace_reset())
    if traced["attention_fp32"]:
        raise AssertionError("the traced train_lora.yaml run launched the fp32 kernel")
    rec.update(traced_launches=traced, trace_steps=TRAIN_TRACE_STEPS, trace_attempts=attempts)
    print(f"traced train_lora.yaml run of {TRAIN_TRACE_STEPS} steps: kernel executions "
          f"{json.dumps({k: traced[k] for k in MAIN})}, census {want_trace}", flush=True)
    return rec


def run_train_bench(census, card):
    """The port's train_bench lora512, full512 (remat, AdamW) and sd3_lora
    modes at TRAIN_STEPS timed steps: each JSON line, and the wrappers'
    launches over the first and the timed steps equal to the census (remat
    runs each forward kernel twice a step; no backward launches any)."""
    from sonicdiffusionbayeslab_torch import train_bench

    unet, sd3 = _kinds(census["unet"]), _kinds(census["sd3"])
    per = {"lora512": {"attention": unet["attention"], "group_norm": unet["group_norm"]},
           "full512": {"attention": 2 * unet["attention"], "group_norm": 2 * unet["group_norm"]},
           "sd3_lora": {"attention": 2 * sd3["attention"], "group_norm": 0}}
    out = {}
    for mode in TRAIN_BENCH_MODES:
        gc.collect()
        torch.cuda.empty_cache()
        wrapper_counts(reset=True)
        rec = train_bench.run_mode(mode, steps=TRAIN_STEPS)
        print(json.dumps(rec), flush=True)
        counts = bf16_only(wrapper_counts(), f"train_bench {mode}")
        want = {k: (TRAIN_STEPS + 1) * n for k, n in per[mode].items()}
        print(f"train_bench {mode}: wrapper launches {counts}, census {want} ({per[mode]} a "
              f"step); {card}", flush=True)
        if not rec["fits"] or counts != want:
            raise AssertionError(f"train_bench {mode}: fits {rec['fits']}, launches {counts}, "
                                 f"census {want}")
        out[mode] = dict(rec, wrapper_launches=counts, census_launches=want)
    return out


def profile_train_step(mode, card, steps=2):
    """:func:`profile_steps` of a train_bench mode's step, its optimizer the
    ``train_step.optimizer`` span."""
    from sonicdiffusionbayeslab_torch import train_bench

    return profile_steps(train_bench.make_step(mode), f"train_bench {mode}", card,
                         {"optimizer (train_step.optimizer)": "train_step.optimizer"}, steps)


def profile_steps(once, label, card, spans, steps=2):
    """Device time of ``steps`` calls of ``once`` (a train step, after two
    warm ones), from torch.profiler: by kernel group, the spans of the
    attention and GroupNorm backwards (their autograd nodes) and of
    ``spans`` ({label: record_function name}), beside the steps' wall
    clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    once()
    once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            once()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    groups = collections.Counter()
    device_ms = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3 / steps
        device_ms += ms
        groups[kernel_group(e.name)] += ms
    spans = {"attention backward (FlashAttentionFnBackward)": "FlashAttentionFnBackward",
             "group_norm backward (GroupNormSiLUFnBackward)": "GroupNormSiLUFnBackward",
             **spans}
    span_ms = {}
    for span, key in spans.items():
        vals = [(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0))
                for e in prof.key_averages() if e.key and e.key.endswith(key)]
        span_ms[span] = max(vals, default=0) / 1e3 / steps
    rec = dict(step_wall_ms=wall, step_device_ms=device_ms,
               device_idle_share=max(0.0, 1 - device_ms / wall) if device_ms else None,
               groups_ms_per_step=dict(groups.most_common()), spans_ms_per_step=span_ms)
    print(f"profile {label} {json.dumps(rec)}; {card}", flush=True)
    del once
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase14_launches(out, kind):
    """A kernel's launches in each phase-14 run."""
    if kind == "attention_fp32":
        return {f"tiny {n}": r["fp32_attention_launches"]
                for n, r in out["tiny_card_vs_cpu"].items()}
    return {"train_lora.yaml run": out["train_lora"]["wrapper_launches"][kind],
            "train_lora.yaml trace": out["train_lora"]["traced_launches"][kind],
            **{f"train_bench {m}": r["wrapper_launches"][kind]
               for m, r in out["train_bench"].items()}}


def run_training_phase(report, card, checked, profile):
    """Phase 14: training at full width (train_lora.yaml through the loop,
    train_bench's lora512, full512 and sd3_lora), gradients through both
    Functions on the card, and tiny fp32 steps card vs CPU."""
    census = train_census()
    per = {part: dict(_kinds(c)) for part, c in census.items()}
    print(f"phase 14 census (launches a forward or an encode): {json.dumps(per)}", flush=True)
    if (per["unet"]["attention"], per["unet"]["group_norm"], per["encode"]["group_norm"],
            per["sd3"]["attention"]) != (32, 61, 22, 24):
        raise AssertionError(f"phase 14 census {per}: expected 32 attentions and 61 GroupNorms a "
                             "UNet forward, 22 GroupNorms an encode, 24 attentions a MMDiT forward")
    out = {"census": per}
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["checked_shapes"] = check_train_forward(census, report, checked)
    out["gradients"] = check_train_gradients(census, report)
    out["tiny_card_vs_cpu"] = train_tiny_card_vs_cpu(census["tiny"])
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory(prefix="sdbl_train_") as tmp:
        out["train_lora"] = run_train_lora_config(census, card, tmp)
    out["train_bench"] = run_train_bench(census, card)
    if profile:
        out["profiles"] = {m: profile_train_step(m, card) for m in TRAIN_BENCH_MODES}
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 14 took {out['phase_s']:.1f} s", flush=True)
    report["e2e"]["training"] = out


# ------------------------------ distillation, textual inversion (phase 15)
# configs/train_lora.yaml's model and dataset with a distill training
# section: LCM-LoRA of rank DISTILL_RANK on a grid of DISTILL_GRID nodes,
# otherwise LCMDistillConfig's defaults, batch TRAIN_BATCH.
DISTILL_STEPS, DISTILL_LOG, DISTILL_TRACE_STEPS = 12, 4, 2
DISTILL_RANK, DISTILL_GRID = 64, 50
# The w-conditioned full student (the full LCM recipe) at WCOND_BATCH.
WCOND_BATCH, WCOND_STEPS, WCOND_DIM, WCOND_W = 4, 6, 256, (3.0, 15.0)
# Textual inversion: two placeholder rows seeded from two other tokens'.
TI_STEPS, TI_LR, TI_PLACEHOLDERS, TI_INIT = 12, 5e-3, (49400, 49401), (1929, 2368)
LCM_STEPS = 4  # the LCM plan's steps of the samples
WCOND_GUIDANCE = (8.0, 2.0)  # the w-conditioned engine's two embedded guidance scales


def distill_census():
    """Phase 15's {(kind, shape): launches} by call: the teacher's forward at
    twice TRAIN_BATCH (CFG's two halves), the target's and the student's at
    TRAIN_BATCH, the w-conditioned run's at twice WCOND_BATCH and at
    WCOND_BATCH, an encode of TRAIN_BATCH 512^2 images, the LCM sample's
    UNet call at BATCH rows (no CFG) and its decode."""
    return dict(teacher=module_census(2 * TRAIN_BATCH), unet=module_census(TRAIN_BATCH),
                wcond_teacher=module_census(2 * WCOND_BATCH), wcond=module_census(WCOND_BATCH),
                encode=module_census(enc_batch=TRAIN_BATCH, enc_size=SIZE),
                sample=module_census(BATCH), decode=module_census(vae_batch=BATCH))


def distill_step_census(per, teacher="teacher", unet="unet"):
    """A distill step's launches: the teacher's forward, the target's and
    the student's (no backward launches any)."""
    return {k: per[teacher][k] + 2 * per[unet][k] for k in MAIN}


def check_kv_gradients(census, report):
    """dk and dv through ``FlashAttentionFn`` with only K and V requiring grad
    (the query from activations no gradient reaches: textual inversion's
    first cross-attention), at every cross-attention shape of the UNet at
    TRAIN_BATCH, bf16, against autograd through the plain version in fp32
    under GRAD_TOL; one launch a forward, none a backward, no dq formed
    for the caller.  Max errors into ``report["phase15_grad_errs"]``."""
    from sonicdiffusionbayeslab_torch.ops import flash_attention as fa
    from sonicdiffusionbayeslab_torch.ops.attention import dot_product_attention, plain_attention

    gen = torch.Generator(device="cuda").manual_seed(16)
    shapes = sorted({s for k, s in census["unet"] if k == "attention" and s[2] == 77})
    dtype = torch.bfloat16
    wrapper = fa._KERNELS[fa.kernel_for(dtype)]
    out = 0.0
    for shape in shapes:
        q, k, v = attn_inputs(shape, dtype, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        kr, vr = (x.clone().requires_grad_(True) for x in (k, v))
        n0 = wrapper.launches
        o = dot_product_attention(q, kr, vr)
        if not isinstance(o.grad_fn, fa.FlashAttentionFn._backward_cls):
            raise AssertionError(f"K/V-only attention {shape} did not go through the Function")
        grads = torch.autograd.grad(o, (kr, vr), do)
        torch.cuda.synchronize()
        if wrapper.launches != n0 + 1:
            raise AssertionError(f"K/V-only attention {shape}: {wrapper.launches - n0} launches")
        B, N, M, H, _ = shape
        rows = max(1, min(B, int(PLAIN_BYTES // (30 * H * N * M))))
        errs = [0.0, 0.0]
        for b in range(0, B, rows):
            ref_in = [x[b:b + rows].float().requires_grad_(True) for x in (k, v)]
            ref = torch.autograd.grad(plain_attention(q[b:b + rows].float(), *ref_in), ref_in,
                                      do[b:b + rows].float())
            for i, (g, r) in enumerate(zip(grads, ref)):
                errs[i] = max(errs[i], grad_close(g[b:b + rows], r, dtype,
                                                  f"K/V-only attention {shape} d{'kv'[i]}"))
        out = max(out, *errs)
        report["phase15_grad_errs"]["attention"].append(max(errs))
        print(f"phase 15 K/V-only attention bf16 {shape} gradients: max abs err dk "
              f"{errs[0]:.3e} dv {errs[1]:.3e} (GRAD_TOL {GRAD_TOL[dtype]})", flush=True)
        del q, k, v, do, kr, vr, o, grads
    torch.cuda.empty_cache()
    return dict(shapes=[list(s) for s in shapes], max_abs_err=out)


def distill_tiny_card_vs_cpu(tiny_census):
    """One LCM-LoRA (rank 4) and one w-conditioned full distill step's
    gradients, and one textual-inversion step's row gradient, of the tiny
    fp32 UNet on the card (TF32 off) and on the CPU from the same weights,
    state, latents, contexts and draws (the first row at the clean
    boundary): every gradient within TINY_GRAD_REL of its tensor's max |g|
    (``tiny_grads_close``), the losses within 1e-3; the card's launches
    are the forwards' (a distill step's three, a TI step's one)."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.training.distillation import (LCMDistillConfig,
                                                                     LCMDistiller)
    from sonicdiffusionbayeslab_torch.training.textual_inversion import TextualInversionTrainer

    per = _kinds(tiny_census)
    rng = np.random.default_rng(15)
    arr = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    lat, ctx, unc, noise = arr(2, 8, 8, 4), arr(2, 77, 32), arr(2, 77, 32) * 0.1, arr(2, 8, 8, 4)
    draws = dict(idx=torch.tensor([0, 6]), noise=noise, w=torch.tensor([3.0, 9.0]))
    engines = tiny_engine_pair()
    grid = dict(original_inference_steps=10, learning_rate=TINY_TRAIN_LR)
    cases = {"distill lora": LCMDistillConfig(lora_rank=4, **grid),
             "distill wcond full": LCMDistillConfig(lora_rank=0, w_min=2.0, w_max=10.0,
                                                    student_time_cond_proj_dim=8, **grid)}
    ids = np.full((2, 77), 5, np.int64)
    ids[:, 3], ids[:, 4] = 997, 998
    ti_draws = dict(timesteps=torch.tensor([37, 812]), noise=noise)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for name in (*cases, "textual inversion"):
            wrapper_counts(reset=True)
            if name in cases:
                trainers = {d: LCMDistiller(e, cases[name]) for d, e in engines.items()}
                init = trainers["cpu"].init_state(generator=torch.Generator().manual_seed(0))
                res = {d: tr.value_and_grad(tr.init_state(trainable=init.trainable), lat, ctx,
                                            unc, **draws)
                       for d, tr in trainers.items()}
                forwards = 3
            else:
                trainers = {d: TextualInversionTrainer(e, [997, 998]) for d, e in engines.items()}
                res = {}
                for d, tr in trainers.items():
                    loss, g = tr.value_and_grad(tr.init_state(init_ids=[10, 11]), lat, ids,
                                                **ti_draws)
                    res[d] = loss, {"rows": g}
                forwards = 1
            counts = wrapper_counts()
            rel = tiny_grads_close(res["cuda"][1], res["cpu"][1], f"tiny {name}")
            err = abs(float(res["cuda"][0]) - float(res["cpu"][0]))
            want = {"attention_fp32": forwards * per["attention"],
                    "group_norm": forwards * per["group_norm"], "attention": 0}
            print(f"tiny fp32 {name} step, card vs CPU: gradients within {rel:.2e} of each "
                  f"tensor's max|g| (at most {TINY_GRAD_REL}), loss abs err {err:.3e} (tolerance "
                  f"1e-3); launches {counts}, expected {want}", flush=True)
            if not err <= 1e-3 or counts != want:
                raise AssertionError(f"the tiny {name} step on the card disagrees with the CPU "
                                     "or launched other than its forwards' kernels")
            out[name] = dict(max_grad_rel_err=rel, loss_abs_err=err,
                             fp32_attention_launches=counts["attention_fp32"],
                             group_norm_launches=counts["group_norm"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return out


def run_distill_loop(per, card, root, img_dir, ann):
    """``mode: distill`` through ``training.loop.run_training`` at full
    SD-1.5 width (configs/train_lora.yaml's model and dataset with the
    TRAIN_IMAGES PNGs; training: LCM-LoRA of rank DISTILL_RANK, grid
    DISTILL_GRID, batch TRAIN_BATCH, DISTILL_STEPS steps, otherwise
    LCMDistillConfig's defaults): finite losses, steps/s and peak memory,
    the wrappers' launches equal to the census (a step's teacher, target
    and student forwards, the prep's encode), the teacher's weights
    bit-equal from the distiller's first sight of them to the end,
    lora_peft.npz with every target's tensors fused by merge_lora into a
    LCM_STEPS-step LCM sample at consistency_model_config.yaml's guidance
    that differs from the base model's; then a DISTILL_TRACE_STEPS run
    traced against the census."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.config import load_config
    from sonicdiffusionbayeslab_torch.models.unet import UNet2DCondition, UNetConfig
    from sonicdiffusionbayeslab_torch.models.weights import merge_lora
    from sonicdiffusionbayeslab_torch.schedulers import LCMScheduler
    from sonicdiffusionbayeslab_torch.training import distillation as D
    from sonicdiffusionbayeslab_torch.training.lora import lora_targets
    from sonicdiffusionbayeslab_torch.training.loop import run_training

    repo = Path(__file__).resolve().parent
    training = {"mode": "distill", "lora_rank": DISTILL_RANK,
                "original_inference_steps": DISTILL_GRID, "batch_size": TRAIN_BATCH,
                "num_steps": DISTILL_STEPS, "log_every": DISTILL_LOG,
                "save_dir": str(Path(root) / "distill_out")}
    overrides = {"dataset.img_dataset": str(img_dir), "dataset.prompts": str(ann),
                 "training": training}
    print(f"configs/train_lora.yaml with overrides {json.dumps(overrides)}", flush=True)
    step = distill_step_census(per)
    per_step = {"attention": step["attention"],
                "group_norm": step["group_norm"] + per["encode"]["group_norm"]}
    seen = {}
    orig = D.LCMDistiller.init_state

    def init_state(self, *a, **kw):  # the teacher's weights as the distiller first sees them
        seen["teacher"] = {k: v.clone() for k, v in self.engine.unet.state_dict().items()}
        return orig(self, *a, **kw)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wrapper_counts(reset=True)
    D.LCMDistiller.init_state = init_state
    try:
        t0 = time.perf_counter()
        out = run_training(load_config(repo / "configs" / "train_lora.yaml", overrides))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        D.LCMDistiller.init_state = orig
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = bf16_only(wrapper_counts(), "the distill run")
    want = {k: DISTILL_STEPS * n for k, n in per_step.items()}
    losses = out["losses"]
    pipe, engine = out["pipeline"], out["engine"]
    teacher_same = all(torch.equal(v, seen["teacher"][k])
                       for k, v in engine.unet.state_dict().items())
    del seen
    rec = dict(losses=losses, steps_per_sec=out["steps_per_sec"],
               images_per_sec=out["steps_per_sec"] * TRAIN_BATCH, wall_s=wall, peak_gb=peak,
               wrapper_launches=counts, census_launches=want, teacher_bit_equal=teacher_same)
    print(f"distill (LCM-LoRA rank {DISTILL_RANK}, grid {DISTILL_GRID}, AdamW, EMA target "
          f"0.95), SD-1.5 bf16 {SIZE}x{SIZE}, batch {TRAIN_BATCH}, {DISTILL_STEPS} steps through "
          f"the loop: losses {losses}, steady {out['steps_per_sec']:.3f} steps/s "
          f"({rec['images_per_sec']:.2f} images/s), run wall {wall:.1f} s, peak memory "
          f"{peak:.2f} GB; wrapper launches {counts}, census {want} ({per_step} a step); "
          f"teacher bit-equal after: {teacher_same}; {card}", flush=True)
    if len(losses) != DISTILL_STEPS // DISTILL_LOG or not all(np.isfinite(losses)):
        raise AssertionError(f"distill run: logged losses {losses}")
    if counts != want or not teacher_same:
        raise AssertionError(f"distill run: wrapper launches {counts}, census {want}; teacher "
                             f"bit-equal {teacher_same}")
    with torch.device("meta"):
        targets = lora_targets(UNet2DCondition(UNetConfig.sd15()))
    npz = np.load(Path(root) / "distill_out" / "final" / "lora_peft.npz")
    keys = {f"unet.{m}.{s}" for m in targets for s in ("lora_A.weight", "lora_B.weight", "alpha")}
    ranks = {npz[k].shape[0] for k in keys if k.endswith("lora_A.weight")}
    if set(npz.files) != keys or ranks != {DISTILL_RANK}:
        raise AssertionError(f"lora_peft.npz holds {len(npz.files)} arrays, the census of "
                             f"{len(targets)} targets {len(keys)}")
    guidance = float(load_config(repo / "configs" / "consistency_model_config.yaml")
                     .experiment_params["guidance_scale"])
    pipe.scheduler = LCMScheduler(original_inference_steps=DISTILL_GRID)
    kw = dict(num_inference_steps=LCM_STEPS, guidance_scale=guidance, seed=29)
    base = pipe(PROMPTS[:1], **kw)[0]
    sd, names = merge_lora(engine.unet.state_dict(),
                           {k: torch.from_numpy(npz[k]) for k in npz.files})
    engine.unet.load_state_dict(sd)
    engine.weights_changed()
    fused = pipe(PROMPTS[:1], **kw)[0]
    diff = float(np.abs(fused - base).max())
    rec.update(fused_modules=len(names), lcm_guidance=guidance, image_max_abs_diff=diff)
    print(f"lora_peft.npz: {len(npz.files)} arrays (rank {DISTILL_RANK}); fused by merge_lora "
          f"into {len(names)} modules; one {SIZE}x{SIZE} sample, {LCM_STEPS}-step LCM at "
          f"guidance {guidance} (consistency_model_config.yaml): max abs diff from the base "
          f"model's {diff:.4f}", flush=True)
    if fused.shape != (1, SIZE, SIZE, 3) or not np.isfinite(fused).all() or not diff > 0:
        raise AssertionError(f"the distilled LoRA's sample: shape {fused.shape}, max abs diff "
                             f"from the base model's {diff}")
    del out, pipe, engine, sd, base, fused
    gc.collect()
    torch.cuda.empty_cache()
    short = load_config(repo / "configs" / "train_lora.yaml", {
        **overrides, "training": {**training, "num_steps": DISTILL_TRACE_STEPS,
                                  "save_dir": str(Path(root) / "distill_trace")}})
    want_trace = {k: DISTILL_TRACE_STEPS * n for k, n in per_step.items()}
    _, traced, attempts = traced_exact(lambda: run_training(short), want_trace,
                                       "the traced distill run", reset=retrace_reset())
    if traced["attention_fp32"]:
        raise AssertionError("the traced distill run launched the fp32 kernel")
    rec.update(traced_launches=traced, trace_steps=DISTILL_TRACE_STEPS, trace_attempts=attempts)
    print(f"traced distill run of {DISTILL_TRACE_STEPS} steps: kernel executions "
          f"{json.dumps({k: traced[k] for k in MAIN})}, census {want_trace}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _steps(step, n):
    """``n`` calls of ``step()`` (each returning a step's metrics) -> (the
    losses, steady steps/s over calls 2..n, the device synchronised at
    both ends)."""
    losses, t_first = [], None
    for i in range(n):
        metrics = step()
        losses.append(metrics["loss"])
        if i == 0:
            torch.cuda.synchronize()
            t_first = time.perf_counter()
    torch.cuda.synchronize()
    return [float(x) for x in losses], (n - 1) / (time.perf_counter() - t_first)


def run_wcond_and_ti(per, card, root, img_dir, ann, profile):
    """On one SD-1.5 engine (random bf16 weights, seed 0) and TRAIN_BATCH of
    the PNGs encoded: the w-conditioned full student (LCMDistiller with
    lora_rank 0, cond_proj of width WCOND_DIM, w in WCOND_W) at WCOND_BATCH
    for WCOND_STEPS steps (cond_proj nonzero after the first update, the
    teacher bit-equal, launches equal to the census), its EMA student
    loaded strictly into an engine whose UNet has time_cond_proj_dim, a
    LCM_STEPS-step LCM sample at BATCH through the CUDA graph at each of
    WCOND_GUIDANCE (the capturing run's launches equal to the census; the
    images differ), one eager forward bit-equal to the graphed one; then
    textual inversion of TI_PLACEHOLDERS seeded from TI_INIT at TRAIN_BATCH
    for TI_STEPS steps (only those rows change; the token table's other
    rows, the text tower and the UNet bit-equal; launches equal to the
    census; the embeddings' npz).  With ``profile``, a trace of a LCM-LoRA
    distill step and of a TI step at TRAIN_BATCH."""
    import dataclasses

    import numpy as np

    from sonicdiffusionbayeslab_torch.data.dataset import ImageDatasetWithPrompts, batched
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
    from sonicdiffusionbayeslab_torch.models.sampler import (StableDiffusionEngine,
                                                             guidance_scale_embedding)
    from sonicdiffusionbayeslab_torch.schedulers import LCMScheduler
    from sonicdiffusionbayeslab_torch.training.distillation import (LCMDistillConfig,
                                                                     LCMDistiller)
    from sonicdiffusionbayeslab_torch.training.textual_inversion import (TOKEN_TABLE,
                                                                          TextualInversionTrainer)
    from sonicdiffusionbayeslab_torch.training.trainer import TrainConfig

    out = {}
    pipe = StableDiffusionModel(image_size=SIZE)
    eng = pipe.engine
    batch = next(iter(batched(ImageDatasetWithPrompts(str(img_dir), str(ann), SIZE), TRAIN_BATCH)))
    gen = torch.Generator(device="cuda").manual_seed(15)
    lat_hw = SIZE // 2 ** (len(eng.vae_config.block_out_channels) - 1)
    latents = eng.encode_image(torch.as_tensor(batch["image"]).cuda(), noise=torch.randn(
        (TRAIN_BATCH, lat_hw, lat_hw, 4), generator=gen, device="cuda"))
    prompts = list(batch["prompt"])
    context = eng.encode_prompts(pipe.tokenizer(prompts))
    uncond = eng.encode_prompts(pipe.tokenizer([""] * TRAIN_BATCH))
    unet_before = {k: v.clone() for k, v in eng.unet.state_dict().items()}
    text_before = {k: v.clone() for k, v in eng.text.state_dict().items()}

    # ---- the w-conditioned full student
    cfg = LCMDistillConfig(lora_rank=0, student_time_cond_proj_dim=WCOND_DIM,
                           w_min=WCOND_W[0], w_max=WCOND_W[1])
    dist = LCMDistiller(eng, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = dist.init_state()
    cp = state.trainable["time_embedding.cond_proj.weight"]
    zero_before = bool(cp.abs().max() == 0)
    wrapper_counts(reset=True)
    box = [state]
    moved = []

    def step():
        box[0], m = dist.distill_step(box[0], latents[:WCOND_BATCH], context[:WCOND_BATCH],
                                      uncond[:WCOND_BATCH], gen)
        if not moved:
            moved.append(float(box[0].trainable["time_embedding.cond_proj.weight"].detach()
                               .abs().max()))
        return m

    losses, rate = _steps(step, WCOND_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = bf16_only(wrapper_counts(), "the w-conditioned distill steps")
    want = {k: WCOND_STEPS * n for k, n in distill_step_census(per, "wcond_teacher",
                                                               "wcond").items()}
    teacher_same = all(torch.equal(v, unet_before[k]) for k, v in eng.unet.state_dict().items())
    print(f"w-conditioned full student (cond_proj {WCOND_DIM} wide, zero at init: "
          f"{zero_before}; w in {WCOND_W}), SD-1.5 bf16 {SIZE}x{SIZE}, batch {WCOND_BATCH}, "
          f"{WCOND_STEPS} steps: losses {losses}, steady {rate:.3f} steps/s, peak memory "
          f"{peak:.2f} GB; max |cond_proj| after the first update {moved[0]:.3e}; wrapper "
          f"launches {counts}, census {want}; teacher bit-equal after: {teacher_same}; {card}",
          flush=True)
    if (not all(np.isfinite(losses)) or not zero_before or not moved[0] > 0 or counts != want
            or not teacher_same):
        raise AssertionError("the w-conditioned distill steps: losses, cond_proj, launches or "
                             "the teacher wrong")
    out["wcond"] = dict(losses=losses, steps_per_sec=rate, peak_gb=peak,
                        cond_proj_after_first_update=moved[0], wrapper_launches=counts,
                        census_launches=want)
    student = dist.student_unet_params(box[0])
    del dist, state, box, step
    gc.collect()
    torch.cuda.empty_cache()
    weng = StableDiffusionEngine(dataclasses.replace(eng.unet_config,
                                                     time_cond_proj_dim=WCOND_DIM),
                                 eng.vae_config, eng.text_config, device="cuda")
    weng.load_state_dicts({"unet": student, "vae": eng.vae.state_dict(),
                           "text": eng.text.state_dict()})  # strict
    del student
    plan = LCMScheduler(original_inference_steps=DISTILL_GRID).build_plan(LCM_STEPS)
    ctx2 = context[:BATCH]
    images, first = [], None
    for g in WCOND_GUIDANCE:
        wrapper_counts(reset=True)
        with torch.inference_mode():
            o = weng.sample(plan, ctx2, None, seed=29, guidance_scale=g,
                            latent_hw=(lat_hw, lat_hw))
        images.append(o.images.float().cpu().numpy())
        if first is None:
            first = bf16_only(wrapper_counts(), "the w-conditioned LCM sample")
    want_first = {k: 3 * per["sample"][k] + per["decode"].get(k, 0) for k in MAIN}
    diff = float(np.abs(images[0] - images[1]).max())
    captures = dict(weng.graphed_unet.captures)
    with torch.inference_mode():
        lat = torch.randn((BATCH, lat_hw, lat_hw, 4), generator=gen,
                          device="cuda").to(torch.bfloat16)
        tb = torch.full((BATCH,), float(plan.timesteps[1]), device="cuda")
        emb = guidance_scale_embedding(torch.full((BATCH,), WCOND_GUIDANCE[0] - 1.0),
                                       WCOND_DIM).cuda()
        eager = weng.unet(lat, tb, ctx2, timestep_cond=emb)
        graphed = weng.graphed_unet(lat, tb, ctx2, *(None,) * 8, emb)
    same = bool(torch.equal(eager, graphed))
    print(f"w-conditioned engine (time_cond_proj_dim {WCOND_DIM}, the EMA student loaded "
          f"strictly): {LCM_STEPS}-step LCM samples at batch {BATCH} through the CUDA graph at "
          f"guidance {WCOND_GUIDANCE} embedded (no CFG): max abs diff {diff:.4f}; the first "
          f"run's wrapper launches {first}, census {want_first} (warm-ups and capture: 3 "
          f"forwards, and a decode); captures {captures}; eager forward bit-equal to the "
          f"graphed one: {same}", flush=True)
    if (not all(np.isfinite(i).all() for i in images) or images[0].shape != (BATCH, SIZE, SIZE, 3)
            or not diff > 0 or first != want_first or not same or list(captures.values()) != [1]):
        raise AssertionError("the w-conditioned engine's samples, launches or graph disagree")
    out["wcond"].update(sample_launches=first, sample_census=want_first, guidance_diff=diff,
                        eager_graphed_bit_equal=same)
    del weng, images, eager, graphed
    gc.collect()
    torch.cuda.empty_cache()

    # ---- textual inversion
    ids = np.asarray(pipe.tokenizer(prompts)).copy()
    ids[:, 1:1 + len(TI_PLACEHOLDERS)] = TI_PLACEHOLDERS
    ti = TextualInversionTrainer(eng, TI_PLACEHOLDERS, TrainConfig(learning_rate=TI_LR))
    torch.cuda.reset_peak_memory_stats()
    box = [ti.init_state(init_ids=TI_INIT)]
    seeded = bool(torch.equal(box[0].trainable.to(eng.dtype),
                              text_before[TOKEN_TABLE][list(TI_INIT)]))
    wrapper_counts(reset=True)

    def ti_step():
        box[0], m = ti.train_step(box[0], latents, ids, gen)
        return m

    losses, rate = _steps(ti_step, TI_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = bf16_only(wrapper_counts(), "the textual inversion steps")
    want = {k: TI_STEPS * per["unet"][k] for k in MAIN}
    table = ti.text_params(box[0])[TOKEN_TABLE]
    changed = torch.nonzero((table != text_before[TOKEN_TABLE]).any(dim=1)).flatten().tolist()
    frozen = (all(torch.equal(v, text_before[k]) for k, v in eng.text.state_dict().items())
              and all(torch.equal(v, unet_before[k]) for k, v in eng.unet.state_dict().items()))
    ti.save_embeddings(box[0], Path(root) / "ti.npz")
    npz = np.load(Path(root) / "ti.npz")
    print(f"textual inversion of tokens {TI_PLACEHOLDERS} (seeded from {TI_INIT}: {seeded}), "
          f"Adam lr {TI_LR}, SD-1.5 bf16 {SIZE}x{SIZE}, batch {TRAIN_BATCH}, {TI_STEPS} steps: "
          f"losses {losses}, steady {rate:.3f} steps/s ({rate * TRAIN_BATCH:.2f} images/s), peak "
          f"memory {peak:.2f} GB; rows changed {changed}; token table's other rows, text tower "
          f"and UNet bit-equal: {frozen}; wrapper launches {counts}, census {want} (the text "
          f"tower's masked attention takes the plain path); ti.npz {npz.files} "
          f"{list(npz['embeddings'].shape)}; {card}", flush=True)
    if (not all(np.isfinite(losses)) or not seeded or changed != sorted(TI_PLACEHOLDERS)
            or not frozen or counts != want or npz.files != ["ids", "embeddings"]
            or list(npz["ids"]) != list(TI_PLACEHOLDERS)):
        raise AssertionError("textual inversion: losses, rows, frozen weights, launches or the "
                             "npz wrong")
    out["ti"] = dict(losses=losses, steps_per_sec=rate, images_per_sec=rate * TRAIN_BATCH,
                     peak_gb=peak, rows_changed=changed, wrapper_launches=counts,
                     census_launches=want)
    if profile:
        lora = LCMDistiller(eng, LCMDistillConfig(lora_rank=DISTILL_RANK,
                                                  original_inference_steps=DISTILL_GRID))
        dbox = [lora.init_state()]

        def distill_once():
            dbox[0], m = lora.distill_step(dbox[0], latents, context, uncond, gen)
            float(m["loss"])

        out["profiles"] = {
            "distill": profile_steps(distill_once, f"distill LCM-LoRA batch {TRAIN_BATCH}", card, {
                "teacher (distill_step.teacher)": "distill_step.teacher",
                "target (distill_step.target)": "distill_step.target",
                "optimizer (distill_step.optimizer)": "distill_step.optimizer"}),
            "ti": profile_steps(lambda: float(ti_step()["loss"]),
                                f"textual inversion batch {TRAIN_BATCH}", card,
                                {"optimizer (ti_step.optimizer)": "ti_step.optimizer"})}
        del lora, dbox
    del pipe, eng, ti, box, unet_before, text_before
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase15_launches(out, kind):
    """A kernel's launches in each phase-15 run."""
    if kind == "attention_fp32":
        return {f"tiny {n}": r["fp32_attention_launches"]
                for n, r in out["tiny_card_vs_cpu"].items()}
    return {"distill run": out["distill"]["wrapper_launches"][kind],
            "distill trace": out["distill"]["traced_launches"][kind],
            "w-conditioned steps": out["wcond"]["wrapper_launches"][kind],
            "w-conditioned LCM sample (capture)": out["wcond"]["sample_launches"][kind],
            "textual inversion": out["ti"]["wrapper_launches"][kind]}


def run_distill_phase(report, card, checked, profile):
    """Phase 15: LCM distillation (LCM-LoRA through the loop, the
    w-conditioned full student and its sampling) and textual inversion at
    full SD-1.5 width, K/V-only gradients through the bf16 attention
    Function, tiny fp32 steps card vs CPU."""
    census = distill_census()
    per = {part: dict(_kinds(c)) for part, c in census.items()}
    print(f"phase 15 census (launches a forward, an encode or a decode): {json.dumps(per)}",
          flush=True)
    step = distill_step_census(per)
    if (step["attention"], step["group_norm"], per["encode"]["group_norm"]) != (96, 183, 22):
        raise AssertionError(f"phase 15 census {per}: expected 96 attentions and 183 GroupNorms "
                             "a distill step, 22 GroupNorms an encode")
    out = {"census": per, "part_s": {}}
    t0 = time.perf_counter()

    def timed(part, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        out["part_s"][part] = time.perf_counter() - t
        return result

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["checked_shapes"] = timed("forward checks", check_forward, {
        (k, torch.bfloat16) for c in census.values() for k in c}, report, checked, 15)
    out["kv_gradients"] = timed("K/V-only gradients", check_kv_gradients, census, report)
    out["tiny_card_vs_cpu"] = timed("tiny card vs CPU", distill_tiny_card_vs_cpu,
                                    module_census(2, tiny=True))
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory(prefix="sdbl_distill_") as tmp:
        img_dir, ann = write_train_images(tmp)
        out["distill"] = timed("distill through the loop", run_distill_loop, per, card, tmp,
                               img_dir, ann)
        out.update(timed("w-conditioned student and textual inversion", run_wcond_and_ti, per,
                         card, tmp, img_dir, ann, profile))
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 15 took {out['phase_s']:.1f} s: "
          f"{json.dumps({k: round(v, 1) for k, v in out['part_s'].items()})}", flush=True)
    report["e2e"]["distillation"] = out


# ------------------------------------------------ multi-device (phase 16)
# Two ranks share the one card (gloo: NCCL refuses two ranks on one GPU),
# so every number here is contention between two processes, not scaling.
DP_RANKS = 2
DP_PROMPTS = PROMPTS + ["a red fox in fresh snow, photograph",
                        "a city street at night, neon lights, rain"]
DP_TRAIN_STEPS = 2
# The two-rank LoRA run (train_lora.yaml, batch 4 a rank) against one
# process.  One step on fixed inputs: the ranks' averaged loss and
# gradients within DP_SPLIT_REL of one process's mean over the same two
# halves of the batch (the same shapes and kernels; only the all-reduce
# differs), and within DP_GRAD_REL of its tensor's largest entry of one
# process at batch 8 (TINY_GRAD_REL's form; bf16 at full width, where
# half the batch gives cuBLAS and cuDNN other shapes to sum: 2.12e-2 in
# PR 16's first chip run).  The run: each logged loss within DP_LOSS_REL
# of one process's at batch 8; each adapter tensor's update over the run
# (trained minus initial) within DP_UPDATE_REL of one process's L2 norm
# (AdamW's normalised step turns gradient rounding into update
# differences of its own size where a gradient entry is near 0).
DP_SPLIT_REL, DP_LOSS_REL, DP_GRAD_REL, DP_UPDATE_REL = 1e-6, 1e-2, 5e-2, 1e-1
DP_TIMEOUT_S = 600


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# The rank processes of phases 16-18 start in phase 12 (prestart_ranks)
# and wait for a go file: their imports, ~8 s a process on the card's
# machine, overlap the single-process phases instead of each rank group's
# start.  A waiting rank whose main process has gone, or that got no go
# file in RANK_WAIT_S, exits.
_WAITING = {}  # (flag, mode or None, rank) -> (process, its log, its go file)
_WAIT_DIR = []
RANK_WAIT_S = 3000


def _rank_argv(flag, mode, rank):
    """This script as a rank: ``flag`` --dp-rank or --tp-rank."""
    argv = [sys.executable, str(Path(__file__).resolve()), flag, str(rank)]
    return argv + (["--tp-mode", mode] if mode else []) + [
        "--spawned", repr(time.time()), "--parent", str(os.getpid())]


def _rank_env():
    return dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))


def prestart_ranks(specs):
    """Starts a rank process for each (flag, mode, rank) of ``specs``, each
    waiting for its go file (``start_rank``); every one still waiting when
    this script exits is stopped."""
    import atexit

    if not _WAIT_DIR:
        _WAIT_DIR.append(Path(tempfile.mkdtemp(prefix="sdbl_ranks_")))
        atexit.register(_stop_waiting)
    for flag, mode, r in specs:
        tag = f"{flag[2:4]}_{mode or 'dp'}_{r}"
        log, go = _WAIT_DIR[0] / f"{tag}.log", _WAIT_DIR[0] / f"{tag}.go"
        with open(log, "w") as f:
            p = subprocess.Popen(_rank_argv(flag, mode, r) + ["--go-file", str(go)],
                                 env=_rank_env(), stdout=f, stderr=subprocess.STDOUT)
        _WAITING[(flag, mode, r)] = (p, log, go)


def _stop_waiting():
    for p, _, _ in _WAITING.values():
        if p.poll() is None:
            p.kill()
            p.wait()
    _WAITING.clear()
    for d in _WAIT_DIR:
        shutil.rmtree(d, ignore_errors=True)


def start_rank(flag, mode, rank, addr, root, log):
    """A rank process told to start its group's work (the group's address
    and directory): the one ``prestart_ranks`` left waiting, its go file
    written, else a new one logging to ``log``.  (process, its log)."""
    go = dict(addr=addr, dir=str(root), at=time.time())
    if (flag, mode, rank) in _WAITING:
        p, log, path = _WAITING.pop((flag, mode, rank))
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(go))
        tmp.rename(path)  # whole, or not there
        return p, log
    with open(log, "w") as f:
        p = subprocess.Popen(_rank_argv(flag, mode, rank) + ["--go", json.dumps(go)],
                             env=_rank_env(), stdout=f, stderr=subprocess.STDOUT)
    return p, log


def wait_for_go(path, spawned, parent):
    """A waiting rank: imports what the ranks run, then waits for ``path``
    and returns what it holds (exits once ``parent`` is no longer its
    parent)."""
    import sonicdiffusionbayeslab_torch.config  # noqa: F401
    import sonicdiffusionbayeslab_torch.models.pipelines  # noqa: F401
    import sonicdiffusionbayeslab_torch.parallel.distributed  # noqa: F401
    import sonicdiffusionbayeslab_torch.parallel.mesh  # noqa: F401
    import sonicdiffusionbayeslab_torch.training.loop  # noqa: F401

    path = Path(path)
    while not path.exists():
        if os.getppid() != parent or time.time() - spawned > RANK_WAIT_S:
            sys.exit(3)
        time.sleep(0.1)
    return json.loads(path.read_text())


def dp_train(root, img_dir, ann, mesh_data=0):
    """configs/train_lora.yaml through ``run_training`` for DP_TRAIN_STEPS
    steps (the dataset and save_dir overridden; ``training.mesh_data``
    ``mesh_data``): (record, {adapter: update over the run}, {"loss",
    adapter: gradient} of one step on fixed inputs from the loop's initial
    adapters, this rank's rows of them; in one process, also the mean of
    the steps on each rank's rows, with their rows of the batch's
    draws)."""
    from sonicdiffusionbayeslab_torch.config import load_config
    from sonicdiffusionbayeslab_torch.parallel.mesh import batch_sharding
    from sonicdiffusionbayeslab_torch.training.loop import _generator, run_training
    from sonicdiffusionbayeslab_torch.training.trainer import leaves

    repo = Path(__file__).resolve().parent
    overrides = {"dataset.img_dataset": str(img_dir), "dataset.prompts": str(ann),
                 "training.num_steps": DP_TRAIN_STEPS, "training.log_every": 1,
                 "training.save_dir": str(Path(root) / f"lora_dp{mesh_data}"),
                 "training.mesh_data": mesh_data}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wrapper_counts(reset=True)
    t0 = time.perf_counter()
    out = run_training(load_config(repo / "configs" / "train_lora.yaml", overrides))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = dict(losses=out["losses"], steps_per_sec=out["steps_per_sec"], wall_s=wall,
               peak_gb=torch.cuda.max_memory_allocated() / 2**30,
               wrapper_launches=bf16_only(wrapper_counts(), "the LoRA run"))
    trainer, dev = out["trainer"], out["engine"].device
    init = leaves(trainer.init_state(generator=_generator(dev, 29, 0)).trainable)
    update = {k: (v - init[k]).detach().cpu() for k, v in leaves(out["state"].trainable).items()}
    batch = int(load_config(repo / "configs" / "train_lora.yaml").training["batch_size"])
    g = torch.Generator().manual_seed(16)
    lat = torch.randn((batch, SIZE // 8, SIZE // 8, 4), generator=g)
    ctx = torch.randn((batch, 77, 768), generator=g)
    rows = batch_sharding(trainer.mesh).rows(batch)
    state = trainer.init_state(generator=_generator(dev, 29, 0))
    loss, grads = trainer.value_and_grad(state, lat[rows], ctx[rows],
                                         generator=torch.Generator(device=dev).manual_seed(17))
    grads = {"loss": loss.cpu(), **{k: v.detach().cpu() for k, v in grads.items()}}
    if not mesh_data:
        ts, noise = trainer.draws(batch, lat.shape, torch.Generator(device=dev).manual_seed(17))
        n = batch // DP_RANKS
        halves = [trainer.value_and_grad(state, lat[r * n:(r + 1) * n], ctx[r * n:(r + 1) * n],
                                         noise=noise[r * n:(r + 1) * n],
                                         timesteps=ts[r * n:(r + 1) * n])
                  for r in range(DP_RANKS)]
        grads["split"] = {"loss": (halves[0][0] + halves[1][0]).cpu() / 2, **{
            k: ((halves[0][1][k] + halves[1][1][k]) / 2).cpu() for k in halves[0][1]}}
    del out, trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return rec, update, grads


def dp_rank(rank, addr, root):
    """One rank of phase 16 (parts b and c), run as its own process: the
    SD-1.5 pipeline with ``mesh_data=DP_RANKS`` over a gloo group on the
    card (a cold run checked against the census' capture count, a timed
    run, a traced run whose kernel executions are the census of a batch-2
    run), then the two-rank LoRA run.  Writes ``rank<r>.json``, and rank
    0 its gathered images and the run's updates and gradients."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
    from sonicdiffusionbayeslab_torch.parallel import distributed
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    root = Path(root)
    t_start = time.perf_counter()
    distributed.initialize(coordinator=addr, num_processes=DP_RANKS, process_id=rank,
                           backend="gloo", device="cuda")
    # A rank's rows: BATCH prompts, CFG-doubled in its UNet calls.
    _, per_unet, per_vae = census(2 * BATCH)
    t0 = time.perf_counter()
    model = StableDiffusionModel(image_size=SIZE, tiny=False, dtype="bfloat16", seed=0,
                                 device="cuda", mesh_data=DP_RANKS)
    init_s = time.perf_counter() - t0
    kw = dict(num_inference_steps=STEPS, guidance_scale=GUIDANCE, seed=29)
    wrapper_counts(reset=True)
    t0 = time.perf_counter()
    model(DP_PROMPTS, **kw)
    cold_s = time.perf_counter() - t0
    first = bf16_only(wrapper_counts(), f"rank {rank}'s first run")
    want_first = {k: (GraphedCall.WARMUP + 1) * per_unet[k] + per_vae[k] for k in MAIN}
    if first != want_first:
        raise AssertionError(f"rank {rank}: first run's wrapper launches {first}, census "
                             f"{want_first}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    imgs, exec_time, _ = model(DP_PROMPTS, **kw)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if imgs.shape != (len(DP_PROMPTS), SIZE, SIZE, 3) or not np.isfinite(imgs).all():
        raise AssertionError(f"rank {rank}: images {imgs.shape}")
    want = {k: STEPS * per_unet[k] + per_vae[k] for k in MAIN}
    (imgs_t, _, _), traced, attempts = traced_exact(
        lambda: model(DP_PROMPTS, **kw), want, f"rank {rank}'s data-parallel run",
        same=lambda o: np.array_equal(o[0], imgs), reset=retrace_reset())
    if not np.array_equal(imgs_t, imgs):
        raise AssertionError(f"rank {rank}: a second identical run gave other images")
    np.save(root / f"images_rank{rank}.npy", imgs)
    sampling = dict(init_s=init_s, cold_s=cold_s, execution_time_s=exec_time, call_s=wall,
                    peak_gb=peak, first_run_wrapper_launches=first,
                    traced_launches={k: traced[k] for k in MAIN}, trace_attempts=attempts)
    print(f"phase 16 rank {rank} sampling {json.dumps(sampling)}", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    rec, update, grads = dp_train(root, root / "train_images",
                                  root / "img2annotations_train_first16.json", DP_RANKS)
    print(f"phase 16 rank {rank} training {json.dumps(rec)}", flush=True)
    if rank == 0:
        torch.save({"update": update, "grads": grads}, root / "train_rank0.pt")
    (root / f"rank{rank}.json").write_text(json.dumps(dict(
        sampling=sampling, training=rec, wall_s=time.perf_counter() - t_start)))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def nccl_one_rank():
    """Phase 16 (a): a one-rank NCCL group on the card: all_sum_scalar and
    all_sum_array through device tensors, make_mesh(1) on cuda."""
    import numpy as np
    import torch.distributed as dist

    from sonicdiffusionbayeslab_torch.parallel import distributed, mesh

    t0 = time.perf_counter()
    if not distributed.initialize(coordinator=f"localhost:{_free_port()}", num_processes=1,
                                  process_id=0, device="cuda"):
        raise AssertionError("initialize started no process group")
    try:
        backend = dist.get_backend()
        s = distributed.all_sum_scalar(1.5)
        a = distributed.all_sum_array(np.arange(4.0))
        m = mesh.make_mesh(1)
        got = dict(backend=backend, scalar=s, array=a.tolist(), mesh=str(m),
                   mesh_device=m.device_type, data_axis=mesh.axis_size(m, "data"))
    finally:
        dist.destroy_process_group()
    got["wall_s"] = time.perf_counter() - t0
    print(f"phase 16 (a) one-rank NCCL group: {json.dumps(got)}", flush=True)
    if (backend != "nccl" or s != 1.5 or got["array"] != [0.0, 1.0, 2.0, 3.0]
            or got["mesh_device"] != "cuda" or got["data_axis"] != 1):
        raise AssertionError(f"one-rank NCCL group: {got}")
    return got


def run_dp_ranks(root):
    """Phase 16 (b, c): DP_RANKS processes of this script (``--dp-rank``),
    each rank's output in ``rank<r>.log``; every rank must exit 0 within
    DP_TIMEOUT_S, and every process is stopped."""
    addr = f"localhost:{_free_port()}"
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(DP_RANKS):
            p, log = start_rank("--dp-rank", None, r, addr, root, root / f"rank{r}.log")
            procs.append(p)
            logs.append(log)
        deadline = time.monotonic() + DP_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        text = logs[r].read_text()
        print(f"--- rank {r} (exit {p.returncode}), last lines:\n" + "\n".join(
            text.splitlines()[-12:]), flush=True)
        if p.returncode != 0:
            raise AssertionError(f"phase 16 rank {r} exited {p.returncode}")
    return [json.loads((root / f"rank{r}.json").read_text()) for r in range(DP_RANKS)], wall


def dp_reference_rows(model, root):
    """Phase 16 (b)'s one-process runs: each rank's rows of DP_PROMPTS
    (encoded as the pipeline encodes the whole batch) through the engine
    with their global sample indices; each must be bit-equal to the ranks'
    gathered images."""
    import numpy as np

    kw = dict(guidance_scale=GUIDANCE, latent_hw=(SIZE // 8, SIZE // 8), seed=29)
    emb, neg = model._encode(DP_PROMPTS), model._encode([""] * len(DP_PROMPTS))
    plan = model.build_plan(STEPS)
    rows = len(DP_PROMPTS) // DP_RANKS
    want = np.concatenate([
        model.engine.sample(plan, emb[r * rows:(r + 1) * rows], neg[r * rows:(r + 1) * rows],
                            sample_indices=range(r * rows, (r + 1) * rows), **kw).images
        .cpu().numpy() for r in range(DP_RANKS)])
    got = [np.load(root / f"images_rank{r}.npy") for r in range(DP_RANKS)]
    equal = [bool(np.array_equal(g, want)) for g in got]
    diff = [float(np.abs(g - want).max()) for g in got]
    print(f"phase 16 (b) gathered images of each rank against one-process runs of each rank's "
          f"rows: bit-equal {equal} (max abs diff {diff})", flush=True)
    if not all(equal):
        raise AssertionError(f"the two-rank images differ from the one-process rows: {diff}")
    return dict(bit_equal=equal, max_abs_diff=diff)


def dp_compare_training(root, one):
    """Phase 16 (c): the ranks' LoRA run against one process's (``one``
    from dp_train) within DP_LOSS_REL, DP_GRAD_REL and DP_UPDATE_REL."""
    rec, update, grads = one
    split = grads.pop("split")
    ranks = torch.load(root / "train_rank0.pt")
    got_rec = json.loads((root / "rank0.json").read_text())["training"]

    def rel(got, want):
        """Largest |got - want| / max |want| over the gradient tensors, and
        the loss's relative difference."""
        g = max(float((got[k] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for k, w in want.items() if k != "loss")
        return g, abs(float(got["loss"]) - float(want["loss"])) / abs(float(want["loss"]))

    loss_rel = max(abs(g - w) / abs(w) for g, w in zip(got_rec["losses"], rec["losses"]))
    split_rel, split_loss_rel = rel(ranks["grads"], split)
    split_equal = all(torch.equal(ranks["grads"][k], v) for k, v in split.items())
    grad_rel, grad_loss_rel = rel(ranks["grads"], grads)
    upd_rel = max(float((ranks["update"][k] - u).norm()) / max(float(u.norm()), 1e-30)
                  for k, u in update.items())
    out = dict(one_process=rec, two_ranks_losses=got_rec["losses"], loss_rel=loss_rel,
               split_rel=split_rel, split_loss_rel=split_loss_rel, split_bit_equal=split_equal,
               step_loss_rel=grad_loss_rel, grad_rel=grad_rel, update_rel=upd_rel,
               adapters=len(update))
    print(f"phase 16 (c) two ranks at batch 4 against one process: one step on fixed inputs "
          f"against the mean of one process's steps on the same halves: gradients max |diff| / "
          f"max |g| {split_rel:.2e}, loss rel {split_loss_rel:.2e} (bound {DP_SPLIT_REL}; "
          f"bit-equal {split_equal}); against one process at batch 8: gradients {grad_rel:.2e} "
          f"(bound {DP_GRAD_REL}), loss rel {grad_loss_rel:.2e}; the run's losses "
          f"{got_rec['losses']} vs {rec['losses']} (max rel {loss_rel:.2e}, bound "
          f"{DP_LOSS_REL}); {len(update)} adapter updates over the run: max L2 rel "
          f"{upd_rel:.2e} (bound {DP_UPDATE_REL})", flush=True)
    if not (split_rel <= DP_SPLIT_REL and split_loss_rel <= DP_SPLIT_REL
            and loss_rel <= DP_LOSS_REL and grad_loss_rel <= DP_LOSS_REL
            and grad_rel <= DP_GRAD_REL and upd_rel <= DP_UPDATE_REL):
        raise AssertionError(f"the two-rank LoRA run differs from one process's: {out}")
    return out


def meta_unet_flops(unet_batch):
    """The FLOPs of one SD-1.5 UNet forward counted from shapes alone (no
    device): FlopCounterMode over the census' meta-device run (convolutions
    and matmuls), plus 4·B·H·N·M·D per attention call and 10 (6 without
    SiLU) operations an element per GroupNorm call of the census."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        calls = module_census(unet_batch)
    kernels = 0
    for (kind, shape), n in calls.items():
        if kind == "attention":
            B, N, M, H, D = shape
            kernels += n * 4 * B * H * N * M * D
        else:
            B, N, C, _, _, silu = shape
            kernels += n * (10 if silu else 6) * B * N * C
    return int(fc.get_total_flops()) + kernels


def run_tools(model, per_unet, per_vae, root, card):
    """Phase 16 (d): ``profiling.trace`` around one batch-2 pipeline call
    (pads before and after it, as traced_launches has), read by
    ``python -m sonicdiffusionbayeslab_torch.utils.trace_analysis``, whose
    rollup must count the census' kernels by group (retraced up to
    TRACE_ATTEMPTS times, as traced_exact does); then ``flops_estimate``
    of one eager UNet forward at the loop's batch against the count from
    shapes."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.utils import profiling

    kw = dict(num_inference_steps=STEPS, guidance_scale=GUIDANCE, seed=29)
    imgs = model(PROMPTS, **kw)[0]
    want = {"flash_attention (ours)": STEPS * per_unet["attention"] + per_vae["attention"],
            "group_norm_silu (ours)": STEPS * per_unet["group_norm"] + per_vae["group_norm"]}
    pat = re.compile(r"^(flash_attention \(ours\)|group_norm_silu \(ours\))\s+([\d.]+)\s+"
                     r"[\d.]+%\s+(\d+)")
    history = []
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        d = root / f"trace{attempt}"
        t0 = time.perf_counter()
        with profiling.trace(d):
            _pads()
            time.sleep(0.1)
            out = model(PROMPTS, **kw)[0]
            torch.cuda.synchronize()
            time.sleep(0.1)
            _pads()
        trace_s = time.perf_counter() - t0
        r = subprocess.run([sys.executable, "-m",
                            "sonicdiffusionbayeslab_torch.utils.trace_analysis", str(d), "12"],
                           capture_output=True, text=True, timeout=300,
                           env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent)))
        if r.returncode != 0:
            raise AssertionError(f"trace_analysis exited {r.returncode}: {r.stderr[-2000:]}")
        rows = [m for m in map(pat.match, r.stdout.splitlines()) if m]
        got = {m.group(1): int(m.group(3)) for m in rows}
        ms = {m.group(1): float(m.group(2)) for m in rows}
        history.append(got)
        if got == want:
            break
        short = all(got.get(k, 0) <= n for k, n in want.items())
        print(f"trace {attempt} of {TRACE_ATTEMPTS} of the tools' trace: {got}, expected {want}; "
              f"short in some kind and over in none: {short}", flush=True)
        if not (short and np.array_equal(out, imgs)):
            break
    if got != want:
        raise AssertionError(f"trace_analysis counted {history}, census {want}")
    print(f"phase 16 (d) trace_analysis of one batch-2 run ({trace_s:.2f} s traced, trace "
          f"{attempt}):\n{r.stdout}", flush=True)
    eng = model.engine
    b = 2 * BATCH
    g = torch.Generator().manual_seed(18)
    x = torch.randn((b, SIZE // 8, SIZE // 8, 4), generator=g).cuda().to(eng.dtype)
    ctx = torch.randn((b, 77, 768), generator=g).cuda().to(eng.dtype)
    tb = torch.full((b,), 501.0, device="cuda")
    with torch.inference_mode():
        est = profiling.flops_estimate(eng.unet, x, tb, ctx)["flops"]
    shapes = meta_unet_flops(b)
    print(f"phase 16 (d) flops_estimate of one UNet forward at batch {b}: {est} "
          f"({est / 1e12:.4f} TFLOP); the count from shapes: {shapes}; {card}", flush=True)
    if est != shapes:
        raise AssertionError(f"flops_estimate {est} != the count from shapes {shapes}")
    return dict(trace_counts=got, trace_ms=ms, trace_attempts=attempt, trace_s=trace_s,
                flops_estimate=est, flops_from_shapes=shapes)


def run_multi_device(report, card):
    """Phase 16: (a) a one-rank NCCL group; (b) SD-1.5 data-parallel
    sampling and (c) LoRA training on DP_RANKS gloo ranks sharing the card,
    against one process; (d) the profiling tools.  Each part's wall clock
    and the ranks' memory peaks are printed."""
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel

    out = {}
    t0 = time.perf_counter()
    out["nccl"] = nccl_one_rank()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="sdbl_dp_") as tmp:
        root = Path(tmp)
        write_train_images(root)
        ranks, ranks_wall = run_dp_ranks(root)
        out["ranks"] = ranks
        out["ranks_wall_s"] = ranks_wall
        _, per_unet, per_vae = census(2 * BATCH)
        for r, rec in enumerate(ranks):
            s = rec["sampling"]
            print(f"phase 16 (b) rank {r}: 20-step loop {s['execution_time_s']:.4f} s, call "
                  f"{s['call_s']:.4f} s, peak {s['peak_gb']:.2f} GiB, first-run wrappers "
                  f"{s['first_run_wrapper_launches']}, traced {s['traced_launches']}; training "
                  f"{rec['training']['steps_per_sec']} steps/s, peak "
                  f"{rec['training']['peak_gb']:.2f} GiB; rank wall {rec['wall_s']:.1f} s; "
                  f"{card}", flush=True)
        t1 = time.perf_counter()
        model = StableDiffusionModel(image_size=SIZE, tiny=False, dtype="bfloat16", seed=0,
                                     device="cuda")
        out["rows"] = dp_reference_rows(model, root)
        out["rows_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out["tools"] = run_tools(model, per_unet, per_vae, root, card)
        out["tools_s"] = time.perf_counter() - t1
        del model
        t1 = time.perf_counter()
        one = dp_train(root, root / "train_images", root / "img2annotations_train_first16.json")
        out["training"] = dp_compare_training(root, one)
        out["training_s"] = time.perf_counter() - t1
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 16 wall clock: {out['wall_s']:.1f} s (NCCL {out['nccl']['wall_s']:.1f}, "
          f"ranks {ranks_wall:.1f}, one-process rows {out['rows_s']:.1f}, tools "
          f"{out['tools_s']:.1f}, one-process LoRA {out['training_s']:.1f}); {card}", flush=True)
    report["e2e"]["multi_device"] = out
    return out


def phase16_launches(out, kind):
    """A kernel's launches in phase 16: each rank's first-run wrappers and
    traced executions, and the tools' trace."""
    if kind not in MAIN:
        return {f"rank {r}": 0 for r in range(DP_RANKS)}
    group = {"attention": "flash_attention (ours)", "group_norm": "group_norm_silu (ours)"}[kind]
    res = {}
    for r, rec in enumerate(out["ranks"]):
        res[f"rank {r} first run wrappers"] = rec["sampling"]["first_run_wrapper_launches"][kind]
        res[f"rank {r} traced"] = rec["sampling"]["traced_launches"][kind]
        res[f"rank {r} LoRA run wrappers"] = rec["training"]["wrapper_launches"][kind]
    res["trace_analysis"] = out["tools"]["trace_counts"][group]
    return res


# ------------------------- tensor and sequence parallel on ranks sharing the card (phase 17)
# Gloo ranks share the one card (NCCL refuses two ranks on one GPU), so the
# phase shows correctness and launch counts; every time it prints is
# contention between processes, with the collectives through the host.
TP_NOTE = "contention on one card, gloo through the host: not scaling"
TP_WORLD = {"model": 2, "seq": 2, "both": 4, "sd3_model": 2, "sd3_seq": 2}
TP_MESH = {"model": dict(mesh_model=2), "seq": dict(mesh_seq=2),
           "both": dict(mesh_seq=2, mesh_model=2), "sd3_model": dict(mesh_model=2),
           "sd3_seq": dict(mesh_seq=2)}
# The SD-1.5 runs', the served request's and SD3's denoising steps (the
# phase cuts steps, never widths: a reduce crosses the host, and a rank's
# 20-step bf16 SD-1.5 loop took 17-29 s under model).
TP_SHORT_STEPS, SD3_TP_STEPS, SD3_T5_STEPS = 4, 2, 1
# Against one process: a forward's relative L2 (UNet, MMDiT, T5) and the
# images' mean |difference| on [0, 1], by dtype.  fp32 runs with TF32 off.
# T5-XXL with random weights (lecun-normal q and k, 8x T5's own q scale,
# and unscaled logits) amplifies any change of summation order with depth:
# on an H100 one process's fp32 encode moves 3.5e-2 (relative L2) when its
# channels are permuted (``permuted_t5_encode``), and its bf16 encode is
# far from its fp32 one.  So the split T5 is held block by block (each
# block on the one process's input to it, bf16 at block 0, fp32 at every
# block) with these gates, and its whole fp32 encode to T5_ORDER_FACTOR
# times the permuted encode's drift in the same run.  SD3's tight loops
# run on the CLIP context; the T5-conditioned one has the bf16 image gate.
TP_FORWARD_REL = {"float32": 1e-4, "bfloat16": 2e-2}
TP_IMAGE_MEAN = {"float32": 1e-3, "bfloat16": 5e-2}
T5_ORDER_FACTOR = 2.0
# The split GroupNorm's statistics merged from TP_SPLITS row slices against
# the same kernel's over all rows (the one-launch kernel's steps 1-4).
GN_STATS_REL, TP_SPLITS = 1e-6, (2, 4)
TP_TIMEOUT_S = 600
TP_SERVE_SEED = 170
SPLIT_GN = {
    "group_norm_partials": dict(name="group_norm_partials", route="cuda", dtype="bfloat16",
                                source="sonicdiffusionbayeslab_torch/ops/csrc/groupnorm.cu",
                                replaces="sonicdiffusionbayeslab_tpu/ops/groupnorm.py:27"),
    "group_norm_apply": dict(name="group_norm_apply", route="cuda", dtype="bfloat16",
                             source="sonicdiffusionbayeslab_torch/ops/csrc/groupnorm.cu",
                             replaces="sonicdiffusionbayeslab_tpu/ops/groupnorm.py:27"),
}


def split_gn_counts(reset=False):
    """The split GroupNorm wrappers' launch counts."""
    from sonicdiffusionbayeslab_torch.ops.groupnorm import group_norm_apply, group_norm_partials

    wrappers = {"group_norm_partials": group_norm_partials, "group_norm_apply": group_norm_apply}
    if reset:
        for w in wrappers.values():
            w.launches = 0
    return {k: w.launches for k, w in wrappers.items()}


def all_counts(reset=False):
    return {**wrapper_counts(reset), **split_gn_counts(reset)}


def split_gn_bound(kind, B, N, C, G, silu, dtype):
    """(least ms, "bytes" | "operations") of one split-GroupNorm launch on a
    rank's [B, N, C]: the partials read x and write [B, G, 3] fp32, ~4
    operations an element; the apply reads x, the statistics, gamma and
    beta and writes y, ~2 operations an element (6 with the SiLU)."""
    size = torch.tensor([], dtype=dtype).element_size()
    if kind == "group_norm_partials":
        nbytes, ops = B * N * C * size + 12 * B * G, 4 * B * N * C
    else:
        nbytes, ops = 2 * B * N * C * size + 2 * C * size + 8 * B * G, (6 if silu else 2) * B * N * C
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FLOPS[torch.float32] * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def split_pair(x, w, b, G, eps, silu, n):
    """The split GroupNorm pair in one process as ``n`` seq ranks run it on
    ``x``'s rows cut in ``n`` slices: each slice's partials, gathered in
    row order, merged and applied to each slice by the apply kernel;
    (output, the statistics the kernel merged, the gathered partials).
    Raises unless every slice's apply merged the same bits, as every rank
    must."""
    from sonicdiffusionbayeslab_torch.ops.groupnorm import group_norm_apply, group_norm_partials

    slices = [s.contiguous() for s in x.chunk(n, dim=1)]
    parts = torch.stack([group_norm_partials(s, G) for s in slices])
    ys, stats = zip(*(group_norm_apply(s, parts, w, b, eps, silu, return_stats=True)
                      for s in slices))
    if not all(torch.equal(st, stats[0]) for st in stats[1:]):
        raise AssertionError(f"split GroupNorm {tuple(x.shape)} in {n} slices: the slices' "
                             "applies merged different statistics")
    return torch.cat(ys, dim=1), stats[0], parts


def check_split_group_norm(unet_calls):
    """Phase 17 (a): the split GroupNorm pair at every GroupNorm shape of the
    SD-1.5 UNet at batch 2 * BATCH, its rows cut in 2 and 4 slices (one
    process), bf16 and fp32: the statistics the apply kernel merged from
    the slices' partials within GN_STATS_REL (relative) of the same
    kernels' over all rows and of ``merge_group_stats`` of the same
    partials, and within the plain partials' merge; the output against
    ``plain_group_norm`` with the GroupNorm gates; each kernel launched
    twice on one input at a rank's shape, bit-equal.  Then each kernel
    timed at a rank's shape of n_seq 2 (bf16; the apply on the two ranks'
    gathered partials), beside its plain version, ``torch.var_mean`` (the
    partials' library call) and the bound, with its launch plan; totals
    are per-shape medians x the launches at that shape in one rank's
    seq-split batch-2 run."""
    from sonicdiffusionbayeslab_torch.ops.groupnorm import (apply_plan, card_partials_plan,
                                                            group_norm_apply,
                                                            group_norm_partials, merge_group_stats,
                                                            plain_group_norm,
                                                            plain_group_norm_apply,
                                                            plain_group_norm_partials)

    gen = torch.Generator(device="cuda").manual_seed(17)
    shapes = sorted(s for k, s in unet_calls if k == "group_norm")
    out = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   bound_by=collections.Counter(), launches_a_forward=0) for k in SPLIT_GN}
    stats_rel = merge_rel = 0.0
    merge_bit_equal, repeats = True, 0
    timings = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape in shapes:
            B, N, C, G, eps, silu = shape
            x, w, b = gn_inputs(shape, dtype, gen)
            whole = group_norm_apply(x, group_norm_partials(x, G)[None], w, b, eps, silu,
                                     return_stats=True)[1]
            want = plain_group_norm(x, w, b, G, eps, silu)
            for n in TP_SPLITS:
                slices = [s.contiguous() for s in x.chunk(n, dim=1)]
                y, stats, parts = split_pair(x, w, b, G, eps, silu, n)
                rel = ((stats - whole).abs() / whole.abs()).max().item()
                stats_rel = max(stats_rel, rel)
                if rel > GN_STATS_REL:
                    raise AssertionError(f"split GroupNorm {shape} in {n} slices, {dtype}: merged "
                                         f"statistics {rel:.3e} from all rows' (relative)")
                torch_merge = merge_group_stats(parts, eps)
                merge_bit_equal &= torch.equal(stats, torch_merge)
                rel = ((stats - torch_merge).abs() / torch_merge.abs()).max().item()
                merge_rel = max(merge_rel, rel)
                if rel > GN_STATS_REL:
                    raise AssertionError(f"split GroupNorm {shape} in {n} slices, {dtype}: the "
                                         f"kernel's merge {rel:.3e} from merge_group_stats' "
                                         "(relative)")
                plain = merge_group_stats(torch.stack([plain_group_norm_partials(s, G)
                                                       for s in slices]), eps)
                p_err = (stats - plain).abs().max().item()
                a_err = compare("group_norm", dtype, y, want,
                                f"split GroupNorm {shape} in {n} slices, {dtype}")
                out["group_norm_partials"]["max_abs_err"] = max(
                    out["group_norm_partials"]["max_abs_err"], p_err)
                out["group_norm_apply"]["max_abs_err"] = max(out["group_norm_apply"]["max_abs_err"],
                                                             a_err)
            xs = x[:, :N // 2].contiguous()
            parts2 = torch.stack([group_norm_partials(s.contiguous(), G)
                                  for s in x.chunk(2, dim=1)])
            twice = [(group_norm_partials(xs, G), group_norm_apply(xs, parts2, w, b, eps, silu))
                     for _ in range(2)]
            if not all(torch.equal(u, v) for u, v in zip(*twice)):
                raise AssertionError(f"split GroupNorm {shape}, {dtype}: two launches on one "
                                     "input differ")
            repeats += 1
            if dtype != torch.bfloat16:
                continue
            launches = unet_calls[("group_norm", shape)]
            pp = card_partials_plan(B, N // 2, C, G, 1, True)  # 1: bfloat16
            ap = apply_plan(B, N // 2, C, xs.element_size())
            plans = {
                "group_norm_partials": (f"ranges of {pp.channels} channels x {pp.ranges}, "
                                        f"split {pp.split}, {pp.ctas} CTAs of {pp.threads} "
                                        f"threads ({pp.row_lanes} lanes), {pp.smem} B"),
                "group_norm_apply": (f"{ap.tiles} tiles of {ap.tile_rows} rows x {B}, "
                                     f"{ap.ctas} CTAs of {ap.threads} threads "
                                     f"({ap.row_lanes} lanes)"),
            }
            calls = {
                "group_norm_partials": (lambda: group_norm_partials(xs, G),
                                        lambda: plain_group_norm_partials(xs, G),
                                        lambda: torch.var_mean(xs.view(B, -1, G, C // G),
                                                               dim=(1, 3))),
                "group_norm_apply": (lambda: group_norm_apply(xs, parts2, w, b, eps, silu),
                                     lambda: plain_group_norm_apply(xs, parts2, w, b, eps, silu),
                                     None),
            }
            for kind, (kern, plain_fn, lib) in calls.items():
                ms, plain_ms = cuda_ms(kern), cuda_ms(plain_fn)
                lib_ms = cuda_ms(lib) if lib is not None else None
                b_ms, by = split_gn_bound(kind, B, N // 2, C, G, silu, dtype)
                r = out[kind]
                r["ms"] += STEPS * launches * ms
                r["plain_ms"] += STEPS * launches * plain_ms
                r["bound_ms"] += STEPS * launches * b_ms
                r["bound_by"][by] += STEPS * launches * b_ms
                if lib_ms is not None:
                    r["library_ms"] += STEPS * launches * lib_ms
                r["launches_a_forward"] += launches
                timings.append(dict(kernel=kind, shape=[B, N // 2, C, G], launches=launches,
                                    ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                                    bound_by=by, plan=plans[kind]))
                print(f"phase 17 (a) {kind} bf16 {B},{N // 2},{C} (G {G}) x{launches} a forward: "
                      f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, library "
                      f"{'-' if lib_ms is None else f'{lib_ms * 1e3:.1f} us'}, bound "
                      f"{b_ms * 1e3:.1f} us ({by}); {plans[kind]}", flush=True)
    for r in out.values():
        r["bound_by"] = max(r["bound_by"], key=r["bound_by"].get)
    out["group_norm_apply"]["library_ms"] = None  # no one call applies given statistics
    print(f"phase 17 (a) split GroupNorm: merged statistics within {stats_rel:.3e} (relative) "
          f"of all rows' over {len(shapes)} shapes x {TP_SPLITS} slices x bf16/fp32; the "
          f"kernel's merge within {merge_rel:.3e} of merge_group_stats' (bit-equal: "
          f"{merge_bit_equal}); two launches bit-equal at {repeats} rank shapes; max abs err "
          f"partials {out['group_norm_partials']['max_abs_err']:.3e}, apply "
          f"{out['group_norm_apply']['max_abs_err']:.3e}; totals over one rank's run: "
          + json.dumps({k: {f: r[f] for f in ('ms', 'plain_ms', 'bound_ms', 'library_ms')}
                        for k, r in out.items()}), flush=True)
    return dict(kernels=out, stats_rel=stats_rel, merge_rel=merge_rel,
                merge_bit_equal=merge_bit_equal, bit_equal_repeats=repeats, timings=timings)


def rel_l2(got, want):
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


class recording_kernel_shapes:
    """A context in which every attention, GroupNorm and split-GroupNorm
    call of the UNet's, the MMDiT's and their layers' adds its shape to
    the set ``shapes`` and goes on unchanged: ("attention", (B, N, M, H,
    D)) for a call the kernel takes, ("group_norm", (B, N, C, G, eps,
    silu)) and ("group_norm_split", (B, N, C, G, eps, silu, ranks))."""

    def __init__(self, shapes):
        self.shapes = shapes

    def __enter__(self):
        import torch.distributed as dist

        from sonicdiffusionbayeslab_torch.models import layers, mmdit
        from sonicdiffusionbayeslab_torch.ops.attention import uses_kernel
        from sonicdiffusionbayeslab_torch.ops.groupnorm import resolve_groups

        self.saved = (layers.dot_product_attention, mmdit.dot_product_attention,
                      layers.group_norm_silu, layers.group_norm_silu_split)
        attn_fn, _, gn_fn, split_fn = self.saved
        add = self.shapes.add

        def rows(x, groups, eps, silu):
            B, C = x.shape[0], x.shape[-1]
            return (B, x.numel() // (B * C), C, resolve_groups(C, groups), eps, bool(silu))

        def attn(q, k, v, mask=None):
            if uses_kernel(q, mask):
                add(("attention", (*q.shape[:2], k.shape[1], *q.shape[2:])))
            return attn_fn(q, k, v, mask=mask)

        def gn(x, weight, bias, groups=32, eps=1e-5, silu=True):
            add(("group_norm", rows(x, groups, eps, silu)))
            return gn_fn(x, weight, bias, groups, eps, silu)

        def split(x, weight, bias, groups, eps, silu, group):
            add(("group_norm_split", rows(x, groups, eps, silu) + (dist.get_world_size(group),)))
            return split_fn(x, weight, bias, groups, eps, silu, group)

        layers.dot_product_attention = mmdit.dot_product_attention = attn
        layers.group_norm_silu, layers.group_norm_silu_split = gn, split
        return self.shapes

    def __exit__(self, *exc):
        from sonicdiffusionbayeslab_torch.models import layers, mmdit

        (layers.dot_product_attention, mmdit.dot_product_attention, layers.group_norm_silu,
         layers.group_norm_silu_split) = self.saved


def check_split_shapes(ranks):
    """Phase 17 (a, split shapes): each kernel at every shape rank 0 of each
    mode launched in its UNet or MMDiT forwards (``kernel_shapes``), bf16
    and fp32, against its plain version with ``compare``'s gates: the
    attention kernels on a model rank's heads and on a seq rank's queries
    against the gathered keys (N != M); the one-launch GroupNorm on a model
    rank's channels and groups; the split pair on a seq rank's rows, cut
    from a whole map of ``ranks`` times its rows and held to
    ``plain_group_norm`` of the whole.  Raises if a mode recorded none of
    the kinds its split launches; returns the max abs errors by kernel and
    dtype and the shapes by kind."""
    from sonicdiffusionbayeslab_torch.ops.groupnorm import plain_group_norm

    want_kinds = {"model": {"attention", "group_norm"}, "seq": {"attention", "group_norm_split"},
                  "both": {"attention", "group_norm_split"}, "sd3_model": {"attention"},
                  "sd3_seq": {"attention"}}
    shapes = set()
    for mode, recs in ranks.items():
        got = {(kind, tuple(shape)) for kind, shape in recs[0]["kernel_shapes"]}
        missing = want_kinds[mode] - {kind for kind, _ in got}
        if missing:
            raise AssertionError(f"phase 17 {mode}: rank 0 recorded no {sorted(missing)} shape")
        shapes |= got
    gen = torch.Generator(device="cuda").manual_seed(171)
    errs = collections.defaultdict(float)
    for dtype in (torch.bfloat16, torch.float32):
        tag = "" if dtype == torch.bfloat16 else "_fp32"
        for kind, shape in sorted(shapes):
            what = f"phase 17 {kind} {shape} {dtype}"
            if kind == "group_norm_split":
                B, N, C, G, eps, silu, n = shape
                x, w, b = gn_inputs((B, n * N, C), dtype, gen)
                got = split_pair(x, w, b, G, eps, silu, n)[0]
                err = compare("group_norm", dtype, got, plain_group_norm(x, w, b, G, eps, silu),
                              what)
            else:
                inputs = (attn_inputs if kind == "attention" else gn_inputs)(shape, dtype, gen)
                kern, plain = run_kernel(kind, shape, inputs)
                err = compare(kind, dtype, kern(), plain(), what)
            errs[kind + tag] = max(errs[kind + tag], err)
        torch.cuda.empty_cache()
    by_kind = collections.defaultdict(list)
    for kind, shape in sorted(shapes):
        by_kind[kind].append(list(shape))
    print(f"phase 17 (a) the kernels at the split modes' {len(shapes)} shapes x bf16/fp32 against "
          f"their plain versions: max abs err {json.dumps(dict(errs))}; shapes "
          f"{json.dumps(by_kind)}", flush=True)
    return dict(max_abs_err=dict(errs), shapes=by_kind)


def seq_drift_parts(unet, inp):
    """One process's bf16 UNet forward on the fixed inputs against itself
    with one numerical change of the seq split emulated in the process
    (relative L2 of the output): "batch_halves", the batch as two calls
    (other GEMM and conv algorithms, nothing split); "conv", every conv on
    two row halves, each with the halo rows its padding reads (stride 2:
    only the row above), as two seq ranks run it; "group_norm", every
    GroupNorm as the split pair over two row halves; "attention", every
    attention as two halves of the queries against all the keys; "all",
    the three at once."""
    import torch.nn.functional as F

    from sonicdiffusionbayeslab_torch.models import layers

    orig = {"conv_padded": layers.conv_padded, "group_norm_silu": layers.group_norm_silu,
            "dot_product_attention": layers.dot_product_attention}

    def conv(conv_, x, padding=((1, 1), (1, 1)), bias=True):
        (top, bottom), lr = padding
        stride, h = conv_.stride[0], x.shape[1] // 2
        bottom_read = 0 if stride == 2 else bottom
        xp = F.pad(x, (0, 0, 0, 0, top, bottom))
        return torch.cat([orig["conv_padded"](conv_, xp[:, r * h:(r + 1) * h + top + bottom_read],
                                              ((0, 0), lr), bias) for r in (0, 1)], dim=1)

    def gn(x, weight, bias, groups=32, eps=1e-5, silu=True):
        from sonicdiffusionbayeslab_torch.ops.groupnorm import resolve_groups

        return split_pair(x, weight, bias, resolve_groups(x.shape[-1], groups), eps, silu, 2)[0]

    def attn(q, k, v, mask=None):
        return torch.cat([orig["dot_product_attention"](h.contiguous(), k, v, mask=mask)
                          for h in q.chunk(2, dim=1)], dim=1)

    emul = {"conv": ("conv_padded", conv), "group_norm": ("group_norm_silu", gn),
            "attention": ("dot_product_attention", attn)}
    args = (inp["x"].to(unet.dtype), inp["t"], inp["ctx"].to(unet.dtype))

    def forward(*a):
        with torch.inference_mode():
            return unet(*a).float()

    base = forward(*args)
    half = args[0].shape[0] // 2
    out = {"batch_halves": rel_l2(torch.cat([forward(*(t[:half] for t in args)),
                                             forward(*(t[half:] for t in args))]), base)}
    for name, parts in [(k, [k]) for k in emul] + [("all", list(emul))]:
        try:
            for part in parts:
                setattr(layers, *emul[part])
            out[name] = rel_l2(forward(*args), base)
        finally:
            for attr, fn in orig.items():
                setattr(layers, attr, fn)
    return out


def t5_block_states(t5, ids):
    """[L + 1, B, T, d_model] on the host: the hidden states entering each
    of T5's blocks and leaving the last (before the final norm)."""
    x, bias = t5.shared(ids), t5.position_bias(ids.shape[1], ids.device)
    states = [x.float().cpu()]
    for blk in t5.encoder.block:
        x = blk(x, bias)
        states.append(x.float().cpu())
    return torch.stack(states)


def t5_block_drift(t5, states):
    """Each of T5's (split) blocks run on the one-process input to it
    (``states``, as ``t5_block_states`` gives them): its update (output
    minus input) against the one process's, relative L2, a block each."""
    dev = t5.shared.weight.device
    bias = t5.position_bias(states.shape[2], dev)
    out = []
    for i, blk in enumerate(t5.encoder.block):
        x = states[i].to(dev, t5.shared.weight.dtype)
        out.append(rel_l2(blk(x, bias).float().cpu() - states[i], states[i + 1] - states[i]))
    return out


def permuted_t5_encode(t5, ids, seed=17):
    """T5's encode of ``ids`` as the same function with d_model, d_ff and
    the heads permuted (each weight's rows and columns, the norms' scales
    and the bias table's columns moved alike), so that every contraction
    sums in another order; returned in the original channel order.
    Permutes ``t5``'s weights in place."""
    cfg, dev = t5.config, t5.shared.weight.device
    gen = torch.Generator().manual_seed(seed)
    p_d, p_ff, p_h = (torch.randperm(n, generator=gen) for n in
                      (cfg.d_model, cfg.d_ff, cfg.num_heads))
    p_inner = (p_h[:, None] * cfg.d_kv + torch.arange(cfg.d_kv)).flatten()
    p_d, p_ff, p_h, p_inner = (t.to(dev) for t in (p_d, p_ff, p_h, p_inner))

    def take(mod, dim, idx):
        mod.weight.data = mod.weight.data.index_select(dim, idx)

    take(t5.shared, 1, p_d)
    for blk in t5.encoder.block:
        attn, ff = blk.layer
        sa, mlp = attn.SelfAttention, ff.DenseReluDense
        for norm in (attn.layer_norm, ff.layer_norm):
            take(norm, 0, p_d)
        for lin in (sa.q, sa.k, sa.v):
            take(lin, 1, p_d)
            take(lin, 0, p_inner)
        take(sa.o, 0, p_d)
        take(sa.o, 1, p_inner)
        if hasattr(sa, "relative_attention_bias"):
            take(sa.relative_attention_bias, 1, p_h)
        for lin in (mlp.wi_0, mlp.wi_1):
            take(lin, 1, p_d)
            take(lin, 0, p_ff)
        take(mlp.wo, 0, p_d)
        take(mlp.wo, 1, p_ff)
    take(t5.encoder.final_layer_norm, 0, p_d)
    return t5(ids).index_select(-1, torch.argsort(p_d))


def tp_references(root):
    """The one-process runs the split ones are held to: SD-1.5 (random
    weights from seed 0) one UNet forward at batch 2 * BATCH on fixed
    inputs and images at batch BATCH (seed 29), fp32 (TF32 off,
    TP_SHORT_STEPS steps) and bf16 (TP_SHORT_STEPS steps);
    SD3-medium with T5-XXL (``sd3_tp_runs``).  Inputs and outputs go to
    ``root``.  Returns the seconds each took and one process's own drift
    (``seq_drift_parts``; bf16 against fp32; T5's permuted encode)."""
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
    from sonicdiffusionbayeslab_torch.models.t5 import T5Config

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(170)
    lat = SIZE // 8
    inp = dict(x=torch.randn(2 * BATCH, lat, lat, 4, generator=gen, device="cuda"),
               t=torch.full((2 * BATCH,), 501.0, device="cuda"),
               ctx=torch.randn(2 * BATCH, 77, 768, generator=gen, device="cuda"))
    torch.save({k: v.cpu() for k, v in inp.items()}, root / "tp_inputs.pt")
    refs = {}
    kw = dict(guidance_scale=GUIDANCE, seed=29)
    for dtype in ("float32", "bfloat16"):
        torch.backends.cudnn.allow_tf32 = dtype != "float32"
        model = StableDiffusionModel(image_size=SIZE, dtype=dtype, seed=0, device="cuda")
        dt = model.engine.dtype
        with torch.inference_mode():
            refs[f"{dtype}_forward"] = model.engine.unet(
                inp["x"].to(dt), inp["t"], inp["ctx"].to(dt)).float().cpu()
        if dtype == "bfloat16":
            drift = seq_drift_parts(model.engine.unet, inp)
        refs[f"{dtype}_images"] = torch.from_numpy(model(
            PROMPTS, num_inference_steps=TP_SHORT_STEPS, **kw)[0])
        del model
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    torch.save(refs, root / "tp_refs.pt")
    drift["bf16_vs_fp32"] = rel_l2(refs["bfloat16_forward"], refs["float32_forward"])
    sd15_s = time.perf_counter() - t0

    cfg = T5Config.xxl()
    sd3_lat = SD3_SIZE // 8
    sinp = dict(ids=torch.randint(0, cfg.vocab_size, (2, cfg.max_length), generator=gen,
                                  device="cuda").cpu(),
                t5_h=torch.randn(2, cfg.max_length, cfg.d_model, generator=gen, device="cuda").cpu(),
                x=torch.randn(2, sd3_lat, sd3_lat, 16, generator=gen, device="cuda").cpu(),
                t=torch.full((2,), 700.0),
                ctx=torch.randn(2, 77 + cfg.max_length, cfg.d_model, generator=gen,
                                device="cuda").cpu(),
                pooled=torch.randn(2, 2048, generator=gen, device="cuda").cpu())
    torch.save(sinp, root / "tp_sd3_inputs.pt")
    sd3_refs = sd3_tp_runs(None, root)[1]
    torch.save(sd3_refs, root / "tp_sd3_refs.pt")
    gc.collect()
    torch.cuda.empty_cache()
    # One process's own rounding, beside the split's drift: its bf16
    # forward against its fp32 one, and the split's changes emulated one at
    # a time (SD-1.5); T5's fp32 encode against the same function with
    # every contraction reordered.
    drift.update(mmdit_bf16_vs_fp32=rel_l2(sd3_refs["bfloat16_forward"], sd3_refs["float32_forward"]),
                 t5_permuted=rel_l2(sd3_refs["t5_permuted"], sd3_refs["t5"]))
    print(f"phase 17 one process's own drift (relative L2): {json.dumps(drift)}", flush=True)
    return dict(sd15_s=sd15_s, sd3_s=time.perf_counter() - t0 - sd15_s), drift


def t5_xxl():
    """T5-XXL's encoder on the card in bf16 with random weights from a fixed
    seed (``init_module``'s families), built on the meta device so that no
    fp32 copy is ever allocated."""
    from sonicdiffusionbayeslab_torch.models.sampler import init_module
    from sonicdiffusionbayeslab_torch.models.t5 import T5Config, T5Encoder

    with torch.device("meta"):
        t5 = T5Encoder(T5Config.xxl()).to(torch.bfloat16)
    t5 = t5.to_empty(device="cuda").requires_grad_(False).eval()
    init_module(t5, torch.Generator(device="cuda").manual_seed(5))
    return t5


def sd3_tp_runs(mode, root):
    """Phase 17 (d) in one process (``mode`` None) or split by ``mode`` on
    this rank; returns (record, outputs).  T5-XXL (not for ``sd3_seq``,
    which does not split it) as a module: block 0 on fixed hidden states
    in bf16, then cast to fp32 (TF32 off), block 0 again and one encode of
    the fixed ids; one process keeps the hidden states entering each block
    and encodes once more with its channels permuted
    (``permuted_t5_encode``), a split rank runs each block on the one
    process's input to it (``t5_block_drift``).  SD3-medium (random bf16
    weights from seed 0, CLIP context: a T5-conditioned run would only
    carry T5's drift, see TP_FORWARD_REL): one bf16 MMDiT forward at batch
    2 on the fixed inputs (its patch rows; the seq axis's gathered), with
    its kernel shapes, one SD3_TP_STEPS-step run of one prompt (CFG: model
    batch 2) with its launches, then the MMDiT cast to fp32 and one more
    forward.  Then, but for ``sd3_seq``, the T5-conditioned pipeline (T5
    resident) for SD3_T5_STEPS steps of the same prompt."""
    from sonicdiffusionbayeslab_torch.parallel import distributed
    from sonicdiffusionbayeslab_torch.parallel import mesh as M

    inp = {k: v.cuda() for k, v in torch.load(root / "tp_sd3_inputs.pt").items()}
    mesh_kw = TP_MESH[mode] if mode else {}
    torch.cuda.reset_peak_memory_stats()
    rec, outs, shapes = {}, {}, set()
    if mode != "sd3_seq":
        t0 = time.perf_counter()
        t5 = t5_xxl()
        if mode is not None:
            M.place_module(t5, M.ParallelContext.from_mesh(M.make_mesh(n_data=1, n_model=2)))
        blk, T = t5.encoder.block[0], inp["ids"].shape[1]
        with torch.inference_mode():
            outs["t5_block_bfloat16"] = blk(inp["t5_h"].to(torch.bfloat16),
                                            t5.position_bias(T, "cuda")).float().cpu()
            t5.float()
            torch.backends.cudnn.allow_tf32 = False
            outs["t5_block_float32"] = blk(inp["t5_h"], t5.position_bias(T, "cuda")).cpu()
            outs["t5"] = t5(inp["ids"]).cpu()
            if mode is None:
                torch.save(t5_block_states(t5, inp["ids"]), root / "tp_t5_states.pt")
                outs["t5_permuted"] = permuted_t5_encode(t5, inp["ids"]).cpu()
            else:
                rec["t5_blocks_rel_l2"] = t5_block_drift(t5, torch.load(root / "tp_t5_states.pt"))
            torch.backends.cudnn.allow_tf32 = True
        rec["t5_s"] = time.perf_counter() - t0
        del t5, blk
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pipe = sd3_pipeline(image_size=SD3_SIZE, seed=0, device="cuda", **mesh_kw)
    eng = pipe.engine
    rec["init_s"] = time.perf_counter() - t0
    par = eng.par
    rows = M.latent_sharding(pipe.mesh, eng.unet.seq_multiple).height.rows(SD3_SIZE // 8)
    rec["latent_rows"] = [rows.start or 0, rows.stop or SD3_SIZE // 8]

    def forward(dtype):
        t1 = time.perf_counter()
        with torch.inference_mode(), recording_kernel_shapes(shapes):
            out = eng.unet(inp["x"][:, rows].to(dtype), inp["t"], inp["ctx"].to(dtype),
                           text_embeds=inp["pooled"].to(dtype))
            if par is not None and par.n_seq > 1:
                out = distributed.all_gather_seq(out, 1, par.seq_group)
        torch.cuda.synchronize()
        rec[f"{str(dtype)[6:]}_forward_s"] = time.perf_counter() - t1
        outs[f"{str(dtype)[6:]}_forward"] = out.float().cpu()

    forward(torch.bfloat16)
    all_counts(reset=True)
    t1 = time.perf_counter()
    imgs, rec["execution_time_s"], _ = pipe(PROMPTS[:1], num_inference_steps=SD3_TP_STEPS,
                                            guidance_scale=SD3_GUIDANCE, seed=29)
    rec["call_s"] = time.perf_counter() - t1
    rec["launches"] = all_counts()
    outs["images"] = torch.from_numpy(imgs)
    eng.unet.float()
    torch.backends.cudnn.allow_tf32 = False
    forward(torch.float32)
    torch.backends.cudnn.allow_tf32 = True
    del pipe, eng
    gc.collect()
    torch.cuda.empty_cache()
    if mode != "sd3_seq":
        t0 = time.perf_counter()
        pipe = sd3_pipeline(image_size=SD3_SIZE, seed=0, device="cuda", use_t5=True,
                            t5_staged=False, **mesh_kw)
        all_counts(reset=True)
        imgs, _, _ = pipe(PROMPTS[:1], num_inference_steps=SD3_T5_STEPS,
                          guidance_scale=SD3_GUIDANCE, seed=29)
        rec["t5_launches"] = all_counts()
        rec["t5_pipeline_s"] = time.perf_counter() - t0
        outs["t5_images"] = torch.from_numpy(imgs)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    rec["kernel_shapes"] = sorted([kind, list(shape)] for kind, shape in shapes)
    return rec, outs


def tp_census(mode, dtype, steps, per_unet, per_vae):
    """A rank's launches in a ``steps``-step batch-BATCH SD-1.5 run of
    ``mode``: the one-process census restated (the attention kernel of the
    dtype at the local shapes; under seq the split pair for every UNet
    GroupNorm and the one-launch kernel for the VAE's)."""
    attn = "attention" if dtype == "bfloat16" else "attention_fp32"
    seq = TP_MESH[mode].get("mesh_seq", 1) > 1
    gn = steps * per_unet["group_norm"]
    want = dict(attention=0, attention_fp32=0, group_norm=per_vae["group_norm"] + (0 if seq else gn),
                group_norm_partials=gn if seq else 0, group_norm_apply=gn if seq else 0)
    want[attn] = steps * per_unet["attention"]
    return want


def tp_serve(model, rank):
    """Phase 17 (e): on rank 0 ``serving.server.serve`` (port 0, max_batch 1)
    answers one /generate request while rank 1 follows
    (``serving.batcher.follow``); then both ranks call the pipeline
    directly with the batch the server made, and rank 0 holds the served
    PNG to the device round of that call, bit for bit."""
    import threading
    import urllib.request

    import numpy as np

    from sonicdiffusionbayeslab_torch.serving.batcher import follow, quantize_uint8
    from sonicdiffusionbayeslab_torch.serving.server import serve

    rec = {}
    t0 = time.perf_counter()
    if rank == 0:
        ready = threading.Event()
        th = threading.Thread(target=serve, args=(model, "stable_diffusion_model"), daemon=True,
                              kwargs=dict(host="127.0.0.1", port=0, max_batch=1,
                                          max_wait_ms=5.0, pipeline_depth=1, ready_event=ready))
        th.start()
        if not ready.wait(timeout=120):
            raise AssertionError("the server did not start")
        body = {"prompt": PROMPTS[0], "steps": TP_SHORT_STEPS, "guidance": GUIDANCE,
                "seed": TP_SERVE_SEED}
        req = urllib.request.Request(
            f"http://127.0.0.1:{ready.httpd.server_address[1]}/generate",
            data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                resp = json.loads(r.read())
        finally:
            ready.httpd.shutdown()
            th.join(timeout=300)
        served = _decode_png(resp["image_png_base64"])
        rec["batch_size"] = resp["batch_size"]
    else:
        rec["follower_calls"] = follow(model)
    rec["serve_s"] = time.perf_counter() - t0
    imgs, _, _ = model([PROMPTS[0]], num_inference_steps=TP_SHORT_STEPS,
                       guidance_scale=GUIDANCE, negative_prompt=[""],
                       sample_indices=[2 * TP_SERVE_SEED + 1], seed=0, output_type="device",
                       time_loop=False)
    direct = quantize_uint8(imgs).cpu().numpy()[0]
    if rank == 0:
        rec["bit_equal"] = bool(np.array_equal(direct, served))
    return rec


def tp_rank_sd15(rank, mode, root, per_unet, per_vae):
    """A rank of an SD-1.5 mode: for fp32 (TF32 off) and bf16, the pipeline
    split by the mode, one UNet forward on the fixed inputs (its rows; the
    seq axis's gathered) and one TP_SHORT_STEPS-step run with its
    launches (the four ranks: bf16 only); the served request under
    ``model``."""
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
    from sonicdiffusionbayeslab_torch.parallel import distributed
    from sonicdiffusionbayeslab_torch.parallel import mesh as M

    inp = {k: v.cuda() for k, v in torch.load(root / "tp_inputs.pt").items()}
    rec, saves, shapes = {}, {}, set()
    for dtype in ("float32", "bfloat16"):
        torch.backends.cudnn.allow_tf32 = dtype != "float32"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = StableDiffusionModel(image_size=SIZE, dtype=dtype, seed=0, device="cuda",
                                     **TP_MESH[mode])
        init_s = time.perf_counter() - t0
        unet, par = model.engine.unet, model.engine.par
        rows = M.latent_sharding(model.mesh, unet.seq_multiple).height.rows(SIZE // 8)
        held = sum(p.numel() for p in unet.parameters())
        t0 = time.perf_counter()
        with torch.inference_mode(), recording_kernel_shapes(shapes):
            out = unet(inp["x"][:, rows].to(unet.dtype), inp["t"], inp["ctx"].to(unet.dtype))
            if par.n_seq > 1:
                out = distributed.all_gather_seq(out, 1, par.seq_group)
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        saves[f"{dtype}_forward"] = out.float().cpu()
        steps = TP_SHORT_STEPS
        if mode == "both" and dtype == "float32":  # the four ranks' run is bf16 only
            rec[dtype] = dict(init_s=init_s, forward_s=forward_s, unet_params=held)
            del model, unet, par
            continue
        all_counts(reset=True)
        t0 = time.perf_counter()
        imgs, exec_time, _ = model(PROMPTS, num_inference_steps=steps, guidance_scale=GUIDANCE,
                                   seed=29)
        call_s = time.perf_counter() - t0
        counts = all_counts()
        saves[f"{dtype}_images"] = torch.from_numpy(imgs)
        rec[dtype] = dict(init_s=init_s, forward_s=forward_s, execution_time_s=exec_time,
                          call_s=call_s, steps=steps, launches=counts, unet_params=held,
                          latent_rows=[rows.start or 0, rows.stop or SIZE // 8],
                          census=tp_census(mode, dtype, steps, per_unet, per_vae),
                          peak_gb=torch.cuda.max_memory_allocated() / 2**30)
        if mode == "model" and dtype == "bfloat16":
            rec["served"] = tp_serve(model, rank)
        del model, unet, par
    torch.backends.cudnn.allow_tf32 = True
    torch.save(saves, root / f"tp_{mode}_rank{rank}.pt")
    rec["kernel_shapes"] = sorted([kind, list(shape)] for kind, shape in shapes)
    return rec


def tp_rank_sd3(rank, mode, root):
    """A rank of an SD3 mode: ``sd3_tp_runs`` split by the mode."""
    rec, outs = sd3_tp_runs(mode, root)
    torch.save(outs, root / f"tp_{mode}_rank{rank}.pt")
    return {"bfloat16": rec, "kernel_shapes": rec.pop("kernel_shapes")}


def tp_rank(rank, mode, addr, root, spawned, go_at):
    """One rank of phase 17, run as its own process (``--tp-rank``): a gloo
    group of TP_WORLD[mode] ranks on the card, the mode's runs, its record
    in ``tp_<mode>_rank<r>.json``."""
    import torch.distributed as dist

    from sonicdiffusionbayeslab_torch.parallel import distributed

    root = Path(root)
    t_start = time.perf_counter()
    startup = dict(imports=_IMPORTED_AT - spawned, to_work=time.time() - go_at)
    distributed.initialize(coordinator=addr, num_processes=TP_WORLD[mode], process_id=rank,
                           backend="gloo", device="cuda")
    if mode.startswith("a9b"):
        rec = a9b_rank(rank, mode, root)
    elif mode.startswith("sd3"):
        rec = tp_rank_sd3(rank, mode, root)
    else:
        _, per_unet, per_vae = census(2 * BATCH)
        rec = tp_rank_sd15(rank, mode, root, per_unet, per_vae)
    rec["wall_s"] = time.perf_counter() - t_start
    rec["startup_s"], rec["done_at"] = startup, time.time()
    print(f"phase 17 {mode} rank {rank}: {json.dumps(rec)}", flush=True)
    (root / f"tp_{mode}_rank{rank}.json").write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


def run_tp_ranks(root, modes, during=None):
    """Each mode's TP_WORLD[mode] processes of this script (``--tp-rank``),
    all modes at once, each rank's output in ``tp_<mode>_rank<r>.log``;
    ``during()`` runs in this process while they do; every rank must exit
    0 within TP_TIMEOUT_S, and every process is stopped."""
    procs, logs = [], {}
    t0 = time.perf_counter()
    try:
        for mode in modes:
            addr = f"localhost:{_free_port()}"
            for r in range(TP_WORLD[mode]):
                p, logs[mode, r] = start_rank("--tp-rank", mode, r, addr, root,
                                              root / f"tp_{mode}_rank{r}.log")
                procs.append((mode, r, p))
        deadline = time.monotonic() + TP_TIMEOUT_S
        if during is not None:
            during()
        for _, _, p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    exited = time.time()
    for mode, r, p in procs:
        if p.returncode != 0:
            text = logs[mode, r].read_text()
            print(f"--- {mode} rank {r} (exit {p.returncode}), last lines:\n"
                  + "\n".join(text.splitlines()[-30:]), flush=True)
            raise AssertionError(f"phase 17 {mode} rank {r} exited {p.returncode}")
    out = {mode: [json.loads((root / f"tp_{mode}_rank{r}.json").read_text())
                  for r in range(TP_WORLD[mode])] for mode in modes}
    lag = exited - max(rec["done_at"] for recs in out.values() for rec in recs)
    print(f"ranks of {', '.join(modes)}: {wall:.1f} s wall; from spawn to the end of the "
          "imports, from the go to the work, and the work, s: " + json.dumps(
              {m: [[round(rec["startup_s"][k], 1) for k in ("imports", "to_work")]
                   + [round(rec["wall_s"], 1)] for rec in recs] for m, recs in out.items()})
          + f"; the last record written {lag:.1f} s before every rank had exited", flush=True)
    return out, wall


def tp_compare(root, mode, ranks, card):
    """Every rank's outputs equal rank 0's; rank 0's held to one process
    with the gates; each rank's launches equal to its census (SD-1.5);
    its times printed with the card."""
    import numpy as np

    sd3 = mode.startswith("sd3")
    refs = torch.load(root / ("tp_sd3_refs.pt" if sd3 else "tp_refs.pt"))
    outs = [torch.load(root / f"tp_{mode}_rank{r}.pt") for r in range(TP_WORLD[mode])]
    for r, o in enumerate(outs[1:], 1):
        for k, v in o.items():
            if not torch.equal(v, outs[0][k]):
                raise AssertionError(f"phase 17 {mode}: rank {r}'s {k} differs from rank 0's")
    res = {}
    if sd3:
        checks = [(f"mmdit_{d}", d, "forward", refs[f"{d}_forward"], outs[0][f"{d}_forward"])
                  for d in ("float32", "bfloat16")]
        checks.append(("bfloat16_images", "bfloat16", "images", refs["images"],
                       outs[0]["images"]))
        if "t5" in outs[0]:
            checks += [(f"t5_block_{d}", d, "forward", refs[f"t5_block_{d}"],
                        outs[0][f"t5_block_{d}"]) for d in ("float32", "bfloat16")]
            checks.append(("t5_conditioned_images", "bfloat16", "images", refs["t5_images"],
                           outs[0]["t5_images"]))
    else:
        short = mode == "both"
        checks = []
        for dtype in ("float32", "bfloat16"):
            checks.append((f"{dtype}_forward", dtype, "forward", refs[f"{dtype}_forward"],
                           outs[0][f"{dtype}_forward"]))
            if short and dtype == "float32":
                continue  # the four ranks run their short loop in bf16 against it
            ref = refs[f"{dtype}_images"]
            checks.append((f"{dtype}_images", dtype, "images", ref, outs[0][f"{dtype}_images"]))
    failed = []
    for name, dtype, what, want, got in checks:
        if what == "forward":
            err = rel_l2(got, want)
            res[name] = dict(rel_l2=err)
            if not torch.isfinite(got).all() or err > TP_FORWARD_REL[dtype]:
                failed.append(f"{name}: relative L2 {err:.3e} from one process > "
                              f"{TP_FORWARD_REL[dtype]}")
        else:
            got, want = got.numpy(), want.numpy()
            d = np.abs(got.astype(np.float64) - want.astype(np.float64))
            res[name] = dict(mean_abs=float(d.mean()), max_abs=float(d.max()))
            if got.shape != want.shape or not np.isfinite(got).all() \
                    or d.mean() > TP_IMAGE_MEAN[dtype]:
                failed.append(f"{name}: mean |diff| {d.mean():.3e} from one process > "
                              f"{TP_IMAGE_MEAN[dtype]} (shape {got.shape})")
    if sd3 and "t5" in outs[0]:
        # The whole fp32 encode, against one process's own change of order.
        err, own = rel_l2(outs[0]["t5"], refs["t5"]), rel_l2(refs["t5_permuted"], refs["t5"])
        res["t5_encode_float32"] = dict(rel_l2=err, one_process_permuted=own)
        if not err <= T5_ORDER_FACTOR * own:
            failed.append(f"t5 encode: relative L2 {err:.3e} from one process > "
                          f"{T5_ORDER_FACTOR} x {own:.3e}, one process's permuted encode's")
        # Each split T5 block on the one process's input to it.
        blocks = ranks[0]["bfloat16"]["t5_blocks_rel_l2"]
        res["t5_blocks_float32"] = dict(max_rel_l2=max(blocks), rel_l2=blocks)
        if not max(blocks) <= TP_FORWARD_REL["float32"]:
            failed.append(f"t5 blocks: an update's relative L2 {max(blocks):.3e} from one "
                          f"process > {TP_FORWARD_REL['float32']} ({blocks})")
    for r, rec in enumerate(ranks):
        for dtype, m in rec.items():
            if not isinstance(m, dict) or "launches" not in m:
                continue
            if "census" in m and m["launches"] != m["census"]:
                failed.append(f"rank {r} {dtype}: launches {m['launches']}, census {m['census']}")
            if sd3:  # the MMDiT's joint attentions, the VAE's GroupNorms
                runs = [("launches", SD3_TP_STEPS)] + (
                    [("t5_launches", SD3_T5_STEPS)] if "t5_launches" in m else [])
                for key, steps in runs:
                    got = m[key]
                    if (got["attention"] != steps * 24 or got["group_norm"] != 30
                            or got["group_norm_partials"]):
                        failed.append(f"rank {r} {key}: {got}, expected {steps * 24} attention, "
                                      f"30 GroupNorm")
            secs = {k: round(v, 3) for k, v in m.items() if k.endswith("_s")}
            print(f"phase 17 {mode} rank {r} {dtype}: seconds {json.dumps(secs)}, peak "
                  f"{m['peak_gb']:.2f} GiB, launches {m['launches']} ({TP_NOTE}); {card}",
                  flush=True)
    if mode == "model":
        served = ranks[0]["served"]
        res["served"] = served
        if not served["bit_equal"] or served["batch_size"] != 1 \
                or ranks[1]["served"]["follower_calls"] != 1:
            failed.append(f"(e) served request: {served}, follower {ranks[1]['served']}")
    print(f"phase 17 {mode} against one process: {json.dumps(res)}", flush=True)
    if failed:
        raise AssertionError(f"phase 17 {mode}: " + "; ".join(failed))
    return res


def run_tensor_parallel(report, card):
    """Phase 17: (a) the split GroupNorm kernels; one-process references
    and one process's own drift; (b) SD-1.5 at mesh_model=2 and
    mesh_seq=2, (c) four ranks at mesh_seq=2 x mesh_model=2, (d)
    SD3-medium at mesh_model=2 (with T5-XXL) and mesh_seq=2, (e) the
    server on the mesh_model=2 ranks, each against one process; gloo
    groups of several modes run at once; then the kernels at every shape
    the split forwards launched, against their plain versions."""
    out = {}
    t0 = time.perf_counter()
    out["split_group_norm"] = check_split_group_norm(module_census(2 * BATCH))
    out["kernels_s"] = time.perf_counter() - t0
    print(f"phase 17 (a) took {out['kernels_s']:.1f} s", flush=True)
    _, per_unet, per_vae = census(2 * BATCH)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="sdbl_tp_") as tmp:
        root = Path(tmp)
        t1 = time.perf_counter()
        out["references_s"], out["one_process_drift"] = tp_references(root)
        print(f"phase 17 one-process references: {json.dumps(out['references_s'])}", flush=True)
        ranks = {}
        # Two groups of six ranks at once, ~50-60 GB of the card's 80 each.
        for group in (("model", "seq", "sd3_seq"), ("both", "sd3_model")):
            got, wall = run_tp_ranks(root, group)
            ranks.update(got)
            out[f"{'+'.join(group)}_wall_s"] = wall
            print(f"phase 17 ranks of {', '.join(group)}: {wall:.1f} s wall; " + "; ".join(
                f"{m} rank {r} {json.dumps({k: v for k, v in rec.items() if k != 'kernel_shapes'})}"
                for m in group for r, rec in enumerate(got[m])), flush=True)
        out["ranks_s"] = time.perf_counter() - t1
        out["ranks"] = ranks
        out["against_one_process"], failed = {}, []
        for m in ranks:  # every mode compared and printed before a failure raises
            try:
                out["against_one_process"][m] = tp_compare(root, m, ranks[m], card)
            except AssertionError as e:
                failed.append(str(e))
    t1 = time.perf_counter()
    out["split_shapes"] = check_split_shapes(ranks)
    out["split_shapes_s"] = time.perf_counter() - t1
    apply_row = out["split_group_norm"]["kernels"]["group_norm_apply"]
    apply_row["max_abs_err"] = max(apply_row["max_abs_err"],
                                   *(e for k, e in out["split_shapes"]["max_abs_err"].items()
                                     if k.startswith("group_norm_split")))
    if failed:
        raise AssertionError("; ".join(failed))
    # A rank keeps its share of the model axis's weights: under model the
    # UNet's parameters a rank holds fall, under seq they stay whole.
    held = {m: ranks[m][0]["bfloat16"]["unet_params"] for m in ("model", "seq", "both")}
    print(f"phase 17 UNet parameters a rank holds: {json.dumps(held)}", flush=True)
    if not held["model"] == held["both"] < 0.8 * held["seq"]:
        raise AssertionError(f"phase 17: a model rank holds {held} UNet parameters")
    out["launches"] = {m: [{d: v["launches"] for d, v in rec.items()
                            if isinstance(v, dict) and "launches" in v} for rec in recs]
                       for m, recs in ranks.items()}
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 17 wall clock: {out['wall_s']:.1f} s (kernels {out['kernels_s']:.1f}, one "
          f"process {json.dumps(out['references_s'])}, ranks {out['ranks_s']:.1f}, the kernels "
          f"at the split shapes {out['split_shapes_s']:.1f}; {TP_NOTE}); {card}", flush=True)
    report["e2e"]["tensor_parallel"] = out
    return out


def phase17_launches(out, kind):
    """A kernel's launches in phase 17's bf16 SD-1.5 runs: each mode's rank 0."""
    return {m: recs[0]["bfloat16"]["launches"][kind] for m, recs in out["ranks"].items()}


# -------------- phase 18: the T5 tokenizer.json reader; training, int8 and ToMe on split ranks
# A T5-shaped tokenizer.json written here (the card's machine has no
# ``tokenizers``): 32,100 pieces made from T5_TOK_SEED (<pad>, </s>, <unk>,
# 31,997 pieces, 100 <extra_id_*>), a Precompiled charsmap encoded here,
# Replace(" {2,}", " "), Metaspace and TemplateProcessing's </s>, in the
# layout of SD3's tokenizer_3.  T5_TOK_IDS are the ids that the
# ``tokenizers`` package gives T5_TOK_PROMPTS on that file
# (tests/test_torch_t5_tokenizer.py derives them there); the port's reader
# must give the same on the card's machine.
T5_TOK_SEED, T5_TOK_PIECES, T5_TOK_EXTRA = 18, 32000, 100
T5_TOK_PROMPTS = [
    "a photograph of an astronaut riding a horse",
    "  Ｆｕｌｌ-width  ＡＢＣ  and   runs of   spaces  ",
    "café créme ﬁne Ångström",
    "emoji \U0001F600\U0001F3FD and 中文 unknowns </s> in the middle",
    "",
]
T5_TOK_IDS = [
    [4, 14817, 9113, 1839, 18177, 708, 16817, 10004, 2678, 247, 3, 2414, 3472, 5669, 3467, 4,
     23863, 3416, 1],
    [66, 3073, 25, 131, 5880, 9, 10696, 56, 57, 59, 16817, 9, 285, 14329, 708, 3625, 3403, 4396,
     169, 1],
    [8, 14267, 139, 6319, 139, 9934, 14, 20306, 56, 2, 29, 4336, 2678, 145, 27, 1],
    [12, 2237, 16434, 169, 2, 16817, 9, 169, 2, 5406, 4879, 7070, 14329, 169, 1, 20, 29, 28711,
     269, 21623, 5216, 1],
    [1],
]


def t5_tokenizer_spec(seed=T5_TOK_SEED):
    """The phase's tokenizer.json as a dict (see T5_TOK_PROMPTS)."""
    import numpy as np

    from sonicdiffusionbayeslab_torch.models.tokenizer import encode_precompiled_charsmap

    rng = np.random.default_rng(seed)
    letters = "abcdefghijklmnopqrstuvwxyz"
    chars = (letters + letters.upper() + "0123456789.,-'!?éèàöüçÅ"
             + "".join(chr(c) for c in range(0x4e00, 0x4e08)))
    pieces, seen = [], {"<pad>", "</s>", "<unk>"}
    for c in chars:
        for p in (c, "▁" + c):
            seen.add(p)
            pieces.append(p)
    pieces.append("▁")
    seen.add("▁")
    while len(pieces) < T5_TOK_PIECES - 3:
        n = int(rng.integers(2, 9))
        p = "".join(letters[i] for i in rng.integers(0, 26, n))
        if rng.random() < 0.5:
            p = "▁" + p
        if p not in seen:
            seen.add(p)
            pieces.append(p)
    scores = -rng.uniform(2.0, 14.0, len(pieces))
    vocab = ([["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0]]
             + [[p, float(s)] for p, s in zip(pieces, scores)]
             + [[f"<extra_id_{i}>", 0.0] for i in range(T5_TOK_EXTRA - 1, -1, -1)])
    charsmap = {chr(0xFF01 + i): chr(0x21 + i) for i in range(94)}  # full-width ASCII
    charsmap.update({"　": " ", "ﬁ": "fi", "é": "é", "Å": "Å",
                     "​": "", "\x07": ""})
    added = [{"id": i, "content": vocab[i][0], "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i in [0, 1, 2] + list(range(len(vocab) - T5_TOK_EXTRA, len(vocab)))]
    meta = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
            "split": True}
    return {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap": base64.b64encode(
                encode_precompiled_charsmap(charsmap)).decode()},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
        "pre_tokenizer": meta,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "special_tokens": {"</s>": {"id": "</s>", "ids": [1], "tokens": ["</s>"]}}},
        "decoder": meta,
        "model": {"type": "Unigram", "unk_id": 2, "vocab": vocab, "byte_fallback": False},
    }


def write_t5_tokenizer(directory):
    """Write the phase's ``tokenizer.json`` into ``directory``; its path."""
    path = Path(directory) / "tokenizer.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(t5_tokenizer_spec(), ensure_ascii=False))
    return path


# Phase 18's rank groups (gloo, sharing the card like phase 17's): two train
# groups and "a9b_infer" on the model axis, "a9b_seq" on the seq axis; the
# train groups' cases.
A9B_WORLD = {"a9b_train": 2, "a9b_train2": 2, "a9b_infer": 2, "a9b_seq": 2}
TP_WORLD.update(A9B_WORLD)  # their processes start as phase 17's do (tp_rank)
A9B_MESH = {"a9b_train": dict(mesh_model=2), "a9b_train2": dict(mesh_model=2),
            "a9b_infer": dict(mesh_model=2), "a9b_seq": dict(mesh_seq=2)}
A9B_GROUP_CASES = {"a9b_train": ("lora_bf16", "lora", "full_remat"),
                   "a9b_train2": ("controlnet", "distill", "sd3_lora")}
# The fp32 train cases (TF32 off) at batch 1 (SD-1.5 512^2, SD3 1024^2 with
# SD3_TRAIN_CTX context tokens), the bf16 LoRA step at batch 2, the loop's
# steps; the SD3 T5 + ToMe run's steps.
A9B_CASES = ("lora", "full_remat", "controlnet", "distill", "sd3_lora")
A9B_BF16_BATCH, A9B_LOOP_STEPS, A9B_SD3_STEPS = 2, 2, 2
# The fp32 SD3 LoRA step's MMDiT depth (SD3-medium's widths, 8 of its 24
# blocks: depth cut, never width; every block type splits alike).
A9B_SD3_DEPTH = 8
# The int8 and ToMe SD-1.5 runs' steps (the phase cuts steps, never widths:
# a split rank's eager step crosses the host ~140 times); the t5_bench
# twin's steps (t5_bench's default is 20).  (A9B_STEPS was 10 and the twin
# ran 20 steps until the script first passed its time limit on a slow
# host: steps cut, never widths.)
A9B_STEPS, A9B_T5_BENCH_STEPS = 4, 8
# Against one process: an fp32 gradient's relative L2 a tensor (of its own
# norm, or of 1% of the case's largest where a tensor's own gradient is
# noise about zero: a bias before a GroupNorm of one channel a group), the
# loss; the bf16 LoRA gradients' relative L2 within the larger of 2e-2 and
# twice one process's own bf16-against-fp32 drift, its loss within the
# larger of 1e-4 (ten times fp32's gate) and twice one process's own
# bf16-against-fp32 loss difference; the images' mean |diff| (int8: within
# one process's own int8-against-exact drift plus its own bf16 reordering
# drift, the exact run in chunks of 2 against the whole batch, which every
# split run carries: phase 17's split exact bf16 runs drift ~3e-3 from one
# process's).  A sampled int8 image moves with every rounding the quantizer
# flips, and with random bf16 weights any change of summation order moves
# an image as far as int8 does (one step: 2.6e-3 either way), so no
# distance to one process's images can tell a split that ran int8 from one
# that ran exact; three more gates do: the int8 layers bit-equal to one
# process's on one input (a feed-forward over model, a conv over seq: the
# scales are the whole rows', the int32 sums exact), the int8 launches one
# process's, and the split's one-step int8 images at least half as far
# from its own exact ones as one process's are from its exact ones (a
# split that ran exact gives its exact images' bits).
A9B_GRAD_REL, A9B_LOSS_REL, A9B_BF16_FLOOR, A9B_TOME_MEAN = 1e-4, 1e-5, 2e-2, 5e-2
A9B_BF16_LOSS_FLOOR = 1e-4


def a9b_inputs(root):
    """The fixed inputs of phase 18's train steps (seeded on the CPU) in
    ``root``/a9b_inputs.pt."""
    g = torch.Generator().manual_seed(180)
    lat = SIZE // 8
    inp = dict(lat=torch.randn(A9B_BF16_BATCH, lat, lat, 4, generator=g),
               ctx=torch.randn(A9B_BF16_BATCH, 77, 768, generator=g),
               uncond=torch.randn(A9B_BF16_BATCH, 77, 768, generator=g),
               noise=torch.randn(A9B_BF16_BATCH, lat, lat, 4, generator=g),
               t=torch.tensor([301, 777]), idx=torch.tensor([11, 37]),
               hint=torch.rand(A9B_BF16_BATCH, SIZE, SIZE, 3, generator=g),
               sd3_lat=torch.randn(1, SD3_SIZE // 8, SD3_SIZE // 8, 16, generator=g),
               sd3_noise=torch.randn(1, SD3_SIZE // 8, SD3_SIZE // 8, 16, generator=g),
               sd3_ctx=torch.randn(1, SD3_TRAIN_CTX, 4096, generator=g),
               sd3_pooled=torch.randn(1, 2048, generator=g), sd3_u=torch.tensor([0.3]))
    torch.save(inp, Path(root) / "a9b_inputs.pt")


def a9b_engine(family, dtype, mesh=None, controlnet=False):
    """A full-width engine with random weights from seed 0 (a ControlNet with
    random heads: ``init_controlnet`` zeroes them), placed on ``mesh``; its
    text towers and VAE dropped, as a train step on given latents and
    context reads neither."""
    import dataclasses

    from sonicdiffusionbayeslab_torch.models.mmdit import MMDiTConfig
    from sonicdiffusionbayeslab_torch.models.sampler import StableDiffusionEngine
    from sonicdiffusionbayeslab_torch.models.sd3 import SD3Engine

    if family == "sd3":
        cfg = dataclasses.replace(MMDiTConfig.sd3_medium(), depth=A9B_SD3_DEPTH)
        eng = SD3Engine(cfg, dtype=dtype, device="cuda").init_params(0)
    else:
        eng = StableDiffusionEngine(dtype=dtype, device="cuda").init_params(0)
    for name in eng.MODULES:
        if name != "unet":
            setattr(eng, name, None)
    gc.collect()
    torch.cuda.empty_cache()
    if controlnet:
        g = torch.Generator(device="cuda").manual_seed(181)
        with torch.no_grad():
            for conv in eng.init_controlnet(0).heads():
                conv.weight.normal_(0.0, 0.02, generator=g)
                conv.bias.normal_(0.0, 0.02, generator=g)
    if mesh is not None:
        eng.parallelize(mesh)
    return eng


def a9b_step(case, eng, inp, mesh=None, shapes=None):
    """(loss, {leaf: gradient on the host}) of one ``value_and_grad`` of
    ``case`` on ``eng`` (batch 1, or A9B_BF16_BATCH for the bf16 LoRA step)."""
    from sonicdiffusionbayeslab_torch.training.distillation import LCMDistillConfig, LCMDistiller
    from sonicdiffusionbayeslab_torch.training.lora import MMDIT_TARGETS
    from sonicdiffusionbayeslab_torch.training.trainer import DiffusionTrainer, TrainConfig

    n = A9B_BF16_BATCH if case == "lora_bf16" else 1
    c = {k: v[:n].cuda() for k, v in inp.items()}
    if case == "distill":
        tr = LCMDistiller(eng, LCMDistillConfig(lora_rank=64, original_inference_steps=50),
                          mesh=mesh)
        st = tr.init_state(generator=torch.Generator(device="cuda").manual_seed(182))
        args, kw = (st, c["lat"], c["ctx"], c["uncond"]), dict(idx=c["idx"], noise=c["noise"])
    elif case == "sd3_lora":
        tr = DiffusionTrainer(eng, TrainConfig(objective="flow", lora_rank=8, remat=True,
                                               lora_targets=MMDIT_TARGETS), mesh=mesh)
        st = tr.init_state(generator=torch.Generator(device="cuda").manual_seed(182))
        args = (st, c["sd3_lat"], c["sd3_ctx"])
        kw = dict(noise=c["sd3_noise"], u=c["sd3_u"], added={"text_embeds": c["sd3_pooled"]})
    else:
        cfg = {"lora": dict(lora_rank=8, snr_gamma=5.0), "lora_bf16": dict(lora_rank=8),
               "full_remat": dict(remat=True, optimizer="adafactor"),
               "controlnet": dict(train_target="controlnet")}
        tr = DiffusionTrainer(eng, TrainConfig(**cfg[case]), mesh=mesh)
        st = tr.init_state(generator=torch.Generator(device="cuda").manual_seed(182))
        args, kw = (st, c["lat"], c["ctx"]), dict(noise=c["noise"], timesteps=c["t"])
        if case == "controlnet":
            kw["hint"] = c["hint"]
    if case.startswith("lora") or case in ("distill", "sd3_lora"):  # b random: every a learns
        with torch.no_grad():
            g = torch.Generator(device="cuda").manual_seed(183)
            for ab in st.trainable.values():
                ab["b"].normal_(0.0, 1e-3, generator=g)
    if shapes is not None:
        with recording_kernel_shapes(shapes):
            loss, grads = tr.value_and_grad(*args, **kw)
    else:
        loss, grads = tr.value_and_grad(*args, **kw)
    out = float(loss), {k: v.detach().float().cpu() for k, v in grads.items()}
    del tr, st, grads
    return out


def a9b_grad_errs(got, want, rel, loss_rel):
    """The largest per-tensor relative L2 of ``got``'s gradients against
    ``want``'s (see A9B_GRAD_REL) and the losses' relative difference;
    ``ok`` where they are within ``rel`` and ``loss_rel``."""
    (loss, g), (w_loss, w) = got, want
    if set(g) != set(w):
        raise AssertionError("the split step's trainable tensors are not one process's")
    floor = 1e-2 * max(float(v.norm()) for v in w.values())
    worst = max(float((g[k] - w[k]).norm()) / max(float(w[k].norm()), floor) for k in w)
    return dict(loss_rel=abs(loss - w_loss) / abs(w_loss), grad_rel_l2=worst,
                ok=worst <= rel and abs(loss - w_loss) <= loss_rel * abs(w_loss))


def a9b_train_rank(rank, mesh, root, cases, loop=False):
    """A train group's rank (mesh_model=2): each of ``cases`` (``lora_bf16``:
    the bf16 LoRA step with its launches and kernel shapes; the others
    fp32, TF32 off) split; with ``loop``, train_lora.yaml through the loop.
    Rank 0 then takes each step in one process and holds the split's to
    it (bf16: within the larger of A9B_BF16_FLOOR and twice one process's
    own bf16-against-fp32 drift of the same step)."""
    import torch.distributed as dist

    from sonicdiffusionbayeslab_torch.config import load_config
    from sonicdiffusionbayeslab_torch.training.loop import run_training

    inp = torch.load(Path(root) / "a9b_inputs.pt")
    rec, shapes, split = {}, set(), {}
    t0 = time.perf_counter()

    def engines(one_process):
        """(family, dtype, its cases) in the order the cases run."""
        for family, dtype, names in (("sd15", torch.bfloat16, ("lora_bf16",)),
                                     ("sd15", torch.float32, A9B_CASES[:4]),
                                     ("sd3", torch.float32, A9B_CASES[4:])):
            names = [c for c in names if c in cases]
            if names:
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = (
                    dtype != torch.float32)
                torch.cuda.reset_peak_memory_stats()
                eng = a9b_engine(family, dtype, None if one_process else mesh,
                                 controlnet="controlnet" in names)
                yield eng, names
                if not one_process:
                    rec[f"{family}_{str(dtype)[6:]}_peak_gb"] = (
                        torch.cuda.max_memory_allocated() / 2**30)
                del eng
                gc.collect()
                torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True

    for eng, names in engines(False):
        for case in names:
            bf16 = case == "lora_bf16"
            if bf16:
                all_counts(reset=True)
            t1 = time.perf_counter()
            split[case] = a9b_step(case, eng, inp, mesh, shapes if bf16 else None)
            torch.cuda.synchronize()
            rec[f"{case}_step_s"] = time.perf_counter() - t1
            if bf16:
                rec["launches"] = all_counts()
    rec["split_s"] = time.perf_counter() - t0
    if loop:  # train_lora.yaml at mesh_data 1, mesh_model 2: rank 0 saves the adapters
        t1 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        out = run_training(load_config(
            Path(__file__).resolve().parent / "configs" / "train_lora.yaml",
            a9b_loop_overrides(root, "split", mesh_model=2)))
        rec["loop"] = dict(losses=out["losses"], steps_per_sec=out["steps_per_sec"],
                           wall_s=time.perf_counter() - t1,
                           peak_gb=torch.cuda.max_memory_allocated() / 2**30)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:  # one process's steps on the same inputs, then the gates
        t1 = time.perf_counter()
        against = rec["against_one_process"] = {}
        for eng, names in engines(True):
            for case in names:
                bf16 = case == "lora_bf16"
                if bf16:
                    all_counts(reset=True)
                one = a9b_step(case, eng, inp)
                if not bf16:
                    against[case] = a9b_grad_errs(split[case], one, A9B_GRAD_REL, A9B_LOSS_REL)
                    continue
                rec["one_process_launches"] = all_counts()
                eng.unet.float()  # the same weights in fp32: one process's own bf16 drift
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
                own = a9b_grad_errs(one, a9b_step(case, eng, inp), 1.0, 1.0)
                gate = max(A9B_BF16_FLOOR, 2 * own["grad_rel_l2"])
                loss_gate = max(A9B_BF16_LOSS_FLOOR, 2 * own["loss_rel"])
                against[case] = {**a9b_grad_errs(split[case], one, gate, loss_gate),
                                 "gate": gate, "loss_gate": loss_gate,
                                 "one_process_bf16_vs_fp32": own["grad_rel_l2"],
                                 "one_process_bf16_vs_fp32_loss": own["loss_rel"]}
        rec["one_process_s"] = time.perf_counter() - t1
    rec["kernel_shapes"] = sorted([kind, list(shape)] for kind, shape in shapes)
    return rec


def a9b_loop_overrides(root, name, **mesh):
    root = Path(root)
    return {"dataset.img_dataset": str(root / "train_images"),
            "dataset.prompts": str(root / "img2annotations_train_first16.json"),
            "training.num_steps": A9B_LOOP_STEPS, "training.log_every": 1,
            "training.save_dir": str(root / f"loop_{name}"),
            **({"training.mesh_data": 1, **{f"training.{k}": v for k, v in mesh.items()}}
               if mesh else {})}


def a9b_infer_rank(rank, mesh, root):
    """``a9b_infer`` (mesh_model=2): an A9B_STEPS-step bf16 SD-1.5 run under int8
    with its launches, the int8 feed-forward against one process's
    (``a9b_int8_ff``) and one-step runs int8 and exact; then a random rank-64 LoRA fused into
    the split weights, each rank's slices held bit-equal to one process's
    fused weights cut to the rank's share (fused here, from the same
    seed)."""
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
    from sonicdiffusionbayeslab_torch.models.weights import load_torch_state_dict, merge_lora
    from sonicdiffusionbayeslab_torch.parallel.mesh import SplitParams

    rec, saves, shapes = {}, {}, set()
    whole = StableDiffusionModel(image_size=SIZE, seed=0, device="cuda").engine.unet.state_dict()
    model = StableDiffusionModel(image_size=SIZE, seed=0, device="cuda", **A9B_MESH["a9b_infer"])
    model.engine.set_quant_mode("int8")
    all_counts(reset=True)
    int8_counts(reset=True)
    t0 = time.perf_counter()
    with recording_kernel_shapes(shapes):
        imgs, rec["int8_execution_time_s"], _ = model(PROMPTS, num_inference_steps=A9B_STEPS,
                                                      guidance_scale=GUIDANCE, seed=29)
    rec["int8_call_s"] = time.perf_counter() - t0
    rec["int8_launches"] = {**all_counts(), **int8_counts()}
    saves["int8"] = torch.from_numpy(imgs)
    rec["int8_ff"] = a9b_int8_ff(model.engine.unet, whole)
    for mode in ("int8", None):
        model.engine.set_quant_mode(mode)
        saves[f"{mode or 'exact'}_1step"] = torch.from_numpy(model(
            PROMPTS, num_inference_steps=1, guidance_scale=GUIDANCE, seed=29)[0])
    lora = Path(root) / "a9b_lora.bin"
    model.load_lora_weights(str(lora)).fuse_lora()
    unet = model.engine.unet
    split = SplitParams.of(unet)
    fused, names = merge_lora(whole, load_torch_state_dict(lora))
    local = unet.state_dict()
    bad = [k for k, v in fused.items() if not torch.equal(split.local(k, v), local[k])]
    rec["fuse"] = dict(modules=len(names), split_tensors=sum(k in split.cuts for k in local),
                       not_bit_equal=bad[:5])
    torch.save(saves, Path(root) / f"a9b_infer_rank{rank}.pt")
    rec["kernel_shapes"] = sorted([kind, list(shape)] for kind, shape in shapes)
    return rec


def a9b_seq_rank(rank, mesh, root):
    """``a9b_seq`` (mesh_seq=2): A9B_STEPS-step bf16 SD-1.5 runs under
    int8_conv (then the int8 conv against one process's,
    ``a9b_int8_conv_rows``, and one-step runs int8_conv and exact) and
    with ToMe 0.5; SD3-medium with
    DiT-ToMe 0.5 for A9B_SD3_STEPS steps; each with its launches."""
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel

    rec, saves, shapes = {}, {}, set()
    model = StableDiffusionModel(image_size=SIZE, seed=0, device="cuda", **A9B_MESH["a9b_seq"])
    for name, kw in (("int8_conv", {}), ("tome", dict(tome_ratio=0.5))):
        model.engine.set_quant_mode("int8_conv" if name == "int8_conv" else None)
        all_counts(reset=True)
        int8_counts(reset=True)
        t0 = time.perf_counter()
        with recording_kernel_shapes(shapes):
            imgs, rec[f"{name}_execution_time_s"], _ = model(
                PROMPTS, num_inference_steps=A9B_STEPS, guidance_scale=GUIDANCE, seed=29, **kw)
        rec[f"{name}_call_s"] = time.perf_counter() - t0
        rec[f"{name}_launches"] = {**all_counts(), **int8_counts()}
        saves[name] = torch.from_numpy(imgs)
        if name == "int8_conv":
            rec["int8_conv_rows"] = a9b_int8_conv_rows(model.engine.unet)
            for mode in ("int8_conv", None):
                model.engine.set_quant_mode(mode)
                saves[f"{mode or 'exact'}_1step"] = torch.from_numpy(model(
                    PROMPTS, num_inference_steps=1, guidance_scale=GUIDANCE, seed=29)[0])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    saves["sd3_tome"], rec["sd3_launches"] = a9b_sd3_tome(shapes, **A9B_MESH["a9b_seq"])
    rec["sd3_s"] = time.perf_counter() - t0
    torch.save(saves, Path(root) / f"a9b_seq_rank{rank}.pt")
    rec["kernel_shapes"] = sorted([kind, list(shape)] for kind, shape in shapes)
    return rec


def a9b_int8_ff(unet, whole):
    """The first transformer block's feed-forward of the split ``unet``
    under int8 (its hidden units; ``net.2``'s token scales all-maxed over
    model, its int32 partials summed) against the same layer whole (from
    ``whole``, one process's state dict), on one bf16 input."""
    from sonicdiffusionbayeslab_torch.models.layers import GEGLUFeedForward
    from sonicdiffusionbayeslab_torch.ops.quant import set_quant_mode

    name = "down_blocks.0.attentions.0.transformer_blocks.0.ff"
    split = unet.get_submodule(name)
    dim = split.net[2].weight.shape[0]
    one = GEGLUFeedForward(dim).to("cuda", torch.bfloat16)
    one.load_state_dict({k[len(name) + 1:]: v for k, v in whole.items()
                         if k.startswith(name + ".")})
    set_quant_mode(one, "int8")
    g = torch.Generator(device="cuda").manual_seed(185)
    x = torch.randn(2, (SIZE // 8) ** 2, dim, generator=g, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        got, want = split(x), one(x)
    return dict(split=split.split, bit_equal=torch.equal(got, want),
                max_abs=float((got.float() - want.float()).abs().max()))


def a9b_int8_conv_rows(unet):
    """The first resnet's conv1 of the ``seq``-split ``unet`` under
    int8_conv (halo rows; the sample's scale all-maxed over seq) on this
    rank's rows of one bf16 map, against the same conv on the whole map
    (one process's call), cut to those rows."""
    from sonicdiffusionbayeslab_torch.ops import quant

    res = unet.get_submodule("down_blocks.0.resnets.0")
    par, lat = res.par, SIZE // 8
    g = torch.Generator(device="cuda").manual_seed(186)
    x = torch.randn(2, lat, lat, res.conv1.in_channels, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    h = lat // par.n_seq
    rows = slice(par.seq_index * h, (par.seq_index + 1) * h)
    with torch.no_grad():
        got = res._conv(res.conv1, x[:, rows].contiguous())
        want = quant.conv_int8(res.conv1, x, ((1, 1), (1, 1)))[:, rows]
    return dict(mode=res.quant_mode, bit_equal=torch.equal(got, want),
                max_abs=float((got.float() - want.float()).abs().max()))


def a9b_sd3_tome(shapes=None, **mesh):
    """SD3-medium (CLIP context) with DiT-ToMe 0.5, A9B_SD3_STEPS steps of
    one prompt: (images, launches)."""
    import contextlib

    pipe = sd3_pipeline(image_size=SD3_SIZE, seed=0, device="cuda", **mesh)
    all_counts(reset=True)
    ctx = recording_kernel_shapes(shapes) if shapes is not None else contextlib.nullcontext()
    with ctx:
        imgs, _, _ = pipe(PROMPTS[:1], num_inference_steps=A9B_SD3_STEPS,
                          guidance_scale=SD3_GUIDANCE, seed=29, tome_ratio=0.5)
    counts = all_counts()
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return torch.from_numpy(imgs), counts


def a9b_sd3_t5_snapshot(root):
    """SD3-medium with T5-XXL (resident) whose ``tokenizer_3`` is the phase's
    tokenizer.json, read by the pipeline's own reader from the snapshot
    directory ``root``/sd3: the ids of T5_TOK_PROMPTS[:2] must be the
    pinned ones, and A9B_SD3_STEPS steps of them finite images."""
    import numpy as np

    t0 = time.perf_counter()
    pipe = sd3_pipeline(image_size=SD3_SIZE, seed=0, device="cuda", use_t5=True,
                        t5_staged=False)
    pipe.pretrained_model = str(Path(root) / "sd3")
    pipe.tokenizer3 = pipe._t5_tokenizer(False)
    prompts = T5_TOK_PROMPTS[:2]
    ids = pipe.tokenizer3(prompts)
    for row, want in zip(ids, T5_TOK_IDS[:2]):
        if list(row[:len(want)]) != want or row[len(want):].any():
            raise AssertionError(f"phase 18: the SD3 pipeline's T5 ids {list(row[:32])} are not "
                                 f"the pinned {want}")
    all_counts(reset=True)
    imgs, exec_s, _ = pipe(prompts, num_inference_steps=A9B_SD3_STEPS,
                           guidance_scale=SD3_GUIDANCE, seed=29)
    counts = all_counts()
    if imgs.shape != (2, SD3_SIZE, SD3_SIZE, 3) or not np.isfinite(imgs).all():
        raise AssertionError(f"phase 18: SD3 with T5 through the snapshot gave {imgs.shape} "
                             "images, or non-finite ones")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return dict(execution_time_s=exec_s, launches=counts, s=time.perf_counter() - t0)


def a9b_rank(rank, mode, root):
    """A rank of a phase 18 group (``tp_rank``'s mode ``a9b_*``)."""
    from sonicdiffusionbayeslab_torch.parallel import mesh as M

    axes = A9B_MESH[mode]
    mesh = M.make_mesh(n_data=1, n_model=axes.get("mesh_model", 1),
                       n_seq=axes.get("mesh_seq", 1), device_type="cuda")
    if mode in A9B_GROUP_CASES:
        return a9b_train_rank(rank, mesh, root, A9B_GROUP_CASES[mode], loop=mode == "a9b_train2")
    return {"a9b_infer": a9b_infer_rank, "a9b_seq": a9b_seq_rank}[mode](rank, mesh, root)


def a9b_assets(root):
    """What phase 18's processes read: the train steps' inputs, the
    tokenizer.json (in a snapshot's ``tokenizer_3``), the loop's images and
    a random rank-64 LoRA."""
    root = Path(root)
    a9b_inputs(root)
    write_t5_tokenizer(root / "sd3" / "tokenizer_3")
    write_train_images(root)
    write_random_lora(root / "a9b_lora.bin", rank=64, seed=18)


def a9b_references(root):
    """Phase 18's one-process runs (bf16, random weights from seed 0): SD-1.5
    A9B_STEPS-step images exact (whole and in chunks of 2), int8 and
    int8_conv (with their int8 launches), and with ToMe 0.5; one-step
    images exact, int8 and int8_conv; SD3's DiT-ToMe run; train_lora.yaml
    through the loop (A9B_LOOP_STEPS steps).  Runs beside the first wave
    of ranks."""
    from sonicdiffusionbayeslab_torch.config import load_config
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
    from sonicdiffusionbayeslab_torch.training.loop import run_training

    root = Path(root)
    refs, rec = {}, {}
    t0 = time.perf_counter()
    model = StableDiffusionModel(image_size=SIZE, seed=0, device="cuda")
    for name, mode, kw in (("exact", None, {}), ("exact_mb2", None, dict(unet_microbatch=2)),
                           ("int8", "int8", {}), ("int8_conv", "int8_conv", {}),
                           ("tome", None, dict(tome_ratio=0.5))):
        model.engine.set_quant_mode(mode)
        int8_counts(reset=True)
        imgs, rec[f"{name}_execution_time_s"], _ = model(PROMPTS, num_inference_steps=A9B_STEPS,
                                                         guidance_scale=GUIDANCE, seed=29, **kw)
        refs[name] = torch.from_numpy(imgs)
        if mode is not None:
            rec[f"{name}_int8_launches"] = int8_counts()
    for mode in (None, "int8", "int8_conv"):  # after the counted runs: new graphs, new shapes
        model.engine.set_quant_mode(mode)
        refs[f"{mode or 'exact'}_1step"] = torch.from_numpy(model(
            PROMPTS, num_inference_steps=1, guidance_scale=GUIDANCE, seed=29)[0])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    refs["sd3_tome"], rec["sd3_launches"] = a9b_sd3_tome()
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = run_training(load_config(Path(__file__).resolve().parent / "configs" / "train_lora.yaml",
                                   a9b_loop_overrides(root, "one")))
    rec["loop"] = dict(losses=out["losses"], steps_per_sec=out["steps_per_sec"],
                       wall_s=time.perf_counter() - t1,
                       peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    torch.save(refs, root / "a9b_refs.pt")
    rec["s"] = time.perf_counter() - t0
    return rec


def a9b_tokenizer(root, out):
    """Phase 18 (a) in this process: the tokenizer.json the phase wrote,
    read by the port's reader on this machine (no ``tokenizers`` here),
    gives the pinned ids."""
    from sonicdiffusionbayeslab_torch.models.tokenizer import T5UnigramTokenizer, load_t5_tokenizer

    t0 = time.perf_counter()
    tok = load_t5_tokenizer(str(Path(root) / "sd3" / "tokenizer_3"), 32128, 256)
    if not isinstance(tok, T5UnigramTokenizer):
        raise AssertionError("phase 18: the tokenizer.json was not read by the T5 reader")
    got = [tok.encode(p) for p in T5_TOK_PROMPTS]
    if got != T5_TOK_IDS:
        raise AssertionError(f"phase 18: T5 ids {got} != the pinned {T5_TOK_IDS}")
    out["tokenizer"] = dict(prompts=len(T5_TOK_PROMPTS), pieces=len(tok.scores),
                            s=time.perf_counter() - t0)
    print(f"phase 18 (a) T5 tokenizer.json ({len(tok.scores)} pieces) read by the port: "
          f"{len(got)} prompts' ids equal the pinned ids", flush=True)


def a9b_t5_bench(root, out):
    """Phase 18 (a): the tokenizer (``a9b_tokenizer``), the t5_bench twin in
    both modes (each JSON line printed), SD3 with T5 through the
    tokenizer.json (``a9b_sd3_t5_snapshot``)."""
    from sonicdiffusionbayeslab_torch import t5_bench

    a9b_tokenizer(root, out)
    for mode in t5_bench.MODES:
        rec = t5_bench.run_mode(mode, steps=A9B_T5_BENCH_STEPS)
        print(json.dumps(rec), flush=True)
        if not rec["fits"]:
            raise AssertionError(f"phase 18: t5_bench {mode} did not fit: {rec['error']}")
        out[f"t5_bench_{mode}"] = rec
    out["sd3_t5_snapshot"] = a9b_sd3_t5_snapshot(root)
    print(f"phase 18 (a) SD3 with T5-XXL through the snapshot's tokenizer.json: "
          f"{json.dumps(out['sd3_t5_snapshot'])}", flush=True)


def check_a9b_shapes(ranks):
    """Phase 18's kernels at every shape its split runs recorded (the bf16
    LoRA step's forward at H/2 heads and norm2 at C/2, the int8 run's, the
    ToMe runs' merged attention over the gathered map), bf16 and fp32,
    against their plain versions with ``compare``'s gates."""
    from sonicdiffusionbayeslab_torch.ops.groupnorm import plain_group_norm

    shapes = set()
    for recs in ranks.values():
        shapes |= {(kind, tuple(shape)) for kind, shape in recs[0]["kernel_shapes"]}
    if not {"attention", "group_norm", "group_norm_split"} <= {k for k, _ in shapes}:
        raise AssertionError(f"phase 18 recorded only {sorted({k for k, _ in shapes})} shapes")
    gen = torch.Generator(device="cuda").manual_seed(184)
    errs = collections.defaultdict(float)
    for dtype in (torch.bfloat16, torch.float32):
        tag = "" if dtype == torch.bfloat16 else "_fp32"
        for kind, shape in sorted(shapes):
            what = f"phase 18 {kind} {shape} {dtype}"
            if kind == "group_norm_split":
                B, N, C, G, eps, silu, n = shape
                x, w, b = gn_inputs((B, n * N, C), dtype, gen)
                err = compare("group_norm", dtype, split_pair(x, w, b, G, eps, silu, n)[0],
                              plain_group_norm(x, w, b, G, eps, silu), what)
            else:
                inputs = (attn_inputs if kind == "attention" else gn_inputs)(shape, dtype, gen)
                kern, plain = run_kernel(kind, shape, inputs)
                err = compare(kind, dtype, kern(), plain(), what)
            errs[kind + tag] = max(errs[kind + tag], err)
        torch.cuda.empty_cache()
    print(f"phase 18 the kernels at the split runs' {len(shapes)} shapes x bf16/fp32 against "
          f"their plain versions: max abs err {json.dumps(dict(errs))}", flush=True)
    return dict(max_abs_err=dict(errs), shapes=len(shapes))


def a9b_compare(root, ranks, refs_rec, card):
    """Phase 18's gates on the ranks' records and images against the
    references; every failure is collected, printed and raised together."""
    root = Path(root)
    refs = torch.load(root / "a9b_refs.pt")
    mean = lambda a, b: float((a.float() - b.float()).abs().mean())  # noqa: E731
    out, failed = {}, []
    tr = ranks["a9b_train"]
    against = {**tr[0]["against_one_process"], **ranks["a9b_train2"][0]["against_one_process"]}
    out["train"] = against
    if set(against) != {c for cs in A9B_GROUP_CASES.values() for c in cs}:
        failed.append(f"train cases {sorted(against)} compared")
    failed += [f"{case}: {r}" for case, r in against.items() if not r["ok"]]
    one_counts = tr[0]["one_process_launches"]
    for r, rec in enumerate(tr):
        if rec["launches"] != one_counts:
            failed.append(f"train rank {r} launches {rec['launches']} != one process's "
                          f"{one_counts}")
    loop = ranks["a9b_train2"][0]["loop"]
    loop_one, loop_split = refs_rec["loop"]["losses"], loop["losses"]
    loop_rel = max(abs(a - b) / abs(b) for a, b in zip(loop_split, loop_one))
    out["loop"] = dict(split=loop, one=refs_rec["loop"], loss_rel=loop_rel)
    if len(loop_split) != A9B_LOOP_STEPS or loop_rel > A9B_BF16_FLOOR:
        failed.append(f"loop losses {loop_split} against {loop_one}")
    import numpy as np

    got = np.load(root / "loop_split" / "final" / "lora_peft.npz")
    want = np.load(root / "loop_one" / "final" / "lora_peft.npz")
    if sorted(got.files) != sorted(want.files) or any(got[k].shape != want[k].shape
                                                      for k in want.files):
        failed.append("the split loop's lora_peft.npz is not one process's in keys and shapes")
    out["loop"]["max_abs_diff"] = max(float(np.abs(got[k] - want[k]).max()) for k in want.files)
    inf = ranks["a9b_infer"]
    out["fuse"] = inf[0]["fuse"]
    if any(rec["fuse"]["not_bit_equal"] for rec in inf) or not inf[0]["fuse"]["split_tensors"]:
        failed.append(f"fused split weights not bit-equal: {[r['fuse'] for r in inf]}")
    saves = {m: [torch.load(root / f"{m}_rank{r}.pt") for r in range(A9B_WORLD[m])]
             for m in ("a9b_infer", "a9b_seq")}
    failed += a9b_int8_gates(ranks, refs, refs_rec, saves, out, mean)
    runs = {"int8 (mesh_model=2)": ("a9b_infer", "int8", "int8"),
            "int8_conv (mesh_seq=2)": ("a9b_seq", "int8_conv", "int8_conv"),
            "tome 0.5 (mesh_seq=2)": ("a9b_seq", "tome", "tome"),
            "sd3 DiT-ToMe 0.5 (mesh_seq=2)": ("a9b_seq", "sd3_tome", "sd3_tome")}
    out["images"] = {}
    for what, (mode, key, ref) in runs.items():
        got = saves[mode][0][key]
        if any(not torch.equal(s[key], got) for s in saves[mode][1:]):
            failed.append(f"{what}: ranks' images differ")
        d = mean(got, refs[ref])
        gate = (mean(refs[ref], refs["exact"]) + mean(refs["exact_mb2"], refs["exact"])
                if key.startswith("int8") else A9B_TOME_MEAN)
        out["images"][what] = dict(mean_abs=d, gate=gate)
        if not d <= gate:
            failed.append(f"{what}: mean |diff| {d:.3e} > {gate:.3e}")
    print(f"phase 18 against one process ({TP_NOTE}; {card}): {json.dumps(out)}", flush=True)
    if failed:
        raise AssertionError("phase 18: " + "; ".join(failed))
    return out


def a9b_int8_gates(ranks, refs, refs_rec, saves, out, mean):
    """The split int8 runs' gates that a split which ran exact would fail
    (see A9B_GRAD_REL's comment): each rank's int8 layer bit-equal to one
    process's; its int8 launches one process's (a split rank's UNet runs
    eagerly, one call a step; one process's graph records a call
    GraphedCall.WARMUP + 1 times); its one-step int8 images at least half
    as far from its own exact ones as one process's are from its exact
    ones (mean |diff|).  Returns the failures; the readings (the distances
    to one process's one-step images too) go into ``out["int8"]``."""
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    failed, res = [], {}
    runs = {"int8 (mesh_model=2)": ("a9b_infer", "int8", "int8_ff"),
            "int8_conv (mesh_seq=2)": ("a9b_seq", "int8_conv", "int8_conv_rows")}
    for what, (mode, key, layer) in runs.items():
        want = refs_rec[f"{key}_int8_launches"]
        layers = [rec[layer] for rec in ranks[mode]]
        launches = [{k: rec[f"{key}_launches"][k] for k in want} for rec in ranks[mode]]
        got1 = saves[mode][0][f"{key}_1step"]
        d_split = mean(got1, saves[mode][0]["exact_1step"])
        d_one = mean(refs[f"{key}_1step"], refs["exact_1step"])
        res[what] = dict(layer=layers, launches=launches, one_process_launches=want,
                         one_step_int8_vs_exact=d_split, one_process_one_step_int8_vs_exact=d_one,
                         one_step_to_one_process_int8=mean(got1, refs[f"{key}_1step"]),
                         one_step_to_one_process_exact=mean(got1, refs["exact_1step"]))
        if not all(r["bit_equal"] for r in layers):
            failed.append(f"{what}: the int8 layer is not one process's: {layers}")
        conv = key == "int8_conv"
        if not want["int8_dense"] or bool(want["int8_conv"]) != conv or any(
                n[k] * (GraphedCall.WARMUP + 1) != want[k] * A9B_STEPS for n in launches
                for k in want):
            failed.append(f"{what}: int8 launches {launches}, one process's {want} (its graph's "
                          f"{GraphedCall.WARMUP + 1} recordings against {A9B_STEPS} steps)")
        if any(not torch.equal(s[k], saves[mode][0][k]) for s in saves[mode][1:]
               for k in (f"{key}_1step", "exact_1step")):
            failed.append(f"{what}: ranks' one-step images differ")
        if not d_split >= 0.5 * d_one:
            failed.append(f"{what}: the split's one-step int8 images are {d_split:.3e} from its "
                          f"exact ones, one process's {d_one:.3e}")
    out["int8"] = res
    return failed


def run_a9b(report, card):
    """Phase 18: what the JAX package runs under a mesh (training and LoRA
    fusing over model, int8 and ToMe split) and the T5 tokenizer.json
    reader: one-process references,
    gloo rank groups in two waves (the card's 80 GB do not hold all of it
    at once): the two train groups (model) while this process makes the
    one-process references, then ``a9b_infer`` (model) and ``a9b_seq``
    while it reads the tokenizer.json, runs the t5_bench twin and SD3 with
    T5 through the tokenizer.json; the gates; the kernels at the split
    runs' shapes."""
    out = {}
    t0 = time.perf_counter()
    gc.collect()  # the earlier phases' reference cycles hold memory of the card
    torch.cuda.empty_cache()
    print(f"phase 18 starts with {torch.cuda.memory_allocated() / 2**30:.2f} GB allocated in "
          "this process", flush=True)
    with tempfile.TemporaryDirectory(prefix="sdbl_a9b_") as tmp:
        root = Path(tmp)
        a9b_assets(root)
        t1 = time.perf_counter()
        ranks, out["ranks_wall_s"] = {}, {}

        def references():
            out["references"] = a9b_references(root)
            print(f"phase 18 one-process references: {json.dumps(out['references'])}",
                  flush=True)

        for group, during in ((("a9b_train", "a9b_train2"), references),
                              (("a9b_infer", "a9b_seq"), lambda: a9b_t5_bench(root, out))):
            got, out["ranks_wall_s"]["+".join(group)] = run_tp_ranks(root, group, during)
            ranks.update(got)
        refs = out["references"]
        out["ranks"] = {m: [{k: v for k, v in rec.items() if k != "kernel_shapes"}
                            for rec in recs] for m, recs in ranks.items()}
        print(f"phase 18 ranks and (a): {time.perf_counter() - t1:.1f} s wall; "
              + json.dumps(out["ranks"]), flush=True)
        out["against_one_process"] = a9b_compare(root, ranks, refs, card)
    out["kernels"] = check_a9b_shapes(ranks)
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 18 wall clock: {out['wall_s']:.1f} s ({TP_NOTE}); {card}", flush=True)
    report["e2e"]["a9b"] = out
    return out


def phase18_launches(out, kind):
    """A kernel's launches in phase 18: a train rank's bf16 LoRA step, the
    int8 run at mesh_model=2, the int8_conv and ToMe runs and SD3's
    DiT-ToMe run at mesh_seq=2 (rank 0 of each), and the one-process SD3
    run with T5 through the tokenizer.json."""
    r = out["ranks"]
    return {"lora_step_mesh_model2": r["a9b_train"][0]["launches"].get(kind, 0),
            "int8_mesh_model2": r["a9b_infer"][0]["int8_launches"].get(kind, 0),
            "int8_conv_mesh_seq2": r["a9b_seq"][0]["int8_conv_launches"].get(kind, 0),
            "tome_mesh_seq2": r["a9b_seq"][0]["tome_launches"].get(kind, 0),
            "sd3_tome_mesh_seq2": r["a9b_seq"][0]["sd3_launches"].get(kind, 0),
            "sd3_t5_snapshot": out["sd3_t5_snapshot"]["launches"].get(kind, 0)}


# ------------------------------------------------- phase 19: prefix, fused
# Phase 19's gates: the prefix's and the fused UNet's bf16 images against
# the plain run's (mean |diff|, the split runs' bf16 gate of phase 17), the
# prefix's fp32 forward (TF32 off) against the plain one (relative L2).
P19_IMAGE_MEAN, P19_FP32_REL = 5e-2, 1e-5


def park(model, device):
    """The pipeline's engine modules moved to ``device`` (phase 5's weights
    wait in host memory through phases 6-18), its graphs dropped."""
    eng = model.engine
    eng.weights_changed()
    for m in eng.modules():
        m.to(device)
    gc.collect()
    torch.cuda.empty_cache()


def is_gemm(name):
    """A cuBLAS or cuBLASLt GEMM kernel (trace_analysis' matmul group), not
    a split-K GEMM's reduction kernel: one a matmul."""
    from sonicdiffusionbayeslab_torch.utils.trace_analysis import kernel_group

    return kernel_group(name) == "matmuls (cuBLAS)" and "reduce" not in name.lower()


def fused_unet(unet):
    """A fused copy of ``unet`` (``to_qkv``, ``to_kv``) on the card, from its
    weights through ``weights.fuse_projections``."""
    from sonicdiffusionbayeslab_torch.models.unet import UNet2DCondition
    from sonicdiffusionbayeslab_torch.models.weights import fuse_projections

    with torch.device("meta"):
        fused = UNet2DCondition(unet.config, fused_qkv=True)
    fused = fused.to(unet.dtype).to_empty(device="cuda").requires_grad_(False).eval()
    fused = fused.to(memory_format=torch.channels_last)
    fused.load_state_dict(fuse_projections(unet.state_dict(), fused), strict=True)
    return fused


def fused_view_checks(census, report):
    """The bf16 attention kernel on q, k and v as the strided views a fused
    projection gives it (``to_qkv``'s [B, N, 3 H D], or ``to_q`` and
    ``to_kv``'s [B, M, 2 H D]) at every attention shape of the main path,
    against its plain version on the same views."""
    from sonicdiffusionbayeslab_torch.ops.attention import plain_attention
    from sonicdiffusionbayeslab_torch.ops.flash_attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(19)
    errs = {}
    for kind, shape in sorted(k for k in census if k[0] == "attention"):
        B, N, M, H, D = shape
        mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
        if N == M:  # a self-attention: one [B, N, 3 H D] output, its q section scaled in place
            qkv = mk(B, N, 3 * H * D)
            qkv[..., :H * D] *= 3
            q, k, v = (t.view(B, N, H, D) for t in qkv.split(H * D, dim=-1))
        else:  # a cross: to_q's own output, to_kv's [B, M, 2 H D]
            q = mk(B, N, H, D) * 3
            k, v = (t.view(B, M, H, D) for t in mk(B, M, 2 * H * D).split(H * D, dim=-1))
        row = 3 * H * D if N == M else 2 * H * D
        if (q.stride(1) != (row if N == M else H * D) or k.stride(1) != row
                or v.stride(1) != row):
            raise AssertionError(f"attention {shape}: q/k/v strides {q.stride()}, {k.stride()}, "
                                 f"{v.stride()} are not a fused projection's views")
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        errs[str(shape)] = compare("attention", torch.bfloat16, got, plain_attention(q, k, v),
                                   f"attention {shape} on fused views")
        report["phase19_errs"]["attention"].append(errs[str(shape)])
    print(f"phase 19 (b) bf16 attention on fused strided q/k/v views: max abs err {errs}")
    return errs


def run_prefix_fused(report, card, model, per_unet, per_vae, main_counts):
    """Phase 19 on the main path's pipeline (phase 5's weights): (a) the CFG
    shared prefix (``SDBL_CFG_PREFIX=1``, the sanitizer on), graphed: its
    census on the meta device, its kernels at the shapes it adds, the
    wrappers' launches over the capturing run and a trace's over a warm
    one, the images against the plain run's, the fp32 forward against the
    plain one, the loops in turns; (b) a fused copy of the UNet: its fp32
    forward against the separate one's, a 20-step run, the attention kernel
    on fused strided views, the cuBLAS GEMMs of one eager forward each way; (c) the sanitizer on the tiny fp32 NaN plan."""
    import copy

    import numpy as np

    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
    from sonicdiffusionbayeslab_torch.schedulers import DPMSolverScheduler
    from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedCall

    t_phase = time.perf_counter()
    out = {}
    eng = model.engine
    kw = dict(num_inference_steps=STEPS, guidance_scale=GUIDANCE, seed=29)
    # (a) The prefix's census: the same launches a forward, some at B rows.
    pcensus = module_census(2 * BATCH, prefix=True)
    per_prefix = _kinds(pcensus)
    new_shapes = sorted(set(pcensus) - set(main_counts))
    b_rows = {str(k): n for k, n in pcensus.items() if k[1][0] == BATCH}
    print(f"phase 19 (a) prefix census a UNet forward: {dict(per_prefix)}, at {BATCH} rows "
          f"{b_rows}; shapes no earlier phase runs: {new_shapes}")
    if {k: per_prefix[k] for k in MAIN} != {k: per_unet[k] for k in MAIN} or not b_rows:
        raise AssertionError(f"the prefix's census {dict(per_prefix)} is not the plain "
                             f"forward's {dict(per_unet)} with some calls at {BATCH} rows")
    errs = {}
    gen = torch.Generator(device="cuda").manual_seed(190)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dtype in (torch.bfloat16, torch.float32):  # fp32: the forward below launches them
        for kind, shape in new_shapes:
            inputs = (attn_inputs if kind == "attention" else gn_inputs)(shape, dtype, gen)
            kern, plain = run_kernel(kind, shape, inputs)
            got = kern()
            torch.cuda.synchronize()
            what = f"{kind} {str(dtype)[6:]} {shape}"
            errs[what] = compare(kind, dtype, got, plain(), f"{what} (prefix)")
            report["phase19_errs"][report_key(kind, dtype)].append(errs[what])
    torch.backends.cudnn.allow_tf32 = True  # bf16 runs: TF32 is not used anyway
    print(f"phase 19 (a) kernels at the prefix's shapes against their plain versions: {errs}")
    timings = [timing_row(kind, shape, torch.bfloat16, "prefix", STEPS * pcensus[(kind, shape)],
                          gen) for kind, shape in new_shapes]
    os.environ["SDBL_CHECK_NANS"] = "1"  # the sanitizer on every run of (a) and (b)
    try:
        wrapper_counts(reset=True)
        model(PROMPTS, **kw)  # the plain variant's capture (park dropped the graphs)
        plain_cap = bf16_only(wrapper_counts(), "phase 19 plain capture")
        os.environ["SDBL_CFG_PREFIX"] = "1"
        wrapper_counts(reset=True)
        model(PROMPTS, **kw)
        counts = bf16_only(wrapper_counts(), "phase 19 prefix capture")
        want = {k: (GraphedCall.WARMUP + 1) * per_prefix[k] + per_vae[k] for k in MAIN}
        if counts != want or plain_cap != want:
            raise AssertionError(f"phase 19 capturing runs' wrappers: prefix {counts}, plain "
                                 f"{plain_cap}, expected {want}")
        times = {"plain": [], "prefix": []}
        images = {}
        for name in ("plain", "prefix", "prefix", "plain"):  # in turns
            if name == "plain":
                os.environ.pop("SDBL_CFG_PREFIX", None)
            else:
                os.environ["SDBL_CFG_PREFIX"] = "1"
            imgs, t_loop, _ = model(PROMPTS, **kw)
            check_images(imgs)
            times[name].append(t_loop)
            images[name] = imgs
        os.environ["SDBL_CFG_PREFIX"] = "1"
        wrapper_counts(reset=True)
        want = {k: STEPS * per_prefix[k] + per_vae[k] for k in MAIN}
        (imgs_traced, _, _), traced, _ = traced_exact(
            lambda: model(PROMPTS, **kw), want, "the prefix run",
            same=lambda o: np.array_equal(o[0], images["prefix"]), reset=retrace_reset())
        traced = bf16_only(traced, "the prefix run (trace)")
        if traced != want or not np.array_equal(imgs_traced, images["prefix"]):
            raise AssertionError(f"the prefix run: traced {traced}, expected {want}; or other "
                                 "images on a second identical run")
        captures = dict(eng.graphed_unet.captures)
    finally:
        os.environ.pop("SDBL_CFG_PREFIX", None)
    mean = float(np.abs(images["prefix"] - images["plain"]).mean())
    # The fp32 forward, TF32 off: the prefix against the plain call.
    torch.backends.cudnn.allow_tf32 = False
    u32 = copy.deepcopy(eng.unet).float()
    g = torch.Generator(device="cuda").manual_seed(191)
    lat = torch.randn(BATCH, SIZE // 8, SIZE // 8, 4, generator=g, device="cuda")
    ctx = torch.randn(2 * BATCH, 77, 768, generator=g, device="cuda")
    tb = torch.full((BATCH,), 601.0, device="cuda")
    with torch.inference_mode():
        fp_prefix = u32(lat, tb, ctx, cfg_shared_prefix=True)
        fp_plain = u32(torch.cat([lat, lat]), torch.cat([tb, tb]), ctx)
    rel = rel_l2(fp_prefix, fp_plain)
    del fp_prefix
    torch.backends.cudnn.allow_tf32 = True
    out["prefix"] = dict(
        census=dict(per_prefix), b_rows=b_rows, kernel_errs=errs, timings=timings,
        capture_wrappers=counts,
        traced=traced, images_mean_abs_diff=mean, fp32_rel_l2=rel, loop_s=times, captures={
            str(k): v for k, v in captures.items()})
    print(f"phase 19 (a) prefix: capturing run's wrappers {counts}, traced {traced}; images {mean:.3e} mean |diff| from plain (gate {P19_IMAGE_MEAN}); "
          f"fp32 forward {rel:.3e} relative L2 (gate {P19_FP32_REL}); loops in turns {times} s; "
          f"graph captures {captures}; {card}", flush=True)
    if not mean <= P19_IMAGE_MEAN or not rel <= P19_FP32_REL:
        raise AssertionError("the prefix changed the images or the fp32 forward")

    # (b) The fused copy of the main path's UNet.  First its fp32 forward,
    # TF32 off, against the separate one's at (a)'s inputs.
    torch.backends.cudnn.allow_tf32 = False
    f32 = fused_unet(u32)
    with torch.inference_mode():
        frel = rel_l2(f32(torch.cat([lat, lat]), torch.cat([tb, tb]), ctx), fp_plain)
    del u32, f32, fp_plain
    torch.backends.cudnn.allow_tf32 = True
    print(f"phase 19 (b) fused UNet's fp32 forward: {frel:.3e} relative L2 from the separate "
          f"one's (gate {P19_FP32_REL})", flush=True)
    if not frel <= P19_FP32_REL:
        raise AssertionError("the fused UNet changed the fp32 forward")
    separate = eng.unet
    fused = fused_unet(separate)
    removed = sum(2 if hasattr(m, "to_qkv") else 1 for m in fused.modules()
                  if getattr(m, "fused_qkv", False) and hasattr(m, "to_out"))
    emb = eng.encode_prompts(model.tokenizer(PROMPTS))
    embeds = torch.cat([eng.encode_prompts(model.tokenizer([""] * BATCH)), emb])
    lat = torch.randn(2 * BATCH, SIZE // 8, SIZE // 8, 4, generator=g, device="cuda").to(eng.dtype)
    tb = torch.full((2 * BATCH,), 499.0, device="cuda")
    gemms = {}
    with torch.inference_mode():
        for name, unet in (("separate", separate), ("fused", fused)):
            unet(lat, tb, embeds)
            wrapper_counts(reset=True)
            _, c, _ = traced_exact(lambda: unet(lat, tb, embeds), {k: per_unet[k] for k in MAIN},
                                   f"an eager {name} UNet forward", reset=retrace_reset(),
                                   symbols={"gemm": is_gemm})
            gemms[name] = c["gemm"]
    print(f"phase 19 (b) cuBLAS GEMM kernels of one eager UNet forward at batch {2 * BATCH}: "
          f"{gemms}; the fusion removes {removed} projections", flush=True)
    if gemms["separate"] - gemms["fused"] != removed:
        raise AssertionError(f"the fused forward's GEMMs {gemms} do not drop by {removed}")
    eng.unet = fused
    eng.weights_changed()
    try:
        wrapper_counts(reset=True)
        model(PROMPTS, **kw)
        fcounts = bf16_only(wrapper_counts(), "phase 19 fused capture")
        want = {k: (GraphedCall.WARMUP + 1) * per_unet[k] + per_vae[k] for k in MAIN}
        if fcounts != want:
            raise AssertionError(f"the fused run's wrappers {fcounts}, expected {want}")
        fimgs, f_loop, _ = model(PROMPTS, **kw)
        check_images(fimgs)
    finally:
        eng.unet = separate
        eng.weights_changed()
    fmean = float(np.abs(fimgs - images["plain"]).mean())
    view_errs = fused_view_checks(main_counts, report)
    out["fused"] = dict(capture_wrappers=fcounts, gemms_a_forward=gemms, removed=removed,
                        fp32_rel_l2=frel, images_mean_abs_diff=fmean, loop_s=f_loop, view_errs=view_errs)
    print(f"phase 19 (b) fused UNet: capturing run's wrappers {fcounts}; images {fmean:.3e} "
          f"mean |diff| from plain (gate {P19_IMAGE_MEAN}); loop {f_loop:.4f} s; {card}",
          flush=True)
    if not fmean <= P19_IMAGE_MEAN:
        raise AssertionError("the fused UNet changed the images")
    del fused

    # (c) The sanitizer on the NaN plan (ROADMAP.md section C), tiny fp32.
    tiny_pipe = StableDiffusionModel(tiny=True, dtype="float32", seed=0, device="cuda")
    tiny, ids = tiny_pipe.engine, tiny_pipe.tokenizer(PROMPTS)
    nan_plan = DPMSolverScheduler(algorithm_type="dpmsolver",
                                  final_sigmas_type="zero").build_plan(STEPS)
    try:
        tiny.sample(nan_plan, tiny.encode_prompts(ids), tiny.encode_prompts(ids),
                    latent_hw=(8, 8), check_nans=True)
    except FloatingPointError as e:
        out["sanitizer"] = str(e)
    else:
        raise AssertionError("the sanitizer let the NaN plan's latents through")
    finally:
        os.environ.pop("SDBL_CHECK_NANS", None)
    print(f"phase 19 (c) sanitizer: the finite runs passed; the NaN plan raised "
          f"FloatingPointError: {out['sanitizer']}")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 19 took {out['wall_s']:.1f} s", flush=True)
    report["e2e"]["phase19"] = out


def phase19_launches(out, kind):
    """A kernel's launches in phase 19: the prefix's traced run and its
    capturing run's wrappers, the fused UNet's capturing run's wrappers."""
    if kind not in MAIN:
        return {}
    return {"prefix_traced_run": out["prefix"]["traced"][kind],
            "prefix_capture_wrappers": out["prefix"]["capture_wrappers"][kind],
            "fused_capture_wrappers": out["fused"]["capture_wrappers"][kind]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the denoising loop with torch.profiler")
    ap.add_argument("--json", default=None, help="write the full report to this path")
    ap.add_argument("--phase19-only", action="store_true",
                    help="phases 1, 2 and 19 alone, on a model of its own (a rehearsal; prints "
                         "no ok line)")
    # The rank processes of phases 16-18: this script started by start_rank
    # (phase 16's run_dp_ranks, run_tp_ranks), or by prestart_ranks to wait
    # for its go file; the go: the group's address and directory.
    ap.add_argument("--dp-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-mode", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--spawned", type=float, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--parent", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--go", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--go-file", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dp_rank is not None or args.tp_rank is not None:
        if not torch.cuda.is_available():
            print("no CUDA device: this script needs a GPU", file=sys.stderr)
            sys.exit(1)
        go = (wait_for_go(args.go_file, args.spawned, args.parent) if args.go_file
              else json.loads(args.go))
        if args.dp_rank is not None:
            dp_rank(args.dp_rank, go["addr"], go["dir"])
        else:
            tp_rank(args.tp_rank, args.tp_mode, go["addr"], go["dir"], args.spawned, go["at"])
        return

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
    from concurrent.futures import ThreadPoolExecutor

    from sonicdiffusionbayeslab_torch.ops import _build

    def build():
        t0 = time.perf_counter()
        _build.kernels()
        print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
        return sass_counts(_build)

    # nvcc and cuobjdump run while this thread takes the census on the meta
    # device, which needs no kernel.
    builder = ThreadPoolExecutor(1)
    built = builder.submit(build)

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
    report_sass = built.result()
    builder.shutdown()
    print_gn_plans(shapes)
    report = {k: {"launches": None, "wrapper_launches": None, "launches_from": None,
                  "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                  "bound_fma_ms": 0.0, "bound_by_ms": collections.Counter()}
              for k in (*KERNELS, "attention_fp32_unet")}
    report["errs"] = collections.defaultdict(list)
    report["phase10_errs"] = collections.defaultdict(list)
    report["phase12_errs"] = collections.defaultdict(list)
    report["phase13_errs"] = collections.defaultdict(list)
    report["phase14_errs"] = collections.defaultdict(list)
    report["phase14_grad_errs"] = collections.defaultdict(list)
    report["phase15_errs"] = collections.defaultdict(list)
    report["phase15_grad_errs"] = collections.defaultdict(list)
    report["phase19_errs"] = collections.defaultdict(list)
    report["e2e"] = {}
    if args.phase19_only:
        from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel

        phase("19 alone")
        run_prefix_fused(report, card, StableDiffusionModel(image_size=SIZE, dtype="bfloat16",
                                                            seed=0, device="cuda"),
                         per_unet, per_vae, run_counts)
        print(json.dumps({k: phase19_launches(report["e2e"]["phase19"], k) for k in MAIN}))
        return

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
    main_model = run_main_path(report, per_unet, per_vae, tiny_census, card, args.profile)
    park(main_model, "cpu")  # its weights wait in host memory for phase 19

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

    with tempfile.TemporaryDirectory(prefix="sdbl_assets_") as tmp:
        phase(f"9. quality metrics: configs/ddim_config.yaml as shipped with a real-image "
              f"directory and aesthetic_score, SD-1.5 {SIZE}x{SIZE}, batch {METRIC_BATCH}")
        assets = dict(run_metrics(report, card, metric_counts, tmp), root=tmp)

        phase(f"10. SD-2.1 (768-v) and SDXL-base: sd21_config.yaml and sdxl_config.yaml as "
              f"shipped at full width, batch {FAMILY_BATCH}")
        run_families(report, card, assets)

        phase(f"11. img2img and inpainting at SD-1.5 {SIZE}x{SIZE} (strength {STRENGTH}), the "
              f"SDXL encoder at {ENC_XL_SIZE}^2, and turbo_config.yaml ({TURBO_QUANT} + ToMe "
              f"{TURBO_TOME}) as shipped, batch {TURBO_BATCH}")
        run_img2img_quant(report, card, assets, args.profile)

        phase(f"12. SD3-medium at {SD3_SIZE}x{SD3_SIZE}: flow Euler loops (exact, trunk-delta, "
              f"ToMe, int8, T5 staged and resident), the three sd3 configs as shipped at batch "
              f"{SD3_CLI_BATCH}, and the quality frontier")
        run_sd3(report, card, assets, args.profile)

    phase(f"13. serving (HTTP at max_batch {SERVE_BATCH}, serve_bench hero at batch "
          f"{SERVE_BENCH_BATCH}) and ControlNet, IP-Adapter and prompt weighting at SD-1.5 "
          f"{SIZE}x{SIZE}")
    checked = ({(k, torch.bfloat16) for k in check_shapes}
               | {(k, torch.float32) for k in check_shapes}
               | {(k, torch.float32) for k, _ in fp32_shapes})
    run_serving_conditioning(report, card, checked)

    phase(f"14. training at SD-1.5 {SIZE}x{SIZE} (configs/train_lora.yaml through the loop, "
          f"batch {TRAIN_BATCH}; train_bench {', '.join(TRAIN_BENCH_MODES)}), gradients through "
          "the kernels' autograd Functions, tiny fp32 steps card vs CPU")
    run_training_phase(report, card, checked, args.profile)

    phase(f"15. LCM distillation (LCM-LoRA through the loop, the w-conditioned full student "
          f"and its LCM sampling) and textual inversion at SD-1.5 {SIZE}x{SIZE}, K/V-only "
          "gradients through the bf16 attention Function, tiny fp32 steps card vs CPU")
    run_distill_phase(report, card, checked, args.profile)

    phase(f"16. multi-device: a one-rank NCCL group; SD-1.5 {SIZE}x{SIZE} data-parallel sampling "
          f"(batch {len(DP_PROMPTS)}) and train_lora.yaml (batch 8) on {DP_RANKS} gloo ranks "
          "sharing the card, against one process; profiling.trace, trace_analysis and "
          "flops_estimate")
    run_multi_device(report, card)

    phase(f"17. tensor and sequence parallel on ranks sharing the card: the split GroupNorm "
          f"kernels; SD-1.5 {SIZE}x{SIZE} at mesh_model=2, mesh_seq=2 and 2 x 2 (fp32 and "
          f"bf16), SD3-medium {SD3_SIZE}x{SD3_SIZE} with T5-XXL at mesh_model=2 and mesh_seq=2, "
          "the server at mesh_model=2, each against one process")
    run_tensor_parallel(report, card)

    phase(f"18. the T5 tokenizer.json reader and the t5_bench twin (SD3-medium with T5-XXL at "
          f"{SD3_SIZE}x{SD3_SIZE}, staged and resident); on gloo ranks sharing the card against "
          f"one process: training at mesh_model=2 (train_lora.yaml through the loop; LoRA, full "
          f"with remat, ControlNet, LCM-LoRA and SD3 LoRA steps), fuse_lora on split weights, "
          f"int8 at mesh_model=2 and int8_conv at mesh_seq=2, ToMe 0.5 at mesh_seq=2 (SD-1.5 "
          f"{SIZE}x{SIZE}; SD3 with T5 through the tokenizer.json)")
    run_a9b(report, card)

    phase(f"19. the CFG shared prefix (graphed), a fused-q/k/v copy of the main path's UNet and "
          f"the NaN sanitizer, on phase 5's SD-1.5 weights at {SIZE}x{SIZE}, batch {BATCH}")
    park(main_model, "cuda")
    run_prefix_fused(report, card, main_model, per_unet, per_vae, run_counts)
    del main_model

    phase("20. kernels")
    print(f"phases 1-19 took {time.perf_counter() - _T0:.1f} s; {card}")
    fam = report["e2e"]["families"]
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
            "phase10_wrapper_launches": {
                **{f"{f} cli": fam[f"{f}_cli"]["wrapper_launches"][kind] for f in FAMILIES},
                **{f"{f} cli trace": fam[f"{f}_cli"]["traced_launches"][kind] for f in FAMILIES},
                **{f"{f} engine": fam[f"{f}_engine"]["first_run_wrapper_launches"].get(kind, 0)
                   for f in FAMILIES},
                **{f"tiny {f}": m["fp32_attention_launches"]
                   for f, m in fam["tiny_card_vs_cpu"].items() if kind == "attention_fp32"}},
            "phase10_totals": {f"{f} {part}": t[part][kind] for f, t in
                               fam["kernel_totals"].items() for part in t if kind in t[part]},
            "phase10_max_abs_err": max(report["phase10_errs"][kind], default=None),
            "phase11_wrapper_launches": phase11_launches(report["e2e"]["img2img_quant"], kind),
            "phase12_wrapper_launches": phase12_launches(report["e2e"]["sd3"], kind),
            "phase12_totals": {part: t[kind] for part, t in
                               report["e2e"]["sd3"]["kernel_totals"].items() if kind in t},
            "phase12_max_abs_err": max(report["phase12_errs"][kind], default=None),
            "phase13_wrapper_launches": phase13_launches(report["e2e"]["serving_conditioning"],
                                                         kind),
            "phase13_max_abs_err": max(report["phase13_errs"][kind], default=None),
            "phase14_wrapper_launches": phase14_launches(report["e2e"]["training"], kind),
            "phase14_max_abs_err": max(report["phase14_errs"][kind], default=None),
            "phase14_max_abs_grad_err": max(report["phase14_grad_errs"][kind], default=None),
            "phase15_wrapper_launches": phase15_launches(report["e2e"]["distillation"], kind),
            "phase15_max_abs_err": max(report["phase15_errs"][kind], default=None),
            "phase15_max_abs_grad_err": max(report["phase15_grad_errs"][kind], default=None),
            "phase16_launches": phase16_launches(report["e2e"]["multi_device"], kind),
            "phase17_launches": phase17_launches(report["e2e"]["tensor_parallel"], kind),
            "phase18_launches": phase18_launches(report["e2e"]["a9b"], kind),
            "phase18_max_abs_err": {k: v for k, v in
                                    report["e2e"]["a9b"]["kernels"]["max_abs_err"].items()
                                    if k.startswith(kind)},
            "phase19_launches": phase19_launches(report["e2e"]["phase19"], kind),
            "phase19_max_abs_err": max(report["phase19_errs"][kind], default=None),
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
    tp = report["e2e"]["tensor_parallel"]
    for kind, meta in SPLIT_GN.items():
        r = tp["split_group_norm"]["kernels"][kind]
        kernels.append({
            **meta, "launches": tp["ranks"]["seq"][0]["bfloat16"]["launches"][kind],
            "launches_from": "the wrappers' count over phase 17's bf16 mesh_seq=2 SD-1.5 run "
                             f"({TP_SHORT_STEPS} steps, batch 2) on rank 0, reset just before it",
            "phase17_launches": phase17_launches(tp, kind),
            "phase18_launches": phase18_launches(report["e2e"]["a9b"], kind),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "totals_over": "the UNet's GroupNorm shapes at a mesh_seq=2 rank's rows in bfloat16: "
                           "per-shape median x launches at that shape in one run",
        })
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
             "kernels": kernels, "timings": rows, "tome_timings": report["tome_timings"],
             "phase10_timings": fam["timings"],
             "phase11_gn_encoder_timings": report["e2e"]["img2img_quant"]["gn_encoder_timings"],
             "phase11_int8_gemms": report["e2e"]["img2img_quant"]["int8_gemms"],
             "phase12_timings": report["e2e"]["sd3"]["timings"],
             "phase13_ip_timings": report["e2e"]["serving_conditioning"]["ip_timings"],
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
