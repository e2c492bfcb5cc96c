"""Config-driven fine-tuning loop.

Counterpart of ``sonicdiffusionbayeslab_tpu/training/loop.py``: drives
:class:`DiffusionTrainer` (``training.mode: diffusion``, the default) or
:class:`LCMDistiller` (``mode: distill``, LCM consistency distillation of
an SD-1.5/2.x UNet) from the experiment YAML (``model`` and ``dataset``
sections as the CLI reads them, plus a ``training`` section whose keys
that name the trainer's config fields set them):

  images + captions -> VAE encode (frozen) + text encode (frozen)
  -> train_step (noise, UNet, loss, optimizer, EMA), or distill_step
     (the teacher with CFG against the empty prompt's context, encoded
     once; the EMA target; the student)
  -> metric lines every ``log_every`` steps and checkpoints under
     ``save_dir`` (``step_<n>/`` every ``save_every`` steps, ``final/``)

    python -m sonicdiffusionbayeslab_torch.training.loop --config configs/train_lora.yaml \\
        [--set training.num_steps=12 ...] [--device cpu]

A LoRA run (LCM-LoRA too) writes ``lora_peft.npz`` from the trained
adapters (the peft layout that ``models/weights.py::merge_lora`` reads, as
the JAX package writes it); a full or ControlNet run writes the trained
weights as a torch state dict under diffusers names
(``unet/diffusion_pytorch_model.bin`` or
``controlnet/diffusion_pytorch_model.bin``, which ``load_sd_checkpoint``
and ``load_controlnet_checkpoint`` read; a full distillation's student
from its EMA target), where the JAX package writes an orbax checkpoint.
Textual inversion is a library API
(``training/textual_inversion.py``), not a mode, as in the JAX package.

``training.mesh_data`` N > 1 trains data-parallel on N ranks (one
process a GPU):

    torchrun --nproc_per_node N -m sonicdiffusionbayeslab_torch.training.loop \
        --config configs/train_lora.yaml --set training.mesh_data=N

``batch_size`` stays the global batch.  Every rank draws the prep noise
of the global batch and encodes its own rows; the trainer draws the
global batch's timesteps and noise and averages the gradients over the
ranks, so every rank takes the one-process step.  Rank 0 alone prints and
saves.  ``mesh_model`` or ``mesh_seq`` above 1 raises (ROADMAP.md A9).
"""

from __future__ import annotations

import argparse
import dataclasses
import queue as queue_mod
import threading
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from sonicdiffusionbayeslab_torch.parallel import distributed
from sonicdiffusionbayeslab_torch.parallel.distributed import initialize
from sonicdiffusionbayeslab_torch.parallel.mesh import batch_sharding, check_data_only, make_mesh
from sonicdiffusionbayeslab_torch.training.distillation import LCMDistillConfig, LCMDistiller
from sonicdiffusionbayeslab_torch.training.trainer import DiffusionTrainer, TrainConfig
from sonicdiffusionbayeslab_torch.utils.device import resolve_device, synchronize


def train_config_from_dict(d: Dict[str, Any], cls=TrainConfig):
    """``cls`` (``TrainConfig`` or ``LCMDistillConfig``) from the keys of
    ``d`` that name its fields, ``betas`` as a tuple."""
    keep = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in dict(d).items() if k in keep}
    if "betas" in kw:
        kw["betas"] = tuple(kw["betas"])
    return cls(**kw)


def _generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, stream)."""
    state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & (2**63 - 1))


def run_training(config) -> Dict[str, Any]:
    """Returns {"losses": [...] (one a logged step), "state", "trainer",
    "engine", "steps_per_sec"} (steady state: steps 2..N over the time
    from step 1's end to the last step's, the device synchronised at both
    ends; before the final save)."""
    from sonicdiffusionbayeslab_torch.data.dataset import ImageDatasetWithPrompts, batched
    from sonicdiffusionbayeslab_torch.registry import load_all_plugins, models_registry

    load_all_plugins()
    tcfg_raw = dict(config.get("training", {}))
    num_steps = int(tcfg_raw.pop("num_steps", 100))
    batch_size = int(tcfg_raw.pop("batch_size",
                                  config.get("inference", {}).get("batch_size", 4)))
    log_every = int(tcfg_raw.pop("log_every", 10))
    save_every = int(tcfg_raw.pop("save_every", 0))
    save_dir = tcfg_raw.pop("save_dir", None)
    seed = int(config.get("experiment", {}).get("seed", 29))
    n_data = int(tcfg_raw.pop("mesh_data", 0)) or 1
    check_data_only(tcfg_raw.pop("mesh_seq", 1), tcfg_raw.pop("mesh_model", 1) or 1,
                    "training")
    mode = str(tcfg_raw.pop("mode", "diffusion"))
    prefetch = int(tcfg_raw.pop("prefetch", 2))
    if mode not in ("diffusion", "distill"):
        raise ValueError(f"unknown training mode {mode!r} (diffusion|distill)")
    # Checked before the weights are built: the world must hold the mesh.
    mesh = (make_mesh(n_data, device_type=resolve_device(config.model.get("device")).type)
            if n_data > 1 else None)
    shard = batch_sharding(mesh)
    shard.rows(batch_size)  # the global batch must divide over the data axis
    main = distributed.is_main()

    mcfg = dict(config.model)
    name = mcfg.pop("model_name", "stable_diffusion_model")
    mcfg.setdefault("image_size", config.dataset.get("image_size", 512))
    pipe = models_registry[name](**mcfg)
    engine = pipe.engine
    dev = engine.device
    is_sd3 = hasattr(engine, "encode_prompts_sd3")
    is_sdxl = (not is_sd3) and hasattr(engine, "encode_prompts_xl")
    if is_sd3:
        # The MMDiT is a velocity model: flow matching is its objective, and
        # its LoRAs train both joint-attention streams.
        from sonicdiffusionbayeslab_torch.training.lora import MMDIT_TARGETS

        tcfg_raw.setdefault("objective", "flow")
        tcfg_raw.setdefault("lora_targets", MMDIT_TARGETS)
        if mode == "distill":
            raise ValueError("LCM distillation targets the UNet family; the "
                             "MMDiT family trains with objective: flow")
    if is_sdxl and mode == "distill":
        raise ValueError("LCM distillation is wired for the SD-1.5/2.x UNet "
                         "family (no added_cond plumbing in the distiller)")

    dcfg = config.dataset
    dataset = ImageDatasetWithPrompts(dcfg["img_dataset"], dcfg["prompts"],
                                      dcfg.get("image_size", 512))
    if len(dataset) < batch_size:
        raise ValueError(f"dataset has {len(dataset)} items < batch_size {batch_size}")

    local_batch = batch_size // shard.count
    if mode == "distill":
        trainer = LCMDistiller(engine, train_config_from_dict(tcfg_raw, LCMDistillConfig),
                               mesh=mesh)
        # The empty prompt's context is constant: encoded once.
        uncond = engine.encode_prompts(pipe.tokenizer([""] * local_batch))
    else:
        trainer = DiffusionTrainer(engine, train_config_from_dict(tcfg_raw), mesh=mesh)
    state = trainer.init_state(generator=_generator(dev, seed, 0))
    step_gen, prep_gen = _generator(dev, seed, 1), _generator(dev, seed, 2)
    vcfg = engine.vae_config
    down = 2 ** (len(vcfg.block_out_channels) - 1)
    t5 = []  # the staged mode's copy of T5 on the card, made at the first encode

    def prep(batch) -> tuple:
        """Batch prep of this rank's rows: VAE encode (its posterior
        sample's noise drawn for the global batch from the loop's prep
        generator) and text encode."""
        images = torch.as_tensor(batch["image"], dtype=torch.float32)
        B, H, W, _ = images.shape
        noise = torch.randn((B, H // down, W // down, vcfg.latent_channels),
                            generator=prep_gen, device=prep_gen.device)
        images, noise = shard.take(images).to(dev), shard.take(noise)
        B = images.shape[0]
        latents = engine.encode_image(images, noise=noise)
        prompts = list(shard.take(list(batch["prompt"])))
        added = None
        if is_sd3:
            ids3 = pipe.tokenizer3(prompts) if pipe.tokenizer3 is not None else None
            if ids3 is not None and pipe.t5_staged and not t5:
                t5.append(engine.t5_copy(dev))
            context, pooled = engine.encode_prompts_sd3(
                pipe.tokenizer(prompts), pipe.tokenizer2(prompts), ids3, t5[0] if t5 else None)
            added = {"text_embeds": pooled}
        elif is_sdxl:
            context, pooled = engine.encode_prompts_xl(pipe.tokenizer(prompts),
                                                       pipe.tokenizer2(prompts))
            # text_time for images already at the target size: (orig_h,
            # orig_w, crop_top, crop_left, target_h, target_w).
            time_ids = torch.tensor([H, W, 0.0, 0.0, H, W], device=dev).repeat(B, 1)
            added = {"text_embeds": pooled, "time_ids": time_ids}
        else:
            context = engine.encode_prompts(pipe.tokenizer(prompts))
        # ControlNet: identity conditioning, the raw image is the hint.
        hint = images if trainer.target == "controlnet" else None
        return latents, context, hint, added

    def raw_batches():
        step_i = 0
        while step_i < num_steps:
            for batch in batched(dataset, batch_size):
                if step_i >= num_steps:
                    return
                if len(batch["prompt"]) < batch_size:
                    continue  # drop the short remainder
                yield batch
                step_i += 1

    # prefetch = queue depth of a producer thread running the prep ahead of
    # the steps; 0 = inline.
    if prefetch:
        q: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Queue ``item`` unless the consumer has stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def producer():
            try:
                for batch in raw_batches():
                    if not put(prep(batch)):
                        return
            except BaseException as e:  # surfaced in the consumer
                put(e)
                return
            put(None)

        worker = threading.Thread(target=producer, daemon=True, name="sdbl-train-prefetch")
        worker.start()

        def prepared():
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item

        stream = prepared()
    else:
        stream = (prep(batch) for batch in raw_batches())

    losses: list = []
    step = 0
    t0 = time.perf_counter()
    t_first = t_last = None
    try:
        for latents, context, hint, added in stream:
            if mode == "distill":
                state, metrics = trainer.distill_step(state, latents, context, uncond, step_gen)
            else:
                state, metrics = trainer.train_step(state, latents, context, step_gen,
                                                    hint=hint, added=added)
            step += 1
            if step == 1:
                synchronize(dev)
                t_first = time.perf_counter()
            if step % log_every == 0 or step == num_steps:
                loss = float(metrics["loss"])
                losses.append(loss)
                rate = step / (time.perf_counter() - t0)
                if main:
                    print(f"step {step}/{num_steps} loss {loss:.4f} "
                          f"grad_norm {float(metrics['grad_norm']):.3f} ({rate:.2f} it/s)",
                          flush=True)
            if save_every and save_dir and main and step % save_every == 0:
                _save(trainer, state, Path(save_dir), step)
        synchronize(dev)
        t_last = time.perf_counter()
    finally:
        if prefetch:
            stop.set()
            worker.join(timeout=60)
    steady = (step - 1) / (t_last - t_first) if step > 1 else None
    if save_dir and main:
        _save(trainer, state, Path(save_dir), step, final=True)
    return {"losses": losses, "state": state, "trainer": trainer, "engine": engine,
            "pipeline": pipe, "steps_per_sec": steady}


def _save(trainer, state, save_dir: Path, step: int, final: bool = False) -> Path:
    from sonicdiffusionbayeslab_torch.training.lora import lora_to_peft_state_dict

    out = save_dir / ("final" if final else f"step_{step}")
    if trainer.target == "lora":
        out.mkdir(parents=True, exist_ok=True)
        np.savez(out / "lora_peft.npz", **lora_to_peft_state_dict(state.trainable))
    else:
        if trainer.target == "controlnet":
            sub, sd = "controlnet", trainer.controlnet_params(state)
        elif isinstance(trainer, LCMDistiller):
            sub, sd = "unet", trainer.student_unet_params(state)
        else:
            sub, sd = "unet", trainer.unet_params(state)
        (out / sub).mkdir(parents=True, exist_ok=True)
        torch.save({k: v.cpu() for k, v in sd.items()}, out / sub / "diffusion_pytorch_model.bin")
    print(f"saved {out.name} -> {out}", flush=True)
    return out


def main(argv=None) -> None:
    from sonicdiffusionbayeslab_torch.cli import _parse_sets
    from sonicdiffusionbayeslab_torch.config import load_config

    parser = argparse.ArgumentParser(description="SonicDiffusionBayesLab fine-tuning "
                                                 "(PyTorch/CUDA)")
    parser.add_argument("--config", dest="config", required=True)
    parser.add_argument("--set", dest="sets", action="append", metavar="KEY=VALUE",
                        help="override a config key by dotted path (repeatable; value is YAML)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    overrides = _parse_sets(args.sets)
    if args.device is not None:
        overrides["model.device"] = args.device
    initialize(device=args.device)
    run_training(load_config(args.config, overrides))


if __name__ == "__main__":
    main()
