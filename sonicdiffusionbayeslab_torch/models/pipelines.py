"""Pipelines of the port: SD-1.5, SD-2.x, SDXL and SD3, text-to-image,
img2img and inpainting, and SD-1.5 with ControlNet.

Counterpart of ``sonicdiffusionbayeslab_tpu/models/pipelines.py::
StableDiffusionModel`` and ``StableDiffusionXLModel``, with the same call
contract: ``pipe(prompts, ...) -> (images, execution_time, x0_images)``,
images [B, H, W, 3] in [0, 1], execution_time the denoising loop's wall
clock; ``init_image`` (with ``strength``) and ``mask_image`` turn a call
into img2img and inpainting.  ``StableDiffusionModel``
is registered as ``stable_diffusion_model`` (``variant`` sd15, sd21 or
auto); the two-scheduler, interleaved-scheduler and skip-steps variants,
which differ only in how they compose the plan, as
``stable_diffusion_model_two_schedulers``, ``..._interliving_schedulers``
and ``..._skip_timesteps``; ``StableDiffusionXLModel`` as
``stable_diffusion_xl_model``; ``StableDiffusion3Model`` (the MMDiT,
flow-matching) as ``stable_diffusion_3_model``, with its three composing
variants; ``StableDiffusionControlNetModel`` as
``stable_diffusion_controlnet_model``.  IP-Adapter (``ip_adapter``, and
a call's ``ip_image_embeds``) and ``(word:1.3)`` prompt weighting
(``prompt_weighting``) apply to the UNet families.  Weights come from
``pretrained_model``
when it names a local diffusers snapshot directory, else from a
deterministic random init from ``seed``; a LoRA from a local file is fused
into the UNet with ``load_lora_weights`` and ``fuse_lora``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

import torch.nn.functional as F

from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
from sonicdiffusionbayeslab_torch.models.ip_adapter import load_ip_adapter, merge_ip_params
from sonicdiffusionbayeslab_torch.models.prompt_weighting import (
    apply_prompt_weights,
    batch_weighted_ids,
)
from sonicdiffusionbayeslab_torch.models.sampler import (
    SDXLEngine,
    SDXLTextConfigs,
    StableDiffusionEngine,
)
from sonicdiffusionbayeslab_torch.models.tokenizer import load_t5_tokenizer, load_tokenizer
from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
from sonicdiffusionbayeslab_torch.models.vae import VAEConfig
from sonicdiffusionbayeslab_torch.models.weights import (
    load_controlnet_checkpoint,
    load_sd3_checkpoint,
    load_sd_checkpoint,
    load_torch_state_dict,
    merge_lora,
)
from sonicdiffusionbayeslab_torch.parallel.mesh import check_data_only, make_mesh, shard_params
from sonicdiffusionbayeslab_torch.registry import models_registry
from sonicdiffusionbayeslab_torch.schedulers import DPMSolverScheduler
from sonicdiffusionbayeslab_torch.schedulers import plans as plan_composers
from sonicdiffusionbayeslab_torch.utils.rng import (
    ENCODE_NOISE_TAG,
    INIT_NOISE_TAG,
    per_sample_noise,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def nearest_indices(size_in: int, size_out: int) -> np.ndarray:
    """The source index of each output index of a nearest resize, as
    ``jax.image.resize(..., "nearest")`` computes it: floor((i + 0.5) *
    size_in / size_out) in float32 (torch's "nearest" rounds otherwise)."""
    pos = (np.arange(size_out, dtype=np.float32) + np.float32(0.5)) * np.float32(size_in)
    return np.floor(pos / np.float32(size_out)).astype(np.int64)


def resize_mask(mask, hw) -> torch.Tensor:
    """A mask [B, H, W] or [B, H, W, 1] -> [B, h, w, 1] fp32 by nearest
    resize (``nearest_indices``)."""
    m = torch.as_tensor(np.asarray(mask, np.float32))
    if m.dim() == 3:
        m = m[..., None]
    rows, cols = nearest_indices(m.shape[1], hw[0]), nearest_indices(m.shape[2], hw[1])
    return m[:, rows][:, :, cols]


@models_registry.add_to_registry("stable_diffusion_model")
class StableDiffusionModel:
    """Single-scheduler text-to-image pipeline.  ``device`` defaults to
    CUDA; without a GPU it raises unless ``device="cpu"`` is given.  On a
    GPU the first call at a new batch or size captures a CUDA graph of each
    UNet call variant it runs, in place of that variant's previous one
    (DeepCache runs two variants).  The experiment assigns
    ``scheduler`` and may set ``unet_microbatch`` and ``cache_plan_fn``
    (DeepCache: plan length -> ``CachePlan``), ``tome_ratio`` (Token
    Merging; a call's ``tome_ratio`` overrides it) and ``guidance_rescale``
    (rescaled CFG, 0 for off), and set the UNet's int8 mode with
    ``engine.set_quant_mode``; each call sets ``num_timesteps`` to its
    plan's number of UNet evaluations.  ``lora`` is the config's LoRA path,
    which the ``consistency_model`` method loads.  ``variant`` picks SD-1.5
    (``sd15``) or SD-2.x (``sd21``: OpenCLIP ViT-H context, 64-wide heads,
    linear projections); ``auto`` reads a local snapshot's
    ``unet/config.json``, else the model id's name.

    ``ip_adapter``: an IP-Adapter ``.bin`` (a path that does not exist
    initialises one randomly, for a 1024-wide image embedding, as the JAX
    package does); calls then take ``ip_image_embeds`` [B, E] and
    ``ip_scale`` (default ``ip_scale``).  ``prompt_weighting``: the
    ``(word:1.3)`` emphasis syntax (``models/prompt_weighting.py``), off by
    default so that literal parentheses in captions stay literal.

    A uniform batch of prompts (all one string, e.g. the serving path's
    empty negatives) is encoded once and kept, 4 entries at most, keyed on
    (prompt, batch size) and dropped when the engine's weights change.

    ``mesh_data`` > 1 (0 or 1: one device) samples data-parallel over that
    many ranks (``torch.distributed``, one process each, started before
    the pipeline): every rank builds the same weights and calls the
    pipeline with the same arguments, samples its rows of the batch and
    returns the whole batch (``engine.sample``'s ``mesh``).  ``mesh_seq``
    or ``mesh_model`` above 1 raises (ROADMAP.md item A9)."""

    def __init__(self, pretrained_model: str = "runwayml/stable-diffusion-v1-5",
                 image_size: int = 512, tiny: bool = False, dtype: str = "bfloat16",
                 seed: int = 0, lora: str = None, variant: str = "auto", device=None,
                 ip_adapter: str = None, ip_scale: float = 1.0, prompt_weighting: bool = False,
                 mesh_data: int = 0, mesh_seq: int = 1, mesh_model: int = 1):
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {dtype!r}")
        check_data_only(mesh_seq, mesh_model, type(self).__name__)
        self.lora = lora
        self.pretrained_model = pretrained_model
        self.image_size = int(image_size)
        self.tiny = bool(tiny)
        self.variant = self._resolve_variant(variant, pretrained_model)
        self.engine = self._make_engine(DTYPES[dtype], self.tiny, device)
        snapshot = Path(pretrained_model)
        if snapshot.exists():
            self._load_checkpoint(snapshot)
        else:  # a hub id with no local copy: deterministic random init
            self.engine.init_params(seed)
        self.device = self.engine.device
        self.latent_hw = self.image_size // 8 if not tiny else 8
        self.tokenizer = self._tokenizer("tokenizer", self.engine.text_config)
        self.scheduler = DPMSolverScheduler(solver_order=2)
        self.num_timesteps = 0  # NFE of the last call
        self.unet_microbatch: Optional[int] = None  # the calls' default
        self.cache_plan_fn = None  # DeepCache hook (set by the deep_cache method)
        self.tome_ratio = None  # Token Merging: a ratio or a TomeConfig
        self.guidance_rescale = 0.0
        self._pending_lora = None
        self.lora_merged: List[str] = []  # modules the last fuse_lora changed
        self.prompt_weighting = bool(prompt_weighting)
        self.ip_scale = float(ip_scale)
        self.has_ip = ip_adapter is not None
        if self.has_ip:
            self._load_ip_adapter(ip_adapter)
        self._encode_memo: Dict[tuple, torch.Tensor] = {}
        self._memo_version = self.engine.weights_version
        self.mesh = None
        self.placements: Dict[str, Dict[str, tuple]] = {}
        if (int(mesh_data) or 1) > 1:
            self.mesh = make_mesh(n_data=int(mesh_data), device_type=self.device.type)
            self.place_params(self.engine.MODULES + (("image_proj",) if self.has_ip else ()))

    def place_params(self, names: Sequence[str]) -> None:
        """Place the engine modules ``names`` on the mesh
        (``parallel.shard_params``; every rank holds its own copy, so no
        data moves) and keep each weight's placements in
        ``placements[name]``: replicated along every axis, since only the
        data axis runs.  The DTensors themselves are dropped, so a module
        moved later (SD3's staged T5) leaves no copy behind."""
        for name in names:
            sd = getattr(self.engine, name).state_dict()
            self.placements[name] = {k: v.placements
                                     for k, v in shard_params(sd, self.mesh).items()}

    def _load_ip_adapter(self, path: str) -> None:
        eng = self.engine
        if Path(path).exists():
            loaded = load_ip_adapter(path, eng.unet_config)
            eng.init_ip_adapter(embed_dim=loaded["embed_dim"], num_tokens=loaded["num_tokens"])
            merge_ip_params(eng.unet, loaded["unet_ip"])
            eng.image_proj.load_state_dict(loaded["image_proj"], strict=True)
            eng.weights_changed()
        else:  # no local file: a random adapter (random base weights anyway)
            eng.init_ip_adapter(seed=0)
        self.ip_embed_dim = eng.image_proj.embed_dim

    @staticmethod
    def _resolve_variant(variant: str, pretrained_model: str) -> str:
        """sd15 or sd21.  ``auto``: a local snapshot's ``unet/config.json``
        (``cross_attention_dim`` 1024 is SD-2.x), else the model id's name."""
        if variant != "auto":
            if variant not in ("sd15", "sd21"):
                raise ValueError(f"unknown variant {variant!r} (sd15|sd21|auto)")
            return variant
        cfg_path = Path(pretrained_model) / "unet" / "config.json"
        if cfg_path.exists():
            c = json.loads(cfg_path.read_text())
            return "sd21" if int(c.get("cross_attention_dim", 768)) == 1024 else "sd15"
        name = pretrained_model.lower()
        return "sd21" if ("stable-diffusion-2" in name or "sd2" in name) else "sd15"

    def _make_engine(self, dtype: torch.dtype, tiny: bool, device) -> StableDiffusionEngine:
        if self.variant == "sd21":
            configs = ((UNetConfig.tiny21(), VAEConfig.tiny(), CLIPTextConfig.tiny21()) if tiny
                       else (UNetConfig.sd21(), VAEConfig.sd15(), CLIPTextConfig.sd21()))
        else:
            configs = ((UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny()) if tiny
                       else (UNetConfig.sd15(), VAEConfig.sd15(), CLIPTextConfig.sd15()))
        return StableDiffusionEngine(*configs, dtype=dtype, device=device)

    def _load_checkpoint(self, snapshot: Path) -> None:
        load_sd_checkpoint(snapshot, self.engine)

    def _tokenizer(self, subdir: str, tc: CLIPTextConfig):
        """The snapshot's ``subdir`` BPE tokenizer where it has one, else the
        offline hash tokenizer, for the tower ``tc``."""
        snapshot = Path(self.pretrained_model)
        tok_dir = snapshot / subdir if snapshot.exists() else None
        return load_tokenizer(tok_dir and str(tok_dir), tc.vocab_size, tc.max_length)

    def _encode(self, prompts: Sequence[str]) -> torch.Tensor:
        prompts = list(prompts)
        if not prompts or any(p != prompts[0] for p in prompts):
            return self._encode_uncached(prompts)
        if self._memo_version != self.engine.weights_version:
            self._encode_memo.clear()
            self._memo_version = self.engine.weights_version
        key = (prompts[0], len(prompts))
        states = self._encode_memo.get(key)
        if states is None:
            states = self._encode_uncached(prompts)
            if len(self._encode_memo) >= 4:
                self._encode_memo.pop(next(iter(self._encode_memo)))
            self._encode_memo[key] = states
        return states

    @torch.inference_mode()
    def _encode_uncached(self, prompts: Sequence[str]) -> torch.Tensor:
        if not self.prompt_weighting:
            return self.engine.encode_prompts(self.tokenizer(list(prompts)))
        # Emphasis syntax: per-token scaling with the mean restored; a batch
        # without it takes the plain ids and no rescale.
        ids, weights = batch_weighted_ids(self.tokenizer, list(prompts))
        states = self.engine.encode_prompts(ids)
        if np.any(weights != 1.0):
            states = apply_prompt_weights(states, weights)
        return states

    def _extra_sample_kwargs(self, batch: int, lat_hw) -> Dict[str, Any]:
        """Subclass hook: more ``engine.sample`` arguments (SDXL's
        ``added_cond``); ``lat_hw`` is the call's latent grid."""
        return {}

    def build_plan(self, num_inference_steps: int, **plan_kw):
        if plan_kw:
            raise TypeError(f"{type(self).__name__} takes no plan arguments, got {sorted(plan_kw)}")
        return self.scheduler.build_plan(num_inference_steps)

    def load_lora_weights(self, path: str):
        """Stage a LoRA state dict (kohya or peft layout) from a local file,
        or from ``pytorch_lora_weights.bin`` / ``.safetensors`` in a local
        directory.  A hub id with no local copy stages nothing, so the LoRA
        method's sampling still runs on the base weights."""
        p = Path(path)
        candidates = [p] if p.is_file() else [
            p / "pytorch_lora_weights.bin", p / "pytorch_lora_weights.safetensors"]
        self._pending_lora = next(
            (load_torch_state_dict(c) for c in candidates if c.exists()), None)
        return self

    def fuse_lora(self, scale: float = 1.0):
        """Merge the staged LoRA into the UNet's weights (``lora_merged``
        lists the modules changed) and drop the UNet's CUDA graphs."""
        if self._pending_lora is not None:
            unet = self.engine.unet
            sd, self.lora_merged = merge_lora(unet.state_dict(), self._pending_lora, scale)
            unet.load_state_dict(sd, strict=True)
            self.engine.weights_changed()
            self._pending_lora = None
        return self

    def __call__(
        self,
        prompt: Sequence[str],
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        seed: int = 0,
        sample_indices: Optional[Sequence[int]] = None,
        negative_prompt: Optional[Sequence[str]] = None,
        use_x0: bool = False,
        x0_samples: Optional[int] = None,
        output_type: str = "np",
        height: Optional[int] = None,
        width: Optional[int] = None,
        unet_microbatch: Optional[int] = None,
        tome_ratio: Optional[float] = None,
        init_image=None,
        strength: float = 0.8,
        mask_image=None,
        encode_noise=None,
        init_noise=None,
        blend_noise=None,
        ip_image_embeds=None,
        ip_scale: Optional[float] = None,
        time_loop: bool = True,
        **plan_kw,
    ):
        """Returns (images [B, H, W, 3] in [0, 1] as numpy, or the final
        latents when ``output_type == "latent"``, or the images as the
        device's tensor, not yet copied to the host, when ``output_type ==
        "device"``; execution_time, -1.0 with ``time_loop`` False, which
        skips the loop's device synchronisations (the serving path);
        x0_images [S, n, H, W, 3] or None).  ``plan_kw`` goes to
        ``build_plan`` (the composing variants' arguments).

        img2img: ``init_image`` [B, H, W, 3] in [0, 1] runs the last
        ``min(int(n * strength), n)`` of the ``n`` steps (diffusers'
        strength) from the image's latents noised to the first of them
        (the scheduler's ``tail_plan`` and ``noised_latents``).  Inpainting
        adds ``mask_image`` [B, H, W] or [B, H, W, 1], 1 = regenerate: the
        rest is held to the source re-noised to each step's level (the
        scheduler's ``blend_schedule``).  Sample i's draws, the encoder's
        posterior sample (``encode_noise``), the start noise
        (``init_noise``) and the blend's (``blend_noise``), each [B, h, w,
        4], come from (seed, i) and a tag of each where not given."""
        if output_type not in ("np", "latent", "device"):
            raise ValueError(f"output_type must be 'np', 'latent' or 'device', "
                             f"got {output_type!r}")
        lat_hw = (self.latent_hw, self.latent_hw)
        if height is not None or width is not None:
            h, w = int(height or self.image_size), int(width or self.image_size)
            if h % 8 or w % 8:
                raise ValueError(f"height/width must be multiples of 8, got {h}x{w}")
            if init_image is not None:
                raise ValueError("height/width override is text2img-only")
            lat_hw = (h // 8, w // 8)
        if mask_image is not None and init_image is None:
            raise ValueError("mask_image requires init_image")
        img2img = {}
        if init_image is not None:
            plan, img2img = self._img2img(num_inference_steps, init_image, strength, mask_image,
                                          seed, sample_indices, encode_noise, init_noise)
            lat_hw = tuple(img2img["init_latents"].shape[1:3])
            if "blend" in img2img:
                img2img["blend_noise"] = blend_noise
        else:
            plan = self.build_plan(num_inference_steps, **plan_kw)
        self.num_timesteps = plan.nfe

        embeds = self._encode(prompt)
        neg = None
        if guidance_scale > 1.0:
            neg = self._encode(list(negative_prompt) if negative_prompt else [""] * len(prompt))
        ip_arg = None
        if ip_image_embeds is not None:
            if not self.has_ip:
                raise ValueError("pipeline built without ip_adapter; pass ip_adapter=")
            emb = np.asarray(ip_image_embeds, np.float32)
            if emb.shape[-1] != self.ip_embed_dim:
                raise ValueError(f"ip_image_embeds dim {emb.shape[-1]} != adapter's embedding "
                                 f"dim {self.ip_embed_dim}")
            ip_arg = {"image_embeds": emb,
                      "scale": self.ip_scale if ip_scale is None else float(ip_scale)}
        out = self.engine.sample(
            plan, embeds, neg, seed=seed, sample_indices=sample_indices,
            guidance_scale=guidance_scale,
            cache_plan=self.cache_plan_fn(plan.num_steps) if self.cache_plan_fn else None,
            latent_hw=lat_hw, collect_x0=use_x0,
            x0_samples=x0_samples, decode=output_type != "latent",
            microbatch=self.unet_microbatch if unet_microbatch is None else unet_microbatch,
            guidance_rescale=self.guidance_rescale,
            tome=self.tome_ratio if tome_ratio is None else tome_ratio,
            ip_adapter=ip_arg, time_loop=time_loop, mesh=self.mesh,
            **img2img,
            **self._extra_sample_kwargs(len(prompt), lat_hw),
        )
        images = out.images if out.images is not None else out.latents
        if output_type == "device":
            return images, out.execution_time, out.x0_images
        x0 = out.x0_images.cpu().numpy() if out.x0_images is not None else None
        return images.cpu().numpy(), out.execution_time, x0

    def _img2img(self, num_steps, init_image, strength, mask_image, seed, sample_indices,
                 encode_noise, init_noise):
        """(the tail plan, ``engine.sample``'s ``init_latents`` and, with a
        mask, ``blend``) of an img2img or inpainting call."""
        sched = self.scheduler
        if sched is None or not hasattr(sched, "tail_plan"):
            raise RuntimeError("img2img needs a scheduler with tail_plan")
        n = int(num_steps)
        start = max(n - min(int(n * strength), n), 0)
        if start >= n:
            raise ValueError(f"strength {strength} leaves no steps to run")
        plan = sched.tail_plan(n, start)
        img = torch.as_tensor(np.asarray(init_image, np.float32))
        idx = range(img.shape[0]) if sample_indices is None else [int(i) for i in sample_indices]
        f = 2 ** (len(self.engine.vae_config.block_out_channels) - 1)  # pixels a latent spans
        lat_shape = (img.shape[1] // f, img.shape[2] // f, self.engine.vae_config.latent_channels)

        def draw(given, tag):
            if given is not None:
                return torch.as_tensor(given, dtype=torch.float32)
            return per_sample_noise(seed, idx, lat_shape, tag)

        z = self.engine.encode_image(img, draw(encode_noise, ENCODE_NOISE_TAG))
        noise = draw(init_noise, INIT_NOISE_TAG).to(z.device)
        out = {"init_latents": sched.noised_latents(z, noise, n, start)}
        if mask_image is not None:
            blend_a, blend_s = sched.blend_schedule(n, start)
            if len(blend_a) != plan.num_steps:
                raise RuntimeError("blend schedule misaligned with plan rows")
            out["blend"] = (resize_mask(mask_image, z.shape[1:3]), z, blend_a, blend_s)
        return plan, out


class _TwoSchedulersPlanMixin:
    """Scheduler switching: ``scheduler_first`` for ``num_step_switch``
    steps, then ``scheduler_second`` (``schedulers/plans.py``)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.scheduler_first = None
        self.scheduler_second = None

    def build_plan(self, num_inference_steps, num_inference_steps_second=None,
                   num_step_switch=1, type_switch="closest"):
        return plan_composers.two_scheduler_plan(
            self.scheduler_first, self.scheduler_second, num_inference_steps,
            num_inference_steps_second or num_inference_steps, num_step_switch, type_switch)


class _InterlivingPlanMixin:
    """Interleaved schedulers: ``scheduler_inter`` runs the first step of
    each listed window of ``scheduler_main``'s schedule."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.scheduler_main = None
        self.scheduler_inter = None

    def build_plan(self, num_inference_steps, interliving_steps=(), interleave_mode="ladder"):
        return plan_composers.interleave_plan(
            self.scheduler_main, self.scheduler_inter, num_inference_steps,
            interliving_steps, mode=interleave_mode)


class _SkipTimestepsPlanMixin:
    """Step skipping: the listed step indices of ``scheduler``'s run never
    run."""

    def build_plan(self, num_inference_steps, skip_timesteps=()):
        if not skip_timesteps:
            return self.scheduler.build_plan(num_inference_steps)
        return plan_composers.skip_plan(self.scheduler, num_inference_steps, skip_timesteps)


@models_registry.add_to_registry("stable_diffusion_model_two_schedulers")
class StableDiffusionModelTwoSchedulers(_TwoSchedulersPlanMixin, StableDiffusionModel):
    """Scheduler-switching pipeline."""


@models_registry.add_to_registry("stable_diffusion_model_interliving_schedulers")
class StableDiffusionModelInterlivingSchedulers(_InterlivingPlanMixin, StableDiffusionModel):
    """Interleaved-scheduler pipeline."""


@models_registry.add_to_registry("stable_diffusion_model_skip_timesteps")
class StableDiffusionModelSkipTimesteps(_SkipTimestepsPlanMixin, StableDiffusionModel):
    """Step-skipping pipeline."""


@models_registry.add_to_registry("stable_diffusion_xl_model")
class StableDiffusionXLModel(StableDiffusionModel):
    """SDXL text-to-image: the same engine loop, schedulers and call
    contract, with SDXL's two text towers (CLIP ViT-L and OpenCLIP bigG,
    penultimate states side by side) and its text_time conditioning: the
    bigG tower's projected pooled embedding and the ``time_ids`` (original
    size, crop corner, target size) from the call's latent grid.  The
    unconditional half of CFG takes the negative prompt's pooled embedding,
    as the JAX pipeline does.  Prompt weighting weights each tower's states
    with its own tokenizer's weights and leaves the pooled embedding
    unweighted; no prompt memo."""

    def __init__(self, pretrained_model: str = "stabilityai/stable-diffusion-xl-base-1.0",
                 image_size: int = 1024, tiny: bool = False, dtype: str = "bfloat16",
                 seed: int = 0, lora: str = None, device=None, prompt_weighting: bool = False,
                 mesh_data: int = 0, mesh_seq: int = 1, mesh_model: int = 1):
        super().__init__(pretrained_model=pretrained_model, image_size=image_size, tiny=tiny,
                         dtype=dtype, seed=seed, lora=lora, device=device,
                         prompt_weighting=prompt_weighting, mesh_data=mesh_data,
                         mesh_seq=mesh_seq, mesh_model=mesh_model)
        self.tokenizer2 = self._tokenizer("tokenizer_2", self.engine.text2_config)
        self._pooled_queue: List[torch.Tensor] = []

    def _make_engine(self, dtype: torch.dtype, tiny: bool, device) -> SDXLEngine:
        if tiny:
            return SDXLEngine(UNetConfig.tiny_xl(), VAEConfig.tiny(), SDXLTextConfigs.tiny(),
                              dtype=dtype, device=device)
        return SDXLEngine(dtype=dtype, device=device)

    @torch.inference_mode()
    def _encode(self, prompts: Sequence[str]) -> torch.Tensor:
        if not self.prompt_weighting:
            ctx, pooled = self.engine.encode_prompts_xl(self.tokenizer(list(prompts)),
                                                         self.tokenizer2(list(prompts)))
            self._pooled_queue.append(pooled)
            return ctx
        ids1, w1 = batch_weighted_ids(self.tokenizer, list(prompts))
        ids2, w2 = batch_weighted_ids(self.tokenizer2, list(prompts))
        ctx, pooled = self.engine.encode_prompts_xl(ids1, ids2)
        self._pooled_queue.append(pooled)
        if np.any(w1 != 1.0) or np.any(w2 != 1.0):
            h1 = self.engine.text_config.hidden_size  # tower 1's features come first
            ctx = torch.cat([apply_prompt_weights(ctx[..., :h1], w1),
                             apply_prompt_weights(ctx[..., h1:], w2)], dim=-1)
        return ctx

    def _extra_sample_kwargs(self, batch: int, lat_hw) -> Dict[str, Any]:
        # __call__ encodes the prompts, then (under CFG) the negative prompts.
        queue, self._pooled_queue = self._pooled_queue, []
        # (orig_h, orig_w, crop_top, crop_left, target_h, target_w) of the
        # call's latent grid, so height/width overrides follow.
        h, w = float(lat_hw[0] * 8), float(lat_hw[1] * 8)
        time_ids = torch.tensor([[h, w, 0.0, 0.0, h, w]]).repeat(batch, 1)
        added = {"text_embeds": queue[0], "time_ids": time_ids}
        if len(queue) > 1:
            added["negative_text_embeds"] = queue[1]
        return {"added_cond": added}


@models_registry.add_to_registry("stable_diffusion_3_model")
class StableDiffusion3Model(StableDiffusionXLModel):
    """SD3-class rectified-flow text-to-image (``models/mmdit.py``,
    ``models/sd3.py``): the MMDiT velocity transformer, sampled with
    ``flow_match_euler_scheduler`` plans by the same engine loop; CFG, x0
    capture, microbatch, img2img's flow-path seeding, DeepCache (the
    trunk-delta cache), Token Merging (image tokens) and int8 W8A8 apply.
    Conditioning is CLIP-only by default (both towers' penultimate states
    zero-padded to T5's width, both projected pooled embeddings);
    ``use_t5`` adds T5-XXL's states after them on the sequence axis, with
    ``HashTokenizer`` ids (a snapshot's ``tokenizer_3/tokenizer.json`` has
    no reader in the port and raises).

    ``t5_staged``: the T5 weights stay in host memory, go to the card for
    a call's encodes and are freed before its denoising loop (``True``,
    "staged"), or stay on the card (``False``, "resident"); "auto" stages
    at full size and keeps the tiny model resident (the JAX package's rule
    for one device).  Both give the same images.

    ControlNet, IP-Adapter and prompt weighting are refused, as in the JAX
    package."""

    def __init__(self, pretrained_model: str = "stabilityai/stable-diffusion-3-medium",
                 image_size: int = 1024, tiny: bool = False, dtype: str = "bfloat16",
                 seed: int = 0, lora: str = None, use_t5: bool = False,
                 t5_staged: object = "auto", prompt_weighting: bool = False,
                 ip_adapter: str = None, device=None, mesh_data: int = 0, mesh_seq: int = 1,
                 mesh_model: int = 1):
        check_data_only(mesh_seq, mesh_model, type(self).__name__)
        if prompt_weighting:
            raise NotImplementedError(
                "prompt weighting is not wired for SD3's padded dual-tower context (weights "
                "would need to apply before the T5-width pad)")
        if ip_adapter:
            raise NotImplementedError("IP-Adapter is a UNet-family feature")
        self._use_t5 = bool(use_t5)
        self.tiny = bool(tiny)
        self.t5_staged = self._staged(t5_staged)
        self.pretrained_model = pretrained_model
        # Checked before the weights are built: the T5 tokenizer of a real
        # snapshot has no reader here.
        self.tokenizer3 = None
        if self._use_t5:
            self.tokenizer3 = self._t5_tokenizer(tiny)
        self._t5_dev = None  # the staged mode's copy of T5 on the card during encodes
        super().__init__(pretrained_model=pretrained_model, image_size=image_size, tiny=tiny,
                         dtype=dtype, seed=seed, lora=lora, device=device, mesh_data=mesh_data)
        if self.t5_staged:
            self.engine.t5.to("cpu")

    def _staged(self, opt) -> bool:
        if not self._use_t5:
            return False
        if opt in (False, "false", "off", "resident"):
            return False
        if opt in (True, "true", "staged"):
            return True
        if opt != "auto":
            raise ValueError(f"t5_staged must be auto, staged or resident, got {opt!r}")
        return not self.tiny

    def _t5_tokenizer(self, tiny: bool):
        from sonicdiffusionbayeslab_torch.models.t5 import T5Config

        cfg = T5Config.tiny() if tiny else T5Config.xxl()
        snapshot = Path(self.pretrained_model)
        tok_dir = snapshot / "tokenizer_3" if snapshot.exists() else None
        return load_t5_tokenizer(tok_dir and str(tok_dir), cfg.vocab_size, cfg.max_length)

    def _make_engine(self, dtype: torch.dtype, tiny: bool, device):
        from sonicdiffusionbayeslab_torch.models.mmdit import MMDiTConfig
        from sonicdiffusionbayeslab_torch.models.sd3 import SD3Engine
        from sonicdiffusionbayeslab_torch.models.t5 import T5Config

        if tiny:
            return SD3Engine(MMDiTConfig.tiny(), VAEConfig.tiny16(), SDXLTextConfigs.tiny(),
                             t5_config=T5Config.tiny() if self._use_t5 else None, dtype=dtype,
                             device=device)
        return SD3Engine(use_t5=self._use_t5, dtype=dtype, device=device)

    def _load_checkpoint(self, snapshot: Path) -> None:
        load_sd3_checkpoint(snapshot, self.engine)

    def _encode(self, prompts: Sequence[str]) -> torch.Tensor:
        ids3 = self.tokenizer3(list(prompts)) if self.tokenizer3 is not None else None
        t5 = None
        if ids3 is not None and self.t5_staged:
            if self._t5_dev is None:
                self._t5_dev = self.engine.t5_copy(self.device)
            t5 = self._t5_dev
        ctx, pooled = self.engine.encode_prompts_sd3(self.tokenizer(list(prompts)),
                                                     self.tokenizer2(list(prompts)), ids3, t5)
        self._pooled_queue.append(pooled)
        return ctx

    def _extra_sample_kwargs(self, batch: int, lat_hw) -> Dict[str, Any]:
        # The staged T5 copy goes before the loop claims the memory; the
        # caching allocator reuses it once the encodes' kernels are done.
        self._t5_dev = None
        queue, self._pooled_queue = self._pooled_queue, []
        # time_ids: engine plumbing only; the MMDiT ignores them.
        added = {"text_embeds": queue[0], "time_ids": torch.zeros(batch, 6)}
        if len(queue) > 1:
            added["negative_text_embeds"] = queue[1]
        return {"added_cond": added}


@models_registry.add_to_registry("stable_diffusion_3_model_two_schedulers")
class StableDiffusion3ModelTwoSchedulers(_TwoSchedulersPlanMixin, StableDiffusion3Model):
    """SD3 scheduler switching: both schedulers flow-space (the composers'
    SPACE guard refuses a flow-to-VP mix)."""


@models_registry.add_to_registry("stable_diffusion_3_model_interliving_schedulers")
class StableDiffusion3ModelInterlivingSchedulers(_InterlivingPlanMixin, StableDiffusion3Model):
    """SD3 interleaved schedulers (flow-to-flow)."""


@models_registry.add_to_registry("stable_diffusion_3_model_skip_timesteps")
class StableDiffusion3ModelSkipTimesteps(_SkipTimestepsPlanMixin, StableDiffusion3Model):
    """SD3 step skipping on the flow sigma grid (skipped transitions are
    absent)."""


def resize_bilinear(images, hw) -> torch.Tensor:
    """Images [B, H, W, C] -> [B, h, w, C] fp32, bilinear with half-pixel
    centres, antialiased where it shrinks (as ``jax.image.resize(...,
    "bilinear")`` is)."""
    x = torch.as_tensor(np.asarray(images, np.float32))
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    x = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear", antialias=True,
                      align_corners=False)
    return x.permute(0, 2, 3, 1).contiguous()


@models_registry.add_to_registry("stable_diffusion_controlnet_model")
class StableDiffusionControlNetModel(StableDiffusionModel):
    """ControlNet-conditioned text-to-image (``models/controlnet.py``): the
    same engine, schedulers and call contract, with the ControlNet's
    residuals added to the UNet's skip states at every step.  ``controlnet``
    names a local diffusers ControlNet snapshot dir; without one the
    ControlNet is random with zero heads (an exact no-op).  A call needs
    ``control_image`` [B, H, W, 3] in [0, 1] (resized to the call's pixel
    size where it differs) and takes ``controlnet_scale`` (default
    ``controlnet_scale``).  DeepCache and ``unet_microbatch`` > 1 are
    refused with it, as in the JAX package."""

    def __init__(self, pretrained_model: str = "runwayml/stable-diffusion-v1-5",
                 image_size: int = 512, tiny: bool = False, dtype: str = "bfloat16",
                 seed: int = 0, lora: str = None, variant: str = "auto", device=None,
                 controlnet: str = None, controlnet_scale: float = 1.0, ip_adapter: str = None,
                 ip_scale: float = 1.0, prompt_weighting: bool = False, mesh_data: int = 0,
                 mesh_seq: int = 1, mesh_model: int = 1):
        super().__init__(pretrained_model=pretrained_model, image_size=image_size, tiny=tiny,
                         dtype=dtype, seed=seed, lora=lora, variant=variant, device=device,
                         ip_adapter=ip_adapter, ip_scale=ip_scale,
                         prompt_weighting=prompt_weighting, mesh_data=mesh_data,
                         mesh_seq=mesh_seq, mesh_model=mesh_model)
        self.controlnet_scale = float(controlnet_scale)
        self.engine.init_controlnet(seed=0)
        if controlnet and Path(controlnet).exists():
            load_controlnet_checkpoint(controlnet, self.engine)
        if self.mesh is not None:  # the ControlNet's copy is placed like the UNet
            self.place_params(("controlnet",))
        self._control_call: Optional[Dict[str, Any]] = None

    def __call__(self, prompt, *args, control_image=None, controlnet_scale=None, **kw):
        if control_image is None:
            raise ValueError("stable_diffusion_controlnet_model requires control_image")
        hw = (int(kw.get("height") or self.image_size), int(kw.get("width") or self.image_size))
        self._control_call = {
            "image": resize_bilinear(control_image, hw),
            "scale": self.controlnet_scale if controlnet_scale is None else float(controlnet_scale),
        }
        try:
            return super().__call__(prompt, *args, **kw)
        finally:
            self._control_call = None

    def _extra_sample_kwargs(self, batch: int, lat_hw) -> Dict[str, Any]:
        return {"control": self._control_call}
