"""SD-1.5 text-to-image pipeline of the port.

Counterpart of ``sonicdiffusionbayeslab_tpu/models/pipelines.py::
StableDiffusionModel`` on the text-to-image path, with the same call
contract: ``pipe(prompts, ...) -> (images, execution_time, x0_images)``,
images [B, H, W, 3] in [0, 1], execution_time the denoising loop's wall
clock.  It is registered as ``stable_diffusion_model``, the model the
experiment builds.  Weights come from ``pretrained_model`` when it names a
local diffusers snapshot directory, else from a deterministic random init
from ``seed``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import torch

from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
from sonicdiffusionbayeslab_torch.models.sampler import StableDiffusionEngine
from sonicdiffusionbayeslab_torch.models.tokenizer import load_tokenizer
from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
from sonicdiffusionbayeslab_torch.models.vae import VAEConfig
from sonicdiffusionbayeslab_torch.models.weights import load_sd_checkpoint
from sonicdiffusionbayeslab_torch.registry import models_registry
from sonicdiffusionbayeslab_torch.schedulers import DPMSolverScheduler

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@models_registry.add_to_registry("stable_diffusion_model")
class StableDiffusionModel:
    """Single-scheduler text-to-image pipeline.  ``device`` defaults to
    CUDA; without a GPU it raises unless ``device="cpu"`` is given.  On a
    GPU the first call at a new batch or size captures the UNet's CUDA
    graph for it, in place of the previous one.  The experiment assigns
    ``scheduler`` and may set ``unet_microbatch``; each call sets
    ``num_timesteps`` to its plan's number of UNet evaluations."""

    def __init__(self, pretrained_model: str = "runwayml/stable-diffusion-v1-5",
                 image_size: int = 512, tiny: bool = False, dtype: str = "bfloat16",
                 seed: int = 0, device=None):
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {dtype!r}")
        self.image_size = int(image_size)
        self.tiny = bool(tiny)
        if tiny:
            configs = (UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny())
        else:
            configs = (UNetConfig.sd15(), VAEConfig.sd15(), CLIPTextConfig.sd15())
        self.engine = StableDiffusionEngine(*configs, dtype=DTYPES[dtype], device=device)
        snapshot = Path(pretrained_model)
        if snapshot.exists():
            load_sd_checkpoint(snapshot, self.engine)
        else:  # a hub id with no local copy: deterministic random init
            self.engine.init_params(seed)
        self.device = self.engine.device
        self.latent_hw = self.image_size // 8 if not tiny else 8
        tc = self.engine.text_config
        tok_dir = snapshot / "tokenizer" if snapshot.exists() else None
        self.tokenizer = load_tokenizer(tok_dir and str(tok_dir), tc.vocab_size, tc.max_length)
        self.scheduler = DPMSolverScheduler(solver_order=2)
        self.num_timesteps = 0  # NFE of the last call
        self.unet_microbatch: Optional[int] = None  # the calls' default

    def build_plan(self, num_inference_steps: int):
        return self.scheduler.build_plan(num_inference_steps)

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
    ):
        """Returns (images [B, H, W, 3] in [0, 1] as numpy, or the final
        latents when ``output_type == "latent"``; execution_time;
        x0_images [S, n, H, W, 3] or None)."""
        if output_type not in ("np", "latent"):
            raise ValueError(f"output_type must be 'np' or 'latent', got {output_type!r}")
        lat_hw = (self.latent_hw, self.latent_hw)
        if height is not None or width is not None:
            h, w = int(height or self.image_size), int(width or self.image_size)
            if h % 8 or w % 8:
                raise ValueError(f"height/width must be multiples of 8, got {h}x{w}")
            lat_hw = (h // 8, w // 8)
        plan = self.build_plan(num_inference_steps)
        self.num_timesteps = plan.nfe

        embeds = self.engine.encode_prompts(self.tokenizer(list(prompt)))
        neg = None
        if guidance_scale > 1.0:
            negs = list(negative_prompt) if negative_prompt else [""] * len(prompt)
            neg = self.engine.encode_prompts(self.tokenizer(negs))
        out = self.engine.sample(
            plan, embeds, neg, seed=seed, sample_indices=sample_indices,
            guidance_scale=guidance_scale, latent_hw=lat_hw, collect_x0=use_x0,
            x0_samples=x0_samples, decode=output_type != "latent",
            microbatch=self.unet_microbatch if unet_microbatch is None else unet_microbatch,
        )
        images = out.images if out.images is not None else out.latents
        x0 = out.x0_images.cpu().numpy() if out.x0_images is not None else None
        return images.cpu().numpy(), out.execution_time, x0
