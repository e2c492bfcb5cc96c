"""SD3Engine: the rectified-flow (SD3-class) engine.

Counterpart of ``sonicdiffusionbayeslab_tpu/models/sd3.py``: the MMDiT
(``models/mmdit.py``) with SD3's 16-channel VAE, the two CLIP towers, each
with its text projection, and an optional T5-XXL encoder, sampled by
``FlowMatchEulerScheduler`` plans through the base engine's loop (CFG, x0
capture, microbatch, DeepCache as the trunk-delta cache, Token Merging,
int8 and CUDA graphs apply unchanged).

Text conditioning (diffusers' SD3 pipeline):

* context tokens: the penultimate hidden states of CLIP-L and CLIP-bigG
  side by side (768 + 1280 = 2048 features), zero-padded to
  ``joint_attention_dim`` (4096, T5's width); with T5, its last hidden
  states follow on the sequence axis (77 + 256 tokens);
* the pooled vector: both towers' pooled outputs through their
  ``text_projection``, concatenated (768 + 1280), in fp32 as the JAX
  engine keeps them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextModelWithProjection
from sonicdiffusionbayeslab_torch.models.mmdit import MMDiT, MMDiTConfig
from sonicdiffusionbayeslab_torch.models.sampler import SDXLTextConfigs, StableDiffusionEngine
from sonicdiffusionbayeslab_torch.models.t5 import T5Config, T5Encoder
from sonicdiffusionbayeslab_torch.models.vae import AutoencoderKL, VAEConfig


class SD3Engine(StableDiffusionEngine):
    """MMDiT + SD3 VAE + two projected CLIP towers (+ T5 with ``use_t5`` or
    a ``t5_config``) through the base engine.  The MMDiT keeps the name
    ``unet`` (and ``unet_config``) so the loop drives it unchanged.
    :meth:`parallelize` splits the MMDiT and T5.  ``fused_qkv`` fuses the
    VAE's mid attentions only (the MMDiT's joint attention has its own
    projections, as in the JAX package)."""

    TP_MODULES = ("unet", "t5")

    def __init__(self, mmdit_config: MMDiTConfig = None, vae_config: VAEConfig = None,
                 text_configs: SDXLTextConfigs = None, t5_config: Optional[T5Config] = None,
                 use_t5: bool = False, dtype: torch.dtype = torch.bfloat16, device=None,
                 fused_qkv: Optional[bool] = None):
        tc = text_configs or SDXLTextConfigs.sdxl()
        self.text2_config = tc.text2
        mmdit_config = mmdit_config or MMDiTConfig.sd3_medium()
        self.t5_config = None
        if use_t5 or t5_config is not None:
            self.t5_config = t5_config or T5Config.xxl()
            if self.t5_config.d_model != mmdit_config.joint_attention_dim:
                raise ValueError(f"T5 d_model {self.t5_config.d_model} must equal the MMDiT "
                                 f"joint_attention_dim {mmdit_config.joint_attention_dim}")
        self.MODULES = ("unet", "vae", "text", "text2") + (("t5",) if self.t5_config else ())
        super().__init__(mmdit_config, vae_config or VAEConfig.sd3(), tc.text1, dtype=dtype,
                         device=device, fused_qkv=fused_qkv)

    def _build_modules(self) -> None:
        self.unet = MMDiT(self.unet_config)
        self.vae = AutoencoderKL(self.vae_config, fused_qkv=self.fused_qkv)
        self.text = CLIPTextModelWithProjection(self.text_config)
        self.text2 = CLIPTextModelWithProjection(self.text2_config)
        self.t5 = T5Encoder(self.t5_config) if self.t5_config else None

    def t5_copy(self, device) -> T5Encoder:
        """A copy of the T5 tower on ``device`` (the staged mode's encode
        phase): built without initialisation, its weights copied in."""
        with torch.device("meta"):
            t5 = T5Encoder(self.t5_config).to(self.dtype)
        t5.to_empty(device=device).requires_grad_(False).eval()
        t5.load_state_dict(self.t5.state_dict())
        return t5

    @torch.inference_mode()
    def encode_prompts_sd3(self, ids1: np.ndarray, ids2: np.ndarray,
                           ids3: Optional[np.ndarray] = None, t5: Optional[T5Encoder] = None):
        """Token ids of each tower -> (context [B, 77 (+ 256), joint dim],
        pooled [B, 768 + 1280]), fp32.  ``ids3`` (T5's) needs an engine
        built with T5; ``t5`` is the tower to run it on (default the
        engine's own)."""
        def as_ids(a, device):
            return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)

        o1 = self.text.outputs(as_ids(ids1, self.device))
        o2 = self.text2.outputs(as_ids(ids2, self.device))
        ctx = torch.cat([o1["penultimate_hidden_state"], o2["penultimate_hidden_state"]], dim=-1)
        pad = self.unet_config.joint_attention_dim - ctx.shape[-1]
        if pad < 0:
            raise ValueError(f"CLIP feature dim {ctx.shape[-1]} exceeds joint_attention_dim "
                             f"{self.unet_config.joint_attention_dim}")
        ctx = F.pad(ctx.float(), (0, pad))
        pooled = torch.cat([o["pooled_output"].float() @ tower.text_projection.weight.float().t()
                            for o, tower in ((o1, self.text), (o2, self.text2))], dim=-1)
        if ids3 is not None:
            if self.t5 is None:
                raise ValueError("engine was built without use_t5=True")
            t5 = t5 or self.t5
            states = t5(as_ids(ids3, t5.shared.weight.device)).to(self.device)
            ctx = torch.cat([ctx, states], dim=1)
        return ctx, pooled
