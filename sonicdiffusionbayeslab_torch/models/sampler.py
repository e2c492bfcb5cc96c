"""The sampling engine: text encode, the denoising loop around the UNet,
and the VAE decode.

Counterpart of ``sonicdiffusionbayeslab_tpu/models/sampler.py::
StableDiffusionEngine`` with DeepCache (``CachePlan``), Token Merging,
noise-injecting plans, rescaled CFG, img2img's image encode and
inpainting's per-step blend, the UNet's int8 modes, ControlNet and
IP-Adapter, a w-conditioned (full LCM) UNet's guidance embedding, and of
its ``SDXLEngine`` (two text towers and the UNet's text_time
conditioning).
The JAX engine scans a jitted
body over the plan's rows; here the loop is plain Python over the same
rows, each step one UNet call (chunked when ``microbatch`` > 1), the CFG
combine and one ``apply_row`` in fp32.  On a GPU each UNet call variant
(plain; DeepCache's full and shallow calls; each with its ToMe config) is
replayed from its own CUDA graph (``utils/cuda_graph.py``), because eager PyTorch's host time per UNet
forward exceeds its device time; on the CPU it runs eagerly.
``execution_time`` is the wall clock of the denoising loop alone, with the
device synchronised on both sides (the reference's timing contract).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sonicdiffusionbayeslab_torch.models.clip_text import (
    CLIPTextConfig,
    CLIPTextModel,
    CLIPTextModelWithProjection,
)
from sonicdiffusionbayeslab_torch.models.controlnet import ControlNet
from sonicdiffusionbayeslab_torch.models.ip_adapter import ImageProjection
from sonicdiffusionbayeslab_torch.models.layers import GroupNorm, RMSNorm
from sonicdiffusionbayeslab_torch.models.unet import UNet2DCondition, UNetConfig
from sonicdiffusionbayeslab_torch.models.vae import AutoencoderKL, VAEConfig
from sonicdiffusionbayeslab_torch.ops import quant
from sonicdiffusionbayeslab_torch.ops.tome import TomeConfig
from sonicdiffusionbayeslab_torch.parallel import distributed
from sonicdiffusionbayeslab_torch.parallel import mesh as mesh_lib
from sonicdiffusionbayeslab_torch.schedulers.plan import SamplePlan
from sonicdiffusionbayeslab_torch.schedulers.runtime import apply_row, init_carry, plan_rows, row
from sonicdiffusionbayeslab_torch.utils.cuda_graph import GraphedVariants
from sonicdiffusionbayeslab_torch.utils.device import resolve_device, synchronize
from sonicdiffusionbayeslab_torch.utils.rng import (
    BLEND_NOISE_TAG,
    per_sample_latents,
    per_sample_noise,
    per_sample_step_noise,
    tome_destinations,
)

# Probability mass of a standard normal inside [-2, 2], as the bounds of
# the uniform draw that inverse-CDF sampling turns into a truncated normal.
_TRUNC_LO = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0
_TRUNC_HI = (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
# Flax's lecun_normal draws from N(0, 1) truncated to [-2, 2] and divides
# by this constant, the standard deviation of that truncated normal.
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class CachePlan:
    """DeepCache schedule: step i runs the deep trunk iff ``full[i]``, and
    replays the trunk's features of the last full step otherwise.
    ``branch`` is the split level (``cache_branch_id``) between the
    always-run shallow branch and the cached trunk."""

    full: np.ndarray  # bool [L]
    branch: int = 0

    @classmethod
    def every(cls, num_steps: int, cache_interval: int, branch: int = 0) -> "CachePlan":
        idx = np.arange(num_steps)
        return cls(full=(idx % int(cache_interval)) == 0, branch=int(branch))


def guidance_scale_embedding(w, dim: int) -> torch.Tensor:
    """The sinusoidal embedding [B, dim] of guidance scales ``w`` [B] for a
    w-conditioned (full LCM) UNet's ``timestep_cond``: diffusers'
    ``get_guidance_scale_embedding``, w x 1000, sines then cosines at
    ``exp(i * -log(10000) / (half - 1))``, a zero column for odd ``dim``.
    The arguments are fp32 products, as the JAX package forms them; exp,
    sin and cos of them are taken in float64 and rounded, since their fp32
    versions differ by an ulp between libraries and the sines' arguments
    reach 10^4 (an ulp of a frequency there moves a sine by 10^-4)."""
    w = torch.as_tensor(w, dtype=torch.float32) * 1000.0
    half = dim // 2
    step = -torch.log(torch.tensor(10000.0, device=w.device)) / (half - 1)
    x = torch.arange(half, dtype=torch.float32, device=w.device) * step
    freqs = torch.exp(x.double()).float()
    emb = (w[:, None] * freqs[None, :]).double()
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1).float()
    return torch.nn.functional.pad(emb, (0, dim % 2))


@dataclasses.dataclass(frozen=True)
class SDXLTextConfigs:
    """SDXL's two text towers: CLIP ViT-L (penultimate states) and OpenCLIP
    bigG (penultimate states and the projected pooled embedding)."""

    text1: CLIPTextConfig
    text2: CLIPTextConfig

    @classmethod
    def sdxl(cls) -> "SDXLTextConfigs":
        return cls(CLIPTextConfig.sd15(), CLIPTextConfig.sdxl_g())

    @classmethod
    def tiny(cls) -> "SDXLTextConfigs":
        return cls(CLIPTextConfig(vocab_size=1000, hidden_size=16, num_layers=2, num_heads=2,
                                  intermediate_size=32),
                   CLIPTextConfig.tiny_g())


@dataclasses.dataclass
class SampleOutput:
    images: Optional[torch.Tensor]  # [B, H, W, 3] in [0, 1], fp32
    execution_time: float  # denoising-loop seconds
    x0_images: Optional[torch.Tensor]  # [S, n, H, W, 3]: per-step x0 decodes
    latents: torch.Tensor  # final latents [B, h, w, 4], fp32
    nfe: int


def _lecun_truncated_(p: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """Flax's ``lecun_normal``: N(0, 1/fan_in) truncated at two standard
    deviations (of the untruncated normal it is rescaled from)."""
    u = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    u.uniform_(2 * _TRUNC_LO - 1, 2 * _TRUNC_HI - 1, generator=gen)
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    p.copy_(u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std))


def _normal_(p: torch.Tensor, std: float, gen: torch.Generator) -> None:
    u = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    p.copy_(u.normal_(0.0, std, generator=gen))


@torch.no_grad()
def init_module(module: nn.Module, gen: torch.Generator) -> None:
    """Random init with the JAX package's initializer families: linear and
    conv kernels lecun-normal, biases zero, norm scales one, token
    embeddings N(0, 1/features), CLIP position embeddings N(0, 0.01^2)."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            _lecun_truncated_(m.weight, m.weight[0].numel(), gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, RMSNorm):
            m.weight.fill_(1.0)
        elif isinstance(m, nn.Embedding):
            std = 0.01 if name.endswith("position_embedding") else m.embedding_dim ** -0.5
            _normal_(m.weight, std, gen)


class StableDiffusionEngine:
    """Owns the modules (``MODULES``: UNet, VAE, text tower) on one device;
    parameters are initialised with :meth:`init_params` or loaded with
    :meth:`load_state_dicts`.  On a GPU, ``graphed_unet`` replays each
    UNet call variant (and int8 mode) from a CUDA graph of its last input
    shape; the call is :meth:`denoise`, the UNet with the ControlNet (when
    the call passes a control image) before it.  :meth:`set_quant_mode`
    sets the UNet's int8 mode; the VAE and the text towers stay exact.

    ControlNet and IP-Adapter are optional: :meth:`init_controlnet` builds
    ``controlnet`` (weights from ``load_state_dict`` or
    ``weights.load_controlnet_checkpoint``), :meth:`init_ip_adapter` builds
    ``image_proj`` and adds the UNet's IP projections.  Every change of
    weights goes through :meth:`weights_changed`, which drops the graphs
    and counts ``weights_version`` up (the pipeline's prompt memo reads
    it)."""

    MODULES = ("unet", "vae", "text")

    def __init__(
        self,
        unet_config: UNetConfig = None,
        vae_config: VAEConfig = None,
        text_config: CLIPTextConfig = None,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
    ):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.unet_config = unet_config or UNetConfig.sd15()
        self.vae_config = vae_config or VAEConfig.sd15()
        self.text_config = text_config or CLIPTextConfig.sd15()
        with torch.device(self.device):
            self._build_modules()
        for m in self.modules():
            self._place(m)
        self.controlnet: Optional[ControlNet] = None
        self.image_proj: Optional[ImageProjection] = None
        self.weights_version = 0
        self.graphed_unet = GraphedVariants(self.denoise, state=self._graph_state)

    def _place(self, m: nn.Module) -> nn.Module:
        m.requires_grad_(False).eval()
        # Conv weights in channels_last, matching the NHWC activations.
        return m.to(device=self.device, dtype=self.dtype, memory_format=torch.channels_last)

    def weights_changed(self) -> None:
        """Drop the UNet's CUDA graphs and count ``weights_version`` up:
        called after any change of the modules' weights."""
        self.graphed_unet.clear()
        self.weights_version += 1

    def _graph_state(self):
        mode = self.unet.quant_mode
        return (("quant", mode),) if mode else ()

    def set_quant_mode(self, mode: Optional[str]) -> "StableDiffusionEngine":
        """The UNet's int8 mode (``ops.quant.MODES``; None is exact)."""
        quant.set_quant_mode(self.unet, mode)
        return self

    def _build_modules(self) -> None:
        self.unet = UNet2DCondition(self.unet_config)
        self.vae = AutoencoderKL(self.vae_config)
        self.text = CLIPTextModel(self.text_config)

    def modules(self) -> Tuple[nn.Module, ...]:
        return tuple(getattr(self, name) for name in self.MODULES)

    # ------------------------------------------------------------- params
    def init_params(self, seed: int = 0) -> "StableDiffusionEngine":
        """Deterministic random init on the engine's device."""
        for i, m in enumerate(self.modules()):
            init_module(m, self._generator(seed, i))
        self.weights_changed()
        return self

    def load_state_dicts(self, sds: dict) -> "StableDiffusionEngine":
        """A state dict for each of ``MODULES`` (e.g. from
        ``weights.state_dicts_from_jax``), loaded strictly; an
        ``"image_proj"`` entry (IP-Adapter's projection, with the UNet's
        IP entries) needs :meth:`init_ip_adapter` first."""
        for key, m in zip(self.MODULES, self.modules()):
            m.load_state_dict(sds[key], strict=True)
        if "image_proj" in sds:
            if self.image_proj is None:
                raise ValueError("an image_proj state dict needs init_ip_adapter first")
            self.image_proj.load_state_dict(sds["image_proj"], strict=True)
        self.weights_changed()
        return self

    def _generator(self, seed: int, stream: int) -> torch.Generator:
        """A generator on the device seeded from (seed, stream)."""
        state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(state) & (2**63 - 1))

    def init_controlnet(self, seed: int = 0) -> ControlNet:
        """Build ``controlnet`` (the UNet's config) with a random encoder
        copy and zero heads: an exact no-op until trained or loaded."""
        with torch.device(self.device):
            net = ControlNet(self.unet_config)
        init_module(net, self._generator(seed, 0xC0))
        self.controlnet = self._place(net.zero_heads())
        self.weights_changed()
        return self.controlnet

    def init_ip_adapter(self, seed: int = 0, embed_dim: int = 1024,
                        num_tokens: int = 4) -> ImageProjection:
        """Build ``image_proj`` (``embed_dim`` -> ``num_tokens`` tokens) and
        add the UNet's ``to_k_ip``/``to_v_ip``, all randomly initialised."""
        with torch.device(self.device):
            proj = ImageProjection(embed_dim, self.unet_config.cross_attention_dim, num_tokens)
        self.unet.add_ip_adapter()
        ip = nn.ModuleList([getattr(a, p) for _, a in self.unet.cross_attentions()
                            for p in ("to_k_ip", "to_v_ip")])
        init_module(ip, self._generator(seed, 0x1BAD))
        init_module(proj, self._generator(seed, 0x1BAE))
        self.image_proj = self._place(proj)
        self.weights_changed()
        return self.image_proj

    def denoise(self, sample, timesteps, context, cache=None, tome_dst=None, text_embeds=None,
                time_ids=None, ip_context=None, ip_scale=None, control_image=None,
                control_scale=None, timestep_cond=None, **static):
        """One UNet call (``UNet2DCondition.forward``'s arguments), with
        IP-Adapter's tokens and scale, given ``control_image`` [B, 8h, 8w,
        3] and ``control_scale`` (a 0-dim tensor) the ControlNet's residuals
        first, and a w-conditioned UNet's ``timestep_cond``: every input a
        tensor, so that one CUDA graph holds both networks and copies each
        input in at every replay."""
        if control_image is not None:
            static["control_residuals"] = self.controlnet(
                sample, timesteps, context, control_image, control_scale, text_embeds, time_ids)
        if ip_context is not None:
            static.update(ip_context=ip_context, ip_scale=ip_scale)
        if timestep_cond is not None:
            static["timestep_cond"] = timestep_cond
        return self.unet(sample, timesteps, context, cache, tome_dst, text_embeds, time_ids,
                         **static)

    # ------------------------------------------------------ encode / decode
    @torch.inference_mode()
    def encode_prompts(self, input_ids: np.ndarray) -> torch.Tensor:
        """[B, 77] token ids -> [B, 77, C] fp32 hidden states."""
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long, device=self.device)
        return self.text(ids)

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B, h, w, 4] -> images [B, 8h, 8w, 3] in [0, 1]."""
        img = self.vae.decode(latents.to(self.device))
        return (img / 2 + 0.5).clamp(0.0, 1.0)

    @torch.inference_mode()
    def encode_image(self, images, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Images [B, H, W, 3] in [0, 1] -> scaled latents [B, H/8, W/8, 4]
        fp32: mapped to [-1, 1], encoded, one posterior sample (``noise``,
        else torch's default CPU generator's draw)."""
        x = torch.as_tensor(images, dtype=torch.float32).to(self.device) * 2.0 - 1.0
        return self.vae.encode_sample(x, noise)

    # ------------------------------------------------------------- sample
    def _unet_chunks(self, microbatch: int, args, tome_dst=None, added=None, extra=(),
                     **static):
        """:meth:`denoise` on the model batch as ``microbatch`` sequential
        chunks (or whole).  ``args`` (latents, timesteps, context and
        DeepCache's features or None) and ``added`` (SDXL's pooled
        embeddings and time_ids, and a w-conditioned UNet's guidance
        embedding, each or None) are batch-leading and chunk alike,
        and so do the outputs (one tensor, or DeepCache's pair);
        ``tome_dst`` goes whole to every chunk, and so does ``extra``
        (IP-Adapter's tokens and scale, the control image and scale, each
        or None), which the sampler passes only unchunked."""
        unet = self.graphed_unet if self.device.type == "cuda" else self.denoise
        n = len(args)
        args = (*args, *(added or (None, None, None)))

        def call(*part):
            text_embeds, time_ids, timestep_cond = part[n:]
            part = (*part[:n], tome_dst, text_embeds, time_ids, *(extra or (None,) * 4),
                    timestep_cond)
            while part[-1] is None:
                part = part[:-1]
            return unet(*part, **static)

        if microbatch <= 1:
            return call(*args)
        if args[0].shape[0] % microbatch:
            raise ValueError(f"unet_microbatch {microbatch} must divide the model batch "
                             f"{args[0].shape[0]}")
        chunks = [[None] * microbatch if a is None else a.chunk(microbatch) for a in args]
        outs = [call(*part) for part in zip(*chunks)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o) for o in zip(*outs))
        return torch.cat(outs)

    @torch.inference_mode()
    def sample(
        self,
        plan: SamplePlan,
        prompt_embeds: torch.Tensor,  # [B, T, C]
        negative_embeds: Optional[torch.Tensor],  # [B, T, C] or None
        seed: int = 0,
        sample_indices: Optional[Sequence[int]] = None,
        guidance_scale: float = 7.5,
        guidance_rescale: float = 0.0,
        cache_plan: Optional[CachePlan] = None,
        latent_hw: Tuple[int, int] = (64, 64),
        collect_x0: bool = False,
        x0_samples: Optional[int] = None,  # None = the whole batch
        decode: bool = True,
        init_latents: Optional[torch.Tensor] = None,
        microbatch: Optional[int] = None,
        step_noise: Optional[torch.Tensor] = None,  # [L, B, h, w, C]
        tome=None,  # a ratio in (0, 1) or a TomeConfig
        tome_dst: Optional[torch.Tensor] = None,  # [L, slots, D]
        added_cond: Optional[dict] = None,
        blend: Optional[tuple] = None,
        blend_noise: Optional[torch.Tensor] = None,  # [B, h, w, C]
        control: Optional[dict] = None,
        ip_adapter: Optional[dict] = None,
        time_loop: bool = True,
        mesh=None,
    ) -> SampleOutput:
        """One batch: CFG-doubled UNet calls over the plan's rows, then the
        decode.  Sample ``i``'s initial latents depend only on (seed, i)
        unless ``init_latents`` is given; a noise-injecting plan's noise at
        step k depends only on (seed, i, k) unless ``step_noise`` is given.
        With ``cache_plan`` the steps it marks not full run only the UNet's
        shallow branch on the trunk features of the last full step.

        ``guidance_rescale`` > 0 rescales the CFG combination toward the
        conditional prediction's standard deviation (Lin et al. 2023).
        ``tome`` merges tokens around the UNet's self-attentions
        (``ops/tome.py``); with ``tome.rand`` step i's destinations are
        drawn before the loop from (timestep, site, block) unless
        ``tome_dst`` gives them (row i for every call of step i).

        ``added_cond`` (SDXL's text_time conditioning): ``text_embeds``
        [B, P] (positive pooled embeddings), ``negative_text_embeds`` [B, P]
        (CFG's unconditional half; zeros when absent) and ``time_ids``
        [B, 6]; under CFG the pooled embeddings go in as [negative,
        positive] and the time_ids twice, as the context does.

        ``blend`` (inpainting): ``(mask [B, h, w, 1], 1 = regenerate; source
        latents [B, h, w, C]; blend_a [L]; blend_s [L])``, the last two from
        the scheduler's ``blend_schedule``.  After row k's scheduler step
        the kept region (mask 0) becomes ``blend_a[k] * source + blend_s[k]
        * blend_noise``; where not given, sample i's ``blend_noise`` is
        drawn from (seed, i, ``BLEND_NOISE_TAG``) (the JAX engine draws the
        batch's from ``fold_in(key, 0xB1E0D)``).

        ``control`` (ControlNet, :meth:`init_controlnet`): ``image`` [B, 8h,
        8w, 3] in [0, 1] at the latents' pixel size, doubled under CFG, and
        ``scale`` (1.0 where absent); DeepCache refuses it.  ``ip_adapter``
        (:meth:`init_ip_adapter`): ``image_embeds`` [B, E] and ``scale``;
        under CFG the unconditional half takes the projection of a zero
        embedding.  Neither composes with ``microbatch`` > 1.

        A w-conditioned UNet (``time_cond_proj_dim``, a full LCM model)
        takes the embedding of ``guidance_scale - 1`` for every row of the
        model batch (CFG-doubled where CFG runs) as its ``timestep_cond``.

        ``time_loop`` False skips the device synchronisations around the
        loop, so the loop, the decode and whatever follows queue on the
        device without a wait; ``execution_time`` is then -1.0.

        ``mesh`` (``parallel.make_mesh``) with a data axis above 1: every
        argument is the global batch's, this rank samples its rows
        (:meth:`_sample_rows`) and every rank returns the global batch."""
        if mesh is not None and mesh_lib.axis_size(mesh, "data") > 1:
            return self._sample_rows(mesh, plan, prompt_embeds, negative_embeds, dict(
                seed=seed, sample_indices=sample_indices, guidance_scale=guidance_scale,
                guidance_rescale=guidance_rescale, cache_plan=cache_plan, latent_hw=latent_hw,
                collect_x0=collect_x0, x0_samples=x0_samples, decode=decode,
                init_latents=init_latents, microbatch=microbatch, step_noise=step_noise,
                tome=tome, tome_dst=tome_dst, added_cond=added_cond, blend=blend,
                blend_noise=blend_noise, control=control, ip_adapter=ip_adapter,
                time_loop=time_loop))
        mesh_lib.check_data_only(mesh_lib.axis_size(mesh, "seq"),
                                 mesh_lib.axis_size(mesh, "model"), "engine.sample")
        dev = self.device
        B = int(prompt_embeds.shape[0])
        do_cfg = guidance_scale > 1.0 and negative_embeds is not None
        embeds = torch.cat([negative_embeds, prompt_embeds]) if do_cfg else prompt_embeds
        embeds = embeds.to(dev)
        lat_shape = (latent_hw[0], latent_hw[1], self.unet_config.in_channels)
        idx = range(B) if sample_indices is None else [int(i) for i in sample_indices]
        if init_latents is not None:
            latents0 = torch.as_tensor(init_latents, dtype=torch.float32).to(dev)
            if tuple(latents0.shape) != (B,) + lat_shape:
                raise ValueError(f"init_latents {tuple(latents0.shape)} != {(B,) + lat_shape}")
        else:
            latents0 = per_sample_latents(seed, idx, lat_shape, device=dev)
        if step_noise is not None:
            step_noise = torch.as_tensor(step_noise, dtype=torch.float32).to(dev)
            if tuple(step_noise.shape) != (plan.num_steps, B) + lat_shape:
                raise ValueError(f"step_noise {tuple(step_noise.shape)} != "
                                 f"{(plan.num_steps, B) + lat_shape}")
        if cache_plan is not None:
            if len(cache_plan.full) != plan.num_steps:
                raise ValueError("cache plan length != plan length")
            if not cache_plan.full[0]:
                raise ValueError("first step must compute the deep trunk")
        microbatch = int(microbatch or 0)
        x0_count = B if x0_samples is None else max(1, min(int(x0_samples), B))
        tome, dst = self._tome_destinations(plan, tome, tome_dst, cache_plan, latent_hw)
        static = {} if tome is None else {"tome": tome}
        added = (*(self._added(added_cond, do_cfg) or (None, None)),
                 self._timestep_cond(guidance_scale, B * (2 if do_cfg else 1)))
        extra = self._conditioning(control, ip_adapter, cache_plan, microbatch, B, latent_hw,
                                   do_cfg)

        xs = plan_rows(plan, dev)
        blend_src = None
        if blend is not None:
            mask, source, blend_a, blend_s = blend
            if len(blend_a) != plan.num_steps or len(blend_s) != plan.num_steps:
                raise ValueError("blend schedule length != plan length")
            xs["blend_a"] = torch.as_tensor(np.asarray(blend_a, np.float32), device=dev)
            xs["blend_s"] = torch.as_tensor(np.asarray(blend_s, np.float32), device=dev)
            blend_mask = torch.as_tensor(mask, dtype=torch.float32).to(dev)
            blend_src = torch.as_tensor(source, dtype=torch.float32).to(dev)
            if blend_noise is None:
                blend_noise = per_sample_noise(seed, idx, lat_shape, BLEND_NOISE_TAG)
            blend_noise = torch.as_tensor(blend_noise, dtype=torch.float32).to(dev)
            if blend_noise.shape != latents0.shape or blend_src.shape != latents0.shape:
                raise ValueError(f"blend source {tuple(blend_src.shape)} and noise "
                                 f"{tuple(blend_noise.shape)} != latents {tuple(latents0.shape)}")
        carry = init_carry(plan, latents0)
        cache = None
        x0s = []
        if time_loop:
            synchronize(dev)
        t0 = time.perf_counter()
        for i in range(plan.num_steps):
            r = row(xs, i)
            lat = carry.latents * r["in_scale"]
            lat_in = (torch.cat([lat, lat]) if do_cfg else lat).to(self.dtype)
            tb = r["timestep"].expand(lat_in.shape[0])
            if cache_plan is None:
                noise_pred = self._unet_chunks(microbatch, (lat_in, tb, embeds, None),
                                               dst["full"][i] if dst else None, added, extra,
                                               **static)
            elif cache_plan.full[i]:
                noise_pred, cache = self._unet_chunks(microbatch, (lat_in, tb, embeds, None),
                                                      dst["full"][i] if dst else None, added,
                                                      extra, return_cache=True,
                                                      cache_branch_id=cache_plan.branch, **static)
            else:
                noise_pred = self._unet_chunks(microbatch, (lat_in, tb, embeds, cache),
                                               dst["shallow"][i] if dst else None, added, extra,
                                               cache_branch_id=cache_plan.branch, **static)
            noise_pred = noise_pred.float()
            if do_cfg:
                eps_u, eps_t = noise_pred.chunk(2)
                eps = eps_u + guidance_scale * (eps_t - eps_u)
                if guidance_rescale > 0.0:
                    axes = tuple(range(1, eps.dim()))
                    std_t = eps_t.std(dim=axes, keepdim=True, correction=0)
                    std_c = eps.std(dim=axes, keepdim=True, correction=0)
                    eps = (guidance_rescale * (eps * std_t / std_c)
                           + (1.0 - guidance_rescale) * eps)
            else:
                eps = noise_pred
            noise = None
            if plan.needs_noise:
                noise = (step_noise[i] if step_noise is not None
                         else per_sample_step_noise(seed, idx, i, lat_shape, device=dev))
            carry, x0 = apply_row(carry, eps, r, noise)
            if blend_src is not None:
                target = r["blend_a"] * blend_src + r["blend_s"] * blend_noise
                carry = carry._replace(
                    latents=blend_mask * carry.latents + (1.0 - blend_mask) * target)
            if collect_x0:
                x0s.append(x0[:x0_count])
        if time_loop:
            synchronize(dev)
            execution_time = time.perf_counter() - t0
        else:
            execution_time = -1.0  # not timed: nothing waited for the loop

        latents = carry.latents
        images = self.decode(latents) if decode else None
        x0_images = torch.stack([self.decode(x) for x in x0s]) if collect_x0 else None
        return SampleOutput(images=images, execution_time=execution_time,
                            x0_images=x0_images, latents=latents, nfe=plan.nfe)

    def _sample_rows(self, mesh, plan, prompt_embeds, negative_embeds, kw) -> SampleOutput:
        """Data-parallel :meth:`sample`: this rank's contiguous rows of the
        batch (``parallel.mesh.RowShard``) with their global
        ``sample_indices``, so each row draws what it draws in one process,
        and its rows of every per-sample input (``init_latents``,
        ``step_noise``, ``blend`` and ``blend_noise``, ``added_cond``, the
        control image, the IP-Adapter embeddings); CFG pairs a row's own
        negative and positive.  The images, latents and x0 decodes are
        all-gathered along the data axis in rank order; ``execution_time``
        is the slowest rank's loop."""
        shard = mesh_lib.latent_sharding(mesh)
        B = int(prompt_embeds.shape[0])
        take = shard.take
        idx = np.arange(B) if kw["sample_indices"] is None else np.asarray(kw["sample_indices"])
        if len(idx) != B:
            raise ValueError(f"sample_indices has {len(idx)} entries for a batch of {B}")
        x0_count = B if kw["x0_samples"] is None else max(1, min(int(kw["x0_samples"]), B))
        n = B // shard.count
        # Each rank decodes the x0 of its first m rows (one shape on every
        # rank, for the gather); the batch's first x0_count rows are among them.
        m = min(n, x0_count)
        kw.update(sample_indices=[int(i) for i in take(idx)], x0_samples=m,
                  init_latents=take(kw["init_latents"]), blend_noise=take(kw["blend_noise"]),
                  step_noise=None if kw["step_noise"] is None else take(kw["step_noise"], 1))
        if kw["blend"] is not None:
            mask, source, blend_a, blend_s = kw["blend"]
            kw["blend"] = (take(mask), take(source), blend_a, blend_s)
        if kw["added_cond"] is not None:
            kw["added_cond"] = {k: take(v) for k, v in kw["added_cond"].items()}
        for key, field in (("control", "image"), ("ip_adapter", "image_embeds")):
            if kw[key] is not None:
                kw[key] = {**kw[key], field: take(np.asarray(kw[key][field], np.float32))}
        out = self.sample(plan, take(prompt_embeds), take(negative_embeds), **kw)
        group = mesh_lib.axis_group(mesh, "data")
        gather = functools.partial(distributed.all_gather_rows, group=group)
        x0 = None
        if out.x0_images is not None:
            x0 = gather(out.x0_images, dim=1)[:, [g // n * m + g % n for g in range(x0_count)]]
        t = out.execution_time
        return SampleOutput(
            images=None if out.images is None else gather(out.images),
            execution_time=distributed.all_max_scalar(t, group) if t >= 0 else t,
            x0_images=x0, latents=gather(out.latents), nfe=out.nfe)

    def _conditioning(self, control, ip_adapter, cache_plan, microbatch, B, latent_hw, do_cfg):
        """(IP tokens, IP scale, control image, control scale) at the model
        batch on the device, each None where unused."""
        dev = self.device
        ip_tokens = ip_scale = hint = control_scale = None
        if control is not None:
            if self.controlnet is None:
                raise ValueError("control needs the engine's ControlNet (init_controlnet)")
            if cache_plan is not None:
                raise ValueError("ControlNet cannot be combined with DeepCache")
            hint = torch.as_tensor(np.asarray(control["image"], np.float32)).to(dev)
            want = (B, latent_hw[0] * 8, latent_hw[1] * 8, 3)
            if tuple(hint.shape) != want:
                raise ValueError(f"control image {tuple(hint.shape)} != {want}")
            if do_cfg:
                hint = torch.cat([hint, hint])
            control_scale = torch.tensor(float(control.get("scale", 1.0)), device=dev)
        if ip_adapter is not None:
            if self.image_proj is None:
                raise ValueError("ip_adapter needs the engine's image projection "
                                 "(init_ip_adapter, or a loaded IP-Adapter)")
            emb = torch.as_tensor(np.asarray(ip_adapter["image_embeds"], np.float32)).to(dev)
            if emb.shape[0] != B:
                raise ValueError(f"image_embeds batch {emb.shape[0]} != {B}")
            ip_tokens = self.image_proj(emb)
            if do_cfg:
                # The unconditional half conditions on a zero image embedding.
                ip_tokens = torch.cat([self.image_proj(torch.zeros_like(emb)), ip_tokens])
            ip_scale = torch.tensor(float(ip_adapter.get("scale", 1.0)), device=dev)
        if microbatch > 1 and (control is not None or ip_adapter is not None):
            raise ValueError("unet_microbatch composes with the plain, SDXL and DeepCache UNet "
                             "calls only (not ControlNet or IP-Adapter)")
        return ip_tokens, ip_scale, hint, control_scale

    def _timestep_cond(self, guidance_scale: float, rows: int) -> Optional[torch.Tensor]:
        """A w-conditioned UNet's guidance embedding of ``guidance_scale -
        1`` for ``rows`` rows on the device, else None."""
        dim = getattr(self.unet_config, "time_cond_proj_dim", None)
        if dim is None:
            return None
        w = torch.full((rows,), guidance_scale - 1.0, dtype=torch.float32)
        return guidance_scale_embedding(w, dim).to(self.device)

    def _added(self, added_cond, do_cfg):
        """(pooled embeddings, time_ids) at the model batch on the device, or
        None without ``added_cond``."""
        if added_cond is None:
            return None
        pos = torch.as_tensor(added_cond["text_embeds"], dtype=torch.float32).to(self.device)
        ids = torch.as_tensor(added_cond["time_ids"], dtype=torch.float32).to(self.device)
        if do_cfg:
            neg = added_cond.get("negative_text_embeds")
            neg = (torch.zeros_like(pos) if neg is None
                   else torch.as_tensor(neg, dtype=torch.float32).to(self.device))
            pos, ids = torch.cat([neg, pos]), torch.cat([ids, ids])
        return pos, ids

    def _tome_destinations(self, plan, tome, tome_dst, cache_plan, latent_hw):
        """(TomeConfig or None, {call variant: [L, slots, D] destinations on
        the device} or None).  A ratio <= 0 turns ToMe off.  Without
        ``tome_dst`` each variant's slots (a full call's, and DeepCache's
        shallow call's) are drawn per step."""
        if tome is not None and not isinstance(tome, TomeConfig):
            tome = TomeConfig(ratio=float(tome)) if float(tome) > 0 else None
        if tome is None or not tome.rand:
            if tome_dst is not None:
                raise ValueError("tome_dst needs a ToMe config with rand")
            return tome, None
        variants = {"full": None} if cache_plan is None else {"full": None,
                                                               "shallow": cache_plan.branch}
        if tome_dst is not None:
            tome_dst = torch.as_tensor(tome_dst, dtype=torch.int64)
            if tome_dst.dim() != 3 or tome_dst.shape[0] != plan.num_steps:
                raise ValueError(f"tome_dst {tuple(tome_dst.shape)} is not [{plan.num_steps}, "
                                 f"slots, D]")
            return tome, {v: tome_dst.to(self.device) for v in variants}
        out = {}
        for v, branch in variants.items():
            slots = self.unet.tome_slots(*latent_hw, tome, branch)
            out[v] = torch.stack([tome_destinations(int(t), slots, tome)
                                  for t in plan.timesteps]).to(self.device)
        return tome, out


class SDXLEngine(StableDiffusionEngine):
    """The SDXL engine: SDXL's UNet (depth and heads a level, text_time
    conditioning), the SDXL VAE and two text towers, ``text`` (CLIP ViT-L)
    and ``text2`` (OpenCLIP bigG with its ``text_projection``).  Sampling
    is the base engine's, given ``added_cond``."""

    MODULES = ("unet", "vae", "text", "text2")

    def __init__(self, unet_config: UNetConfig = None, vae_config: VAEConfig = None,
                 text_configs: SDXLTextConfigs = None, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        tc = text_configs or SDXLTextConfigs.sdxl()
        self.text2_config = tc.text2
        super().__init__(unet_config or UNetConfig.sdxl(), vae_config or VAEConfig.sdxl(),
                         tc.text1, dtype=dtype, device=device)

    def _build_modules(self) -> None:
        super()._build_modules()
        self.text2 = CLIPTextModelWithProjection(self.text2_config)

    @torch.inference_mode()
    def encode_prompts_xl(self, ids1: np.ndarray, ids2: np.ndarray):
        """Token ids of each tower's tokenizer -> (context [B, 77, 768 + 1280],
        both towers' penultimate states side by side; pooled [B, 1280], the
        bigG tower's end-of-text state through ``text_projection``), fp32."""
        as_ids = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long,  # noqa: E731
                                           device=self.device)
        o1, o2 = self.text.outputs(as_ids(ids1)), self.text2.outputs(as_ids(ids2))
        ctx = torch.cat([o1["penultimate_hidden_state"], o2["penultimate_hidden_state"]], dim=-1)
        # In fp32, as the JAX engine keeps its projection.
        pooled = o2["pooled_output"] @ self.text2.text_projection.weight.float().t()
        return ctx, pooled
