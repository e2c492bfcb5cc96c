"""Latent-consistency distillation: LCM-LoRA and the w-conditioned full
student.

Counterpart of ``sonicdiffusionbayeslab_tpu/training/distillation.py``
(Luo et al. 2023): distill a guided diffusion teacher into a consistency
model that samples in 1-8 steps with ``lcm_scheduler``'s plan, whose
boundary scalings it shares (``schedulers/lcm.py::boundary_scalings``).
One step:

  z_t   = alpha_t x + sigma_t eps               (noising at a grid node t)
  eps_w = eps_c + w (eps_c - eps_u)             (the frozen teacher with CFG,
                                                 one call over [uncond|cond])
  z_s   = DDIM(z_t -> s = t - k) under eps_w    (one step down the grid)
  f_on  = c_skip(t) z_t + c_out(t) x0_student(z_t, t)
  f_tg  = c_skip(s) z_s + c_out(s) x0_target(z_s, s)   (the EMA target, no
                                                        gradient; x0 of z_t
                                                        where s < 0)
  loss  = huber(f_on - f_tg)

The student is LoRA adapters over the frozen teacher (LCM-LoRA) or, with
``lora_rank=0``, an fp32 copy of the UNet.  With
``student_time_cond_proj_dim`` that copy gains a zero-initialised
``cond_proj`` and is conditioned on w's embedding (the full LCM recipe,
w drawn per example in [w_min, w_max]); only a UNet built with that
``time_cond_proj_dim`` samples it.

PyTorch runs the step eagerly: three UNet calls (the teacher at twice the
batch and the target under ``no_grad``, the student with its backward
through the kernels' autograd Functions), ``torch.autograd.grad`` over the
trainable tensors, then clip, AdamW and the EMA, all in place.  The draws
(grid index, noise, w) come from a ``torch.Generator`` or are passed in.
Data parallel (``mesh``) as ``training/trainer.py``: this rank's rows,
the global batch's draws, the loss and gradients averaged over the data
axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call
from torch.profiler import record_function

from sonicdiffusionbayeslab_torch.models.sampler import guidance_scale_embedding
from sonicdiffusionbayeslab_torch.models.unet import UNet2DCondition
from sonicdiffusionbayeslab_torch.schedulers.lcm import boundary_scalings
from sonicdiffusionbayeslab_torch.schedulers.schedule import NoiseSchedule, ScheduleConfig
from sonicdiffusionbayeslab_torch.training import optim
from sonicdiffusionbayeslab_torch.training.lora import DEFAULT_TARGETS, apply_lora, init_lora
from sonicdiffusionbayeslab_torch.parallel.mesh import batch_sharding
from sonicdiffusionbayeslab_torch.training.trainer import (TrainState, _clone_tree, _f32_copy,
                                                           _own, data_mean_, ema_update, leaves)


@dataclasses.dataclass(frozen=True)
class LCMDistillConfig:
    """The JAX package's ``LCMDistillConfig``, field for field."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    # Consistency distillation (diffusers' LCM training conventions).
    guidance_scale: float = 7.5  # the fixed w without w sampling
    original_inference_steps: int = 50  # N nodes of the distillation grid
    timestep_scaling: float = 10.0
    sigma_data: float = 0.5
    huber_c: float = 0.001
    # Accepted for the JAX package's configs; a no-op here, where the state
    # is always updated in place (continue from the returned state).
    donate: bool = True
    ema_decay: float = 0.95  # the target network's EMA
    lora_rank: int = 64  # 0: a full UNet copy
    lora_targets: str = DEFAULT_TARGETS
    lora_scale: float = 1.0
    # The full LCM recipe: w ~ U[w_min, w_max] per example, embedded at this
    # width into a zero-initialised cond_proj (lora_rank 0 only).
    w_min: Optional[float] = None
    w_max: Optional[float] = None
    student_time_cond_proj_dim: Optional[int] = None


class LCMDistiller:
    """The consistency-distillation step for an engine's UNet (the teacher,
    frozen): ``init_state`` makes the student and its optimizer state,
    ``distill_step`` takes one step.  A call that passes no generator draws
    from the distiller's own, seeded with 0."""

    def __init__(self, engine, config: LCMDistillConfig = LCMDistillConfig(),
                 schedule_config: ScheduleConfig = None, mesh=None):
        self.engine = engine
        self.config = config
        self.mesh = mesh
        self.schedule = NoiseSchedule.create(schedule_config or ScheduleConfig())
        if self.schedule.config.prediction_type != "epsilon":
            raise ValueError("LCM distillation implemented for epsilon-prediction teachers")
        T = self.schedule.config.num_train_timesteps
        N = config.original_inference_steps
        if T % N:
            raise ValueError(f"num_train_timesteps {T} not divisible by grid {N}")
        self.w_conditioned = config.student_time_cond_proj_dim is not None
        self.student_unet = engine.unet
        if self.w_conditioned:
            if config.lora_rank > 0:
                raise ValueError(
                    "w-conditioned distillation needs a full student "
                    "(lora_rank=0): the cond_proj has no teacher counterpart")
            if (config.w_min is None) != (config.w_max is None):
                raise ValueError("set both w_min and w_max (or neither)")
            # The student's module: its weights are always the state's
            # (functional_call), so it holds none of its own.
            with torch.device("meta"):
                self.student_unet = UNet2DCondition(dataclasses.replace(
                    engine.unet_config, time_cond_proj_dim=config.student_time_cond_proj_dim))
        elif config.w_min is not None or config.w_max is not None:
            raise ValueError("w sampling requires student_time_cond_proj_dim")
        self.target = "lora" if config.lora_rank > 0 else "unet"
        self.k = T // N
        # The ascending grid t_i = (i + 1) k - 1: lcm_timesteps' nodes.
        self.grid = np.arange(1, N + 1, dtype=np.int64) * self.k - 1
        chain = []
        if config.max_grad_norm and config.max_grad_norm > 0:
            chain.append(optim.clip_by_global_norm(config.max_grad_norm))
        chain.append(optim.adamw(config.learning_rate, b1=config.betas[0], b2=config.betas[1],
                                 eps=config.eps, weight_decay=config.weight_decay))
        self.tx = optim.chain(*chain)
        dev = engine.device
        self.generator = torch.Generator(device=dev).manual_seed(0)
        self._ac = torch.tensor(self.schedule.alphas_cumprod, dtype=torch.float32, device=dev)
        self._grid = torch.as_tensor(self.grid, device=dev)
        c_skip, c_out = boundary_scalings(np.arange(T), config.timestep_scaling,
                                          config.sigma_data)
        self._c_skip = torch.tensor(c_skip, dtype=torch.float32, device=dev)
        self._c_out = torch.tensor(c_out, dtype=torch.float32, device=dev)

    # ----------------------------------------------------------- state
    def init_state(self, generator: Optional[torch.Generator] = None,
                   trainable=None) -> TrainState:
        """The student: ``trainable`` copied (e.g. ``weights.trainable_from_jax``),
        else fresh LoRA adapters over the teacher (``a`` from ``generator``,
        else the distiller's) or an fp32 copy of the teacher's UNet, with a
        zero ``cond_proj`` when w-conditioned (step 0 is the teacher for
        every w).  The EMA target starts as a copy of it."""
        cfg, eng = self.config, self.engine
        if trainable is None:
            if cfg.lora_rank > 0:
                trainable = init_lora(eng.unet, cfg.lora_rank, generator or self.generator,
                                      cfg.lora_targets)
            else:
                trainable = dict(eng.unet.named_parameters())
                if self.w_conditioned:
                    trainable["time_embedding.cond_proj.weight"] = torch.zeros(
                        eng.unet_config.block_out_channels[0], cfg.student_time_cond_proj_dim)
        trainable = _f32_copy(trainable, eng.device)
        flat = leaves(trainable)
        for t in flat.values():
            t.requires_grad_(True)
        return TrainState(step=0, trainable=trainable, opt_state=self.tx.init(flat),
                          ema=_clone_tree(trainable))

    # ----------------------------------------------------------- step
    def _alpha_sigma(self, t):
        """(sqrt(acp), sqrt(1 - acp)) at ``t`` as [B, 1, 1, 1]; t = -1 (below
        the grid) is the clean boundary, acp = 1."""
        a2 = torch.where(t >= 0, self._ac[t.clamp(min=0)], torch.ones((), device=t.device))
        return a2.sqrt()[:, None, None, None], (1.0 - a2).sqrt()[:, None, None, None]

    def _scalings(self, t):
        """(c_skip, c_out) at ``t`` (>= 0) as [B, 1, 1, 1]."""
        return self._c_skip[t][:, None, None, None], self._c_out[t][:, None, None, None]

    def _student_params(self, tree):
        """The student's weights in the UNet's dtype for ``functional_call``:
        the teacher's with the adapters merged (LoRA), or the whole tree."""
        if self.config.lora_rank > 0:
            return apply_lora(dict(self.engine.unet.named_parameters()), tree,
                              scale=self.config.lora_scale)
        dt = self.engine.unet.dtype
        return {k: v.to(dt) for k, v in tree.items()}

    def draws(self, batch: int, latent_shape, generator: Optional[torch.Generator] = None):
        """(grid index [B], noise, w [B] or None) from ``generator`` (else
        the distiller's): the index uniform over the grid, standard normal
        noise of ``latent_shape``, w uniform in [w_min, w_max] where the
        config samples it."""
        gen = generator or self.generator
        cfg = self.config
        idx = torch.randint(0, len(self.grid), (batch,), generator=gen, device=gen.device)
        noise = torch.randn(tuple(latent_shape), generator=gen, device=gen.device)
        w = None
        if cfg.w_min is not None:
            w = cfg.w_min + (cfg.w_max - cfg.w_min) * torch.rand(batch, generator=gen,
                                                                 device=gen.device)
        return idx, noise, w

    def value_and_grad(self, state: TrainState, latents, context, uncond_context,
                       generator: Optional[torch.Generator] = None, idx=None, noise=None,
                       w=None):
        """(loss, {leaf name: gradient}) of one batch at ``state``: latents
        [B, h, w, C] clean (VAE-scaled), context and uncond_context [B, T,
        D].  ``idx`` (grid indices), ``noise`` and ``w`` replace the draws.
        Profiler spans ``distill_step.teacher``, ``.target`` and
        ``.loss_and_grad``."""
        cfg, eng = self.config, self.engine
        dev, dt = eng.device, eng.unet.dtype
        latents = _own(latents).to(dev, torch.float32)
        context, uncond = _own(context).to(dev), _own(uncond_context).to(dev)
        B = latents.shape[0]
        shard = batch_sharding(self.mesh)
        if idx is None or noise is None or (w is None and cfg.w_min is not None):
            Bg = B * shard.count  # the global batch's draws on every rank
            d_idx, d_noise, d_w = self.draws(Bg, (Bg,) + tuple(latents.shape[1:]), generator)
            idx = d_idx if idx is None else idx
            noise = d_noise if noise is None else noise
            w = d_w if w is None else w
        idx, noise, w = shard.take(idx), shard.take(noise), shard.take(w)
        if cfg.w_min is None:
            w = torch.full((B,), cfg.guidance_scale, dtype=torch.float32)
        w = torch.as_tensor(w).to(dev, torch.float32)
        noise = torch.as_tensor(noise).to(dev, torch.float32)
        t = self._grid[torch.as_tensor(idx).to(dev, torch.long)]
        s = t - self.k  # the next node down; -1 below grid[0] is the clean boundary
        a_t, s_t = self._alpha_sigma(t)
        z_t = a_t * latents + s_t * noise

        with torch.no_grad(), record_function("distill_step.teacher"):
            eps2 = eng.unet(torch.cat([z_t, z_t]).to(dt), torch.cat([t, t]).float(),
                            torch.cat([uncond, context]).to(dt)).float()
        eps_u, eps_c = eps2.chunk(2)
        eps_w = eps_c + w[:, None, None, None] * (eps_c - eps_u)
        x0_t = (z_t - s_t * eps_w) / a_t  # one DDIM step down the grid
        a_s, s_s = self._alpha_sigma(s)
        z_s = a_s * x0_t + s_s * eps_w
        s0 = s.clamp(min=0)
        # Diffusers' convention: the student embeds w itself while the
        # teacher's guidance is eps_c + w (eps_c - eps_u); sampling embeds
        # guidance_scale - 1, so a guidance scale g is the teacher's CFG g.
        kw = ({"timestep_cond": guidance_scale_embedding(w, cfg.student_time_cond_proj_dim)}
              if self.w_conditioned else {})
        ctx = context.to(dt)

        def f_consistency(params, z, tt, aa, ss, c_skip, c_out):
            eps = functional_call(self.student_unet, params, (z.to(dt), tt.float(), ctx), kw,
                                  strict=False).float()
            return c_skip * z + c_out * ((z - ss * eps) / aa)

        # The target (EMA student) for every row, replaced by x0_t at the
        # clean boundary, as the JAX step's where: a fixed launch count.
        with torch.no_grad(), record_function("distill_step.target"):
            f_tgt = torch.where((s < 0)[:, None, None, None], x0_t,
                                f_consistency(self._student_params(state.ema), z_s, s0, a_s, s_s,
                                              *self._scalings(s0)))
        flat = leaves(state.trainable)
        with record_function("distill_step.loss_and_grad"):
            f_on = f_consistency(self._student_params(state.trainable), z_t, t, a_t, s_t,
                                 *self._scalings(t))
            loss = (torch.sqrt((f_on - f_tgt) ** 2 + cfg.huber_c ** 2) - cfg.huber_c).mean()
            grads = torch.autograd.grad(loss, list(flat.values()))
        loss = loss.detach()
        data_mean_(self.mesh, [loss, *grads])
        return loss, dict(zip(flat, grads))

    def distill_step(self, state: TrainState, latents, context, uncond_context,
                     generator: Optional[torch.Generator] = None, idx=None, noise=None, w=None):
        """One step (:meth:`value_and_grad`, then the clip, AdamW and the EMA
        target's update) -> (new state, {"loss", "grad_norm"}), both 0-dim
        tensors on the device (grad_norm before clipping); the state's
        tensors are updated in place.  Profiler span
        ``distill_step.optimizer`` beside value_and_grad's."""
        cfg = self.config
        loss, grads = self.value_and_grad(state, latents, context, uncond_context, generator,
                                          idx, noise, w)
        flat = leaves(state.trainable)
        with torch.no_grad(), record_function("distill_step.optimizer"):
            gnorm = optim.global_norm(grads)
            updates, opt_state = self.tx.update(grads, state.opt_state, flat)
            optim.apply_updates(flat, updates)
            ema_update(leaves(state.ema), flat, cfg.ema_decay)
        return (TrainState(step=state.step + 1, trainable=state.trainable, opt_state=opt_state,
                           ema=state.ema),
                {"loss": loss, "grad_norm": gnorm})

    # ----------------------------------------------------------- export
    def student_unet_params(self, state: TrainState, use_ema: bool = True):
        """The distilled UNet's state dict in the UNet's dtype, for sampling
        with the LCM plan: the EMA target's by default (the network the
        consistency property holds for).  A w-conditioned student's loads
        into a UNet built with its ``time_cond_proj_dim``."""
        tree = state.ema if use_ema else state.trainable
        unet = self.engine.unet
        if self.config.lora_rank > 0:
            sd = {k: v.detach() for k, v in unet.state_dict().items()}
            with torch.no_grad():
                sd.update(apply_lora(sd, tree, scale=self.config.lora_scale))
            return sd
        return {k: v.detach().to(unet.dtype) for k, v in tree.items()}
