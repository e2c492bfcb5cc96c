"""The diffusion train step.

Counterpart of ``sonicdiffusionbayeslab_tpu/training/trainer.py``: noise and
timestep draws, forward-process noising, the UNet (or MMDiT) forward, the
prediction-target loss (epsilon / v_prediction with optional min-SNR-γ
weighting, or rectified-flow matching), the gradient, the global-norm
clip, the optimizer (``training/optim.py``, ``training/opt8bit.py``) and
EMA.  PyTorch runs it eagerly: the engine's modules are driven through
``torch.func.functional_call`` with the trainable tensors in place of
their weights, and the hand-written kernels sit on the forward pass inside
``torch.autograd.Function``s (``ops/flash_attention.py::FlashAttentionFn``,
``ops/groupnorm.py::GroupNormSiLUFn``), whose backwards are the JAX
package's plain rules.

Random draws (t, noise, flow's u) come from an explicit ``torch.Generator``
and may be passed in (``noise=``, ``timesteps=``, ``u=``), so a test can
feed the JAX package's draws.  The state's tensors are updated in place,
as the JAX step donates its state: always continue from the returned
state.

Data parallel (``mesh`` with a data axis above 1, one process a rank): a
step's batch arguments are this rank's rows of the global batch, the
draws (drawn or passed) are the global batch's, made alike on every rank
from the same generator and cut to the rank's rows, and the loss and the
gradients are averaged over the data axis before the clip and the
optimizer, so every rank takes the step one process takes on the global
batch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.func import functional_call
from torch.profiler import record_function
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from sonicdiffusionbayeslab_torch.parallel import distributed
from sonicdiffusionbayeslab_torch.parallel.mesh import axis_group, axis_size, batch_sharding
from sonicdiffusionbayeslab_torch.schedulers.schedule import NoiseSchedule, ScheduleConfig
from sonicdiffusionbayeslab_torch.training import optim
from sonicdiffusionbayeslab_torch.training.lora import DEFAULT_TARGETS, apply_lora, init_lora


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's ``TrainConfig``, field for field."""

    learning_rate: float = 1e-4
    weight_decay: float = 1e-2
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    warmup_steps: int = 0
    max_grad_norm: float = 1.0
    prediction_type: str = "epsilon"  # epsilon | v_prediction (ddpm objective)
    snr_gamma: Optional[float] = None  # min-SNR-gamma loss weighting (None = uniform)
    # "ddpm" (epsilon/v on the alphas_cumprod forward process) or "flow":
    # rectified-flow matching for the MMDiT (x_t = (1 - σ) x0 + σ ε with
    # σ = sigmoid(u), u ~ N(logit_mean, logit_std); the target is the
    # velocity ε - x0; the timestep input σ * 1000).
    objective: str = "ddpm"  # ddpm | flow
    logit_mean: float = 0.0
    logit_std: float = 1.0
    flow_num_train_timesteps: int = 1000
    ema_decay: Optional[float] = None  # None = no EMA shadow
    # LoRA: rank > 0 trains adapters only (base UNet frozen).
    lora_rank: int = 0
    lora_targets: str = DEFAULT_TARGETS
    lora_scale: float = 1.0
    # unet (full fine-tune) | lora (implied by lora_rank > 0) | controlnet
    # (the encoder copy and its heads; the UNet frozen; a hint image batch).
    train_target: str = "unet"
    controlnet_scale: float = 1.0
    # Rematerialization of the forward (torch.utils.checkpoint), saving only
    # the outputs of matmuls without batch dims, as the JAX package's
    # dots_with_no_batch_dims_saveable policy: the backward runs the forward
    # again, so each forward kernel launches twice a step.
    remat: bool = False
    optimizer: str = "adamw"  # adamw | adamw8bit | adafactor
    # Accepted for the JAX package's configs; a no-op here, where the state
    # is always updated in place.
    donate: bool = True


@dataclasses.dataclass
class TrainState:
    step: int
    trainable: Any  # {param name: fp32 tensor}, or LoRA {module: {"a", "b"}}
    opt_state: Any
    ema: Any  # a copy of ``trainable`` or None


_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """Keep the outputs of 2-D matmuls (no batch dims), recompute the rest."""
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                   _save_matmuls))


def _own(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A normal copy of an inference-mode tensor (the engine's encoders run
    under ``torch.inference_mode``, and autograd cannot save such a tensor)."""
    return t.clone() if t is not None and t.is_inference() else t


def data_mean_(mesh, tensors) -> None:
    """Average ``tensors`` in place over ``mesh``'s data axis (no-op
    without one)."""
    if axis_size(mesh, "data") > 1:
        distributed.all_mean_(tensors, axis_group(mesh, "data"))


def leaves(trainable) -> Dict[str, torch.Tensor]:
    """The trainable tensors as one flat tree (LoRA: ``<module>/a``, ``/b``)."""
    out = {}
    for name, t in trainable.items():
        if isinstance(t, dict):
            out.update({f"{name}/{k}": v for k, v in t.items()})
        else:
            out[name] = t
    return out


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float) -> None:
    """``e = d * e + (1 - d) * p`` in place for every leaf, d in fp32 as the
    JAX package's EMA takes it."""
    d = torch.tensor(decay, dtype=torch.float32)
    one_minus = float(1.0 - d)
    for k, e in ema.items():
        e.mul_(float(d)).add_(params[k] * one_minus)


def _f32_copy(tree, device):
    """An fp32 copy of a {name: tensor} or LoRA {module: {"a", "b"}} tree on
    ``device``, never an alias of the caller's tensors."""
    return {k: (_f32_copy(v, device) if isinstance(v, dict)
                else v.detach().to(device, torch.float32, copy=True)) for k, v in tree.items()}


def _clone_tree(trainable):
    return {k: ({kk: vv.detach().clone() for kk, vv in v.items()} if isinstance(v, dict)
                else v.detach().clone()) for k, v in trainable.items()}


class DiffusionTrainer:
    """The train step for an engine's UNet (or MMDiT): ``init_state`` makes
    the trainable tensors and the optimizer state, ``train_step`` takes
    one step.  A call that passes no generator draws from the trainer's
    own, seeded with 0."""

    def __init__(self, engine, config: TrainConfig = TrainConfig(),
                 schedule_config: ScheduleConfig = None, mesh=None):
        self.engine = engine
        self.config = config
        self.mesh = mesh
        self.schedule = NoiseSchedule.create(schedule_config or ScheduleConfig())
        if config.prediction_type not in ("epsilon", "v_prediction"):
            raise ValueError(f"unknown prediction_type {config.prediction_type!r}")
        if config.objective not in ("ddpm", "flow"):
            raise ValueError(f"unknown objective {config.objective!r} (ddpm|flow)")
        if config.train_target not in ("unet", "lora", "controlnet"):
            raise ValueError(f"unknown train_target {config.train_target!r}")
        if config.objective == "flow":
            if config.train_target == "controlnet":
                raise ValueError("flow objective has no ControlNet family (MMDiT)")
            if config.snr_gamma is not None:
                raise ValueError(
                    "snr_gamma is a DDPM-SNR concept; the flow objective's "
                    "timestep density is the logit_mean/logit_std weighting")
        self.target = (
            "lora" if (config.lora_rank > 0 and config.train_target == "unet")
            else config.train_target
        )
        if self.target == "lora" and config.lora_rank <= 0:
            raise ValueError("train_target='lora' requires lora_rank > 0")
        self.tx = self._make_optimizer()
        self.generator = torch.Generator(device=engine.device).manual_seed(0)
        ac = torch.tensor(self.schedule.alphas_cumprod, dtype=torch.float32,
                          device=engine.device)
        self._ac, self._snr = ac, ac / (1.0 - ac)

    # ----------------------------------------------------------- optimizer
    def _make_optimizer(self) -> optim.Transform:
        cfg = self.config
        lr = (optim.linear_schedule(0.0, cfg.learning_rate, cfg.warmup_steps)
              if cfg.warmup_steps > 0 else cfg.learning_rate)
        chain = []
        if cfg.max_grad_norm and cfg.max_grad_norm > 0:
            chain.append(optim.clip_by_global_norm(cfg.max_grad_norm))
        if cfg.optimizer == "adafactor":
            chain.append(optim.adafactor(lr, weight_decay_rate=cfg.weight_decay or None))
        elif cfg.optimizer == "adamw8bit":
            from sonicdiffusionbayeslab_torch.training.opt8bit import adamw8bit

            chain.append(adamw8bit(lr, b1=cfg.betas[0], b2=cfg.betas[1], eps=cfg.eps,
                                   weight_decay=cfg.weight_decay))
        elif cfg.optimizer == "adamw":
            chain.append(optim.adamw(lr, b1=cfg.betas[0], b2=cfg.betas[1], eps=cfg.eps,
                                     weight_decay=cfg.weight_decay))
        else:
            raise ValueError(
                f"unknown optimizer {cfg.optimizer!r} (adamw|adamw8bit|adafactor)")
        return optim.chain(*chain)

    # ----------------------------------------------------------- state
    def init_state(self, generator: Optional[torch.Generator] = None,
                   controlnet_state: Optional[Dict[str, torch.Tensor]] = None,
                   adapters=None) -> TrainState:
        """LoRA: fresh adapters over the frozen UNet (``a`` from
        ``generator``, else the trainer's), or ``adapters`` (e.g.
        ``weights.lora_from_jax``).  ControlNet: an fp32 copy of
        ``controlnet_state`` or of the engine's ControlNet (built with
        ``init_controlnet`` if absent: zero heads, so step 0 is the frozen
        UNet's).  Full: an fp32 master copy of the UNet's weights."""
        cfg = self.config
        eng = self.engine
        if self.target == "lora":
            trainable = adapters or init_lora(eng.unet, cfg.lora_rank,
                                              generator or self.generator, cfg.lora_targets)
        elif self.target == "controlnet":
            if controlnet_state is None:
                net = eng.controlnet if eng.controlnet is not None else eng.init_controlnet(0)
                controlnet_state = dict(net.named_parameters())
            trainable = controlnet_state
        else:
            trainable = dict(eng.unet.named_parameters())
        trainable = _f32_copy(trainable, eng.device)
        flat = leaves(trainable)
        for t in flat.values():
            t.requires_grad_(True)
        ema = _clone_tree(trainable) if cfg.ema_decay else None
        return TrainState(step=0, trainable=trainable, opt_state=self.tx.init(flat), ema=ema)

    # ----------------------------------------------------------- step
    def draws(self, batch: int, latent_shape, generator: Optional[torch.Generator] = None):
        """(t or u [B], noise) from ``generator`` (else the trainer's): t
        uniform over the training timesteps (ddpm) or u ~ N(logit_mean,
        logit_std) (flow), then standard normal noise of ``latent_shape``."""
        gen = generator or self.generator
        cfg = self.config
        if cfg.objective == "flow":
            first = cfg.logit_mean + cfg.logit_std * torch.randn(
                batch, generator=gen, device=gen.device)
        else:
            first = torch.randint(0, len(self._ac), (batch,), generator=gen, device=gen.device)
        return first, torch.randn(tuple(latent_shape), generator=gen, device=gen.device)

    def _unet_call(self, module, params, x, t, c, added, **kw):
        return functional_call(module, params, (x, t, c), {**(added or {}), **kw},
                               strict=False)

    def value_and_grad(self, state: TrainState, latents, context, generator=None, hint=None,
                       added=None, noise=None, timesteps=None, u=None):
        """(loss, {leaf name: gradient}) of one batch at ``state``: latents
        [B, h, w, C] (VAE-scaled), context [B, T, D]; ``hint`` [B, 8h, 8w,
        3] the control image (controlnet target); ``added`` the MMDiT's
        ``text_embeds`` or SDXL's ``text_embeds`` and ``time_ids``.
        ``noise``, ``timesteps`` (ddpm) and ``u`` (flow) replace the draws."""
        cfg, eng = self.config, self.engine
        dev, dt = eng.device, eng.unet.dtype
        latents = _own(latents).to(dev, torch.float32)
        context = _own(context).to(dev)
        added = {k: _own(v).to(dev) for k, v in (added or {}).items()}
        B = latents.shape[0]
        shard = batch_sharding(self.mesh)
        if (noise is None) or (timesteps is None and u is None):
            Bg = B * shard.count  # the global batch's draws on every rank
            first, drawn = self.draws(Bg, (Bg,) + tuple(latents.shape[1:]), generator)
            noise = drawn if noise is None else noise
            if cfg.objective == "flow":
                u = first if u is None else u
            else:
                timesteps = first if timesteps is None else timesteps
        noise, timesteps, u = shard.take(noise), shard.take(timesteps), shard.take(u)
        noise = torch.as_tensor(noise).to(dev, torch.float32)
        if cfg.objective == "flow":
            sigma = torch.sigmoid(torch.as_tensor(u).to(dev, torch.float32))
            s = sigma[:, None, None, None]
            noisy = (1.0 - s) * latents + s * noise
            y = noise - latents
            t = sigma * cfg.flow_num_train_timesteps
            w = torch.ones(B, device=dev)
        else:
            idx = torch.as_tensor(timesteps).to(dev, torch.long)
            a = self._ac[idx][:, None, None, None]
            sqrt_a, sqrt_1ma = a.sqrt(), (1.0 - a).sqrt()
            noisy = sqrt_a * latents + sqrt_1ma * noise
            y = sqrt_a * noise - sqrt_1ma * latents if cfg.prediction_type == "v_prediction" \
                else noise
            t = idx.float()
            if cfg.snr_gamma is not None:
                snr = self._snr[idx]
                w = torch.clamp(snr, max=cfg.snr_gamma)
                # min-SNR-γ (Hang et al. 2023): epsilon loss over SNR, v over SNR + 1.
                w = w / (snr + 1.0) if cfg.prediction_type == "v_prediction" else w / snr
            else:
                w = torch.ones(B, device=dev)

        maybe_remat = _remat if cfg.remat else (lambda fn, *a: fn(*a))
        x_in, c_in = noisy.to(dt), context.to(dt)
        flat = leaves(state.trainable)
        if self.target == "controlnet":
            if hint is None:
                raise ValueError("controlnet training needs a hint image batch")
            hint = _own(torch.as_tensor(hint)).to(dev)
            scale = torch.tensor(cfg.controlnet_scale, device=dev)

            def fwd(tr, x, tt, c, h):
                residuals = functional_call(
                    eng.controlnet, {k: v.to(dt) for k, v in tr.items()},
                    (x, tt, c, h, scale), added, strict=False)
                return eng.unet(x, tt, c, control_residuals=residuals, **added).float()

            pred = maybe_remat(fwd, state.trainable, x_in, t, c_in, hint)
        elif self.target == "lora":
            merged = apply_lora(dict(eng.unet.named_parameters()), state.trainable,
                                scale=cfg.lora_scale)

            def fwd(p, x, tt, c):
                return self._unet_call(eng.unet, p, x, tt, c, added).float()

            pred = maybe_remat(fwd, merged, x_in, t, c_in)
        else:
            def fwd(tr, x, tt, c):
                return self._unet_call(eng.unet, {k: v.to(dt) for k, v in tr.items()},
                                       x, tt, c, added).float()

            pred = maybe_remat(fwd, state.trainable, x_in, t, c_in)
        per = ((pred - y) ** 2).mean(dim=(1, 2, 3))
        loss = (w * per).mean()
        grads = torch.autograd.grad(loss, list(flat.values()))
        loss = loss.detach()
        data_mean_(self.mesh, [loss, *grads])
        return loss, dict(zip(flat, grads))

    def train_step(self, state: TrainState, latents, context, generator=None, hint=None,
                   added=None, noise=None, timesteps=None, u=None):
        """One optimization step -> (new state, {"loss", "grad_norm"}), both
        0-dim tensors on the device (grad_norm before clipping).  The
        state's tensors are updated in place.  Profiler spans:
        ``train_step.loss_and_grad`` and ``train_step.optimizer`` (the
        norm, the clipped update and EMA)."""
        with record_function("train_step.loss_and_grad"):
            loss, grads = self.value_and_grad(state, latents, context, generator, hint, added,
                                              noise, timesteps, u)
        flat = leaves(state.trainable)
        with torch.no_grad(), record_function("train_step.optimizer"):
            gnorm = optim.global_norm(grads)
            updates, opt_state = self.tx.update(grads, state.opt_state, flat)
            optim.apply_updates(flat, updates)
            if self.config.ema_decay:
                ema_update(leaves(state.ema), flat, self.config.ema_decay)
        new_state = TrainState(step=state.step + 1, trainable=state.trainable,
                               opt_state=opt_state, ema=state.ema)
        return new_state, {"loss": loss, "grad_norm": gnorm}

    # ----------------------------------------------------------- export
    def unet_params(self, state: TrainState, use_ema: bool = False) -> Dict[str, torch.Tensor]:
        """The effective UNet state dict for sampling (the EMA shadow's
        with ``use_ema`` where kept), in the UNet's dtype."""
        tree = state.ema if (use_ema and state.ema is not None) else state.trainable
        unet = self.engine.unet
        sd = {k: v.detach() for k, v in unet.state_dict().items()}
        if self.target == "lora":
            with torch.no_grad():
                sd.update(apply_lora(sd, tree, scale=self.config.lora_scale))
            return sd
        if self.target == "controlnet":
            return sd  # frozen; the trained weights are the ControlNet's
        return {k: v.detach().to(unet.dtype) for k, v in tree.items()}

    def controlnet_params(self, state: TrainState, use_ema: bool = False):
        """The trained ControlNet's state dict, in the UNet's dtype."""
        if self.target != "controlnet":
            raise ValueError("trainer target is not 'controlnet'")
        tree = state.ema if (use_ema and state.ema is not None) else state.trainable
        return {k: v.detach().to(self.engine.unet.dtype) for k, v in tree.items()}
