"""Textual inversion (Gal et al. 2022): learn new concept token embeddings.

Counterpart of ``sonicdiffusionbayeslab_tpu/training/textual_inversion.py``.
The only trainable tensor is k rows of the CLIP text tower's token table
(the placeholder tokens); the UNet, the VAE and the rest of the tower stay
frozen.  The step puts the rows into the table out of place
(``index_put``) and runs the tower with that table through
``torch.func.functional_call``, so autograd reaches exactly those rows, and
no parameter requires grad or is modified.  The text tower's forward runs
inside the step with gradient, then the frozen UNet's: the gradient reaches
the rows through the cross-attentions' K and V, through the attention
kernel's autograd Function (``ops/flash_attention.py::FlashAttentionFn``);
the tower's own causal attention takes the plain path, as in inference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from sonicdiffusionbayeslab_torch.schedulers.schedule import NoiseSchedule, ScheduleConfig
from sonicdiffusionbayeslab_torch.training import optim
from sonicdiffusionbayeslab_torch.training.trainer import (TrainConfig, TrainState, _own,
                                                           ema_update)
from sonicdiffusionbayeslab_torch.utils import profiling

# The token table's name in the text tower's state dict.
TOKEN_TABLE = "text_model.embeddings.token_embedding.weight"


class TextualInversionTrainer:
    """Optimizes the token-table rows ``placeholder_ids`` of the engine's
    text tower (``text``).  A call that passes no generator draws from the
    trainer's own, seeded with 0."""

    def __init__(self, engine, placeholder_ids: Sequence[int], config: TrainConfig = TrainConfig(),
                 schedule_config: ScheduleConfig = None):
        self.engine = engine
        self.config = config
        # Order kept: init_ids pair with placeholder_ids by position.
        self.placeholder_ids = np.asarray(list(dict.fromkeys(int(i) for i in placeholder_ids)))
        if len(self.placeholder_ids) == 0:
            raise ValueError("need at least one placeholder token id")
        if self.placeholder_ids.max() >= engine.text_config.vocab_size:
            raise ValueError("placeholder id out of vocab range")
        self.schedule = NoiseSchedule.create(schedule_config or ScheduleConfig())
        if config.prediction_type not in ("epsilon", "v_prediction"):
            raise ValueError(f"unknown prediction_type {config.prediction_type!r}")
        lr = (optim.linear_schedule(0.0, config.learning_rate, config.warmup_steps)
              if config.warmup_steps > 0 else config.learning_rate)
        chain = []
        if config.max_grad_norm and config.max_grad_norm > 0:
            chain.append(optim.clip_by_global_norm(config.max_grad_norm))
        # Plain Adam: weight decay would drag the concept embedding to zero.
        chain.append(optim.adam(lr, b1=config.betas[0], b2=config.betas[1], eps=config.eps))
        self.tx = optim.chain(*chain)
        dev = engine.device
        self.generator = torch.Generator(device=dev).manual_seed(0)
        self._ids = torch.as_tensor(self.placeholder_ids, device=dev)
        ac = torch.tensor(self.schedule.alphas_cumprod, dtype=torch.float32, device=dev)
        self._ac, self._snr = ac, ac / (1.0 - ac)

    @property
    def _table(self) -> torch.Tensor:
        return self.engine.text.text_model.embeddings.token_embedding.weight

    def _patched(self, rows: torch.Tensor) -> torch.Tensor:
        """The token table with ``rows`` at the placeholder ids, out of place."""
        table = self._table
        return table.index_put((self._ids,), rows.to(table.dtype))

    # ----------------------------------------------------------- state
    def init_state(self, init_ids: Optional[Sequence[int]] = None) -> TrainState:
        """The rows, fp32: copies of the rows of ``init_ids`` (existing tokens
        that seed the concepts, e.g. a coarse class), else of the
        placeholders' own.  EMA only with ``ema_decay``."""
        src = np.asarray(init_ids) if init_ids is not None else self.placeholder_ids
        if len(src) != len(self.placeholder_ids):
            raise ValueError("init_ids length != placeholder count")
        rows = self._table[torch.as_tensor(src, device=self.engine.device)].detach().float()
        rows = rows.clone().requires_grad_(True)
        ema = rows.detach().clone() if self.config.ema_decay else None
        return TrainState(step=0, trainable=rows, opt_state=self.tx.init({"rows": rows}),
                          ema=ema)

    # ----------------------------------------------------------- step
    def value_and_grad(self, state: TrainState, latents, input_ids,
                       generator: Optional[torch.Generator] = None, timesteps=None, noise=None):
        """(loss, the rows' gradient [k, C]) of one batch at ``state``:
        latents [B, h, w, C] (VAE-scaled), ``input_ids`` [B, T] holding the
        placeholders.  ``timesteps`` and ``noise`` replace the draws (t
        uniform over the training timesteps, then standard normal noise)."""
        cfg, eng = self.config, self.engine
        dev, dt = eng.device, eng.unet.dtype
        latents = _own(torch.as_tensor(latents)).to(dev, torch.float32)
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long, device=dev)
        B = latents.shape[0]
        gen = generator or self.generator
        if timesteps is None:
            timesteps = torch.randint(0, len(self._ac), (B,), generator=gen, device=gen.device)
        if noise is None:
            noise = torch.randn(tuple(latents.shape), generator=gen, device=gen.device)
        idx = torch.as_tensor(timesteps).to(dev, torch.long)
        noise = torch.as_tensor(noise).to(dev, torch.float32)
        a = self._ac[idx][:, None, None, None]
        sqrt_a, sqrt_1ma = a.sqrt(), (1.0 - a).sqrt()
        noisy = sqrt_a * latents + sqrt_1ma * noise
        y = sqrt_a * noise - sqrt_1ma * latents if cfg.prediction_type == "v_prediction" else noise
        if cfg.snr_gamma is not None:
            snr = self._snr[idx]
            w = torch.clamp(snr, max=cfg.snr_gamma)
            w = w / (snr + 1.0) if cfg.prediction_type == "v_prediction" else w / snr
        else:
            w = torch.ones(B, device=dev)
        rows = state.trainable
        ctx = functional_call(eng.text, {TOKEN_TABLE: self._patched(rows)}, (ids,), strict=False)
        pred = eng.unet(noisy.to(dt), idx.float(), ctx.to(dt)).float()
        loss = (w * ((pred - y) ** 2).mean(dim=(1, 2, 3))).mean()
        (grad,) = torch.autograd.grad(loss, [rows])
        return loss.detach(), grad

    def train_step(self, state: TrainState, latents, input_ids,
                   generator: Optional[torch.Generator] = None, timesteps=None, noise=None):
        """One optimization step -> (new state, {"loss", "grad_norm"}), both
        0-dim tensors on the device (grad_norm before clipping); the rows
        (and their EMA) are updated in place.  Profiler spans
        ``ti_step.loss_and_grad`` and ``ti_step.optimizer``."""
        with profiling.span("ti_step.loss_and_grad"):
            loss, grad = self.value_and_grad(state, latents, input_ids, generator, timesteps,
                                             noise)
        flat = {"rows": state.trainable}
        with torch.no_grad(), profiling.span("ti_step.optimizer"):
            grads = {"rows": grad}
            gnorm = optim.global_norm(grads)
            updates, opt_state = self.tx.update(grads, state.opt_state, flat)
            optim.apply_updates(flat, updates)
            if self.config.ema_decay:
                ema_update({"rows": state.ema}, flat, self.config.ema_decay)
        return (TrainState(step=state.step + 1, trainable=state.trainable, opt_state=opt_state,
                           ema=state.ema),
                {"loss": loss, "grad_norm": gnorm})

    # ----------------------------------------------------------- export
    def text_params(self, state: TrainState, use_ema: bool = False):
        """The text tower's state dict with the learned rows in its token
        table (the EMA's with ``use_ema`` where kept): loads into the
        engine's ``text`` for ``encode_prompts``."""
        rows = state.ema if (use_ema and state.ema is not None) else state.trainable
        sd = {k: v.detach() for k, v in self.engine.text.state_dict().items()}
        with torch.no_grad():
            sd[TOKEN_TABLE] = self._patched(rows)
        return sd

    def save_embeddings(self, state: TrainState, path) -> None:
        """The portable artifact, as the JAX package writes it: an npz of
        ``ids`` (the placeholder ids) and ``embeddings`` (the rows, fp32)."""
        np.savez(path, ids=self.placeholder_ids,
                 embeddings=state.trainable.detach().float().cpu().numpy())
