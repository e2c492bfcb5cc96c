"""Plan consumer: the scheduler half of each denoising step, in torch.

Counterpart of ``sonicdiffusionbayeslab_tpu/schedulers/runtime.py``.
Everything runs in float32 whatever the model dtype: a step is a few
scalar-weighted sums of fp32 latents, history entries and the model output.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from sonicdiffusionbayeslab_torch.schedulers.plan import SamplePlan


class SchedulerCarry(NamedTuple):
    latents: torch.Tensor  # fp32 [B, ...]
    hist: torch.Tensor  # fp32 [H, B, ...]
    saved: Optional[torch.Tensor]  # fp32 [B, ...] or None (fixed per plan)


def plan_rows(plan: SamplePlan, device) -> Dict[str, torch.Tensor]:
    """``plan.scan_xs()`` as fp32 tensors on ``device``; row i is ``{k: v[i]}``."""
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in plan.scan_xs().items()}


def row(xs: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in xs.items()}


def init_carry(plan: SamplePlan, latents: torch.Tensor) -> SchedulerCarry:
    latents = latents.float()
    if plan.init_scale != 1.0:
        latents = latents * plan.init_scale
    hist = latents.new_zeros((plan.hist_depth,) + tuple(latents.shape))
    saved = torch.zeros_like(latents) if plan.has_saved else None
    return SchedulerCarry(latents, hist, saved)


def apply_row(
    carry: SchedulerCarry,
    eps: torch.Tensor,
    xs: Dict[str, torch.Tensor],
    noise: Optional[torch.Tensor] = None,
) -> tuple[SchedulerCarry, torch.Tensor]:
    """One scheduler step; ``xs`` is this step's row.  Returns the new carry
    and the step's x0 prediction."""
    x = carry.latents
    eps = eps.float()

    m = xs["cm_sample"] * x + xs["cm_eps"] * eps
    x0 = xs["cx_sample"] * x + xs["cx_eps"] * eps

    pushed = torch.cat([m[None], carry.hist[:-1]], dim=0)
    hist = torch.where(xs["push"] > 0, pushed, carry.hist)

    new = xs["w_sample"] * x + xs["w_eps"] * eps
    new = new + torch.tensordot(xs["w_hist"], hist, dims=1)
    if carry.saved is not None:
        new = new + xs["w_saved"] * carry.saved
        saved = xs["s_x"] * x + xs["s_saved"] * carry.saved
        saved = saved + torch.tensordot(xs["s_hist"], hist, dims=1)
    else:
        saved = None
    if noise is not None:
        new = new + xs["w_noise"] * noise
    return SchedulerCarry(new, hist, saved), x0


def run_plan(
    plan: SamplePlan,
    initial_latents: torch.Tensor,
    eps_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    generator: Optional[torch.Generator] = None,
    collect_x0: bool = False,
):
    """Model-free plan runner.  ``eps_fn(timestep, latents) -> model output``;
    the generator draws the noise of plans that inject it."""
    if plan.needs_noise and generator is None:
        raise ValueError(f"plan {plan.name} injects noise; pass a generator")
    xs = plan_rows(plan, initial_latents.device)
    carry = init_carry(plan, initial_latents)
    x0s = []
    for i in range(plan.num_steps):
        r = row(xs, i)
        eps = eps_fn(r["timestep"], r["in_scale"] * carry.latents)
        noise = None
        if plan.needs_noise:
            noise = torch.randn(carry.latents.shape, generator=generator,
                                device=generator.device, dtype=torch.float32)
            noise = noise.to(carry.latents.device)
        carry, x0 = apply_row(carry, eps, r, noise)
        if collect_x0:
            x0s.append(x0)
    if collect_x0:
        return carry.latents, torch.stack(x0s)
    return carry.latents
