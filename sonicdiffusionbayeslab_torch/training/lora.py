"""LoRA adapters over a torch module's weights, merged functionally.

Counterpart of ``sonicdiffusionbayeslab_tpu/training/lora.py``.  An
adapter keeps the JAX package's layout, ``{"a": [in, r], "b": [r, out]}``
for a linear weight ``W`` [out, in], and the effective weight is
``W + (alpha / r) * scale * (a @ b)ᵀ``, summed in fp32 and cast back to
W's dtype.  ``a`` is Gaussian (std ``in^-½``), ``b`` zero, so step 0 is
the base model exactly.  Adapters are keyed by the module's name in the
port's (diffusers') naming, e.g.
``down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q``; the
target sets below are the JAX package's restated over those names.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

# Attention projections: the JAX package's ``.*/(to_q|...)/kernel$`` over
# its paths, here over the port's parameter names (``to_out`` is
# ``to_out.0``, the transformer MLP's proj_in/proj_out ``ff.net.0.proj`` and
# ``ff.net.2``).
DEFAULT_TARGETS = r".*\.(to_q|to_k|to_v|to_out\.0|to_qkv|to_kv)\.weight$"
ATTN_AND_FF_TARGETS = (
    r".*\.(to_q|to_k|to_v|to_out\.0|to_qkv|to_kv|ff\.net\.0\.proj|ff\.net\.2)\.weight$"
)
# MMDiT joint attention: both streams' projections.
MMDIT_TARGETS = (
    r".*\.(to_q|to_k|to_v|to_out\.0|add_q_proj|add_k_proj|add_v_proj|to_add_out)\.weight$"
)

Adapters = Dict[str, Dict[str, torch.Tensor]]


def lora_targets(module, targets: str = DEFAULT_TARGETS) -> Dict[str, torch.Tensor]:
    """{module name: weight} of the 2-D (linear) weights whose parameter
    names match ``targets``; convolutions are left to full fine-tuning.
    ``module``: an ``nn.Module`` or its {parameter name: tensor} (a split
    module's whole weights, ``parallel.mesh.SplitParams.whole_state``)."""
    pat = re.compile(targets)
    params = module.named_parameters() if isinstance(module, nn.Module) else module.items()
    return {name[: -len(".weight")]: w for name, w in params
            if pat.match(name) and w.dim() == 2}


def init_lora(module, rank: int, generator: Optional[torch.Generator] = None,
              targets: str = DEFAULT_TARGETS, dtype: torch.dtype = torch.float32) -> Adapters:
    """Fresh adapters for every target of ``module`` (as
    :func:`lora_targets` takes it), in sorted name order:
    ``a`` from ``generator`` (on its device; torch's default CPU generator
    if None) over the module's device, ``b`` zero."""
    matched = lora_targets(module, targets)
    if not matched:
        raise ValueError(f"no LoRA targets matched {targets!r}")
    gen_device = generator.device if generator is not None else torch.device("cpu")
    adapters: Adapters = {}
    for name in sorted(matched):
        w = matched[name]
        d_out, d_in = w.shape
        a = torch.randn((d_in, rank), generator=generator, device=gen_device, dtype=torch.float32)
        adapters[name] = {"a": (a / max(d_in, 1) ** 0.5).to(w.device, dtype),
                          "b": torch.zeros((rank, d_out), dtype=dtype, device=w.device)}
    return adapters


def apply_lora(weights: Mapping[str, torch.Tensor], adapters: Adapters, scale: float = 1.0,
               alpha: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """``{"<module>.weight": W + (alpha/r) * scale * (a @ b)ᵀ}`` for every
    adapted module, from ``weights`` (parameter name -> tensor, e.g.
    ``dict(module.named_parameters())``); differentiable in the adapters."""
    out = {}
    for name, ab in adapters.items():
        w = weights[f"{name}.weight"]
        r = ab["a"].shape[-1]
        eff_alpha = float(alpha) if alpha is not None else float(r)
        delta = (ab["a"] @ ab["b"]) * (eff_alpha / r) * scale
        out[f"{name}.weight"] = (w.float() + delta.float().t()).to(w.dtype)
    return out


def lora_to_peft_state_dict(adapters: Adapters, prefix: str = "unet") -> Dict[str, np.ndarray]:
    """The peft layout that ``models/weights.py::merge_lora`` reads:
    ``<prefix>.<module>.lora_A.weight`` [r, in], ``lora_B.weight`` [out, r]
    and ``alpha`` (= r), as fp32 numpy arrays, the JAX package's export."""
    out: Dict[str, np.ndarray] = {}
    for name, ab in adapters.items():
        r = ab["a"].shape[-1]
        out[f"{prefix}.{name}.lora_A.weight"] = ab["a"].detach().float().cpu().numpy().T
        out[f"{prefix}.{name}.lora_B.weight"] = ab["b"].detach().float().cpu().numpy().T
        out[f"{prefix}.{name}.alpha"] = np.asarray(float(r), np.float32)
    return out
