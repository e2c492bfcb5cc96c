"""Training: the diffusion train step (full fine-tune, LoRA, ControlNet;
ddpm and flow objectives; EMA; remat), LCM consistency distillation
(LCM-LoRA and the w-conditioned full student), textual inversion, their
optimizers and the config-driven loop.

Counterpart of ``sonicdiffusionbayeslab_tpu/training/``, on one device or
over ranks: data-parallel (``mesh_data``) and tensor-parallel
(``mesh_model``), as the JAX loop reads its mesh; it has no
sequence-parallel training.
"""

from sonicdiffusionbayeslab_torch.training.distillation import LCMDistillConfig, LCMDistiller
from sonicdiffusionbayeslab_torch.training.lora import (
    apply_lora,
    init_lora,
    lora_to_peft_state_dict,
)
from sonicdiffusionbayeslab_torch.training.textual_inversion import TextualInversionTrainer
from sonicdiffusionbayeslab_torch.training.trainer import (
    DiffusionTrainer,
    TrainConfig,
    TrainState,
)

__all__ = [
    "DiffusionTrainer",
    "LCMDistillConfig",
    "LCMDistiller",
    "TextualInversionTrainer",
    "TrainConfig",
    "TrainState",
    "init_lora",
    "apply_lora",
    "lora_to_peft_state_dict",
]
