"""Training: the diffusion train step (full fine-tune, LoRA, ControlNet;
ddpm and flow objectives; EMA; remat), its optimizers and the
config-driven loop.

Counterpart of ``sonicdiffusionbayeslab_tpu/training/`` without LCM
distillation and textual inversion (ROADMAP.md item A6).
"""

from sonicdiffusionbayeslab_torch.training.lora import (
    apply_lora,
    init_lora,
    lora_to_peft_state_dict,
)
from sonicdiffusionbayeslab_torch.training.trainer import (
    DiffusionTrainer,
    TrainConfig,
    TrainState,
)

__all__ = [
    "DiffusionTrainer",
    "TrainConfig",
    "TrainState",
    "init_lora",
    "apply_lora",
    "lora_to_peft_state_dict",
]
