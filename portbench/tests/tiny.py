"""Tiny versions of the benchmark's configurations and cells, with the
port's tiny models' geometries (``UNetConfig.tiny``/``tiny_xl``,
``VAEConfig.tiny``, the tiny text towers), for driving the harness on the
CPU."""

from __future__ import annotations

import copy
from typing import Dict

from portbench import run as harness

TINY_UNET = {
    "sd15": dict(block_out_channels=[32, 64], layers_per_block=1, attention_head_dim=2,
                 cross_attention_dim=32, down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"],
                 up_block_types=["UpBlock2D", "CrossAttnUpBlock2D"]),
    "sdxl": dict(block_out_channels=[32, 64], layers_per_block=1, attention_head_dim=[2, 4],
                 cross_attention_dim=32, transformer_layers_per_block=[1, 2],
                 down_block_types=["DownBlock2D", "CrossAttnDownBlock2D"],
                 up_block_types=["CrossAttnUpBlock2D", "UpBlock2D"],
                 addition_time_embed_dim=8, projection_class_embeddings_input_dim=16 + 6 * 8),
}
TINY_TEXT = {
    ("sd15", "text"): dict(vocab_size=1000, hidden_size=32, num_hidden_layers=2,
                           num_attention_heads=2, intermediate_size=64),
    ("sdxl", "text"): dict(vocab_size=1000, hidden_size=16, num_hidden_layers=2,
                           num_attention_heads=2, intermediate_size=32),
    ("sdxl", "text2"): dict(vocab_size=1000, hidden_size=16, num_hidden_layers=2,
                            num_attention_heads=2, intermediate_size=32, projection_dim=16),
}


def tiny_config(name: str, dtype: str = "float32") -> Dict:
    cfg = copy.deepcopy(harness.load_json(harness.ROOT / "configs" / f"{name}.json"))
    cfg["modules"]["unet"]["config"].update(TINY_UNET[name])
    # The port's tiny pipelines all take VAEConfig.tiny(), SD-1.5's scaling.
    cfg["modules"]["vae"]["config"].update(block_out_channels=[16, 32], layers_per_block=1,
                                           scaling_factor=0.18215)
    for (cname, tower), sizes in TINY_TEXT.items():
        if cname == name:
            cfg["modules"][tower]["config"].update(sizes)
    kwargs = {"tiny": True, **({"variant": "sd15"} if name == "sd15" else {})}
    cfg["pipeline"].update(dtype=dtype, image_size=64, program_kwargs=kwargs)
    return cfg


def tiny_spec(workload: str, limits=None, config=None, **mix) -> Dict:
    """The cell's spec with its configuration (or ``config``, another
    configuration's name) cut to the tiny geometry and its mix to ``mix``'s
    values (default: batch 4, 3 steps, 2 chunks)."""
    spec = harness.cell_spec(workload)
    spec["config"] = tiny_config(config or spec["cell"]["config"])
    spec["mix"] = dict(spec["mix"], **{"batch": 4, "steps": 3, "unet_microbatch": 2,
                                       "check_images": 3, "trace_seconds": 0.5, **mix})
    if limits is not None:
        spec["cell"] = dict(spec["cell"], limits=limits)
    return spec
