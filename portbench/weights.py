"""The benchmark's weights: made from ``--seed`` on the device, a few large
draws a network, and handed alike to the program and to the reference.

For each network of a configuration (``reference.sample.build_nets`` on
the meta device gives the names and shapes), one standard normal draw of
all its parameters in the served dtype from a device ``torch.Generator``
seeded by (seed, network index), then scaled in place: a matrix or kernel
by 1/sqrt(fan_in), a token embedding by 1/sqrt(width), a position
embedding by 0.01, a norm's scale to 1 + 0.05 n and its shift to 0.02 n,
any other bias to 0.02 n.  Keys listed in ``ZERO_KEYS`` of a network are
zero (the VAE's attention q/k/v biases, which the port has no place for).
The same seed gives the same bits on every call.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from portbench.reference import nets
from portbench.reference.sample import build_nets

# The VAE mid attention's q/k/v biases of diffusers' layout: zero (the
# port's VAE attention has none).
ZERO_SUFFIXES = ("attentions.0.to_q.bias", "attentions.0.to_k.bias", "attentions.0.to_v.bias")


def _kinds(module: nn.Module) -> Dict[str, str]:
    """{parameter name: kind} with kind matrix, embedding, position, scale,
    shift, bias or zero."""
    out = {}
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            key = f"{mname}.{pname}" if mname else pname
            if isinstance(m, (nets.GroupNorm, nn.LayerNorm)):
                kind = "scale" if pname == "weight" else "shift"
            elif isinstance(m, nn.Embedding):
                kind = "position" if mname.endswith("position_embedding") else "embedding"
            elif p.dim() >= 2:
                kind = "matrix"
            else:
                kind = "bias"
            if key.endswith(ZERO_SUFFIXES):
                kind = "zero"
            out[key] = kind
    return out


def stream_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed of its own for each stream of the run's ``seed``."""
    entropy = [int(seed) % 2**64, *map(int, stream)]
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return int(state) & 0x7FFF_FFFF_FFFF_FFFF


@torch.no_grad()
def make_weights(config: Dict, seed: int, device, dtype: torch.dtype,
                 names=None) -> Dict[str, Dict]:
    """{network name: state dict} of the configuration's networks (those in
    ``names``, else all), each parameter a view of its network's one flat
    draw; a network's draw does not depend on which others are made."""
    out = {}
    for index, (name, net) in enumerate(build_nets(config, device="meta").items()):
        if names is not None and name not in names:
            continue
        kinds = _kinds(net)
        shapes = {k: p.shape for k, p in net.named_parameters()}
        total = sum(int(np.prod(s)) for s in shapes.values())
        gen = torch.Generator(device=device).manual_seed(stream_seed(seed, index))
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        sd, at = {}, 0
        for key, shape in shapes.items():
            n = int(np.prod(shape))
            t = flat[at:at + n].view(shape)
            at += n
            kind = kinds[key]
            if kind == "matrix":
                t.mul_(float(np.prod(shape[1:])) ** -0.5)
            elif kind == "embedding":
                t.mul_(shape[-1] ** -0.5)
            elif kind == "position":
                t.mul_(0.01)
            elif kind == "scale":
                t.mul_(0.05).add_(1.0)
            elif kind in ("shift", "bias"):
                t.mul_(0.02)
            else:
                t.zero_()
            sd[key] = t
        out[name] = sd
    return out


def program_state(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A network's state dict as the port loads it: without the keys that
    are zero by ``ZERO_SUFFIXES``."""
    return {k: v for k, v in sd.items() if not k.endswith(ZERO_SUFFIXES)}


@torch.no_grad()
def make_adapters(names_shapes: Dict[str, tuple], rank: int, seed: int, device) -> Dict:
    """LoRA adapters {module: {"a": [in, r], "b": [r, out]}} in float32 for
    the weights ``names_shapes`` ({module: (out, in)}): ``a`` N(0, 1/in)
    from one draw on the device, ``b`` zero (so the first step is the base
    model's)."""
    total = sum(shape[1] * rank for shape in names_shapes.values())
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 0x10AA))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name in sorted(names_shapes):
        d_out, d_in = names_shapes[name]
        a = flat[at:at + d_in * rank].view(d_in, rank).mul_(d_in ** -0.5)
        at += d_in * rank
        out[name] = {"a": a, "b": torch.zeros(rank, d_out, device=device)}
    return out
