"""The device mesh and the placement of batches and parameters on it.

Counterpart of ``sonicdiffusionbayeslab_tpu/parallel/mesh.py``: one mesh
over the axes ("data", "seq", "model") (a
``torch.distributed.device_mesh.DeviceMesh`` of one rank a process).  The
JAX package annotates arrays and lets GSPMD insert the collectives; here a
rank holds its own rows and weights, and the layers call the collectives
themselves (``parallel/distributed.py``).

* ``data``: batch parallel.  :func:`shard_batch` gives this rank's
  contiguous rows of a batch, as the JAX package's ``P("data")`` sharding
  puts them.
* ``seq``: sequence parallel.  :func:`latent_sharding` splits the latent
  height too (``P("data", "seq")``): rank r of ``seq`` holds rows
  ``[r * h / n, (r + 1) * h / n)`` of every feature map; the 3x3 convs
  exchange halo rows, GroupNorm merges its statistics across the axis and
  self-attention gathers K and V.
* ``model``: tensor parallel.  :func:`place_module` keeps on each rank its
  share of the heads and hidden units of the UNet's, ControlNet's,
  MMDiT's and T5's layers (``models/layers.py``, ``mmdit.py``, ``t5.py``);
  the row-parallel output projections sum their partials across the axis.
  :func:`shard_params` places parameters by the JAX package's
  ``_TP_RULES``; what a rank runs departs from that where a local kernel
  needs it (:func:`place_module`).

What stays refused names ROADMAP.md item A9b (:data:`A9B`): training with
``seq`` or ``model`` above 1, Token Merging with ``seq``, int8 with
``model``, the int8 conv modes with ``seq`` (their activation scale is
one a sample, over rows that the ranks split), and CUDA-graph capture of
the collectives (a split model runs eagerly).

Without a process group :func:`make_mesh` of one rank is ``None``: the
callers' single-device path, as a ``mesh=None`` argument is everywhere.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import torch

from sonicdiffusionbayeslab_torch.parallel import distributed

AXES = ("data", "seq", "model")
A9 = ("ROADMAP.md item A9 (tensor and sequence parallel sampling: the UNet, ControlNet, MMDiT "
      "and T5 over model, the latent height over seq)")
A9B = ("ROADMAP.md item A9b (training under seq or model, ToMe under seq, int8 under model, "
       "int8 convs under seq, CUDA-graph capture of the collectives)")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_seq: int = 1,
              device_type: Optional[str] = None):
    """The ("data", "seq", "model") mesh over the world's ranks; by default
    every rank on the data axis.  Raises ValueError when the axes' product
    is not the world size.  With no process group (a world of one) the mesh
    is ``None``.  ``device_type`` (where the mesh's tensors live) defaults
    to CUDA under NCCL and the CPU under gloo; ranks sharing one GPU over
    gloo pass "cuda"."""
    world = distributed.world_size()
    if n_data is None:
        n_data = world // (n_model * n_seq)
    if n_data * n_model * n_seq != world:
        raise ValueError(f"mesh {n_data}x{n_seq}x{n_model} != {world} processes (devices)")
    if not distributed.is_initialized():
        return None
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = device_type or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(dev, (n_data, n_seq, n_model), mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` (1 for a ``None`` mesh)."""
    if mesh is None:
        return 1
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 for a ``None`` mesh)."""
    return 0 if mesh is None else int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


def check_supported(what: str, mesh_seq: int = 1, mesh_model: int = 1, *, tome=None,
                    quant: Optional[str] = None, training: bool = False) -> None:
    """Raise NotImplementedError, naming ROADMAP A9b, for what a ``seq`` or
    ``model`` axis above 1 does not run yet: training, Token Merging under
    ``seq``, int8 under ``model`` and the int8 conv modes under ``seq``
    (``quant``: an ``ops.quant`` mode or None)."""
    from sonicdiffusionbayeslab_torch.ops.quant import conv_enabled

    seq, model = int(mesh_seq), int(mesh_model)
    refused = []
    if training and (seq > 1 or model > 1):
        refused.append(f"training with mesh_seq={seq}, mesh_model={model}")
    if tome is not None and seq > 1:
        refused.append(f"Token Merging with mesh_seq={seq}")
    if quant and model > 1:
        refused.append(f"int8 ({quant}) with mesh_model={model}")
    if conv_enabled(quant) and seq > 1:
        refused.append(f"int8 convs ({quant}) with mesh_seq={seq}")
    if refused:
        raise NotImplementedError(f"{what}: {'; '.join(refused)} is not ported ({A9B})")


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's contiguous share of an axis of ``count`` ranks: rows
    ``[index * n / count, (index + 1) * n / count)``; ``multiple``: each
    share must also divide by it (the UNet's downsampling, the MMDiT's
    patch)."""

    index: int
    count: int
    axis: str = "data"
    what: str = "batch"
    multiple: int = 1

    def rows(self, n: int) -> slice:
        if n % (self.count * self.multiple):
            extra = f" x {self.multiple}" if self.multiple > 1 else ""
            raise ValueError(f"{self.what} {n} not divisible by {self.axis} axis "
                             f"{self.count}{extra}")
        k = n // self.count
        return slice(self.index * k, (self.index + 1) * k)

    def take(self, x, dim: int = 0):
        """``x``'s rows (a tensor, numpy array or sequence) along ``dim``."""
        if x is None:
            return None
        sl = self.rows(x.shape[dim] if hasattr(x, "shape") else len(x))
        if dim == 0:
            return x[sl]
        return x[(slice(None),) * dim + (sl,)]


def batch_sharding(mesh) -> RowShard:
    """The leading (batch) axis over the mesh's data axis."""
    return RowShard(axis_index(mesh, "data"), axis_size(mesh, "data"))


@dataclasses.dataclass(frozen=True)
class LatentShard:
    """[B, h, w, C] latents: the batch over ``data``, the height over
    ``seq`` (the JAX package's ``P("data", "seq")``)."""

    batch: RowShard
    height: RowShard

    def take(self, x):
        x = self.batch.take(x)
        return x if self.height.count == 1 else self.height.take(x, 1)


def latent_sharding(mesh, multiple: int = 1) -> LatentShard:
    """This rank's share of [B, h, w, C] latents: rows of the batch over
    ``data`` and rows ``[r * h / n, (r + 1) * h / n)`` of the height over
    ``seq``.  ``multiple``: each height share must divide by it as well
    (``2 ** (levels - 1)`` for a UNet, so that every level it downsamples
    to splits alike; the patch size for the MMDiT); a height that does not
    split so raises ValueError."""
    return LatentShard(batch_sharding(mesh),
                       RowShard(axis_index(mesh, "seq"), axis_size(mesh, "seq"), "seq",
                                "latent height", int(multiple)))


def shard_batch(mesh, *arrays):
    """This rank's rows of each array; raises ValueError for a batch the
    data axis does not divide."""
    s = batch_sharding(mesh)
    out = tuple(s.take(a) for a in arrays)
    return out[0] if len(out) == 1 else out


def shard_latents(mesh, latents):
    return latent_sharding(mesh).take(latents)


@dataclasses.dataclass(frozen=True, eq=False)
class ParallelContext:
    """What a placed module needs to run split: the mesh, this rank's
    coordinates on ``seq`` and ``model`` and the sizes of those axes.  A
    module gets it once, from :func:`place_module`."""

    mesh: object
    n_seq: int
    seq_index: int
    n_model: int
    model_index: int

    @classmethod
    def from_mesh(cls, mesh) -> "ParallelContext":
        return cls(mesh, axis_size(mesh, "seq"), axis_index(mesh, "seq"),
                   axis_size(mesh, "model"), axis_index(mesh, "model"))

    @property
    def seq_group(self):
        return axis_group(self.mesh, "seq")

    @property
    def model_group(self):
        return axis_group(self.mesh, "model")


def place_module(module: torch.nn.Module, ctx: ParallelContext) -> Dict[str, Optional[int]]:
    """Give every submodule of ``module`` the context (``par``) and keep, on
    this rank, only its share of each tensor-parallel layer's weights:
    every submodule with a ``tp_shard_`` method (``models/layers.py``,
    ``mmdit.py``, ``t5.py``) cuts its own along the ``model`` axis.
    Returns the execution plan, {parameter name: the dim this rank holds
    a 1/n_model slice of, or None for the whole tensor}.

    It departs from :func:`param_placement` where a local kernel needs it:
    biases and norm scales of column-parallel layers are cut with their
    weights; GEGLU's ``[h ; gate]`` projection gives each rank the same
    rows of both halves; a layer whose heads (or hidden units, or groups)
    the axis does not divide keeps its whole weights and runs unsplit;
    the time embedding, the ControlNet's heads and whatever is not placed
    (the VAE, the CLIP towers) run whole."""
    plan = {name: None for name, _ in module.named_parameters()}
    for prefix, m in module.named_modules():
        m.par = ctx
        if ctx.n_model > 1 and hasattr(m, "tp_shard_"):
            for name, dim in m.tp_shard_(ctx.model_index, ctx.n_model).items():
                plan[f"{prefix}.{name}" if prefix else name] = dim
    return plan


def execution_placements(plan: Dict[str, Optional[int]], mesh) -> Dict[str, tuple]:
    """{parameter: DTensor placements over the mesh's axes} of what each
    rank runs: ``Shard(dim)`` on ``model`` where the plan cuts the
    parameter, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    model_dim = AXES.index("model")
    out = {}
    for name, dim in plan.items():
        p = [Replicate()] * len(AXES)
        if dim is not None:
            p[model_dim] = Shard(dim)
        out[name] = tuple(p)
    return out


# ------------------------------------------------------------------- TP
# The JAX package's _TP_RULES on the port's diffusers names and torch
# layouts: parameter-name regex -> the torch dim split over "model".  A
# JAX dense kernel [in, out] is a torch weight [out, in], so P(None,
# "model") (split out) is dim 0 and P("model", None) (split in) is dim 1; a
# JAX conv kernel [h, w, in, out] is [out, in, h, w], the same dims.
# Biases and norm scales are replicated, as there.
_TP_RULES: Dict[str, int] = {
    # attention projections: split heads (out dim of q/k/v, in dim of out-proj)
    r".*\.(to_q|to_k|to_v|q_proj|k_proj|v_proj)\.weight$": 0,
    r".*\.(to_qkv|to_kv)\.weight$": 0,
    r".*\.(to_out\.0|out_proj)\.weight$": 1,
    # transformer MLP: split hidden
    r".*\.ff\.net\.0\.proj\.weight$": 0,
    r".*\.ff\.net\.2\.weight$": 1,
    # the JAX package's fc1/fc2: CLIP's MLPs and the timestep, text and
    # added-conditioning embeddings' two linears
    r".*\.(fc1|linear_1)\.weight$": 0,
    r".*\.(fc2|linear_2)\.weight$": 1,
    # convs: split output channels (resnet conv1) / input channels (conv2)
    r".*\.conv1\.weight$": 0,
    r".*\.conv2\.weight$": 1,
    # MMDiT joint attention, context stream: heads split as the image stream's
    r".*\.(add_q_proj|add_k_proj|add_v_proj)\.weight$": 0,
    r".*\.to_add_out\.weight$": 1,
    r".*\.ff_context\.net\.0\.proj\.weight$": 0,
    r".*\.ff_context\.net\.2\.weight$": 1,
    # T5 encoder: head-split q/k/v, hidden-split gated-GELU FF
    r".*\.SelfAttention\.(q|k|v)\.weight$": 0,
    r".*\.SelfAttention\.o\.weight$": 1,
    r".*\.DenseReluDense\.(wi_0|wi_1)\.weight$": 0,
    r".*\.DenseReluDense\.wo\.weight$": 1,
}


def param_sharding_rules() -> Dict[str, int]:
    return dict(_TP_RULES)


def param_placement(name: str, shape, n_model: int,
                    rules: Optional[Dict[str, int]] = None) -> Optional[int]:
    """The torch dim of parameter ``name`` split over a ``model`` axis of
    ``n_model`` ranks, or None (replicated): the first matching rule, and
    replicated when ``n_model`` is 1 or the dim does not divide (the JAX
    package's divisibility guard)."""
    if n_model <= 1:
        return None
    rules = _TP_RULES if rules is None else rules
    for pat, dim in rules.items():
        if re.match(pat, name):
            return dim if int(shape[dim]) % n_model == 0 else None
    return None


def shard_params(state_dict: Dict[str, torch.Tensor], mesh,
                 rules: Optional[Dict[str, int]] = None) -> Dict[str, torch.Tensor]:
    """{name: DTensor} placing each tensor of ``state_dict`` on ``mesh`` per
    the rules: ``Shard(dim)`` over "model" where :func:`param_placement`
    gives a dim, replicated on every other axis and tensor.  Every rank
    holds the full weights (one seed or checkpoint), so no data moves: a
    rank keeps its own chunk (``src_data_rank=None``).  With ``n_model``
    1 every placement is replicated, the data-parallel layout."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    n_model = axis_size(mesh, "model")
    model_dim = mesh.mesh_dim_names.index("model")
    out = {}
    for name, t in state_dict.items():
        placements = [Replicate()] * mesh.ndim
        dim = param_placement(name, t.shape, n_model, rules)
        if dim is not None:
            placements[model_dim] = Shard(dim)
        out[name] = distribute_tensor(t.detach(), mesh, placements, src_data_rank=None)
    return out
