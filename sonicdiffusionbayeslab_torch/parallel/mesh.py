"""The device mesh and the placement of batches and parameters on it.

Counterpart of ``sonicdiffusionbayeslab_tpu/parallel/mesh.py``: one mesh
over the axes ("data", "seq", "model") (a
``torch.distributed.device_mesh.DeviceMesh`` of one rank a process).  The
JAX package annotates arrays and lets GSPMD insert the collectives; here a
rank holds its own rows and the code around the model calls the
collectives itself (``parallel/distributed.py``).

* ``data``: batch parallel.  :func:`shard_batch` and :func:`shard_latents`
  give this rank's contiguous rows of a batch, as the JAX package's
  ``P("data")`` sharding puts them.
* ``seq`` and ``model``: sequence and tensor parallel.  The placements are
  ported (:func:`shard_params` follows the JAX package's ``_TP_RULES`` in
  torch layouts); the execution across ranks is not (ROADMAP.md item A9),
  and the pipelines, the training loop and the server raise for either
  axis above 1.

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
A9 = "ROADMAP.md item A9 (tensor and sequence parallel execution across ranks)"


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


def check_data_only(mesh_seq: int = 1, mesh_model: int = 1, what: str = "this entry point"):
    """Raise NotImplementedError for a ``seq`` or ``model`` axis above 1."""
    if int(mesh_seq) > 1 or int(mesh_model) > 1:
        raise NotImplementedError(
            f"{what}: mesh_seq={mesh_seq}, mesh_model={mesh_model}: sequence and tensor "
            f"parallel execution is not ported; only the data axis runs ({A9})")


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's contiguous share of a batch along one mesh axis: rows
    ``[index * B / count, (index + 1) * B / count)``."""

    index: int
    count: int

    def rows(self, batch: int) -> slice:
        if batch % self.count:
            raise ValueError(f"batch {batch} not divisible by data axis {self.count}")
        n = batch // self.count
        return slice(self.index * n, (self.index + 1) * n)

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


def latent_sharding(mesh) -> RowShard:
    """[B, h, w, C] latents: the batch over the data axis (the JAX package
    also splits the height over ``seq``: A9)."""
    check_data_only(axis_size(mesh, "seq"), 1, "latent_sharding")
    return batch_sharding(mesh)


def shard_batch(mesh, *arrays):
    """This rank's rows of each array; raises ValueError for a batch the
    data axis does not divide."""
    s = batch_sharding(mesh)
    out = tuple(s.take(a) for a in arrays)
    return out[0] if len(out) == 1 else out


def shard_latents(mesh, latents):
    return latent_sharding(mesh).take(latents)


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
