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

Training runs over ``data`` and ``model`` as the JAX loop does: the
trainable tensors and the optimizer state are whole on every rank, a
split layer's forward takes its slice of them (:class:`SplitParams`), and
the gradients of what the ranks split are summed over ``model``.  What
stays refused is training with ``seq`` above 1, which the JAX loop has
no mode for (:func:`check_supported`).  A split model runs eagerly: its
collectives are not captured in a CUDA graph.

Without a process group :func:`make_mesh` of one rank is ``None``: the
callers' single-device path, as a ``mesh=None`` argument is everywhere.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Dict, Optional

import torch

from sonicdiffusionbayeslab_torch.parallel import distributed

AXES = ("data", "seq", "model")
A9 = ("ROADMAP.md item A9 (tensor and sequence parallel sampling: the UNet, ControlNet, MMDiT "
      "and T5 over model, the latent height over seq)")


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


def check_supported(what: str, mesh_seq: int = 1, *, training: bool = False) -> None:
    """Raise NotImplementedError for training with a ``seq`` axis above 1:
    the JAX package's loop reads only ``mesh_data`` and ``mesh_model``, so
    it has no sequence-parallel training to port."""
    if training and int(mesh_seq) > 1:
        raise NotImplementedError(
            f"{what}: training with mesh_seq={int(mesh_seq)}: the JAX package's training loop "
            "has no seq axis (it reads mesh_data and mesh_model only)")


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

    @functools.cached_property
    def seq_group(self):  # looked up once: the split layers ask on every call
        return axis_group(self.mesh, "seq")

    @functools.cached_property
    def model_group(self):
        return axis_group(self.mesh, "model")


def take_local(t: torch.Tensor, dim: int, index: int, count: int, halves: int = 1) -> torch.Tensor:
    """The ``index``-th of ``count`` slices of ``t`` along ``dim``;
    ``halves`` stacked blocks (GEGLU's ``[h ; gate]``) each cut alike.
    Differentiable in ``t``."""
    if halves == 1:
        return t.chunk(count, dim)[index]
    return torch.cat([c.chunk(count, dim)[index] for c in t.chunk(halves, dim)], dim)


@dataclasses.dataclass(frozen=True, eq=False)
class SplitParams:
    """A placed module's parameters against its whole ones: ``cuts``
    {parameter name: (dim, halves)} of those the rank holds a slice of over
    ``model`` (:func:`place_module`'s ``tp_cuts``), and the rank's share.
    A trainer keeps whole tensors and feeds the module :meth:`local` slices
    of them; what the ranks split has its gradient summed over ``model``."""

    cuts: Dict[str, tuple]
    ctx: ParallelContext

    @classmethod
    def of(cls, module: Optional[torch.nn.Module]) -> Optional["SplitParams"]:
        """The module's split, or None where it runs whole."""
        ctx = getattr(module, "par", None)
        cuts = getattr(module, "tp_cuts", None)
        if ctx is None or ctx.n_model == 1 or not cuts:
            return None
        return cls(dict(cuts), ctx)

    def local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        cut = self.cuts.get(name)
        if cut is None:
            return whole
        return take_local(whole, cut[0], self.ctx.model_index, self.ctx.n_model, cut[1])

    def whole(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's slice (a gather over
        ``model``; no gradient)."""
        cut = self.cuts.get(name)
        if cut is None:
            return local
        dim, halves = cut
        with torch.no_grad():
            parts = distributed.all_gather_seq(local.detach().unsqueeze(0), 0,
                                               self.ctx.model_group).unbind(0)
            blocks = [torch.cat([p.chunk(halves, dim)[h] for p in parts], dim)
                      for h in range(halves)]
        return torch.cat(blocks, dim) if halves > 1 else blocks[0]

    def whole_state(self, module: torch.nn.Module, params_only: bool = True) -> Dict[str, torch.Tensor]:
        """``module``'s parameters (or its state dict), whole."""
        items = module.named_parameters() if params_only else module.state_dict().items()
        return {k: self.whole(k, v) for k, v in items}

    def adapter(self, name: str, ab: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A LoRA adapter ``{"a": [in, r], "b": [r, out]}`` of module
        ``name`` cut to the rank's rows (``b``'s columns) or input columns
        (``a``'s rows) of the module's split weight."""
        cut = self.cuts.get(f"{name}.weight")
        if cut is None:
            return ab
        dim, halves = cut
        i, n = self.ctx.model_index, self.ctx.n_model
        if dim == 0:
            return {"a": ab["a"], "b": take_local(ab["b"], 1, i, n, halves)}
        return {"a": take_local(ab["a"], 0, i, n, halves), "b": ab["b"]}

    def is_split(self, leaf: str) -> bool:
        """Whether a trainable leaf (a parameter name, or a LoRA adapter's
        ``<module>/a`` or ``/b``) feeds split layers, so that each rank's
        gradient of it is a part to be summed over ``model``."""
        if "/" in leaf:
            return f"{leaf.rsplit('/', 1)[0]}.weight" in self.cuts
        return leaf in self.cuts

    def sum_grads_(self, grads: Dict[str, torch.Tensor]) -> None:
        """Sum, in place over ``model``, the gradients of the leaves that
        feed split layers; a replicated leaf's gradient is already whole."""
        distributed.all_sum_([g for k, g in grads.items() if self.is_split(k)],
                             self.ctx.model_group)


def place_module(module: torch.nn.Module, ctx: ParallelContext) -> Dict[str, Optional[int]]:
    """Give every submodule of ``module`` the context (``par``) and keep, on
    this rank, only its share of each tensor-parallel layer's weights:
    every submodule with a ``tp_shard_`` method (``models/layers.py``,
    ``mmdit.py``, ``t5.py``) cuts its own along the ``model`` axis and
    returns {parameter: (dim, halves)} of each cut.
    Returns the execution plan, {parameter name: the dim this rank holds
    a 1/n_model slice of, or None for the whole tensor}.

    It departs from :func:`param_placement` where a local kernel needs it:
    biases and norm scales of column-parallel layers are cut with their
    weights; GEGLU's ``[h ; gate]`` projection gives each rank the same
    rows of both halves; a layer whose heads (or hidden units, or groups)
    the axis does not divide keeps its whole weights and runs unsplit;
    the time embedding, the ControlNet's heads and whatever is not placed
    (the VAE, the CLIP towers) run whole.  The module's ``tp_cuts`` keeps
    {parameter: (dim, halves)} of what it cut (:class:`SplitParams`)."""
    plan = {name: None for name, _ in module.named_parameters()}
    cuts = {}
    for prefix, m in module.named_modules():
        m.par = ctx
        if ctx.n_model > 1 and hasattr(m, "tp_shard_"):
            for name, cut in m.tp_shard_(ctx.model_index, ctx.n_model).items():
                full = f"{prefix}.{name}" if prefix else name
                plan[full] = cut[0]
                cuts[full] = cut
    module.tp_cuts = cuts
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
