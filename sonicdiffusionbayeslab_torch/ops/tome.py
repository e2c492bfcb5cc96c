"""Token Merging (ToMe) for Stable Diffusion (Bolya & Hoffman, "Token
Merging for Fast Stable Diffusion", CVPRW 2023).

The port's own version of ``sonicdiffusionbayeslab_tpu/ops/tome.py``, which
is plain XLA there (no Pallas kernel), so stock torch ops compute it here.
Before a transformer block's self-attention, the ``r`` most redundant
tokens of an h x w map are merged into their most similar destination
(bipartite soft matching on cosine similarity); the attention runs over
``N - r`` tokens; its output is unmerged back to N by copying each
destination's row to the sources merged into it.  This is an approximate
method, in DeepCache's family.

The same computation as the JAX function, in a form a CUDA graph can
capture: ``r`` is a Python int, so every shape is static; nothing reads a
value back to the host; the destinations of a randomised partition come in
as a tensor (drawn on the host before the denoising loop,
``utils/rng.py::tome_destinations``).  One destination per sy x sx cell;
similarity on the first ``metric_channels`` channels with the norm in
fp32, scores in fp32; the ``r`` sources with the best scores merge; a
destination becomes ``(x_d + sum of its sources) / (1 + count)`` in x's
dtype (a one-hot batched matmul, deterministic, where a scatter-add would
sum in an arbitrary order on the GPU); unmerge is one gather through a
``[B, N]`` index map.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

__all__ = ["TomeConfig", "bipartite_soft_matching_2d", "dst_index_grid", "shared_matching"]


class TomeConfig:
    """Static ToMe settings; hashable, so a config keys a CUDA graph variant.

    ratio: fraction of the tokens to merge away at an eligible map.
    sx, sy: destination stride (one destination per sx * sy cell).
    max_downsample: act only at UNet levels whose downsample factor is at
      most this (1: only the latent-resolution level).
    rand: a random destination within each cell, drawn anew each step
      (else the cell's top-left token).
    metric_channels: similarity on the first this-many channels (0: all).
    share: one matching per map shape and batch within a UNet call, reused
      by every block at that shape (else one per block).
    """

    __slots__ = ("ratio", "sx", "sy", "max_downsample", "rand", "metric_channels", "share")

    def __init__(self, ratio: float = 0.5, sx: int = 2, sy: int = 2, max_downsample: int = 1,
                 rand: bool = True, metric_channels: int = 64, share: bool = True):
        if not 0.0 < ratio < 1.0:
            raise ValueError(f"tome ratio must be in (0, 1), got {ratio}")
        self.ratio = float(ratio)
        self.sx = int(sx)
        self.sy = int(sy)
        self.max_downsample = int(max_downsample)
        self.rand = bool(rand)
        self.metric_channels = int(metric_channels)
        self.share = bool(share)

    def _key(self):
        return (self.ratio, self.sx, self.sy, self.max_downsample, self.rand,
                self.metric_channels, self.share)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, TomeConfig) and self._key() == other._key()

    def __repr__(self):
        return (f"TomeConfig(ratio={self.ratio}, sx={self.sx}, sy={self.sy}, "
                f"max_downsample={self.max_downsample}, rand={self.rand}, "
                f"metric_channels={self.metric_channels}, share={self.share})")

    def r_for(self, h: int, w: int) -> int:
        """Tokens merged at an h x w map (at most the source count)."""
        n = h * w
        return min(int(n * self.ratio), n - self.n_dst(h, w))

    def n_dst(self, h: int, w: int) -> int:
        """Destinations at an h x w map: one per whole sy x sx cell."""
        return (h // self.sy) * (w // self.sx)


def dst_index_grid(h: int, w: int, sy: int, sx: int,
                   generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """[hc * wc] int64 flat token index of each cell's destination: an
    in-cell offset drawn from ``generator`` per cell (on the generator's
    device), else the top-left corner (made on ``device``, so that a graph
    capture copies nothing from the host)."""
    hc, wc = h // sy, w // sx
    if generator is not None:
        device = generator.device
        oy = torch.randint(0, sy, (hc, wc), generator=generator, device=device)
        ox = torch.randint(0, sx, (hc, wc), generator=generator, device=device)
    else:
        oy = ox = torch.zeros((hc, wc), dtype=torch.int64, device=device)
    yy = torch.arange(hc, device=device)[:, None] * sy + oy
    xx = torch.arange(wc, device=device)[None, :] * sx + ox
    return (yy * w + xx).reshape(-1)


def _tile(a: torch.Tensor, b: int) -> torch.Tensor:
    """Per-row index tensor ``a`` for a batch ``b`` that is a multiple of
    the batch the matching was built at (the same matching in each copy)."""
    if a.shape[0] == b:
        return a
    if b % a.shape[0]:
        raise ValueError(f"tome matching built for batch {a.shape[0]} applied to {b}")
    return a.repeat((b // a.shape[0],) + (1,) * (a.dim() - 1))


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, i], :] for [B, n] indices."""
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


Matching = Tuple[Callable[[torch.Tensor], torch.Tensor], Callable[[torch.Tensor], torch.Tensor]]


def bipartite_soft_matching_2d(metric: torch.Tensor, h: int, w: int, cfg: TomeConfig,
                               dst_idx: Optional[torch.Tensor] = None) -> Matching:
    """(merge, unmerge) for one h x w token map.

    ``metric`` is [B, N, C], the similarity features (the transformer
    block's input), N = h * w; ``dst_idx`` the [n_dst] destination token
    indices (:func:`dst_index_grid`), None for each cell's top-left token.
    For B' any multiple of B:

      merge:   [B', N, C'] -> [B', N - r, C']  (kept sources, then the
               destinations, each the mean of itself and its sources)
      unmerge: [B', N - r, C'] -> [B', N, C']  (a source reads its
               destination's row)
    """
    B, N, _ = metric.shape
    if N != h * w:
        raise ValueError(f"metric tokens {N} != {h}x{w}")
    r = cfg.r_for(h, w)
    if r <= 0:
        return (lambda x: x), (lambda x: x)
    dev = metric.device
    if dst_idx is None:
        dst_idx = dst_index_grid(h, w, cfg.sy, cfg.sx, device=dev)
    dst_idx = dst_idx.to(dev)
    n_dst = dst_idx.shape[0]
    n_src = N - n_dst

    # Sources: the tokens that are no destination, in token order (the
    # destinations sort to the back).
    ar = torch.arange(N, device=dev)
    is_dst = torch.zeros(N, dtype=torch.int64, device=dev).scatter_(0, dst_idx, 1)
    src_idx = torch.argsort(is_dst * N + ar)[:n_src]

    mc = cfg.metric_channels
    if mc and mc < metric.shape[-1]:
        metric = metric[..., :mc]
    mnorm = metric / (torch.linalg.vector_norm(metric.float(), dim=-1, keepdim=True) + 1e-6)
    a = mnorm.index_select(1, src_idx)  # [B, Ns, C] fp32
    b = mnorm.index_select(1, dst_idx)  # [B, Nd, C]
    scores = torch.bmm(a, b.transpose(1, 2))  # [B, Ns, Nd] fp32
    best = scores.argmax(dim=-1)  # [B, Ns] destination slot of each source
    val = scores.gather(-1, best[..., None])[..., 0]

    # The r best-scoring sources merge; ties keep token order.
    order = torch.sort(val, dim=-1, descending=True, stable=True).indices
    merged_slots, kept_slots = order[:, :r], order[:, r:]
    merged_dst = best.gather(1, merged_slots)  # [B, r]
    n_kept = n_src - r
    kept_tok = src_idx[kept_slots]  # [B, n_kept]
    merged_tok = src_idx[merged_slots]  # [B, r]

    # Unmerge: row of each token in [kept | destinations].
    idx_map = torch.zeros((B, N), dtype=torch.int64, device=dev)
    idx_map.scatter_(1, kept_tok, ar[:n_kept].expand(B, -1))
    idx_map.scatter_(1, dst_idx.expand(B, -1), n_kept + ar[:n_dst].expand(B, -1))
    idx_map.scatter_(1, merged_tok, n_kept + merged_dst)

    def merge(x: torch.Tensor) -> torch.Tensor:
        bx = x.shape[0]
        kept = _rows(x, _tile(kept_tok, bx))
        mx = _rows(x, _tile(merged_tok, bx))
        xd = x.index_select(1, dst_idx)  # [B', Nd, C']
        onehot = torch.zeros((bx, r, n_dst), dtype=x.dtype, device=x.device)
        onehot.scatter_(2, _tile(merged_dst, bx)[..., None], 1.0)
        sums = torch.bmm(onehot.transpose(1, 2), mx)  # [B', Nd, C']
        cnts = onehot.sum(dim=1)[..., None]  # [B', Nd, 1]
        xd = (xd + sums) / (1.0 + cnts).to(x.dtype)
        return torch.cat([kept, xd], dim=1)

    def unmerge(x: torch.Tensor) -> torch.Tensor:
        return _rows(x, _tile(idx_map, x.shape[0]))

    return merge, unmerge


def shared_matching(x: torch.Tensor, cfg: TomeConfig, hw, dst_idx: Optional[torch.Tensor],
                    cache: Optional[dict]) -> Matching:
    """:func:`bipartite_soft_matching_2d` of ``x`` on the ``hw`` token map,
    shared through ``cache`` (one dict per model call) when ``cfg.share``:
    a matching of the same map built at a batch that divides x's is reused
    (the first block's, so later blocks' destinations go unused)."""
    share = cfg.share and cache is not None
    if share:
        for (h, w, b), mu in cache.items():
            if (h, w) == tuple(hw) and x.shape[0] % b == 0:
                return mu
    mu = bipartite_soft_matching_2d(x, hw[0], hw[1], cfg, dst_idx)
    if share:
        cache[(hw[0], hw[1], x.shape[0])] = mu
    return mu


def merge_wavg(merge: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``merge(x)``: the paper's ``merge_wavg`` kept for API parity (the
    mean weighting lives in the merge itself), as the JAX package's."""
    return merge(x)
