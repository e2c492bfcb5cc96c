"""The fp32 attention kernel's arithmetic (``csrc/flash_attention.cu``),
emulated step by step in plain PyTorch on the CPU.

The kernel runs both products on the tensor cores as split TF32: every
operand x becomes ``hi = tf32(x)`` (what ``cvt.rna.tf32.f32`` gives: round
to nearest, ties away from zero, to 10 mantissa bits) and ``lo = x - hi``,
exact in fp32, whose low 13 bits the tensor core ignores (truncation to
TF32).  A product a.b is taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi into
one fp32 accumulator; only a_lo.b_lo, about 2^-22 of it, is dropped.
Around the products it is an online softmax over 64-key tiles in base 2
(log2(e) D^-1/2 folded into one multiply), the last tile's missing keys
masked, each tile's P.V summed in fresh fragments and added to O in fp32.

The accumulation is modelled as the tensor core rounds it: each
``mma.sync.m16n8k8`` adds its 8 products (exact in float64) to the fp32
accumulator and rounds the sum toward zero, three mma a k-step, small terms
first.  This is a model of the rounding, not of the hardware's exact
alignment of the addends: it reproduces the error of one chain of mma over
all of a 4096-key P.V (about 8e-5, which failed the gate on the card at
4096 x 4096), the reason each tile's P.V starts from fresh fragments.

The emulation is held to float64 attention within the fp32 gate of the
kernel checks on the card (|err| <= 2e-5 + 1e-4 |ref|, queries x3), a
single TF32 product is shown to fail that gate (why three products), the
chained P.V is shown to lose far more than fresh fragments at 4096 keys,
and the emulation is held to the JAX package's Pallas kernel in interpret
mode.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonicdiffusionbayeslab_tpu.ops.flash_attention import flash_attention as pallas_attention

ATOL, RTOL = 2e-5, 1e-4  # the fp32 attention gate of chip_smoke.py, unchanged
TILE = 64  # keys a K/V tile


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: add half of the 13 dropped bits to the
    magnitude (the sign bit stays), then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """A TF32 operand as the tensor core reads it: its low 13 bits cleared."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    """(hi, lo) as the products see them."""
    hi = tf32(x)
    return hi, truncate_tf32(x - hi)


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32, rounded toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def mm_tf32x3(a, b, acc=None):
    """a @ b (plus ``acc``) as the kernel's chain of mma.sync.m16n8k8: for
    each k-step of 8, three products, small terms first, each added to the
    fp32 accumulator with the sum rounded toward zero."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    K = a.shape[-1]

    def steps(x, y):  # [..., n, K/8, m]: each k-step's 8 products, summed exactly
        return torch.einsum("...njk,...jkm->...njm", x.double().unflatten(-1, (K // 8, 8)),
                            y.double().unflatten(-2, (K // 8, 8)))

    terms = steps(a_lo, b_hi), steps(a_hi, b_lo), steps(a_hi, b_hi)
    if acc is None:
        acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for j in range(K // 8):
        for t in terms:
            acc = round_toward_zero(acc.double() + t[..., j, :])
    return acc


def mm_tf32(a, b):
    """a @ b as one TF32 product."""
    return tf32(a) @ tf32(b)


def emulate(q, k, v, mm=mm_tf32x3, chain=False):
    """[B, N, H, D] float32 attention as the kernel computes it; with
    ``chain``, P.V runs on in O's accumulator instead of fresh fragments."""
    q, k, v = (x.transpose(1, 2).float() for x in (q, k, v))  # [B, H, L, D]
    B, H, N, D = q.shape
    M = k.shape[2]
    c = torch.tensor(D ** -0.5 * math.log2(math.e), dtype=torch.float32)
    m = torch.full((B, H, N, 1), -math.inf)
    l = torch.zeros(B, H, N, 1)
    o = torch.zeros(B, H, N, D)
    for k0 in range(0, M, TILE):
        rows = min(TILE, M - k0)  # the ragged last tile: missing keys are zero-filled
        kt = torch.zeros(B, H, TILE, D)
        vt = torch.zeros(B, H, TILE, D)
        kt[:, :, :rows], vt[:, :, :rows] = k[:, :, k0:k0 + rows], v[:, :, k0:k0 + rows]
        s = mm(q, kt.transpose(-1, -2)) * c
        s[..., rows:] = -math.inf  # and masked
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))  # finite: key k0 is valid
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = mm(p, vt, o * corr) if chain else o * corr + mm(p, vt)
        m = m_new
    return (o / l).transpose(1, 2)


def inputs(B, N, M, H, D, seed):
    rng = np.random.default_rng(seed)
    mk = lambda L, s=1.0: (rng.standard_normal((B, L, H, D)) * s).astype(np.float32)  # noqa: E731
    return mk(N, 3.0), mk(M), mk(M)


def reference64(q, k, v):
    q, k, v = (torch.from_numpy(x).double() for x in (q, k, v))
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * q.shape[-1] ** -0.5
    return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(logits, -1), v)


def excess(got, want):
    """max(|got - want| - (ATOL + RTOL |want|)): positive where the gate fails."""
    got, want = got.double(), want.double()
    return ((got - want).abs() - (ATOL + RTOL * want.abs())).max().item()


def test_tf32_rounds_to_nearest_ties_away():
    up = 1.0 + 2.0 ** -10  # TF32's next value above 1
    half = 2.0 ** -11  # half its spacing at 1: a tie
    x = torch.tensor([1.0, 1.0 + half, 1.0 + half - 2.0 ** -23, -(1.0 + half), 0.0, -0.0])
    got = tf32(x)
    # The tie 1 + 2^-11 goes away from zero, where ties-to-even would give 1.
    assert got.tolist() == [1.0, up, 1.0, -up, 0.0, -0.0]
    assert torch.signbit(got[-1])
    assert (got.view(torch.int32) & 0x1FFF == 0).all()  # 10 mantissa bits are left
    # hi + lo keeps 21 bits: the split's own error is within 2^-21 relative.
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(10000).astype(np.float32))
    hi, lo = split(r)
    assert ((hi.double() + lo.double() - r.double()).abs() <= 2.0 ** -21 * r.double().abs()).all()


@pytest.mark.parametrize("D", [40, 80, 160])
@pytest.mark.parametrize("M", [77, 200])
def test_split_tf32_meets_the_fp32_gate_and_one_tf32_product_does_not(M, D):
    q, k, v = inputs(1, 96, M, 2, D, seed=D + M)
    want = reference64(q, k, v)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    three = emulate(tq, tk, tv)
    assert torch.isfinite(three).all()
    assert excess(three, want) <= 0, f"split TF32 fails the fp32 gate by {excess(three, want):.2e}"
    one = emulate(tq, tk, tv, mm=mm_tf32)
    assert excess(one, want) > 0, "a single TF32 product would pass the fp32 gate"
    # And by far: its largest error is many times the split form's.
    assert (one.double() - want).abs().max() > 10 * (three.double() - want).abs().max()


def test_fresh_pv_fragments_hold_the_gate_at_4096_keys_where_one_chain_loses_far_more():
    # 4096 keys: one chain over all of P.V is 512 k-steps x 3 mma into O.
    q, k, v = inputs(1, 128, 4096, 1, 40, seed=7)
    want = reference64(q, k, v)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    fresh = emulate(tq, tk, tv)
    gap = excess(fresh, want)
    assert gap <= 0, f"fresh fragments fail the fp32 gate by {gap:.2e}"
    chained = emulate(tq, tk, tv, chain=True)
    err_fresh = (fresh.double() - want).abs().max().item()
    err_chained = (chained.double() - want).abs().max().item()
    # Rounding toward zero 1536 times loses ~1e-4 of O (8.3e-5 on the card).
    assert err_chained > 10 * err_fresh and err_chained > 5e-5, (err_chained, err_fresh)


@pytest.mark.parametrize("D", [40, 80, 160])
@pytest.mark.parametrize("M", [77, 200])
def test_split_tf32_emulation_matches_pallas_kernel(M, D):
    q, k, v = inputs(1, 40, M, 2, D, seed=3 * D + M)
    got = emulate(*map(torch.from_numpy, (q, k, v)))
    want = torch.from_numpy(np.array(pallas_attention(jnp.asarray(q), jnp.asarray(k),
                                                      jnp.asarray(v), interpret=True)))
    # Both are fp32 attention; the gate of the fp32 kernel checks on the card.
    assert excess(got, want) <= 0, f"max abs err {(got - want).abs().max().item():.2e}"
