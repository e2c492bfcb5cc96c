"""Gradients through the port's attention and GroupNorm(+SiLU) against the
JAX package's reverse-mode rules (CPU).

``FlashAttentionFn`` and ``GroupNormSiLUFn`` run the kernel wrappers'
forwards (on the CPU, the plain versions) with stock backwards: the JAX
package's ``_flash_bwd`` (closed-form VJP in fp32) and ``_gn_bwd``
(``jax.vjp`` of the one-pass ``_gn_silu_ref``).  Here each is held to
``jax.vjp`` of the JAX op with its Pallas forward run in interpret mode,
and the grad-mode routing of ``flash_attention`` (also through
``dot_product_attention``) and ``GroupNorm`` is checked.  The card's gradients against the plain versions are cases of
``test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, randn, t
from sonicdiffusionbayeslab_torch.models import layers as L
from sonicdiffusionbayeslab_torch.ops import attention as attn_ops
from sonicdiffusionbayeslab_torch.ops import flash_attention as fa
from sonicdiffusionbayeslab_torch.ops import groupnorm as gn_ops
from sonicdiffusionbayeslab_tpu.ops.flash_attention import flash_attention as pallas_attention
from sonicdiffusionbayeslab_tpu.ops.groupnorm import group_norm_silu as pallas_group_norm

# |port - jax| <= atol + rtol * |jax|.  fp32: both sides take the same fp32
# einsums and differ in summation order (a few ulp of O(1) values).  bf16:
# both compute in fp32 and round the result to bf16 (spacing 2^-8
# relative), so they differ by at most one bf16 step of the value.
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 8e-3)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jax_vjp(fn, primals, cotangent):
    out, vjp = jax.vjp(fn, *primals)
    return out, vjp(cotangent)


def _as(a, dtype):
    return t(a).to(dtype).requires_grad_(True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,M,H,D", [
    (2, 16, 16, 2, 40),    # self-attention, SD-1.5 level 0's head_dim
    (1, 24, 77, 2, 64),    # ragged M = 77 text tokens, SD-2.x/SDXL/SD3 head_dim
    (1, 8, 77, 1, 80),     # SD-1.5 level 1's head_dim
    (1, 16, 20, 2, 160),   # SD-1.5 levels 2-3's head_dim
])
def test_attention_vjp_matches_jax(dtype, B, N, M, H, D):
    q, k, v = randn((B, N, H, D), 0, 2.0), randn((B, M, H, D), 1), randn((B, M, H, D), 2)
    do = randn((B, N, H, D), 3)
    jd = JNP[dtype]
    want_o, want = _jax_vjp(lambda a, b, c: pallas_attention(a, b, c, interpret=True),
                            [jnp.asarray(x, jd) for x in (q, k, v)], jnp.asarray(do, jd))
    tq, tk, tv = (_as(x, dtype) for x in (q, k, v))
    o = attn_ops.dot_product_attention(tq, tk, tv)
    assert isinstance(o.grad_fn, fa.FlashAttentionFn._backward_cls)
    got = torch.autograd.grad(o, (tq, tk, tv), t(do).to(dtype))
    atol, rtol = TOL[dtype]
    assert_close(o.float(), np.asarray(want_o, np.float32), atol, rtol)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert_close(g.float(), np.asarray(w, np.float32), atol, rtol)


@pytest.mark.parametrize("score_bytes", [
    4 * 16 * 20 * 3,       # 3 (batch, head) pairs a chunk: groups of one row's heads
    4 * 16 * 20 * 8,       # 8 pairs: whole rows, two at a time
])
def test_chunked_attention_vjp_equals_unchunked(score_bytes, monkeypatch):
    """The score budget cuts the work into (batch, head) chunks; each
    pair's gradient is its own, so the result is the unchunked one."""
    B, N, M, H, D = 3, 16, 20, 4, 8
    q, k, v, do = (t(randn(s, i)) for i, s in enumerate(
        [(B, N, H, D), (B, M, H, D), (B, M, H, D), (B, N, H, D)]))
    whole = fa.attention_vjp(q, k, v, do)
    monkeypatch.setattr(fa, "VJP_SCORE_BYTES", score_bytes)
    parts = fa.attention_vjp(q, k, v, do)
    for a, b in zip(parts, whole):
        assert_close(a, b.numpy(), 1e-6, 1e-6)
    # and both are autograd's gradient of the plain version
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    ref = torch.autograd.grad(attn_ops.plain_attention(qr, kr, vr), (qr, kr, vr), do)
    for a, b in zip(whole, ref):
        assert_close(a, b.numpy(), 1e-5, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("silu", [True, False])
def test_group_norm_vjp_matches_jax(dtype, silu):
    x = randn((2, 8, 8, 64), 4, 3.0) + 1.0
    w, b = randn((64,), 5, 0.5) + 1.0, randn((64,), 6, 0.5)
    dy = randn((2, 8, 8, 64), 7)
    jd = JNP[dtype]
    want_y, want = _jax_vjp(
        lambda a, g, c: pallas_group_norm(a, g, c, 32, 1e-5, silu, interpret=True),
        [jnp.asarray(a, jd) for a in (x, w, b)], jnp.asarray(dy, jd))
    tx, tw, tb = (_as(a, dtype) for a in (x, w, b))
    y = gn_ops.group_norm_silu(tx, tw, tb, 32, 1e-5, silu)
    assert isinstance(y.grad_fn, gn_ops.GroupNormSiLUFn._backward_cls)
    got = torch.autograd.grad(y, (tx, tw, tb), t(dy).to(dtype))
    atol, rtol = TOL[dtype]
    assert_close(y.float(), np.asarray(want_y, np.float32), atol, rtol)
    for g, w_ in zip(got, want):
        assert g.dtype == dtype
        assert_close(g.float(), np.asarray(w_, np.float32), atol, rtol)


def test_group_norm_vjp_of_x_alone_and_of_the_affine_alone():
    """A frozen norm (weights without grad) still passes dx, and a norm of
    an input without grad still gives dγ/dβ: each Function input's
    gradient is returned exactly where autograd asks for it."""
    x, w, b = t(randn((1, 4, 4, 32), 8)), t(randn((32,), 9)), t(randn((32,), 10))
    xr = x.clone().requires_grad_(True)
    y = gn_ops.group_norm_silu(xr, w, b)
    (dx,) = torch.autograd.grad(y.sum(), (xr,))
    wr, br = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    dw, db = torch.autograd.grad(gn_ops.group_norm_silu(x, wr, br).sum(), (wr, br))
    xa, wa, ba = (a.clone().requires_grad_(True) for a in (x, w, b))
    ref = torch.autograd.grad(gn_ops.reference_group_norm(xa, wa, ba, 32, 1e-5, True).sum(),
                              (xa, wa, ba))
    for g, r in zip((dx, dw, db), ref):
        assert_close(g, r.numpy(), 0.0)


def test_reference_group_norm_is_one_pass_and_plain_two_pass():
    """The backward's reference keeps JAX's one-pass statistics; the
    forward's plain version keeps its two-pass ones.  On data with a large
    mean the two differ, as the JAX package's reference and default
    GroupNorm do."""
    x = t(randn((1, 4, 4, 32), 11) + 300.0)
    w, b = torch.ones(32), torch.zeros(32)
    one = gn_ops.reference_group_norm(x, w, b, 32, 1e-5, False)
    two = gn_ops.plain_group_norm(x, w, b, 32, 1e-5, False)
    assert (one - two).abs().max() > 1e-4
    from sonicdiffusionbayeslab_tpu.ops.groupnorm import _gn_silu_ref

    want = _gn_silu_ref(jnp.asarray(x.numpy()), jnp.ones(32), jnp.zeros(32), 32, 1e-5, False)
    assert_close(one, np.asarray(want), 1e-5, 1e-5)


def test_grad_mode_routing_and_the_unchanged_no_grad_path():
    q = t(randn((1, 8, 2, 16), 12))
    k, v = t(randn((1, 8, 2, 16), 13)), t(randn((1, 8, 2, 16), 14))
    # no input requires grad, or grad mode off: the plain call, no history
    o = attn_ops.dot_product_attention(q, k, v)
    assert o.grad_fn is None and torch.equal(o, fa.flash_attention(q, k, v))
    qr = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert attn_ops.dot_product_attention(qr, k, v).grad_fn is None
    with torch.inference_mode():
        assert attn_ops.dot_product_attention(qr, k, v).grad_fn is None
    routed = attn_ops.dot_product_attention(qr, k, v)
    assert isinstance(routed.grad_fn, fa.FlashAttentionFn._backward_cls)
    assert isinstance(fa.flash_attention(qr, k, v).grad_fn, fa.FlashAttentionFn._backward_cls)
    assert torch.equal(routed.detach(), o)
    # a masked call is not the kernel's: autograd through the plain version
    mask = torch.ones(1, 1, 8, 8, dtype=torch.bool)
    masked = attn_ops.dot_product_attention(qr, k, v, mask=mask)
    assert not isinstance(masked.grad_fn, fa.FlashAttentionFn._backward_cls)

    gn = L.GroupNorm(32, silu=True)
    x = t(randn((1, 4, 4, 32), 15))
    y = gn(x)  # the module's weights require grad
    assert isinstance(y.grad_fn, gn_ops.GroupNormSiLUFn._backward_cls)
    with torch.no_grad():
        y0 = gn(x)
    assert y0.grad_fn is None and torch.equal(y0, y.detach())
    assert torch.equal(y0, gn_ops.plain_group_norm(x, gn.weight, gn.bias, 32, 1e-5, True))
    gn.requires_grad_(False)
    assert gn(x).grad_fn is None


def test_attention_module_backward_matches_plain_autograd():
    """A transformer Attention block's parameter gradients through the
    Function equal autograd through the plain version (the same math)."""
    attn = L.Attention(32, 2, 16, context_dim=24)
    for p in attn.parameters():
        torch.nn.init.normal_(p, std=0.2)
    x, ctx = t(randn((2, 12, 32), 16)), t(randn((2, 7, 24), 17))
    got = torch.autograd.grad(attn(x, context=ctx).square().sum(), list(attn.parameters()))
    saved = L.dot_product_attention
    L.dot_product_attention = attn_ops.plain_attention
    try:
        want = torch.autograd.grad(attn(x, context=ctx).square().sum(), list(attn.parameters()))
    finally:
        L.dot_product_attention = saved
    for g, w in zip(got, want):
        assert_close(g, w.numpy(), 1e-5, 1e-5)
