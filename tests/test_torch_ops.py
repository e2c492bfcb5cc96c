"""The port's attention and GroupNorm(+SiLU) ops against the JAX package.

On the CPU a wrapper takes its kernel's plain version, so these tests hold
the plain versions to the JAX reference math (``_xla_attention``, the Flax
``GroupNorm``) and to the Pallas kernels run in interpret mode.  The CUDA
kernels against their plain versions are in ``test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, randn, t
from sonicdiffusionbayeslab_torch.ops import attention as attn_ops
from sonicdiffusionbayeslab_torch.ops import groupnorm as gn_ops
from sonicdiffusionbayeslab_tpu.ops.attention import _xla_attention
from sonicdiffusionbayeslab_tpu.ops.flash_attention import flash_attention as pallas_attention
from sonicdiffusionbayeslab_tpu.ops.groupnorm import group_norm_silu as pallas_group_norm

# fp32 on both sides; the two differ only in summation order and exp
# implementation, a few ulp of the O(1) outputs.
ATOL = 2e-5


@pytest.mark.parametrize("B,N,M,H,D", [
    (1, 64, 64, 2, 40),    # SD head_dim 40, N % 8 == 0
    (2, 100, 77, 2, 40),   # ragged N, M = 77 text tokens (cross-attention)
    (1, 33, 45, 1, 80),    # ragged N and M, head_dim 80
])
def test_plain_attention_matches_jax(B, N, M, H, D):
    q, k, v = randn((B, N, H, D), 0), randn((B, M, H, D), 1), randn((B, M, H, D), 2)
    got = attn_ops.dot_product_attention(t(q), t(k), t(v))  # CPU: the plain path
    assert_close(got, _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)), ATOL)
    assert_close(got, pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       interpret=True), ATOL)


def test_plain_attention_causal_mask_matches_jax():
    B, T, H, D = 2, 77, 2, 16
    q, k, v = randn((B, T, H, D), 3), randn((B, T, H, D), 4), randn((B, T, H, D), 5)
    mask = np.tril(np.ones((T, T), bool))[None, None]
    got = attn_ops.dot_product_attention(t(q), t(k), t(v), mask=torch.from_numpy(mask))
    want = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask))
    assert_close(got, want, ATOL)


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("C", [64, 16])  # 16 < 32 groups: gcd(16, 32) = 16 groups
def test_plain_group_norm_matches_jax(C, eps, silu):
    from sonicdiffusionbayeslab_tpu.models.layers import GroupNorm as FlaxGroupNorm

    x = randn((2, 8, 8, C), 8, scale=3.0) + 1.0
    w, b = randn((C,), 9, 0.5) + 1.0, randn((C,), 10, 0.5)
    got = gn_ops.group_norm_silu(t(x), t(w), t(b), 32, eps, silu)
    flax_gn = FlaxGroupNorm(epsilon=eps, silu=silu)
    want = flax_gn.apply({"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}},
                         jnp.asarray(x))
    assert_close(got, want, 1e-5)
    groups = gn_ops.resolve_groups(C, 32)
    assert groups == (32 if C % 32 == 0 else 16)
    want_pallas = pallas_group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups=groups,
                                    eps=eps, silu=silu, block_rows=16, interpret=True)
    # The Pallas kernel's variance is E[x^2] - mean^2 (one more rounding
    # than the two-pass form on inputs of mean ~1, std ~3).
    assert_close(got, want_pallas, 1e-4)
