"""The port's kernel wrappers: dispatch, CPU fallback to the plain
versions, argument checks, and (on a GPU) each hand-written CUDA kernel
against its plain version.

Imports torch and the port only, so it also runs on a GPU machine without
JAX:  python -m pytest tests/test_torch_kernels.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from sonicdiffusionbayeslab_torch.ops import attention as attn_ops
from sonicdiffusionbayeslab_torch.ops import groupnorm as gn_ops
from sonicdiffusionbayeslab_torch.ops.flash_attention import flash_attention


def randn(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def assert_close(got, want, atol, rtol):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), atol=atol, rtol=rtol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the GPU")
    return torch.device("cuda")


def test_attention_dispatch_rule():
    q = torch.zeros(1, 4, 8, 40)
    assert attn_ops.uses_kernel(q)
    assert not attn_ops.uses_kernel(q, mask=torch.ones(1, 1, 4, 4, dtype=torch.bool))
    assert not attn_ops.uses_kernel(torch.zeros(1, 4, 1, 512))  # the VAE's mid attention
    assert not attn_ops.uses_kernel(torch.zeros(1, 4, 2, 36))  # head_dim not a multiple of 8


def test_kernel_wrappers_take_plain_path_on_cpu_and_count_nothing():
    q = randn((1, 16, 2, 8), 6)
    a0, g0 = flash_attention.launches, gn_ops.group_norm_silu.launches
    assert torch.equal(flash_attention(q, q, q), attn_ops.plain_attention(q, q, q))
    x, w, b = randn((1, 4, 4, 32), 7), torch.ones(32), torch.zeros(32)
    assert torch.equal(gn_ops.group_norm_silu(x, w, b), gn_ops.plain_group_norm(x, w, b, 32, 1e-5, True))
    assert (flash_attention.launches, gn_ops.group_norm_silu.launches) == (a0, g0)


def test_kernel_wrappers_refuse_other_devices():
    q = torch.zeros(1, 8, 2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q, q, q)
    x = torch.zeros(1, 4, 4, 32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        gn_ops.group_norm_silu(x, torch.ones(32, device="meta"), torch.zeros(32, device="meta"))


@pytest.mark.parametrize("n_rows,batch", [(64, 2), (4096, 2), (262144, 2), (77, 1), (1, 4)])
def test_groupnorm_chunking_covers_rows(n_rows, batch):
    S, R = gn_ops.chunking(n_rows, batch)
    assert S >= 1 and R >= 1
    assert (S - 1) * R < n_rows <= S * R  # every chunk non-empty, all rows covered


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_attention_kernel_matches_plain(cuda, dtype, atol):
    gen = torch.Generator(device=cuda).manual_seed(0)
    for B, N, M, H, D in [(2, 1000, 1000, 2, 40), (2, 300, 77, 8, 40), (1, 64, 64, 8, 160)]:
        q = torch.randn(B, N, H, D, generator=gen, device=cuda).to(dtype)
        k = torch.randn(B, M, H, D, generator=gen, device=cuda).to(dtype)
        v = torch.randn(B, M, H, D, generator=gen, device=cuda).to(dtype)
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert_close(got, attn_ops.plain_attention(q, k, v), atol, 2e-2)
    qkv = torch.randn(2, 500, 3, 8, 40, generator=gen, device=cuda).to(dtype)
    q, k, v = qkv.unbind(2)  # non-contiguous views of one fused projection
    assert torch.equal(flash_attention(q, k, v),
                       flash_attention(q.contiguous(), k.contiguous(), v.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_group_norm_kernel_matches_plain(cuda, dtype, atol):
    gen = torch.Generator(device=cuda).manual_seed(0)
    for B, H, W, C in [(2, 64, 64, 320), (2, 8, 8, 1280), (1, 128, 128, 128), (2, 8, 8, 16)]:
        x = (torch.randn(B, H, W, C, generator=gen, device=cuda) * 3 + 1).to(dtype)
        w = torch.randn(C, generator=gen, device=cuda).to(dtype)
        b = torch.randn(C, generator=gen, device=cuda).to(dtype)
        for silu in (True, False):
            got = gn_ops.group_norm_silu(x, w, b, 32, 1e-5, silu)
            want = gn_ops.plain_group_norm(x, w, b, gn_ops.resolve_groups(C, 32), 1e-5, silu)
            torch.cuda.synchronize()
            assert_close(got, want, atol, 1e-2)
