"""Each main-path block of the port against its Flax module.

Same random Flax weights (random biases and norm scales too), loaded into
the torch block through the port's name-map entries with ``strict=True``;
same numpy inputs; fp32 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import assert_close, flax_init, load_block, randn, t
from sonicdiffusionbayeslab_torch.models import layers as L
from sonicdiffusionbayeslab_tpu.models import layers as FL

# fp32 on both sides: differences are summation order in the convs and
# matmuls (XLA vs oneDNN/BLAS), a few ulp of O(1) activations, grown a
# little through the norms of the deeper blocks.
ATOL = 5e-5


def _case(name):
    """-> (flax module, flax inputs, torch module, map filler)."""
    x_map = randn((2, 8, 8, 32), 0)
    tokens = randn((2, 16, 32), 1)
    ctx = randn((2, 77, 24), 2)
    if name == "mlp":
        return (FL.TimestepEmbedMLP(64), (randn((3, 32), 3),), L.TimestepEmbedMLP(32, 64),
                lambda m, d, s: (m.dense(f"{d}/fc1", f"{s}.linear_1"),
                                 m.dense(f"{d}/fc2", f"{s}.linear_2")))
    if name == "groupnorm_silu":
        return (FL.GroupNorm(silu=True), (x_map,), L.GroupNorm(32, silu=True),
                lambda m, d, s: m.norm(d, s))
    if name == "resnet_temb_shortcut":  # UNet resnet, 32 -> 64 channels
        return (FL.ResnetBlock(64), (x_map, randn((2, 128), 4)), L.ResnetBlock(32, 64, 128),
                lambda m, d, s: m.resnet(d, s))
    if name == "resnet_vae_gcd":  # VAE resnet, eps 1e-6, 16 channels -> gcd(16, 32) groups
        return (FL.ResnetBlock(16, norm_epsilon=1e-6), (randn((2, 8, 8, 16), 5),),
                L.ResnetBlock(16, 16, eps=1e-6), lambda m, d, s: m.resnet(d, s))
    if name == "self_attention":
        return (FL.Attention(2, 16), (tokens,), L.Attention(32, 2, 16),
                lambda m, d, s: m.attention(d, s))
    if name == "cross_attention":
        return (FL.Attention(2, 16), (tokens, ctx), L.Attention(32, 2, 16, context_dim=24),
                lambda m, d, s: m.attention(d, s))
    if name == "geglu":
        return (FL.GEGLUFeedForward(32), (tokens,), L.GEGLUFeedForward(32),
                lambda m, d, s: (m.dense(f"{d}/proj_in", f"{s}.net.0.proj"),
                                 m.dense(f"{d}/proj_out", f"{s}.net.2")))
    if name == "transformer_block":
        return (FL.TransformerBlock(2, 16), (tokens, ctx), L.TransformerBlock(32, 2, 16, 24),
                lambda m, d, s: m.transformer_block(d, s))
    if name == "spatial_transformer":
        return (FL.SpatialTransformer(2, 16, depth=2), (x_map, ctx),
                L.SpatialTransformer(32, 2, 16, 24, depth=2),
                lambda m, d, s: m.spatial_transformer(d, s, 2))
    if name == "downsample":
        return (FL.Downsample(32), (x_map,), L.Downsample(32),
                lambda m, d, s: m.conv(f"{d}/conv", f"{s}.conv"))
    if name == "upsample":
        return (FL.Upsample(32), (x_map,), L.Upsample(32),
                lambda m, d, s: m.conv(f"{d}/conv", f"{s}.conv"))
    if name == "attn_block2d":  # the VAE mid attention: one head of width C
        return (FL.AttnBlock2D(), (randn((2, 4, 4, 32), 6),), L.AttnBlock2D(32),
                lambda m, d, s: m.attn_block2d(d, s))
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "mlp", "groupnorm_silu", "resnet_temb_shortcut", "resnet_vae_gcd", "self_attention",
    "cross_attention", "geglu", "transformer_block", "spatial_transformer", "downsample",
    "upsample", "attn_block2d",
])
def test_block_matches_flax(name):
    flax_mod, inputs, torch_mod, fill = _case(name)
    params = flax_init(flax_mod, 0, *inputs)
    want = flax_mod.apply({"params": params}, *map(jnp.asarray, inputs))
    load_block(torch_mod, params, fill)
    got = torch_mod(*map(t, inputs))
    assert got.shape == tuple(want.shape)
    assert_close(got, want, ATOL)


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding_matches_jax(dim):
    ts = np.array([1.0, 261.0, 999.0], np.float32)
    # sin/cos of arguments up to ~1e3 rad: both sides round the fp32
    # argument identically, the libm results differ by an ulp or two.
    want = FL.timestep_embedding(jnp.asarray(ts), dim)
    assert_close(L.timestep_embedding(t(ts), dim), want, 1e-5)
