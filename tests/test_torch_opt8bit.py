"""The blockwise-int8 AdamW (``training/opt8bit.py``) against the JAX
package's plain-jnp one: the dynamic code tables bit-equal, the
quantization (codes and scales) equal, and the optimizer's steps."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import assert_close, randn
from sonicdiffusionbayeslab_torch.training import opt8bit as T8
from sonicdiffusionbayeslab_torch.training import optim
from sonicdiffusionbayeslab_tpu.training import opt8bit as J8


@pytest.mark.parametrize("signed", [True, False])
def test_code_tables_bit_equal(signed):
    got, want = T8._dynamic_code(signed), J8._dynamic_code(signed)
    assert got.dtype == np.float32 and got.shape == (256,)
    assert np.array_equal(got, want)
    assert np.all(np.diff(got) > 0)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("n", [7, 2048, 5000])  # under, at and over one block
def test_quantize_and_dequantize_equal_jax(signed, n):
    x = randn((n,), n, 0.1)
    if not signed:
        x = np.abs(x)
    x[: min(n, 3)] = 0.0
    codes, scales = T8.quantize(torch.from_numpy(x), signed)
    jcodes, jscales = J8._quantize(jnp.asarray(x), signed)
    assert codes.dtype == torch.uint8
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    assert np.array_equal(scales.numpy(), np.asarray(jscales))
    back = T8.dequantize(codes, scales, signed, (n,))
    want = J8._dequantize(jcodes, jscales, signed, (n,), n)
    assert np.array_equal(back.numpy(), np.asarray(want))
    # nearest code: the round trip is within half a code step of the block
    assert_close(back, x, float(np.abs(x).max()) * 0.05)


def test_all_zero_block_keeps_zero_scale():
    codes, scales = T8.quantize(torch.zeros(3000), True)
    assert torch.all(scales == 0)
    assert torch.all(T8.dequantize(codes, scales, True, (3000,)) == 0)


def test_adamw8bit_steps_match_jax():
    """Four steps over a 2-D, a 1-D and a 4-D leaf, decay on: the
    parameters within 1e-6 + 1e-6·|p|, one int8 code in 10^4 allowed off
    by a code boundary (its entry by at most 1% of the learning rate), and
    the stored codes equal but for those."""
    lr = 1e-2
    shapes = {"w": (64, 48), "b": (33,), "k": (8, 4, 3, 3)}
    p0 = {k: randn(s, i) for i, (k, s) in enumerate(shapes.items())}
    tj = J8.adamw8bit(lr, weight_decay=1e-2)
    tt = T8.adamw8bit(lr, weight_decay=1e-2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = tj.init(jp), tt.init(tp)
    for step in range(4):
        g = {k: randn(s, 50 + 10 * step + i, 0.5) for i, (k, s) in enumerate(shapes.items())}
        ju, js = tj.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = tt.update({k: torch.from_numpy(v.copy()) for k, v in g.items()}, ts, tp)
        optim.apply_updates(tp, tu)
        for k in shapes:
            want, got = np.asarray(jp[k]), tp[k].numpy()
            err = np.abs(got - want)
            off = err > 1e-6 + 1e-6 * np.abs(want)
            assert off.mean() <= 1e-4 and err.max() <= 1e-2 * lr, (k, step, err.max())
    jleaves = js[0].leaves
    for k in shapes:
        for field in ("m_codes", "r_codes"):
            same = np.asarray(getattr(jleaves[k], field)) == ts[0]["leaves"][k][field].numpy()
            assert same.mean() >= 1 - 1e-4
