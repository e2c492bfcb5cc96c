"""Int8 W8A8 in the port (``ops/quant.py`` and the UNet's call sites)
against the JAX package's ``ops/quant.py``, on the CPU: the int8 tensors
and int32 sums bit-equal, the float outputs within 1e-6 |ref|, the
reference's error bounds against fp32, the modes' dispatch and the VAE's
opt-out, the tiny engine under each mode against the JAX engine, the
mode's switch on one pipeline, and configs/turbo_config.yaml through the
port's CLI (tiny models)."""

import csv
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sonicdiffusionbayeslab_torch import cli
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.models import layers as L
from sonicdiffusionbayeslab_torch.models.unet import UNet2DCondition, UNetConfig
from sonicdiffusionbayeslab_torch.ops import quant as Q
from sonicdiffusionbayeslab_tpu import schedulers as JS
from sonicdiffusionbayeslab_tpu.models import layers as JL
from sonicdiffusionbayeslab_tpu.models.tokenizer import HashTokenizer
from sonicdiffusionbayeslab_tpu.ops import quant as JQ
from torch_parity import assert_close, flax_init, load_block, randn, t, tiny_engines

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def jax_mode():
    """Sets the JAX package's process-wide mode; restores None after."""
    yield JQ.set_quant_mode
    JQ.set_quant_mode(None)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# ------------------------------------------------------------- primitives
@pytest.mark.parametrize("shape", [(5, 37), (2, 7, 16), (64, 320)])
def test_int8_dense_bit_equal_to_jax(shape):
    """The int8 operands and the int32 sums bit-equal to the JAX package's
    (``_quantize_rows`` and its int32 ``dot_general``); the output within
    1e-6 |ref|."""
    K = shape[-1]
    x, w, b = randn(shape, 0), randn((K, 11), 1), randn((11,), 2)
    jx_q, js_x = JQ._quantize_rows(jnp.asarray(x))
    jw_q, js_w = JQ._quantize_rows(jnp.asarray(w).T)
    jacc = jax.lax.dot_general(jx_q, jw_q.T, (((x.ndim - 1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    x_q, s_x = Q.quantize_rows(t(x))
    w_q, s_w = Q.quantize_rows(t(w.T))
    acc = Q.int8_matmul(x_q.reshape(-1, K), w_q).reshape(*shape[:-1], -1)
    for got, want in ((x_q, jx_q), (s_x, js_x), (w_q, jw_q), (s_w, js_w), (acc, jacc)):
        assert got.dtype == getattr(torch, str(want.dtype)), (got.dtype, want.dtype)
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    want = np.asarray(JQ.int8_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    out_dtype=jnp.float32))
    got = Q.int8_dense(t(x), t(w.T), t(b))
    assert_close(got, want, 0.0, 1e-6)


@pytest.mark.parametrize("shape,stride,pad", [((2, 6, 5, 7), (1, 1), ((1, 1), (1, 1))),
                                              ((2, 9, 8, 16), (2, 2), ((1, 1), (1, 1))),
                                              ((1, 7, 9, 8), (2, 2), ((0, 1), (0, 1)))])
def test_int8_conv_bit_equal_to_jax(shape, stride, pad):
    """The int32 sums of the conv, by the plain float64 conv and by the
    card's im2col layout (summed here in float64), bit-equal to the JAX
    package's int32 ``conv_general_dilated``; the output within 1e-6 |ref|."""
    C = shape[-1]
    x, w, b = randn(shape, 3), randn((3, 3, C, 9), 4), randn((9,), 5)
    xf = jnp.asarray(x)
    s_x = jnp.maximum(jnp.max(jnp.abs(xf), axis=(1, 2, 3), keepdims=True), 1e-12) / 127.0
    jx_q = jnp.clip(jnp.round(xf / s_x), -127, 127).astype(jnp.int8)
    s_w = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(w)), axis=(0, 1, 2), keepdims=True), 1e-12) / 127.0
    jw_q = jnp.clip(jnp.round(jnp.asarray(w) / s_w), -127, 127).astype(jnp.int8)
    jacc = jax.lax.conv_general_dilated(jx_q, jw_q, stride, pad,
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        preferred_element_type=jnp.int32)
    weight = t(np.transpose(w, (3, 2, 0, 1)))  # OIHW
    x_q, sx = Q.quantize_rows(t(x).reshape(shape[0], -1))
    w_q, sw = Q.quantize_rows(Q.conv_weight_rows(weight))
    np.testing.assert_array_equal(x_q.reshape(shape).numpy(), np.asarray(jx_q))
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(jw_q).reshape(-1, 9).T)
    plain = Q._conv_accumulate(x_q.reshape(shape), w_q, 3, 3, stride, pad)
    cols = Q.im2col(x_q.reshape(shape), 3, 3, stride, pad)
    card_layout = Q.int8_matmul(cols.reshape(-1, cols.shape[-1]), w_q).reshape(plain.shape)
    for got in (plain, card_layout):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jacc))
    want = np.asarray(JQ.int8_conv(xf, jnp.asarray(w), jnp.asarray(b), strides=stride,
                                   padding=pad, out_dtype=jnp.float32))
    got = Q.int8_conv(t(x), weight, t(b), stride=stride, padding=pad)
    assert_close(got, want, 0.0, 1e-6)


@pytest.mark.parametrize("M,K,N", [(5, 37, 11), (16, 24, 8), (17, 40, 13), (33, 2880, 320)])
def test_padded_int_mm_bit_equal_to_int64(M, K, N):
    """``torch._int_mm`` with the zero rows and columns that meet its card
    shape rules (M > 16, K and N multiples of 8), here on the CPU: the
    exact int64 product, and the plain float64 one."""
    g = torch.Generator().manual_seed(M)
    a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8)
    want = a.long() @ w.long().t()
    got = Q.padded_int_mm(a, w)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got.long(), want)
    assert torch.equal(Q.int8_matmul(a, w).long(), want)


def test_int8_error_bounds_vs_fp32():
    """The reference's bounds (tests/test_ops_quant.py): relative RMS error
    under 2% for a 64 x 320 x 1280 dense and a 16 x 16 x 64 3x3 conv."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 320)).astype(np.float32)
    w = (rng.standard_normal((320, 1280)) / np.sqrt(320)).astype(np.float32)
    exact = x @ w
    got = Q.int8_dense(t(x), t(w.T)).numpy()
    assert np.linalg.norm(got - exact) / np.linalg.norm(exact) < 0.02
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 16, 16, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 64, 3, 3)) / np.sqrt(9 * 64)).astype(np.float32)
    exact = F.conv2d(t(x).permute(0, 3, 1, 2), t(w), padding=1).permute(0, 2, 3, 1).numpy()
    got = Q.int8_conv(t(x), t(w)).numpy()
    assert np.linalg.norm(got - exact) / np.linalg.norm(exact) < 0.02


def test_int8_matmul_refuses_other_dtypes_and_devices():
    a = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        Q.int8_matmul(a.float(), a)
    with pytest.raises(ValueError, match="cuda or cpu"):
        Q.int8_matmul(a.to("meta"), a.to("meta"))
    with pytest.raises(ValueError, match="unknown quant mode"):
        Q.check_mode("int4")


# ---------------------------------------------------------------- dispatch
def _count_sites(monkeypatch, module, mode, run):
    """{"dense": n, "conv": n} int8 call sites a ``run()`` of ``module``
    under ``mode`` reaches."""
    seen = {"dense": 0, "conv": 0}
    lin, conv = Q.linear_int8, Q.conv_int8

    def rec_lin(layer, x):
        seen["dense"] += 1
        return lin(layer, x) if x.device.type != "meta" else F.linear(x, layer.weight.flatten(1))

    def rec_conv(c, x, padding):
        seen["conv"] += 1
        return conv(c, x, padding) if x.device.type != "meta" else L.conv_nhwc(c, x)

    monkeypatch.setattr(Q, "linear_int8", rec_lin)
    monkeypatch.setattr(Q, "conv_int8", rec_conv)
    Q.set_quant_mode(module, mode)
    try:
        run()
    finally:
        Q.set_quant_mode(module, None)
    return seen


@pytest.mark.parametrize("mode,want", [(None, (0, 0)), ("int8", (192, 0)),
                                       ("int8_conv", (192, 50)), ("int8_conv_only", (0, 50))])
def test_sd15_unet_int8_call_sites(monkeypatch, mode, want):
    """The SD-1.5 UNet (on the meta device) under each mode: 16
    transformers x 12 projections, and 22 ResnetBlocks x 2 + 3 Downsample
    + 3 Upsample 3x3 convs; conv_in/conv_out, the shortcuts and the time
    projections stay exact."""
    monkeypatch.setattr(L, "group_norm_silu", lambda x, *a: torch.empty_like(x))
    monkeypatch.setattr(L, "dot_product_attention", lambda q, k, v, mask=None: torch.empty_like(q))
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig.sd15())
        args = (torch.empty(2, 8, 8, 4), torch.empty(2), torch.empty(2, 77, 768))
        seen = _count_sites(monkeypatch, unet, mode, lambda: unet(*args))
    assert (seen["dense"], seen["conv"]) == want


def test_resnet_and_resamplers_dispatch_and_vae_opt_out():
    """Under int8_conv a ResnetBlock and the UNet's Downsample/Upsample
    quantize, as the JAX blocks with allow_quant do (within 1e-5); built
    without allow_quant (the VAE's) they are bit-equal to the exact path;
    the quantized outputs differ from it by under 5%."""
    x, temb = randn((1, 8, 8, 16), 6), randn((1, 32), 7)
    blk = JL.ResnetBlock(16)
    params = flax_init(blk, 8, x, temb)
    fill = lambda m, d, s: m.resnet(d, s)  # noqa: E731
    cases = [(L.ResnetBlock(16, 16, 32), L.ResnetBlock(16, 16, 32, allow_quant=False), blk,
              params, fill, (x, temb))]
    for jmod, tq, tx in ((JL.Downsample(16, allow_quant=True), L.Downsample(16, allow_quant=True),
                          L.Downsample(16)),
                         (JL.Upsample(16, allow_quant=True), L.Upsample(16, allow_quant=True),
                          L.Upsample(16))):
        p = flax_init(jmod, 9, x)
        cases.append((tq, tx, jmod, p, lambda m, d, s: m.conv(f"{d}/conv", f"{s}.conv"), (x,)))
    for tq, tx, jmod, p, fill, inputs in cases:
        load_block(tq, p, fill)
        load_block(tx, p, fill)
        JQ.set_quant_mode("int8_conv")
        try:
            want_q = np.asarray(jmod.apply({"params": p}, *map(jnp.asarray, inputs)))
        finally:
            JQ.set_quant_mode(None)
        want = np.asarray(jmod.apply({"params": p}, *map(jnp.asarray, inputs)))
        for m in (tq, tx):
            Q.set_quant_mode(m, "int8_conv")
        with torch.no_grad():
            got_q, got_opt_out = tq(*map(t, inputs)), tx(*map(t, inputs))
            Q.set_quant_mode(tq, None)
            got_exact = tq(*map(t, inputs))
        assert_close(got_q, want_q, 1e-5, 1e-5)
        assert torch.equal(got_opt_out, got_exact)
        assert_close(got_exact, want, 1e-5, 1e-5)
        rel = float((got_q - got_exact).norm() / got_exact.norm())
        assert 0.0 < rel < 0.05, rel


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def prompts():
    tok = HashTokenizer(vocab_size=1000)
    return tok(["a boat", "a cat"]), tok(["", ""])


@pytest.mark.parametrize("mode,bound", [("int8", 0.35), ("int8_conv_only", 0.6)])
def test_tiny_engine_under_mode_tracks_jax(prompts, jax_mode, mode, bound):
    """5-step DPM++ with CFG 7.5 from given latents under each mode, against
    the JAX engine under the same mode and both exact runs.

    Rounding to int8 is discontinuous: an activation within ~1e-4 of a
    rounding boundary (in units of its scale) rounds the other way under the
    ulp-level differences of two fp32 implementations (LayerNorm, conv and
    attention summation orders), and CFG 7.5 amplifies such a flip over the
    steps.  So the quantized runs are held to the JAX engine's by their
    drift from the exact run: the port's drift inside the reference's bound
    and within 10% of the JAX engine's, and the port's run nearer the JAX
    engine's quantized run than that is to its exact one.  The blocks that
    hold every int8 call site are held to 1e-5 in the tests above and
    below."""
    jeng, params, teng = tiny_engines()
    ids, neg = prompts
    lat0 = randn((2, 8, 8, 4), 12)
    kw = dict(latent_hw=(8, 8), guidance_scale=7.5, decode=False)
    jplan = JS.DPMSolverScheduler(solver_order=2).build_plan(5)
    plan = S.DPMSolverScheduler(solver_order=2).build_plan(5)
    jemb, jneg = jeng.encode_prompts(params, ids), jeng.encode_prompts(params, neg)
    runs = {}
    for m in (mode, None):
        jax_mode(m)
        runs[("jax", m)] = np.asarray(jeng.sample(params, jplan, jemb, jneg, jax.random.PRNGKey(3),
                                                  init_latents=jnp.asarray(lat0), **kw).latents)
        jax_mode(None)
        teng.set_quant_mode(m)
        try:
            runs[("port", m)] = teng.sample(plan, teng.encode_prompts(ids),
                                            teng.encode_prompts(neg), init_latents=t(lat0),
                                            **kw).latents.numpy()
        finally:
            teng.set_quant_mode(None)
    rel = lambda a, b: float(np.linalg.norm(runs[a] - runs[b]) / np.linalg.norm(runs[b]))  # noqa: E731
    assert_close(runs[("port", None)], runs[("jax", None)], 1e-3)
    drift, jax_drift = rel(("port", mode), ("port", None)), rel(("jax", mode), ("jax", None))
    assert 0.0 < drift < bound, drift
    assert abs(drift - jax_drift) <= 0.1 * jax_drift, (drift, jax_drift)
    assert rel(("port", mode), ("jax", mode)) < jax_drift


def test_transformer_block_under_int8_matches_jax(jax_mode):
    """A transformer block (self- and cross-attention, GEGLU) and a
    SpatialTransformer (its 1x1-conv proj_in/out) under int8: within 1e-5 of
    the JAX blocks under int8."""
    x, ctx, xs = randn((2, 64, 32), 1), randn((2, 77, 32), 2), randn((2, 8, 8, 32), 5)
    cases = [(JL.TransformerBlock(2, 16), L.TransformerBlock(32, 2, 16, 32), (x, ctx),
              lambda m, d, s: m.transformer_block(d, s)),
             (JL.SpatialTransformer(2, 16), L.SpatialTransformer(32, 2, 16, 32), (xs, ctx),
              lambda m, d, s: m.spatial_transformer(d, s, 1))]
    for jmod, tmod, inputs, fill in cases:
        p = flax_init(jmod, 3, *inputs)
        load_block(tmod, p, fill)
        jax_mode("int8")
        want = np.asarray(jmod.apply({"params": p}, *map(jnp.asarray, inputs)))
        jax_mode(None)
        Q.set_quant_mode(tmod, "int8")
        with torch.no_grad():
            got = tmod(*map(t, inputs))
            Q.set_quant_mode(tmod, None)
            exact = tmod(*map(t, inputs))
        assert_close(got, want, 1e-5, 1e-5)
        assert not torch.equal(got, exact)


def test_switching_the_mode_off_gives_the_exact_bits_back():
    """One tiny pipeline: exact, int8_conv_only, int8, exact again; the
    quantized runs differ and the last is bit-equal to the first."""
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel

    pipe = StableDiffusionModel(tiny=True, dtype="float32", device="cpu")
    run = lambda: pipe(["a red boat"], num_inference_steps=4, seed=5)[0]  # noqa: E731
    first = run()
    for mode in ("int8_conv_only", "int8"):
        pipe.engine.set_quant_mode(mode)
        assert pipe.engine.unet.quant_mode == mode
        assert not np.array_equal(run(), first)
        assert pipe.engine.vae.decoder.mid_block.attentions[0].quant_mode is None
    pipe.engine.set_quant_mode(None)
    np.testing.assert_array_equal(run(), first)


def test_turbo_config_runs_through_the_cli(tmp_path, monkeypatch):
    """configs/turbo_config.yaml (tome 0.5 + int8_conv_only, DPM++) through
    the port's CLI on the tiny model: its table row, PNGs, and the model's
    UNet in the config's mode."""
    from sonicdiffusionbayeslab_torch.experiments import base

    built = []
    setup = base.BaseMethod.setup_model

    def recording_setup(self):
        setup(self)
        built.append(self.model)

    monkeypatch.setattr(base.BaseMethod, "setup_model", recording_setup)
    monkeypatch.chdir(tmp_path)
    overrides = {"model.tiny": True, "model.image_size": 64, "model.dtype": "float32",
                 "dataset.image_size": 64, "dataset.max_count": 2, "inference.batch_size": 2,
                 "dataset.prompts": str(REPO / "data" / "dataset" / "prompts_sample.json"),
                 "experiment_params.num_inference_steps": [3], "logger.run_id": "turbo",
                 "quality_metrics": {"clip_score": {"model_name_or_path": "x"}}}
    metrics = cli.run(str(REPO / "configs" / "turbo_config.yaml"), overrides, device="cpu")
    with open(tmp_path / "outputs" / "turbo" / "tables" / "final.tsv") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    assert len(rows) == 1 and rows[0]["nfe"] == "3" and metrics["exp"] == [rows[0]["exp"]]
    assert "0.5" in rows[0]["exp"] and 0.0 <= float(rows[0]["clip_score"]) <= 100.0
    assert len(list((tmp_path / "outputs").glob(f"*/{rows[0]['exp']}/*.png"))) == 2
    assert [m.engine.unet.quant_mode for m in built] == ["int8_conv_only"]
    assert built[0].engine.vae.encoder.mid_block.attentions[0].quant_mode is None


def test_quantized_weights_follow_weight_changes():
    """The int8 weights a layer keeps are those of its current weights:
    after an in-place write (``load_state_dict``, a LoRA fuse) and after a
    new tensor (``.to``) the conv quantizes the new weights."""
    conv = torch.nn.Conv2d(8, 8, 3, padding=1)
    x = t(randn((1, 6, 6, 8), 8))
    first = Q.conv_int8(conv, x, ((1, 1), (1, 1)))
    assert torch.equal(Q.conv_int8(conv, x, ((1, 1), (1, 1))), first)
    with torch.no_grad():
        conv.load_state_dict({"weight": conv.weight * 2 + 0.1, "bias": conv.bias})
    fresh = torch.nn.Conv2d(8, 8, 3, padding=1)
    fresh.load_state_dict(conv.state_dict())
    assert torch.equal(Q.conv_int8(conv, x, ((1, 1), (1, 1))),
                       Q.conv_int8(fresh, x, ((1, 1), (1, 1))))
    conv = conv.to(torch.float64).to(torch.float32)
    assert torch.equal(Q.conv_int8(conv, x, ((1, 1), (1, 1))),
                       Q.conv_int8(fresh, x, ((1, 1), (1, 1))))
