"""The port's train step against the JAX package's (tiny configs, fp32,
CPU, JAX trees from ``jax.eval_shape``): the LoRA target sets, one LoRA
step's loss, gradient norm and every adapter's gradient, 3-step LoRA
(``configs/train_lora.yaml``'s training section; v-prediction with
min-SNR), full fine-tune and SD3 flow LoRA runs, the peft export, and the
guards.  Both sides get the same weights, the same adapters
(``weights.lora_from_jax``), latents, context, and the JAX step's own
draws of t (or u) and noise from ``split(fold_in(key, step))``.

Tolerances.  One step: loss and gradients within 1e-6 + 1e-4·|ref| (fp32
through the same UNet, summation order apart).  Runs: Adam's first
updates are m̂ / (√v̂ + ε) ≈ sign(g) for |g| ≫ ε, so an entry whose
gradient lies within the two sides' fp32 noise of zero can step the other
way, moving by up to 2·lr(c) at step count c; every other entry agrees to
that noise.  So every entry is within 2·Σ lr(c) over the steps run, and at
most 0.1% of them are more than 0.1·max lr(c) apart, with lr(c) the
schedule's rate (under warmup it starts at 0, so the nominal learning rate
would size the bounds far too loose).  Measured at a constant lr: none of
the adapters; 0.018% of the full UNet's 0.79 M entries, the largest 0.47·lr.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (assert_adam_close, assert_close, randn, step_lrs, t, tiny_engines,
                          tiny_sd3_engines)
from sonicdiffusionbayeslab_torch.config import load_config
from sonicdiffusionbayeslab_torch.models import mmdit as TM
from sonicdiffusionbayeslab_torch.models import weights as W
from sonicdiffusionbayeslab_torch.models.unet import UNet2DCondition, UNetConfig
from sonicdiffusionbayeslab_torch.training import lora as TL
from sonicdiffusionbayeslab_torch.training import loop as TLoop
from sonicdiffusionbayeslab_torch.training import trainer as TT
from sonicdiffusionbayeslab_tpu.models import mmdit as JM
from sonicdiffusionbayeslab_tpu.models import unet as JU
from sonicdiffusionbayeslab_tpu.models import weights as JW
from sonicdiffusionbayeslab_tpu.training import lora as JL
from sonicdiffusionbayeslab_tpu.training import loop as JLoop
from sonicdiffusionbayeslab_tpu.training import trainer as JT

KEY = jax.random.PRNGKey(7)
STEP_TOL = (1e-6, 1e-4)


def np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def jax_draws(step, shape, flow=False, T=1000):
    """The JAX train step's draws at ``step``: (t or u [B], noise)."""
    k_t, k_noise = jax.random.split(jax.random.fold_in(KEY, step))
    noise = np.array(jax.random.normal(k_noise, shape, jnp.float32))
    if flow:
        return np.array(jax.random.normal(k_t, (shape[0],), jnp.float32)), noise
    return np.array(jax.random.randint(k_t, (shape[0],), 0, T)), noise


def port_step(trainer, state, lat, ctx, step, flow=False, **kw):
    first, noise = jax_draws(step, lat.shape, flow)
    draws = {"u": t(first)} if flow else {"timesteps": torch.from_numpy(first)}
    return trainer.train_step(state, t(lat), t(ctx), noise=t(noise), **draws, **kw)


@pytest.fixture(scope="module")
def batch():
    return randn((2, 8, 8, 4), 1), randn((2, 77, 32), 2)


# ------------------------------------------------------------- targets
def _jax_matched(tree, pattern, name_map):
    flat = JL._flat_paths(tree)
    return {name_map[p][0][: -len(".weight")] for p, v in flat.items()
            if re.match(pattern, p) and v.ndim == 2}


@functools.lru_cache(maxsize=None)
def _unet_trees(family):
    cfg = {"tiny": UNetConfig.tiny, "tiny_xl": UNetConfig.tiny_xl,
           "sd15": UNetConfig.sd15}[family]()
    jcfg = getattr(JU.UNetConfig, family)()
    lat = jnp.zeros((1, 8, 8, 4))
    added = ((jnp.zeros((1, cfg.pooled_dim)), jnp.zeros((1, 6)))
             if cfg.pooled_dim else ())
    args = (lat, jnp.zeros((1,)), jnp.zeros((1, 77, cfg.cross_attention_dim)))
    if added:
        args += ({"text_embeds": added[0], "time_ids": added[1]},)
    tree = jax.eval_shape(JU.UNet2DCondition(jcfg).init, KEY, *args)["params"]
    with torch.device("meta"):
        return cfg, tree, UNet2DCondition(cfg)


@pytest.mark.parametrize("family", ["tiny", "tiny_xl", "sd15"])
@pytest.mark.parametrize("which", ["DEFAULT_TARGETS", "ATTN_AND_FF_TARGETS"])
def test_unet_target_sets_match_jax(family, which):
    """The port's regexes over its names match the modules the JAX
    package's match over its paths, mapped through ``unet_name_map``
    (SD-1.5 at full geometry: 128 attention projections)."""
    cfg, tree, unet = _unet_trees(family)
    want = _jax_matched(tree, getattr(JL, which), W.unet_name_map(cfg))
    got = set(TL.lora_targets(unet, getattr(TL, which)))
    assert got == want and got
    if family == "sd15" and which == "DEFAULT_TARGETS":
        assert len(got) == 16 * 2 * 4


@pytest.mark.parametrize("which", ["DEFAULT_TARGETS", "MMDIT_TARGETS"])
def test_mmdit_target_sets_match_jax(which):
    cfg = TM.MMDiTConfig.tiny()
    jcfg = JM.MMDiTConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    tree = jax.eval_shape(JM.MMDiT(jcfg).init, KEY, jnp.zeros((1, 8, 8, 16)), jnp.zeros((1,)),
                          jnp.zeros((1, 7, 40)), {"text_embeds": jnp.zeros((1, 32))})["params"]
    with torch.device("meta"):
        mmdit = TM.MMDiT(cfg)
    want = _jax_matched(tree, getattr(JL, which), W.mmdit_name_map(cfg))
    got = set(TL.lora_targets(mmdit, getattr(TL, which)))
    assert got == want and got
    if which == "MMDIT_TARGETS":  # both streams; the last block has no to_add_out
        assert sum(".add_q_proj" in n for n in got) == cfg.depth
        assert sum(".to_add_out" in n for n in got) == cfg.depth - 1


# ------------------------------------------------------------ one step
def _jax_lora_loss(jeng, params, cfg, lat, ctx, tsteps, noise):
    """The JAX trainer's loss_fn (training/trainer.py) as a function of
    the adapters, for jax.value_and_grad."""
    ac = jnp.asarray(JT.DiffusionTrainer(jeng, cfg).schedule.alphas_cumprod, jnp.float32)
    a = ac[tsteps][:, None, None, None]
    noisy = jnp.sqrt(a) * lat + jnp.sqrt(1.0 - a) * noise
    snr = (ac / (1.0 - ac))[tsteps]
    w = jnp.minimum(snr, cfg.snr_gamma) / snr

    def loss(adapters):
        p = JL.apply_lora(params["unet"], adapters, scale=cfg.lora_scale)
        pred = jeng.unet.apply({"params": p}, noisy, tsteps.astype(jnp.float32), ctx)
        return jnp.mean(w * jnp.mean((pred.astype(jnp.float32) - noise) ** 2, axis=(1, 2, 3)))

    return jax.jit(jax.value_and_grad(loss))


def test_lora_step_loss_and_every_adapter_gradient_match_jax(batch):
    """At fresh adapters (b = 0: every b gets a gradient, every a none)
    and at adapters with a random b (every a gets one): the loss, every
    adapter's gradient and the global norm, within 1e-6 + 1e-4·|ref|."""
    jeng, params, teng = tiny_engines()
    lat, ctx = batch
    cfg_kw = dict(lora_rank=4, snr_gamma=5.0)
    jcfg = JT.TrainConfig(**cfg_kw)
    fresh = np_tree(JL.init_lora(params["unet"], 4, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    perturbed = jax.tree_util.tree_map_with_path(
        lambda p, v: (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
        if p[-1].key == "b" else v, fresh)
    tsteps, noise = jax_draws(0, lat.shape)
    vg = _jax_lora_loss(jeng, params, jcfg, jnp.asarray(lat), jnp.asarray(ctx),
                        jnp.asarray(tsteps), jnp.asarray(noise))
    trainer = TT.DiffusionTrainer(teng, TT.TrainConfig(**cfg_kw))
    for adapters, b_zero in ((fresh, True), (perturbed, False)):
        want_loss, want_grads = vg(jax.tree.map(jnp.asarray, adapters))
        want = {f"{m}/{k}": v for m, ab in W.lora_from_jax(np_tree(want_grads),
                                                            UNetConfig.tiny()).items()
                for k, v in ab.items()}
        state = trainer.init_state(adapters=W.lora_from_jax(adapters, UNetConfig.tiny()))
        loss, grads = trainer.value_and_grad(state, t(lat), t(ctx), noise=t(noise),
                                             timesteps=torch.from_numpy(tsteps))
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
        assert set(grads) == set(want) and len(grads) == 2 * 32  # 4 transformers x 8
        for k, g in grads.items():
            assert_close(g, want[k].numpy(), *STEP_TOL)
            if k.endswith("/b") or not b_zero:
                assert g.abs().max() > 0, k
            else:
                assert torch.all(g == 0), k
        from sonicdiffusionbayeslab_torch.training.optim import global_norm

        np.testing.assert_allclose(float(global_norm(grads)),
                                   float(jax.numpy.sqrt(sum(jnp.sum(g * g) for g in
                                                            jax.tree.leaves(want_grads)))),
                                   rtol=1e-5)


# ---------------------------------------------------------------- runs
def _lora_run(batch, train_section, steps=3):
    """``steps`` steps of both trainers from one ``training`` section; the
    JAX run's and the port's (metrics a step, final states)."""
    jeng, params, teng = tiny_engines()
    lat, ctx = batch
    jtr = JT.DiffusionTrainer(jeng, JLoop.train_config_from_dict(
        {**train_section, "donate": False}))
    js = jtr.init_state(params, key=jax.random.PRNGKey(3))
    ttr = TT.DiffusionTrainer(teng, TLoop.train_config_from_dict(train_section))
    ts = ttr.init_state(adapters=W.lora_from_jax(np_tree(js.trainable), UNetConfig.tiny()))
    out = []
    for s in range(steps):
        js, jm = jtr.train_step(js, params, jnp.asarray(lat), jnp.asarray(ctx), KEY)
        ts, tm = port_step(ttr, ts, lat, ctx, s)
        out.append((float(jm["loss"]), float(tm["loss"]), float(jm["grad_norm"]),
                    float(tm["grad_norm"])))
    return out, (jtr, js), (ttr, ts)


def _compare_adapters(ts_tree, js_tree, lrs):
    want = W.lora_from_jax(np_tree(js_tree), UNetConfig.tiny())
    assert set(ts_tree) == set(want)
    for m, ab in want.items():
        for k in "ab":
            assert_adam_close(ts_tree[m][k].detach(), ab[k], lrs)


def test_train_lora_yaml_section_three_steps_match_jax(batch):
    """``configs/train_lora.yaml``'s training section as shipped (rank 8,
    warmup 100, clip 1, AdamW with decay, min-SNR 5, EMA 0.999): losses
    and grad norms a step, then the adapters and their EMA."""
    section = dict(load_config("configs/train_lora.yaml").training)
    for k in ("num_steps", "batch_size", "log_every", "save_every", "save_dir", "mesh_data",
              "mesh_model"):
        section.pop(k)
    metrics, (_, js), (_, ts) = _lora_run(batch, section)
    for jl, tl, jg, tg in metrics:
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(tg, jg, rtol=1e-5)
    lrs = step_lrs(section["learning_rate"], 3, section["warmup_steps"])
    _compare_adapters(ts.trainable, js.trainable, lrs)
    _compare_adapters(ts.ema, js.ema, lrs)


def test_vpred_min_snr_run_matches_jax_and_every_a_learns_from_step_1(batch):
    section = dict(lora_rank=4, learning_rate=1e-3, prediction_type="v_prediction",
                   snr_gamma=5.0)
    metrics, (_, js), (ttr, ts) = _lora_run(batch, section, steps=2)
    for jl, tl, jg, tg in metrics:
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(tg, jg, rtol=1e-5)
    _compare_adapters(ts.trainable, js.trainable, step_lrs(1e-3, 2))
    # b moved at step 0, so from step 1 on every a has a gradient
    lat, ctx = batch
    _, grads = ttr.value_and_grad(ts, t(lat), t(ctx))
    for k, g in grads.items():
        assert g.abs().max() > 0, k


def test_full_finetune_three_steps_match_jax(batch):
    jeng, params, teng = tiny_engines()
    lat, ctx = batch
    jtr = JT.DiffusionTrainer(jeng, JT.TrainConfig(donate=False))
    js = jtr.init_state(params)
    ttr = TT.DiffusionTrainer(teng, TT.TrainConfig())
    ts = ttr.init_state()
    for s in range(3):
        js, jm = jtr.train_step(js, params, jnp.asarray(lat), jnp.asarray(ctx), KEY)
        ts, tm = port_step(ttr, ts, lat, ctx, s)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    want = W.invert(np_tree(js.trainable), W.unet_name_map(UNetConfig.tiny()))
    assert set(want) == set(ts.trainable)
    got = np.concatenate([ts.trainable[k].detach().numpy().ravel() for k in sorted(want)])
    assert_adam_close(got, np.concatenate([want[k].ravel() for k in sorted(want)]),
                      step_lrs(1e-4, 3))


@pytest.fixture(scope="module")
def sd3():
    return tiny_sd3_engines.__wrapped__()


def test_sd3_flow_lora_covers_both_streams_and_matches_jax(sd3):
    """Rectified flow (logit-normal σ, velocity target, t = σ·1000) over
    MMDIT_TARGETS: losses and grad norms over 2 steps, the adapters after,
    and after step 0 every adapter's b has moved, the context stream's
    add_*_proj / to_add_out included, but the last block's add_q_proj: that
    block (context_pre_only) discards its context queries' output, so
    their gradient is zero on both sides."""
    jeng, params, teng = sd3
    lat, ctx, pooled = randn((2, 8, 8, 16), 5), randn((2, 7, 40), 6), randn((2, 32), 7)
    kw = dict(objective="flow", lora_rank=4, lora_targets=JL.MMDIT_TARGETS, learning_rate=1e-3)
    jtr = JT.DiffusionTrainer(jeng, JT.TrainConfig(donate=False, **kw))
    js = jtr.init_state(params, key=jax.random.PRNGKey(3))
    ttr = TT.DiffusionTrainer(teng, TT.TrainConfig(**{**kw, "lora_targets": TL.MMDIT_TARGETS}))
    ts = ttr.init_state(adapters=W.mmdit_lora_from_jax(np_tree(js.trainable)))
    assert any(".add_k_proj" in m for m in ts.trainable)
    for s in range(2):
        js, jm = jtr.train_step(js, params, jnp.asarray(lat), jnp.asarray(ctx), KEY,
                                added={"text_embeds": jnp.asarray(pooled)})
        ts, tm = port_step(ttr, ts, lat, ctx, s, flow=True, added={"text_embeds": t(pooled)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    want = W.mmdit_lora_from_jax(np_tree(js.trainable))
    for m, ab in want.items():
        for k in "ab":
            assert_adam_close(ts.trainable[m][k].detach(), ab[k], step_lrs(1e-3, 2))
        last_q = m == f"transformer_blocks.{TM.MMDiTConfig.tiny().depth - 1}.attn.add_q_proj"
        assert (ts.trainable[m]["b"].abs().max() > 0) != last_q, m


# ------------------------------------------------------------ export
def test_peft_export_equals_jax_and_fuses_through_merge_lora():
    """The peft state dict of the same adapters: the JAX package's keys
    and arrays exactly; fused by the port's ``merge_lora`` it gives the
    trainer's effective UNet weights."""
    jeng, params, teng = tiny_engines()
    adapters = np_tree(JL.init_lora(params["unet"], 4, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(5)
    adapters = jax.tree_util.tree_map_with_path(
        lambda p, v: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        if p[-1].key == "b" else v, adapters)
    want = JL.lora_to_peft_state_dict(adapters, JW.unet_name_map(jeng.unet_config))
    ported = W.lora_from_jax(adapters, UNetConfig.tiny())
    got = TL.lora_to_peft_state_dict(ported)
    assert set(got) == set(want) and len(got) == 3 * 32
    for k in want:
        assert np.array_equal(got[k], np.asarray(want[k])), k
    merged, names = W.merge_lora(teng.unet.state_dict(),
                                 {k: torch.from_numpy(np.array(v)) for k, v in got.items()})
    assert sorted(names) == sorted(ported)
    trainer = TT.DiffusionTrainer(teng, TT.TrainConfig(lora_rank=4))
    effective = trainer.unet_params(trainer.init_state(adapters=ported))
    for k, v in effective.items():
        assert_close(merged[k], v.numpy(), 1e-6, 1e-6)


# ------------------------------------------------------------ guards
@pytest.mark.parametrize("kw", [
    dict(prediction_type="sample"),
    dict(objective="edm"),
    dict(train_target="textual_inversion"),
    dict(objective="flow", train_target="controlnet"),
    dict(objective="flow", snr_gamma=5.0),
    dict(train_target="lora", lora_rank=0),
    dict(optimizer="sgd"),
])
def test_guards_raise_where_jax_raises(kw):
    jeng, _, teng = tiny_engines()
    with pytest.raises(ValueError) as jerr:
        JT.DiffusionTrainer(jeng, JT.TrainConfig(**kw))
    with pytest.raises(ValueError) as terr:
        TT.DiffusionTrainer(teng, TT.TrainConfig(**kw))
    assert str(terr.value) == str(jerr.value)


def test_controlnet_target_needs_a_hint(batch):
    jeng, params, teng = tiny_engines()
    lat, ctx = batch
    with pytest.raises(ValueError, match="hint"):
        JT.DiffusionTrainer(jeng, JT.TrainConfig(train_target="controlnet")).train_step(
            None, params, lat, ctx, KEY)
    tr = TT.DiffusionTrainer(teng, TT.TrainConfig(train_target="controlnet"))
    with pytest.raises(ValueError, match="hint"):  # before the state is read
        tr.train_step(TT.TrainState(step=0, trainable={}, opt_state=None, ema=None),
                      t(lat), t(ctx))
