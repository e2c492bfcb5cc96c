"""The port's LCM distillation against the JAX package's (tiny configs,
fp32, CPU, JAX trees from ``jax.eval_shape``): the grid and boundary
scalings against the port's LCM plan, one LoRA step's loss and every
adapter's gradient, 3-step LCM-LoRA and w-conditioned full runs, the
frozen teacher, the distilled student's LCM sample, ``mode: distill``
through both loops, and the guards.  Both sides start from one state
(``weights.trainable_from_jax``) and take the JAX step's draws (grid
index, noise, w from ``split(fold_in(key, step), 3)``).

Tolerances, as ``test_torch_training.py``'s: one step 1e-6 + 1e-4·|ref|
(fp32 through the same three UNet calls, summation order apart); runs
within Adam's sign-flip bound (``torch_parity.assert_adam_close``), losses
and grad norms a step within 1e-5 relative; the LCM samples 1e-3, as the
engines' tests."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (assert_adam_close, assert_close, fast_flax_init, jax_step_noise, randn,
                          step_lrs, t, tiny_engines)
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.config import ConfigNode, validate_config
from sonicdiffusionbayeslab_torch.data.imageio import write_png
from sonicdiffusionbayeslab_torch.models import weights as W
from sonicdiffusionbayeslab_torch.models.clip_text import CLIPTextConfig
from sonicdiffusionbayeslab_torch.models.sampler import StableDiffusionEngine
from sonicdiffusionbayeslab_torch.models.unet import UNetConfig
from sonicdiffusionbayeslab_torch.models.vae import VAEConfig
from sonicdiffusionbayeslab_torch.schedulers.lcm import boundary_scalings, lcm_rows, lcm_timesteps
from sonicdiffusionbayeslab_torch.schedulers.schedule import NoiseSchedule, ScheduleConfig
from sonicdiffusionbayeslab_torch.training import distillation as TD
from sonicdiffusionbayeslab_torch.training import loop as TLoop
from sonicdiffusionbayeslab_torch.training.trainer import leaves
from sonicdiffusionbayeslab_tpu import schedulers as JS
from sonicdiffusionbayeslab_tpu.models.sampler import guidance_scale_embedding as jax_embedding
from sonicdiffusionbayeslab_tpu.training import distillation as JD
from sonicdiffusionbayeslab_tpu.training import lora as JL

KEY = jax.random.PRNGKey(11)
STEP_TOL = (1e-6, 1e-4)
N = 10  # grid nodes (original_inference_steps) of the tiny runs
LORA = dict(lora_rank=4, original_inference_steps=N, learning_rate=1e-3)
WCOND = dict(lora_rank=0, original_inference_steps=N, learning_rate=1e-4, w_min=2.0,
             w_max=10.0, student_time_cond_proj_dim=8)


def np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def jax_draws(step, batch, shape, w_range=None):
    """The JAX distill step's draws at ``step``: (grid index [B], noise, w [B]
    or None)."""
    k_i, k_n, k_w = jax.random.split(jax.random.fold_in(KEY, step), 3)
    idx = np.array(jax.random.randint(k_i, (batch,), 0, N))
    noise = np.array(jax.random.normal(k_n, shape, jnp.float32))
    w = (np.array(jax.random.uniform(k_w, (batch,), jnp.float32, *w_range))
         if w_range else None)
    return idx, noise, w


@pytest.fixture(scope="module")
def batch():
    return randn((2, 8, 8, 4), 1), randn((2, 77, 32), 2), randn((2, 77, 32), 3, 0.1)


@pytest.fixture(scope="module")
def jax_lora():
    """The JAX LCM-LoRA distiller (its jitted step shared by the tests) and
    its initial state."""
    jeng, params, _ = tiny_engines()
    jdist = JD.LCMDistiller(jeng, JD.LCMDistillConfig(donate=False, **LORA))
    return jdist, jdist.init_state(params, key=jax.random.PRNGKey(3))


# --------------------------------------------------------- grid, scalings
def test_grid_and_scalings_are_the_lcm_plans():
    """The grid is the LCM plan's node set and its boundary scalings are
    the plan's (bit-equal: both from ``boundary_scalings``); both as the
    JAX distiller's (its scalings in fp32, to 1e-6 relative)."""
    jeng, _, teng = tiny_engines()
    for n in (10, 50):
        dist = TD.LCMDistiller(teng, TD.LCMDistillConfig(original_inference_steps=n))
        jdist = JD.LCMDistiller(jeng, JD.LCMDistillConfig(original_inference_steps=n))
        assert np.array_equal(dist.grid, jdist.grid)
        for steps in range(1, n + 1):
            assert set(lcm_timesteps(steps, 1000, n)) <= set(dist.grid)
        ts = torch.as_tensor(dist.grid)
        c_skip, c_out = dist._scalings(ts)
        want = boundary_scalings(dist.grid)
        assert np.array_equal(c_skip.flatten().numpy(), np.float32(want[0]))
        assert np.array_equal(c_out.flatten().numpy(), np.float32(want[1]))
        j_skip, j_out = jdist._scalings(jnp.asarray(dist.grid))
        assert_close(c_skip, j_skip, 0.0, 1e-6)
        assert_close(c_out, j_out, 0.0, 1e-6)
    # The plan's last row (no noise after it) applies c_skip and c_out as they are.
    sched = NoiseSchedule.create(ScheduleConfig())
    for steps in (1, 4):
        last = lcm_rows(sched, steps, original_inference_steps=N)[-1]
        skip, out = boundary_scalings(last.timestep)
        assert (last.w_sample, last.w_hist[0]) == (float(skip), float(out))
    # The clean boundary: f(z, 0) = z.
    c_skip, c_out = dist._scalings(torch.tensor([0]))
    assert float(c_skip) == 1.0 and float(c_out) == 0.0


# ------------------------------------------------------------ one step
def _jax_loss(jdist, params, lat, ctx, unc, idx, noise, w):
    """The JAX distill step's loss (training/distillation.py) as a function
    of the trainable tree, its EMA target held at ``ema``."""
    cfg, unet = jdist.config, jdist.engine.unet
    student = jdist.student_unet if jdist.w_conditioned else unet
    ac = jnp.asarray(jdist.schedule.alphas_cumprod, jnp.float32)
    t_ = jnp.asarray(jdist.grid, jnp.int32)[idx]
    s_ = t_ - jdist.k

    def alpha_sigma(tt):
        a2 = jnp.where(tt >= 0, ac[jnp.maximum(tt, 0)], 1.0)
        return jnp.sqrt(a2)[:, None, None, None], jnp.sqrt(1.0 - a2)[:, None, None, None]

    a_t, s_t = alpha_sigma(t_)
    z_t = a_t * lat + s_t * noise
    eps2 = unet.apply({"params": params["unet"]}, jnp.concatenate([z_t, z_t]),
                      jnp.concatenate([t_, t_]).astype(jnp.float32),
                      jnp.concatenate([unc, ctx]))
    eps_u, eps_c = jnp.split(eps2, 2)
    eps_w = eps_c + w[:, None, None, None] * (eps_c - eps_u)
    x0_t = (z_t - s_t * eps_w) / a_t
    a_s, s_s = alpha_sigma(s_)
    z_s = a_s * x0_t + s_s * eps_w
    kw = ({"timestep_cond": jax_embedding(w, cfg.student_time_cond_proj_dim)}
          if jdist.w_conditioned else {})

    def params_of(tree):
        return JL.apply_lora(params["unet"], tree) if cfg.lora_rank else tree

    def f(tree, z, tt, aa, ss):
        c_skip, c_out = jdist._scalings(tt)
        eps = student.apply({"params": params_of(tree)}, z, tt.astype(jnp.float32), ctx, **kw)
        return c_skip * z + c_out * (z - ss * eps) / aa

    def loss(trainable, ema):
        s0 = jnp.maximum(s_, 0)
        f_tgt = jax.lax.stop_gradient(jnp.where((s_ < 0)[:, None, None, None], x0_t,
                                                f(ema, z_s, s0, a_s, s_s)))
        d2 = (f(trainable, z_t, t_, a_t, s_t) - f_tgt) ** 2
        return jnp.mean(jnp.sqrt(d2 + cfg.huber_c ** 2) - cfg.huber_c)

    return jax.jit(jax.value_and_grad(loss))


def test_lora_step_loss_and_every_adapter_gradient_match_jax(batch, jax_lora):
    """At adapters with a random b (every a and b has a gradient), the
    first row at the clean boundary (grid index 0: the target is x0 of the
    teacher's step): the loss, every adapter's gradient and the norm."""
    _, params, teng = tiny_engines()
    lat, ctx, unc = batch
    jdist, js0 = jax_lora
    adapters = np_tree(js0.trainable)
    rng = np.random.default_rng(4)
    adapters = jax.tree_util.tree_map_with_path(
        lambda p, v: (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
        if p[-1].key == "b" else v, adapters)
    idx, noise = np.array([0, 6]), randn(lat.shape, 5)
    w = np.full((2,), 7.5, np.float32)
    vg = _jax_loss(jdist, params, jnp.asarray(lat), jnp.asarray(ctx), jnp.asarray(unc),
                   jnp.asarray(idx), jnp.asarray(noise), jnp.asarray(w))
    tree = jax.tree.map(jnp.asarray, adapters)
    want_loss, want_grads = vg(tree, tree)
    want = leaves(W.trainable_from_jax(np_tree(want_grads), UNetConfig.tiny()))
    dist = TD.LCMDistiller(teng, TD.LCMDistillConfig(**LORA))
    state = dist.init_state(trainable=W.trainable_from_jax(adapters, UNetConfig.tiny()))
    loss, grads = dist.value_and_grad(state, t(lat), t(ctx), t(unc), idx=torch.from_numpy(idx),
                                      noise=t(noise))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    assert set(grads) == set(want) and len(grads) == 2 * 32
    for k, g in grads.items():
        assert_close(g, want[k].numpy(), *STEP_TOL)
        assert g.abs().max() > 0, k
    np.testing.assert_allclose(float(TD.optim.global_norm(grads)), float(jnp.sqrt(sum(
        jnp.sum(g * g) for g in jax.tree.leaves(want_grads)))), rtol=1e-5)


# ---------------------------------------------------------------- runs
def _runs(batch, kw, jax_side=None, steps=3):
    """``steps`` steps of both distillers from one state (``jax_side``: the
    JAX distiller and its state, else made from ``kw``): the metrics a
    step, (JAX distiller, state), (port distiller, state)."""
    jeng, params, teng = tiny_engines()
    lat, ctx, unc = batch
    if jax_side is None:
        jdist = JD.LCMDistiller(jeng, JD.LCMDistillConfig(donate=False, **kw))
        jax_side = jdist, jdist.init_state(params, key=jax.random.PRNGKey(3))
    jdist, js = jax_side
    dist = TD.LCMDistiller(teng, TD.LCMDistillConfig(**kw))
    ts = dist.init_state(trainable=W.trainable_from_jax(np_tree(js.trainable), UNetConfig.tiny()))
    teacher = {k: v.clone() for k, v in teng.unet.state_dict().items()}
    w_range = (kw["w_min"], kw["w_max"]) if "w_min" in kw else None
    out = []
    for s in range(steps):
        js, jm_ = jdist.distill_step(js, params, jnp.asarray(lat), jnp.asarray(ctx),
                                     jnp.asarray(unc), KEY)
        idx, noise, w = jax_draws(s, 2, lat.shape, w_range)
        ts, tm = dist.distill_step(ts, t(lat), t(ctx), t(unc), idx=torch.from_numpy(idx),
                                   noise=t(noise), w=None if w is None else t(w))
        out.append((float(jm_["loss"]), float(tm["loss"]), float(jm_["grad_norm"]),
                    float(tm["grad_norm"])))
    assert all(torch.equal(v, teacher[k]) for k, v in teng.unet.state_dict().items())
    assert not any(p.requires_grad for p in teng.unet.parameters())
    return out, (jdist, js), (dist, ts)


def _assert_runs_close(metrics, js_tree, ts_tree, lr, steps=3):
    for jl, tl, jg, tg in metrics:
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(tg, jg, rtol=1e-5)
    want = leaves(W.trainable_from_jax(np_tree(js_tree), UNetConfig.tiny()))
    got = leaves(ts_tree)
    assert set(got) == set(want)
    if "conv_in.weight" in want:  # a full tree: its entries as one, as the full fine-tune test
        assert_adam_close(torch.cat([got[k].detach().flatten() for k in sorted(want)]),
                          torch.cat([want[k].flatten() for k in sorted(want)]),
                          step_lrs(lr, steps))
        return
    for k, v in want.items():
        assert_adam_close(got[k].detach(), v, step_lrs(lr, steps))


@pytest.fixture(scope="module")
def lora_runs(batch, jax_lora):
    return _runs(batch, LORA, jax_lora)


def test_lcm_lora_three_steps_match_jax_and_the_teacher_stays(lora_runs):
    metrics, (_, js), (_, ts) = lora_runs
    _assert_runs_close(metrics, js.trainable, ts.trainable, LORA["learning_rate"])
    _assert_runs_close(metrics, js.ema, ts.ema, LORA["learning_rate"])
    assert ts.step == 3


def test_wcond_full_student_three_steps_match_jax(batch):
    """The w-conditioned full student: w drawn in [2, 10] and embedded;
    its zero cond_proj has a gradient from step 0 and moves."""
    metrics, (_, js), (dist, ts) = _runs(batch, WCOND)
    _assert_runs_close(metrics, js.trainable, ts.trainable, WCOND["learning_rate"])
    cp = ts.trainable["time_embedding.cond_proj.weight"]
    assert cp.shape == (32, 8) and cp.abs().max() > 0
    sd = dist.student_unet_params(ts)
    assert set(sd) == set(ts.trainable) and all(v.dtype == torch.float32 for v in sd.values())


def test_the_distilled_lora_student_samples_as_jax(lora_runs):
    """The EMA student's weights (LoRA fused into the teacher's) through 4
    LCM steps without CFG, the JAX engine's noise passed in."""
    _, (jdist, js), (dist, ts) = lora_runs
    jeng, params, _ = tiny_engines()
    p2 = dict(params, unet=jdist.student_unet_params(js, params))
    lat0, idx, key = randn((1, 8, 8, 4), 7), [0], jax.random.PRNGKey(0)
    ctx = randn((1, 77, 32), 8)
    want = jeng.sample(p2, JS.LCMScheduler(original_inference_steps=N).build_plan(4),
                       jnp.asarray(ctx), None, key, guidance_scale=0.0, latent_hw=(8, 8),
                       init_latents=jnp.asarray(lat0))
    eng = StableDiffusionEngine(UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
                                dtype=torch.float32, device="cpu")
    eng.load_state_dicts(W.state_dicts_from_jax(params))
    eng.unet.load_state_dict(dist.student_unet_params(ts), strict=True)
    got = eng.sample(S.LCMScheduler(original_inference_steps=N).build_plan(4), t(ctx), None,
                     guidance_scale=0.0, latent_hw=(8, 8), init_latents=t(lat0),
                     step_noise=t(jax_step_noise(key, idx, 4, (8, 8, 4))))
    assert want.nfe == got.nfe == 4
    assert_close(got.latents, want.latents, 1e-3)
    assert_close(got.images, want.images, 1e-3)


# ---------------------------------------------------------------- loop
def _dataset(root, n=4, size=16):
    img_dir = root / "imgs"
    rng = np.random.default_rng(0)
    ann = {}
    for i in range(n):
        name = f"im_{i}.png"
        write_png(img_dir / name, rng.integers(0, 255, (size, size, 3), dtype=np.uint8))
        ann[name] = f"synthetic image {i}"
    (root / "prompts.json").write_text(json.dumps(ann))
    return img_dir, root / "prompts.json"


def _raw(root, training, model="stable_diffusion_model", size=16):
    img_dir, ann = _dataset(root, size=size)
    return {"experiment_name": "t", "experiment": {"seed": 29},
            "model": {"model_name": model, "pretrained_model": "x", "tiny": True,
                      "image_size": size, "dtype": "float32"},
            "dataset": {"img_dataset": str(img_dir), "prompts": str(ann), "image_size": size},
            "training": {"mode": "distill", "num_steps": 3, "batch_size": 2, "log_every": 1,
                         "original_inference_steps": N, "prefetch": 0, **training}}


def test_distill_mode_through_both_loops(tmp_path, monkeypatch):
    """``training.mode: distill`` (LCM-LoRA rank 2) through the JAX loop and
    the port's on 4 PNGs: finite losses and lora_peft.npz with the same
    keys; a full student's export loads strictly into the UNet."""
    import yaml

    from sonicdiffusionbayeslab_tpu.config import load_config as jax_load_config
    from sonicdiffusionbayeslab_tpu.training.loop import run_training as jax_run_training

    fast_flax_init(monkeypatch)
    npz = {}
    for side in ("jax", "torch"):
        raw = _raw(tmp_path / side, {"learning_rate": 1e-3, "lora_rank": 2,
                                     "save_dir": str(tmp_path / side / "out")})
        if side == "jax":
            (tmp_path / "train.yaml").write_text(yaml.safe_dump(raw))
            out = jax_run_training(jax_load_config(str(tmp_path / "train.yaml")))
        else:
            raw["model"]["device"] = "cpu"
            out = TLoop.run_training(validate_config(ConfigNode(raw)))
            assert isinstance(out["trainer"], TD.LCMDistiller) and out["steps_per_sec"] > 0
        assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
        npz[side] = np.load(tmp_path / side / "out" / "final" / "lora_peft.npz")
    assert set(npz["torch"].files) == set(npz["jax"].files) and len(npz["jax"].files) == 3 * 32
    full = TLoop.run_training(validate_config(ConfigNode(
        {**_raw(tmp_path / "full", {"lora_rank": 0, "num_steps": 2,
                                    "save_dir": str(tmp_path / "full" / "out")}),
         "model": {"model_name": "stable_diffusion_model", "pretrained_model": "x", "tiny": True,
                   "dtype": "float32", "device": "cpu"}})))
    sd = torch.load(tmp_path / "full" / "out" / "final" / "unet" / "diffusion_pytorch_model.bin")
    full["engine"].unet.load_state_dict(sd, strict=True)


# ------------------------------------------------------------ guards
@pytest.mark.parametrize("kw,schedule", [
    (dict(), dict(prediction_type="v_prediction")),
    (dict(original_inference_steps=7), dict()),
    (dict(lora_rank=0, w_min=2.0, w_max=8.0), dict()),
    (dict(lora_rank=4, student_time_cond_proj_dim=8), dict()),
    (dict(lora_rank=0, w_min=2.0, student_time_cond_proj_dim=8), dict()),
])
def test_guards_raise_where_jax_raises(kw, schedule):
    jeng, _, teng = tiny_engines()
    sched = dataclasses.replace(ScheduleConfig(), **schedule)
    from sonicdiffusionbayeslab_tpu.schedulers.schedule import ScheduleConfig as JSC

    with pytest.raises(ValueError) as jerr:
        JD.LCMDistiller(jeng, JD.LCMDistillConfig(**kw), dataclasses.replace(JSC(), **schedule))
    with pytest.raises(ValueError) as terr:
        TD.LCMDistiller(teng, TD.LCMDistillConfig(**kw), sched)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("model,words", [
    ("stable_diffusion_3_model", "MMDiT family trains with objective: flow"),
    ("stable_diffusion_xl_model", "SD-1.5/2.x UNet family")])
def test_distill_mode_refuses_sd3_and_sdxl_as_jax(tmp_path, model, words):
    import inspect

    from sonicdiffusionbayeslab_tpu.training import loop as JLoop

    raw = _raw(tmp_path, {}, model=model)
    raw["model"]["device"] = "cpu"
    with pytest.raises(ValueError, match=words) as err:
        TLoop.run_training(validate_config(ConfigNode(raw)))
    assert str(err.value).replace(" ", "") in inspect.getsource(JLoop).replace('"', "").replace(
        "\n", "").replace(" ", "")


def test_fields_and_defaults_are_jax_s():
    want = {f.name: f.default for f in dataclasses.fields(JD.LCMDistillConfig)}
    got = {f.name: f.default for f in dataclasses.fields(TD.LCMDistillConfig)}
    want["lora_targets"] = got["lora_targets"]  # the same set, over the port's names
    assert got == want
