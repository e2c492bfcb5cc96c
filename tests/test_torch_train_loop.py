"""The port's training behaviour on the CPU (tiny configs, fp32): step 0 of
LoRA is the base model, the base stays frozen, EMA, the v-prediction and
min-SNR losses, full fine-tune, the ControlNet target, remat, and the
config-driven loop (``run_training``: prefetch 0 and 2, the LoRA export
fused back, full and SD3 runs, its guards, ``main``).  Parity with the JAX
package's numbers is ``test_torch_training.py``'s."""

import json

import numpy as np
import pytest
import torch

from torch_parity import assert_close, randn, t
from sonicdiffusionbayeslab_torch.config import ConfigNode, validate_config
from sonicdiffusionbayeslab_torch.data.imageio import write_png
from sonicdiffusionbayeslab_torch.models import weights as W
from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel
from sonicdiffusionbayeslab_torch.training import loop as TLoop
from sonicdiffusionbayeslab_torch.training import trainer as TT
from sonicdiffusionbayeslab_torch.training.optim import global_norm

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engine():
    """A tiny fp32 SD-1.5 engine of this file's own (the ControlNet test
    adds a ControlNet to it)."""
    return StableDiffusionModel("x", tiny=True, dtype="float32", device="cpu").engine


@pytest.fixture(scope="module")
def batch():
    return t(randn((2, 8, 8, 4), 1)), t(randn((2, 77, 32), 2))


DRAWS = dict(noise=t(randn((2, 8, 8, 4), 3)), timesteps=torch.tensor([37, 812]))


def _snapshot(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def test_lora_step0_is_the_base_model_and_the_base_stays_frozen(engine, batch):
    base = _snapshot(engine.unet)
    lora = TT.DiffusionTrainer(engine, TT.TrainConfig(lora_rank=4, learning_rate=1e-2))
    state = lora.init_state()
    assert all(torch.equal(v, base[k]) for k, v in lora.unet_params(state).items())
    full = TT.DiffusionTrainer(engine, TT.TrainConfig())
    loss_lora, _ = lora.value_and_grad(state, *batch, **DRAWS)
    loss_full, _ = full.value_and_grad(full.init_state(), *batch, **DRAWS)
    assert float(loss_lora) == float(loss_full)
    for _ in range(2):
        state, m = lora.train_step(state, *batch)
        assert np.isfinite(float(m["loss"]))
    assert all(torch.equal(v, base[k]) for k, v in engine.unet.state_dict().items())
    assert not any(p.requires_grad for p in engine.unet.parameters())
    moved = lora.unet_params(state)
    assert any(not torch.equal(moved[k], base[k]) for k in base)
    assert state.step == 2


def test_ema_is_the_decayed_average_of_the_trained_weights(engine, batch):
    tr = TT.DiffusionTrainer(engine, TT.TrainConfig(lora_rank=4, ema_decay=0.9,
                                                    learning_rate=1e-2))
    state = tr.init_state()
    before = {k: {kk: vv.detach().clone() for kk, vv in v.items()}
              for k, v in state.trainable.items()}
    state, _ = tr.train_step(state, *batch)
    d = torch.tensor(0.9, dtype=torch.float32)
    for k, ab in state.trainable.items():
        for kk, v in ab.items():
            want = d * before[k][kk] + (1 - d) * v.detach()
            assert_close(state.ema[k][kk], want.numpy(), 1e-7, 1e-6)
    ema = tr.unet_params(state, use_ema=True)
    assert any(not torch.equal(ema[k], v) for k, v in tr.unet_params(state).items())


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("snr_gamma", [None, 5.0])
def test_prediction_targets_and_min_snr_weights(engine, batch, prediction_type, snr_gamma):
    """The loss is the weighted MSE to the target, recomputed here from
    the UNet's own prediction: epsilon (noise) or v (√ᾱ·ε − √(1−ᾱ)·x0);
    min-SNR-γ weights min(SNR, γ)/SNR (epsilon) or /(SNR + 1) (v)."""
    tr = TT.DiffusionTrainer(engine, TT.TrainConfig(prediction_type=prediction_type,
                                                    snr_gamma=snr_gamma, lora_rank=4))
    loss, _ = tr.value_and_grad(tr.init_state(), *batch, **DRAWS)
    lat, ctx = batch
    ac = torch.tensor(tr.schedule.alphas_cumprod, dtype=torch.float32)[DRAWS["timesteps"]]
    a = ac[:, None, None, None]
    noisy = a.sqrt() * lat + (1 - a).sqrt() * DRAWS["noise"]
    with torch.no_grad():
        pred = engine.unet(noisy, DRAWS["timesteps"].float(), ctx)
    y = (a.sqrt() * DRAWS["noise"] - (1 - a).sqrt() * lat if prediction_type == "v_prediction"
         else DRAWS["noise"])
    w = torch.ones(2)
    if snr_gamma:
        snr = ac / (1 - ac)
        w = torch.clamp(snr, max=snr_gamma) / (snr + 1 if prediction_type == "v_prediction"
                                                else snr)
        assert not torch.allclose(w, torch.ones(2))
    want = (w * ((pred - y) ** 2).mean(dim=(1, 2, 3))).mean()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)


def test_full_finetune_trains_an_fp32_master_copy(engine, batch):
    base = _snapshot(engine.unet)
    tr = TT.DiffusionTrainer(engine, TT.TrainConfig(learning_rate=1e-3))
    state = tr.init_state()
    assert set(state.trainable) == set(dict(engine.unet.named_parameters()))
    losses = []
    for _ in range(3):
        state, m = tr.train_step(state, *batch, generator=torch.Generator().manual_seed(0))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]  # the same draws every step: it fits them
    assert all(torch.equal(v, base[k]) for k, v in engine.unet.state_dict().items())
    sd = tr.unet_params(state)
    assert all(v.dtype == engine.unet.dtype for v in sd.values())
    engine.unet.load_state_dict(sd)  # what _save writes loads strictly
    engine.unet.load_state_dict(base)


def test_controlnet_target_trains_the_copy_with_the_unet_frozen(engine, batch):
    """Zero heads: step 0's loss is the frozen UNet's, and only the heads
    get a gradient (the copy's encoder is behind them); after steps the
    copy has moved and the UNet has not."""
    base = _snapshot(engine.unet)
    tr = TT.DiffusionTrainer(engine, TT.TrainConfig(train_target="controlnet",
                                                    learning_rate=1e-3))
    state = tr.init_state()
    hint = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    loss, grads = tr.value_and_grad(state, *batch, hint=hint, **DRAWS)
    plain = TT.DiffusionTrainer(engine, TT.TrainConfig(lora_rank=4))
    want, _ = plain.value_and_grad(plain.init_state(), *batch, **DRAWS)
    assert float(loss) == float(want)
    heads = {n for n, _ in engine.controlnet.named_parameters()
             if n.startswith(("controlnet_down_blocks", "controlnet_mid_block"))}
    for k, g in grads.items():  # the cond embedding's zero conv_out is behind them too
        assert bool(g.abs().max() > 0) == (k in heads), k
    for _ in range(2):
        state, m = tr.train_step(state, *batch, hint=hint)
        assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    after, _ = tr.value_and_grad(state, *batch, hint=hint, **DRAWS)
    assert float(after) != float(loss)
    assert all(torch.equal(v, base[k]) for k, v in engine.unet.state_dict().items())
    cn = tr.controlnet_params(state)
    assert set(cn) == set(dict(engine.controlnet.named_parameters()))
    with pytest.raises(ValueError, match="controlnet"):
        plain.controlnet_params(plain.init_state())


@pytest.mark.parametrize("kw", [dict(lora_rank=4), dict(), dict(train_target="controlnet")])
def test_remat_gives_the_same_loss_and_gradients(engine, batch, kw):
    """torch.utils.checkpoint with the matmul-saving policy runs the
    forward again in the backward: the same loss and gradients."""
    if kw.get("train_target") and engine.controlnet is None:
        engine.init_controlnet(0)
    extra = {"hint": torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))} \
        if kw.get("train_target") else {}
    plain = TT.DiffusionTrainer(engine, TT.TrainConfig(**kw))
    remat = TT.DiffusionTrainer(engine, TT.TrainConfig(remat=True, **kw))
    state = plain.init_state(generator=torch.Generator().manual_seed(5))
    if kw.get("lora_rank"):  # a non-zero b, so every adapter has a gradient
        for ab in state.trainable.values():
            ab["b"].data.normal_(0, 0.05, generator=torch.Generator().manual_seed(6))
    l0, g0 = plain.value_and_grad(state, *batch, **DRAWS, **extra)
    l1, g1 = remat.value_and_grad(state, *batch, **DRAWS, **extra)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for k in g0:
        assert_close(g1[k], g0[k].numpy(), 1e-7, 1e-5)
    assert float(global_norm(g0)) > 0


def test_inference_tensors_from_the_encoders_are_taken(engine, batch):
    """encode_prompts runs under inference_mode; the trainer copies such
    tensors, so a LoRA'd cross-attention can save its context."""
    ids = np.zeros((2, 77), np.int64)
    ctx = engine.encode_prompts(ids)
    assert ctx.is_inference()
    tr = TT.DiffusionTrainer(engine, TT.TrainConfig(lora_rank=4))
    state, m = tr.train_step(tr.init_state(), batch[0], ctx)
    assert np.isfinite(float(m["loss"]))


# ---------------------------------------------------------------- loop
def _dataset(root, n=4, size=16):
    img_dir = root / "imgs"
    rng = np.random.default_rng(0)
    ann = {}
    for i in range(n):
        name = f"img_{i}.jpg"  # PNG content under the annotation's name
        write_png(img_dir / name, rng.integers(0, 255, (size, size, 3), dtype=np.uint8))
        ann[name] = f"a synthetic training image number {i}"
    (root / "ann.json").write_text(json.dumps(ann))
    return img_dir, root / "ann.json"


def _config(root, training, model="stable_diffusion_model", size=16):
    img_dir, ann = _dataset(root, size=size)
    raw = {"experiment_name": "t", "experiment": {"seed": 29},
           "model": {"model_name": model, "pretrained_model": "x", "tiny": True,
                     "dtype": "float32", "device": "cpu"},
           "dataset": {"img_dataset": str(img_dir), "prompts": str(ann), "image_size": size},
           "training": {"num_steps": 3, "batch_size": 2, "log_every": 1, **training}}
    return validate_config(ConfigNode(raw))


def test_run_training_prefetch_matches_inline_and_its_lora_fuses(tmp_path, capsys):
    runs = {}
    for depth in (0, 2):
        out = TLoop.run_training(_config(tmp_path / f"d{depth}", {
            "lora_rank": 4, "learning_rate": 1e-2, "prefetch": depth,
            "save_dir": str(tmp_path / f"out{depth}")}))
        runs[depth] = out
    assert runs[0]["losses"] == runs[2]["losses"] and len(runs[0]["losses"]) == 3
    assert all(np.isfinite(runs[0]["losses"]))
    assert runs[0]["steps_per_sec"] > 0
    assert "step 3/3 loss" in capsys.readouterr().out
    npz = np.load(tmp_path / "out2" / "final" / "lora_peft.npz")
    trainer, state = runs[2]["trainer"], runs[2]["state"]
    assert len(npz.files) == 3 * len(state.trainable)
    engine = runs[2]["engine"]
    merged, names = W.merge_lora(engine.unet.state_dict(),
                                 {k: torch.from_numpy(npz[k]) for k in npz.files})
    assert sorted(names) == sorted(state.trainable)
    for k, v in trainer.unet_params(state).items():
        assert_close(merged[k], v.numpy(), 1e-6, 1e-6)


def test_run_training_full_target_saves_a_loadable_unet(tmp_path):
    out = TLoop.run_training(_config(tmp_path, {
        "num_steps": 2, "learning_rate": 1e-3, "prefetch": 0, "save_every": 1,
        "save_dir": str(tmp_path / "out")}))
    engine = out["engine"]
    for tag in ("step_1", "step_2", "final"):
        sd = torch.load(tmp_path / "out" / tag / "unet" / "diffusion_pytorch_model.bin")
        engine.unet.load_state_dict(sd, strict=True)


def test_run_training_sd3_flow_lora(tmp_path):
    """The SD3 branch: flow objective and MMDIT_TARGETS by default, the
    pooled embeddings as the MMDiT's text_embeds."""
    out = TLoop.run_training(_config(tmp_path, {
        "lora_rank": 4, "prefetch": 0, "save_dir": str(tmp_path / "out")},
        model="stable_diffusion_3_model"))
    assert out["trainer"].config.objective == "flow"
    assert all(np.isfinite(out["losses"]))
    keys = np.load(tmp_path / "out" / "final" / "lora_peft.npz").files
    assert any(".attn.add_v_proj.lora_B" in k for k in keys)


def test_run_training_sdxl_time_ids(tmp_path):
    out = TLoop.run_training(_config(tmp_path, {"lora_rank": 4, "prefetch": 0},
                                     model="stable_diffusion_xl_model"))
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))


@pytest.mark.parametrize("training,refused", [({"mesh_model": 2}, False), ({"mesh_seq": 2}, True)])
def test_modes_still_to_come_name_their_roadmap_item(tmp_path, training, refused):
    """As the JAX loop reads its mesh: ``mesh_model`` without ``mesh_data``
    builds no mesh, so the run is one process's (tests/test_torch_split_training.py
    runs it with ``mesh_data``); ``mesh_seq`` raises, as the JAX loop has no
    seq axis."""
    if refused:
        with pytest.raises(NotImplementedError, match="training loop has no seq axis"):
            TLoop.run_training(_config(tmp_path, training))
        return
    out = TLoop.run_training(_config(tmp_path, {**training, "lora_rank": 4, "prefetch": 0,
                                                "num_steps": 2}))
    assert out["trainer"].mesh is None and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))


@pytest.mark.parametrize("mode", ["textual_inversion", "lora", "Distill"])
def test_other_modes_raise_the_jax_loops_error(tmp_path, mode):
    """Textual inversion is a library API, not a loop mode, in both
    packages: any mode but diffusion and distill is the JAX loop's
    ValueError, word for word."""
    import inspect

    from sonicdiffusionbayeslab_tpu.training import loop as JLoop

    with pytest.raises(ValueError) as err:
        TLoop.run_training(_config(tmp_path, {"mode": mode}))
    assert str(err.value) == f"unknown training mode {mode!r} (diffusion|distill)"
    assert 'f"unknown training mode {mode!r} (diffusion|distill)"' in inspect.getsource(JLoop)


def test_prefetch_surfaces_a_prep_error_in_the_loop(tmp_path):
    cfg = _config(tmp_path, {"lora_rank": 4, "prefetch": 2})
    (tmp_path / "imgs" / "img_1.jpg").write_bytes(b"not an image")
    with pytest.raises(Exception, match="(?i)png|image|signature|decode"):
        TLoop.run_training(cfg)


def test_main_runs_a_config_file_on_the_cpu(tmp_path):
    img_dir, ann = _dataset(tmp_path)
    (tmp_path / "c.yaml").write_text(
        'experiment_name: "t"\nmodel:\n  model_name: "stable_diffusion_model"\n'
        '  pretrained_model: "x"\n  tiny: true\n  dtype: "float32"\n'
        f'dataset:\n  img_dataset: "{img_dir}"\n  prompts: "{ann}"\n  image_size: 16\n'
        'training:\n  num_steps: 2\n  batch_size: 2\n  lora_rank: 4\n')
    TLoop.main(["--config", str(tmp_path / "c.yaml"), "--device", "cpu",
                "--set", f"training.save_dir={tmp_path / 'out'}", "--set", "training.log_every=1"])
    assert (tmp_path / "out" / "final" / "lora_peft.npz").exists()


@pytest.mark.parametrize("mode", ["lora512", "full512_adam8bit", "sd3_lora"])
def test_train_bench_prints_one_json_line(mode, capsys):
    from sonicdiffusionbayeslab_torch import train_bench

    train_bench.main([mode, "--tiny", "--device", "cpu", "--steps", "1", "--batch", "2"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == f"train_{mode}" and rec["fits"] and rec["batch"] == 2
    assert rec["sec_per_step"] > 0 and rec["peak_hbm_gb"] is None and rec["device"] is None
