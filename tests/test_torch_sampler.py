"""The port's plans, runtime, engine, pipeline and CLI against the JAX
package (tiny configs, fp32, CPU), and the port's import hygiene."""

import struct
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import assert_close, randn, t, tiny_engines
from sonicdiffusionbayeslab_torch import schedulers as S
from sonicdiffusionbayeslab_torch.schedulers import runtime as R
from sonicdiffusionbayeslab_torch.utils.rng import per_sample_latents
from sonicdiffusionbayeslab_tpu import schedulers as JS
from sonicdiffusionbayeslab_tpu.schedulers import runtime as JR

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("steps,kw", [
    (20, {"solver_order": 2}),  # the main path
    (4, {"solver_order": 2}),
    (20, {"solver_order": 3, "use_karras_sigmas": True}),
    (10, {"solver_order": 1, "final_sigmas_type": "sigma_min"}),
    (12, {"solver_order": 2, "algorithm_type": "dpmsolver", "solver_type": "heun",
          "final_sigmas_type": "sigma_min"}),
    (8, {"solver_order": 2, "prediction_type": "v_prediction"}),
])
def test_dpm_plan_rows_bit_equal_to_jax(steps, kw):
    got = S.DPMSolverScheduler(**kw).build_plan(steps)
    want = JS.DPMSolverScheduler(**kw).build_plan(steps)
    assert got.name == want.name
    assert (got.hist_depth, got.needs_noise, got.has_saved) == (
        want.hist_depth, want.needs_noise, want.has_saved)
    g, w = got.scan_xs(), want.scan_xs()
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes(), k


def test_run_plan_matches_jax():
    plan = S.DPMSolverScheduler(solver_order=2).build_plan(20)
    jplan = JS.DPMSolverScheduler(solver_order=2).build_plan(20)
    x = randn((2, 8, 8, 4), 0)

    def eps_jax(ts, lat):
        return 0.3 * lat + jnp.sin(ts / 100.0)

    def eps_torch(ts, lat):
        return 0.3 * lat + torch.sin(ts / 100.0)

    want, want_x0 = JR.run_plan(jplan, jnp.asarray(x), eps_jax, collect_x0=True)
    got, got_x0 = R.run_plan(plan, t(x), eps_torch, collect_x0=True)
    # fp32 elementwise updates in the same order; the history sum may be
    # associated differently: ~1e-6 relative over 20 steps.
    assert_close(got, want, 1e-5, 1e-5)
    assert_close(got_x0, want_x0, 1e-5, 1e-5)


@pytest.fixture(scope="module")
def tiny_run():
    """The JAX tiny engine's 20-step DPM++ (order 2) CFG 7.5 run, with the
    per-step x0 of sample 0, from given initial latents."""
    from sonicdiffusionbayeslab_tpu.models.tokenizer import HashTokenizer

    jeng, params, teng = tiny_engines()
    tok = HashTokenizer(vocab_size=1000)
    ids, neg_ids = tok(["a cat", "a dog"]), tok(["", ""])
    lat0 = randn((2, 8, 8, 4), 5)
    plan = JS.DPMSolverScheduler(solver_order=2).build_plan(20)
    out = jeng.sample(params, plan, jeng.encode_prompts(params, ids),
                      jeng.encode_prompts(params, neg_ids), jax.random.PRNGKey(0),
                      guidance_scale=7.5, latent_hw=(8, 8), init_latents=jnp.asarray(lat0),
                      collect_x0=True, x0_samples=1)
    return dict(teng=teng, ids=ids, neg_ids=neg_ids, lat0=lat0, out=out)


@pytest.mark.parametrize("microbatch", [None, 2])
def test_tiny_engine_end_to_end_matches_jax(tiny_run, microbatch):
    """Encode, 20 UNet steps with CFG, DPM++ rows, decode: the JAX engine's
    run (whole batch) against the port's, whole and in 2 chunks."""
    teng, out = tiny_run["teng"], tiny_run["out"]
    plan = S.DPMSolverScheduler(solver_order=2).build_plan(20)
    got = teng.sample(plan, teng.encode_prompts(tiny_run["ids"]),
                      teng.encode_prompts(tiny_run["neg_ids"]), guidance_scale=7.5,
                      latent_hw=(8, 8), init_latents=t(tiny_run["lat0"]), collect_x0=True,
                      x0_samples=1, microbatch=microbatch)
    assert got.nfe == 20 and got.execution_time > 0
    # fp32 through 20 UNet calls whose CFG combine amplifies the model's
    # summation-order noise 7.5x: the final latents agree to ~1e-4.
    assert_close(got.latents, out.latents, 1e-3)
    assert got.images.shape == (2, 16, 16, 3)
    assert float(got.images.min()) >= 0.0 and float(got.images.max()) <= 1.0
    assert_close(got.images, out.images, 1e-3)  # images in [0, 1]
    assert got.x0_images.shape == (20, 1, 16, 16, 3)
    assert_close(got.x0_images, out.x0_images, 1e-3)


def test_per_sample_latents_depend_only_on_index():
    a = per_sample_latents(7, [0, 1, 2], (4, 4, 4))
    b = per_sample_latents(7, [2, 0], (4, 4, 4))
    assert torch.equal(a[2], b[0]) and torch.equal(a[0], b[1])
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a, per_sample_latents(8, [0, 1, 2], (4, 4, 4)))


def test_port_imports_no_jax():
    pkg = REPO / "sonicdiffusionbayeslab_torch"
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'yaml', 'pandas',\n"
        "                                    'PIL', 'sonicdiffusionbayeslab_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "sonicdiffusionbayeslab_torch.models.pipelines" in mods
    assert {f"sonicdiffusionbayeslab_torch.{m}" for m in (
        "calc_clip_score", "data._dataio", "data.imageio", "metrics.aesthetic", "metrics.frechet",
        "metrics.image_reward_model", "metrics.inception", "ops.quant", "models.mmdit",
        "models.sd3", "models.t5", "schedulers.flow", "quality_frontier", "serving",
        "serving.batcher", "serving.server", "serve_bench", "models.controlnet",
        "models.ip_adapter", "models.prompt_weighting", "training", "training.lora",
        "training.optim", "training.opt8bit", "training.trainer", "training.loop",
        "train_bench", "training.distillation", "training.textual_inversion", "parallel",
        "parallel.distributed", "parallel.mesh", "utils.profiling", "utils.trace_analysis")
    } <= set(mods)


def test_pipeline_without_device_raises_without_gpu():
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StableDiffusionModel(tiny=True)


def test_generate_cli_writes_png(tmp_path, capsys):
    from sonicdiffusionbayeslab_torch import generate

    out = tmp_path / "img_{i:03d}.png"
    generate.main(["--prompt", "a lighthouse", "--prompt", "a boat", "--tiny", "--device", "cpu",
                   "--steps", "4", "--out", str(out)])
    assert "wrote" in capsys.readouterr().out
    data = (tmp_path / "img_001.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    assert (w, h) == (16, 16)
    idat_len = struct.unpack(">I", data[33:37])[0]
    raw = zlib.decompress(data[41:41 + idat_len])
    assert len(raw) == h * (1 + 3 * w)
    with pytest.raises(ValueError, match="not ported"):
        generate.main(["--prompt", "x", "--scheduler", "flow_match_euler_scheduler",
                       "--device", "cpu"])
