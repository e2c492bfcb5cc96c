"""Whole runs of the harness: with no card a measured run exits non-zero
and prints no result; what the benchmark runs loads neither JAX nor the
JAX package, and the reference loads nothing of the port; a tiny run on
the CPU (the harness's look for a card skipped) comes out correct, and
with the timed path broken underneath comes out not correct."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import numpy as np
import pytest

from portbench import run as harness
from portbench.tests.tiny import tiny_spec

FORBIDDEN = set(harness.FORBIDDEN)


def python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=harness.CHECKOUT, text=True,
                          capture_output=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                                 "CUDA_VISIBLE_DEVICES": ""})


def test_measured_run_without_a_card_exits_nonzero_and_prints_nothing():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "sd15-offline-b32", "--seed", str(2**31 + 5), "--seconds", "1",
                          "--trace", "0"], cwd=harness.CHECKOUT, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin",
                                                      "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_tiny_run_loads_no_jax_and_the_reference_no_port():
    code = ("import sys; from portbench import run; from portbench.tests.tiny import tiny_spec;"
            "r = run.run_cell(tiny_spec('sd15-offline-b32'), 3, 0.2, True, device='cpu');"
            "assert r['correct'], r;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "sonicdiffusionbayeslab_torch" in loaded and not loaded & FORBIDDEN
    code = ("import sys; import portbench.reference.sample, portbench.reference.census;"
            "import portbench.reference.nets;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert not loaded & (FORBIDDEN | {"sonicdiffusionbayeslab_torch"})


def test_sources_import_no_forbidden_top_level_name():
    for path in harness.ROOT.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in FORBIDDEN, (path, n)
                if "reference" in path.parts:
                    assert top != "sonicdiffusionbayeslab_torch", (path, n)


def run_tiny(seed=11, config=None):
    spec = tiny_spec("sd15-offline-b32", config=config)
    return harness.run_cell(spec, seed, 0.2, False, device="cpu")


@pytest.mark.parametrize("config", ["sd15", "sdxl"])
def test_sound_tiny_run_is_correct_under_the_cells_limits(config):
    res = run_tiny(config=config)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and set(res["metrics"]) == {"images_per_s", "setup_s"}


def test_a_step_that_returns_its_state_unchanged_is_not_correct(monkeypatch):
    from sonicdiffusionbayeslab_torch.models import sampler

    monkeypatch.setattr(sampler, "apply_row", lambda carry, eps, r, noise=None:
                        (carry, carry.latents))
    assert not run_tiny()["correct"]


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    from sonicdiffusionbayeslab_torch.models.sampler import StableDiffusionEngine

    whole = StableDiffusionEngine._unet_chunks

    def half(self, microbatch, args, *a, **kw):
        out = whole(self, microbatch, args, *a, **kw)
        n = out.shape[0] // 2  # each CFG half's second rows copy its first
        for lo in (0, n):
            out[lo + n // 2:lo + n] = out[lo:lo + n - n // 2][:n // 2]
        return out

    monkeypatch.setattr(StableDiffusionEngine, "_unet_chunks", half)
    assert not run_tiny()["correct"]


def test_an_image_altered_where_it_is_produced_is_not_correct(monkeypatch):
    from sonicdiffusionbayeslab_torch.serving import batcher

    rounded = batcher.quantize_uint8

    def altered(images):
        out = rounded(images).clone()
        out[-1] = 255 - out[-1]  # the batch's last image, inverted
        return out

    monkeypatch.setattr(batcher, "quantize_uint8", altered)
    assert not run_tiny()["correct"]


def test_sample_of_checked_images_holds_both_ends_of_the_last_call():
    from portbench.traffic.offline import sample_checks

    calls = [{"k": k} for k in range(5)]
    picks = sample_checks(2**31 + 3, calls, 32, 4)
    assert picks[:2] == [(4, 0), (4, 31)] and len(set(picks)) == 4
    assert picks == sample_checks(2**31 + 3, calls, 32, 4)
    assert np.all([0 <= r < 32 for _, r in picks])


def run_tiny_train(seed=13):
    spec = tiny_spec("sd15-lora-b8", batch=2)
    return harness.run_cell(spec, seed, 0.5, False, device="cpu")


def test_sound_tiny_train_run_is_correct_under_the_cells_limits():
    res = run_tiny_train()
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train_images_per_s", "setup_s"}


def test_a_train_step_that_returns_its_state_unchanged_is_not_correct(monkeypatch):
    import torch

    from sonicdiffusionbayeslab_torch.training.trainer import DiffusionTrainer

    monkeypatch.setattr(DiffusionTrainer, "train_step", lambda self, state, *a, **kw: (
        state, {"loss": torch.zeros(()), "grad_norm": torch.zeros(())}))
    res = run_tiny_train()
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_train_batch_left_out_is_not_correct(monkeypatch):
    from sonicdiffusionbayeslab_torch.training.trainer import DiffusionTrainer

    whole = DiffusionTrainer.value_and_grad

    def first_half(self, state, latents, context, generator=None, hint=None, added=None,
                   noise=None, timesteps=None, u=None):
        n = latents.shape[0] // 2
        return whole(self, state, latents[:n], context[:n], generator, hint, added,
                     noise[:n], timesteps[:n], u)

    monkeypatch.setattr(DiffusionTrainer, "value_and_grad", first_half)
    assert not run_tiny_train()["correct"]
