"""The port's ``quality_frontier.py`` against the JAX package's: the mode
matrix (labels, call arguments, int8 modes, DeepCache settings), the
refusal without ``--sd15``, the COCO prompts, the deltas, and one ``main``
run on tiny SD-1.5 and SD3 snapshots written into a temporary directory,
whose 16 rows reach the TSV and JSONL with no int8 mode left behind."""

import csv
import dataclasses
import json

import numpy as np
import pytest

from sonicdiffusionbayeslab_torch import quality_frontier as F
from sonicdiffusionbayeslab_torch.models import mmdit as TM
from sonicdiffusionbayeslab_torch.models import weights as W
from sonicdiffusionbayeslab_torch.models.pipelines import (
    StableDiffusion3Model,
    StableDiffusionModel,
)
from sonicdiffusionbayeslab_tpu import quality_frontier as JF


@pytest.mark.parametrize("family", ["sd15", "sd3"])
def test_mode_matrix_equals_jax(family):
    got = F.SD15_MODES if family == "sd15" else F.SD3_MODES
    want = JF.SD15_MODES if family == "sd15" else JF.SD3_MODES
    assert [dataclasses.asdict(m) for m in got] == [dataclasses.asdict(m) for m in want]
    assert len(got) == (9 if family == "sd15" else 7)
    assert got[0].label.endswith("exact_bf16")
    for m in got[1:]:  # approximate modes never call themselves exact
        assert m.call_kw or m.quant or m.cache_interval


def test_requires_sd15_snapshot():
    with pytest.raises(SystemExit):
        F.main([])


def test_coco_prompts_equal_jax():
    assert F.coco_prompts(7) == JF.coco_prompts(7)
    assert len(F.coco_prompts(3)) == 3 and all(F.coco_prompts(3))


def test_deltas_as_jax():
    rows = [{"mode": "exact_bf16", "family": "sd15", "sec_per_image": 0.5, "clip_score": 30.0},
            {"mode": "tome_0.5", "family": "sd15", "sec_per_image": 0.4, "clip_score": 29.0},
            {"mode": "sd3_int8", "family": "sd3", "sec_per_image": 1.0, "clip_score": None}]
    F.add_deltas(rows)
    assert rows[1]["speedup_vs_exact"] == round(0.5 / 0.4, 3) == 1.25
    assert rows[1]["clip_delta_pct"] == round(100.0 * (29.0 - 30.0) / 30.0, 3)
    assert rows[0]["speedup_vs_exact"] == 1.0 and "speedup_vs_exact" not in rows[2]


def test_main_on_tiny_snapshots(tmp_path, monkeypatch, capsys):
    """Tiny fp32 SD-1.5 and SD3 snapshots (``write_snapshot``), a random
    tiny CLIP tower, 1 prompt, 2 steps: 9 + 7 rows with the reference's
    columns, each mode's NFE, a CLIP score, and every row run with the
    model's int8 mode its own (reset after the row).  The SD3 modes split
    the trunk at block 2, so the tiny MMDiT gets depth 3 here."""
    tiny = TM.MMDiTConfig.tiny()
    monkeypatch.setattr(TM.MMDiTConfig, "tiny", classmethod(
        lambda cls: dataclasses.replace(tiny, depth=3)))
    sd15 = W.write_snapshot(StableDiffusionModel(tiny=True, dtype="float32", device="cpu").engine,
                            tmp_path / "sd15")
    sd3 = W.write_snapshot(StableDiffusion3Model(tiny=True, dtype="float32", device="cpu").engine,
                           tmp_path / "sd3")
    calls, seen = [], []
    call = StableDiffusionModel.__call__

    def recording_call(self, prompt, **kw):
        calls.append((self.engine.unet.quant_mode, self.cache_plan_fn is not None,
                      kw.get("tome_ratio"), kw["guidance_scale"]))
        return call(self, prompt, **kw)

    monkeypatch.setattr(StableDiffusionModel, "__call__", recording_call)
    run_mode = F.run_mode

    def recording(pipe, mode, *a, **kw):
        row = run_mode(pipe, mode, *a, **kw)
        seen.append((mode.label, mode.quant, pipe.engine.unet.quant_mode, pipe.cache_plan_fn))
        return row

    monkeypatch.setattr(F, "run_mode", recording)
    out = tmp_path / "frontier" / "run"
    assert F.main(["--sd15", str(sd15), "--sd3", str(sd3), "--clip", "x", "--prompts", "1",
                   "--batch", "1", "--sd3-batch", "1", "--steps", "2", "--tiny",
                   "--dtype", "float32", "--device", "cpu", "--out", str(out)]) == 0
    assert "frontier written" in capsys.readouterr().err
    with open(f"{out}.tsv") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    assert list(rows[0]) == F.COLUMNS == ["mode", "family", "nfe", "sec_per_image",
                                          "images_per_hour", "clip_score", "speedup_vs_exact",
                                          "clip_delta_pct"]
    labels = [m.label for m in F.SD15_MODES + F.SD3_MODES]
    assert [r["mode"] for r in rows] == labels
    assert [json.loads(line)["mode"] for line in open(f"{out}.jsonl")] == labels
    assert {r["nfe"] for r in rows} == {"2"}
    assert all(np.isfinite(float(r["clip_score"])) and float(r["sec_per_image"]) > 0
               for r in rows)
    assert rows[0]["speedup_vs_exact"] == rows[9]["speedup_vs_exact"] == "1.0"
    assert calls == [(m.quant, m.cache_interval >= 2, m.call_kw.get("tome_ratio"),
                      7.0 if m.family == "sd3" else 7.5) for m in F.SD15_MODES + F.SD3_MODES]
    assert [s[0] for s in seen] == labels
    assert all(q is None and plan is None for _, _, q, plan in seen)
