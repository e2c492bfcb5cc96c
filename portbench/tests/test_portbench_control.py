"""The control of each offline cell on the card, at the cell's own size:
the program with its int8 path on (``ops/quant.py``'s ``int8_conv``, the
step below the configurations' bf16) fails the cell's limit on three
seeds, and the sound program passes it on the same seeds.  On the CPU,
where int8 has no kernel, the tiny run holds the control's direction:
the control's gap exceeds the sound one."""

from __future__ import annotations

import pytest
import torch

from portbench import calibrate
from portbench import run as harness
from portbench.tests.tiny import tiny_spec

CELLS = ("sd15-offline-b32",)
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    spec = harness.cell_spec(workload)
    (name, limit), = spec["cell"]["limits"].items()
    sound = [r[name] for r in calibrate.readings(spec, SEEDS, None)]
    control = [r[name] for r in calibrate.readings(spec, SEEDS, "int8_conv")]
    assert max(sound) <= limit < min(control), (sound, limit, control)


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_above_the_sound_program_on_the_cpu(workload):
    spec = tiny_spec(workload)
    name = next(iter(spec["cell"]["limits"]))
    sound = next(calibrate.readings(spec, [7], None, device="cpu"))[name]
    control = next(calibrate.readings(spec, [7], "int8_conv", device="cpu"))[name]
    assert control > sound


@pytest.mark.cuda
def test_train_control_and_faults_fail_and_program_passes_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    spec = harness.cell_spec("sd15-lora-b8")
    limits = spec["cell"]["limits"]
    for reading in calibrate.train_readings(spec, SEEDS, None):
        assert all(reading[k] <= v for k, v in limits.items()), reading
    for mode in ("int8", "half_batch"):
        for reading in calibrate.train_readings(spec, SEEDS, mode):
            assert any(reading[k] > v for k, v in limits.items()), reading


def test_train_control_and_faults_read_above_the_sound_program_on_the_cpu():
    spec = tiny_spec("sd15-lora-b8", batch=2)
    sound = next(calibrate.train_readings(spec, [7], None, device="cpu"))
    for mode in ("int8", "half_batch"):
        got = next(calibrate.train_readings(spec, [7], mode, device="cpu"))
        assert got["change_gap"] > sound["change_gap"] and got["grad_gap"] > sound["grad_gap"]
