"""The readers of the program's spans against hand counts on synthetic
traces: the share of a train step phase's time in which the device
idled; None where the trace holds no such span (a program without it)
or no trace was taken."""

from __future__ import annotations

import pytest

from portbench import run as harness
from portbench.record import Record
from portbench.trace import Trace

TRAIN = ["forward_idle.train", "backward_idle.train", "optimizer_idle.train"]


def reader(name):
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py", "reader")


def train_trace():
    """Two steps.  Step at b: forward [b, b+1000] with the device busy over
    [b+200, b+500]; backward [b+1000, b+3000], busy 600 ns of it in four
    kernels; the optimizer [b+3000, b+4000], busy 100 ns."""
    host = [("portbench.window", 0, 10_000, 1)]
    kernels, launches = [], {}
    corr = 0

    def launch(at, start, ns):
        nonlocal corr
        corr += 1
        launches[corr] = at
        kernels.append((f"k{corr}", start, start + ns, corr))

    for b in (0, 5000):
        host += [("train_step.loss_and_grad", b, b + 3000, 1),
                 ("train_step.forward", b, b + 1000, 1),
                 ("train_step.backward", b + 1000, b + 3000, 1),
                 ("train_step.optimizer", b + 3000, b + 4000, 1)]
        launch(b + 100, b + 200, 300)  # forward: busy 300
        for at, ns in ((1150, 50), (1450, 70), (1750, 30), (2000, 450)):  # backward: busy 600
            launch(b + at, b + at + 50, ns)
        launch(b + 3100, b + 3400, 100)  # optimizer: busy 100
    return Trace(kernels=kernels, host=host, window=(0, 10_000), launches=launches)


def train_record(trace):
    return Record(calls=[{"t0": 0.0, "t1": 1.0, "images": 8, "traced": True},
                         {"t0": 1.0, "t1": 2.0, "images": 8, "traced": True}], trace=trace)


def test_train_span_readers_by_hand():
    rec = train_record(train_trace())
    assert reader("forward_idle.train").read(rec) == pytest.approx(100 * (1 - 300 / 1000))
    assert reader("backward_idle.train").read(rec) == pytest.approx(100 * (1 - 600 / 2000))
    assert reader("optimizer_idle.train").read(rec) == pytest.approx(100 * (1 - 100 / 1000))


def test_idle_share_clips_kernels_that_cross_a_span_edge():
    from portbench.spans import idle_share

    t = Trace(kernels=[("a", 50, 150, 1), ("b", 180, 260, 2), ("c", 290, 400, 3)],
              host=[("s", 100, 200, 1), ("s", 250, 300, 1)], window=(0, 1000))
    # Busy inside [100, 200]: 50 (a) + 20 (b); inside [250, 300]: 10 (b) + 10 (c).
    assert idle_share(t, "s") == pytest.approx(100 * (1 - 90 / 150))


@pytest.mark.parametrize("name", TRAIN)
def test_span_readers_read_nothing_without_their_spans_or_a_trace(name):
    full = train_trace()
    # The parent's program: the same kernels and harness spans, none of the program's.
    bare = Trace(kernels=full.kernels, host=[h for h in full.host if h[0].startswith("portbench.")],
                 window=full.window, launches=full.launches)
    assert reader(name).read(train_record(bare)) is None
    assert reader(name).read(train_record(None)) is None
    assert reader(name).read(train_record(full)) is not None
