"""The port's profiler spans (``utils/profiling.py::span``) on the CPU.

With no profiler running a span is one shared null context: a pipeline
call, a LoRA train step and a served batch run with ``record_function``
made to raise.  Under ``torch.profiler.profile`` (following every thread,
so that the batcher's worker, started before the profiler, is recorded)
the same runs emit each span as many times as the work it covers, nested
as the code nests them.  Every wait has a bound."""

import collections
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile, record_function

from sonicdiffusionbayeslab_torch.models.pipelines import (StableDiffusionModel,
                                                           StableDiffusionXLModel)
from sonicdiffusionbayeslab_torch.schedulers import DPMSolverScheduler
from sonicdiffusionbayeslab_torch.serving import GenerateRequest, InferenceServer
from sonicdiffusionbayeslab_torch.training import trainer as TT
from sonicdiffusionbayeslab_torch.utils import profiling

torch.set_num_threads(1)
WAIT = 60  # seconds: the bound of every wait below
STEPS, CHUNKS = 3, 2


@pytest.fixture(scope="module")
def pipe():
    p = StableDiffusionModel("x", tiny=True, dtype="float32", device="cpu")
    p.scheduler = DPMSolverScheduler(solver_order=2)
    return p


@pytest.fixture(scope="module")
def xl_pipe():
    return StableDiffusionXLModel(tiny=True, dtype="float32", device="cpu")


def call(pipe):
    images, _, _ = pipe(["a red boat", "a lighthouse"], num_inference_steps=STEPS,
                        unet_microbatch=CHUNKS, seed=3)
    assert images.shape[0] == 2 and images.shape[-1] == 3 and np.isfinite(images).all()


def train_step(pipe):
    trainer = TT.DiffusionTrainer(pipe.engine, TT.TrainConfig(lora_rank=4, ema_decay=0.9))
    g = torch.Generator().manual_seed(5)
    latents, context = torch.randn(2, 8, 8, 4, generator=g), torch.randn(2, 77, 32, generator=g)
    _, m = trainer.train_step(trainer.init_state(), latents, context,
                              noise=torch.randn(2, 8, 8, 4, generator=g),
                              timesteps=torch.tensor([37, 812]))
    assert np.isfinite(float(m["loss"]))


def served_batch(pipe):
    """Two requests into a server whose batch closes when it holds both."""
    server = InferenceServer(pipe, max_batch=2, max_wait_ms=30_000.0, pipeline_depth=2)
    try:
        futures = [server.submit(GenerateRequest(prompt=p, num_inference_steps=STEPS, seed=i))
                   for i, p in enumerate(["a red boat", "a lighthouse"])]
        for f in futures:
            assert f.result(timeout=WAIT)["image"].shape[-1] == 3
        assert server.stats["batches"] == 1
    finally:
        server.shutdown(wait=True)


RUNS = {"call": call, "train_step": train_step, "served_batch": served_batch}


def test_span_without_a_profiler_is_one_shared_null_context():
    assert profiling.span("pipeline.encode") is profiling.span("attention.backward")
    assert isinstance(profiling.span("x"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(profiling.span("x"), torch.autograd.profiler.record_function)
    assert isinstance(profiling.span("x"), contextlib.nullcontext)


@pytest.mark.parametrize("run", RUNS, ids=list(RUNS))
def test_runs_enter_no_record_function_without_a_profiler(pipe, run, monkeypatch):
    def refuse(name, *a, **kw):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    RUNS[run](pipe)


def spans(run, pipe):
    """{name: [(start, end, thread)]} of the Kineto host events that a
    profiler following every thread records around ``run`` (itself in a
    span ``test.run`` on the calling thread)."""
    config = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=config) as prof:
        with record_function("test.run"):
            run(pipe)
    out = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        out[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id()))
    return out


def inside(inner, outer) -> bool:
    return any(o[2] == inner[2] and o[0] <= inner[0] and inner[1] <= o[1] for o in outer)


@pytest.mark.parametrize("which", ["sd15", "sdxl"])
def test_call_spans_both_encodes_once_before_the_loop(pipe, xl_pipe, which):
    p = pipe if which == "sd15" else xl_pipe
    got = spans(call, p)
    (encode,) = got["pipeline.encode"]  # the prompts' and the negatives' encodes
    assert inside(encode, got["test.run"])
    # The text towers' lookups lie inside the span; the UNet's and the VAE's
    # convolutions all after it.
    assert any(inside(e, [encode]) for e in got["aten::embedding"])
    assert got["aten::conv2d"] and all(encode[1] <= c[0] for c in got["aten::conv2d"])


def test_train_step_spans_nest_and_count_the_backwards(pipe):
    got = spans(train_step, pipe)
    for name in ("train_step.loss_and_grad", "train_step.forward", "train_step.backward",
                 "train_step.optimizer"):
        assert len(got[name]) == 1, name
    outer = got["train_step.loss_and_grad"]
    assert inside(got["train_step.forward"][0], outer)
    assert inside(got["train_step.backward"][0], outer)
    assert got["train_step.forward"][0][1] <= got["train_step.backward"][0][0]
    # One backward span for each forward application of the two Functions,
    # as many as the tiny UNet has attention layers and fused GroupNorms.
    attentions = sum(type(m).__name__ == "Attention" for m in pipe.engine.unet.modules())
    assert len(got["attention.backward"]) == len(got["FlashAttentionFn"]) == attentions > 0
    assert len(got["group_norm.backward"]) == len(got["GroupNormSiLUFn"]) > 0
    backward = got["train_step.backward"][0]
    for name in ("attention.backward", "group_norm.backward"):
        assert all(backward[0] <= s[0] and s[1] <= backward[1] for s in got[name]), name


def test_served_batch_spans_the_encode_on_the_worker_thread(pipe):
    got = spans(served_batch, pipe)
    (encode,) = got["pipeline.encode"]  # one batch of both requests
    (main,) = got["test.run"]
    assert encode[2] != main[2] and main[0] <= encode[0] and encode[1] <= main[1]
