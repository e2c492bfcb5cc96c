"""The port's serving path (``sonicdiffusionbayeslab_torch/serving``,
``serve_bench.py``) on the CPU: the batcher's calls, counters, uint8 round
and PNG bytes against the JAX package's; the behaviour
``tests/test_serving.py`` checks of the JAX server (coalescing, signature
groups, overload, queue-wait timeout, drain, 64 requests without a loss,
overlap with ``pipeline_depth`` 2 and none with 1, the knobs of ``main``);
a real tiny pipeline behind the server, bit-equal to the pipeline called
directly; and the HTTP front end.  Every wait has a bound."""

import base64
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sonicdiffusionbayeslab_torch import serve_bench
from sonicdiffusionbayeslab_torch.data.imageio import encode_png_bytes
from sonicdiffusionbayeslab_torch.registry import load_all_plugins, models_registry
from sonicdiffusionbayeslab_torch.schedulers import DPMSolverScheduler
from sonicdiffusionbayeslab_torch.serving import (
    GenerateRequest,
    InferenceServer,
    ServerOverloadedError,
)
from sonicdiffusionbayeslab_torch.serving import batcher as B
from sonicdiffusionbayeslab_torch.serving import server as server_mod

torch.set_num_threads(1)
WAIT = 60  # seconds: the bound of every wait below


@pytest.fixture(scope="module")
def pipe():
    load_all_plugins()
    p = models_registry["stable_diffusion_model"](pretrained_model="x", tiny=True,
                                                  image_size=64, dtype="float32", device="cpu")
    p.scheduler = DPMSolverScheduler(solver_order=2)
    return p


@pytest.fixture()
def server(pipe):
    s = InferenceServer(pipe, max_batch=4, max_wait_ms=150.0)
    yield s
    s.shutdown()


class _RecordingPipe:
    """Records each call's arguments; images of zeros on the host."""

    num_timesteps = 3

    def __init__(self):
        self.calls = []

    def __call__(self, prompts, **kw):
        self.calls.append(dict(prompts=list(prompts), **kw))
        return np.zeros((len(prompts), 4, 4, 3), np.float32), 0.01, None


def _pending(mod, requests, first_index=7):
    from concurrent.futures import Future

    return [mod._Pending(r, Future(), first_index + i) for i, r in enumerate(requests)]


@pytest.mark.parametrize("size", [None, (64, 128)])
def test_run_batch_arguments_and_counters_equal_jax(size):
    """The same pending requests through each package's ``_run_batch``: the
    prompts, negatives (padded with "" to max_batch), sample_indices
    (explicit seeds odd, counter streams even, padding 0), step count,
    guidance, size arguments and the serving flags are equal, and so are
    the counters; the port passes seed 0 where JAX passes PRNGKey(0)."""
    from sonicdiffusionbayeslab_tpu.serving import batcher as JB

    hw = dict(height=size[0], width=size[1]) if size else {}
    reqs = lambda mod: [  # noqa: E731
        mod.GenerateRequest("a cat", 3, 6.0, "blurry", seed=5, **hw),
        mod.GenerateRequest("a dog", 3, 6.0, **hw),
        mod.GenerateRequest("a boat", 3, 6.0, "", seed=2**20, **hw)]
    got = {}
    for name, mod in (("port", B), ("jax", JB)):
        rec = _RecordingPipe()
        srv = mod.InferenceServer(rec, max_batch=5, max_wait_ms=1.0, pipeline_depth=1)
        try:
            batch = _pending(mod, reqs(mod))
            srv._run_batch(batch)
            outs = [p.future.result(timeout=WAIT) for p in batch]
        finally:
            srv.shutdown()
        (call,) = rec.calls
        got[name] = (call, dict(srv.stats), outs)
    (pc, ps, po), (jc, js, jo) = got["port"], got["jax"]
    key = jc.pop("key")
    assert np.array_equal(np.asarray(key), np.asarray([0, 0])) and pc.pop("seed") == 0
    assert pc.keys() == jc.keys()
    for k in pc:
        np.testing.assert_array_equal(np.asarray(pc[k]), np.asarray(jc[k]), err_msg=k)
    assert pc["sample_indices"].tolist() == [11, (0x5E4E + 8) * 2, 2**21 + 1, 0, 0]
    assert pc["output_type"] == "device" and pc["time_loop"] is False
    assert {k: v for k, v in ps.items() if k != "batch_seconds"} == \
        {k: v for k, v in js.items() if k != "batch_seconds"}
    for a, b in zip(po, jo):
        assert a.keys() == b.keys() and a["batch_size"] == b["batch_size"] == 3
        assert a["nfe"] == b["nfe"] and a["image"].dtype == b["image"].dtype == np.uint8


def test_uint8_round_bit_equal_to_jax_and_png_bytes():
    """The device round (``quantize_uint8``, fp32 multiply then add) equals
    the JAX batcher's and the host's, bit for bit, on random images and on
    the values at and around each k / 255 and (k - 0.5) / 255.  The PNGs of
    the float and of the rounded image are the same bytes as the JAX
    package's PNG of the float image, and decode to the rounded pixels."""
    import io

    import jax.numpy as jnp
    from PIL import Image

    from sonicdiffusionbayeslab_tpu.data.imageio import encode_png_bytes as jax_png

    rng = np.random.default_rng(0)
    k = np.arange(256, dtype=np.float32)
    edges = np.concatenate([k / 255, (k - 0.5) / 255, (k + 0.5) / 255])
    edges = np.concatenate([edges, np.nextafter(edges, 2), np.nextafter(edges, -1),
                            [-0.1, 1.1, 0.0, 1.0]]).astype(np.float32)
    imgs = np.concatenate([rng.random(3 * 32 * 32 * 3, dtype=np.float32),
                           edges, np.zeros(-len(edges) % 3, np.float32)])
    imgs = imgs[: len(imgs) // 96 * 96].reshape(-1, 4, 8, 3)
    got = B.quantize_uint8(torch.from_numpy(imgs)).numpy()
    want = np.asarray(jnp.clip(jnp.asarray(imgs) * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint8))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, B.quantize_uint8_host(imgs))
    for img, rounded in ((imgs[0], got[0]), (imgs[1], got[1])):
        png = encode_png_bytes(img)
        assert png == encode_png_bytes(rounded)
        assert png == jax_png(img)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))), rounded)


def test_single_request(server):
    out = server.generate(GenerateRequest("a cat", num_inference_steps=3), timeout=WAIT)
    assert out["image"].shape == (16, 16, 3) and out["image"].dtype == np.uint8
    assert out["nfe"] == 3


def test_untimed_loop_reports_batch_wall(server):
    """The server calls the pipeline with time_loop=False; execution_time is
    the batch's positive wall clock, never the -1.0 of an untimed loop."""
    out = server.generate(GenerateRequest("a dog", num_inference_steps=3), timeout=WAIT)
    assert out["execution_time"] > 0


def test_device_output_and_untimed_loop(pipe):
    """``output_type="device"`` returns the images as the device's tensor
    (here the CPU's), equal to the numpy output; ``time_loop=False`` gives
    execution_time -1.0."""
    kw = dict(num_inference_steps=3, guidance_scale=5.0, seed=3)
    want, t_np, _ = pipe(["a cat", "a dog"], **kw)
    got, t_dev, _ = pipe(["a cat", "a dog"], output_type="device", time_loop=False, **kw)
    assert isinstance(got, torch.Tensor) and t_dev == -1.0 and t_np > 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_encode_memo_uniform_batches(pipe):
    """Uniform batches are encoded once (keyed on prompt and batch size, at
    most 4 entries); mixed batches are not memoised."""
    pipe._encode_memo.clear()
    e1 = pipe._encode(["", ""])
    assert pipe._encode(["", ""]) is e1
    e3 = pipe._encode(["", "", ""])
    assert e3 is not e1 and e3.shape[0] == 3
    assert pipe._encode(["a cat", "a dog"]) is not pipe._encode(["a cat", "a dog"])
    torch.testing.assert_close(e1, pipe._encode_uncached(["", ""]), atol=0, rtol=0)
    for i in range(5):
        pipe._encode([f"p{i}"] * 2)
    assert len(pipe._encode_memo) == 4 and ("p4", 2) in pipe._encode_memo


def test_encode_memo_cleared_by_weight_changes(tmp_path):
    """A weight change clears the memo: after ``fuse_lora`` a uniform batch
    is encoded again (a new tensor), and after new text-tower weights it
    gives the new states."""
    from sonicdiffusionbayeslab_torch.models.pipelines import StableDiffusionModel

    p = StableDiffusionModel(tiny=True, dtype="float32", device="cpu")
    before = p._encode(["a cat"] * 2)
    assert p._encode(["a cat"] * 2) is before
    name = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q"
    w = p.engine.unet.state_dict()[f"{name}.weight"]
    kohya = "lora_unet_" + name.replace(".", "_")
    lora = {f"{kohya}.lora_down.weight": torch.ones(2, w.shape[1]) * 1e-2,
            f"{kohya}.lora_up.weight": torch.ones(w.shape[0], 2) * 1e-2}
    torch.save(lora, tmp_path / "lora.bin")
    p.load_lora_weights(str(tmp_path / "lora.bin")).fuse_lora()
    assert p.lora_merged
    after = p._encode(["a cat"] * 2)
    assert after is not before
    torch.testing.assert_close(after, before, atol=0, rtol=0)  # the text tower is unchanged
    sds = {k: m.state_dict() for k, m in zip(p.engine.MODULES, p.engine.modules())}
    sds["text"] = {k: v * 1.5 if k.endswith("final_layer_norm.weight") else v
                   for k, v in sds["text"].items()}
    p.engine.load_state_dicts(sds)
    new = p._encode(["a cat"] * 2)
    torch.testing.assert_close(new, p._encode_uncached(["a cat"] * 2), atol=0, rtol=0)
    assert not torch.equal(new, before)


def test_concurrent_requests_coalesce(server):
    futs = [server.submit(GenerateRequest(f"prompt {i}", num_inference_steps=3))
            for i in range(4)]
    outs = [f.result(timeout=WAIT) for f in futs]
    assert all(o["image"].shape == (16, 16, 3) for o in outs)
    assert any(o["batch_size"] == 4 for o in outs)
    assert server.stats["batches"] < server.stats["requests"]


def test_served_image_equals_the_pipeline_called_directly(pipe, server):
    """A seeded request served alone and the same request sharing its batch
    give the image the pipeline gives directly at the same sample index in
    a batch padded to max_batch, bit for bit."""
    req = GenerateRequest("a cat", num_inference_steps=3, seed=123)
    solo = server.generate(req, timeout=WAIT)
    futs = [server.submit(req), server.submit(GenerateRequest("a dog", 3, seed=77)),
            server.submit(GenerateRequest("a fish", 3, seed=78))]
    shared = futs[0].result(timeout=WAIT)
    [f.result(timeout=WAIT) for f in futs[1:]]
    direct, _, _ = pipe(["a cat", "", "", ""], num_inference_steps=3, guidance_scale=7.5,
                        negative_prompt=[""] * 4, sample_indices=[247, 0, 0, 0], seed=0)
    np.testing.assert_array_equal(solo["image"], shared["image"])
    np.testing.assert_array_equal(solo["image"], B.quantize_uint8_host(direct[0]))


def test_uint8_readback_matches_float_path(pipe):
    req = GenerateRequest("a cat", num_inference_steps=3, seed=9)
    outs = {}
    for dtype in ("uint8", "float32"):
        s = InferenceServer(pipe, max_batch=2, max_wait_ms=50.0, readback_dtype=dtype)
        try:
            outs[dtype] = s.generate(req, timeout=WAIT)["image"]
        finally:
            s.shutdown()
    assert outs["uint8"].dtype == np.uint8 and outs["float32"].dtype == np.float32
    assert encode_png_bytes(outs["uint8"]) == encode_png_bytes(outs["float32"])
    with pytest.raises(ValueError, match="readback_dtype"):
        InferenceServer(pipe, readback_dtype="bf16")


def test_mixed_signatures_split_batches(server):
    futs = [server.submit(GenerateRequest("a", num_inference_steps=3)),
            server.submit(GenerateRequest("b", num_inference_steps=2)),
            server.submit(GenerateRequest("c", num_inference_steps=3))]
    assert [f.result(timeout=WAIT)["nfe"] for f in futs] == [3, 2, 3]


def test_nonsquare_requests_group_by_shape(server):
    futs = [server.submit(GenerateRequest("a", num_inference_steps=2, height=64, width=128)),
            server.submit(GenerateRequest("b", num_inference_steps=2)),
            server.submit(GenerateRequest("c", num_inference_steps=2, height=64, width=128))]
    shapes = [f.result(timeout=WAIT)["image"].shape for f in futs]
    assert shapes == [(16, 32, 3), (16, 16, 3), (16, 32, 3)]


def test_malformed_seed_is_submitters_error(server):
    with pytest.raises(ValueError, match="seed"):
        server.submit(GenerateRequest("a cat", num_inference_steps=2, seed="abc"))
    assert server.generate(GenerateRequest("a cat", 2), timeout=WAIT)["image"].shape == (16, 16, 3)


def test_shutdown_refuses_new_requests(pipe):
    s = InferenceServer(pipe, max_batch=4, max_wait_ms=50.0)
    s.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        s.submit(GenerateRequest("a cat"))


class _BlockingPipe:
    """Its call blocks until released (or sleeps ``delay_s``)."""

    num_timesteps = 2

    def __init__(self, delay_s=None):
        self.release = threading.Event()
        self.delay_s = delay_s
        self.calls = 0

    def __call__(self, prompts, **kw):
        self.calls += 1
        if self.delay_s is not None:
            time.sleep(self.delay_s)
        else:
            assert self.release.wait(timeout=WAIT), "the test did not release the pipe"
        return np.zeros((len(prompts), 4, 4, 3), np.float32), 0.01, None


def test_overload_rejects_submit():
    fake = _BlockingPipe()
    s = InferenceServer(fake, max_batch=1, max_wait_ms=1.0, max_pending=3)
    try:
        futs = [s.submit(GenerateRequest(f"p{i}", num_inference_steps=2)) for i in range(3)]
        with pytest.raises(ServerOverloadedError, match="back off"):
            s.submit(GenerateRequest("overflow", num_inference_steps=2))
        assert s.stats["rejected"] == 1
        fake.release.set()
        assert len([f.result(timeout=WAIT) for f in futs]) == 3
        assert s.submit(GenerateRequest("after", num_inference_steps=2)).result(WAIT)
    finally:
        fake.release.set()
        s.shutdown()


def test_queue_wait_timeout():
    fake = _BlockingPipe()
    s = InferenceServer(fake, max_batch=1, max_wait_ms=1.0)
    try:
        a = s.submit(GenerateRequest("a", num_inference_steps=2))
        t0 = time.monotonic()
        while fake.calls == 0 and time.monotonic() - t0 < WAIT:
            time.sleep(0.005)
        b = s.submit(GenerateRequest("b", num_inference_steps=2, timeout_s=0.05))
        time.sleep(0.15)
        fake.release.set()
        assert a.result(timeout=WAIT)
        with pytest.raises(TimeoutError, match="waited"):
            b.result(timeout=WAIT)
        assert s.stats["timeouts"] == 1
        assert s.submit(GenerateRequest("c", num_inference_steps=2)).result(WAIT)
    finally:
        fake.release.set()
        s.shutdown()


def test_graceful_drain_serves_queued_then_stops():
    s = InferenceServer(_BlockingPipe(delay_s=0.02), max_batch=2, max_wait_ms=1.0)
    futs = [s.submit(GenerateRequest(f"p{i}", num_inference_steps=2)) for i in range(6)]
    s.shutdown(wait=True, drain=True)
    assert len([f.result(timeout=1) for f in futs]) == 6  # resolved already
    with pytest.raises(RuntimeError, match="shut down"):
        s.submit(GenerateRequest("late"))


def test_load_64_concurrent_zero_lost(pipe):
    s = InferenceServer(pipe, max_batch=8, max_wait_ms=30.0, max_pending=128)
    try:
        futs = [s.submit(GenerateRequest(f"prompt {i}", num_inference_steps=2))
                for i in range(64)]
        outs = [f.result(timeout=WAIT) for f in futs]
        assert len(outs) == 64 and all(o["image"].shape == (16, 16, 3) for o in outs)
        assert s.stats["requests"] == 64
        assert s.stats["errors"] == 0 and s.stats["timeouts"] == 0
        assert s.stats["batches"] <= 16
    finally:
        s.shutdown()


class _LazyArray:
    """A host copy (``__array__``) that takes ``readback_s``."""

    def __init__(self, shape, readback_s, log, tag):
        self.shape, self.readback_s, self.log, self.tag = shape, readback_s, log, tag

    def __array__(self, *args, **kw):
        time.sleep(self.readback_s)
        self.log.append(("readback_done", self.tag, time.monotonic()))
        return np.zeros(self.shape, np.float32)


class _OverlapPipe:
    """A fast call and a slow copy to the host; logs both."""

    num_timesteps = 2

    def __init__(self, compute_s=0.05, readback_s=0.3):
        self.compute_s, self.readback_s = compute_s, readback_s
        self.log, self.calls = [], 0

    def __call__(self, prompts, output_type="np", **kw):
        self.calls += 1
        self.log.append(("call", self.calls, time.monotonic()))
        time.sleep(self.compute_s)
        arr = _LazyArray((len(prompts), 4, 4, 3), self.readback_s, self.log, self.calls)
        return (arr if output_type == "device" else np.asarray(arr)), 0.01, None


def _times(log, kind):
    return [t for k, _, t in log if k == kind]


def test_pipelined_worker_overlaps_readback():
    fake = _OverlapPipe(compute_s=0.05, readback_s=0.4)
    s = InferenceServer(fake, max_batch=1, max_wait_ms=1.0, pipeline_depth=2)
    try:
        futs = [s.submit(GenerateRequest(f"p{i}", num_inference_steps=2)) for i in range(3)]
        assert all(f.result(timeout=WAIT)["image"].shape == (4, 4, 3) for f in futs)
        calls, readbacks = _times(fake.log, "call"), _times(fake.log, "readback_done")
        assert len(calls) == 3 and len(readbacks) == 3
        assert calls[1] < readbacks[0], (calls, readbacks)  # batch 2 ran during batch 1's copy
        assert s.stats["batches"] == 3 and s.stats["errors"] == 0
    finally:
        s.shutdown()


def test_pipeline_depth_1_is_serial():
    fake = _OverlapPipe(compute_s=0.01, readback_s=0.2)
    s = InferenceServer(fake, max_batch=1, max_wait_ms=1.0, pipeline_depth=1)
    try:
        futs = [s.submit(GenerateRequest(f"p{i}", num_inference_steps=2)) for i in range(2)]
        [f.result(timeout=WAIT) for f in futs]
        calls, readbacks = _times(fake.log, "call"), _times(fake.log, "readback_done")
        assert calls[1] >= readbacks[0], (calls, readbacks)
    finally:
        s.shutdown()


def test_pipelined_results_match_serial(pipe):
    s1 = InferenceServer(pipe, max_batch=2, max_wait_ms=1.0, pipeline_depth=1)
    s2 = InferenceServer(pipe, max_batch=2, max_wait_ms=1.0, pipeline_depth=3)
    try:
        req = GenerateRequest("a red boat", num_inference_steps=3, seed=11)
        a, b = s1.generate(req, timeout=WAIT), s2.generate(req, timeout=WAIT)
        np.testing.assert_array_equal(a["image"], b["image"])
        assert b["nfe"] == a["nfe"] == 3
    finally:
        s1.shutdown()
        s2.shutdown()


def test_pipelined_drain_resolves_every_future():
    s = InferenceServer(_OverlapPipe(compute_s=0.01, readback_s=0.1), max_batch=1,
                        max_wait_ms=1.0, pipeline_depth=3)
    futs = [s.submit(GenerateRequest(f"p{i}", num_inference_steps=2)) for i in range(5)]
    s.shutdown(wait=True, drain=True)
    outs = [f.result(timeout=1) for f in futs]
    assert len(outs) == 5 and all(o["image"].shape == (4, 4, 3) for o in outs)


def test_serving_sd3_family_end_to_end():
    from sonicdiffusionbayeslab_torch.schedulers import FlowMatchEulerScheduler

    load_all_plugins()
    p3 = models_registry["stable_diffusion_3_model"](pretrained_model="x", tiny=True,
                                                     image_size=64, dtype="float32",
                                                     device="cpu")
    p3.scheduler = FlowMatchEulerScheduler(shift=3.0)
    s = InferenceServer(p3, max_batch=2, max_wait_ms=100.0)
    try:
        futs = [s.submit(GenerateRequest(f"prompt {i}", 2, 4.0)) for i in range(2)]
        assert all(f.result(timeout=WAIT)["image"].shape == (16, 16, 3) for f in futs)
        a = s.generate(GenerateRequest("same", 2, seed=7), timeout=WAIT)
        b = s.generate(GenerateRequest("same", 2, seed=7), timeout=WAIT)
        np.testing.assert_array_equal(a["image"], b["image"])
    finally:
        s.shutdown()


def _http(url, data=None):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return json.loads(r.read())


def _start(serve, pipe, name, **kw):
    ready = threading.Event()
    th = threading.Thread(target=serve, args=(pipe, name),
                          kwargs=dict(host="127.0.0.1", port=0, ready_event=ready, **kw),
                          daemon=True)
    th.start()
    assert ready.wait(timeout=WAIT)
    return ready, th, f"http://127.0.0.1:{ready.httpd.server_address[1]}"


def _stop(ready, th):
    ready.httpd.shutdown()
    ready.inference.shutdown(wait=False)
    th.join(timeout=WAIT)


def test_http_server_end_to_end(pipe):
    ready, th, base = _start(server_mod.serve, pipe, "stable_diffusion_model", max_batch=2,
                             max_wait_ms=50.0)
    try:
        health = _http(f"{base}/healthz")
        assert health == {"ok": True, "devices": server_mod.device_count(),
                          "model": "stable_diffusion_model"}
        out = _http(f"{base}/generate", json.dumps({"prompt": "a cat", "steps": 2,
                                                    "guidance": 5.0, "seed": 4}).encode())
        assert out["nfe"] == 2
        png = base64.b64decode(out["image_png_base64"])
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        direct, _, _ = pipe(["a cat", ""], num_inference_steps=2, guidance_scale=5.0,
                            negative_prompt=["", ""], sample_indices=[9, 0], seed=0)
        assert png == encode_png_bytes(direct[0])
        assert _http(f"{base}/metrics")["images"] >= 1
        with pytest.raises(urllib.error.HTTPError) as e:
            _http(f"{base}/generate", b"{}")
        assert e.value.code == 400
    finally:
        _stop(ready, th)


def test_http_json_keys_equal_jax():
    """/healthz, /metrics and /generate answer with the JAX server's keys."""
    from sonicdiffusionbayeslab_tpu.serving import server as jax_server

    keys = {}
    for name, serve in (("port", server_mod.serve), ("jax", jax_server.serve)):
        ready, th, base = _start(serve, _RecordingPipe(), "m", max_batch=2, max_wait_ms=1.0)
        try:
            keys[name] = [sorted(_http(f"{base}/healthz")),
                          sorted(_http(f"{base}/generate", b'{"prompt": "a", "steps": 3}')),
                          sorted(_http(f"{base}/metrics"))]
        finally:
            _stop(ready, th)
    assert keys["port"] == keys["jax"]


def _config(tmp_path, **sections):
    text = "\n".join([
        "experiment_name: serve", "experiment:", "  method: tome", "  seed: 1",
        "model:", "  model_name: stable_diffusion_model", "  pretrained_model: x",
        "  tiny: true", "  image_size: 64", "  dtype: float32",
        "scheduler:", "  scheduler_name: dpm_solver_scheduler",
        "dataset:", "  img_dataset: .", "  prompts: .", "  image_size: 64",
        "logger:", "  wandb_enable: False", "  save: False", "  save_dir: .",
        *(f"{k}:\n" + "\n".join(f"  {a}: {b}" for a, b in v.items())
          for k, v in sections.items())])
    p = tmp_path / "serve.yaml"
    p.write_text(text + "\n")
    return str(p)


def test_serve_main_applies_acceleration_knobs(tmp_path, monkeypatch):
    """``main`` serves the stack the config benchmarks: inference.quant and
    unet_microbatch, experiment_params.tome_ratio, the scheduler's
    arguments and a scalar cache_interval; ``--device`` reaches the
    pipeline."""
    path = _config(tmp_path, inference={"batch_size": 4, "quant": "int8_conv_only",
                                        "unet_microbatch": 2},
                   experiment_params={"tome_ratio": 0.5, "solver_order": 1,
                                      "cache_interval": 3, "cache_branch_id": 1})
    captured = {}
    monkeypatch.setattr(server_mod, "serve",
                        lambda pipe, name, *a, **kw: captured.update(pipe=pipe, name=name, a=a))
    server_mod.main(["--config", path, "--device", "cpu", "--port", "0", "--max_batch", "3"])
    p = captured["pipe"]
    assert captured["name"] == "stable_diffusion_model" and captured["a"][1:3] == (0, 3)
    assert p.engine.unet.quant_mode == "int8_conv_only" and p.device.type == "cpu"
    assert p.unet_microbatch == 2 and p.tome_ratio == 0.5
    assert p.scheduler.solver_order == 1
    plan = p.cache_plan_fn(6)
    assert plan.full.tolist() == [True, False, False, True, False, False] and plan.branch == 1


def test_serve_main_refuses_a_cache_sweep_and_meshes(tmp_path):
    path = _config(tmp_path, inference={"batch_size": 4},
                   experiment_params={"cache_interval": "[2, 3, 5]"})
    with pytest.raises(SystemExit, match="scalar"):
        server_mod.main(["--config", path, "--device", "cpu"])
    # Two ranks of any mesh axis need a process group of two (torchrun's);
    # the seq and model axes run (tests/test_torch_tensor_parallel.py).
    (tmp_path / "plain").mkdir()
    plain = _config(tmp_path / "plain", inference={"batch_size": 4})
    for axis, mesh in (("--mesh_seq", "1x2x1"), ("--mesh_model", "1x1x2")):
        with pytest.raises(ValueError, match=f"mesh {mesh} != 1 processes"):
            server_mod.main(["--config", plain, "--device", "cpu", axis, "2"])
    with pytest.raises(ValueError, match="mesh 2x1x1 != 1 processes"):
        server_mod.main(["--config", plain, "--device", "cpu", "--mesh_data", "2"])


def test_serve_bench_tiny_json_line(capsys):
    rec = serve_bench.main(["hero", "--tiny", "--device", "cpu", "--requests", "4"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "serve_hero" and line["requests"] == 4 and line["max_batch"] == 4
    assert line["value"] > 0 and line["steps"] == 3 and line["pipeline_depth"] == 2
    assert rec["batches"] == line["batches"] >= 2
