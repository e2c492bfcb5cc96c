"""HTTP front end of the micro-batching server, on the standard library.

    python -m sonicdiffusionbayeslab_torch.serving.server --config configs/dpm_solver_config.yaml
    python -m sonicdiffusionbayeslab_torch.serving.server --config configs/smoke.yaml \\
        --device cpu --port 0

Counterpart of ``sonicdiffusionbayeslab_tpu/serving/server.py``.  Endpoints:
  GET  /healthz  -> {"ok": true, "devices": N, "model": "..."}
  GET  /metrics  -> the batcher's counters (requests, images, batches, ...)
  POST /generate -> {"prompt": "...", "steps": 20, "guidance": 7.5,
                     "negative_prompt": "", "seed": null, "height", "width"}
                 -> {"image_png_base64": "...", "execution_time": s,
                     "batch_size": n, "nfe": k}

The handler threads only marshal JSON, and all compute goes through the
batcher's single worker, so requests coalesce into full batches.  ``--port
0`` takes a free port (printed).  ``--mesh_data N`` serves one pipeline
data-parallel over N ranks (one process a GPU):

    torchrun --nproc_per_node N -m sonicdiffusionbayeslab_torch.serving.server \
        --config configs/dpm_solver_config.yaml --mesh_data N

Rank 0 owns the HTTP front end and the batcher; the other ranks follow
its pipeline calls (``serving/batcher.py::follow``) until it shuts down.
``--mesh_seq`` and ``--mesh_model`` above 1 raise (ROADMAP.md item A9).
"""

from __future__ import annotations

import argparse
import base64
import inspect
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from sonicdiffusionbayeslab_torch.data.imageio import encode_png_bytes
from sonicdiffusionbayeslab_torch.parallel import distributed
from sonicdiffusionbayeslab_torch.parallel.distributed import initialize
from sonicdiffusionbayeslab_torch.parallel.mesh import check_data_only
from sonicdiffusionbayeslab_torch.serving.batcher import GenerateRequest, InferenceServer, follow


def _png_b64(image: np.ndarray) -> str:
    return base64.b64encode(encode_png_bytes(image)).decode("ascii")


def device_count() -> int:
    """The devices the server runs on: the world size of a multi-process
    server, else this process's CUDA devices, or 1 (the CPU) without any."""
    if distributed.is_initialized():
        return distributed.world_size()
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def make_handler(server: InferenceServer, model_name: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True, "devices": device_count(), "model": model_name})
            elif self.path == "/metrics":
                s = dict(server.stats)
                s["mean_batch_seconds"] = s["batch_seconds"] / s["batches"] if s["batches"] else 0.0
                self._send(200, s)
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                seed = req.get("seed")
                if seed is not None:
                    seed = int(seed)
                g = GenerateRequest(
                    prompt=str(req["prompt"]),
                    num_inference_steps=int(req.get("steps", 20)),
                    guidance_scale=float(req.get("guidance", 7.5)),
                    negative_prompt=str(req.get("negative_prompt", "")),
                    seed=seed,
                    height=int(req["height"]) if req.get("height") else None,
                    width=int(req["width"]) if req.get("width") else None,
                )
                fut = server.submit(g)  # submit validates: its errors are 400s
            except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            try:
                out = fut.result(timeout=600)
            except Exception as e:  # the pipeline's errors
                self._send(500, {"error": str(e)})
                return
            self._send(200, {
                "image_png_base64": _png_b64(out["image"]),
                "execution_time": out["execution_time"],
                "batch_size": out["batch_size"],
                "nfe": out["nfe"],
            })

    return Handler


def serve(pipe, model_name: str, host: str = "127.0.0.1", port: int = 8000,
          max_batch: int = 8, max_wait_ms: float = 25.0, pipeline_depth: int = 2,
          ready_event: Optional[threading.Event] = None):
    """Serve until ``httpd.shutdown()``; ``ready_event`` (for callers that
    run it in a thread) gets ``httpd`` and ``inference`` attributes and is
    set once the socket listens."""
    inference = InferenceServer(pipe, max_batch=max_batch, max_wait_ms=max_wait_ms,
                                pipeline_depth=pipeline_depth)
    httpd = ThreadingHTTPServer((host, port), make_handler(inference, model_name))
    bound_host, bound_port = httpd.server_address[:2]
    print(f"serving {model_name} on http://{bound_host}:{bound_port}", flush=True)
    if ready_event is not None:
        ready_event.httpd = httpd  # type: ignore[attr-defined]
        ready_event.inference = inference  # type: ignore[attr-defined]
        ready_event.set()
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        # A data-parallel server waits for its worker, whose stop releases
        # the followers.
        inference.shutdown(wait=distributed.world_size() > 1)


def build_pipe(cfg, device=None, mesh_data: int = 0):
    """The pipeline a config serves: the model section (``image_size``
    from the dataset's where unset), the scheduler with its arguments from
    ``experiment_params``, and the acceleration knobs the experiment path
    reads: ``inference.quant``, ``inference.unet_microbatch``,
    ``experiment_params.tome_ratio`` and a scalar
    ``experiment_params.cache_interval`` (with ``cache_branch_id``);
    ``mesh_data`` > 1 overrides the model section's.  Returns (pipeline,
    model name)."""
    from sonicdiffusionbayeslab_torch.models.sampler import CachePlan
    from sonicdiffusionbayeslab_torch.ops.quant import check_mode
    from sonicdiffusionbayeslab_torch.registry import models_registry, schedulers_registry

    mcfg = dict(cfg.model)
    name = mcfg.pop("model_name")
    if int(mesh_data) > 1:
        mcfg["mesh_data"] = int(mesh_data)
    mcfg.setdefault("image_size", cfg.dataset.get("image_size", 512))
    ep = dict(cfg.get("experiment_params", {}) or {})
    ci = ep.get("cache_interval")
    if isinstance(ci, (list, tuple)):
        raise SystemExit("serving needs a scalar experiment_params.cache_interval (one "
                         f"operating point), got sweep {ci!r}")
    inf = dict(cfg.get("inference", {}) or {})
    quant = check_mode(str(inf["quant"]).lower() or None) if inf.get("quant") is not None else None
    models_registry.validate_kwargs(name, mcfg, allow_missing=True)
    pipe = models_registry[name](**mcfg, device=device)
    sname = cfg.get("scheduler", {}).get("scheduler_name", "dpm_solver_scheduler")
    # Scheduler arguments come from experiment_params as on the experiment
    # path: an SD-2.1 v-prediction config served with epsilon rows would
    # give noise.
    accepted = set(inspect.signature(schedulers_registry[sname].__init__).parameters)
    skw = {k: v for k, v in ep.items() if k in accepted}
    pipe.scheduler = schedulers_registry[sname](**skw)
    if skw:
        print(f"scheduler kwargs from experiment_params: {skw}")
    if quant is not None:
        pipe.engine.set_quant_mode(quant)
        print(f"quant mode: {quant}")
    if inf.get("unet_microbatch") is not None:
        pipe.unet_microbatch = int(inf["unet_microbatch"])
    if ep.get("tome_ratio") is not None:
        pipe.tome_ratio = float(ep["tome_ratio"])
        print(f"token merging: ratio {pipe.tome_ratio}")
    if ci is not None:
        interval, branch = int(ci), int(ep.get("cache_branch_id", 0))
        pipe.cache_plan_fn = lambda n: CachePlan.every(n, interval, branch)
        print(f"deep cache: interval {interval}, branch {branch}")
    return pipe, name


def main(argv=None) -> None:
    from sonicdiffusionbayeslab_torch.config import load_config
    from sonicdiffusionbayeslab_torch.registry import load_all_plugins

    parser = argparse.ArgumentParser(description="SonicDiffusionBayesLab PyTorch server")
    parser.add_argument("--config", required=True,
                        help="experiment YAML: its model and scheduler sections are used")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000, help="0 takes a free port")
    parser.add_argument("--max_batch", type=int, default=8)
    parser.add_argument("--max_wait_ms", type=float, default=25.0)
    parser.add_argument("--pipeline_depth", type=int, default=2,
                        help="overlapped batches: the worker runs batch N+1 while batch N's "
                             "copy to the host finishes (1 = serial)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--mesh_data", type=int, default=0,
                        help="data-parallel ranks (started by torchrun, one a GPU); 0 or 1: "
                             "one process")
    parser.add_argument("--mesh_seq", type=int, default=1,
                        help="above 1 is not ported (ROADMAP.md A9)")
    parser.add_argument("--mesh_model", type=int, default=1,
                        help="above 1 is not ported (ROADMAP.md A9)")
    args = parser.parse_args(argv)
    check_data_only(args.mesh_seq, args.mesh_model, "the server")
    if args.mesh_data > 1:
        initialize(device=args.device)
    load_all_plugins()
    cfg = load_config(args.config)
    pipe, name = build_pipe(cfg, args.device, args.mesh_data)
    if distributed.rank() != 0:
        follow(pipe)
        return
    serve(pipe, name, args.host, args.port, args.max_batch, args.max_wait_ms,
          args.pipeline_depth)


if __name__ == "__main__":
    main()
