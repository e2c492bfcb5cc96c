"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is ``portbench/workloads/<cell>.json``
(its configuration, traffic mix and chips); the configuration is
``portbench/configs/<config>.json``, the mix ``portbench/traffic/<mix>.json``,
whose ``kind`` names the driver ``portbench/traffic/<kind>.py``; each
per-layer metric is read by ``portbench/metrics/<metric>.py``.  Which
metrics a cell prints comes from ``BENCHMARK.json``.  With ``--trace 0``
the line holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones, read from a ``torch.profiler`` trace of the window and
the harness's own spans and counters.

The last lines on standard error, and the result's last key ``checks``,
give each number that decides ``correct`` beside its limit.  The run
exits with a code other than 0, and prints no result, without enough
CUDA devices, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # the set-up time counts from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent  # portbench/
CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sonicdiffusionbayeslab_tpu")
# Kernel and build caches at fixed paths inside the checkout.
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton_cache",
              "CUDA_CACHE_PATH": "build/cuda_cache"}


class NoDevice(RuntimeError):
    """Fewer CUDA devices than the cell asks for."""


def load_json(path: Path) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file under ``portbench/`` (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(workload: str, benchmark: Optional[Dict] = None) -> Dict:
    """The cell's workload, configuration and traffic mix, and the
    metrics ``BENCHMARK.json`` gives it (end-to-end and per-layer names)."""
    cell = load_json(ROOT / "workloads" / f"{workload}.json")
    if benchmark is None:
        benchmark = load_json(CHECKOUT / "BENCHMARK.json")

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"name": workload, "cell": cell,
            "config": load_json(ROOT / "configs" / f"{cell['config']}.json"),
            "mix": load_json(ROOT / "traffic" / f"{cell['traffic']}.json"),
            "end_to_end": [m for m in benchmark["end_to_end"] if applies(m)],
            "per_layer": [m for m in benchmark["per_layer"] if applies(m)]}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(spec: Dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = None) -> Dict:
    """Drive the cell once and return its result line (a dict).  ``device``
    "cpu" is for the tests, which drive a tiny configuration with no card."""
    import torch

    chips = int(spec["cell"]["chips"])
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoDevice(f"the cell needs {chips} CUDA device(s); torch sees "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    driver = importlib.import_module(f"portbench.traffic.{spec['mix']['kind']}")
    out = driver.run(spec, seed=seed, seconds=seconds, trace=trace, device=device,
                     t_start=T_START if t_start is None else t_start)
    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            reader = load_module(ROOT / "metrics" / f"{m['name']}.py",
                                 f"portbench_metric_{m['name']}")
            value = reader.read(out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out["end_to_end"][m["name"]]), "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    checks = out["checks"]
    result = {"correct": all(c["ok"] for c in checks), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics}
    if device == "cuda":
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": chips, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    rec = out["record"]
    if trace and rec.trace is not None:
        result["device"].update(busy_s=rec.trace.busy_s(), window_s=rec.trace.window_s)
        result["breakdown"] = {"device_ops": rec.trace.device_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(CHECKOUT / rel)
    spec = cell_spec(args.workload)
    try:
        result = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    except NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; nothing it runs may import JAX "
              "or the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
