"""Experiment CLI of the port:

    python -m sonicdiffusionbayeslab_torch.cli --config configs/smoke.yaml
    python -m sonicdiffusionbayeslab_torch.cli --config configs/smoke.yaml --device cpu \\
        --set dataset.max_count=2 --set experiment_params.num_inference_steps=[4]

Counterpart of ``sonicdiffusionbayeslab_tpu/cli.py``: loads the YAML (a bare
name resolves under ./configs), applies the ``--set`` overrides, seeds numpy
and torch, builds the registered method and runs its sweep, then prints the
run directory and the metric table.  The model and the metrics run on CUDA
unless ``--device`` (or ``model.device`` in the config) names another
device; without a GPU the default raises.

On N ranks (one process a GPU), with the batches sampled data-parallel:

    torchrun --nproc_per_node N -m sonicdiffusionbayeslab_torch.cli \
        --config configs/smoke.yaml --set model.mesh_data=N

or with the UNet split over the ranks (tensor parallel over ``model``,
the latent height over ``seq``; the product of the mesh's axes is N):

    torchrun --nproc_per_node 2 -m sonicdiffusionbayeslab_torch.cli \
        --config configs/smoke.yaml --set model.mesh_model=2

``run`` starts the process group first (``parallel.initialize``: NCCL on
CUDA, gloo with ``--device cpu``); every rank runs the sweep, rank 0
writes the run directory and every rank prints the same metric lines.
"""

from __future__ import annotations

import argparse

from sonicdiffusionbayeslab_torch.config import load_config, parse_value
from sonicdiffusionbayeslab_torch.parallel.distributed import initialize
from sonicdiffusionbayeslab_torch.registry import load_all_plugins, methods_registry
from sonicdiffusionbayeslab_torch.utils.rng import setup_seed


def _parse_sets(pairs):
    """``--set a.b=v`` strings -> {dotted: value read as YAML}; an empty key
    or value is refused."""
    out = {}
    for p in pairs or ():
        key, sep, val = p.partition("=")
        if not sep or not key or not val.strip():
            raise SystemExit(f"--set expects key=value with a non-empty value, got {p!r}")
        out[key] = parse_value(val, f"--set {key}")
    return out


def run(config_path: str, overrides=None, device=None):
    """Run the config's sweep; ``device`` (e.g. "cpu") sets ``model.device``.
    Returns the metric table {column: values}."""
    initialize(device=device)
    load_all_plugins()
    overrides = dict(overrides or {})
    if device is not None:
        overrides["model.device"] = str(device)
    config = load_config(config_path, overrides)
    setup_seed(config.experiment.get("seed", 29))
    method = methods_registry[config.experiment.method](config)
    metrics = method.run_experiment()
    method.logger.finish()
    print(f"run dir: {method.logger.local.dir}")
    for k, v in metrics.items():
        print(f"{k}: {v}")
    return metrics


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="SonicDiffusionBayesLab experiment runner "
                                                 "(PyTorch/CUDA)")
    parser.add_argument("--config", "--config_file", dest="config", required=True,
                        help="YAML config path (bare names resolve under ./configs)")
    parser.add_argument("--set", dest="sets", action="append", metavar="KEY=VALUE",
                        help="override a config key by dotted path, e.g. "
                             "--set dataset.max_count=32 (repeatable; value is YAML)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu: where the model and metrics run")
    args = parser.parse_args(argv)
    run(args.config, _parse_sets(args.sets), device=args.device)


if __name__ == "__main__":
    main()
