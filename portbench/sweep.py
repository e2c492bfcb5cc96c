"""The sweep that fixes a serving cell's offered rate: one server in one
process, an open-loop window at each of ``--rates`` (requests/s), one JSON
line a rate (served rate, p50 and p95 from due times, batch fill, the
first and last tenth's median latency: a backlog that grows shows as the
last tenth's above the first's).

    python3 -m portbench.sweep --workload sd15-serve-mb8 --seed 7 --seconds 30 \\
        --rates 6 7 8 9 10 11
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import run as harness
from portbench.traffic import serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    spec = harness.cell_spec(args.workload)
    for row in serve.sweep(spec, args.seed, args.rates, args.seconds):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
