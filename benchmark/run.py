"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix and
limits are found by name (``benchmark/configs``, ``benchmark/workloads``,
``benchmark/limits``); the mix names its driver, ``benchmark/traffic/<driver>.py``,
whose ``run(ctx)`` builds the system under test from the seed, warms up,
measures for ``--seconds``, closes the window, then checks what the timed
path produced against the plain reference (``benchmark/reference.py``).
With ``--trace 0`` the line carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, each read by
``benchmark/metrics/<metric>.py`` from a profiled sub-window.

It exits non-zero and prints no result without enough CUDA cards, or where
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    started = harness.process_start()
    args = parse(argv)
    for key, path in harness.CACHE_ENV.items():
        os.environ[key] = str(path)
    cell = harness.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"refused: {cell.name} needs {cell.chips} CUDA card(s); "
                    f"available={torch.cuda.is_available()}, "
                    f"count={torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    driver = importlib.import_module(f"benchmark.traffic.{cell.mix['driver']}")
    ctx = dict(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
               started=started, device=torch.device("cuda", 0))
    result, checks = driver.run(ctx)
    return harness.finish(result, checks)


if __name__ == "__main__":
    sys.exit(main())
