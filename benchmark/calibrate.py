"""Readings that set the limits of a cell's checks, all in one process:

- ``program``: the numbers a run compares, read from the program on each
  seed (training: its first steps; serving: a short window at the cell's
  load, the same number of requests compared as a run compares);
- ``control``: the reference put in the program's place, in the nearest
  precision below the configuration's (training: TF32, every operand of its
  matrix products and convolutions rounded to TF32; serving: bfloat16);
- ``half_batch`` (training): the reference in the program's place with
  half of the image's rows left out of the loss, the mean over the rest.

    python3 benchmark/calibrate.py --workload mipnerf360_train \\
        --seeds 11,12,13 --control-seeds 21,22,23 [--seconds 4]

Prints one JSON line per seed and side. Needs a CUDA card. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark import harness, reference as R  # noqa: E402
from benchmark.traffic import serve as SV, train as TR  # noqa: E402


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def train_readings(cell, seed: int, sides, device) -> dict:
    TR.set_precision(False)
    state = TR.build(cell, seed, device)
    steps = cell.mix["checked_steps"]
    got = {}
    if "program" in sides:
        trainer, views = TR.make_trainer(cell, state)
        got["program"] = TR.program_steps(trainer, views, state["targets"], state["start"], steps)
        del trainer
        free()
    if "control" in sides:
        got["control"] = TR.reference_steps(cell, state, steps, tf32=True)
    if "half_batch" in sides:
        rows = slice(0, cell.config["height"] // 2)
        got["half_batch"] = TR.reference_steps(cell, state, steps, loss_rows=rows)
    want = TR.reference_steps(cell, state, steps)
    return {side: TR.compare(g, want) for side, g in got.items()}


def serve_readings(cell, seed: int, sides, device, seconds: float) -> dict:
    state = SV.build(cell, seed, device)
    server = SV.make_server(cell, state)
    SV.warm_up(server, cell.mix["views"])
    got = SV.window(server, state["plan"], seconds, cell.mix["checked_requests"], state["rng"],
                    device, False)
    del server
    SV.release_program()
    out = {}
    if "program" in sides:
        out["program"] = SV.check(cell, state, got["kept"])[0]
    if "control" in sides:
        worst = {}
        for n, _ in got["kept"]:
            for i in state["plan"][n % len(state["plan"])]:
                low = SV.as_output(R.render(state["params"], state["pool"][i],
                                            dtype=torch.bfloat16))
                want = R.render(state["params"], state["pool"][i])
                for k, x in SV.compare_view(low, 0, want).items():
                    worst[k] = max(worst.get(k, 0.0), x)
        out["control"] = worst
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)
    device = torch.device("cuda", 0)
    kind = cell.mix["driver"]
    faults = ("control", "half_batch") if kind == "train" else ("program", "control")
    plan = [(int(s), ("program",)) for s in args.seeds.split(",") if s]
    plan += [(int(s), faults) for s in args.control_seeds.split(",") if s]
    for seed, sides in plan:
        start = time.perf_counter()
        if kind == "train":
            readings = train_readings(cell, seed, sides, device)
        else:
            readings = serve_readings(cell, seed, sides, device, args.seconds)
        for side, numbers in readings.items():
            print(json.dumps(dict(workload=cell.name, seed=seed, side=side, numbers=numbers,
                                  seconds=time.perf_counter() - start)), flush=True)
        free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
