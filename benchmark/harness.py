"""What every cell's run shares: the cell's files found by name, the
device record, the traced sub-window and its reduction, the checks and the
result line."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH_DIR = ROOT / "benchmark"
#: Top-level modules that may not be loaded in a run: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "gausplat_tpu")
#: Where the program's kernel caches go: fixed folders inside the checkout.
CACHE_ENV = {"TRITON_CACHE_DIR": ROOT / "build" / "triton"}


def process_start() -> float:
    """This process's start on the epoch clock, from /proc (the time of
    this module's import where /proc cannot say)."""
    try:
        stat = pathlib.Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        boot = next(int(line.split()[1]) for line in
                    pathlib.Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with its files: the configuration
    (``configs/<config>.json``), the traffic mix (``workloads/<traffic>.json``,
    whose ``driver`` names ``traffic/<driver>.py``) and the limits of its
    checks (``limits/<name>.json``); ``end_to_end`` / ``per_layer``: the
    metric entries this cell reports."""

    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def find_cell(name: str, bench_path: pathlib.Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = load_json(bench_path)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in {bench_path.name}")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    # A metric without ``workloads``: an end-to-end one is every cell's, a
    # per-layer one that of every cell that reports the metric it moves.
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name=name, chips=entry["chips"], config=load_json(ROOT / config["file"]),
                mix=load_json(BENCH_DIR / "workloads" / f"{entry['traffic']}.json"),
                limits=load_json(BENCH_DIR / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def nvidia_smi(query: str) -> str:
    try:
        done = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return done.stdout.strip().splitlines()[0] if done.stdout.strip() else done.stderr.strip()


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def log_timeline(marks: list) -> None:
    """A window's marks on standard error, one ``a:b:...`` tuple each
    (seconds into the window first), so that the rate and the tail of any
    leading part of a run's window can be read back from its log."""
    log("timeline:", " ".join(":".join(f"{x:.4f}" if isinstance(x, float) else str(x)
                                       for x in mark) for mark in marks))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def percentile(values: list, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation."""
    s = sorted(values)
    k = (len(s) - 1) * q / 100.0
    lo = math.floor(k)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (k - lo)


# --- the traced sub-window ------------------------------------------------------------

#: The port's kernel wrappers' device kernels, by the names the profiler
#: gives them, and the wrappers whose launch counters count them.
PORT_KERNELS = {
    "rasterize_forward_kernel": ("gausplat_tpu_torch.ops.rasterize", "RASTERIZE_FORWARD"),
    "rasterize_backward_kernel": ("gausplat_tpu_torch.ops.rasterize", "RASTERIZE_BACKWARD"),
    "expand_slots": ("gausplat_tpu_torch.ops.expand", "EXPAND"),
}


def port_counters() -> dict:
    """The port's launch counters (replays included), by device kernel."""
    import importlib

    return {name: getattr(importlib.import_module(mod), attr).launches
            for name, (mod, attr) in PORT_KERNELS.items()}


@dataclasses.dataclass
class Trace:
    """A profiled sub-window of ``units`` steps or requests: every device
    operation ``(name, start_us, end_us)``, the host's ops, the window's
    bounds, the port's launch counts over it."""

    units: int
    device_ops: list
    host_ops: list
    start_us: float
    end_us: float
    counted: dict

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self) -> list:
        spans = sorted((max(s, self.start_us), min(e, self.end_us))
                       for _, s, e in self.device_ops if e > self.start_us and s < self.end_us)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def records(self, match) -> list:
        return [e - s for name, s, e in self.device_ops if match(name)]

    def kernel_ms_per_unit(self, match, counted: int | None = None) -> float | None:
        """Device ms a unit of the operations whose names ``match``: the
        mean over the records held times ``counted`` launches where the
        port's counter gives them (the profiler drops records), else the
        records' sum. None where no record matched."""
        held = self.records(match)
        if not held:
            return None
        total_us = sum(held) / len(held) * counted if counted else sum(held)
        return total_us / 1e3 / self.units

    def port_kernel_ms(self, name: str) -> float | None:
        return self.kernel_ms_per_unit(lambda k: name in k, self.counted.get(name))

    def breakdown(self, top: int = 10) -> dict:
        totals = {}
        for name, s, e in self.device_ops:
            totals[name[:120]] = totals.get(name[:120], 0.0) + (e - s) / 1e6
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        merged = self.busy_intervals()
        gaps, last = [], self.start_us
        for s, e in merged + [[self.end_us, self.end_us]]:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        named = []
        for s, e in gaps:
            mid = (s + e) / 2
            covering = [(he - hs, name) for name, hs, he in self.host_ops if hs <= mid <= he]
            named.append([min(covering)[1][:120] if covering else "no host op", (e - s) / 1e6])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


def profile_units(unit, seconds: float, sync) -> Trace:
    """Run ``unit()`` under ``torch.profiler`` for about ``seconds``, each in
    a ``bench.unit`` span inside one ``bench.window`` span; ``sync()`` waits
    for the device at the end. ``unit()`` returns the units it did (a
    request's views), or None for one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    before = port_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            start, units, calls = time.perf_counter(), 0, 0
            while calls == 0 or time.perf_counter() - start < seconds:
                calls += 1
                with record_function("bench.unit"):
                    done = unit()
                units += 1 if done is None else done
            sync()
    counted = {k: n - before[k] for k, n in port_counters().items()}
    device_ops, host_ops, window = [], [], None
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            # The benchmark's own spans also show on the device's timeline.
            if not ev.name.startswith("bench."):
                device_ops.append((ev.name, s, e))
        else:
            host_ops.append((ev.name, s, e))
            if ev.name == "bench.window":
                window = (s, e)
    if window is None:
        raise RuntimeError("the profiler kept no bench.window span")
    return Trace(units, device_ops, host_ops, window[0], window[1], counted)


def end_to_end(cell: Cell, **measured) -> dict:
    """The cell's end-to-end metrics out of those its driver ``measured``."""
    return {m["name"]: {"value": float(measured[m["name"]]), "unit": m["unit"]}
            for m in cell.end_to_end}


def reader_path(name: str) -> pathlib.Path:
    """A metric's reader: ``benchmark/metrics/<name>.py``, else the one of
    the name before its first dot (``idle_share.py`` reads every
    ``idle_share.<cell kind>``)."""
    own = BENCH_DIR / "metrics" / f"{name}.py"
    return own if own.is_file() else BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py"


def read_metrics(metrics: list, run: dict) -> dict:
    """Each metric's reader's ``read(run)``; a metric whose reader finds
    nothing is left out."""
    import importlib.util

    out = {}
    for i, m in enumerate(metrics):
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{i}",
                                                      reader_path(m["name"]))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        value = module.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# --- checks and the result line ------------------------------------------------------------


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number against its limit: correct where every one is finite and
    at most its limit, and no limit is missing."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = limit is not None and value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok and bool(numbers), checks


def sync(device) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on a CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def device_record(device, peak: int, trace: Trace | None = None) -> dict:
    """The result line's ``device``. A CPU dry run (tests only: ``run.py``
    refuses without a card) says so in ``platform``."""
    import torch

    cuda = device.type == "cuda"
    record = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": 1,
              "memory_peak_bytes": int(peak)}
    if trace is not None:
        record.update(busy_s=trace.busy_s, window_s=trace.window_s)
    return record


def finish(result: dict, checks: dict) -> int:
    """Print the checks on standard error and the result line last on
    standard output; refuse (exit 3, no line) where JAX or the JAX package
    was loaded."""
    bad = forbidden_modules()
    if bad:
        log(f"refused: modules loaded in this process: {bad}")
        return 3
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps({**result, "checks": checks}), flush=True)
    return 0
