"""The median over requests of a request's latency less its device time
(CUDA events recorded on the stream before and after the call)."""

import statistics


def read(run):
    gaps = run.get("host_overhead_ms")
    return statistics.median(gaps) if gaps else None
