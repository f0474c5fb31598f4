"""Reduction of a ``torch.profiler`` chrome trace to what the per-layer
metrics read.

Device operations (``kernel``, ``gpu_memcpy``, ``gpu_memset`` events) are
tied to the host span that launched them through the runtime call's
``correlation`` id, so a span's device time counts the work it launched
even where the device ran it later.  The traced window is the host span
:data:`WINDOW`, which the benchmark opens around the traced pass.
"""

from __future__ import annotations

import bisect
import json
import os

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def _union(intervals: list) -> float:
    total, reach = 0.0, float("-inf")
    for a, z in sorted(intervals):
        if z > reach:
            total += z - max(a, reach)
            reach = z
    return total


def summarize(path: str, top: int = 10) -> dict:
    """Read (and delete) the trace at ``path``; times in seconds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.unlink(path)
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and "dur" in e]
    window = [(a, z) for name, a, z in spans if name == WINDOW]
    if len(window) != 1:
        raise ValueError(f"trace: {len(window)} '{WINDOW}' spans")
    w0, w1 = window[0]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {})}
    device = [(e["ts"], e["ts"] + e["dur"], e["name"], launch.get(e.get("args", {}).get("correlation")))
              for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    device = [d for d in device if d[1] > w0 and d[0] < w1]
    clipped = [(max(a, w0), min(z, w1)) for a, z, _, _ in device]
    busy = _union(clipped)

    span_busy = {}
    for name in sorted({n for n, _, _ in spans if n != WINDOW}):
        ivals = sorted((a, z) for n, a, z in spans if n == name)
        starts = [a for a, _ in ivals]
        inside = []
        for a, z, _, t in device:
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ivals[i][0] <= t < ivals[i][1]:
                inside.append((a, z))
        span_busy[name] = {"device_s": _union(inside) / 1e6,
                           "wall_s": sum(z - a for a, z in ivals) / 1e6, "count": len(ivals)}

    by_name = {}
    for a, z, name, _ in device:
        s, n = by_name.get(name, (0.0, 0))
        by_name[name] = (s + (z - a) / 1e6, n + 1)

    # idle gaps between the merged device intervals, named by the innermost
    # host span open where each gap starts
    merged = []
    for a, z in sorted(clipped):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], z)
        else:
            merged.append([a, z])
    edges = [w0] + [x for seg in merged for x in seg] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    inner = sorted(((a, z, n) for n, a, z in spans if n != WINDOW), key=lambda s: s[1] - s[0])

    def host_span(t):
        return next((n for a, z, n in inner if a <= t < z), "outside any span")

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy / 1e6,
        "spans": span_busy,
        "ops": {name: {"seconds": s, "count": n} for name, (s, n) in by_name.items()},
        "device_ops": [[name.removeprefix("void ")[:120], s] for name, (s, _) in
                       sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]],
        "idle_gaps": [[host_span(a), (z - a) / 1e6] for a, z in gaps[:top]],
    }


def kernel_time(summary: dict, pattern: str) -> tuple[float, int]:
    """(device seconds, launches) of the device operations whose name holds
    ``pattern``."""
    hits = [v for name, v in summary["ops"].items() if pattern in name]
    return sum(v["seconds"] for v in hits), sum(v["count"] for v in hits)
