"""Runs one cell once and prints its result line.

Everything that belongs to one configuration, cell, traffic mix or
per-layer metric is a file of its own, found by its name:

* ``configs/<config>.json``: the configuration as it is run (the
  program's config under ``program``, the builder under ``model``, the
  plain reference under ``reference``, the FLOP count under ``flops``);
* ``workloads/<cell>.json``: the configuration, the mix, the chips, the
  entry the window drives (``entries/<entry>.py``) and the limits that
  decide ``correct``;
* ``traffic/<mix>.json``: the mix's parameters, read by ``traffic.py``;
* ``metrics/<metric>.py``: one reader per per-layer metric, ``read(record)
  -> float | None`` (None: nothing to read, the metric is left out).

``BENCHMARK.json`` at the root says which metrics a cell reports.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mraudio_tpu", "bench")


@dataclasses.dataclass
class Ctx:
    cell: dict
    config: dict
    mix: dict
    seed: int
    trace: bool
    device: object
    t0: float
    scratch: str

    def reference_module(self):
        return importlib.import_module(f"portbench.reference.{self.config['reference']}")


def load(root: Path, kind: str, name: str) -> dict:
    path = root / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def context(root: Path, cell_name: str, seed: int, trace: bool, device, t0: float,
            scratch: str) -> Ctx:
    cell = load(root, "workloads", cell_name)
    return Ctx(cell=cell, config=load(root, "configs", cell["config"]),
               mix=load(root, "traffic", cell["traffic"]), seed=seed, trace=trace,
               device=device, t0=t0, scratch=scratch)


def read_metric(root: Path, name: str, record: dict):
    """The per-layer metric ``name`` by its reader ``metrics/<name>.py``
    under ``root``, else under the package."""
    path = root / "metrics" / f"{name}.py"
    if not path.exists():
        path = PACKAGE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(record)


def cell_metrics(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries of ``BENCHMARK.json`` that ``cell_name`` reports."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if "workloads" not in m or cell_name in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def result_line(bench: dict, cell_name: str, out: dict, ctx: Ctx, root: Path,
                device_info: dict) -> dict:
    """The result object: ``correct``, counts, the cell's metrics, the
    device, the trace's breakdown, and last the numbers compared, each
    beside its limit."""
    metrics = {}
    for m in cell_metrics(bench, cell_name, ctx.trace):
        if ctx.trace:
            value = read_metric(root, m["name"], dict(out["record"], device_name=device_info["kind"],
                                                      config=ctx.config, mix=ctx.mix))
        else:
            value = out["end_to_end"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {name: {"value": v if math.isfinite(v) else 1e30, "limit": lim}
              for name, (v, lim) in out["checks"].items()}
    line = {"correct": all(v <= lim for v, lim in out["checks"].values()),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device_info}
    tr = out["record"].get("trace")
    if ctx.trace and tr is not None:
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["checks"] = checks
    return line


def execute(root: Path, bench: dict, workload: str, seed: int, trace: bool, device, t0: float,
            scratch: str) -> tuple[int, dict | None]:
    """Run the cell ``workload`` once on ``device``: ``(exit code, result
    line)``; the code is 3, with no line, when a forbidden module was
    loaded."""
    import torch

    ctx = context(root, workload, seed, trace, device, t0, scratch)
    entry = importlib.import_module(f"portbench.entries.{ctx.cell['entry']}")
    out = entry.run(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}", file=sys.stderr)
        return 3, None
    cuda = device.type == "cuda"
    info = {"platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": ctx.cell["chips"], "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if trace:
        tr = out["record"]["trace"]
        info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    line = result_line(bench, workload, out, ctx, root, info)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0, line


def main(args, t0: float) -> int:
    repo = PACKAGE.parent
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(repo / "build" / "portbench-cache" / sub)
    import torch

    with open(repo / "BENCHMARK.json") as f:
        bench = json.load(f)
    chips = load(PACKAGE, "workloads", args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); found {found}", file=sys.stderr)
        return 2
    rc, line = execute(PACKAGE, bench, args.workload, args.seed, bool(args.trace),
                       torch.device("cuda", 0), t0, str(repo / "build" / "portbench"))
    if line is not None:
        print(json.dumps(line))
    return rc
