"""The harness finds every file by its name, and a new cell or per-layer
metric takes new files and ``BENCHMARK.json`` entries only: a throwaway
cell and metric, added in a temporary root, run at tiny size."""

import json
import shutil
import time

import torch

from portbench import harness

REPO = harness.PACKAGE.parent


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_entry_has_its_files():
    bench = _bench()
    assert bench["paths"] == ["portbench"] and bench["command"] == ["python3", "portbench/run.py"]
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert c["file"] == f"portbench/configs/{c['name']}.json" and cfg["name"] == c["name"]
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        cell = harness.load(harness.PACKAGE, "workloads", w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (w["config"], w["traffic"],
                                                                    w["chips"])
        harness.load(harness.PACKAGE, "traffic", w["traffic"])
        assert (harness.PACKAGE / "entries" / f"{cell['entry']}.py").exists()
        e2e = {m["name"] for m in harness.cell_metrics(bench, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(bench, w["name"], True)
    for m in bench["per_layer"]:
        assert (harness.PACKAGE / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_a_throwaway_cell_and_metric_need_only_new_files(tmp_path, data_root):
    for kind in ("configs", "workloads", "traffic"):
        shutil.copytree(data_root / kind, tmp_path / kind)
    shutil.copytree(harness.PACKAGE / "metrics", tmp_path / "metrics")
    cell = json.loads((data_root / "workloads" / "tiny-xib-eval.json").read_text())
    (tmp_path / "workloads" / "throwaway-eval.json").write_text(json.dumps(cell))
    (tmp_path / "metrics" / "clips_per_batch.throwaway.py").write_text(
        "def read(record):\n    return record['window']['clips_per_batch']\n")
    (tmp_path / "metrics" / "silent.throwaway.py").write_text(
        "def read(record):\n    return None\n")
    bench = _bench()
    bench["workloads"].append({"name": "throwaway-eval", "config": "tiny-xib",
                               "traffic": "tiny-b2", "chips": 1, "why": "a test"})
    for name in ("clips_per_batch.throwaway", "silent.throwaway"):
        bench["per_layer"].append({"name": name, "unit": "clips", "better": "higher",
                                   "source": "program_counter", "layer": "driver",
                                   "moves": "clips_per_s", "workloads": ["throwaway-eval"]})
    rc, line = harness.execute(tmp_path, bench, "throwaway-eval", 5, True,
                               torch.device("cpu"), time.perf_counter(), str(tmp_path / "out"))
    assert rc == 0 and line["correct"]
    assert line["metrics"]["clips_per_batch.throwaway"] == {"value": 2, "unit": "clips"}
    assert "silent.throwaway" not in line["metrics"]
    # the package's own cells do not list the throwaway metric
    assert all(m["name"] != "clips_per_batch.throwaway"
               for m in harness.cell_metrics(bench, "xib-qwen2-eval", True))
