"""Nothing the benchmark runs loads JAX, flax, the JAX package or
``bench.py``: top-level module names compared whole, so the port
(``mraudio_tpu_torch``) is not taken for the JAX package."""

import ast
import subprocess
import sys

from portbench import harness


def _top_names(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_a_forbidden_module():
    for path in harness.PACKAGE.rglob("*.py"):
        assert not _top_names(path) & set(harness.FORBIDDEN), path


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mraudio_tpu_torch_lookalike", sys)
    assert "mraudio_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mraudio_tpu.config", sys)
    assert harness.forbidden_modules() == ["mraudio_tpu"]


def test_a_run_loads_none_of_them():
    code = ("import sys; sys.path.insert(0, '.');"
            "from portbench import harness, calibrate;"
            "from portbench.entries import run_inference;"
            "from portbench.reference import xinstructblip, videollama;"
            "import mraudio_tpu_torch.infer.evaluate, mraudio_tpu_torch.models.factory,"
            " mraudio_tpu_torch.models.videollama;"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.PACKAGE.parent,
                         capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result(tmp_path):
    """Without a card the command exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "xib-qwen2-eval",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.PACKAGE.parent, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
