"""The port stands alone: no module of ``mraudio_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax, optax, orbax or the JAX package, and none imports
PyYAML, ``transformers`` or ``tokenizers`` at module level (the card's
machine has no HF packages)."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "mraudio_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mraudio_tpu")
LAZY = ("yaml", "transformers", "tokenizers")     # imported inside the functions that need them


def _imports(tree, module_level_only=False):
    nodes = tree.body if module_level_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_module_level_yaml(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name in _imports(tree):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"
    for name in _imports(tree, module_level_only=True):
        assert name.split(".")[0] not in LAZY, f"{path.name} imports {name} at module level"


def test_package_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mraudio_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, 'mraudio_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'mraudio_tpu', 'yaml', 'transformers', "
        "'tokenizers'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_parallel_modules_and_the_rank_program_stand_alone():
    """The ``parallel/`` modules are among the sources checked above, and
    the mesh tests' rank program (``test_torch_parallel_ranks.py``, run in
    processes of its own) imports neither JAX nor the JAX package."""
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {f"mraudio_tpu_torch/parallel/{m}.py"
            for m in ("__init__", "mesh", "partition", "comm")} <= names
    code = (
        "import sys\n"
        "import test_torch_parallel_ranks\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'mraudio_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT / "tests",
                         env={**os.environ, "PYTHONPATH": str(ROOT)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_native_bindings_build_into_build_dir():
    """The port builds its own decode library under ``build/`` from the C++
    source and never loads or writes the JAX package's artifact in
    ``native/``."""
    from mraudio_tpu_torch.data import native_bindings as nb

    src = (ROOT / "mraudio_tpu_torch" / "data" / "native_bindings.py").read_text()
    assert "libmraudio_native.so" in src and "native/libmraudio_native.so" not in src
    assert pathlib.Path(nb._LIB_PATH).parent == ROOT / "build" / "native"
    assert pathlib.Path(nb._SOURCE) == ROOT / "native" / "mraudio_native.cc"


def test_videollama_module_is_covered():
    """The VideoLLaMA backbone is among the sources checked above and
    imports nothing of the JAX package (its JAX counterpart,
    ``mraudio_tpu/models/videollama.py``, is the reference)."""
    path = ROOT / "mraudio_tpu_torch" / "models" / "videollama.py"
    assert path in SOURCES
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = {name.split(".")[0] for name in _imports(tree)}
    assert "mraudio_tpu_torch" in tops and not tops & set(FORBIDDEN)


def test_every_module_of_the_jax_package_has_a_counterpart():
    """Every ``*.py`` of the JAX package has its namesake in the port but
    ``utils/platform.py`` (JAX's platform and compile-cache set-up, whose
    counterpart is ``device.py``); the new modules are among the sources
    checked above."""
    jax_files = {p.relative_to(ROOT / "mraudio_tpu").as_posix()
                 for p in (ROOT / "mraudio_tpu").rglob("*.py")}
    port_files = {p.relative_to(ROOT / "mraudio_tpu_torch").as_posix()
                  for p in (ROOT / "mraudio_tpu_torch").rglob("*.py")}
    assert jax_files - port_files == {"utils/platform.py"}
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {f"mraudio_tpu_torch/{m}.py" for m in ("data/media", "cli/prepare_data",
                                                   "utils/fetch")} <= names
