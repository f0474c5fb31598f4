"""The port stands alone: no module of ``mraudio_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax or the JAX package, and none imports
PyYAML at module level."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "mraudio_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "mraudio_tpu")


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
        assert name.split(".")[0] != "yaml", f"{path.name} imports yaml at module level"


def test_package_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mraudio_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, 'mraudio_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'mraudio_tpu', 'yaml'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
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
