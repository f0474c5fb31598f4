"""What the repository's root ``conftest.py`` installs for the whole suite:
one xdist worker per module, a per-test time limit in xdist workers, and
each process's compilation cache.  The first two run in small inner
pytest runs of their own."""

import importlib.util
import os
import re
from types import SimpleNamespace

import pytest

pytest_plugins = ["pytester"]

ROOT_CONFTEST = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conftest.py")


def _load_guard():
    spec = importlib.util.spec_from_file_location("suite_guard", ROOT_CONFTEST)
    guard = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(guard)
    return guard


guard = _load_guard()


def _run(pytester, monkeypatch, *args):
    # Only xdist: the other installed plugins would double each inner
    # process's start-up.
    monkeypatch.setenv("PYTEST_DISABLE_PLUGIN_AUTOLOAD", "1")
    return pytester.runpytest_subprocess(
        "-p", "xdist", "--dist", "load", "-p", "no:cacheprovider", *args,
        timeout=60)


def _conftest(limit_s):
    """The inner run's conftest: the scheduler hook and the time limit, as
    the root conftest installs them, with a limit of ``limit_s``."""
    return f"""
import importlib.util

spec = importlib.util.spec_from_file_location("suite_guard", {ROOT_CONFTEST!r})
guard = importlib.util.module_from_spec(spec)
spec.loader.exec_module(guard)

pytest_xdist_make_scheduler = guard.pytest_xdist_make_scheduler
pytest_runtest_makereport = guard.pytest_runtest_makereport

def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running")
    guard.install_time_limit(config, {limit_s})
"""


def test_a_stalled_test_fails_with_its_stack_and_the_run_goes_on(
        pytester, monkeypatch):
    pytester.makeconftest(_conftest(limit_s=2))
    pytester.makepyfile(test_stall="""
import time

def test_stalls():
    time.sleep(120)

def test_after_the_stall():
    assert True
""")
    result = _run(pytester, monkeypatch, "-n", "1")
    result.assert_outcomes(passed=1, failed=1)
    out = result.stdout.str()
    assert "crashed while running 'test_stall.py::test_stalls'" in out
    assert "replacing crashed worker gw0" in out
    err = result.stderr.str()
    assert "Timeout (0:00:02)!" in err
    assert re.search(r'test_stall\.py", line \d+ in test_stalls', err)


@pytest.mark.parametrize("where", ["serial", "slow"])
def test_no_limit_outside_a_worker_nor_for_slow_tests(
        pytester, monkeypatch, where):
    """A serial run would end with its process, and a test marked slow is
    left out of tier 1 because it needs more than the limit."""
    pytester.makeconftest(_conftest(limit_s=1))
    mark = "@pytest.mark.slow" if where == "slow" else ""
    pytester.makepyfile(test_long=f"""
import time
import pytest

{mark}
def test_long():
    time.sleep(3)
""")
    result = _run(pytester, monkeypatch,
                  "-n", "0" if where == "serial" else "1")
    result.assert_outcomes(passed=1)
    assert "Timeout" not in result.stderr.str()


def test_all_tests_of_a_module_run_on_one_worker(pytester, monkeypatch):
    pytester.makeconftest(_conftest(limit_s=60))
    body = """
import os
import pytest

@pytest.mark.parametrize("i", range(6))
def test_case(i):
    with open("workers.txt", "a") as f:
        f.write(f"{__name__} {os.environ['PYTEST_XDIST_WORKER']}\\n")
"""
    pytester.makepyfile(test_first=body, test_second=body)
    result = _run(pytester, monkeypatch, "-n", "2")
    result.assert_outcomes(passed=12)
    lines = (pytester.path / "workers.txt").read_text().splitlines()
    assert len(lines) == 12
    workers = {}
    for line in lines:
        module, worker = line.split()
        workers.setdefault(module, set()).add(worker)
    assert sorted(workers) == ["test_first", "test_second"]
    assert all(len(w) == 1 for w in workers.values()), workers


def test_a_report_drops_only_the_cache_load_notes(pytester, monkeypatch):
    pytester.makeconftest(_conftest(limit_s=60))
    note = ("E1018 17:48:07.140343    3545 cpu_aot_loader.cc:210] Loading "
            "XLA:CPU AOT result. Target machine feature +prefer-no-scatter "
            "is not  supported on the host machine. Compile machine "
            "features: [+64bit,+adx]")
    pytester.makepyfile(test_noisy=f"""
import os

def test_fails_after_logging():
    os.write(2, b"first kept line\\n{note}\\n"
                b"E1018 17:48:07.2 3545 other.cc:1] second kept line\\n")
    assert False
""")
    result = _run(pytester, monkeypatch, "-n", "1")
    result.assert_outcomes(failed=1)
    out = result.stdout.str()
    assert "first kept line" in out and "second kept line" in out
    # The test's source, in the traceback, holds the note indented.
    assert not re.search(r"^E1018 .*cpu_aot_loader", out, re.MULTILINE)
    assert re.search(r"^E1018 .*second kept line", out, re.MULTILINE)


class _Node:
    """What xdist's schedulers use of a worker."""

    shutting_down = False

    def __init__(self, id):
        self.gateway = SimpleNamespace(id=id)
        self.sent = []

    def send_runtest_some(self, indices):
        self.sent.append(indices)

    def shutdown(self):
        self.shutting_down = True


def test_a_dead_workers_test_is_not_handed_to_its_replacement():
    """Pins what ``ModuleScheduling`` uses of xdist's ``LoadScopeScheduling``
    (``assigned_work`` and ``remove_node``): an xdist release that changes
    either fails here."""
    config = SimpleNamespace(getvalue={"tx": ["2*popen"]}.__getitem__,
                             option=SimpleNamespace(loadscopereorder=False))
    sched = guard.module_scheduling_class()(config)
    collection = ["a.py::t0", "a.py::t1", "a.py::t2", "b.py::u0"]
    first, second, replacement = _Node("gw0"), _Node("gw1"), _Node("gw2")
    for node in (first, second):
        sched.add_node(node)
        sched.add_node_collection(node, collection)
    sched.schedule()
    assert first.sent == [[0, 1, 2]] and second.sent == [[3]]
    # `first` dies in a.py::t0; the rest of a.py goes to its replacement.
    assert sched.remove_node(first) == "a.py::t0"
    sched.add_node(replacement)
    sched.add_node_collection(replacement, collection)
    sched.schedule()
    assert replacement.sent == [[1, 2]]
    # At shutdown, with nothing left, no test is reported as crashed.
    sched.mark_test_complete(replacement, 1)
    sched.mark_test_complete(replacement, 2)
    assert sched.remove_node(replacement) is None


def _cache_hits(f, x):
    import jax

    hits = []

    def listener(event, **kwargs):
        if event == "/jax/compilation_cache/cache_hits":
            hits.append(event)

    jax.monitoring.register_event_listener(listener)
    try:
        return jax.jit(f)(x), len(hits)
    finally:
        jax.monitoring.unregister_event_listener(listener)


def test_a_graph_compiled_before_the_cache_clear_loads_from_disk():
    """After the cache clear that ends every module, a graph compiled
    before it is loaded, not compiled again; in a module of
    ``COLD_MODULES`` it is compiled again."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    def f(x):
        return jnp.sin(x) * 3.0 + 1.0

    x = jnp.arange(7.0)
    want = jax.jit(f)(x)
    jax.clear_caches()
    got, hits = _cache_hits(f, x)
    assert hits == 1
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    jax.clear_caches()
    guard.empty_compile_cache()
    got, hits = _cache_hits(f, x)
    assert hits == 0
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
