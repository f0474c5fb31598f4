"""Where and for how long the tests run, and what a test process keeps of
its JAX compiles.

- Under xdist, all tests of a module (of a class, where a module has
  classes) run on one worker, whatever ``--dist`` says.
- Under xdist, each test but those marked ``slow`` has
  ``TEST_TIME_LIMIT_S`` for its setup, call and teardown together.
- Where ``tests/conftest.py`` has imported JAX, each test process has a
  persistent compilation cache of its own.

``tests/conftest.py`` sets JAX up for the tests; ``tests/test_suite_guard.py``
checks each mechanism here.
"""

import faulthandler
import functools
import os
import re
import shutil
import sys
import tempfile

import pytest

# The slowest test takes up to ~150 s with six workers on eight cores.
TEST_TIME_LIMIT_S = 300

# Modules that compile cold, whatever their worker compiled before.
# `test_sharded_loss_matches_single_device` can deadlock in XLA:CPU's
# collectives while its many small SPMD programs compile, and seldom does
# when they load from the cache; the time limit should keep reporting it.
COLD_MODULES = ("tests/test_parallel.py",)

_CACHE_ROOT = "jax_compile_cache_root"
_cache_root_key = pytest.StashKey[str]()


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    # Under `--dist load` a late module is spread over up to six workers,
    # each building its module fixture and compiling its graphs again.
    return module_scheduling_class()(config, log)


@functools.cache
def module_scheduling_class():
    """xdist's ``LoadScopeScheduling``, except that the test a worker died
    in is not handed to the worker that replaces it: it is reported as
    crashed, once, and the rest of its module runs on."""
    from xdist.scheduler import LoadScopeScheduling

    class ModuleScheduling(LoadScopeScheduling):
        def remove_node(self, node):
            workload = self.assigned_work[node]
            crashitem = next((nodeid for unit in workload.values()
                              for nodeid, done in unit.items() if not done),
                             None)
            for unit in workload.values():
                if crashitem in unit:
                    unit[crashitem] = True
            super().remove_node(node)
            return crashitem

    return ModuleScheduling


class TimeLimit:
    """Ends the process, with every thread's stack on stderr, when one
    test's setup, call and teardown take more than ``seconds``.

    ``faulthandler``'s timer runs on a C thread, so it fires even when the
    main thread is blocked in native code (an XLA rendezvous, a C++ loop).
    The xdist controller reports the test as crashed (failed), starts
    another worker and goes on."""

    def __init__(self, seconds):
        self.seconds = seconds
        # Made in pytest_configure, where fd 2 is still the real stderr;
        # while a test runs it points at pytest's capture file, which dies
        # with the process.
        self.stderr = os.dup(2)

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_protocol(self, item, nextitem):
        if item.get_closest_marker("slow"):
            return (yield)
        faulthandler.dump_traceback_later(self.seconds, exit=True,
                                          file=self.stderr)
        try:
            return (yield)
        finally:
            faulthandler.cancel_dump_traceback_later()


def install_time_limit(config, seconds):
    """Gives each test ``seconds`` in an xdist worker.  Only there: in a
    serial run, ending the process would end the whole session."""
    if hasattr(config, "workerinput"):
        config.pluginmanager.register(TimeLimit(seconds))


def pytest_configure(config):
    install_time_limit(config, TEST_TIME_LIMIT_S)
    jax = sys.modules.get("jax")
    if jax is None:
        return
    # `tests/conftest.py::_clear_jax_caches_between_modules` drops every
    # compiled executable after each module; the next module that builds
    # the same graphs loads them from here instead of compiling them again.
    # One directory per process (JAX writes entries in place, and a second
    # process could read a torn one), all under a root that the xdist
    # controller or the serial process removes at its end, also where the
    # time limit ended a worker.  Set through jax.config, not the
    # environment, so that no subprocess a test starts shares it.
    root = getattr(config, "workerinput", {}).get(_CACHE_ROOT)
    if root is None:
        root = tempfile.mkdtemp(prefix="jax-compile-cache-")
        config.add_cleanup(
            functools.partial(shutil.rmtree, root, ignore_errors=True))
    config.stash[_cache_root_key] = root
    jax.config.update("jax_compilation_cache_dir", tempfile.mkdtemp(dir=root))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)


# XLA:CPU logs two lines of some 4 KB each for every executable it loads
# from the cache: two tuning features of the compile target
# (+prefer-no-gather, +prefer-no-scatter) are not in the host's feature
# list.  These lines, and no others, are dropped from the stderr that a
# test report carries.
_CACHE_LOAD_NOTE = re.compile(
    r"^E[\d:. ]+\d+ cpu_aot_loader\.cc:\d+\] Loading XLA:CPU AOT result\. "
    r"Target machine feature \+prefer-no-(?:gather|scatter) is not .*\n?",
    re.MULTILINE)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_makereport(item, call):
    report = yield
    report.sections = [(name, _CACHE_LOAD_NOTE.sub("", text))
                       for name, text in report.sections]
    return report


@pytest.hookimpl(optionalhook=True)
def pytest_configure_node(node):
    root = node.config.stash.get(_cache_root_key, None)
    if root is not None:
        node.workerinput[_CACHE_ROOT] = root


def empty_compile_cache():
    """Removes every entry of this process's compilation cache."""
    jax = sys.modules.get("jax")
    path = jax and jax.config.jax_compilation_cache_dir
    if not path or not os.path.isdir(path):
        return
    for entry in os.scandir(path):
        if entry.name != ".lockfile":
            os.remove(entry.path)


@pytest.fixture(autouse=True, scope="module")
def _compile_cold_modules(request):
    if request.node.nodeid in COLD_MODULES:
        empty_compile_cache()
    yield
