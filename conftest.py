"""How the repo's test runs go, for every pytest run in this checkout.

``tests/conftest.py`` sets up the JAX package (CPU, 8 virtual devices,
float64, its compilation cache); this file holds the rest, each setting
with its reason:

* Time limit.  A test's setup and its call each stop after ``time_limit``
  seconds, an ini value (480 unless ``-o time_limit=N`` sets another for a
  run; 0 turns it off).  At the limit faulthandler dumps every thread's
  stack and SIGALRM fails the test under its own name, so a hung test costs
  one limit and the run goes on.  A test stuck inside native code gets its
  stacks dumped on time and fails when control returns to Python.  480 s is
  twice the slowest test left in tier-1 (236 s under six xdist workers on
  an 8-core CPU, where JAX compiles and runs on every core).
* Thread count.  torch runs one intra-op thread in every test process.  The
  port's CPU tests solve small problems, where more threads cost more than
  they bring, and the xdist workers already fill the cores.  It is set once
  here, so that no test module's import decides it for the others.
* Cache clearing.  ``jax.clear_caches()`` runs after each test module.
  XLA:CPU crashes a process that has compiled about 90 programs (a
  segfault in ``backend_compile_and_load``, reached from
  ``_compile_and_write_cache``); dropping the compiled programs of each
  finished module keeps every worker under that count.
* ``slow``.  The JAX package's tests in ``SLOW`` take over 60 s alone on an
  8-core CPU and carry the mark (``-m 'not slow'`` leaves them out).
"""

import faulthandler
import signal
import sys
import threading

import pytest
import torch

torch.set_num_threads(1)

#: node ids of the tests marked ``slow``, each with its time alone
SLOW = (
    # none finished within 600 s alone
    "tests/test_acopf.py::test_case118_published_optimum",
    "tests/test_structured.py::test_structured_case118_published_optimum",
    "tests/test_structured.py::test_structured_case30x10_300bus",
    # 121 s alone with no compilation cache
    "tests/test_acopf.py::test_case118_ladder_iteration_count",
)


def pytest_addoption(parser):
    parser.addini("time_limit", "seconds a test's setup or call may take before it "
                  "fails (0: no limit)", default="480")


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # first, so that -m 'not slow' sees the marks
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()


def _limited(item):
    limit = float(item.config.getini("time_limit"))
    if limit <= 0 or threading.current_thread() is not threading.main_thread():
        yield
        return

    # descriptor 2: captured with the test's output unless capture is off
    out = sys.__stderr__

    def expire(signum, frame):
        # the watchdog below may lose the race to this handler's cleanup
        faulthandler.cancel_dump_traceback_later()
        faulthandler.dump_traceback(file=out)
        pytest.fail(f"{item.nodeid} ran past its time limit of {limit:g} s")

    previous = signal.signal(signal.SIGALRM, expire)
    # dumps the stacks even while the main thread is inside native code
    faulthandler.dump_traceback_later(limit, file=out)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    yield from _limited(item)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    yield from _limited(item)
