"""The per-test time limit of the repo's top-level ``conftest.py``.

Each case runs pytest in a subprocess on a temporary test file beside a copy
of that conftest, with the limit lowered to 3 s by ``-o`` for that run only: a
test that sleeps past it fails under its own name with every thread's stack
dumped, and the test after it still runs; a test that ends in time passes.
"""

import os
import shutil
import subprocess
import sys

import pytest

CONFTEST = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conftest.py")

BODY = """import time


def test_sleep():
    time.sleep({seconds})


def test_after():
    pass
"""


@pytest.mark.parametrize("seconds, passes", [(60, False), (0.1, True)],
                         ids=["past_the_limit", "within_the_limit"])
def test_time_limit(tmp_path, seconds, passes):
    shutil.copy(CONFTEST, tmp_path / "conftest.py")
    (tmp_path / "test_sleep.py").write_text(BODY.format(seconds=seconds))
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-o", "time_limit=3", "test_sleep.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    out = run.stdout + run.stderr
    if passes:
        assert run.returncode == 0, out
        assert "2 passed" in out, out
    else:
        assert run.returncode == 1, out
        assert "test_sleep.py::test_sleep ran past its time limit of 3 s" in out, out
        assert "most recent call first" in out, out  # faulthandler's dump of the stacks
        assert 'File "' + str(tmp_path / "test_sleep.py") + '", line 5 in test_sleep' in out, out
        assert "1 failed, 1 passed" in out, out
