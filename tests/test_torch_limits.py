"""The port tests' time limit (tests/torch_limits.py), in pytest runs of their own.

The inner runs take torch_limits' fixture with the limit cut to 1 s and the
faulthandler backstop to 3 s, so that nothing here waits the 300 s a port
test is allowed.  Their tests sleep 600 s: an inner run that ends within a
minute was ended by the limit, however long its start-up took on a loaded
machine.
"""

import os
import re

import torch

from torch_limits import time_limit  # noqa: F401

pytest_plugins = ["pytester"]

TESTS = os.path.dirname(os.path.abspath(__file__))
INNER_HEADER = f"""
import signal, sys, time

sys.path.insert(0, {TESTS!r})
import torch_limits

torch_limits.TEST_TIME_LIMIT = 1.0
torch_limits.HANG_BACKSTOP = 3.0
from torch_limits import time_limit  # noqa: F401
"""


def _run(pytester, body):
    pytester.makepyfile(INNER_HEADER + body)
    return pytester.runpytest_subprocess("-p", "no:cacheprovider", timeout=200)


def test_a_test_past_the_limit_fails_and_says_so(pytester):
    result = _run(pytester, "def test_sleeps():\n    time.sleep(600)\n")
    result.assert_outcomes(failed=1)
    out = result.stdout.str()
    said = re.search(r"test_sleeps ran past its time limit of 1 s \((\d+\.\d) s elapsed\)", out)
    assert said and float(said.group(1)) >= 1.0, out
    assert result.duration < 60


def test_tests_inside_the_limit_pass(pytester):
    """Each test has the limit to itself: two of 0.6 s pass together."""
    body = "def test_first():\n    time.sleep(0.6)\n\ndef test_second():\n    time.sleep(0.6)\n"
    _run(pytester, body).assert_outcomes(passed=2)


def test_a_wait_that_takes_no_signal_ends_the_worker(pytester):
    """SIGALRM blocked stands for a wait in C code: the backstop dumps the
    stack and ends the process."""
    body = ("def test_blocked():\n"
            "    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})\n"
            "    time.sleep(600)\n")
    result = _run(pytester, body)
    assert result.ret != 0
    err = result.stderr.str()
    assert "Timeout (0:00:03)!" in err and "test_blocked" in err, err
    assert result.duration < 60


def test_port_tests_run_on_one_torch_thread():
    assert torch.get_num_threads() == 1
