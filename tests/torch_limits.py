"""What every test of eggshell_tpu_torch runs under: one torch thread and a time limit.

A port test file takes both by importing the autouse fixture:

    from torch_limits import time_limit  # noqa: F401

The reference package's own tests do not import it, and run as they always did.
"""

import faulthandler
import os
import signal
import time

import pytest
import torch

# One intra-op thread a worker: the tier-1 run's six workers share eight cores,
# and torch's thread pool on the port's small CPU tensors then spends its time
# waiting on itself (three batched living_room steps at B = 8: 0.05 s on one
# thread, 1.4 s on eight).
torch.set_num_threads(1)

# A port test's own time limit, from its function-scope setup to its teardown.
# SIGALRM fails the test that overstays it; a wait inside C code that never
# returns to the interpreter (a collective, a lock) cannot take the signal, so
# faulthandler dumps every thread's stack and ends the process a minute later.
# A subprocess a port test starts gets a shorter timeout, so that it fails
# first and names itself.
TEST_TIME_LIMIT = 300.0
HANG_BACKSTOP = 360.0
_stderr_fd = None


def _uncaptured_stderr(config):
    """A copy of fd 2 as it is outside pytest's capture, where the backstop writes."""
    global _stderr_fd
    if _stderr_fd is None:
        with config.pluginmanager.getplugin("capturemanager").global_and_fixture_disabled():
            _stderr_fd = os.dup(2)
    return _stderr_fd


@pytest.fixture(autouse=True)
def time_limit(request):
    start = time.monotonic()

    def overstayed(signum, frame):
        pytest.fail(f"{request.node.nodeid} ran past its time limit of {TEST_TIME_LIMIT:g} s "
                    f"({time.monotonic() - start:.1f} s elapsed)")

    handler = signal.signal(signal.SIGALRM, overstayed)
    signal.setitimer(signal.ITIMER_REAL, TEST_TIME_LIMIT)
    faulthandler.dump_traceback_later(HANG_BACKSTOP, exit=True,
                                      file=_uncaptured_stderr(request.config))
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, handler)
