"""Crash handling (toolkit/crash_handler.{h,cc} equivalent): install
fault handlers that dump Python + native backtraces on SIGSEGV/SIGABRT
and on unhandled exceptions (ref SetupCrashHandling,
toolkit/crash_handler.h:12-15).

A copy of `eggshell_tpu.utils.crash_handler` (pure Python)."""

from __future__ import annotations

import faulthandler
import signal
import sys
import traceback
from typing import Optional, TextIO


def setup_crash_handling(stream: Optional[TextIO] = None) -> None:
    stream = stream or sys.stderr
    faulthandler.enable(file=stream, all_threads=True)
    for sig in (signal.SIGTERM,):
        try:
            faulthandler.register(sig, file=stream, all_threads=True)
        except (ValueError, AttributeError):
            pass  # not main thread / platform without register

    def hook(exc_type, exc, tb):
        print("=== unhandled exception ===", file=stream)
        traceback.print_exception(exc_type, exc, tb, file=stream)

    sys.excepthook = hook
