"""Error funnel — the toolkit/error.{h,cc} equivalent.

Error/Warning/Message printf-style reporting through a pluggable handler
(ref toolkit/error.h:24-61: stderr default, swappable for a GUI handler),
`panic` (abort), and `check`/`check_msg` assertion helpers
(ref error.h:63-90).  For assertions on a device tensor use
`device_check`, which queues `torch._assert_async` and so needs no
synchronisation.

Counterpart of `eggshell_tpu.utils.errors`.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

import torch

_handler: Optional[Callable[[str, str], None]] = None


def set_error_handler(handler: Optional[Callable[[str, str], None]]) -> None:
    """handler(level, message); None restores the stderr default."""
    global _handler
    _handler = handler


def _emit(level: str, fmt: str, *args) -> None:
    msg = (fmt % args) if args else fmt
    if _handler is not None:
        _handler(level, msg)
    else:
        print(f"{level}: {msg}", file=sys.stderr)


def message(fmt: str, *args) -> None:
    _emit("Message", fmt, *args)


def warning(fmt: str, *args) -> None:
    _emit("Warning", fmt, *args)


def error(fmt: str, *args) -> None:
    _emit("Error", fmt, *args)


class PanicError(RuntimeError):
    pass


def panic(fmt: str, *args) -> None:
    """Report and raise (the reference aborts the process,
    toolkit/error.cc; raising is the Python-appropriate analog)."""
    msg = (fmt % args) if args else fmt
    _emit("Panic", "%s", msg)
    raise PanicError(msg)


def check(condition, msg: str = "CHECK failed") -> None:
    if not condition:
        panic("%s", msg)


def check_msg(condition, fmt: str, *args) -> None:
    if not condition:
        panic(fmt, *args)


def device_check(pred, fmt: str, *args) -> None:
    """Assert `pred` without a host read where it is a tensor (the JAX
    package's `checkify.check`; ref DBG_CHECK, SURVEY.md section 5.2).

    - A Python bool (or a CPU tensor) is checked now: False raises
      `PanicError` with the message, through the handler, as `check_msg`.
    - A CUDA tensor (one element, bool or number, nonzero meaning true) is
      checked on the device by `torch._assert_async`: nothing is read
      back, and a false value fires a device-side assert.  The user then
      sees a `RuntimeError` ("CUDA error: device-side assert triggered")
      at the next call that synchronises with the card, not at this line,
      and the CUDA context is unusable for the rest of the process; the
      message is not carried to the host.
    """
    if isinstance(pred, torch.Tensor) and pred.device.type == "cuda":
        msg = (fmt % args) if args else fmt
        torch._assert_async(pred, msg)
        return
    check_msg(bool(pred), fmt, *args)
