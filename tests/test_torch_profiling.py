"""CPU tests of `eggshell_tpu_torch.utils.profiling`'s handling of a
flushed window: the flush's device operations are dropped from each call's
events, a window that does not start each call with them raises, and
`device_window` profiles such a window again (the profiler is replaced by
recorded event lists)."""

from types import SimpleNamespace

import pytest

from eggshell_tpu_torch.utils import profiling
from eggshell_tpu_torch.utils.profiling import _drop_flush
from torch_limits import time_limit  # noqa: F401


def _events(names):
    return [SimpleNamespace(name=n, time_range=SimpleNamespace(start=i, end=i + 1))
            for i, n in enumerate(names)]


def test_drop_flush_keeps_each_calls_own_events():
    events = _events(["fill", "k1", "k2"] * 4)
    kept = _drop_flush(events, 4, {"fill": 1})
    assert [e.name for e in kept] == ["k1", "k2"] * 4


@pytest.mark.parametrize("names", [
    ["fill", "k1", "k2", "k1", "fill", "k2"],          # a call without its flush first
    ["fill", "k1", "fill", "k1", "k1"],                 # not the same count every call
])
def test_drop_flush_rejects_a_misaligned_window(names):
    with pytest.raises(RuntimeError):
        _drop_flush(_events(names), 2, {"fill": 1})


def test_device_window_profiles_again_after_a_window_that_lost_events(monkeypatch):
    """The first window of the flush alone and the first flushed window each
    lose an event; both are profiled again, and the whole windows are read."""
    windows = iter([
        (_events(["fill"] * 3), 1.0),                    # the flush alone, one call lost
        (_events(["fill"] * 4), 1.0),
        (_events(["fill", "k", "fill", "k", "fill", "k", "k"]), 1.0),   # lost a fill
        (_events(["fill", "k"] * 4), 1.0),
    ])
    monkeypatch.setattr(profiling, "_window", lambda fn, reps, flush: next(windows))
    monkeypatch.setattr(profiling.torch.cuda, "synchronize", lambda: None)
    w = profiling.device_window(lambda: None, 4, flush=lambda: None)
    assert w["by_name"] == {"k": (1e-3, 1.0)} and w["attempts"] == 2
