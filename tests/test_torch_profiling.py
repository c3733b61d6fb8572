"""CPU tests of `eggshell_tpu_torch.utils.profiling`'s handling of a
flushed window: the flush's device operations are dropped from each call's
events, and a window that does not start each call with them raises."""

from types import SimpleNamespace

import pytest

from eggshell_tpu_torch.utils.profiling import _drop_flush


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
