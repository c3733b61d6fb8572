"""Colormaps — toolkit/colormaps.{h,cc} equivalent (Jet/Hot/Gray/HSV).

`colormap(name, n)` returns an (n, 3) float array in [0, 1]; the names
match the reference's set (toolkit/colormaps.h:15-24).

A copy of `eggshell_tpu.viz.colormaps` (NumPy).
"""

from __future__ import annotations

import numpy as np


def _jet(t):
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return np.stack([r, g, b], axis=-1)


def _hot(t):
    r = np.clip(3 * t, 0, 1)
    g = np.clip(3 * t - 1, 0, 1)
    b = np.clip(3 * t - 2, 0, 1)
    return np.stack([r, g, b], axis=-1)


def _gray(t):
    return np.stack([t, t, t], axis=-1)


def _hsv(t):
    h = t * 6.0
    r = np.clip(np.abs(h - 3) - 1, 0, 1)
    g = np.clip(2 - np.abs(h - 2), 0, 1)
    b = np.clip(2 - np.abs(h - 4), 0, 1)
    return np.stack([r, g, b], axis=-1)


_MAPS = {"jet": _jet, "hot": _hot, "gray": _gray, "hsv": _hsv}


def colormap(name: str = "jet", n: int = 256) -> np.ndarray:
    t = np.linspace(0.0, 1.0, n)
    try:
        return _MAPS[name](t)
    except KeyError:
        raise ValueError(f"unknown colormap {name!r}; have {sorted(_MAPS)}")
