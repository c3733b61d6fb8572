"""SI-prefix number formatting (toolkit/si_prefix.{h,cc} equivalent).

A copy of `eggshell_tpu.utils.si_prefix` (pure Python)."""

from __future__ import annotations

_PREFIXES = [
    (1e24, "Y"), (1e21, "Z"), (1e18, "E"), (1e15, "P"), (1e12, "T"),
    (1e9, "G"), (1e6, "M"), (1e3, "k"), (1.0, ""), (1e-3, "m"),
    (1e-6, "u"), (1e-9, "n"), (1e-12, "p"), (1e-15, "f"), (1e-18, "a"),
    (1e-21, "z"), (1e-24, "y"),
]


def si_prefix(value: float, digits: int = 3) -> str:
    """Format with an SI prefix: 1.23e-8 -> '12.3n'."""
    if value == 0:
        return f"{0:.{digits}g}"
    mag = abs(value)
    for scale, prefix in _PREFIXES:
        if mag >= scale:
            return f"{value / scale:.{digits}g}{prefix}"
    scale, prefix = _PREFIXES[-1]
    return f"{value / scale:.{digits}g}{prefix}"


def si_parse(s: str) -> float:
    """Inverse of si_prefix: '12.3n' -> 1.23e-8."""
    s = s.strip()
    for _, prefix in _PREFIXES:
        if prefix and s.endswith(prefix):
            return float(s[: -len(prefix)]) * dict(
                (p, sc) for sc, p in _PREFIXES
            )[prefix]
    return float(s)
