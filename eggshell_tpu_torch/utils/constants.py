"""Small constant tensors, made once per (values, dtype, device).

A step that builds a constant with `torch.tensor(list, device="cuda")`
copies it from the host on every call, and a CUDA graph refuses to
capture that copy.  `constant` makes the tensor on its first call and
hands back the same tensor after, so a step that has run once before its
capture reads every constant from the card.  The tensors are shared:
callers never write into them.
"""

from __future__ import annotations

import functools

import torch


def _frozen(values):
    if isinstance(values, (list, tuple)):
        return tuple(_frozen(v) for v in values)
    return values


@functools.lru_cache(maxsize=None)
def _cached(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype, device) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype, device=device)`, the same tensor
    on every call with equal arguments (values nested lists or tuples)."""
    return _cached(_frozen(values), dtype, torch.device(device))
