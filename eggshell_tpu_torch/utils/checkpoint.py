"""Checkpoint / resume of simulation + MPC state.

The reference has no checkpointing (SURVEY.md §5.4); multi-host MPC runs
need it.  Save/restore of a tree — dicts, lists and tuples (NamedTuples
such as `State` included) of tensors and numbers, typically
{"state": State batch, "controls": (H, 6), "step": int} — through
`torch.save` / `torch.load(weights_only=True)`, with an explicit restore
target for dtype and device fidelity.

Counterpart of `eggshell_tpu.utils.checkpoint` (orbax there).  The file
holds every tensor on the host, NamedTuples as plain tuples; the target
gives them back their type.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch


def _plain(tree):
    """The tree as torch.load(weights_only=True) takes it: tensors
    detached and copied to the host, NamedTuples as tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_plain(v) for v in tree)
    return tree


def _like(loaded, target):
    """`loaded` in the structure of `target`: each tensor leaf on the
    target leaf's device in its dtype, each number of its type,
    NamedTuples rebuilt."""
    if isinstance(target, torch.Tensor):
        return torch.as_tensor(loaded).to(device=target.device, dtype=target.dtype)
    if isinstance(target, dict):
        return {k: _like(loaded[k], v) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if len(loaded) != len(target):
            raise ValueError(f"checkpoint has {len(loaded)} entries where the target has "
                             f"{len(target)}")
        items = [_like(x, t) for x, t in zip(loaded, target)]
        if hasattr(target, "_fields"):
            return type(target)(*items)
        return type(target)(items)
    if isinstance(target, (bool, int, float, complex)):
        return type(target)(loaded.item() if isinstance(loaded, torch.Tensor) else loaded)
    return loaded


def save_checkpoint(path: str, tree: Any) -> None:
    """Write `tree` to the file `path`, replacing it if it exists (as
    orbax's force=True does), through a temporary file beside it."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(_plain(tree), tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    """The tree saved at `path`: host tensors and plain tuples without a
    target; with one, the target's structure, each leaf's dtype and
    device and each NamedTuple's type."""
    loaded = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    return loaded if target is None else _like(loaded, target)
