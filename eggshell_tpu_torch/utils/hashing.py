"""Content hashing, counterpart of `eggshell_tpu.utils.hashing`: md5 of
bytes, of a file and of a JSON-serialisable config (the JAX package's
digests), and a stable hash of a nest of tensors and arrays
(`hash_pytree`).  The model API keys its cache of solves on
`hash_config`."""

from __future__ import annotations

import hashlib
import json
from typing import Any

import numpy as np
import torch


def md5_hex(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


def md5_file(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _update(h, node) -> None:
    """Feed `node` into `h`: a container as its kind, its size and (for a
    NamedTuple or dict) its field names, then its children in order (dict
    keys sorted); a leaf as its dtype, shape and bytes (a tensor's taken
    from a CPU copy)."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        h.update(f"namedtuple {type(node).__name__} {node._fields}".encode())
        children = list(node)
    elif isinstance(node, (tuple, list)):
        h.update(f"{type(node).__name__} {len(node)}".encode())
        children = list(node)
    elif isinstance(node, dict):
        keys = sorted(node)
        h.update(f"dict {keys!r}".encode())
        children = [node[k] for k in keys]
    elif node is None:
        h.update(b"None")
        return
    else:
        if isinstance(node, torch.Tensor):
            node = node.detach().cpu().numpy()
        arr = np.asarray(node)
        h.update(f"leaf {arr.dtype} {arr.shape}".encode())
        h.update(np.ascontiguousarray(arr).tobytes())
        return
    for child in children:
        _update(h, child)


def hash_pytree(tree: Any) -> str:
    """Stable md5 of a nest of NamedTuples, tuples, lists, dicts, tensors,
    arrays and scalars: the same structure and the same values give the
    same digest, a changed value, dtype, shape or structure another.  It is
    not the JAX package's digest, which hashes JAX's treedef string."""
    h = hashlib.md5()
    _update(h, tree)
    return h.hexdigest()


def hash_config(obj: Any) -> str:
    """Hash any JSON-serialisable config."""
    return md5_hex(json.dumps(obj, sort_keys=True, default=str).encode())
