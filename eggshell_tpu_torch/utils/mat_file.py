"""MATLAB .mat export/import (toolkit/mat_file.{h,cc} equivalent).

The reference writes MATLAB v7 files with dense/sparse/complex support
(toolkit/mat_file.h:13-24) for debugging and for rama's mesh+solution
export (rama/solver.h:228-231).  Backed by scipy.io here, with the same
incremental-writer API shape.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


class MatFile:
    """Accumulate named arrays, write once on `save()` (or use the
    context manager)."""

    def __init__(self, path: str):
        self.path = path
        self._vars: Dict[str, Any] = {}

    def write(self, name: str, array) -> None:
        arr = np.asarray(array)
        self._vars[name] = arr

    def write_sparse(self, name: str, matrix) -> None:
        import scipy.sparse as sp

        self._vars[name] = sp.csc_matrix(matrix)

    def write_scalar(self, name: str, value) -> None:
        self._vars[name] = np.asarray(value)

    def save(self) -> None:
        import scipy.io

        scipy.io.savemat(self.path, self._vars, do_compression=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.save()
        return False


def load_mat(path: str) -> Dict[str, Any]:
    import scipy.io

    out = scipy.io.loadmat(path)
    return {k: v for k, v in out.items() if not k.startswith("__")}
