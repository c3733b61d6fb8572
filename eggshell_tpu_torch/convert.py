"""Scenes, states and 2D FDTD fields of the JAX package, as numpy arrays,
to the port's tensors, and its FEM meshes to the port's `Mesh`.

The caller turns the JAX NamedTuples into dicts of numpy arrays
(``{k: np.asarray(v) for k, v in spec._asdict().items()}``), so this
module needs no JAX.  Integer fields become int64, boolean fields stay
boolean and float fields take `dtype`.  A `SimConfig` needs no converter:
`SimConfig.to_json` of one package is `SimConfig.from_json` of the other,
and the fused chain adds no parameter that crosses over.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from eggshell_tpu_torch.fem.fdtd import Field2D
from eggshell_tpu_torch.fem.mesher import Mesh
from eggshell_tpu_torch.physics.scene import SceneSpec, State


def _tensor(x, device, dtype):
    a = np.array(x)  # a writable copy: the JAX package's arrays are read-only
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a.astype(np.float64), device=device).to(dtype)


def spec_from_numpy(fields: Mapping, *, device, dtype) -> SceneSpec:
    return SceneSpec(**{k: _tensor(fields[k], device, dtype)
                        for k in SceneSpec._fields})


def state_from_numpy(fields: Mapping, *, device, dtype) -> State:
    return State(**{k: _tensor(fields[k], device, dtype)
                    for k in State._fields})


def field2d_from_numpy(fields: Mapping, *, device, dtype) -> Field2D:
    return Field2D(**{k: _tensor(fields[k], device, dtype) for k in Field2D._fields})


def mesh_from_numpy(fields: Mapping) -> Mesh:
    """A JAX-package `Mesh` given as its dataclass fields of numpy arrays
    (``dataclasses.asdict(mesh)``) as the port's `Mesh`; meshes stay numpy
    on the host, so each field is copied as it is."""
    import dataclasses

    return Mesh(**{f.name: None if fields.get(f.name) is None else np.array(fields[f.name])
                   for f in dataclasses.fields(Mesh)})
