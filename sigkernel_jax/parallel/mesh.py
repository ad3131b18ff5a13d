"""Device-mesh helpers.

The reference is single-process, single-device (SURVEY.md S2: no distributed
backend exists upstream). The scale-out story here replaces the CUDA
block grid and the ``max_batch`` recursion with a 1-D/2-D
``jax.sharding.Mesh``: the batch axis of ``compute_kernel`` and the
``(A, B)`` Gram tile grid of ``compute_Gram`` are embarrassingly parallel.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(axis_names: Sequence[str] = ("data",),
              shape: Optional[Tuple[int, ...]] = None,
              devices=None) -> Mesh:
    """Build a mesh over the available devices.

    Default: all devices on a single ``data`` axis. Pass
    ``axis_names=("rows", "cols")`` and a ``shape`` for a 2-D Gram-tile mesh.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        elif len(axis_names) == 2:
            # squarest 2-D factorisation of n
            r = int(np.floor(np.sqrt(n)))
            while n % r:
                r -= 1
            shape = (r, n // r)
        else:
            raise ValueError("pass an explicit shape for >2 mesh axes")
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, axis_names)


def default_mesh() -> Mesh:
    """All devices on one ``data`` axis."""
    return make_mesh()
