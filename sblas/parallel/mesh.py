"""Mesh helpers: 1D 'chips' axis (the reference's multi-GPU analogue) and a
2D ('rows', 'cols') mesh for the scalable 2D-partitioned routines."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

chips_axis = "chips"
rows_axis = "rows"
cols_axis = "cols"
hosts_axis = "hosts"


def make_mesh(ndev: int | None = None) -> Mesh:
    """1D mesh over the first ``ndev`` devices (default: all)."""
    devs = jax.devices()
    if ndev is None:
        ndev = len(devs)
    if ndev > len(devs):
        raise ValueError(f"requested {ndev} devices, have {len(devs)}")
    return Mesh(np.array(devs[:ndev]), (chips_axis,))


def make_mesh2d(rows: int | None = None, cols: int | None = None) -> Mesh:
    """2D ('rows', 'cols') mesh. With no args, picks the most-square
    factorization of the device count (rows <= cols)."""
    devs = jax.devices()
    if rows is None and cols is None:
        n = len(devs)
        rows = int(np.sqrt(n))
        while n % rows:
            rows -= 1
        cols = n // rows
    elif rows is None:
        rows = len(devs) // cols
    elif cols is None:
        cols = len(devs) // rows
    if rows * cols > len(devs):
        raise ValueError(
            f"requested {rows}x{cols} devices, have {len(devs)}")
    return Mesh(
        np.array(devs[: rows * cols]).reshape(rows, cols),
        (rows_axis, cols_axis),
    )
