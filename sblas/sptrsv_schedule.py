"""SpTRSV level-set analysis (host side, SURVEY.md C7).

Builds the wavefront schedule for a triangular solve: rows bucketed by
dependency level (Naumov-style level sets), then packed into fixed-size tiles
that never mix levels, so the device solve is a serial scan over tiles with
all dependencies pointing at strictly earlier tiles.

The reference's sync-free variant (C9: per-row spin-wait on atomics) is not
built; the level-set schedule plus tile batching is the strategy, walked by
an XLA loop or by one kernel launch on a GPU (SURVEY.md C9, ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .formats import CSR, INDEX_DTYPE
from . import native


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True, eq=False)
class LevelSchedule:
    """Padded tile schedule for a triangular solve.

    Rows are ordered by (level, row) and padded so every level occupies a
    whole number of ``tile_rows``-row tiles. Slot arrays have one entry per
    padded slot:

    - ``slot_row``  (S,): original row for the slot, or ``n`` for pad slots.
    - ``col``  (S, W): off-diagonal column indices, padded with ``n+1``...
      actually padded with ``n`` pointing at a constant-zero x slot.
    - ``val``  (S, W): matching off-diagonal values (0 for pads).
    - ``inv_diag`` (S,): 1/diagonal for the row (1 for pads/unit diag).
    - ``num_tiles``: S / tile_rows.
    - ``level_of_tile`` (num_tiles,): level id per tile (diagnostics).

    x is computed in a buffer of length n+2: slot n is the constant-zero
    gather target for padded columns; slot n+1 is the dump target written by
    pad slots.
    """

    n: int
    nnz: int
    tile_rows: int
    width: int
    nlevels: int
    slot_row: np.ndarray
    col: np.ndarray
    val: np.ndarray
    inv_diag: np.ndarray
    level_of_tile: np.ndarray
    levels: np.ndarray  # per original row

    @property
    def num_tiles(self) -> int:
        return len(self.slot_row) // self.tile_rows

    @property
    def padded_slots(self) -> int:
        return len(self.slot_row)


def build_level_schedule(
    l: CSR, *, lower: bool = True, unit_diagonal: bool = False,
    tile_rows: int = 0, width_multiple: int = 8,
) -> LevelSchedule:
    """Analyse a triangular CSR matrix into a :class:`LevelSchedule`.

    ``tile_rows=0`` picks a size balancing padding waste (small tiles) against
    per-tile parallelism (big tiles): max(8, min(512, mean level size rounded
    to 8)).
    """
    n = l.shape[0]
    if l.shape[0] != l.shape[1]:
        raise ValueError("sptrsv requires a square matrix")
    levels, nlevels = native.level_schedule(l.indptr, l.indices, n, lower=lower)

    if tile_rows <= 0:
        mean_level = max(n // max(nlevels, 1), 1)
        tile_rows = int(np.clip(_round_up(mean_level, 8), 8, 512))

    # Order rows by (level, row); pad each level to a multiple of tile_rows.
    order = np.lexsort((np.arange(n), levels))
    level_sizes = np.bincount(levels, minlength=nlevels)
    padded_sizes = np.maximum(
        ((level_sizes + tile_rows - 1) // tile_rows) * tile_rows, 0
    )
    total = int(padded_sizes.sum())
    slot_row = np.full(total, n, dtype=INDEX_DTYPE)
    starts = np.concatenate([[0], np.cumsum(padded_sizes)[:-1]])
    src = 0
    for lv in range(nlevels):
        sz = int(level_sizes[lv])
        slot_row[starts[lv]: starts[lv] + sz] = order[src: src + sz]
        src += sz

    # Off-diagonal ELL per slot + diagonal extraction.
    indptr = l.indptr.astype(np.int64)
    deg = np.diff(indptr)
    rows_nnz = l.row_ids().astype(np.int64)
    cols_nnz = l.indices.astype(np.int64)
    is_diag = rows_nnz == cols_nnz
    is_off = (cols_nnz < rows_nnz) if lower else (cols_nnz > rows_nnz)

    diag = np.ones(n, dtype=np.float64)
    if not unit_diagonal:
        dmask = is_diag
        diag_rows = rows_nnz[dmask]
        diag[diag_rows] = l.data[dmask]
        missing = np.setdiff1d(np.arange(n), diag_rows, assume_unique=False)
        if len(missing):
            raise ValueError(
                f"{len(missing)} rows have no diagonal entry "
                f"(first: {missing[:5]}); pass unit_diagonal=True or fix L"
            )
        if np.any(diag == 0.0):
            raise ValueError("zero diagonal entry; matrix is singular")

    off_rows = rows_nnz[is_off]
    off_cols = cols_nnz[is_off]
    off_vals = l.data[is_off]
    off_deg = np.bincount(off_rows, minlength=n)
    width = _round_up(max(int(off_deg.max(initial=0)), 1), width_multiple)

    # slot index for each original row
    slot_of_row = np.full(n + 1, -1, dtype=np.int64)
    live = slot_row != n
    slot_of_row[slot_row[live]] = np.flatnonzero(live)

    col = np.full((total, width), n, dtype=INDEX_DTYPE)  # n -> zero slot
    val = np.zeros((total, width), dtype=l.data.dtype)
    if len(off_rows):
        o_indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(off_deg, out=o_indptr[1:])
        pos = np.arange(len(off_rows)) - o_indptr[off_rows]
        col[slot_of_row[off_rows], pos] = off_cols
        val[slot_of_row[off_rows], pos] = off_vals

    inv_diag = np.ones(total, dtype=l.data.dtype)
    inv_diag[live] = (1.0 / diag[slot_row[live]]).astype(l.data.dtype)

    level_of_tile = np.repeat(
        np.arange(nlevels, dtype=INDEX_DTYPE), padded_sizes // tile_rows
    )
    sched = LevelSchedule(
        n=n, nnz=l.nnz, tile_rows=tile_rows, width=width, nlevels=nlevels,
        slot_row=slot_row, col=col, val=val, inv_diag=inv_diag,
        level_of_tile=level_of_tile, levels=levels,
    )
    return sched


def validate_schedule(sched: LevelSchedule) -> None:
    """Debug check (SURVEY.md §5 race-detection analogue): every slot's
    dependencies must resolve to strictly earlier tiles."""
    tr = sched.tile_rows
    tile_of_slot = np.arange(sched.padded_slots) // tr
    slot_of_row = np.full(sched.n + 1, -1, dtype=np.int64)
    live = sched.slot_row != sched.n
    slot_of_row[sched.slot_row[live]] = np.flatnonzero(live)
    dep_cols = sched.col[live]
    real = dep_cols != sched.n
    dep_tiles = tile_of_slot[slot_of_row[dep_cols[real]]]
    own_tiles = np.repeat(tile_of_slot[live], real.sum(axis=1))
    if not np.all(dep_tiles < own_tiles):
        bad = np.flatnonzero(dep_tiles >= own_tiles)[:5]
        raise AssertionError(f"schedule violates dependencies at {bad}")
    # no tile mixes levels
    lot = sched.level_of_tile
    assert len(lot) == sched.num_tiles
