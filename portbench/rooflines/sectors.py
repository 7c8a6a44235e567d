"""Bytes of sketch state a scatter-add moves: each 32-byte sector that
holds a cell it changed, read once and written once. The cells come
from the launch's own inputs, so the data decides the count, not the
width of the state."""

from __future__ import annotations

import numpy as np

SECTOR_BYTES = 32
_CELLS = SECTOR_BYTES // 4          # int32 cells in a sector


def touched_bytes(*flat_cells: np.ndarray) -> int:
    """`flat_cells`: for each state, the flat int32 indices of the cells
    the launch changed (repeats allowed)."""
    return 2 * SECTOR_BYTES * sum(
        len(np.unique(np.asarray(c, np.int64) // _CELLS))
        for c in flat_cells)
