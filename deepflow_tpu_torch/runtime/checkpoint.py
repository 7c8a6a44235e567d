"""Sketch-state checkpointing: the historical name over the snapshot bus.

A copy of the JAX package's `runtime/checkpoint.py`: `SketchCheckpointer`
is the same object as `runtime/snapbus.SnapshotBus`, which serves the
querier's reads (`serving/`), degraded-mode restore and restart replay
from one snapshot format: atomic rolling npz snapshots of one state,
fsynced file then directory around the rename; a restart loses at most
one window; an incompatible snapshot (a changed config) is refused, not
misloaded. New code imports `runtime/snapbus.py` directly.
"""

from __future__ import annotations

from deepflow_tpu_torch.runtime.snapbus import SketchSnapshot, SnapshotBus

__all__ = ["SketchCheckpointer", "SketchSnapshot", "SnapshotBus"]

# the historical name: identical object, not a subclass, so isinstance
# checks and counters stay interchangeable across the rename
SketchCheckpointer = SnapshotBus
