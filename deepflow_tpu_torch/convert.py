"""Carry sketch state between the JAX package and this port.

The hash seeds are this system's weights: two runs agree only from the
same seeds and the same accumulated counts. `state_from_numpy` takes the
JAX package's FlowSuiteState (and FlowDictState) with numpy leaves, as
`jax.device_get` returns them, or the flat leaf list in the reference's
order, and builds the port's state on a device. `state_to_numpy` goes
back to that flat list, in the reference's leaf order and dtypes
(uint32 leaves come back as uint32, int32 as int32).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from deepflow_tpu_torch.models import flow_suite
from deepflow_tpu_torch.models.flow_dict import FlowDictState
from deepflow_tpu_torch.models.flow_suite import FlowSuiteState
from deepflow_tpu_torch.ops import cms, entropy, hll, topk

# FlowSuiteState leaves, depth first, with the reference's dtypes
SUITE_LEAVES: Tuple[Tuple[str, type], ...] = (
    ("sketch.counts", np.int32), ("sketch.seeds", np.uint32),
    ("ring.keys", np.uint32), ("ring.counts", np.int32),
    ("services.registers", np.int32),
    ("ent.hist", np.int32), ("ent.seeds", np.uint32),
    ("rows_seen", np.int32), ("batches_seen", np.int32),
)
DICT_LEAVES: Tuple[Tuple[str, type], ...] = (("table", np.uint32),)


def _get(obj, path: str):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _leaves(obj, spec) -> List[np.ndarray]:
    if hasattr(obj, spec[0][0].split(".")[0]):
        return [np.asarray(_get(obj, path)) for path, _ in spec]
    leaves = [np.asarray(x) for x in obj]
    if len(leaves) != len(spec):
        raise ValueError(f"expected {len(spec)} leaves, got {len(leaves)}")
    return leaves


def _to_torch(arr: np.ndarray, dtype, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype != np.dtype(dtype):
        raise ValueError(f"leaf dtype {arr.dtype}, expected {np.dtype(dtype)}")
    # a C-ordered copy that keeps 0-d leaves 0-d (np.ascontiguousarray
    # would make them 1-d)
    return torch.from_numpy(arr.astype(arr.dtype, order="C").view(np.int32)
                            ).to(device)


def state_from_numpy(suite, dict_state=None, device="cuda"
                     ) -> Tuple[FlowSuiteState, Optional[FlowDictState]]:
    """Reference leaves (numpy) -> (FlowSuiteState, FlowDictState or None)
    of this port on `device`."""
    device = flow_suite.check_device(device)
    t = [_to_torch(a, dt, device)
         for a, (_, dt) in zip(_leaves(suite, SUITE_LEAVES), SUITE_LEAVES)]
    state = FlowSuiteState(
        sketch=cms.CMSState(counts=t[0], seeds=t[1]),
        ring=topk.TopKState(keys=t[2], counts=t[3]),
        services=hll.HLLState(registers=t[4]),
        ent=entropy.EntropyState(hist=t[5], seeds=t[6]),
        rows_seen=t[7], batches_seen=t[8])
    dstate = None
    if dict_state is not None:
        (table,) = _leaves(dict_state, DICT_LEAVES)
        dstate = FlowDictState(table=_to_torch(table, np.uint32, device))
    return state, dstate


def _to_numpy(t: torch.Tensor, dtype) -> np.ndarray:
    # a copy on every device: on the CPU `.cpu()` would return the live
    # tensor, which the next in-place update changes under the caller
    return t.detach().to("cpu", copy=True).numpy().view(dtype)


def state_to_numpy(state: FlowSuiteState,
                   dstate: Optional[FlowDictState] = None
                   ) -> List[np.ndarray]:
    """The port's state -> numpy copies of its leaves in the reference's
    order and dtypes (the FlowDictState table last, when given)."""
    out = [_to_numpy(_get(state, path), dt) for path, dt in SUITE_LEAVES]
    if dstate is not None:
        out.append(_to_numpy(dstate.table, np.uint32))
    return out


def leaf_specs(state: FlowSuiteState) -> List[Tuple[tuple, np.dtype]]:
    """(shape, reference dtype) of each FlowSuiteState leaf, in the
    reference's order, without copying the state off its device."""
    return [(tuple(_get(state, path).shape), np.dtype(dt))
            for path, dt in SUITE_LEAVES]

