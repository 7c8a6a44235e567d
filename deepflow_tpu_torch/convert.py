"""Carry sketch state between the JAX package and this port.

The hash seeds are this system's weights: two runs agree only from the
same seeds and the same accumulated counts. `state_from_numpy` takes the
JAX package's FlowSuiteState (and FlowDictState) with numpy leaves, as
`jax.device_get` returns them, or the flat leaf list in the reference's
order, and builds the port's state on a device. `state_to_numpy` goes
back to that flat list, in the reference's leaf order and dtypes
(uint32 leaves come back as uint32, int32 as int32). The anomaly plane's,
the AppSuite's and the metrics suite's states move the same way; the
AppSuite's float32 leaves hold counts, which the port keeps as int32.
A sharded suite's per-shard list moves as the reference's stacked state,
every leaf with a leading device axis (`sharded_to_numpy`,
`sharded_from_numpy`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from deepflow_tpu_torch.models import app_suite, flow_suite, metrics_suite
from deepflow_tpu_torch.models.flow_dict import FlowDictState
from deepflow_tpu_torch.models.flow_suite import FlowSuiteState
from deepflow_tpu_torch.ops import (cms, ddsketch, entropy, hll,
                                    matrix_profile, pca, topk)

# FlowSuiteState leaves, depth first, with the reference's dtypes
SUITE_LEAVES: Tuple[Tuple[str, type], ...] = (
    ("sketch.counts", np.int32), ("sketch.seeds", np.uint32),
    ("ring.keys", np.uint32), ("ring.counts", np.int32),
    ("services.registers", np.int32),
    ("ent.hist", np.int32), ("ent.seeds", np.uint32),
    ("rows_seen", np.int32), ("batches_seen", np.int32),
)
DICT_LEAVES: Tuple[Tuple[str, type], ...] = (("table", np.uint32),)
# AnomalyState leaves, depth first, with the reference's dtypes
ANOMALY_LEAVES: Tuple[Tuple[str, type], ...] = (
    ("keys", np.uint32), ("born", np.int32), ("last_window", np.int32),
    ("offers", np.int32), ("evictions", np.int32), ("window", np.int32),
    ("ent_mean", np.float32), ("ent_var", np.float32),
    ("pca.mean", np.float32), ("pca.var", np.float32),
    ("pca.w", np.float32), ("pca.step", np.int32),
    ("res_mean", np.float32), ("res_var", np.float32),
    ("mp.ring", np.float32), ("mp.count", np.int32),
)
# AppSuiteState leaves, depth first, with the reference's dtypes
APP_LEAVES: Tuple[Tuple[str, type], ...] = (
    ("requests", np.float32), ("errors", np.float32),
    ("rrt.hist", np.float32), ("rrt.zeros", np.float32),
)

# MetricsSuiteState leaves, depth first, with the reference's dtypes
METRICS_LEAVES: Tuple[Tuple[str, type], ...] = (
    ("ent.hist", np.int32), ("ent.seeds", np.uint32),
    ("ent_mean", np.float32), ("ent_var", np.float32),
    ("windows", np.int32),
    ("pca.mean", np.float32), ("pca.var", np.float32),
    ("pca.w", np.float32), ("pca.step", np.int32),
    ("win_sum", np.float32),
    ("mp.ring", np.float32), ("mp.count", np.int32),
)


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
    # would make them 1-d); uint32 is held as int32 bits
    arr = arr.astype(arr.dtype, order="C")
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr).to(device)


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


def anomaly_from_numpy(state, device="cuda"):
    """The reference's AnomalyState with numpy leaves (or its flat leaf
    list) -> fresh tensors of this port's AnomalyState on `device`."""
    # imported here: the anomaly package's alerts module imports this one
    from deepflow_tpu_torch.anomaly import detectors

    device = flow_suite.check_device(device)
    t = [_to_torch(a, dt, device)
         for a, (_, dt) in zip(_leaves(state, ANOMALY_LEAVES),
                               ANOMALY_LEAVES)]
    return detectors.AnomalyState(
        keys=t[0], born=t[1], last_window=t[2], offers=t[3],
        evictions=t[4], window=t[5], ent_mean=t[6], ent_var=t[7],
        pca=pca.PCAState(mean=t[8], var=t[9], w=t[10], step=t[11]),
        res_mean=t[12], res_var=t[13],
        mp=matrix_profile.MPState(ring=t[14], count=t[15]))


def anomaly_to_numpy(state) -> List[np.ndarray]:
    """The port's AnomalyState -> numpy copies of its leaves in the
    reference's order and dtypes (0-d leaves stay 0-d)."""
    return [_to_numpy(_get(state, path), dt) for path, dt in ANOMALY_LEAVES]


def _counts_to_torch(arr: np.ndarray, device) -> torch.Tensor:
    """A float32 leaf of whole counts -> an int32 tensor of them."""
    arr = np.asarray(arr)
    if arr.dtype != np.float32:
        raise ValueError(f"leaf dtype {arr.dtype}, expected float32")
    if not (np.all(arr >= 0) and np.all(arr <= np.iinfo(np.int32).max)
            and np.array_equal(arr, np.floor(arr))):
        raise ValueError("AppSuite leaf holds values that are not int32 "
                         "counts")
    return torch.from_numpy(arr.astype(np.int32)).to(device)


def app_from_numpy(state, device="cuda") -> app_suite.AppSuiteState:
    """The reference's AppSuiteState with numpy leaves (or its flat leaf
    list) -> fresh int32 tensors of this port's AppSuiteState on
    `device`."""
    device = flow_suite.check_device(device)
    t = [_counts_to_torch(a, device) for a in _leaves(state, APP_LEAVES)]
    return app_suite.AppSuiteState(
        requests=t[0], errors=t[1],
        rrt=ddsketch.DDSketchState(hist=t[2], zeros=t[3]))


def app_to_numpy(state: app_suite.AppSuiteState) -> List[np.ndarray]:
    """The port's AppSuiteState -> float32 numpy leaves in the
    reference's order."""
    return [_get(state, path).detach().to("cpu", torch.float32,
                                          copy=True).numpy()
            for path, _ in APP_LEAVES]


def metrics_from_numpy(state, device="cuda") -> metrics_suite.MetricsSuiteState:
    """The reference's MetricsSuiteState with numpy leaves (or its flat
    leaf list) -> fresh tensors of this port's state on `device`."""
    device = flow_suite.check_device(device)
    t = [_to_torch(a, dt, device)
         for a, (_, dt) in zip(_leaves(state, METRICS_LEAVES),
                               METRICS_LEAVES)]
    return metrics_suite.MetricsSuiteState(
        ent=entropy.EntropyState(hist=t[0], seeds=t[1]),
        ent_mean=t[2], ent_var=t[3], windows=t[4],
        pca=pca.PCAState(mean=t[5], var=t[6], w=t[7], step=t[8]),
        win_sum=t[9],
        mp=matrix_profile.MPState(ring=t[10], count=t[11]))


def metrics_to_numpy(state: metrics_suite.MetricsSuiteState
                     ) -> List[np.ndarray]:
    """The port's MetricsSuiteState -> numpy copies of its leaves in the
    reference's order and dtypes."""
    return [_to_numpy(_get(state, path), dt) for path, dt in METRICS_LEAVES]


def _dict_to_numpy(dstate: FlowDictState) -> List[np.ndarray]:
    return [_to_numpy(dstate.table, np.uint32)]


def _dict_from_numpy(leaves, device) -> FlowDictState:
    (table,) = _leaves(leaves, DICT_LEAVES)
    return FlowDictState(table=_to_torch(table, np.uint32,
                                         flow_suite.check_device(device)))


# kind -> (state type, leaf spec, to numpy, from numpy on a device)
_SHARDED = {
    "flow": (FlowSuiteState, SUITE_LEAVES, state_to_numpy,
             lambda leaves, dev: state_from_numpy(leaves, device=dev)[0]),
    "dict": (FlowDictState, DICT_LEAVES, _dict_to_numpy, _dict_from_numpy),
    "app": (app_suite.AppSuiteState, APP_LEAVES, app_to_numpy,
            app_from_numpy),
    "metrics": (metrics_suite.MetricsSuiteState, METRICS_LEAVES,
                metrics_to_numpy, metrics_from_numpy),
}


def sharded_to_numpy(states) -> List[np.ndarray]:
    """A sharded suite's per-shard states (or dict table replicas) -> the
    reference's stacked leaves: each leaf's per-shard copies stacked on a
    leading device axis, in the reference's order and dtypes."""
    to_numpy = next(v[2] for v in _SHARDED.values()
                    if isinstance(states[0], v[0]))
    return [np.stack(ls) for ls in zip(*map(to_numpy, states))]


def sharded_from_numpy(stacked, kind: str, devices) -> list:
    """The reference's stacked sharded state (a state with numpy leaves
    or its flat leaf list; `kind` one of "flow", "dict", "app",
    "metrics") -> one fresh state per shard, shard d on devices[d]."""
    _, spec, _, from_numpy = _SHARDED[kind]
    leaves = _leaves(stacked, spec)
    if any(a.shape[0] != len(devices) for a in leaves):
        raise ValueError(f"leading axis is not {len(devices)} shards")
    return [from_numpy([a[d] for a in leaves], dev)
            for d, dev in enumerate(devices)]
