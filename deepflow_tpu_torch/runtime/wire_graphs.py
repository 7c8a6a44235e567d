"""The dict wire's per-signature program, replayed from CUDA graphs.

A group's program (`flow_dict.make_wire_update`) is some 420 small
launches a plane. Issued one by one from the feed thread, each costs a
trip through the interpreter lock that the worker thread also wants, and
the card waits on the host. The program makes no host sync (each
plane's n is read on the device), so on a CUDA stream `WireGraphs`
captures it once per signature, at its second sighting (the first runs
eagerly and warms what a capture cannot load: lazily loaded modules,
the sorts' temporary storage), and replays it for every later group of
that signature.

- State. Every graph reads and writes one static set of tensors: the
  FlowSuiteState's leaves and the dict table. The captured program ends
  by copying the leaves it makes anew (the ring, the row and batch
  counters) into their static tensors; it updates the rest in place.
  Before a replay, a leaf of the caller's state that is not its static
  tensor (a window flush's fresh state, a restore, an eager run's new
  ring) is copied in.
- Input. Each signature reads a static buffer of its words: a group's
  words are copied into it on the compute stream just before the replay,
  behind the compute stream's wait on the H2D copy.
- Hand kernels. The fused sketch kernels (ops/cuda_sketch) are not
  captured: each call ends a graph segment and is made from the host
  between two segments, on views of the group's own input tensor and on
  a copy of any plane a graph computed. Each launch owns its inputs as
  an eager launch does, and is counted where eager launches are.
- Memory. All graphs share one pool. Replays are serialized on one
  stream, and nothing a graph computes outlives its group.

A capture that raises ends cleanly: its signature then runs eagerly for
the object's life (`l4_graph_capture_failures`), and no row is lost. On
the CPU every program runs eagerly.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Set

import torch

from deepflow_tpu_torch.ops import cuda_sketch

_LOG = logging.getLogger(__name__)

# arguments of the fused kernels that they add into in place
# (cms_counts, ent_hist): these must be static tensors
_KERNEL_OUTPUTS = (2, 3)


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a NamedTuple tree, depth first."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in _leaves(sub)]


def _rebuild(tree, leaves):
    """`tree` with its tensors taken in `_leaves` order from the
    iterator `leaves`."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    return type(tree)(*(_rebuild(sub, leaves) for sub in tree))


def _arg(plan, flat_d: torch.Tensor):
    kind, x = plan
    if kind == "input":
        shape, stride, offset = x
        return flat_d.as_strided(shape, stride,
                                 flat_d.storage_offset() + offset)
    if kind == "copy":
        return x.clone()
    return x


class _Replay:
    """One signature's captured program: graph segments and host
    launches in program order, over its static input buffer."""

    def __init__(self, flat: torch.Tensor) -> None:
        self.flat = flat
        self.steps: list = []     # a CUDAGraph, or (fn, argument plans)

    def run(self, flat_d: torch.Tensor) -> None:
        self.flat.copy_(flat_d)
        for step in self.steps:
            if isinstance(step, tuple):
                fn, plans = step
                fn(*(_arg(p, flat_d) for p in plans))
            else:
                step.replay()


class WireGraphs:
    """Runs the dict wire's programs for one exporter: eagerly on the
    CPU and at a signature's first sighting, from CUDA graphs captured on
    `stream` after that. Called on one thread at a time (the exporter's
    feed thread, or its inline path under the state lock)."""

    CAPTURE_AT = 2     # the sighting of a signature that captures it

    def __init__(self, stream: Optional[torch.cuda.Stream]) -> None:
        self._stream = stream
        self._pool = torch.cuda.graph_pool_handle() \
            if stream is not None else None
        self._replays: Dict[tuple, _Replay] = {}
        self._seen: Dict[tuple, int] = {}
        self._eager_only: Set[tuple] = set()
        self._static: Optional[List[torch.Tensor]] = None
        self._state = self._dstate = None
        self.captures = 0
        self.replays = 0
        self.eager = 0
        self.capture_failures = 0

    def run(self, sig, prog, state, dstate, flat_d: torch.Tensor):
        """Apply `prog` (the signature's program) to one group's words
        `flat_d` on the current stream; returns (state, dstate)."""
        rep = self._replays.get(sig)
        if rep is None:
            if self._stream is None or sig in self._eager_only \
                    or self._sighting(sig) < self.CAPTURE_AT:
                return self._eager(prog, state, dstate, flat_d)
            self._bind(state, dstate)
            rep = self._capture(sig, prog, flat_d)
            if rep is None:
                return self._eager(prog, self._state, self._dstate, flat_d)
        else:
            self._bind(state, dstate)
        rep.run(flat_d)
        self.replays += 1
        return self._state, self._dstate

    def clear(self) -> None:
        """Drop every graph (the program cache was cleared); later
        captures take a new pool."""
        self._replays.clear()
        self._seen.clear()
        if self._stream is not None:
            self._pool = torch.cuda.graph_pool_handle()

    def counters(self) -> dict:
        return {"l4_graph_captures": self.captures,
                "l4_graph_replays": self.replays,
                "l4_graph_eager": self.eager,
                "l4_graph_capture_failures": self.capture_failures}

    def _eager(self, prog, state, dstate, flat_d):
        self.eager += 1
        state, dstate, _ = prog(state, dstate, flat_d)
        return state, dstate

    def _sighting(self, sig) -> int:
        n = self._seen[sig] = self._seen.get(sig, 0) + 1
        return n

    def _bind(self, state, dstate) -> None:
        """Make the static set hold the caller's state: a leaf that is
        not its static tensor is copied in."""
        leaves = _leaves(state) + _leaves(dstate)
        if self._static is None:
            self._static = [torch.empty_like(t) for t in leaves]
            it = iter(self._static)
            self._state, self._dstate = _rebuild(state, it), \
                _rebuild(dstate, it)
        for s, t in zip(self._static, leaves):
            if t is not s:
                s.copy_(t)

    def _plan(self, i: int, a, flat: torch.Tensor, static: Set[int]):
        """How a replay passes argument `i` of a split-off kernel call:
        a view of the group's input, a static tensor, a copy of a plane
        the graph computed, or a host value."""
        if not isinstance(a, torch.Tensor):
            return ("value", a)
        ptr = a.untyped_storage().data_ptr()
        if ptr == flat.untyped_storage().data_ptr() \
                and a.dtype == flat.dtype:
            return ("input", (tuple(a.shape), a.stride(),
                              a.storage_offset() - flat.storage_offset()))
        if ptr in static:
            return ("static", a)
        if i in _KERNEL_OUTPUTS:
            raise ValueError(f"kernel output argument {i} is not a static "
                             "state tensor")
        return ("copy", a)

    def _capture(self, sig, prog, flat_d: torch.Tensor
                 ) -> Optional[_Replay]:
        """Capture `prog` against the static set and a new static input
        buffer, split at the hand kernels; None when the capture
        failed."""
        rep = _Replay(torch.empty_like(flat_d))
        static = {t.untyped_storage().data_ptr() for t in self._static}
        open_graph = []

        def begin():
            g = torch.cuda.CUDAGraph()
            g.capture_begin(pool=self._pool,
                            capture_error_mode="thread_local")
            open_graph.append(g)

        def end():
            g = open_graph.pop()
            g.capture_end()
            rep.steps.append(g)

        def split(fn, args):
            end()
            rep.steps.append((fn, tuple(self._plan(i, a, rep.flat, static)
                                        for i, a in enumerate(args))))
            begin()

        try:
            begin()
            with cuda_sketch.split_launches(split):
                state, dstate, _ = prog(self._state, self._dstate, rep.flat)
            for s, t in zip(self._static, _leaves(state) + _leaves(dstate)):
                if t is not s:
                    s.copy_(t)
            end()
        except Exception:     # a capture fault is no device fault
            _LOG.exception("dict wire signature %s not capturable; it runs "
                           "eagerly", sig)
            if open_graph:
                self._abort(open_graph.pop())
            # the allocator records into a pool again neither after a
            # failed capture nor once all its graphs are freed
            self._pool = torch.cuda.graph_pool_handle()
            self.capture_failures += 1
            self._eager_only.add(sig)
            return None
        self._replays[sig] = rep
        self.captures += 1
        return rep

    def _abort(self, graph: torch.cuda.CUDAGraph) -> None:
        """End a failed capture. An invalidated capture's end raises
        before the allocator stops routing the stream to the pool, so
        that routing is ended here too."""
        try:
            graph.capture_end()
        except RuntimeError:
            try:
                torch._C._cuda_endAllocateToPool(
                    self._stream.device.index, self._pool)
            except RuntimeError:
                pass     # this torch ended the routing itself
