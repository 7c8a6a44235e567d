"""Whole-program concurrency rules: the lock-order graph
and the inconsistent-locking shared-write detector.

The threaded core of this pipeline (Supervisor-spawned receivers, pack
pools, pod shard workers, spill drainers, serving accept threads) keeps
its invariants with per-object locks, and the spill, sender and pod
layers multiplied how many of those locks can be held at once: a window
flush holds the sketch state lock while the spill drainer replays into
the queues, a pod epoch close walks every shard while each shard worker
holds its own state. Two rules prove the text can't deadlock or race
where that is provable:

- `lock-order-cycle` builds the project-wide lock acquisition graph —
  an edge A -> B wherever code lexically acquires B (directly, or
  transitively through self-method and member-object calls) while A is
  held — and flags every cycle, including the length-1 cycle of
  re-acquiring a non-reentrant Lock through a helper.
- `unlocked-shared-write` finds attributes touched from >= 2 thread
  entry points (Supervisor.spawn targets, `run` worker methods, the
  `put`/`puts` producer path) that the class itself treats as
  lock-protected (some write holds a lock) but writes at least once
  with no lock held — the inconsistent-locking race shape, which keeps
  the rule silent on deliberately lock-free counters and flags.

Both rules reason lexically per frame (a nested def's body does not run
where it is written) and only inside the concurrency core
(`runtime/`, `parallel/`, `batch/`, `serving/`): the agent/ reference
tree has its own idioms and its own baseline debt. The whole-program
facts are built once per scan and memoized on the ProjectIndex
(`index.memo`) — every file's check() queries the same model, which is
what keeps the lint runtime flat as rules accumulate.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from deepflow_tpu_torch.analysis.core import (Checker, ClassInfo, FileContext,
                                              Finding, ProjectIndex, dotted,
                                              register)

__all__ = ["LockOrderCycle", "UnlockedSharedWrite", "scoped"]

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)

# container methods that mutate their receiver: a call through
# self.<attr> to one of these is a WRITE of <attr> for race purposes
_MUTATORS = frozenset(["append", "appendleft", "extend", "insert",
                       "pop", "popleft", "popitem", "clear", "update",
                       "add", "remove", "discard", "setdefault",
                       "sort", "reverse", "rotate"])

# the concurrency core: the four packages whose thread topology the
# ledger invariants live in. agent/ (the ported reference tree)
# and decode/ (host-pure column math) stay out of scope.
_SCOPE_DIRS = ("runtime", "parallel", "batch", "serving")


def scoped(path: str) -> bool:
    parts = path.split("/")
    return any(d in parts[:-1] for d in _SCOPE_DIRS)


# a lock node: ("ClassName", "_lock_attr") — class-qualified because
# every instance of a class shares the same acquisition ORDER even
# though each instance has its own lock object
LockNode = Tuple[str, str]


@dataclass
class _MethodFacts:
    """Per-(class, method) lexical facts, one frame at a time."""

    # locks this method acquires directly: [(lock, with-node, held-at)]
    acquires: List[Tuple[LockNode, ast.AST, Tuple[LockNode, ...]]] = \
        field(default_factory=list)
    # self.<m>() call sites with the locks held at the call:
    # [(method name, call node, held)]
    self_calls: List[Tuple[str, ast.AST, Tuple[LockNode, ...]]] = \
        field(default_factory=list)
    # self.<attr>.<m>() where attr maps to a repo class:
    # [(attr, method name, call node, held)]
    member_calls: List[Tuple[str, str, ast.AST, Tuple[LockNode, ...]]] = \
        field(default_factory=list)
    # self.<X> reads/writes: [(attr, node, held, writing, frame label)]
    accesses: List[Tuple[str, ast.AST, Tuple[LockNode, ...], bool]] = \
        field(default_factory=list)


class _Model:
    """The memoized whole-program concurrency model."""

    def __init__(self, index: ProjectIndex) -> None:
        self.index = index
        # (path, class) -> ClassInfo for in-scope classes
        self.infos: Dict[Tuple[str, str], ClassInfo] = {}
        for infos in index.classes.values():
            for info in infos:
                if scoped(info.path):
                    self.infos[(info.path, info.name)] = info
        # (path, class, method) -> _MethodFacts
        self.facts: Dict[Tuple[str, str, str], _MethodFacts] = {}
        for (path, cname), info in sorted(self.infos.items()):
            for mname, mnode in sorted(info.method_asts.items()):
                self.facts[(path, cname, mname)] = self._collect(
                    info, mnode)
        self._acq_memo: Dict[Tuple[str, str, str],
                             Set[Tuple[LockNode, str]]] = {}
        # edges: (src, dst) -> anchor site (path, line, col, via) — the
        # FIRST site encountered, deterministic because construction
        # order is sorted
        self.edges: Dict[Tuple[LockNode, LockNode],
                         Tuple[str, int, int, str]] = {}
        self.self_deadlocks: List[Tuple[str, int, int, LockNode, str]] = []
        self._cycles: Optional[List[List[LockNode]]] = None
        self._build_edges()

    # -- per-method lexical pass ------------------------------------------
    def _collect(self, info: ClassInfo, method: ast.AST) -> _MethodFacts:
        facts = _MethodFacts()

        def visit_block(nodes, held: Tuple[LockNode, ...]) -> None:
            for node in nodes:
                visit(node, held)

        def visit(node: ast.AST, held: Tuple[LockNode, ...]) -> None:
            if isinstance(node, _FUNC_DEFS + (ast.Lambda,)):
                # a nested def runs later, holding nothing it didn't
                # take itself — fresh frame, same attribution
                body = node.body if isinstance(node.body, list) \
                    else [node.body]
                visit_block(body, ())
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                got: List[LockNode] = []
                for item in node.items:
                    lock = self._lock_of(item.context_expr, info)
                    if lock is not None:
                        facts.acquires.append((lock, item.context_expr,
                                               held + tuple(got)))
                        got.append(lock)
                for item in node.items:
                    visit(item.context_expr, held)
                visit_block(node.body, held + tuple(got))
                return
            if isinstance(node, ast.Call):
                d = dotted(node.func)
                if d is not None and d.startswith("self."):
                    parts = d.split(".")
                    if len(parts) == 2 and parts[1] in info.method_asts:
                        facts.self_calls.append((parts[1], node, held))
                    elif len(parts) == 3:
                        if parts[1] in info.attr_classes:
                            facts.member_calls.append(
                                (parts[1], parts[2], node, held))
                        if parts[2] in _MUTATORS:
                            # self._buf.append(x) mutates _buf as
                            # surely as self._buf = [...] rebinds it
                            facts.accesses.append(
                                (parts[1], node, held, True))
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, (ast.Store, ast.Del)):
                d = dotted(node.value)
                if d is not None and d.startswith("self.") \
                        and d.count(".") == 1:
                    facts.accesses.append(
                        (d.split(".", 1)[1], node, held, True))
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self":
                writing = isinstance(node.ctx, (ast.Store, ast.Del))
                facts.accesses.append((node.attr, node, held, writing))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        held0: Tuple[LockNode, ...] = ()
        visit_block(method.body, held0)
        return facts

    @staticmethod
    def _lock_of(expr: ast.AST, info: ClassInfo) -> Optional[LockNode]:
        d = dotted(expr)
        if d is None or not d.startswith("self.") or d.count(".") != 1:
            return None
        attr = d.split(".", 1)[1]
        if attr in info.lock_attrs:
            return (info.name, attr)
        return None

    # -- transitive acquisition -------------------------------------------
    def acquired_by(self, path: str, cname: str, mname: str,
                    _stack: Optional[Set] = None
                    ) -> Set[Tuple[LockNode, str]]:
        """Locks (lock, via-label) method (path, cname, mname) may
        acquire, transitively through self-method and member-object
        calls. Cycle-guarded; unresolvable callees contribute nothing
        (proven facts only)."""
        key = (path, cname, mname)
        memo = self._acq_memo.get(key)
        if memo is not None:
            return memo
        stack = _stack if _stack is not None else set()
        if key in stack:
            return set()
        stack.add(key)
        facts = self.facts.get(key)
        out: Set[Tuple[LockNode, str]] = set()
        if facts is not None:
            for lock, _node, _held in facts.acquires:
                out.add((lock, f"{cname}.{mname}"))
            for callee, _node, _held in facts.self_calls:
                for lock, via in self.acquired_by(path, cname, callee,
                                                 stack):
                    out.add((lock, via))
            for attr, callee, _node, _held in facts.member_calls:
                for dpath, dname in self._member_classes(path, cname,
                                                         attr):
                    for lock, via in self.acquired_by(dpath, dname,
                                                      callee, stack):
                        out.add((lock, via))
        stack.discard(key)
        if _stack is None:
            self._acq_memo[key] = out
        return out

    def _member_classes(self, path: str, cname: str,
                        attr: str) -> List[Tuple[str, str]]:
        """Resolve self.<attr> (constructor-assigned) to in-scope class
        candidates, honoring the file's imports like the rest of the
        index — an unresolvable member stays silent."""
        info = self.infos.get((path, cname))
        if info is None:
            return []
        leaf = info.attr_classes.get(attr)
        if leaf is None:
            return []
        cands = self.index._infos_for_name(path, leaf)
        if cands is None:
            return []
        return [(i.path, i.name) for i in cands
                if (i.path, i.name) in self.infos]

    # -- the graph ---------------------------------------------------------
    def _build_edges(self) -> None:
        for (path, cname, mname), facts in sorted(self.facts.items()):
            info = self.infos[(path, cname)]
            for lock, node, held in facts.acquires:
                if lock in held \
                        and info.lock_kinds.get(lock[1]) != "RLock":
                    self.self_deadlocks.append(
                        (path, node.lineno, node.col_offset, lock,
                         f"{cname}.{mname}"))
                for h in held:
                    if h != lock:
                        self._edge(h, lock, path, node,
                                   f"{cname}.{mname}")
            for callee, node, held in facts.self_calls:
                if not held:
                    continue
                for lock, via in sorted(self.acquired_by(path, cname,
                                                         callee)):
                    for h in held:
                        if h == lock \
                                and info.lock_kinds.get(h[1]) != "RLock" \
                                and lock[0] == cname:
                            self.self_deadlocks.append(
                                (path, node.lineno, node.col_offset,
                                 lock,
                                 f"{cname}.{mname} -> {via}"))
                        elif h != lock:
                            self._edge(h, lock, path, node,
                                       f"{cname}.{mname} -> {via}")
            for attr, callee, node, held in facts.member_calls:
                if not held:
                    continue
                for dpath, dname in self._member_classes(path, cname,
                                                         attr):
                    for lock, via in sorted(self.acquired_by(dpath,
                                                             dname,
                                                             callee)):
                        for h in held:
                            if h == lock \
                                    and info.lock_kinds.get(h[1]) \
                                    != "RLock":
                                # same non-reentrant lock re-acquired
                                # through the member chain: deadlock
                                # with no second thread, same as the
                                # self-call case
                                self.self_deadlocks.append(
                                    (path, node.lineno,
                                     node.col_offset, lock,
                                     f"{cname}.{mname} -> {via}"))
                            elif h != lock:
                                self._edge(h, lock, path, node,
                                           f"{cname}.{mname} -> {via}")

    def _edge(self, src: LockNode, dst: LockNode, path: str,
              node: ast.AST, via: str) -> None:
        self.edges.setdefault(
            (src, dst), (path, node.lineno, node.col_offset, via))

    def cycles(self) -> List[List[LockNode]]:
        """Simple cycles of the acquisition graph, one per strongly
        connected component, rotated to start at the smallest node so
        the rendered message (the baseline key) is stable. Memoized:
        every scoped file's check() asks, the graph decomposes once."""
        if self._cycles is not None:
            return self._cycles
        adj: Dict[LockNode, Set[LockNode]] = {}
        for (src, dst) in self.edges:
            adj.setdefault(src, set()).add(dst)
        sccs = _tarjan(adj)
        out: List[List[LockNode]] = []
        for scc in sccs:
            if len(scc) < 2:
                continue
            start = min(scc)
            cycle = _cycle_through(adj, scc, start)
            if cycle:
                out.append(cycle)
        out.sort()
        self._cycles = out
        return out


def _tarjan(adj: Dict[LockNode, Set[LockNode]]) -> List[Set[LockNode]]:
    index: Dict[LockNode, int] = {}
    low: Dict[LockNode, int] = {}
    on: Set[LockNode] = set()
    stack: List[LockNode] = []
    sccs: List[Set[LockNode]] = []
    counter = [0]
    nodes = sorted(set(adj) | {d for ds in adj.values() for d in ds})

    def strong(v: LockNode) -> None:
        # iterative Tarjan: lock graphs are small, but recursion depth
        # must not depend on project shape
        work = [(v, iter(sorted(adj.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                if w in on:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc: Set[LockNode] = set()
                while True:
                    w = stack.pop()
                    on.discard(w)
                    scc.add(w)
                    if w == node:
                        break
                sccs.append(scc)

    for v in nodes:
        if v not in index:
            strong(v)
    return sccs


def _cycle_through(adj: Dict[LockNode, Set[LockNode]],
                   scc: Set[LockNode],
                   start: LockNode) -> Optional[List[LockNode]]:
    """Shortest cycle from `start` back to itself inside its SCC (BFS,
    deterministic neighbor order)."""
    prev: Dict[LockNode, LockNode] = {}
    frontier = [start]
    seen = {start}
    while frontier:
        nxt: List[LockNode] = []
        for node in frontier:
            for w in sorted(adj.get(node, ())):
                if w not in scc:
                    continue
                if w == start:
                    cycle = [node]
                    cur = node
                    while cur != start:
                        cur = prev[cur]
                        cycle.append(cur)
                    cycle.reverse()       # [start, ..., node]
                    return cycle
                if w not in seen:
                    seen.add(w)
                    prev[w] = node
                    nxt.append(w)
        frontier = nxt
    return None


def _model(index: ProjectIndex) -> _Model:
    model = index.memo.get("concurrency")
    if model is None:
        model = _Model(index)
        index.memo["concurrency"] = model
    return model


def _fmt(node: LockNode) -> str:
    return f"{node[0]}.{node[1]}"


@register
class LockOrderCycle(Checker):
    """Deadlock by lock-order inversion is a whole-program property: no
    single file shows both halves of `flush -> spill._lock ->
    queues._lock` vs `drain -> queues._lock -> spill._lock`. This rule
    renders the project-wide acquisition graph and proves it acyclic —
    or names each cycle. The length-1 cycle (re-acquiring a
    non-reentrant Lock/Condition through a helper while already holding
    it) is reported too: that one needs no second thread to wedge."""

    name = "lock-order-cycle"
    description = ("cycle in the project-wide lock acquisition graph "
                   "(potential deadlock), or a non-reentrant lock "
                   "re-acquired while already held")

    def check(self, ctx: FileContext,
              index: ProjectIndex) -> Iterable[Finding]:
        if not scoped(ctx.path):
            return
        model = _model(index)
        for path, line, col, lock, via in model.self_deadlocks:
            if path != ctx.path:
                continue
            info = model.infos.get((path, lock[0]))
            kind = info.lock_kinds.get(lock[1], "Lock") if info else "Lock"
            yield Finding(
                self.name, ctx.path, line, col,
                f"{_fmt(lock)} is a non-reentrant {kind} re-acquired "
                f"via {via} while already held — this deadlocks with "
                f"no second thread involved",
                self.severity)
        for cycle in model.cycles():
            # anchor each cycle at its smallest edge site so the whole
            # cycle is ONE finding, pragma-able at one line
            sites = []
            for i, src in enumerate(cycle):
                dst = cycle[(i + 1) % len(cycle)]
                site = model.edges.get((src, dst))
                if site is not None:
                    sites.append((site, src, dst))
            if not sites:
                continue
            sites.sort(key=lambda s: (s[0][0], s[0][1], s[0][2]))
            (path, line, col, via), _src, _dst = sites[0]
            if path != ctx.path:
                continue
            ring = " -> ".join(_fmt(n) for n in cycle + [cycle[0]])
            yield Finding(
                self.name, ctx.path, line, col,
                f"lock-order cycle {ring}: two threads taking these "
                f"locks in opposing order deadlock; acquire in one "
                f"global order or detach before calling out "
                f"(first edge held here via {via})",
                self.severity)


# the producer-facing mutation methods that count as thread entry
# points beside spawn targets, callback handoffs and `run` workers:
# the main put path, plus the timeline's two cross-thread
# faces — `sample_once` is the sampler thread's per-tick entry (the
# spawn target is a closure, invisible to the self.<m> detector) and
# `prom_fetch` is the querier server threads' read entry into the
# same rings
_ENTRY_NAMES = frozenset(["run", "put", "puts", "put_batch",
                          "sample_once", "prom_fetch"])

# Reviewed per-file sanction (the _SANCTIONED_SYNCS_BY_FILE pattern):
# methods whose bare writes are governed by a documented ownership
# protocol instead of a lock. The overlapped feed makes the
# FEED THREAD the sole owner of the exporter's device state BETWEEN
# drain barriers — flush/checkpoint/probe only touch state after a
# barrier returned (see the "overlapped feed" section comment in
# runtime/tpu_sketch.py). Lock-free by design there, not by accident;
# a bare state write anywhere OUTSIDE this allowlist still fails.
_BARRIER_OWNED_BY_FILE = {
    "runtime/tpu_sketch.py": frozenset([
        "_feed_process", "_feed_process_group", "_feed_process_staged",
        "_dispatch_begin", "_dispatch_group", "_dispatch_staged",
        "_dispatch_lanes_group", "_dispatch_dict_group",
        # dict-wire twins of the staged pair above: the feed
        # thread owns state/_dict_state/host ledgers between the same
        # drain barriers; the dict path adds no new ownership rule
        "_feed_process_dict_staged", "_dispatch_dict_staged",
        "_absorb_dict_staged_host",
        "_absorb_tensorbatch", "_absorb_staged_host",
        "_staging_get", "_staging_release",
        "_feed_fence_error", "_feed_crash_restart",
        # shared by the locked inline path and the feed path — the two
        # are mode-exclusive (prefetch on/off), never concurrent
        "_timed_update",
        # the port's exporter splits the same two paths' shared steps
        # into helpers of their own (the H2D copy, a program's apply,
        # the host fallback's update, the attribution hand-off, the
        # stale-generation drop): each runs under the inline path's lock
        # or on the feed thread between drain barriers, never both at
        # once
        "_to_device", "_apply_wire", "_apply_lanes", "_host_update",
        "_take_attribution", "_drop_stale",
    ]),
    # runtime/autotune.py joins this rule with NO sanction
    # entry on purpose: the controller's only cross-thread syncs are
    # real locks — the module _REGISTRY_LOCK and the per-controller
    # _lock funneling every transition through _tick_locked /
    # _start_trial_locked / _fallback_locked — so it is held to the
    # plain lock discipline, not a barrier-ownership protocol.
}


@register
class UnlockedSharedWrite(Checker):
    """A data race needs three things the text can show: an attribute
    reachable from two thread roots, a class that protects it with a
    lock SOMEWHERE (so it is not a deliberately lock-free counter), and
    one write site that skips the lock. The pod ledger and the
    spill drainer both live exactly in this shape — `sent == delivered
    + host + lost + pending` only balances if every transition is
    under the shard state lock."""

    name = "unlocked-shared-write"
    description = ("attribute shared across thread entry points "
                   "(spawn targets / run / put) written both with and "
                   "without its lock — take the lock or move the write "
                   "into a *_locked helper")

    def check(self, ctx: FileContext,
              index: ProjectIndex) -> Iterable[Finding]:
        if not scoped(ctx.path):
            return
        model = _model(index)
        for (path, cname), info in sorted(model.infos.items()):
            if path != ctx.path:
                continue
            yield from self._check_class(model, path, cname, info)

    def _check_class(self, model: _Model, path: str, cname: str,
                     info: ClassInfo) -> Iterator[Finding]:
        entries = sorted((info.spawned | info.callbacks | _ENTRY_NAMES)
                         & set(info.method_asts))
        if len(entries) < 2:
            return
        reach = {e: self._reach(model, path, cname, e) for e in entries}
        owned = frozenset()
        for sfx, methods in _BARRIER_OWNED_BY_FILE.items():
            if path.endswith(sfx):
                owned = methods
        # attr -> entry roots touching it; writes split by lockedness
        touched: Dict[str, Set[str]] = {}
        locked_writes: Dict[str, int] = {}
        unlocked: Dict[str, List[Tuple[ast.AST, str]]] = {}
        for entry, methods in reach.items():
            for m in methods:
                facts = model.facts.get((path, cname, m))
                if facts is None:
                    continue
                is_locked_fn = m.endswith("_locked") or m in owned
                for attr, node, held, writing in facts.accesses:
                    if attr in info.lock_attrs:
                        continue
                    touched.setdefault(attr, set()).add(entry)
                    if not writing:
                        continue
                    if held or is_locked_fn:
                        locked_writes[attr] = \
                            locked_writes.get(attr, 0) + 1
                    else:
                        unlocked.setdefault(attr, []).append(
                            (node, f"{cname}.{m}"))
        # __init__ writes are construction (happens-before the spawn):
        # they neither condemn nor excuse — and they are not in any
        # entry's reach set, so nothing to subtract here.
        seen: Set[Tuple[int, int, str]] = set()
        for attr in sorted(unlocked):
            roots = touched.get(attr, set())
            if len(roots) < 2 or not locked_writes.get(attr):
                continue
            for node, where in unlocked[attr]:
                key = (node.lineno, node.col_offset, attr)
                if key in seen:
                    continue
                seen.add(key)
                yield Finding(
                    self.name, path, node.lineno, node.col_offset,
                    f"self.{attr} is written under a lock elsewhere in "
                    f"{cname} but written bare in {where}(), and it is "
                    f"reachable from thread entry points "
                    f"{'/'.join(sorted(roots))} — take the lock here "
                    f"or move this into a *_locked helper",
                    self.severity)

    @staticmethod
    def _reach(model: _Model, path: str, cname: str,
               entry: str) -> Set[str]:
        """Methods of (path, cname) transitively reachable from
        `entry` via self-calls (same class only: member objects have
        their own classes and their own entry analysis)."""
        out: Set[str] = set()
        stack = [entry]
        while stack:
            m = stack.pop()
            if m in out:
                continue
            out.add(m)
            facts = model.facts.get((path, cname, m))
            if facts is None:
                continue
            for callee, _node, _held in facts.self_calls:
                if callee not in out:
                    stack.append(callee)
        return out
