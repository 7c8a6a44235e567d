"""The per-file deepflow-lint rules (the original six plus
silent-drop). Each guards an incident class paid for once already;
the docstrings name the original failure so the rule stays reviewable
against its reason to exist. The whole-program concurrency and twin
rules live in concurrency.py / twins.py.

All checkers are lexical (stdlib `ast`): they prove properties of the
program TEXT, not the runtime. Where a rule cannot decide statically
(an external base class, an unresolvable receiver) it stays silent —
a linter that cries wolf gets pragma'd into uselessness. Grandfathered
true positives live in the committed baseline instead.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from deepflow_tpu_torch.analysis.core import (Checker, FileContext, Finding,
                                              ProjectIndex, dotted, register)

__all__ = ["UnsupervisedThread", "EmitUnderLock", "HostSyncInDevicePath",
           "TraceUnsafeJit", "CountableMissingCounters", "FaultSiteDrift",
           "SilentDrop"]

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _walk_scoped(node: ast.AST, cls: Optional[str] = None,
                 funcs: Tuple[str, ...] = ()
                 ) -> Iterator[Tuple[ast.AST, Optional[str],
                                     Tuple[str, ...]]]:
    """Yield (node, enclosing class, enclosing function stack)."""
    for child in ast.iter_child_nodes(node):
        yield child, cls, funcs
        if isinstance(child, ast.ClassDef):
            yield from _walk_scoped(child, child.name, funcs)
        elif isinstance(child, _FUNC_DEFS):
            yield from _walk_scoped(child, cls, funcs + (child.name,))
        else:
            yield from _walk_scoped(child, cls, funcs)


def _scope_label(cls: Optional[str], funcs: Tuple[str, ...]) -> str:
    if funcs:
        return f"{cls}.{funcs[-1]}" if cls else funcs[-1]
    return cls or "<module>"


def _walk_same_frame(root: ast.AST) -> Iterator[ast.AST]:
    """Walk `root`'s subtree WITHOUT descending into nested function
    definitions: code inside a nested def is not executed where it is
    defined, so lexical held-a-lock reasoning must stop at the frame."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, _FUNC_DEFS + (ast.Lambda,)):
            stack.extend(ast.iter_child_nodes(node))


@register
class UnsupervisedThread(Checker):
    """The supervision tree exists because raising workers died
    silently and their lane went dark with no counter moving. A bare
    `threading.Thread(...)` re-opens exactly that hole: no crash
    capture, no backoff restart, no deadman heartbeat. Only
    runtime/supervisor.py may construct threads."""

    name = "unsupervised-thread"
    description = ("bare threading.Thread() outside runtime/supervisor.py "
                   "— spawn through Supervisor.spawn")

    def check(self, ctx: FileContext,
              index: ProjectIndex) -> Iterable[Finding]:
        if ctx.path.endswith("runtime/supervisor.py"):
            return
        aliases = set()        # names bound to threading.Thread itself
        mod_aliases = set()    # names bound to the threading module
        for n in ast.walk(ctx.tree):
            if isinstance(n, ast.ImportFrom) and n.module == "threading":
                aliases |= {a.asname or a.name for a in n.names
                            if a.name == "Thread"}
            elif isinstance(n, ast.Import):
                mod_aliases |= {a.asname or a.name for a in n.names
                                if a.name == "threading"}
        for node, cls, funcs in _walk_scoped(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if d is None:
                continue
            if d in aliases \
                    or any(d == f"{m}.Thread" for m in mod_aliases) \
                    or d == "threading.Thread" \
                    or d.endswith(".threading.Thread") \
                    or d.endswith("._threading.Thread"):
                yield self.finding(
                    ctx, node,
                    f"bare threading.Thread() in "
                    f"{_scope_label(cls, funcs)}: spawn through "
                    f"Supervisor.spawn for crash capture, restart and "
                    f"deadman beats")


_EMIT_METHODS = frozenset(["emit", "put", "puts", "send", "observe"])


@register
class EmitUnderLock(Checker):
    """The throttler deadlock: ThrottlingQueue emitted downstream
    while holding its reservoir lock, and a re-entrant emit wedged every
    decoder. The fix was swap-under-lock (detach state under the lock,
    emit after release; see runtime/throttler.py `_swap_locked`). This
    rule flags emit/put/send/observe calls lexically inside a
    `with self.<lock>:` body — or anywhere in a function whose
    `_locked` suffix promises the caller already holds one."""

    name = "emit-under-lock"
    description = ("metrics/queue/exporter emit while holding a lock — "
                   "use the swap-under-lock pattern")

    def check(self, ctx: FileContext,
              index: ProjectIndex) -> Iterable[Finding]:
        seen: Set[Tuple[int, int]] = set()
        for node, cls, funcs in _walk_scoped(ctx.tree):
            if isinstance(node, ast.With):
                lock = self._lock_name(node, cls, ctx.path, index)
                if lock:
                    yield from self._scan(
                        ctx, node, f"while holding {lock}", seen)
            elif isinstance(node, _FUNC_DEFS) \
                    and node.name.endswith("_locked"):
                yield from self._scan(
                    ctx, node,
                    f"inside {node.name}() (the _locked suffix means the "
                    f"caller holds a lock)", seen)

    @staticmethod
    def _lock_name(node: ast.With, cls: Optional[str], path: str,
                   index: ProjectIndex) -> Optional[str]:
        for item in node.items:
            d = dotted(item.context_expr)
            if d is None:
                continue
            leaf = d.rsplit(".", 1)[-1]
            if "lock" in leaf.lower() or "mutex" in leaf.lower():
                return d
            # `with self._ready:` where _ready = threading.Condition(...)
            if cls and d.startswith("self.") \
                    and leaf in index.lock_attrs_of(cls, path):
                return d
        return None

    def _scan(self, ctx: FileContext, root: ast.AST, why: str,
              seen: Set[Tuple[int, int]]) -> Iterable[Finding]:
        for sub in _walk_same_frame(root):
            if not (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)):
                continue
            if sub.func.attr.lstrip("_") not in _EMIT_METHODS:
                continue
            at = (sub.lineno, sub.col_offset)
            if at in seen:        # a with-lock inside a _locked function
                continue
            seen.add(at)
            d = dotted(sub.func) or sub.func.attr
            yield self.finding(
                ctx, sub,
                f"{d}() {why}: a slow or re-entrant emit deadlocks every "
                f"caller — detach under the lock, emit after release "
                f"(swap-under-lock)")


_DEVICE_PATH_SUFFIXES = ("runtime/tpu_sketch.py", "runtime/app_red.py",
                         "runtime/feed.py", "runtime/audit.py",
                         "runtime/profiler.py", "serving/cache.py",
                         "serving/tables.py", "serving/anomaly.py",
                         "batch/staging.py", "anomaly/detectors.py",
                         "anomaly/alerts.py",
                         # the self-telemetry sampler and the
                         # incident recorder run BESIDE the device
                         # pipeline on every deployment — a device sync
                         # on the sampler tick would serialize dispatch
                         # once per second forever; both must stay
                         # host-pure (zero sanctioned syncs)
                         "runtime/timeline.py", "runtime/incident.py",
                         # the feed autotuner ticks beside
                         # the device pipeline for the life of the
                         # exporter — a device sync on the control
                         # tick would serialize dispatch once per
                         # interval, which is exactly the stall the
                         # controller exists to remove. It reads only
                         # the exporter's host-side counters; zero
                         # sanctioned syncs, same stance as the
                         # sampler
                         "runtime/autotune.py")
# the sampled-drain helpers where a blocking sync is the point: explicit
# attribution drains on every Nth batch / cold compile, the
# degraded-mode device probe, the overlapped feed's
# bounded-window fence — the ONE place the prefetch pipeline may block
# on the device —
# and the accuracy observatory's window close
# ONE global set of sanctioned sync HELPER names (functions whose whole
# point is the blocking device fetch), replacing the earlier
# per-FILE allowlist: the finding is now a device VALUE
# reaching a materializer, not a file — see the per-value pass below,
# which covers every file via the devprog jit-site index. Beyond the
# original sampled-drain helpers, the set carries: `device_lost` (the
# anomaly plane's once-per-device-error baseline salvage),
# `_contribute`/`_probe_device` (the pod epoch protocol's one
# device_get per shard per epoch + the degraded-recovery probe on
# the shard ladder), and `_merge_global`/`_close_epoch_collective`
# (the cross-host epoch merge — the one stacked device program of the
# DCN path). serving/cache.py's `refresh` needed no sanction at all:
# it re-reads the bus/disk, never the device.
_SANCTIONED_SYNCS = frozenset(["_to_device", "_timed_update", "put_batch",
                               "_probe_device_locked", "_fence_one",
                               "_discard_inflight", "close_window",
                               "_compare", "device_lost", "_contribute",
                               "_probe_device", "_merge_global",
                               "_close_epoch_collective"])


@register
class HostSyncInDevicePath(Checker):
    """The attribution work kept the device pipeline async on
    purpose: a `block_until_ready` (or `.item()` / `device_get`
    materialization) on the hot path serializes dispatch against the
    device and caps throughput at one batch in flight. Blocking drains
    are allowed only inside the sanctioned sampled-drain helpers."""

    name = "host-sync-in-device-path"
    description = ("blocking device sync (block_until_ready/device_get/"
                   ".item(), or np.asarray/float/int materializing "
                   "device state) in the async device path — or a "
                   "jitted program's result value materialized in ANY "
                   "file — outside the sanctioned sync helpers")

    def check(self, ctx: FileContext,
              index: ProjectIndex) -> Iterable[Finding]:
        # the lazy import keeps the module graph acyclic: devprog is
        # the whole-program jit index, this file is per-file rules
        from deepflow_tpu_torch.analysis import devprog
        seen: Set[Tuple[int, int]] = set()
        if ctx.path.endswith(_DEVICE_PATH_SUFFIXES) \
                or "/parallel/" in f"/{ctx.path}":
            for node, cls, funcs in _walk_scoped(ctx.tree):
                if not isinstance(node, ast.Call):
                    continue
                if any(f in _SANCTIONED_SYNCS for f in funcs):
                    continue
                what = self._sync_kind(node)
                if what:
                    seen.add((node.lineno, node.col_offset))
                    yield self.finding(
                        ctx, node,
                        f"{what} in {_scope_label(cls, funcs)} blocks "
                        f"the async device pipeline; host syncs belong "
                        f"in the sampled-drain helpers "
                        f"({', '.join(sorted(_SANCTIONED_SYNCS))})")
        # per-VALUE pass, every file: a value provably
        # produced by a jitted program reaching a materializer outside
        # the sanctioned helpers is the finding — the device path is
        # wherever device values flow, not a list of files
        for node, what, var, producer, scope in devprog.device_value_syncs(
                ctx, index, _SANCTIONED_SYNCS):
            at = (node.lineno, node.col_offset)
            if at in seen:
                continue
            seen.add(at)
            yield self.finding(
                ctx, node,
                f"{what} on '{var}' — a device value produced by "
                f"{producer}() — in {scope} forces a blocking device "
                f"sync; materialize at the sanctioned sync boundaries "
                f"({', '.join(sorted(_SANCTIONED_SYNCS))})")

    @staticmethod
    def _sync_kind(node: ast.Call) -> Optional[str]:
        if isinstance(node.func, ast.Attribute):
            if node.func.attr == "block_until_ready":
                return "block_until_ready()"
            if node.func.attr == "item" and not node.args:
                return ".item()"
        d = dotted(node.func)
        if d and (d == "device_get" or d.endswith(".device_get")):
            return "jax.device_get()"
        # np.asarray/float/int materialize (D2H-fetch) their argument.
        # Host arrays are everywhere in these files, so only flag when
        # the argument mentions the device-resident sketch *state* —
        # the one thing that is ALWAYS a device value here. Broader
        # device locals are beyond lexical reach; the unconditional
        # primitives above catch their sync points instead.
        if d in ("np.asarray", "numpy.asarray", "float", "int") \
                and node.args:
            for sub in ast.walk(node.args[0]):
                name = sub.attr if isinstance(sub, ast.Attribute) else (
                    sub.id if isinstance(sub, ast.Name) else "")
                if "state" in name:
                    return f"{d}() on device state"
        return None


_JIT_LEAVES = frozenset(["jit", "pmap", "shard_map"])
_TIME_CALLS = frozenset(["time.time", "time.perf_counter", "time.monotonic",
                         "time.time_ns", "time.perf_counter_ns"])
# numpy attributes that are compile-time-static by construction (dtype
# objects and their queries) — everything else under np.* runs at TRACE
# time and bakes its result into the compiled program as a constant
_NP_STATIC = frozenset(["dtype", "iinfo", "finfo", "uint8", "uint16",
                        "uint32", "uint64", "int8", "int16", "int32",
                        "int64", "float16", "float32", "float64", "bool_",
                        "intp", "ndim", "shape"])


@register
class TraceUnsafeJit(Checker):
    """A jitted function's Python body runs ONCE, at trace time:
    `time.time()` freezes the compile timestamp into the program,
    `random.*` freezes one draw, `np.*` constant-folds host math,
    `print` fires only on recompiles, and `.item()` forces a host sync
    mid-trace. The reference hit this class once (compile-time constants
    poisoning kernel quantiles). Flags hazards inside functions/lambdas
    reachable from jax.jit / pmap / shard_map call sites and
    decorators, following module-local helper calls (bare names and
    self.<method>) with a visited set; cross-module calls are not
    traversed."""

    name = "trace-unsafe-jit"
    description = ("host-side effect (time/random/np/print/.item) inside "
                   "a function passed to jax.jit/shard_map/pmap")

    def check(self, ctx: FileContext,
              index: ProjectIndex) -> Iterable[Finding]:
        defs: Dict[str, ast.AST] = {
            n.name: n for n in ast.walk(ctx.tree)
            if isinstance(n, _FUNC_DEFS)}
        targets: List[Tuple[ast.AST, str]] = []
        seen: Set[int] = set()

        def add(node: ast.AST, label: str) -> None:
            if id(node) not in seen:
                seen.add(id(node))
                targets.append((node, label))

        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                d = dotted(node.func)
                if self._is_wrapper(d) and node.args:
                    arg = node.args[0]
                    if isinstance(arg, ast.Lambda):
                        add(arg, f"lambda passed to {d}")
                    elif isinstance(arg, ast.Name) and arg.id in defs:
                        add(defs[arg.id], f"{arg.id}() (wrapped by {d})")
            elif isinstance(node, _FUNC_DEFS):
                for dec in node.decorator_list:
                    if self._decorator_jits(dec):
                        add(node, f"{node.name}() (jitted by decorator)")
        for target, label in targets:
            yield from self._scan(ctx, target, label, defs, set())

    @staticmethod
    def _is_wrapper(d: Optional[str]) -> bool:
        return d is not None and d.rsplit(".", 1)[-1] in _JIT_LEAVES

    @classmethod
    def _decorator_jits(cls, dec: ast.AST) -> bool:
        if cls._is_wrapper(dotted(dec)):
            return True                        # @jax.jit
        if isinstance(dec, ast.Call):
            d = dotted(dec.func)
            if cls._is_wrapper(d):
                return True                    # @jax.jit(static_argnames=..)
            if d and d.rsplit(".", 1)[-1] == "partial" and dec.args:
                return cls._is_wrapper(dotted(dec.args[0]))
        return False

    def _scan(self, ctx: FileContext, root: ast.AST, label: str,
              defs: Dict[str, ast.AST],
              visited: Set[int]) -> Iterable[Finding]:
        if id(root) in visited:
            return
        visited.add(id(root))
        for sub in ast.walk(root):
            if not isinstance(sub, ast.Call):
                continue
            hazard = self._hazard(sub)
            if hazard:
                yield self.finding(
                    ctx, sub,
                    f"{hazard} inside jit-traced {label}: runs once at "
                    f"trace time, not per batch — its result is baked "
                    f"into the compiled program")
                continue
            # follow module-local helper calls: the jit trace descends
            # into them, so the lint must too (bare names and
            # self.<method>; cross-module helpers are out of reach)
            d = dotted(sub.func)
            helper = None
            if d in defs:
                helper = defs[d]
            elif d and d.startswith("self.") and d.count(".") == 1 \
                    and d[5:] in defs:
                helper = defs[d[5:]]
            if helper is not None:
                yield from self._scan(ctx, helper,
                                      f"{label} via {d}()", defs, visited)

    @staticmethod
    def _hazard(node: ast.Call) -> Optional[str]:
        d = dotted(node.func)
        if d in _TIME_CALLS:
            return f"{d}()"
        if d and (d.startswith("random.") or d == "random"):
            return f"{d}()"
        if d and d.startswith(("np.", "numpy.")) \
                and d.split(".", 1)[1].split(".")[0] not in _NP_STATIC:
            return f"{d}()"
        if d == "print":
            return "print()"
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "item" and not node.args:
            return ".item()"
        return None


@register
class CountableMissingCounters(Checker):
    """The silent AttributeError class: a Countable registration pointed at
    a `counters` the class didn't actually provide, the stats collector
    swallowed the raise (a broken source must not kill the scrape), and
    the tpu_sketch lane vanished from stats without a trace. Where the
    registered object's class resolves within the repo, prove
    `counters` exists — through repo-local base classes — and report
    only a PROVEN absence (external bases stay silent)."""

    name = "countable-missing-counters"
    description = ("object registered as a Countable whose class "
                   "defines no counters()")

    def check(self, ctx: FileContext,
              index: ProjectIndex) -> Iterable[Finding]:
        local_ctors = self._module_ctor_names(ctx.tree)
        for node, cls, funcs in _walk_scoped(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "register"):
                continue
            args = list(node.args) + [kw.value for kw in node.keywords]
            for arg in args:
                if not (isinstance(arg, ast.Attribute)
                        and arg.attr == "counters"):
                    continue
                owner = self._owner_class(arg.value, cls, ctx.path,
                                          local_ctors, index)
                if owner and index.resolves_method(
                        owner, "counters", path=ctx.path) == "no":
                    yield self.finding(
                        ctx, node,
                        f"'{owner}' is registered as a Countable in "
                        f"{_scope_label(cls, funcs)} but defines no "
                        f"counters() — the stats collector will silently "
                        f"drop it on every scrape")

    @staticmethod
    def _module_ctor_names(tree: ast.Module) -> Dict[str, Set[str]]:
        """name -> class leaf names ever constructor-assigned to it."""
        out: Dict[str, Set[str]] = {}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)):
                ctor = dotted(node.value.func)
                if ctor:
                    out.setdefault(node.targets[0].id, set()).add(
                        ctor.rsplit(".", 1)[-1])
        return out

    @staticmethod
    def _owner_class(recv: ast.AST, cls: Optional[str], path: str,
                     local_ctors: Dict[str, Set[str]],
                     index: ProjectIndex) -> Optional[str]:
        if isinstance(recv, ast.Name):
            if recv.id == "self":
                return cls
            ctors = local_ctors.get(recv.id, set())
            if len(ctors) == 1:            # unambiguous local `x = Cls(...)`
                return next(iter(ctors))
            return None
        if (isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self" and cls):
            infos = index.classes.get(cls, [])
            same = [i for i in infos if i.path == path]
            for info in same or infos:
                owner = info.attr_classes.get(recv.attr)
                if owner:
                    return owner
        return None


# the conservation ledger's vocabulary: identifiers carrying these
# words hold data-plane payload whose disappearance must move a counter
# (README "Loss accounting" — every loss class has an owning Countable)
_DATA_NOUNS = frozenset([
    "frame", "frames", "row", "rows", "chunk", "chunks", "batch",
    "batches", "record", "records", "blob", "blobs", "segment",
    "segments", "seg", "datagram", "datagrams", "msg", "msgs",
    "payload", "payloads",
    # alerts are data-plane product output — a dropped alert
    # must move a Countable exactly like a dropped row
    "alert", "alerts",
    # timeline samples and incident bundles are the
    # observability plane's payload — an overwritten ring sample and an
    # evicted bundle both move a Countable, never vanish
    "sample", "samples", "bundle", "bundles", "incident", "incidents",
    # DCN epoch markers and host contributions are protocol
    # payload — a silently vanished marker is a host silently excluded
    # (dcn_markers_lost must move), a dropped contribution is rows
    # (pod_rows_lost must move)
    "marker", "markers", "contribution", "contributions"])
# a drop path is "counted" when its block provably moves a ledger: any
# augmented assignment (counter += n), or a call whose name owns a loss
# verb (self._count_drop(), tracer.incr(...), shed(), ...)
_COUNT_WORDS = frozenset([
    "count", "counts", "counted", "counter", "counters", "drop",
    "dropped", "drops", "evict", "evicted", "shed", "discard",
    "discarded", "lost", "lose", "loss", "exclude", "excluded",
    "reject", "rejected", "nack", "incr", "inc", "torn", "miss",
    "missed", "skip", "skipped", "overwritten"])


def _words(name: str) -> List[str]:
    if name.isupper():
        return []               # ALL_CAPS constant, not data-plane state
    return name.lower().split("_")


def _mentions_noun(node: ast.AST) -> Set[str]:
    """Data nouns referenced anywhere under `node` (names, attributes,
    function parameters are handled by callers)."""
    out: Set[str] = set()
    for sub in ast.walk(node):
        name = sub.id if isinstance(sub, ast.Name) else (
            sub.attr if isinstance(sub, ast.Attribute) else (
                sub.arg if isinstance(sub, ast.arg) else ""))
        if name:
            out.update(w for w in _words(name) if w in _DATA_NOUNS)
    return out


def _counted(stmts: List[ast.stmt], defs: Dict[str, ast.AST],
             _visited: Optional[Set[str]] = None) -> bool:
    """Does this block provably account for what it abandons? Stops at
    nested defs (their bodies do not run here). A value-bearing return
    also counts: the caller receives the evidence and owns the ledger
    (spill's `return evicted` pattern). Same-file helper calls are
    followed (`self._on_device_error(sh, rows)` counts because the
    helper's body moves the ledger), cycle-guarded — the trace-unsafe
    rule's posture applied to conservation."""
    visited = _visited if _visited is not None else set()
    for stmt in stmts:
        for sub in _walk_same_frame_stmts(stmt):
            if isinstance(sub, ast.AugAssign):
                return True
            if isinstance(sub, ast.Raise):
                return True
            if isinstance(sub, ast.Return) and sub.value is not None \
                    and not (isinstance(sub.value, ast.Constant)
                             and sub.value.value is None):
                return True
            if isinstance(sub, ast.Call):
                d = dotted(sub.func)
                leaf = (d or "").rsplit(".", 1)[-1] if d else (
                    sub.func.attr if isinstance(sub.func, ast.Attribute)
                    else "")
                if leaf and set(_words(leaf)) & _COUNT_WORDS:
                    return True
                helper = None
                if d and d in defs:
                    helper = d
                elif d and d.startswith("self.") and d.count(".") == 1 \
                        and d[5:] in defs:
                    helper = d[5:]
                if helper is not None and helper not in visited:
                    visited.add(helper)
                    if _counted(defs[helper].body, defs, visited):
                        return True
    return False


_WAIT_LEAVES = frozenset(["wait", "sleep", "beat", "is_set"])


def _backpressure_only(stmts: List[ast.stmt]) -> bool:
    """`self._stop.wait(0.05); continue` — the retry idiom: nothing is
    consumed, the loop re-attempts the same work. Not a drop. A bare
    `continue` with no wait is NOT this idiom — that one skips."""
    saw_wait = False
    for stmt in stmts:
        if isinstance(stmt, (ast.Continue, ast.Pass)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            func = stmt.value.func
            leaf = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else "")
            if leaf in _WAIT_LEAVES:
                saw_wait = True
                continue
        return False
    return saw_wait


def _walk_same_frame_stmts(root: ast.AST) -> Iterator[ast.AST]:
    yield root
    if isinstance(root, _FUNC_DEFS + (ast.Lambda,)):
        return
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, _FUNC_DEFS + (ast.Lambda,)):
            stack.extend(ast.iter_child_nodes(node))


def _falsiness_guard(test: ast.AST) -> bool:
    """True when the branch test is (or contains) an emptiness check of
    a data noun — `if not frames:`, `if frame is None:`,
    `if len(batch) == 0:` — i.e. the early return abandons NOTHING."""
    for sub in ast.walk(test):
        if isinstance(sub, ast.UnaryOp) and isinstance(sub.op, ast.Not) \
                and _mentions_noun(sub.operand):
            return True
        if isinstance(sub, ast.Compare):
            ops = sub.ops
            if any(isinstance(o, (ast.Is, ast.Eq)) for o in ops) \
                    and _mentions_noun(sub):
                comparators = [sub.left] + list(sub.comparators)
                if any(isinstance(c, ast.Constant)
                       and c.value in (None, 0) for c in comparators):
                    return True
    return False


@register
class SilentDrop(Checker):
    """The pod ledger made `sent == delivered + host + lost +
    pending` the product guarantee, and README's loss-accounting table
    names the Countable that owns every loss class. This rule enforces
    the table's CLOSURE statically: a data-plane `except`, `continue`,
    or guarded early-`return` that abandons frames/rows/chunks/batches
    without moving any counter is exactly how the ledger starts lying
    — the next `spill_evicted`-shaped bug, caught as text. Scoped to
    the conservation core (runtime/, parallel/, batch/, serving/);
    emptiness guards (`if not frames: return`) and value-bearing
    returns (the caller owns the ledger) stay silent."""

    name = "silent-drop"
    description = ("data-plane except/continue/early-return discards "
                   "frames/rows/chunks/batches without incrementing a "
                   "Countable — every loss class needs an owning "
                   "counter (README loss-accounting table)")

    # telemetry/control-plane modules inside the scoped dirs: dropping
    # a trace span, a /metrics scrape or a debug reply is not row loss
    # — the conservation ledger covers DATA, these carry evidence
    _EXEMPT_SUFFIXES = ("runtime/tracing.py", "runtime/profiler.py",
                        "runtime/debug.py", "runtime/promexpo.py",
                        "runtime/stats.py")

    def check(self, ctx: FileContext,
              index: ProjectIndex) -> Iterable[Finding]:
        from deepflow_tpu_torch.analysis.concurrency import scoped
        if not scoped(ctx.path) or ctx.path.endswith(self._EXEMPT_SUFFIXES):
            return
        seen: Set[Tuple[int, int]] = set()
        # flat same-file helper map for counted-call following (homonym
        # methods across classes over-approximate toward silence, which
        # is the right direction for a proven-violations-only rule)
        self._defs = {n.name: n for n in ast.walk(ctx.tree)
                      if isinstance(n, _FUNC_DEFS)}
        yield from self._scan_frame(ctx, ctx.tree, None, None, seen)

    # -- traversal ---------------------------------------------------------
    def _scan_frame(self, ctx: FileContext, frame: ast.AST,
                    func: Optional[ast.AST],
                    noun_params: Optional[Set[str]],
                    seen: Set[Tuple[int, int]]) -> Iterator[Finding]:
        """Walk one function frame; recurse into nested defs with their
        own parameter context."""
        body = frame.body if isinstance(frame.body, list) \
            else [frame.body]
        yield from self._scan_block(ctx, body, func, noun_params, None,
                                    None, seen)

    def _scan_block(self, ctx, stmts, func, noun_params, loop_nouns,
                    branch, seen) -> Iterator[Finding]:
        for i, stmt in enumerate(stmts):
            if isinstance(stmt, ast.Try):
                yield from self._scan_try(ctx, stmt, stmts[i + 1:],
                                          func, noun_params, loop_nouns,
                                          branch, seen)
            else:
                yield from self._scan_stmt(ctx, stmt, func, noun_params,
                                           loop_nouns, branch, seen)

    def _scan_stmt(self, ctx, node, func, noun_params, loop_nouns,
                   branch, seen) -> Iterator[Finding]:
        if isinstance(node, ast.ClassDef):
            yield from self._scan_block(ctx, node.body, None, None,
                                        None, None, seen)
            return
        if isinstance(node, _FUNC_DEFS):
            params = {a.arg for a in
                      (node.args.posonlyargs + node.args.args
                       + node.args.kwonlyargs)
                      if set(_words(a.arg)) & _DATA_NOUNS}
            yield from self._scan_frame(ctx, node, node,
                                        params or None, seen)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            nouns = _mentions_noun(node.target) or None
            yield from self._scan_block(ctx, node.body, func,
                                        noun_params, nouns, None, seen)
            yield from self._scan_block(ctx, node.orelse, func,
                                        noun_params, loop_nouns, branch,
                                        seen)
            return
        if isinstance(node, ast.While):
            # worker-loop shape: `while ...: msg = q.get(); ...` — the
            # loop is noun-carrying when its body top level binds one
            nouns: Set[str] = set()
            for s in node.body:
                if isinstance(s, ast.Assign):
                    for t in s.targets:
                        nouns |= _mentions_noun(t)
            yield from self._scan_block(ctx, node.body, func,
                                        noun_params, nouns or None,
                                        None, seen)
            yield from self._scan_block(ctx, node.orelse, func,
                                        noun_params, loop_nouns, branch,
                                        seen)
            return
        if isinstance(node, ast.If):
            yield from self._scan_block(ctx, node.body, func,
                                        noun_params, loop_nouns,
                                        (node.test, node.body), seen)
            yield from self._scan_block(ctx, node.orelse, func,
                                        noun_params, loop_nouns,
                                        (node.test, node.orelse), seen)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            yield from self._scan_block(ctx, node.body, func,
                                        noun_params, loop_nouns, branch,
                                        seen)
            return
        if isinstance(node, ast.Continue):
            yield from self._continue_discard(ctx, node, loop_nouns,
                                              branch, seen)
            return
        if isinstance(node, ast.Return):
            yield from self._return_discard(ctx, node, func,
                                            noun_params, branch, seen)
            return

    # -- the three shapes --------------------------------------------------
    def _scan_try(self, ctx, node, rest, func, noun_params, loop_nouns,
                  branch, seen) -> Iterator[Finding]:
        try_nouns = self._live_try_nouns(node.body)
        for handler in node.handlers:
            flagged = list(self._except_swallow(
                ctx, handler, try_nouns, rest, seen))
            yield from flagged
            # a flagged swallow already covers any continue/return
            # inside it — don't double-report the same drop
            yield from self._scan_block(
                ctx, handler.body, func, noun_params,
                None if flagged else loop_nouns,
                None if flagged else (None, handler.body), seen)
        for sub in (node.body, node.orelse, node.finalbody):
            yield from self._scan_block(ctx, sub, func, noun_params,
                                        loop_nouns, branch, seen)

    @staticmethod
    def _live_try_nouns(body: List[ast.stmt]) -> Set[str]:
        """Nouns whose data EXISTS inside the try body — i.e. noun
        identifiers that are LOADED there. A noun that only ever
        appears as a plain assignment target (`chunk = conn.recv()`)
        is a store, not a load: it never held data when the call
        raised, so the recv-retry loops stay silent."""
        loads: Set[str] = set()
        for stmt in body:
            for sub in _walk_same_frame_stmts(stmt):
                if isinstance(sub, ast.Name) \
                        and not isinstance(sub.ctx, ast.Store):
                    loads |= {w for w in _words(sub.id)
                              if w in _DATA_NOUNS}
                elif isinstance(sub, ast.Attribute):
                    loads |= {w for w in _words(sub.attr)
                              if w in _DATA_NOUNS}
        return loads

    def _except_swallow(self, ctx, handler, try_nouns, rest,
                        seen) -> Iterator[Finding]:
        nouns = try_nouns & _DATA_NOUNS
        if not nouns:
            return
        if _counted(handler.body, self._defs):
            return
        # no terminal jump: the handler falls through to the try's
        # siblings — if THOSE move the ledger (pod's rollback counts
        # after the except), the path is covered
        falls_through = not any(
            isinstance(s, (ast.Return, ast.Continue, ast.Break))
            for s in handler.body)
        if falls_through and _counted(rest, self._defs):
            return
        at = (handler.lineno, handler.col_offset)
        if at in seen:
            return
        seen.add(at)
        yield Finding(
            self.name, ctx.path, handler.lineno, handler.col_offset,
            f"except path swallows a failure while handling "
            f"{'/'.join(sorted(nouns))} without moving any counter — "
            f"count the loss (README loss-accounting) or re-raise",
            self.severity)

    def _continue_discard(self, ctx, node, loop_nouns, branch,
                          seen) -> Iterator[Finding]:
        if not loop_nouns or branch is None:
            return                  # unconditional continue: no drop
        test, block = branch
        if test is not None and _falsiness_guard(test):
            return                  # `if not frame: continue` skips nothing
        if _backpressure_only(block):
            return                  # wait-and-retry: nothing consumed
        if _counted(block, self._defs):
            return
        at = (node.lineno, node.col_offset)
        if at in seen:
            return
        seen.add(at)
        yield Finding(
            self.name, ctx.path, node.lineno, node.col_offset,
            f"continue discards the current "
            f"{'/'.join(sorted(loop_nouns))} without moving any "
            f"counter — count the drop before skipping",
            self.severity)

    def _return_discard(self, ctx, node, func, noun_params, branch,
                        seen) -> Iterator[Finding]:
        if func is None or not noun_params or branch is None:
            return
        if node.value is not None \
                and not (isinstance(node.value, ast.Constant)
                         and node.value.value is None):
            return                  # value-bearing: caller owns ledger
        test, block = branch
        if test is not None and _falsiness_guard(test):
            return                  # `if not frames: return` drops nothing
        if _counted(block, self._defs):
            return
        if self._counted_before(func, node.lineno):
            return                  # `lost += rows; ...; if X: return`
        at = (node.lineno, node.col_offset)
        if at in seen:
            return
        seen.add(at)
        yield Finding(
            self.name, ctx.path, node.lineno, node.col_offset,
            f"early return drops the "
            f"{'/'.join(sorted(noun_params))} argument without moving "
            f"any counter — count the drop (README loss-accounting) "
            f"or make the guard an emptiness check",
            self.severity)

    def _counted_before(self, func: ast.AST, lineno: int) -> bool:
        """The `self.lost_rows += rows; ...; if degraded: return` shape:
        the function already moved a ledger for its argument before the
        guard — the early return abandons nothing uncounted."""
        for stmt in func.body:
            for sub in _walk_same_frame_stmts(stmt):
                if getattr(sub, "lineno", lineno) >= lineno:
                    continue
                if isinstance(sub, ast.AugAssign):
                    return True
                if isinstance(sub, ast.Call):
                    d = dotted(sub.func)
                    leaf = (d or "").rsplit(".", 1)[-1] if d else (
                        sub.func.attr
                        if isinstance(sub.func, ast.Attribute) else "")
                    if leaf and set(_words(leaf)) & _COUNT_WORDS:
                        return True
        return False


@register
class FaultSiteDrift(Checker):
    """runtime/faults.py is trustworthy only while its site registry
    matches the injection points: a site with no caller silently stops
    injecting (chaos coverage rots), and an injection point using an
    unregistered constant never fires. Diffs `FAULT_*` definitions
    against name references (and site-string literals) across the scan.
    Needs a whole-package scan — linting faults.py alone reads every
    site as orphaned."""

    name = "fault-site-drift"
    description = ("FAULT_* site with no injection point, or injection "
                   "point with no registered site")

    def check(self, ctx: FileContext,
              index: ProjectIndex) -> Iterable[Finding]:
        if not index.fault_defs:
            return                       # faults.py outside the scan scope
        if ctx.path == index.fault_defs_path:
            for name, (value, line) in sorted(index.fault_defs.items()):
                if name in index.fault_refs:
                    continue
                if index.site_strings.get(value):
                    continue             # armed/fired via its spec string
                yield Finding(
                    self.name, ctx.path, line, 0,
                    f"fault site '{value}' ({name}) has no injection "
                    f"point outside faults.py — the registry and the "
                    f"data plane have drifted", self.severity)
            return
        for name, refs in sorted(index.fault_refs.items()):
            if name in index.fault_defs:
                continue
            for path, line in refs:
                if path == ctx.path:
                    yield Finding(
                        self.name, ctx.path, line, 0,
                        f"{name} is referenced here but not defined in "
                        f"runtime/faults.py — this injection point can "
                        f"never fire", self.severity)
