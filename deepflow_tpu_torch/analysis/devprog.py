"""deepflow-devcheck: whole-program device-plane rules.

Every throughput bar this repo publishes hangs on ~38 `jax.jit` call
sites across the device-plane files, and three of their contracts are
invisible to per-file lexical rules:

- **donation** (`donate_argnums`) deletes the argument's buffer at
  dispatch — any later read of the donated value is undefined (the
  reference caught this live once: a dead donated buffer cascading
  every later feed dispatch into failure);
- **the program cache key** (static argnums/argnames, shapes, dtypes)
  silently multiplies compiled programs when fed per-batch values —
  `len(batch)` as a static arg is one XLA compile per distinct length;
- **uint32-by-convention** hash lanes overflow int32 jnp defaults the
  moment a mixing constant escapes the `_mix32` mask discipline of
  `utils/u32.py` / `ops/hashing.py`;
- **state pytree leaf layout** IS the snapbus npz wire format
  (`leaf_{i}` keys in flatten order): adding or reordering a leaf
  breaks snapshot restore, restart replay and kill+rejoin.

This module indexes every jit site project-wide (assignments,
`self.<attr>` bindings, decorators — including the
`functools.partial(jax.jit, static_argnames=...)` form — returns, and
factory functions whose return value IS a jitted program, so
`self._step = detectors.make_window_step(cfg)` carries the donation
contract across files) and enforces all four disciplines:

- `donation-use-after-donate`: branch-aware forward dataflow over each
  frame; a donated value read, re-passed or stashed after the donating
  call is a finding, and rebinding the program's result over the same
  name (`state = upd(state, batch)`) is the sanctioned shape.
- `retrace-hazard`: static-key positions fed from `len()` or container
  displays are findings outright; additionally every site's cache-key
  fingerprint and compiled-program bound live in a committed
  `.lint-programs.json` (mirroring the twin store) — editing a jit
  key is only green again after `df-ctl lint --ack-programs`.
- `u32-overflow`: in the u32/hashing modules and their importers,
  mixing a tracked uint32 lane with a bare int constant that does not
  fit int32, or casting an unmasked uint32 lane straight to int32, is
  a finding on both the device side and the host twins.
- `pytree-schema-drift`: the SCHEMA_TABLE below names every state
  pytree that crosses a durability boundary; each one's leaf layout
  (names, order, declared type) is fingerprinted into a committed
  `.lint-schemas.json`, gated exactly like twin edits.

The host-sync rule (checkers.py) also rides this index: a value
provably produced by a jitted program reaching `.item()` / `float()` /
`bool()` / `np.asarray` / `device_get` outside a sanctioned sync
helper is a finding in ANY file — the per-file allowlist is gone.

All rules keep the package's "proven absence only" posture: an
unresolvable callee or an out-of-scan file stays silent, and fixture
scans (stores = None) are never judged against the real repo's
committed stores.
"""

from __future__ import annotations

import ast
import hashlib
import json
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from deepflow_tpu_torch.analysis.core import (Checker, FileContext, Finding,
                                              ProjectIndex, dotted, register)
from deepflow_tpu_torch.analysis.twins import resolve_ref

__all__ = ["JitSite", "sites_for_path", "all_sites", "bindings_for",
           "site_fingerprint", "device_value_syncs",
           "DonationUseAfterDonate", "RetraceHazard", "U32Overflow",
           "PytreeSchemaDrift", "SCHEMA_TABLE",
           "build_programs_store", "build_schemas_store",
           "load_programs_store", "save_programs_store",
           "load_schemas_store", "save_schemas_store",
           "PROGRAMS_STORE_VERSION", "SCHEMAS_STORE_VERSION"]

PROGRAMS_STORE_VERSION = 1
SCHEMAS_STORE_VERSION = 1

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


# State pytrees that cross a durability boundary (snapbus npz payloads,
# restart replay, kill+rejoin-by-snapshot, the anomaly snapshot bus).
# The nested ops states are listed too: snapbus flattens recursively,
# so a leaf added INSIDE PCAState shifts every later `leaf_{i}` key of
# an AnomalyState payload. Parsed LEXICALLY from the scanned source of
# this file (fixtures may ship their own analysis/devprog.py), so keep
# every entry a plain string literal: (schema-id, "path:QualName").
SCHEMA_TABLE = [
    ("flow-suite-state",
     "deepflow_tpu_torch/models/flow_suite.py:FlowSuiteState"),
    ("flow-window-output",
     "deepflow_tpu_torch/models/flow_suite.py:FlowWindowOutput"),
    ("flow-dict-state",
     "deepflow_tpu_torch/models/flow_dict.py:FlowDictState"),
    ("app-suite-state",
     "deepflow_tpu_torch/models/app_suite.py:AppSuiteState"),
    ("metrics-suite-state",
     "deepflow_tpu_torch/models/metrics_suite.py:MetricsSuiteState"),
    ("cms-state", "deepflow_tpu_torch/ops/cms.py:CMSState"),
    ("topk-state", "deepflow_tpu_torch/ops/topk.py:TopKState"),
    ("hll-state", "deepflow_tpu_torch/ops/hll.py:HLLState"),
    ("entropy-state", "deepflow_tpu_torch/ops/entropy.py:EntropyState"),
    ("pca-state", "deepflow_tpu_torch/ops/pca.py:PCAState"),
    ("mp-state", "deepflow_tpu_torch/ops/matrix_profile.py:MPState"),
    ("ddsketch-state", "deepflow_tpu_torch/ops/ddsketch.py:DDSketchState"),
    ("anomaly-state",
     "deepflow_tpu_torch/anomaly/detectors.py:AnomalyState"),
    # the 8-leaf alert snapshot: its `leaves()` staticmethod IS the
    # anomaly bus wire layout (names + np dtypes, in order)
    ("alert-snapshot", "deepflow_tpu_torch/anomaly/alerts.py:AlertSnapshot"),
]


# -- scoped walking (local copy: checkers.py imports this module for the
# per-value sync pass, so the import must not point back) -------------------

def _walk_scoped(node: ast.AST, cls: Optional[str] = None,
                 funcs: Tuple[str, ...] = ()
                 ) -> Iterator[Tuple[ast.AST, Optional[str],
                                     Tuple[str, ...]]]:
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
    """Subtree walk that stops at nested def/lambda boundaries: code in
    a nested function does not execute where it is written, so neither
    donation deaths nor device-value syncs may cross the frame."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, _FUNC_DEFS + (ast.Lambda,)):
            stack.extend(ast.iter_child_nodes(node))


# -- the project-wide jit-site index ----------------------------------------

class JitSite:
    """One `jax.jit(...)` (or partial-jit decorator) occurrence with its
    cache-key-bearing config. `qual` is deliberately line-free so the
    committed .lint-programs.json survives unrelated edits above it."""

    __slots__ = ("path", "line", "qual", "binding", "wrapped",
                 "wrapped_def", "static_argnums", "static_argnames",
                 "donate_argnums")

    def __init__(self, path: str, line: int, qual: str,
                 binding: Optional[str], wrapped: Optional[str],
                 wrapped_def: Optional[ast.AST], cfg: dict) -> None:
        self.path = path
        self.line = line
        self.qual = qual
        self.binding = binding
        self.wrapped = wrapped
        self.wrapped_def = wrapped_def
        self.static_argnums = tuple(
            v for v in cfg["static_argnums"] if isinstance(v, int))
        self.static_argnames = tuple(
            v for v in cfg["static_argnames"] if isinstance(v, str))
        self.donate_argnums = tuple(
            v for v in cfg["donate_argnums"] if isinstance(v, int))

    @property
    def site_id(self) -> str:
        return f"{self.path}:{self.qual}"

    @property
    def label(self) -> str:
        return self.binding or self.qual


def _const_tuple(node: ast.AST) -> tuple:
    """Config values as a tuple of int/str constants; anything built at
    runtime collapses to ('<dyn>',) — the site still indexes, but the
    unknown positions never drive donation/static reasoning."""
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, str)):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out: list = []
        for e in node.elts:
            if isinstance(e, ast.Constant) \
                    and isinstance(e.value, (int, str)):
                out.append(e.value)
            else:
                return ("<dyn>",)
        return tuple(out)
    return ("<dyn>",)


def _jit_call_config(call: ast.AST
                     ) -> Optional[Tuple[Optional[ast.AST], dict]]:
    """(wrapped-arg node | None, config) if `call` is `jax.jit(...)` or
    `functools.partial(jax.jit, ...)`; None otherwise. The partial form
    carries no wrapped arg — it decorates a def, which the site walker
    substitutes in."""
    if not isinstance(call, ast.Call):
        return None
    d = dotted(call.func)
    leaf = d.rsplit(".", 1)[-1] if d else ""
    wrapped: Optional[ast.AST] = None
    if leaf == "jit":
        wrapped = call.args[0] if call.args else None
    elif leaf == "partial" and call.args:
        inner = dotted(call.args[0])
        if not (inner and inner.rsplit(".", 1)[-1] == "jit"):
            return None
    else:
        return None
    cfg = {"static_argnums": (), "static_argnames": (),
           "donate_argnums": (), "donate_argnames": ()}
    for kw in call.keywords:
        if kw.arg in cfg:
            cfg[kw.arg] = _const_tuple(kw.value)
    return wrapped, cfg


def _wrapped_name(node: Optional[ast.AST]) -> Optional[str]:
    if node is None:
        return None
    if isinstance(node, ast.Lambda):
        return "<lambda>"
    if isinstance(node, _FUNC_DEFS):
        return node.name
    return dotted(node)


def sites_for_path(path: str, tree: ast.Module,
                   index: ProjectIndex) -> List["JitSite"]:
    memo = index.memo.setdefault("devprog_sites", {})
    if path in memo:
        return memo[path]
    local_defs: Dict[str, ast.AST] = {}
    for n in ast.walk(tree):
        if isinstance(n, _FUNC_DEFS):
            local_defs.setdefault(n.name, n)
    sites: List[JitSite] = []
    quals: Dict[str, int] = {}
    consumed: Set[int] = set()

    def add(call: ast.Call, qual: str, binding: Optional[str],
            wrapped: Optional[ast.AST], cfg: dict) -> None:
        n = quals.get(qual, 0)
        quals[qual] = n + 1
        if n:
            qual = f"{qual}#{n + 1}"       # stable: appearance order
        name = _wrapped_name(wrapped)
        wdef = wrapped if isinstance(wrapped, (ast.Lambda,) + _FUNC_DEFS) \
            else local_defs.get(name) if name else None
        sites.append(JitSite(path, call.lineno, qual, binding, name,
                             wdef, cfg))

    for node, cls, funcs in _walk_scoped(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            res = _jit_call_config(node.value)
            if res is None:
                continue
            td = dotted(node.targets[0])
            if td is None:
                continue
            consumed.add(id(node.value))
            wrapped, cfg = res
            if td.startswith("self.") and cls:
                add(node.value, f"{cls}.{td[5:]}", td, wrapped, cfg)
            elif cls or funcs:
                add(node.value, f"{_scope_label(cls, funcs)}.{td}",
                    td, wrapped, cfg)
            else:
                add(node.value, td, td, wrapped, cfg)
        elif isinstance(node, ast.Return) and node.value is not None:
            res = _jit_call_config(node.value)
            if res is None:
                continue
            consumed.add(id(node.value))
            wrapped, cfg = res
            add(node.value,
                f"{_scope_label(cls, funcs)}.return"
                f"[{_wrapped_name(wrapped) or '?'}]", None, wrapped, cfg)
        elif isinstance(node, _FUNC_DEFS):
            for dec in node.decorator_list:
                res = _jit_call_config(dec)
                if res is None:
                    continue
                consumed.add(id(dec))
                _w, cfg = res
                qual = node.name if not (cls or funcs) else \
                    f"{_scope_label(cls, funcs)}.{node.name}" if funcs \
                    else f"{cls}.{node.name}"
                add(dec, qual, node.name, node, cfg)
    for node, cls, funcs in _walk_scoped(tree):
        if isinstance(node, ast.Call) and id(node) not in consumed:
            res = _jit_call_config(node)
            if res is None:
                continue
            wrapped, cfg = res
            add(node,
                f"{_scope_label(cls, funcs)}.jit"
                f"[{_wrapped_name(wrapped) or '?'}]", None, wrapped, cfg)
    memo[path] = sites
    return sites


def all_sites(index: ProjectIndex) -> Dict[str, List[JitSite]]:
    cached = index.memo.get("devprog_all_sites")
    if cached is not None:
        return cached
    out = {p: sites_for_path(p, t, index)
           for p, t in sorted(index.trees.items())}
    index.memo["devprog_all_sites"] = out
    return out


def _factory_map(index: ProjectIndex) -> Dict[str, JitSite]:
    """Function leaf name -> site, for functions whose return value IS
    a jit call (`make_coalesced_update`, `make_window_step`): a call to
    the factory hands the caller a jitted callable carrying that
    site's donate/static config — this is what makes the donation rule
    whole-PROGRAM rather than per-file."""
    cached = index.memo.get("devprog_factories")
    if cached is not None:
        return cached
    out: Dict[str, JitSite] = {}
    for _path, sites in all_sites(index).items():
        for site in sites:
            head, sep, _ = site.qual.partition(".return[")
            if sep:
                out.setdefault(head.rsplit(".", 1)[-1], site)
    index.memo["devprog_factories"] = out
    return out


def bindings_for(path: str, tree: ast.Module,
                 index: ProjectIndex) -> Dict[str, JitSite]:
    """Callable references resolvable to a jit site in this file:
    `self.X` attrs and bare names bound to a jit call, jitted local
    defs (decorator form), and names bound from a jit-returning
    factory call (cross-file)."""
    memo = index.memo.setdefault("devprog_bindings", {})
    if path in memo:
        return memo[path]
    out: Dict[str, JitSite] = {}
    for site in sites_for_path(path, tree, index):
        if site.binding:
            out[site.binding] = site
            if site.wrapped_def is not None \
                    and isinstance(site.wrapped_def, _FUNC_DEFS) \
                    and site.binding == site.wrapped_def.name:
                # decorated method: callable both bare and via self.
                out[f"self.{site.binding}"] = site
    fmap = _factory_map(index)
    for node, cls, _funcs in _walk_scoped(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.value, ast.Call)):
            continue
        d = dotted(node.value.func)
        if d is None:
            continue
        site = fmap.get(d.rsplit(".", 1)[-1])
        if site is None:
            continue
        td = dotted(node.targets[0])
        if td is not None:
            out.setdefault(td, site)
    memo[path] = out
    return out


def site_fingerprint(site: JitSite) -> str:
    """Cache-key fingerprint: the static/donate config, the wrapped
    callable's name, and (when it resolves locally) the wrapped
    signature's normalized AST — a changed parameter list changes the
    key structure every caller compiles against."""
    h = hashlib.sha256()
    h.update(repr((site.static_argnums, site.static_argnames,
                   site.donate_argnums, site.wrapped)).encode("utf-8"))
    args = getattr(site.wrapped_def, "args", None)
    if args is not None:
        h.update(ast.dump(args, include_attributes=False).encode("utf-8"))
    return h.hexdigest()[:16]


# -- stores -----------------------------------------------------------------

def _load_store(path: str, version: int, kind: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("version") != version:
        raise ValueError(f"{path}: unsupported {kind}-store version "
                         f"{doc.get('version')!r}")
    return doc


def _save_store(doc: dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")


def load_programs_store(path: str) -> dict:
    return _load_store(path, PROGRAMS_STORE_VERSION, "programs")


def save_programs_store(doc: dict, path: str) -> None:
    _save_store(doc, path)


def load_schemas_store(path: str) -> dict:
    return _load_store(path, SCHEMAS_STORE_VERSION, "schemas")


def save_schemas_store(doc: dict, path: str) -> None:
    _save_store(doc, path)


# -- donation-use-after-donate ----------------------------------------------

class _DonationFlow:
    """Branch-aware forward dataflow over one frame: tracks names whose
    buffer a jitted call donated, reports any later load. If/else arms
    flow independently from the pre-branch state and union after (a use
    in the else-arm of the donating if-arm is alive); loop bodies flow
    twice so a donate-at-bottom / use-at-top pair across iterations is
    caught; rebinding (`state = upd(state, batch)`) both kills the old
    death and skips minting a new one — that IS the sanctioned shape."""

    def __init__(self, checker: "DonationUseAfterDonate",
                 ctx: FileContext, bindings: Dict[str, JitSite],
                 scope: str) -> None:
        self.checker = checker
        self.ctx = ctx
        self.bindings = bindings
        self.scope = scope
        self.findings: List[Finding] = []
        self._reported: Set[Tuple[int, int]] = set()

    def run(self, body: List[ast.stmt]) -> None:
        self._block(body, {})

    # dead: var -> (site, donated position)
    def _block(self, stmts: List[ast.stmt], dead: dict) -> dict:
        for st in stmts:
            if isinstance(st, _FUNC_DEFS + (ast.ClassDef,)):
                continue                   # nested frame: not executed here
            elif isinstance(st, ast.If):
                self._loads(st.test, dead)
                d1 = self._block(st.body, dict(dead))
                d2 = self._block(st.orelse, dict(dead))
                dead = {**d1, **d2}
            elif isinstance(st, (ast.For, ast.AsyncFor)):
                self._loads(st.iter, dead)
                d = dict(dead)
                self._kill(st.target, d)
                d = self._block(st.body, d)
                self._kill(st.target, d)
                d = self._block(st.body, d)
                de = self._block(st.orelse, dict(d))
                dead = {**dead, **d, **de}
            elif isinstance(st, ast.While):
                self._loads(st.test, dead)
                d = self._block(st.body, dict(dead))
                self._loads(st.test, d)
                d = self._block(st.body, d)
                de = self._block(st.orelse, dict(d))
                dead = {**dead, **d, **de}
            elif isinstance(st, ast.Try):
                db = self._block(st.body, dict(dead))
                merged = {**dead, **db}    # handler may enter anywhere
                dh: dict = {}
                for h in st.handlers:
                    dh.update(self._block(h.body, dict(merged)))
                do = self._block(st.orelse, dict(db))
                dead = self._block(st.finalbody, {**merged, **dh, **do})
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                for item in st.items:
                    self._loads(item.context_expr, dead)
                    if item.optional_vars is not None:
                        self._kill(item.optional_vars, dead)
                dead = self._block(st.body, dead)
            else:
                self._simple(st, dead)
        return dead

    def _simple(self, st: ast.stmt, dead: dict) -> None:
        self._loads(st, dead)
        killed: Set[str] = set()
        for t in self._targets(st):
            self._kill(t, dead, killed)
        for call in self._calls(st):
            site = self._site_for(call)
            if site is None or not site.donate_argnums:
                continue
            for pos in site.donate_argnums:
                if not isinstance(pos, int) or pos >= len(call.args):
                    continue
                v = dotted(call.args[pos])
                if v and v not in killed:
                    dead[v] = (site, pos)

    @staticmethod
    def _targets(st: ast.stmt) -> List[ast.AST]:
        if isinstance(st, ast.Assign):
            return list(st.targets)
        if isinstance(st, (ast.AugAssign, ast.AnnAssign)):
            return [st.target]
        if isinstance(st, ast.Delete):
            return list(st.targets)
        return []

    def _kill(self, target: ast.AST, dead: dict,
              killed: Optional[Set[str]] = None) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._kill(e, dead, killed)
            return
        if isinstance(target, ast.Starred):
            self._kill(target.value, dead, killed)
            return
        v = dotted(target)
        if v:
            dead.pop(v, None)
            if killed is not None:
                killed.add(v)

    def _calls(self, st: ast.stmt) -> Iterator[ast.Call]:
        for node in _walk_same_frame(st):
            if isinstance(node, ast.Call):
                yield node

    def _site_for(self, call: ast.Call) -> Optional[JitSite]:
        d = dotted(call.func)
        if d is not None and d in self.bindings:
            return self.bindings[d]
        # `jax.jit(f, donate_argnums=0)(state)` called inline
        res = _jit_call_config(call.func)
        if res is not None:
            wrapped, cfg = res
            return JitSite(self.ctx.path, call.lineno,
                           f"{self.scope}.jit"
                           f"[{_wrapped_name(wrapped) or '?'}]",
                           None, _wrapped_name(wrapped), None, cfg)
        return None

    def _loads(self, root: ast.AST, dead: dict) -> None:
        if not dead:
            return
        for node in _walk_same_frame(root):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                v: Optional[str] = node.id
            elif isinstance(node, ast.Attribute) \
                    and isinstance(node.ctx, ast.Load):
                v = dotted(node)
            else:
                continue
            if v is None or v not in dead:
                continue
            at = (node.lineno, node.col_offset)
            if at in self._reported:
                continue
            self._reported.add(at)
            site, pos = dead[v]
            self.findings.append(self.checker.finding(
                self.ctx, node,
                f"'{v}' was donated to {site.label}() (donate_argnums "
                f"includes arg {pos}) and is read again in {self.scope} "
                f"— donation deletes the buffer at dispatch, so this "
                f"read returns garbage or raises; rebind the program's "
                f"result over '{v}' or stop donating it"))


@register
class DonationUseAfterDonate(Checker):
    """A live bug class, made statically impossible: a value
    passed at a donated position is DEAD after the call — the next
    dispatch that touches it fails, and every later feed batch
    cascades. The flow is per-frame, branch-aware, and resolves jitted
    callables project-wide (including jit-returning factories)."""

    name = "donation-use-after-donate"
    description = ("donated jit argument read/re-passed/stashed after "
                   "the donating call — the buffer is deleted at "
                   "dispatch; rebind the result over the donated name")

    def check(self, ctx: FileContext,
              index: ProjectIndex) -> Iterable[Finding]:
        bindings = bindings_for(ctx.path, ctx.tree, index)
        frames: List[Tuple[str, List[ast.stmt]]] = [
            ("<module>", ctx.tree.body)]
        for node, cls, funcs in _walk_scoped(ctx.tree):
            if isinstance(node, _FUNC_DEFS):
                frames.append((
                    _scope_label(cls, funcs + (node.name,)), node.body))
        for scope, body in frames:
            flow = _DonationFlow(self, ctx, bindings, scope)
            flow.run(body)
            yield from flow.findings


# -- retrace-hazard ---------------------------------------------------------

_UNHASHABLE_DISPLAYS = (ast.List, ast.Set, ast.Dict, ast.ListComp,
                        ast.SetComp, ast.DictComp)


def _program_facts(index: ProjectIndex) -> Tuple[
        Dict[str, JitSite], Dict[str, object],
        List[Tuple[str, int, str]]]:
    """(site_id -> site, site_id -> derived program bound,
    hazard findings). The bound is the count of distinct static-arg
    signatures observed across every call site in the scan —
    'unbounded' when any static position is fed a per-batch value."""
    cached = index.memo.get("devprog_program_facts")
    if cached is not None:
        return cached
    sites_by_id: Dict[str, JitSite] = {}
    signatures: Dict[str, Set[str]] = {}
    unbounded: Dict[str, str] = {}
    hazards: List[Tuple[str, int, str]] = []
    for path, sites in all_sites(index).items():
        for site in sites:
            sites_by_id[site.site_id] = site
    for path, tree in sorted(index.trees.items()):
        bindings = bindings_for(path, tree, index)
        if not bindings:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            site = bindings.get(d) if d else None
            if site is None:
                continue
            feeders: List[Tuple[object, ast.AST]] = []
            for pos in site.static_argnums:
                if isinstance(pos, int) and pos < len(node.args):
                    feeders.append((pos, node.args[pos]))
            for kw in node.keywords:
                if kw.arg in site.static_argnames:
                    feeders.append((kw.arg, kw.value))
            if not feeders:
                continue
            sig_parts: List[str] = []
            for key, arg in feeders:
                if isinstance(arg, ast.Call) \
                        and dotted(arg.func) == "len":
                    unbounded[site.site_id] = "len()"
                    hazards.append((
                        path, arg.lineno,
                        f"static arg {key!r} of {site.label}() is fed "
                        f"from len(...) — one compiled program per "
                        f"distinct length (a retrace storm on variable "
                        f"batches); pad to a fixed capacity or hoist "
                        f"the length into bounded config"))
                elif isinstance(arg, _UNHASHABLE_DISPLAYS):
                    unbounded[site.site_id] = "container"
                    hazards.append((
                        path, arg.lineno,
                        f"static arg {key!r} of {site.label}() is an "
                        f"unhashable container display — the program "
                        f"cache cannot key it (TypeError at best, a "
                        f"per-call retrace at worst); pass a tuple of "
                        f"scalars"))
                if isinstance(arg, ast.Constant):
                    sig_parts.append(repr(arg.value))
                else:
                    sig_parts.append(dotted(arg) or "?")
            signatures.setdefault(site.site_id, set()).add(
                "|".join(sig_parts))
    bounds: Dict[str, object] = {}
    for sid, site in sites_by_id.items():
        if sid in unbounded:
            bounds[sid] = "unbounded"
        elif site.static_argnums or site.static_argnames:
            bounds[sid] = max(1, len(signatures.get(sid, set())))
        else:
            bounds[sid] = 1
    facts = (sites_by_id, bounds, hazards)
    index.memo["devprog_program_facts"] = facts
    return facts


@register
class RetraceHazard(Checker):
    """Every distinct jit cache key is one XLA compile held forever in
    the program cache. Keys fed from per-batch values make the count
    unbounded (the hazard findings); beyond that, each site's key
    config and program bound are committed in .lint-programs.json so a
    cache-key edit is reviewed — `df-ctl lint --ack-programs` is the
    only way to move the store, exactly like the twin gate."""

    name = "retrace-hazard"
    description = ("jit cache key fed from per-batch values, or a "
                   "jitted program whose key/config drifted from the "
                   "committed .lint-programs.json — "
                   "`df-ctl lint --ack-programs`")

    def check(self, ctx: FileContext,
              index: ProjectIndex) -> Iterable[Finding]:
        for path, line, message in self._results(index):
            if path == ctx.path:
                yield Finding(self.name, path, line, 0, message,
                              self.severity)

    def _results(self, index: ProjectIndex
                 ) -> List[Tuple[str, int, str]]:
        cached = index.memo.get("devprog_retrace_results")
        if cached is not None:
            return cached
        sites_by_id, bounds, hazards = _program_facts(index)
        out = list(hazards)
        store = index.programs_store
        if store is not None:
            entries = store.get("programs", {})
            for sid, site in sorted(sites_by_id.items()):
                entry = entries.get(sid)
                if entry is None:
                    out.append((
                        site.path, site.line,
                        f"jitted program '{sid}' has no committed "
                        f"cache-key entry — review its retrace risk "
                        f"and `df-ctl lint --ack-programs`"))
                    continue
                if entry.get("fp") != site_fingerprint(site):
                    out.append((
                        site.path, site.line,
                        f"jit cache key for '{sid}' changed since last "
                        f"acknowledged (static/donate config or wrapped "
                        f"signature) — re-review retrace risk and "
                        f"`df-ctl lint --ack-programs`"))
                    continue
                want = entry.get("programs")
                got = bounds.get(sid)
                if got == "unbounded" and want != "unbounded":
                    out.append((
                        site.path, site.line,
                        f"compiled-program bound for '{sid}' is now "
                        f"UNBOUNDED (was committed at {want!r}) — fix "
                        f"the feeder or `df-ctl lint --ack-programs`"))
                elif isinstance(got, int) and isinstance(want, int) \
                        and got > want:
                    out.append((
                        site.path, site.line,
                        f"compiled-program bound exceeded for '{sid}': "
                        f"{got} distinct static signatures > committed "
                        f"{want} — `df-ctl lint --ack-programs` after "
                        f"review"))
            # committed programs whose site is gone — gated on the
            # site's FILE being in the scan (partial scans stay silent)
            for sid in sorted(entries):
                if sid in sites_by_id:
                    continue
                decl_file = sid.split(":", 1)[0]
                hit = next((p for p in index.defs_by_path
                            if p == decl_file
                            or p.endswith("/" + decl_file)), None)
                if hit is None:
                    continue
                out.append((
                    hit, 1,
                    f"committed jit program '{sid}' no longer exists — "
                    f"`df-ctl lint --ack-programs` to drop it "
                    f"deliberately"))
        index.memo["devprog_retrace_results"] = out
        return out


def build_programs_store(index: ProjectIndex) -> Tuple[dict, List[str]]:
    """Fingerprint every jit site in the scan. Unlike the twin/schema
    builders there is nothing to fail to resolve — sites come FROM the
    scan — so the missing list exists only for CLI symmetry."""
    sites_by_id, bounds, _hazards = _program_facts(index)
    entries = {
        sid: {"fp": site_fingerprint(site),
              "static": [*site.static_argnums, *site.static_argnames],
              "donate": list(site.donate_argnums),
              "wrapped": site.wrapped or "<lambda>",
              "programs": bounds.get(sid, 1)}
        for sid, site in sites_by_id.items()}
    return {"version": PROGRAMS_STORE_VERSION, "tool": "deepflow-lint",
            "programs": entries}, []


# -- u32-overflow -----------------------------------------------------------

# calls whose result is a uint32 lane by construction: the u32/hashing
# module surface plus the numpy/jax constructors themselves
_U32_PRODUCERS = frozenset([
    "mix32", "_mix32_np", "fold_columns", "fold_columns_np",
    "splitmix32_seeds", "make_seeds", "flow_key", "service_key",
    "hash_combine", "bucket_salts", "uint32", "_U32", "u32", "as_u32",
])

_INT32_MAX = 0x7FFFFFFF
_U32_BINOPS = (ast.Mult, ast.Add, ast.Sub, ast.LShift, ast.BitXor,
               ast.BitOr, ast.Mod, ast.FloorDiv)


@register
class U32Overflow(Checker):
    """The hashing discipline (utils/u32.py, ops/hashing.py): every
    mixing constant on a uint32 lane is wrapped (`_U32(0x85EBCA6B)`)
    so host numpy and device jnp wrap identically at 32 bits. A bare
    Python int that does not fit int32 mixed into a tracked lane
    promotes the host side to int64 while the device side (int32 jnp
    default) overflows — the exact way a host/device twin pair drifts
    in overflow behavior without any AST edit to either twin. Also
    flags casting an unmasked uint32 lane straight to int32 (values
    >= 2^31 go negative; shift or mask into range first, as
    ops/hashing.bucket does)."""

    name = "u32-overflow"
    description = ("uint32-by-convention lane mixed with a bare int "
                   "constant beyond int32, or cast to int32 without a "
                   "range-clearing shift/mask — wrap constants in "
                   "np.uint32 (the _mix32 discipline)")

    def check(self, ctx: FileContext,
              index: ProjectIndex) -> Iterable[Finding]:
        if not self._in_scope(ctx, index):
            return
        for node, cls, funcs in _walk_scoped(ctx.tree):
            if not isinstance(node, _FUNC_DEFS):
                continue
            yield from self._check_frame(ctx, node,
                                         _scope_label(cls, funcs
                                                      + (node.name,)))

    @staticmethod
    def _in_scope(ctx: FileContext, index: ProjectIndex) -> bool:
        if ctx.path.endswith(("utils/u32.py", "ops/hashing.py")):
            return True
        for _local, (mod, _lvl, orig) in \
                index.imports.get(ctx.path, {}).items():
            text = f"{mod}.{orig}"
            if "u32" in text or "hashing" in text:
                return True
        return False

    def _check_frame(self, ctx: FileContext, fn: ast.AST,
                     scope: str) -> Iterable[Finding]:
        u32: Set[str] = set()
        # fixpoint over assignment chains (x = mix32(...); y = x ^ k)
        for _ in range(3):
            grew = False
            for node in _walk_same_frame(fn):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1):
                    continue
                v = dotted(node.targets[0])
                if v and v not in u32 and self._is_u32(node.value, u32):
                    u32.add(v)
                    grew = True
            if not grew:
                break
        for node in _walk_same_frame(fn):
            if isinstance(node, ast.BinOp) \
                    and isinstance(node.op, _U32_BINOPS):
                pairs = ((node.left, node.right), (node.right, node.left))
                for lane, const in pairs:
                    if not self._is_u32(lane, u32):
                        continue
                    if isinstance(const, ast.Constant) \
                            and isinstance(const.value, int) \
                            and not isinstance(const.value, bool) \
                            and not (0 <= const.value <= _INT32_MAX):
                        yield self.finding(
                            ctx, const,
                            f"bare int constant {const.value:#x} mixed "
                            f"into a uint32 lane in {scope} — the host "
                            f"side promotes to int64 while the device "
                            f"side overflows int32, so the twins "
                            f"diverge; wrap it (np.uint32(...), the "
                            f"_mix32 discipline)")
                        break
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "astype" \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id in u32 and node.args:
                dt = dotted(node.args[0]) or ""
                if dt.rsplit(".", 1)[-1] == "int32":
                    yield self.finding(
                        ctx, node,
                        f"uint32 lane '{node.func.value.id}' cast "
                        f"straight to int32 in {scope} — hash values "
                        f">= 2^31 go negative; shift or mask into "
                        f"range first (the ops/hashing bucket "
                        f"discipline)")

    def _is_u32(self, node: ast.AST, u32: Set[str]) -> bool:
        if isinstance(node, ast.Name):
            return node.id in u32
        if isinstance(node, ast.Attribute):
            d = dotted(node)
            return d in u32 if d else False
        if isinstance(node, ast.Call):
            d = dotted(node.func)
            return bool(d) and d.rsplit(".", 1)[-1] in _U32_PRODUCERS
        if isinstance(node, ast.BinOp):
            return self._is_u32(node.left, u32) \
                or self._is_u32(node.right, u32)
        return False


# -- pytree-schema-drift ----------------------------------------------------

def _ann_str(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return ast.dump(node, include_attributes=False)


def schema_leaves(node: ast.AST) -> List[dict]:
    """Leaf layout of a state class: NamedTuple AnnAssign fields in
    declaration order (name + declared type), or — for plain classes
    like AlertSnapshot — the `leaves()` staticmethod's parameter order
    with the np dtype each leaf is asarray'd to. This IS the flatten
    order snapbus serializes as `leaf_{i}` npz keys."""
    if not isinstance(node, ast.ClassDef):
        return []
    out: List[dict] = []
    for item in node.body:
        if isinstance(item, ast.AnnAssign) \
                and isinstance(item.target, ast.Name):
            out.append({"name": item.target.id,
                        "type": _ann_str(item.annotation)})
    if out:
        return out
    for item in node.body:
        if isinstance(item, _FUNC_DEFS) and item.name == "leaves":
            params = [a.arg for a in item.args.args
                      if a.arg not in ("self", "cls")]
            dtypes: Dict[str, str] = {}
            for sub in ast.walk(item):
                if not (isinstance(sub, ast.Return)
                        and isinstance(sub.value, (ast.List, ast.Tuple))):
                    continue
                for elt in sub.value.elts:
                    if not (isinstance(elt, ast.Call) and elt.args):
                        continue
                    name = dotted(elt.args[0])
                    if name is None:
                        continue
                    dt = None
                    if len(elt.args) > 1:
                        dt = dotted(elt.args[1])
                    for kw in elt.keywords:
                        if kw.arg == "dtype":
                            dt = dotted(kw.value)
                    dtypes[name.rsplit(".", 1)[-1]] = dt or "?"
            return [{"name": p, "type": dtypes.get(p, "?")}
                    for p in params]
    return []


def schema_fingerprint(leaves: List[dict]) -> str:
    blob = json.dumps(leaves, sort_keys=True)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


class SchemaDecl:
    def __init__(self, schema_id: str, ref: str, decl_path: str,
                 decl_line: int) -> None:
        self.schema_id = schema_id
        self.ref = ref
        self.decl_path = decl_path
        self.decl_line = decl_line


def collect_schemas(index: ProjectIndex) -> List[SchemaDecl]:
    """SCHEMA_TABLE rows parsed lexically out of any scanned
    analysis/devprog.py (the real package's, or a fixture's own)."""
    cached = index.memo.get("devprog_schemas")
    if cached is not None:
        return cached
    out: List[SchemaDecl] = []
    for path in sorted(index.trees):
        if not path.endswith("analysis/devprog.py"):
            continue
        tree = index.trees[path]
        for node in tree.body:
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "SCHEMA_TABLE"
                    and isinstance(node.value, (ast.List, ast.Tuple))):
                continue
            for elt in node.value.elts:
                if not isinstance(elt, (ast.Tuple, ast.List)) \
                        or len(elt.elts) != 2:
                    continue
                vals = [e.value for e in elt.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)]
                if len(vals) == 2:
                    out.append(SchemaDecl(vals[0], vals[1], path,
                                          elt.elts[0].lineno))
    seen: Dict[str, SchemaDecl] = {}
    for s in out:
        seen.setdefault(s.schema_id, s)
    out = sorted(seen.values(), key=lambda s: s.schema_id)
    index.memo["devprog_schemas"] = out
    return out


def _leaf_diff(old: List[dict], new: List[dict]) -> str:
    oldn = [l["name"] for l in old]
    newn = [l["name"] for l in new]
    oldt = {l["name"]: l.get("type") for l in old}
    newt = {l["name"]: l.get("type") for l in new}
    parts: List[str] = []
    added = [n for n in newn if n not in oldn]
    removed = [n for n in oldn if n not in newn]
    if added:
        parts.append("added leaf " + ", ".join(f"'{n}'" for n in added))
    if removed:
        parts.append("removed leaf "
                     + ", ".join(f"'{n}'" for n in removed))
    retyped = [n for n in newn
               if n in oldt and oldt[n] != newt[n]]
    if retyped:
        parts.append("retyped " + ", ".join(
            f"'{n}' ({oldt[n]} -> {newt[n]})" for n in retyped))
    if not parts and oldn != newn:
        for i, (a, b) in enumerate(zip(oldn, newn)):
            if a != b:
                parts.append(f"reordered (leaf {i} is now '{b}', "
                             f"was '{a}')")
                break
    return "; ".join(parts) or "leaf layout changed"


@register
class PytreeSchemaDrift(Checker):
    """A state pytree's leaf layout is the snapbus wire format: npz
    payloads carry `leaf_{i}` keys in flatten order, restore validates
    only count/shape/dtype — a reordered pair of same-shaped leaves
    restores SILENTLY WRONG. Each declared schema's layout is
    committed in .lint-schemas.json; editing one fails lint until
    `df-ctl lint --ack-schemas`, which forces the
    restore-compatibility question into review (exactly the twin-edit
    workflow)."""

    name = "pytree-schema-drift"
    description = ("durable state pytree whose leaf layout (names/"
                   "order/type) differs from the committed "
                   ".lint-schemas.json — snapshot restore breaks on "
                   "layout drift; `df-ctl lint --ack-schemas`")

    def check(self, ctx: FileContext,
              index: ProjectIndex) -> Iterable[Finding]:
        for path, line, message in self._results(index):
            if path == ctx.path:
                yield Finding(self.name, path, line, 0, message,
                              self.severity)

    def _results(self, index: ProjectIndex
                 ) -> List[Tuple[str, int, str]]:
        cached = index.memo.get("devprog_schema_results")
        if cached is not None:
            return cached
        out: List[Tuple[str, int, str]] = []
        store = index.schemas_store or {}
        entries = store.get("schemas", {}) if store else {}
        seen_ids = set()
        for decl in collect_schemas(index):
            seen_ids.add(decl.schema_id)
            hit = resolve_ref(index, decl.ref)
            if hit is None:
                decl_file = decl.ref.split(":", 1)[0]
                if any(p == decl_file or p.endswith("/" + decl_file)
                       for p in index.defs_by_path):
                    out.append((
                        decl.decl_path, decl.decl_line,
                        f"schema '{decl.schema_id}': ref {decl.ref!r} "
                        f"does not resolve in this scan — the state "
                        f"class was deleted or moved without updating "
                        f"SCHEMA_TABLE"))
                continue          # file outside the scan: stay silent
            path, node = hit
            leaves = schema_leaves(node)
            if not leaves:
                out.append((
                    path, node.lineno,
                    f"schema '{decl.schema_id}' ({decl.ref}): no leaf "
                    f"layout is derivable (neither NamedTuple fields "
                    f"nor a leaves() method) — the schema gate cannot "
                    f"protect it"))
                continue
            entry = entries.get(decl.schema_id)
            if entry is None:
                out.append((
                    path, node.lineno,
                    f"schema '{decl.schema_id}' ({decl.ref}) has no "
                    f"committed leaf fingerprint — run the snapshot "
                    f"round-trip tests, then `df-ctl lint "
                    f"--ack-schemas`"))
                continue
            if entry.get("fp") != schema_fingerprint(leaves):
                diff = _leaf_diff(entry.get("leaves", []), leaves)
                out.append((
                    path, node.lineno,
                    f"schema '{decl.schema_id}' ({decl.ref}) drifted "
                    f"since last acknowledged: {diff} — the leaf "
                    f"layout is the snapbus npz wire format (restore, "
                    f"replay and kill+rejoin read it positionally); "
                    f"re-run the snapshot round-trip tests and "
                    f"`df-ctl lint --ack-schemas`"))
        decl_path = next((p for p in sorted(index.defs_by_path)
                          if p.endswith("analysis/devprog.py")), None)
        if decl_path is not None:
            for sid in sorted(entries):
                if sid in seen_ids:
                    continue
                out.append((
                    decl_path, 1,
                    f"committed schema '{sid}' is no longer declared "
                    f"in SCHEMA_TABLE — `df-ctl lint --ack-schemas` "
                    f"to drop it deliberately"))
        index.memo["devprog_schema_results"] = out
        return out


def build_schemas_store(index: ProjectIndex) -> Tuple[dict, List[str]]:
    """Fingerprint every declared schema -> (store doc, unresolvable
    refs). Like --ack-twin, the ack path refuses to write placeholders
    for classes it cannot see."""
    entries: Dict[str, dict] = {}
    missing: List[str] = []
    for decl in collect_schemas(index):
        hit = resolve_ref(index, decl.ref)
        if hit is None:
            missing.append(f"{decl.schema_id}: ref {decl.ref!r}")
            continue
        leaves = schema_leaves(hit[1])
        if not leaves:
            missing.append(f"{decl.schema_id}: no derivable leaf "
                           f"layout at {decl.ref!r}")
            continue
        entries[decl.schema_id] = {"ref": decl.ref, "leaves": leaves,
                                   "fp": schema_fingerprint(leaves)}
    return {"version": SCHEMAS_STORE_VERSION, "tool": "deepflow-lint",
            "schemas": entries}, missing


# -- per-value device syncs (consumed by checkers.HostSyncInDevicePath) -----

_MATERIALIZER_NAMES = frozenset(["float", "bool"])


def device_value_syncs(ctx: FileContext, index: ProjectIndex,
                       sanctioned: frozenset
                       ) -> List[Tuple[ast.AST, str, str, str, str]]:
    """(node, sync kind, var, producer label, scope) for every value
    provably produced by a jitted program that reaches `.item()` /
    `float()` / `bool()` / `np.asarray` / `device_get` outside the
    sanctioned sync helpers — in ANY file. This is the per-VALUE form
    of the host-sync rule: the finding is the device value, not the
    file it sits in."""
    bindings = bindings_for(ctx.path, ctx.tree, index)
    if not bindings:
        return []
    # device-valued names, per (class, function-stack) frame, plus
    # self.<attr> targets class-wide (a jit result stored on self in
    # one method is still a device value in every other method)
    frame_dev: Dict[tuple, Dict[str, str]] = {}
    class_dev: Dict[Optional[str], Dict[str, str]] = {}
    for node, cls, funcs in _walk_scoped(ctx.tree):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        d = dotted(node.value.func)
        site = bindings.get(d) if d else None
        if site is None:
            continue
        names: List[str] = []
        for t in node.targets:
            elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
            for e in elts:
                v = dotted(e)
                if v:
                    names.append(v)
        for v in names:
            if v.startswith("self."):
                class_dev.setdefault(cls, {})[v] = site.label
            else:
                frame_dev.setdefault((cls, funcs), {})[v] = site.label
    if not frame_dev and not class_dev:
        return []
    out: List[Tuple[ast.AST, str, str, str, str]] = []
    for node, cls, funcs in _walk_scoped(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if any(f in sanctioned for f in funcs):
            continue
        dev = dict(class_dev.get(cls, {}))
        dev.update(frame_dev.get((cls, funcs), {}))
        if not dev:
            continue
        hit = _dev_sync_kind(node, dev)
        if hit is not None:
            kind, var = hit
            out.append((node, kind, var, dev[var],
                        _scope_label(cls, funcs)))
    return out


def _dev_sync_kind(call: ast.Call,
                   dev: Dict[str, str]) -> Optional[Tuple[str, str]]:
    if isinstance(call.func, ast.Attribute) and call.func.attr == "item" \
            and not call.args:
        v = dotted(call.func.value)
        if v in dev:
            return ".item()", v
    d = dotted(call.func)
    if d is None or not call.args:
        return None
    leaf = d.rsplit(".", 1)[-1]
    v = dotted(call.args[0])
    if v is None or v not in dev:
        return None
    if d in _MATERIALIZER_NAMES:
        return f"{d}()", v
    if leaf == "asarray" and d in ("np.asarray", "numpy.asarray"):
        return f"{d}()", v
    if leaf == "device_get":
        return "jax.device_get()", v
    return None
