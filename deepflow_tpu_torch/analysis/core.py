"""deepflow-lint core: the checker framework behind `df-ctl lint`.

The port's copy of the JAX package's `analysis/core.py`: the same rules,
fingerprints and finding messages, over `deepflow_tpu_torch/`. Its
committed stores live inside the port (`analysis/stores/`), never the
repo-root `.lint-*.json` / `.model-conform.json` the JAX package's own
analyzer gates on.

The pipeline keeps hard disciplines: worker
threads belong under the `Supervisor` (runtime/supervisor.py), metrics
are never emitted while a lock is held (the throttler deadlock
class), the async device pipeline only blocks inside the sanctioned
sampled-drain helpers, jitted programs stay trace-pure, every Countable
registration points at a real `counters()`, and the fault-site registry
matches its injection points. Nothing enforced any of it — each rule was
one incident away from being re-learned. This package checks them
mechanically: stdlib `ast` only (no new dependencies), a per-file
visitor pass over the tree plus one cross-file `ProjectIndex` for the
rules that need whole-project facts (class hierarchies, fault-site
definitions vs. references).

Vocabulary:

- A `Checker` declares a rule name/severity and yields `Finding`s for
  one parsed file; checkers register themselves via `@register`.
- `# lint: disable=<rule>[,<rule>...]` on a finding's line suppresses
  it (`all` suppresses every rule on that line).
- A *baseline* is a committed JSON file of grandfathered findings keyed
  WITHOUT line numbers (path + rule + message), so unrelated edits that
  shift lines neither resurface old findings nor hide new ones. The CI
  gate is "no findings beyond the baseline", and shrinking the baseline
  is how debt is paid down (it must shrink, not grow).
"""

from __future__ import annotations

import ast
import json
import os
import re
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Finding", "FileContext", "ProjectIndex", "Checker",
           "register", "all_rules", "run_lint", "run_on_sources",
           "scan_package", "save_baseline", "load_baseline",
           "new_findings", "format_findings", "findings_to_json",
           "findings_to_sarif", "default_twin_store_path",
           "default_conform_store_path", "default_doc_path",
           "default_programs_store_path", "default_schemas_store_path",
           "default_baseline_path", "store_dir"]


@dataclass(frozen=True)
class Finding:
    """One rule violation at one site."""

    rule: str
    path: str          # repo-relative posix path ("deepflow_tpu_torch/...")
    line: int
    col: int
    message: str
    severity: str = "error"

    @property
    def key(self) -> str:
        """Baseline identity: deliberately line/col-free so grandfathered
        findings survive unrelated edits above them in the file."""
        return f"{self.path}::{self.rule}::{self.message}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "severity": self.severity}

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.severity}: [{self.rule}] {self.message}")


# -- pragmas ---------------------------------------------------------------

_PRAGMA_RE = re.compile(r"#\s*lint:\s*disable=([A-Za-z0-9_,\-]+)")


def _pragmas(source: str) -> Dict[int, set]:
    """line (1-based) -> set of rule names disabled on that line.
    Tokenized, not regex-over-lines: a pragma inside a STRING literal
    ("# lint: disable=all" as data) must not silently suppress real
    findings on its line."""
    import io
    import tokenize
    out: Dict[int, set] = {}
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return out             # unparsable files never reach checkers
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _PRAGMA_RE.search(tok.string)
        if m:
            out.setdefault(tok.start[0], set()).update(
                r.strip() for r in m.group(1).split(",") if r.strip())
    return out


@dataclass
class FileContext:
    """Everything a checker sees for one file."""

    path: str                  # normalized posix, repo-relative
    source: str
    tree: ast.Module
    pragma_lines: Dict[int, set] = field(default_factory=dict)

    def suppressed(self, f: Finding) -> bool:
        rules = self.pragma_lines.get(f.line)
        return bool(rules) and (f.rule in rules or "all" in rules)


# -- cross-file project index ----------------------------------------------

@dataclass
class ClassInfo:
    name: str
    path: str
    bases: List[str]                       # dotted base expressions
    methods: set = field(default_factory=set)
    # self.<attr> = ClassName(...) constructor calls seen in any method
    attr_classes: Dict[str, str] = field(default_factory=dict)
    # self.<attr> = threading.Lock()/RLock()/Condition(...)
    lock_attrs: set = field(default_factory=set)
    # lock attr -> "Lock" | "RLock" | "Condition" (re-entrancy matters
    # to the lock-order checker: with self._rlock nested in itself is
    # legal, with self._lock is a self-deadlock)
    lock_kinds: Dict[str, str] = field(default_factory=dict)
    # method name -> its def node (the concurrency checkers walk real
    # bodies; names alone cannot carry held-lock context)
    method_asts: Dict[str, ast.AST] = field(default_factory=dict)
    # methods whose bound reference was passed to a *.spawn(...) call
    # (Supervisor.spawn targets and worker factories): thread roots
    spawned: set = field(default_factory=set)
    # methods handed out as bare `self.<m>` callback references in any
    # call (ctor wiring like DeviceFeed(process=self._feed), scrape
    # registration): they run on whoever holds the reference — another
    # thread until proven otherwise
    callbacks: set = field(default_factory=set)


# a string literal that could plausibly name a fault site ("queue.stall")
_SITE_STR_RE = re.compile(r"^[a-z][a-z0-9_]*\.[a-z][a-z0-9_]*$")

_DEF_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


class ProjectIndex:
    """Whole-scan facts for the cross-file rules.

    Built in one pass over every parsed file before checkers run:
    class hierarchies (countable-missing-counters resolves `counters()`
    through repo-local bases), per-class lock attributes (emit-under-lock
    recognizes `with self._ready:` when `_ready` was assigned a
    `threading.Condition`), and the fault-site ledger (fault-site-drift
    diffs `FAULT_*` definitions in faults.py against name/value
    references at the injection points).
    """

    def __init__(self) -> None:
        self.classes: Dict[str, List[ClassInfo]] = {}
        # path -> local name -> (module, relative-import level, orig
        # name; orig == "" for plain `import module [as name]`)
        self.imports: Dict[str, Dict[str, Tuple[str, int, str]]] = {}
        # FAULT_* consts defined in faults.py: name -> (value, line)
        self.fault_defs: Dict[str, Tuple[str, int]] = {}
        self.fault_defs_path: Optional[str] = None
        # FAULT_* Name loads outside faults.py: name -> [(path, line)]
        self.fault_refs: Dict[str, List[Tuple[str, int]]] = {}
        # site-shaped string literals outside faults.py: value -> paths
        self.site_strings: Dict[str, set] = {}
        # path -> qualname ("func" / "Class" / "Class.method") -> node,
        # for the twin-drift fingerprint resolver
        self.defs_by_path: Dict[str, Dict[str, ast.AST]] = {}
        # path -> module tree (twin-table parsing needs module-level
        # statements, which defs_by_path deliberately drops)
        self.trees: Dict[str, ast.Module] = {}
        # committed twin-fingerprint store (.lint-twins.json contents),
        # or None when the scan was given none (fixture scans)
        self.twin_store: Optional[dict] = None
        # committed model-conformance store (.model-conform.json), same
        # contract as twin_store (gated exactly alike)
        self.conform_store: Optional[dict] = None
        # committed jit cache-key store (.lint-programs.json) and
        # durable-pytree schema store (.lint-schemas.json) for the
        # device-plane rules; None for fixture scans
        self.programs_store: Optional[dict] = None
        self.schemas_store: Optional[dict] = None
        # project documentation text (README.md) for the doc-drift
        # rule; None = no doc in scope (fixture scans stay silent)
        self.doc_text: Optional[str] = None
        # scratch memo space for whole-program analyses built lazily on
        # first query (lock graph, twin registry): one build per scan
        # no matter how many files ask — the memoized-ProjectIndex
        # contract behind the lint runtime budget
        self.memo: Dict[str, object] = {}

    # -- construction ------------------------------------------------------
    def add_file(self, ctx: FileContext) -> None:
        is_faults = ctx.path.endswith("faults.py")
        self.trees[ctx.path] = ctx.tree
        self._add_defs(ctx)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                self._add_class(node, ctx.path)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name.split(".")[0]
                    self.imports.setdefault(ctx.path, {})[local] = \
                        (a.name, 0, "")
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    self.imports.setdefault(ctx.path, {})[
                        a.asname or a.name] = \
                        (node.module or "", node.level, a.name)
            elif is_faults and isinstance(node, ast.Assign):
                self._maybe_fault_def(node, ctx.path)
            elif not is_faults and isinstance(node, ast.Name) \
                    and isinstance(node.ctx, ast.Load) \
                    and node.id.startswith("FAULT_"):
                self.fault_refs.setdefault(node.id, []).append(
                    (ctx.path, node.lineno))
            elif not is_faults and isinstance(node, ast.Constant) \
                    and isinstance(node.value, str) \
                    and _SITE_STR_RE.match(node.value):
                self.site_strings.setdefault(node.value, set()).add(ctx.path)

    def _maybe_fault_def(self, node: ast.Assign, path: str) -> None:
        if (len(node.targets) == 1 and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.startswith("FAULT_")
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            self.fault_defs[node.targets[0].id] = (node.value.value,
                                                   node.lineno)
            self.fault_defs_path = path

    def _add_defs(self, ctx: FileContext) -> None:
        """Top-level (and one-level class-nested) def/class nodes by
        qualname — the twin-drift resolver's address space."""
        defs = self.defs_by_path.setdefault(ctx.path, {})
        for item in ctx.tree.body:
            if isinstance(item, _DEF_NODES):
                defs[item.name] = item
                if isinstance(item, ast.ClassDef):
                    for sub in item.body:
                        if isinstance(sub, _DEF_NODES):
                            defs[f"{item.name}.{sub.name}"] = sub

    def _add_class(self, node: ast.ClassDef, path: str) -> None:
        info = ClassInfo(node.name, path,
                         [d for d in (dotted(b) for b in node.bases) if d])
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info.methods.add(item.name)
                info.method_asts[item.name] = item
                for sub in ast.walk(item):
                    self._maybe_self_attr(sub, info)
                    self._maybe_spawn(sub, info)
            elif isinstance(item, ast.Assign):
                for t in item.targets:
                    if isinstance(t, ast.Name):
                        info.methods.add(t.id)     # class-level attrs too
        self.classes.setdefault(node.name, []).append(info)

    @staticmethod
    def _maybe_self_attr(node: ast.AST, info: ClassInfo) -> None:
        """Record `self.X = Ctor(...)` constructor and lock assignments."""
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            return
        t = node.targets[0]
        if not (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                and t.value.id == "self" and isinstance(node.value, ast.Call)):
            return
        ctor = dotted(node.value.func)
        if ctor is None:
            return
        leaf = ctor.rsplit(".", 1)[-1]
        if leaf in ("Lock", "RLock", "Condition"):
            info.lock_attrs.add(t.attr)
            info.lock_kinds[t.attr] = leaf
        else:
            info.attr_classes.setdefault(t.attr, leaf)

    @staticmethod
    def _maybe_spawn(node: ast.AST, info: ClassInfo) -> None:
        """Record thread-root handoffs of this class's methods.

        `sup.spawn(name, self._run)` marks `_run` a spawn target (the
        Supervisor.spawn signature: target is the second positional or
        the `target=` keyword); `sup.spawn(name, self._make_worker(i))`
        marks the factory (its returned closure runs on the thread).
        Separately, ANY bare `self.<m>` passed as a call argument is a
        callback reference (`DeviceFeed(process=self._feed)`,
        `stats.register("x", self.counters)`) — it runs on whichever
        thread holds it."""
        if not isinstance(node, ast.Call):
            return
        args = list(node.args) + [kw.value for kw in node.keywords]
        for arg in args:
            if (isinstance(arg, ast.Attribute)
                    and isinstance(arg.value, ast.Name)
                    and arg.value.id == "self"):
                info.callbacks.add(arg.attr)
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr == "spawn"):
            return
        targets = node.args[1:2] + [kw.value for kw in node.keywords
                                    if kw.arg in ("target", "fn")]
        for arg in targets:
            target = arg.func if isinstance(arg, ast.Call) else arg
            if (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"):
                info.spawned.add(target.attr)

    # -- queries -----------------------------------------------------------
    _EXTERNAL_BASES = frozenset(["object", "Protocol", "ABC", "Generic",
                                 "Enum", "IntEnum", "NamedTuple"])

    def _module_files(self, mod: str, level: int,
                      from_path: str) -> List[str]:
        """Path suffixes a dotted module could live at. Relative imports
        resolve against the importing file's directory."""
        if level:
            base = os.path.dirname(from_path)
            for _ in range(level - 1):
                base = os.path.dirname(base)
            stem = "/".join(p for p in (base.replace(os.sep, "/"),
                                        mod.replace(".", "/")) if p)
        else:
            stem = mod.replace(".", "/")
        return [stem + ".py", stem + "/__init__.py"] if stem else []

    def _infos_for_name(self, from_path: str,
                        dotted_name: str) -> Optional[List[ClassInfo]]:
        """Resolve a class NAME as used in `from_path` to its ClassInfo
        candidates, honoring that file's imports. None = unknown (the
        name is imported from outside the scan, or unresolvable) —
        homonym classes in other files never stand in for an import
        (the 'proven absence only' contract)."""
        parts = dotted_name.split(".")
        leaf = parts[-1]
        cands = self.classes.get(leaf, [])
        imp = self.imports.get(from_path, {})
        if len(parts) == 1:
            ent = imp.get(leaf)
            if ent is None:
                # not imported: only a same-file definition counts
                # (plus the bare cross-file fixture case: a file with
                # no import statements at all may reference freely)
                same = [i for i in cands if i.path == from_path]
                if same:
                    return same
                if not imp:
                    return cands or None
                return None
            mod, level, orig = ent
            if orig == "":
                return None            # `import x` then bare x as a class?
            suffixes = self._module_files(mod, level, from_path)
        else:
            ent = imp.get(parts[0])
            if ent is None:
                return None
            mod, level, orig = ent
            middle = parts[1:-1]
            if orig == "":             # import pkg.mod [as root]
                suffixes = self._module_files(
                    ".".join([mod] + middle), 0, from_path)
            else:                      # from mod import sub [as root]
                sub = ".".join([orig] + middle)
                mod_full = f"{mod}.{sub}" if mod else sub
                suffixes = self._module_files(mod_full, level, from_path)
        out = [i for i in cands
               if any(i.path == s or i.path.endswith("/" + s)
                      for s in suffixes)]
        return out or None

    def resolves_method(self, class_name: str, method: str,
                        path: Optional[str] = None) -> str:
        """'yes' | 'no' | 'unknown': does the class (or any resolvable
        ancestor) define `method`? `path` anchors homonym classes to
        the file where the registration was seen. 'unknown' whenever a
        class or base along an undecided chain cannot be pinned to a
        repo-local definition — the checker only reports when the
        absence is PROVEN, never on partial information."""
        infos = self.classes.get(class_name)
        if not infos:
            return "unknown"
        if path is not None:
            infos = self._infos_for_name(path, class_name)
            if infos is None:
                return "unknown"
        return self._resolves_infos(infos, method, set())

    def _resolves_infos(self, infos: List[ClassInfo], method: str,
                        seen: set) -> str:
        verdict = "no"
        for info in infos:
            key = (info.path, info.name)
            if key in seen:
                continue               # cycle: nothing new that way
            seen.add(key)
            if method in info.methods:
                return "yes"
            for base in info.bases:
                if base.rsplit(".", 1)[-1] in self._EXTERNAL_BASES:
                    continue           # known method-free for our rules
                sub_infos = self._infos_for_name(info.path, base)
                if sub_infos is None:
                    verdict = "unknown"
                    continue
                sub = self._resolves_infos(sub_infos, method, seen)
                if sub == "yes":
                    return "yes"
                if sub == "unknown":
                    verdict = "unknown"
        return verdict

    def lock_attrs_of(self, class_name: str,
                      path: Optional[str] = None) -> set:
        """Lock/Condition attrs of `class_name`; `path` pins homonyms
        to the file being checked (attrs of an unrelated same-named
        class elsewhere must not leak in)."""
        infos = self.classes.get(class_name, [])
        if path is not None:
            same = [i for i in infos if i.path == path]
            infos = same or infos
        out: set = set()
        for info in infos:
            out |= info.lock_attrs
        return out


def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# -- checker registry ------------------------------------------------------

class Checker:
    """One rule. Subclasses set `name`/`severity`/`description` and
    implement `check` yielding Findings for a single file (the shared
    `ProjectIndex` carries any cross-file facts they need)."""

    name = ""
    severity = "error"
    description = ""

    def check(self, ctx: FileContext,
              index: ProjectIndex) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, ctx: FileContext, node: ast.AST,
                message: str) -> Finding:
        return Finding(self.name, ctx.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message,
                       self.severity)


_REGISTRY: Dict[str, type] = {}


def register(cls: type) -> type:
    if not cls.name:
        raise ValueError(f"{cls.__name__} has no rule name")
    _REGISTRY[cls.name] = cls
    return cls


def all_rules() -> Dict[str, type]:
    """rule name -> Checker class. Checker modules register on import;
    discovery walks the WHOLE analysis package (pkgutil), so a new
    rule module lands in the registry — and therefore in --list-rules
    and the SARIF rule table — the moment the file exists. No
    hand-maintained import list to forget."""
    import importlib
    import pkgutil

    import deepflow_tpu_torch.analysis as _pkg
    for info in pkgutil.walk_packages(_pkg.__path__,
                                      prefix=_pkg.__name__ + "."):
        importlib.import_module(info.name)
    return dict(_REGISTRY)


# -- runner ----------------------------------------------------------------

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "node_modules"}


def _iter_py_files(root: str) -> List[str]:
    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in _SKIP_DIRS and not d.startswith("."))
        out.extend(os.path.join(dirpath, f) for f in sorted(filenames)
                   if f.endswith(".py"))
    return out


def build_index(files: Sequence[Tuple[str, str]]
                ) -> Tuple[List[FileContext], ProjectIndex, List[Finding]]:
    """Parse + index (relpath, source) pairs. Unparsable files become
    parse-error findings instead of contexts — a silent parse skip
    would read as "clean" (no-silent-caps)."""
    contexts: List[FileContext] = []
    errors: List[Finding] = []
    index = ProjectIndex()
    for path, source in files:
        cached = _PARSE_CACHE.get(path)
        if cached is not None and cached[0] == source:
            ctx = FileContext(path, source, cached[1], cached[2])
        else:
            try:
                tree = ast.parse(source, filename=path)
            except SyntaxError as e:
                errors.append(Finding("parse-error", path, e.lineno or 1,
                                      e.offset or 0,
                                      f"syntax error: {e.msg}"))
                continue
            ctx = FileContext(path, source, tree, _pragmas(source))
            _PARSE_CACHE[path] = (source, tree, ctx.pragma_lines)
        contexts.append(ctx)
        index.add_file(ctx)
    return contexts, index, errors


# path -> (source, tree, pragma lines): parsing ~250 files dominates a
# self-scan, and the debug-loop `lint` command + the gate's budget both
# re-scan an unchanged tree — trees are never mutated by checkers, so
# an exact-source hit is safe to share across ProjectIndex builds
_PARSE_CACHE: Dict[str, Tuple[str, ast.Module, Dict[int, set]]] = {}


def _check_files(files: Sequence[Tuple[str, str]],
                 rules: Optional[Sequence[str]] = None,
                 twin_store: Optional[dict] = None,
                 conform_store: Optional[dict] = None,
                 doc_text: Optional[str] = None,
                 programs_store: Optional[dict] = None,
                 schemas_store: Optional[dict] = None) -> List[Finding]:
    """Core pass over (relpath, source) pairs: parse, index, check."""
    registry = all_rules()
    if rules:
        unknown = sorted(set(rules) - set(registry))
        if unknown:
            raise ValueError(f"unknown rule(s): {', '.join(unknown)} "
                             f"(known: {', '.join(sorted(registry))})")
        registry = {k: v for k, v in registry.items() if k in rules}
    contexts, index, findings = build_index(files)
    index.twin_store = twin_store
    index.conform_store = conform_store
    index.doc_text = doc_text
    index.programs_store = programs_store
    index.schemas_store = schemas_store
    for ctx in contexts:
        for cls in registry.values():
            for f in cls().check(ctx, index):
                if not ctx.suppressed(f):
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def _norm(path: str, start: str) -> str:
    return os.path.relpath(os.path.abspath(path), start).replace(os.sep, "/")


def package_parent() -> str:
    """Directory finding paths are relative to (the installed port
    package's parent — the repo root), so they read
    "deepflow_tpu_torch/..." from any cwd."""
    import deepflow_tpu_torch
    return os.path.dirname(os.path.dirname(
        os.path.abspath(deepflow_tpu_torch.__file__)))


def store_dir() -> str:
    """The port's committed stores: `analysis/stores/` inside the
    package (the repo-root files belong to the JAX package)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "stores")


def default_baseline_path() -> str:
    return os.path.join(store_dir(), "lint-baseline.json")


def default_twin_store_path() -> str:
    return os.path.join(store_dir(), "lint-twins.json")


def default_conform_store_path() -> str:
    return os.path.join(store_dir(), "model-conform.json")


def default_doc_path() -> str:
    return os.path.join(package_parent(), "README.md")


def default_programs_store_path() -> str:
    return os.path.join(store_dir(), "lint-programs.json")


def default_schemas_store_path() -> str:
    return os.path.join(store_dir(), "lint-schemas.json")


def _auto_twin_store(twin_store) -> Optional[dict]:
    """"auto" -> the committed lint-twins.json (None before the first
    --ack-twin ever ran); a dict/None passes through (fixtures)."""
    if twin_store != "auto":
        return twin_store
    from deepflow_tpu_torch.analysis import twins
    try:
        return twins.load_store(default_twin_store_path())
    except FileNotFoundError:
        return None


def _auto_conform_store(conform_store) -> Optional[dict]:
    """"auto" -> the committed model-conform.json (None before the
    first --ack-conform); a dict/None passes through (fixtures)."""
    if conform_store != "auto":
        return conform_store
    from deepflow_tpu_torch.analysis.model import conform
    try:
        return conform.load_store(default_conform_store_path())
    except FileNotFoundError:
        return None


def _auto_programs_store(programs_store) -> Optional[dict]:
    """"auto" -> the committed lint-programs.json (None before the
    first --ack-programs); a dict/None passes through (fixtures)."""
    if programs_store != "auto":
        return programs_store
    from deepflow_tpu_torch.analysis import devprog
    try:
        return devprog.load_programs_store(default_programs_store_path())
    except FileNotFoundError:
        return None


def _auto_schemas_store(schemas_store) -> Optional[dict]:
    """"auto" -> the committed lint-schemas.json (None before the
    first --ack-schemas); a dict/None passes through (fixtures)."""
    if schemas_store != "auto":
        return schemas_store
    from deepflow_tpu_torch.analysis import devprog
    try:
        return devprog.load_schemas_store(default_schemas_store_path())
    except FileNotFoundError:
        return None


def _auto_doc_text(doc_text) -> Optional[str]:
    """"auto" -> the repo README.md (the doc-drift rule's coverage
    target); a str/None passes through (fixtures)."""
    if doc_text != "auto":
        return doc_text
    try:
        with open(default_doc_path(), encoding="utf-8") as fh:
            return fh.read()
    except OSError:
        return None


def run_lint(paths: Optional[Sequence[str]] = None,
             rules: Optional[Sequence[str]] = None,
             twin_store="auto", conform_store="auto",
             doc_text="auto", programs_store="auto",
             schemas_store="auto") -> List[Finding]:
    """Lint `paths` (files or directories; default: the installed
    deepflow_tpu_torch package). Files under the installed package normalize
    relative to the package PARENT ("deepflow_tpu_torch/runtime/stats.py" —
    the same keys scan_package and the committed baseline use, from any
    cwd); files elsewhere fall back to cwd-relative."""
    if not paths:
        return scan_package(rules=rules, twin_store=twin_store,
                            conform_store=conform_store,
                            doc_text=doc_text,
                            programs_store=programs_store,
                            schemas_store=schemas_store)
    return _check_files(load_path_sources(paths), rules=rules,
                        twin_store=_auto_twin_store(twin_store),
                        conform_store=_auto_conform_store(conform_store),
                        doc_text=_auto_doc_text(doc_text),
                        programs_store=_auto_programs_store(programs_store),
                        schemas_store=_auto_schemas_store(schemas_store))


def load_path_sources(paths: Sequence[str]) -> List[Tuple[str, str]]:
    pkg_parent = package_parent()
    cwd = os.getcwd()
    files: List[Tuple[str, str]] = []
    for p in paths:
        targets = _iter_py_files(p) if os.path.isdir(p) else [p]
        for t in targets:
            rel = _norm(t, pkg_parent)
            if rel.startswith(".."):
                rel = _norm(t, cwd)
            with open(t, encoding="utf-8") as fh:
                files.append((rel, fh.read()))
    return files


def load_package_sources() -> List[Tuple[str, str]]:
    pkg_parent = package_parent()
    pkg_dir = os.path.join(pkg_parent, "deepflow_tpu_torch")
    files = []
    for t in _iter_py_files(pkg_dir):
        with open(t, encoding="utf-8") as fh:
            files.append((_norm(t, pkg_parent), fh.read()))
    return files


def scan_package(rules: Optional[Sequence[str]] = None,
                 twin_store="auto", conform_store="auto",
                 doc_text="auto", programs_store="auto",
                 schemas_store="auto") -> List[Finding]:
    """Self-scan the installed deepflow_tpu_torch tree (CI + the `lint` debug
    command): paths come out relative to the package's parent, matching
    the committed baseline regardless of the caller's cwd."""
    return _check_files(load_package_sources(), rules=rules,
                        twin_store=_auto_twin_store(twin_store),
                        conform_store=_auto_conform_store(conform_store),
                        doc_text=_auto_doc_text(doc_text),
                        programs_store=_auto_programs_store(programs_store),
                        schemas_store=_auto_schemas_store(schemas_store))


def run_on_sources(sources: Dict[str, str],
                   rules: Optional[Sequence[str]] = None,
                   twin_store: Optional[dict] = None,
                   conform_store: Optional[dict] = None,
                   doc_text: Optional[str] = None,
                   programs_store: Optional[dict] = None,
                   schemas_store: Optional[dict] = None) -> List[Finding]:
    """Lint in-memory {path: source} — the test-fixture surface.
    All stores and `doc_text` default to None (NOT the committed
    stores or the real README): fixture scans must never be judged
    against the real repo's contracts."""
    return _check_files(sorted(sources.items()), rules=rules,
                        twin_store=twin_store,
                        conform_store=conform_store, doc_text=doc_text,
                        programs_store=programs_store,
                        schemas_store=schemas_store)


# -- baseline --------------------------------------------------------------

_BASELINE_VERSION = 1


def save_baseline(findings: Sequence[Finding], path: str) -> None:
    """Grandfather `findings`: line-free entries, sorted for stable
    diffs (a baseline change must review as a list edit, not a shuffle)."""
    entries = sorted(
        ({"path": f.path, "rule": f.rule, "message": f.message,
          "severity": f.severity} for f in findings),
        key=lambda e: (e["path"], e["rule"], e["message"]))
    doc = {"version": _BASELINE_VERSION, "tool": "deepflow-lint",
           "findings": entries}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")


def load_baseline(path: str) -> Counter:
    """Baseline file -> Counter of finding keys (multiset: two identical
    grandfathered violations in one file need two entries)."""
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("version") != _BASELINE_VERSION:
        raise ValueError(f"{path}: unsupported baseline version "
                         f"{doc.get('version')!r}")
    return Counter(f"{e['path']}::{e['rule']}::{e['message']}"
                   for e in doc["findings"])


def new_findings(findings: Sequence[Finding],
                 baseline: Counter) -> List[Finding]:
    """Findings beyond the baseline's multiset — the CI gate. The n-th
    occurrence of a key is new once n exceeds its grandfathered count."""
    seen: Counter = Counter()
    out: List[Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col)):
        seen[f.key] += 1
        if seen[f.key] > baseline.get(f.key, 0):
            out.append(f)
    return out


# -- output ----------------------------------------------------------------

def format_findings(findings: Sequence[Finding]) -> str:
    if not findings:
        return "deepflow-lint: clean"
    by_rule = Counter(f.rule for f in findings)
    lines = [f.render() for f in findings]
    lines.append("deepflow-lint: " + ", ".join(
        f"{n} {r}" for r, n in sorted(by_rule.items())))
    return "\n".join(lines)


def findings_to_json(findings: Sequence[Finding]) -> str:
    return json.dumps([f.to_dict() for f in findings], indent=1)


_SARIF_LEVELS = {"error": "error", "warning": "warning", "note": "note"}


def findings_to_sarif(findings: Sequence[Finding]) -> dict:
    """SARIF 2.1.0 document for CI annotation surfaces (`df-ctl lint
    --sarif <path>` writes it). Carries the full rule table so a
    viewer can render descriptions for rules with zero results too."""
    rules = [{"id": name,
              "shortDescription": {"text": cls.description},
              "defaultConfiguration": {
                  "level": _SARIF_LEVELS.get(cls.severity, "error")}}
             for name, cls in sorted(all_rules().items())]
    rules.append({"id": "parse-error",
                  "shortDescription": {"text": "file failed to parse — "
                                               "checkers cannot see it"},
                  "defaultConfiguration": {"level": "error"}})
    results = [{
        "ruleId": f.rule,
        "level": _SARIF_LEVELS.get(f.severity, "error"),
        "message": {"text": f.message},
        "locations": [{"physicalLocation": {
            "artifactLocation": {"uri": f.path},
            "region": {"startLine": max(f.line, 1),
                       "startColumn": f.col + 1},
        }}],
    } for f in findings]
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {"name": "deepflow-lint",
                                "rules": rules}},
            "results": results,
        }],
    }
