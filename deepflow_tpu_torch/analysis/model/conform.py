"""The conformance layer: tie the abstract models to the real code so
the proof cannot rot.

A model checker is only worth its CI minutes while the model still
describes the program. Every protocol model declares a CONFORMANCE
contract — the code ledgers it abstracts (`counters()` methods and the
counter names it models), its fault alphabet (real `runtime/faults.py`
site strings), and the code transitions each model action twins
(`"path.py:Class.method"` refs, the twins.py address space). This
module extracts the same facts FROM THE CODE through the lint
ProjectIndex and registers the `model-conform` rule:

- a modeled counter that is no longer a key of the code's `counters()`
  dict, a modeled fault site missing from faults.py, or a twin'd
  transition whose qualname no longer resolves is a finding — the
  model says things about code that no longer exists;
- a faults.py site matching one of the model's declared prefixes
  (``shard.``/``merge.`` for the pod) that the model does NOT list is
  a finding in the other direction — the fault alphabet must stay a
  SUPERSET of the code's shard sites, or chaos grows a failure mode
  the proof never explored;
- the committed `.model-conform.json` fingerprint is gated exactly
  like `.lint-twins.json`: the extracted code-side alphabet (counter
  key sets, normalized-AST fingerprints of the twinned transitions,
  the declared site list) must match the committed one. Editing
  `PodFlowSuite._contribute` or growing `counters()` without
  re-acknowledging (`df-ctl verify --ack-conform`, after `df-ctl
  verify` passed) fails CI here.

CONFORMANCE dicts are parsed LEXICALLY out of the scanned sources of
`analysis/model/*` (pure literals, like TWIN_TABLE), so fixture scans
can ship their own models and the real scan never imports anything.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from deepflow_tpu_torch.analysis.core import (Checker, FileContext, Finding,
                                              ProjectIndex, register)
from deepflow_tpu_torch.analysis.twins import fingerprint, resolve_ref

__all__ = ["CONFORM_STORE_VERSION", "collect_conformances",
           "extract_counter_keys", "build_store", "load_store",
           "save_store", "ModelConform"]

CONFORM_STORE_VERSION = 1


def load_store(path: str) -> dict:
    import json
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("version") != CONFORM_STORE_VERSION:
        raise ValueError(f"{path}: unsupported conform-store version "
                         f"{doc.get('version')!r}")
    return doc


def save_store(doc: dict, path: str) -> None:
    import json
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")


# -- declaration collection --------------------------------------------------

class _Decl:
    """One model's CONFORMANCE contract, as declared."""

    def __init__(self, doc: dict, path: str, line: int) -> None:
        self.protocol = doc.get("protocol", "?")
        self.ledgers = doc.get("ledgers", [])
        self.fault_sites = list(doc.get("fault_sites", []))
        self.site_prefixes = list(doc.get("site_prefixes", []))
        self.twins = dict(doc.get("twins", {}))
        self.path = path
        self.line = line


def collect_conformances(index: ProjectIndex) -> List[_Decl]:
    """Module-level ``CONFORMANCE = {...}`` literals in every scanned
    file under analysis/model/ (memoized per scan)."""
    cached = index.memo.get("model_conformances")
    if cached is not None:
        return cached
    out: List[_Decl] = []
    for path in sorted(index.trees):
        if "analysis/model/" not in path:
            continue
        tree = index.trees[path]
        for node in tree.body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "CONFORMANCE"):
                continue
            try:
                doc = ast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                continue          # not a pure literal: nothing to gate
            if isinstance(doc, dict):
                out.append(_Decl(doc, path, node.lineno))
    index.memo["model_conformances"] = out
    return out


# -- code-side extraction ----------------------------------------------------

def extract_counter_keys(index: ProjectIndex,
                         src_ref: str) -> Optional[Set[str]]:
    """String keys the resolved counters() method can emit: constant
    keys of every dict literal in its body plus constant-subscript
    stores (``c["x"] = ...``). None when the ref does not resolve."""
    hit = resolve_ref(index, src_ref)
    if hit is None:
        return None
    _path, node = hit
    keys: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Dict):
            for k in sub.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    keys.add(k.value)
        elif isinstance(sub, ast.Assign):
            for t in sub.targets:
                if isinstance(t, ast.Subscript) \
                        and isinstance(t.slice, ast.Constant) \
                        and isinstance(t.slice.value, str):
                    keys.add(t.slice.value)
    return keys


def _code_sites(index: ProjectIndex) -> Set[str]:
    """Registered fault-site strings (faults.py FAULT_* values)."""
    return {value for value, _line in index.fault_defs.values()}


# -- the committed store -----------------------------------------------------

def build_store(index: ProjectIndex) -> Tuple[dict, List[str]]:
    """Fingerprint every declared protocol's code-side alphabet ->
    (store doc, unresolvable refs). Like twins.build_store, the ack
    path refuses placeholders: acking a contract whose refs don't
    resolve would grandfather the gap."""
    protocols: Dict[str, dict] = {}
    missing: List[str] = []
    for decl in collect_conformances(index):
        entry: dict = {"decl": decl.path,
                       "fault_sites": sorted(decl.fault_sites),
                       "ledgers": {}, "modeled": {}, "twins": {}}
        for ledger in decl.ledgers:
            src = ledger.get("src", "")
            keys = extract_counter_keys(index, src)
            if keys is None:
                missing.append(f"{decl.protocol}: ledger src {src!r}")
                continue
            entry["ledgers"][src] = sorted(keys)
            # the DECLARED model-side counter list too: narrowing the
            # contract (un-modeling a counter) must trip the gate the
            # same way widening the code ledger does
            entry["modeled"][src] = sorted(ledger.get("counters", []))
        for action, ref in sorted(decl.twins.items()):
            hit = resolve_ref(index, ref)
            if hit is None:
                missing.append(f"{decl.protocol}: twin {action} -> {ref!r}")
                continue
            entry["twins"][action] = {"ref": ref,
                                      "fp": fingerprint(hit[1])}
        protocols[decl.protocol] = entry
    return {"version": CONFORM_STORE_VERSION, "tool": "deepflow-model",
            "protocols": protocols}, missing


# -- the rule ----------------------------------------------------------------

@register
class ModelConform(Checker):
    """The deepflow-model <-> code conformance gate. Fails when a
    modeled counter, fault site or twin'd transition drifts from the
    code, or when the code side changed without `--ack-conform` (the
    committed `.model-conform.json` is the contract, exactly like the
    twin store)."""

    name = "model-conform"
    description = ("protocol model vs code drift: modeled counter not "
                   "in the code ledger, fault site not registered, "
                   "twin'd transition renamed, or the code-side "
                   "alphabet changed since `.model-conform.json` was "
                   "acknowledged (`df-ctl verify --ack-conform`)")

    def check(self, ctx: FileContext,
              index: ProjectIndex) -> Iterable[Finding]:
        for path, line, message in self._results(index):
            if path == ctx.path:
                yield Finding(self.name, path, line, 0, message,
                              self.severity)

    # -- the memoized whole-scan pass --------------------------------------
    def _results(self, index: ProjectIndex
                 ) -> List[Tuple[str, int, str]]:
        cached = index.memo.get("model_conform_results")
        if cached is not None:
            return cached
        out: List[Tuple[str, int, str]] = []
        decls = collect_conformances(index)
        store = getattr(index, "conform_store", None) or {}
        store_protos = store.get("protocols", {})
        code_sites = _code_sites(index)
        seen = set()
        for decl in decls:
            seen.add(decl.protocol)
            out.extend(self._check_decl(index, decl, code_sites,
                                        store_protos.get(decl.protocol),
                                        have_store=bool(store)))
        # committed protocols no longer declared anywhere: the registry
        # shrank without an ack (only meaningful when the scan saw the
        # model package at all — partial scans stay silent)
        if decls:
            anchor = decls[0]
            for proto in sorted(store_protos):
                if proto not in seen:
                    out.append((
                        anchor.path, 1,
                        f"committed conformance for protocol '{proto}' "
                        f"is no longer declared by any model — "
                        f"`df-ctl verify --ack-conform` to drop it "
                        f"deliberately"))
        index.memo["model_conform_results"] = out
        return out

    def _check_decl(self, index: ProjectIndex, decl: _Decl,
                    code_sites: Set[str], committed: Optional[dict],
                    have_store: bool) -> List[Tuple[str, int, str]]:
        out: List[Tuple[str, int, str]] = []
        p = decl.protocol
        at = (decl.path, decl.line)
        fresh_ledgers: Dict[str, List[str]] = {}
        for ledger in decl.ledgers:
            src = ledger.get("src", "")
            keys = extract_counter_keys(index, src)
            if keys is None:
                # out-of-scan ledgers stay silent on partial scans; an
                # in-scan file that simply lost the method must trip
                suffix = src.partition(":")[0]
                if any(path == suffix or path.endswith("/" + suffix)
                       for path in index.defs_by_path):
                    out.append((*at, f"protocol '{p}': ledger source "
                                f"{src!r} does not resolve — the "
                                f"counters() the model abstracts was "
                                f"renamed or deleted"))
                continue
            fresh_ledgers[src] = sorted(keys)
            for name in ledger.get("counters", []):
                if name not in keys:
                    out.append((*at, f"protocol '{p}': modeled counter "
                                f"'{name}' is not a key of {src} — the "
                                f"model and the code ledger drifted"))
        if code_sites:           # faults.py inside the scan
            for site in decl.fault_sites:
                if site not in code_sites:
                    out.append((*at, f"protocol '{p}': modeled fault "
                                f"site '{site}' is not registered in "
                                f"runtime/faults.py — the model "
                                f"injects a fault the chaos registry "
                                f"cannot"))
            for prefix in decl.site_prefixes:
                for site in sorted(code_sites):
                    if site.startswith(prefix) \
                            and site not in decl.fault_sites:
                        out.append((*at, f"protocol '{p}': faults.py "
                                    f"site '{site}' matches modeled "
                                    f"prefix '{prefix}' but is absent "
                                    f"from the model's fault alphabet "
                                    f"— the proof never explores it"))
        fresh_twins: Dict[str, dict] = {}
        any_twin_resolved = False
        for action, ref in sorted(decl.twins.items()):
            hit = resolve_ref(index, ref)
            if hit is None:
                suffix = ref.partition(":")[0]
                if not suffix.endswith(".py"):
                    suffix = suffix.replace(".", "/") + ".py"
                if any(path == suffix or path.endswith("/" + suffix)
                       for path in index.defs_by_path):
                    out.append((*at, f"protocol '{p}': twin'd "
                                f"transition '{action}' ref {ref!r} "
                                f"does not resolve — the code "
                                f"transition was renamed or deleted "
                                f"without updating the model"))
                continue
            any_twin_resolved = True
            fresh_twins[action] = {"ref": ref, "fp": fingerprint(hit[1]),
                                   "at": hit}
        if not fresh_ledgers and not any_twin_resolved:
            return out           # contract fully outside this scan
        # -- the committed-fingerprint gate (the twin-store posture) -------
        if committed is None:
            out.append((*at, f"protocol '{p}' has no committed "
                        f"conformance fingerprint"
                        + ("" if have_store else
                           " (no .model-conform.json)")
                        + " — run `df-ctl verify`, then "
                        f"`df-ctl verify --ack-conform`"))
            return out
        if sorted(decl.fault_sites) != committed.get("fault_sites", []):
            out.append((*at, f"protocol '{p}': the model's fault "
                        f"alphabet changed since the last ack — "
                        f"re-run `df-ctl verify` and `--ack-conform`"))
        for src, keys in sorted(fresh_ledgers.items()):
            want = committed.get("ledgers", {}).get(src)
            if want is not None and want != keys:
                gained = sorted(set(keys) - set(want))
                lost = sorted(set(want) - set(keys))
                detail = "; ".join(
                    x for x in (f"gained {gained}" if gained else "",
                                f"lost {lost}" if lost else "") if x)
                out.append((*at, f"protocol '{p}': the code ledger "
                            f"{src} changed since the last ack "
                            f"({detail}) — extend the model (or "
                            f"confirm it unaffected), re-run `df-ctl "
                            f"verify`, then `--ack-conform`"))
        for action, fresh in sorted(fresh_twins.items()):
            want = committed.get("twins", {}).get(action, {})
            if want.get("ref") != fresh["ref"] \
                    or want.get("fp") != fresh["fp"]:
                path, node = fresh["at"]
                out.append((path, node.lineno,
                            f"protocol '{p}': code transition "
                            f"{fresh['ref']} (modeled as '{action}') "
                            f"changed since the conformance ack — "
                            f"re-run `df-ctl verify` and "
                            f"`df-ctl verify --ack-conform`"))
        # NARROWING the contract is drift too, and it is checked at
        # declaration level (the decl is always fully in-scan, so a
        # partial scan that cannot RESOLVE a ref never false-trips):
        # an acked twin, ledger or modeled counter that the model no
        # longer declares un-arms part of the proof silently.
        declared_srcs = {l.get("src", "") for l in decl.ledgers}
        for src in sorted(committed.get("ledgers", {})):
            if src not in declared_srcs:
                out.append((*at, f"protocol '{p}': acked ledger {src} "
                            f"is no longer declared by the model — "
                            f"`df-ctl verify --ack-conform` to drop "
                            f"it deliberately"))
        declared_counters = {l.get("src", ""):
                             sorted(l.get("counters", []))
                             for l in decl.ledgers}
        for src, want in sorted(committed.get("modeled", {}).items()):
            got = declared_counters.get(src)
            if got is not None and got != want:
                dropped = sorted(set(want) - set(got))
                if dropped:
                    out.append((*at, f"protocol '{p}': counter(s) "
                                f"{dropped} of {src} were modeled at "
                                f"the last ack but are no longer — "
                                f"the proof narrowed; re-ack "
                                f"deliberately"))
        for action in sorted(committed.get("twins", {})):
            if action not in decl.twins:
                out.append((*at, f"protocol '{p}': acked twin'd "
                            f"transition '{action}' is no longer "
                            f"declared by the model — the proof lost "
                            f"a code anchor; `df-ctl verify "
                            f"--ack-conform` to drop it deliberately"))
        return out
