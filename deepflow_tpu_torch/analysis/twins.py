"""Host/device twin registry + the twin-drift gate.

Half this pipeline's correctness story is BIT-IDENTITY between a host
implementation and its device kernel: `utils/u32.fold_columns_np` vs
`fold_columns`, `flow_suite.unpack_lanes_np` vs the device unpack (and
the fused CUDA kernel's in-kernel copy of the same prologue),
`serving/tables.py` scalar estimators vs `ops/cms.query` /
`ops/hll.estimate`, the shadow auditor vs the seeded bucket hash.
Runtime tests assert equality on the inputs they generate; nothing
stops an edit to ONE side from quietly shifting a contract the tests
under-sample. This module makes twin-ness a DECLARED, gated fact:

- `@host_twin_of("deepflow_tpu_torch/ops/hashing.py:bucket")` marks a host
  function/class as the twin of a device-side def (a no-op at
  runtime — the checker reads it lexically, so the marker costs
  nothing on the hot path);
- `TWIN_TABLE` lists the pairs that cannot carry a decorator (class
  twins like `_HostSketch`, the fused kernel's plain version);
- each side's NORMALIZED-AST fingerprint (docstrings stripped,
  line/col-free dump, sha256) is committed in the port's own
  `analysis/stores/lint-twins.json`;
- the `twin-drift` rule fails the gate whenever a registered side's
  fingerprint differs from the committed one — editing a twin is only
  green again after `df-ctl lint --ack-twin`, i.e. after a human (and
  the bit-identity tests in the same CI run) re-acknowledged the pair.

Refs are `"<path-suffix-or-module>:<qualname>"`:
`"deepflow_tpu_torch/utils/u32.py:mix32"`, `"deepflow_tpu_torch.ops.cms:query"`,
`"deepflow_tpu_torch/runtime/tpu_sketch.py:_HostSketch"` and
`"...:Class.method"` all resolve. A pair whose BOTH sides fall outside
the scan stays silent (partial scans must not cry drift — the
fault-site-drift posture); one resolvable side with the other missing
is itself a finding, because deleting half a twin is the largest drift
there is.
"""

from __future__ import annotations

import ast
import copy
import hashlib
import json
from typing import Dict, Iterable, List, Optional, Tuple

from deepflow_tpu_torch.analysis.core import (Checker, FileContext, Finding,
                                              ProjectIndex, dotted, register)
# the runtime marker lives in a dependency-free leaf so hot data-plane
# modules never import the analyzer package just to tag a twin; the
# rule reads the decorator lexically either way
from deepflow_tpu_torch.utils.twinmark import host_twin_of

__all__ = ["host_twin_of", "TWIN_TABLE", "TwinDrift", "fingerprint",
           "collect_pairs", "load_store", "save_store", "STORE_VERSION"]


# Pairs that cannot carry the decorator: class twins whose "function"
# is their whole body, and device-side kernels twinned against a def
# that already exists for the unfused path. Format:
#   (pair-name, host ref, device ref)
# The checker parses this table LEXICALLY out of the scanned source of
# this file (fixtures may ship their own analysis/twins.py), so keep
# every entry a plain string literal.
TWIN_TABLE = [
    # the degraded-mode host fallback mirrors the whole device update:
    # CMS + entropy + HLL + top-K on numpy, bit-equal by test
    ("host-sketch",
     "deepflow_tpu_torch/runtime/tpu_sketch.py:_HostSketch",
     "deepflow_tpu_torch/models/flow_suite.py:update"),
    # the fused CUDA kernel (csrc/fused_sketch.cu) re-states the unpack
    # prologue + fold + bucket hash in-kernel. It is not Python, so the
    # pair names the plain version the kernel is held to bit for bit;
    # any edit to either side must re-prove bit-exactness
    ("pallas-unpack-sketch",
     "deepflow_tpu_torch/ops/cuda_sketch.py:_hists_plain",
     "deepflow_tpu_torch/models/flow_suite.py:unpack_lanes"),
    # the shadow auditor's absorb() re-derives the device's seeded
    # bucket hash + admission fold on numpy scalars
    ("audit-shadow-absorb",
     "deepflow_tpu_torch/runtime/audit.py:ShadowAuditor.absorb",
     "deepflow_tpu_torch/ops/hashing.py:bucket"),
    # serving point reads must answer exactly what the device kernel
    # would: scalar CMS read vs ops/cms.query
    ("serving-cms-point",
     "deepflow_tpu_torch/serving/tables.py:_SketchView.cms_point",
     "deepflow_tpu_torch/ops/cms.py:query"),
    # Ertl HLL readout on host registers vs the device estimator
    ("serving-hll-estimate",
     "deepflow_tpu_torch/serving/tables.py:_hll_estimate_np",
     "deepflow_tpu_torch/ops/hll.py:estimate"),
]

STORE_VERSION = 1


# -- fingerprints -----------------------------------------------------------

def _strip_docstrings(node: ast.AST) -> None:
    for sub in ast.walk(node):
        body = getattr(sub, "body", None)
        if not isinstance(body, list) or not body:
            continue
        first = body[0]
        if isinstance(first, ast.Expr) \
                and isinstance(first.value, ast.Constant) \
                and isinstance(first.value.value, str):
            sub.body = body[1:] or [ast.Pass()]


def fingerprint(node: ast.AST) -> str:
    """Normalized-AST hash: docstrings out, positions out — so comment
    and layout edits don't trip the gate, while ANY executable change
    (operator, constant, call, decorator) does."""
    node = copy.deepcopy(node)
    _strip_docstrings(node)
    dump = ast.dump(node, include_attributes=False)
    return hashlib.sha256(dump.encode("utf-8")).hexdigest()[:16]


# -- ref resolution ---------------------------------------------------------

def _ref_path_suffix(ref: str) -> Tuple[str, str]:
    """'pkg/mod.py:Qual.name' or 'pkg.mod:Qual.name' ->
    ('pkg/mod.py', 'Qual.name')."""
    mod, _, qual = ref.partition(":")
    if not qual:
        raise ValueError(f"twin ref {ref!r} has no ':qualname'")
    if not mod.endswith(".py"):
        mod = mod.replace(".", "/") + ".py"
    return mod, qual


def resolve_ref(index: ProjectIndex,
                ref: str) -> Optional[Tuple[str, ast.AST]]:
    """Resolve a ref against the scan: (path, node) or None."""
    suffix, qual = _ref_path_suffix(ref)
    for path, defs in index.defs_by_path.items():
        if path == suffix or path.endswith("/" + suffix):
            node = defs.get(qual)
            if node is not None:
                return path, node
    return None


# -- registry collection ----------------------------------------------------

class TwinPair:
    def __init__(self, pair_id: str, host_ref: str, device_ref: str,
                 decl_path: str, decl_line: int) -> None:
        self.pair_id = pair_id
        self.host_ref = host_ref
        self.device_ref = device_ref
        self.decl_path = decl_path
        self.decl_line = decl_line


def collect_pairs(index: ProjectIndex) -> List[TwinPair]:
    """All declared pairs in the scan: `@host_twin_of` markers plus
    the lexical TWIN_TABLE of any scanned analysis/twins.py. Memoized
    on the index (one walk per scan)."""
    cached = index.memo.get("twin_pairs")
    if cached is not None:
        return cached
    pairs: List[TwinPair] = []
    for path, defs in sorted(index.defs_by_path.items()):
        for qual, node in sorted(defs.items()):
            for dec in getattr(node, "decorator_list", []):
                ref = _marker_ref(dec)
                if ref is not None:
                    host_ref = f"{path}:{qual}"
                    pairs.append(TwinPair(host_ref, host_ref, ref,
                                          path, node.lineno))
        if path.endswith("analysis/twins.py"):
            pairs.extend(_table_pairs(index, path))
    # decorator on a method yields both "Class.method" and (never)
    # bare duplicates; de-dup by pair_id keeping first
    seen: Dict[str, TwinPair] = {}
    for p in pairs:
        seen.setdefault(p.pair_id, p)
    out = sorted(seen.values(), key=lambda p: p.pair_id)
    index.memo["twin_pairs"] = out
    return out


def _marker_ref(dec: ast.AST) -> Optional[str]:
    if not isinstance(dec, ast.Call):
        return None
    d = dotted(dec.func)
    if d is None or d.rsplit(".", 1)[-1] != "host_twin_of":
        return None
    if dec.args and isinstance(dec.args[0], ast.Constant) \
            and isinstance(dec.args[0].value, str):
        return dec.args[0].value
    return None


def _table_pairs(index: ProjectIndex, path: str) -> List[TwinPair]:
    """Parse TWIN_TABLE rows lexically out of a scanned twins.py (the
    real package's, or a fixture's own)."""
    tree = index.trees.get(path)
    if tree is None:
        return []
    out: List[TwinPair] = []
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "TWIN_TABLE"):
            continue
        if not isinstance(node.value, (ast.List, ast.Tuple)):
            continue
        for elt in node.value.elts:
            if not isinstance(elt, (ast.Tuple, ast.List)) \
                    or len(elt.elts) != 3:
                continue
            vals = [e.value for e in elt.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)]
            if len(vals) == 3:
                out.append(TwinPair(vals[0], vals[1], vals[2], path,
                                    elt.elts[0].lineno))
    return out


# -- store ------------------------------------------------------------------

def load_store(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("version") != STORE_VERSION:
        raise ValueError(f"{path}: unsupported twin-store version "
                         f"{doc.get('version')!r}")
    return doc


def save_store(doc: dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")


def build_store(index: ProjectIndex) -> Tuple[dict, List[str]]:
    """Fingerprint every declared pair -> (store doc, unresolvable
    refs). The ack path refuses to write placeholders for refs it
    cannot see: acking a half-missing pair would grandfather the gap."""
    pairs = collect_pairs(index)
    entries: Dict[str, dict] = {}
    missing: List[str] = []
    for p in pairs:
        sides = {}
        for side, ref in (("host", p.host_ref), ("device", p.device_ref)):
            hit = resolve_ref(index, ref)
            if hit is None:
                missing.append(f"{p.pair_id}: {side} ref {ref!r}")
                continue
            sides[side] = {"ref": ref, "fp": fingerprint(hit[1])}
        if len(sides) == 2:
            entries[p.pair_id] = sides
    return {"version": STORE_VERSION, "tool": "deepflow-lint",
            "pairs": entries}, missing


# -- the rule ---------------------------------------------------------------

@register
class TwinDrift(Checker):
    """One half of a declared host/device twin edited without
    re-acknowledging the pair. The committed fingerprints are the
    contract; `--ack-twin` is the ONLY way to move them, which forces
    the bit-identity question into review instead of past it."""

    name = "twin-drift"
    description = ("declared host/device twin whose normalized-AST "
                   "fingerprint differs from the committed "
                   ".lint-twins.json — re-run the identity tests and "
                   "`df-ctl lint --ack-twin`")

    def check(self, ctx: FileContext,
              index: ProjectIndex) -> Iterable[Finding]:
        results = self._results(index)
        for path, line, message in results:
            if path == ctx.path:
                yield Finding(self.name, path, line, 0, message,
                              self.severity)

    def _results(self, index: ProjectIndex
                 ) -> List[Tuple[str, int, str]]:
        cached = index.memo.get("twin_results")
        if cached is not None:
            return cached
        out: List[Tuple[str, int, str]] = []
        store = index.twin_store or {}
        store_pairs = store.get("pairs", {}) if store else {}
        seen_ids = set()
        for p in collect_pairs(index):
            seen_ids.add(p.pair_id)
            host = resolve_ref(index, p.host_ref)
            device = resolve_ref(index, p.device_ref)
            if host is None and device is None:
                continue        # pair fully outside this scan's scope
            if host is None or device is None:
                side, ref = ("host", p.host_ref) if host is None \
                    else ("device", p.device_ref)
                out.append((
                    p.decl_path, p.decl_line,
                    f"twin pair '{p.pair_id}': {side} ref {ref!r} does "
                    f"not resolve in this scan — the twin was deleted "
                    f"or moved without updating the registry"))
                continue
            entry = store_pairs.get(p.pair_id)
            if entry is None:
                out.append((
                    p.decl_path, p.decl_line,
                    f"twin pair '{p.pair_id}' is declared but has no "
                    f"committed fingerprints — run the bit-identity "
                    f"tests, then `df-ctl lint --ack-twin`"))
                continue
            for side, ref, (path, node) in (
                    ("host", p.host_ref, host),
                    ("device", p.device_ref, device)):
                want = entry.get(side, {}).get("fp")
                got = fingerprint(node)
                if want != got:
                    out.append((
                        path, node.lineno,
                        f"twin pair '{p.pair_id}': the {side} side "
                        f"({ref}) changed since the pair was last "
                        f"acknowledged — re-run the identity tests "
                        f"and `df-ctl lint --ack-twin`"))
        # store entries whose pair declaration is gone: the registry
        # shrank without an ack. Gated on the registry FILE being in
        # the scan (not on "some pair declared" — a commit deleting
        # EVERY registration must still trip); partial scans that never
        # saw twins.py stay silent, and a decorator pair only cries
        # stale when its declaring file was scanned without the marker
        decl = self._any_twins_path(index)
        if decl is not None:
            for pair_id in sorted(store_pairs):
                if pair_id in seen_ids:
                    continue
                if ".py:" in pair_id:
                    decl_file = pair_id.split(":", 1)[0]
                    if not any(p == decl_file
                               or p.endswith("/" + decl_file)
                               for p in index.defs_by_path):
                        continue
                out.append((
                    decl, 1,
                    f"committed twin pair '{pair_id}' is no longer "
                    f"declared anywhere — `df-ctl lint --ack-twin` to "
                    f"drop it deliberately"))
        index.memo["twin_results"] = out
        return out

    @staticmethod
    def _any_twins_path(index: ProjectIndex) -> Optional[str]:
        for path in sorted(index.defs_by_path):
            if path.endswith("analysis/twins.py"):
                return path
        return None
