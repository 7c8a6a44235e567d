"""The doc-drift rule: the README's knob and
gauge tables must keep up with the code.

Two contracts rot silently today: `IngesterConfig` grows a knob nobody
documents (operators discover it by reading the dataclass), and
`tracing.GAUGE_HELP` grows a gauge whose README row never lands (the
/metrics HELP string exists, the operator-facing table lies by
omission). This rule closes both: every `IngesterConfig` field and
every `GAUGE_HELP` key must appear — as a word — somewhere in the
README the scan was given (`ProjectIndex.doc_text`; the runner loads
the repo README.md, fixtures pass their own). A knob or gauge added
without its doc row is a finding at the definition line, pragma-able
and SARIF-emitted like every other rule.

Scope is deliberately the two declared registries, not every dataclass
in the tree: these are the operator-facing surfaces the README already
tables; a generic "document everything" rule would be pragma'd into
uselessness on day one.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Optional, Set

from deepflow_tpu_torch.analysis.core import (Checker, FileContext, Finding,
                                              ProjectIndex, register)

__all__ = ["DocDrift"]

_CONFIG_SUFFIX = "pipelines/ingester.py"
_CONFIG_CLASS = "IngesterConfig"
_GAUGE_SUFFIX = "runtime/tracing.py"
_GAUGE_TABLES = ("GAUGE_HELP", "GAUGE_HELP_PREFIXES")


def _doc_words(doc: str) -> Set[str]:
    """Identifier-shaped words in the doc — the membership test. A
    name inside backticks, a table row, or dotted prose
    (`IngesterConfig.prefetch_depth`) all tokenize to the bare word."""
    return set(re.findall(r"[A-Za-z_][A-Za-z0-9_]*", doc))


@register
class DocDrift(Checker):
    """An operator-facing registry entry (IngesterConfig knob /
    GAUGE_HELP gauge) with no row in the README. The doc tables are a
    contract with operators the same way the exposition HELP strings
    are a contract with scrapers."""

    name = "doc-drift"
    description = ("IngesterConfig knob or tracing.GAUGE_HELP gauge "
                   "absent from the README knob/gauge tables — "
                   "document the new name or it never existed for "
                   "operators")

    def check(self, ctx: FileContext,
              index: ProjectIndex) -> Iterable[Finding]:
        if index.doc_text is None:
            return               # no doc in scope: fixture scans stay silent
        is_cfg = ctx.path.endswith(_CONFIG_SUFFIX)
        is_gauge = ctx.path.endswith(_GAUGE_SUFFIX)
        if not (is_cfg or is_gauge):
            return
        words = index.memo.get("doc_words")
        if words is None:
            words = _doc_words(index.doc_text)
            index.memo["doc_words"] = words
        if is_cfg:
            yield from self._check_config(ctx, words)
        if is_gauge:
            yield from self._check_gauges(ctx, words)

    def _check_config(self, ctx: FileContext,
                      words: Set[str]) -> Iterable[Finding]:
        for node in ctx.tree.body:
            if not (isinstance(node, ast.ClassDef)
                    and node.name == _CONFIG_CLASS):
                continue
            for item in node.body:
                if not (isinstance(item, ast.AnnAssign)
                        and isinstance(item.target, ast.Name)):
                    continue
                name = item.target.id
                if name.startswith("_") or name in words:
                    continue
                yield self.finding(
                    ctx, item,
                    f"{_CONFIG_CLASS}.{name} has no row in the README "
                    f"knob table — operators cannot discover a knob "
                    f"that is only a dataclass field")

    def _check_gauges(self, ctx: FileContext,
                      words: Set[str]) -> Iterable[Finding]:
        for node in ctx.tree.body:
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id in _GAUGE_TABLES):
                continue
            value = node.value
            if not isinstance(value, ast.Dict):
                continue
            for key in value.keys:
                if not (isinstance(key, ast.Constant)
                        and isinstance(key.value, str)):
                    continue
                # prefix families document their stem (the trailing _
                # never reads as part of the word)
                name = key.value.rstrip("_")
                if not name or name in words:
                    continue
                yield self.finding(
                    ctx, key,
                    f"gauge '{key.value}' (tracing.GAUGE_HELP) has no "
                    f"row in the README gauge tables — it scrapes "
                    f"with HELP text but operators reading the doc "
                    f"never learn it exists")
