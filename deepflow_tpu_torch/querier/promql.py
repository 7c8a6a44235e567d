"""PromQL engine over the ext_metrics sample tables.

Reference: server/querier/app/prometheus/ — a PromQL adapter serving
Grafana and remote_read (service/promql.go embeds the upstream engine;
functions.go maps its function library onto querier SQL). This engine
parses a real expression grammar and evaluates it on a time grid:

- instant & range vector selectors with label matchers and `offset`
- rate() / irate() / increase() with upstream counter-reset correction
  and window-edge extrapolation (promql/functions.go extrapolatedRate)
- histogram_quantile() over `le`-bucketed series — which is how DDSketch
  windows surface (runtime/app_red.py emits cumulative gamma-bucket
  samples; the sketch IS a histogram, so the upstream bucket
  interpolation applies unchanged)
- sum/avg/max/min/count/stddev/stdvar with by (...) / without (...)
- topk/bottomk/quantile, the *_over_time family (incl. quantile,
  stddev/stdvar and present), subqueries (expr[range:step]) with
  absolute step anchoring, and elementwise math/clamp/sgn functions
- changes/resets/deriv/predict_linear over range vectors (vectorized
  per-window cumsum regressions)
- vector○scalar and vector○vector arithmetic (+ - * / % ^), filter and
  `bool` comparisons (== != > < >= <=), set ops and/or/unless — all
  with on (...) / ignoring (...), plus group_left/group_right
  many-to-one matching with label copy
- label_replace/label_join, absent, sort/sort_desc, timestamp,
  time()/scalar()/vector() scalar bridges

Evaluation is columnar: every expression evaluates to a list of
(labels, values-aligned-to-grid) pairs in one vectorized pass — an
instant query is just a one-point grid. Series come back keyed by their
label-set string (the reverse of the SmartEncoded labels hash).
"""

from __future__ import annotations

import math
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from deepflow_tpu_torch.models.flow_suite import check_device
from deepflow_tpu_torch.store.db import Store
from deepflow_tpu_torch.store.dict_store import TagDictRegistry

DEFAULT_LOOKBACK_S = 300
_UNIT_S = {"s": 1, "m": 60, "h": 3600, "d": 86400}

AGG_OPS = ("sum", "avg", "max", "min", "count", "stddev", "stdvar")
RANGE_FUNCS = ("rate", "irate", "increase", "delta",
               "changes", "resets", "deriv")
OVER_TIME_FUNCS = ("avg_over_time", "max_over_time", "min_over_time",
                   "sum_over_time", "count_over_time", "last_over_time",
                   "stddev_over_time", "stdvar_over_time",
                   "present_over_time")
# elementwise math over an instant vector (upstream functions.go set)
MATH_FUNCS = {
    "abs": np.abs, "ceil": np.ceil, "floor": np.floor,
    # upstream round() rounds ties UP (floor(v + 0.5)); np.round is
    # banker's half-to-even and would silently differ on *.5 samples
    "round": lambda v: np.floor(v + 0.5),
    "sqrt": np.sqrt, "exp": np.exp,
    "ln": np.log, "log2": np.log2, "log10": np.log10,
    "sgn": np.sign,
}
CLAMP_FUNCS = ("clamp_min", "clamp_max")
QUANTILE_OT = "quantile_over_time"
# the sketch datasource (serving/tables.py): leaf functions that
# answer from the snapshot cache instead of the samples table —
# sketch_topk(10), sketch_cms_point(key), sketch_hll_card([group]),
# sketch_entropy(). Optional scalar-literal argument.
SKETCH_FUNCS = ("sketch_cms_point", "sketch_hll_card",
                "sketch_topk", "sketch_entropy")


def _anomaly_metrics():
    """The anomaly selectors (deferred import: the evaluator
    must not pull the serving package unless a plane is mounted)."""
    from deepflow_tpu_torch.serving.anomaly import ANOMALY_PROM_METRICS
    return ANOMALY_PROM_METRICS


# -- AST -------------------------------------------------------------------
@dataclass(frozen=True)
class Selector:
    metric: str
    matchers: Tuple[Tuple[str, str, str], ...]  # (label, op, value)
    range_s: Optional[int] = None
    offset_s: int = 0


@dataclass(frozen=True)
class Func:
    name: str                  # rate|irate|increase|delta|histogram_quantile
    args: Tuple["Expr", ...]


@dataclass(frozen=True)
class AggExpr:
    op: str                    # sum|avg|max|min|count
    by: Tuple[str, ...]
    arg: "Expr"
    without: bool = False      # by-list is an EXCLUSION set


@dataclass(frozen=True)
class Bin:
    op: str                    # + - * / % ^, comparisons, and/or/unless
    left: "Expr"
    right: "Expr"
    # vector-matching modifiers: None = no modifier (full-label match);
    # `on` restricts the join key to these labels (an EMPTY on() legally
    # joins everything on the empty key), `ignoring` removes them
    match_on: Optional[Tuple[str, ...]] = None
    ignoring: bool = False
    # comparisons: True = return 0/1 instead of filtering
    bool_mode: bool = False
    # many-to-one matching: "left"/"right" = group_left/group_right with
    # the extra labels to copy from the one-side; None = one-to-one
    group_side: Optional[str] = None
    group_labels: Tuple[str, ...] = ()


@dataclass(frozen=True)
class Str:
    value: str                 # string literal (label_replace/join args)


@dataclass(frozen=True)
class Num:
    value: float


@dataclass(frozen=True)
class Subquery:
    """expr[range:step] — the inner expression evaluated on its own
    step grid inside each outer window (promql subquery semantics)."""
    expr: "Expr"
    range_s: int
    step_s: int
    offset_s: int = 0


Expr = Union[Selector, Func, AggExpr, Bin, Num, Str, Subquery]

COMPARE_OPS = ("==", "!=", ">", "<", ">=", "<=")
SET_OPS = ("and", "or", "unless")
# funcs that evaluate to a per-grid-point SCALAR (usable where Num is)
SCALAR_FUNCS = ("time", "scalar")


def _selectors(e: Expr) -> List[Selector]:
    if isinstance(e, Selector):
        return [e]
    if isinstance(e, Func):
        return [s for a in e.args for s in _selectors(a)]
    if isinstance(e, AggExpr):
        return _selectors(e.arg)
    if isinstance(e, Bin):
        return _selectors(e.left) + _selectors(e.right)
    if isinstance(e, Subquery):
        return _selectors(e.expr)
    return []


# -- parser ----------------------------------------------------------------
_TOKEN = re.compile(r"""
    \s*(
        "(?:[^"\\]|\\.)*"                 # string
      | \d+(?:\.\d+)?[smhd]               # duration
      | \d+\.\d+ | \.\d+ | \d+            # number
      | [A-Za-z_:][A-Za-z0-9_:.]*         # ident
      | =~ | !~ | != | == | >= | <=
      | [()\[\]{},=+*/:%^<>-]
    )""", re.VERBOSE)


def _tokenize(s: str) -> List[str]:
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN.match(s, pos)
        if not m:
            if s[pos:].strip() == "":
                break
            raise ValueError(f"bad PromQL token at: {s[pos:pos + 20]!r}")
        out.append(m.group(1))
        pos = m.end()
    return out


def _duration_s(tok: str) -> int:
    m = re.fullmatch(r"(\d+(?:\.\d+)?)([smhd])", tok)
    if not m:
        raise ValueError(f"bad duration {tok!r}")
    return int(float(m.group(1)) * _UNIT_S[m.group(2)])


class _Parser:
    def __init__(self, toks: List[str]) -> None:
        self.toks = toks
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of PromQL")
        self.i += 1
        return t

    def expect(self, tok: str) -> None:
        t = self.next()
        if t != tok:
            raise ValueError(f"expected {tok!r}, got {t!r}")

    def accept(self, tok: str) -> bool:
        if self.peek() == tok:
            self.i += 1
            return True
        return False

    # precedence: (+,-) < (*,/) < atom
    def _label_list(self) -> Tuple[str, ...]:
        """Parenthesized label-name list, shared by by/without/on/
        ignoring."""
        self.expect("(")
        names = []
        while not self.accept(")"):
            names.append(self.next())
            self.accept(",")
        return tuple(names)

    def _match_modifier(self):
        """Optional on(...)/ignoring(...) after a binary operator.
        None = no modifier; an empty on() is meaningful (empty-key
        join), so the two must stay distinguishable."""
        word = (self.peek() or "").lower()
        if word not in ("on", "ignoring"):
            return None, False
        self.next()
        return self._label_list(), word == "ignoring"

    def _group_modifier(self):
        """Optional group_left(...)/group_right(...) after on/ignoring —
        many-to-one matching with labels copied from the one-side."""
        word = (self.peek() or "").lower()
        if word not in ("group_left", "group_right"):
            return None, ()
        self.next()
        labels: Tuple[str, ...] = ()
        if self.peek() == "(":
            labels = self._label_list()
        return ("left" if word == "group_left" else "right"), labels

    # precedence, loosest to tightest (upstream promql):
    #   or < and/unless < comparisons < +,- < *,/,% < ^ < atom
    def expr(self) -> Expr:
        left = self.and_expr()
        while (self.peek() or "").lower() == "or":
            self.next()
            on, ign = self._match_modifier()
            left = Bin("or", left, self.and_expr(), on, ign)
        return left

    def and_expr(self) -> Expr:
        left = self.cmp_expr()
        while (self.peek() or "").lower() in ("and", "unless"):
            op = self.next().lower()
            on, ign = self._match_modifier()
            left = Bin(op, left, self.cmp_expr(), on, ign)
        return left

    def cmp_expr(self) -> Expr:
        left = self.addsub()
        while self.peek() in COMPARE_OPS:
            op = self.next()
            bool_mode = False
            if (self.peek() or "").lower() == "bool":
                self.next()
                bool_mode = True
            on, ign = self._match_modifier()
            gs, gl = self._group_modifier()
            left = Bin(op, left, self.addsub(), on, ign, bool_mode, gs, gl)
        return left

    def addsub(self) -> Expr:
        left = self.term()
        while self.peek() in ("+", "-"):
            op = self.next()
            on, ign = self._match_modifier()
            gs, gl = self._group_modifier()
            left = Bin(op, left, self.term(), on, ign, False, gs, gl)
        return left

    def term(self) -> Expr:
        left = self.power()
        while self.peek() in ("*", "/", "%"):
            op = self.next()
            on, ign = self._match_modifier()
            gs, gl = self._group_modifier()
            left = Bin(op, left, self.power(), on, ign, False, gs, gl)
        return left

    def power(self) -> Expr:
        left = self.atom()
        if self.peek() == "^":                 # right-associative
            self.next()
            on, ign = self._match_modifier()
            return Bin("^", left, self.power(), on, ign)
        return left

    def atom(self) -> Expr:
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of PromQL")
        if t == "(":
            self.next()
            e = self.expr()
            self.expect(")")
            return self._maybe_subquery(e)
        if t == "-":
            # unary minus: negative scalar literals (clamp bounds etc.)
            self.next()
            inner = self.atom()
            if isinstance(inner, Num):
                return Num(-inner.value)
            return Bin("-", Num(0.0), inner)
        if re.fullmatch(r"\d+\.\d+|\.\d+|\d+", t):
            self.next()
            return Num(float(t))
        if t.startswith('"'):
            self.next()
            return Str(t[1:-1])
        ident = self.next()
        low = ident.lower()
        if low in AGG_OPS and self.peek() in ("(", "by", "without"):
            by: Tuple[str, ...] = ()
            without = False
            has_modifier = False
            if self.accept("by"):
                by, has_modifier = self._label_list(), True
            elif self.accept("without"):
                by, without, has_modifier = self._label_list(), True, True
            self.expect("(")
            arg = self.expr()
            self.expect(")")
            # trailing modifier form: sum(x) by (a) / sum(x) without (a)
            # — a SECOND modifier is a syntax error upstream too (an
            # empty leading list like `by ()` legitimately means
            # "aggregate everything away", so track seen-ness, not
            # list emptiness)
            if not has_modifier and self.accept("by"):
                by = self._label_list()
            elif not has_modifier and self.accept("without"):
                by, without = self._label_list(), True
            return self._maybe_subquery(AggExpr(low, by, arg, without))
        if low in RANGE_FUNCS + OVER_TIME_FUNCS and self.peek() == "(":
            self.next()
            arg = self.expr()
            self.expect(")")
            self._require_ranged(arg, low)
            return self._maybe_subquery(Func(low, (arg,)))
        if low in MATH_FUNCS and self.peek() == "(":
            self.next()
            arg = self.expr()
            self.expect(")")
            return self._maybe_subquery(Func(low, (arg,)))
        if low in CLAMP_FUNCS and self.peek() == "(":
            self.next()
            arg = self.expr()
            self.expect(",")
            bound = self.expr()
            self.expect(")")
            if not isinstance(bound, Num):
                raise ValueError(f"{low} needs a scalar bound")
            return self._maybe_subquery(Func(low, (arg, bound)))
        if low in ("histogram_quantile", "topk", "bottomk",
                   "quantile", QUANTILE_OT) and self.peek() == "(":
            self.next()
            phi = self.expr()
            self.expect(",")
            arg = self.expr()
            self.expect(")")
            if not isinstance(phi, Num):
                raise ValueError(f"{low} needs a scalar first argument")
            if low == QUANTILE_OT:
                self._require_ranged(arg, low)
            return self._maybe_subquery(Func(low, (phi, arg)))
        if low == "clamp" and self.peek() == "(":
            self.next()
            arg = self.expr()
            self.expect(",")
            lo_b = self.expr()
            self.expect(",")
            hi_b = self.expr()
            self.expect(")")
            if not (isinstance(lo_b, Num) and isinstance(hi_b, Num)):
                raise ValueError("clamp needs scalar bounds")
            return self._maybe_subquery(Func(low, (arg, lo_b, hi_b)))
        if low == "predict_linear" and self.peek() == "(":
            self.next()
            arg = self.expr()
            self.expect(",")
            horizon = self.expr()
            self.expect(")")
            if not isinstance(horizon, Num):
                raise ValueError("predict_linear needs a scalar horizon")
            self._require_ranged(arg, low)
            return self._maybe_subquery(Func(low, (arg, horizon)))
        if low in ("label_replace", "label_join") and self.peek() == "(":
            self.next()
            args = [self.expr()]
            while self.accept(","):
                args.append(self.expr())
            self.expect(")")
            n_str = len(args) - 1
            if not all(isinstance(a, Str) for a in args[1:]):
                raise ValueError(f"{low} takes string arguments after "
                                 "the vector")
            if low == "label_replace" and n_str != 4:
                raise ValueError("label_replace(v, dst, replacement, "
                                 "src, regex)")
            if low == "label_join" and n_str < 2:
                raise ValueError("label_join(v, dst, sep, src...)")
            return self._maybe_subquery(Func(low, tuple(args)))
        if low in SKETCH_FUNCS and self.peek() == "(":
            self.next()
            if self.accept(")"):
                return self._maybe_subquery(Func(low, ()))
            arg = self.expr()
            self.expect(")")
            if not isinstance(arg, Num):
                raise ValueError(f"{low} takes one scalar literal "
                                 "argument (a flow key / group / k)")
            return self._maybe_subquery(Func(low, (arg,)))
        if low == "time" and self.peek() == "(":
            self.next()
            self.expect(")")
            return Func("time", ())
        if low in ("absent", "sort", "sort_desc", "timestamp", "scalar",
                   "vector") and self.peek() == "(":
            self.next()
            arg = self.expr()
            self.expect(")")
            return self._maybe_subquery(Func(low, (arg,)))
        # plain selector
        return self.selector(ident)

    def _accept_colon_duration(self) -> Optional[int]:
        """The subquery ':step' — ':' fuses into the next token because
        the ident class allows recording-rule colons; accept either
        ':<dur>' as one token or ':' followed by a duration."""
        t = self.peek()
        if t is None:
            return None
        if t == ":":
            self.next()
            if self.peek() == "]":
                return 0                    # expr[1h:] — default step
            return _duration_s(self.next())
        if t.startswith(":") and len(t) > 1:
            self.next()
            return _duration_s(t[1:])
        return None

    @staticmethod
    def _require_ranged(arg: Expr, fn: str) -> None:
        """Range-vector argument check, shared by every windowing fn."""
        ranged = (isinstance(arg, Subquery)
                  or (isinstance(arg, Selector)
                      and arg.range_s is not None))
        if not ranged:
            raise ValueError(f"{fn}() needs a range vector "
                             f"(metric[5m] or a subquery)")

    def _maybe_subquery(self, e: Expr) -> Expr:
        """[range:step] suffix after a non-selector expression."""
        if self.peek() != "[":
            return e
        # lookahead: a ':' inside the brackets makes it a subquery; a
        # plain [dur] after a non-selector is an error promql rejects
        save = self.i
        self.next()
        rng = _duration_s(self.next())
        step = self._accept_colon_duration()
        if step is None:
            self.i = save
            return e
        self.expect("]")
        # step 0 = "default resolution": resolved at evaluation time
        offset_s = 0
        if (self.peek() or "").lower() == "offset":
            self.next()
            offset_s = _duration_s(self.next())
        return Subquery(e, rng, step, offset_s)

    def selector(self, metric: str) -> Selector:
        matchers: List[Tuple[str, str, str]] = []
        if self.accept("{"):
            while not self.accept("}"):
                name = self.next()
                op = self.next()
                if op not in ("=", "!=", "=~", "!~"):
                    raise ValueError(f"bad matcher op {op!r}")
                val = self.next()
                if not (val.startswith('"') and val.endswith('"')):
                    raise ValueError(f"matcher value must be quoted: "
                                     f"{val!r}")
                matchers.append((name, op, val[1:-1]))
                self.accept(",")
        range_s = None
        sub = None
        if self.accept("["):
            range_s = _duration_s(self.next())
            step = self._accept_colon_duration()
            if step is not None:            # metric[30m:1m] subquery
                sub = (range_s, step)
                range_s = None
            self.expect("]")
        offset_s = 0
        if (self.peek() or "").lower() == "offset":
            self.next()
            offset_s = _duration_s(self.next())
        if sub is not None:
            return Subquery(Selector(metric, tuple(matchers), None, 0),
                            sub[0], sub[1], offset_s)
        return Selector(metric, tuple(matchers), range_s, offset_s)


def parse_promql(q: str) -> Expr:
    p = _Parser(_tokenize(q))
    e = p.expr()
    if p.peek() is not None:
        raise ValueError(f"trailing PromQL at {p.peek()!r}")
    return e


def _parse_labels(s: str) -> Dict[str, str]:
    out = {}
    for part in s.split(","):
        k, _, v = part.partition("=")
        if k:
            out[k] = v
    return out


# -- evaluation ------------------------------------------------------------
SeriesList = List[Tuple[Dict[str, str], np.ndarray]]


def _counter_corrected(vs: np.ndarray) -> np.ndarray:
    """Counter-reset correction: every drop adds the pre-drop value back
    (upstream promql: resets are treated as counter restarts from 0)."""
    drops = np.where(np.diff(vs) < 0, vs[:-1], 0.0)
    out = vs.astype(np.float64).copy()
    out[1:] += np.cumsum(drops)
    return out


def _extrapolated(ts, vs, grid, range_s, is_counter, is_rate):
    """Upstream extrapolatedRate (promql/functions.go): per grid point,
    the window's sample delta extrapolated toward the window edges, with
    counter-reset correction and zero-crossing clamping. Vectorized over
    all grid points at once."""
    start = grid - range_s
    lo = np.searchsorted(ts, start, side="left")
    hi = np.searchsorted(ts, grid, side="right") - 1
    count = hi - lo + 1
    ok = count >= 2
    loc = np.minimum(np.maximum(lo, 0), len(ts) - 1)
    hic = np.maximum(hi, 0)
    cv = _counter_corrected(vs) if is_counter else vs.astype(np.float64)
    delta = cv[hic] - cv[loc]
    first_v = vs[loc]
    sampled = (ts[hic] - ts[loc]).astype(np.float64)
    ok &= sampled > 0
    sampled = np.maximum(sampled, 1e-9)
    avg_int = sampled / np.maximum(count - 1, 1)
    to_start = (ts[loc] - start).astype(np.float64)
    to_end = (grid - ts[hic]).astype(np.float64)
    threshold = avg_int * 1.1
    to_start = np.where(to_start >= threshold, avg_int / 2, to_start)
    to_end = np.where(to_end >= threshold, avg_int / 2, to_end)
    if is_counter:
        # don't extrapolate a counter below zero
        with np.errstate(divide="ignore", invalid="ignore"):
            to_zero = sampled * (first_v / np.where(delta > 0, delta, 1.0))
        clamp = (delta > 0) & (first_v >= 0) & (to_zero < to_start)
        to_start = np.where(clamp, to_zero, to_start)
    factor = (sampled + to_start + to_end) / sampled
    out = delta * factor
    if is_rate:
        out = out / range_s
    return np.where(ok, out, np.nan)


class _Evaluator:
    def __init__(self, engine: "PromEngine", grid: np.ndarray) -> None:
        self.engine = engine
        self.grid = grid
        # default subquery resolution (expr[1h:]): the outer grid's own
        # step, or the conventional 15s scrape interval for instants
        self.default_step = int(grid[1] - grid[0]) if len(grid) > 1 \
            else 15
        # one table scan per distinct (lo, hi) window per evaluation:
        # `rps / rps` must not rescan identical data per selector
        self._scan_cache: Dict[Tuple[int, int], dict] = {}

    def eval(self, e: Expr) -> SeriesList:
        if isinstance(e, Num):
            raise ValueError("scalar-only expression has no series")
        if isinstance(e, Str):
            raise ValueError("string literal is not a query")
        if isinstance(e, Selector):
            return self._instant(e)
        if isinstance(e, Func):
            if e.name in RANGE_FUNCS:
                return self._range_fn(e.name, e.args[0])
            if e.name in OVER_TIME_FUNCS:
                return self._over_time(e.name, e.args[0])
            if e.name == QUANTILE_OT:
                return self._quantile_over_time(e.args[0].value,
                                                e.args[1])
            if e.name == "histogram_quantile":
                phi = e.args[0].value
                return self._histogram_quantile(phi, self.eval(e.args[1]))
            if e.name in ("topk", "bottomk"):
                return self._topk(int(e.args[0].value),
                                  self.eval(e.args[1]),
                                  largest=e.name == "topk")
            if e.name == "quantile":
                return self._quantile_agg(e.args[0].value,
                                          self.eval(e.args[1]))
            if e.name in MATH_FUNCS:
                fn = MATH_FUNCS[e.name]
                with np.errstate(invalid="ignore", divide="ignore"):
                    return [(_drop_name(lbl), fn(vals))
                            for lbl, vals in self.eval(e.args[0])]
            if e.name in CLAMP_FUNCS:
                bound = e.args[1].value
                fn = np.maximum if e.name == "clamp_min" else np.minimum
                return [(_drop_name(lbl), fn(vals, bound))
                        for lbl, vals in self.eval(e.args[0])]
            if e.name == "clamp":
                lo_b, hi_b = e.args[1].value, e.args[2].value
                if lo_b > hi_b:     # upstream: empty result, not a swap
                    return []
                return [(_drop_name(lbl), np.clip(vals, lo_b, hi_b))
                        for lbl, vals in self.eval(e.args[0])]
            if e.name == "predict_linear":
                return self._linear(e.args[0],
                                    horizon=e.args[1].value)
            if e.name == "label_replace":
                return self._label_replace(e)
            if e.name == "label_join":
                return self._label_join(e)
            if e.name == "absent":
                return self._absent(e.args[0])
            if e.name in ("sort", "sort_desc"):
                series = self.eval(e.args[0])
                sign = -1.0 if e.name == "sort_desc" else 1.0
                # order by the last grid point's value (upstream sorts
                # instant vectors; NaN sinks to the end either way)
                def sort_key(item):
                    v = item[1][-1]
                    return (np.isnan(v), sign * v)
                return sorted(series, key=sort_key)
            if e.name == "timestamp":
                return self._timestamp(e.args[0])
            if e.name == "vector":
                return [({}, self._scalar(e.args[0]))]
            if e.name in SKETCH_FUNCS:
                return self._sketch_series(e)
            if e.name in SCALAR_FUNCS:
                raise ValueError(f"{e.name}() is scalar-valued; use it "
                                 "inside an arithmetic expression or "
                                 "wrap it in vector()")
            raise ValueError(f"unknown function {e.name}")
        if isinstance(e, AggExpr):
            return self._agg(e)
        if isinstance(e, Bin):
            return self._bin(e)
        raise ValueError(f"cannot evaluate {e!r}")

    # -- selectors ---------------------------------------------------------
    def _fetch(self, sel: Selector, lo: int, hi: int):
        """[(labels, ts, vs)] for series matching the selector with any
        samples in [lo, hi)."""
        # the self-telemetry timeline: selectors over metrics
        # the in-process rings carry (tpu_sketch_rows_in, slo_burn_rate,
        # tpu_device_busy_fraction, ...) are answered from the timeline
        # instead of a store scan — every selector path funnels here, so
        # rate()/increase()/*_over_time()/subqueries all work against
        # self-metrics through the existing routes
        timeline = getattr(self.engine, "timeline", None)
        if timeline is not None and timeline.has_metric(sel.metric):
            return timeline.prom_fetch(sel.metric, list(sel.matchers),
                                       lo, hi)
        key = (lo, hi)
        cols = self._scan_cache.get(key)
        if cols is None:
            t = self.engine.store.table(self.engine.db, self.engine.table)
            cols = t.scan(time_range=(lo, hi))
            self._scan_cache[key] = cols
        return self.engine._fetch(sel.metric, list(sel.matchers), lo, hi,
                                  cols=cols)

    def _instant(self, sel: Selector) -> SeriesList:
        if sel.range_s is not None:
            raise ValueError("range vector needs rate()/increase()/... "
                             "around it")
        # the anomaly datasource: anomaly_score{detector=...}
        # et al. are real instant-vector selectors answered from the
        # plane's snapshot cache, never the samples table
        anomaly = getattr(self.engine, "anomaly", None)
        if anomaly is not None and sel.metric in _anomaly_metrics():
            return [(dict(labels), np.asarray(vals, np.float64))
                    for labels, vals in anomaly.prom_instant(
                        sel.metric, sel.matchers,
                        self.grid - sel.offset_s)]
        g = self.grid - sel.offset_s
        lo = int(g.min()) - DEFAULT_LOOKBACK_S
        hi = int(g.max()) + 1
        out: SeriesList = []
        for labels, ts, vs in self._fetch(sel, lo, hi):
            idx = np.searchsorted(ts, g, side="right") - 1
            valid = idx >= 0
            age = np.where(valid, g - ts[np.maximum(idx, 0)],
                           np.int64(1 << 40))
            valid &= age <= DEFAULT_LOOKBACK_S
            vals = np.where(valid, vs[np.maximum(idx, 0)].astype(np.float64),
                            np.nan)
            if not np.isnan(vals).all():
                out.append((labels, vals))
        return out

    def _range_samples(self, node, g: np.ndarray):
        """Per-series raw samples for a range argument: a Selector with
        a range reads the store; a Subquery EVALUATES its inner
        expression on the subquery's own step grid (promql subquery
        semantics) and treats the finite points as samples."""
        if isinstance(node, Selector):
            lo = int(g.min()) - node.range_s
            hi = int(g.max()) + 1
            return self._fetch(node, lo, hi), node.range_s
        assert isinstance(node, Subquery)
        sg = node
        step = sg.step_s or self.default_step
        start = int(g.min()) - sg.range_s - sg.offset_s
        end = int(g.max()) - sg.offset_s
        # promql anchors subquery evaluation times at ABSOLUTE multiples
        # of the step — otherwise the same historical window returns
        # different values depending on when it is asked for
        first = (start // step + 1) * step
        sub_grid = np.arange(first, end + 1, step, dtype=np.int64)
        inner = _Evaluator(self.engine, sub_grid).eval(sg.expr)
        out = []
        for labels, vals in inner:
            keep = ~np.isnan(vals)
            if keep.any():
                out.append((labels, sub_grid[keep] + sg.offset_s,
                            vals[keep]))
        return out, sg.range_s

    def _range_fn(self, name: str, node) -> SeriesList:
        offset = node.offset_s if isinstance(node, Selector) else 0
        g = self.grid - offset
        series, range_s = self._range_samples(node, g)
        out: SeriesList = []
        for labels, ts, vs in series:
            if name == "irate":
                vals = self._irate(ts, vs, g, range_s)
            elif name in ("changes", "resets"):
                vals = self._changes(ts, vs, g, range_s,
                                     resets=name == "resets")
            elif name == "deriv":
                vals = self._deriv(ts, vs, g, range_s)
            else:
                vals = _extrapolated(
                    ts, vs, g, range_s,
                    is_counter=name in ("rate", "increase"),
                    is_rate=name == "rate")
            if not np.isnan(vals).all():
                # rate() drops the metric name upstream; matchers keep
                # label identity
                out.append((labels, vals))
        return out

    @staticmethod
    def _changes(ts, vs, grid, range_s, resets: bool):
        """changes()/resets(): count of value changes (or drops) between
        consecutive samples inside each window, via one cumsum over the
        pairwise indicators."""
        d = np.diff(vs.astype(np.float64))
        ind = (d < 0) if resets else (d != 0)
        # C[i] = number of flagged pairs among samples [0..i]
        c = np.concatenate([[0], np.cumsum(ind)])
        lo = np.searchsorted(ts, grid - range_s, side="right")
        hi = np.searchsorted(ts, grid, side="right")
        ok = hi > lo
        # pairs fully inside the window: both endpoints in [lo, hi) —
        # clamp hi-1 up to lo so an empty/single-sample window counts 0,
        # and everything into c's index range
        n_c = len(c)
        lo_c = np.minimum(lo, n_c - 1)
        hi_c = np.minimum(np.maximum(hi - 1, lo_c), n_c - 1)
        cnt = c[hi_c] - c[lo_c]
        return np.where(ok, cnt.astype(np.float64), np.nan)

    def _deriv(self, ts, vs, grid, range_s):
        slope, _ = self._regress(ts, vs, grid, range_s)
        return slope

    def _linear(self, node, horizon: float) -> SeriesList:
        """predict_linear(v[r], t): least-squares value t seconds past
        each grid point."""
        offset = node.offset_s if isinstance(node, Selector) else 0
        g = self.grid - offset
        series, range_s = self._range_samples(node, g)
        out: SeriesList = []
        for labels, ts, vs in series:
            slope, at_grid = self._regress(ts, vs, g, range_s)
            vals = at_grid + slope * horizon
            if not np.isnan(vals).all():
                out.append((_drop_name(labels), vals))
        return out

    @staticmethod
    def _regress(ts, vs, grid, range_s):
        """Per-window least squares, vectorized with window cumsums.
        Returns (slope per grid point, regression value AT the grid
        point — upstream's intercept perspective). Timestamps are
        rebased to the series start so the t^2 sums keep precision."""
        t0 = ts[0] if len(ts) else 0
        t = (ts - t0).astype(np.float64)
        v = vs.astype(np.float64)
        cs = lambda x: np.concatenate([[0.0], np.cumsum(x)])  # noqa: E731
        St, Sv, Stt, Stv = cs(t), cs(v), cs(t * t), cs(t * v)
        lo = np.searchsorted(ts, grid - range_s, side="right")
        hi = np.searchsorted(ts, grid, side="right")
        n = (hi - lo).astype(np.float64)
        ok = n >= 2
        sum_t = St[hi] - St[lo]
        sum_v = Sv[hi] - Sv[lo]
        sum_tt = Stt[hi] - Stt[lo]
        sum_tv = Stv[hi] - Stv[lo]
        denom = n * sum_tt - sum_t * sum_t
        with np.errstate(divide="ignore", invalid="ignore"):
            slope = (n * sum_tv - sum_t * sum_v) / denom
            mean_t = sum_t / np.maximum(n, 1)
            mean_v = sum_v / np.maximum(n, 1)
            g_rel = (grid - t0).astype(np.float64)
            at_grid = mean_v + slope * (g_rel - mean_t)
        ok &= np.abs(denom) > 1e-9
        return (np.where(ok, slope, np.nan),
                np.where(ok, at_grid, np.nan))

    def _over_time(self, name: str, node) -> SeriesList:
        """avg/max/min/sum/count/last _over_time: aggregate the raw
        samples inside each grid point's (t - range, t] window."""
        offset = node.offset_s if isinstance(node, Selector) else 0
        g = self.grid - offset
        series, range_s = self._range_samples(node, g)
        out: SeriesList = []
        for labels, ts, vs in series:
            lo = np.searchsorted(ts, g - range_s, side="right")
            hi = np.searchsorted(ts, g, side="right")
            valid = hi > lo
            vals = np.full(len(g), np.nan)
            if not valid.any():
                continue
            # one vectorized pass per window shape (the module's
            # columnar discipline): cumsum differences for sum/count/
            # avg/last, paired reduceat for max/min (a sentinel pad
            # keeps the trailing hi == len(vs) index legal)
            if name in ("sum_over_time", "count_over_time",
                        "avg_over_time"):
                cs = np.concatenate([[0.0], np.cumsum(vs)])
                sums = cs[hi] - cs[lo]
                cnt = (hi - lo).astype(np.float64)
                if name == "sum_over_time":
                    res = sums
                elif name == "count_over_time":
                    res = cnt
                else:
                    with np.errstate(invalid="ignore"):
                        res = sums / np.maximum(cnt, 1)
            elif name in ("stddev_over_time", "stdvar_over_time"):
                # per-window two-pass variance: the cumsum-of-squares
                # form cancels catastrophically for large-valued gauges
                # with tiny variance (E[x^2]-E[x]^2 at x ~ 1e9 loses
                # every significant bit), so this slices per point like
                # quantile_over_time — correctness over vectorization
                res = np.full(len(g), np.nan)
                for i in range(len(g)):
                    if hi[i] > lo[i]:
                        w = vs[lo[i]:hi[i]]
                        res[i] = np.var(w) if name == "stdvar_over_time" \
                            else np.std(w)
            elif name == "present_over_time":
                res = np.ones(len(g))     # any sample in window -> 1
            elif name == "last_over_time":
                res = vs[np.maximum(hi - 1, 0)]
            else:
                sentinel = -np.inf if name == "max_over_time" else np.inf
                ufn = np.maximum if name == "max_over_time" \
                    else np.minimum
                vs_p = np.append(vs, sentinel)
                pairs = np.column_stack(
                    [lo, np.maximum(hi, lo + 1)]).ravel()
                res = ufn.reduceat(vs_p, pairs)[::2]
            vals = np.where(valid, res, np.nan)
            if not np.isnan(vals).all():
                out.append((_drop_name(labels), vals))
        return out

    @staticmethod
    def _irate(ts, vs, grid, range_s):
        hi = np.searchsorted(ts, grid, side="right") - 1
        lo = np.searchsorted(ts, grid - range_s, side="left")
        ok = (hi >= 1) & (hi > lo)
        h = np.maximum(hi, 1)
        dv = vs[h].astype(np.float64) - vs[h - 1]
        # counter reset between the two samples: restart from v[last]
        dv = np.where(dv < 0, vs[h].astype(np.float64), dv)
        dt = (ts[h] - ts[h - 1]).astype(np.float64)
        return np.where(ok & (dt > 0), dv / np.maximum(dt, 1e-9), np.nan)

    def _quantile_over_time(self, phi: float, node) -> SeriesList:
        """phi-quantile of the raw samples in each window. No reduceat
        analogue exists for quantiles, so this is the one over-time
        aggregation that slices per grid point — bounded by the grid
        size, and windows are typically small."""
        offset = node.offset_s if isinstance(node, Selector) else 0
        g = self.grid - offset
        series, range_s = self._range_samples(node, g)
        out: SeriesList = []
        if phi < 0 or phi > 1:
            fill = -np.inf if phi < 0 else np.inf
        else:
            fill = None
        for labels, ts, vs in series:
            lo = np.searchsorted(ts, g - range_s, side="right")
            hi = np.searchsorted(ts, g, side="right")
            vals = np.full(len(g), np.nan)
            for i in range(len(g)):
                if hi[i] > lo[i]:
                    vals[i] = fill if fill is not None else \
                        float(np.quantile(vs[lo[i]:hi[i]], phi))
            if not np.isnan(vals).all():
                out.append((_drop_name(labels), vals))
        return out

    # -- label rewriting / presence / scalar bridges -----------------------
    def _label_replace(self, e: Func) -> SeriesList:
        dst, repl, src, regex = (a.value for a in e.args[1:])
        if not re.fullmatch(r"[a-zA-Z_][a-zA-Z0-9_]*", dst):
            raise ValueError(f"label_replace: bad destination {dst!r}")
        pat = re.compile(regex)
        out: SeriesList = []
        for labels, vals in self.eval(e.args[0]):
            m = pat.fullmatch(labels.get(src, ""))   # upstream anchors
            if m:
                # $1 group refs -> python backrefs
                new = m.expand(re.sub(r"\$(\d+)", r"\\\1", repl))
                labels = dict(labels)
                if new:
                    labels[dst] = new
                else:
                    labels.pop(dst, None)     # empty value drops label
            out.append((labels, vals))
        return out

    def _label_join(self, e: Func) -> SeriesList:
        dst, sep = e.args[1].value, e.args[2].value
        srcs = [a.value for a in e.args[3:]]
        out: SeriesList = []
        for labels, vals in self.eval(e.args[0]):
            labels = dict(labels)
            new = sep.join(labels.get(s, "") for s in srcs)
            if new:
                labels[dst] = new
            else:
                labels.pop(dst, None)
            out.append((labels, vals))
        return out

    def _absent(self, arg) -> SeriesList:
        """absent(v): 1 at grid points where v has NO series value.
        Labels derive from the selector's equality matchers (upstream),
        so `absent(up{job="api"})` alerts carry job="api"."""
        series = self.eval(arg)
        if series:
            stack = np.vstack([v for _, v in series])
            present = (~np.isnan(stack)).any(axis=0)
        else:
            present = np.zeros(len(self.grid), bool)
        vals = np.where(present, np.nan, 1.0)
        if np.isnan(vals).all():
            return []
        labels = {}
        if isinstance(arg, Selector):
            labels = {n: v for n, op, v in arg.matchers if op == "="}
        return [(labels, vals)]

    def _timestamp(self, arg) -> SeriesList:
        """timestamp(v): the evaluation-window sample's own timestamp
        per grid point (selector args only — the one function that
        needs raw sample times after instant lookup)."""
        if not isinstance(arg, Selector) or arg.range_s is not None:
            raise ValueError("timestamp() takes an instant selector")
        g = self.grid - arg.offset_s
        lo = int(g.min()) - DEFAULT_LOOKBACK_S
        hi = int(g.max()) + 1
        out: SeriesList = []
        for labels, ts, vs in self._fetch(arg, lo, hi):
            idx = np.searchsorted(ts, g, side="right") - 1
            valid = idx >= 0
            stamp = ts[np.maximum(idx, 0)]
            valid &= (g - stamp) <= DEFAULT_LOOKBACK_S
            vals = np.where(valid, stamp.astype(np.float64), np.nan)
            if not np.isnan(vals).all():
                out.append((_drop_name(labels), vals))
        return out

    def _sketch_series(self, e: Func) -> SeriesList:
        """The sketch datasource's leaf functions: delegate
        to serving.SketchTables.prom_series — values come from the
        in-process snapshot cache (staleness-bounded host reads), never
        from the samples table or the device."""
        tables = getattr(self.engine, "sketch", None)
        if tables is None:
            raise ValueError(
                f"{e.name}() needs the sketch datasource — no serving "
                "tables are wired into this querier")
        arg = e.args[0].value if e.args else None
        return [(dict(labels), np.asarray(vals, np.float64))
                for labels, vals in tables.prom_series(e.name, arg,
                                                       self.grid)]

    def _scalar(self, e: Expr) -> np.ndarray:
        """Per-grid-point scalar value of a scalar-valued expression."""
        if isinstance(e, Num):
            return np.full(len(self.grid), e.value)
        if isinstance(e, Func) and e.name == "time":
            return self.grid.astype(np.float64)
        if isinstance(e, Func) and e.name == "scalar":
            series = self.eval(e.args[0])
            if len(series) == 1:
                return series[0][1].astype(np.float64)
            return np.full(len(self.grid), np.nan)  # upstream semantics
        if isinstance(e, Bin):
            a, b = self._scalar(e.left), self._scalar(e.right)
            if e.op in COMPARE_OPS:
                # scalar comparisons are always bool-valued upstream
                return _compare(e.op, a, b).astype(np.float64)
            return _arith(e.op, a, b)
        raise ValueError(f"not a scalar expression: {e!r}")

    @staticmethod
    def _is_scalar(e: Expr) -> bool:
        if isinstance(e, Num):
            return True
        if isinstance(e, Func) and e.name in SCALAR_FUNCS:
            return True
        if isinstance(e, Bin) and e.op not in SET_OPS:
            # scalar○scalar arithmetic/comparison is scalar (1^2, etc.)
            return (_Evaluator._is_scalar(e.left)
                    and _Evaluator._is_scalar(e.right))
        return False

    # -- histogram_quantile ------------------------------------------------
    @staticmethod
    def _histogram_quantile(phi: float, series: SeriesList) -> SeriesList:
        groups: Dict[Tuple, Dict] = {}
        for labels, vals in series:
            le = labels.get("le")
            if le is None:
                continue
            rest = tuple(sorted((k, v) for k, v in labels.items()
                                if k not in ("le", "__name__")))
            g = groups.setdefault(rest, {"les": [], "vals": []})
            g["les"].append(math.inf if le in ("+Inf", "Inf", "inf")
                            else float(le))
            g["vals"].append(vals)
        out: SeriesList = []
        for rest, g in groups.items():
            les = np.asarray(g["les"])
            order = np.argsort(les)
            les = les[order]
            counts = np.vstack([g["vals"][i] for i in order])  # [B, G]
            if len(les) < 2 or not math.isinf(les[-1]):
                # upstream: quantile needs at least 2 buckets and +Inf
                continue
            counts = np.where(np.isnan(counts), 0.0, counts)
            # cumulative `le` buckets can regress slightly across series
            # merges — monotonize like upstream ensureMonotonic
            counts = np.maximum.accumulate(counts, axis=0)
            total = counts[-1]
            if phi < 0:
                q = np.full(counts.shape[1], -math.inf)
            elif phi > 1:
                q = np.full(counts.shape[1], math.inf)
            else:
                rank = phi * total
                b = np.argmax(counts >= rank[None, :], axis=0)
                b = np.minimum(b, len(les) - 1)
                upper = les[b]
                lower = np.where(b > 0, les[np.maximum(b - 1, 0)], 0.0)
                c_hi = counts[b, np.arange(counts.shape[1])]
                c_lo = np.where(
                    b > 0,
                    counts[np.maximum(b - 1, 0), np.arange(counts.shape[1])],
                    0.0)
                with np.errstate(divide="ignore", invalid="ignore"):
                    frac = (rank - c_lo) / np.maximum(c_hi - c_lo, 1e-12)
                q = lower + (upper - lower) * np.clip(frac, 0.0, 1.0)
                # +Inf bucket hit: report the highest finite bound
                q = np.where(np.isinf(upper), les[-2], q)
                q = np.where(total > 0, q, np.nan)
            if not np.isnan(q).all():
                out.append((dict(rest), q))
        return out

    @staticmethod
    def _topk(k: int, series: SeriesList, largest: bool) -> SeriesList:
        """Per grid point, keep the k highest (lowest) series values;
        the rest become stale (NaN) — upstream topk/bottomk."""
        if not series or k <= 0:
            return []
        stack = np.vstack([vals for _, vals in series])
        key = np.where(np.isnan(stack), -np.inf if largest else np.inf,
                       stack)
        k_eff = min(k, stack.shape[0])
        top = np.argpartition(-key if largest else key, k_eff - 1,
                              axis=0)[:k_eff]
        keep = np.zeros_like(stack, dtype=bool)
        keep[top, np.arange(stack.shape[1])] = True
        keep &= ~np.isnan(stack)
        out: SeriesList = []
        for i, (labels, vals) in enumerate(series):
            v = np.where(keep[i], vals, np.nan)
            if not np.isnan(v).all():
                out.append((_drop_name(labels), v))
        return out

    @staticmethod
    def _quantile_agg(phi: float, series: SeriesList) -> SeriesList:
        """quantile(phi, expr): the phi-quantile ACROSS series per grid
        point (linear interpolation, upstream semantics)."""
        if not series:
            return []
        stack = np.vstack([vals for _, vals in series])
        dead = np.isnan(stack).all(axis=0)
        if phi < 0 or phi > 1:
            # upstream: an out-of-range phi yields -Inf/+Inf, a loud
            # signal of a bad query — never a plausible-looking value
            q = np.where(dead, np.nan,
                         -np.inf if phi < 0 else np.inf)
            return [({}, q)]
        # zero-fill all-NaN columns BEFORE nanquantile (it warns on
        # all-NaN slices), then mask them back to stale
        q = np.nanquantile(np.where(dead[None, :], 0.0, stack),
                           phi, axis=0)
        q = np.where(dead, np.nan, q)
        if np.isnan(q).all():
            return []
        return [({}, q)]

    # -- aggregation -------------------------------------------------------
    def _agg(self, e: AggExpr) -> SeriesList:
        series = self.eval(e.arg)
        groups: Dict[Tuple, List[np.ndarray]] = {}
        for labels, vals in series:
            if e.without:
                key = tuple(sorted(
                    (k, v) for k, v in labels.items()
                    if k not in e.by and k != "__name__"))
            else:
                key = tuple(labels.get(b, "") for b in e.by)
            groups.setdefault(key, []).append(vals)
        out: SeriesList = []
        for key, arrs in groups.items():
            stack = np.vstack(arrs)
            dead = np.isnan(stack).all(axis=0)
            if e.op == "count":
                agg = (~np.isnan(stack)).sum(axis=0).astype(np.float64)
            else:
                safe = np.where(dead[None, :], 0.0, stack)
                agg = {"sum": np.nansum, "max": np.nanmax,
                       "min": np.nanmin, "avg": np.nanmean,
                       # population variance, upstream semantics
                       "stdvar": np.nanvar, "stddev": np.nanstd,
                       }[e.op](safe, axis=0)
            agg = np.where(dead, np.nan, agg)
            # output labels derive from the key itself: (k, v) pairs in
            # without-mode, the by-list zip otherwise
            out.append((dict(key) if e.without
                        else dict(zip(e.by, key)), agg))
        return out

    # -- binary ops --------------------------------------------------------
    def _bin(self, e: Bin) -> SeriesList:
        if e.op in SET_OPS:
            return self._set_op(e)
        lsc = self._is_scalar(e.left)
        rsc = self._is_scalar(e.right)
        if lsc and rsc:
            raise ValueError("scalar-only expression has no series")
        is_cmp = e.op in COMPARE_OPS
        if lsc or rsc:
            if e.match_on is not None:
                raise ValueError("vector matching (on/ignoring) only "
                                 "applies between instant vectors")
            series = self.eval(e.right if lsc else e.left)
            c = self._scalar(e.left if lsc else e.right)
            out = []
            for labels, vals in series:
                a, b = (c, vals) if lsc else (vals, c)
                if is_cmp:
                    hit = _compare(e.op, a, b)
                    if e.bool_mode:
                        v = np.where(np.isnan(vals), np.nan,
                                     hit.astype(np.float64))
                        out.append((_drop_name(labels), v))
                    else:
                        # filter: keep the VECTOR side's value (upstream
                        # keeps labels incl. the metric name)
                        v = np.where(hit, vals, np.nan)
                        if not np.isnan(v).all():
                            out.append((labels, v))
                else:
                    out.append((_drop_name(labels), _arith(e.op, a, b)))
            return out
        left = self.eval(e.left)
        right = self.eval(e.right)

        def match_key(labels: Dict[str, str]) -> Tuple:
            return _match_key(labels, e.match_on, e.ignoring)

        if e.group_side is not None:
            return self._bin_grouped(e, left, right, match_key)

        # one-to-one vector match (full label set minus __name__ by
        # default; on()/ignoring() restrict the key)
        rmap: Dict[Tuple, np.ndarray] = {}
        for labels, vals in right:
            key = match_key(labels)
            if key in rmap:
                raise ValueError("many-to-many vector match (use a "
                                 "narrower on()/ignoring() set or "
                                 "group_left/group_right)")
            rmap[key] = vals
        out: SeriesList = []
        matched_left = set()
        for labels, vals in left:
            key = match_key(labels)
            other = rmap.get(key)
            if other is None:
                continue          # unmatched series just drop (upstream)
            if key in matched_left:
                # only ACTUAL duplicate matches are errors, like
                # upstream's matchedSigs tracking
                raise ValueError("many-to-one vector match on the left "
                                 "side (add group_left)")
            matched_left.add(key)
            if is_cmp:
                hit = _compare(e.op, vals, other)
                if e.bool_mode:
                    out.append((dict(key),
                                np.where(np.isnan(vals) | np.isnan(other),
                                         np.nan, hit.astype(np.float64))))
                else:
                    v = np.where(hit, vals, np.nan)
                    if not np.isnan(v).all():
                        out.append((dict(labels), v))
            else:
                out.append((dict(key), _arith(e.op, vals, other)))
        return out

    def _bin_grouped(self, e: Bin, left, right, match_key) -> SeriesList:
        """group_left/group_right many-to-one: the one-side must be
        unique per key; many-side labels survive, plus any
        group-modifier labels copied from the one-side."""
        many, one = (left, right) if e.group_side == "left" \
            else (right, left)
        one_map: Dict[Tuple, Tuple[Dict[str, str], np.ndarray]] = {}
        for labels, vals in one:
            key = match_key(labels)
            if key in one_map:
                raise ValueError("group_left/group_right: the one-side "
                                 "has duplicate match keys")
            one_map[key] = (labels, vals)
        is_cmp = e.op in COMPARE_OPS
        out: SeriesList = []
        for labels, vals in many:
            got = one_map.get(match_key(labels))
            if got is None:
                continue
            o_labels, o_vals = got
            a, b = (vals, o_vals) if e.group_side == "left" \
                else (o_vals, vals)
            shown = _drop_name(labels)
            for gl in e.group_labels:
                if gl in o_labels:
                    shown[gl] = o_labels[gl]
            if is_cmp:
                hit = _compare(e.op, a, b)
                if e.bool_mode:
                    out.append((shown,
                                np.where(np.isnan(a) | np.isnan(b),
                                         np.nan, hit.astype(np.float64))))
                else:
                    v = np.where(hit, vals, np.nan)
                    if not np.isnan(v).all():
                        # filter mode keeps the many-side labels (incl.
                        # __name__) PLUS the copied group labels
                        full = dict(labels)
                        for gl in e.group_labels:
                            if gl in o_labels:
                                full[gl] = o_labels[gl]
                        out.append((full, v))
            else:
                out.append((shown, _arith(e.op, a, b)))
        return out

    def _set_op(self, e: Bin) -> SeriesList:
        left = self.eval(e.left)
        right = self.eval(e.right)

        def key_of(labels: Dict[str, str]) -> Tuple:
            return _match_key(labels, e.match_on, e.ignoring)

        # per-grid-point presence on the right, unioned by key
        rpresent: Dict[Tuple, np.ndarray] = {}
        for labels, vals in right:
            k = key_of(labels)
            p = ~np.isnan(vals)
            rpresent[k] = rpresent[k] | p if k in rpresent else p
        out: SeriesList = []
        if e.op in ("and", "unless"):
            for labels, vals in left:
                p = rpresent.get(key_of(labels))
                if e.op == "and":
                    keep = p if p is not None else \
                        np.zeros(len(vals), bool)
                else:
                    keep = ~p if p is not None else \
                        np.ones(len(vals), bool)
                v = np.where(keep, vals, np.nan)
                if not np.isnan(v).all():
                    out.append((labels, v))
            return out
        # or: all left series, plus right series at points where no
        # left series with the same key is present
        lpresent: Dict[Tuple, np.ndarray] = {}
        for labels, vals in left:
            k = key_of(labels)
            p = ~np.isnan(vals)
            lpresent[k] = lpresent[k] | p if k in lpresent else p
            out.append((labels, vals))
        for labels, vals in right:
            p = lpresent.get(key_of(labels))
            v = vals if p is None else np.where(p, np.nan, vals)
            if not np.isnan(v).all():
                out.append((labels, v))
        return out


def _drop_name(labels: Dict[str, str]) -> Dict[str, str]:
    return {k: v for k, v in labels.items() if k != "__name__"}


def _keeps_name(expr: Expr) -> bool:
    """Does the top-level expression preserve the metric name? Plain
    selectors do; so do filter-mode comparisons, set ops, and the
    label/ordering functions that pass series through unchanged
    (upstream: only value-transforming expressions drop __name__)."""
    if isinstance(expr, Selector):
        return True
    if isinstance(expr, Bin):
        if expr.op in SET_OPS:
            return _keeps_name(expr.left)
        return expr.op in COMPARE_OPS and not expr.bool_mode
    if isinstance(expr, Func) and expr.name in (
            "sort", "sort_desc", "label_replace", "label_join"):
        return _keeps_name(expr.args[0])
    return False


def _arith(op: str, a, b):
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    with np.errstate(divide="ignore", invalid="ignore"):
        if op == "%":
            # upstream uses Go math.Mod: result takes the DIVIDEND's
            # sign; np.mod takes the divisor's
            return np.fmod(np.asarray(a, np.float64),
                           np.asarray(b, np.float64))
        if op == "^":
            return np.power(np.asarray(a, np.float64),
                            np.asarray(b, np.float64))
        if op == "/":
            return np.asarray(a, np.float64) / np.asarray(b, np.float64)
    # never fall through (a set op reaching here would silently divide)
    raise ValueError(f"not an arithmetic operator: {op!r}")


def _match_key(labels: Dict[str, str], match_on, ignoring: bool) -> Tuple:
    """Vector-matching key: full label set minus __name__ by default;
    on() keeps only the on-labels PRESENT on the series (never
    fabricates empty-valued entries — they would leak into legends and
    outer groupings); ignoring() strips its labels."""
    kept = _drop_name(labels)
    if match_on is not None and not ignoring:
        kept = {k: kept[k] for k in match_on if k in kept}
    elif match_on is not None:
        kept = {k: v for k, v in kept.items() if k not in match_on}
    return tuple(sorted(kept.items()))


def _compare(op: str, a, b) -> np.ndarray:
    with np.errstate(invalid="ignore"):
        if op == "==":
            return np.asarray(a) == np.asarray(b)
        if op == "!=":
            return np.asarray(a) != np.asarray(b)
        if op == ">":
            return np.asarray(a) > np.asarray(b)
        if op == "<":
            return np.asarray(a) < np.asarray(b)
        if op == ">=":
            return np.asarray(a) >= np.asarray(b)
        return np.asarray(a) <= np.asarray(b)


# -- engine ----------------------------------------------------------------
class PromEngine:
    def __init__(self, store: Store, tag_dicts: TagDictRegistry,
                 db: str = "ext_metrics", table: str = "ext_samples",
                 sketch=None, anomaly=None, timeline=None,
                 device="cuda") -> None:
        self.store = store
        # the server's device, checked as QueryEngine checks it; the
        # evaluator itself is host numpy float64 on either device
        self.device = check_device(device)
        self.tag_dicts = tag_dicts
        self.db = db
        self.table = table
        # serving.SketchTables: backs the sketch_* functions
        self.sketch = sketch
        # serving.AnomalyTables: backs the anomaly_*
        # instant-vector selectors
        self.anomaly = anomaly
        # runtime.Timeline: selectors over self-telemetry
        # series answer from the in-process rings, not a store scan
        self.timeline = timeline

    # -- series access -----------------------------------------------------
    def _fetch(self, metric: str, matchers, lo: int, hi: int,
               cols: Optional[dict] = None):
        """[(labels, sorted ts, vs)] for the metric's series passing the
        matchers, with samples in [lo, hi). Read-only dictionary lookups
        — the query path must never grow a dict (a typo'd Grafana panel
        would journal a new entry per refresh)."""
        mh = self.tag_dicts.get("metric_name").lookup(metric)
        if mh is None:
            return []
        if cols is None:
            t = self.store.table(self.db, self.table)
            cols = t.scan(time_range=(lo, hi))
        sel = cols["metric"] == np.uint32(mh)
        label_dict = self.tag_dicts.get("label_set")
        out = []
        for lh in np.unique(cols["labels"][sel]):
            labels = _parse_labels(label_dict.decode(int(lh)) or "")
            if not self._match(labels, matchers):
                continue
            m = sel & (cols["labels"] == np.uint32(lh))
            ts = cols["timestamp"][m].astype(np.int64)
            vs = cols["value"][m].astype(np.float64)
            order = np.argsort(ts)
            labels = {"__name__": metric, **labels}
            out.append((labels, ts[order], vs[order]))
        return out

    def _matching_series(self, metric, matchers, cols, sel):
        """label_hash -> decoded labels for series in cols[sel] passing
        the matchers (used by series() discovery)."""
        label_dict = self.tag_dicts.get("label_set")
        out: Dict[int, Dict[str, str]] = {}
        for lh in np.unique(cols["labels"][sel]):
            labels = _parse_labels(label_dict.decode(int(lh)) or "")
            if self._match(labels, matchers):
                out[int(lh)] = labels
        return out

    # -- queries -----------------------------------------------------------
    def query(self, promql: str, at: Optional[int] = None) -> List[dict]:
        """Instant query: [{metric: {...}, value: [ts, "v"]}] in the
        Prometheus HTTP API result shape."""
        at = at if at is not None else int(time.time())
        expr = parse_promql(promql)
        grid = np.asarray([at], np.int64)
        series = _Evaluator(self, grid).eval(expr)
        out = []
        for labels, vals in series:
            if np.isnan(vals[0]):
                continue
            shown = labels if _keeps_name(expr) else _drop_name(labels)
            out.append({"metric": shown,
                        "value": [at, str(float(vals[0]))]})
        if isinstance(expr, Func) and expr.name in ("sort", "sort_desc"):
            return out      # the function's ordering IS the result
        return sorted(out, key=lambda r: str(r["metric"]))

    def query_range(self, promql: str, start: int, end: int,
                    step: int) -> List[dict]:
        """Range query on the [start, end] step grid — Prometheus matrix
        results [{metric, values: [[ts, "v"], ...]}] (what Grafana
        panels POST)."""
        if step <= 0:
            raise ValueError("step must be positive")
        if end < start:
            raise ValueError("end < start")
        expr = parse_promql(promql)
        grid = np.arange(start, end + 1, step, dtype=np.int64)
        series = _Evaluator(self, grid).eval(expr)
        result = []
        for labels, vals in sorted(series, key=lambda r: str(r[0])):
            shown = labels if _keeps_name(expr) else _drop_name(labels)
            values = [[int(g), str(float(v))]
                      for g, v in zip(grid, vals) if not np.isnan(v)]
            if values:
                result.append({"metric": shown, "values": values})
        return result

    # -- discovery (Grafana datasource surface) ---------------------------
    def label_names(self) -> List[str]:
        """GET /api/v1/labels: every label name across stored series,
        plus __name__ (reference: app/prometheus router label APIs)."""
        names = set()
        for s in self.tag_dicts.get("label_set").values():
            names.update(_parse_labels(s))
        names.discard("")
        names.add("__name__")
        return sorted(names)

    def label_values(self, name: str) -> List[str]:
        """GET /api/v1/label/<name>/values."""
        if name == "__name__":
            return sorted(self.tag_dicts.get("metric_name").values())
        vals = set()
        for s in self.tag_dicts.get("label_set").values():
            v = _parse_labels(s).get(name)
            if v is not None:
                vals.add(v)
        return sorted(vals)

    def series(self, matches, start: Optional[int] = None,
               end: Optional[int] = None) -> List[Dict[str, str]]:
        """GET /api/v1/series?match[]=...: label sets of series with
        samples in [start, end] matching ANY selector (the Prometheus
        API unions repeated match[] params)."""
        if isinstance(matches, str):
            matches = [matches]
        end = end if end is not None else int(time.time())
        start = start if start is not None else end - 3600
        t = self.store.table(self.db, self.table)
        cols = t.scan(columns=["metric", "labels"],
                      time_range=(start, end + 1))
        out, seen = [], set()
        for match in matches:
            expr = parse_promql(match)
            sels = _selectors(expr)
            for sq in sels:
                mh = self.tag_dicts.get("metric_name").lookup(sq.metric)
                if mh is None:
                    continue
                sel = cols["metric"] == np.uint32(mh)
                for lh, labels in self._matching_series(
                        sq.metric, list(sq.matchers), cols, sel).items():
                    if (sq.metric, lh) not in seen:
                        seen.add((sq.metric, lh))
                        out.append({"__name__": sq.metric, **labels})
        return out

    def remote_read(self, body: bytes) -> bytes:
        """Prometheus remote-read: snappy(ReadRequest) -> snappy(
        ReadResponse) (reference: server/querier/app/prometheus remote
        read service). Serves raw matrix data so a federated Prometheus
        can pull this store's samples."""
        from deepflow_tpu_torch.utils import snappy
        from deepflow_tpu_torch.wire.gen import telemetry_pb2 as pb

        _PB_OPS = {0: "=", 1: "!=", 2: "=~", 3: "!~"}
        req = pb.ReadRequest()
        req.ParseFromString(snappy.decompress(body))
        label_dict = self.tag_dicts.get("label_set")
        metric_dict = self.tag_dicts.get("metric_name")
        resp = pb.ReadResponse()
        t = self.store.table(self.db, self.table)
        for q in req.queries:
            result = resp.results.add()
            matchers = [(m.name, _PB_OPS[m.type], m.value)
                        for m in q.matchers]
            # the common shape names one metric exactly: prefilter by its
            # hash (read-only lookup) before any scan/decode work
            eq_name = next((v for n, op, v in matchers
                            if n == "__name__" and op == "="), None)
            want_mh = None
            if eq_name is not None:
                want_mh = metric_dict.lookup(eq_name)
                if want_mh is None:
                    continue
            lo = int(q.start_timestamp_ms // 1000)
            hi = int(-(-q.end_timestamp_ms // 1000)) + 1
            cols = t.scan(time_range=(lo, hi))
            if not len(cols["timestamp"]):
                continue
            if want_mh is not None:
                sel = cols["metric"] == np.uint32(want_mh)
                cols = {k: v[sel] for k, v in cols.items()}
                if not len(cols["timestamp"]):
                    continue
            # group rows by (metric, labels) hash pair
            pair = (cols["metric"].astype(np.uint64) << np.uint64(32)) \
                | cols["labels"].astype(np.uint64)
            for ph in np.unique(pair):
                mh, lh = int(ph >> np.uint64(32)), \
                    int(ph & np.uint64(0xFFFFFFFF))
                name = metric_dict.decode(mh) or ""
                labels = _parse_labels(label_dict.decode(lh) or "")
                full = {"__name__": name, **labels}
                if not self._match(full, matchers):
                    continue
                sel = pair == ph
                ts = cols["timestamp"][sel].astype(np.int64) * 1000
                vs = cols["value"][sel].astype(np.float64)
                keep = (ts >= q.start_timestamp_ms) & \
                    (ts <= q.end_timestamp_ms)
                if not keep.any():
                    continue
                order = np.argsort(ts[keep])
                series = result.timeseries.add()
                for k, v in sorted(full.items()):
                    lbl = series.labels.add()
                    lbl.name, lbl.value = k, v
                for tms, val in zip(ts[keep][order].tolist(),
                                    vs[keep][order].tolist()):
                    s = series.samples.add()
                    s.timestamp, s.value = int(tms), float(val)
        return snappy.compress(resp.SerializeToString())

    @staticmethod
    def _match(labels: Dict[str, str],
               matchers) -> bool:
        for name, op, value in matchers:
            have = labels.get(name, "")
            if op == "=" and have != value:
                return False
            if op == "!=" and have == value:
                return False
            if op == "=~" and not re.fullmatch(value, have):
                return False
            if op == "!~" and re.fullmatch(value, have):
                return False
        return True
