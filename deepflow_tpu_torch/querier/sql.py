"""DeepFlow-SQL parser: a small recursive-descent front end.

Supports the query shapes the reference querier serves from Grafana
(engine/clickhouse/clickhouse.go TransSelect/TransWhere/TransGroupBy):

    SELECT * | <expr> [AS alias], ... FROM <table>
      [WHERE <cond> [AND <cond>]...]
      [GROUP BY col, ...] [HAVING <cond> [AND ...]]
      [ORDER BY key [ASC|DESC], ...] [LIMIT n]
    SHOW DATABASES | SHOW TABLES [FROM db] |
    SHOW TAGS FROM <table> | SHOW METRICS FROM <table> |
    SHOW TAG <tag> VALUES FROM <table> [LIMIT n]

Expressions: columns, integer/float/string literals, aggregate calls
(Sum/Min/Max/Avg/Count, Percentile(col, p), PerSecond(expr) — the
reference's TransMetricFunc function set), and +,-,*,/ arithmetic over
them (derived metrics like Sum(retrans)/Sum(packet_tx)). Conditions:
=, !=, <, <=, >, >=, IN/NOT IN (...), LIKE/NOT LIKE ('%' and '_'
wildcards on dictionary-backed columns), REGEXP, combined with
AND/OR/NOT and parentheses (full boolean trees; time-range pruning
reads the top-level conjuncts). The reference's sqlparser fork
(querier/parse/parse.go) plays this role; a hand-rolled parser keeps
the dependency surface zero.

Time bucketing: `time(N)` (alias `interval(N)`) may appear in GROUP BY
and in the select list — the reference's TransGroupBy interval grouping
(engine/clickhouse/clickhouse.go:816-1088 lowers it to
toStartOfInterval); here it floors the table's time column to N-second
buckets so timeseries panels can be driven straight from SQL.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

AGG_FUNCS = {"sum", "min", "max", "avg", "count"}

_TOKEN = re.compile(r"""
    \s*(
        '(?:[^'\\]|\\.)*'        # string literal
      | [A-Za-z_][A-Za-z0-9_.]*  # ident (may be db.table)
      | \d+\.\d+ | \d+           # number
      | != | <= | >= | [(),=<>*+/-]
    )""", re.VERBOSE)


def tokenize(s: str) -> List[str]:
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN.match(s, pos)
        if not m:
            if s[pos:].strip() == "":
                break
            raise ValueError(f"bad token at: {s[pos:pos+20]!r}")
        out.append(m.group(1))
        pos = m.end()
    return out


# -- AST -------------------------------------------------------------------
@dataclass(frozen=True)
class Column:
    name: str


@dataclass(frozen=True)
class Literal:
    value: Union[int, float, str]


@dataclass(frozen=True)
class Agg:
    func: str                 # sum|min|max|avg|count|percentile
    arg: Optional["Expr"]     # None for Count(*)
    param: Optional[float] = None   # Percentile(col, p)'s p


@dataclass(frozen=True)
class IntervalRef:
    """PerSecond()'s divisor: the GROUP BY time-bucket width, or the
    query's WHERE time span (reference: engine/clickhouse metrics
    TransMetricFunc lowers PerSecond to value/interval)."""


@dataclass(frozen=True)
class BinOp:
    op: str                   # + - * /
    left: "Expr"
    right: "Expr"


@dataclass(frozen=True)
class TimeBucket:
    """time(N) / interval(N): the table's time column floored to
    N-second buckets. Output column name defaults to `time`."""
    seconds: int


@dataclass(frozen=True)
class QualifiedFunc:
    """A dotted function call — ``sketch.topk(10)``,
    ``sketch.cms_point(key)`` — the virtual-datasource surface (the
    sketch tables). The parser stays generic: it records the dotted
    name plus LITERAL arguments; the owning datasource interprets them
    (serving/tables.py for the ``sketch.*`` family)."""
    name: str
    args: Tuple[Union[int, float, str], ...] = ()


Expr = Union[Column, Literal, Agg, BinOp, TimeBucket, IntervalRef,
             QualifiedFunc]


@dataclass(frozen=True)
class Cond:
    column: str
    op: str         # = != < <= > >= in not_in like not_like regexp
    value: Union[int, float, str, Tuple]


@dataclass(frozen=True)
class BoolOp:
    """WHERE boolean tree node. Select.where is a top-level AND list;
    OR/NOT subtrees appear as BoolOp entries (so time-range pruning
    keeps working off the top-level conjuncts)."""
    op: str                   # "and" | "or" | "not"
    children: Tuple           # Cond | BoolOp


WhereNode = Union[Cond, BoolOp]


@dataclass(frozen=True)
class SelectItem:
    expr: Expr
    alias: Optional[str]


@dataclass(frozen=True)
class Select:
    items: List[SelectItem]
    table: str
    where: List[Cond] = field(default_factory=list)
    # column names, plus at most one TimeBucket for interval grouping
    group_by: List[Union[str, TimeBucket]] = field(default_factory=list)
    # [(alias/col, desc), ...] — primary key first
    order_by: List[Tuple[str, bool]] = field(default_factory=list)
    limit: Optional[int] = None
    # post-aggregation conditions on output column names/aliases
    having: List[Cond] = field(default_factory=list)
    offset: int = 0


@dataclass(frozen=True)
class Show:
    what: str                 # databases|tables|tags|metrics|tag_values
    table: Optional[str] = None
    tag: Optional[str] = None            # SHOW TAG <tag> VALUES FROM t
    limit: Optional[int] = None


@dataclass(frozen=True)
class JoinSelect:
    """The final SELECT of a WITH query: two CTE results joined on an
    equality conjunction (the reference's Grafana multi-metric panel
    shape, clickhouse_test.go:452)."""
    items: List[SelectItem]          # qualified Column("q1.x") refs
    left: str
    right: str
    join_type: str                   # left | inner
    on: List[Tuple[str, str]]        # (left col, right col) pairs
    order_by: List[Tuple[str, bool]] = field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0


@dataclass(frozen=True)
class With:
    ctes: List[Tuple[str, Select]]
    select: JoinSelect


Statement = Union[Select, Show, With]


def expr_columns(expr: Expr) -> set:
    """Column names referenced anywhere in an expression tree."""
    if isinstance(expr, Column):
        return {expr.name}
    if isinstance(expr, Agg):
        return expr_columns(expr.arg) if expr.arg is not None else set()
    if isinstance(expr, BinOp):
        return expr_columns(expr.left) | expr_columns(expr.right)
    return set()


class _Parser:
    def __init__(self, tokens: List[str]) -> None:
        self.toks = tokens
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of query")
        self.i += 1
        return t

    def expect(self, word: str) -> None:
        t = self.next()
        if t.lower() != word.lower():
            raise ValueError(f"expected {word!r}, got {t!r}")

    def accept(self, word: str) -> bool:
        if (self.peek() or "").lower() == word.lower():
            self.i += 1
            return True
        return False

    # -- expressions -------------------------------------------------------
    def parse_expr(self) -> Expr:
        left = self.parse_term()
        while self.peek() in ("+", "-"):
            op = self.next()
            left = BinOp(op, left, self.parse_term())
        return left

    def parse_term(self) -> Expr:
        left = self.parse_atom()
        while self.peek() in ("*", "/"):
            op = self.next()
            left = BinOp(op, left, self.parse_atom())
        return left

    def parse_atom(self) -> Expr:
        t = self.next()
        if t == "(":
            e = self.parse_expr()
            self.expect(")")
            return e
        if t.startswith("'"):
            return Literal(t[1:-1])
        if re.fullmatch(r"\d+", t):
            return Literal(int(t))
        if re.fullmatch(r"\d+\.\d+", t):
            return Literal(float(t))
        if t.lower() in ("time", "interval") and self.peek() == "(":
            return self._time_bucket()
        if t.lower() == "percentile" and self.peek() == "(":
            self.next()
            arg = self.parse_expr()
            self.expect(",")
            p = self._value(self.next())
            self.expect(")")
            if not isinstance(p, (int, float)) or not 0 <= p <= 100:
                raise ValueError(f"Percentile needs 0..100, got {p!r}")
            return Agg("percentile", arg, float(p))
        if t.lower() == "persecond" and self.peek() == "(":
            # PerSecond(expr) = expr / the query interval (time-bucket
            # width under interval grouping, else the WHERE time span)
            self.next()
            arg = self.parse_expr()
            self.expect(")")
            return BinOp("/", arg, IntervalRef())
        if t.lower() in AGG_FUNCS and self.peek() == "(":
            self.next()
            if self.accept("*"):
                self.expect(")")
                return Agg(t.lower(), None)
            arg = self.parse_expr()
            self.expect(")")
            return Agg(t.lower(), arg)
        if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_.]*", t):
            raise ValueError(f"unexpected token {t!r}")
        if "." in t and self.peek() == "(":
            # dotted function call (sketch.topk(10)-style): literal
            # arguments only — the datasource that owns the namespace
            # validates names/arity (engine._select routes by table)
            self.next()
            args = []
            if not self.accept(")"):
                args.append(self._value(self.next()))
                while self.accept(","):
                    args.append(self._value(self.next()))
                self.expect(")")
            return QualifiedFunc(t.lower(), tuple(args))
        return Column(t)

    # -- clauses -----------------------------------------------------------
    def parse_select(self, stop_at_paren: bool = False) -> Select:
        items = []
        if self.accept("*"):
            # SELECT *: expanded to the table's columns by the engine
            # (which knows the schema); must be the only select item
            items.append(SelectItem(Column("*"), None))
        else:
            while True:
                e = self.parse_expr()
                alias = None
                if self.accept("as"):
                    alias = self.next()
                items.append(SelectItem(e, alias))
                if not self.accept(","):
                    break
        self.expect("from")
        table = self.next()
        where: List[Cond] = []
        group_by: List[str] = []
        order_by: List[Tuple[str, bool]] = []
        limit = None
        if self.accept("where"):
            where = self.parse_bool()
        if self.accept("group"):
            self.expect("by")
            group_by.append(self._group_item())
            while self.accept(","):
                group_by.append(self._group_item())
            if sum(isinstance(g, TimeBucket) for g in group_by) > 1:
                raise ValueError("at most one time()/interval() bucket "
                                 "per GROUP BY")
        having: List[Cond] = []
        if self.accept("having"):
            having.append(self.parse_cond())
            while self.accept("and"):
                having.append(self.parse_cond())
        order_by, limit, offset = self._order_limit_tail()
        if not stop_at_paren and self.peek() is not None:
            raise ValueError(f"trailing tokens at {self.peek()!r}")
        return Select(items, table, where, group_by, order_by, limit,
                      having, offset)

    def _time_bucket(self) -> TimeBucket:
        self.expect("(")
        t = self.next()
        if not re.fullmatch(r"\d+", t) or int(t) <= 0:
            raise ValueError(f"time() needs a positive interval in "
                             f"seconds, got {t!r}")
        self.expect(")")
        return TimeBucket(int(t))

    def _group_item(self) -> Union[str, TimeBucket]:
        t = self.next()
        if t.lower() in ("time", "interval") and self.peek() == "(":
            return self._time_bucket()
        return t

    def parse_with(self) -> "With":
        ctes: List[Tuple[str, Select]] = []
        seen = set()
        while True:
            name = self.next()
            if name in seen:
                raise ValueError(f"duplicate CTE name {name!r}")
            seen.add(name)
            self.expect("as")
            self.expect("(")
            self.expect("select")
            ctes.append((name, self.parse_select(stop_at_paren=True)))
            self.expect(")")
            if not self.accept(","):
                break
        self.expect("select")
        items = []
        while True:
            e = self.parse_expr()
            if not isinstance(e, Column) or "." not in e.name:
                raise ValueError("the joined SELECT takes qualified "
                                 "columns (query1.col [AS alias])")
            alias = self.next() if self.accept("as") else None
            items.append(SelectItem(e, alias))
            if not self.accept(","):
                break
        self.expect("from")
        left = self.next()
        join_type = "inner"
        if self.accept("left"):
            join_type = "left"
        elif self.accept("inner"):
            pass
        self.expect("join")
        right = self.next()
        self.expect("on")
        on: List[Tuple[str, str]] = []
        while True:
            a = self.next()
            self.expect("=")
            b = self.next()
            for side in (a, b):
                if "." not in side:
                    raise ValueError(f"ON needs qualified columns, "
                                     f"got {side!r}")
            # normalize so the left CTE's column comes first
            la, ca = a.split(".", 1)
            lb, cb = b.split(".", 1)
            if la == left and lb == right:
                on.append((ca, cb))
            elif la == right and lb == left:
                on.append((cb, ca))
            else:
                raise ValueError(f"ON references unknown query "
                                 f"names: {a} = {b}")
            if not self.accept("and"):
                break
        order_by, limit, offset = self._order_limit_tail()
        if self.peek() is not None:
            raise ValueError(f"trailing tokens at {self.peek()!r}")
        names = {n for n, _ in ctes}
        if left not in names or right not in names:
            raise ValueError(f"JOIN references undefined query "
                             f"({left}, {right})")
        return With(ctes, JoinSelect(items, left, right, join_type, on,
                                     order_by, limit, offset))

    def _order_limit_tail(self):
        """The shared `ORDER BY k [ASC|DESC], ... LIMIT n` clause tail
        (plain selects and joined WITH-selects parse it identically)."""
        order_by: List[Tuple[str, bool]] = []
        if self.accept("order"):
            self.expect("by")
            while True:
                key = self.next()
                desc = False
                if self.accept("desc"):
                    desc = True
                elif self.accept("asc"):
                    pass
                order_by.append((key, desc))
                if not self.accept(","):
                    break
        limit = None
        offset = 0
        if self.accept("limit"):
            limit = int(self.next())
            if self.accept("offset"):
                offset = int(self.next())
        return order_by, limit, offset

    def parse_bool(self) -> List[WhereNode]:
        """WHERE tree, precedence OR < AND < NOT < atom; returns the
        top-level AND conjunct list (time pruning reads it directly)."""
        node = self._bool_or()
        if isinstance(node, BoolOp) and node.op == "and":
            return list(node.children)
        return [node]

    def _bool_or(self) -> WhereNode:
        left = self._bool_and()
        branches = [left]
        while self.accept("or"):
            branches.append(self._bool_and())
        if len(branches) == 1:
            return left
        return BoolOp("or", tuple(branches))

    def _bool_and(self) -> WhereNode:
        left = self._bool_not()
        parts = [left]
        while self.accept("and"):
            parts.append(self._bool_not())
        if len(parts) == 1:
            return left
        # flatten nested ANDs so parse_bool's top-level list is maximal
        flat: List[WhereNode] = []
        for p in parts:
            if isinstance(p, BoolOp) and p.op == "and":
                flat.extend(p.children)
            else:
                flat.append(p)
        return BoolOp("and", tuple(flat))

    def _bool_not(self) -> WhereNode:
        if self.accept("not"):
            return BoolOp("not", (self._bool_not(),))
        if self.peek() == "(":
            # lookahead: '(' here is a boolean group, because a
            # condition atom always starts with a column name
            self.next()
            inner = self._bool_or()
            self.expect(")")
            return inner
        return self.parse_cond()

    def parse_cond(self) -> Cond:
        col = self.next()
        op = self.next().lower()
        negate = False
        if op == "not":
            negate = True
            op = self.next().lower()
            if op not in ("in", "like"):
                raise ValueError(f"bad operator NOT {op!r}")
        if op == "in":
            self.expect("(")
            vals = [self._value(self.next())]
            while self.accept(","):
                vals.append(self._value(self.next()))
            self.expect(")")
            return Cond(col, "not_in" if negate else "in", tuple(vals))
        if op == "like":
            v = self._value(self.next())
            if not isinstance(v, str):
                raise ValueError("LIKE needs a string pattern")
            return Cond(col, "not_like" if negate else "like", v)
        if op == "regexp":
            v = self._value(self.next())
            if not isinstance(v, str):
                raise ValueError("REGEXP needs a string pattern")
            return Cond(col, "regexp", v)
        if op not in ("=", "!=", "<", "<=", ">", ">="):
            raise ValueError(f"bad operator {op!r}")
        return Cond(col, op, self._value(self.next()))

    @staticmethod
    def _value(t: str) -> Union[int, float, str]:
        if t.startswith("'"):
            return t[1:-1]
        if re.fullmatch(r"\d+", t):
            return int(t)
        if re.fullmatch(r"\d+\.\d+", t):
            return float(t)
        raise ValueError(f"bad literal {t!r}")


def parse_sql(sql: str) -> Statement:
    toks = tokenize(sql)
    p = _Parser(toks)
    head = p.next().lower()
    if head == "select":
        return p.parse_select()
    if head == "with":
        return p.parse_with()
    if head == "show":
        what = p.next().lower()
        if what == "databases":
            return Show("databases")
        if what == "tables":
            table = None
            if p.accept("from"):
                table = p.next()
            return Show("tables", table)
        if what in ("tags", "metrics"):
            p.expect("from")
            return Show(what, p.next())
        if what == "tag":
            # show tag <name> values from <table> [limit n] — the
            # Grafana variable-dropdown query (clickhouse.go:53)
            tag = p.next()
            p.expect("values")
            p.expect("from")
            table = p.next()
            limit = None
            if p.accept("limit"):
                limit = int(p.next())
            if p.peek() is not None:
                raise ValueError(f"trailing tokens at {p.peek()!r}")
            return Show("tag_values", table, tag=tag, limit=limit)
        raise ValueError(f"SHOW {what} not supported")
    raise ValueError(f"unsupported statement {head!r}")
