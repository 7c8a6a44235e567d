"""SQL statement obfuscation: literals -> ?, normalized whitespace.

Reference: agent/src/flow_generator/protocol_logs/sql/sql_obfuscate.rs —
the agent ships obfuscated statements so log storage never carries bound
values (PII) and identical query shapes aggregate under one endpoint.
This is a single-pass tokenizer, not a SQL grammar: strings, numbers and
comments are recognized lexically, everything else passes through with
whitespace collapsed.

The port's own copy of the JAX package's `agent/sql_obfuscate.py` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

_WS = b" \t\r\n"
_NUM_LEAD = b"0123456789"
_IDENT = (b"abcdefghijklmnopqrstuvwxyz"
          b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_$.")


def obfuscate_sql(stmt: bytes, max_len: int = 256) -> str:
    """Replace quoted strings and numeric literals with '?'.

    - 'single' / "double" / `backtick` quoted runs (with '' and \\'
      escapes) collapse to ?
    - numbers (ints, decimals, 0x..., exponent forms) collapse to ?,
      but identifiers keep trailing digits (tab1e2 stays)
    - -- line comments and /* block comments */ drop
    - whitespace runs collapse to one space
    """
    out = bytearray()
    i, n = 0, len(stmt)
    prev_ident = False
    while i < n and len(out) < max_len:
        c = stmt[i]
        if c in _WS:
            while i < n and stmt[i] in _WS:
                i += 1
            if out and out[-1:] != b" ":
                out += b" "
            prev_ident = False
            continue
        if c in (0x27, 0x22, 0x60):              # ' " `
            q = c
            i += 1
            while i < n:
                if stmt[i] == 0x5C and i + 1 < n:      # backslash escape
                    i += 2
                    continue
                if stmt[i] == q:
                    if i + 1 < n and stmt[i + 1] == q:  # '' doubling
                        i += 2
                        continue
                    i += 1
                    break
                i += 1
            out += b"?"
            prev_ident = False
            continue
        if stmt[i:i + 2] == b"--":
            while i < n and stmt[i] not in b"\r\n":
                i += 1
            continue
        if stmt[i:i + 2] == b"/*":
            end = stmt.find(b"*/", i + 2)
            i = n if end < 0 else end + 2
            continue
        if c in _NUM_LEAD and not prev_ident:
            i += 1
            if c == 0x30 and i < n and stmt[i] in b"xX":   # 0x...
                i += 1
                while i < n and stmt[i] in b"0123456789abcdefABCDEF":
                    i += 1
            else:
                while i < n and stmt[i] in b"0123456789.eE+-":
                    # stop +/- unless right after an exponent marker
                    if stmt[i] in b"+-" and stmt[i - 1] not in b"eE":
                        break
                    i += 1
            out += b"?"
            prev_ident = False
            continue
        out.append(c)
        prev_ident = c in _IDENT
        i += 1
    return out.decode("latin-1").strip()[:max_len]


def sql_verb(stmt: bytes) -> str:
    """Leading keyword (SELECT/INSERT/...) of a statement, uppercased."""
    s = stmt.lstrip()
    for i, ch in enumerate(s[:32]):
        if chr(ch) not in ("abcdefghijklmnopqrstuvwxyz"
                          "ABCDEFGHIJKLMNOPQRSTUVWXYZ"):
            return s[:i].decode("latin-1").upper()
    return s[:32].decode("latin-1").upper()
