"""Text helpers for attacker-facing string handling.

The port's own copy of the JAX package's `utils/text.py` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations


def parse_int(s: str, default: int = 0) -> int:
    """int(s) for ASCII-decimal strings, `default` otherwise.

    The obvious `int(s) if s.isdigit() else default` is a trap on
    payload-derived text: latin-1 decoding turns bytes like 0xB3 into
    '³', for which str.isdigit() is True but int() raises ValueError —
    found live by the L7 registry fuzz as a parser crash. This helper
    is the one safe spelling; use it anywhere the string came off the
    wire."""
    return int(s) if s.isascii() and s.isdigit() else default
