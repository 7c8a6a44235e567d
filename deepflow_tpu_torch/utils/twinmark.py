"""The host/device twin marker, dependency-free on purpose.

Modules tag a host twin of a device op with `@host_twin_of(...)`
(`serving/tables.py`'s scalar CMS hash and flow-key fold). It costs
nothing to import and imports nothing. A copy of the JAX package's
`utils/twinmark.py`, whose twin-drift check reads the decorator.
"""

from __future__ import annotations

__all__ = ["host_twin_of"]


def host_twin_of(device_ref: str):
    """Declare the decorated def/class the host twin of `device_ref`
    ("path/to/mod.py:qualname" or "pkg.mod:qualname").

    Runtime no-op beyond tagging (`__device_twin__`) — the lint reads
    the decorator lexically. The tag keeps the link discoverable from
    a REPL (`fold_columns_np.__device_twin__`)."""
    def deco(obj):
        obj.__device_twin__ = device_ref
        return obj
    return deco
