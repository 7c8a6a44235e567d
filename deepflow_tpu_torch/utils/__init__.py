"""u32 arithmetic helpers. The public names resolve on first use: `u32`
imports torch, and host-only modules import `utils.text`, `utils.snappy`
and `utils.twinmark` without it."""

from deepflow_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "as_u32": "u32",
    "fold_columns": "u32",
    "mix32": "u32",
    "splitmix32_seeds": "u32",
}

__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
