"""The sketch ops (torch) and the hand kernels' wrappers.

The six op modules resolve on first use: host-only modules import
`ops._build` (the build directory) without torch. No import builds or
loads a kernel library; `_build` does that at a kernel's first launch.
"""

from deepflow_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "cms": None,
    "entropy": None,
    "hashing": None,
    "hll": None,
    "pca": None,
    "topk": None,
}

__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
