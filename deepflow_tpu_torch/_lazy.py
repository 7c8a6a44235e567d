"""Package attributes that import their module on first use (PEP 562).

A package `__init__` that re-exports names from heavy modules binds them
lazily, so importing one light submodule (a host-only role's) does not
import torch through its package."""

from __future__ import annotations

import importlib
import sys
from typing import Callable, Dict, List, Optional, Tuple


def lazy_exports(package: str, exports: Dict[str, Optional[str]]
                 ) -> Tuple[Callable, Callable]:
    """(`__getattr__`, `__dir__`) for `package`. `exports` maps each
    public name to the submodule that defines it, or to None where the
    name is itself a submodule. A resolved name is cached on the
    package."""

    def __getattr__(name: str):
        if name not in exports:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        mod = importlib.import_module(f"{package}.{exports[name] or name}")
        value = mod if exports[name] is None else getattr(mod, name)
        setattr(sys.modules[package], name, value)
        return value

    def __dir__() -> List[str]:
        return sorted(set(vars(sys.modules[package])) | set(exports))

    return __getattr__, __dir__
