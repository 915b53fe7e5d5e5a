"""PEP 562 lazy exports: a package's public names import their module at
first use, so importing the package builds nothing and touches no device."""

from __future__ import annotations

import importlib
from typing import Dict


def lazy_exports(package: str, where: Dict[str, str]):
    """(__getattr__, __dir__) for `package`, whose names `where` maps to the
    relative module that defines each."""

    def __getattr__(name):
        if name in where:
            return getattr(importlib.import_module(where[name], package), name)
        raise AttributeError(f"module {package!r} has no attribute {name!r}")

    def __dir__():
        return sorted(set(importlib.import_module(package).__dict__) | set(where))

    return __getattr__, __dir__
