"""Arch registry (``repro/configs/registry.py``): ``--arch <id>``
resolution.

Each architecture lives in its own ``configs/<id>.py`` module, which
defines ``SPEC`` and registers it here on import (see ``__init__``).
"""
from __future__ import annotations

from typing import Dict

from .base import ArchSpec

_REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_arch(name: str) -> ArchSpec:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def all_archs() -> Dict[str, ArchSpec]:
    return dict(_REGISTRY)
