"""The check that nothing the benchmark runs has loaded JAX or the JAX
package: top-level module names compared whole, so ``repro_torch`` (the
port) passes and ``repro`` (the JAX package) does not."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """The loaded module names whose top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check(where: str) -> None:
    """Raise, naming what was found, if a forbidden module is loaded."""
    found = forbidden_modules()
    if found:
        raise ImportError(f"{where}: the benchmark has loaded "
                          f"{', '.join(found[:20])}")
