"""Spans and a host-synchronisation counter inside the update and search
engines.

Off by default.  ``span`` then returns one shared no-op context after a
single flag test, and ``host_sync`` returns at once: nothing is allocated,
no clock is read and nothing synchronises.

``enable(True)`` turns both on, for one thread at a time.  A span then adds,
per name, its calls, its inclusive host seconds, its self seconds (inclusive
less the time its child spans cover) and the host synchronisations counted
while it was open to ``totals()``; counts are inclusive.  The counter is
fed in one place: while tracing is on, CUDA's sync debug mode warns at
every operation that makes the host wait on the device (a ``.cpu()``,
``.tolist()``, ``.item()``, ``bool()`` or ``int()`` of a device tensor, a
blocking copy to the device, ``torch.nonzero``, a boolean-mask index), and
a warnings hook counts each warning (``SYNC_WARNING``) instead of showing
it.  The mode does not report ``torch.cuda.synchronize``, so the callers
of that mark it with ``host_sync()``.  Without CUDA nothing synchronises
and the counter stays 0.

``request(name)`` opens the root span of one request (one
``StreamingIndex.insert``, ``delete`` or ``search`` call) under a new
sequence id, which every span inside it carries.  While a ``torch.profiler``
records, each span also emits a user annotation of its name, so program
spans sit on the clock of the device intervals in the exported trace.  The
annotation's arguments are the request id and then the request's keyword
attributes, in order; the exported trace shows them under ``Concrete
Inputs`` when the profiler records shapes.  A span never synchronises:
its seconds are the host's, which on a host-bound path include the waits
that the counter counts.

Nothing is written to disk: a reader takes ``totals()`` (a copy) and the
profiler's trace.
"""
from __future__ import annotations

import copy
import time
import warnings
from typing import Optional

import torch

# what CUDA's sync debug mode says of each synchronising operation
SYNC_WARNING = "called a synchronizing CUDA operation"

_ON = False
_stack: list = []          # the open spans, innermost last
_totals: dict = {}         # name -> {"calls", "incl_s", "self_s", "host_syncs"}
_syncs = 0                 # synchronisations counted since the module loaded
_rid = 0                   # the last request id handed out
_restore = None            # (warnings state, sync debug mode)
_shown = None              # the warnings hook that other warnings go to


class _Null:
    """The span returned while tracing is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "rid", "args", "t0", "child_s", "s0", "_ann")

    def __init__(self, name: str, rid: Optional[int], args: tuple):
        self.name = name
        self.rid = rid
        self.args = args

    def __enter__(self):
        self._ann = None
        if torch.autograd._profiler_enabled():
            self._ann = torch.autograd._record_function_with_args_enter(
                self.name, -1 if self.rid is None else self.rid, *self.args)
        self.child_s = 0.0
        self.s0 = _syncs
        _stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        if self._ann is not None:
            torch.autograd._record_function_with_args_exit(self._ann)
        _stack.pop()
        if _stack:
            _stack[-1].child_s += seconds
        row = _totals.get(self.name)
        if row is None:
            row = _totals[self.name] = {"calls": 0, "incl_s": 0.0,
                                        "self_s": 0.0, "host_syncs": 0}
        row["calls"] += 1
        row["incl_s"] += seconds
        row["self_s"] += seconds - self.child_s
        row["host_syncs"] += _syncs - self.s0
        return False


def span(name: str):
    """A context manager timing ``name`` inside the current request (see the
    module docstring)."""
    if not _ON:
        return _NULL
    return _Span(name, _stack[-1].rid if _stack else None, ())


def request(name: str, **attrs):
    """``span`` for the root of one request, under a new request id."""
    if not _ON:
        return _NULL
    global _rid
    _rid += 1
    return _Span(name, _rid, tuple(attrs.values()))


def host_sync() -> None:
    """Count one ``torch.cuda.synchronize``, which the sync debug mode does
    not report."""
    if _ON:
        global _syncs
        _syncs += 1


def _count_sync(message, category, filename, lineno, file=None, line=None):
    """The warnings hook while tracing is on: counts the sync debug mode's
    warnings and passes every other warning on."""
    if str(message).startswith(SYNC_WARNING):
        global _syncs
        _syncs += 1
    else:
        _shown(message, category, filename, lineno, file, line)


def enable(on: bool = True) -> bool:
    """Turn tracing on or off; returns whether it was on."""
    global _ON, _restore, _shown
    was, on = _ON, bool(on)
    if on and not was:
        saved = warnings.catch_warnings()
        saved.__enter__()
        _shown = warnings.showwarning
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.showwarning = _count_sync
        mode = None
        if torch.cuda.is_available():
            mode = torch.cuda.get_sync_debug_mode()
            # warns once that the mode is a prototype: passed on
            torch.cuda.set_sync_debug_mode("warn")
        _restore = (saved, mode)
    elif was and not on:
        saved, mode = _restore
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        saved.__exit__(None, None, None)
        _restore = None
    _ON = on
    return was


def totals() -> dict:
    """A copy of the per-name table: ``{name: {"calls", "incl_s", "self_s",
    "host_syncs"}}``."""
    return copy.deepcopy(_totals)


def reset() -> None:
    """Clear the per-name table."""
    _totals.clear()


__all__ = ["SYNC_WARNING", "enable", "host_sync", "request", "reset",
           "span", "totals"]
