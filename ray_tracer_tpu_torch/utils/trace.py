"""Profiler ranges for the host loop: spans and zero-length marks that a
running ``torch.profiler`` records beside the device's operations.

The profiler is the switch.  With none running, :func:`span` returns a
shared no-op context after one flag read and builds no name, and
:func:`mark` does nothing.  With one running, each enters a
``_RecordFunctionFast`` range: a function-scope range, not a user
annotation (``record_function``'s kind), so the profiler copies nothing
of it onto the device's timeline, and the device operations it traces
stay the program's own.

Names carry their counts as ``key=value`` words after the span's name
(``rt.round lanes=4147200 live=4147200``); a name is formatted only when
the profiler is on.
"""

from __future__ import annotations

import contextlib

import torch

_Range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Is a profiler recording?"""
    return torch._C._autograd._profiler_enabled()


def span(name: str, *args):
    """A range named ``name % args`` while a profiler records, else a no-op
    context."""
    if not recording():
        return _OFF
    return _Range(name % args if args else name)


def mark(name: str, *args) -> None:
    """A zero-length range named ``name % args`` while a profiler records:
    a counter at one point of the host's timeline."""
    if recording():
        with _Range(name % args if args else name):
            pass
