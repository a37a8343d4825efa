"""The detector's layer spans, for a profiler trace and a host-clock record.

``span(name)`` marks a layer of the port (the whole forward, the backbone
and FPN, the backprojection, the 3D neck, the head, the decode, the NMS,
the loss and its targets, the training step and its phases, a DCN), as a
context manager or as a decorator::

    with span('neck3d'):
        out = self.neck_3d(volume)

    @span('nms')
    def multiclass_nms_3d(...): ...

Two sinks read the spans; the caller turns them on, nothing here does:

* while a ``torch.profiler`` session is active, a span is a
  ``record_function('imvx.<name>')`` range, in the same chrome trace as the
  device events and on their clock;
* while :func:`recording` is active, a span appends ``(name, parent index,
  thread id, t0_ns, t1_ns)`` on ``time.perf_counter_ns`` to the list that
  :func:`recording` yields: the host's time without the profiler's cost of
  recording every operator.  The parent is the innermost span open on the
  same thread when it began (``None`` at the top).

With neither on, a span costs one check of this module's flag and of the
profiler's, and returns the name's one shared no-op context.  While
``torch.export`` traces (``torch.compiler.is_compiling()``) a span is
always the no-op, so exported programs hold none of it.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = 'imvx.'

# the list of the active recording, or None; its open spans by thread
_records = None
_open = {}
_lock = threading.Lock()
_nulls = {}


class _Decorates:
    """``@span(name)``: each call of the function runs inside
    ``span(name)``, decided at the call."""

    __slots__ = ('name',)

    def __init__(self, name: str):
        self.name = name

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapped


class _Null(_Decorates):
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Live(_Decorates):
    __slots__ = ('range', 'records', 'index', 'stack')

    def __enter__(self):
        records = _records
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        else:
            self.range = None
        self.records = records
        if records is not None:
            tid = threading.get_ident()
            with _lock:
                stack = _open.setdefault(tid, [])
                self.index = len(records)
                records.append((self.name, stack[-1] if stack else None,
                                tid, time.perf_counter_ns(), None))
            stack.append(self.index)
            self.stack = stack
        return self

    def __exit__(self, *exc):
        if self.records is not None:
            t1 = time.perf_counter_ns()
            self.stack.pop()
            self.records[self.index] = self.records[self.index][:4] + (t1,)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """The layer span ``name``: a context manager, or a decorator that
    opens it around every call of the function."""
    if (_records is None and not _autograd_profiler._is_profiler_enabled
            or torch.compiler.is_compiling()):
        try:
            return _nulls[name]
        except KeyError:
            return _nulls.setdefault(name, _Null(name))
    return _Live(name)


@contextlib.contextmanager
def recording():
    """Record every span of the block on the host clock: yields the list
    that the block's spans fill, as ``(name, parent, thread, t0_ns,
    t1_ns)`` with ``parent`` an index into it or ``None``."""
    global _records
    if _records is not None:
        raise RuntimeError('a recording is already active')
    records = []
    _open.clear()
    _records = records
    try:
        yield records
    finally:
        _records = None
        _open.clear()
