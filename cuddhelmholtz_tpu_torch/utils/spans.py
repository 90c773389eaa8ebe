"""The port's spans and counters, on the clock of the device trace.

``span(name)`` is a context manager around a stretch of host work (one
Krylov step, one DDH apply, one ``prepare``); ``count(name, n)`` adds to a
named counter.  A span records ``(name, start_ns, end_ns, parent, root)``:
``parent`` is the index of the enclosing span in the same recording (None
for a top-level one) and ``root`` the index of the top-level span it lies
under (its own for a top-level span), so every span under one call into
the program, such as one ``DDH.solver`` run, one application of P or one
``prepare``, shares a root.  Stamps are ``time.time_ns()``, the epoch clock
that the profiler stamps device events with, so a span lines up with the
device's kernels in a ``torch.profiler`` trace.  A span records host time
only and never synchronises the device: the device's time is the trace's.

Spans and the counts of a recording are kept only while recording:

  * while a ``torch.profiler`` recording runs (torch's own flag), so a
    traced window of the benchmark gets the program's spans for exactly
    that window; the recording starts at the first span or count inside
    the profiler's window and stays readable (``last()``) after it;
  * inside a ``recording()`` block.

A new recording clears the previous one.  A recording keeps at most CAP
spans; later ones are dropped and counted (``Recording.dropped``).  Off, a
span site reads two flags and returns one shared no-op object: no
allocation and no clock read.  Counters also add to totals that are always
kept (``total``, ``totals``, ``reset``).

The recorder is one per process and not thread-safe: the port calls it
from one thread.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from contextlib import contextmanager

import torch.autograd.profiler as _profiler

CAP = 1 << 21  # spans a recording keeps

_OFF, _PROFILER, _BLOCK = 0, 1, 2  # who keeps the current recording


class Recording:
    """The spans and counts of one recording."""

    def __init__(self):
        # (name, start_ns, end_ns, parent, root) in order of start; a span
        # still open reads start_ns = end_ns = 0
        self.spans: list = []
        self.counts: dict = defaultdict(int)
        self.dropped = 0
        self._open: list = []  # (index, root) of the spans open now


_rec: Recording | None = None  # the current or last recording
_state = _OFF
_totals: dict = defaultdict(int)


def _active() -> Recording | None:
    """The recording that spans and counts go to now: a ``recording()``
    block's, or the profiler's (started here when its window has begun),
    else None."""
    global _rec, _state
    if _state == _BLOCK:
        return _rec
    if _profiler._is_profiler_enabled:
        if _state == _OFF:
            _rec, _state = Recording(), _PROFILER
        return _rec
    _state = _OFF  # the profiler's window has ended: its recording stays readable
    return None


class _Span:
    __slots__ = ("rec", "name", "i", "t0")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        if len(rec.spans) >= CAP:
            rec.dropped += 1
            self.i = -1
            return self
        self.i = i = len(rec.spans)
        parent, root = rec._open[-1] if rec._open else (None, i)
        rec.spans.append((self.name, 0, 0, parent, root))
        rec._open.append((i, root))
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.i >= 0:
            rec = self.rec
            rec._open.pop()
            name, _, _, parent, root = rec.spans[self.i]
            rec.spans[self.i] = (name, self.t0, t1, parent, root)
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()


def span(name: str):
    """A context manager that records the host time of its body as the span
    ``name`` while recording; else the shared no-op."""
    if _state or _profiler._is_profiler_enabled:
        rec = _active()
        if rec is not None:
            return _Span(rec, name)
    return _NOOP


def spanned(name: str):
    """Decorate a function so that each call is the span ``name``."""
    def wrap(f):
        @functools.wraps(f)
        def inner(*args, **kwargs):
            with span(name):
                return f(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``: to its total, and while recording
    to the recording's counts."""
    _totals[name] += n
    if _state or _profiler._is_profiler_enabled:
        rec = _active()
        if rec is not None:
            rec.counts[name] += n


@contextmanager
def recording():
    """Record the body's spans and counts into a new recording, whatever the
    profiler does; yields it."""
    global _rec, _state
    outer = _state
    _rec, _state = Recording(), _BLOCK
    try:
        yield _rec
    finally:
        _state = _BLOCK if outer == _BLOCK else _OFF


def last() -> Recording | None:
    """The current or last recording (None before the first)."""
    return _rec


def total(name: str) -> int:
    """The counter ``name``'s total since the process started (or its last
    ``reset``)."""
    return _totals.get(name, 0)


def totals(prefix: str = "") -> dict:
    """Every counter total whose name starts with ``prefix``, by the rest of
    its name."""
    return {k[len(prefix):]: v for k, v in _totals.items() if k.startswith(prefix)}


def reset(prefix: str = "") -> None:
    """Set every counter total whose name starts with ``prefix`` to 0."""
    for k in [k for k in _totals if k.startswith(prefix)]:
        del _totals[k]
