"""In-memory span recorder for the port's layer boundaries.

A span is (name, start, end, id, parent, attrs): start and end in
nanoseconds since the epoch (``time.time_ns()``, the clock that
``torch.profiler``'s Kineto timestamps share), ``parent`` the id of the
span open around it (None at the top), ``attrs`` a dict.

- ``with span(name, **attrs):`` nests: spans opened this way form one
  call stack per process, so record them from one thread.
- ``begin(name, **attrs)`` / ``end(token)`` open in one call and close in
  another, outside the stack: a request's spans, each carrying its
  request id ``rid``.
- ``timed(name, **attrs)`` is ``span`` that reads the clock whether
  recording is on or off, for callers that keep the duration themselves
  (``.seconds``); on, its span has the same two readings.

- ``backward_marks(name)`` gives two identity functions for a layer's
  input and output; differentiated, the output's opens span ``name`` on
  the call stack when the backward reaches the layer and the input's
  closes it when the backward leaves it. Only while recording: off, they
  return their argument and add nothing to autograd's graph.

Off is the default. Off, ``span`` and ``begin`` test one module flag and
return a shared no-op (or None): no clock is read, nothing is kept.
``enable()`` turns recording on, ``disable()`` off, and ``drain()`` hands
out the finished spans and forgets them.
"""
from __future__ import annotations

import itertools
import time
from typing import NamedTuple, Optional

import torch

_on = False
_done: list = []
_stack: list = []
_ids = itertools.count(1)


class Span(NamedTuple):
    name: str
    start: int
    end: int
    id: int
    parent: Optional[int]
    attrs: dict


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> list:
    """The spans finished since the last drain, in the order they ended."""
    global _done
    out, _done = _done, []
    return out


class _Open:
    """A span on the call stack; ``keep`` False only times the block."""

    __slots__ = ("name", "attrs", "keep", "id", "parent", "start", "end")

    def __init__(self, name, attrs, keep):
        self.name, self.attrs, self.keep = name, attrs, keep

    def __enter__(self):
        if self.keep:
            self.parent = _stack[-1] if _stack else None
            self.id = next(_ids)
            _stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        if self.keep:
            _stack.pop()
            _done.append(Span(self.name, self.start, self.end, self.id, self.parent,
                              self.attrs))
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def span(name: str, **attrs):
    """A context manager recording ``name`` around its block when on."""
    if not _on:
        return _NOOP
    return _Open(name, attrs, True)


def timed(name: str, **attrs) -> _Open:
    """A context manager that always times its block (``.seconds``) and
    records it as span ``name`` when on."""
    return _Open(name, attrs, _on)


def begin(name: str, **attrs):
    """Opens a span outside the call stack; the token for ``end``, or None
    when off."""
    if not _on:
        return None
    return (name, time.time_ns(), next(_ids), attrs)


def end(token):
    """Closes a span ``begin`` opened (None: nothing)."""
    if token is None:
        return
    name, start, sid, attrs = token
    _done.append(Span(name, start, time.time_ns(), sid, None, attrs))


class _Mark(torch.autograd.Function):
    """Identity whose backward opens (``opens``) or closes the span held in
    ``box``, a list the two marks of one layer share."""

    @staticmethod
    def forward(ctx, x, name, box, opens):
        ctx.name, ctx.box, ctx.opens = name, box, opens
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.opens:
            if _on:
                ctx.box.append(_Open(ctx.name, {}, True).__enter__())
        elif ctx.box:
            ctx.box.pop().__exit__(None, None, None)
        return g, None, None, None


def _same(x):
    return x


def backward_marks(name: str):
    """(mark_input, mark_output) of one layer's call: see the module's
    docstring. Identity functions that change nothing while off or where
    no gradient is taken."""
    if not (_on and torch.is_grad_enabled()):
        return _same, _same
    box: list = []
    armed: list = []

    def mark_input(x):
        if not x.requires_grad:
            return x
        armed.append(True)
        return _Mark.apply(x, name, box, False)

    def mark_output(y):
        # opened only where the input's mark will close it
        return _Mark.apply(y, name, box, True) if armed and y.requires_grad else y
    return mark_input, mark_output
