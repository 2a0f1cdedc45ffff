"""Schedule-phase tracing on ``torch.profiler`` ranges.

JAX has two span flavours with different lifetimes: ``phase_scope``, a
trace-time ``jax.named_scope`` that names the staged ops (the TMP
gather/compute/reduce chunks in XLA profiles, their transposes in the
backward included), and ``trace_annotation``, a host-side
``TraceAnnotation`` (step dispatch, engine tick).  Eager PyTorch has no
trace time: both are ``torch.profiler.record_function`` ranges around
the code that launches the ops.  Both names are kept so that each call
site has its JAX counterpart:

* :func:`phase_scope` — ``tmp.<schedule>.{row_matmul,gather_matmul,
  sub<j>}`` (``core/schedule.py``);
* :func:`trace_annotation` — ``train_step``, ``engine_tick``.

A ``record_function`` costs a dispatcher call on entry and on exit even
when no profiler records (9-11 us a range on one CPU core against
0.5-0.6 us for the gated range: ``tools/range_cost.py``), and a decode
tick of a 64-layer model enters 64 of them, a training step hundreds.
So a range is opened only while a profiler records; otherwise both
return a shared null context (one flag read).

The backward: the autograd engine runs the backward of a forward range's
ops after the range has closed.  :func:`scoped` runs a function under
:func:`phase_scope` and, while a profiler records with autograd on,
opens the same named range when the gradients reach the function's
outputs and closes it when they leave through its inputs, so the
backward's products and collectives are attributed too.  The engine
runs ready nodes latest-created first, so the nodes between the two
marks are the function's own (a node that a gradient reaches only by
another path may run inside; none does on the schedules' parts).
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch
from torch.autograd import profiler as _profiler

from repro_torch.core.comm import Pending
from repro_torch.obs.recorder import _NULL_SPAN


def phase_scope(name: str):
    """Name the ops launched inside the block (profile-visible)."""
    if not _profiler._is_profiler_enabled:
        return _NULL_SPAN
    return torch.profiler.record_function(name)


def trace_annotation(name: str):
    """Host-side profiler region (a step, an engine tick): the same range
    as :func:`phase_scope`, under JAX's name for it."""
    return phase_scope(name)


class _RangeOpen(torch.autograd.Function):
    """Identity on a function's outputs; its backward opens the range."""

    @staticmethod
    def forward(ctx, name, box, *ys):
        ctx.name, ctx.box = name, box
        return ys

    @staticmethod
    def backward(ctx, *gs):
        ctx.box.append(torch.ops.profiler._record_function_enter_new(
            ctx.name, None))
        return (None, None) + gs


class _RangeClose(torch.autograd.Function):
    """Identity on a function's inputs; its backward closes the range."""

    @staticmethod
    def forward(ctx, box, *xs):
        ctx.box = box
        return xs

    @staticmethod
    def backward(ctx, *gs):
        if ctx.box:
            torch.ops.profiler._record_function_exit._RecordFunction(
                ctx.box.pop())
        return (None,) + gs


def _tensor_leaves(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, Pending):
        return [out.result]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensor_leaves(o)]
    return []


def _rebuild(out, it):
    if isinstance(out, torch.Tensor):
        return next(it)
    if isinstance(out, Pending):
        # the handle's wait still finishes the collective; it then hands
        # back the marked tensor, a view of the one the collective fills
        return Pending(next(it), out.wait)
    if isinstance(out, (tuple, list)):
        return type(out)(_rebuild(o, it) for o in out)
    return out


def scoped(name: str, fn: Callable[..., Any], *args):
    """``fn(*args)`` under :func:`phase_scope` ``(name)``; while a profiler
    records, the backward from ``fn``'s outputs (tensors, tuples of them
    or a :class:`~repro_torch.core.comm.Pending`) to its tensor
    arguments that require grad runs under the same named range."""
    if not _profiler._is_profiler_enabled:
        return fn(*args)
    with torch.profiler.record_function(name):
        marked = [i for i, a in enumerate(args)
                  if isinstance(a, torch.Tensor) and a.requires_grad]
        if not (torch.is_grad_enabled() and marked):
            return fn(*args)
        box: list = []
        args = list(args)
        for i, t in zip(marked, _RangeClose.apply(
                box, *(args[i] for i in marked))):
            args[i] = t
        out = fn(*args)
        ys = _tensor_leaves(out)
        grad = [i for i, y in enumerate(ys) if y.requires_grad]
        if not grad:
            return out
        for i, y in zip(grad, _RangeOpen.apply(
                name, box, *(ys[i] for i in grad))):
            ys[i] = y
        return _rebuild(out, iter(ys))
