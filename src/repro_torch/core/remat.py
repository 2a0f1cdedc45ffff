"""Recomputation policies (paper §3.2), ``repro.core.remat`` in eager
PyTorch.

* ``coarse`` — Megatron/Merak: the whole layer runs under one
  checkpoint, so its backward replays the layer's forward, **the TMP
  collectives included** (2 all-reduces per sub-batch).  Early stopping of
  the replay is off, so the replay is the whole layer, as in the paper.
* ``fine``   — Oases: each part (its body and its row-parallel exit)
  runs under a checkpoint whose replay stops short of the exit: the exit
  (:meth:`~repro_torch.core.schedule.TmpCtx.row_matmul`) saves only its
  input and weight, so the replay recomputes the body and skips the exit
  product and its collective.  What is kept is each part's input (the
  residual stream; the collective's output only feeds the residual add
  after it), and the replay contains no collective.  A collective inside
  a body (the y sums of a 2-D entry, ring attention) keeps its output
  in the first run (:class:`Keep`) and hands it back in the replay.
  JAX gets the same from ``save_only_these_names`` on the collective
  outputs.
* ``none``   — nothing is recomputed.

``merak`` always takes ``coarse`` (Fig. 3b); the other schedules take
``fine`` when ``fine_remat`` is set (JAX's default) and ``coarse``
otherwise.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.core.comm import Pending


def policy(schedule: str, *, remat: bool, fine: bool) -> str:
    """``none``, ``coarse`` or ``fine`` for a schedule and TrainHParams'
    ``remat`` / ``fine_remat``."""
    if not remat:
        return "none"
    if schedule == "merak" or not fine:
        return "coarse"
    return "fine"


class Keep:
    """The state one checkpointed part shares between its first run and
    its replay: ``replay`` is False in the first run and True in the
    replay, and :meth:`value` hands an op's result from the first to the
    second, call by call in program order.  The part's closure lives
    until the backward, so it keeps only what the replay must not
    recompute (the outputs of the collectives inside the body: ring
    attention's out and lse, a 2-D entry's y sums), and never the first
    run's exit handle: that would keep the exit's output alive."""

    def __init__(self):
        self.replay = False
        self._kept: List[Tuple[torch.Tensor, ...]] = []
        self._next = 0

    def rewind(self):
        """Start a run of the part: the replay hands the kept values back
        from the first."""
        self._next = 0

    def value(self, compute: Callable[[], Tuple[torch.Tensor, ...]]
              ) -> Tuple[torch.Tensor, ...]:
        """``compute()`` in the first run, kept (detached); the kept
        tensors in the replay, which computes nothing."""
        if self.replay:
            self._next += 1
            return self._kept[self._next - 1]
        out = compute()
        self._kept.append(tuple(t.detach() for t in out))
        return out


def kept(keep: Optional[Keep], compute: Callable[[], torch.Tensor]
         ) -> torch.Tensor:
    """``compute()``, through ``keep`` (:meth:`Keep.value`) when a fine
    checkpoint runs the part (``keep`` not None)."""
    if keep is None:
        return compute()
    return keep.value(lambda: (compute(),))[0]


def checkpoint_part(run: Callable[..., Pending], *args) -> Pending:
    """Fine recomputation of one part: ``run(keep, *args)`` returns the
    part's exit handle (:meth:`~repro_torch.core.schedule.TmpCtx.
    row_matmul`).  It runs once under a checkpoint, and the backward
    replays it with ``keep.replay`` set, which skips the exit product and
    its collective (and hands kept values to the ops that asked).  The
    handle waits for the first run's collective."""
    keep = Keep()
    box: List[Pending] = []

    def once(*a):
        keep.rewind()
        pend = run(keep, *a)
        if not keep.replay:
            keep.replay = True
            box.append(pend)
        return pend.result

    y = checkpoint(once, *args, use_reentrant=False)
    return Pending(y, box.pop().wait)


def checkpoint_body(body: Callable, *args):
    """Fine recomputation of an exit-less part (the MoE FFN at tp=1, whose
    reduce is the identity): ``body(*args, None)`` runs under a checkpoint
    and its replay recomputes the whole body, as JAX's policy, which keeps
    only the collective outputs, does."""
    return checkpoint(body, *args, None, use_reentrant=False)


def checkpoint_layer(layer: Callable, *args):
    """Run a whole layer under a checkpoint whose replay is the whole
    layer, collectives included (coarse recomputation)."""
    with set_checkpoint_early_stop(False):
        return checkpoint(layer, *args, use_reentrant=False)
