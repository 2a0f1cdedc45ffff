"""RG-LRU: the wrapper of the CUDA kernels ``csrc/rglru.cu`` (forward and
backward) and the autograd Function of the recurrence.

Counterpart of ``repro.kernels.rglru.rglru``: x [b, s, w] (the conv'd
input branch), the five f32 [w] gate vectors ``w_a``, ``b_a``, ``w_x``,
``b_x``, ``a_param`` -> (y [b, s, w] in x's dtype, h_last [b, w] f32,
which is ``y[:, -1]`` cast, as in the TPU kernel).  No initial state, as
in the TPU kernel.  The prefill takes the exact f32 state of the last
step instead, as JAX's ``rglru_scan`` returns it (:func:`rglru_prefill`:
the forward kernel writes it beside y).  A CPU tensor takes the plain versions
(:func:`repro_torch.kernels.ref.rglru_states_ref`,
:func:`~repro_torch.kernels.ref.rglru_bwd_ref`); a CUDA tensor launches
the kernels or raises.

The kernels walk time in tiles of ``TILE`` steps (``WARPS`` sub-chunks of
``STEPS``), a block owning ``LANES`` channels of one batch row for the
whole sequence.  JAX has no backward kernel (XLA differentiates
``rglru_scan``'s ``associative_scan``).  The port's backward is a kernel
too: when a gradient is wanted the forward keeps the f32 state entering
each tile, [b, ceil(s / TILE), w] (2 MB a layer at b 2 x s 4096 x
w 4096), and the backward recomputes the gates from x and each tile's h
from its saved state.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (RGLRU_GATES, rglru_bwd_ref,
                                    rglru_states_ref, wide_dtype)

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}
# the kernels' geometry (csrc/rglru.cu)
LANES = 32               # channels a block owns, a lane each
WARPS = 8                # sub-chunks of a time tile, a warp each
STEPS = 8                # steps of a sub-chunk
TILE = WARPS * STEPS     # steps between two saved states


def tiles(s: int) -> int:
    """Time tiles of a sequence of s steps (rows of the saved states)."""
    return -(-s // TILE)


def tile_states(h: torch.Tensor) -> torch.Tensor:
    """The state entering each time tile, [b, tiles(s), w], from the
    states of every step h [b, s, w]: 0 for the first tile, then
    ``h[:, j * TILE - 1]``."""
    b, s, w = h.shape
    return torch.cat([h.new_zeros(b, 1, w), h[:, TILE - 1:s - 1:TILE]], 1)


def _check(x: torch.Tensor, gates: Tuple[torch.Tensor, ...]):
    if x.dim() != 3 or any(g.shape != (x.shape[2],) for g in gates):
        raise ValueError(
            f"rglru: x {tuple(x.shape)} and gates "
            f"{[tuple(g.shape) for g in gates]} do not match [b, s, w] and "
            f"five [w] vectors")


def _cuda_check(what: str, x: torch.Tensor, gates, *more: torch.Tensor):
    """What the kernels take: f32 or bf16 x (and ``more`` in x's dtype
    unless f32 states), f32 gates, contiguity."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} kernel takes f32 or bf16 x, got {x.dtype}")
    if any(g.dtype != torch.float32 for g in gates):
        raise TypeError(f"{what} kernel takes f32 gate vectors, got "
                        f"{[g.dtype for g in gates]}")
    if not all(t.is_contiguous() for t in (x, *gates, *more)):
        raise ValueError(f"{what} kernel takes contiguous tensors")


def _fwd(x, gates, states: bool, last: bool):
    """The forward kernel: (y, the tile-start states if ``states``, the
    last step's f32 state [b, w] if ``last``)."""
    _cuda_check("rglru", x, gates)
    b, s, w = x.shape
    y = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    h0 = torch.empty(b, tiles(s), w, **f32) if states else None
    hl = torch.empty(b, w, **f32) if last else None
    rc = _build.library().repro_rglru_fwd(
        x.data_ptr(), *(g.data_ptr() for g in gates), y.data_ptr(),
        h0.data_ptr() if states else None, hl.data_ptr() if last else None,
        b, s, w, _DTYPES[x.dtype], _build.stream_ptr(x))
    _build.check(rc, "rglru kernel launch")
    _build.LAUNCHES["rglru"] += 1
    return y, h0, hl


def rglru_fwd(x: torch.Tensor, gates: Tuple[torch.Tensor, ...], *,
              states: bool = False):
    """-> (y [b, s, w] in x's dtype, the f32 tile-start states
    [b, tiles(s), w] (:func:`tile_states`) if ``states`` else None).
    ``gates``: the five [w] vectors in ``RGLRU_GATES`` order.  No autograd
    (see :func:`rglru`)."""
    _check(x, gates)
    if _build.on_cpu("rglru", x, *gates):
        h = rglru_states_ref(x, dict(zip(RGLRU_GATES, gates)))
        return h.to(x.dtype), (tile_states(h) if states else None)
    return _fwd(x, gates, states, False)[:2]


def rglru_prefill(x: torch.Tensor, gates: Tuple[torch.Tensor, ...]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rglru_scan``'s (y in x's dtype, the f32 state of the last step
    [b, w]), from h = 0: the forward kernel writing that state beside y
    (one launch), the plain recurrence on the CPU.  No autograd."""
    _check(x, gates)
    if _build.on_cpu("rglru", x, *gates):
        h = rglru_states_ref(x, dict(zip(RGLRU_GATES, gates)))
        return h.to(x.dtype), h[:, -1]
    y, _, hl = _fwd(x, gates, False, True)
    return y, hl


def rglru_bwd(x: torch.Tensor, gates: Tuple[torch.Tensor, ...],
              h0: torch.Tensor, dy: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Gradient of :func:`rglru_fwd`'s y given its tile-start states
    ``h0`` and dy (x's dtype) -> (dx in x's dtype, then the f32 [w]
    gradients of the five gate vectors).  On the CPU the plain backward
    takes the states of every step, recomputed from x."""
    _check(x, gates)
    b, s, w = x.shape
    if h0.shape != (b, tiles(s), w) or dy.shape != x.shape \
            or h0.dtype != wide_dtype(x):
        raise ValueError(
            f"rglru_bwd: h0 {tuple(h0.shape)} {h0.dtype} and dy "
            f"{tuple(dy.shape)} must be {(b, tiles(s), w)} "
            f"{wide_dtype(x)} and {tuple(x.shape)}")
    if _build.on_cpu("rglru_bwd", x, *gates, h0, dy):
        gd = dict(zip(RGLRU_GATES, gates))
        return rglru_bwd_ref(x, gd, rglru_states_ref(x, gd), dy)
    _cuda_check("rglru_bwd", x, gates, h0, dy)
    if dy.dtype != x.dtype:
        raise TypeError(f"rglru_bwd kernel takes dy in x's dtype {x.dtype}, "
                        f"got {dy.dtype}")
    dx = torch.empty_like(x)
    partial = torch.empty(5, b, w, dtype=torch.float32, device=x.device)
    dgates = torch.empty(5, w, dtype=torch.float32, device=x.device)
    rc = _build.library().repro_rglru_bwd(
        x.data_ptr(), *(g.data_ptr() for g in gates), h0.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), partial.data_ptr(), dgates.data_ptr(),
        b, s, w, _DTYPES[x.dtype], _build.stream_ptr(x))
    _build.check(rc, "rglru_bwd kernel launch")
    _build.LAUNCHES["rglru_bwd"] += 1
    return (dx, *dgates.unbind(0))


class RGLRUFunction(torch.autograd.Function):
    """Forward: the RG-LRU kernel (plain version on the CPU), keeping the
    f32 tile-start states when a gradient is wanted; backward: the
    backward kernel (plain version on the CPU).  Saves x, the gates and
    the tile-start states."""

    @staticmethod
    def forward(ctx, x, w_a, b_a, w_x, b_x, a_param):
        gates = (w_a, b_a, w_x, b_x, a_param)
        y, h0 = rglru_fwd(x, gates, states=any(ctx.needs_input_grad))
        if h0 is not None:
            ctx.save_for_backward(x, *gates, h0)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, *gates, h0 = ctx.saved_tensors
        return rglru_bwd(x, tuple(gates), h0, dy.contiguous())


def rglru(x: torch.Tensor, gates: Dict[str, torch.Tensor]
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable RG-LRU with ``repro.kernels.rglru.rglru``'s
    signature: x [b, s, w]; ``gates`` a dict with the five [w] vectors ->
    (y, h_last).  Inputs are made contiguous for the kernels."""
    y = RGLRUFunction.apply(x.contiguous(),
                            *(gates[k].contiguous() for k in RGLRU_GATES))
    return y, y[:, -1].float()
