"""Ring attention: sequence-parallel attention whose KV shards circulate
the tensor-parallel group (``repro.kernels.ring_attention``).

q stays sequence-local; every rank's K/V shard is folded, one shard at a
time, into an online-softmax carry.  Positions are absolute (default: the
contiguous shard ``rank * s_local + arange(s_local)``; padding rows carry
-1), causal / window / softcap masks apply elementwise, and a shard that
no (query, key) pair of this rank can see is skipped (JAX's
``_step_needed``).

* :func:`ring_forward_plain` — the plain ring over ``comm.ring_shift``
  (JAX's ``_ring_forward``): after s hops rank i holds shard
  ``(i - s) mod n`` (the port's rings shift to ``rank + 1``; JAX's to
  ``rank - 1``: the same shards in another order, exact up to f32
  rounding).  -> (out, lse [b, h, sq] f32).
* :func:`ring_forward_kernel` — the CUDA kernel ``csrc/ring_attention.cu``
  (the port of ``_ring_attn_kernel``): each rank publishes its K/V shard
  into its peer workspace, and every block reads the shards it needs
  through the peer pointers.  Contiguous positions only, as the TPU
  kernel (``ring_attention.py:232-233``).
* :func:`ring_backward_plain` — the reverse ring (JAX's
  ``_ring_backward``), in torch ops on every device: dQ accumulates
  locally, dK and dV travel with their shard and are home after n hops.
  JAX has no backward kernel here, so the port adds none.

:func:`ring_attention` is differentiable through
:class:`RingAttentionFunction` (a ctypes launch outside an autograd
Function would drop its gradient on the card).  On a CUDA tensor the
forward always launches the kernel; positions other than the contiguous
shard raise there, and nothing falls back to the plain ring.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.comm import Comm
from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, Q_CHUNK

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}
HEAD_DIMS = (32, 64, 128)


def backend(comm: Comm) -> str:
    """``ref`` for a group of one (the one-shard ring, CPU tensors only)
    or ``ring`` (JAX's ``backend`` without the TPU's ``pallas``: on the
    card the ring's forward is the kernel)."""
    return "ref" if comm.size <= 1 else "ring"


# --------------------------------------------------------------------------
# positions and block masks
# --------------------------------------------------------------------------
def contiguous_positions(rank: int, b: int, s: int,
                         device) -> torch.Tensor:
    """[b, s] int: shard ``rank`` of ``arange(n * s)``."""
    return (rank * s + torch.arange(s, device=device))[None].expand(b, s)


def _as_positions(pos: Optional[torch.Tensor], rank: int, b: int, s: int,
                  device) -> torch.Tensor:
    if pos is None:
        return contiguous_positions(rank, b, s, device)
    if pos.dim() == 1:
        pos = pos[None]
    return pos.to(device=device, dtype=torch.int64).expand(b, s).contiguous()


def check_kernel_positions(q_positions: Optional[torch.Tensor],
                           kv_positions: Optional[torch.Tensor], rank: int,
                           sq: int, sk: int):
    """Raise unless the positions are the contiguous shards the kernel
    assumes (None, or ``rank * s + arange(s)`` on every row)."""
    for name, pos, s in (("q_positions", q_positions, sq),
                         ("kv_positions", kv_positions, sk)):
        if pos is None:
            continue
        want = rank * s + torch.arange(s, device=pos.device)
        if pos.shape[-1] != s or not bool((pos == want).all()):
            raise NotImplementedError(
                f"ring_attention kernel: {name} other than the contiguous "
                f"shard rank * {s} + arange({s}) (the TPU kernel assumes "
                f"them too, ring_attention.py:232); padded or permuted "
                f"positions run only on the CPU")


def _valid(qp: torch.Tensor, pb: torch.Tensor, causal: bool,
           window: Optional[int]) -> torch.Tensor:
    """qp [b, c], pb [b, sk] -> [b, 1, 1, c, sk] bool (JAX's
    ``_valid_mask``)."""
    pbb = pb[:, None, None, None, :]
    qpb = qp[:, None, None, :, None]
    valid = pbb >= 0
    if causal:
        valid = valid & (pbb <= qpb)
    if window is not None:
        valid = valid & (pbb > qpb - window)
    return valid


def _step_needed(qp: torch.Tensor, pb: torch.Tensor, causal: bool,
                 window: Optional[int]) -> bool:
    """False iff no (query, key) pair of this block can attend (JAX's
    ``_step_needed``, range-based and conservative)."""
    live = pb >= 0
    if not bool(live.any()):
        return False
    if causal and int(pb[live].min()) > int(qp.max()):
        return False
    if window is not None and int(pb.max()) <= int(qp.min()) - window:
        return False
    return True


def _shard_needed(src: int, idx: int, sq: int, sk: int, causal: bool,
                  window: Optional[int]) -> bool:
    """:func:`_step_needed` for contiguous shards, from their offsets (no
    tensor read, so no device synchronisation on the card)."""
    if causal and src * sk > idx * sq + sq - 1:
        return False
    if window is not None and src * sk + sk - 1 <= idx * sq - window:
        return False
    return True


def _heads(t: torch.Tensor, kvh: int) -> torch.Tensor:
    """[b, s, h, hd] -> f32 [b, kvh, g, s, hd]."""
    b, s, h, hd = t.shape
    return t.float().reshape(b, s, kvh, h // kvh, hd).permute(0, 2, 3, 1, 4)


def _kv(t: torch.Tensor) -> torch.Tensor:
    """[b, sk, kvh, hd] -> f32 [b, kvh, 1, sk, hd]."""
    return t.float().permute(0, 2, 1, 3)[:, :, None]


def _shift(comm: Comm, *ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """One hop of same-dtype tensors of one shape, in one ring shift."""
    if len(ts) == 1:
        return (comm.ring_shift(ts[0]),)
    return tuple(comm.ring_shift(torch.stack(ts)).unbind(0))


# --------------------------------------------------------------------------
# the plain ring
# --------------------------------------------------------------------------
def ring_forward_plain(q, k, v, comm: Comm, *, causal: bool = True,
                       window: Optional[int] = None, softcap: float = 0.0,
                       scale: float, q_positions=None, kv_positions=None):
    """One rank's ring forward over ``comm.ring_shift``: q [b, sq, h, hd];
    k, v [b, sk, kvh, hd] -> (out [b, sq, h, hd] in q's dtype, lse
    [b, h, sq] f32 = m + log(l), l floored at 1e-30).  Blocks are cut into
    ``Q_CHUNK`` query rows (the f32 scores stay [b, h, Q_CHUNK, sk]).
    Implicit positions ride the ring as the source index (and the block
    skip reads no tensor); explicit ones hop with their shard."""
    n, idx = comm.size, comm.rank
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    dev = q.device
    implicit = q_positions is None and kv_positions is None
    qp = _as_positions(q_positions, idx, b, sq, dev)
    qs = _heads(q, kvh) * scale                      # [b, kvh, g, sq, hd]
    acc = torch.zeros(b, kvh, g, sq, hd, dtype=torch.float32, device=dev)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(b, kvh, g, sq, dtype=torch.float32, device=dev)
    kb, vb = k, v
    pb = None if kv_positions is None else _as_positions(
        kv_positions, idx, b, sk, dev)
    for s in range(n):
        src = (idx - s) % n
        pbs = contiguous_positions(src, b, sk, dev) if pb is None else pb
        if (_shard_needed(src, idx, sq, sk, causal, window) if implicit
                else _step_needed(qp, pbs, causal, window)):
            kf, vf = _kv(kb), _kv(vb)
            for q0 in range(0, sq, Q_CHUNK):
                c = slice(q0, min(q0 + Q_CHUNK, sq))
                sc = torch.matmul(qs[:, :, :, c], kf.transpose(-1, -2))
                if softcap:
                    sc = softcap * torch.tanh(sc / softcap)
                sc = torch.where(_valid(qp[:, c], pbs, causal, window), sc,
                                 torch.full_like(sc, NEG_INF))
                m_new = torch.maximum(m[..., c], sc.amax(dim=-1))
                p = torch.exp(sc - m_new[..., None])
                corr = torch.exp(m[..., c] - m_new)
                l[..., c] = l[..., c] * corr + p.sum(dim=-1)
                acc[:, :, :, c] = (acc[:, :, :, c] * corr[..., None]
                                   + torch.matmul(p, vf))
                m[..., c] = m_new
        if s < n - 1:
            kb, vb = _shift(comm, kb, vb)
            if pb is not None:
                (pb,) = _shift(comm, pb)
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).permute(0, 3, 1, 2, 4)
    return (out.reshape(b, sq, h, hd).to(q.dtype),
            (m + torch.log(l_safe)).reshape(b, h, sq))


def ring_backward_plain(q, k, v, out, lse, dout, comm: Comm, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: float = 0.0, scale: float,
                        q_positions=None, kv_positions=None):
    """The reverse ring (JAX's ``_ring_backward``) in f32 torch ops, one
    ``Q_CHUNK`` of query rows at a time: P is recomputed from ``lse``,
    ``delta = rowsum(dout * out)``, dS is damped by ``1 - tanh^2`` under a
    softcap.  dQ accumulates here; each shard's dK/dV travel with it and
    reach home at the n-th hop.  -> (dq, dk, dv) in the inputs' dtypes."""
    n, idx = comm.size, comm.rank
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    dev = q.device
    implicit = q_positions is None and kv_positions is None
    qp = _as_positions(q_positions, idx, b, sq, dev)
    qs = _heads(q, kvh) * scale
    dof = _heads(dout, kvh)
    delta = (dof * _heads(out, kvh)).sum(dim=-1)     # [b, kvh, g, sq]
    lse5 = lse.reshape(b, kvh, g, sq)
    dq = torch.zeros(b, kvh, g, sq, hd, dtype=torch.float32, device=dev)
    kb, vb = k, v
    dkb = torch.zeros(b, kvh, sk, hd, dtype=torch.float32, device=dev)
    dvb = torch.zeros_like(dkb)
    pb = None if kv_positions is None else _as_positions(
        kv_positions, idx, b, sk, dev)
    for s in range(n):
        src = (idx - s) % n
        pbs = contiguous_positions(src, b, sk, dev) if pb is None else pb
        if (_shard_needed(src, idx, sq, sk, causal, window) if implicit
                else _step_needed(qp, pbs, causal, window)):
            kf, vf = _kv(kb), _kv(vb)
            for q0 in range(0, sq, Q_CHUNK):
                c = slice(q0, min(q0 + Q_CHUNK, sq))
                z = torch.matmul(qs[:, :, :, c], kf.transpose(-1, -2))
                if softcap:
                    t = torch.tanh(z / softcap)
                    z = softcap * t
                p = torch.where(_valid(qp[:, c], pbs, causal, window),
                                torch.exp(z - lse5[..., c, None]),
                                torch.zeros_like(z))
                dp = torch.matmul(dof[:, :, :, c], vf.transpose(-1, -2))
                ds = p * (dp - delta[..., c, None])
                if softcap:
                    ds = ds * (1.0 - t * t)
                dq[:, :, :, c] += torch.matmul(ds, kf) * scale
                dkb += torch.matmul(ds.transpose(-1, -2),
                                    qs[:, :, :, c]).sum(dim=2)
                dvb += torch.matmul(p.transpose(-1, -2),
                                    dof[:, :, :, c]).sum(dim=2)
        if s < n - 1:
            kb, vb = _shift(comm, kb, vb)
            if pb is not None:
                (pb,) = _shift(comm, pb)
        dkb, dvb = _shift(comm, dkb, dvb)    # the n-th hop brings them home
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)
    return (dq, dkb.permute(0, 2, 1, 3).to(k.dtype),
            dvb.permute(0, 2, 1, 3).to(v.dtype))


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------
def _check_shapes(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(
            f"ring_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} do not match [b, sq, h, hd] and "
            f"[b, sk, kvh, hd] with kvh | h")
    if window is not None and window < 1:
        raise ValueError(f"ring_attention: window {window} < 1")


def _kv_slot_bytes(k: torch.Tensor) -> int:
    """Bytes one call publishes into its peer workspace slot: K, then V
    at the next 256-byte boundary."""
    return 2 * ((k.numel() * k.element_size() + 255) // 256 * 256)


def ring_forward_kernel(q, k, v, comm: Comm, *, causal: bool = True,
                        window: Optional[int] = None, softcap: float = 0.0,
                        scale: float):
    """One rank's call of the ring-attention kernel over the peer
    workspaces of ``comm`` (a :class:`~repro_torch.core.comm.PeerComm`):
    -> (out [b, sq, h, hd] in q's dtype, lse [b, h, sq] f32).  Contiguous
    positions; runs on the communicator's stream, like every peer kernel,
    so the peer kernels of a rank run in program order."""
    from repro_torch.core.comm import peer_comm
    comm = peer_comm(comm)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"ring_attention kernel takes f32 or bf16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"ring_attention kernel supports hd in "
                         f"{HEAD_DIMS}, got {hd}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("ring_attention kernel takes contiguous, 16-byte "
                         "aligned q, k, v")
    if _kv_slot_bytes(k) > comm.ws.slot_bytes:
        raise ValueError(
            f"ring_attention: a K/V shard of {_kv_slot_bytes(k)} bytes does "
            f"not fit an attention slot of {comm.ws.slot_bytes} bytes")
    out = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    comm.attn_epoch += 1
    comm.ws.check()
    with torch.cuda.stream(comm.begin()):
        rc = _build.library().repro_ring_attention(
            comm.ws.ptrs.data_ptr(), ctypes.addressof(comm.ws.host_ptrs),
            comm.rank, comm.size, comm.ws.slot_bytes,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, sq, sk, h, kvh, hd, int(causal), window or 0,
            scale, softcap, comm.attn_epoch, _DTYPES[q.dtype],
            comm.ws.err_dev, comm.stream.cuda_stream)
    _build.check(rc, "ring_attention kernel launch")
    _build.LAUNCHES["ring_attention"] += 1
    torch.cuda.current_stream(q.device).wait_event(comm.end(q, k, v, out,
                                                            lse))
    return out, lse


def ring_forward(q, k, v, comm: Comm, *, causal: bool = True,
                 window: Optional[int] = None, softcap: float = 0.0,
                 scale: float, q_positions=None, kv_positions=None):
    """(out, lse) of one rank: the kernel on CUDA tensors (contiguous
    positions only), the plain ring on CPU tensors."""
    if _build.on_cpu("ring_attention", q, k, v):
        return ring_forward_plain(q, k, v, comm, causal=causal,
                                  window=window, softcap=softcap, scale=scale,
                                  q_positions=q_positions,
                                  kv_positions=kv_positions)
    check_kernel_positions(q_positions, kv_positions, comm.rank, q.shape[1],
                           k.shape[1])
    return ring_forward_kernel(q, k, v, comm, causal=causal, window=window,
                               softcap=softcap, scale=scale)


class RingAttentionFunction(torch.autograd.Function):
    """Forward: :func:`ring_forward` (the kernel on the card), or under
    fine recomputation's replay the ``out`` and ``lse`` its first run
    kept (``keep``, :class:`repro_torch.core.remat.Keep`): the replay
    neither launches the kernel nor runs the ring.  Backward: the reverse
    ring.  Saves q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, comm, opts, keep):
        def run():
            return ring_forward(q, k, v, comm, q_positions=q_positions,
                                kv_positions=kv_positions, **opts)
        out, lse = keep.value(run) if keep is not None else run()
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.positions = (q_positions, kv_positions)
        ctx.comm, ctx.opts = comm, opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        qp, kvp = ctx.positions
        dq, dk, dv = ring_backward_plain(q, k, v, out, lse,
                                         dout.contiguous(), ctx.comm,
                                         q_positions=qp, kv_positions=kvp,
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   comm: Comm, causal: bool = True,
                   window: Optional[int] = None, softcap: float = 0.0,
                   scale: Optional[float] = None,
                   q_positions: Optional[torch.Tensor] = None,
                   kv_positions: Optional[torch.Tensor] = None,
                   keep=None) -> torch.Tensor:
    """Sequence-sharded attention over the ring of ``comm`` (JAX's
    ``ring_attention``): q [b, sq, h, hd]; k, v [b, sk, kvh, hd];
    positions ABSOLUTE ([b, s] or [s]; default the contiguous shard of
    ``arange``; padding KV rows -1) -> [b, sq, h, hd], differentiable.
    ``keep``: fine recomputation's state of the enclosing part."""
    _check_shapes(q, k, v, window)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    opts = dict(causal=causal, window=window, softcap=float(softcap),
                scale=scale)
    if backend(comm) == "ref" \
            and not _build.on_cpu("ring_attention", q, k, v):
        raise ValueError("ring_attention on the card needs a PeerComm "
                         "group of two or more ranks")
    return RingAttentionFunction.apply(q, k, v, q_positions, kv_positions,
                                       comm, opts, keep)
