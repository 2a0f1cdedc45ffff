"""Roofline terms of one rank's training step: the port's counterpart of
``repro.launch.hlo_cost``.

The port has no HLO: there is no compiled module to walk.  The counter
traces the step instead.  It runs the step function under
``FakeTensorMode`` on CPU fake tensors (nothing is allocated or computed,
so a full-width step traces on a laptop; the kernel wrappers take their
CPU branch) and a ``TorchDispatchMode`` sees every aten op the step
executes: forward, autograd backward and the optimizer.  It accumulates
JAX's three terms:

* dot flops  (2 * numel(out) * contracted size of every ``mm``,
             ``addmm``, ``bmm``, ``baddbmm`` and ``mv``; ``matmul`` and
             ``einsum`` reach the mode as these);
* HBM bytes  (each op's tensor operands and outputs once; views cost
             nothing; an op that only writes its destination, such as
             ``copy_`` into a slice, is charged the slice it writes, not
             the buffer behind it, and an in-place update reads and
             writes the slice it was given: JAX's in-place correction,
             ``hlo_cost.py:257-294``, whose O(L^2) over-count has its
             counterpart here in the stacked layer leaves);
* per-rank collective bytes (each op of a
             :class:`~repro_torch.core.comm.TraceComm` with JAX's ring
             factors, :func:`_collective_cost`; ``ring_shift`` is a
             collective-permute).

A step runs in a Python loop, so each microbatch and layer is counted as
it runs: there is no trip count to multiply (:meth:`Tracer.run` with
``micro`` extrapolates the microbatches of a long step from three).

**Kernels as units.**  A call of a kernel wrapper is one unit, as an HLO
fusion is one op in JAX's walker: its bytes and flops are the
``kernels/bounds.py`` work counts of its shapes (each input read once,
each output written once, whatever the plain version does inside), and
its collectives those of the card's kernel.  The count with kernels as
units (``dot_flops``, ``hbm_bytes``) stays the same whatever implements a
kernel: it is the roofline count.  With ``plain=True`` the units also run
their plain versions, whose products are then counted as executed
(``plain_dot_flops``): the count held against JAX's ``dot_flops``, whose
step computes these functions in ``jnp``.  Otherwise a unit returns empty
outputs of the right shapes and the trace is faster.  Where the card's
branch of a function differs from the CPU's (the ring all-gathers of the
``fused`` exit and of the SP entry), the trace takes the card's.

**Memory.**  The bytes of the step's arguments (this rank's params,
optimizer state and batch), the peak of the live tensors the step
allocates beyond them (a unit's outputs, not its plain version's
intermediates), its outputs, and the argument bytes updated in place
(JAX's ``alias_bytes``: the port updates params and state in place).
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.kernels import bounds

# JAX's dtype table (``repro.launch.hlo_cost.DTYPE_BYTES``), copied
DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1,
    "f8e5m2": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "token": 0, "opaque": 0,
}
# torch's dtypes under their HLO names
HLO_DTYPES = {torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
              torch.int16: "s16", torch.bfloat16: "bf16",
              torch.float16: "f16", torch.int32: "s32",
              torch.float32: "f32", torch.int64: "s64",
              torch.float64: "f64", torch.complex64: "c64",
              torch.complex128: "c128"}

# a Comm op's kind in JAX's HLO
COMM_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
              "reduce_scatter": "reduce-scatter",
              "ring_shift": "collective-permute"}


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * DTYPE_BYTES[HLO_DTYPES[t.dtype]]


def _collective_cost(kind: str, size: float, n: int) -> Tuple[float, float]:
    """-> (payload_bytes, per_rank_link_bytes) with JAX's ring factors
    (``repro.launch.hlo_cost._collective_cost``, copied): ``size`` is the
    payload as the HLO states it (the all-gather's gathered output, the
    reduce-scatter's scattered output)."""
    n = max(n, 1)
    if kind.startswith("all-reduce"):
        return size, 2.0 * size * (n - 1) / n
    if kind.startswith("all-gather"):
        return size, size * (n - 1) / n            # size = gathered output
    if kind.startswith("reduce-scatter"):
        return size, size * (n - 1)                # size = scattered output
    if kind.startswith("all-to-all") or kind.startswith("ragged"):
        return size, size * (n - 1) / n
    if kind.startswith("collective"):
        return size, size
    return 0.0, 0.0


@dataclass
class HloCost:
    """JAX's fields and ``to_dict`` keys; the port's extra readings
    (``plain_dot_flops``, ``torch_flops``, ``units``, ``products``,
    ``mem``, ``dot_by_dtype``, ``collective_ops``: (kind, payload,
    group) -> count) stay out of ``to_dict``."""
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_link_bytes: float = 0.0
    collective_payload_bytes: float = 0.0
    collective_counts: Dict[str, int] = field(default_factory=dict)
    collective_by_kind: Dict[str, float] = field(default_factory=dict)
    plain_dot_flops: float = 0.0
    plain_hbm_bytes: float = 0.0
    torch_flops: float = 0.0
    units: Dict[str, Dict[str, float]] = field(default_factory=dict)
    products: Dict[Tuple, float] = field(default_factory=dict)
    mem: Dict[str, int] = field(default_factory=dict)
    dot_by_dtype: Dict[str, float] = field(default_factory=dict)
    collective_ops: Dict[Tuple, float] = field(default_factory=dict)

    def to_dict(self):
        return {
            "dot_flops": self.dot_flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_link_bytes": self.collective_link_bytes,
            "collective_payload_bytes": self.collective_payload_bytes,
            "collective_counts": dict(self.collective_counts),
            "collective_by_kind": dict(self.collective_by_kind),
        }

    def roofline_seconds(self, *, peak_flops: float, hbm_bw: float,
                         link_bw: float, mxu_eff: float = 1.0) -> Dict:
        """Roofline step-time estimate from the extracted HLO terms.

        ``serial_s`` charges compute + comm back-to-back (a blocking
        schedule); ``overlapped_s`` is the fused/collective-matmul bound
        ``max(T_compute, T_comm)`` — comm below the compute roofline is
        free when the kernel streams tiles into the ring.  The gap between
        the two is the step time a fused schedule can recover.
        """
        t_compute = max(self.dot_flops / max(peak_flops * mxu_eff, 1.0),
                        self.hbm_bytes / max(hbm_bw, 1.0))
        t_comm = self.collective_link_bytes / max(link_bw, 1.0)
        return {
            "compute_s": t_compute,
            "comm_s": t_comm,
            "serial_s": t_compute + t_comm,
            "overlapped_s": max(t_compute, t_comm),
        }


# --------------------------------------------------------------------------
# kernel units: work counts and output shapes
# --------------------------------------------------------------------------
def _wide(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _elt(x: torch.Tensor) -> int:
    return x.element_size()


def _overlap(q0: int, sq: int, k0: int, sk: int, causal: bool,
             window: Optional[int]) -> int:
    """(query, key) pairs of a head that may attend between the query
    positions [q0, q0 + sq) and the key positions [k0, k0 + sk)."""
    if not causal and window is None:
        return sq * sk
    total = 0
    for p in range(q0, q0 + sq):
        hi = min(p, k0 + sk - 1) if causal else k0 + sk - 1
        lo = k0 if window is None else max(k0, p - window + 1)
        total += max(0, hi - lo + 1)
    return total


@dataclass
class Work:
    """What a unit charges: bytes, product flops (``dot``), other
    operations (``ops``) and its collectives as (kind, payload, group)."""
    nbytes: float
    dot: float = 0.0
    ops: float = 0.0
    collectives: List[Tuple[str, float, int]] = field(default_factory=list)


def _rmsnorm_fwd(x, scale, *, eps=1e-5):
    d = x.shape[-1]
    nb, ops = bounds.rmsnorm_work(x.numel() // max(d, 1), d, _elt(x))
    return Work(nb, ops=ops), lambda: x.new_empty(x.shape)


def _rmsnorm_bwd(x, scale, dy, *, eps=1e-5):
    d = x.shape[-1]
    nb, ops = bounds.rmsnorm_bwd_work(x.numel() // max(d, 1), d, _elt(x))
    return Work(nb, ops=ops), lambda: (x.new_empty(x.shape),
                                       scale.new_empty(scale.shape))


def _flash_pairs(s, causal, window, sk=None):
    sk = s if sk is None else sk
    if causal and sk == s:
        return bounds.visible_pairs(s, window)
    return _overlap(0, s, 0, sk, causal, window)


def _flash_fwd(q, k, v, *, causal=True, window=None, softcap=0.0,
               scale=None):
    b, s, h, hd = q.shape
    sk = k.shape[1]
    (nb, fl), _ = bounds.flash_work(b, s, h, k.shape[2], hd,
                                    _flash_pairs(s, causal, window, sk),
                                    _elt(q), sk)
    return Work(nb, dot=fl), lambda: (
        q.new_empty(q.shape), q.new_empty((b, h, s), dtype=_wide(q)))


def _flash_bwd(q, k, v, out, lse, dout, *, causal=True, window=None,
               softcap=0.0, scale=None):
    b, s, h, hd = q.shape
    sk = k.shape[1]
    _, (nb, fl) = bounds.flash_work(b, s, h, k.shape[2], hd,
                                    _flash_pairs(s, causal, window, sk),
                                    _elt(q), sk)
    return Work(nb, dot=fl), lambda: (q.new_empty(q.shape),
                                      k.new_empty(k.shape),
                                      v.new_empty(v.shape))


def _paged_decode(q, k_pages, v_pages, tables, pos, *, softcap=0.0,
                  scale=None):
    """Fake positions cannot be read: every slot is charged its table's
    whole capacity (a bound above the data's work)."""
    b, _, h, hd = q.shape
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    cap = tables.shape[1] * page
    nb, fl = bounds.paged_decode_work(b, h, kvh, hd, b * cap, b * cap,
                                      tables.numel(), _elt(q))
    return Work(nb, dot=fl), lambda: q.new_empty(q.shape)


def _tile_matmul(x, w, **kw):
    (m, k), n = x.shape, w.shape[1]
    nb, fl = bounds.gemm_work(m, k, n, _elt(x))
    return Work(nb, dot=fl), lambda: x.new_empty((m, n))


def _ring_matmul_rs(x, w, comm, scatter_dim):
    """The ring kernel (``csrc/ring_matmul_rs.cu``): every row of x times
    w, this rank's chunk written; its n - 1 hops carry f32 partial
    chunks."""
    n, k, d = comm.size, x.shape[-1], w.shape[1]
    rows = x.numel() // k
    chunk = rows // n
    shape = list(x.shape)
    shape[scatter_dim] //= n
    shape[-1] = d
    work = Work((x.numel() + k * d + chunk * d) * _elt(x),
                dot=2 * rows * k * d,
                collectives=[("collective-permute", chunk * d * 4, n)]
                * (n - 1))
    return work, lambda: x.new_empty(shape)


def _ring_geometry(q, k, comm, causal, window, q_positions, kv_positions):
    """(KV shards this rank reads, visible pairs a head, extra hop bytes)
    of the contiguous shards (explicit positions are charged as the
    contiguous ones; they hop beside their shard)."""
    n, idx = comm.size, comm.rank
    sq, sk = q.shape[1], k.shape[1]
    shards = pairs = 0
    for src in range(n):
        p = _overlap(idx * sq, sq, src * sk, sk, causal, window)
        shards += p > 0
        pairs += p
    extra = 0 if kv_positions is None else k.shape[0] * sk * 8
    return shards, pairs, extra


def _ring_fwd(q, k, v, comm, *, causal=True, window=None, softcap=0.0,
              scale=None, q_positions=None, kv_positions=None):
    """The ring-attention kernel (``csrc/ring_attention.cu``), charged with
    the ring's n - 1 hops of the stacked K/V shard (JAX's ring)."""
    b, sq, h, hd = q.shape
    n, kvh = comm.size, k.shape[2]
    shards, pairs, extra = _ring_geometry(q, k, comm, causal, window,
                                          q_positions, kv_positions)
    nb, fl = bounds.ring_attention_work(b, sq, h, kvh, hd, shards, pairs,
                                        _elt(q))
    hop = [("collective-permute", 2 * tensor_bytes(k), n)]
    if extra:
        hop.append(("collective-permute", extra, n))
    return Work(nb, dot=fl, collectives=hop * (n - 1)), lambda: (
        q.new_empty(q.shape), q.new_empty((b, h, sq), dtype=torch.float32))


def _ring_bwd(q, k, v, out, lse, dout, comm, *, causal=True, window=None,
              softcap=0.0, scale=None, q_positions=None, kv_positions=None):
    """The reverse ring: 8 hd flops a visible pair and head; reads q, out,
    dout, lse and each needed K/V shard, writes dq and the shard's dK/dV;
    n - 1 hops of the stacked K/V and n of the f32 dK/dV."""
    b, sq, h, hd = q.shape
    n, kvh = comm.size, k.shape[2]
    shards, pairs, extra = _ring_geometry(q, k, comm, causal, window,
                                          q_positions, kv_positions)
    kv = b * sq * kvh * hd
    nb = 4 * b * sq * h * hd * _elt(q) + b * h * sq * 4 \
        + shards * 4 * kv * _elt(q)
    hop = [("collective-permute", 2 * tensor_bytes(k), n)]
    if extra:
        hop.append(("collective-permute", extra, n))
    colls = hop * (n - 1) + [("collective-permute", 2 * kv * 4, n)] * n
    return Work(nb, dot=8 * hd * pairs * b * h, collectives=colls), \
        lambda: (q.new_empty(q.shape), k.new_empty(k.shape),
                 v.new_empty(v.shape))


def _moe_gmm(x, w):
    e, c, d = x.shape
    f = w.shape[2]
    nb, fl = bounds.moe_gmm_work(e, c, d, f, _elt(x))
    return Work(nb, dot=fl), lambda: x.new_empty((e, c, f))


def _moe_gmm_bwd(x, w, dy, *, need_dx=True, need_dw=True):
    e, c, d = x.shape
    f = w.shape[2]
    nb = fl = 0
    if need_dx:                     # dy [e, c, f] @ w^T [e, f, d]
        b_, f_ = bounds.moe_gmm_work(e, c, f, d, _elt(x))
        nb, fl = nb + b_, fl + f_
    if need_dw:                     # x^T [e, d, c] @ dy [e, c, f]
        b_, f_ = bounds.moe_gmm_work(e, d, c, f, _elt(x))
        nb, fl = nb + b_, fl + f_
    return Work(nb, dot=fl), lambda: (
        x.new_empty(x.shape) if need_dx else None,
        w.new_empty(w.shape) if need_dw else None)


def _ssd_fwd(x, dt, A_log, B, C, D, *, chunk=128):
    b, s, h, p = x.shape
    nb, fl = bounds.ssd_work(b, s, h, p, B.shape[-1], min(chunk, s),
                             _elt(x))
    return Work(nb, dot=fl), lambda: x.new_empty(x.shape)


def _ssd_bwd(x, dt, A_log, B, C, D, dy, *, chunk=128):
    b, s, h, p = x.shape
    nb, fl = bounds.ssd_bwd_work(b, s, h, p, B.shape[-1], min(chunk, s),
                                 _elt(x))
    return Work(nb, dot=fl), lambda: tuple(
        t.new_empty(t.shape) for t in (x, dt, A_log, B, C, D))


def _rglru_fwd(x, gates, *, states=False):
    b, s, w = x.shape
    nb, ops = bounds.rglru_work(b, s, w, _elt(x))
    tiles = -(-s // bounds.RGLRU_TILE)
    return Work(nb, ops=ops), lambda: (
        x.new_empty(x.shape),
        x.new_empty((b, tiles, w), dtype=_wide(x)) if states else None)


def _rglru_bwd(x, gates, h0, dy):
    b, s, w = x.shape
    nb, ops = bounds.rglru_bwd_work(b, s, w, _elt(x))
    return Work(nb, ops=ops), lambda: (
        x.new_empty(x.shape), *(g.new_empty(g.shape) for g in gates))


# (module, function, unit name, work and outputs): the functions each
# wrapper's CPU branch reaches, patched while a Tracer runs
UNITS = [
    ("repro_torch.kernels.rmsnorm", "rmsnorm_fwd", "rmsnorm", _rmsnorm_fwd),
    ("repro_torch.kernels.rmsnorm", "rmsnorm_bwd", "rmsnorm_bwd",
     _rmsnorm_bwd),
    ("repro_torch.kernels.flash_attention", "flash_attention_fwd",
     "flash_attention", _flash_fwd),
    ("repro_torch.kernels.flash_attention", "flash_attention_bwd",
     "flash_attention_bwd", _flash_bwd),
    ("repro_torch.kernels.flash_attention", "paged_flash_decode",
     "paged_decode", _paged_decode),
    ("repro_torch.kernels.collective_matmul", "tile_matmul", "tile_matmul",
     _tile_matmul),
    ("repro_torch.kernels.collective_matmul", "ring_matmul_reducescatter",
     "ring_matmul_rs", _ring_matmul_rs),
    ("repro_torch.kernels.ring_attention", "ring_forward_plain",
     "ring_attention", _ring_fwd),
    ("repro_torch.kernels.ring_attention", "ring_backward_plain",
     "ring_attention_bwd", _ring_bwd),
    ("repro_torch.kernels.moe_gmm", "moe_gmm", "moe_gmm", _moe_gmm),
    ("repro_torch.kernels.moe_gmm", "moe_gmm_bwd", "moe_gmm_bwd",
     _moe_gmm_bwd),
    ("repro_torch.kernels.ssd", "ssd_fwd", "ssd", _ssd_fwd),
    ("repro_torch.kernels.ssd", "ssd_bwd", "ssd_bwd", _ssd_bwd),
    ("repro_torch.kernels.rglru", "rglru_fwd", "rglru", _rglru_fwd),
    ("repro_torch.kernels.rglru", "rglru_bwd", "rglru_bwd", _rglru_bwd),
]


def _card_allgather(y_chunk, comm, dim):
    """The card's branch of ``matmul_allreduce`` after the ring kernel:
    the communicator's all-gather (the CPU rings it over ``ring_shift``)."""
    return comm.all_gather(y_chunk, dim)


def _card_allgather_matmul(x, ws, comm, gather_dim):
    """The card's SP entry: the all-gather of x, then one product a
    weight (the CPU rings the shards)."""
    h = comm.all_gather(x.contiguous(), gather_dim)
    return tuple(torch.matmul(h, w) for w in ws)


CARD_BRANCHES = [
    ("repro_torch.kernels.collective_matmul", "ring_allgather",
     _card_allgather),
    ("repro_torch.kernels.collective_matmul", "ring_allgather_matmul",
     _card_allgather_matmul),
]


# --------------------------------------------------------------------------
# the tracer
# --------------------------------------------------------------------------
_PRODUCTS = {"mm": 1, "addmm": 1, "bmm": 2, "baddbmm": 2, "mv": 1,
             "addmv": 1}
# ops that move no bytes: allocation without initialisation and aliases
_FREE = {"empty", "empty_strided", "new_empty", "new_empty_strided",
         "_unsafe_view", "detach", "alias", "lift_fresh", "set_",
         "_local_scalar_dense", "resize_", "_to_copy_meta"}
# in-place ops that overwrite their destination without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_",
               "random_", "bernoulli_", "exponential_", "index_put_"}

_ACTIVE: List["Tracer"] = []


def record(kind: str, payload: int, size: int):
    """A :class:`~repro_torch.core.comm.TraceComm` op (``kind`` in the
    Comm's words) into the running tracer; ignored outside one and inside
    a kernel unit, which charges its own collectives."""
    if _ACTIVE and _ACTIVE[-1].depth == 0:
        _ACTIVE[-1].collective(COMM_KINDS[kind], payload, size)


def _tensors(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _clear_caches():
    """Drop the tensors the model path caches across calls (rope's
    frequencies): a fake one must not outlive its trace, nor a real one
    enter it."""
    from repro_torch.models import attention
    attention._rope_freqs.cache_clear()


def _skey(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Counter(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self, tracer: "Tracer"):
        super().__init__()
        self.tracer = tracer

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.tracer.op(func, args, kwargs, out)
        return out


class Tracer:
    """The counting context: ``with Tracer(...) as tr:`` enters
    ``FakeTensorMode`` (tensors made inside are fake CPU tensors, not
    counted), :meth:`run` counts a call, :meth:`cost` gives the
    :class:`HloCost`.  ``plain``: run the kernel units' plain versions
    and count their products (the JAX-comparable count) rather than
    return their outputs unfilled."""

    def __init__(self, *, default_group: int = 1, plain: bool = False):
        self.default_group = default_group
        self.plain = plain
        self.depth = 0
        self.acc: Dict[Tuple, float] = defaultdict(float)
        self.arg_keys: Dict[int, int] = {}
        self.live: Dict[int, List[int]] = {}
        self.live_bytes = self.peak = 0
        self.updated: Dict[int, int] = {}
        self.out_bytes = 0
        self._stack = contextlib.ExitStack()

    # the context -----------------------------------------------------
    def __enter__(self) -> "Tracer":
        from torch._subclasses.fake_tensor import FakeTensorMode
        _clear_caches()
        self.fake = FakeTensorMode(allow_non_fake_inputs=True)
        self._stack.enter_context(self.fake)
        self._stack.callback(_clear_caches)
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False

    def fakify(self, tree):
        """Real tensors (nested in dicts, lists, tuples) as fake ones."""
        if isinstance(tree, torch.Tensor):
            t = self.fake.from_tensor(tree)
            return t
        if isinstance(tree, dict):
            return {k: self.fakify(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.fakify(v) for v in tree)
        return tree

    @contextlib.contextmanager
    def _patched(self):
        import importlib
        saved = []
        try:
            for mod, name, unit, work in UNITS:
                m = importlib.import_module(mod)
                saved.append((m, name, getattr(m, name)))
                setattr(m, name, self._unit(unit, work, getattr(m, name)))
            for mod, name, fn in CARD_BRANCHES:
                m = importlib.import_module(mod)
                saved.append((m, name, getattr(m, name)))
                setattr(m, name, fn)
            yield
        finally:
            for m, name, fn in reversed(saved):
                setattr(m, name, fn)

    def _unit(self, unit: str, work, plain_fn):
        def call(*args, **kwargs):
            w, outputs = work(*args, **kwargs)
            a = self.acc
            if self.depth == 0:
                a["dot"] += w.dot
                first = next(_tensors(args), None)
                if w.dot and first is not None:
                    a["dot_dtype", HLO_DTYPES[first.dtype]] += w.dot
                a["bytes"] += w.nbytes
                for key, v in (("calls", 1), ("bytes", w.nbytes),
                               ("dot", w.dot), ("ops", w.ops)):
                    a["unit", unit, key] += v
                for kind, payload, n in w.collectives:
                    self.collective(kind, payload, n)
            self.depth += 1
            try:
                out = plain_fn(*args, **kwargs) if self.plain else outputs()
            finally:
                self.depth -= 1
            if self.depth == 0:
                for t in _tensors(out):
                    self._track(t)
            return out
        return call

    def run(self, fn: Callable, *args, micro: Optional[Tuple[Any, str, int]]
            = None):
        """Count ``fn(*args)`` and return its result.  ``micro``: (module,
        attribute, n): a function called once at the start of each
        microbatch of a step traced with three microbatches; the counts
        are extrapolated to n (the three's counts, plus n - 3 times the
        second microbatch's: every microbatch after the first runs the
        same ops, and the first may fill a cache, rope's frequencies)."""
        from torch.utils.flop_counter import FlopCounterMode
        for t in _tensors(args):
            self.arg_keys.setdefault(_skey(t),
                                     t.untyped_storage().nbytes())
        marks: List[Dict] = []
        fc = FlopCounterMode(display=False)
        with contextlib.ExitStack() as st:
            if micro is not None:
                mod, attr, _ = micro
                orig = getattr(mod, attr)

                def marked(*a, **k):
                    marks.append(dict(self.acc,
                                      torch_flops=fc.get_total_flops()))
                    return orig(*a, **k)
                setattr(mod, attr, marked)
                st.callback(setattr, mod, attr, orig)
            st.enter_context(self._patched())
            st.enter_context(fc)
            _ACTIVE.append(self)
            st.callback(_ACTIVE.pop)
            st.enter_context(_Counter(self))
            out = fn(*args)
        self.acc["torch_flops"] += fc.get_total_flops()
        for t in _tensors(out):
            self.out_bytes += tensor_bytes(t)
        if micro is not None and micro[2] != len(marks):
            if len(marks) != 3:
                raise ValueError(f"extrapolating microbatches needs a trace "
                                 f"of 3, got {len(marks)}")
            one = {k: marks[2].get(k, 0.0) - marks[1].get(k, 0.0)
                   for k in set(marks[2]) | set(marks[1])}
            for k, v in one.items():
                self.acc[k] += (micro[2] - 3) * v
        return out

    # counting ----------------------------------------------------------
    def collective(self, kind: str, payload: float, n: Optional[int]):
        payload, link = _collective_cost(kind, payload,
                                         n or self.default_group)
        a = self.acc
        a["payload"] += payload
        a["link"] += link
        a["bytes"] += 2 * payload
        a["plain_bytes"] += 2 * payload
        a["coll_count", kind] += 1
        a["coll_link", kind] += link
        a["coll_op", kind, int(payload), n or self.default_group] += 1

    def _track(self, t: torch.Tensor):
        key = _skey(t)
        if key in self.arg_keys:
            return
        ent = self.live.get(key)
        if ent is None:
            nb = t.untyped_storage().nbytes()
            self.live[key] = [1, nb]
            self.live_bytes += nb
            self.peak = max(self.peak, self.live_bytes)
        else:
            ent[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int):
        ent = self.live.get(key)
        if ent is not None:
            ent[0] -= 1
            if ent[0] == 0:
                self.live_bytes -= ent[1]
                del self.live[key]

    def op(self, func, args, kwargs, out):
        name = func._schema.name.split("::")[-1]
        outs = list(_tensors(out))
        schema = func._schema
        mutated = set()
        for i, arg in enumerate(schema.arguments):
            if arg.alias_info is not None and arg.alias_info.is_write:
                v = args[i] if i < len(args) else kwargs.get(arg.name)
                for t in _tensors(v):
                    mutated.add(id(t))
                    if _skey(t) in self.arg_keys and self.depth == 0:
                        self.updated[_skey(t)] = self.arg_keys[_skey(t)]
        if self.depth == 0:
            for t in outs:
                self._track(t)
        if func.namespace != "aten" or func.is_view or name in _FREE:
            return
        nb = sum(tensor_bytes(t) for t in outs)
        for t in _tensors((args, kwargs)):
            # a destination is written (counted with the outputs); it is
            # read too unless the op only overwrites it
            if id(t) not in mutated or not (name in _WRITE_ONLY
                                            or "out" in kwargs):
                nb += tensor_bytes(t)
        dot = 0.0
        base = name[1:] if name.startswith("_") else name
        if base in _PRODUCTS and outs:
            mats = [t for t in _tensors(args) if t.dim() >= 1]
            lhs = mats[-2] if base in ("addmm", "baddbmm", "addmv") \
                else mats[0]
            k = lhs.shape[-1]
            dot = 2.0 * outs[0].numel() * k
            self.acc["product", tuple(outs[0].shape), k] += 1
        a = self.acc
        a["plain_dot"] += dot
        a["plain_bytes"] += nb
        if self.depth == 0:
            a["dot"] += dot
            a["bytes"] += nb
            if dot:
                a["dot_dtype", HLO_DTYPES[outs[0].dtype]] += dot

    # the result --------------------------------------------------------
    def cost(self) -> HloCost:
        a = self.acc
        counts = {k[1]: int(round(v)) for k, v in a.items()
                  if isinstance(k, tuple) and k[0] == "coll_count"}
        by_kind = {k[1]: v for k, v in a.items()
                   if isinstance(k, tuple) and k[0] == "coll_link"}
        units: Dict[str, Dict[str, float]] = {}
        for k, v in a.items():
            if isinstance(k, tuple) and k[0] == "unit":
                units.setdefault(k[1], {})[k[2]] = v
        products = {k[1:]: v for k, v in a.items()
                    if isinstance(k, tuple) and k[0] == "product"}
        ops = {k[1:]: v for k, v in a.items()
               if isinstance(k, tuple) and k[0] == "coll_op"}
        by_dtype = {k[1]: v for k, v in a.items()
                    if isinstance(k, tuple) and k[0] == "dot_dtype"}
        arg = sum(self.arg_keys.values())
        alias = sum(self.updated.values())
        return HloCost(
            dot_flops=a["dot"], hbm_bytes=a["bytes"],
            collective_link_bytes=a["link"],
            collective_payload_bytes=a["payload"],
            collective_counts=counts, collective_by_kind=by_kind,
            plain_dot_flops=a["plain_dot"], plain_hbm_bytes=a["plain_bytes"],
            torch_flops=a["torch_flops"], units=units, products=products,
            mem={"argument_bytes": arg, "temp_bytes": self.peak,
                 "output_bytes": self.out_bytes + alias,
                 "alias_bytes": alias},
            dot_by_dtype=by_dtype, collective_ops=ops)


def analyze(fn: Callable, *args, default_group: int = 1,
            plain: bool = False) -> HloCost:
    """The :class:`HloCost` of ``fn(*args)``: the real tensors in
    ``args`` become fake CPU tensors (nothing of ``fn`` is computed) and
    every op ``fn`` runs is counted.  ``default_group``: the group size of
    a collective that states none (JAX's argument); ``plain``: see
    :class:`Tracer`."""
    with Tracer(default_group=default_group, plain=plain) as tr:
        fargs = tr.fakify(args)
        for real, fake in zip(_tensors(args), _tensors(fargs)):
            if real.requires_grad and not fake.requires_grad:
                fake.requires_grad_()
        tr.run(fn, *fargs)
    return tr.cost()

