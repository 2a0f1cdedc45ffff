"""Oases planner ILP (paper §4, Eq. 2–6), solved with scipy HiGHS: the
port's copy of ``repro.core.planner.ilp`` (``plan``, ``replan``,
``plan_joint``, ``plan_serving``, ``expand_options``), the same
arithmetic and the same ``milp`` inputs, so both packages return the
same plans.

Decision: one-hot s_{i,j} over TMP-degree options per graph node (block).
Eq. 3's max{} terms are linearized with auxiliary continuous u-variables;
Eq. 5's quadratic edge term s_v^T R s_u with per-edge product binaries
y_{jk} >= s_vj + s_uk - 1.  Eq. 6 memory is a single linear constraint.

Same-layer blocks share one degree (the paper plans per layer, Table 6), so
s is per-LAYER and the per-block costs are summed within a layer.

Planner v2: the option space extends beyond the paper's 1D baseline to 2D
hybrid partitions ``(dx, dy)`` — width over dx intra-node lanes, the
contraction dim over dy inter-node hops (arXiv:2104.05343-style), costed
with the per-axis bandwidths of :class:`costmodel.HWConfig`.  ``layout``
picks the search space: ``'1d'`` (ints only, the paper), ``'2d'`` (every
factorization including the 1D-equivalent ``(n, 1)``), ``'auto'`` (union).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import LinearConstraint, milp
from scipy.sparse import lil_matrix

from repro_torch.configs.base import ArchConfig, ShapeConfig, TrainHParams
from repro_torch.core.planner import costmodel as cm


def _telemetry_plan(entry: str, pr):
    """Record a finished solve through the process-global telemetry
    recorder (:mod:`repro_torch.obs`): the solve time histogram and a
    planner.plan event carrying the chosen plan and its predicted
    iteration time.  A no-op unless a recorder is configured (the
    launchers' ``--telemetry``)."""
    from repro_torch import obs
    rec = obs.get_recorder()
    rec.observe("planner.solve_ms", pr.solve_ms, entry=entry)
    rec.event("planner.plan", entry=entry,
              predicted_ms=round(pr.predicted_s * 1e3, 3),
              solve_ms=round(pr.solve_ms, 1), status=str(pr.status),
              msg=f"[planner] {entry}: {pr.summary()}")
    return pr


def _fmt_degree(d) -> str:
    dx, dy = cm._dxy(d)
    return f"{dx}x{dy}" if dy > 1 else str(dx)


@dataclass
class PlanResult:
    degrees: List[object]                  # int (1D) or (dx, dy) (2D)
    predicted_s: float
    solve_ms: float
    status: str
    groups: List[Tuple[object, int]]       # (degree, count) runs
    schedules: Optional[List[str]] = None  # per-layer schedule names
    plan: Optional[object] = None          # executable ParallelPlan
    seqs: Optional[List[int]] = None       # per-layer ring seq shards

    def summary(self) -> str:
        sq = self.seqs if self.seqs and any(q > 1 for q in self.seqs) \
            else None
        if sq or (self.schedules is not None
                  and len(set(self.schedules)) > 1):
            scheds = self.schedules or [""] * len(self.degrees)
            runs = " + ".join(
                f"[{_fmt_degree(d)}{'/' + s if s else ''}"
                f"{f'/seq{q}' if q > 1 else ''}] * {n}"
                for (d, s, q), n in _runs(list(zip(
                    self.degrees, scheds, sq or [1] * len(self.degrees)))))
        else:
            sched = f"/{self.schedules[0]}" if self.schedules else ""
            runs = " + ".join(f"[{_fmt_degree(d)}{sched}] * {n}"
                              for d, n in self.groups)
        return (f"[{runs}] predicted {self.predicted_s*1e3:.1f} ms/iter "
                f"(ILP {self.solve_ms:.1f} ms, {self.status})")


def _runs(values: Sequence) -> List[Tuple[object, int]]:
    out = []
    for d in values:
        if out and out[-1][0] == d:
            out[-1] = (d, out[-1][1] + 1)
        else:
            out.append((d, 1))
    return out


def _as_plan(hp, degrees, schedules, *, seqs=None, pp: int = 1,
             virtual_stages: int = 1, microbatch: Optional[int] = None,
             decode_micro: int = 0, mesh_shape=(), mesh_axes=()):
    """Wrap an ILP decision as an executable ParallelPlan.

    Under pipeline parallelism the per-stage TMP degree lives in the MESH
    (stage-internal model axes), not in per-layer pinned degrees — the
    grouped layout does not compose with PP — so pp > 1 plans record
    mesh-following (``None``) degrees and should carry the mesh signature
    instead.  A seq-sharded decision over a UNIFORM degree likewise
    records mesh-following degrees: the ring runs on the plain
    ``(data, model)`` mesh of that degree and the seq axis alone decides
    per-layer behaviour (lm.build_train_loss's stacked ring fast path /
    seq-grouped scan both require mesh-following degrees there)."""
    import dataclasses as _dc

    from repro_torch.core.plan import ParallelPlan
    if microbatch is not None:
        hp = _dc.replace(hp, microbatch=microbatch)
    hp = _dc.replace(hp, virtual_stages=max(virtual_stages, 1))
    if seqs is not None and not any(q > 1 for q in seqs):
        seqs = None
    follow = pp > 1 or (seqs is not None
                        and len({cm._dkey(d) for d in degrees}) == 1)
    return ParallelPlan.from_hparams(
        hp, len(degrees),
        degrees=([None] * len(degrees) if follow
                 else [_dkey_plan(d) for d in degrees]),
        schedules=list(schedules), seqs=list(seqs) if seqs else None,
        pp=max(pp, 1), decode_micro=decode_micro,
        mesh_shape=mesh_shape, mesh_axes=mesh_axes)


def _dkey_plan(d):
    dx, dy = cm._dxy(d)
    return dx if dy == 1 else (dx, dy)


def _mesh_sig(hw: cm.HWConfig, pp: int, degree) -> Tuple[Tuple[int, ...],
                                                         Tuple[str, ...]]:
    """The canonical launch mesh of a uniform-degree (pp, degree) decision
    on ``hw`` — recorded into the decision's ParallelPlan so ``--plan``
    launches reconstruct the mesh the planner actually costed."""
    dx, dy = cm._dxy(degree)
    dp = max(hw.n_chips // (max(pp, 1) * dx * dy), 1)
    if dy > 1:
        shape: Tuple[int, ...] = (dp, dx, dy)
        axes: Tuple[str, ...] = ("data", "model_x", "model_y")
    else:
        shape, axes = (dp, dx), ("data", "model")
    if pp > 1:
        shape, axes = (pp,) + shape, ("pipe",) + axes
    return shape, axes


def _plan_mesh_sig(hw: cm.HWConfig, degrees) -> Tuple[Tuple[int, ...],
                                                      Tuple[str, ...]]:
    """Launch mesh of a (pp = 1) per-layer plan: a uniform strategy takes
    the plain/2D mesh; mixed (or per-layer-2D) strategies need the
    FACTORED mesh — binary t-sub-axes covering the largest group, extra
    axes doubling as data parallelism for lower-degree layers (the
    execution contract of lm._grouped_scan).  Returns ``((), ())`` when
    the factored axes would exceed the t1..t4 vocabulary (the launcher's
    explicit --mesh takes over)."""
    import math as _math
    kinds = {cm._dkey(d) for d in degrees}
    dmax = max(cm._dtot(d) for d in degrees)
    if len(kinds) == 1:
        return _mesh_sig(hw, 1, next(iter(kinds)))
    k = int(_math.log2(dmax))
    if k > 4 or 2 ** k != dmax:               # beyond T_AXES: don't guess
        return (), ()
    dp = max(hw.n_chips // dmax, 1)
    return ((dp,) + (2,) * k,
            ("data",) + tuple(f"t{i + 1}" for i in range(k)))


def expand_options(cfg: ArchConfig, hw: cm.HWConfig,
                   options: Sequence[int], layout: str) -> List:
    """The per-layer degree option space for a layout.

    2D factorizations keep dx within one node (the x-ring must ride the
    fast lanes) and require the contraction dim divisible by dy (the
    per-axis decomposition slices d_model); ``(n, 1)`` degenerates stay so
    a forced-2D search is never less expressive than 1D.
    """
    base = [int(n) for n in options]
    if layout == "1d":
        return base
    ns = hw.node_size or hw.n_chips
    out: List = [] if layout == "2d" else list(base)
    for n in base:
        dy = 2
        while dy <= n:
            dx = n // dy
            if (dx * dy == n and dx <= ns
                    and cfg.d_model % dy == 0):
                out.append((dx, dy))
            dy *= 2
        if layout == "2d":
            out.append((n, 1))
    return out


def _consolidate_seqs(cfg, degrees, lsched, lseqs):
    """Defragment the ILP's seq axis.  Layers with identical
    (kind, degree, schedule) are cost-identical columns, so HiGHS
    scatters a memory-driven ring-layer count arbitrarily among them.
    Sorting each equivalence class's seq values in place (head-sharded
    first, ring last) keeps the exact per-class ring count — Eq. 3/6
    node terms are unchanged — while minimizing seq-axis transitions,
    each of which estimate_iteration charges a residual regather."""
    pat = cfg.layer_pattern
    groups: Dict[tuple, List[int]] = {}
    for i in range(len(lseqs)):
        groups.setdefault(
            (pat[i % len(pat)], cm._dkey(degrees[i]), lsched[i]),
            []).append(i)
    out = list(lseqs)
    for idxs in groups.values():
        for i, v in zip(idxs, sorted(lseqs[i] for i in idxs)):
            out[i] = v
    return out


def _smooth_schedules(cfg, shape, hp, degrees, lsched, hw, options, scheds,
                      lseqs=None, ring_ok=None, mem_cap=None):
    """Post-solve consistency guard for the (degree, schedule[, seq])
    search.

    The ILP's linearization charges schedule and seq transitions nothing
    (edge products range over degree pairs only), while
    ``estimate_iteration`` exposes the pending overlap cool-down when
    leaving an oases/merak run and the residual regather at every
    seq-axis boundary — so a near-tie could fragment the stack into a
    plan the estimator scores worse than a uniform overlay.  Evaluate the
    ILP's choice against every uniform-schedule overlay on the SAME
    (degrees, seqs), and — when the seq axis is in play — against the
    uniform seq overlays (all-off, and all-on where every layer is
    ring-capable), keeping the cheapest MEMORY-FEASIBLE candidate (seq
    overlays move Eq. 6, so each one re-checks ``mem_cap``; the ILP
    choice wins exact ties).  Returns ``(schedules, seqs, estimate)``."""
    L = len(lsched)
    lseqs = list(lseqs) if lseqs is not None else [1] * L
    base = [1] * L
    seq_cands = [list(lseqs)]
    if any(q > 1 for q in lseqs):
        seq_cands.append(base)
        full = [int(cm._dtot(d)) if (ring_ok is None or ring_ok[i])
                and not isinstance(degrees[i], (tuple, list))
                and cm._dtot(degrees[i]) > 1 else 1
                for i, d in enumerate(degrees)]
        if full != lseqs and any(q > 1 for q in full):
            seq_cands.append(full)
    candidates = [(list(lsched), sq) for sq in seq_cands]
    if len(set(lsched)) > 1:
        candidates += [([s] * L, sq) for s in scheds for sq in seq_cands]
    e0 = cm.estimate_iteration(cfg, shape, hp, degrees, hw, options,
                               schedules=list(lsched), seqs=list(lseqs))
    best = None
    for cand, sq in candidates:
        e = cm.estimate_iteration(cfg, shape, hp, degrees, hw, options,
                                  schedules=cand, seqs=sq)
        # an overlay must not move Eq. 6 the wrong way past the cap (the
        # estimator's mem includes fixed terms the ILP row does not, so
        # "no worse than the ILP's own choice" is the consistent bar)
        if (mem_cap is not None and e["mem_bytes"] > mem_cap
                and e["mem_bytes"] > e0["mem_bytes"]):
            continue                      # overlay broke Eq. 6: drop it
        key = (e["iter_s"],
               sum(a != b for a, b in zip(sq, sq[1:])),
               sum(a != b for a, b in zip(cand, cand[1:])))
        if best is None or key < best[0]:
            best = (key, cand, sq, e)
    return best[1], best[2], best[3]


def _pair_pass_bounds(sched: str, split: int, d: float, c: float,
                      fused_v: float) -> Tuple[float, float]:
    """The two Eq. 3 lower bounds of one (layer, degree, schedule) option
    for one pass: the layer's exposed-time variable u must satisfy
    ``u >= lb1`` and ``u >= lb2`` when this option is chosen.  Non-overlap
    schedules collapse both bounds to the same constant (matching
    estimate_iteration's per-schedule branches exactly — this is what
    lets the ILP search (degree, schedule) pairs with the existing
    per-schedule exposed-cost terms)."""
    if sched == "fused":
        return fused_v, fused_v
    if sched in ("oases", "merak") and split > 1:
        return split * d, (split - 1) * d + c
    if sched == "wang":
        v = split * d + c / max(split * 2, 1) + c * 0.1
        return v, v
    v = split * (d + c)                      # megatron / split == 1
    return v, v


def plan(cfg: ArchConfig, shape: ShapeConfig, hp: TrainHParams,
         hw: cm.HWConfig = cm.V5E,
         options: Sequence[int] = (2, 4, 8, 16),
         mem_cap: Optional[float] = None,
         time_limit: float = 20.0,
         layout: str = "1d",
         stages: int = 1,
         objective: str = "throughput",
         schedules: Optional[Sequence[str]] = None,
         seq: str = "none"
         ) -> "PlanResult | ServingPlanResult":
    """``layout`` is the explicit search-space knob (it deliberately does
    NOT read ``hp.tmp_layout``, which governs the *execution* layout and
    defaults to mesh-following 'auto'): '1d' preserves the paper's search
    space; pass '2d' or 'auto' to enable hybrid partitions.  ``stages``:
    pipeline-stage count — weight/optimizer rows of Eq. 6 scale 1/stages
    (each chip holds that fraction of the layers) while live activations
    keep their in-flight-microbatch factor (costmodel.pipeline_mem_scales;
    used by :func:`plan_joint`).

    ``schedules`` extends the per-layer option space from degrees to
    ``(degree, schedule)`` pairs — the paper's actual search space (§4,
    Table 6 plans per layer): pass a tuple of schedule names or
    ``"auto"`` for all of them; ``None`` (default) searches degrees only
    under ``hp.schedule``.  The result's ``.plan`` is the executable
    :class:`~repro_torch.core.plan.ParallelPlan`.

    ``objective='latency'`` retargets the search at serving: instead of
    the per-layer throughput ILP it runs :func:`plan_serving` — a
    ``(dx, dy, pp)`` mesh search minimizing per-token decode-step latency
    (``costmodel.decode_step_time``) — and returns a
    :class:`ServingPlanResult`.

    ``seq`` opens the plan's third per-layer axis, ring attention
    (kernels/ring_attention.py): ``'auto'`` extends every 1D degree
    option n > 1 on a self/local-attention layer with its seq-sharded
    variant seq == n — attention weights replicated, sequence sharded,
    the block collective replaced by the overlapped KV ring
    (``costmodel.ring_attn_costs``) — so the one-hot ranges over
    (degree, schedule, seq ∈ {1, degree}) triples.  ``'none'`` (default)
    keeps the two-axis search exactly.  The seq axis does not compose
    with pipeline stages (``stages > 1`` forces it off, matching
    core/plan.py's validation)."""
    if objective == "latency":
        # the serving search defaults to the full layout space ('1d' here
        # is plan()'s paper-faithful TRAINING default, not a user choice;
        # call plan_serving directly to force a 1D-only latency search)
        return plan_serving(cfg, shape, hp, hw, options=options,
                            mem_cap=mem_cap,
                            layout="auto" if layout == "1d" else layout)
    if objective != "throughput":
        raise ValueError(
            f"unknown planner objective {objective!r}: expected "
            f"'throughput' (training iteration time, the default) or "
            f"'latency' (serving per-token decode latency)")
    t0 = time.perf_counter()
    from repro_torch.core.plan import validate_schedule
    if schedules is None:
        scheds: Tuple[str, ...] = (hp.schedule,)
    elif schedules == "auto":
        # preference order, not SCHEDULES order: cost ties resolve to the
        # earliest entry, and oases/merak are exactly tied in the model
        # (same Eq. 3 bounds) while barrier-free oases is never worse in
        # reality — so oases leads and merak can only win a real gap
        # (there is none), keeping auto plans on the paper's schedule
        scheds = ("oases", "fused", "wang", "megatron", "merak")
    else:
        scheds = tuple(validate_schedule(s, what="planner schedule")
                       for s in schedules)
        if not scheds:
            raise ValueError("schedules must name at least one schedule "
                             "(or be None / 'auto')")
    if seq not in ("none", "auto"):
        raise ValueError(f"unknown planner seq axis {seq!r}: expected "
                         f"'none' (head-sharded only, the default) or "
                         f"'auto' (offer seq == degree ring attention "
                         f"per layer)")
    options = expand_options(cfg, hw, options, layout)
    L = cfg.num_layers
    D = len(options)
    ring_on = seq == "auto" and stages == 1
    # option/layer ring capability: 1D groups of >= 2 chips, on layers
    # whose attention is self/local (cross-attn KV comes from the encoder
    # and stays head-sharded — models/params.py keeps those specs classic)
    ring_opt = [cm._dxy(o)[1] == 1 and cm._dtot(o) > 1 for o in options]
    from repro_torch.configs.base import GLOBAL_ATTN, LOCAL_ATTN
    pat = cfg.layer_pattern
    ring_layer = [pat[i % len(pat)] in (GLOBAL_ATTN, LOCAL_ATTN)
                  for i in range(L)]
    # the per-layer one-hot ranges over (degree, schedule, seq) TRIPLES;
    # rf == 1 means "ring: seq == this option's degree"
    pairs = [(dj, sj, rf) for dj in range(D) for sj in range(len(scheds))
             for rf in ((0, 1) if ring_on and ring_opt[dj] else (0,))]
    P = len(pairs)
    mem_cap = mem_cap if mem_cap is not None else hw.hbm_cap

    # per-layer aggregated cost vectors, indexed by DEGREE option (blocks
    # within a layer summed; the degree-only terms are schedule-agnostic —
    # per-pair exposed costs derive from them in _pair_pass_bounds)
    blocks = cm.layer_blocks(cfg, shape)
    split = max(hp.split, 1)
    need_fused = "fused" in scheds

    d_f = np.zeros((L, D))
    c_f = np.zeros((L, D))
    d_b = np.zeros((L, D))
    c_b = np.zeros((L, D))
    mem = np.zeros((L, D))
    # fused node costs must be summed over blocks PER BLOCK (the kernel
    # rings are per-block: one block's comm never hides under another
    # block's compute), matching estimate_iteration — aggregating d/c
    # first and applying max{} after would understate comm-bound layers
    fused_f = np.zeros((L, D))
    fused_b = np.zeros((L, D))
    # ring-pair cost split: the MLP-side blocks keep the layer schedule
    # (d/c/fused *_m arrays) while the attention block collapses to the
    # overlapped ring constant (ring_f/ring_b) with its own Eq. 6 row
    d_f_m = np.zeros((L, D))
    c_f_m = np.zeros((L, D))
    d_b_m = np.zeros((L, D))
    c_b_m = np.zeros((L, D))
    mem_m = np.zeros((L, D))
    fused_f_m = np.zeros((L, D))
    fused_b_m = np.zeros((L, D))
    ring_f = np.zeros((L, D))
    ring_b = np.zeros((L, D))
    mem_r = np.zeros((L, D))
    s_sc, t_sc = cm.pipeline_mem_scales(stages, hp.microbatch)
    for i, layer in enumerate(blocks):
        for blk in layer:
            nc = cm.node_costs(cfg, blk, shape, hp, hw, options)
            d_f[i] += nc.d_f
            c_f[i] += nc.c_f
            d_b[i] += nc.d_b
            c_b[i] += nc.c_b
            mem[i] += np.array(nc.mem_s) * s_sc + np.array(nc.mem_t) * t_sc
            if need_fused:
                for j in range(D):
                    dx_j, _ = cm._dxy(options[j])
                    fused_f[i, j] += cm.overlapped_time_2d(
                        split * nc.d_f[j],
                        split * (nc.c_f[j] - nc.c_f_y[j]),
                        split * nc.c_f_y[j], dx_j - 1)
                    fused_b[i, j] += cm.overlapped_time_2d(
                        split * nc.d_b[j],
                        split * (nc.c_b[j] - nc.c_b_y[j]),
                        split * nc.c_b_y[j], dx_j - 1)
            if not (ring_on and ring_layer[i]):
                continue
            if blk.name == "attn":
                rc = cm.ring_attn_costs(cfg, blk, shape, hp, hw, options)
                for j in range(D):
                    if not ring_opt[j]:
                        continue
                    n_j = cm._dtot(options[j])
                    ring_f[i, j] += cm.overlapped_time(
                        split * rc.d_f[j], split * rc.c_f[j], n_j - 1)
                    ring_b[i, j] += cm.overlapped_time(
                        split * rc.d_b[j], split * rc.c_b[j], n_j - 1)
                    mem_r[i, j] += rc.mem_s[j] * s_sc + rc.mem_t[j] * t_sc
            else:
                d_f_m[i] += nc.d_f
                c_f_m[i] += nc.c_f
                d_b_m[i] += nc.d_b
                c_b_m[i] += nc.c_b
                mem_m[i] += (np.array(nc.mem_s) * s_sc
                             + np.array(nc.mem_t) * t_sc)
                if need_fused:
                    for j in range(D):
                        dx_j, _ = cm._dxy(options[j])
                        fused_f_m[i, j] += cm.overlapped_time_2d(
                            split * nc.d_f[j],
                            split * (nc.c_f[j] - nc.c_f_y[j]),
                            split * nc.c_f_y[j], dx_j - 1)
                        fused_b_m[i, j] += cm.overlapped_time_2d(
                            split * nc.d_b[j],
                            split * (nc.c_b[j] - nc.c_b_y[j]),
                            split * nc.c_b_y[j], dx_j - 1)

    # Eq. 3 per layer, both passes, per (degree, schedule) pair:
    #   overlap (oases/merak, split>1): u >= split*d AND
    #       u >= (split-1)*d + c  (comm hidden behind the other sub-batch's
    #       compute, cool-down exposed)
    #   fused / wang / blocking: one constant exposed cost (both bounds
    #       collapse) — see _pair_pass_bounds.
    # Variables: x = [s(0,0)..s(L-1,P-1), uF_0..uF_{L-1}, uB_..., y_edges]
    # y products range over DEGREE pairs only (edge costs are
    # schedule-agnostic: a schedule change at equal degree reshard nothing).
    nS = L * P
    nU = 2 * L
    edges = [(i, i + 1) for i in range(L - 1)]
    nY = len(edges) * D * D
    N = nS + nU + nY

    cost = np.zeros(N)
    integrality = np.zeros(N)
    integrality[:nS] = 1
    integrality[nS + nU:] = 1
    lb = np.zeros(N)
    ub = np.ones(N)
    ub[nS:nS + nU] = np.inf

    # objective: sum of u variables + edge costs via y
    cost[nS:nS + nU] = 1.0

    # Deterministic tie-breaks (the Eq. 3 max{} linearization leaves every
    # compute-bound degree at the same objective, and HiGHS fragments such
    # ties into arbitrary per-layer mixes):
    # * a 1%-of-comm nudge aligns the ILP's preference with
    #   estimate_iteration's sequential model (lower exposed comm wins);
    # * a ~3e-4-of-compute epsilon prefers 1D, then the thinnest y split;
    # * a ~1e-4-of-compute epsilon prefers earlier-listed schedules, so
    #   degenerate schedule ties collapse to one deterministic choice
    #   instead of HiGHS-arbitrary per-layer fragmentation.
    # All sit well below any real gap (tens of percent in the commodity
    # regime) but above HiGHS's ~1e-7 tolerances, so ties resolve the same
    # way on every solve.
    # * a ~5e-5-of-compute epsilon prefers the head-sharded (seq == 1)
    #   variant, so ring only wins a real modeled gap.
    scale = float(np.mean(d_f) + np.mean(c_f)) or 1.0
    for p, (j, sj, rf) in enumerate(pairs):
        _, dyj = cm._dxy(options[j])
        for i in range(L):
            cost[i * P + p] += 1e-2 * (c_f[i, j] + c_b[i, j])
            if dyj > 1:
                cost[i * P + p] += 3e-4 * scale * (1.0 + np.log2(dyj))
            if sj:
                cost[i * P + p] += 1e-4 * scale * sj
            if rf:
                cost[i * P + p] += 5e-5 * scale

    rows = []
    lo = []
    hi = []

    def add(coefs: Dict[int, float], lo_v, hi_v):
        rows.append(coefs)
        lo.append(lo_v)
        hi.append(hi_v)

    # one-hot rows
    for i in range(L):
        add({i * P + p: 1.0 for p in range(P)}, 1.0, 1.0)

    # ring pairs exist only on ring-capable layers: pin the others' s to 0
    if ring_on:
        for i in range(L):
            if ring_layer[i]:
                continue
            for p, (_, _, rf) in enumerate(pairs):
                if rf:
                    ub[i * P + p] = 0.0

    # u constraints: two lower-bound rows per (layer, pass) whenever any
    # pair's bounds differ (the overlap schedules), one otherwise — the
    # single-schedule default emits exactly the pre-pair rows.  Ring
    # pairs bound u by the MLP-side schedule terms plus the overlapped
    # ring constant (both bounds shift by the same constant).
    for i in range(L):
        for off, dk, ck, fk, dmk, cmk, fmk, rk in (
                (0, d_f, c_f, fused_f, d_f_m, c_f_m, fused_f_m, ring_f),
                (L, d_b, c_b, fused_b, d_b_m, c_b_m, fused_b_m, ring_b)):
            u = nS + off + i
            b1 = np.zeros(P)
            b2 = np.zeros(P)
            for p, (j, sj, rf) in enumerate(pairs):
                if rf:
                    v1, v2 = _pair_pass_bounds(
                        scheds[sj], split, dmk[i, j], cmk[i, j], fmk[i, j])
                    b1[p], b2[p] = v1 + rk[i, j], v2 + rk[i, j]
                else:
                    b1[p], b2[p] = _pair_pass_bounds(
                        scheds[sj], split, dk[i, j], ck[i, j], fk[i, j])
            add({u: 1.0, **{i * P + p: -b1[p] for p in range(P)}},
                0.0, np.inf)
            if np.any(b2 != b1):
                add({u: 1.0, **{i * P + p: -b2[p] for p in range(P)}},
                    0.0, np.inf)

    # edge products + costs over degree pairs: y_e,dj,dk >= sum_{p in
    # pairs(dj)} s_a,p + sum_{p in pairs(dk)} s_b,p - 1
    deg_pairs = {j: [p for p, (dj, _, _) in enumerate(pairs) if dj == j]
                 for j in range(D)}
    for e, (a, b) in enumerate(edges):
        for j in range(D):
            for k in range(D):
                if options[j] == options[k]:
                    continue
                yi = nS + nU + e * D * D + j * D + k
                coefs = {yi: 1.0}
                for p in deg_pairs[j]:
                    coefs[a * P + p] = -1.0
                for p in deg_pairs[k]:
                    coefs[b * P + p] = coefs.get(b * P + p, 0.0) - 1.0
                add(coefs, -1.0, np.inf)
                nc_from = cm.NodeCosts(
                    [d_f[a, j]], [c_f[a, j]], [d_b[a, j]], [c_b[a, j]],
                    [0], [0])
                cost[yi] = cm.edge_cost(
                    cfg, shape, hw, options[j], options[k],
                    nc_from, 0, 0) * 2.0

    # Eq. 6 memory: sum_i s_i . mem_i + fixed <= cap (schedule-agnostic)
    vp = cfg.padded_vocab()
    max_total = max(cm._dtot(o) for o in options)
    fixed = vp * cfg.d_model * 2.0 / max_total * (2 if not cfg.tie_embeddings else 1)
    fixed *= 7.0  # + f32 optimizer states
    add({i * P + p: (mem_m[i, j] + mem_r[i, j]) if rf else mem[i, j]
         for i in range(L) for p, (j, _, rf) in enumerate(pairs)},
        -np.inf, mem_cap - fixed)

    A = lil_matrix((len(rows), N))
    for r, coefs in enumerate(rows):
        for c_idx, v in coefs.items():
            A[r, c_idx] = v
    con = LinearConstraint(A.tocsc(), np.array(lo), np.array(hi))
    # mip_rel_gap must sit below the tie-break epsilons or HiGHS stops at
    # an incumbent that still fragments degenerate ties
    res = milp(c=cost, constraints=con, integrality=integrality,
               bounds=(lb, ub),
               options={"time_limit": time_limit, "presolve": True,
                        "mip_rel_gap": 1e-9})
    solve_ms = (time.perf_counter() - t0) * 1e3

    if res.x is None:
        # infeasible (e.g. memory cap too tight at low degrees): fall back
        # to uniform max total degree (preferring a 1D int on ties)
        fb = max(options,
                 key=lambda o: (cm._dtot(o), not isinstance(o, tuple)))
        degrees = [fb] * L
        lsched = [scheds[0]] * L
        est = cm.estimate_iteration(cfg, shape, hp, degrees, hw, options,
                                    schedules=lsched)
        msh, max_ = _plan_mesh_sig(hw, degrees)
        return _telemetry_plan("plan", PlanResult(
            degrees, est["iter_s"], solve_ms,
            f"fallback:{res.status}", _runs(degrees),
            schedules=lsched,
            plan=_as_plan(hp, degrees, lsched,
                          mesh_shape=msh, mesh_axes=max_)))

    s = res.x[:nS].reshape(L, P)
    chosen = [pairs[int(np.argmax(s[i]))] for i in range(L)]
    degrees = [options[j] for j, _, _ in chosen]
    lsched = [scheds[sj] for _, sj, _ in chosen]
    lseqs = [int(cm._dtot(options[j])) if rf else 1 for j, _, rf in chosen]
    if any(q > 1 for q in lseqs):
        lseqs = _consolidate_seqs(cfg, degrees, lsched, lseqs)
    lsched, lseqs, est = _smooth_schedules(
        cfg, shape, hp, degrees, lsched, hw, options, scheds,
        lseqs=lseqs, ring_ok=ring_layer, mem_cap=mem_cap)
    msh, max_ = _plan_mesh_sig(hw, degrees)
    return _telemetry_plan("plan", PlanResult(
        degrees, est["iter_s"], solve_ms,
        str(res.status), _runs(degrees), schedules=lsched, seqs=lseqs,
        plan=_as_plan(hp, degrees, lsched, seqs=lseqs,
                      mesh_shape=msh, mesh_axes=max_)))


def replan(cfg: ArchConfig, shape: ShapeConfig, hp: TrainHParams,
           hw: cm.HWConfig,
           options: Sequence[int] = (2, 4, 8, 16),
           mem_cap: Optional[float] = None,
           time_limit: float = 5.0,
           layout: str = "1d",
           schedules: Optional[Sequence[str]] = None,
           uniform: bool = True) -> PlanResult:
    """Mid-run replanning against a degraded topology
    (``HWConfig.degrade``): the elastic supervisor's planner entry point
    (runtime/elastic.py).

    Differences from :func:`plan`, all in the name of producing a plan
    that is guaranteed executable on whatever survived:

    * the option space is CLAMPED to the surviving chip count (each
      option rounds down to the largest power of two <= min(option,
      n_chips); degree 1 — no TMP — is the 1-chip limit case);
    * ``uniform=True`` (default) collapses a mixed-degree decision to its
      max-degree uniform strategy — a surviving mesh is relaunched as a
      plain ``(data, model)`` mesh, not the factored t-axis mesh that
      per-layer mixed degrees require — and records the mesh-following
      (degree ``None``) form so the plan runs on the relaunched mesh
      without a grouped parameter relayout;
    * a short default ``time_limit`` — this runs between training steps.
    """
    import math as _math

    def _clamp(n: int) -> int:
        n = max(min(int(n), hw.n_chips), 1)
        return 2 ** int(_math.log2(n))

    opts = sorted({_clamp(n) for n in options}) or [1]
    pr = plan(cfg, shape, hp, hw, options=opts, mem_cap=mem_cap,
              time_limit=time_limit, layout=layout, schedules=schedules)
    if not uniform:
        return _telemetry_plan("replan", pr)
    degrees, scheds = list(pr.degrees), list(pr.schedules)
    if len({(cm._dkey(d), s) for d, s in zip(degrees, scheds)}) > 1:
        # collapse like plan_joint: the max-degree strategy is the one
        # that satisfied Eq. 6 memory everywhere
        k = max(range(len(degrees)), key=lambda i: cm._dtot(degrees[i]))
        degrees = [degrees[k]] * len(degrees)
        scheds = [scheds[k]] * len(scheds)
        est = cm.estimate_iteration(cfg, shape, hp, degrees, hw, opts,
                                    schedules=scheds)
        pr = PlanResult(degrees, est["iter_s"], pr.solve_ms,
                        f"uniform-collapse:{pr.status}", _runs(degrees),
                        schedules=scheds)
    # mesh-following executable form: the decision lives in the mesh
    # signature (dp x tp), the layers follow the mesh — so the relaunched
    # trainer needs no factored axes and no grouped param layout
    from repro_torch.core.plan import ParallelPlan
    msh, max_ = _mesh_sig(hw, 1, pr.degrees[0])
    pr.plan = ParallelPlan.from_hparams(
        hp, len(pr.degrees), schedules=list(pr.schedules),
        mesh_shape=msh, mesh_axes=max_)
    return _telemetry_plan("replan", pr)


# --------------------------------------------------------------------------
# joint PP x TMP search (the pipeline axis of core/pipeline.py)
# --------------------------------------------------------------------------
@dataclass
class JointPlanResult:
    pp: int                                # pipeline stages (1 = TMP-only)
    n_micro: int                           # 1F1B microbatch count
    virtual_stages: int
    degrees: List[object]                  # per-layer TMP degrees per stage
    predicted_s: float                     # composed pipeline iteration time
    tmp_s: float                           # the stage-internal TMP time
    bubble_fraction: float
    p2p_s: float
    mem_bytes: float
    fits: bool
    tmp_only_s: float                      # best pp=1 candidate (baseline)
    solve_ms: float
    status: str
    groups: List[Tuple[object, int]]
    schedules: Optional[List[str]] = None  # per-layer schedule names
    plan: Optional[object] = None          # executable ParallelPlan

    def summary(self) -> str:
        runs = " + ".join(f"[{_fmt_degree(d)}] * {n}"
                          for d, n in self.groups)
        return (f"pp={self.pp} x [{runs}] m={self.n_micro} "
                f"v={self.virtual_stages} predicted "
                f"{self.predicted_s*1e3:.1f} ms/iter (bubble "
                f"{self.bubble_fraction*100:.1f}%, p2p "
                f"{self.p2p_s*1e3:.2f} ms; tmp-only "
                f"{self.tmp_only_s*1e3:.1f} ms; {self.status})")


def _default_pp_options(cfg: ArchConfig, hw: cm.HWConfig,
                        virtual_stages: int = 1) -> List[int]:
    """Power-of-two stage counts that divide both the chips and the
    EXECUTABLE layer unit — the scan-group count num_layers/|pattern|
    (models/params.stack_layout), which is what
    core/pipeline.validate_stage_layout enforces at training time — capped
    at 8 (deeper pipes need more microbatches than the Eq. 3 shapes
    carry)."""
    v = max(virtual_stages, 1)
    pat = max(len(cfg.layer_pattern), 1)
    groups = cfg.num_layers // pat if cfg.num_layers % pat == 0 else 0
    out = [1]
    p = 2
    while p <= min(hw.n_chips // 2, 8):
        if hw.n_chips % p == 0 and groups and groups % (p * v) == 0:
            out.append(p)
        p *= 2
    return out


def _default_microbatch_options(pp: int, v: int,
                                shape: ShapeConfig) -> List[int]:
    """Candidate 1F1B microbatch counts: pp..8*pp*v, divisors of the
    global batch (more microbatches shrink the bubble; fewer keep each
    matmul fat — the search arbitrates via the cost model)."""
    if pp == 1:
        return [0]                        # resolve_hp semantics (auto)
    out = [m for m in (pp, 2 * pp, 4 * pp * v, 8 * pp * v)
           if m <= shape.global_batch and shape.global_batch % m == 0]
    seen: List[int] = []
    for m in out:
        if m not in seen:
            seen.append(m)
    if seen:
        return seen
    # no power-of-two-ish candidate divides the batch: fall back to the
    # largest divisor <= pp so the winning plan stays executable
    # (resolve_microbatch rejects non-divisors at training time)
    m = min(pp, shape.global_batch)
    while m > 1 and shape.global_batch % m:
        m -= 1
    return [m]


def plan_joint(cfg: ArchConfig, shape: ShapeConfig, hp: TrainHParams,
               hw: cm.HWConfig = cm.V5E,
               options: Sequence[int] = (2, 4, 8, 16),
               mem_cap: Optional[float] = None,
               time_limit: float = 20.0,
               layout: str = "auto",
               pp_options: Optional[Sequence[int]] = None,
               virtual_stages: int = 1,
               schedules: Optional[Sequence[str]] = None) -> JointPlanResult:
    """Joint (pp, per-stage TMP degrees, microbatch count) search.

    ``options`` name the TOTAL model-parallel capacity exactly as in
    :func:`plan` — a pp-stage candidate searches per-stage TMP degrees
    ``option / pp``, which hold per-chip weight memory constant across
    candidates (a stage owns 1/pp of the layers), so ``options=(16,)``
    expresses the same "weights must spread over 16 chips" regime whether
    the spread is one 16-way ring or 2 stages x 8-way rings.

    For every candidate stage count the per-layer TMP ILP runs on the
    *stage's* hardware slice (n_chips/pp chips, same node topology), then
    the pipeline-bubble + P2P terms compose the stage time into an
    iteration estimate (:func:`costmodel.pipeline_time`).  On commodity
    fixtures this is the AMP decision: stages across boxes (activations,
    thin) x TMP within a box (weight collectives, fat); on a uniform
    NVLink box the bubble buys nothing and the search stays TMP-only.
    Ties break toward lower pp, then fewer microbatches.
    """
    import dataclasses as _dc
    t0 = time.perf_counter()
    cap = mem_cap if mem_cap is not None else hw.hbm_cap
    v = max(virtual_stages, 1)
    pps = list(pp_options) if pp_options is not None \
        else _default_pp_options(cfg, hw, v)
    candidates: List[JointPlanResult] = []
    # (pp, m, opts) worklist first, so the per-ILP budget spreads
    # time_limit across ALL solves (floored at 1 s each — HiGHS under a
    # sub-second cap returns junk incumbents, so a long worklist can
    # overrun a very small time_limit by up to len(work) seconds)
    work: List[Tuple[int, int, List[int]]] = []
    for pp in pps:
        chips = max(hw.n_chips // pp, 1)
        # clamp (not filter) to the stage's chip count so tiny hosts —
        # e.g. a 1-device --calibrate run — still get a plan
        opts = sorted({min(max(int(n) // pp, 1), chips) for n in options})
        if not opts:
            continue
        for m in _default_microbatch_options(pp, v, shape):
            work.append((pp, m, opts))
            if pp == 1:
                break                      # microbatch=auto covers pp=1
    per_solve = max(time_limit / max(len(work), 1), 1.0)
    for pp, m, opts in work:
        hw_s = cm.stage_hw(hw, pp)
        hp_m = _dc.replace(hp, microbatch=m,
                           virtual_stages=v if pp > 1 else 1)
        pr = plan(cfg, shape, hp_m, hw_s, options=opts,
                  mem_cap=cap, time_limit=per_solve, layout=layout,
                  stages=pp, schedules=schedules)
        deg_max = max(cm._dtot(d) for d in pr.degrees)
        # executability: the runtime (pipeline.resolve_microbatch) needs
        # n_micro to divide the PER-SHARD batch under this plan's dp, not
        # just the global batch — clamp to the largest dividing count
        dp = max((hw.n_chips // pp) // max(deg_max, 1), 1)
        local = max(shape.global_batch // dp, 1)
        n_micro = min(max(m, 1), local)
        while n_micro > 1 and local % n_micro:
            n_micro -= 1
        if n_micro != max(m, 1):
            # the candidate's costs must describe the clamped count, not
            # the one the ILP was seeded with
            hp_m = _dc.replace(hp_m, microbatch=n_micro)
        # executable plan: a pp>1 plan must be strategy-uniform (stage-
        # internal TMP is uniform per stage) — collapse to the dominant
        # (max-degree) strategy when the per-stage ILP mixed, and rank the
        # candidate on the COLLAPSED strategy (what would actually run),
        # not the inexecutable mixed one
        pdeg, psched = list(pr.degrees), list(pr.schedules)
        if pp > 1 and len({(cm._dkey(d), s)
                           for d, s in zip(pdeg, psched)}) > 1:
            k = max(range(len(pdeg)), key=lambda i: cm._dtot(pdeg[i]))
            pdeg = [pdeg[k]] * len(pdeg)
            psched = [psched[k]] * len(psched)
        est = cm.estimate_iteration(cfg, shape, hp_m, pdeg,
                                    hw_s, opts, stages=pp,
                                    schedules=psched)
        t_hop = cm.p2p_hop_seconds(cfg, shape, hw, pp, n_micro,
                                   deg_max) if pp > 1 else 0.0
        total, bfrac, p2p = cm.pipeline_time(est["iter_s"], pp,
                                             n_micro, v, t_hop)
        candidates.append(JointPlanResult(
            pp=pp, n_micro=n_micro,
            virtual_stages=v if pp > 1 else 1,
            degrees=pdeg, predicted_s=total,
            tmp_s=est["iter_s"], bubble_fraction=bfrac, p2p_s=p2p,
            mem_bytes=est["mem_bytes"],
            fits=est["mem_bytes"] < cap,
            tmp_only_s=0.0, solve_ms=0.0, status=pr.status,
            groups=_runs(pdeg), schedules=psched,
            plan=_as_plan(hp, pdeg, psched, pp=pp,
                          virtual_stages=v if pp > 1 else 1,
                          microbatch=n_micro if pp > 1 else hp.microbatch,
                          **(dict(zip(("mesh_shape", "mesh_axes"),
                                      _mesh_sig(hw, pp, pdeg[0])))
                             if pp > 1 else {}))))
    if not candidates:
        raise ValueError(
            f"no feasible (pp, degree) candidates for {cfg.name} on "
            f"{hw.n_chips} chips with options {tuple(options)}")
    fitting = [c for c in candidates if c.fits] or candidates
    best = min(fitting, key=lambda c: (c.predicted_s, c.pp, c.n_micro))
    tmp_only = [c for c in candidates if c.pp == 1]
    best.tmp_only_s = min(c.predicted_s for c in tmp_only) if tmp_only \
        else float("inf")
    best.solve_ms = (time.perf_counter() - t0) * 1e3
    return _telemetry_plan("plan_joint", best)


# --------------------------------------------------------------------------
# serving-mesh search (objective="latency")
# --------------------------------------------------------------------------
@dataclass
class ServingPlanResult:
    degree: object                         # per-stage TMP degree: int | (dx, dy)
    pp: int                                # pipeline stages (1 = TMP-only)
    n_micro: int                           # decode micro-groups in flight
    predicted_s: float                     # per-engine-step (per-token) latency
    tok_per_s: float                       # batch tokens per step / latency
    mem_bytes: float
    fits: bool
    tmp_only_s: float                      # best pp=1 candidate (baseline)
    solve_ms: float
    status: str
    plan: Optional[object] = None          # executable ParallelPlan
    spec_k: int = 0                        # chosen speculative depth (0 = off)
    page_size: int = 0                     # paged-KV block size (0 = dense)

    @property
    def dxy(self) -> Tuple[int, int]:
        return cm._dxy(self.degree)

    def summary(self) -> str:
        spec = f" spec_k={self.spec_k}" if self.spec_k else ""
        return (f"serve pp={self.pp} x [{_fmt_degree(self.degree)}]"
                f"{spec} m={self.n_micro} predicted "
                f"{self.predicted_s*1e3:.2f} ms/token "
                f"({self.tok_per_s:.0f} tok/s; tmp-only "
                f"{self.tmp_only_s*1e3:.2f} ms; {self.status})")


def plan_serving(cfg: ArchConfig, shape: ShapeConfig, hp: TrainHParams,
                 hw: cm.HWConfig = cm.V5E,
                 options: Sequence[int] = (2, 4, 8, 16),
                 mem_cap: Optional[float] = None,
                 layout: str = "auto",
                 pp_options: Optional[Sequence[int]] = None,
                 virtual_stages: int = 1,
                 spec_options: Sequence[int] = (0,),
                 draft: Optional[ArchConfig] = None,
                 spec_accept: float = 0.8,
                 page_size: int = 0) -> ServingPlanResult:
    """Search ``(dx, dy, pp)`` serving meshes for minimum per-token decode
    latency (``costmodel.decode_step_time``).

    ``options`` name the TOTAL model-parallel capacity exactly as in
    :func:`plan`/:func:`plan_joint`: a pp-stage candidate shards each
    stage ``option / pp`` ways, holding per-chip weight memory constant
    across candidates.  ``shape`` describes the serving point —
    ``global_batch`` concurrent decode slots at KV context ``seq_len``
    (e.g. ``configs.base.DECODE_32K``).  At these shapes collectives are
    latency-bound, so on commodity fixtures wide 1D rings that span boxes
    lose to 2D splits or cross-box pipeline stages; on a uniform NVLink
    box the 1D ring stays optimal.  Ties break toward fewer stages, then
    the 1D layout, then the thinnest y split, then the smallest spec_k.

    ``spec_options`` adds speculative depths to the search (``draft`` is
    the proposer ArchConfig, required for any k > 0; ``spec_accept`` is
    the modeled per-token acceptance rate).  Speculation composes with
    pp=1 candidates only (``lm.build_verify`` rejects pipe meshes), so a
    pipeline candidate competes at k=0.  The latency floor the verify
    amortizes is exactly the per-layer collective latency, so commodity
    fixtures pick k > 1 while a uniform fast box keeps k at 0 or 1
    (pinned in tests/test_planner_golden.py).  ``page_size`` threads the
    paged-KV gather discount into every candidate.
    """
    t0 = time.perf_counter()
    cap = mem_cap if mem_cap is not None else hw.hbm_cap
    v = max(virtual_stages, 1)
    spec_ks = sorted({int(k) for k in spec_options})
    if any(k > 0 for k in spec_ks) and draft is None:
        raise ValueError(
            f"spec_options {tuple(spec_options)} include k > 0 but no "
            f"draft model was given — pass draft=<ArchConfig> (e.g. "
            f"get_config('gpt-draft-h2048'))")
    candidates = []
    for n_total in (int(n) for n in options):
        pps = list(pp_options) if pp_options is not None \
            else _default_pp_options(cfg, hw, v)
        for pp in pps:
            if n_total % pp or n_total // pp < 1:
                continue
            n_s = n_total // pp
            for deg in expand_options(cfg, hw, [n_s], layout):
                for k in spec_ks:
                    if k > 0 and pp > 1:
                        continue
                    est = cm.decode_step_time(
                        cfg, shape, hp, hw, deg, pp, virtual_stages=v,
                        page_size=page_size, spec_k=k,
                        spec_accept=spec_accept,
                        draft=draft if k > 0 else None)
                    dx, dy = cm._dxy(deg)
                    fits = est["mem_bytes"] < cap
                    candidates.append((est["step_s"], pp, dy, dx, k, deg,
                                       est, fits))
    if not candidates:
        raise ValueError(
            f"no feasible (degree, pp) serving candidates for {cfg.name} "
            f"on {hw.n_chips} chips with options {tuple(options)}")
    fitting = [c for c in candidates if c[7]] or candidates
    best = min(fitting, key=lambda c: c[:5])
    tmp_only = [c for c in candidates if c[1] == 1 and c[4] == 0]
    _, pp, _, _, spec_k, deg, est, fits = best
    return _telemetry_plan("plan_serving", ServingPlanResult(
        degree=deg, pp=pp, n_micro=est["n_micro"],
        predicted_s=est["step_s"], tok_per_s=est["tok_per_s"],
        mem_bytes=est["mem_bytes"], fits=fits,
        tmp_only_s=min(c[0] for c in tmp_only) if tmp_only else float("inf"),
        solve_ms=(time.perf_counter() - t0) * 1e3,
        status="fits" if fits else "over-memory",
        spec_k=spec_k, page_size=page_size,
        plan=_as_plan(hp, [deg] * cfg.num_layers,
                      [hp.schedule] * cfg.num_layers, pp=pp,
                      virtual_stages=v if pp > 1 else 1,
                      decode_micro=est["n_micro"] if pp > 1 else 0,
                      **dict(zip(("mesh_shape", "mesh_axes"),
                                 _mesh_sig(hw, pp, deg))))))
