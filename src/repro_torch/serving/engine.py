"""Batched serving engine (``repro.serving.engine``): a dense per-slot
decode state by default, or GLOBAL_ATTN k/v in a paged pool
(``paged=True``), on one device or a mesh of rank processes, with or
without a draft model.

The engine owns ``slots`` decode rows.  Requests are admitted into free
slots, every step decodes one token for all slots (prompts are
teacher-forced through decode steps, as in the JAX engine), and finished
sequences free their slots.  Every layer kind serves at tp=1: the state
is :func:`~repro_torch.models.params.cache_specs`' tree (local-attention
rings, RG-LRU and SSD states, the context's K/V, which stay zeros, as in
JAX's engine, since no prefill fills them), and paging swaps only the
global layers' k/v for pools.  The host logic (admission, reservations,
prefix reuse, copy-on-write, release audits, ``stats``) is the JAX
engine's, line for line, so both engines emit the same tokens in the same
number of steps.  As in JAX, a slot's dense or recurrent state is not
cleared between requests (positions mask stale k/v; recurrent states
carry on).

Parallel serving (``mesh``): the engine runs in every rank process of a
mesh (SPMD), each rank holding its shard of the weights and of the state
(the kv-head dim, as :class:`~repro_torch.models.params.ModelLayout` and
``cache_specs`` lay them out), and decodes under the training schedules
at decode shapes (``lm.decode_step`` over a
:class:`~repro_torch.core.schedule.TmpCtx`: 1-D and 2-D; ``fused`` rings
the exits over the slot batch).  The greedy token is gathered over the
vocab shards before the host reads it, so every rank makes the same host
decisions.  The dense all-global archs serve at tp > 1; a ``data`` axis
above 1 (slots sharded over it, as in JAX) and pipelines are refused.

Speculative decoding (``draft=<ArchConfig>, spec_k=k``): the draft, on
the same mesh with its own dense state, proposes ``k`` tokens a round
after one catch-up step that re-consumes ``prev_tok`` (repairing its
cache after a rejected tail); the target verifies all ``k + 1`` tokens in
one batched ``lm.verify_step`` and the engine accepts the longest
agreeing run, which is exactly undrafted decode's tokens.

Telemetry (:mod:`repro_torch.obs`) records JAX's ``serving.*`` metrics:
queue depth, slot occupancy, free pages, the prefix hit rate and the
speculative accept rate each tick, the decode step time, TTFT and decoded
tokens, and the drain's wall time and throughput.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import GLOBAL_ATTN, ArchConfig, TrainHParams
from repro_torch.core.axes import RankMesh, deg_total, mesh_info
from repro_torch.core.comm import Comm, MeshComm, SoloComm
from repro_torch.core.device import resolve_device
from repro_torch.core.pipeline import PIPE_ITEM
from repro_torch.core.schedule import TmpCtx
from repro_torch.models import lm
from repro_torch.models import params as prm
from repro_torch.serving.paged_cache import PagedKVCache

# the ROADMAP.md item that keeps what the engine's mesh does not take yet
DATA_SLOTS_ITEM = ("ROADMAP.md A5, slots sharded over a data axis: the "
                   "engine takes a data axis of 1")


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [prompt_len] int32
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


class ServingEngine:
    """``prefill_len`` is the admission contract: the longest prompt a
    request may carry (default ``max_seq // 2``).

    ``mesh``: None (one device), a :class:`~repro_torch.core.comm.
    MeshComm` (a rank of a mesh, as ``launch/ranks.run_ranks`` hands it;
    its model axes are the group) or one group's Comm (the 1-D group of
    the whole model).  ``schedule`` and ``tmp_layout`` pick the decode's
    TMP schedule and layout, as training's.

    ``plan``: an executable :class:`~repro_torch.core.plan.ParallelPlan`
    (JAX's checks): its schedule (the primary one of mixed per-layer
    schedules, all token-identical at decode) and layout apply; mixed
    per-layer degrees, a degree other than the mesh's model group and a
    pipeline raise; ring-attention seq shards are recorded
    (``serving.seq_shard_ignored``) and decode serves head-sharded.

    ``paged`` puts GLOBAL_ATTN k/v in a pool of ``pages`` physical pages
    of ``page_size`` tokens (0 = auto-size so every slot can reach
    ``max_seq``, plus the null page); ``prefix_cache`` (requires
    ``paged`` and an all-global-attention pattern) reuses cached prompt
    blocks across requests.  ``draft`` + ``spec_k`` turn on speculative
    decoding (greedy, token-identical to undrafted decode).

    ``device``: ``None`` means the card and raises when there is none;
    pass ``"cpu"`` to run the plain PyTorch versions of the kernels.

    ``telemetry``: a :mod:`repro_torch.obs` recorder; None resolves the
    process-global one on each tick, so a launcher's ``--telemetry``
    reaches an engine built before it."""

    def __init__(self, cfg: ArchConfig, mesh=None, *, slots: int,
                 max_seq: int, eos_id: int = 2,
                 prefill_len: Optional[int] = None,
                 schedule: str = "oases", tmp_layout: str = "auto",
                 plan=None, paged: bool = False, pages: int = 0,
                 page_size: int = 16, prefix_cache: bool = False,
                 draft: Optional[ArchConfig] = None, spec_k: int = 0,
                 device=None, telemetry=None):
        prm.check_supported(cfg)
        self.cfg = cfg
        self._telemetry = telemetry
        self.comm, info = _mesh_of(mesh)
        self.plan = plan
        hp = TrainHParams(schedule=schedule, tmp_layout=tmp_layout)
        if info.dp > 1:
            raise NotImplementedError(
                f"the port's engine serves on a data axis of 1, got a "
                f"mesh {dict(zip(info.mesh.axis_names, info.mesh.shape))} "
                f"({DATA_SLOTS_ITEM})")
        if info.pp > 1:
            raise NotImplementedError(f"a pipeline mesh ({PIPE_ITEM})")
        if plan is not None:
            plan.validate_for(cfg)
            degs = {d for d in plan.degrees}
            if len(degs) > 1:
                raise ValueError(
                    f"plan {plan.summary()} pins mixed per-layer TMP "
                    f"degrees — the grouped layout is training-only; "
                    f"serve with a uniform-degree plan (e.g. "
                    f"plan(objective='latency').plan)")
            deg = next(iter(degs))
            if deg is not None and deg_total(deg) != info.tp:
                raise ValueError(
                    f"plan {plan.summary()} pins TMP degree {deg} but the "
                    f"mesh's model group is {info.tp}-way — launch with "
                    f"the plan's recorded mesh (serve.py --plan rebuilds "
                    f"it) or a matching --mesh")
            if plan.pp > 1:
                raise NotImplementedError(
                    f"plan {plan.summary()} expects pp={plan.pp} "
                    f"({PIPE_ITEM})")
            hp = plan.apply(hp)
            if plan.has_seq_layers or plan.seq_shard > 1:
                # the plan carries ring-attention seq shards for
                # provenance; decode serves head-sharded
                self.rec.event(
                    "serving.seq_shard_ignored",
                    f"plan {plan.summary()} carries ring-attention seq "
                    f"shards; decode serves head-sharded (the KV ring "
                    f"spans training sequences, not the decode cache)",
                    seq_shard=plan.seq_shard)
        self.ctx = TmpCtx(self.comm, schedule=hp.schedule,
                          layout=hp.tmp_layout)
        self.info = info
        self.rank = self.comm.rank
        self.layout = prm.ModelLayout(cfg, info, layout=hp.tmp_layout,
                                      max_pos=max_seq + 8)
        lm.check_servable(cfg, self.ctx)
        self.device = resolve_device(device)
        self.slots = slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        if prefill_len is None:
            prefill_len = max(max_seq // 2, 1)
        if not 1 <= prefill_len < max_seq:
            raise ValueError(
                f"prefill_len {prefill_len} must be in [1, max_seq) = "
                f"[1, {max_seq}) — a prompt-full slot needs at least one "
                f"position of decode headroom")
        self.prefill_len = prefill_len
        if prefix_cache and not paged:
            raise ValueError(
                "prefix_cache requires paged=True — prefix reuse maps "
                "cached KV *pages* into the new slot's block table; the "
                "dense per-slot cache has no shareable unit")
        if (spec_k > 0) != (draft is not None):
            raise ValueError(
                "speculative decoding needs both a draft model and "
                "spec_k >= 1 (serve.py --draft <config> --spec-k k); got "
                f"spec_k={spec_k}, draft="
                f"{draft.name if draft is not None else None}")
        if prefix_cache:
            _, pat, tail = prm.stack_layout(cfg)
            other = sorted((set(pat) | set(tail)) - {GLOBAL_ATTN})
            if other:
                raise ValueError(
                    f"prefix cache requires an all-global-attention layer "
                    f"pattern; {cfg.name} mixes in {other} — skipping "
                    f"prefill for a shared span cannot reconstruct "
                    f"ring-buffer or recurrent layer states")
        self.spec_k = int(spec_k)
        self.draft_cfg = draft
        if draft is not None and draft.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft model {draft.name} has vocab {draft.vocab_size} "
                f"but target {cfg.name} has {cfg.vocab_size} — draft "
                f"proposals must live in the target's token space")
        self.paged: Optional[PagedKVCache] = None
        ptuple = None
        if paged:
            if pages <= 0:
                pages = slots * (max_seq // max(page_size, 1)) + 1
            self.paged = PagedKVCache(pages=pages, page_size=page_size,
                                      slots=slots, max_seq=max_seq,
                                      prefix_cache=prefix_cache)
            ptuple = (pages, page_size)
        self.state_specs = prm.cache_specs(cfg, batch=slots, seq=max_seq,
                                           paged=ptuple, info=info,
                                           layout=hp.tmp_layout)
        if self.spec_k:
            lm.check_verifiable(cfg)
            lm.check_servable(draft, self.ctx)
            # the draft serves its own dense cache on the same mesh; its
            # rows are freely rewritten when a rejection rewinds pos
            # (stale rows beyond pos are position-masked, and every
            # revisited position is rewritten before it is attended)
            self.draft_layout = prm.ModelLayout(draft, info,
                                                layout=hp.tmp_layout,
                                                max_pos=max_seq + 8)
            self.draft_state_specs = prm.cache_specs(
                draft, batch=slots, seq=max_seq, info=info,
                layout=hp.tmp_layout)
        self.draft_params: Optional[Dict[str, Any]] = None
        self.draft_state: Optional[Dict[str, Any]] = None

        self.params: Optional[Dict[str, Any]] = None
        self.state: Optional[Dict[str, Any]] = None
        self.pos = np.zeros((slots,), np.int32)
        self.cur_tok = np.zeros((slots,), np.int32)
        # token at pos-1 per slot: the speculative catch-up input that
        # repairs the draft cache after a rejected tail
        self.prev_tok = np.zeros((slots,), np.int32)
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: Deque[Request] = deque()
        self._pending: Optional[Request] = None
        self.stats = {"decoded_tokens": 0, "steps": 0, "admitted": 0,
                      "prompt_tokens": 0, "prefix_hits": 0,
                      "prefix_hit_tokens": 0, "spec_proposed": 0,
                      "spec_accepted": 0}
        # host wall time of each decode step (ends in the device->host copy
        # of the next tokens, so it includes the device work)
        self.step_s: List[float] = []

    @property
    def rec(self):
        return (self._telemetry if self._telemetry is not None
                else obs.get_recorder())

    def load(self, seed: int = 0, params: Optional[Dict[str, Any]] = None,
             draft_params: Optional[Dict[str, Any]] = None):
        """This rank's weights (``params``: e.g. :func:`repro_torch.models.
        params.from_flat` cut by ``self.layout.shard``; the whole weights
        at tp=1), or random weights from ``seed`` (this rank's shards of
        them, drawn a leaf at a time: ``ModelLayout.init_shard``), and a
        zero state; the draft's from ``seed + 1``, as JAX's engine."""
        self.params = (params if params is not None
                       else self._random(self.cfg, self.layout, seed))
        self.state = prm.zeros_state(self.cfg, self.state_specs,
                                     device=self.device, info=self.info)
        if self.spec_k:
            self.draft_params = (
                draft_params if draft_params is not None
                else self._random(self.draft_cfg, self.draft_layout,
                                  seed + 1))
            self.draft_state = prm.zeros_state(
                self.draft_cfg, self.draft_state_specs, device=self.device,
                info=self.info)

    def _random(self, cfg: ArchConfig, layout, seed: int):
        if self.ctx.tp_total == 1:
            return prm.init_params(cfg, seed=seed, device=self.device,
                                   max_pos=layout.max_pos)
        return layout.init_shard(self.rank, seed=seed, device=self.device)

    @property
    def queued(self) -> int:
        """Requests waiting for a free slot, including one held back by
        cache-full backpressure."""
        return len(self.queue) + (self._pending is not None)

    def submit(self, req: Request):
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if len(req.prompt) > self.prefill_len:
            raise ValueError(
                f"request {req.rid}: prompt of {len(req.prompt)} tokens "
                f"exceeds prefill_len={self.prefill_len} (engine admission "
                f"contract; raise --prefill-len / max_seq or chunk the "
                f"prompt)")
        req._submit_t = time.perf_counter()   # TTFT clock starts here
        self.queue.append(req)

    def _next_request(self) -> Optional[Request]:
        if self._pending is not None:
            req, self._pending = self._pending, None
            return req
        return self.queue.popleft() if self.queue else None

    def _admit(self):
        for s in range(self.slots):
            if self.active[s] is not None:
                continue
            req = self._next_request()
            if req is None:
                return
            hit = 0
            if self.paged is not None:
                shared, span = self.paged.lookup(req.prompt)
                # keep at least one prompt token to consume: the engine's
                # first step on the slot must produce a next-token
                hit = min(span, len(req.prompt) - 1)
                if not self.paged.can_admit(len(req.prompt),
                                            req.max_new_tokens,
                                            shared_pages=len(shared),
                                            headroom=self.spec_k):
                    # cache-full backpressure: park the request at the
                    # head of the line until a release frees enough blocks
                    self._pending = req
                    self.rec.counter("serving.admission_deferred", 1)
                    return
                self.paged.admit(s, len(req.prompt), req.max_new_tokens,
                                 headroom=self.spec_k, shared=shared)
                if hit:
                    self.stats["prefix_hits"] += 1
                    self.stats["prefix_hit_tokens"] += hit
            self.active[s] = req
            self.pos[s] = hit
            self.cur_tok[s] = int(req.prompt[hit])
            self.prev_tok[s] = int(req.prompt[max(hit - 1, 0)])
            req._prompt_cursor = hit + 1
            req._inserted = False
            self.stats["admitted"] += 1
            self.stats["prompt_tokens"] += len(req.prompt)

    # ------------------------------------------------------------------
    # paged plumbing
    # ------------------------------------------------------------------
    def _paged_args(self, cow: List[Tuple[int, int]]):
        """Device tensors (tables, cow_src, cow_dst).  Only the real COW
        pairs are passed: eager PyTorch needs no fixed-length padding."""
        if len(cow) > self.slots:
            raise RuntimeError(
                f"{len(cow)} COW copies in one step exceeds the capacity of "
                f"{self.slots} — at most one shared block can enter a "
                f"slot's write range per step")
        pairs = np.asarray(cow, np.int32).reshape(-1, 2)
        dev = self.device
        return (torch.from_numpy(self.paged.table.copy()).to(dev),
                torch.from_numpy(pairs[:, 0].copy()).to(dev),
                torch.from_numpy(pairs[:, 1].copy()).to(dev))

    def _maybe_insert_prefix(self, s: int):
        """Index the slot's prompt blocks once the full prompt is written
        (before any release, so the pages outlive the slot)."""
        req = self.active[s]
        if (self.paged is None or not self.paged.prefix_enabled
                or req is None or req._inserted
                or self.pos[s] < len(req.prompt)):
            return
        self.paged.insert(s, req.prompt)
        req._inserted = True

    def _release_slot(self, s: int):
        self.active[s] = None
        if self.paged is not None:
            self.paged.release(s)
            self.paged.check()
            self._check_invariants()

    def _check_invariants(self):
        """Released slots map nothing, and every non-null page is either
        free or held (slot tables / prefix index) — no leaked limbo."""
        pc = self.paged
        for s in range(self.slots):
            if self.active[s] is None and pc.mapped(s):
                raise RuntimeError(
                    f"slot {s} is free but still maps {pc.mapped(s)} "
                    f"pages — release leaked blocks")
        held = {int(pg) for srow in pc.table for pg in srow if pg}
        held |= {e.page for e in pc._index.values()}
        if len(held) + pc.free_pages != pc.pages - 1:
            raise RuntimeError(
                f"page conservation violated: {len(held)} held + "
                f"{pc.free_pages} free != {pc.pages - 1} allocatable")

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def step(self):
        """One engine iteration: admit, then decode one token for all
        slots (or one speculative round of up to ``spec_k + 1``)."""
        rec = self.rec
        self._admit()
        rec.gauge("serving.queue_depth", self.queued)
        rec.gauge("serving.slot_occupancy",
                  sum(a is not None for a in self.active) / self.slots)
        if self.paged is not None:
            rec.gauge("serving.free_pages", self.paged.free_pages)
            if self.paged.prefix_enabled and self.stats["prompt_tokens"]:
                rec.gauge("serving.prefix_hit_rate",
                          self.stats["prefix_hit_tokens"]
                          / self.stats["prompt_tokens"])
        if self.spec_k:
            if self.stats["spec_proposed"]:
                rec.gauge("serving.spec_accept_rate",
                          self.stats["spec_accepted"]
                          / self.stats["spec_proposed"])
            self._spec_step(rec)
        else:
            self._plain_step(rec)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _plain_step(self, rec):
        t0 = time.perf_counter()
        extra = ()
        if self.paged is not None:
            cow: List[Tuple[int, int]] = []
            for s in range(self.slots):
                if self.active[s] is not None:
                    cow += self.paged.ensure_writable(
                        s, int(self.pos[s]), int(self.pos[s]))
            extra = self._paged_args(cow)
        tokens = self._tensor(self.cur_tok.copy())
        pos = self._tensor(self.pos.copy())
        with obs.trace_annotation("engine_tick"):
            next_tok = lm.decode_step(self.cfg, self.params, self.state,
                                      tokens, pos, *extra, ctx=self.ctx)
            next_tok = next_tok.cpu().numpy()
        now = time.perf_counter()
        self.step_s.append(now - t0)
        rec.observe("serving.decode_step_s", now - t0)
        self.stats["steps"] += 1
        decoded = 0
        for s in range(self.slots):
            req = self.active[s]
            if req is None:
                continue
            self.pos[s] += 1
            self.prev_tok[s] = self.cur_tok[s]
            self._maybe_insert_prefix(s)
            cur = getattr(req, "_prompt_cursor", len(req.prompt))
            if cur < len(req.prompt):       # still consuming the prompt
                self.cur_tok[s] = int(req.prompt[cur])
                req._prompt_cursor = cur + 1
                continue
            tok = int(next_tok[s])
            if not req.out_tokens and hasattr(req, "_submit_t"):
                rec.observe("serving.ttft_s", now - req._submit_t,
                            rid=req.rid)
            req.out_tokens.append(tok)
            self.stats["decoded_tokens"] += 1
            decoded += 1
            self.cur_tok[s] = tok
            if (tok == self.eos_id
                    or len(req.out_tokens) >= req.max_new_tokens
                    or self.pos[s] >= self.max_seq - 1):
                req.done = True
                self._release_slot(s)
        if decoded:
            rec.counter("serving.decoded_tokens", decoded)

    # ------------------------------------------------------------------
    # speculative decoding
    # ------------------------------------------------------------------
    def _spec_step(self, rec):
        """One speculative round: k+1 draft steps (one catch-up plus k
        proposals), one batched verify, host-side longest-agreeing-run
        acceptance.  Greedy-token-identical to undrafted decode."""
        k = self.spec_k
        t0 = time.perf_counter()
        pos0 = self.pos.copy()
        # tok_block[:, j] is the token at absolute position pos0 + j;
        # column 0 is cur_tok, prompt positions are teacher-forced over
        # whatever the draft proposes
        tok_block = np.zeros((self.slots, k + 1), np.int32)
        tok_block[:, 0] = self.cur_tok

        def forced(s: int, j: int) -> Optional[int]:
            req = self.active[s]
            p = int(pos0[s]) + j
            if req is not None and p < len(req.prompt):
                return int(req.prompt[p])
            return None

        with obs.trace_annotation("spec_draft"):
            # catch-up: re-consume prev_tok at pos-1 so the draft cache
            # row the last rejection left stale is repaired before the
            # draft attends through it; its output is discarded
            lm.decode_step(self.draft_cfg, self.draft_params,
                           self.draft_state, self._tensor(self.prev_tok),
                           self._tensor(np.maximum(pos0 - 1, 0)),
                           ctx=self.ctx)
            for j in range(1, k + 1):
                nt = lm.decode_step(
                    self.draft_cfg, self.draft_params, self.draft_state,
                    self._tensor(tok_block[:, j - 1]),
                    self._tensor(np.minimum(pos0 + (j - 1),
                                            self.max_seq - 1)),
                    ctx=self.ctx)
                prop = nt.cpu().numpy()
                for s in range(self.slots):
                    f = forced(s, j)
                    tok_block[s, j] = int(prop[s]) if f is None else f

        extra = ()
        if self.paged is not None:
            cow: List[Tuple[int, int]] = []
            for s in range(self.slots):
                if self.active[s] is not None:
                    cow += self.paged.ensure_writable(
                        s, int(pos0[s]), int(pos0[s]) + k)
            extra = self._paged_args(cow)
        with obs.trace_annotation("spec_verify"):
            choices = lm.verify_step(self.cfg, self.params, self.state,
                                     self._tensor(tok_block),
                                     self._tensor(pos0), *extra,
                                     ctx=self.ctx).cpu().numpy()
        now = time.perf_counter()
        self.step_s.append(now - t0)
        rec.observe("serving.decode_step_s", now - t0)
        self.stats["steps"] += 1

        decoded = 0
        for s in range(self.slots):
            req = self.active[s]
            if req is None:
                continue
            plen = len(req.prompt)
            self.stats["spec_proposed"] += sum(
                1 for j in range(1, k + 1) if int(pos0[s]) + j >= plen)
            j = 0
            stop = False
            nxt_pos = int(pos0[s]) + 1
            nxt_tok = int(tok_block[s, 0])
            while True:
                # consume tok_block[s, j] at position pos0+j; the token at
                # pos0+j+1 is either the next forced prompt token or the
                # verifier's (== the undrafted oracle's) emission
                nxt_pos = int(pos0[s]) + j + 1
                if nxt_pos < plen:
                    nxt_tok = int(req.prompt[nxt_pos])
                    req._prompt_cursor = nxt_pos + 1
                else:
                    nxt_tok = int(choices[s, j])
                    if not req.out_tokens and hasattr(req, "_submit_t"):
                        rec.observe("serving.ttft_s", now - req._submit_t,
                                    rid=req.rid)
                    req.out_tokens.append(nxt_tok)
                    self.stats["decoded_tokens"] += 1
                    decoded += 1
                    if (nxt_tok == self.eos_id
                            or len(req.out_tokens) >= req.max_new_tokens):
                        stop = True
                if nxt_pos >= self.max_seq - 1:
                    stop = True
                if stop or j >= k:
                    break
                if int(tok_block[s, j + 1]) != nxt_tok:
                    break   # divergence — nxt_tok is the oracle correction
                if nxt_pos >= plen:
                    self.stats["spec_accepted"] += 1   # a proposal survived
                j += 1
            self.pos[s] = nxt_pos
            self.cur_tok[s] = nxt_tok
            self.prev_tok[s] = int(tok_block[s, j])
            self._maybe_insert_prefix(s)
            if stop:
                req.done = True
                self._release_slot(s)
        if decoded:
            rec.counter("serving.decoded_tokens", decoded)

    def run_until_drained(self, max_steps: int = 10_000) -> Dict:
        t0 = time.perf_counter()
        for _ in range(max_steps):
            if (not self.queue and self._pending is None
                    and all(a is None for a in self.active)):
                break
            self.step()
        dt = time.perf_counter() - t0
        rec = self.rec
        rec.gauge("serving.drain_s", dt)
        rec.gauge("serving.tok_per_s",
                  self.stats["decoded_tokens"] / max(dt, 1e-9))
        out = {**self.stats, "wall_s": dt,
               "tok_per_s": self.stats["decoded_tokens"] / max(dt, 1e-9)}
        if self.paged is not None:
            self.paged.check()
            self._check_invariants()
            out["paged"] = dict(self.paged.stats,
                                free_pages=self.paged.free_pages,
                                index_size=self.paged.index_size)
            if self.paged.prefix_enabled:
                hit = (self.stats["prefix_hit_tokens"]
                       / max(self.stats["prompt_tokens"], 1))
                rec.gauge("serving.prefix_hit_rate", hit)
                out["prefix_hit_rate"] = hit
        if self.spec_k:
            acc = (self.stats["spec_accepted"]
                   / max(self.stats["spec_proposed"], 1))
            rec.gauge("serving.spec_accept_rate", acc)
            out["spec_accept_rate"] = acc
        return out


def _mesh_of(mesh):
    """(the communicator, its MeshInfo) of the engine's ``mesh``: None ->
    one rank; a MeshComm as it is; one group's Comm -> the 1-D ``(1,
    size)`` mesh of ``("data", "model")``."""
    if mesh is None:
        mesh = SoloComm()
    if isinstance(mesh, MeshComm):
        return mesh, mesh.info
    if not isinstance(mesh, Comm):
        raise TypeError(f"mesh must be None, a MeshComm or a Comm, got "
                        f"{type(mesh).__name__}")
    return mesh, mesh_info(RankMesh((1, mesh.size), ("data", "model")))
