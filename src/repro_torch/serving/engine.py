"""Batched serving engine (``repro.serving.engine`` on one device): a
dense per-slot decode state by default, or GLOBAL_ATTN k/v in a paged
pool (``paged=True``).

The engine owns ``slots`` decode rows.  Requests are admitted into free
slots, every step decodes one token for all slots (prompts are
teacher-forced through decode steps, as in the JAX engine), and finished
sequences free their slots.  Every layer kind serves: the state is
:func:`~repro_torch.models.params.cache_specs`' tree (local-attention
rings, RG-LRU and SSD states, the context's K/V, which stay zeros, as in
JAX's engine, since no prefill fills them), and paging swaps only the
global layers' k/v for pools.  The host logic (admission, reservations,
prefix reuse, copy-on-write, release audits, ``stats``) is the JAX
engine's, line for line, so both engines emit the same tokens in the same
number of steps.  As in JAX, a slot's dense or recurrent state is not
cleared between requests (positions mask stale k/v; recurrent states
carry on).  Telemetry (:mod:`repro_torch.obs`) records JAX's
``serving.*`` metrics: queue depth, slot occupancy, free pages and the
prefix hit rate each tick, the decode step time, TTFT and decoded tokens,
and the drain's wall time and throughput.  Speculative decoding (and its
metrics) is not ported yet (ROADMAP.md queue A, A5).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import GLOBAL_ATTN, ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import lm
from repro_torch.models import params as prm
from repro_torch.serving.paged_cache import PagedKVCache


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

    ``paged`` puts GLOBAL_ATTN k/v in a pool of ``pages`` physical pages
    of ``page_size`` tokens (0 = auto-size so every slot can reach
    ``max_seq``, plus the null page); ``prefix_cache`` (requires
    ``paged`` and an all-global-attention pattern) reuses cached prompt
    blocks across requests.

    ``device``: ``None`` means the card and raises when there is none;
    pass ``"cpu"`` to run the plain PyTorch versions of the kernels.

    ``telemetry``: a :mod:`repro_torch.obs` recorder; None resolves the
    process-global one on each tick, so a launcher's ``--telemetry``
    reaches an engine built before it."""

    def __init__(self, cfg: ArchConfig, *, slots: int, max_seq: int,
                 eos_id: int = 2, prefill_len: Optional[int] = None,
                 paged: bool = False, pages: int = 0, page_size: int = 16,
                 prefix_cache: bool = False, device=None, telemetry=None):
        prm.check_supported(cfg)
        self.cfg = cfg
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
        if prefix_cache:
            _, pat, tail = prm.stack_layout(cfg)
            other = sorted((set(pat) | set(tail)) - {GLOBAL_ATTN})
            if other:
                raise ValueError(
                    f"prefix cache requires an all-global-attention layer "
                    f"pattern; {cfg.name} mixes in {other} — skipping "
                    f"prefill for a shared span cannot reconstruct "
                    f"ring-buffer or recurrent layer states")
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
                                           paged=ptuple)

        self.params: Optional[Dict[str, Any]] = None
        self.state: Optional[Dict[str, Any]] = None
        self.pos = np.zeros((slots,), np.int32)
        self.cur_tok = np.zeros((slots,), np.int32)
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
        self._telemetry = telemetry

    @property
    def rec(self):
        return (self._telemetry if self._telemetry is not None
                else obs.get_recorder())

    def load(self, seed: int = 0, params: Optional[Dict[str, Any]] = None):
        """Random weights from ``seed`` (or the given weights, e.g. from
        :func:`repro_torch.models.params.from_flat`) and a zero state."""
        self.params = params if params is not None else prm.init_params(
            self.cfg, seed=seed, device=self.device,
            max_pos=self.max_seq + 8)
        self.state = prm.zeros_state(self.cfg, self.state_specs,
                                     device=self.device)

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
                                            shared_pages=len(shared)):
                    # cache-full backpressure: park the request at the
                    # head of the line until a release frees enough blocks
                    self._pending = req
                    self.rec.counter("serving.admission_deferred", 1)
                    return
                self.paged.admit(s, len(req.prompt), req.max_new_tokens,
                                 shared=shared)
                if hit:
                    self.stats["prefix_hits"] += 1
                    self.stats["prefix_hit_tokens"] += hit
            self.active[s] = req
            self.pos[s] = hit
            self.cur_tok[s] = int(req.prompt[hit])
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
        slots."""
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
        self._plain_step(rec)

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
        tokens = torch.from_numpy(self.cur_tok.copy()).to(self.device)
        pos = torch.from_numpy(self.pos.copy()).to(self.device)
        with obs.trace_annotation("engine_tick"):
            next_tok = lm.decode_step(self.cfg, self.params, self.state,
                                      tokens, pos, *extra)
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
        return out
