"""The port's decode on a TMP mesh against the JAX package on the CPU
(the gate of ``tests/_scripts/serving_equivalence.py`` parts 1, 2 and
6-8 at ``data`` 1): the serving engine in every rank process of a mesh
of gloo ranks, each rank on its shards of the weights and of the state,
decoding under the training schedules at decode shapes.

* tp=2 (``(1, 2)``) under ``megatron``, ``oases`` and ``fused``, dense
  and paged (page 8); the prefix cache under ``fused``; speculative
  decoding (a draft of the same reduced arch, ``spec_k`` 3) under
  ``fused``, dense and paged + prefix-cached; reduced ``granite-8b`` (a
  second GQA arch of the dense path) under ``fused`` and ``oases``;
* the 2-D layout ``(1, 2, 2)`` (heads over ``model_x``, d_model over
  ``model_y``) under ``oases`` and ``fused``, paged under ``oases``, and
  speculative decoding under ``oases``;
* every rank's tokens equal JAX's 1-device engine's (dense, undrafted)
  on the same weights and prompts; ``fused`` rings its exits over the
  slot batch (ring hops counted), the other schedules run none.

Reduced f32 ``internlm2-1.8b`` (4 q / 2 kv heads, vocab 512), 4 slots of
48 positions, 6 requests of 6 new tokens (JAX's recipe), weights drawn
with numpy (``_torch_family.numpy_params``); one rank spawn per mesh."""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_family import (SERVE_MAX_SEQ as MAX_SEQ, SERVE_NEW as NEW,
                           SERVE_SLOTS as SLOTS, cfgs, gate_prompts, mesh,
                           numpy_params, shared_prefix_prompts)
from repro.configs.base import TrainHParams as JTrainHParams
from repro.core import compat
from repro.models import params as jprm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.launch.ranks import run_ranks

import _torch_ranks

TIMEOUT = 240
ARCHS = ("internlm2-1.8b", "granite-8b")
XY = ((1, 2, 2), ("data", "model_x", "model_y"))
PAGED = dict(paged=True, page_size=8)
PREFIX = dict(paged=True, page_size=8, prefix_cache=True)


@functools.lru_cache(maxsize=None)
def oracle(arch):
    """JAX's 1-device dense engine on numpy weights (seed 0; the draft's
    seed 1): (flat, draft flat, {prompt set: tokens})."""
    jcfg, tcfg = cfgs(arch)
    jeng = JServingEngine(jcfg, mesh(), slots=SLOTS, max_seq=MAX_SEQ,
                          hp=JTrainHParams())
    flat = numpy_params(jeng.specs, seed=0)
    jeng.load(params=jprm.tree_from_flat(
        jeng.specs, {k: jnp.asarray(v) for k, v in flat.items()}))
    out = {}
    for name, make in (("plain", gate_prompts),
                       ("shared", shared_prefix_prompts)):
        reqs = [JRequest(rid=i, prompt=p, max_new_tokens=NEW)
                for i, p in enumerate(make(tcfg.vocab_size))]
        for r in reqs:
            jeng.submit(r)
        with compat.set_mesh(mesh()):
            jeng.run_until_drained()
        out[name] = [r.out_tokens for r in reqs]
    return flat, numpy_params(jeng.specs, seed=1), out


def _case(pset, vocab, **kw):
    make = gate_prompts if pset == "plain" else shared_prefix_prompts
    return dict(prompts=make(vocab), new=NEW, **kw)


def _tp2_cases(vocab):
    out = {}
    for s in ("megatron", "oases", "fused"):
        out[(s, "dense")] = _case("plain", vocab, schedule=s)
        out[(s, "paged")] = _case("plain", vocab, schedule=s, **PAGED)
    out[("fused", "prefix")] = _case("shared", vocab, schedule="fused",
                                     **PREFIX)
    out[("fused", "spec")] = _case("plain", vocab, schedule="fused",
                                   draft=True)
    out[("fused", "spec-paged-prefix")] = _case(
        "shared", vocab, schedule="fused", draft=True, **PREFIX)
    return out


@pytest.fixture(scope="module")
def served():
    """One spawn a mesh: tp=2 (internlm2's cases, then granite's) and
    2-D (1, 2, 2)."""
    res = {}
    _, tcfg = cfgs(ARCHS[0])
    vocab = tcfg.vocab_size
    jobs = {}
    for arch in ARCHS:
        flat, dflat, _ = oracle(arch)
        cases = (_tp2_cases(vocab) if arch == ARCHS[0] else {
            ("fused", "dense"): _case("plain", vocab, schedule="fused"),
            ("oases", "paged"): _case("plain", vocab, schedule="oases",
                                      **PAGED)})
        jobs[arch] = ("serve_cases", (arch, flat, dflat, cases))
    res["tp2"] = run_ranks(_torch_ranks.everything, 2, device="cpu",
                           threads=1, timeout=TIMEOUT, args=(jobs,))
    flat, dflat, _ = oracle(ARCHS[0])
    cases = {("oases", "dense"): _case("plain", vocab, schedule="oases"),
             ("fused", "dense"): _case("plain", vocab, schedule="fused"),
             ("oases", "paged"): _case("plain", vocab, schedule="oases",
                                       **PAGED),
             ("oases", "spec"): _case("plain", vocab, schedule="oases",
                                      draft=True)}
    res["2d"] = run_ranks(_torch_ranks.everything, device="cpu", threads=1,
                          timeout=TIMEOUT, mesh=XY,
                          args=({ARCHS[0]: ("serve_cases",
                                            (ARCHS[0], flat, dflat,
                                             cases))},))
    return res


def _want(arch, cache):
    return oracle(arch)[2]["shared" if "prefix" in cache else "plain"]


TP2 = [(ARCHS[0], s, c) for s in ("megatron", "oases", "fused")
       for c in ("dense", "paged")] + [
    (ARCHS[0], "fused", c) for c in ("prefix", "spec",
                                     "spec-paged-prefix")] + [
    (ARCHS[1], "fused", "dense"), (ARCHS[1], "oases", "paged")]


@pytest.mark.parametrize("arch,sched,cache", TP2)
def test_tp2_decode_equals_one_device_jax(served, arch, sched, cache):
    ranks = [r[arch][(sched, cache)] for r in served["tp2"]]
    want = _want(arch, cache)
    for rank, got in enumerate(ranks):
        assert got["tokens"] == want, (rank, arch, sched, cache)
    counts = ranks[0]["counts"]
    # fused rings every exit over the slot batch (or the verified block);
    # the other schedules all-reduce
    assert (counts["ring_shift"] > 0) == (sched == "fused"), counts
    if "spec" in cache:
        assert ranks[0]["stats"]["spec_proposed"] > 0


@pytest.mark.parametrize("sched,cache", [("oases", "dense"),
                                         ("fused", "dense"),
                                         ("oases", "paged"),
                                         ("oases", "spec")])
def test_2d_decode_equals_one_device_jax(served, sched, cache):
    want = _want(ARCHS[0], cache)
    for rank, r in enumerate(served["2d"]):
        got = r[ARCHS[0]][(sched, cache)]
        assert got["tokens"] == want, (rank, sched, cache)
        assert (got["counts"]["ring_shift"] > 0) == (sched == "fused")


@pytest.mark.parametrize("shape,rank", [(((1, 2), ("data", "model")), 1),
                                        (XY, 3)])
def test_init_shard_equals_shard_of_init_params(shape, rank):
    """A rank's random weights drawn a leaf at a time (what the engine
    loads on a mesh) are its shards of the whole model's, bit for bit."""
    import torch
    from repro_torch.core.axes import RankMesh, mesh_info
    from repro_torch.models import params as tprm

    _, tcfg = cfgs(ARCHS[1])
    lay = tprm.ModelLayout(tcfg, mesh_info(RankMesh(*shape)),
                           max_pos=MAX_SEQ + 8)
    want = tprm.flatten(lay.shard(
        tprm.init_params(tcfg, seed=3, max_pos=lay.max_pos), rank))
    got = tprm.flatten(lay.init_shard(rank, seed=3))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
