"""The port's speculative decoding against the JAX package on the CPU:
the engine with a draft model (``spec_k`` 3) against JAX's spec engine,
``lm.verify_step`` against ``build_verify``, the refusals, and the serve
CLI's mesh, plan and draft flags.

JAX's own gate is ``tests/_scripts/serving_equivalence.py`` part 8: the
reduced ``internlm2-1.8b`` in f32, 4 slots of 48 positions, 6 requests
of 6 new tokens, the draft the same reduced arch with other weights
(JAX's engine seeds it with seed + 1; here both sides take numpy weights
from seeds 0 and 1, ``_torch_family.numpy_params``), on dense, paged
(page 8) and paged + prefix-cached caches (its ``shared_prefix_prompts``,
copied into ``_torch_family``).  The port's spec engine gives JAX's spec engine's tokens
and ``stats`` (``spec_proposed`` and ``spec_accepted`` among them) and
undrafted decode's tokens.  ``verify_step`` gives ``build_verify``'s
choices and k/v leaves within 1e-6 (f32, the same products in another
order), also for a block that runs past ``max_seq - 1``."""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_family import (SERVE_MAX_SEQ, SERVE_NEW, SERVE_REQUESTS,
                           SERVE_SLOTS, cfgs, gate_prompts, jax_flat, mesh,
                           numpy_params, rel_err, shared_prefix_prompts)
from repro.configs.base import TrainHParams as JTrainHParams
from repro.core import compat
from repro.models import lm as jlm
from repro.models import params as jprm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs.base import LOCAL_ATTN
from repro_torch.core.axes import RankMesh
from repro_torch.core.comm import MeshComm, SoloComm
from repro_torch.core.plan import LayerStrategy, ParallelPlan
from repro_torch.core.schedule import TmpCtx
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models import params as tprm
from repro_torch.serving import Request, ServingEngine

ARCH = "internlm2-1.8b"
SLOTS, MAX_SEQ, N_REQ, NEW = (SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_REQUESTS,
                              SERVE_NEW)
SPEC_K = 3
KV_TOL = 1e-6


def drain(eng, ps, cls, new=NEW):
    reqs = [cls(rid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(ps)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert stats["admitted"] == N_REQ and all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], stats


@functools.lru_cache(maxsize=None)
def weights():
    """numpy weights of the reduced target (seed 0) and draft (seed 1)."""
    jcfg, _ = cfgs(ARCH)
    specs = jlm.build_decode(jcfg, mesh(), JTrainHParams(),
                             global_batch=SLOTS, seq_len=MAX_SEQ)[1]
    return numpy_params(specs, seed=0), numpy_params(specs, seed=1)


def _jparams(specs, flat):
    return jprm.tree_from_flat(specs, {k: jnp.asarray(v)
                                       for k, v in flat.items()})


# (name, engine options, prompts): JAX's part 8 cases at one device
CACHES = {"dense": ({}, gate_prompts),
          "paged": (dict(paged=True, page_size=8), gate_prompts),
          "prefix": (dict(paged=True, page_size=8, prefix_cache=True),
                     shared_prefix_prompts)}


@pytest.mark.parametrize("cache", list(CACHES))
def test_spec_engine_equals_jax_and_undrafted(cache):
    """The port's spec engine against JAX's on the same weights and
    draft: the same tokens and ``stats``; and undrafted decode's
    tokens (the port's undrafted engine on the same cache)."""
    kw, make = CACHES[cache]
    jcfg, tcfg = cfgs(ARCH)
    ps = make(tcfg.vocab_size)
    flat, dflat = weights()
    jeng = JServingEngine(jcfg, mesh(), slots=SLOTS, max_seq=MAX_SEQ,
                          draft=jcfg, spec_k=SPEC_K, **kw)
    jeng.load(params=_jparams(jeng.specs, flat),
              draft_params=_jparams(jeng.draft_specs, dflat))
    with compat.set_mesh(mesh()):
        jtok, jstats = drain(jeng, ps, JRequest)
    teng = ServingEngine(tcfg, slots=SLOTS, max_seq=MAX_SEQ, device="cpu",
                         draft=tcfg, spec_k=SPEC_K, **kw)
    teng.load(params=tprm.from_flat(tcfg, flat),
              draft_params=tprm.from_flat(tcfg, dflat))
    ttok, tstats = drain(teng, ps, Request)
    assert ttok == jtok
    assert teng.stats == jeng.stats
    assert tstats["spec_accept_rate"] == jstats["spec_accept_rate"]
    assert teng.stats["spec_proposed"] > 0
    plain = ServingEngine(tcfg, slots=SLOTS, max_seq=MAX_SEQ, device="cpu",
                          **kw)
    plain.load(params=tprm.from_flat(tcfg, flat))
    ptok, pstats = drain(plain, ps, Request)
    assert ptok == ttok
    assert pstats["steps"] > tstats["steps"] or cache == "prefix"


def test_self_draft_accepts_nearly_everything():
    """A draft with the target's own weights proposes the target's
    tokens: the same output as undrafted decode, an accept rate of at
    least 0.9, and fewer engine steps.  Requests take 32 new tokens here:
    the proposals of a round in which a request ends (at its last token
    or EOS) count as proposed and not accepted (JAX's accounting), which
    at 6 new tokens is 1 - 0.875 of them, every other proposal
    agreeing."""
    _, tcfg = cfgs(ARCH)
    flat, _ = weights()
    ps = gate_prompts(tcfg.vocab_size)
    out = {}
    for name, kw in (("plain", {}), ("self", dict(draft=tcfg,
                                                  spec_k=SPEC_K))):
        eng = ServingEngine(tcfg, slots=SLOTS, max_seq=MAX_SEQ,
                            device="cpu", **kw)
        eng.load(params=tprm.from_flat(tcfg, flat),
                 draft_params=tprm.from_flat(tcfg, flat) if kw else None)
        out[name] = drain(eng, ps, Request, new=32)
    assert out["self"][0] == out["plain"][0]
    assert out["self"][1]["spec_accept_rate"] >= 0.9
    assert out["self"][1]["steps"] < out["plain"][1]["steps"]


@functools.lru_cache(maxsize=None)
def _jax_verify(paged):
    jcfg, _ = cfgs(ARCH)
    fn, specs, st_specs = jlm.build_verify(
        jcfg, mesh(), JTrainHParams(), global_batch=SLOTS, seq_len=MAX_SEQ,
        paged=paged)
    return jax.jit(fn), specs, st_specs


@pytest.mark.parametrize("paged", [None, (4 * SLOTS * MAX_SEQ // 8 + 1, 8)])
def test_verify_step_matches_build_verify(paged):
    """``lm.verify_step`` against ``build_verify`` from one random state:
    four tokens a slot at positions from 0 to ``max_seq - 2`` (that
    slot's block runs past the last position: its rows clamp onto it);
    paged through tables of distinct real pages (no slot writes the null
    page).  Choices equal, every k/v leaf within 1e-6 relative."""
    jcfg, tcfg = cfgs(ARCH)
    fn, specs, st_specs = _jax_verify(paged)
    flat, _ = weights()
    rng = np.random.default_rng(4)
    jzero = jax_flat(jprm.zeros_state(st_specs))
    state = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in jzero.items()}
    tokens = rng.integers(3, tcfg.vocab_size, (SLOTS, SPEC_K + 1)) \
        .astype(np.int32)
    pos = np.array([0, 17, MAX_SEQ - 6, MAX_SEQ - 2], np.int32)
    extra, textra = (), ()
    if paged is not None:
        nb = MAX_SEQ // paged[1]
        tables = (rng.permutation(np.arange(1, paged[0]))[:SLOTS * nb]
                  .reshape(SLOTS, nb).astype(np.int32))
        cow = np.zeros((SLOTS,), np.int32)
        extra = (jnp.asarray(tables), jnp.asarray(cow), jnp.asarray(cow))
        textra = (torch.from_numpy(tables),)
    jstate = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jprm.zeros_state(st_specs)),
        [jnp.asarray(state[k]) for k in jzero])
    with compat.set_mesh(mesh()):
        jch, jst = fn(_jparams(specs, flat), jstate, jnp.asarray(tokens),
                      jnp.asarray(pos), *extra)
    tspecs = tprm.cache_specs(tcfg, batch=SLOTS, seq=MAX_SEQ, paged=paged)
    tstate = tprm.state_from_flat(tcfg, state, tspecs)
    ch = tlm.verify_step(tcfg, tprm.from_flat(tcfg, flat), tstate,
                         torch.from_numpy(tokens), torch.from_numpy(pos),
                         *textra)
    assert ch.dtype == torch.int32 and ch.shape == (SLOTS, SPEC_K + 1)
    np.testing.assert_array_equal(ch.numpy(), np.asarray(jch))
    got, want = tprm.state_to_flat(tstate), jax_flat(jst)
    assert set(got) == set(want)
    for k in want:
        assert rel_err(got[k], want[k]) <= KV_TOL, k
    # a block of one is the decode step
    tstate = tprm.state_from_flat(tcfg, state, tspecs)
    one = tlm.verify_step(tcfg, tprm.from_flat(tcfg, flat), tstate,
                          torch.from_numpy(tokens[:, :1]),
                          torch.from_numpy(pos), *textra)
    tstate = tprm.state_from_flat(tcfg, state, tspecs)
    dec = tlm.decode_step(tcfg, tprm.from_flat(tcfg, flat), tstate,
                          torch.from_numpy(tokens[:, 0]),
                          torch.from_numpy(pos), *textra)
    np.testing.assert_array_equal(one[:, 0].numpy(), dec.numpy())


def test_refusals():
    """The verify refuses a layer pattern that is not all global
    attention (JAX's messages); the engine refuses a draft without
    ``spec_k`` and the reverse, a draft of another vocab, mixed plan
    degrees, a degree other than the mesh's, a pipeline plan and a data
    axis above 1; the launcher refuses ``--pp`` and ``--decode-micro``
    above 0."""
    _, gcfg = cfgs("gemma2-9b")
    _, tcfg = cfgs(ARCH)
    with pytest.raises(ValueError, match="all-global-attention"):
        tlm.verify_step(gcfg, {}, {}, torch.zeros(1, 2, dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="global-attention"):
        tblocks.verify_fn(gcfg, TmpCtx(), LOCAL_ATTN)
    with pytest.raises(ValueError, match="all-global-attention"):
        ServingEngine(gcfg, slots=2, max_seq=32, device="cpu", draft=gcfg,
                      spec_k=2)
    kw = dict(slots=2, max_seq=32, device="cpu")
    with pytest.raises(ValueError, match="both a draft model"):
        ServingEngine(tcfg, draft=tcfg, **kw)
    with pytest.raises(ValueError, match="both a draft model"):
        ServingEngine(tcfg, spec_k=2, **kw)
    with pytest.raises(ValueError, match="token space"):
        ServingEngine(tcfg, draft=tcfg.replace(vocab_size=256), spec_k=2,
                      **kw)
    two = (LayerStrategy(2, "oases"), LayerStrategy(1, "oases"))
    with pytest.raises(ValueError, match="mixed per-layer"):
        ServingEngine(tcfg, plan=ParallelPlan(layers=two), **kw)
    with pytest.raises(ValueError, match="pins TMP degree 2"):
        ServingEngine(tcfg, plan=ParallelPlan(
            layers=(LayerStrategy(2, "fused"),) * 2), **kw)
    with pytest.raises(NotImplementedError, match="A8"):
        ServingEngine(tcfg, plan=ParallelPlan(
            layers=(LayerStrategy(None, "fused"),) * 2, pp=2), **kw)
    data2 = MeshComm(RankMesh((2, 1), ("data", "model")), 0,
                     lambda axes, i, members: SoloComm())
    with pytest.raises(NotImplementedError, match="A5, slots sharded"):
        ServingEngine(tcfg, data2, **kw)
    with pytest.raises(NotImplementedError, match="A8"):
        tserve.main(["--reduced", "--device", "cpu", "--pp", "2"])
    with pytest.raises(NotImplementedError, match="A8"):
        tserve.main(["--reduced", "--device", "cpu", "--decode-micro", "2"])


def _cli(capsys, *flags):
    out = tserve.main(["--reduced", "--device", "cpu", "--requests", "4",
                       "--max-new-tokens", "6", "--slots", "2",
                       "--max-seq", "48", *flags])
    text = capsys.readouterr().out
    assert json.loads(text[text.index("{\n"):]) == out
    return out, text


def test_serve_cli_mesh_plan_and_draft(capsys, tmp_path):
    """``--mesh 1x2 --schedule fused --draft --spec-k 3`` on two gloo ranks
    serves the one-rank undrafted run's tokens; ``--save-plan`` writes
    the resolved plan and ``--plan`` replays it; ``--print-plan
    commodity`` prints the latency planner's serving plan."""
    ref, _ = _cli(capsys)
    path = tmp_path / "plan.json"
    out, _ = _cli(capsys, "--mesh", "1x2", "--schedule", "fused", "--draft",
                  ARCH, "--spec-k", "3", "--save-plan", str(path))
    assert out["mesh"] == {"data": 1, "model": 2}
    assert out["schedule"] == "fused" and out["spec_proposed"] > 0
    assert out["sample_output"] == ref["sample_output"]
    assert out["decoded_tokens"] == ref["decoded_tokens"]
    plan = ParallelPlan.load(str(path))
    assert plan.mesh_shape == (1, 2) and plan.summary() == out["plan"]
    _, text = _cli(capsys, "--print-plan", "commodity", "--plan",
                   str(path), "--schedule", "megatron")
    assert "latency planner (commodity): serve" in text
    assert "[plan] loaded" in text
