"""The port's serving engine on the dense decode state on the CPU:
gemma2's engine against JAX's dense engine with its local rings wrapping,
a paged gemma2 engine (global layers paged, local rings dense) against
its dense one, JAX's engine behaviours (``tests/test_serving.py``) and
the launcher's ``--paged`` flag.  The other families' engines are held to
JAX's in ``tests/test_torch_serve_families.py``, beside their prefill
cases, whose JAX decode they share.

Reduced f32 configs on a 1x1 mesh, weights drawn with numpy
(``_torch_family.numpy_params``).  gemma2 serves at ``max_seq`` 96
against its reduced window of 64."""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import json

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_family import (cfgs, drain, engines_agree, mesh, numpy_params,
                           serve_requests)
from repro.models import params as jprm
from repro.serving import ServingEngine as JServingEngine
from repro_torch.launch import serve as tserve
from repro_torch.models import params as tprm
from repro_torch.serving import Request, ServingEngine

# gemma2's engines: 2 slots of 96 positions, 3 requests of up to 44
# prompt and 44 new tokens (positions past the window of 64)
GEMMA2 = dict(slots=2, max_seq=96)
GEMMA2_REQUESTS = (3, 44, 44)


def test_gemma2_dense_engine_token_identical_to_jax():
    """gemma2's dense engine against JAX's: the same tokens, stats and
    states, its local rings wrapped (a slot past position 64)."""
    jcfg, tcfg = cfgs("gemma2-9b")
    jeng = JServingEngine(jcfg, mesh(), **GEMMA2)
    flat = numpy_params(jeng.specs)
    jeng.load(params=jprm.tree_from_flat(
        jeng.specs, {k: jnp.asarray(v) for k, v in flat.items()}))
    teng = ServingEngine(tcfg, device="cpu", **GEMMA2)
    teng.load(params=tprm.from_flat(tcfg, flat))
    engines_agree(jeng, teng, serve_requests(tcfg.vocab_size,
                                             *GEMMA2_REQUESTS, seed=3),
                  1e-4)
    assert int(teng.pos.max()) > tcfg.window


def test_paged_gemma2_engine_equals_dense():
    """Global layers in page pools, local rings dense: the same tokens and
    stats as the dense engine (no prefix cache: a mixed pattern refuses
    it, with JAX's error)."""
    _, tcfg = cfgs("gemma2-9b")
    reqs = serve_requests(tcfg.vocab_size, *GEMMA2_REQUESTS, seed=3)
    params = tprm.init_params(tcfg, seed=4)
    runs = {}
    for paged in (False, True):
        eng = ServingEngine(tcfg, device="cpu", paged=paged, page_size=8,
                            **GEMMA2)
        eng.load(params=params)
        runs[paged] = (eng, *drain(eng, reqs, Request))
    (d, dreqs, _), (p, preqs, pstats) = runs[False], runs[True]
    for a, b in zip(dreqs, preqs):
        assert a.out_tokens == b.out_tokens, a.rid
    assert d.stats == p.stats
    assert pstats["paged"]["free_pages"] == p.paged.pages - 1
    # (local, global): the global layers' k/v are pools, the locals' rings
    assert p.state["blocks"][1]["k"].shape[1:3] == (p.paged.pages, 8)
    assert d.state["blocks"][0]["k"].shape == p.state["blocks"][0]["k"].shape
    with pytest.raises(ValueError, match="all-global-attention"):
        ServingEngine(tcfg, device="cpu", paged=True, prefix_cache=True,
                      **GEMMA2)


def _mk_engine(**kw):
    """JAX's ``tests/test_serving.py`` engine: reduced internlm2-1.8b,
    2 slots, max_seq 48, dense."""
    _, tcfg = cfgs("internlm2-1.8b")
    eng = ServingEngine(tcfg, device="cpu",
                        **{"slots": 2, "max_seq": 48, **kw})
    eng.load(seed=0)
    return eng


def test_slot_exhaustion_backs_up_admission_queue():
    eng = _mk_engine()
    for i in range(5):
        eng.submit(Request(rid=i, prompt=np.arange(3, 6, dtype=np.int32),
                           max_new_tokens=3))
    eng.step()
    assert eng.stats["admitted"] == 2
    assert eng.queued == 3
    assert all(a is not None for a in eng.active)
    stats = eng.run_until_drained()
    assert stats["admitted"] == 5
    assert eng.queued == 0
    assert all(a is None for a in eng.active)


def test_eos_mid_batch_frees_slot_for_queued_request():
    probe = _mk_engine()
    reqs = [Request(rid=i, prompt=np.arange(3 + i, 8 + i, dtype=np.int32),
                    max_new_tokens=8) for i in range(2)]
    for r in reqs:
        probe.submit(r)
    probe.run_until_drained()
    eos = next((t for t in reqs[0].out_tokens[1:]
                if t not in reqs[1].out_tokens), reqs[0].out_tokens[1])
    eng = _mk_engine(eos_id=int(eos))
    rs = [Request(rid=i, prompt=np.arange(3 + i, 8 + i, dtype=np.int32),
                  max_new_tokens=8) for i in range(3)]
    for r in rs:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert rs[0].done and rs[0].out_tokens[-1] == eos
    assert len(rs[0].out_tokens) < 8
    assert stats["admitted"] == 3
    assert rs[1].done and rs[2].done


def test_prefill_len_validated():
    eng = _mk_engine(prefill_len=8)
    assert eng.prefill_len == 8
    with pytest.raises(ValueError, match="prefill_len"):
        eng.submit(Request(rid=0, prompt=np.arange(3, 12, dtype=np.int32)))
    with pytest.raises(ValueError, match="empty"):
        eng.submit(Request(rid=1, prompt=np.zeros((0,), np.int32)))
    r = Request(rid=2, prompt=np.arange(3, 11, dtype=np.int32),
                max_new_tokens=2)
    eng.submit(r)
    eng.run_until_drained()
    assert r.done and len(r.out_tokens) == 2
    assert _mk_engine().prefill_len == 24
    for bad in (32, 0):
        with pytest.raises(ValueError, match="max_seq"):
            _mk_engine(max_seq=32, prefill_len=bad)


def _serve(capsys, *flags):
    tserve.main(["--reduced", "--device", "cpu", "--requests", "3",
                 "--slots", "2", "--max-seq", "32", "--max-new-tokens", "3",
                 *flags])
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "recurrentgemma-9b"])
def test_serve_launcher_dense_by_default_and_paged(arch, capsys):
    dense = _serve(capsys, "--arch", arch)
    assert "paged" not in dense and dense["admitted"] == 3
    if arch == "internlm2-1.8b":
        paged = _serve(capsys, "--arch", arch, "--paged", "--page-size",
                       "8", "--prefix-cache")
        assert paged["paged"]["free_pages"] + paged["paged"][
            "index_size"] >= 1
        assert paged["sample_output"] == dense["sample_output"]
    with pytest.raises(ValueError, match="requires paged"):
        _serve(capsys, "--arch", arch, "--prefix-cache")
