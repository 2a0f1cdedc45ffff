"""The port's serving slice against the JAX package on the CPU: the weight
bridge, one paged decode step, the whole engine, the page allocator, and
the launcher.  Reduced ``gpt-serve-h4096`` (d 128, 4 heads over 2 kv
heads, hd 32, 2 layers) in f32 on a 1x1 mesh.

Tolerance for KV pools: 1e-5 abs (f32, same math in another summation
order).  Page 0 is left out of pool comparisons: inactive slots write the
null page and which write wins is unspecified.
"""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainHParams
from repro.configs.registry import get_config as jax_get_config
from repro.core import compat
from repro.core.axes import mesh_info
from repro.models import lm as jlm
from repro.models import params as jprm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving.paged_cache import PagedKVCache as JPagedKVCache
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models import params as tprm
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.paged_cache import PagedKVCache

ARCH = "gpt-serve-h4096"


def _mesh():
    return compat.make_mesh((1, 1), ("data", "model"),
                            axis_types=compat.auto_axis_types(2))


def _cfgs():
    jcfg = jax_get_config(ARCH).reduced().replace(dtype="float32")
    tcfg = get_config(ARCH).reduced().replace(dtype="float32")
    return jcfg, tcfg


def _jax_params(jcfg, seed=0):
    specs = jprm.model_specs(jcfg, mesh_info(_mesh()))
    return jprm.init_params(specs, jax.random.PRNGKey(seed))


def test_config_copy_matches_jax():
    jcfg, tcfg = _cfgs()
    for full in (jax_get_config(ARCH), jax_get_config("internlm2-1.8b")):
        mine = get_config(full.name)
        for name in (f.name for f in dataclasses.fields(mine)):
            assert getattr(mine, name) == getattr(full, name), name
        assert mine.padded_vocab() == full.padded_vocab()
        assert mine.resolved_head_dim == full.resolved_head_dim
        for name in (f.name for f in dataclasses.fields(mine.reduced())):
            assert (getattr(mine.reduced(), name)
                    == getattr(full.reduced(), name)), name
    assert tcfg.num_kv_heads == jcfg.num_kv_heads == 2     # GQA when reduced


def test_weight_bridge_round_trip_is_bit_exact():
    jcfg, tcfg = _cfgs()
    flat = jprm.tree_to_flat(_jax_params(jcfg))
    params = tprm.from_flat(tcfg, flat)
    back = tprm.to_flat(params)
    assert set(back) == set(flat)
    for key, arr in flat.items():
        assert back[key].dtype == arr.dtype, key
        assert np.array_equal(back[key], arr), key
    assert params["blocks"][0]["wq"].shape == (2, 128, 128)
    assert "['blocks'][0]['wq']" in flat and "['lm_head']" in flat


def test_weight_bridge_rejects_wrong_tree():
    jcfg, tcfg = _cfgs()
    flat = jprm.tree_to_flat(_jax_params(jcfg))
    with pytest.raises(KeyError, match="missing"):
        tprm.from_flat(tcfg, {k: v for k, v in flat.items()
                              if k != "['lm_head']"})
    bad = dict(flat)
    bad["['final_ln']"] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError, match="shape"):
        tprm.from_flat(tcfg, bad)


def test_one_paged_decode_step_matches_jax():
    """One step with history in the pools, a COW pair, GQA, slots at a
    page boundary and at the last position, and one inactive slot."""
    jcfg, tcfg = _cfgs()
    b, max_seq, page = 4, 32, 8
    nb = max_seq // page
    pages = b * nb + 2
    rng = np.random.default_rng(3)
    jparams = _jax_params(jcfg, seed=1)
    dec, _, st_specs = jlm.build_decode(
        jcfg, _mesh(), TrainHParams(), global_batch=b, seq_len=max_seq,
        paged=(pages, page))
    state = jprm.zeros_state(st_specs)
    pool_shape = state["blocks"][0]["k"].shape
    assert pool_shape == tprm.cache_specs(
        tcfg, batch=b, seq=max_seq, paged=(pages, page))["blocks"][0]["k"].shape
    k0 = rng.standard_normal(pool_shape).astype(np.float32)
    v0 = rng.standard_normal(pool_shape).astype(np.float32)
    tables = np.zeros((b, nb), np.int32)
    tables[:3] = rng.permutation(np.arange(1, pages))[:3 * nb].reshape(3, nb)
    pos = np.array([5, page, max_seq - 1, 9], np.int32)   # slot 3 inactive
    tokens = rng.integers(3, jcfg.vocab_size, b).astype(np.int32)
    cow_src = np.array([tables[0, 1], 0, 0, 0], np.int32)
    cow_dst = np.array([pages - 1, 0, 0, 0], np.int32)
    tables[0, 1] = pages - 1
    jstate = {"blocks": [{"k": jnp.asarray(k0), "v": jnp.asarray(v0)}],
              "tail": []}
    jtok, jnew = jax.jit(dec)(jparams, jstate, *(jnp.asarray(a) for a in (
        tokens, pos, tables, cow_src, cow_dst)))

    params = tprm.from_flat(tcfg, jprm.tree_to_flat(jparams))
    tstate = {"blocks": [{"k": torch.from_numpy(k0.copy()),
                          "v": torch.from_numpy(v0.copy())}]}
    ttok = tlm.decode_step(tcfg, params, tstate, *(torch.from_numpy(a) for a
                                                   in (tokens, pos, tables,
                                                       cow_src, cow_dst)))
    assert ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for key in ("k", "v"):
        mine = tstate["blocks"][0][key].numpy()[:, 1:]
        ref = np.asarray(jnew["blocks"][0][key])[:, 1:]
        np.testing.assert_allclose(mine, ref, atol=1e-5, rtol=0)
        assert not np.array_equal(mine, (k0 if key == "k" else v0)[:, 1:])


def _requests(rng, vocab):
    """Six requests; 0, 2 and 4 share an 11-token prefix (mid-block with
    page 8), so later ones hit the prefix cache and copy on write."""
    shared = rng.integers(3, vocab, 11).astype(np.int32)
    out = []
    for i in range(6):
        tail = rng.integers(3, vocab, int(rng.integers(2, 9))).astype(np.int32)
        prompt = np.concatenate([shared, tail]) if i % 2 == 0 else tail
        out.append((i, prompt, int(rng.integers(3, 8))))
    return out


def test_engine_token_identical_to_jax():
    jcfg, tcfg = _cfgs()
    kw = dict(slots=2, max_seq=64, paged=True, page_size=8,
              prefix_cache=True)
    jeng = JServingEngine(jcfg, _mesh(), **kw)
    jeng.load(seed=0)
    teng = ServingEngine(tcfg, device="cpu", **kw)
    teng.load(params=tprm.from_flat(tcfg, jprm.tree_to_flat(jeng.params)))

    reqs = _requests(np.random.default_rng(7), jcfg.vocab_size)
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=m) for i, p, m in reqs]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=m) for i, p, m in reqs]
    for r in jreqs:
        jeng.submit(r)
    for r in treqs:
        teng.submit(r)
    jstats = jeng.run_until_drained()
    tstats = teng.run_until_drained()

    for jr, tr in zip(jreqs, treqs):
        assert tr.done and jr.done
        assert tr.out_tokens == jr.out_tokens, tr.rid
    assert teng.stats == jeng.stats
    assert tstats["paged"] == jstats["paged"]
    assert tstats["prefix_hit_rate"] == jstats["prefix_hit_rate"]
    assert teng.stats["prefix_hits"] >= 1 and tstats["paged"]["cow"] >= 1
    np.testing.assert_array_equal(teng.paged.table, jeng.paged.table)
    for key in ("k", "v"):
        np.testing.assert_allclose(
            teng.state["blocks"][0][key].numpy()[:, 1:],
            np.asarray(jeng.state["blocks"][0][key])[:, 1:],
            atol=1e-5, rtol=0)


def test_engine_refuses_dense_cache_and_missing_card():
    """The dense cache is the default (as JAX's engine) and serves; with
    no card the engine refuses to start without ``device="cpu"``."""
    _, tcfg = _cfgs()
    eng = ServingEngine(tcfg, slots=2, max_seq=64, paged=False, device="cpu")
    assert eng.paged is None
    assert ServingEngine(tcfg, slots=2, max_seq=64, device="cpu").paged is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(tcfg, slots=2, max_seq=64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_cache_copy_matches_jax(seed):
    """Same random admit / ensure_writable / insert / release sequence on
    both allocators: equal tables, refcounts, free lists and stats."""
    rng = np.random.default_rng(seed)
    kw = dict(pages=14, page_size=4, slots=3, max_seq=16, prefix_cache=True)
    caches = (JPagedKVCache(**kw), PagedKVCache(**kw))
    prompts = [rng.integers(3, 9, int(rng.integers(2, 9))).astype(np.int32)
               for _ in range(4)]
    pos = [0, 0, 0]
    live = [None, None, None]
    for _ in range(60):
        s = int(rng.integers(0, 3))
        if live[s] is None:
            prompt = prompts[int(rng.integers(0, 4))]
            results = []
            for c in caches:
                shared, span = c.lookup(prompt)
                ok = c.can_admit(len(prompt), 4, shared_pages=len(shared))
                if ok:
                    c.admit(s, len(prompt), 4, shared=shared)
                results.append((shared, span, ok))
            assert results[0] == results[1]
            if results[0][2]:
                live[s] = prompt
                pos[s] = min(results[0][1], len(prompt) - 1)
        elif pos[s] >= len(live[s]) + 3 or rng.random() < 0.1:
            for c in caches:
                if pos[s] >= len(live[s]):
                    c.insert(s, live[s])
                c.release(s)
            live[s] = None
        else:
            cows = [c.ensure_writable(s, pos[s], pos[s]) for c in caches]
            assert cows[0] == cows[1]
            pos[s] += 1
            if pos[s] == len(live[s]):
                for c in caches:
                    c.insert(s, live[s])
        jc, tc = caches
        np.testing.assert_array_equal(tc.table, jc.table)
        np.testing.assert_array_equal(tc.ref, jc.ref)
        assert tc.free == jc.free
        assert tc.stats == jc.stats
        assert set(tc._index) == set(jc._index)
        tc.check()


def test_serve_launcher_cpu(capsys):
    tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                 "--requests", "3", "--slots", "2", "--max-seq", "32",
                 "--paged", "--page-size", "8", "--prefix-cache",
                 "--max-new-tokens", "4"])
    out = json.loads(capsys.readouterr().out)
    assert out["admitted"] == 3 and out["device"] == "cpu"
    assert 3 <= out["decoded_tokens"] <= 12
    assert out["paged"]["free_pages"] + out["paged"]["index_size"] >= 1
    assert all(0 <= t < 512 for t in out["sample_output"])


def _gauges(recorder, names):
    """Each gauge's values in record order."""
    return {n: [r["value"] for r in recorder.ring if r["name"] == n]
            for n in names}


def test_engine_telemetry_matches_jax():
    """JAX's and the port's paged engines, fed the same requests with
    explicit recorders and a page pool small enough to defer admissions:
    equal tick-by-tick gauges, decoded tokens, TTFT and decode-step counts
    and deferrals."""
    from repro.obs import Recorder as JRecorder
    from repro_torch.obs import Recorder

    jcfg, tcfg = _cfgs()
    kw = dict(slots=3, max_seq=64, paged=True, page_size=8, pages=9,
              prefix_cache=True)
    jrec, trec = JRecorder(ring_size=8192), Recorder(ring_size=8192)
    jeng = JServingEngine(jcfg, _mesh(), telemetry=jrec, **kw)
    jeng.load(seed=0)
    teng = ServingEngine(tcfg, device="cpu", telemetry=trec, **kw)
    teng.load(params=tprm.from_flat(tcfg, jprm.tree_to_flat(jeng.params)))
    reqs = _requests(np.random.default_rng(11), jcfg.vocab_size)
    for i, p, m in reqs:
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=m))
        teng.submit(Request(rid=i, prompt=p, max_new_tokens=m))
    jeng.run_until_drained()
    tstats = teng.run_until_drained()

    ticks = ("serving.queue_depth", "serving.slot_occupancy",
             "serving.free_pages", "serving.prefix_hit_rate")
    mine, theirs = _gauges(trec, ticks), _gauges(jrec, ticks)
    assert mine == theirs
    assert len(mine["serving.queue_depth"]) == tstats["steps"]
    assert trec.counters["serving.admission_deferred"] == \
        jrec.counters["serving.admission_deferred"] >= 1
    assert trec.counters["serving.decoded_tokens"] == \
        jrec.counters["serving.decoded_tokens"] == tstats["decoded_tokens"]
    for name, n in (("serving.ttft_s", len(reqs)),
                    ("serving.decode_step_s", tstats["steps"])):
        assert len(trec.hists[name]) == len(jrec.hists[name]) == n, name
    assert list(trec.hists["serving.decode_step_s"]) == teng.step_s
    ttft_rids = [r["tags"]["rid"] for r in trec.ring
                 if r["name"] == "serving.ttft_s"]
    assert ttft_rids == [r["tags"]["rid"] for r in jrec.ring
                         if r["name"] == "serving.ttft_s"]
    for name in ("serving.tok_per_s", "serving.drain_s",
                 "serving.prefix_hit_rate"):
        assert name in trec.gauges and name in jrec.gauges
    assert trec.gauges["serving.prefix_hit_rate"] == \
        jrec.gauges["serving.prefix_hit_rate"] == tstats["prefix_hit_rate"]


def test_serve_launcher_telemetry(tmp_path, capsys):
    from repro_torch.obs import get_recorder, report
    from repro_torch.obs.recorder import NULL
    d = str(tmp_path / "tel")
    tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                 "--requests", "3", "--slots", "2", "--max-seq", "32",
                 "--page-size", "8", "--max-new-tokens", "4",
                 "--telemetry", d, "--telemetry-flush", "1"])
    out = json.loads(capsys.readouterr().out)
    assert get_recorder() is NULL          # the launcher restores it
    assert report.main([d, "--validate"]) == 0
    assert "telemetry records OK" in capsys.readouterr().out
    recs = report.load(d)
    steps = [r for r in recs if r["name"] == "serving.decode_step_s"]
    assert len(steps) == out["steps"]
    assert sum(r["value"] for r in recs
               if r["name"] == "serving.decoded_tokens") == \
        out["decoded_tokens"]
    assert len([r for r in recs if r["name"] == "serving.ttft_s"]) == 3
    with pytest.raises(SystemExit, match="telemetry-flush"):
        tserve.main(["--reduced", "--device", "cpu", "--telemetry", d,
                     "--telemetry-flush", "0"])
