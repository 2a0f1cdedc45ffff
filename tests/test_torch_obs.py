"""The port's telemetry (``repro_torch.obs``) against the JAX package's
(``repro.obs``) on the CPU.

* The in-process cases of ``tests/test_obs.py`` that have a counterpart
  in the port (the three ``runtime.elastic`` cases wait for ROADMAP.md
  A4; the HLO case has no counterpart in eager PyTorch).
* Against JAX: the same seeded good and corrupted records through both
  validators (the same decisions and messages), both reports' text on
  the same records, ``plan_groups`` and ``plan_group_model`` (labels
  equal, floats to relative 1e-12) over four configs, uniform degrees 1-8
  and a mixed plan on the H100 fixture, ``OverlapProbe.report``'s
  decomposition and events, and the ``planner.plan`` event of ``plan``.
* The port alone: the trainer's per-step records, and the phase ranges
  of one reduced CPU step under ``torch.profiler``, backward included.
"""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import dataclasses
import json
import os
import re
import time

import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.registry import get_config as jax_get_config
from repro.core import planner as jplanner
from repro.core.planner import costmodel as jcm
from repro.models import params as jprm
from repro.obs import probe as jprobe
from repro.obs import recorder as jrec_mod
from repro.obs import report as jreport
from repro.obs import schema as jschema
from repro_torch import obs
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import get_config
from repro_torch.core import planner as tplanner
from repro_torch.core.planner import costmodel as tcm
from repro_torch.models import params as tprm
from repro_torch.obs import probe as tprobe
from repro_torch.obs import recorder as rec_mod
from repro_torch.obs import report as treport
from repro_torch.obs import schema as tschema
from repro_torch.obs.recorder import NULL, Recorder
from repro_torch.obs.schema import SchemaError, validate_lines, validate_record

REL = 1e-12


@pytest.fixture(autouse=True)
def _isolate_global_recorders():
    """Tests that install a global recorder must not leak it."""
    prev, jprev = rec_mod.get_recorder(), jrec_mod.get_recorder()
    yield
    rec_mod.set_recorder(prev)
    jrec_mod.set_recorder(jprev)


# --------------------------------------------------------------------------
# the in-process cases of tests/test_obs.py
# --------------------------------------------------------------------------
def test_schema_roundtrip(tmp_path):
    d = str(tmp_path / "tel")
    with Recorder(d, flush_every=1) as r:
        r.counter("c.things", 2, host=0)
        r.gauge("g.depth", 3.5)
        r.observe("h.step_s", 0.01, step=1)
        r.event("e.fault", msg="[test] something happened", kind="host_loss")
        with r.span("s.phase", layer=0):
            pass
    lines = open(os.path.join(d, "telemetry.jsonl")).read().splitlines()
    assert len(validate_lines(lines)) == 5
    assert [json.loads(ln)["kind"] for ln in lines] == [
        "counter", "gauge", "histogram", "event", "span"]


def test_schema_rejects_malformed():
    validate_record({"ts": 1.0, "kind": "gauge", "name": "x", "value": 1})
    for bad in (
        {"kind": "gauge", "name": "x", "value": 1},
        {"ts": 1.0, "kind": "nope", "name": "x"},
        {"ts": 1.0, "kind": "gauge", "name": "x"},
        {"ts": 1.0, "kind": "gauge", "name": "x", "value": "y"},
        {"ts": 1.0, "kind": "span", "name": "x", "dur_s": -1},
        {"ts": 1.0, "kind": "event", "name": "x", "bogus": 1},
        {"ts": 1.0, "kind": "event", "name": "x",
         "tags": {"nested": {"a": 1}}},
    ):
        with pytest.raises(SchemaError):
            validate_record(bad)


def test_ring_eviction():
    r = Recorder(ring_size=4)
    for i in range(10):
        r.gauge("g", i)
    assert [rec["value"] for rec in r.ring] == [6, 7, 8, 9]


def test_histogram_percentiles():
    r = Recorder()
    for v in range(1, 101):
        r.observe("h", v)
    assert r.percentile("h", 0) == 1 and r.percentile("h", 100) == 100
    assert r.percentile("h", 50) in (50, 51)
    assert r.percentile("h", 90) in (90, 91)
    assert r.percentile("h", 99) in (99, 100)
    assert r.percentile("missing", 50) is None
    s = r.summary()["histograms"]["h"]
    assert s["count"] == 100 and abs(s["mean"] - 50.5) < 1e-9


def test_counters_gauges_aggregate():
    r = Recorder()
    r.counter("c", 1)
    r.counter("c", 2)
    r.gauge("g", 7)
    r.gauge("g", 9)
    s = r.summary()
    assert s["counters"]["c"] == 3 and s["gauges"]["g"] == 9


def test_span_records_duration():
    r = Recorder()
    with r.span("phase", layer=3):
        time.sleep(0.001)
    rec = r.ring[-1]
    assert (rec["kind"], rec["name"], rec["tags"]) == ("span", "phase",
                                                       {"layer": 3})
    assert rec["dur_s"] >= 0.001


def test_console_passthrough_keeps_legacy_lines():
    seen = []
    r = Recorder(console=seen.append)
    r.event("trainer.step", msg="[trainer] step 10 loss 2.0")
    r.gauge("g", 1)
    assert seen == ["[trainer] step 10 loss 2.0"]


def test_flush_every_must_be_positive(tmp_path):
    with pytest.raises(ValueError, match="positive"):
        Recorder(str(tmp_path), flush_every=0)


def test_null_recorder_overhead():
    """The disabled recorder and the disabled phase ranges stay near-zero
    (the same 2 us bound as JAX's test)."""
    n = 200_000
    NULL.counter("warm")
    t0 = time.perf_counter()
    for _ in range(n):
        NULL.counter("x", 1, step=0)
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 2e-6, f"disabled-mode cost {per_call*1e9:.0f} ns/call"
    t0 = time.perf_counter()
    for _ in range(n):
        with obs.phase_scope("tmp.oases.row_matmul"):
            pass
    per_range = (time.perf_counter() - t0) / n
    assert per_range < 2e-6, f"idle range cost {per_range*1e9:.0f} ns"
    with NULL.span("x"):
        pass


def test_trace_annotation_is_reentrant():
    from torch.profiler import profile
    for recording in (False, True):
        with profile() if recording else NULL.span("x"):
            with obs.trace_annotation("outer"):
                with obs.phase_scope("inner"):
                    pass


def test_configure_installs_global(tmp_path):
    d = str(tmp_path / "tel")
    r = rec_mod.configure(d, flush_every=1)
    try:
        assert rec_mod.get_recorder() is r
        rec_mod.get_recorder().gauge("g", 1)
        r.flush()
        assert len(validate_lines(open(os.path.join(
            d, "telemetry.jsonl")).read().splitlines())) == 1
    finally:
        r.close()


def test_set_recorder_none_restores_null():
    rec_mod.set_recorder(Recorder())
    rec_mod.set_recorder(None)
    assert rec_mod.get_recorder() is NULL


def test_report_render_and_validate(tmp_path, capsys):
    d = str(tmp_path / "tel")
    with Recorder(d, flush_every=1) as r:
        for i in range(5):
            r.observe("trainer.step_time_s", 0.01 * (i + 1), step=i)
        r.counter("serving.decoded_tokens", 64)
        r.gauge("serving.queue_depth", 2)
        r.event("overlap.group", group="g0:attn[4/oases]x2",
                schedule="oases", layers=2, predicted_exposed_frac=0.5,
                measured_exposed_frac=0.25, residual=-0.1)
        r.event("trainer.restore", msg="[trainer] restored step 5")
    assert treport.main([d, "--validate"]) == 0
    assert "telemetry records OK" in capsys.readouterr().out
    assert treport.main([d]) == 0
    out = capsys.readouterr().out
    assert "per-phase breakdown" in out and "trainer.step_time_s" in out
    assert "overlap efficiency" in out and "g0:attn[4/oases]x2" in out


def test_report_validate_catches_corruption(tmp_path):
    d = str(tmp_path / "tel")
    with Recorder(d, flush_every=1) as r:
        r.gauge("g", 1)
    with open(os.path.join(d, "telemetry.jsonl"), "a") as f:
        f.write('{"ts": 1.0, "kind": "nope", "name": "x"}\n')
    assert treport.main([d, "--validate"]) == 1


def _groups(side):
    g1 = side.GroupModel(label="g0:attn[4/oases]x2", kind="attn",
                         schedule="oases", degree=4, layers=2,
                         compute_s=0.08, comm_s=0.02, predicted_s=0.09)
    g2 = side.GroupModel(label="g1:mlp[4/megatron]x2", kind="mlp",
                         schedule="megatron", degree=4, layers=2,
                         compute_s=0.02, comm_s=0.02, predicted_s=0.04)
    return [g1, g2]


def test_probe_residual_math():
    g1, g2 = _groups(tprobe)
    assert abs(g1.predicted_exposed_frac - 0.5) < 1e-12
    assert abs(g2.predicted_exposed_frac - 1.0) < 1e-12
    out = tprobe.OverlapProbe([g1, g2]).report(0.12)
    assert abs(out["measured_exposed_frac"] - 0.5) < 1e-9
    r1, r2 = out["groups"]
    assert abs(r1["residual"]) < 1e-9 and abs(r2["residual"] + 0.25) < 1e-9
    assert not out["calibration_stale"]
    probe = tprobe.OverlapProbe([g1, g2])
    assert probe.report(0.05)["measured_exposed_frac"] == 0.0
    above = probe.report(1.0)
    assert above["measured_exposed_frac"] == 1.0 and above["calibration_stale"]


def test_probe_emits_stale_event_and_skips_without_comm():
    r = Recorder()
    tprobe.OverlapProbe(_groups(tprobe)).report(1.0, r, step=7)
    names = [rec["name"] for rec in r.ring]
    assert names.count("overlap.group") == 2 and "calibration_stale" in names
    stale = [rec for rec in r.ring if rec["name"] == "calibration_stale"][0]
    assert "re-run calibration" in stale["msg"] and "torchcal" in stale["msg"]
    assert stale["tags"]["step"] == 7
    g = tprobe.GroupModel(label="g0", kind="attn", schedule="oases",
                          degree=1, layers=2, compute_s=0.1, comm_s=0.0,
                          predicted_s=0.1)
    out = tprobe.OverlapProbe([g]).report(0.2, r)
    assert out["skipped"] == "no-comm" and r.ring[-1]["name"] == "overlap.skip"


# --------------------------------------------------------------------------
# against JAX: validators and reports
# --------------------------------------------------------------------------
def _seeded_records(seed, n=120):
    """Good records of every kind, and copies corrupted one way each."""
    rng = np.random.default_rng(seed)
    kinds = ["counter", "gauge", "histogram", "event", "span"]
    good, bad = [], []
    for i in range(n):
        kind = kinds[int(rng.integers(5))]
        rec = {"ts": float(rng.uniform(1e9, 2e9)), "kind": kind,
               "name": f"m{int(rng.integers(4))}.x"}
        if kind in ("counter", "gauge", "histogram"):
            rec["value"] = (int(rng.integers(100)) if rng.random() < 0.3
                            else float(rng.standard_normal()))
        if kind == "span":
            rec["dur_s"] = float(rng.uniform(0, 1))
        if kind == "event" and rng.random() < 0.5:
            rec["msg"] = f"[e] line {i}"
        if rng.random() < 0.5:
            rec["tags"] = {"step": i, "rid": None, "ok": bool(i % 2),
                           "s": "a"}
        good.append(rec)
        c = dict(rec)
        how = int(rng.integers(11))
        if how == 0:
            c.pop(["ts", "kind", "name"][int(rng.integers(3))])
        elif how == 1:
            c["kind"] = "nope"
        elif how == 2:
            c["ts"] = "1.0"
        elif how == 3:
            c["name"] = ""
        elif how == 4:
            c["kind"], c["value"] = "gauge", "y"
        elif how == 5:
            c["kind"], c["dur_s"] = "span", -1.0
        elif how == 6:
            c["msg"] = 3
        elif how == 7:
            c["tags"] = {"nested": {"a": 1}}
        elif how == 8:
            c["tags"] = [1, 2]
        elif how == 9:
            c["bogus"] = 1
        else:
            c = [c]
        bad.append(c)
    return good, bad


def _decision(schema, rec):
    try:
        return ("ok", schema.validate_record(rec))
    except Exception as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", [0, 1])
def test_validators_agree_with_jax(seed):
    good, bad = _seeded_records(seed)
    for rec in good + bad:
        mine, theirs = _decision(tschema, rec), _decision(jschema, rec)
        assert mine == theirs
    assert sum(_decision(tschema, r)[0] == "ok" for r in bad) == 0
    lines = [json.dumps(r) for r in good]
    assert tschema.validate_lines(lines) == jschema.validate_lines(lines)
    for broken in ([*lines[:3], "{half", *lines[3:]],
                   [*lines[:5], json.dumps(bad[0]), *lines[5:]]):
        msgs = []
        for schema in (tschema, jschema):
            with pytest.raises(Exception) as ei:
                schema.validate_lines(broken)
            msgs.append((type(ei.value).__name__, str(ei.value)))
        assert msgs[0] == msgs[1]


def _report_records():
    """A run's worth of records on both recorders' shape: histograms,
    spans, counters, gauges, overlap rows, serving and notable events."""
    r = Recorder(clock=iter(range(10_000)).__next__)
    rng = np.random.default_rng(3)
    for i in range(40):
        r.observe("trainer.step_time_s", float(rng.uniform(0.05, 2.0)),
                  step=i)
        r.observe("serving.decode_step_s", float(rng.uniform(1e-4, 0.2)))
        r.gauge("trainer.loss", float(rng.uniform(2, 11)), step=i)
        r.counter("serving.decoded_tokens", int(rng.integers(1, 9)))
    for i in range(16):
        r.observe("serving.ttft_s", float(rng.uniform(0.01, 3.0)), rid=i)
    with r.span("ckpt.write"):
        pass
    for name, v in (("serving.tok_per_s", 1234.5),
                    ("serving.prefix_hit_rate", 0.375),
                    ("serving.free_pages", 17),
                    ("serving.slot_occupancy", 0.75),
                    ("overlap.model_residual", 3.25)):
        r.gauge(name, v)
    r.counter("serving.admission_deferred", 3)
    tprobe.OverlapProbe(_groups(tprobe)).report(1.0, r, step=39)
    for i in range(25):
        r.event("trainer.step", step=i, msg=f"[trainer] step {i} loss 2.0")
    r.event("planner.plan", entry="plan", predicted_ms=1.5)
    return list(r.ring)


def test_report_text_equals_jax():
    records = _report_records()
    assert treport.render(records) == jreport.render(records)
    assert treport.render([]) == jreport.render([])
    assert "== serving ==" in treport.render(records)


# --------------------------------------------------------------------------
# against JAX: the group model and the probe
# --------------------------------------------------------------------------
ARCHS = ("gpt-h2048", "internlm2-1.8b", "mamba2-130m", "recurrentgemma-9b")


def _hw():
    fields = dataclasses.asdict(tcm.H100_80GB_HBM3)
    return tcm.HWConfig(**fields), jcm.HWConfig(**fields)


def _setups(arch, **hp):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    shape = ("probe", 1024, 8, "train")
    return ((tcfg, tbase.ShapeConfig(*shape), tbase.TrainHParams(**hp)),
            (jcfg, jbase.ShapeConfig(*shape), jbase.TrainHParams(**hp)))


def _close(a, b):
    if isinstance(a, float) or isinstance(b, float):
        return a == b or abs(a - b) <= REL * max(abs(a), abs(b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return a == b


def _plans(n):
    yield [1] * n, None
    for d in (2, 4, 8):
        yield [d] * n, ["oases"] * n
    mixed = [8 if i % 3 else 2 for i in range(n)]
    yield mixed, [("megatron", "oases", "fused")[(i // 2) % 3]
                  for i in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_group_model_equals_jax(arch):
    thw, jhw = _hw()
    (tcfg, tshape, thp), (jcfg, jshape, jhp) = _setups(arch)
    for degrees, scheds in _plans(tcfg.num_layers):
        tg = tprm.plan_groups(tcfg, degrees, scheds)
        jg = jprm.plan_groups(jcfg, degrees, scheds)
        assert [dataclasses.astuple(g) for g in tg] == [
            dataclasses.astuple(g) for g in jg]
        mine = tprobe.plan_group_model(tcfg, tshape, thp, thw, degrees,
                                       scheds)
        theirs = jprobe.plan_group_model(jcfg, jshape, jhp, jhw, degrees,
                                         scheds)
        assert len(mine) == len(theirs) == len(tg)
        for a, b in zip(mine, theirs):
            assert _close(dataclasses.asdict(a), dataclasses.asdict(b)), (
                a, b)
            assert _close(a.predicted_exposed_frac, b.predicted_exposed_frac)


def _events(r):
    out = []
    for rec in r.ring:
        rec = {k: v for k, v in rec.items() if k != "ts"}
        if "msg" in rec:
            rec["msg"] = rec["msg"].replace("torchcal", "hwcal")
        out.append(rec)
    return out


@pytest.mark.parametrize("schedule", ["oases", "fused"])
def test_probe_report_equals_jax(schedule):
    thw, jhw = _hw()
    (tcfg, tshape, thp), (jcfg, jshape, jhp) = _setups("gpt-h2048")
    n = tcfg.num_layers
    degrees, scheds = [2] * n, [schedule] * (n // 2) + ["megatron"] * (n // 2)
    tp = tprobe.OverlapProbe.for_run(tcfg, tshape, thp, thw, degrees,
                                     scheds, hw_note="h100")
    jp = jprobe.OverlapProbe.for_run(jcfg, jshape, jhp, jhw, degrees,
                                     scheds, hw_note="h100")
    compute = sum(g.compute_s for g in tp.groups)
    model = sum(g.predicted_s for g in tp.groups)
    # under the floor, inside the model's band, clamped, stale
    for measured in (0.5 * compute, 0.99 * model, 1e3 * model, 2.0 * model):
        tr, jr = Recorder(), jrec_mod.Recorder()
        mine = tp.report(measured, tr, step=3)
        theirs = jp.report(measured, jr, step=3)
        assert _close(mine, theirs)
        assert _close(_events(tr), _events(jr))
    assert mine["calibration_stale"] and len(mine["groups"]) == 2


def test_planner_plan_event_equals_jax():
    """With each side's recorder installed, ``plan`` emits equal
    planner.plan tags (the ILP's own solve time aside) and solve_ms
    histogram tags."""
    seen = []
    for side, recmod, base, cm in ((tplanner, rec_mod, tbase, tcm),
                                   (jplanner, jrec_mod, jbase, jcm)):
        arch = (get_config if side is tplanner else jax_get_config)(
            "gpt-h2048")
        r = recmod.Recorder()
        recmod.set_recorder(r)
        pr = side.plan(arch, base.ShapeConfig("cli", 1024, 8, "train"),
                       base.TrainHParams(), cm.COMMODITY_25GBE,
                       layout="1d", options=(2, 4, 8), time_limit=120.0)
        recmod.set_recorder(None)
        ev = [x for x in r.ring if x["name"] == "planner.plan"]
        hs = [x for x in r.ring if x["name"] == "planner.solve_ms"]
        assert len(ev) == len(hs) == 1 and hs[0]["value"] == pr.solve_ms
        tags = dict(ev[0]["tags"])
        assert tags.pop("solve_ms") == round(pr.solve_ms, 1)
        seen.append((tags, hs[0]["tags"],
                     re.sub(r"ILP [0-9.]+ ms", "ILP - ms", ev[0]["msg"])))
    assert seen[0] == seen[1]


# --------------------------------------------------------------------------
# the port alone: the trainer and the phase ranges
# --------------------------------------------------------------------------
def test_trainer_records_each_step():
    from repro_torch.runtime import Trainer
    cfg = get_config("internlm2-1.8b").reduced().replace(dtype="float32")
    seen = []
    r = Recorder(console=seen.append)
    tr = Trainer(cfg, tbase.TrainHParams(), global_batch=4, seq_len=16,
                 device="cpu", log_fn=None, telemetry=r)
    res = tr.train(4)
    losses = [x["value"] for x in r.ring if x["name"] == "trainer.loss"]
    assert losses == res["losses"]
    assert list(r.hists["trainer.step_time_s"]) == res["step_times"]
    assert len(r.hists["trainer.step_time_s"]) == 4
    tps = [x for x in r.ring if x["name"] == "trainer.tokens_per_s"]
    assert [x["tags"]["step"] for x in tps] == [0, 1, 2, 3]
    # the step event is the line the trainer logged before telemetry
    assert seen == [f"[trainer] step 0 loss {res['losses'][0]:.4f} "
                    f"{res['step_times'][0] * 1e3:.0f} ms"]
    # no sink: no probe
    assert not any(x["name"].startswith("overlap.") for x in r.ring)


def _profiled_step(schedule, split=2):
    """One reduced CPU forward and backward at tp=1 under the profiler:
    -> {range name: [events]}, and the forward's count of each."""
    from torch.profiler import profile

    from repro_torch.core.schedule import TmpCtx
    from repro_torch.models import lm
    cfg = get_config("internlm2-1.8b").reduced().replace(dtype="float32")
    params = tprm.init_params(cfg, seed=0)
    for t in tprm.flat_leaves(params):
        t.requires_grad_()
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(3, cfg.vocab_size, (4, 17))
                           .astype(np.int32))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    hp = tbase.TrainHParams(schedule=schedule, remat=False, split=split)
    with profile() as prof:
        loss, _ = lm.train_loss(cfg, params, batch, hp,
                                TmpCtx(schedule=schedule))
        loss.backward()
    by = {}
    for e in prof.events():
        if e.name.startswith("tmp."):
            by.setdefault(e.name, []).append(e)
    return cfg, by


def _descendants(e):
    for c in e.cpu_children:
        yield c
        yield from _descendants(c)


def _ancestors(e):
    while e.cpu_parent is not None:
        e = e.cpu_parent
        yield e


def _in_backward(e) -> bool:
    """The range runs in the autograd engine: it holds backward nodes, or
    a backward node holds it (an exit's range opens in its own backward)."""
    return any("Backward" in a.name
               for a in (*_ancestors(e), *_descendants(e)))


@pytest.mark.parametrize("schedule,subs", [("megatron", 1), ("oases", 2)])
def test_phase_ranges_cover_forward_and_backward(schedule, subs):
    cfg, by = _profiled_step(schedule)
    n = cfg.num_layers
    assert set(by) == ({f"tmp.{schedule}.row_matmul",
                        f"tmp.{schedule}.gather_matmul"}
                       | {f"tmp.{schedule}.sub{j}" for j in range(subs)})
    for name, evts in by.items():
        # 2 parts a layer, each range once in the forward and once in the
        # backward (row and gather once per sub-batch)
        per = 2 * n * (1 if ".sub" in name else subs)
        bwd = [e for e in evts if _in_backward(e)]
        assert (len(evts), len(bwd)) == (2 * per, per), name
        assert all(any(c.name.startswith("aten::") for c in _descendants(e))
                   for e in evts), name
    # the backward of an exit holds its two products
    row = [e for e in by[f"tmp.{schedule}.row_matmul"] if _in_backward(e)]
    assert all(sum(c.name == "aten::matmul" for c in e.cpu_children) == 2
               for e in row)
