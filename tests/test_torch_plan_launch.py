"""The port's launcher under executable plans and the planner, and the
planner's calibration cache, on the CPU:

* ``--planner --save-plan p`` and then ``--plan p`` give the flag run's
  losses, at tp=1 and at tp=2 on gloo ranks; the plan is resolved once in
  the launcher's process and handed to the ranks;
* a plan the port cannot run raises with the plan's summary and the
  ROADMAP.md item (A9 for per-layer ring-attention seqs, A8 for
  pipelines, A4 for data parallelism, A10c for the families at more than
  one rank);
* the port's ``microbatch`` 0 means auto: the launcher resolves it before
  planning and ``plan.apply`` never turns it into JAX's "none";
* ``calibrated_hw`` writes one cache file of its own and reads it back,
  and honours ``REPRO_NO_CALIBRATE``.
"""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import contextlib
import dataclasses
import io
import json

import pytest

from repro.core.planner import calibrate as jcal
from repro_torch.configs.base import TrainHParams
from repro_torch.configs.registry import get_config
from repro_torch.core.plan import LayerStrategy, ParallelPlan
from repro_torch.core.planner import calibrate
from repro_torch.core.planner.costmodel import H100_80GB_HBM3, HWConfig
from repro_torch.launch import steps
from repro_torch.launch import train as launcher
from repro_torch.runtime import Trainer

BASE = ["--reduced", "--device", "cpu", "--steps", "2", "--seed", "3"]


def _main(argv):
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        out = launcher.main(argv)
    text = buf.getvalue()
    lines = text.splitlines()                # the JSON comes last
    assert json.loads("\n".join(lines[lines.index("{"):])) == out
    return out, text


@pytest.mark.parametrize("tp", [1, 2])
def test_planned_run_replays_the_flag_run(tp, tmp_path):
    """The ILP's plan (uniform degree tp, oases; the 1-D search space)
    trains as the flags do, and its file replays the run."""
    flags = BASE + ["--tp", str(tp), "--schedule", "oases",
                    "--tmp-layout", "1d"]
    path = str(tmp_path / "plan.json")
    ref, _ = _main(flags)
    planned, text = _main(flags + ["--planner", "--no-calibrate",
                                   "--save-plan", path])
    replay, _ = _main(BASE + ["--tp", str(tp), "--plan", path])
    assert "H100_80GB_HBM3" in text and "planner: [[" in text
    plan = ParallelPlan.load(path)
    assert plan.layers == (LayerStrategy(tp, "oases"),) * 2
    assert plan.mesh_shape == (1, tp)
    assert planned["plan"] == replay["plan"] == plan.summary()
    assert planned["predicted_ms"] > 0 and "predicted_ms" not in replay
    for out in (planned, replay):
        assert (out["first_loss"], out["last_loss"]) == (
            ref["first_loss"], ref["last_loss"])
        assert "device_step_ms" not in out       # no device number on the CPU


@pytest.mark.parametrize("payload,item", [
    ({"layers": [[None, "oases", 2], [None, "oases", 1]]}, "A9"),
    ({"layers": [[[1, 2], "oases"], [[1, 2], "oases"]],
      "mesh_shape": [2, 1, 2], "mesh_axes": ["data", "model_x", "model_y"]},
     "A4"),
    ({"layers": [[None, "oases"]] * 2, "mesh_shape": [2, 1, 1],
      "mesh_axes": ["pipe", "data", "model"]}, "A8"),
    ({"layers": [[None, "oases"]] * 2, "pp": 2}, "A8"),
    ({"layers": [[None, "oases"]] * 2, "mesh_shape": [2, 1],
      "mesh_axes": ["data", "model"]}, "A4"),
])
def test_plans_the_port_cannot_run_raise(payload, item, tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(payload))
    summary = ParallelPlan.from_dict(payload).summary()
    with pytest.raises(NotImplementedError, match=item) as ei:
        _main(BASE + ["--plan", str(path)])
    assert summary in str(ei.value)


def test_plan_for_another_group_size_raises(tmp_path):
    path = tmp_path / "plan.json"
    ParallelPlan(layers=(LayerStrategy(None, "oases"),) * 2,
                 mesh_shape=(1, 2), mesh_axes=("data", "model")).save(
        str(path))
    with pytest.raises(ValueError, match="--tp 2"):
        _main(BASE + ["--tp", "1", "--plan", str(path)])


@pytest.mark.parametrize("knob,item", [
    ({"pp": 2}, "A8"), ({"grad_compress": True}, "A4"),
    ({"virtual_stages": 2}, "A8")])
def test_plan_knobs_refused_before_the_ranks(knob, item, tmp_path,
                                             monkeypatch):
    """A plan file's knobs the port cannot run raise in the launcher's
    process, before any rank is spawned."""
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"layers": [[None, "oases"]] * 2, **knob}))
    import repro_torch.launch.ranks as ranks

    def no_ranks(*a, **kw):
        raise AssertionError("ranks spawned for a plan the port refuses")

    monkeypatch.setattr(ranks, "run_ranks", no_ranks)
    with pytest.raises(NotImplementedError, match=item):
        _main(BASE + ["--tp", "2", "--plan", str(path)])


def test_2d_layout_raises():
    """The 2-D layout of a family the port trains at one rank only (MoE)
    raises naming A10c, before any rank starts."""
    with pytest.raises(NotImplementedError, match="A10c"):
        _main(["--arch", "granite-moe-3b-a800m"] + BASE
              + ["--mesh", "1x2x2", "--tmp-layout", "2d"])


def test_trainer_takes_a_plan():
    """``Trainer(plan=...)`` projects the plan onto its hyper-parameters
    (as JAX's), runs a mixed plan as plan groups, and refuses per-layer
    ring-attention seqs before building anything."""
    cfg = get_config("internlm2-1.8b").reduced().replace(dtype="float32")
    plan = ParallelPlan(layers=(LayerStrategy(None, "megatron"),) * 2,
                        split=1, microbatch=2)
    tr = Trainer(cfg, TrainHParams(), global_batch=4, seq_len=16,
                 device="cpu", log_fn=None, plan=plan)
    assert tr.plan is plan
    assert (tr.hp.schedule, tr.hp.split, tr.hp.microbatch) == (
        "megatron", 1, 2)
    mixed = ParallelPlan(layers=(LayerStrategy(None, "megatron"),
                                 LayerStrategy(None, "oases")))
    tr = Trainer(cfg, TrainHParams(), global_batch=4, seq_len=16,
                 device="cpu", log_fn=None, plan=mixed)
    assert [(g.schedule, ctx.schedule) for g, ctx in tr.step_fn.groups] \
        == [("megatron", "megatron"), ("oases", "oases")]
    seqs = ParallelPlan(layers=(LayerStrategy(None, "oases", 2),
                                LayerStrategy(None, "oases")))
    with pytest.raises(NotImplementedError, match="A9"):
        Trainer(cfg, TrainHParams(), global_batch=4, seq_len=16,
                device="cpu", log_fn=None, plan=seqs)


def test_uniform_ring_plan_becomes_seq_shard():
    cfg = get_config("internlm2-1.8b").reduced()
    plan = ParallelPlan(layers=(LayerStrategy(None, "oases", 2),) * 2)
    assert steps.unpack_plan(cfg, TrainHParams(), plan, 2).seq_shard == 2


def test_apply_keeps_the_ports_auto_microbatch(tmp_path):
    """0 is the port's auto count: a plan carrying 0 applies as 0, which
    the step resolves to the auto count (never JAX's "no accumulation"),
    and the launcher writes the resolved count into the plans it makes."""
    cfg = get_config("recurrentgemma-9b")
    auto = steps.resolve_hp(TrainHParams(), 4, seq_len=4096,
                            d_model=cfg.d_model,
                            num_layers=cfg.num_layers).microbatch
    assert auto == 4
    plan = ParallelPlan.from_hparams(TrainHParams(), cfg.num_layers)
    assert plan.microbatch == 0
    assert plan.apply(TrainHParams(microbatch=3)).microbatch == 0
    path = str(tmp_path / "plan.json")
    args = launcher.parse_args(["--arch", "recurrentgemma-9b", "--batch",
                                "4", "--seq", "4096", "--device", "cpu",
                                "--save-plan", path])
    with contextlib.redirect_stdout(io.StringIO()):
        _cfg, hp, _mesh, made, _ = launcher._resolve(args)
    assert hp.microbatch == made.microbatch == auto
    assert ParallelPlan.load(path).microbatch == auto


def test_no_fine_remat_is_coarse_remat():
    assert launcher.parse_args(["--no-fine-remat"]).coarse_remat
    assert launcher.parse_args(["--coarse-remat"]).coarse_remat
    assert not launcher.parse_args([]).coarse_remat


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------
MEASURED = dict(n_chips=1, peak_flops=7.1e14, hbm_bw=2.9e12, hbm_cap=85e9,
                mxu_base_eff=1.0, node_size=1, link_bw=450e9,
                link_bw_x=0.0, link_bw_y=0.0, comm_latency=5e-6,
                comm_latency_y=0.0)


@pytest.fixture
def cal_env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CAL_CACHE", str(tmp_path))
    monkeypatch.delenv("REPRO_NO_CALIBRATE", raising=False)
    monkeypatch.setattr(calibrate, "_MEM_CACHE", {})
    calls = []

    def measure(**kw):
        calls.append(kw)
        return dict(MEASURED)

    monkeypatch.setattr(HWConfig, "measure_fields", staticmethod(measure))
    return tmp_path, calls


def test_calibration_cache_written_once_and_read_back(cal_env, monkeypatch):
    tmp_path, calls = cal_env
    hw = calibrate.calibrated_hw(n_chips=2)
    assert len(calls) == 1
    files = list(tmp_path.iterdir())
    assert [str(f) for f in files] == [calibrate.cache_path()]
    assert files[0].name.startswith("torchcal-")
    rec = json.loads(files[0].read_text())
    assert rec["fields"] == MEASURED       # overrides are not baked in
    assert rec["fingerprint"] == calibrate.host_fingerprint()
    assert (hw.peak_flops, hw.n_chips, hw.node_size) == (7.1e14, 2, 1)
    # a fresh process: the memo is empty, the file answers
    monkeypatch.setattr(calibrate, "_MEM_CACHE", {})
    again = calibrate.calibrated_hw(n_chips=2)
    assert again == hw and len(calls) == 1


def test_calibration_honours_no_calibrate(cal_env, monkeypatch):
    tmp_path, calls = cal_env
    monkeypatch.setenv("REPRO_NO_CALIBRATE", "1")
    hw = calibrate.calibrated_hw(n_chips=2)
    assert not calls and not list(tmp_path.iterdir())
    assert hw == dataclasses.replace(H100_80GB_HBM3, n_chips=2, node_size=2)
    assert hw == calibrate.fixture_hw(n_chips=2)


def test_cache_file_never_the_jax_packages():
    fp = "host-x"
    assert calibrate.cache_path(fp) != jcal.cache_path(fp)
    assert "torch" in calibrate.host_fingerprint()


def test_measuring_needs_a_card():
    with pytest.raises(RuntimeError, match="--no-calibrate"):
        HWConfig.measure_fields(device="cpu")


# ---------------------------------------------------------------------------
# telemetry (--telemetry DIR)
# ---------------------------------------------------------------------------
def _records(d):
    from repro_torch.obs import report
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        assert report.main([d, "--validate"]) == 0
    assert "telemetry records OK" in buf.getvalue()
    return report.load(d)


def test_train_telemetry_tp1_skips_the_probe(tmp_path):
    """tp=1 has no collective: the probe says so (``overlap.skip``); the
    step records, the planner's event and the console lines are there."""
    from repro_torch.obs import get_recorder
    from repro_torch.obs.recorder import NULL
    d = str(tmp_path / "tel")
    out, text = _main(BASE + ["--steps", "3", "--planner", "--no-calibrate",
                              "--telemetry", d])
    assert get_recorder() is NULL          # the launcher restores it
    recs = _records(d)
    names = [r["name"] for r in recs]
    assert names.count("trainer.step_time_s") == 3
    assert names.count("trainer.loss") == 3 and "overlap.skip" in names
    plan_ev = [r for r in recs if r["name"] == "planner.plan"]
    assert len(plan_ev) == 1
    assert plan_ev[0]["tags"]["predicted_ms"] == round(out["predicted_ms"], 3)
    assert names.index("planner.plan") < names.index("trainer.step_time_s")
    assert "[trainer] step 0 loss" in text and "[planner] plan:" in text


def test_train_telemetry_tp2_only_rank0_writes(tmp_path, monkeypatch):
    """At tp=2 on gloo ranks the launcher's planner records come first,
    then rank 0's, once each: the ranks above 0 wrote nothing, and the
    probe's overlap records are there."""
    monkeypatch.setenv("REPRO_NO_CALIBRATE", "1")
    d = str(tmp_path / "tel")
    out, _ = _main(BASE + ["--tp", "2", "--schedule", "megatron",
                           "--planner", "--telemetry", d])
    recs = _records(d)
    names = [r["name"] for r in recs]
    assert names[:2] == ["planner.solve_ms", "planner.plan"]
    assert names.count("trainer.step_time_s") == 2
    assert names.count("trainer.loss") == 2
    losses = [r["value"] for r in recs if r["name"] == "trainer.loss"]
    assert (losses[0], losses[-1]) == (out["first_loss"], out["last_loss"])
    groups = [r for r in recs if r["name"] == "overlap.group"]
    assert len(groups) == 1 and groups[0]["tags"]["schedule"] == "megatron"
    assert 0.0 <= groups[0]["tags"]["measured_exposed_frac"] <= 1.0
    for g in ("overlap.measured_exposed_frac", "overlap.model_residual"):
        assert names.count(g) == 1


def test_train_telemetry_flush_must_be_positive(tmp_path):
    with pytest.raises(SystemExit, match="telemetry-flush"):
        _main(BASE + ["--telemetry", str(tmp_path), "--telemetry-flush",
                      "0"])
