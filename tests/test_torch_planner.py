"""The port's planner (``repro_torch.core.planner``) and executable plans
(``repro_torch.core.plan``) held to the JAX package's on the CPU.

Every case of ``tests/test_planner_golden.py`` and ``tests/test_planner.py``
(the free space, the spanning regime, 2-D against 1-D, mixed schedules,
the seq axis, serving latency, ``spec_k``, the paged-gather discount, every
family) and seeded draws of ``tests/test_planner_properties.py``'s random
configs run through both planners on the same inputs.  Pass: the same
degrees, schedules and seqs per layer, the same status, every float of the
result (``predicted_s`` and the rest) and of ``estimate_iteration`` on the
chosen strategy equal to relative 1e-12, and the attached executable plans
equal as JSON.  The port's configs are built from the JAX configs' fields,
so archs the port's registry lacks (A10b) run here too.  Plan files written
by either package load in the other.
"""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import dataclasses
import json
import math

import numpy as np
import pytest

from repro.configs import base as jbase
from repro.configs import gpt_oases as jgpt
from repro.configs.registry import get_config as jax_get_config
from repro.core import plan as jplan
from repro.core import planner as jplanner
from repro.core.planner import costmodel as jcm
from repro.core.schedule import SCHEDULES as JAX_EXEC_SCHEDULES
from repro_torch.configs import base as tbase
from repro_torch.configs import gpt_oases as tgpt
from repro_torch.configs.registry import _ARCHS as PORT_ARCHS
from repro_torch.configs.registry import get_config
from repro_torch.core import plan as tplan
from repro_torch.core import planner as tplanner
from repro_torch.core import schedule as tschedule
from repro_torch.core.planner import costmodel as tcm

REL = 1e-12


class Side:
    """One package's planner, configs and fixtures, addressed by name."""

    def __init__(self, base, gpt, planner, cm, port):
        self.base, self.gpt, self.planner, self.cm = base, gpt, planner, cm
        self.port = port

    def arch(self, spec):
        if isinstance(spec, dict):
            return self.base.ArchConfig(**spec)
        jcfg = (jgpt.PAPER_TABLE4[spec][0] if spec in jgpt.PAPER_TABLE4
                else jax_get_config(spec))
        if not self.port:
            return jcfg
        kw = dataclasses.asdict(jcfg)
        if jcfg.moe is not None:
            kw["moe"] = self.base.MoEConfig(**kw["moe"])
        return self.base.ArchConfig(**kw)

    def shape(self, spec):
        if isinstance(spec, str):
            return self.base.SHAPES[spec]
        if spec[0] == "paper":
            return self.gpt.paper_shape(spec[1])
        return self.base.ShapeConfig(*spec)

    def hw(self, spec):
        if isinstance(spec, dict):
            return self.cm.HWConfig(**spec)
        return {"25gbe": self.cm.COMMODITY_25GBE,
                "nvlink": self.cm.NVLINK_BOX, "v5e": self.cm.V5E}[spec]


JAX = Side(jbase, jgpt, jplanner, jcm, port=False)
PORT = Side(tbase, tgpt, tplanner, tcm, port=True)

H8192 = "gpt-h8192"
PAPER = ("paper", jgpt.PAPER_TABLE4[H8192][3])
SERVE = ("serve_b8_4k", 4096, 8, "decode")
MIXED_CAPS = {"llama-3.2-vision-11b": 18.5e9, "granite-moe-3b-a800m": 5.6e9}
SEQ_ARCH, SEQ_CAP = "internlm2-1.8b", 10.8e9


def _c(fn, arch, shape, hw, hp=None, **kw):
    if fn in ("plan", "replan", "plan_joint"):
        # far above any solve here, so that a loaded host cannot make one
        # package's solve stop at the limit and the other's not
        kw.setdefault("time_limit", 120.0)
    return dict(fn=fn, arch=arch, shape=shape, hw=hw, hp=hp or {}, kw=kw)


def _prop_arch(num_layers, d_model, heads, ff_mult):
    return dict(name="prop", family="dense", num_layers=num_layers,
                d_model=d_model, num_heads=heads,
                num_kv_heads=heads // 2 or 1, d_ff=d_model * ff_mult,
                vocab_size=1024, head_dim=d_model // heads)


def _prop_hw(n_chips, node_size, bw, bw_x, bw_y):
    return dict(n_chips=n_chips, node_size=node_size, peak_flops=1e14,
                hbm_bw=8e11, link_bw=bw, link_bw_x=bw_x, link_bw_y=bw_y,
                hbm_cap=32e9)


def _property_cases(n=12, seed=0):
    """Seeded draws over test_planner_properties.py's plan_feasible space."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        pick = lambda xs: xs[int(rng.integers(len(xs)))]   # noqa: E731
        arch = _prop_arch(int(rng.integers(2, 6)), pick([128, 256, 512]),
                          pick([4, 8]), pick([2, 4]))
        n_chips = pick([8, 16])
        hw = _prop_hw(n_chips, pick([0, 4, 8]), float(rng.uniform(1e9, 1e11)),
                      pick([0.0, 5e10, 2e11]), pick([0.0, 2e9, 1e10]))
        out[f"property-{i}"] = _c(
            "plan", arch, ("prop_train", 512, 16, "train"), hw,
            hp=dict(schedule=pick(["oases", "megatron", "fused"])),
            options=tuple(n for n in (2, 4, 8, 16) if n <= n_chips),
            layout=pick(["1d", "2d", "auto"]), mem_cap=64e9)
    return out


CASES = {}
# test_planner_golden.py: free space, spanning regime, 2-D vs 1-D
for _s in ("oases", "fused", "megatron"):
    for _f in ("25gbe", "nvlink"):
        for _layout in ("1d", "auto"):
            CASES[f"golden-{_s}-{_f}-{_layout}"] = _c(
                "plan", H8192, PAPER, _f, hp=dict(schedule=_s),
                layout=_layout)
            CASES[f"golden-spanning-{_s}-{_f}-{_layout}"] = _c(
                "plan", H8192, PAPER, _f, hp=dict(schedule=_s),
                options=(16,), layout=_layout)
CASES["golden-defaults-oases-tuple"] = _c(
    "plan", H8192, PAPER, "25gbe", schedules=("oases",))
# mixed (degree, schedule) plans and every uniform schedule beside them
for _a, _cap in MIXED_CAPS.items():
    for _sch in ("auto",) + tuple(JAX_EXEC_SCHEDULES):
        CASES[f"mixed-{_a}-{_sch}"] = _c(
            "plan", _a, "train_4k", "25gbe", options=(8, 16), mem_cap=_cap,
            schedules=_sch if _sch == "auto" else (_sch,))
# the seq axis: under the long-context cap and with memory free
for _seq in ("auto", "none"):
    CASES[f"seq-capped-{_seq}"] = _c(
        "plan", SEQ_ARCH, "prefill_32k", "25gbe", options=(8, 16),
        mem_cap=SEQ_CAP, schedules="auto", seq=_seq)
    CASES[f"seq-free-{_seq}"] = _c(
        "plan", SEQ_ARCH, "prefill_32k", "25gbe", options=(8, 16),
        schedules="auto", seq=_seq)
# serving latency, pp candidates, spec_k, the paged-gather discount
for _f in ("25gbe", "nvlink"):
    CASES[f"serve-latency-{_f}"] = _c(
        "plan", H8192, SERVE, _f, hp=dict(schedule="fused"), options=(16,),
        objective="latency")
    CASES[f"serve-spec-{_f}"] = _c(
        "plan_serving", "gpt-serve-h4096", SERVE, _f,
        hp=dict(schedule="fused"), options=(16,), pp_options=(1,),
        spec_options=(0, 1, 2, 3, 4), draft="gpt-draft-h2048")
    for _sched in ("fused", "megatron"):
        for _deg in (16, (8, 2)):
            CASES[f"decode-{_f}-{_sched}-{_deg}"] = _c(
                "decode_step_time", H8192, SERVE, _f,
                hp=dict(schedule=_sched), degree=_deg)
CASES["serve-pp2"] = _c(
    "plan_serving", H8192, SERVE, "25gbe", hp=dict(schedule="fused"),
    options=(16,), pp_options=(2,))
CASES["decode-spec3"] = _c(
    "decode_step_time", "gpt-serve-h4096", SERVE, "25gbe",
    hp=dict(schedule="fused"), degree=(8, 2), spec_k=3,
    draft="gpt-draft-h2048")
CASES["decode-pp2"] = _c("decode_step_time", "gpt-serve-h4096", SERVE,
                         "25gbe", degree=8, pp=2)
for _ps in (0, 4, 16, 64, 256):
    CASES[f"decode-paged-{_ps}"] = _c(
        "decode_step_time", H8192, SERVE, "25gbe",
        hp=dict(schedule="fused"), degree=(8, 2), page_size=_ps)
# estimate_iteration: schedule transitions, seq transitions, remat, 2-D
_GRAN = "granite-moe-3b-a800m"
CASES["estimate-transition-mixed"] = _c(
    "estimate_iteration", _GRAN, "train_4k", "25gbe", degrees=8,
    schedules=lambda L: ["oases"] * (L // 2) + ["megatron"] * (L - L // 2))
for _s in ("oases", "megatron"):
    CASES[f"estimate-transition-{_s}"] = _c(
        "estimate_iteration", _GRAN, "train_4k", "25gbe", degrees=8,
        schedules=lambda L, s=_s: [s] * L)
CASES["estimate-seq-fragmented"] = _c(
    "estimate_iteration", SEQ_ARCH, "prefill_32k", "25gbe", degrees=8,
    options=(8,), seqs=lambda L: [8 if i % 2 else 1 for i in range(L)])
CASES["estimate-seq-consolidated"] = _c(
    "estimate_iteration", SEQ_ARCH, "prefill_32k", "25gbe", degrees=8,
    options=(8,), seqs=lambda L: sorted(8 if i % 2 else 1 for i in range(L)))
for _d in (2, 4, 8, 16, (8, 1), (4, 2)):
    for _hp in (dict(schedule="oases"), dict(schedule="megatron"),
                dict(schedule="fused"),
                dict(schedule="megatron", fine_remat=False)):
        CASES[f"estimate-internlm-{_d}-{'-'.join(map(str, _hp.values()))}"] \
            = _c("estimate_iteration", "internlm2-1.8b", "train_4k", "v5e",
                 hp=_hp, degrees=_d)
_HETERO = dict(n_chips=16, node_size=8, link_bw_x=100e9, link_bw_y=2e9)
for _d in (16, (8, 2)):
    for _name, _hw in (("hetero", _HETERO),
                       ("fast", dict(_HETERO, link_bw_y=100e9))):
        CASES[f"estimate-{_name}-{_d}"] = _c(
            "estimate_iteration", "internlm2-1.8b", "train_4k", _hw,
            hp=dict(schedule="fused"), degrees=_d)
for _sname in ("train_4k", "prefill_32k"):
    CASES[f"estimate-recurrentgemma-{_sname}"] = _c(
        "estimate_iteration", "recurrentgemma-9b", _sname, "v5e",
        degrees=16)
# test_planner.py: default hardware, memory caps, every family, layouts
for _a in ("internlm2-1.8b", "gemma2-9b", "granite-8b", "internlm2-20b",
           "recurrentgemma-9b", "moonshot-v1-16b-a3b", "whisper-small",
           "mamba2-130m", "llama-3.2-vision-11b"):
    CASES[f"family-{_a}"] = _c("plan", _a, "train_4k", "v5e")
for _cap in (64e9, 8e9, 3.2e10):
    CASES[f"memcap-granite-8b-{_cap:g}"] = _c(
        "plan", "granite-8b", "train_4k", "v5e", mem_cap=_cap)
CASES["fused-granite-8b"] = _c("plan", "granite-8b", "train_4k", "v5e",
                               hp=dict(schedule="fused"))
for _layout in ("1d", "auto", "2d"):
    CASES[f"layout-granite-8b-{_layout}"] = _c(
        "plan", "granite-8b", "train_4k", _HETERO,
        hp=dict(schedule="fused"), layout=_layout)
# replan (a degraded topology) and the joint PP x TMP search
CASES["replan-degraded"] = _c(
    "replan", "internlm2-1.8b", "train_4k",
    dict(n_chips=6, node_size=4, link_bw=50e9), options=(2, 4, 8, 16))
CASES["plan-joint"] = _c(
    "plan_joint", "internlm2-1.8b", "train_4k", "25gbe", options=(16,),
    pp_options=(1, 2))
CASES.update(_property_cases())


def _per_layer(value, L):
    if callable(value):
        return value(L)
    return [value] * L


def _run(side, case):
    cfg = side.arch(case["arch"])
    shape, hw = side.shape(case["shape"]), side.hw(case["hw"])
    hp = side.base.TrainHParams(**case["hp"])
    kw = dict(case["kw"])
    if "draft" in kw:
        kw["draft"] = side.arch(kw["draft"])
    fn = getattr(side.planner, case["fn"])
    if case["fn"] == "decode_step_time":
        return fn(cfg, shape, hp, hw, kw.pop("degree"), **kw)
    if case["fn"] == "estimate_iteration":
        L = cfg.num_layers
        for key in ("schedules", "seqs"):
            if key in kw:
                kw[key] = _per_layer(kw[key], L)
        return fn(cfg, shape, hp, _per_layer(kw.pop("degrees"), L), hw,
                  **kw)
    res = fn(cfg, shape, hp, hw, **kw)
    if hasattr(res, "seqs") and hasattr(res, "degrees"):
        # every estimate_iteration field of the chosen strategy
        res = (res, side.planner.estimate_iteration(
            cfg, shape, hp, res.degrees, hw, schedules=res.schedules,
            seqs=res.seqs))
    return res


def _same(a, b, path="result"):
    """Equal structure, equal ints/strings, floats to relative 1e-12;
    solve times are not compared, attached plans as JSON."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            if f.name == "solve_ms":
                continue
            x, y = getattr(a, f.name), getattr(b, f.name)
            if f.name == "plan" and x is not None:
                assert y is not None and x.to_dict() == y.to_dict(), path
                continue
            _same(x, y, f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert isinstance(b, (float, int)), (path, a, b)
        assert (a == b or math.isclose(a, b, rel_tol=REL, abs_tol=0.0)
                or (math.isnan(a) and math.isnan(b))), (path, a, b)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_planner_matches_jax(name):
    _same(_run(JAX, CASES[name]), _run(PORT, CASES[name]))


def test_golden_decisions_reproduced():
    """Spot checks that the cases above are the golden regimes: the port
    itself returns the pinned free-space and 2-D decisions."""
    r = _run(PORT, CASES["golden-fused-25gbe-auto"])[0]
    assert r.degrees == [4] * len(r.degrees) and r.status == "0"
    r = _run(PORT, CASES["golden-spanning-oases-25gbe-auto"])[0]
    assert r.degrees == [(8, 2)] * len(r.degrees)
    r = _run(PORT, CASES["mixed-granite-moe-3b-a800m-auto"])[0]
    got = {}
    for d, s in zip(r.degrees, r.schedules):
        got[(d, s)] = got.get((d, s), 0) + 1
    assert got == {(8, "oases"): 18, (16, "wang"): 14}, r.summary()


@pytest.mark.parametrize("fn,args", [
    ("plan", dict(seq="wat")), ("plan", dict(objective="wat")),
    ("decode_step_time", dict(spec_k=2)),
    ("decode_step_time", dict(spec_k=2, pp=2, draft="gpt-draft-h2048")),
    ("plan_serving", dict(spec_options=(0, 2))),
])
def test_planner_refusals_match_jax(fn, args):
    msgs = []
    for side in (JAX, PORT):
        kw = dict(args)
        if "draft" in kw:
            kw["draft"] = side.arch(kw["draft"])
        cfg, shape = side.arch("gpt-serve-h4096"), side.shape(SERVE)
        hp, hw = side.base.TrainHParams(), side.hw("25gbe")
        with pytest.raises(ValueError) as ei:
            if fn == "decode_step_time":
                side.planner.decode_step_time(cfg, shape, hp, hw, 8, **kw)
            else:
                getattr(side.planner, fn)(cfg, shape, hp, hw,
                                          options=(16,), **kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("fixture", ["COMMODITY_25GBE", "NVLINK_BOX", "V5E"])
def test_fixtures_match_jax(fixture):
    assert (dataclasses.asdict(getattr(tcm, fixture))
            == dataclasses.asdict(getattr(jcm, fixture)))
    assert tcm.HWConfig() == tcm.V5E


@pytest.mark.parametrize("d,c,steps", [(3.0, 2.0, 4), (5.0, 0.0, 8),
                                       (0.0, 5.0, 8), (1.5, 7.25, 1)])
def test_overlap_laws_match_jax(d, c, steps):
    assert tcm.overlapped_time(d, c, steps) == jcm.overlapped_time(d, c,
                                                                   steps)
    for cy in (0.0, 1.0, 9.0):
        assert (tcm.overlapped_time_2d(d, c, cy, steps)
                == jcm.overlapped_time_2d(d, c, cy, steps))


def test_expand_options_match_jax():
    for arch in ("internlm2-1.8b", "gemma2-9b"):
        for layout in ("1d", "2d", "auto"):
            hw = dict(n_chips=16, node_size=8)
            assert (tplanner.expand_options(PORT.arch(arch),
                                            PORT.hw(hw), (2, 4, 8, 16),
                                            layout)
                    == jplanner.expand_options(JAX.arch(arch), JAX.hw(hw),
                                               (2, 4, 8, 16), layout))


def test_h100_fixture_from_bounds():
    """The port's card fixture states the data sheet through
    kernels/bounds.py, and the defaults stay JAX's TPU numbers."""
    from repro_torch.kernels import bounds
    h = tcm.H100_80GB_HBM3
    assert h.peak_flops == bounds.PEAK_FLOPS["bfloat16"]
    assert h.hbm_bw == bounds.PEAK_BYTES
    assert h.hbm_cap == 80e9 and h.node_size == 8
    assert tcm.V5E.peak_flops == 197e12


# ---------------------------------------------------------------------------
# configs the planner reads
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(PORT_ARCHS))
def test_registry_configs_match_jax(arch):
    """Every field of JAX's ArchConfig, the new ones included, full and
    reduced."""
    mine, full = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(full)
    assert (dataclasses.asdict(mine.reduced())
            == dataclasses.asdict(full.reduced()))


def test_shapes_match_jax():
    assert ({k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()})
    assert tgpt.PAPER_SEQ_LEN == jgpt.PAPER_SEQ_LEN
    assert (dataclasses.asdict(tgpt.paper_shape(32))
            == dataclasses.asdict(jgpt.paper_shape(32)))
    assert tbase.CROSS_ATTN == jbase.CROSS_ATTN


def test_hparams_defaults_match_jax():
    port, jax_ = tbase.TrainHParams(), jbase.TrainHParams()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(jax_, f.name), f.name


@pytest.mark.parametrize("kw,item", [
    (dict(grad_compress=True), "A4"), (dict(virtual_stages=2), "A8")])
def test_hparams_refuse_what_the_port_does_not_run(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        tbase.TrainHParams(**kw)


def test_hparams_take_the_2d_layout():
    assert tbase.TrainHParams(tmp_layout="2d").tmp_layout == "2d"


def test_hparams_validate_names():
    with pytest.raises(ValueError, match="valid schedules are"):
        tbase.TrainHParams(schedule="megatorn")
    with pytest.raises(ValueError, match="tmp_layout"):
        tbase.TrainHParams(tmp_layout="3d")


# ---------------------------------------------------------------------------
# executable plans: one schedule set, JSON interop, the same validation
# ---------------------------------------------------------------------------
def test_schedule_sets_agree():
    """The port keeps one schedule set: the schedules' and the plans' are
    the same object, equal to JAX's."""
    assert tschedule.SCHEDULES is tplan.SCHEDULES
    assert tschedule.validate_schedule is tplan.validate_schedule
    assert tuple(tplan.SCHEDULES) == tuple(JAX_EXEC_SCHEDULES)
    assert tplan.TMP_LAYOUTS == jplan.TMP_LAYOUTS


def _plan_cases(mod):
    LS, PP = mod.LayerStrategy, mod.ParallelPlan
    return [
        PP(layers=(LS(None, "oases"),)),
        PP(layers=(LS(2, "megatron"), LS((4, 2), "fused"),
                   LS(None, "wang")), tmp_layout="2d", split=1,
           zero1=False),
        PP(layers=(LS(16, "merak"),) * 5, microbatch=8, decode_micro=2,
           grad_compress=True, seq_parallel=True),
        PP(layers=(LS(8, "fused"),) * 4, mesh_shape=(2, 1, 8),
           mesh_axes=("pipe", "data", "model"), pp=2, virtual_stages=2),
        PP(layers=(LS(None, "oases", 1),) * 3 + (LS(None, "oases", 8),) * 2,
           mesh_shape=(1, 8), mesh_axes=("data", "model"), seq_shard=1),
        PP(layers=(LS(None, "oases"),) * 4, seq_shard=4),
    ]


@pytest.mark.parametrize("i", range(6))
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_plan_files_interchange(i, direction, tmp_path):
    src, dst = (jplan, tplan) if direction == "jax-to-port" else (tplan,
                                                                   jplan)
    p = _plan_cases(src)[i]
    path = p.save(str(tmp_path / "plan.json"))
    q = dst.ParallelPlan.load(path)
    assert q.to_dict() == p.to_dict()
    assert q.to_json() == p.to_json()
    assert q == _plan_cases(dst)[i]
    assert q.summary() == p.summary()
    assert q.grouping_signature() == p.grouping_signature()
    assert (q.is_mixed, q.primary_schedule, q.planned_degrees,
            q.planned_seqs) == (p.is_mixed, p.primary_schedule,
                                p.planned_degrees, p.planned_seqs)


@pytest.mark.parametrize("text", [
    "{not json", "[1, 2]", "{}", '{"layers": [[4, "oases"]], "frob": 1}',
    '{"layers": [[4, "oases", "extra"]]}',
    '{"layers": [{"degree": 4, "schedule": "oases", "x": 1}]}',
    '{"layers": [[3, "oases"]]}', '{"layers": [[4, "bogus"]]}',
    '{"layers": [[null, "oases"]], "pp": 0}',
    '{"layers": [[null, "oases"]], "mesh_shape": [2], "mesh_axes": []}',
    '{"layers": [[null, "oases"], [null, "wang"]], "pp": 2}'])
def test_plan_refusals_match_jax(text):
    msgs = []
    for mod in (jplan, tplan):
        with pytest.raises(ValueError) as ei:
            mod.ParallelPlan.from_json(text)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_from_hparams_apply_roundtrip():
    hp = tbase.TrainHParams(schedule="fused", tmp_layout="1d", split=4,
                            microbatch=2, zero1=False, seq_parallel=True,
                            seq_shard=2)
    p = tplan.ParallelPlan.from_hparams(hp, 6)
    assert p.num_layers == 6 and not p.is_mixed
    hp2 = p.apply(tbase.TrainHParams())
    for f in ("schedule", "tmp_layout", "split", "microbatch",
              "virtual_stages", "zero1", "grad_compress", "seq_parallel",
              "seq_shard"):
        assert getattr(hp2, f) == getattr(hp, f), f
    with pytest.raises(ValueError, match="entries"):
        tplan.ParallelPlan.from_hparams(hp, 4, degrees=[2, 2])


def test_planner_attaches_the_same_plan():
    """plan() wraps its decision as an executable plan in both packages,
    and a ring decision on a uniform degree follows the mesh."""
    r = _run(PORT, CASES["seq-capped-auto"])[0]
    assert r.plan is not None and r.plan.planned_seqs == tuple(r.seqs)
    assert all(ls.degree is None for ls in r.plan.layers)
    j = _run(JAX, CASES["seq-capped-auto"])[0]
    assert (tplan.ParallelPlan.from_json(j.plan.to_json()).to_dict()
            == r.plan.to_dict())
