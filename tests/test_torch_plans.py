"""The port's per-layer plans against the JAX package on the CPU:

* the mesh algebra (``core/axes.py``: ``MeshInfo`` per degree, the
  linearized ``axes_index``, ``batch_pspec`` / ``local_batch``) held to
  JAX's own ``MeshInfo`` through a stand-in mesh (``mesh_info`` reads only
  ``axis_names`` and ``shape``), and the launcher's parsers to JAX's,
  messages included;
* the weight carrier (``relayout_flat``, ``split_layer_flat``,
  ``pack_layer_flat``) leaf for leaf against JAX's on the grouped cases of
  ``tests/_scripts/plan_equivalence.py``;
* mixed schedules at uniform degree on 2 gloo ranks and mixed degrees on
  the factored mesh ``(1, 2, 2)`` on 4, against JAX's 1-device
  ``build_train_loss`` on the same weights (the gate of
  ``plan_equivalence.py``): loss within 1e-5 relative on every rank,
  gradients gathered into the stacked layout within ``grads_err`` 1e-4;
* the Trainer under a mixed plan: replicas bitwise equal after its
  steps, losses against the one-rank Trainer (1e-5 relative);
* the launcher's ``--mesh factored --plan`` against its one-rank run;
* the refusals: a ``data`` axis above 1 (A4), pipelines (A8), per-layer
  seqs (A9), and a batch the extra data-parallel ranks do not divide.

One spawn per mesh runs every case (``tests/_torch_ranks.py``).
"""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import json
import types

import numpy as np
import pytest

from repro.core import axes as jaxes
from repro.launch import mesh as jmesh
from repro.models import params as jprm
from repro_torch.configs.base import TrainHParams
from repro_torch.configs.registry import get_config
from repro_torch.core import axes as taxes
from repro_torch.core.plan import LayerStrategy, ParallelPlan
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import params as tprm

import _torch_jax_oracle as jo
import _torch_ranks

ARCH = "internlm2-1.8b"
B, S = 4, 64
TIMEOUT = 240
FACTORED = ((1, 2, 2), ("data", "t1", "t2"))
MESHES = {"factored4": FACTORED,
          "factored8": ((1, 2, 2, 2), ("data", "t1", "t2", "t3")),
          "xy": ((1, 2, 2), ("data", "model_x", "model_y")),
          "1d": ((1, 4), ("data", "model"))}
DEGREES = [None, 1, 2, 4, 8, (1, 2), (2, 1), (2, 2), (1, 4), (4, 1),
           (2, 4), (4, 2), (8, 1), 16]
SCHED_CASES = [["oases", "megatron"], ["fused", "oases"],
               ["megatron", "wang"], ["merak", "oases"]]
DEGREE_CASES = [([4, 2], ["oases", "fused"]), ([2, 4], ["oases", "fused"]),
                ([4, 2], ["wang", "oases"]), ([2, 4], ["wang", "oases"])]
TRAINER_PLAN = {"layers": [[4, "oases"], [2, "megatron"]]}
TRAINER_KW = dict(learning_rate=1e-3, warmup_steps=1, microbatch=2)


def _case(degrees, scheds):
    return f"{degrees}-{scheds}"


def _call(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except (ValueError, NotImplementedError) as e:
        return (type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# the mesh algebra
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_info_matches_jax(mesh):
    """Every MeshInfo property and per-degree axis method, and the batch
    specs at batch 1, 4 and 8, as JAX's MeshInfo computes them (or the
    same error with the same message)."""
    shape, names = MESHES[mesh]
    stand_in = types.SimpleNamespace(axis_names=names,
                                     shape=dict(zip(names, shape)))
    j = jaxes.mesh_info(stand_in)
    t = taxes.mesh_info(taxes.RankMesh(shape, names))
    for f in ("batch_axes", "model_axes", "pipe_axes", "tp", "pp", "dp",
              "factored", "twod"):
        assert getattr(t, f) == getattr(j, f), f
    for d in DEGREES:
        for m in ("tp_axes", "xy_axes", "extra_dp_axes", "all_batch_axes"):
            assert _call(getattr(t, m), d) == _call(getattr(j, m), d), (m, d)
        for b in (1, 4, 8):
            want = _call(jaxes.batch_pspec, j, b, d)
            if want[0] == "ok":
                entry = want[1][0] or ()
                want = ("ok", (entry,) if isinstance(entry, str)
                        else tuple(entry))
            assert _call(taxes.batch_pspec, t, b, d) == want, (d, b)
            assert (_call(taxes.local_batch, t, b, d)
                    == _call(jaxes.local_batch, j, b, d)), (d, b)
    assert t.axes_not_in(((names[1],), None)) == j.axes_not_in(
        (names[1], None))


@pytest.mark.parametrize("mesh", ["factored8", "xy"])
def test_axes_index_and_groups(mesh):
    """``axes_index`` is JAX's linearized index over the ORDERED tuple
    (``idx = idx * size(a) + coord(a)``, ``repro.core.tmp.axes_index``);
    rank r sits at the row-major coordinates of r; each group over an
    axes tuple is the ranks sharing every other coordinate, listed in
    ``axes_index`` order, and the groups partition the mesh."""
    m = taxes.RankMesh(*MESHES[mesh])
    model = m.axis_names[1:]
    tuples = [model, model[::-1], model[:1], model[1:], ()]
    for r in range(m.size):
        c = m.coords(r)
        assert m.rank_of(c) == r
        assert m.axes_index(r, m.axis_names) == r
        for axes in tuples:
            idx = 0
            for a in axes:
                idx = idx * m.sizes[a] + c[a]
            assert m.axes_index(r, axes) == idx
            g = m.group(r, axes)
            assert g[idx] == r
            assert [m.axes_index(q, axes) for q in g] == list(range(len(g)))
    for axes in tuples:
        flat = sorted(q for g in m.groups(axes) for q in g)
        assert flat == list(range(m.size))


@pytest.mark.parametrize("spec", ["8,4x2,16", "2,2", "4x2", "3", "4x3",
                                  "4x2x2", "a", "4,,2", "", "0", "2xb"])
def test_parse_degrees_matches_jax(spec):
    assert _call(tmesh.parse_degrees, spec) == _call(jmesh.parse_degrees,
                                                     spec)


@pytest.mark.parametrize("spec,pp", [("1x4", 0), ("1x2x2", 0), ("2x8", 2),
                                     ("4", 0), ("1x2x2x2", 0), ("1xa", 0),
                                     ("0x4", 0), ("1x4", -1)])
def test_parse_mesh_spec_matches_jax(spec, pp):
    assert (_call(tmesh.parse_mesh_spec, spec, pp=pp)
            == _call(jmesh.parse_mesh_spec, spec, pp=pp))


def test_resolve_mesh_spec():
    """``auto`` is ``(1, tp)``, ``factored`` has log2(tp) binary t-axes,
    an explicit spec sets the ranks, and a JAX pod mesh or a --tp the
    spec's model group does not have is refused."""
    assert tmesh.resolve_mesh_spec("auto", tp=2) == taxes.RankMesh(
        (1, 2), ("data", "model"))
    assert tmesh.resolve_mesh_spec("factored", tp=8) == taxes.RankMesh(
        (1, 2, 2, 2), ("data", "t1", "t2", "t3"))
    assert tmesh.resolve_mesh_spec("1x2x2") == taxes.RankMesh(
        (1, 2, 2), ("data", "model_x", "model_y"))
    assert tmesh.mesh_signature(tmesh.make_2d_mesh(1, 2, 4)) == (
        (1, 2, 4), ("data", "model_x", "model_y"))
    for bad, kw in (("factored", dict(tp=3)), ("production", {}),
                    ("1x2x2", dict(tp=2))):
        with pytest.raises(ValueError):
            tmesh.resolve_mesh_spec(bad, **kw)


# ---------------------------------------------------------------------------
# the weight carrier
# ---------------------------------------------------------------------------
CARRIER_CASES = ([(None, s) for s in SCHED_CASES]
                 + [(d, s) for d, s in (([4, 2], ["oases", "fused"]),
                                        ([8, 8], ["megatron", "oases"]),
                                        ([(2, 2), 4], ["fused", "wang"]),
                                        ([8, 4], ["wang", "oases"]))])


@pytest.mark.parametrize("degrees,scheds", CARRIER_CASES)
def test_weight_carrier_matches_jax(degrees, scheds):
    """JAX's stacked weights into the plan's grouped layout and back,
    split and pack, leaf for leaf equal to JAX's own helpers; the grouped
    names are those of the port's grouped ``model_specs``."""
    import jax
    from repro.configs.registry import get_config as jget
    from repro.core import compat
    jcfg = jget(ARCH).reduced().replace(dtype="float32")
    tcfg = get_config(ARCH).reduced().replace(dtype="float32")
    mesh = compat.make_mesh((1, 1), ("data", "model"),
                            axis_types=compat.auto_axis_types(2))
    from repro.core.axes import mesh_info
    specs = jprm.model_specs(jcfg, mesh_info(mesh))
    flat = jprm.tree_to_flat(jprm.init_params(specs, jax.random.PRNGKey(1)))
    degs = degrees or [None] * tcfg.num_layers
    dst = {"degrees": degs, "schedules": scheds}
    got = tprm.relayout_flat(tcfg, flat, {}, dst)
    want = jprm.relayout_flat(jcfg, flat, {}, dst)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert set(got) == set(tprm.model_specs(
        tcfg, taxes.mesh_info(tmesh.make_factored_mesh(8)),
        degrees=degs, schedules=scheds))
    back = tprm.relayout_flat(tcfg, got, dst, {})
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    ts, tl = tprm.split_layer_flat(tcfg, got, **dst)
    js, jl = jprm.split_layer_flat(jcfg, got, **dst)
    assert ts.keys() == js.keys() and len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    packed = tprm.pack_layer_flat(tcfg, ts, tl, **dst)
    assert list(packed) == list(jprm.pack_layer_flat(jcfg, js, jl, **dst))


def test_weight_carrier_refuses_a_wrong_plan():
    cfg = get_config(ARCH).reduced()
    flat = {k: np.zeros(s.shape, np.float32)
            for k, s in tprm.model_specs(cfg).items()}
    grouped = tprm.relayout_flat(cfg, flat, {}, {"degrees": [4, 2],
                                                 "schedules": ["oases"] * 2})
    with pytest.raises(ValueError, match="no per-layer plan"):
        tprm.split_layer_flat(cfg, grouped)
    with pytest.raises(ValueError, match="plan group expects"):
        tprm.split_layer_flat(cfg, grouped, degrees=[4, 4],
                              schedules=["oases"] * 2)


# ---------------------------------------------------------------------------
# runs on gloo ranks against JAX's oracle
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def oracle():
    return jo.oracle(ARCH, B, S)


@pytest.fixture(scope="module")
def ranks(oracle):
    """One spawn on 2 ranks (mixed schedules), one on the factored mesh of
    4 (mixed degrees, the Trainer under a mixed plan, the batch refusal)."""
    sched = {_case(None, s): dict(schedules=s) for s in SCHED_CASES}
    two = run_ranks(_torch_ranks.everything, 2, device="cpu", threads=1,
                    timeout=TIMEOUT, args=({"model": (
                        "plan_variants", (ARCH, oracle["flat"],
                                          oracle["batch"], sched))},))
    deg = {_case(d, s): dict(degrees=d, schedules=s)
           for d, s in DEGREE_CASES}
    four = run_ranks(_torch_ranks.everything, device="cpu", threads=1,
                     timeout=TIMEOUT, mesh=FACTORED, args=({
                         "model": ("plan_variants",
                                   (ARCH, oracle["flat"], oracle["batch"],
                                    deg)),
                         "trainer": ("plan_trainer",
                                     ("gpt-h1024", _gpt_flat(), TRAINER_KW,
                                      TRAINER_PLAN, 2, 4, 32)),
                         "split": ("split_raises", (ARCH, [4, 2], 3))},))
    return {2: two, 4: four}


def _gpt_flat():
    cfg = get_config("gpt-h1024").reduced().replace(dtype="float32")
    return tprm.to_flat(tprm.init_params(cfg, seed=5))


def _check(res, oracle, mesh, case):
    cfg = get_config(ARCH).reduced().replace(dtype="float32")
    runs = [r["model"][case] for r in res]
    for r in runs:
        assert abs(r["loss"] - oracle["loss"]) <= 1e-5 * abs(oracle["loss"])
    assert len({r["loss"] for r in runs}) == 1
    degrees, scheds = runs[0]["layout"]
    lay = tprm.ModelLayout(cfg, taxes.mesh_info(taxes.RankMesh(*mesh)),
                           degrees, scheds)
    grads = lay.gather([r["grads"] for r in runs], partial=True)
    assert set(grads) == set(oracle["grads"])
    assert jo.grads_err(oracle["grads"], grads) <= 1e-4


@pytest.mark.parametrize("scheds", SCHED_CASES)
def test_mixed_schedules_match_jax(ranks, oracle, scheds):
    """Per-layer schedules at the mesh's degree (2 ranks): each schedule's
    layer runs as its own plan group, under its own context and split."""
    _check(ranks[2], oracle, ((1, 2), ("data", "model")),
           _case(None, scheds))


@pytest.mark.parametrize("degrees,scheds", DEGREE_CASES)
def test_mixed_degrees_match_jax(ranks, oracle, degrees, scheds):
    """Degree 4 and degree 2 layers on the factored mesh: the degree-2
    group's two sub-groups each train half the batch, the batch
    resharded at each degree change."""
    _check(ranks[4], oracle, FACTORED, _case(degrees, scheds))


@pytest.mark.parametrize("degrees", [[4, 2], [2, 4]])
def test_mixed_plan_counts_its_reshards(ranks, degrees):
    """One degree change each way: the forward cuts the batch into the
    degree-2 group (a free slice) and gathers it back (one all-gather);
    the backward all-gathers the cut's cotangent and slices the
    gather's (free).  No other op of these schedules all-gathers on the
    CPU (the fused ring shifts)."""
    for r in ranks[4]:
        run = r["model"][_case(degrees, ["oases", "fused"])]
        assert run["fwd"]["all_gather"] == 1
        assert run["bwd"]["all_gather"] == 1


def test_replicas_bitwise_equal_after_trainer_steps(ranks):
    """Two Trainer steps under [4/oases, 2/megatron] with 2 microbatches:
    every rank that holds the same shard of a leaf holds the same bits of
    the weight, its f32 master and its first moment (the gradient sums
    run in one rank order); every rank reports the same losses."""
    res = [r["trainer"] for r in ranks[4]]
    cfg = get_config("gpt-h1024").reduced().replace(dtype="float32")
    mesh = taxes.RankMesh(*FACTORED)
    lay = tprm.ModelLayout(cfg, taxes.mesh_info(mesh), (4, 2),
                           ("oases", "megatron"))
    assert len({tuple(r["losses"]) for r in res}) == 1
    for i, (k, spec) in enumerate(lay.specs.items()):
        blocks = {}
        for rank, r in enumerate(res):
            where = tuple(mesh.axes_index(rank, a) for a in spec.dims())
            blocks.setdefault(where, []).append(rank)
        for holders in blocks.values():
            assert len(holders) == lay.holders(k)
            first = res[holders[0]]
            for q in holders[1:]:
                np.testing.assert_array_equal(res[q]["weights"][k],
                                              first["weights"][k])
                np.testing.assert_array_equal(res[q]["master"][i],
                                              first["master"][i])
                np.testing.assert_array_equal(res[q]["m"][i],
                                              first["m"][i])


def test_mixed_plan_trainer_matches_one_rank(ranks):
    """The same two steps on one rank (stacked layout, oases): losses
    within 1e-5 relative."""
    from repro_torch.runtime import Trainer
    cfg = get_config("gpt-h1024").reduced().replace(dtype="float32")
    tr = Trainer(cfg, TrainHParams(**TRAINER_KW), global_batch=4,
                 seq_len=32, device="cpu", log_fn=None,
                 params=tprm.from_flat(cfg, _gpt_flat()))
    want = tr.train(2)["losses"]
    np.testing.assert_allclose(ranks[4][0]["trainer"]["losses"], want,
                               rtol=1e-5)


def test_batch_the_extra_dp_ranks_do_not_divide_raises(ranks):
    """A batch of 3 over the two extra data-parallel ranks of a degree-2
    group of four ranks would run uneven: refused at build time."""
    for r in ranks[4]:
        assert "does not split over the 2 extra data-parallel" in r["split"]


# ---------------------------------------------------------------------------
# the launcher and the refusals
# ---------------------------------------------------------------------------
def _main(argv):
    import contextlib
    import io
    from repro_torch.launch import train as launcher
    with contextlib.redirect_stdout(io.StringIO()):
        return launcher.main(argv)


def test_launcher_factored_plan_matches_tp1(tmp_path):
    """``--tp 4 --mesh factored --plan`` ([4/oases, 2/fused]) trains the
    reduced model as one rank does: first and last loss within 1e-5
    relative, and the plan's summary reports it."""
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"layers": [[4, "oases"], [2, "fused"]]}))
    base = ["--reduced", "--device", "cpu", "--steps", "2", "--seed", "3"]
    one = _main(base)
    four = _main(base + ["--tp", "4", "--mesh", "factored", "--plan",
                         str(path)])
    assert four["plan"] == "plan<[4/oases]*1 + [2/fused]*1>"
    for k in ("first_loss", "last_loss"):
        assert abs(four[k] - one[k]) <= 1e-5 * abs(one[k])


@pytest.mark.parametrize("plan,mesh,item", [
    (ParallelPlan(layers=(LayerStrategy(None, "oases"),) * 2,
                  mesh_shape=(2, 2), mesh_axes=("data", "model")),
     taxes.RankMesh((2, 2), ("data", "model")), "A4"),
    (ParallelPlan(layers=(LayerStrategy(2, "oases", 2),
                          LayerStrategy(2, "oases", 1))),
     taxes.RankMesh(*FACTORED), "A9"),
    (ParallelPlan(layers=(LayerStrategy(None, "oases"),) * 2, pp=2),
     taxes.RankMesh((1, 2), ("data", "model")), "A8")])
def test_plans_refused_name_the_item(plan, mesh, item):
    cfg = get_config(ARCH).reduced()
    with pytest.raises(NotImplementedError, match=item) as ei:
        steps.check_plan(cfg, plan, mesh)
    assert plan.summary() in str(ei.value)


@pytest.mark.parametrize("degrees,mesh,msg", [
    ([4, 2], taxes.RankMesh((1, 4), ("data", "model")), "factored mesh"),
    ([8, 8], taxes.RankMesh(*FACTORED), "power of two <= 4"),
    ([(2, 2), 4], taxes.RankMesh((1, 4), ("data", "model")),
     "need the factored or model_x/model_y mesh"),
    ([(1, 4), (2, 2)], taxes.RankMesh((1, 2, 2),
                                      ("data", "model_x", "model_y")),
     "mesh layout")])
def test_plans_the_mesh_cannot_hold_raise(degrees, mesh, msg):
    """JAX's own errors for degrees the mesh cannot express."""
    cfg = get_config(ARCH).reduced()
    plan = ParallelPlan(layers=tuple(LayerStrategy(d, "oases")
                                     for d in degrees))
    with pytest.raises(ValueError, match=msg):
        steps.check_plan(cfg, plan, mesh)


def test_families_still_refuse_more_than_one_rank():
    """MoE at a mesh of four ranks raises naming A10c even where its
    layers' degree is 1."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    with pytest.raises(NotImplementedError, match="A10"):
        from repro_torch.models import lm
        lm.train_layout(cfg, TrainHParams(), 4, 64, grouped=True)
