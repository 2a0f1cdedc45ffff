"""The port's 2-D layout against the JAX package on the CPU (the gate of
``tests/_scripts/equivalence_2d.py``): heads and d_ff over ``model_x``,
d_model over ``model_y``, the entry products summed over y and the
exits summed over x and gathered over y.

* uniform 2-D ``(2, 2)`` on the ``(1, 2, 2)`` ``model_x`` / ``model_y``
  mesh under ``megatron``, ``oases`` and ``fused``, on ``internlm2-1.8b``
  (GQA) and ``gpt-h2048`` reduced;
* mixed 1-D / 2-D plans on the factored mesh ``(1, 2, 2)``:
  ``[(2, 2), 4]``, ``[2, (2, 2)]`` and ``[(1, 2), (2, 2)]``;
* uniform 2-D with one KV head (internlm2-1.8b reduced, 4 q heads), whose
  KV weights stay whole over x (2 does not divide 1 KV head): each x
  rank slices the KV head its q heads need from the y-sliced input;
* each against JAX's 1-device ``build_train_loss`` on the same weights:
  loss within 1e-5 relative on every rank, gradients gathered into the
  stacked layout within ``grads_err`` 1e-4;
* the collectives of a 2-D layer, and fine recomputation: its replay
  runs none of them (the y sums' outputs are kept), coarse replays every
  forward one.
"""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import numpy as np
import pytest

from repro_torch.configs.registry import get_config
from repro_torch.core import axes as taxes
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import params as tprm

import _torch_jax_oracle as jo
import _torch_ranks

B, S = 4, 64
TIMEOUT = 240
XY = ((1, 2, 2), ("data", "model_x", "model_y"))
FACTORED = ((1, 2, 2), ("data", "t1", "t2"))
MQA = {"num_kv_heads": 1}
ARCHS = ("internlm2-1.8b", "gpt-h2048")
SCHEDULES = ("megatron", "oases", "fused")
REMAT = {"none": dict(remat=False), "fine": dict(), "coarse":
         dict(fine=False)}
MIXED = [[(2, 2), 4], [2, (2, 2)], [(1, 2), (2, 2)]]


@pytest.fixture(scope="module")
def oracles():
    out = {a: jo.oracle(a, B, S) for a in ARCHS}
    out["mqa"] = jo.oracle("internlm2-1.8b", B, S, **MQA)
    return out


def _uniform(arch):
    out = {f"{arch}/{s}": dict(schedule=s) for s in SCHEDULES}
    if arch == "internlm2-1.8b":
        for s in ("oases", "fused"):
            for r, kw in REMAT.items():
                out[f"{arch}/{s}/{r}"] = dict(schedule=s, **kw)
    return out


@pytest.fixture(scope="module")
def ranks(oracles):
    """One spawn per mesh: the 2-D mesh (both archs and the one-KV-head
    variant), the factored mesh."""
    jobs = {a: ("plan_variants", (a, oracles[a]["flat"], oracles[a]["batch"],
                                  _uniform(a))) for a in ARCHS}
    m = oracles["mqa"]
    jobs["mqa"] = ("plan_variants", ("internlm2-1.8b", m["flat"], m["batch"],
                                     {"oases": {}}, MQA))
    xy = run_ranks(_torch_ranks.everything, device="cpu", threads=1,
                   timeout=TIMEOUT, mesh=XY, args=(jobs,))
    o = oracles["internlm2-1.8b"]

    def mixed(cases):
        return {"m": ("plan_variants", (
            "internlm2-1.8b", o["flat"], o["batch"],
            {str(d): dict(degrees=d) for d in cases}))}
    fac = run_ranks(_torch_ranks.everything, device="cpu", threads=1,
                    timeout=TIMEOUT, mesh=FACTORED, args=(mixed(MIXED),))
    return {"xy": xy, "factored": fac}


def _check(runs, oracle, mesh, arch, **kw):
    cfg = get_config(arch).reduced().replace(dtype="float32", **kw)
    for r in runs:
        assert abs(r["loss"] - oracle["loss"]) <= 1e-5 * abs(oracle["loss"])
    assert len({r["loss"] for r in runs}) == 1
    degrees, scheds = runs[0]["layout"]
    lay = tprm.ModelLayout(cfg, taxes.mesh_info(taxes.RankMesh(*mesh)),
                           degrees, scheds)
    grads = lay.gather([r["grads"] for r in runs], partial=True)
    assert set(grads) == set(oracle["grads"])
    assert jo.grads_err(oracle["grads"], grads) <= 1e-4


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_uniform_2d_matches_jax(ranks, oracles, arch, schedule):
    _check([r[arch][f"{arch}/{schedule}"] for r in ranks["xy"]],
           oracles[arch], XY, arch)


@pytest.mark.parametrize("degrees", MIXED)
def test_mixed_1d_2d_matches_jax(ranks, oracles, degrees):
    _check([r["m"][str(degrees)] for r in ranks["factored"]],
           oracles["internlm2-1.8b"], FACTORED, "internlm2-1.8b")


def test_2d_whole_kv_heads_over_x_matches_jax(ranks, oracles):
    """One KV head at (2, 2): each x rank slices the KV head its q heads
    need from the KV weights held whole over x (their gradient summed
    over x by f), projecting this rank's d_model chunk, summed over y."""
    from repro_torch.models.params import attn_plan
    cfg = get_config("internlm2-1.8b").reduced().replace(**MQA)
    plan = attn_plan(cfg, 2)
    assert plan.sharded and not plan.kv_sharded and plan.kv_slice == 1
    _check([r["mqa"]["oases"] for r in ranks["xy"]], oracles["mqa"], XY,
           "internlm2-1.8b", **MQA)


def test_2d_layer_collectives(ranks):
    """Uniform (2, 2) under ``oases`` (2 sub-batches), 2 layers: each
    layer and sub-batch sums its 5 entry products over y and its 2 exits
    over x (7 all-reduces) and gathers the 2 exits' columns over y; with
    the embedding (1) and the cross entropy's max, sum and label logit
    (3).  Backward: each part sums the exit input's cotangent over y and
    the entry's over x, and all-gathers the entry slice's over y; f of
    the cross entropy (1) and its checkpointed chunk replayed (3)."""
    for r in ranks["xy"]:
        m = r["internlm2-1.8b"]["internlm2-1.8b/oases/none"]
        per = 2 * 2                       # layers x sub-batches
        assert m["fwd"]["all_reduce"] == 1 + 7 * per + 3
        assert m["fwd"]["all_gather"] == 2 * per
        assert m["bwd"]["all_reduce"] == 2 * 2 * per + 1 + 3
        assert m["bwd"]["all_gather"] == 2 * per


@pytest.mark.parametrize("schedule", ["oases", "fused"])
def test_2d_fine_remat_replays_no_collective(ranks, schedule):
    """Fine recomputation gives the loss and gradients of none (1e-6)
    with the same collectives forward and backward: the replay keeps the
    y sums' outputs and skips the exits.  Coarse replays every forward
    collective of the layers (all but the embedding's and the cross
    entropy's)."""
    for r in ranks["xy"]:
        runs = {k: r["internlm2-1.8b"][f"internlm2-1.8b/{schedule}/{k}"]
                for k in REMAT}
        none, fine, coarse = runs["none"], runs["fine"], runs["coarse"]
        for v in (fine, coarse):
            assert abs(v["loss"] - none["loss"]) <= 1e-6
            assert jo.grads_err(none["grads"], v["grads"]) <= 1e-6
        assert fine["fwd"] == none["fwd"] == coarse["fwd"]
        assert fine["bwd"] == none["bwd"]
        outside = {"all_reduce": 4}       # embedding, cross entropy
        for kind, n in none["fwd"].items():
            layer = n - outside.get(kind, 0)
            assert coarse["bwd"][kind] - none["bwd"][kind] == layer, kind


def test_2d_weights_are_sharded_both_ways():
    """The layout's specs: entry weights' rows over y and columns over x,
    exits' rows over x and output columns over y, the norm scales whole;
    each rank holds a quarter of a projection."""
    cfg = get_config("gpt-h2048").reduced()
    lay = tprm.ModelLayout(cfg, taxes.mesh_info(taxes.RankMesh(*XY)))
    spec = {k.split("'")[-2]: s for k, s in lay.specs.items()}
    assert spec["wq"].dims() == ((), ("model_y",), ("model_x",))
    assert spec["wo"].dims() == ((), ("model_x",), ("model_y",))
    assert spec["wd"].dims() == ((), ("model_x",), ("model_y",))
    assert spec["ln"].dims() == ((), ())
    assert spec["embed"].dims() == (("model_x", "model_y"), ())
    whole = {k: np.zeros(s.shape, np.float32)
             for k, s in lay.specs.items()}
    part = lay.shard_flat(whole, 3)
    for k, s in lay.specs.items():
        n = lay.mesh.axes_size(s.sharded_axes())
        assert part[k].size * n == whole[k].size
