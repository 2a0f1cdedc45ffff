"""The port's sequence parallelism and ring attention against the JAX
package on the CPU.

* The plain ring (``repro_torch.kernels.ring_attention``) at n = 2 and 4
  gloo ranks against JAX's ``ring_attention`` (``shard_map`` on an
  n-device host mesh, in a subprocess of its own:
  ``tests/_torch_jax_ring.py``) and JAX's one-device
  ``chunked_attention``: out, lse, dq, dk, dv; causal f32 and bf16, GQA
  8/2, window 24, softcap 30, padded positions (-1).
* The SP collectives and the SP pair of the fused collective-matmul
  against their reference paths (``fused_equivalence.py`` part 3's SP
  case), forward and gradients.
* ``train_loss`` on reduced internlm2-1.8b at tp = 2 and 4 against JAX's
  one-device ``build_train_loss``: the five schedules with
  ``seq_parallel``, and ``megatron``/``oases``/``fused`` with
  ``seq_shard = tp``; ranks identical; SP against the all-reduce scheme
  (``sp_equivalence.py``'s gate).
* Fine recomputation's replay under ring attention runs no ring and no
  collective; coarse replays them.
* The raising cases, and the launcher's ``--seq-shard``.

Ranks are spawned gloo processes (``repro_torch.launch.ranks``), one
spawn per tp value running every body (``tests/_torch_ranks.py``),
with a timeout; the JAX subprocess runs beside them.  The CUDA kernel is
held against the plain version on the card by ``chip_smoke.py`` (phase
11).

Tolerances: ring attention 2e-5 f32 and 2e-2 bf16 (``ring_equivalence.py``:
relative to each gradient's max; out and lse absolute); collectives 2e-5
f32 and 3e-2 bf16 (``fused_equivalence.py``); the model: loss 1e-5
relative and ``grads_err`` <= 1e-4 (as ``tests/test_torch_tmp.py``);
fine against coarse and no recomputation 1e-6 (the same arithmetic,
replayed); SP against all-reduce: loss 2e-4, ``grads_err`` 5e-3
(``sp_equivalence.py``).
"""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainHParams as JTrainHParams
from repro.configs.registry import get_config as jax_get_config
from repro.core import compat
from repro.models import lm as jlm
from repro.models import params as jprm
from repro_torch.configs.base import TrainHParams
from repro_torch.configs.registry import get_config
from repro_torch.core.comm import Comm, SoloComm
from repro_torch.core.schedule import SCHEDULES
from repro_torch.kernels import ring_attention as tra
from repro_torch.launch import train as ttrain
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import lm as tlm
from repro_torch.models import params as tprm

import _torch_ranks

ROOT = Path(__file__).resolve().parents[1]
ARCH = "internlm2-1.8b"
B, S = 4, 64
TIMEOUT = 240
RINGS = (2, 4)
# ring attention cases (ring_equivalence.py's kernel tier, hd 16, s 64)
RING_CASES = {
    "causal-f32": dict(h=4, kvh=4, dtype="float32"),
    "causal-bf16": dict(h=4, kvh=4, dtype="bfloat16"),
    "gqa-f32": dict(h=8, kvh=2, dtype="float32"),
    "window-f32": dict(h=4, kvh=4, dtype="float32", window=24),
    "softcap-gqa-f32": dict(h=8, kvh=2, dtype="float32", softcap=30.0),
    "pad-f32": dict(h=4, kvh=4, dtype="float32", pad=5),
}
CM_CASES = [("float32", 2, 32, 64, 48), ("bfloat16", 2, 32, 64, 48),
            ("float32", 3, 16, 104, 72)]
# (schedule, remat, fine_remat, seq_parallel, seq_shard as a multiple of
# tp: 0 = off, 1 = ring over the group)
SP_VARIANTS = [(s, True, True, True, 0) for s in SCHEDULES]
RING_VARIANTS = [(s, True, True, True, 1)
                 for s in ("megatron", "oases", "fused")]
EXTRA_VARIANTS = [("oases", True, False, True, 1),     # ring, coarse
                  ("oases", False, True, True, 1),     # ring, no remat
                  ("oases", True, True, False, 0)]     # all-reduce scheme


def _variants(tp):
    return [(s, r, f, sp, tp if k else 1)
            for s, r, f, sp, k in SP_VARIANTS + RING_VARIANTS
            + EXTRA_VARIANTS]


def _mesh():
    return compat.make_mesh((1, 1), ("data", "model"),
                            axis_types=compat.auto_axis_types(2))


def grads_err(g1: dict, g2: dict) -> float:
    """``tests/_scripts/runner.py:174``."""
    return max(float(np.max(np.abs(g1[k] - g2[k])))
               / (float(np.max(np.abs(g1[k]))) + 1e-8) for k in g1)


def _jax_flat(tree):
    return {jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ring_inputs():
    """Every case's q, k, v, do and positions, from one numpy seed."""
    rng = np.random.default_rng(0)
    cases, arrays = {}, {}
    for name, c in RING_CASES.items():
        b, s, hd = 2, 64, 16
        q, do = (rng.standard_normal((b, s, c["h"], hd)).astype(np.float32)
                 for _ in range(2))
        k, v = (rng.standard_normal((b, s, c["kvh"], hd)).astype(np.float32)
                for _ in range(2))
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
        if c.get("pad"):
            # the last rows are padding: kv position -1, no cotangent
            pos[:, s - c["pad"]:] = -1
            do[:, s - c["pad"]:] = 0.0
        cases[name] = dict(dtype=c["dtype"], window=c.get("window"),
                           softcap=c.get("softcap", 0.0))
        arrays.update({f"{name}/{k_}": a for k_, a in
                       (("q", q), ("k", k), ("v", v), ("do", do),
                        ("pos", pos))})
    return cases, arrays


@pytest.fixture(scope="module")
def oracle():
    """JAX's 1-device loss and grads (reduced f32 internlm2-1.8b, default
    hyper-parameters, JAX's init) and the inputs."""
    jcfg = jax_get_config(ARCH).reduced().replace(dtype="float32")
    loss_fn, specs, _ = jlm.build_train_loss(
        jcfg, _mesh(), JTrainHParams(), global_batch=B, seq_len=S)
    p = jprm.init_params(specs, jax.random.PRNGKey(0))
    rng = np.random.default_rng(42)
    batch = {k: rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with compat.set_mesh(_mesh()):
        loss = float(jax.jit(loss_fn)(p, jb)[0])
        grads = _jax_flat(jax.jit(jax.grad(
            lambda p, b: loss_fn(p, b)[0]))(p, jb))
    return dict(flat=jprm.tree_to_flat(p), batch=batch, loss=loss,
                grads=grads)


@pytest.fixture(scope="module")
def runs(oracle, tmp_path_factory):
    """The JAX ring subprocess, started first, and one rank spawn per tp
    beside it."""
    cases, arrays = _ring_inputs()
    tmp = tmp_path_factory.mktemp("ring")
    src, dst = tmp / "inputs.npz", tmp / "outputs.npz"
    np.savez(src, cases=json.dumps(cases), **arrays)
    jax_proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_jax_ring.py"),
         str(src), str(dst)],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks = {}
        for tp in RINGS:
            jobs = {"ring": ("ring_cases", (cases, arrays)),
                    "barrier": ("barrier_wait", (0.5,)),
                    "cm": ("sp_collective_cases", (CM_CASES,)),
                    "model": ("sp_model_variants",
                              (ARCH, oracle["flat"], oracle["batch"],
                               _variants(tp)))}
            ranks[tp] = run_ranks(_torch_ranks.everything, tp,
                                  device="cpu", args=(jobs,),
                                  timeout=TIMEOUT, threads=1)
        log, _ = jax_proc.communicate(timeout=TIMEOUT)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, log
    return dict(ranks=ranks, cases=cases, arrays=arrays,
                jax=dict(np.load(dst)))


def _cat(per_rank, key, axis):
    return np.concatenate([r[key] for r in per_rank], axis=axis)


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_attention_matches_jax(runs, case, n):
    """The plain ring at n ranks against JAX's ring (out, lse, dq, dk, dv)
    and JAX's one-device ``chunked_attention`` (out, dq, dk, dv).  Padding
    rows carry unspecified values in every implementation and are left
    out of out and lse."""
    per_rank = [r["ring"][case] for r in runs["ranks"][n]]
    got = {"out": _cat(per_rank, "out", 1), "lse": _cat(per_rank, "lse", 2)}
    for g in ("dq", "dk", "dv"):
        got[g] = _cat(per_rank, g, 1)
    live = runs["arrays"][f"{case}/pos"] >= 0                  # [b, s]
    tol = 2e-2 if runs["cases"][case]["dtype"] == "bfloat16" else 2e-5
    jx = runs["jax"]
    for ref in (f"ring{n}", "one"):
        want = {k: jx[f"{case}/{ref}/{k}"] for k in ("out", "dq", "dk", "dv")}
        if ref != "one":
            want["lse"] = jx[f"{case}/{ref}/lse"]
        errs = {"out": float(np.abs(np.where(live[:, :, None, None],
                                             got["out"] - want["out"],
                                             0)).max())}
        if "lse" in want:
            errs["lse"] = float(np.abs(np.where(live[:, None, :],
                                                got["lse"] - want["lse"],
                                                0)).max())
        for g in ("dq", "dk", "dv"):
            errs[g] = float(np.abs(got[g] - want[g]).max()
                            / (np.abs(want[g]).max() + 1e-6))
        assert all(e < tol for e in errs.values()), (ref, errs)


@pytest.mark.parametrize("n", RINGS)
def test_sp_collectives_match_references(runs, n):
    """sp_all_gather, sp_reduce_scatter and batch_split against every
    rank's inputs computed locally, and fused_matmul_reducescatter and
    fused_allgather_matmul against the SP collectives with plain products:
    forward and gradients."""
    for r in runs["ranks"][n]:
        for (dname, *_), errs in r["cm"].items():
            tol = 3e-2 if dname == "bfloat16" else 2e-5
            assert max(errs.values()) <= tol, (dname, errs)


def _gathered(res, variant, tp):
    cfg = get_config(ARCH).reduced().replace(dtype="float32")
    _, _, _, sp, shard = variant
    return tprm.gather_grads(
        cfg, [r["model"][variant]["grads"] for r in res], seq_shard=shard,
        partial=tprm.partial_grad_leaves(cfg, seq_parallel=sp,
                                         seq_shard=shard))


@pytest.mark.parametrize("tp", RINGS)
@pytest.mark.parametrize("variant", SP_VARIANTS + RING_VARIANTS,
                         ids=lambda v: f"{v[0]}-{'ring' if v[4] else 'sp'}")
def test_sp_and_ring_training_match_jax(runs, oracle, tp, variant):
    """Every schedule under SP and three under ring attention, fine
    remat: loss 1e-5 relative on every rank, identical on every rank, and
    the gathered gradients within ``grads_err`` 1e-4 of JAX's 1-device
    run."""
    v = variant[:4] + (tp if variant[4] else 1,)
    res = runs["ranks"][tp]
    losses = {r["model"][v]["loss"] for r in res}
    assert len(losses) == 1, losses
    assert abs(losses.pop() - oracle["loss"]) <= 1e-5 * abs(oracle["loss"])
    grads = _gathered(res, v, tp)
    assert set(grads) == set(oracle["grads"])
    assert grads_err(oracle["grads"], grads) <= 1e-4


@pytest.mark.parametrize("tp", RINGS)
def test_sp_matches_the_all_reduce_scheme(runs, tp):
    """``sp_equivalence.py``: ``oases`` with and without SP, loss within
    2e-4 and ``grads_err`` < 5e-3."""
    res = runs["ranks"][tp]
    sp, ar = ("oases", True, True, True, 1), ("oases", True, True, False, 1)
    g_sp, g_ar = _gathered(res, sp, tp), _gathered(res, ar, tp)
    assert abs(res[0]["model"][sp]["loss"] - res[0]["model"][ar]["loss"]) \
        < 2e-4
    assert grads_err(g_ar, g_sp) < 5e-3


@pytest.mark.parametrize("tp", RINGS)
def test_fine_replay_runs_no_ring(runs, tp):
    """Ring attention under ``oases`` (2 sub-batches): the forward runs
    the ring once per layer and sub-batch; fine recomputation's backward
    runs it no more and adds, beyond the backward without recomputation,
    only the MLP part's entry all-gathers (one a layer and sub-batch, as
    JAX's policy replays them): no ring shift and no other collective.
    Coarse replays the ring (its n - 1 hops, K and V in one shift) and the
    MLP part's gather and scatter.  All three give the same loss and
    gradients (1e-6)."""
    cfg = get_config(ARCH).reduced()
    calls = cfg.num_layers * 2
    fine, coarse, off = (("oases", True, True, True, tp),
                         ("oases", True, False, True, tp),
                         ("oases", False, True, True, tp))
    for r in runs["ranks"][tp]:
        m = r["model"]
        for v in (fine, coarse, off):
            assert m[v]["ring_calls"][0] == calls
        assert m[fine]["ring_calls"][1] == m[off]["ring_calls"][1] == 0
        assert m[coarse]["ring_calls"][1] == calls
        assert m[fine]["fwd"] == m[off]["fwd"] == m[coarse]["fwd"]
        assert m[fine]["bwd"] == dict(m[off]["bwd"], all_gather=m[off][
            "bwd"]["all_gather"] + calls)
        extra = {k: m[coarse]["bwd"][k] - m[off]["bwd"][k]
                 for k in m[off]["bwd"]}
        assert extra == {"all_reduce": 0, "reduce_scatter": calls,
                         "all_gather": calls, "ring_shift": calls * (tp - 1)}
        for v in (fine, coarse):
            assert abs(m[v]["loss"] - m[off]["loss"]) <= 1e-6
            assert grads_err(m[off]["grads"], m[v]["grads"]) <= 1e-6


@pytest.mark.parametrize("n", RINGS)
def test_barrier_waits_for_the_last_rank(runs, n):
    """``Comm.barrier`` (the host barrier a rank busy on the host makes the
    others wait at): the first ranks wait for the one that arrives half a
    second late."""
    waits = [r["barrier"] for r in runs["ranks"][n]]
    assert all(w >= 0.4 for w in waits[:-1]), waits


class _Group(Comm):
    """A model group of ``size`` ranks that runs no collective (the
    layout checks raise before any)."""

    def __init__(self, size):
        super().__init__()
        self.size = size


def test_ring_layouts_that_cannot_run_raise():
    """JAX's ring blockers, with its messages: seq_shard other than the
    group size, a sequence seq_shard does not divide, a group of one; and
    TrainHParams rejects a seq_shard that is not a positive power of
    two."""
    cfg = get_config(ARCH).reduced()
    for tp, shard, seq, what in ((2, 4, 64, "!= model group size 2"),
                                 (4, 2, 64, "!= model group size 4"),
                                 (2, 2, 63, "not divisible by seq_shard"),
                                 (1, 2, 64, "no model axes")):
        hp = TrainHParams(seq_shard=shard)
        with pytest.raises(ValueError, match="seq_shard \\(ring attention\\) "
                                             "cannot run here") as e:
            tlm.train_ctx(cfg, hp, _Group(tp), seq)
        assert what in str(e.value)
    for bad in (0, 3, -2, True, 2.0):
        with pytest.raises(ValueError, match="bad seq_shard"):
            TrainHParams(seq_shard=bad)


def test_seq_parallel_without_a_group_degrades_with_a_warning():
    """``seq_parallel`` at tp=1 (and on a sequence the group does not
    divide) runs without SP and says why, as JAX's ``_sp_degraded``; the
    loss is the one without SP."""
    cfg = get_config(ARCH).reduced().replace(dtype="float32")
    params = tprm.init_params(cfg, seed=0)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    with pytest.warns(RuntimeWarning, match="seq_parallel degraded"):
        ctx = tlm.train_ctx(cfg, TrainHParams(seq_parallel=True),
                            SoloComm(), 16)
    assert not ctx.sp
    with pytest.warns(RuntimeWarning, match="not divisible by the model "
                                            "group size 2"):
        assert not tlm.train_ctx(cfg, TrainHParams(seq_parallel=True),
                                 _Group(2), 15).sp
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with_sp = tlm.train_loss(cfg, params, batch,
                                 TrainHParams(seq_parallel=True))[0]
    assert with_sp.item() == tlm.train_loss(cfg, params, batch,
                                            TrainHParams())[0].item()


def test_kernel_position_check():
    """The CUDA wrapper takes only the contiguous shards the kernel
    assumes; its check raises for anything else (padding, another
    rank's positions, another length)."""
    sq = 16
    ok = 3 * sq + torch.arange(sq)
    tra.check_kernel_positions(None, None, 3, sq, sq)
    tra.check_kernel_positions(ok[None].expand(2, sq), ok, 3, sq, sq)
    pad = ok.clone()
    pad[-2:] = -1
    for q_pos, kv_pos in ((pad, None), (None, ok - sq),
                          (ok[:-1], None), (None, torch.arange(sq))):
        with pytest.raises(NotImplementedError, match="contiguous shard"):
            tra.check_kernel_positions(q_pos, kv_pos, 3, sq, sq)


def test_train_launcher_seq_shard_matches_tp1(capsys):
    """``--tp 2 --seq-shard 2`` (ring attention, implied SP) gives the
    first loss of the tp=1 run (1e-5 relative)."""
    def first_loss(*extra):
        ttrain.main(["--reduced", "--device", "cpu", "--steps", "2",
                     "--batch", "2", "--seq", "32", *extra])
        text = capsys.readouterr().out
        return json.loads(text[text.index("{"):])["first_loss"]
    one = first_loss()
    two = first_loss("--tp", "2", "--seq-shard", "2")
    assert abs(one - two) <= 1e-5 * abs(one)
