"""The port's 1-D tensor model parallelism against the JAX package on the
CPU: every schedule at tp=2 (KV heads sharded) and tp=4 (KV heads
replicated and sliced) against JAX's 1-device ``build_train_loss``
(which ``tests/_scripts/equivalence.py`` pins JAX's own tp=2/4 results
to), the recomputation policies and the collectives they replay, the
fused collective-matmul rings against their reference paths, the tile
matmul's plain version against the Pallas kernel in interpret mode, the
autotuner off the card, the tp=2 Trainer and the launcher.

Ranks are spawned gloo processes (``repro_torch.launch.ranks``), one
spawn per tp value running every variant (``tests/_torch_ranks.py``),
each with a timeout, so a hung rank fails instead of hanging the suite.
The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py`` (phase 8).

Tolerances: loss 1e-5 relative and ``grads_err`` <= 1e-4 (f32 sums in
another order, as ``tests/test_torch_training.py``); schedules' loss
spread < 1e-5 (``equivalence.py``); remat variants 1e-6 (the same
arithmetic, replayed); rings against references 2e-5 f32 and 3e-2 bf16
(``fused_equivalence.py``); tile matmul 1e-5 f32 and one bf16 ulp (its
f32 sums in another order, cast once); Trainer losses 1e-4 relative.
"""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import gc
import json
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainHParams as JTrainHParams
from repro.configs.registry import get_config as jax_get_config
from repro.core import compat
from repro.kernels import collective_matmul as jcm
from repro.models import lm as jlm
from repro.models import params as jprm
from repro.runtime import Trainer as JTrainer
from repro_torch.configs.base import TrainHParams
from repro_torch.configs.registry import get_config
from repro_torch.core.comm import SoloComm
from repro_torch.core.schedule import SCHEDULES, TmpCtx
from repro_torch.kernels import autotune
from repro_torch.kernels import collective_matmul as tcm
from repro_torch.kernels.ref import tile_matmul_ref
from repro_torch.launch import train as ttrain
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import lm as tlm
from repro_torch.models import params as tprm

import _torch_ranks

ARCH = "internlm2-1.8b"
B, S = 4, 64
TIMEOUT = 240
VARIANTS = ([(s, True, True) for s in SCHEDULES]
            + [("oases", False, True), ("oases", True, False),
               ("wang", False, True), ("fused", False, True),
               ("fused", True, False)])
CM_CASES = [("float32", 2, 32, 64, 48), ("bfloat16", 2, 32, 64, 48),
            ("float32", 3, 16, 104, 72),        # uneven K_local
            ("float32", 2, 30, 64, 48),         # 30 rows: n=4 indivisible
            ("float32", 2, 31, 64, 48)]         # n=2 indivisible
TRAINER_KW = dict(learning_rate=1e-3, warmup_steps=1, microbatch=2)


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
def trainer_oracle(tmp_path_factory):
    """JAX's Trainer on a 1x1 mesh: 3 steps of reduced gpt-h1024 with 2
    microbatches, and its initial weights."""
    jcfg = jax_get_config("gpt-h1024").reduced().replace(dtype="float32")
    jtr = JTrainer(jcfg, _mesh(), JTrainHParams(**TRAINER_KW),
                   global_batch=4, seq_len=32,
                   ckpt_dir=str(tmp_path_factory.mktemp("ckpt")),
                   log_fn=lambda msg: None)
    p0, _, _ = jtr.init_state(seed=0)
    flat = jprm.tree_to_flat(p0)
    return dict(flat=flat, losses=jtr.train(3, seed=0)["losses"])


@pytest.fixture(scope="module")
def ranks(oracle, trainer_oracle):
    """One spawn per tp value; every variant runs inside it."""
    out = {}
    for tp in (2, 4):
        jobs = {"model": ("model_variants",
                          (ARCH, oracle["flat"], oracle["batch"], VARIANTS)),
                "cm": ("collective_cases", (CM_CASES,))}
        if tp == 2:
            jobs["trainer"] = ("trainer_losses",
                               ("gpt-h1024", trainer_oracle["flat"],
                                TRAINER_KW, 3))
        out[tp] = run_ranks(_torch_ranks.everything, tp, device="cpu",
                            args=(jobs,), timeout=TIMEOUT, threads=1)
    return out


def _gathered(res, variant):
    cfg = get_config(ARCH).reduced().replace(dtype="float32")
    return tprm.gather_grads(cfg, [r["model"][variant]["grads"]
                                   for r in res])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_tmp_schedule_matches_jax(ranks, oracle, tp, schedule):
    """Every schedule, fine remat: loss 1e-5 relative on every rank and the
    gathered gradients within ``grads_err`` 1e-4 of JAX's 1-device run."""
    res = ranks[tp]
    v = (schedule, True, True)
    for r in res:
        assert abs(r["model"][v]["loss"] - oracle["loss"]) \
            <= 1e-5 * abs(oracle["loss"])
    grads = _gathered(res, v)
    assert set(grads) == set(oracle["grads"])
    assert grads_err(oracle["grads"], grads) <= 1e-4


@pytest.mark.parametrize("tp", [2, 4])
def test_schedules_agree_and_ranks_are_identical(ranks, tp):
    """Schedules' loss spread < 1e-5; every rank reports the same loss,
    bit for bit (the all-reduces sum in one rank order)."""
    res = ranks[tp]
    losses = [res[0]["model"][(s, True, True)]["loss"] for s in SCHEDULES]
    assert max(losses) - min(losses) < 1e-5
    for v in VARIANTS:
        assert len({r["model"][v]["loss"] for r in res}) == 1, v


@pytest.mark.parametrize("tp", [2, 4])
def test_remat_policies_and_replayed_collectives(ranks, tp):
    """Off, coarse and fine give the same loss and grads (1e-6).  The
    backward of fine replays no forward collective (its all-reduce count
    equals the one without recomputation: the f all-reduces and the
    cross entropy's checkpointed chunks), and coarse replays the 2
    all-reduces of each layer for each of the 2 sub-batches."""
    res = ranks[tp]
    cfg = get_config(ARCH).reduced()
    off, coarse, fine = (("oases", False, True), ("oases", True, False),
                         ("oases", True, True))
    for r in res:
        m = r["model"]
        for v in (coarse, fine):
            assert abs(m[v]["loss"] - m[off]["loss"]) <= 1e-6
            assert grads_err(m[off]["grads"], m[v]["grads"]) <= 1e-6
        layer_ar = 2 * cfg.num_layers * 2
        # forward: the embedding, 2 exits a layer and sub-batch, the
        # cross entropy's max, sum and label logit
        assert m[fine]["fwd"]["all_reduce"] == 1 + layer_ar + 3
        assert m[off]["fwd"] == m[fine]["fwd"] == m[coarse]["fwd"]
        assert m[fine]["bwd"] == m[off]["bwd"]
        assert (m[coarse]["bwd"]["all_reduce"]
                - m[off]["bwd"]["all_reduce"]) == layer_ar


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("schedule", ["wang", "fused"])
def test_fine_remat_replays_no_exit(ranks, tp, schedule):
    """The replay of fine recomputation skips the exit product and its
    collective for the other exit styles too: ``wang``'s chunked
    all-reduces and ``fused``'s ring.  Fine gives the loss and grads of no
    recomputation (1e-6) with the same collectives forward and backward;
    under ``fused``, coarse replays each exit's ring, 2 (tp - 1)
    ring shifts (reduce-scatter and all-gather) for each of a layer's 2
    exits."""
    res = ranks[tp]
    cfg = get_config(ARCH).reduced()
    off, fine = (schedule, False, True), (schedule, True, True)
    for r in res:
        m = r["model"]
        assert abs(m[fine]["loss"] - m[off]["loss"]) <= 1e-6
        assert grads_err(m[off]["grads"], m[fine]["grads"]) <= 1e-6
        assert m[fine]["fwd"] == m[off]["fwd"]
        assert m[fine]["bwd"] == m[off]["bwd"]
        if schedule == "fused":
            coarse = m[("fused", True, False)]
            assert m[off]["fwd"]["ring_shift"] \
                == cfg.num_layers * 2 * 2 * (tp - 1)
            assert coarse["bwd"]["ring_shift"] - m[off]["bwd"]["ring_shift"] \
                == cfg.num_layers * 2 * 2 * (tp - 1)


@pytest.mark.parametrize("schedule", ["megatron", "oases"])
def test_fine_remat_keeps_no_exit_tensor(schedule):
    """What fine recomputation keeps: after the forward, neither an exit
    product's input (JAX recomputes it) nor a collective's output (the
    residual add consumed it) is alive, while without recomputation the
    exit inputs are kept for the backward; both give the same loss and
    gradients (1e-6).  tp=1, so the exit's all-reduce is the identity
    (``oases`` still goes through its asynchronous handle)."""
    cfg = get_config(ARCH).reduced().replace(dtype="float32")
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    base = tprm.init_params(cfg, seed=0, device=torch.device("cpu"))
    refs = []

    class Spy(TmpCtx):
        def row_matmul(self, x, w, seq_dim=1, *, replay=False):
            pend = super().row_matmul(x, w, seq_dim, replay=replay)
            if not replay:
                refs.append((weakref.ref(x), weakref.ref(pend.result)))
            return pend

    out = {}
    for remat in (False, True):
        refs.clear()
        params = tprm.unflatten({k: t.clone().requires_grad_()
                                 for k, t in tprm.flatten(base).items()})
        loss, _ = tlm.train_loss(
            cfg, params, batch,
            TrainHParams(schedule=schedule, remat=remat, fine_remat=True),
            Spy(SoloComm(), schedule=schedule))
        gc.collect()
        n_exits = 2 * cfg.num_layers * (2 if schedule == "oases" else 1)
        assert len(refs) == n_exits
        inputs_alive = sum(a() is not None for a, _ in refs)
        assert inputs_alive == (0 if remat else n_exits)
        assert all(y() is None for _, y in refs)
        loss.backward()
        out[remat] = (loss.item(), {k: t.grad.numpy().copy() for k, t
                                    in tprm.flatten(params).items()})
    assert abs(out[True][0] - out[False][0]) <= 1e-6
    assert grads_err(out[False][1], out[True][1]) <= 1e-6


@pytest.mark.parametrize("tp", [2, 4])
def test_collective_matmul_rings_match_references(ranks, tp):
    """fused_equivalence.py parts 1-2 over gloo: the ring reduce-scatter,
    all-gather and all-reduce against their reference paths in f32 and
    bf16, the kernel wrapper's CPU path against the all-ranks plain
    version, an indivisible chunk dim (all-reduce takes the reference,
    reduce-scatter raises), and fused gradients equal megatron's."""
    for r in ranks[tp]:
        for (dname, b, s, k, d), e in r["cm"].items():
            tol = 3e-2 if dname == "bfloat16" else 2e-5
            assert e["ar"] <= tol and e["grad"] <= tol, (dname, s, e)
            if s % tp == 0:
                assert e["ar_backend"] == "ring"
                assert max(e["rs"], e["rs_plain"], e["ag"]) <= tol, e
            else:
                assert e["ar_backend"] == "ref"
                assert "not divisible" in e["rs_raises"]


def test_tp2_trainer_matches_jax_trainer(ranks, trainer_oracle):
    """3 steps at tp=2 with 2 microbatches from JAX's initial weights:
    losses within 1e-4 of JAX's Trainer on a 1x1 mesh (the gradient norm
    that clips spans both ranks)."""
    for r in ranks[2]:
        t = r["trainer"]
        assert t["final_step"] == 3 and t["grads_ok"]
        np.testing.assert_allclose(t["losses"], trainer_oracle["losses"],
                                   rtol=1e-4)


def test_run_ranks_raises_when_a_rank_fails():
    """A rank that raises ends the group and surfaces in the caller, even
    while another rank waits in a collective."""
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_ranks(_torch_ranks.fail_on_rank_one, 2, device="cpu",
                  timeout=TIMEOUT, threads=1)


def test_train_launcher_tp2_matches_tp1(capsys):
    def first_loss(tp):
        ttrain.main(["--reduced", "--device", "cpu", "--steps", "2",
                     "--batch", "2", "--seq", "32", "--tp", str(tp),
                     "--schedule", "oases"])
        text = capsys.readouterr().out
        return json.loads(text[text.index("{"):])["first_loss"]
    one, two = first_loss(1), first_loss(2)
    assert abs(one - two) <= 1e-5 * abs(one)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (128, 256, 128, 64, 64, 128),
    (100, 200, 72, 32, 32, 64),          # uneven tiles, padded
    (33, 48, 17, 16, 16, 16),            # heavily uneven
])
def test_tile_matmul_plain_matches_pallas(dtype, m, k, n, bm, bn, bk):
    """``tile_matmul_ref`` (and the wrapper on CPU tensors) against
    ``pallas_tile_matmul`` in interpret mode at the shapes of
    ``tests/test_collective_matmul.py``."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, n))).astype(np.float32)
    want = np.asarray(jcm.pallas_tile_matmul(
        jnp.asarray(x, dtype), jnp.asarray(w, dtype), block_m=bm,
        block_n=bn, block_k=bk, interpret=True).astype(jnp.float32))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    for got in (tile_matmul_ref(tx, tw), tcm.tile_matmul(tx, tw)):
        assert got.dtype == tdt and got.shape == (m, n)
        if tdt == torch.float32:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                       rtol=1e-5)
        else:
            np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6,
                                       rtol=2 ** -7)


def test_autotune_off_card_returns_clipped_default(tmp_path, monkeypatch):
    cache = tmp_path / "tiles.json"
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(cache))
    assert autotune.tuned_blocks(2048, 1024, 2048, torch.bfloat16) \
        == autotune.TC_DEFAULT_BLOCKS
    assert autotune.tuned_blocks(33, 48, 17, torch.float32) == (64, 64, 32)
    entries = json.loads(cache.read_text())
    v = autotune.TILE_VERSION
    assert entries == {f"cpu|{v}|wgmma|m2048k1024n2048|bfloat16":
                       [128, 128, 64],
                       f"cpu|{v}|cuda_core|m33k48n17|float32": [64, 64, 32]}
    # every candidate is a compiled block size within shared memory
    for c in autotune.candidates(2048, 1024, 2048, itemsize=4):
        assert c[0] in autotune.CAND_M and c[1] in autotune.CAND_N
        assert c[2] in autotune.CAND_K
        assert autotune.smem_bytes(*c, itemsize=4) \
            <= autotune.SMEM_BUDGET_BYTES


def test_train_hparams_reject_unknown_schedule():
    with pytest.raises(ValueError, match="unknown schedule"):
        TrainHParams(schedule="gpipe")
    hp = TrainHParams()
    assert (hp.schedule, hp.remat, hp.fine_remat, hp.split) == \
        ("oases", True, True, 2)
