"""The port's dry run (``repro_torch.launch.dryrun``) against JAX's
``repro.launch.dryrun`` and ``repro.launch.hlo_cost`` on the CPU.

* Products: the four families at tp=1 (``megatron`` without remat, and
  gpt under ``oases`` with fine remat), reduced f32, 4 x 64.  The port's
  products as its plain path executes them are held to JAX's
  ``dot_flops`` of the same cell: every product that differs is named with
  its count on each side, and the remainder is pinned to zero.
* Collectives: reduced gpt at tp=2 under ``megatron``, ``oases`` and
  ``fused``, and at (2, 2) ``fused`` on the 2-D mesh, against JAX's
  ``analyze(..., default_group=tp)``: the collectives of 16 KiB and more
  by (kind, payload, group), with the differences by design itemised;
  the small all-reduces (cross-entropy row statistics and norms, which
  XLA's combiner merges into its bulk ones) pinned on both sides.
* The record's keys against JAX's ``run_cell`` literals (read with
  ``ast``, as ``tests/test_mesh_parse.py`` reads JAX's dry run), the CLI
  and its refusals in one subprocess, and the microbatch extrapolation
  against a whole trace.

JAX's cells compile in two subprocesses side by side
(``tests/_torch_jax_cost.py``, 4 host devices).  Counts are exact."""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs.base import ShapeConfig, TrainHParams
from repro_torch.configs.registry import get_config
from repro_torch.core.axes import RankMesh
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 64
MESH_1 = ((1, 1), ("data", "model"))
MESH_TP2 = ((1, 2), ("data", "model"))
MESH_2D = ((1, 2, 2), ("data", "model_x", "model_y"))
NO_REMAT = dict(remat=False)

# key -> (arch, hp, mesh)
PRODUCT_CELLS = {
    "gpt-h2048": ("gpt-h2048", dict(schedule="megatron", **NO_REMAT),
                  MESH_1),
    "gpt-h2048-oases-fine": ("gpt-h2048", dict(schedule="oases", remat=True,
                                               fine_remat=True), MESH_1),
    "mamba2-130m": ("mamba2-130m", dict(schedule="megatron", **NO_REMAT),
                    MESH_1),
    "granite-moe-3b-a800m": ("granite-moe-3b-a800m",
                             dict(schedule="megatron", **NO_REMAT), MESH_1),
    "recurrentgemma-9b": ("recurrentgemma-9b",
                          dict(schedule="megatron", **NO_REMAT), MESH_1),
}
COLLECTIVE_CELLS = {
    "megatron": ("gpt-h2048", dict(schedule="megatron", **NO_REMAT),
                 MESH_TP2),
    "oases": ("gpt-h2048", dict(schedule="oases", **NO_REMAT), MESH_TP2),
    "fused": ("gpt-h2048", dict(schedule="fused", **NO_REMAT), MESH_TP2),
    "2d_fused": ("gpt-h2048", dict(schedule="fused", tmp_layout="2d",
                                   **NO_REMAT), MESH_2D),
}


def _cfg(arch):
    return get_config(arch).reduced().replace(dtype="float32")


@pytest.fixture(scope="module")
def jax_cells():
    cells = [dict(key=k, arch=a, hp=hp, mesh=list(m[0]), axes=list(m[1]),
                  batch=B, seq=S)
             for k, (a, hp, m) in {**PRODUCT_CELLS,
                                   **COLLECTIVE_CELLS}.items()]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    # two processes side by side: the one-rank cells and the meshes
    procs = [subprocess.Popen([sys.executable,
                               str(ROOT / "tests" / "_torch_jax_cost.py"),
                               json.dumps(part)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for part in (cells[:len(PRODUCT_CELLS)],
                          cells[len(PRODUCT_CELLS):])]
    res = {}
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        res.update(json.loads(out.strip().splitlines()[-1]))
    return res


def _trace(arch, hp, mesh, plain):
    return dryrun.trace_step(_cfg(arch), TrainHParams(**hp), global_batch=B,
                             seq_len=S, mesh=RankMesh(*mesh),
                             plain=plain)[0]


# the products that differ, per cell: (name, count, flops each); every
# count is port minus JAX
def _named_products(key, cfg):
    t, d, v = B * S, cfg.d_model, cfg.padded_vocab()
    head = 2 * t * d * v
    attn = 2 * B * cfg.num_heads * S * S * cfg.resolved_head_dim
    n_attn = sum(1 for i in range(cfg.num_layers)
                 if cfg.layer_pattern[i % len(cfg.layer_pattern)]
                 in ("global", "local"))
    # the cross entropy's checkpointed chunk replays the head's product
    # in the backward (torch.utils.checkpoint, on the card too); JAX's
    # compiled step reuses the forward's logits where the head is its own
    # leaf and replays it, as the port does, where it is the tied
    # embedding
    replay = [("xent chunk replay of the head product", 1, head)] \
        if not cfg.tie_embeddings else []
    # the plain flash backward recomputes the scores (one product a layer;
    # the card's backward kernel does too: the bound counts the 4 products
    # of the work, kernels/bounds.py flash_work)
    score = [("flash backward's recomputed scores", n_attn, attn)]
    if key == "mamba2-130m":
        q = min(128, S)
        # the plain SSD's products over the chunk's causal pairs (1 in
        # the forward, 2 in the backward); JAX's three-operand einsums
        # lower to no dot in its CPU HLO; on the card they are the SSD
        # kernels' tensor-core tiles
        return [("plain SSD products over the chunk's pairs",
                 3 * cfg.num_layers, 2 * B * (S // q) * q * q * q)]
    if key == "gpt-h2048-oases-fine":
        # JAX's fine recomputation replays attention's two forward
        # products; the port keeps the flash output (core/remat.Keep)
        return replay + score + [("JAX's fine-remat replay of attention",
                                  -2 * n_attn, attn)]
    return replay + score


@pytest.mark.parametrize("key", list(PRODUCT_CELLS))
def test_products_match_jax(jax_cells, key):
    arch, hp, mesh = PRODUCT_CELLS[key]
    cfg = _cfg(arch)
    hc = _trace(arch, hp, mesh, plain=True)
    jax_dot = jax_cells[key]["dot_flops"]
    named = _named_products(key, cfg)
    assert hc.plain_dot_flops - jax_dot - sum(n * f for _, n, f in named) \
        == 0, (hc.plain_dot_flops, jax_dot, named)
    # the roofline count charges kernels their bounds work, outside the
    # plain versions, and FlopCounterMode sees the same products
    assert hc.torch_flops == hc.plain_dot_flops
    fast = _trace(arch, hp, mesh, plain=False)
    assert fast.dot_flops == hc.dot_flops


def _split(ops):
    """(size class, kind, payload, group) -> count, groups of one (no
    link bytes) dropped; an op of 16 KiB or more whose payload has a
    remainder below 16 KiB is JAX's combiner merging a small all-reduce
    into a bulk one, and is split into the two."""
    out = {}
    for (kind, payload, n), c in ops.items():
        if n == 1:
            continue
        for part, cls in ((payload - payload % 16384, "bulk"),
                          (payload % 16384, "small")):
            if part:
                k = (cls, kind, part, n)
                out[k] = out.get(k, 0) + c
    return out


def _jax_ops(cell):
    return {(k.split()[0], int(k.split()[1]), int(k.split()[2])): v
            for k, v in cell["collectives"].items()}


KIB = 1024
# the small all-reduces (payload, count) on each side, identical for the
# three 1-D cells: JAX's three [256] f32 row statistics of the cross
# entropy (max, sum of exponentials, label logit; 1 KiB each) forward and
# twice in the backward, plus 32 and 1,540 bytes of norm pieces merged
# into other ops; the port's three statistics forward and replayed by the
# checkpointed chunk, and the one f32 gradient norm
SMALL_1D = ({1024: 1, 1056: 1, 1540: 1, 2048: 3}, {1024: 6, 4: 1})

# bulk collectives that differ by design: (kind, payload, group) -> count,
# JAX's side then the port's, with what each is
BULK_DIFF = {
    "megatron": [],
    "oases": [
        # the entry's backward all-reduces (f's transpose): whole-batch in
        # JAX's HLO (XLA merges the two sub-batches'), per sub-batch in
        # the port
        ("entry backward all-reduces", {("all-reduce", 128 * KIB, 2): 4},
         {("all-reduce", 64 * KIB, 2): 8}),
    ],
    "fused": [
        # the exit: JAX rings the reduce-scatter and the all-gather (one
        # hop each at tp=2); the port's ring kernel hops once with the f32
        # partial chunk and the peer all-gather follows (the card's branch)
        ("exit ring", {("collective-permute", 64 * KIB, 2): 8},
         {("collective-permute", 64 * KIB, 2): 4,
          ("all-gather", 128 * KIB, 2): 4}),
        # the entry's backward all-reduce: a ring in JAX's fused HLO, the
        # peer all-reduce in the port
        ("entry backward all-reduces",
         {("collective-permute", 64 * KIB, 2): 8},
         {("all-reduce", 128 * KIB, 2): 4}),
    ],
}


def _bulk(split, diff_side):
    out = {k[1:]: v for k, v in split.items() if k[0] == "bulk"}
    for key, n in diff_side.items():
        out[key] = out.get(key, 0) - n
    return {k: v for k, v in out.items() if v}


@pytest.mark.parametrize("key", ["megatron", "oases", "fused"])
def test_collectives_match_jax_1d(jax_cells, key):
    arch, hp, mesh = COLLECTIVE_CELLS[key]
    hc = _trace(arch, hp, mesh, plain=False)
    j, p = _split(_jax_ops(jax_cells[key])), _split(hc.collective_ops)
    jd, pd = {}, {}
    for _, js, ps in BULK_DIFF[key]:
        for side, acc in ((js, jd), (ps, pd)):
            for k, v in side.items():
                acc[k] = acc.get(k, 0) + v
    assert _bulk(j, jd) == _bulk(p, pd)
    # each difference moves the same link bytes on both sides
    from repro_torch.launch.hlo_cost import _collective_cost
    for name, js, ps in BULK_DIFF[key]:
        assert sum(n * _collective_cost(k[0], k[1], k[2])[1]
                   for k, n in js.items()) == sum(
            n * _collective_cost(k[0], k[1], k[2])[1]
            for k, n in ps.items()), name
    small = tuple({k[2]: v for k, v in side.items() if k[0] == "small"}
                  for side in (j, p))
    assert small == SMALL_1D
    # the link bytes apart: the small all-reduces (each at its payload,
    # tp=2)
    jax_small, port_small = (sum(p * n for p, n in side.items())
                             for side in SMALL_1D)
    assert hc.collective_link_bytes == jax_cells[key][
        "collective_link_bytes"] - (jax_small - port_small)


def _add(acc, key, n):
    acc[key] = acc.get(key, 0) + n
    return acc


def _two_d_diff(cfg, x=2, y=2):
    """The (2, 2) ``fused`` cell's collectives that differ by design
    (ROADMAP.md C), from the config's shapes: (name, JAX's ops, the
    port's ops), each (kind, payload, group) -> count over the step.  What
    both sides run alike is left out: the exits' all-gathers of the
    y-sharded columns, the embedding's sum and the head input's cotangent
    sum over the group of four."""
    f, t, n_layers = 4, B * S, cfg.num_layers
    hd = cfg.resolved_head_dim
    assert cfg.num_kv_heads % x == 0     # KV heads shard over x here
    q = t * cfg.num_heads // x * hd * f
    kv = t * cfg.num_kv_heads // x * hd * f
    ff = t * cfg.d_ff // x * f
    part = t * cfg.d_model // y * f      # an exit's x sum, an entry's chunk
    full = t * cfg.d_model * f

    def jax_ring(*sizes, acc=None):
        # JAX's ring all-reduce of 2: a reduce-scatter hop and an
        # all-gather hop of half the payload; its walker reads no group
        # from a permute and takes the default, the group of four
        acc = {} if acc is None else acc
        for p in sizes:
            _add(acc, ("collective-permute", p // 2, x * y), 2 * n_layers)
        return acc

    def port_ring(*sizes):
        # the ring kernel's hop with the f32 partial chunk, then the peer
        # all-gather (the card's branch)
        acc = {}
        for p in sizes:
            _add(acc, ("collective-permute", p // 2, 2), n_layers)
            _add(acc, ("all-gather", p, 2), n_layers)
        return acc

    def port_entry_bwd():
        # f over x sums the chunk's cotangent; the chunk's slice
        # all-gathers it over y
        return {("all-reduce", part, 2): n_layers,
                ("all-gather", full, 2): n_layers}

    def jax_exit_bwd():
        # the x ring reversed, and the reduce-scatter that transposes the
        # columns' all-gather
        return jax_ring(part, acc={("reduce-scatter", part, 2): n_layers})

    return [
        ("entry y sums forward (wq, wk, wv, wg, wu)",
         jax_ring(q, kv, kv, ff, ff), port_ring(q, kv, kv, ff, ff)),
        ("exit x sums forward (wo, wd)",
         jax_ring(part, part), port_ring(part, part)),
        # JAX reverses the y rings (partial cotangents); the port's
        # cotangents are whole (f/g) and it sums at f and the slice
        ("attention entry backward", jax_ring(q, kv, kv), port_entry_bwd()),
        ("MLP entry backward", jax_ring(ff, ff), port_entry_bwd()),
        # the port slices dy to its columns (free) and sums dx over y
        ("attention exit backward", jax_exit_bwd(),
         {("all-reduce", q, 2): n_layers}),
        ("MLP exit backward", jax_exit_bwd(),
         {("all-reduce", ff, 2): n_layers}),
    ]


# the small all-reduces (payload, group) -> count of the (2, 2) cell:
# JAX's cross-entropy row statistics (1 KiB each, as in 1-D) with 4 and
# 1,540 bytes of norm pieces merged into other ops and 8, 20 and 28 bytes
# of them over the x or y pair; the port's statistics and its one f32
# gradient norm over the group
SMALL_2D = ({(1024, 4): 1, (1028, 4): 1, (1540, 4): 1, (2048, 4): 3,
             (8, 2): 1, (20, 2): 1, (28, 2): 1},
            {(1024, 4): 6, (4, 4): 1})


def _link(ops):
    from repro_torch.launch.hlo_cost import _collective_cost
    return sum(n * _collective_cost(k[0], k[1], k[2])[1]
               for k, n in ops.items())


def test_collectives_2d_fused_by_kind(jax_cells):
    """The 2-D layout under ``fused`` at (2, 2), held to JAX by (kind,
    payload, group) as the 1-D cells are: JAX's ops less its side of
    :func:`_two_d_diff` equal the port's less its side.  The forward
    rings move the same link bytes on both sides (the port's end in an
    all-gather where JAX's second hop is a permute).  By kind the port
    moves 2.6x JAX's all-reduce and 4x its all-gather link bytes, a
    quarter of its permute bytes and none of its reduce-scatters; in all
    393,216 bulk link bytes less, from the backward: the MLP entry sums
    the d_model chunk's cotangent over x where JAX reverses two d_ff-wide
    rings over y, and the attention exit sums its dx over y where JAX
    reverses a ring and reduce-scatters."""
    arch, hp, mesh = COLLECTIVE_CELLS["2d_fused"]
    cfg = _cfg(arch)
    hc = _trace(arch, hp, mesh, plain=False)
    j, p = _split(_jax_ops(jax_cells["2d_fused"])), _split(hc.collective_ops)
    diff = _two_d_diff(cfg)
    jd, pd = {}, {}
    for _, js, ps in diff:
        for side, acc in ((js, jd), (ps, pd)):
            for k, v in side.items():
                _add(acc, k, v)
    assert _bulk(j, jd) == _bulk(p, pd)
    for name, js, ps in diff[:2]:
        assert _link(js) == _link(ps), name
    saved = {name: _link(js) - _link(ps) for name, js, ps in diff}
    assert saved == {"entry y sums forward (wq, wk, wv, wg, wu)": 0,
                     "exit x sums forward (wo, wd)": 0,
                     "attention entry backward": 0,
                     "MLP entry backward": 262144,
                     "attention exit backward": 131072,
                     "MLP exit backward": 0}
    small = tuple({(k[2], k[3]): v for k, v in side.items()
                   if k[0] == "small"} for side in (j, p))
    assert small == SMALL_2D
    jax_small, port_small = (_link({("all-reduce",) + k: n
                                    for k, n in side.items()})
                             for side in SMALL_2D)
    assert hc.collective_link_bytes == jax_cells["2d_fused"][
        "collective_link_bytes"] - sum(saved.values()) \
        - (jax_small - port_small)


def test_microbatch_extrapolation_is_exact():
    """Three microbatches traced and extrapolated to four count what the
    four traced whole count (every op, collective and unit)."""
    cfg = _cfg("gpt-h2048")
    hp = TrainHParams(schedule="oases", microbatch=4)
    kw = dict(global_batch=8, seq_len=32, mesh=RankMesh(*MESH_TP2))
    a, _ = dryrun.trace_step(cfg, hp, extrapolate=True, **kw)
    b, _ = dryrun.trace_step(cfg, hp, extrapolate=False, **kw)
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    # the peak is reached by the third microbatch; the output the same
    assert da.pop("mem") == db.pop("mem")
    assert da == db


def _jax_record_keys():
    """The string keys JAX's ``run_cell`` writes into ``rec`` and its
    ``mem`` dict, read from the source without importing it."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys, mem = set(), set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Subscript) and isinstance(n.value, ast.Name) \
                and n.value.id == "rec" and isinstance(n.slice,
                                                       ast.Constant):
            keys.add(n.slice.value)
        if isinstance(n, ast.Dict):
            ks = {k.value for k in n.keys if isinstance(k, ast.Constant)}
            if "argument_bytes" in ks:
                mem |= ks
            elif "arch" in ks or "status" in ks:
                keys |= ks
    return keys, mem


def test_record_keys_match_jax():
    """An OK record has JAX's keys, ``xla_cost`` named ``torch_cost``;
    ``mem`` has JAX's, ``fits_16GB`` named ``fits_80GB``.  The
    calibrated joint plan (a card) and a SKIP's reason are JAX's too."""
    jkeys, jmem = _jax_record_keys()
    rec = dryrun.run_cell(_cfg("gpt-h2048"), ShapeConfig("t", S, B, "train"),
                          mesh_shape="1x2")
    assert rec["status"] == "OK" and rec["mesh_shape"] == "1x2"
    assert set(rec) == (jkeys - {"xla_cost", "reason",
                                 "calibrated_joint_plan"}) | {"torch_cost"}
    assert set(rec["mem"]) == (jmem - {"fits_16GB"}) | {"fits_80GB"}
    assert set(rec["hlo"]) == {
        "dot_flops", "hbm_bytes", "collective_link_bytes",
        "collective_payload_bytes", "collective_counts",
        "collective_by_kind"}
    assert set(rec["terms_s"]) == {"compute_s", "memory_s", "collective_s"}
    # torch_cost covers the whole step, as xla_cost does: the kernel
    # units' bounds work is added to FlopCounterMode's count of the rest,
    # so the two totals agree only if FlopCounterMode counts every product
    # outside the units as the counter does
    tc, units = rec["torch_cost"], rec["torch_cost"]["kernel_units"]
    assert units["flops"] > 0 and units["bytes accessed"] > 0
    assert tc["flops"] == rec["hlo"]["dot_flops"]
    assert tc["flops"] - units["flops"] < rec["hlo"]["dot_flops"]
    assert tc["bytes accessed"] == rec["hlo"]["hbm_bytes"]
    skip = dryrun.run_cell("gpt-h2048", "long_500k")
    assert skip["status"] == "SKIP" and set(skip) <= jkeys


def test_argument_bytes_are_the_state_a_trainer_holds():
    """The record's argument bytes equal the bytes of a CPU Trainer's
    params, AdamW state and batch at the same cell (the chip gate's
    check)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import params as prm
    from repro_torch.runtime import Trainer
    cfg = _cfg("mamba2-130m")
    hp = TrainHParams(schedule="megatron", microbatch=2)
    tr = Trainer(cfg, hp, global_batch=B, seq_len=S, device="cpu",
                 log_fn=None)
    tr.train(1)
    batch = tr.batch(DataConfig(global_batch=B, seq_len=S,
                                vocab_size=cfg.vocab_size,
                                microbatch=tr.hp.microbatch), 0)
    st = tr.opt_state
    held = sum(t.numel() * t.element_size() for t in (
        *prm.flat_leaves(tr.params), *st["master"], *st["m"], *st["v"],
        *batch.values()))
    hc, _ = dryrun.trace_step(cfg, hp, global_batch=B, seq_len=S,
                              mesh=RankMesh(*MESH_1))
    assert hc.mem["argument_bytes"] == held
    assert hc.mem["alias_bytes"] == held - sum(
        t.numel() * t.element_size() for t in batch.values())


@pytest.mark.parametrize("kw,item", [
    (dict(pp=2), "A8"), (dict(virtual_stages=2), "A8"),
    (dict(shape_name="prefill_32k"), "A5"),
    (dict(shape_name="decode_32k"), "A5"),
    (dict(mesh_shape="2x2"), "A4"), (dict(multi_pod=True), "A4"),
], ids=["pp", "virtual_stages", "prefill", "decode", "data_axis",
        "multi_pod"])
def test_refusals_name_their_item(kw, item):
    kw = dict(dict(shape_name="train_4k"), **kw)
    with pytest.raises(NotImplementedError,
                       match=rf"the PyTorch port runs .* \(ROADMAP.md "
                             rf"{item}\)"):
        dryrun.run_cell("gpt-h2048", kw.pop("shape_name"), **kw)


_CLI = r"""
import json, sys
from repro_torch.launch import dryrun
base = ["--arch", "gpt-h12288", "--shape", "train_4k", "--out", "d.jsonl"]
runs = {
    "trace": ["--mesh-shape", "1x2", "--no-calibrate"],
    "save": ["--plan-only", "--save-plan", "p.json"],
    "load": ["--plan", "p.json", "--plan-only"],
    "A5": ["--shape", "prefill_32k", "--no-calibrate"],
    "A8": ["--pp", "2", "--no-calibrate"],
    "A4": ["--mesh-shape", "2x2", "--no-calibrate"],
    "A9": ["--plan", "seqs.json", "--no-calibrate"],
    "skip": ["--shape", "long_500k", "--no-calibrate"],
}
json.dump({"layers": [[2, "oases", 2]] * 4}, open("seqs.json", "w"))
for name, extra in runs.items():
    dryrun.main(base + extra)
try:
    dryrun.main(base + ["--mesh-shape", "1x2"])
except RuntimeError as e:
    print("CALIBRATE", e)
recs = [json.loads(l) for l in open("d.jsonl")]
print("RECS", json.dumps(dict(zip(runs, recs))))
"""


def test_cli_plan_round_trip_and_refusals(tmp_path):
    """``main`` in one subprocess: a traced cell at ``--mesh-shape 1x2``
    (gpt-h12288, 4 layers at full width, train_4k), ``--plan-only
    --save-plan`` then ``--plan`` of that file, each refusal recorded as an
    ERROR naming its item, a SKIP, and ``--calibrate`` without a card."""
    # no card visible to the subprocess, whatever the host has, so that
    # --calibrate takes its no-card branch
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _CLI], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(ln for ln in out.stdout.splitlines()
                if ln.startswith("RECS "))
    recs = json.loads(line[5:])
    t = recs["trace"]
    assert t["status"] == "OK" and t["mesh_shape"] == "1x2"
    assert t["n_chips"] == 2 and t["microbatch"] > 2
    assert t["hlo"]["collective_link_bytes"] > 0
    assert t["mem"]["fits_80GB"] == (t["mem"]["peak_est_bytes"] < 80e9)
    assert recs["save"]["status"] == recs["load"]["status"] == "PLAN_ONLY"
    assert recs["save"]["mesh_shape"] == "1x16"
    assert recs["load"]["plan"] == recs["save"]["plan"]
    for item in ("A5", "A8", "A4", "A9"):
        assert recs[item]["status"] == "ERROR"
        assert f"NotImplementedError" in recs[item]["error"]
        assert f"(ROADMAP.md {item})" in recs[item]["error"]
    assert recs["skip"]["status"] == "SKIP"
    assert "CALIBRATE --calibrate measures the card" in out.stdout
    assert (tmp_path / "p.json").exists()
