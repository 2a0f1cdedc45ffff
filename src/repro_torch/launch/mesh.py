"""Rank meshes and plan desugaring for the port's launcher: the port's
copy of ``repro.launch.mesh`` over a mesh of rank processes
(:class:`~repro_torch.core.axes.RankMesh`), not of devices.

* ``auto``: the 1-D mesh ``(1, tp)`` of ``("data", "model")``;
* ``factored``: ``("data", "t1", ...)`` with log2(tp) binary t-axes, on
  which per-layer degrees (1-D ints and 2-D ``(dx, dy)`` tuples) mix;
* ``DxM`` / ``DxMxxMy``: an explicit 1-D or 2-D
  (``("data", "model_x", "model_y")``) mesh.

The parsers keep JAX's grammar and error messages.  A ``data`` axis
above 1 is data parallelism (ROADMAP.md A4) and pipelines are A8: the
launcher refuses both (``launch/steps.py::check_plan``).
"""
from __future__ import annotations

import math
from typing import Tuple

from repro_torch.core.axes import RankMesh, T_AXES
from repro_torch.core.pipeline import PIPE_ITEM
from repro_torch.core.plan import ParallelPlan

MESH_AXES = ("data", "model")


def make_1d_mesh(tp: int, data: int = 1) -> RankMesh:
    return RankMesh((data, tp), MESH_AXES)


def make_factored_mesh(tp: int) -> RankMesh:
    """Planner-mode mesh: the ``tp``-way model group factored into binary
    sub-axes ``t1, t2, ...`` so per-layer TMP degrees (powers of two up
    to tp, 1-D ints or 2-D ``(dx, dy)`` tuples: x = leading sub-axes, y =
    the next) are expressible."""
    k = int(math.log2(tp)) if tp > 0 else -1
    if tp <= 0 or 2 ** k != tp or k > len(T_AXES):
        raise ValueError(f"the factored mesh needs a model group of a power "
                         f"of two up to {2 ** len(T_AXES)} ranks, got {tp}")
    return RankMesh((1,) + (2,) * k, ("data",) + T_AXES[:k])


def make_2d_mesh(data: int, dx: int, dy: int) -> RankMesh:
    """Uniform 2D hybrid-partition mesh ``('data','model_x','model_y')``:
    weight width shards over the dx-way axis, the contraction dim over the
    dy-way axis."""
    return RankMesh((data, dx, dy), ("data", "model_x", "model_y"))


_MESH_HELP = ("expected 'DxM' (data x model, e.g. '32x8') or 'DxMxxMy' "
              "(2D hybrid, e.g. '16x8x2'); a pipeline axis is prepended "
              "with pp= / --pp, giving PxDxM")


def parse_mesh_spec(spec: str, *, pp: int = 0):
    """Pure parser: ``spec`` -> (shape, axes), with JAX's messages."""
    parts = [t.strip() for t in str(spec).split("x")]
    shape = []
    for tok in parts:
        if not tok.isdigit() or int(tok) <= 0:
            raise ValueError(
                f"bad mesh spec {spec!r}: component {tok!r} is not a "
                f"positive integer — {_MESH_HELP}")
        shape.append(int(tok))
    if len(shape) == 2:
        axes = ("data", "model")
    elif len(shape) == 3:
        axes = ("data", "model_x", "model_y")
    else:
        raise ValueError(
            f"bad mesh spec {spec!r}: {len(shape)} component(s) — "
            f"{_MESH_HELP}")
    if pp:
        if not isinstance(pp, int) or pp < 1:
            raise ValueError(
                f"bad pipeline degree pp={pp!r}: must be a positive int")
        if pp > 1:
            shape = [pp] + shape
            axes = ("pipe",) + axes
    return tuple(shape), axes


def parse_degrees(spec: str):
    """'8,4x2,16' -> [8, (4, 2), 16]: per-layer TMP degrees, 'AxB' = 2D,
    every token validated up front (JAX's messages)."""
    def _pow2(tok: str, n: int) -> int:
        if n <= 0 or n & (n - 1):
            raise ValueError(
                f"bad degree spec {spec!r}: component {tok!r} — TMP "
                f"degrees must be positive powers of two (paper §4.2)")
        return n

    def _int(tok: str, part: str) -> int:
        if not part.isdigit():
            raise ValueError(
                f"bad degree spec {spec!r}: component {tok!r} is not a "
                f"degree — expected comma-separated entries 'N' (1D) or "
                f"'AxB' (2D), e.g. '8,4x2,16'")
        return int(part)

    out = []
    for tok in (t.strip() for t in str(spec).split(",")):
        if "x" in tok:
            parts = tok.split("x")
            if len(parts) != 2:
                raise ValueError(
                    f"bad degree spec {spec!r}: 2D entry {tok!r} must be "
                    f"exactly 'AxB', e.g. '4x2'")
            out.append((_pow2(tok, _int(tok, parts[0])),
                        _pow2(tok, _int(tok, parts[1]))))
        elif tok:
            out.append(_pow2(tok, _int(tok, tok)))
        else:
            raise ValueError(
                f"bad degree spec {spec!r}: empty entry — expected "
                f"comma-separated 'N' or 'AxB' tokens, e.g. '8,4x2,16'")
    if not out:
        raise ValueError(f"bad degree spec {spec!r}: no entries")
    return out


def resolve_mesh_spec(spec: str = "auto", *, tp: int = 1,
                      pp: int = 1) -> RankMesh:
    """One mesh resolution for the launcher: ``auto`` (``(1, tp)``),
    ``factored`` (binary t-axes of ``tp``) or an explicit ``DxM`` /
    ``DxMxxMy`` grid, whose size then sets the ranks (``tp`` 1 or that
    size)."""
    if spec == "auto":
        return make_1d_mesh(tp)
    if spec == "factored":
        return make_factored_mesh(tp)
    if spec in ("production", "multipod"):
        raise ValueError(f"--mesh {spec} is the JAX package's TPU pod "
                         f"mesh; the port runs auto, factored, 1xM or "
                         f"1xMxxMy")
    mesh = RankMesh(*parse_mesh_spec(spec, pp=pp))
    model = math.prod(n for a, n in zip(mesh.axis_names, mesh.shape)
                      if a.startswith("model"))
    if tp not in (1, model):
        raise ValueError(f"--mesh {spec} has a model group of {model} "
                         f"ranks, not --tp {tp}")
    return mesh


def mesh_signature(mesh: RankMesh) -> Tuple[Tuple[int, ...],
                                            Tuple[str, ...]]:
    """(shape, axes) of a mesh — what a ParallelPlan records."""
    return tuple(mesh.shape), tuple(mesh.axis_names)


def resolve_launch(cfg, hp, *, mesh: str = "auto", tp: int = 1,
                   plan_file: str = "", pp: int = 1, save_plan: str = "",
                   log=print) -> Tuple[RankMesh, ParallelPlan]:
    """The single plan-desugaring path of the launcher
    (``repro.launch.mesh.resolve_launch``):

    * ``--plan plan.json``: the file IS the source of truth — its knobs
      override the legacy flags when the plan is applied, and its
      recorded mesh is rebuilt when present (the mesh flags resolve it
      otherwise);
    * legacy flags: the mesh resolves from ``--mesh`` / ``--tp`` and the
      scattered knobs (schedule, tmp-layout, microbatch, split, seq
      shards) desugar into one ParallelPlan that records it.

    The serving form (``launch/serve.py``) also passes ``pp`` and
    ``save_plan``, a file the resolved plan is written to.  A pipeline
    (``pp`` or the plan's above 1) raises NotImplementedError naming A8:
    the port's meshes have no pipe axis.

    Returns ``(mesh, plan)``: ``hp`` is projected through the plan once,
    where the steps are built (``Trainer(plan=...)``,
    :func:`~repro_torch.launch.steps.unpack_plan`) or the engine is
    (``ServingEngine(plan=...)``)."""
    if plan_file:
        plan = ParallelPlan.load(plan_file).validate_for(cfg)
        log(f"[plan] loaded {plan_file}: {plan.summary()}")
        m = (RankMesh(plan.mesh_shape, plan.mesh_axes) if plan.mesh_shape
             else resolve_mesh_spec(mesh, tp=tp))
    else:
        if pp > 1:
            raise NotImplementedError(
                f"--pp {pp}: the port's meshes have no pipeline axis "
                f"({PIPE_ITEM})")
        m = resolve_mesh_spec(mesh, tp=tp)
        shape, axes = mesh_signature(m)
        plan = ParallelPlan.from_hparams(hp, cfg.num_layers,
                                         mesh_shape=shape, mesh_axes=axes)
    if plan.pp > 1:
        raise NotImplementedError(
            f"{plan.summary()}: pp={plan.pp} ({PIPE_ITEM})")
    if save_plan:
        plan.save(save_plan)
        log(f"[plan] wrote {save_plan}: {plan.summary()}")
    return m, plan
