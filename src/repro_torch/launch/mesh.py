"""Plan desugaring for the port's launcher: the 1-D counterpart of
``repro.launch.mesh.resolve_launch``.  The port's "mesh" is one data rank
and a model group of ``tp`` rank processes, so there is no device mesh to
build; the factored and 2-D meshes are ROADMAP.md A7."""
from __future__ import annotations

from repro_torch.core.plan import ParallelPlan

MESH_AXES = ("data", "model")


def resolve_launch(cfg, hp, *, tp: int = 1,
                   plan_file: str = "") -> ParallelPlan:
    """The single plan-desugaring path of the launcher:

    * ``--plan plan.json``: the file IS the source of truth — its knobs
      override the legacy flags when the plan is applied;
    * legacy flags: the scattered knobs (schedule, tmp-layout,
      microbatch, split, seq shards) desugar into one ParallelPlan on the
      ``(1, tp)`` ``("data", "model")`` mesh.

    Returns the plan alone: ``hp`` is projected through it once, where
    the steps are built (``Trainer(plan=...)``,
    :func:`~repro_torch.launch.steps.unpack_plan`)."""
    if plan_file:
        plan = ParallelPlan.load(plan_file).validate_for(cfg)
        print(f"[plan] loaded {plan_file}: {plan.summary()}")
        return plan
    return ParallelPlan.from_hparams(hp, cfg.num_layers, mesh_shape=(1, tp),
                                     mesh_axes=MESH_AXES)
