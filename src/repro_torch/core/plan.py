"""First-class executable parallelism plans: the port's copy of
``repro.core.plan``.  Plan files are interchangeable between the two
packages (the same fields and JSON).

A :class:`ParallelPlan` is the single serializable object that carries a
run's parallelism decisions end to end: the planner emits one, the
launcher desugars legacy flags into one (``launch/mesh.py``) and the
trainer executes one (``launch/steps.py::check_plan`` says which: per-layer
mixed degrees and schedules, 1-D and 2-D, on one data rank; pipelines,
per-layer seqs and data parallelism are ROADMAP.md A8, A9 and A4).

The paper's search space (§4, Table 6) is *per layer*: each layer carries
its own ``(degree, schedule)`` strategy, where ``degree`` is a TMP degree
(``None`` = follow the whole mesh model group, an ``int`` = 1D ring, an
``(dx, dy)`` tuple = 2D hybrid) and ``schedule`` names one of the overlap
schedules of :data:`SCHEDULES`.  In the JAX package consecutive layers
sharing a strategy execute as one scan group, so a uniform plan
degenerates to the classic stacked layout.

Everything here is pure Python (no torch import) so plans can be built,
validated and round-tripped anywhere, including inside the planner's
ILP.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

# the one schedule set of the port: core/schedule.py and configs/base.py
# import it from here
SCHEDULES = ("megatron", "wang", "merak", "oases", "fused")
TMP_LAYOUTS = ("auto", "1d", "2d")

Degree = Any    # None | int | (dx, dy)


def validate_schedule(name: str, *, what: str = "schedule") -> str:
    """Friendly schedule-name validation: an unknown string used to fall
    silently through the ``effective_split``/``TmpCtx`` branches to
    megatron-like behaviour — now it fails at construction, naming the
    valid set."""
    if name not in SCHEDULES:
        raise ValueError(
            f"unknown {what} {name!r}: valid schedules are "
            f"{', '.join(SCHEDULES)} (see core/schedule.py)")
    return name


def _canon_degree(d: Degree, *, what: str = "degree") -> Degree:
    """Canonicalize/validate one per-layer degree: None, a positive
    power-of-two int, or an (dx, dy) tuple of such ints."""
    def _pow2(n) -> int:
        if not isinstance(n, int) or isinstance(n, bool) or n <= 0 \
                or n & (n - 1):
            raise ValueError(
                f"bad {what} {d!r}: TMP degrees must be positive powers "
                f"of two (paper §4.2), None (follow the mesh), or "
                f"(dx, dy) tuples of such ints")
        return n

    if d is None:
        return None
    if isinstance(d, (tuple, list)):
        if len(d) != 2:
            raise ValueError(
                f"bad {what} {d!r}: a 2D degree is exactly (dx, dy)")
        dx, dy = _pow2(d[0]), _pow2(d[1])
        return dx if dy == 1 else (dx, dy)
    return _pow2(d)


@dataclass(frozen=True)
class LayerStrategy:
    """One layer's ``(degree, schedule, seq)`` strategy.

    ``seq`` is the ring-attention sequence-shard factor (DESIGN.md §12):
    1 = classic head-sharded TMP; > 1 = the layer keeps activations
    sequence-sharded through attention with replicated attention weights
    and a KV ring over the layer's model group.  At runtime ``seq`` must
    equal the layer's effective TMP group size (checked in models/lm.py —
    the ring spans exactly the group the heads would have sharded over).
    """
    degree: Degree = None
    schedule: str = "oases"
    seq: int = 1

    def __post_init__(self):
        object.__setattr__(self, "degree", _canon_degree(self.degree))
        validate_schedule(self.schedule, what="layer schedule")
        q = self.seq
        if not isinstance(q, int) or isinstance(q, bool) or q < 1 \
                or q & (q - 1):
            raise ValueError(
                f"bad layer seq {q!r}: ring-attention seq shards must be "
                f"a positive power-of-two int (1 = off)")
        if q > 1 and isinstance(self.degree, tuple):
            raise ValueError(
                f"seq={q} does not compose with a 2D degree "
                f"{self.degree!r}: the KV ring is a 1D ring over the "
                f"layer's model group")


# JSON field names = dataclass field names; anything else is rejected.
@dataclass(frozen=True)
class ParallelPlan:
    """Frozen, JSON-serializable parallelism plan.

    ``layers`` is the per-layer strategy list (its length must match the
    model's ``num_layers`` — checked against a config by
    :meth:`validate_for`).  ``mesh_shape``/``mesh_axes`` optionally pin
    the device mesh the plan was made for (``()`` = resolve at launch);
    the remaining fields are the knobs that used to travel as loose
    arguments through the trainer/serving/launch stack.
    """
    layers: Tuple[LayerStrategy, ...]
    mesh_shape: Tuple[int, ...] = ()
    mesh_axes: Tuple[str, ...] = ()
    tmp_layout: str = "auto"
    pp: int = 1
    virtual_stages: int = 1
    split: int = 2
    microbatch: int = 0
    decode_micro: int = 0
    zero1: bool = True
    grad_compress: bool = False
    seq_parallel: bool = False
    seq_shard: int = 1

    def __post_init__(self):
        layers = tuple(
            ls if isinstance(ls, LayerStrategy) else LayerStrategy(*ls)
            for ls in self.layers)
        if not layers:
            raise ValueError("a ParallelPlan needs at least one layer "
                             "strategy")
        object.__setattr__(self, "layers", layers)
        object.__setattr__(self, "mesh_shape",
                           tuple(int(s) for s in self.mesh_shape))
        object.__setattr__(self, "mesh_axes",
                           tuple(str(a) for a in self.mesh_axes))
        if len(self.mesh_shape) != len(self.mesh_axes):
            raise ValueError(
                f"mesh_shape {self.mesh_shape} and mesh_axes "
                f"{self.mesh_axes} must have matching lengths")
        if any(s <= 0 for s in self.mesh_shape):
            raise ValueError(f"bad mesh_shape {self.mesh_shape}: "
                             f"components must be positive")
        if self.tmp_layout not in TMP_LAYOUTS:
            raise ValueError(
                f"unknown tmp_layout {self.tmp_layout!r}: valid layouts "
                f"are {', '.join(TMP_LAYOUTS)}")
        for field, lo in (("pp", 1), ("virtual_stages", 1), ("split", 1),
                          ("microbatch", 0), ("decode_micro", 0),
                          ("seq_shard", 1)):
            v = getattr(self, field)
            if not isinstance(v, int) or isinstance(v, bool) or v < lo:
                raise ValueError(f"bad {field} {v!r}: expected int >= {lo}")
        if self.seq_shard & (self.seq_shard - 1):
            raise ValueError(f"bad seq_shard {self.seq_shard!r}: expected "
                             f"a power of two")
        if self.pp > 1 and (self.seq_shard > 1 or self.has_seq_layers):
            raise ValueError(
                "ring-attention sequence sharding does not compose with "
                "pipeline parallelism yet (stage boundaries ship full "
                "sequences)")
        if self.pp > 1 and self.is_mixed:
            raise ValueError(
                "per-layer mixed (degree, schedule) strategies do not "
                "compose with pipeline parallelism yet — a pp > 1 plan "
                "must use one uniform strategy (stage-internal TMP is "
                "uniform per stage)")

    # ---- views -----------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def schedules(self) -> Tuple[str, ...]:
        return tuple(ls.schedule for ls in self.layers)

    @property
    def degrees(self) -> Tuple[Degree, ...]:
        return tuple(ls.degree for ls in self.layers)

    @property
    def seqs(self) -> Tuple[int, ...]:
        return tuple(ls.seq for ls in self.layers)

    @property
    def has_seq_layers(self) -> bool:
        return any(ls.seq > 1 for ls in self.layers)

    @property
    def planned_seqs(self) -> Optional[Tuple[int, ...]]:
        """Per-layer ring-attention seq shards when any layer pins one;
        None for an all-head-sharded plan."""
        return self.seqs if self.has_seq_layers else None

    @property
    def is_mixed(self) -> bool:
        """True when any two layers differ in (degree, schedule, seq)."""
        return len({(ls.degree, ls.schedule, ls.seq)
                    for ls in self.layers}) > 1

    @property
    def uniform_schedule(self) -> Optional[str]:
        s = {ls.schedule for ls in self.layers}
        return next(iter(s)) if len(s) == 1 else None

    @property
    def primary_schedule(self) -> str:
        """The schedule a single-schedule consumer (decode, hp.schedule)
        should run: the uniform schedule, else 'fused' if any layer is
        fused (the only schedule that changes decode's collectives), else
        the first layer's.  All schedules are numerically identical, so
        this only affects overlap, never tokens."""
        u = self.uniform_schedule
        if u is not None:
            return u
        return "fused" if "fused" in self.schedules \
            else self.layers[0].schedule

    @property
    def planned_degrees(self) -> Optional[Tuple[Degree, ...]]:
        """Per-layer degrees when any layer pins one; None for a fully
        mesh-following plan (the uniform stacked layout)."""
        if all(ls.degree is None for ls in self.layers):
            return None
        return self.degrees

    def grouping_signature(self) -> Tuple:
        """What determines the parameter-tree layout this plan trains
        under: grouped (mixed strategies / pinned degrees) vs stacked,
        and the stage stacking.  Checkpoint restores compare signatures
        to decide whether a cross-plan relayout is needed
        (models/params.py::relayout_flat)."""
        if self.is_mixed or self.planned_degrees is not None \
                or self.has_seq_layers:
            if self.has_seq_layers:
                return ("grouped", tuple((ls.degree, ls.schedule, ls.seq)
                                         for ls in self.layers))
            # seq-free plans keep the historical 2-tuple entries so old
            # checkpoint manifests keep matching
            return ("grouped", tuple((ls.degree, ls.schedule)
                                     for ls in self.layers))
        if self.seq_shard > 1:
            return ("stacked", self.pp, 1, self.seq_shard)
        return ("stacked", self.pp, self.virtual_stages if self.pp > 1
                else 1)

    def summary(self) -> str:
        runs: list = []
        for ls in self.layers:
            key = (ls.degree, ls.schedule, ls.seq)
            if runs and runs[-1][0] == key:
                runs[-1][1] += 1
            else:
                runs.append([key, 1])

        def _deg(d):
            if d is None:
                return "mesh"
            if isinstance(d, tuple):
                return f"{d[0]}x{d[1]}"
            return str(d)

        body = " + ".join(
            f"[{_deg(d)}/{s}{f'/seq{q}' if q > 1 else ''}]*{n}"
            for (d, s, q), n in runs)
        if self.seq_shard > 1:
            body += f" seq_shard={self.seq_shard}"
        pp = f" pp={self.pp}x{self.virtual_stages}v" if self.pp > 1 else ""
        mesh = (f" mesh={'x'.join(map(str, self.mesh_shape))}"
                if self.mesh_shape else "")
        return f"plan<{body}{pp}{mesh}>"

    # ---- hparams bridge --------------------------------------------------
    def apply(self, hp):
        """Project this plan onto a TrainHParams (the runtime carrier of
        non-parallelism knobs): schedule/layout/split/microbatch/... come
        from the plan, everything else (lr, remat, steps) from ``hp``.

        ``microbatch`` is copied as it is: in the port 0 means auto (the
        step resolves it), where in JAX it means no accumulation.  The
        launcher resolves the auto count before it builds a plan, so the
        plans it writes carry the count it ran."""
        return dataclasses.replace(
            hp, schedule=self.primary_schedule, tmp_layout=self.tmp_layout,
            split=self.split, microbatch=self.microbatch,
            virtual_stages=self.virtual_stages, zero1=self.zero1,
            grad_compress=self.grad_compress,
            seq_parallel=self.seq_parallel, seq_shard=self.seq_shard)

    @classmethod
    def from_hparams(cls, hp, num_layers: int, *,
                     degrees: Optional[Sequence[Degree]] = None,
                     schedules: Optional[Sequence[str]] = None,
                     seqs: Optional[Sequence[int]] = None,
                     mesh_shape: Sequence[int] = (),
                     mesh_axes: Sequence[str] = (),
                     pp: int = 1,
                     decode_micro: int = 0) -> "ParallelPlan":
        """Desugar legacy (hp, degrees) threading into a plan — the one
        place the scattered knobs become a ParallelPlan."""
        for what, per in (("degrees", degrees), ("schedules", schedules),
                          ("seqs", seqs)):
            if per is not None and len(per) != num_layers:
                raise ValueError(
                    f"per-layer {what} have {len(per)} entries for a "
                    f"{num_layers}-layer model")
        degs = list(degrees) if degrees is not None else [None] * num_layers
        scheds = (list(schedules) if schedules is not None
                  else [hp.schedule] * num_layers)
        sqs = list(seqs) if seqs is not None else [1] * num_layers
        return cls(
            layers=tuple(LayerStrategy(d, s, q)
                         for d, s, q in zip(degs, scheds, sqs)),
            mesh_shape=tuple(mesh_shape), mesh_axes=tuple(mesh_axes),
            tmp_layout=hp.tmp_layout, pp=max(pp, 1),
            virtual_stages=max(hp.virtual_stages, 1),
            split=max(hp.split, 1), microbatch=hp.microbatch,
            decode_micro=decode_micro, zero1=hp.zero1,
            grad_compress=hp.grad_compress, seq_parallel=hp.seq_parallel,
            seq_shard=getattr(hp, "seq_shard", 1))

    def validate_for(self, cfg) -> "ParallelPlan":
        """Check the plan against an ArchConfig (layer count)."""
        if len(self.layers) != cfg.num_layers:
            raise ValueError(
                f"plan has {len(self.layers)} layer strategies but "
                f"{cfg.name} has {cfg.num_layers} layers")
        return self

    # ---- JSON ------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self)}
        # layers serialize as [degree, schedule] and only grow the third
        # element when a layer is seq-sharded, so seq-free plan files stay
        # byte-identical to what older readers expect
        d["layers"] = [
            [list(ls.degree) if isinstance(ls.degree, tuple)
             else ls.degree, ls.schedule] + ([ls.seq] if ls.seq > 1 else [])
            for ls in self.layers]
        if self.seq_shard == 1:
            d.pop("seq_shard")
        d["mesh_shape"] = list(self.mesh_shape)
        d["mesh_axes"] = list(self.mesh_axes)
        return d

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ParallelPlan":
        if not isinstance(d, dict):
            raise ValueError(
                f"a plan payload must be a JSON object, got "
                f"{type(d).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown plan field(s) {sorted(unknown)}: known fields "
                f"are {sorted(known)} (is this file really a "
                f"ParallelPlan JSON?)")
        if "layers" not in d:
            raise ValueError("plan payload missing required field "
                             "'layers'")
        kw = dict(d)
        layers = kw.pop("layers")
        if not isinstance(layers, (list, tuple)):
            raise ValueError(f"plan 'layers' must be a list, got "
                             f"{type(layers).__name__}")
        parsed = []
        for i, ls in enumerate(layers):
            if isinstance(ls, dict):
                extra = set(ls) - {"degree", "schedule", "seq"}
                if extra:
                    raise ValueError(
                        f"layer {i}: unknown strategy field(s) "
                        f"{sorted(extra)}")
                parsed.append(LayerStrategy(ls.get("degree"),
                                            ls.get("schedule", "oases"),
                                            ls.get("seq", 1)))
            elif isinstance(ls, (list, tuple)) and len(ls) in (2, 3):
                try:
                    parsed.append(LayerStrategy(
                        tuple(ls[0]) if isinstance(ls[0], list) else ls[0],
                        ls[1], ls[2] if len(ls) == 3 else 1))
                except (ValueError, TypeError) as e:
                    raise ValueError(f"layer {i}: {e}") from None
            else:
                raise ValueError(
                    f"layer {i}: expected [degree, schedule] or "
                    f"[degree, schedule, seq] (degree = null | int | "
                    f"[dx, dy]), got {ls!r}")
        return cls(layers=tuple(parsed), **kw)

    @classmethod
    def from_json(cls, text: str) -> "ParallelPlan":
        try:
            payload = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"malformed plan JSON: {e}") from None
        return cls.from_dict(payload)

    # ---- files -----------------------------------------------------------
    def save(self, path: str) -> str:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")
        return path

    @classmethod
    def load(cls, path: str) -> "ParallelPlan":
        with open(path) as f:
            return cls.from_json(f.read())
