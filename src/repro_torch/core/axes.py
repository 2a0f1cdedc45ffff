"""Mesh-axis bookkeeping: the port's copy of ``repro.core.axes`` over a
mesh of rank processes instead of devices.

A :class:`RankMesh` names the axes of the ranks of one run and their
sizes; rank r sits at the row-major coordinates of r, as a JAX mesh
orders its devices.  The three mesh flavours of the JAX package:

* the 1-D mesh ``("data", "model")`` — TMP degree = |model| everywhere;
* the 2-D mesh ``("data", "model_x", "model_y")`` — weight *width*
  (heads, d_ff) shards over ``model_x`` and the *contraction* dim
  (d_model) over ``model_y`` (the 2-D method of arXiv:2104.05343);
* the factored (planner) mesh ``("data", "t1", "t2", ...)`` — the model
  group split into binary sub-axes, so a per-layer degree ``n = 2^k`` is
  "shard over the first k t-axes, data parallel over the rest" (paper
  §4.2); a 2-D degree ``(dx, dy)`` takes the first ``log2 dx`` t-axes as
  x and the next ``log2 dy`` as y.

A per-layer TMP degree is an ``int`` (1-D), an ``(dx, dy)`` tuple (2-D)
or None (the whole model group); every entry point accepts all three.
:class:`MeshInfo` and the functions below are JAX's arithmetic with its
error messages; :meth:`RankMesh.axes_index` is ``repro.core.tmp.
axes_index`` (the linearized index over an *ordered* axes tuple).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

T_AXES: Tuple[str, ...] = ("t1", "t2", "t3", "t4")
X_AXIS = "model_x"
Y_AXIS = "model_y"
PIPE_AXIS = "pipe"

Degree = Union[int, Tuple[int, int], None]
Axes = Tuple[str, ...]


def deg_total(degree: Degree) -> Optional[int]:
    """Total TMP group size of a degree (None passes through)."""
    if isinstance(degree, (tuple, list)):
        return int(degree[0]) * int(degree[1])
    return degree


def deg_xy(degree: Degree) -> Tuple[Optional[int], int]:
    """(dx, dy) view of a degree; an int degree is (n, 1)."""
    if isinstance(degree, (tuple, list)):
        return int(degree[0]), int(degree[1])
    return degree, 1


def _log2_exact(n: int, what: str) -> int:
    k = int(math.log2(n)) if n > 0 else -1
    if n <= 0 or 2 ** k != n:
        raise ValueError(f"{what} must be a power of two, got {n}")
    return k


@dataclass(frozen=True)
class RankMesh:
    """The ranks of one run as a mesh: ``shape[i]`` ranks along
    ``axis_names[i]``, rank r at the row-major coordinates of r."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(n) for n in self.shape))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(self.shape) != len(self.axis_names) or \
                any(n < 1 for n in self.shape):
            raise ValueError(f"bad rank mesh {self.shape} "
                             f"{self.axis_names}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def coords(self, rank: int) -> Dict[str, int]:
        out = {}
        for name, n in zip(reversed(self.axis_names), reversed(self.shape)):
            out[name] = rank % n
            rank //= n
        return out

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for name, n in zip(self.axis_names, self.shape):
            r = r * n + coords[name]
        return r

    def axes_size(self, axes: Sequence[str]) -> int:
        s = self.sizes
        return math.prod(s[a] for a in axes)

    def axes_index(self, rank: int, axes: Sequence[str]) -> int:
        """Linearized index of ``rank`` within the given (ordered) axes."""
        c, s = self.coords(rank), self.sizes
        idx = 0
        for a in axes:
            idx = idx * s[a] + c[a]
        return idx

    def group(self, rank: int, axes: Sequence[str]) -> List[int]:
        """The ranks that share every coordinate of ``rank`` outside
        ``axes``, in :meth:`axes_index` order over ``axes``."""
        s = self.sizes
        out = []
        for i in range(self.axes_size(axes)):
            c = dict(self.coords(rank))
            for a in reversed(tuple(axes)):
                c[a] = i % s[a]
                i //= s[a]
            out.append(self.rank_of(c))
        return out

    def groups(self, axes: Sequence[str]) -> List[List[int]]:
        """Every group over ``axes`` (a partition of the ranks), ordered
        by their lowest rank: the same list on every rank."""
        seen, out = set(), []
        for r in range(self.size):
            if r not in seen:
                g = self.group(r, axes)
                seen.update(g)
                out.append(g)
        return out


@dataclass(frozen=True)
class MeshInfo:
    mesh: RankMesh
    batch_axes: Axes       # ('pod', 'data') ∩ mesh axes
    model_axes: Axes       # ('model',), (model_x, model_y) or T_AXES prefix
    pipe_axes: Axes = ()   # ('pipe',) when pipeline-parallel

    def _size(self, axes: Sequence[str]) -> int:
        return self.mesh.axes_size(axes) if axes else 1

    @property
    def tp(self) -> int:
        return self._size(self.model_axes)

    @property
    def pp(self) -> int:
        """Pipeline-parallel degree (number of physical stages)."""
        return self._size(self.pipe_axes)

    @property
    def dp(self) -> int:
        return self._size(self.batch_axes)

    @property
    def factored(self) -> bool:
        return bool(self.model_axes) and self.model_axes[0] in T_AXES

    @property
    def twod(self) -> bool:
        """Mesh carries an explicit 2D model layout (a ``model_y`` axis)."""
        return Y_AXIS in self.model_axes

    # ---- per-degree axis algebra (planner / factored mesh only) ----
    def tp_axes(self, degree: Degree = None) -> Axes:
        """Model axes carrying TMP sharding for a layer of given degree.

        A 2D ``(dx, dy)`` degree returns the x- and y-axes concatenated —
        the combined group used for vocab sharding, batch-axis algebra and
        anything else that is layout-agnostic.
        """
        if isinstance(degree, (tuple, list)):
            ax, ay = self.xy_axes(degree)
            return ax + ay
        if degree is None or degree == self.tp:
            return self.model_axes
        if not self.factored:
            raise ValueError(
                f"degree {degree} != mesh tp {self.tp} requires the "
                f"factored mesh")
        if degree == 1:
            return ()
        k = _log2_exact(degree, "TMP degree")
        if degree > self.tp:
            raise ValueError(f"TMP degree must be a power of two <= "
                             f"{self.tp}")
        return self.model_axes[:k]

    def xy_axes(self, degree: Degree = None) -> Tuple[Axes, Axes]:
        """Split a layer's model axes into ``(x_axes, y_axes)``: x carries
        the width (head / d_ff) sharding, y the contraction-dim (d_model)
        sharding of the 2D hybrid layout.  Int degrees (and plain 1D
        meshes) put everything in x; a mesh with an explicit ``model_y``
        axis splits there; tuple degrees on the factored mesh take binary
        sub-axis prefixes."""
        if isinstance(degree, (tuple, list)):
            dx, dy = int(degree[0]), int(degree[1])
            if dy == 1:
                return self.tp_axes(dx), ()
            if self.twod:
                s = self.mesh.sizes
                sx = math.prod(s[a] for a in self.model_axes if a != Y_AXIS) \
                    if len(self.model_axes) > 1 else 1
                sy = s.get(Y_AXIS, 1)
                if (dx, dy) != (sx, sy):
                    raise ValueError(
                        f"2D degree {(dx, dy)} != mesh layout ({sx}, {sy})")
                return (tuple(a for a in self.model_axes if a != Y_AXIS),
                        (Y_AXIS,))
            if not self.factored:
                raise ValueError(
                    "per-layer 2D degrees need the factored or "
                    "model_x/model_y mesh")
            kx = _log2_exact(dx, "2D degree dx")
            ky = _log2_exact(dy, "2D degree dy")
            if kx + ky > len(self.model_axes):
                raise ValueError(
                    f"2D degree {(dx, dy)} exceeds mesh tp {self.tp}")
            return self.model_axes[:kx], self.model_axes[kx:kx + ky]
        axes = self.tp_axes(degree)
        return (tuple(a for a in axes if a != Y_AXIS),
                tuple(a for a in axes if a == Y_AXIS))

    def extra_dp_axes(self, degree: Degree = None) -> Axes:
        """Model axes a lower-degree layer reuses as extra data
        parallelism."""
        used = self.tp_axes(degree)
        return tuple(a for a in self.model_axes if a not in used)

    def all_batch_axes(self, degree: Degree = None) -> Axes:
        return self.batch_axes + self.extra_dp_axes(degree)

    def axes_not_in(self, pspec: Sequence) -> Axes:
        """Mesh axes a tensor with this partition spec is *replicated*
        over (a spec: one entry per dim, None, an axis name or a tuple of
        them)."""
        used = set()
        for entry in pspec:
            if entry is None:
                continue
            if isinstance(entry, (tuple, list)):
                used.update(entry)
            else:
                used.add(entry)
        return tuple(a for a in self.mesh.axis_names if a not in used)

    def axes_index(self, rank: int, axes: Sequence[str]) -> int:
        """``repro.core.tmp.axes_index``: ``rank``'s linearized index over
        the ordered ``axes``."""
        return self.mesh.axes_index(rank, axes)


def mesh_info(mesh: RankMesh) -> MeshInfo:
    names = tuple(mesh.axis_names)
    batch = tuple(a for a in ("pod", "data") if a in names)
    pipe = tuple(a for a in (PIPE_AXIS,) if a in names)
    if "model" in names:
        model: Axes = ("model",)
    elif X_AXIS in names or Y_AXIS in names:
        model = tuple(a for a in (X_AXIS, Y_AXIS) if a in names)
    else:
        model = tuple(a for a in T_AXES if a in names)
    return MeshInfo(mesh=mesh, batch_axes=batch, model_axes=model,
                    pipe_axes=pipe)


def batch_pspec(info: MeshInfo, global_batch: int,
                degree: Degree = None) -> Axes:
    """The axes the batch dim shards over (JAX's ``P(axes)`` entry; ()
    replicated): every batch axis whose size still divides what is left
    of the batch, in order."""
    axes = []
    s = info.mesh.sizes
    rem = global_batch
    for a in info.all_batch_axes(degree):
        if rem % s[a] == 0:
            axes.append(a)
            rem //= s[a]
    return tuple(axes)


def local_batch(info: MeshInfo, global_batch: int,
                degree: Degree = None) -> int:
    return global_batch // info._size(batch_pspec(info, global_batch,
                                                  degree))
