"""JAX's side of ``tests/test_torch_dryrun.py``: compiles JAX's training
step of each requested cell on the CPU and prints, as one JSON object,
``repro.launch.hlo_cost.analyze`` of it (``to_dict``), its products
(each dot's output shape and contracted size with its count: loop bodies
times their trip counts, fusion bodies included) and its collectives
(kind, payload, group size, count).

Run as a script, so that the 4 host devices of the multi-rank cells are
set before jax is imported (``tests/test_mesh_parse.py:72-78``)::

    python tests/_torch_jax_cost.py '<json list of cells>'

A cell is ``{"key", "arch", "hp": TrainHParams kwargs, "mesh": [shape],
"axes": [names], "batch", "seq", "degrees"?}``; archs are reduced, f32.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import json  # noqa: E402

import jax  # noqa: E402

from repro.configs.base import ShapeConfig, TrainHParams  # noqa: E402
from repro.configs.registry import get_config  # noqa: E402
from repro.core import compat  # noqa: E402
from repro.core.axes import mesh_info  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.launch.steps import input_specs, step_fn_for  # noqa: E402


def products(text: str):
    """{"(out dims) k": count} of every dot the walker counts."""
    comps, entry = hlo_cost.parse_hlo(text)
    out = {}

    def walk(cname, mult, depth=0):
        comp = comps.get(cname)
        if comp is None or depth > 64:
            return
        for op in comp.ops:
            if op.kind == "while":
                if op.called:
                    walk(op.called[0], mult * op.trip, depth + 1)
                continue
            if op.kind in ("call", "fusion") and op.called:
                walk(op.called[0], mult, depth + 1)
                continue
            if op.kind == "conditional":
                for c in op.called:
                    walk(c, mult, depth + 1)
                continue
            if op.kind == "dot":
                dims = hlo_cost._SHAPE_RE.search(op.shape).group(2)
                flops = hlo_cost._dot_flops(op, comp.shapes)
                n = 1
                for d in dims.split(","):
                    if d:
                        n *= int(d)
                key = f"({dims}) {int(round(flops / (2 * n)))}"
                out[key] = out.get(key, 0) + mult
    walk(entry, 1)
    return out


def collectives(text: str, default_group: int):
    """{"kind payload group": count} of every collective the walker
    counts (payload as ``_collective_cost`` reads it)."""
    comps, entry = hlo_cost.parse_hlo(text)
    out = {}

    def walk(cname, mult, depth=0):
        comp = comps.get(cname)
        if comp is None or depth > 64:
            return
        for op in comp.ops:
            if op.kind == "while":
                if op.called:
                    walk(op.called[0], mult * op.trip, depth + 1)
                continue
            if op.kind == "call" and op.called:
                walk(op.called[0], mult, depth + 1)
                continue
            if op.kind == "conditional":
                for c in op.called:
                    walk(c, mult, depth + 1)
                continue
            base = op.kind.replace("-start", "")
            if base in hlo_cost.COLLECTIVES and not op.kind.endswith(
                    ("-done", "-update")):
                payload, _ = hlo_cost._collective_cost(op, default_group)
                n = hlo_cost._group_size(op.rest, default_group)
                key = f"{base} {int(payload)} {n}"
                out[key] = out.get(key, 0) + mult
    walk(entry, 1)
    return out


def main():
    cells = json.loads(sys.argv[1])
    res = {}
    for c in cells:
        cfg = get_config(c["arch"]).reduced().replace(dtype="float32")
        mesh = compat.make_mesh(tuple(c["mesh"]), tuple(c["axes"]),
                                axis_types=compat.auto_axis_types(
                                    len(c["mesh"])))
        hp = TrainHParams(**c["hp"])
        shape = ShapeConfig("cell", c["seq"], c["batch"], "train")
        degrees = c.get("degrees")
        if degrees is not None:
            degrees = [tuple(d) if isinstance(d, list) else d
                       for d in degrees]
        fn = step_fn_for(cfg, shape, mesh, hp, degrees=degrees)
        inputs = input_specs(cfg, shape, mesh, hp, degrees=degrees)
        with compat.set_mesh(mesh):
            text = jax.jit(fn, donate_argnums=(0, 1)).lower(
                *inputs).compile().as_text()
        info = mesh_info(mesh)
        hc = hlo_cost.analyze(text, default_group=info.tp)
        res[c["key"]] = dict(hc.to_dict(), products=products(text),
                             collectives=collectives(text, info.tp))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
