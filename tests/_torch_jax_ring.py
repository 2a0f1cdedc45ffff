"""Subprocess body of ``tests/test_torch_sp.py``: JAX's ring attention on
n-device host meshes, and JAX's one-device ``chunked_attention``, on the
inputs the test wrote.

    python tests/_torch_jax_ring.py INPUTS.npz OUTPUTS.npz

For every case in INPUTS (q, k, v, do, pos and the case's options) and n
in 2 and 4: the ring's out, lse and the gradients dq, dk, dv of
``sum(out * do)`` through ``repro.core.compat.shard_map`` (``check_vma``
off: the ring's ``lax.cond`` branches differ in their varying axes) on an
Auto-typed mesh of the first n host devices; and once per case the same
through ``chunked_attention`` on one device.  The device count must be
set before jax is imported, hence a process of its own.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core import compat  # noqa: E402
from repro.kernels.ring_attention import (_ring_forward,  # noqa: E402
                                          ring_attention)
from repro.models.attention import chunked_attention  # noqa: E402

RINGS = (2, 4)


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def case_outputs(arrs, opts):
    dtype = jnp.bfloat16 if opts["dtype"] == "bfloat16" else jnp.float32
    q, k, v, do = (jnp.asarray(arrs[n], dtype) for n in ("q", "k", "v", "do"))
    pos = jnp.asarray(arrs["pos"], jnp.int32)
    kw = dict(causal=True, window=opts["window"], softcap=opts["softcap"])
    out = {}

    def loss_of(fn):
        def loss(q, k, v):
            o = fn(q, k, v)
            return jnp.sum(o.astype(jnp.float32) * do.astype(jnp.float32)), o
        return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                          has_aux=True))

    (_, o), grads = loss_of(lambda q, k, v: chunked_attention(
        q, k, v, q_positions=pos, kv_positions=pos, **kw))(q, k, v)
    out["one/out"] = _f32(o)
    for name, g in zip(("dq", "dk", "dv"), grads):
        out[f"one/{name}"] = _f32(g)

    for n in RINGS:
        mesh = compat.make_mesh((n,), ("model",),
                                axis_types=compat.auto_axis_types(1),
                                devices=jax.devices()[:n])
        seq = P(None, "model")
        ring = compat.shard_map(
            lambda q, k, v, qp, kvp: ring_attention(
                q, k, v, axes=("model",), q_positions=qp, kv_positions=kvp,
                **kw),
            mesh=mesh, in_specs=(seq,) * 5, out_specs=seq, check_vma=False)
        scale = float(q.shape[-1] ** -0.5)
        fwd = compat.shard_map(
            lambda q, k, v, qp, kvp: _ring_forward(
                q, k, v, qp, kvp, ("model",), True, kw["window"],
                kw["softcap"], scale)[1],
            mesh=mesh, in_specs=(seq,) * 5,
            out_specs=P(None, None, None, "model"), check_vma=False)
        with compat.set_mesh(mesh):
            (_, o), grads = loss_of(lambda q, k, v: ring(q, k, v, pos,
                                                         pos))(q, k, v)
            lse = jax.jit(fwd)(q, k, v, pos, pos)
        out[f"ring{n}/out"] = _f32(o)
        out[f"ring{n}/lse"] = _f32(lse).reshape(q.shape[0], q.shape[2], -1)
        for name, g in zip(("dq", "dk", "dv"), grads):
            out[f"ring{n}/{name}"] = _f32(g)
    return out


def main(src, dst):
    data = np.load(src)
    cases = json.loads(str(data["cases"]))
    result = {}
    for name, opts in cases.items():
        arrs = {k: data[f"{name}/{k}"] for k in ("q", "k", "v", "do", "pos")}
        for key, val in case_outputs(arrs, opts).items():
            result[f"{name}/{key}"] = val
    np.savez(dst, **result)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
