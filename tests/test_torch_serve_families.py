"""The port's prefill, dense decode step and dense engine for every
assigned arch against JAX's ``build_prefill``, ``build_decode`` and dense
``ServingEngine`` on the CPU, and the decode state's carrier.

Each arch runs reduced in f32 at JAX's ``test_prefill_decode_smoke``
recipe (batch 2, prompt 32, then one decode step at position 31 on the
prefill's state), from weights drawn with numpy, every leaf JAX zeroes
drawn too (``_torch_family.numpy_params``: at zero ``c_gate`` would hide
the cross path and every norm would be ``1 + 0``).  gemma2 and
recurrentgemma also run a prompt of 80 against their reduced window of
64, so the local layers' state is the ring (the last 64 positions,
rolled) and the decode writes into it; those two run at 5 and 8 layers,
so the stack has a tail (the reduced configs have whole pattern repeats
only).  The decode step of JAX is its dense engine's (2 slots of 32
positions), one compile per arch shared by the prefill case and the
engine case.

Tolerances: next tokens equal; every state leaf within 1e-5 of JAX's
relative to the leaf's largest magnitude after one step (f32, the same
math in other summation orders; the RG-LRU's scan is sequential here and
associative in JAX), 1e-4 after an engine's drain of ~20 steps."""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_family import (cfgs, check_state, engines_agree, jax_flat,
                           mesh, numpy_params, serve_requests)
from repro.configs.base import TrainHParams
from repro.core import compat
from repro.models import lm as jlm
from repro.models import params as jprm
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs.registry import ASSIGNED
from repro_torch.models import lm as tlm
from repro_torch.models import params as tprm
from repro_torch.serving import ServingEngine

STATE_RTOL = 1e-5        # one step
DRAIN_RTOL = 1e-4        # after an engine's drain
SLOTS, MAX_SEQ = 2, 32   # the prefill's batch and prompt, the engine's


@functools.lru_cache(maxsize=None)
def _jax_engine(arch: str):
    """JAX's dense engine of the reduced f32 ``arch`` (2 slots, max_seq
    32) on the numpy weights, and those weights (flat)."""
    jcfg, _ = cfgs(arch)
    jeng = JServingEngine(jcfg, mesh(), slots=SLOTS, max_seq=MAX_SEQ)
    flat = numpy_params(jeng.specs)
    jeng.load(params=jprm.tree_from_flat(
        jeng.specs, {k: jnp.asarray(v) for k, v in flat.items()}))
    return jeng, flat


def _inputs(cfg, b, s, seed=5):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(3, cfg.vocab_size, (b, s))
             .astype(np.int32)}
    if cfg.context_len:
        batch["ctx"] = rng.standard_normal(
            (b, cfg.context_len, cfg.d_model)).astype(np.float32)
    return batch


def _jax_run(jcfg, b, s, arch, layers):
    """The weights (flat), the batch, and JAX's (prefill token, state,
    decode token, state) at position s - 1: the decode of the shared
    engine at the engine's shape, else its own ``build_decode``."""
    hp = TrainHParams()
    pf, specs, _ = jlm.build_prefill(jcfg, mesh(), hp, global_batch=b,
                                     seq_len=s)
    if layers is None and (b, s) == (SLOTS, MAX_SEQ):
        jeng, flat = _jax_engine(arch)
        decode = jeng.decode_fn
    else:
        flat = numpy_params(specs)
        decode = jax.jit(jlm.build_decode(jcfg, mesh(), hp, global_batch=b,
                                          seq_len=s)[0])
    p = jprm.tree_from_flat(specs, {k: jnp.asarray(v)
                                    for k, v in flat.items()})
    batch = _inputs(jcfg, b, s)
    pos = np.full((b,), s - 1, np.int32)
    with compat.set_mesh(mesh()):
        tok, st = jax.jit(pf)(p, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
        tok2, st2 = decode(p, st, tok, jnp.asarray(pos))
    return (flat, batch, pos, np.asarray(tok), jax_flat(st),
            np.asarray(tok2), jax_flat(st2))


CASES = [(arch, MAX_SEQ, None) for arch in ASSIGNED] + [
    ("gemma2-9b", 80, 5), ("recurrentgemma-9b", 80, 8)]


@pytest.mark.parametrize("arch,s,layers", CASES)
def test_prefill_and_decode_match_jax(arch, s, layers):
    jcfg, tcfg = cfgs(arch, **({"num_layers": layers} if layers else {}))
    b = SLOTS
    flat, batch, pos, jtok, jst, jtok2, jst2 = _jax_run(jcfg, b, s, arch,
                                                        layers)
    params = tprm.from_flat(tcfg, flat, max_pos=s)
    ctx = (torch.from_numpy(batch["ctx"]) if "ctx" in batch else None)
    tok, st = tlm.prefill(tcfg, params, torch.from_numpy(batch["tokens"]),
                          ctx)
    assert tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), jtok)
    check_state(tprm.state_to_flat(st), jst, STATE_RTOL, f"{arch} prefill")
    if layers:
        # a tail after the stacked blocks, and rings of `window` < s rows
        assert st["tail"] and tcfg.window < s
        assert any(t.shape[2] == tcfg.window
                   for e in st["blocks"] + st["tail"]
                   for k, t in e.items() if k == "k")
    # the decode runs on the carried state, as the engine's does
    specs = tprm.cache_specs(tcfg, batch=b, seq=s)
    state = tprm.state_from_flat(tcfg, tprm.state_to_flat(st), specs)
    tok2 = tlm.decode_step(tcfg, params, state, tok, torch.from_numpy(pos))
    np.testing.assert_array_equal(tok2.numpy(), jtok2)
    check_state(tprm.state_to_flat(state), jst2, STATE_RTOL,
                f"{arch} decode")


# the engine cases that share the prefill cases' JAX decode; gemma2's
# wrapping rings are in tests/test_torch_serve_dense.py
ENGINE_ARCHS = ["internlm2-1.8b", "recurrentgemma-9b", "mamba2-130m",
                "granite-moe-3b-a800m", "whisper-small"]


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_dense_engine_token_identical_to_jax(arch):
    """The port's dense engine (the default) against JAX's on the same
    weights: 3 requests over 2 slots (prompts of up to 8 tokens, up to 6
    new ones), so a slot is reused with the state JAX leaves in it."""
    _, tcfg = cfgs(arch)
    jeng, flat = _jax_engine(arch)
    teng = ServingEngine(tcfg, slots=SLOTS, max_seq=MAX_SEQ, device="cpu")
    assert teng.paged is None
    teng.load(params=tprm.from_flat(tcfg, flat))
    engines_agree(jeng, teng,
                  serve_requests(tcfg.vocab_size, 3, 8, 6, seed=3),
                  DRAIN_RTOL)


@pytest.mark.parametrize("arch", ["gemma2-9b", "recurrentgemma-9b",
                                  "whisper-small", "mamba2-130m"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_carrier_round_trip_is_bit_exact(arch, dtype):
    """JAX's zero state's tree (every kind's keys and shapes) is the
    port's, dense and paged, and random states (JAX's dtypes) go through
    ``state_from_flat`` / ``state_to_flat`` bit for bit."""
    jcfg, tcfg = (c.replace(dtype=dtype) for c in cfgs(arch))
    rng = np.random.default_rng(1)
    for paged in (None, (9, 8)):
        _, _, jspecs = jlm.build_decode(jcfg, mesh(), TrainHParams(),
                                        global_batch=3, seq_len=72,
                                        paged=paged)
        jzero = jax_flat(jprm.zeros_state(jspecs))
        specs = tprm.cache_specs(tcfg, batch=3, seq=72, paged=paged)
        zero = tprm.zeros_state(tcfg, specs)
        assert {k: (v.shape, str(v.dtype)) for k, v in jzero.items()} == {
            k: (tuple(t.shape), "float32" if t.dtype == torch.float32
                else "bfloat16") for k, t in tprm.flatten(zero).items()}
        flat = {k: np.asarray(jnp.asarray(rng.standard_normal(v.shape),
                                          v.dtype))
                for k, v in jzero.items()}
        back = tprm.state_to_flat(tprm.state_from_flat(tcfg, flat, specs))
        assert set(back) == set(flat)
        for k, v in flat.items():
            assert np.array_equal(back[k], v.astype(np.float32)), k
    with pytest.raises(KeyError, match="missing"):
        tprm.state_from_flat(tcfg, {}, specs)
