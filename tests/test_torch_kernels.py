"""The port's kernels (on the CPU: their plain versions) against the JAX
package's Pallas kernels in interpret mode and their jnp oracles.

Same inputs, made with numpy from a seed, go through both frameworks.
Tolerances: f32 1e-5 abs for attention (sums in another order), 1e-6 for
RMSNorm; bf16 RMSNorm within one bf16 ulp (rtol 2**-7) after the cast.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tmp as jtmp
from repro.kernels import ops as jops
from repro.kernels.flash_attention import paged_flash_decode as jax_paged_flash
from repro.models.attention import paged_decode_attention as jax_paged_ref
from repro_torch.core import tmp as ttmp
from repro_torch.core.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import paged_flash_decode


def _paged_case(g, hd, page, kvh=2, nb=4, seed=0):
    """Five slots: pos 0, last of page 0, first of page 1, the last
    position, and a slot with an all-zero table (null page only)."""
    rng = np.random.default_rng(seed)
    b = 5
    npages = (b - 1) * nb + 1
    q = rng.standard_normal((b, 1, g * kvh, hd)).astype(np.float32)
    kp = rng.standard_normal((npages, page, kvh, hd)).astype(np.float32)
    vp = rng.standard_normal((npages, page, kvh, hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, npages)).astype(np.int32)
    tables = np.zeros((b, nb), np.int32)
    tables[:b - 1] = perm.reshape(b - 1, nb)
    pos = np.array([0, page - 1, page, nb * page - 1, page + 3], np.int32)
    return q, kp, vp, tables, pos


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_paged_decode_matches_jax(g, hd, page, softcap):
    q, kp, vp, tables, pos = _paged_case(g, hd, page)
    got = paged_flash_decode(*(torch.from_numpy(a) for a in
                               (q, kp, vp, tables, pos)),
                             softcap=softcap).numpy()
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tables, pos)]
    kernel = np.asarray(jax_paged_flash(*jargs, softcap=softcap,
                                        interpret=True))
    oracle = np.asarray(jax_paged_ref(*jargs, softcap=softcap))
    assert got.shape == q.shape
    np.testing.assert_allclose(got, kernel, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 50, 128), (100, 256)])
def test_rms_norm_matches_jax(shape, dtype):
    """Row counts (150, 100) are not multiples of the Pallas block (64)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    s = rng.standard_normal(shape[-1]).astype(np.float32) * 0.1
    jx = jnp.asarray(x).astype(dtype)
    kernel = np.asarray(jops.rmsnorm(jx, jnp.asarray(s), interpret=True,
                                     block_rows=64).astype(jnp.float32))
    oracle = np.asarray(jtmp.rms_norm(jx, jnp.asarray(s)).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ttmp.rms_norm(tx, torch.from_numpy(s)).float().numpy()
    assert got.shape == x.shape
    if dtype == "float32":
        tol = dict(atol=1e-6, rtol=1e-6)
    else:
        tol = dict(atol=1e-6, rtol=2 ** -7)
    np.testing.assert_allclose(got, kernel, **tol)
    np.testing.assert_allclose(got, oracle, **tol)


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_refuse_non_cuda_device_mixes():
    """A CUDA launch needs every operand on one CUDA device; a 'meta'
    tensor is neither CPU nor CUDA and must not reach the plain version."""
    q, kp, vp, tables, pos = (torch.from_numpy(a) for a in
                              _paged_case(1, 32, 8))
    with pytest.raises(ValueError, match="same CUDA device"):
        paged_flash_decode(q.to("meta"), kp, vp, tables, pos)
    with pytest.raises(ValueError, match="same CUDA device"):
        ttmp.rms_norm(torch.zeros(2, 8, device="meta"), torch.zeros(8))
    assert _build.LAUNCHES == {"paged_decode": 0, "rmsnorm": 0}


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The build fails loudly (no silent fallback) when nvcc is absent."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
