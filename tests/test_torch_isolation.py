"""The PyTorch port stands alone: no module of ``repro_torch``, not
``chip_smoke.py`` and no script of ``tools/`` imports JAX or the JAX
package."""
import _torch_threads  # noqa: F401  (one torch thread: see the module)
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")


def _port_modules():
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for name in ("configs.base", "configs.registry", "core.tmp",
                 "kernels.ref", "kernels.rmsnorm", "kernels.flash_attention",
                 "kernels._build", "models.params", "models.attention",
                 "models.blocks", "models.lm", "serving.paged_cache",
                 "serving.engine", "launch.serve", "optim.adamw",
                 "data.pipeline", "launch.steps", "launch.train",
                 "runtime.trainer", "core.comm",
                 "core.schedule", "core.remat", "kernels.collective_matmul",
                 "kernels.autotune", "kernels.peer_comm", "launch.ranks",
                 "kernels.ring_attention", "kernels.bounds",
                 "configs.mamba2_130m", "configs.granite_moe_3b",
                 "models.ssd", "models.moe", "models.rglru", "kernels.ssd",
                 "kernels.moe_gmm", "kernels.rglru",
                 "configs.recurrentgemma_9b", "core.plan", "core.planner",
                 "core.planner.costmodel", "core.planner.ilp",
                 "core.planner.calibrate", "core.pipeline", "launch.mesh",
                 "obs", "obs.recorder", "obs.schema", "obs.tracing",
                 "obs.report", "obs.probe", "core.axes", "launch.hlo_cost",
                 "launch.dryrun", "configs.gemma2_9b", "configs.granite_8b",
                 "configs.internlm2_20b", "configs.moonshot_16b_a3b",
                 "configs.llama32_vision_11b", "configs.whisper_small"):
        assert f"repro_torch.{name}" in mods, name


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*PORT.rglob("*.py"), *(ROOT / "tools").glob("*.py"),
     ROOT / "chip_smoke.py"]))
def test_source_has_no_jax_or_repro_import(path):
    for n, line in enumerate((ROOT / path).read_text().splitlines(), 1):
        assert not IMPORT_RE.match(line), f"{path}:{n}: {line}"
