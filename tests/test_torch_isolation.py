"""The port stands alone: importing every module of holo_tpu_torch (and
chip_smoke.py) loads neither jax nor anything of holo_tpu, and no source
file of either, nor of the port's tools, imports them."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import holo_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "holo_tpu_torch"
TOOLS = ("bgp_fold_pair.py", "bgp_fold_phases.py", "fused_round_pair.py",
         "trop_relax_pair.py", "trop_count_pair.py")


def _modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(holo_tpu_torch.__path__, "holo_tpu_torch.")
    )


def _sources():
    return (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + [ROOT / "tools" / name for name in TOOLS])


def _forbidden(name: str) -> bool:
    return name.split(".")[0] == "jax" or name == "holo_tpu" or name.startswith("holo_tpu.")


def test_every_module_is_found():
    mods = _modules()
    for want in ("holo_tpu_torch.spf.backend", "holo_tpu_torch.kernels.blocked",
                 "holo_tpu_torch.ops.blocked_spf", "holo_tpu_torch.convert",
                 "holo_tpu_torch.ops.spf_engine", "holo_tpu_torch.kernels.ell",
                 "holo_tpu_torch.resilience.breaker", "holo_tpu_torch.frr.inputs",
                 "holo_tpu_torch.frr.kernel", "holo_tpu_torch.frr.scalar",
                 "holo_tpu_torch.frr.manager", "holo_tpu_torch.graft_entry",
                 "holo_tpu_torch.ops.partition", "holo_tpu_torch.ops.cspf",
                 "holo_tpu_torch.ops.bgp_table", "holo_tpu_torch.kernels.bgp",
                 "holo_tpu_torch.protocols.bgp_engine", "holo_tpu_torch.pipeline.tuner",
                 "holo_tpu_torch.pipeline.dispatch", "holo_tpu_torch.resilience.overload",
                 "holo_tpu_torch.resilience.faults", "holo_tpu_torch.resilience.watchdog",
                 "holo_tpu_torch.parallel", "holo_tpu_torch.parallel.mesh",
                 "holo_tpu_torch.telemetry.profiling", "holo_tpu_torch.telemetry.residency",
                 "holo_tpu_torch.analysis.runtime", "holo_tpu_torch.testing"):
        assert want in mods


def test_import_loads_no_jax_and_no_holo_tpu():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'jax'\n"
        "             or m == 'holo_tpu' or m.startswith('holo_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd="/",
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"
