"""The port stands alone: importing every module of holo_tpu_torch, the
daemon's entry holod_torch.py and chip_smoke.py loads neither jax nor
anything of holo_tpu, and no source file of them, nor of the port's tools,
imports either (nor does the package import its entry script)."""

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
    return (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "holod_torch.py"]
            + [ROOT / "tools" / name for name in TOOLS])


def _forbidden(name: str, path: Path) -> bool:
    """jax and holo_tpu anywhere; the entry script inside the package."""
    return (name.split(".")[0] == "jax" or name == "holo_tpu" or name.startswith("holo_tpu.")
            or (name.split(".")[0] == "holod_torch" and PKG in path.parents))


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
                 "holo_tpu_torch.analysis.runtime", "holo_tpu_torch.testing",
                 "holo_tpu_torch.telemetry.flight", "holo_tpu_torch.telemetry.convergence",
                 "holo_tpu_torch.telemetry.observatory", "holo_tpu_torch.telemetry.critpath",
                 "holo_tpu_torch.telemetry.slo", "holo_tpu_torch.kernels.work",
                 "holo_tpu_torch.telemetry.provider", "holo_tpu_torch.utils",
                 "holo_tpu_torch.utils.ip", "holo_tpu_torch.utils.bytesbuf",
                 "holo_tpu_torch.utils.runtime", "holo_tpu_torch.utils.southbound",
                 "holo_tpu_torch.utils.netio", "holo_tpu_torch.utils.ibus",
                 "holo_tpu_torch.utils.bier", "holo_tpu_torch.protocols.ospf",
                 "holo_tpu_torch.protocols.ospf.packet", "holo_tpu_torch.protocols.ospf.lsdb",
                 "holo_tpu_torch.protocols.ospf.interface",
                 "holo_tpu_torch.protocols.ospf.neighbor",
                 "holo_tpu_torch.protocols.ospf.spf_run",
                 "holo_tpu_torch.protocols.ospf.instance",
                 "holo_tpu_torch.protocols.ospf.nb_state", "holo_tpu_torch.routing",
                 "holo_tpu_torch.routing.rib", "holo_tpu_torch.spf.synth_storm",
                 "holo_tpu_torch.yang", "holo_tpu_torch.yang.schema",
                 "holo_tpu_torch.yang.data", "holo_tpu_torch.yang.modules",
                 "holo_tpu_torch.yang.serde", "holo_tpu_torch.northbound",
                 "holo_tpu_torch.northbound.core", "holo_tpu_torch.northbound.provider",
                 "holo_tpu_torch.utils.keychain", "holo_tpu_torch.utils.policy",
                 "holo_tpu_torch.utils.nvstore", "holo_tpu_torch.utils.preempt",
                 "holo_tpu_torch.utils.txqueue", "holo_tpu_torch.protocols.bfd",
                 "holo_tpu_torch.routing.netlink", "holo_tpu_torch.resilience.supervisor",
                 "holo_tpu_torch.daemon", "holo_tpu_torch.daemon.config",
                 "holo_tpu_torch.daemon.hardening", "holo_tpu_torch.daemon.providers",
                 "holo_tpu_torch.daemon.daemon", "holo_tpu_torch.daemon.grpc_server",
                 "holo_tpu_torch.daemon.holo_tpu_pb2", "holo_tpu_torch.daemon.scenario"):
        assert want in mods


def test_import_loads_no_jax_and_no_holo_tpu():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "import holod_torch\n"
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
        bad = [n for n in names if _forbidden(n, path)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"
