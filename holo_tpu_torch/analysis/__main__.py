"""``python -m holo_tpu_torch.analysis [--device cpu|cuda] [--no-cache] [--json]``:
the kernel-contract audit (HL301-HL305) over every registered dispatch
program.

Prints each finding rendered as ``holo_tpu``'s are, then the seconds each
program took, and exits 1 on an error-tier finding.  It runs on the card
unless asked for the CPU (``--device cpu``), like every entry point of the
port.  On the CPU it reads and writes the per-kernel cache
(``.holo_torch_audit_cache.json``) unless ``--no-cache``; on the card every
program runs.  ``--json`` prints one JSON report instead.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from holo_tpu_torch.analysis.core import gate_findings

ROOT = Path(__file__).resolve().parent.parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m holo_tpu_torch.analysis",
                                 description="kernel-contract audit (HL301-HL305)")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the programs run (default: the card)")
    ap.add_argument("--no-cache", action="store_true",
                    help="run every program; read and write no cache")
    ap.add_argument("--json", action="store_true", help="print one JSON report")
    args = ap.parse_args(argv)

    if args.device == "cpu" and not args.no_cache:
        from holo_tpu_torch.analysis.cache import run_audit_cached

        result = run_audit_cached(ROOT)
    else:
        from holo_tpu_torch.analysis.kernel_audit import run_audit
        from holo_tpu_torch.device import resolve_device

        # None is the card: with none present this raises, as every entry
        # point of the port does.
        dev = resolve_device(None if args.device == "cuda" else args.device)
        result = run_audit(str(ROOT), device=str(dev))
    errors = gate_findings(result.findings)
    if args.json:
        print(json.dumps({
            "device": args.device,
            "kernels_checked": result.kernels_checked,
            "kernels_cached": result.kernels_cached,
            "skipped": result.skipped,
            "findings": [f.render() for f in result.findings],
            "suppressed": [f.render() for f in result.suppressed],
            "kernel_seconds": result.kernel_seconds,
            "errors": len(errors),
        }))
    else:
        for f in result.findings:
            print(f.render())
        for name in sorted(result.kernel_seconds):
            print(f"  {name}: {result.kernel_seconds[name]:.3f} s")
        for name in result.skipped:
            print(f"  {name}: skipped (needs a multi-device mesh)")
        print(f"kernel audit on {args.device}: {result.kernels_checked} programs "
              f"({result.kernels_cached} from the cache), {len(result.findings)} findings, "
              f"{len(errors)} at error tier, {len(result.suppressed)} suppressed")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
