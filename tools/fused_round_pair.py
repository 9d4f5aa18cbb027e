#!/usr/bin/env python3
"""Time the port's ``ell_fused_round`` of several trees of this repository on one GPU, in turns.

    python3 tools/fused_round_pair.py TREE[+VARIANT] [TREE[+VARIANT] ...] [--out FILE]

Each TREE is the root of a checkout; an earlier commit is unpacked with
``git archive`` into the gitignored ``.archive/``.  ``TREE+VARIANT`` is a copy
of TREE's ``holo_tpu_torch`` in ``.archive/variant-VARIANT/`` with one text
change to ``csrc/fused_kernels.cu`` (the run fails if the text is missing):

- ``generic``: no int4 load of an interleaved lane's vector (the generic path);
- ``tgf2`` / ``tgf8``: 2 or 8 32-lane tiles a warp of the tile form, not 4.

The trees run one process each, in the order given (parent, change, change,
parent for a paired comparison).  A run imports its tree's ``holo_tpu_torch``
(which builds that tree's kernels), builds the k=90 fat tree
(``fat_tree_topology(k=90)``, 10,125 vertices) and its device graph, and for
both layouts (planar, ``fused``; interleaved, ``packed``) at 1024 lanes (the
masks ``whatif_link_failure_masks(topo, 1024, seed=1)``) and at one lane (no
mask, ``compute()``'s shape) runs ``fused_lanes`` as the engines do:

- the first dispatch holds every ``ell_fused_round`` launch's outputs
  bit-identical to ``fused_round_plain`` on the state it ran from;
- REPS more dispatches time each launch with CUDA events (host launch
  included; the median per launch over the dispatches) and, under the
  profiler, the device time of the fused kernels a dispatch (the mean).

It prints one JSON object a run, the card's name and power limit, and writes
them all to FILE (default ``chiprun_out/fused_round_pair.json``).  Without a
GPU it exits 1.
"""

from __future__ import annotations

import argparse
import inspect
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

REPS = 5
K, BATCH, MASK_SEED = 90, 1024, 1
SOURCE = Path("holo_tpu_torch") / "csrc" / "fused_kernels.cu"
VEC4_LINE = "c.vec4 = packed && nwords == 2 && aligned16(dist) && aligned16(dist_out);"
VARIANTS = {
    "generic": (VEC4_LINE, "c.vec4 = false;"),
    "tgf2": ("constexpr int TGF = 4;", "constexpr int TGF = 2;"),
    "tgf8": ("constexpr int TGF = 4;", "constexpr int TGF = 8;"),
}


def variant_tree(tree: Path, name: str) -> Path:
    """A copy of ``tree``'s port with variant ``name``'s text change."""
    old, new = VARIANTS[name]
    dest = (Path(".archive") / f"variant-{name}").resolve()
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(tree / "holo_tpu_torch", dest / "holo_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    text = (dest / SOURCE).read_text()
    if old not in text:
        raise SystemExit(f"fused_round_pair: variant {name}: {SOURCE} of {tree} lacks {old!r}")
    (dest / SOURCE).write_text(text.replace(old, new))
    return dest


def run_one(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("fused_round_pair: needs a CUDA device")
    from holo_tpu_torch.kernels import ell
    from holo_tpu_torch.ops import graph
    from holo_tpu_torch.ops import spf_engine as se
    from holo_tpu_torch.spf import synth

    dev = torch.device("cuda")
    topo = synth.fat_tree_topology(k=K)
    n_atoms = max(64, topo.n_atoms())
    g = se.device_graph_from_ell(graph.build_ell(topo, n_atoms=n_atoms), dev)
    masks = synth.whatif_link_failure_masks(topo, BATCH, seed=MASK_SEED)
    kernel = ell.ell_fused_round
    frontier_api = "frontier" in inspect.signature(kernel).parameters
    out = {"tree": str(tree), "source_bytes": (tree / SOURCE).stat().st_size,
           "frontier_api": frontier_api}

    def dispatch(lanes, packed, wrap):
        mask = se.pack_edge_masks(masks[:lanes], dev) if lanes > 1 else None
        roots = torch.full((lanes,), topo.root, dtype=torch.int32, device=dev)
        ell.ell_fused_round = wrap
        try:
            res = se.fused_lanes(g, roots, mask, packed)
        finally:
            ell.ell_fused_round = kernel
        torch.cuda.synchronize()
        return res

    for packed, layout in ((False, "planar"), (True, "interleaved")):
        for lanes in (BATCH, 1):
            held, geometry = [], []

            def holding(*args):
                if hasattr(ell, "fused_geometry"):  # what the library launches, on these planes
                    geometry.append(ell.fused_geometry(args[7], args[10]))
                got = kernel(*args)
                state = args[7]
                want = ell.fused_round_plain(*args[:7], state)
                for i, (a, b) in enumerate(zip(got, want)):
                    for x, y in zip((a,) if torch.is_tensor(a) else a,
                                    (b,) if torch.is_tensor(b) else b):
                        if not torch.equal(x, y):
                            raise SystemExit(f"fused_round_pair: {tree} {layout} {lanes} lanes "
                                             f"launch {len(held) + 1} output {i} differs")
                held.append(1)
                return got

            first = dispatch(lanes, packed, holding)
            times = []

            def timing(*args):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                got = kernel(*args)
                end.record()
                times[-1].append((start, end))
                return got

            for _ in range(REPS):
                times.append([])
                res = dispatch(lanes, packed, timing)
                if not all(torch.equal(a, b) for a, b in zip(res, first)):
                    raise SystemExit(f"fused_round_pair: {tree} {layout} dispatches differ")
            ms = [[s.elapsed_time(e) for s, e in rep] for rep in times]
            launch_ms = [statistics.median(col) for col in zip(*ms)]
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(REPS):
                    dispatch(lanes, packed, kernel)
            dev_ms = sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA and "ell_fused" in e.key) / REPS
            row = {"launches": len(launch_ms), "held": len(held), "launch_ms": launch_ms,
                   "ms": statistics.mean(launch_ms), "dispatch_ms": sum(launch_ms),
                   "device_ms": dev_ms}
            if geometry:
                row["geometry"] = geometry[0]
            out[f"{layout}_{lanes}"] = row
            del first
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/fused_round_pair.json"))
    opts = ap.parse_args()
    if opts.one is not None:
        print(json.dumps(run_one(opts.one.resolve())), flush=True)
        return
    import torch

    if not opts.trees or not torch.cuda.is_available():
        raise SystemExit("fused_round_pair: needs one or more trees and a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    made = {}
    runs = []
    for spec in opts.trees:
        tree, _, name = spec.partition("+")
        path = Path(tree).resolve()
        if name:
            if spec not in made:
                made[spec] = variant_tree(path, name)
            path = made[spec]
        proc = subprocess.run([sys.executable, __file__, "--one", str(path)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"fused_round_pair: {spec} failed (rc {proc.returncode}):\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["spec"] = spec
        runs.append(run)
        print(json.dumps(run), flush=True)
    print(smi, flush=True)
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))


if __name__ == "__main__":
    main()
