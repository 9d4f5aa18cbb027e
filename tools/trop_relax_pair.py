#!/usr/bin/env python3
"""Time the port's ``trop_relax`` (T1) of several trees of this repository on one GPU, in turns.

    python3 tools/trop_relax_pair.py TREE[+VARIANT] [TREE[+VARIANT] ...] [--out FILE]

Each TREE is the root of a checkout; an earlier commit is unpacked with
``git archive`` into the gitignored ``.archive/``.  ``TREE+VARIANT`` is a copy
of TREE's ``holo_tpu_torch`` in ``.archive/variant-VARIANT/`` with one text
change to ``csrc/tropical_kernels.cu`` (the run fails if the text is missing):

- ``nodpx``: the relax step as an add and a min (PTX ``add.u32``) in place of
  the DPX ``__viaddmin_u32`` (the run reports each build's ``VIADDMNMX``
  count: ptxas may fuse the pair into the same instruction);
- ``l2`` / ``l1``: 2 or 1 lanes a thread of the tile form at B = 8, not 4
  (128 or 256 threads a block, 256 lanes a block either way).

The trees run one process each, in the order given (parent, change, change,
parent for a paired comparison).  A run imports its tree's ``holo_tpu_torch``
(which builds that tree's kernels), builds the k=90 fat tree
(``fat_tree_topology(k=90)``, 10,125 vertices), its device graph and its
tiles, and runs ``tile_relax`` as the tropical engine does, at 1024 lanes (the
masks ``whatif_link_failure_masks(topo, 1024, seed=1)``, every lane at the
root: the what-if dispatch) and at one lane (no mask: ``compute()``'s):

- the first dispatch holds every ``trop_relax`` call's outputs bit-identical
  to ``trop_relax_plain`` on its own inputs (where the API takes ``out``, on a
  snapshot of it taken before the launch, after checking that it equals
  ``dist`` outside the input frontier);
- REPS more dispatches time each launch with CUDA events (host launch
  included; the median per launch over the dispatches) and, under the
  profiler, the device time of the tile and repair kernels a dispatch (the
  mean) and of each launch (the median);
- the full round (every block active, from the converged distances), and
  launch 1 as it is, without its repair set and with no block active and no
  repair: CUDA events (median of REPS) and device time;
- the tropical lane program (``tropical_lanes``, 1024 lanes): host ms and
  the profiler's device-busy ms;
- the library's launch geometry where the tree reports it, and the DPX
  ``VIADDMNMX`` instructions in its tile kernels' SASS.

It prints one JSON object a run, the card's name and power limit, and writes
them all to FILE (default ``chiprun_out/trop_relax_pair.json``).  Without a
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
SOURCE = Path("holo_tpu_torch") / "csrc" / "tropical_kernels.cu"
DPX_LINE = "return __viaddmin_u32(w, d, acc);"
LANES_LINE = "static constexpr int L = B == 8 ? 4 : 2;"
VARIANTS = {
    "nodpx": (DPX_LINE, 'unsigned s;\n  asm("add.u32 %0, %1, %2;" : "=r"(s) : "r"(w), "r"(d));\n'
                        "  return min(acc, s);"),
    "l2": (LANES_LINE, "static constexpr int L = B == 8 ? 2 : 2;"),
    "l1": (LANES_LINE, "static constexpr int L = B == 8 ? 1 : 2;"),
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
        raise SystemExit(f"trop_relax_pair: variant {name}: {SOURCE} of {tree} lacks {old!r}")
    (dest / SOURCE).write_text(text.replace(old, new))
    return dest


def sass_dpx(build) -> dict:
    """VIADDMNMX instructions in the SASS of each tile-relax kernel of the
    tree's library."""
    out = subprocess.run([str(Path(build.nvcc()).with_name("cuobjdump")), "-sass",
                          str(build.library_path())], capture_output=True, text=True,
                         check=True).stdout
    counts = {}
    for part in out.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if "trop_relax" in name:
            counts[name] = part.count("VIADDMNMX")
    return counts


def run_one(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("trop_relax_pair: needs a CUDA device")
    from holo_tpu_torch.kernels import build, ell
    from holo_tpu_torch.kernels import tropical as kt
    from holo_tpu_torch.ops import graph
    from holo_tpu_torch.ops import spf_engine as se
    from holo_tpu_torch.ops import tropical as trop
    from holo_tpu_torch.spf import synth

    dev = torch.device("cuda")
    topo = synth.fat_tree_topology(k=K)
    n = topo.n_vertices
    ell_np = graph.build_ell(topo, n_atoms=max(64, topo.n_atoms()))
    g = se.device_graph_from_ell(ell_np, dev)
    host, meta = trop.build_tiles_host(ell_np.in_src, ell_np.in_cost, ell_np.in_valid)
    tt = trop.tiles_on(host, dev)
    nb, _, b, _ = tt.tiles.shape
    mask_w = se.pack_edge_masks(synth.whatif_link_failure_masks(topo, BATCH, seed=MASK_SEED), dev)
    kernel = kt.trop_relax
    copy_api = "out" in inspect.signature(kernel).parameters
    out = {"tree": str(tree), "source_bytes": (tree / SOURCE).stat().st_size,
           "copy_api": copy_api, "tiles": {k: meta[k] for k in ("block", "nb", "tm", "pairs")}}
    build.load()
    out["sass_viaddmnmx"] = sass_dpx(build)

    def held_plain(args):
        if copy_api:
            _, _, dist, active, buf, *rest = args
            front = ell._unpack(active, slice(0, dist.shape[1])).repeat_interleave(b, 0)
            if not torch.equal(buf[~front], dist[~front]):
                raise SystemExit(f"trop_relax_pair: {tree}: out differs outside the frontier")
            snap = buf.clone()
            return kernel(*args), kt.trop_relax_plain(*args[:4], snap, *rest)
        return kernel(*args), kt.trop_relax_plain(*args)

    def dispatch(lanes, mask, wrap):
        roots = torch.full((lanes,), topo.root, dtype=torch.int32, device=dev)
        kt.trop_relax = wrap
        try:
            res = trop.tile_relax(g, tt, se.distance_seed(n, roots)[0], mask)
        finally:
            kt.trop_relax = kernel
        torch.cuda.synchronize()
        return res

    def device_ms(fn, reps):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                per[e.key] = e.self_device_time_total / 1e3 / reps
        return per

    def launch_device_ms(fn, reps, name):
        """Device ms of each ``name`` kernel of a dispatch, in launch order
        (the median over ``reps`` dispatches)."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = sorted((e.time_range.start, e.time_range.elapsed_us() / 1e3) for e in prof.events()
                    if e.device_type == DeviceType.CUDA and name in e.name)
        per = len(ev) // reps
        return [statistics.median(ms for _, ms in ev[i::per]) for i in range(per)] if per else []

    def events_ms(fn, reps):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    for lanes, mask in ((BATCH, mask_w), (1, None)):
        p = se.lane_planes(g, mask)
        held = []

        def holding(*args):
            got, want = held_plain(args)
            for i, (x, y) in enumerate(zip(got, want)):
                if not torch.equal(x, y):
                    raise SystemExit(f"trop_relax_pair: {tree} {lanes} lanes launch "
                                     f"{len(held) + 1} output {i} differs")
            held.append(1)
            return got

        first, rounds = dispatch(lanes, mask, holding)
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
            res, _ = dispatch(lanes, mask, timing)
            if not torch.equal(res, first):
                raise SystemExit(f"trop_relax_pair: {tree} {lanes}-lane dispatches differ")
        ms = [[s.elapsed_time(e) for s, e in rep] for rep in times]
        launch_ms = [statistics.median(col) for col in zip(*ms)]
        per = device_ms(lambda: dispatch(lanes, mask, kernel), REPS)
        row = {"launches": len(launch_ms), "held": len(held), "rounds": rounds,
               "launch_ms": launch_ms, "ms": statistics.mean(launch_ms),
               "dispatch_ms": sum(launch_ms),
               "device_ms": sum(v for k, v in per.items() if "trop_relax" in k),
               "repair_device_ms": sum(v for k, v in per.items() if "trop_repair" in k)}
        for name in ("trop_relax", "trop_repair"):
            row[f"{name}_launch_device_ms"] = launch_device_ms(
                lambda: dispatch(lanes, mask, kernel), REPS, name)
        if hasattr(kt, "geometry"):
            row["geometry"] = kt.geometry(b, lanes, nb)
        out[f"dispatch_{lanes}"] = row

    # The full round and launch 1's split, at 1024 lanes.
    p = se.lane_planes(g, mask_w)
    bits = trop.repair_bits(p.slot, mask_w, BATCH, tt)
    rep = kt.repair_set(bits, BATCH) if copy_api else bits
    roots = torch.full((BATCH,), topo.root, dtype=torch.int32, device=dev)
    dist, _ = dispatch(BATCH, mask_w, kernel)
    dist_p = dist[tt.perm.long()].contiguous()
    seed_p = se.distance_seed(n, roots)[0][tt.perm.long()].contiguous()
    front1 = ell.pack_lane_bits((seed_p < (1 << 30)).view(nb, b, BATCH).any(1))
    cases = {
        "full round": ((tt.tiles, tt.cb, dist_p), ell.full_frontier(nb, BATCH, dev), rep,
                       torch.empty_like(dist_p)),
        "launch 1": ((tt.tiles, tt.cb, seed_p), front1, rep, seed_p.clone()),
        "launch 1 without repair": ((tt.tiles, tt.cb, seed_p), front1, None, seed_p.clone()),
        "no block, no repair": ((tt.tiles, tt.cb, seed_p), torch.zeros_like(front1), None,
                                seed_p.clone()),
    }
    ell_args = (p.src, p.cost, p.slot, p.mask, tt.perm, tt.inv)
    for label, (args, active, repair, buf) in cases.items():
        if copy_api:
            def fn(args=args, active=active, repair=repair, buf=buf):
                return kernel(*args, active, buf, repair, *ell_args)
        else:
            def fn(args=args, active=active, repair=repair):
                return kernel(*args, active, repair, *ell_args)
        fn()
        per = device_ms(fn, REPS)
        out[label] = {"ms": events_ms(fn, REPS),
                      "device_ms": sum(v for k, v in per.items() if "trop_" in k),
                      "repair_device_ms": sum(v for k, v in per.items() if "trop_repair" in k)}

    # The tropical lane program (tile relax, G2, M1 without counts).
    def prog():
        trop.tropical_lanes(g, tt, roots, mask_w)
        torch.cuda.synchronize()

    prog()
    out["lane_program"] = {"host_ms": events_ms(prog, 3),
                           "busy_ms": sum(device_ms(prog, 3).values())}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/trop_relax_pair.json"))
    opts = ap.parse_args()
    if opts.one is not None:
        print(json.dumps(run_one(opts.one.resolve())), flush=True)
        return
    import torch

    if not opts.trees or not torch.cuda.is_available():
        raise SystemExit("trop_relax_pair: needs one or more trees and a CUDA device")
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
            raise SystemExit(f"trop_relax_pair: {spec} failed (rc {proc.returncode}):\n"
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
