#!/usr/bin/env python3
"""Time the port's ``trop_count_round`` (T2) of several trees of this repository on one GPU, in turns.

    python3 tools/trop_count_pair.py TREE[+VARIANT] [TREE[+VARIANT] ...] [--out FILE]

Each TREE is the root of a checkout; an earlier commit is unpacked with
``git archive`` into the gitignored ``.archive/``.  ``TREE+VARIANT`` is a copy
of TREE's ``holo_tpu_torch`` in ``.archive/variant-VARIANT/`` with one text
change to ``csrc/tropical_kernels.cu`` (the run fails if the text is missing):

- ``ch32``: 256 / B listed tiles a chunk of the lane form, not 512 / B (32
  at B = 8, not 64);
- ``p64``: 64 (tile, column) pairs staged a pass of the lane form, not 32;
- ``r8``: 8 rows a thread of the lane form at B = 8, not 4 (64 threads a
  block, not 128).

The trees run one process each, in the order given (parent, change, change,
parent for a paired comparison).  A run imports its tree's ``holo_tpu_torch``
(which builds that tree's kernels), builds the k=90 fat tree
(``fat_tree_topology(k=90)``, 10,125 vertices) and two backends on the card,
``TorchSpfBackend(one_engine="tropical")`` (``mp_tropical``) and
``TorchSpfBackend()`` (``mp``), and:

- holds every T2 launch of one ``compute(topo, multipath_k=4)`` bit-identical
  to the plain round on its own inputs (out and the changed flag), keeping
  the inputs of the first launch at each lane width (one lane: the path
  counts; 64: the weights);
- times REPS more computes under the profiler: the device ms of each T2
  launch (the median over the computes), then the median over the launches
  at each lane width, and T2's device ms a compute;
- times T2 alone on the kept inputs at each width (CUDA events and device
  time, median of REPS x 10 launches) and, where the tree has one, the count
  list's build (``count_list``, one a fixpoint);
- times ``mp`` and ``mp_tropical`` ``compute(multipath_k=4)`` in turns (host
  clock, median of REPS) and their device-busy ms (the profiler, the mean of
  REPS);
- reads the library's T2 launch geometry where the tree reports it.

It prints one JSON object a run, the card's name and power limit, and writes
them all to FILE (default ``chiprun_out/trop_count_pair.json``).  Without a
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
import time
from pathlib import Path

REPS = 5
ALONE = 10  # launches a timing of T2 alone
K, KP = 90, 4
SOURCE = Path("holo_tpu_torch") / "csrc" / "tropical_kernels.cu"
VARIANTS = {
    "ch32": ("static constexpr int CH = 512 / B;", "static constexpr int CH = 256 / B;"),
    "p64": ("static constexpr int PAIRS = 32;", "static constexpr int PAIRS = 64;"),
    "r8": ("static constexpr int R = B == 8 ? 4 :", "static constexpr int R = B == 8 ? 8 :"),
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
        raise SystemExit(f"trop_count_pair: variant {name}: {SOURCE} of {tree} lacks {old!r}")
    (dest / SOURCE).write_text(text.replace(old, new))
    return dest


def run_one(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("trop_count_pair: needs a CUDA device")
    from holo_tpu_torch.kernels import build
    from holo_tpu_torch.kernels import tropical as kt
    from holo_tpu_torch.spf import synth
    from holo_tpu_torch.spf.backend import TorchSpfBackend

    dev = torch.device("cuda")
    topo = synth.fat_tree_topology(k=K)
    kernel, plain = kt.trop_count_round, kt.trop_count_plain
    with_list = "listed" in inspect.signature(kernel).parameters
    out_at = 5 if with_list else 4  # out's place in the arguments
    out = {"tree": str(tree), "source_bytes": (tree / SOURCE).stat().st_size,
           "count_list": with_list}
    build.load()
    trop_be = TorchSpfBackend(one_engine="tropical", device=dev)
    mp_be = TorchSpfBackend(device=dev)
    first = trop_be.compute(topo, multipath_k=KP)  # builds the tiles and warms up
    if any(trop_be.breaker.snapshot()[k] for k in ("failures", "fallbacks", "refusals")):
        raise SystemExit(f"trop_count_pair: {tree}: the breaker counted {trop_be.breaker.snapshot()}")

    held, kept = [], {}

    def holding(*args):
        got = kernel(*args)
        fresh = list(args)
        fresh[out_at] = torch.empty_like(args[out_at])
        want = plain(*fresh)
        for i, (a, b) in enumerate(zip(got, want)):
            if not torch.equal(a, b):
                raise SystemExit(f"trop_count_pair: {tree} launch {len(held) + 1} output {i} "
                                 f"differs from the plain round")
        lanes = args[out_at].shape[1]
        held.append(lanes)
        if lanes not in kept:
            kept[lanes] = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
        return got

    kt.trop_count_round = holding
    try:
        res = trop_be.compute(topo, multipath_k=KP)
        torch.cuda.synchronize()
    finally:
        kt.trop_count_round = kernel
    for f in ("npaths", "nh_weights", "dist", "parent"):
        if not (getattr(res, f) == getattr(first, f)).all():
            raise SystemExit(f"trop_count_pair: {tree}: held compute's {f} differs")
    out["held"] = len(held)
    out["lanes_by_launch"] = held

    def device_events(fn, reps):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return prof

    def busy_ms(prof, reps, name=None):
        total = 0.0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                if name is None or name in e.key:
                    total += e.self_device_time_total / 1e3
        return total / reps

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

    # T2's launches of REPS computes, on the device, in launch order.
    prof = device_events(lambda: trop_be.compute(topo, multipath_k=KP), REPS)
    ev = sorted((e.time_range.start, e.time_range.elapsed_us() / 1e3) for e in prof.events()
                if e.device_type == DeviceType.CUDA and "trop_count" in e.name)
    per = len(ev) // REPS
    if per != len(held):
        raise SystemExit(f"trop_count_pair: {tree}: {per} T2 launches a compute under the "
                         f"profiler, {len(held)} held")
    launch_ms = [statistics.median(ms for _, ms in ev[i::per]) for i in range(per)]
    out["launch_device_ms"] = launch_ms
    out["compute_t2_device_ms"] = sum(launch_ms)
    for lanes in sorted(kept):
        ms = [t for t, w in zip(launch_ms, held) if w == lanes]
        args = kept[lanes]
        nb, _, b, _ = args[0].shape

        def alone(args=args):
            for _ in range(ALONE):
                kernel(*args)

        alone()
        row = {"launches": len(ms), "device_ms_median": statistics.median(ms),
               "device_ms": ms,
               "alone_events_ms": events_ms(alone, REPS) / ALONE,
               "alone_device_ms": busy_ms(device_events(alone, REPS), REPS * ALONE, "trop_count")}
        if with_list:
            cnt, cb = args[0], args[1]

            def lists(cnt=cnt, cb=cb):
                for _ in range(ALONE):
                    kt.count_list(cnt, cb)

            lists()
            row["list_events_ms"] = events_ms(lists, REPS) / ALONE
            row["list_device_ms"] = busy_ms(device_events(lists, REPS), REPS * ALONE)
            row["listed_slots"] = int(args[2].n.sum())
        if hasattr(kt, "count_geometry"):
            row["geometry"] = kt.count_geometry(b, lanes, nb)
        out[f"lanes_{lanes}"] = row

    # mp against mp_tropical compute(), in turns.
    backends = {"mp": mp_be, "mp_tropical": trop_be}
    mp_be.compute(topo, multipath_k=KP)
    wall = {e: [] for e in backends}
    for _ in range(REPS):
        for e, be in backends.items():
            t0 = time.perf_counter()
            be.compute(topo, multipath_k=KP)
            torch.cuda.synchronize()
            wall[e].append((time.perf_counter() - t0) * 1e3)
    out["compute"] = {e: {"wall_ms": statistics.median(v), "wall_all_ms": v,
                          "busy_ms": busy_ms(device_events(
                              lambda be=backends[e]: be.compute(topo, multipath_k=KP), REPS),
                              REPS)}
                      for e, v in wall.items()}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/trop_count_pair.json"))
    opts = ap.parse_args()
    if opts.one is not None:
        print(json.dumps(run_one(opts.one.resolve())), flush=True)
        return
    import torch

    if not opts.trees or not torch.cuda.is_available():
        raise SystemExit("trop_count_pair: needs one or more trees and a CUDA device")
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
            raise SystemExit(f"trop_count_pair: {spec} failed (rc {proc.returncode}):\n"
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
