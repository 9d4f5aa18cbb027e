#!/usr/bin/env python3
"""Time the port's ``bgp_fold`` of several trees of this repository on one GPU, in turns.

    python3 tools/bgp_fold_pair.py TREE [TREE ...] [--out FILE]

Each TREE is the root of a checkout; an earlier commit is unpacked with
``git archive`` into the gitignored ``.archive/``.  The trees run one process
each, in the order given (parent, change, change, parent for a paired
comparison).  A run imports its tree's ``holo_tpu_torch`` (which builds that
tree's kernels) and its ``chip_smoke.bgp_full_planes``, synthesizes the full
table as chip_smoke's phase 3i does (524,288 prefixes x 64 peers,
``default_rng(16)``), and at that shape and at the UPDATE shape (4,096 sorted
rows of it) holds the fold's four outputs bit-identical to ``fold_plain``
and times it: CUDA events (median of 9) and the profiler's device time of
the fold kernel alone (mean of 9).  It prints one JSON object a run, the
card's name and power limit, and writes them all to FILE (default
``chiprun_out/bgp_fold_pair.json``).  Without a GPU it exits 1.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPS = 9
SEED, ROWS, COLS, NH_IDS, UPDATE_ROWS = 16, 524_288, 64, 64, 4096


def events_ms(fn, reps: int) -> float:
    import torch

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


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of the bgp_fold kernel a call (profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and "bgp_fold" in e.key)
    if ms <= 0:
        raise SystemExit("bgp_fold_pair: the profiler saw no bgp_fold kernel")
    return ms / reps


def run_one(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bgp_fold_pair: needs a CUDA device")
    import chip_smoke
    from holo_tpu_torch.kernels import bgp as kb
    from holo_tpu_torch.ops import bgp_table as bt

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    planes_np = chip_smoke.bgp_full_planes(rng, ROWS, COLS, NH_IDS)
    nht_enc = chip_smoke.nbias(rng.integers(1, 65, size=NH_IDS, dtype=np.int64))
    nht_res = (rng.random(NH_IDS) < 0.9).astype(np.int32)
    nht_res[0] = 1
    vecs = (np.concatenate([np.arange(1, COLS), [0]]).astype(np.int32),
            np.arange(COLS, dtype=np.int32), (np.arange(COLS) != 0).astype(np.int32),
            nht_enc, nht_res, np.array([1, 2, 4], np.int32))
    args = [torch.from_numpy(v).to(dev) for v in vecs]
    planes = torch.from_numpy(planes_np).to(dev)
    sub = torch.from_numpy(np.sort(rng.choice(ROWS, size=UPDATE_ROWS, replace=False))
                           .astype(np.int32)).to(dev)
    del planes_np
    out = {"tree": str(tree), "source_bytes": (tree / "holo_tpu_torch" / "csrc" /
                                               "bgp_kernels.cu").stat().st_size}
    for shape, fold, plain in (
            ("full", lambda: bt.fold_planes(planes, *args), lambda: kb.fold_plain(planes, *args)),
            ("update", lambda: bt.decide(planes, sub, *args),
             lambda: kb.decide_plain(planes, sub, *args))):
        got, want = fold(), plain()
        torch.cuda.synchronize()
        for name, g, w in zip(("best_col", "reasons", "elig", "mp_sel"), got, want):
            if not torch.equal(g, w):
                raise SystemExit(f"bgp_fold_pair: {tree} {shape}: {name} differs from plain")
        del got, want
        out[f"{shape}_ms"] = events_ms(fold, REPS)
        out[f"{shape}_device_ms"] = device_ms(fold, REPS)
        if hasattr(kb, "geometry"):
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            m = ROWS if shape == "full" else UPDATE_ROWS
            out[f"{shape}_geometry"] = kb.geometry(m, COLS, sms)._asdict()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/bgp_fold_pair.json"))
    opts = ap.parse_args()
    if opts.one is not None:
        print(json.dumps(run_one(opts.one.resolve())), flush=True)
        return
    import torch

    if not opts.trees or not torch.cuda.is_available():
        raise SystemExit("bgp_fold_pair: needs one or more trees and a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    runs = []
    for tree in opts.trees:
        proc = subprocess.run([sys.executable, __file__, "--one", str(tree)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"bgp_fold_pair: {tree} failed (rc {proc.returncode}):\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(run)
        print(json.dumps(run), flush=True)
    print(smi, flush=True)
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps({"card": smi, "runs": runs}, indent=1))


if __name__ == "__main__":
    main()
