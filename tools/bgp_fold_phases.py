#!/usr/bin/env python3
"""Where ``bgp_fold``'s time goes on one GPU: each warp role's cycles by phase.

    python3 tools/bgp_fold_phases.py [--out FILE]

Builds a copy of ``holo_tpu_torch/csrc/bgp_kernels.cu`` with ``clock64()``
counters added at the phase boundaries of each warp (the kernel source itself
carries none), into ``holo_tpu_torch/build/phases/``, and runs it at the
wrapper's geometry on the full table (524,288 x 64, synthesized as
chip_smoke's phase 3i does, ``default_rng(16)``) and at the UPDATE shape
(4,096 sorted rows of it).  It holds the outputs bit-identical to
``decide_plain``, then prints, for fold warps 0 and 1, derive warps 0 and 7
and the producer, the cycles a block spent in each phase (the mean over the
blocks) beside the launch's time by CUDA events, and writes them to FILE
(default ``chiprun_out/bgp_fold_phases.json``).  Phases, in order:

- producer: waiting for a free stage, then the whole warp's life (``total``);
- derive warps: waiting for a fold buffer, waiting for a tile, deriving and
  scanning it, then ``total``;
- fold warps: waiting for a derived group, the walk over the events, the
  multipath pass, waiting for the other lanes, writing the outputs, then
  ``total``.

The counters sit at phase boundaries only, so they cost a few instructions a
tile.  Without a GPU it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "holo_tpu_torch" / "csrc" / "bgp_kernels.cu"
BUILD = ROOT / "holo_tpu_torch" / "build" / "phases"
ROWS, COLS, NH_IDS, UPDATE_ROWS, SEED = 524_288, 64, 64, 4096, 16
SLOTS = 8  # counters a warp
ROLES = (("fold0", 0), ("fold1", 1), ("derive0", 4), ("derive7", 11), ("producer", 12))
PHASES = {
    "producer": ("wait_stage",),
    "derive": ("wait_buffer", "wait_tile", "derive"),
    "fold": ("wait_group", "walk", "multipath", "wait_lanes", "write"),
}

# (anchor in the kernel source, text put after it); each anchor must occur once.
PROBES = (
    ("namespace {\n", "__device__ unsigned long long g_phase[1024 * 16 * 8];\n"),
    ("  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n",
     "  unsigned long long T[8] = {};\n  long long ta = clock64();\n  const long long t0 = ta;\n"
     "#define TICK(n) do { const long long tb = clock64(); T[n] += tb - ta; ta = tb; } while (0)\n"
     "#define DUMP() do { T[7] = clock64() - t0; if (lane == 0 && blockIdx.x < 1024) "
     "for (int q_ = 0; q_ < 8; ++q_) g_phase[(blockIdx.x * 16 + warp) * 8 + q_] = T[q_]; "
     "} while (0)\n"),
    ("      const int s = seq % stages;\n", "      ta = clock64();\n"),
    ("      mbar_wait(&empty[s], ((seq / stages) & 1) ^ 1);\n", "      TICK(0);\n"),
    ("    if (!tma) asm volatile(\"cp.async.wait_all;\" ::: \"memory\");\n", "    DUMP();\n"),
    ("      const int fw = j % warps;\n", "      ta = clock64();\n"),
    ("      mbar_wait(&freed[fw], ((j / warps) & 1) ^ 1);\n", "      TICK(0);\n"),
    ("        const int seq = j * per_group + q, s = seq % stages;\n", "        ta = clock64();\n"),
    ("        mbar_wait(&full[s], (seq / stages) & 1);\n", "        TICK(1);\n"),
    ("        if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage\n",
     "        TICK(2);\n"),
    ("      if (lane == 0) mbar_arrive(&ready[fw]);\n    }\n", "    DUMP();\n"),
    ("    const int g0 = gi * gr, grows = min(gr, m - g0);\n    mbar_wait(&ready[warp], (j / warps) & 1);\n",
     "    TICK(0);\n"),
    ("      // Pass 2: multipath, the first max_paths equal peer columns in order,\n",
     "      if (lane == 0) TICK(1);\n"),
    ("      best_out[g0 + t] = best < 0 ? -1 : s_order[best];\n", "      if (lane == 0) TICK(2);\n"),
    ("    // The group's reasons, eligibility and selection, by column, in\n", "    TICK(3);\n"),
    ("    if (lane == 0) mbar_arrive(&freed[warp]);  // the derive warps may refill the buffer\n  }\n",
     "  DUMP();\n"),
)
READER = ('extern "C" int holo_bgp_fold_phases(void* host) {\n'
          '  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));\n}\n')


def instrumented() -> str:
    text = SRC.read_text()
    for anchor, probe in PROBES:
        if text.count(anchor) != 1:
            raise SystemExit(f"bgp_fold_phases: anchor not found once in {SRC.name}: {anchor!r}")
        text = text.replace(anchor, anchor + probe)
    # the fold warps' write phase ends where the group's buffer is freed
    text = text.replace(
        "    __syncwarp();\n    if (lane == 0) mbar_arrive(&freed[warp]);",
        "    __syncwarp();\n    TICK(4);\n    if (lane == 0) mbar_arrive(&freed[warp]);")
    return text + READER


def build() -> ctypes.CDLL:
    from holo_tpu_torch.kernels import build as kbuild

    BUILD.mkdir(parents=True, exist_ok=True)
    cu, so = BUILD / "bgp_phases.cu", BUILD / "bgp_phases.so"
    cu.write_text(instrumented())
    subprocess.run([kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.holo_bgp_fold.argtypes = kbuild.SIGNATURES["holo_bgp_fold"]
    lib.holo_bgp_fold_phases.argtypes = (ctypes.c_void_p,)
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/bgp_fold_phases.json"))
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bgp_fold_phases: needs a CUDA device")
    import chip_smoke
    from holo_tpu_torch.kernels import bgp as kb

    lib = build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    planes = torch.from_numpy(chip_smoke.bgp_full_planes(rng, ROWS, COLS, NH_IDS)).to(dev)
    nht_enc = chip_smoke.nbias(rng.integers(1, 65, size=NH_IDS, dtype=np.int64))
    nht_res = (rng.random(NH_IDS) < 0.9).astype(np.int32)
    nht_res[0] = 1
    vecs = (np.concatenate([np.arange(1, COLS), [0]]).astype(np.int32),
            np.arange(COLS, dtype=np.int32), (np.arange(COLS) != 0).astype(np.int32),
            nht_enc, nht_res, np.array([1, 2, 4], np.int32))
    args = [torch.from_numpy(v).to(dev) for v in vecs]
    sub = torch.from_numpy(np.sort(rng.choice(ROWS, size=UPDATE_ROWS, replace=False))
                           .astype(np.int32)).to(dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    report = {}
    for shape, idx in (("full", torch.arange(ROWS, dtype=torch.int32, device=dev)),
                       ("update", sub)):
        m = idx.shape[0]
        geo = kb.geometry(m, COLS, sms)
        out = (torch.empty(m, dtype=torch.int32, device=dev),
               torch.empty((m, COLS), dtype=torch.int32, device=dev),
               torch.empty((m, COLS), dtype=torch.bool, device=dev),
               torch.empty((m, COLS), dtype=torch.bool, device=dev))

        def launch():
            rc = lib.holo_bgp_fold(planes.data_ptr(), idx.data_ptr(),
                                   *[a.data_ptr() for a in args], *[o.data_ptr() for o in out],
                                   ROWS, COLS, m, NH_IDS, geo.group_rows, geo.tile_rows,
                                   geo.stages, geo.warps, geo.blocks, stream)
            if rc:
                raise SystemExit(f"bgp_fold_phases: CUDA error {rc} at launch")

        launch()
        torch.cuda.synchronize()
        for name, g, w in zip(("best_col", "reasons", "elig", "mp_sel"), out,
                              kb.decide_plain(planes, idx, *args)):
            if not torch.equal(g, w):
                raise SystemExit(f"bgp_fold_phases: {shape} {name} differs from decide_plain")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        buf = (ctypes.c_ulonglong * (1024 * 16 * SLOTS))()
        if lib.holo_bgp_fold_phases(buf):
            raise SystemExit("bgp_fold_phases: the counters could not be read")
        counts = np.frombuffer(buf, dtype=np.uint64).reshape(1024, 16, SLOTS)[:geo.blocks]
        roles = {}
        for role, warp in ROLES:
            if role.startswith("fold") and warp >= geo.warps:
                continue
            mean = counts[:, warp, :].astype(np.float64).mean(axis=0)
            names = PHASES[role.rstrip("0123456789")]
            roles[role] = {**{n: float(mean[q]) for q, n in enumerate(names)},
                           "total": float(mean[SLOTS - 1])}
        report[shape] = {"geometry": geo._asdict(), "ms": start.elapsed_time(end),
                         "cycles": roles}
        print(f"{shape} ({m} x {COLS}, {geo}): {report[shape]['ms']:.4f} ms by CUDA events, "
              "cycles a block:", flush=True)
        for role, phases in roles.items():
            print(f"  {role:9s} " + ", ".join(f"{n} {v:.0f}" for n, v in phases.items()),
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps({"card": smi, **report}, indent=1))


if __name__ == "__main__":
    main()
