#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``holo_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's two engines on a k=90 fat tree (10,125 vertices, 729,000
directed edges), the headline what-if configuration of the repo
(BASELINE.json config 5): ``TorchSpfBackend(engine="blocked")`` and the
default ``TorchSpfBackend()`` (``engine="gather"``), each through
``compute_whatif`` over 1024 link-failure scenarios and ``compute``, the
gather engine also through ``compute_multiroot`` over 64 roots, DeltaPath:
a chain of eight topology events, each linked to the one before
(``Topology.link_delta``), through ``compute``, and multipath (max-paths 4
and 8: ECMP/UCMP parent sets, path counts, per-atom weights) through
``compute``, ``compute_whatif`` and the DeltaPath chain, and fast reroute
(``FrrEngine("torch").compute``: the all-roots distance matrix, one lane
per vertex, the per-link post-convergence batch and the LFA / remote-LFA /
TI-LFA tables); CSPF (``CspfEngine.compute``: 1024 traffic-engineering
requests as one masked batch, BASELINE.json config 4) on the same fat tree;
and partitioned SPF (``TorchSpfBackend(partition_threshold=1).compute``) on
a 100k-vertex multi-area LSDB (25 OSPF areas of 64 x 64 routers), with its
native area hint and with the flat cut, beside the monolithic ``compute()``,
and on a 10-area one at ``multipath_k`` 4 and 8 and through DeltaPath; and
the BGP table (``DecisionEngine`` on ``TorchBgpTableBackend()``: the RFC 4271
decision process over a 32,768-prefix x 16-peer feed, cold, an UPDATE burst
and next-hop churn; the fold alone over a full table of 524,288 prefixes x
64 peers); and the other single-path engines, ``TorchSpfBackend(one_engine=
"fused" | "packed" | "hybrid" | "tropical")``, and the engine tuner that picks
among them, through ``compute_whatif`` and ``compute`` on the fat tree (the
tropical engine also through ``compute_multiroot``, a masked ``compute`` and
the DeltaPath chain, and its multipath program through ``compute`` at
``multipath_k`` 4 and 8, masked, and the chain).  Phases:

1. build the CUDA kernels from ``holo_tpu_torch/csrc`` with nvcc;
2. run each kernel once on real mid-fixpoint inputs at the main paths'
   shapes -- 1024 scenarios (``compute_whatif``), one (``compute``) and,
   for the gather kernels, 64 roots (``compute_multiroot``) -- and hold
   each of its outputs bit-identical to its plain PyTorch version on the
   same CUDA tensors; run the relax-only path (``whatif_distances_blocked``)
   on the card and on the CPU (plain path) and hold them equal; hold every
   launch of one gather dispatch of the two frontier kernels (``ell_relax``,
   ``ell_nh_round``), and their full round (an all-ones frontier), to the
   plain full round at the three shapes and time each (CUDA events);
3. drive each engine's main path with its launch counters at 0, require
   every kernel of that path to have launched (and the blocked engine to
   have sent nothing to the gather engine), and hold scenarios 0-7,
   ``compute()`` and roots 0-7 bit-identical to the scalar oracle on every
   plane; require an empty ``compute_whatif`` / ``compute_multiroot`` on the
   card to return the empty result and launch no kernel;
3d. DeltaPath: after one warm ``compute``, drive the chain (cost raise and
   fall on a core-aggregation link, its removal and restoration, an overload
   strike of an aggregation switch, three cost changes) with the ELL launch
   counters at 0, require every step to take the incremental path with
   ``ell_relax``, ``ell_first_parent`` and ``ell_mp_round`` (the hops and
   next-hop recompute, one lane, no count or weight planes) launched, hold
   every ``ell_mp_round`` launch of the chain, as it runs, bit-identical to
   ``mp_round_plain`` (same frontier, same out buffer) and to the plain full
   round from the same in-state, and hold each step's four
   planes to the full path (``incremental=False``, a fresh clone) and steps
   0-1 to the scalar oracle; then require ``compute_whatif`` to rebuild after
   a structural delta and to apply a weight delta in place, equal to the full
   path both times;
3e. multipath: hold the two multipath kernels to their plain versions --
   every ``ell_mp_round`` launch of a 64-scenario dispatch and of a
   one-lane dispatch, the first two and the last of the 1024-scenario
   dispatch, each against its frontier bound, and the fused
   ``ell_parent_sets`` (first parent, DAG bits, parent sets) at 1, 64 and
   1024 lanes; time a first touch of fresh device memory -- then, with the
   ELL launch counters at 0, drive ``compute(multipath_k=4 and 8)`` (all
   nine planes equal to the port's multipath oracle),
   ``compute_whatif(multipath_k=4)`` over the 1024 scenarios (scenarios
   0-3 equal to the oracle, every scenario's single-path planes equal to
   the single-path batch) and the DeltaPath chain at ``multipath_k=4``
   (every step incremental and equal to a full multipath ``compute()`` of a
   clone, steps 0-1 also to the oracle), holding every launch of both
   kernels as it runs (``ell_mp_round`` to ``mp_round_plain`` with the same
   frontier and out buffer and to the plain full round, ``ell_parent_sets``
   to ``first_parent_plain`` plus ``parent_sets_plain``), and require both
   kernels launched on each path and ``ell_first_parent`` on none;
   ``multipath_k=1`` equals the single-path ``compute()``, its multipath
   fields None;
3f. fast reroute (root 6075): with the ELL launch counters at 0, a cold
   ``FrrEngine("torch").compute`` (every gather kernel but the multipath
   ones launched), then three warm ones timed per stage (``marshal_frr``,
   ``D``, the post batch, LFA + remote LFA, TI-LFA, readback) with the peak
   device memory; one more compute with every launch of the four gather
   kernels held bit-identical to its plain version on its own inputs (the
   six ``D`` launches at B = N lanes and every launch of the 48-lane post
   batch; the same launches as the cold compute's); a ``TorchSpfBackend``
   on the same topology served by the graph FRR marshaled (one shared
   cache per device); ``D``'s columns of eight roots equal to
   ``spf_reference``, the post planes of the first and last
   link equal to ``ScalarSpfBackend``, all seven tables equal to
   ``frr_select`` run on the host over the card's ``D`` and post planes; on
   a 1,000-vertex LAN topology every table plane equal to ``frr_reference``
   and ``resolve_backup`` equal on every (link, destination), with the
   policies off and with node protection + SRLG-disjointness; the graft
   entry on the card equal to the oracle;
3g. CSPF: 1024 requests drawn as ``bench.py``'s ``stage_cspf10k`` draws them
   (``default_rng(7)``: affinity from 8 bits, bandwidth 1..10, ``exclude_any``
   0..3, ``min_bandwidth`` below 2, random destinations); with the ELL
   counters at 0 a cold batch (G1-G4 must launch), requests 0-7 equal to
   ``spf_reference`` on their masks (cost and first-parent path), every G1-G4
   launch of one more batch held to its plain version, 3 warm batches timed;
3h. partitioned SPF on ``multiarea_topology(25, 64, 64, seed=3)`` (102,400
   vertices): the oracle, then the monolithic ``compute()`` and a partition-
   armed backend with the native hint and one with the flat cut (parts of at
   most 4096), each cold with the ELL counters at 0 (G1, G2 and M1 must
   launch, G3 and G4 not) and 3 warm, all equal to the oracle on the four
   planes, with each phase's time and rounds; every kernel launch of one
   more flat compute held to its plain version; the boundary solve's
   largest-frontier G1 launch timed against its bound; on
   ``multiarea_topology(10, 32, 32, seed=3)`` ``multipath_k`` 4 and 8 equal
   to the multipath oracle (all nine planes; M1-M3 launched and held, G2
   not launched) and a chain of six linked link-cost events (two on gateway
   links, which the cut cuts), every step served incrementally with fewer
   re-solved parts than the cut has, equal to a full partitioned solve
   (steps 0-1 also to the oracle);
3i. the BGP table: the feed of ``bench.py``'s ``stage_bgp_table`` parity
   gate (``default_rng(17)``) at its ``--small`` size (32,768 prefixes x 16
   peers, 314,401 routes, multipath eBGP 4 / iBGP 2), decided by the port's
   ``DecisionEngine`` on ``TorchBgpTableBackend()`` and with no backend (the
   oracle) with the ``bgp_fold`` count at 0 before it: cold, an UPDATE burst
   (1,024 prefixes re-announced with fresh attributes, noted) and NHT churn
   (``nexthop_update`` on two next hops, no scatter), each equal to the oracle
   (Loc-RIB: best route, next-hop set, every candidate's reasons and
   ``igp_cost``; the ibus stream), one launch a batch held bit-identical to
   ``decide_plain`` on its own inputs, every prefix of the batch decided on
   the card (the backend's ``served``), no fallback or poisoned prefix, both arms timed with the card arm's marshal and device batch; the
   full table synthesized at the lane level as the stage does
   (``default_rng(16)``, 1.745 GB on the card), ``bgp_fold``'s four outputs
   held bit-identical to ``fold_plain`` and timed (CUDA events, median of 5,
   and the profiler's device time) against its byte bound, with the launch
   geometry (tile rows, stages, blocks, shared bytes, copy path) printed for
   it, the update shape and each engine batch, the readback of the outputs
   timed; 40 UPDATE rounds
   (a 1,024-row ``scatter_rows`` + a 4,096-row ``decide``; p99 on the host
   clock) with the last decide held to ``decide_plain``; ``DeviceRankBackend``
   on 4,096 seeded tuples with duplicates equal to ``sorted()``;
3j. the engines: with the ELL launch counters at 0 before each, a cold and 3
   warm ``compute_whatif`` (1024 scenarios) and ``compute()`` of seq, fused,
   packed and hybrid, timed by the host clock and CUDA events; each engine's
   own kernels must launch (``ell_fused_round`` in the planar layout for
   fused, the interleaved for packed; ``ell_relax``, ``ell_first_parent``
   and ``ell_mp_round`` for hybrid) and ``ell_nh_seed`` / ``ell_nh_round``
   not; scenarios 0-7 and ``compute()`` equal to the oracle, all 1024
   scenarios to seq's planes; every ``ell_fused_round`` launch of a 64-, an
   8- and a one-lane ``fused_lanes`` dispatch, and the first and last at 1024
   lanes, held bit-identical to ``fused_round_plain`` in all four outputs
   (the new state, the parent, the changed flag and the frontier; each launch
   given its frontier and a clone of the carried parent), each 1024-lane
   launch timed against its frontier bound and the full round's, with its
   recomputed and copied (row, lane)s counted, the form, tiles a warp and
   registers of each shape printed, each dispatch equal to ``spf_lanes``; every
   G1, G2 and M1 launch of a 64-lane ``hybrid_lanes`` held, and the first
   and last M1 launch of a 1024-lane one (its G1 and G2 launches see the
   inputs of seq's, held in phase 2); ``max_iters`` 2
   and 5 on the card equal to the CPU path (16 scenarios and ``compute()``);
   the tuner armed (``explore_rounds=2``): 16 what-if batches and 16
   ``compute()`` calls, each equal to seq's planes, tropical run in both
   buckets, each bucket's picks,
   medians and winner printed, the saved table picked the same cold, and a
   DeltaPath chain after three re-marshals whose depth cap
   (``DeviceGraphCache._depth_cap``) is the tuned one;
3k. the tropical engine: the tile marshal (B, NB, Tm, tiles, MB, host ms);
   with the launch counts at 0 before each, ``TorchSpfBackend(one_engine=
   "tropical")``'s ``compute_whatif`` (1024 scenarios), ``compute()``,
   ``compute_multiroot`` (the 64 roots), a masked ``compute()`` (scenario 1's
   mask, one failed link) and the 8-step DeltaPath chain (seq's backend following it), each of
   which must launch ``trop_relax`` (T1; the what-if and the masked call its
   repair pass ``trop_repair`` too); every T1 call of the first call of each
   path and of chain step 0 held bit-identical to ``trop_relax_plain`` on
   its own inputs (distances, changed flag, next frontier; ``out``
   snapshotted before the launch and equal to ``dist`` outside the input
   frontier, the copy rule's precondition; the repair pairs' entries apart),
   timed and its work counted against its floor (``trop_work``, the copy
   rule's and the contract before it); T1's launch geometry (grid, threads,
   registers, shared memory, blocks an SM) for the tile and row forms and
   every B at 1024 lanes; every scenario
   and root equal to seq's planes, scenarios 0-7, ``compute()``, the masked
   ``compute()``, roots 0-7 and chain steps 0-1 to the oracle; every chain
   step incremental with its tile delta applied in place; warm what-if,
   ``compute()`` and multiroot of seq, fused and tropical timed in turns; T1's
   full round (every block active) at 1024 lanes against its bound; the repair
   set built on the card against the host's rows (phase 4: the lane program's
   device-busy time at 1024 lanes, ``compute()``'s, T1's device time at one
   lane);
3l. the tropical multipath program: with the launch counts at 0 before
   each, ``TorchSpfBackend(one_engine="tropical")``'s ``compute(topo,
   multipath_k=4)`` and ``=8``, a masked ``compute`` (scenario 1's mask,
   ``multipath_k=4``) and the 8-step DeltaPath chain at ``multipath_k=4``
   (seq's backend following it), each of which must launch ``trop_relax``
   and ``trop_count`` (T2; the masked call ``trop_repair`` too); every T2
   launch of each ``compute`` and of chain step 0 held bit-identical to
   ``trop_count_plain`` on its own inputs (out and the changed flag), and
   each of those dispatches' two count lists (one a fixpoint) to
   ``count_list`` on the CPU; all nine planes equal to seq's ``mp`` planes,
   the two computes and chain steps 0-1 to the multipath oracle; every chain
   step incremental on the tiles with its tile delta applied in place;
   ``mp`` and ``mp_tropical`` ``compute()`` timed in turns; T2 alone at one
   lane (the path counts) and at 64 (the weights) against its floor
   (``count_work``: the nonzero counts with an index each; the floor over
   every real tile's counts beside it), its plain version and a float64
   ``einsum`` of the same contraction, with its launch geometry and the
   count list's build time; an armed tuner's ``multipath_k=4`` bucket
   measuring both engines (phase 4: both computes' device-busy time, T2's
   and the list build's device time a launch and a dispatch);
3m. the dispatch pipeline (``holo_tpu_torch.pipeline``): through
   ``AsyncSpfBackend(TorchSpfBackend(), DispatchPipeline(depth=2))``, all
   submitted before any is forced, ``compute()``, ``compute(masks[1])``,
   ``compute(multipath_k=4)``, a tropical backend's ``compute()`` and
   ``compute(multipath_k=4)``, an ``AsyncFrrEngine(FrrEngine("torch"))`` table
   (root 6075) beside an SPF ticket of the same topology, then phase 3d's
   8-step chain interleaved with 8 linked toggles of agg(6,1)-core 45 on the
   tree rooted at edge(1, 0) (6120); each result bit-identical to the synchronous
   ``compute()`` of its input on another backend (so to the oracle where
   phase 3d holds it), the table to the synchronous table; G1-G4, M1-M3, T1
   and T2 launched through the pipeline; its stats: at most one entry in
   flight per key, no ticket failed, shed or abandoned, no respawn; both
   chains continued by toggles, 3 a chain a turn, interleaved through the
   pipeline against the same calls back to back, on the caller's thread and
   on a thread of their own, in turns (wall, overlap ratio, the worker's
   launch and finish an entry); ``launch_one`` / ``finish_one`` called directly on the full,
   masked, multipath, tropical and delta paths, held the same way, each
   phase timed (median of 5), beside the card's name and power limit;
3o. (run after phase 4's timings) the port's telemetry and runtime checks:
   compute(), compute(masks[1]), compute(multipath_k=4), the 1024-lane
   what-if on seq and tropical, the 64-root multi-root, FRR (root 6075), a
   1024-request CSPF batch, the partitioned 10k LSDB, a BGP table's cold
   batch and UPDATE burst, phase 3d's chain and its pipelined twin, each
   with profiling armed and disarmed: bit-identical, equal launches, each
   (site, stage) observed once a call, each device stage's CUDA-event time
   at most its dispatch's wall, no event while disarmed; the overhead in 5
   alternating turns; every path again under the transfer sanitizer with
   no unsanctioned sync, and the flag reads a compute() per engine; the
   residency rows against independent sums; the chains under the donation
   guard and a seeded stale read caught; a torch.profiler trace with the
   spf.one stage ranges and a gather kernel; all beside the card's name
   and power limit;
3p. (after 3o) the dispatch analytics over 3o's twelve paths, each one
   causal event from ``convergence.begin`` to ``fib_commit``: disarmed,
   then with the flight recorder, the convergence tracker, the observatory
   (the card's peaks), the critical-path ledger and the SLO engine armed:
   bit-identical, equal launches; the observatory's observations equal to
   the stage observations made; each bucket's roofline row (its work-tally
   cost entry, device p50, achieved op/s and bytes/s and their shares of
   the peaks, none above 1.05, the verdict); each path's critical-path
   verdict and phases; the watchdog's budget per site from its p99; the
   overhead on ``compute()`` and the 1024-lane what-if in alternating
   turns; the SLO report and the flight ring; all beside the card's name
   and power limit;
3q. (after 3p) the kernel-contract audit (HL301-HL305) on the card: (a)
   every registered dispatch program (33) run once on its seeded audit
   specs under the dispatch recorder with the transfer sanitizer armed at
   "error", its findings and seconds; (b) the main-path seams at full
   width on the k=90 inputs -- ``spf.one`` on each of the four lane
   engines, the what-if at 1024 lanes, the delta scatter of the chain's
   first event and the incremental SPF after it -- their value and index
   lanes and sanctioned windows; (c) the CPU's audit of the same registry
   in this process, whose kernels and findings must equal the card's; no
   error-tier finding, value lanes only int32 and bool, beside the card's
   name and power limit;
4. time each kernel (CUDA events; at one scenario also the profiler's
   device time, which leaves out the host's launch), its plain version, the
   whole batch, ``compute()`` and the gather batch's stages, and DeltaPath's
   delta-linked ``compute()`` against a re-marshal and a cached call, with
   the host's delta lowering and scatter against the incremental SPF's
   device time, beside the card's name and power limit; the FRR compute's
   device-busy share, the CSPF batch and the 100k partitioned and monolithic
   computes with their device-busy shares, ``bgp_fold``'s device time at the
   update shape; then require that no breaker of the run (every SPF backend,
   FRR engine and BGP backend) counted a failure, a fallback or a refusal.

Every failure raises, so the exit code is not 0.  Without a CUDA device, or
without the rest of the repository beside it, the script fails before it
prints any result.  The last line is the device summary as JSON.
"""

from __future__ import annotations

import contextlib
import copy
import json
import statistics
from collections import Counter
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

K = 90  # fat-tree radix: 10,125 vertices
BATCH = 1024  # what-if scenarios
MASK_SEED = 1
ORACLE_SCENARIOS = 8
K1_SCENARIOS = 4
KERNEL_REPS = 10
BATCH_REPS = 3
COMPUTE_REPS = 5
# H100 SXM peaks: HBM 3.35 TB/s; int32 132 SMs x 64 INT32 lanes (Hopper
# white paper) x 1.98 GHz x 2, an add+min pair counting as two operations
# of one fused instruction (DPX VIADDMNMX, counted in the built library in
# phase 1), as an FMA counts as two.
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9 * 2
# int32 operations each kernel needs, counted over the nonzero weight
# entries and, where the work depends on the data, over this run's DAG
# (entry, scenario) pairs -- those where the source is reached and the edge
# is tight (du < CAP and w + du == dv), counted by dag_pairs:
# relax: add, min per (entry, lane).
# dmin_parent: the DAG test per (entry, scenario) -- add, tight test,
#   reached test -- and, per DAG pair, the lexicographic update of (best
#   distance, best id): compare, select the distance, min of the id.
# nh_or: the DAG test per (entry, scenario) -- add, tight, reached, gate --
#   and, per DAG pair whose source passes the gate, an OR per word.
RELAX_OPS = 2
DMIN_PARENT_TEST_OPS, DMIN_PARENT_UPDATE_OPS = 3, 3
NH_OR_TEST_OPS, NH_OR_WORD_OPS = 4, 1
DAG_CHUNK = 1 << 16  # edges per step of dag_pairs
DEVICE = torch.device("cuda")
SOURCE = "holo_tpu_torch/csrc/blocked_kernels.cu"
REPLACES = {
    "relax": "holo_tpu/ops/blocked_spf.py:281 and holo_tpu/ops/blocked.py:118",
    "dmin_parent": "holo_tpu/ops/blocked_spf.py:295 and holo_tpu/ops/blocked_spf.py:312",
    "nh_or": "holo_tpu/ops/blocked_spf.py:337",
}
MULTIROOT = 64  # roots of compute_multiroot, drawn from ROOT_SEED
ROOT_SEED = 2
ORACLE_ROOTS = 8
ELL_SOURCE = "holo_tpu_torch/csrc/ell_kernels.cu"
# The gather kernels stand for XLA loop fusions of holo_tpu's spf_one; the
# JAX package has no Pallas kernel on that path.
ELL_REPLACES = {
    "ell_relax": "holo_tpu/ops/spf_engine.py:860-866 (XLA fusion, no Pallas kernel)",
    "ell_first_parent": "holo_tpu/ops/spf_engine.py:872-894 (XLA fusion, no Pallas kernel)",
    "ell_nh_seed": "holo_tpu/ops/spf_engine.py:976-991 (XLA fusion, no Pallas kernel)",
    "ell_nh_round": "holo_tpu/ops/spf_engine.py:993-1005 (XLA fusion, no Pallas kernel)",
}
# int32 operations of the gather kernels, counted over the usable (slot,
# lane) pairs -- a valid slot whose edge is up in the lane -- and, where the
# work depends on the data, over this run's DAG pairs (source reached, edge
# tight, destination reached and not the lane's root):
# ell_relax: the gather of the source's distance, add, min per active pair
#   (usable, and the source changed in that lane in the previous round: the
#   launch's frontier).
# ell_first_parent: the DAG test per usable pair (add, tight, reached) and,
#   per DAG pair, the lexicographic update (compare, select, min).
# ell_nh_seed (from the DAG bits): per (slot, tile) whose DAG word is not 0
#   an AND (the lanes whose source has hops 0) and an ANDN (the inherit
#   word), and an OR per word per DAG pair whose source has hops 0.
# ell_nh_round: a gather and an OR per word per active inherit pair (inherit
#   bit set, source changed), and per (vertex, word, lane) the OR into the old
#   word and the changed test.
# A frontier launch's gathers read at least one 32-byte sector of the source's
# plane row per active (slot, lane word): a word of 32 lanes whose source
# changed in some lane where the slot is usable (and, per next-hop word, for
# ell_nh_round).
ELL_RELAX_OPS = 3
ELL_TEST_OPS, ELL_UPDATE_OPS = 3, 3
ELL_SPLIT_OPS = 2
ELL_ROUND_OPS = 2
ELL_GATHER_OPS = 2  # ell_nh_round per word per active pair: gather, OR
SECTOR_BYTES = 32
INF = 1 << 30
# The main launch of each frontier kernel: ell_relax's third round, ell_nh_round's
# second (the first of each gathers from almost no changed source).
MID_RELAX, MID_ROUND = 2, 1
DELTA_TOGGLES = 9  # delta-linked compute() calls timed, each toggling one link's cost
REMARSHAL_REPS = 3
WHATIF_AFTER_DELTA = 64  # scenarios of the what-if after each kind of delta
# Multipath (phase 3e): the widths of the compute() checks and of the batch
# and chain, the lanes of the fully held dispatch, the oracle's scenarios.
MP_KS = (4, 8)
MP_K = 4
MP_HOLD_LANES = 64
MP_ORACLE_SCENARIOS = 4
MP_ORACLE_STEPS = 2
MP_SOURCE = "holo_tpu_torch/csrc/mp_kernels.cu"
MP_REPLACES = {
    "ell_mp_round": "holo_tpu/ops/spf_engine.py:1246-1324 _mp_fixpoint "
                    "(XLA fusion, no Pallas kernel)",
    "ell_parent_sets": "holo_tpu/ops/spf_engine.py:1327-1372 _mp_parent_sets and, on the "
                       "multipath paths, :872-894 _sp_dag + _first_parent "
                       "(XLA fusions, no Pallas kernel)",
    "ell_parent_weights": "holo_tpu/ops/spf_engine.py:1361-1366 pweight of _mp_parent_sets "
                          "(XLA fusion, no Pallas kernel)",
}
# int32 operations of the multipath kernels:
# ell_mp_round: per DAG pair an add per atom lane (A), an OR per next-hop
#   word (W), the path-count add and the hops-0 test; per (vertex, lane) a
#   clamp and a changed test per atom and per count, a changed test per
#   word, and the hops update (parent gather, add, select, test).
# ell_parent_sets: per usable pair the DAG and admissibility tests (add,
#   tight test, downward test, INF test), per DAG pair the (dist, id)
#   argmin update (compare, select, min) and per admissible pair an offer to
#   the sorted set (a source and a (cost, source) compare per entry).
MP_PAIR_OPS = 2  # + A + W
MP_CELL_OPS = 4  # + 2 A + W
PS_TEST_OPS = 4
PS_OFFER_OPS = 2  # x kp
# Fast reroute (phase 3f): the warm computes timed, the policy of the main
# path, the LAN topology of the whole-table check and its SRLG seed.
FRR_WARM_REPS = 3
FRR_CFG = dict(enabled=True, remote_lfa=True, ti_lfa=True)
FRR_POLICIES = ({}, {"node_protection": True, "srlg_disjoint": True})
FRR_LAN = dict(n_routers=800, n_networks=200, extra_p2p=1600, seed=23)
FRR_SRLG_SEED = 5
FRR_STAGES = ("marshal_ms", "d_ms", "post_ms", "lfa_rlfa_ms", "tilfa_ms", "readback_ms")
# CSPF (phase 3g): TE requests drawn as bench.py's stage_cspf10k draws them
# (BASELINE.json config 4), the requests held to the oracle, the warm runs.
CSPF_BATCH = 1024
CSPF_SEED = 7
CSPF_ORACLE = 8
CSPF_WARM_REPS = 3
# Partitioned SPF (phase 3h): the multi-area LSDBs (bench.py's multiarea_100k
# and multiarea_10k), the flat cut's part size, the warm runs, the multipath
# widths and the delta chain at 10k.
PART_100K = dict(n_areas=25, rows=64, cols=64, seed=3)
PART_10K = dict(n_areas=10, rows=32, cols=32, seed=3)
PART_MAX_PART = 4096
PART_WARM_REPS = 3
PART_MP_KS = (4, 8)
PART_PHASES = ("bdist_ms", "stitch_ms", "dist_ms", "exchange_ms", "assemble_ms")
# BGP table (phase 3i): the engine feed of bench.py's stage_bgp_table at its
# --small size (:3335, the parity feed of :3340-3388 from default_rng(17)),
# the UPDATE burst and the next hops of the NHT churn, the full table folded
# alone (:3430-3470, default_rng(16)), the UPDATE rounds (:3496-3518) and the
# rank tuples.
BGP_AFS = "ipv4-unicast"
BGP_PREFIXES, BGP_PEERS = 32_768, 16
BGP_MP = {"enabled": True, "ebgp_max": 4, "ibgp_max": 2, "allow_multiple_as": True}
BGP_FEED_SEED = 17
BGP_BURST, BGP_BURST_SEED = 1024, 18
BGP_CHURN = (("9.9.1.1", 40), ("9.9.5.1", 7))  # a metric change; an unresolved hop resolves
BGP_FULL_ROWS, BGP_FULL_COLS, BGP_NH_IDS = 524_288, 64, 64
BGP_PLANE_SEED = 16
BGP_UPDATE_ROWS, BGP_RADIUS, BGP_ROUNDS, BGP_ROUNDS_DROPPED = 1024, 4096, 40, 2
BGP_FOLD_REPS = 5
BGP_RANK_N, BGP_RANK_SEED = 4096, 19
BGP_SOURCE = "holo_tpu_torch/csrc/bgp_kernels.cu"
BGP_REPLACES = ("holo_tpu/ops/bgp_table.py:294-415 _fold_planes through :423-426 _decide_fn "
                "(XLA fusion, no Pallas kernel)")
# int32 operations bgp_fold does for every cell whatever the data, from the
# derive warps' step (csrc/bgp_kernels.cu): the next-hop clamp's min and max,
# the four tests of eligibility and the IGP select.  The (LP, L1) scan, the
# ladder and the multipath test are left out, so the count is a floor.
BGP_CELL_OPS = 7
# The other single-path engines (phase 3j): their names, the warm calls
# timed, the lanes of the fully held fused dispatches, the truncations and
# the scenarios run there on the card and the CPU, the tuner arm's calls and
# the re-marshals that feed its depth cap.
ENGINE_NAMES = ("fused", "packed", "hybrid")
ENGINE_WARM_REPS = 3
FUSED_HOLD_LANES = 64
ENGINE_LIMITS = (2, 5)
ENGINE_LIMIT_SCENARIOS = 16
TUNER_CALLS = 16  # five engines, each explored twice after its unsampled first use
TUNER_REMARSHALS = 3
FUSED_SOURCE = "holo_tpu_torch/csrc/fused_kernels.cu"
FUSED_REPLACES = ("holo_tpu/ops/spf_engine.py:1071-1106 round_fn of spf_one_fused, planar "
                  "(fused) and interleaved (packed) (XLA fusion, no Pallas kernel)")
# int32 operations of ell_fused_round: per usable (slot, lane) pair with the
# source reached the add, the INF test and the min; per DAG pair the (dist,
# src) argmin update (compare, select, min) and an OR per word; per (vertex,
# lane) the hops update (root test, parent test, add, select), the changed
# tests of dist and hops and one per word.
FUSED_PAIR_OPS = 3
FUSED_DAG_OPS = 3  # + W
FUSED_CELL_OPS = 6  # + W
# The tropical engine (phase 3k): the warm calls timed; T1's source, the
# loop body it stands for, and its operations: an add and a min per (tile
# entry, lane) of an active source block; per repair (slot, lane) the add,
# the INF test and the min.
TROP_WARM_REPS = 3
TROP_SOURCE = "holo_tpu_torch/csrc/tropical_kernels.cu"
TROP_REPLACES = ("holo_tpu/ops/tropical.py:423-464, the body of _tile_relax's loop "
                 "(XLA fusion, no Pallas kernel)")
TROP_REPAIR_REPLACES = ("holo_tpu/ops/tropical.py:445-457, the repair rows of _tile_relax's "
                        "loop body (XLA fusion, no Pallas kernel)")
TROP_TILE_OPS = 2
TROP_REPAIR_OPS = 3
# The tropical multipath program (phase 3l): T2's loop bodies, and its
# operations: a multiply and an add per (nonzero count entry of a real slot,
# lane), and per output entry the seed add, the clamp and the changed test.
TROP_COUNT_REPLACES = ("holo_tpu/ops/tropical.py:559-572 and :608-623, the bodies of "
                       "_np_tile_fixpoint's and _aw_tile_fixpoint's loops (XLA int32 einsum, no "
                       "Pallas kernel)")
TROP_COUNT_OPS = 2
TROP_COUNT_CELL_OPS = 3
TROP_MP_TUNER_CALLS = 8  # mp and mp_tropical, each explored twice after its unsampled first use
# The dispatch pipeline (phase 3m): the second chain's root (edge(1, 0), the
# first chain's edge(0, 0) in the next pod), the direct launch/finish calls
# timed per path, the interleaved turns (a turn: this many toggles per chain),
# how long a forced ticket may take.
PIPE_ROOT2 = (K // 2) ** 2 + K * (K // 2) + K // 2
PIPE_REPS = 5
PIPE_TURN_STEPS = 3
PIPE_WAIT_S = 120.0


def cuda_call(fn):
    """(result, device milliseconds) of one call of ``fn``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, reps: int) -> float:
    """Median device milliseconds of ``fn`` over ``reps`` runs."""
    return statistics.median(cuda_call(fn)[1] for _ in range(reps))


def host_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def nbytes(*tensors) -> int:
    """Bytes of the distinct tensors (each read or written once)."""
    seen = {}
    for t in tensors:
        seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def fused_minadd_count(lib_path: Path, nvcc: str) -> int:
    """VIADDMNMX (DPX add+min) instructions in the built library's SASS."""
    sass = subprocess.run(
        [str(Path(nvcc).with_name("cuobjdump")), "-sass", str(lib_path)],
        capture_output=True, text=True, check=True,
    ).stdout
    return sass.count("VIADDMNMX")


def bound(op_count: int, byte_count: int) -> tuple[float, str]:
    ops_ms = op_count / INT32_OPS_S * 1e3
    bytes_ms = byte_count / HBM_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def device_times(fn) -> dict:
    """Device milliseconds of each kernel ``fn`` runs, by name
    (torch.profiler, CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def device_busy(fn) -> tuple[float, list]:
    """Device milliseconds of every kernel ``fn`` runs, and the five
    largest by name."""
    per_op = sorted(device_times(fn).items(), key=lambda kv: -kv[1])
    top = [(name[:60], round(ms, 3)) for name, ms in per_op[:5]]
    return sum(ms for _, ms in per_op), top


def device_ms_per_call(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn`` (profiler, launch excluded)."""
    busy_ms, _ = device_busy(lambda: [fn() for _ in range(reps)])
    return busy_ms / reps


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def stage_inputs(blk, bspf, g, fdst, fid) -> dict:
    """Real kernel inputs: the planes each stage of the main path hands
    its kernel, mid-fixpoint for relax and nh_or."""
    npad = g.in_src.shape[0]
    x = {"dist_mid": blk.distance_fixpoint(g, g.rootp, fdst, fid, limit=2)}
    x["dist"] = blk.distance_fixpoint(g, g.rootp, fdst, fid, limit=npad)
    _, parent_o = bspf.first_parent(g, x["dist"], fdst, fid)
    hops = bspf.hops_fixpoint(g, parent_o, npad)
    x["gate"] = (hops > 0).to(torch.int32)
    x["direct"] = bspf.direct_words(g, x["dist"], hops, fid)
    x["nh"] = bspf.nexthop_fixpoint(g, x["dist"], hops, x["direct"], fdst, fid, limit=1)
    return x


def dag_pairs(blk, g, dist, gate) -> tuple[int, int]:
    """(DAG pairs, DAG pairs whose source passes ``gate``) over the CSC
    entries and the scenarios of ``dist`` [N_pad, B]: the (entry,
    scenario) pairs on which dmin_parent and nh_or do their updates."""
    s = blk.S
    per_col = (g.cptr[:, 1:] - g.cptr[:, :-1]).reshape(-1).long()
    col = torch.repeat_interleave(torch.arange(per_col.numel(), device=dist.device), per_col)
    pair = col // s
    u = g.bsrc.long()[pair] * s + g.crow.long()
    v = g.bdst.long()[pair] * s + col % s
    dag = dag_gated = 0
    for e0 in range(0, u.numel(), DAG_CHUNK):
        ue, ve = u[e0 : e0 + DAG_CHUNK], v[e0 : e0 + DAG_CHUNK]
        du = dist[ue]
        tight = (du < blk.CAP) & (g.cw[e0 : e0 + DAG_CHUNK, None] + du == dist[ve])
        dag += int(tight.sum())
        dag_gated += int((tight & (gate[ue] > 0)).sum())
    return dag, dag_gated


def plain_dmin_parent(kernels, pl, dist, orig_id):
    """dmin_parent's plain version: K3, then K4 fed K3's own output (not
    the corrected dmin that first_parent returns)."""
    dmin = kernels.dmin_plain(*pl, dist)
    return dmin, kernels.parent_plain(*pl, dist, dmin, orig_id)


def kernel_calls(kernels, blk, g, x, nnz: int) -> dict:
    """name -> (kernel call, plain call, operations, bytes) on inputs ``x``.

    A kernel needs only the nonzero weights: an int32 value and an int32
    index each (the dense planes are mostly CAP filler); each vertex plane
    is read once and the output written once.
    """
    pl = (g.w, g.bsrc, g.bdst)
    edges = blk.edges_of(g)
    wbytes = nnz * 8
    batch = x["dist"].shape[1]
    words = x["direct"].shape[1] // batch
    dist, dist_mid = x["dist"], x["dist_mid"]
    gate, nh, direct = x["gate"], x["nh"], x["direct"]
    dag, dag_gated = dag_pairs(blk, g, dist, gate)
    print(f"DAG pairs at B={batch}: {dag} of {nnz * batch} (entry, scenario) pairs "
          f"({dag / (nnz * batch):.4f}), {dag_gated} past the gate", flush=True)
    dp_ops = DMIN_PARENT_TEST_OPS * nnz * batch + DMIN_PARENT_UPDATE_OPS * dag
    nh_ops = NH_OR_TEST_OPS * nnz * batch + NH_OR_WORD_OPS * words * dag_gated
    return {
        "relax": (
            lambda: kernels.relax(*pl, g.seg, dist_mid, edges=edges),
            lambda: kernels.relax_plain(*pl, dist_mid),
            RELAX_OPS * nnz * batch,
            wbytes + nbytes(dist_mid) + dist_mid.numel() * 4,
        ),
        "dmin_parent": (
            lambda: kernels.dmin_parent(*pl, g.seg, dist, g.orig_id, edges=edges),
            lambda: plain_dmin_parent(kernels, pl, dist, g.orig_id),
            dp_ops,
            wbytes + nbytes(dist, g.orig_id) + 2 * dist.numel() * 4,
        ),
        "nh_or": (
            lambda: kernels.nh_or(*pl, g.seg, dist, gate, nh, direct, edges=edges),
            lambda: kernels.nh_or_plain(*pl, dist, gate, nh, direct),
            nh_ops,
            wbytes + nbytes(dist, gate, nh, direct) + direct.numel() * 4,
        ),
    }


def hold_to_plain(calls: dict, label: str) -> dict:
    """Run each kernel and its plain version once on the same tensors and
    require equal bits: name -> row of max_abs_err, plain_ms, bound."""
    rows = {}
    for name, (card, plain, op_count, byte_count) in calls.items():
        got = card()
        torch.cuda.synchronize()
        ref, plain_ms = cuda_call(plain)
        gots, refs = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
        err = 0
        for i, (a, b) in enumerate(zip(gots, refs)):
            require(a.shape == b.shape and a.dtype == b.dtype,
                    f"{name} {label} output {i} shape/dtype")
            e = int((a.long() - b.long()).abs().max())
            same = torch.equal(a, b)
            print(f"kernel {name} {label}: output {i} {tuple(a.shape)} bit-identical to "
                  f"plain: {same} (max_abs_err {e})", flush=True)
            require(same, f"{name} output {i} disagrees with its plain version {label}")
            err = max(err, e)
        b_ms, b_by = bound(op_count, byte_count)
        rows[name] = {"max_abs_err": err, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "ops": op_count, "bytes": byte_count}
        del got, ref, gots, refs, a, b
    return rows


def ell_inputs(ell, se, g, roots, mask) -> tuple:
    """(planes, x): one gather dispatch on the card with every input its
    kernels got: x["relax"] / x["round"] list the (plane, frontier) input of
    each ell_relax / ell_nh_round launch (the last one reported no change),
    x["relax_mid"] / x["round_mid"] the main ones (third relax launch,
    second next-hop launch)."""
    p = se.lane_planes(g, mask)
    n = g.in_src.shape[0]
    dist, front = se.distance_seed(n, roots)
    x = {"relax": []}
    while True:
        x["relax"].append((dist, front))
        dist, changed, front = ell.ell_relax(*p, dist, front)
        if not bool(changed):
            break
    x["dist"] = dist
    parent, x["dag"] = ell.ell_first_parent(*p, dist, roots)
    x["hops"] = se.hops_fixpoint(g, parent, roots, n)
    x["hop0"] = ell.pack_lane_bits(x["hops"] == 0)
    nh, x["inherit"] = ell.ell_nh_seed(p.src, x["dag"], x["hop0"], g.direct_nh_words,
                                       roots.shape[0])
    front = se.nexthop_frontier(nh)
    x["round"] = []
    while True:
        x["round"].append((nh, front))
        nh, changed, front = ell.ell_nh_round(p.src, x["inherit"], nh, front)
        if not bool(changed):
            break
    x["relax_mid"] = x["relax"][min(MID_RELAX, len(x["relax"]) - 1)]
    x["round_mid"] = x["round"][min(MID_ROUND, len(x["round"]) - 1)]
    return p, x


def popcount(words: torch.Tensor) -> int:
    """Set bits in an int32 tensor."""
    x = words.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return int((((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum())


def frontier_work(p, bits: torch.Tensor, front: torch.Tensor) -> tuple[int, int, int]:
    """(active pairs, loaded words, active words) of one frontier launch: the
    (slot, lane) pairs whose ``bits`` word (mask [E, words] by edge, or
    inherit [N, K, words] by slot; None: every lane) and the source's
    frontier bit are set, the (valid slot, tile) words it must load, those
    whose source's frontier word is not 0, and the (slot, lane word) pairs
    holding an active pair, each of which gathers a sector of the source's
    row."""
    valid = p.slot >= 0
    f = front[p.src.long()]  # [N, K, words]
    if bits is None:
        act = f
    elif bits.dim() == 2:
        act = f & bits[p.slot.clamp_min(0).long()]
    else:
        act = f & bits
    act = torch.where(valid[:, :, None], act, 0)
    return (popcount(act), int(((f != 0) & valid[:, :, None]).sum()),
            int((act != 0).sum()))


def launch_bound(p, x, kind: str, plane, front) -> tuple[float, str, int, int]:
    """(bound ms, by, operations, bytes) of one frontier launch on ``plane``
    (dist [N, B] or next hops [N, W, B]) with ``front``: the slot planes,
    the frontier in and out, the plane in and out, the mask (inherit) words
    of the slots whose source changed in some lane of the tile, and the
    gathers, a sector per active (slot, lane word) (per next-hop word);
    operations per active pair (relax: gather, add, min; next hops: a
    gather and an OR per word) and, for next hops, the OR into the old word
    and its test."""
    fbytes = 2 * front.numel() * 4
    if kind == "ell_relax":
        act, loads, act_words = frontier_work(p, p.mask, front)
        ops = ELL_RELAX_OPS * act
        byte_count = nbytes(p.src, p.cost, p.slot) + fbytes + 2 * plane.numel() * 4
        byte_count += (0 if p.mask is None else 4 * loads) + SECTOR_BYTES * act_words
    else:
        act, loads, act_words = frontier_work(p, x["inherit"], front)
        words = plane.shape[1]
        ops = ELL_GATHER_OPS * words * act + ELL_ROUND_OPS * plane.numel()
        byte_count = (nbytes(p.src) + fbytes + 2 * plane.numel() * 4 + 4 * loads
                      + SECTOR_BYTES * words * act_words)
    return (*bound(ops, byte_count), ops, byte_count)


def frontier_launch(ell, p, x, kind: str):
    """(kernel call, plain call) of one ell_relax / ell_nh_round launch on
    (plane, frontier)."""
    if kind == "ell_relax":
        return (lambda d, f: ell.ell_relax(*p, d, f),
                lambda d, f: ell.relax_plain(*p, d, f))
    return (lambda h, f: ell.ell_nh_round(p.src, x["inherit"], h, f),
            lambda h, f: ell.nh_round_plain(p.src, x["inherit"], h, f))


# The frontier kernels: their launches' inputs in ell_inputs' x, and the main one.
FRONTIER_KERNELS = {"ell_relax": ("relax", "relax_mid"), "ell_nh_round": ("round", "round_mid")}


def hold_rounds(ell, p, x, label: str) -> dict:
    """Every launch of the dispatch, and the full round (an all-ones
    frontier on the main input), of ell_relax and ell_nh_round: each output
    (out, changed, frontier_out) held bit-identical to the plain full round
    on the same input, then timed (CUDA events) beside its bound.  name ->
    row of per-round ms and bounds, dispatch sums and the full round."""
    rows = {}
    for kind, (key, mid_key) in FRONTIER_KERNELS.items():
        card, plain = frontier_launch(ell, p, x, kind)
        plane_mid, front_mid = x[mid_key]
        full = (plane_mid, ell.full_frontier(front_mid.shape[0], plane_mid.shape[-1],
                                             front_mid.device))
        timed = []
        for i, (plane, front) in enumerate([*x[key], full]):
            what = f"round {i + 1}" if i < len(x[key]) else "full round"
            got = card(plane, front)
            torch.cuda.synchronize()
            for j, (a, b) in enumerate(zip(got, plain(plane, front))):
                require(torch.equal(a, b),
                        f"{kind} {what} output {j} disagrees with its plain version {label}")
            timed.append((cuda_ms(lambda: card(plane, front), KERNEL_REPS),
                          launch_bound(p, x, kind, plane, front)[0]))
        (full_ms, full_bound), timed = timed[-1], timed[:-1]
        row = {"round_ms": [t for t, _ in timed], "round_bound_ms": [b for _, b in timed],
               "full_round_ms": full_ms, "full_round_bound_ms": full_bound}
        row["dispatch_ms"] = sum(row["round_ms"])
        row["dispatch_bound_ms"] = sum(row["round_bound_ms"])
        print(f"rounds {kind} {label}: every launch's out, changed and frontier_out "
              f"bit-identical to the plain full round; ms per round "
              f"{[round(t, 4) for t in row['round_ms']]} (bounds "
              f"{[round(t, 5) for t in row['round_bound_ms']]}), dispatch "
              f"{row['dispatch_ms']:.4f} ms (bound {row['dispatch_bound_ms']:.5f}), full "
              f"round {full_ms:.4f} ms (bound {full_bound:.5f})", flush=True)
        rows[kind] = row
    return rows


def seed_work(p, x) -> tuple[int, int, int, int]:
    """(DAG pairs, nonzero DAG words, DAG pairs whose source has hops 0,
    slots holding such a pair) of the DAG bits x["dag"] [N, K, words]."""
    direct_bits = x["dag"] & x["hop0"][p.src.long()]
    return (popcount(x["dag"]), int((x["dag"] != 0).sum()), popcount(direct_bits),
            int((direct_bits != 0).any(2).sum()))


def ell_calls(ell, g, p, x, roots, failed: int, label: str) -> dict:
    """name -> (kernel call, plain call, operations, bytes) on inputs ``x``;
    ``failed`` = (valid slot, lane) pairs whose edge is down.  The frontier
    kernels run their main launch with its real frontier."""
    n, lanes = x["dist"].shape
    d = g.direct_nh_words
    words = d.shape[2]
    usable = int((p.slot >= 0).sum()) * lanes - failed
    dag, dag_words, direct, direct_slots = seed_work(p, x)
    print(f"gather pairs {label}: {usable} usable (slot, lane) pairs, {dag} DAG pairs "
          f"({dag / max(usable, 1):.4f}) in {dag_words} nonzero DAG words, {direct} with "
          f"a hops-0 source in {direct_slots} slots", flush=True)
    planes = nbytes(p.src, p.cost, p.slot, *([] if p.mask is None else [p.mask]))
    plane = n * lanes * 4
    bits = x["dag"].numel() * 4  # the DAG bits, and the inherit bits, [N, K, words]
    seed_in = (p.src, x["dag"], x["hop0"], d, lanes)
    calls = {
        "ell_first_parent": (
            lambda: ell.ell_first_parent(*p, x["dist"], roots),
            lambda: ell.first_parent_plain(*p, x["dist"], roots),
            ELL_TEST_OPS * usable + ELL_UPDATE_OPS * dag,
            planes + nbytes(x["dist"], roots) + plane + bits,
        ),
        "ell_nh_seed": (
            lambda: ell.ell_nh_seed(*seed_in),
            lambda: ell.nh_seed_plain(*seed_in),
            ELL_SPLIT_OPS * dag_words + words * direct,
            nbytes(p.src, x["dag"], x["hop0"]) + 4 * words * direct_slots + words * plane
            + bits,
        ),
    }
    for kind, (_, mid_key) in FRONTIER_KERNELS.items():
        card, plain = frontier_launch(ell, p, x, kind)
        plane_in, front = x[mid_key]
        _, _, ops, byte_count = launch_bound(p, x, kind, plane_in, front)
        calls[kind] = (lambda c=card, a=plane_in, f=front: c(a, f),
                       lambda c=plain, a=plane_in, f=front: c(a, f), ops, byte_count)
    return {k: calls[k] for k in ELL_REPLACES}


def link_ids(topo, a: int, b: int) -> tuple[int, int]:
    """Edge ids of a -> b and b -> a."""
    fwd = np.nonzero((topo.edge_src == a) & (topo.edge_dst == b))[0]
    rev = np.nonzero((topo.edge_src == b) & (topo.edge_dst == a))[0]
    require(fwd.size == 1 and rev.size == 1, f"link {a}-{b} is not one edge each way")
    return int(fwd[0]), int(rev[0])


def linked(graph, base, nxt, delta=None):
    """``nxt`` with DeltaPath lineage from ``base``."""
    d = graph.diff_topologies(base, nxt) if delta is None else delta
    require(d is not None, "a chain step is not delta-representable")
    nxt.link_delta(d)
    return nxt


def set_link_cost(graph, synth, topo, a: int, b: int, cost: int):
    """A linked clone of ``topo`` whose a-b link costs ``cost`` both ways."""
    f, r = link_ids(topo, a, b)
    return linked(graph, topo, synth.clone_topology(topo, cost={f: cost, r: cost}))


def delta_chain(graph, synth, topo, k: int) -> list:
    """[(event, topology linked to the one before)]: the DeltaPath chain on
    the fat tree of radix ``k``."""
    half = k // 2
    n_core = half * half

    def agg(p, i):
        return n_core + p * half + i

    def edge(p, i):
        return n_core + k * half + p * half + i

    chain = []
    cur = topo
    a, c = agg(3, 0), 0  # agg(3, 0) <-> core 0
    f, r = link_ids(cur, a, c)
    old = [(int(cur.edge_cost[e]), int(cur.edge_direct_atom[e])) for e in (f, r)]
    cur = set_link_cost(graph, synth, cur, a, c, old[0][0] + 4)
    chain.append(("cost raise agg(3,0)-core 0", cur))
    cur = set_link_cost(graph, synth, cur, a, c, 1)
    chain.append(("cost fall agg(3,0)-core 0", cur))
    f, r = link_ids(cur, a, c)
    keep = np.ones(cur.n_edges, bool)
    keep[[f, r]] = False
    cur = linked(graph, cur, synth.clone_topology(cur, keep=keep))
    chain.append(("link removal agg(3,0)-core 0", cur))
    cur = linked(graph, cur, synth.clone_topology(
        cur, extra=[[a, c, 1, old[0][1]], [c, a, 1, old[1][1]]]))
    chain.append(("link restored agg(3,0)-core 0", cur))
    v = agg(5, 0)
    struck = synth.clone_topology(cur, keep=cur.edge_src != v)
    cur = linked(graph, cur, struck, graph.TopologyDelta(
        base_key=cur.cache_key, overload=np.int32([v]), ids_stable=False))
    chain.append(("overload agg(5,0)", cur))
    for label, (x, y, cost) in (("agg(7,1)-edge(7,3)", (agg(7, 1), edge(7, 3), 9)),
                                (f"agg(10,4)-core {4 * half + 2}", (agg(10, 4), 4 * half + 2, 6)),
                                ("agg(0,5)-edge(0,0)", (agg(0, 5), edge(0, 0), 4))):
        cur = set_link_cost(graph, synth, cur, x, y, cost)
        chain.append((f"cost change {label}", cur))
    return chain


def toggles(graph, synth, topo, k: int, count: int) -> list:
    """``count`` topologies, each linked to the one before (the first to
    ``topo``), toggling one core-aggregation link's cost between 7 and 2."""
    a, c = k * k // 4 + 6 * (k // 2) + 1, k // 2  # agg(6, 1) <-> core k/2
    out, cur = [], topo
    for _ in range(count):
        cost = 2 if int(cur.edge_cost[link_ids(cur, a, c)[0]]) == 7 else 7
        cur = set_link_cost(graph, synth, cur, a, c, cost)
        out.append(cur)
    return out


def same_planes(got, want) -> bool:
    return all(np.array_equal(getattr(got, f), getattr(want, f))
               for f in ("dist", "parent", "hops", "nexthop_words"))


MP_FIELDS = ("parents", "pdist", "pweight", "npaths", "nh_weights")


def same_nine(got, want) -> bool:
    """All nine SpfResult planes equal (the multipath fields present)."""
    return same_planes(got, want) and all(
        getattr(got, f) is not None and np.array_equal(getattr(got, f), getattr(want, f))
        for f in MP_FIELDS)


def held(name: str, label: str, got, want) -> int:
    """Require each output of a kernel call bit-identical to its plain
    version's; the max_abs_err over them."""
    err = 0
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None and b is None:
            continue
        require(a.shape == b.shape and a.dtype == b.dtype, f"{name} {label} output {i} shape")
        err = max(err, int((a.long() - b.long()).abs().max()))
        require(torch.equal(a, b), f"{name} {label} output {i} disagrees with its plain version")
    return err


def _clone(planes):
    return tuple(None if x is None else x.clone() for x in planes)


class Holder:
    """Within ``holding()``, every launch of the two multipath kernels runs
    (and counts) as before and is held at once on its own inputs: each
    ell_mp_round launch's out buffer, changed flag and frontier_out
    bit-identical to both mp_round_plain (same frontier, a copy of the out
    buffer as it was before the launch) and the plain full round from the
    same in-state; each fused ell_parent_sets launch to first_parent_plain
    plus parent_sets_plain's parents and pdist; each ell_parent_weights
    launch to parent_weights_plain.  The plain calls launch no kernel.
    ``full_round=False`` skips the full round: the partitioned fixpoint's
    pinned halo rows keep their values where a full round recomputes them.
    ``ends_only`` holds only the first ell_mp_round launch of the block and
    those that report no change (a fixpoint's last)."""

    def __init__(self, ell, full_round: bool = True, ends_only: bool = False):
        self.ell = ell
        self.full_round, self.ends_only = full_round, ends_only
        self.err = {"ell_mp_round": 0, "ell_parent_sets": 0, "ell_parent_weights": 0}
        self.held = Counter()
        self.mp_launches = 0
        self.lanes = Counter()  # (kernel, lanes, with counts) -> launches

    def mp_round(self, fn):
        ell = self.ell

        def held_round(src, dag, direct, inc, roots, parent, state, front, out):
            fixed = (src, dag, direct, inc, roots, parent)
            want = _clone(out)
            res = fn(*fixed, state, front, out)
            self.mp_launches += 1
            if self.ends_only and self.mp_launches > 1 and bool(res[0]):
                return res
            ref = ell.mp_round_plain(*fixed, state, front, want)
            label = f"launch {self.mp_launches}"
            got = (*out, *res)
            self.err["ell_mp_round"] = max(self.err["ell_mp_round"],
                                           held("ell_mp_round", label, got, (*want, *ref)))
            if self.full_round:
                full = ell.mp_round_full(*fixed, state)
                self.err["ell_mp_round"] = max(
                    self.err["ell_mp_round"],
                    held("ell_mp_round", f"{label} (full round)", got, full))
            self.held["ell_mp_round"] += 1
            self.lanes[("ell_mp_round", state[0].shape[1], state[2] is not None)] += 1
            return res

        return held_round

    def parent_sets(self, fn):
        ell = self.ell

        def held_sets(src, cost, slot, mask, dist, roots, kp):
            got = fn(src, cost, slot, mask, dist, roots, kp)
            zero = torch.zeros_like(dist)
            want = (*ell.first_parent_plain(src, cost, slot, mask, dist, roots),
                    *ell.parent_sets_plain(src, cost, slot, mask, dist, zero, roots, kp)[:2])
            self.err["ell_parent_sets"] = max(
                self.err["ell_parent_sets"],
                held("ell_parent_sets", f"launch {self.held['ell_parent_sets'] + 1}", got, want))
            self.held["ell_parent_sets"] += 1
            self.lanes[("ell_parent_sets", dist.shape[1], kp)] += 1
            return got

        return held_sets

    def parent_weights(self, fn):
        ell = self.ell

        def held_weights(parents, npaths):
            got = fn(parents, npaths)
            self.err["ell_parent_weights"] = max(
                self.err["ell_parent_weights"],
                held("ell_parent_weights", f"launch {self.held['ell_parent_weights'] + 1}",
                     (got,), (ell.parent_weights_plain(parents, npaths),)))
            self.held["ell_parent_weights"] += 1
            return got

        return held_weights


@contextlib.contextmanager
def holding(ell, holder: Holder):
    """Hold every multipath kernel launch within the block (Holder)."""
    fns = ell.ell_mp_round, ell.ell_parent_sets, ell.ell_parent_weights
    ell.ell_mp_round = holder.mp_round(fns[0])
    ell.ell_parent_sets = holder.parent_sets(fns[1])
    ell.ell_parent_weights = holder.parent_weights(fns[2])
    try:
        yield holder
    finally:
        ell.ell_mp_round, ell.ell_parent_sets, ell.ell_parent_weights = fns


# The gather kernels (G1-G4) and their plain versions, which take the same
# arguments.
GATHER_PLAIN = {"ell_relax": "relax_plain", "ell_first_parent": "first_parent_plain",
                "ell_nh_seed": "nh_seed_plain", "ell_nh_round": "nh_round_plain"}


class GatherHolder:
    """Within ``holding_gather()``, every launch of the four gather kernels
    runs (and counts) as before and is held at once bit-identical to its
    plain version on the same inputs (none of them writes an input).
    ``err``: kernel -> max_abs_err; ``lanes``: (kernel, lanes) -> held
    launches.  The plain calls launch no kernel."""

    def __init__(self):
        self.err = {name: 0 for name in GATHER_PLAIN}
        self.lanes = Counter()

    def held_count(self, name: str) -> int:
        return sum(c for (k, _), c in self.lanes.items() if k == name)


@contextlib.contextmanager
def holding_gather(ell, holder: GatherHolder):
    """Hold every gather kernel launch within the block (GatherHolder)."""
    fns = {name: getattr(ell, name) for name in GATHER_PLAIN}

    def wrap(name, fn, plain):
        def held_launch(*args):
            got = fn(*args)
            lanes = got[0].shape[-1]
            label = f"at {lanes} lanes, launch {holder.held_count(name) + 1}"
            holder.err[name] = max(holder.err[name], held(name, label, got, plain(*args)))
            holder.lanes[(name, lanes)] += 1
            return got
        return held_launch

    for name, fn in fns.items():
        setattr(ell, name, wrap(name, fn, getattr(ell, GATHER_PLAIN[name])))
    try:
        yield holder
    finally:
        for name, fn in fns.items():
            setattr(ell, name, fn)


def gathered_sources(ell, src, use) -> torch.Tensor:
    """bool [N, B]: the (source, lane) entries that some slot of ``use``
    (DAG bits of the recomputed lanes, [N, K, words]) gathers."""
    n, k = src.shape
    lanes = use.shape[2] * 32
    out = torch.zeros((n, lanes), dtype=torch.bool, device=src.device)
    flat = src.reshape(-1).long()
    for sl in ell.lane_chunks(n, k, lanes):
        hits = torch.zeros((n, sl.stop - sl.start), dtype=torch.int32, device=src.device)
        hits.index_put_((flat,), ell._unpack(use, sl).reshape(n * k, -1).to(torch.int32),
                        accumulate=True)
        out[:, sl] = hits > 0
    return out


def mp_launch_bound(ell, fixed, state, front) -> dict:
    """The bound of one ell_mp_round launch by what its frontier leaves it,
    and its work: the slot and DAG-bit planes, the frontier plane in and
    out, and the (vertex, lane) entries of the four state planes it must
    read (the recomputed and copied entries and the sources the recomputed
    ones gather, each once) and write (the recomputed and copied ones),
    the parents of the recomputed entries, the direct words of the slots
    with a hops-0 source and, in the tile form, the plan of each (row,
    tile); operations per gathered DAG pair A + W + 2 and per recomputed
    entry 2 A + W + 4."""
    src, dag = fixed[0], fixed[1]
    n, k = src.shape
    hops, nh, npaths, aw = state
    lanes = hops.shape[1]
    words, atoms = nh.shape[1], (0 if aw is None else aw.shape[1])
    entry = 4 * (1 + words + (0 if npaths is None else 1 + atoms))
    rec, copy = ell.mp_row_frontier(src, dag, front)
    use = dag & rec[:, None, :]
    pairs = popcount(use)
    use0 = use & ell.pack_lane_bits(hops == 0)[src.long()]
    n_rec, n_copy = popcount(rec), popcount(copy)
    touched = ell._unpack(rec | copy, slice(0, lanes)) | gathered_sources(ell, src, use)[:, :lanes]
    reads = int(touched.sum())
    byte_count = (nbytes(src, dag) + 2 * front.numel() * 4 + reads * entry
                  + (n_rec + n_copy) * entry + 4 * n_rec
                  + 4 * words * int((use0 != 0).any(2).sum()))
    if lanes > ell.SMALL:  # the tile form's plan, written and read: 8 bytes a (row, tile)
        byte_count += 16 * front.numel()
    ops = pairs * (atoms + words + MP_PAIR_OPS) + n_rec * (2 * atoms + words + MP_CELL_OPS)
    ms, by = bound(ops, byte_count)
    return {"bound_ms": ms, "bound_by": by, "ops": ops, "bytes": byte_count,
            "recomputed": n_rec, "copied": n_copy, "pairs": pairs}


def mp_dispatch(ell, se, g, roots, mask, kp: int, hold_all: bool, label: str) -> dict:
    """One multipath dispatch on the card, step by step as ``se.mp_lanes``
    runs it: the fused ell_parent_sets (width ``kp``) held to
    first_parent_plain plus parent_sets_plain, then each ell_mp_round
    launch timed (CUDA events), measured against its frontier bound and
    held bit-identical to mp_round_plain (same frontier and out buffer) and
    to the plain full round (every launch with ``hold_all``, else the first
    two and the last), then the parent weights held to parent_sets_plain's
    pweight.  Returns the inputs, per-launch times, bounds and errors."""
    n = g.in_src.shape[0]
    p = se.lane_planes(g, mask)
    dist = se.distance_fixpoint(p, roots, n)
    ps_in = (*p, dist, roots, kp)
    (parent, dag, parents, pdist), ps_ms = cuda_call(lambda: ell.ell_parent_sets(*ps_in))
    want = (*ell.first_parent_plain(*p, dist, roots),
            *ell.parent_sets_plain(*p, dist, torch.zeros_like(dist), roots, kp)[:2])
    x = {"p": p, "dist": dist, "ps_in": ps_in, "ps_first_ms": ps_ms,
         "ps_err": held("ell_parent_sets", f"{label} kp={kp}", (parent, dag, parents, pdist),
                        want)}
    del want
    x["ps_plain_ms"] = cuda_call(lambda: ell.first_parent_sets_plain(*ps_in))[1]
    fixed = (p.src, dag, g.direct_nh_words, g.is_router.to(torch.int32), roots, parent)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (state, before, front), start_ms = cuda_call(
        lambda: se.mp_start(n, g.direct_nh_words.shape[2], roots))
    x.update(fixed=fixed, start_ms=start_ms, start_host_ms=(time.perf_counter() - t0) * 1e3,
             round_ms=[], plain_ms=[], err=0, held=[], work=[], dag_pairs=popcount(dag))
    x["full_bound"] = full_round_bound(fixed, state, x["dag_pairs"])
    r = 0
    while True:
        saved = _clone(before)  # the out buffer before the launch
        x["work"].append(mp_launch_bound(ell, fixed, state, front))
        (changed, front_out), ms = cuda_call(
            lambda: ell.ell_mp_round(*fixed, state, front, before))
        x["round_ms"].append(ms)
        last = not bool(changed)
        if hold_all or r < 2 or last:
            ref, plain_ms = cuda_call(lambda: ell.mp_round_plain(*fixed, state, front, saved))
            full = ell.mp_round_full(*fixed, state)
            got = (*before, changed, front_out)
            x["err"] = max(x["err"], held("ell_mp_round", f"{label} launch {r + 1}", got,
                                          (*saved, *ref)),
                           held("ell_mp_round", f"{label} launch {r + 1} (full round)", got,
                                full))
            x["plain_ms"].append(plain_ms)
            x["held"].append(r + 1)
            del ref, full
        del saved
        state, before, front = before, state, front_out
        r += 1
        if last:
            break
    x["npaths"] = state[2]
    del state, before
    pw_in = (parents, x["npaths"])
    pweight, x["pw_ms"] = cuda_call(lambda: ell.ell_parent_weights(*pw_in))
    x["pw_in"] = pw_in
    ref = ell.parent_sets_plain(*p, dist, x["npaths"], roots, kp)[2:]
    x["pw_err"] = max(held("ell_parent_weights", label, (pweight,), ref),
                      held("ell_parent_weights", f"{label} (plain)", (pweight,),
                           (ell.parent_weights_plain(*pw_in),)))
    x["pw_plain_ms"] = cuda_call(lambda: ell.parent_weights_plain(*pw_in))[1]
    del ref
    print(f"kernel ell_parent_sets {label} kp={kp}: parent, DAG bits, parents, pdist "
          f"bit-identical to first_parent_plain + parent_sets_plain, pweight to "
          f"parent_sets_plain ({ps_ms:.3f} ms first launch, ell_parent_weights "
          f"{x['pw_ms']:.3f} ms)", flush=True)
    print(f"kernel ell_mp_round {label}: launches {x['held']} of {r} bit-identical to "
          f"mp_round_plain and the full round (max_abs_err {x['err']}); {x['dag_pairs']} DAG "
          f"pairs; ms per launch {[round(t, 4) for t in x['round_ms']]}; frontier bounds "
          f"{[round(w['bound_ms'], 4) for w in x['work']]}; recomputed entries "
          f"{[w['recomputed'] for w in x['work']]}, copied "
          f"{[w['copied'] for w in x['work']]}, gathered DAG pairs "
          f"{[w['pairs'] for w in x['work']]}; mp_start {start_ms:.3f} ms "
          f"({x['start_host_ms']:.3f} host)", flush=True)
    return x


def full_round_bound(fixed, state, dag_pairs: int) -> tuple[float, str, int, int]:
    """The bound of a full round (every entry recomputed): the fixed planes
    and the four state planes read once and written once; operations per
    DAG pair and per entry."""
    hops, nh, npaths, aw = state
    n, lanes = hops.shape
    words = nh.shape[1]
    atoms = 32 * words
    mp_ops = (dag_pairs * (atoms + words + MP_PAIR_OPS)
              + n * lanes * (2 * atoms + words + MP_CELL_OPS))
    mp_bytes = nbytes(*fixed) + 2 * nbytes(hops, nh, npaths, aw)
    return (*bound(mp_ops, mp_bytes), mp_ops, mp_bytes)


def admissible_pairs(ell, p, dist, roots) -> int:
    """(slot, lane) pairs that ell_parent_sets offers to a set: usable,
    source reached, v reached and not the lane's root, and tight or
    strictly downward."""
    n, k = p.src.shape
    count = 0
    for sl in ell.lane_chunks(n, k, dist.shape[1]):
        d_nbr = dist[:, sl][p.src.long()]
        dv = dist[:, sl][:, None, :]
        live = (dv < ell.INF) & (torch.arange(n, device=dist.device)[:, None, None]
                                 != roots[sl][None, None, :])
        ok = ell._usable(p.slot, p.mask, sl) & (d_nbr < ell.INF) & live
        count += int((ok & ((d_nbr + p.cost[:, :, None] == dv) | (d_nbr < dv))).sum())
    return count


def parent_sets_bound(ell, x, kp: int, usable: int) -> dict:
    """Bounds of the fused ell_parent_sets and of ell_parent_weights on the
    dispatch ``x``.  ell_parent_sets reads the slot planes, mask words,
    dist and roots and writes the first parent, the DAG bits and the
    parents and pdist planes; operations: the DAG and admissibility tests
    per usable pair, the argmin update per DAG pair, an offer per admissible
    pair.  ell_parent_weights reads the parents and npaths and writes
    pweight (an operation a entry: the select past the set)."""
    p, dist = x["p"], x["dist"]
    n, lanes = dist.shape
    roots, dag = x["fixed"][4], x["fixed"][1]
    adm = admissible_pairs(ell, p, dist, roots)
    ops = (PS_TEST_OPS * usable + ELL_UPDATE_OPS * x["dag_pairs"]
           + PS_OFFER_OPS * kp * adm)
    byte_count = (nbytes(p.src, p.cost, p.slot, *([] if p.mask is None else [p.mask]))
                  + nbytes(dist, roots) + n * lanes * 4 + dag.numel() * 4
                  + 2 * n * kp * lanes * 4)
    pw_bytes = nbytes(*x["pw_in"]) + n * kp * lanes * 4
    return {"ell_parent_sets": (*bound(ops, byte_count), ops, byte_count),
            "ell_parent_weights": (*bound(n * kp * lanes, pw_bytes), n * kp * lanes, pw_bytes),
            "admissible": adm}


@contextlib.contextmanager
def keeping_relax(ell, kept: list):
    """Within the block every ell_relax launch runs (and counts) as before,
    and its (plane, frontier) input is appended to ``kept``."""
    fn = ell.ell_relax

    def keep(src, cost, slot, mask, dist, frontier):
        kept.append((dist, frontier))
        return fn(src, cost, slot, mask, dist, frontier)

    ell.ell_relax = keep
    try:
        yield kept
    finally:
        ell.ell_relax = fn


def frr_phase(ell, se, dev, topo) -> dict:
    """Phase 3f: (a) a cold and warm FrrEngine("torch").compute at k=90 with
    the ELL counts at 0, stage times and peak memory; (b) every G1-G4 launch
    of one more compute held, the graph shared with an SPF backend, D's
    columns, the post planes and the tables held; (c) the
    whole table on a LAN topology against the oracle, both policies; (d) the
    graft entry on the card against the oracle."""
    from holo_tpu_torch import graft_entry
    from holo_tpu_torch.frr import kernel as fk
    from holo_tpu_torch.frr.manager import FrrConfig, FrrEngine, resolve_backup
    from holo_tpu_torch.frr.scalar import frr_reference
    from holo_tpu_torch.spf.backend import ScalarSpfBackend, TorchSpfBackend
    from holo_tpu_torch.spf.scalar import spf_reference
    from holo_tpu_torch.spf.synth import random_ospf_topology

    def same_table(got, want) -> bool:
        """All seven BackupTable planes equal, dtypes included."""
        return all(getattr(got, f).dtype == getattr(want, f).dtype
                   and np.array_equal(getattr(got, f), getattr(want, f))
                   for f in fk.TABLE_PLANES)

    t_phase = time.perf_counter()
    x = {}
    n, root = topo.n_vertices, int(topo.root)
    # (a) the main path, counted: one cold compute (graph marshal included:
    # the device's shared graph cache is emptied first).
    se.shared_graph_cache(dev).clear()
    fe = FrrEngine("torch")
    require(fe.device.type == "cuda", "FrrEngine('torch') does not run on the card")
    fe.set_policy(FrrConfig(**FRR_CFG))
    fe.stats = {}
    torch.cuda.synchronize()
    ell.reset_launches()
    t0 = time.perf_counter()
    table = fe.compute(topo)
    torch.cuda.synchronize()
    x["cold_ms"] = (time.perf_counter() - t0) * 1e3
    x["launches"] = dict(ell.launches)
    x["cold_stats"] = dict(fe.stats)
    print(f"FRR path launches: {x['launches']}", flush=True)
    for name in ("ell_relax", "ell_first_parent", "ell_nh_seed", "ell_nh_round"):
        require(x["launches"][name] > 0, f"kernel {name} never launched on the FRR path")
    require(fe.dispatches == Counter({"device": 1}) and fe.graph_cache["miss"] == 1,
            f"the cold FRR compute was not one device dispatch: {dict(fe.dispatches)}")
    require(table.lfa_adj.shape == (table.inputs.n_links, n)
            and table.post_nh.shape[:2] == (table.inputs.n_links, n), "FRR table shapes")
    warm = []
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(FRR_WARM_REPS):
        t0 = time.perf_counter()
        again = fe.compute(topo)
        torch.cuda.synchronize()
        warm.append(((time.perf_counter() - t0) * 1e3, dict(fe.stats)))
        require(same_table(again, table), "a warm FRR compute differs from the cold one")
    x["peak_mb"] = (torch.cuda.max_memory_allocated() - mem0) / 2**20
    x["warm_ms"] = statistics.median(ms for ms, _ in warm)
    x["warm_all_ms"] = [ms for ms, _ in warm]
    x["stages"] = {k: statistics.median(st[k] for _, st in warm)
                   for k in (*FRR_STAGES, "d_launches", "tilfa_rounds")}
    require(fe.graph_cache["hit"] == FRR_WARM_REPS, "a warm FRR compute re-marshaled the graph")
    x["engine"] = fe

    # (b) exactness at k=90: every gather kernel launch of one more compute
    # (the cold one's launches: the counts must match) held to its plain
    # version on its own inputs, D's rows, the post planes, the tables
    # against frr_select on the host.
    t0 = time.perf_counter()
    hold = GatherHolder()
    with holding_gather(ell, hold):
        require(same_table(fe.compute(topo), table), "the held FRR compute differs")
    torch.cuda.synchronize()
    for name in GATHER_PLAIN:
        require(hold.held_count(name) == x["launches"][name],
                f"{name}: {hold.held_count(name)} launches held, the cold compute made "
                f"{x['launches'][name]}")
    fin = table.inputs
    lp = fin.edge_masks.shape[0]
    require(set(hold.lanes) == {("ell_relax", n), *((k, lp) for k in GATHER_PLAIN)},
            f"the held FRR launches ran at other widths: {dict(hold.lanes)}")
    x["held_err"] = hold.err
    print(f"FRR held compute: every gather kernel launch bit-identical to its plain version "
          f"on its own inputs, (kernel, lanes) -> launches {dict(hold.lanes)}, max_abs_err "
          f"{hold.err} ({time.perf_counter() - t0:.1f} s)", flush=True)
    # One graph per device: SPF on the topology FRR marshaled finds it.
    g, how = se.shared_graph_cache(dev).get(topo, max(64, topo.n_atoms()), need_edge_ids=True)
    require(how == "hit", "the FRR graph left the shared cache")
    sbe = TorchSpfBackend(device=dev)
    t0 = time.perf_counter()
    spf_after = sbe.compute(topo)
    spf_after_ms = (time.perf_counter() - t0) * 1e3
    require(same_planes(spf_after, ScalarSpfBackend().compute(topo)),
            "SPF after FRR differs from the oracle")
    require(sbe._gather_cache.lookups == Counter({"hit": 1}),
            f"SPF after FRR re-marshaled the graph: {dict(sbe._gather_cache.lookups)}")
    print(f"shared graph cache: a TorchSpfBackend's first compute() on the FRR topology hit "
          f"its graph ({spf_after_ms:.3f} ms; no second marshal and no second copy of the "
          f"{nbytes(*g) / 2**20:.1f} MiB of ELL planes on the card)", flush=True)
    kept = []
    with keeping_relax(ell, kept):
        D = fk.all_roots(g)
    torch.cuda.synchronize()
    x["d_rounds"] = len(kept)
    x["d_ms"] = cuda_ms(lambda: fk.all_roots(g), FRR_WARM_REPS)
    p = se.lane_planes(g, None)
    fronts = [popcount(f) for _, f in kept]
    main = max(range(len(kept)), key=fronts.__getitem__)
    x["d_main"] = main + 1
    x["d_fronts"] = fronts
    x["d_main_ms"] = cuda_ms(lambda: ell.ell_relax(*p, *kept[main]), KERNEL_REPS)
    x["d_main_bound"] = launch_bound(p, None, "ell_relax", *kept[main])
    del kept
    print(f"FRR D dispatch: {x['d_rounds']} ell_relax launches at B={n} lanes, frontier "
          f"bits by launch {fronts}; launch {main + 1} has the largest frontier", flush=True)
    roots = [root, *map(int, fin.link_far[:3]), *map(int, fin.adj_nbr[:2]), 0, n - 1]
    d_host = D.cpu().numpy()
    for r in roots:
        t = copy.copy(topo)
        t.root = r
        require(np.array_equal(d_host[:, r], spf_reference(t).dist),
                f"D's column of root {r} differs from spf_reference")
    oracle = ScalarSpfBackend()
    post_links = (0, fin.n_links - 1)
    for link in post_links:
        ref = oracle.compute(topo, fin.edge_masks[link])
        require(np.array_equal(table.post_dist[link], ref.dist)
                and np.array_equal(table.post_nh[link], ref.nexthop_words),
                f"the post planes of link {link} differ from ScalarSpfBackend")
    post = se.spf_whatif_batch(g, root, fin.edge_masks)
    post_host = se.SpfTensors(*(t.cpu() for t in post))
    sel = fk.frr_select(torch.from_numpy(d_host), post_host, root, g.is_router.cpu(),
                        fin.link_far, fin.link_cost, fin.link_valid, fin.adj_nbr, fin.adj_cost,
                        fin.adj_link, fin.adj_valid, *fe._policy_args(fin))
    require(same_table(fk.backup_table(sel, fin, root, n), table),
            "the card's FRR tables differ from frr_select on the host over its D and post planes")
    del d_host, post_host, sel
    # The selection stages alone on the card, for phase 4's timing.
    sel_args = (D, post, root, g.is_router, fin.link_far, fin.link_cost, fin.link_valid,
                fin.adj_nbr, fin.adj_cost, fin.adj_link, fin.adj_valid, *fe._policy_args(fin))
    x["select"] = lambda: fk.frr_select(*sel_args)
    kinds = {"lfa": int((table.lfa_adj >= 0).sum()), "rlfa": int((table.rlfa_pq >= 0).sum()),
             "tilfa": int((table.tilfa_p >= 0).sum())}
    x["coverage"] = table.coverage()
    print(f"FRR k={K}: D roots {roots} equal spf_reference; post planes of links "
          f"{list(post_links)} equal ScalarSpfBackend; all seven tables equal frr_select "
          f"on the host over the card's D and post planes; {fin.n_links} links, {fin.n_adj} "
          f"candidates, entries {kinds}, coverage {x['coverage']:.4f}", flush=True)

    # (c) the whole table on a LAN topology, both policies, against the oracle.
    t0 = time.perf_counter()
    lan = random_ospf_topology(**FRR_LAN)
    lan.edge_srlg = np.random.default_rng(FRR_SRLG_SEED).integers(
        0, 8, lan.n_edges).astype(np.uint32)
    lan_fin = None
    for kw in FRR_POLICIES:
        cfg = FrrConfig(**FRR_CFG, **kw)
        eng = FrrEngine("torch")
        eng.set_policy(cfg)
        got = eng.compute(lan)
        want = frr_reference(lan, 64, **kw)
        require(same_table(got, want), f"the LAN FRR table ({kw or 'no policy'}) differs "
                f"from frr_reference")
        for link in range(got.n_links):
            for dest in range(lan.n_vertices):
                require(resolve_backup(got, cfg, link, dest) == resolve_backup(
                    want, cfg, link, dest), f"resolve_backup({link}, {dest}) differs ({kw})")
        lan_fin = got.inputs
    lan_nets = int((~lan.is_router[lan_fin.link_far[:lan_fin.n_links]]).sum())
    members = int((~lan.is_router[lan_fin.link_far[lan_fin.adj_link[:lan_fin.n_adj]]]).sum())
    require(members > 0, "the LAN topology's root has no network link with member candidates")
    print(f"FRR LAN ({lan.n_vertices} vertices, {int((~lan.is_router).sum())} networks, "
          f"{lan.n_edges} edges; root {lan.root}: {lan_fin.n_links} links, {lan_nets} to "
          f"networks, {lan_fin.n_adj} candidates, {members} of them LAN members): every plane equal to frr_reference and "
          f"resolve_backup equal on every (link, destination), with the policies off and with "
          f"node_protection + srlg_disjoint ({time.perf_counter() - t0:.1f} s)", flush=True)

    # (d) the graft entry on the card.
    fn, args = graft_entry.entry()
    require(args[0].in_src.device.type == "cuda", "graft_entry.entry() is not on the card")
    res = fn(*args)
    gtopo, _, gmasks = graft_entry._small_problem(device="cpu")
    host = [t.cpu().numpy() for t in res]
    for b in range(gmasks.shape[0]):
        ref = oracle.compute(gtopo, gmasks[b])
        require(all(np.array_equal(h[b], w) for h, w in zip(
            host[:3], (ref.dist, ref.parent, ref.hops)))
            and np.array_equal(host[3][b].view(np.uint32), ref.nexthop_words),
            f"graft entry scenario {b} differs from the oracle")
    print(f"graft entry: {gmasks.shape[0]} scenarios on the card equal the oracle", flush=True)
    print(f"FRR phase checked in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return x


def cspf_phase(ell, topo) -> dict:
    """Phase 3g: 1024 TE requests (bench.py's stage_cspf10k draws) on the
    k=90 fat tree through ``CspfEngine`` on the card: a cold batch with the
    ELL counts at 0 (G1-G4 must launch), every G1-G4 launch of one more batch
    held to its plain version, requests 0-7 held to ``spf_reference`` on
    their masks (cost and first-parent path), 3 warm batches timed."""
    from holo_tpu_torch.ops.cspf import (
        Constraint,
        CspfEngine,
        LinkAttrs,
        constraint_masks,
        device_constraint_masks,
    )
    from holo_tpu_torch.spf.scalar import spf_reference

    t_phase = time.perf_counter()
    rng = np.random.default_rng(CSPF_SEED)
    attrs = LinkAttrs(affinity=rng.integers(0, 2**8, topo.n_edges, dtype=np.uint32),
                      bandwidth=rng.uniform(1.0, 10.0, topo.n_edges))
    cons = [Constraint(exclude_any=int(rng.integers(0, 4)),
                       min_bandwidth=float(rng.uniform(0.0, 2.0))) for _ in range(CSPF_BATCH)]
    dsts = [int(d) for d in rng.integers(0, topo.n_vertices, CSPF_BATCH)]
    x = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = CspfEngine(topo, attrs)
    require(eng.device.type == "cuda", "CspfEngine does not run on the card")
    torch.cuda.synchronize()
    x["marshal_ms"] = (time.perf_counter() - t0) * 1e3
    ell.reset_launches()
    t0 = time.perf_counter()
    paths = eng.compute(cons, dsts)
    torch.cuda.synchronize()
    x["cold_ms"] = (time.perf_counter() - t0) * 1e3
    x["launches"] = dict(ell.launches)
    print(f"CSPF path launches: {x['launches']}", flush=True)
    for name in GATHER_PLAIN:
        require(x["launches"][name] > 0, f"kernel {name} never launched on the CSPF path")
    require(len(paths) == CSPF_BATCH, "CSPF batch size")
    masks = constraint_masks(topo, attrs, cons[:CSPF_ORACLE])
    require(np.array_equal(device_constraint_masks(topo, attrs, cons[:CSPF_ORACLE],
                                                   DEVICE).cpu().numpy(), masks),
            "CSPF masks built on the card differ from constraint_masks")
    for b in range(CSPF_ORACLE):
        ref = spf_reference(topo, masks[b])
        p, d = paths[b], dsts[b]
        if ref.dist[d] >= (1 << 30):
            require(p.cost is None, f"CSPF request {b}: a path where the oracle has none")
            continue
        chain = [d]
        while chain[-1] != topo.root:
            chain.append(int(ref.parent[chain[-1]]))
        require(p.cost == int(ref.dist[d]) and p.vertices == chain[::-1],
                f"CSPF request {b} differs from spf_reference on its mask")
    x["found"] = sum(p.cost is not None for p in paths)
    require(x["found"] > 0, "no CSPF request found a path")
    hold = GatherHolder()
    with holding_gather(ell, hold):
        again = eng.compute(cons, dsts)
    torch.cuda.synchronize()
    require([(p.cost, p.vertices) for p in again] == [(p.cost, p.vertices) for p in paths],
            "the held CSPF batch differs")
    for name in GATHER_PLAIN:
        require(hold.held_count(name) == x["launches"][name],
                f"CSPF {name}: {hold.held_count(name)} launches held of {x['launches'][name]}")
    require(set(hold.lanes) == {(k, CSPF_BATCH) for k in GATHER_PLAIN},
            f"the held CSPF launches ran at other widths: {dict(hold.lanes)}")
    x["held_err"] = hold.err
    warm = []
    for _ in range(CSPF_WARM_REPS):
        t0 = time.perf_counter()
        eng.compute(cons, dsts)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    x["batch_ms"] = statistics.median(warm)
    x["warm_all_ms"] = warm
    x["requests_per_sec"] = CSPF_BATCH / x["batch_ms"] * 1e3
    x["busy"] = lambda: eng.compute(cons, dsts)
    print(f"CSPF k={K}: {CSPF_BATCH} requests, {x['found']} paths found; requests "
          f"0-{CSPF_ORACLE - 1} equal spf_reference on their masks (cost and path); every "
          f"G1-G4 launch of a held batch bit-identical to its plain version "
          f"({dict(hold.lanes)}); phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return x


def part_chain(graph, synth, topo, per: int, cols: int) -> list:
    """[(event, topology linked to the one before)]: six link-cost events on
    the 10-area LSDB, two of them on gateway (cut) links."""
    def v(area, r, c):
        return area * per + r * cols + c

    events = [("area 3 link", v(3, 5, 7), v(3, 5, 8), 9),
              ("gateway link area 5 g1", v(5, 1, 0), (cols + 5) % per, 5),
              ("area 7 link", v(7, 20, 3), v(7, 21, 3), 1),
              ("gateway link area 2 g2", v(2, 2, 0), (2 * cols + 2) % per, 4),
              ("area 3 link back", v(3, 5, 7), v(3, 5, 8), 2),
              ("area 9 link", v(9, 30, 30), v(9, 30, 31), 8)]
    out, cur = [], topo
    for label, a, b, cost in events:
        cur = set_link_cost(graph, synth, cur, a, b, cost)
        out.append((label, cur))
    return out


def part_timed(be, topo, reps: int) -> dict:
    """A cold partitioned compute with the ELL counts at 0, then ``reps``
    warm ones: times (host clock, each ended by a sync), the launches of
    the cold call, each warm call's phase times and rounds, the result."""
    from holo_tpu_torch.kernels import ell

    be.part_stats = {}
    ell.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = be.compute(topo)
    torch.cuda.synchronize()
    x = {"cold_ms": (time.perf_counter() - t0) * 1e3, "launches": dict(ell.launches),
         "cold_stats": copy.deepcopy(be.part_stats), "out": out}
    require(be.part_stats["path"] == "marshal", "the cold partitioned compute did not marshal")
    warm, stats = [], []
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(reps):
        t0 = time.perf_counter()
        again = be.compute(topo)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
        stats.append(copy.deepcopy(be.part_stats))
        require(be.part_stats["path"] == "full" and same_planes(again, out),
                "a warm partitioned compute re-marshaled or differs from the cold one")
    x["peak_mb"] = (torch.cuda.max_memory_allocated() - mem0) / 2**20
    x["warm_ms"] = statistics.median(warm)
    x["warm_all_ms"] = warm
    x["phases"] = {k: statistics.median(st["timings"][k] for st in stats) for k in PART_PHASES}
    x["rounds"] = stats[-1]["rounds"]
    return x


def partition_phase(ell, se, dev) -> dict:
    """Phase 3h: (a) the 100k-vertex multi-area LSDB (25 areas of 64 x 64)
    through a partition-armed ``TorchSpfBackend`` with its native hint and
    with the flat cut (parts of at most 4096), cold and 3 warm computes with
    the ELL counts at 0, beside the monolithic ``compute()``; all three equal
    to the oracle on the four planes; every kernel launch of one more flat
    compute held to its plain version; the largest-frontier launch of the
    boundary solve timed against its bound; (b) at 10k (10 areas of 32 x 32):
    ``multipath_k`` 4 and 8 against the multipath oracle (nine planes),
    every launch held, and a chain of six linked events served incrementally
    with fewer re-solved parts than the cut has, each step equal to a full
    partitioned solve (steps 0-1 also to the oracle)."""
    from holo_tpu_torch.ops import graph
    from holo_tpu_torch.ops import partition as tp
    from holo_tpu_torch.spf import synth
    from holo_tpu_torch.spf.backend import ScalarSpfBackend, TorchSpfBackend

    t_phase = time.perf_counter()
    x = {}
    topo = synth.multiarea_topology(**PART_100K)
    flat = synth.clone_topology(topo)
    flat.partition_hint = None
    n = topo.n_vertices
    t0 = time.perf_counter()
    ref = ScalarSpfBackend().compute(topo)
    x["oracle_s"] = time.perf_counter() - t0
    print(f"partitioned LSDB: {n} vertices, {topo.n_edges} edges, "
          f"{len(np.unique(topo.partition_hint))} areas; oracle {x['oracle_s']:.1f} s, max "
          f"distance {int(ref.dist[ref.dist < (1 << 30)].max())}", flush=True)
    mono = TorchSpfBackend(device=dev)
    ell.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_out = mono.compute(topo)
    torch.cuda.synchronize()
    x["mono_cold_ms"] = (time.perf_counter() - t0) * 1e3
    x["mono_launches"] = dict(ell.launches)
    require(same_planes(m_out, ref), "the monolithic compute() at 100k differs from the oracle")
    x["mono_ms"] = host_ms(lambda: mono.compute(topo), PART_WARM_REPS)
    x["mono_busy"] = lambda: mono.compute(topo)
    arms = {"hinted": (TorchSpfBackend(device=dev, partition_threshold=1), topo),
            "flat": (TorchSpfBackend(device=dev, partition_threshold=1,
                                     partition_max_part=PART_MAX_PART), flat)}
    x["arms"] = {}
    for arm, (be, t) in arms.items():
        r = part_timed(be, t, PART_WARM_REPS)
        require(same_planes(r["out"], ref), f"the {arm} partitioned compute differs from the "
                f"oracle")
        require(same_planes(r["out"], m_out), f"the {arm} partitioned compute differs from the "
                f"monolithic compute()")
        for name in ("ell_relax", "ell_first_parent", "ell_mp_round"):
            require(r["launches"][name] > 0, f"kernel {name} never launched on the {arm} "
                    f"partitioned path")
        require(r["launches"]["ell_nh_seed"] == r["launches"]["ell_nh_round"] == 0,
                f"G3/G4 launched on the {arm} partitioned path")
        (res,) = be.partition_residents()
        r["stats"] = res.stats()
        r["busy"] = (lambda b=be, tt=t: b.compute(tt))
        x["arms"][arm] = r
        st = r["stats"]
        print(f"partitioned {arm}: {st['parts']} parts, {st['rows']} rows, skeleton "
              f"{st['skeleton']}, {st['cut-edges']} cut edges, {st['boundary-lanes']} boundary "
              f"lanes (b_pad {st['b-pad']}), l_pad "
              f"{st['l-pad']}; equal to the oracle and the monolithic compute() on the four "
              f"planes; launches {r['launches']}; rounds {r['rounds']}", flush=True)
    # Every kernel launch of one more flat compute, held to its plain version.
    be, t = arms["flat"]
    t0 = time.perf_counter()
    ghold, mhold = GatherHolder(), Holder(ell, full_round=False)
    with holding_gather(ell, ghold), holding(ell, mhold):
        require(same_planes(be.compute(t), ref), "the held flat partitioned compute differs")
    torch.cuda.synchronize()
    flat_l = x["arms"]["flat"]["launches"]
    for name in ("ell_relax", "ell_first_parent"):
        require(ghold.held_count(name) == flat_l[name],
                f"{name}: {ghold.held_count(name)} partitioned launches held of {flat_l[name]}")
    require(mhold.held["ell_mp_round"] == flat_l["ell_mp_round"],
            "an ell_mp_round launch of the flat partitioned compute was not held")
    x["held_err"] = {**ghold.err, "ell_mp_round": mhold.err["ell_mp_round"]}
    print(f"partitioned held compute (flat): every launch bit-identical to its plain version, "
          f"(kernel, lanes) -> launches {dict(ghold.lanes)}, M1 {dict(mhold.lanes)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    # The boundary solve's largest-frontier G1 launch against its bound.
    (res,) = be.partition_residents()
    plan = res.plan
    stack = tp.part_stack(plan, res.graph, range(plan.n_parts))
    kept = []
    with keeping_relax(ell, kept):
        tp.boundary_tables(plan, stack, plan.l_pad)
    torch.cuda.synchronize()
    lp = se.LanePlanes(stack.g.in_src, stack.g.in_cost, stack.slot, None)
    fronts = [popcount(f) for _, f in kept]
    main = max(range(len(kept)), key=fronts.__getitem__)
    x["bdist_launches"] = len(kept)
    x["bdist_lanes"] = kept[0][0].shape[1]
    x["bdist_main"] = main + 1
    x["bdist_main_ms"] = cuda_ms(lambda: ell.ell_relax(*lp, *kept[main]), KERNEL_REPS)
    x["bdist_main_bound"] = launch_bound(lp, None, "ell_relax", *kept[main])
    x["bdist_ms"] = cuda_ms(lambda: tp.boundary_tables(plan, stack, plan.l_pad), 1)
    del kept
    print(f"partitioned boundary solve (flat): {x['bdist_launches']} ell_relax launches at "
          f"{x['bdist_lanes']} lanes over {plan.n_rows} rows; launch {main + 1} has the "
          f"largest frontier ({fronts[main]} bits)", flush=True)

    # (b) 10k: multipath and the delta chain.
    t10 = synth.multiarea_topology(**PART_10K)
    per, cols = PART_10K["rows"] * PART_10K["cols"], PART_10K["cols"]
    mbe = TorchSpfBackend(device=dev, partition_threshold=1)
    oracle = ScalarSpfBackend()
    ell.reset_launches()
    hold = Holder(ell, full_round=False)
    ghold = GatherHolder()
    with holding(ell, hold), holding_gather(ell, ghold):
        for k in PART_MP_KS:
            require(same_nine(mbe.compute(t10, multipath_k=k),
                              oracle.compute(t10, multipath_k=k)),
                    f"partitioned compute(multipath_k={k}) differs from the multipath oracle")
    torch.cuda.synchronize()
    x["mp_launches"] = dict(ell.launches)
    for name in MP_REPLACES:
        require(x["mp_launches"][name] > 0 and hold.held[name] == x["mp_launches"][name],
                f"kernel {name} not launched, or not held, on the partitioned multipath path")
    require(x["mp_launches"]["ell_first_parent"] == 0,
            "ell_first_parent launched on the partitioned multipath path")
    x["mp_err"] = dict(hold.err)
    x["mp_err"]["ell_relax"] = ghold.err["ell_relax"]
    print(f"partitioned multipath (10k, k={list(PART_MP_KS)}): nine planes equal to the "
          f"multipath oracle; launches {x['mp_launches']}, every one held "
          f"({dict(hold.lanes)})", flush=True)
    cbe = TorchSpfBackend(device=dev, partition_threshold=1)
    cbe.compute(t10)
    (res10,) = cbe.partition_residents()
    n_parts = res10.plan.n_parts
    full_be = TorchSpfBackend(device=dev, partition_threshold=1, incremental=False)
    cbe.part_stats = {}
    x["chain"] = []
    n_cut = 0
    for i, (label, t) in enumerate(part_chain(graph, synth, t10, per, cols)):
        t0 = time.perf_counter()
        got = cbe.compute(t)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        st = cbe.part_stats
        require(st["path"] == "incremental" and st["resolved"] < n_parts,
                f"partitioned delta step {i} ({label}) was not served incrementally with fewer "
                f"re-solved parts than {n_parts}: {st}")
        require(same_planes(got, full_be.compute(synth.clone_topology(t))),
                f"partitioned delta step {i} ({label}) differs from a full partitioned solve")
        if i < 2:
            require(same_planes(got, oracle.compute(t)),
                    f"partitioned delta step {i} ({label}) differs from the oracle")
        d = t.delta_base
        on_cut = bool((res10.plan.part_of[d.w_src] != res10.plan.part_of[d.w_dst]).any())
        n_cut += on_cut
        x["chain"].append((label, ms, st["resolved"], st["rounds"]["exchange"]))
        print(f"partitioned delta step {i} {label}{' (cut edge)' if on_cut else ''}: "
              f"incremental, {st['resolved']} of {n_parts} parts re-solved, "
              f"{st['rounds']['exchange']} exchange rounds; equal to a full partitioned "
              f"solve{' and the oracle' if i < 2 else ''}; compute() {ms:.3f} ms", flush=True)
    require(n_cut >= 2, "fewer than two chain events on cut edges")
    print(f"partitioned phase checked in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return x


def bgp_attrs(be, rng, n_peers: int):
    """One route's attributes, drawn as bench.py's parity feed draws them
    (:3355-3375; the MED is drawn first)."""
    med = None if rng.random() < 0.2 else int(rng.integers(0, 1000))
    return be.BaseAttrs(
        origin=("Igp", "Egp", "Incomplete")[int(rng.integers(0, 3))],
        as_path=(be.AsSegment("Sequence", tuple(
            int(a) for a in rng.integers(1, 500, size=int(rng.integers(1, 5))))),),
        nexthop=f"9.9.{int(rng.integers(0, n_peers))}.1",
        med=med,
        local_pref=int(rng.integers(50, 300)) if rng.random() < 0.5 else None,
    )


def bgp_feed(be, n_prefixes: int, n_peers: int, seed: int = BGP_FEED_SEED):
    """(nht, feed): bench.py's parity feed (:3340-3388) in its draw order.
    Every 5th next hop is unresolved; each peer announces a prefix with
    probability 0.6, odd peers as eBGP; ``feed`` is [(prefix, [(peer, attrs,
    route type, router id)])], prefixes with no route included."""
    rng = np.random.default_rng(seed)
    nht = {f"9.9.{nh}.1": (int(rng.integers(1, 64)) if nh % 5 else None)
           for nh in range(n_peers)}
    feed = []
    for i in range(n_prefixes):
        routes = []
        for p in range(n_peers):
            if rng.random() < 0.4:
                continue
            routes.append((f"1.1.1.{p + 1}", bgp_attrs(be, rng, n_peers),
                           "External" if p % 2 else "Internal", f"0.0.0.{p + 1}"))
        feed.append((f"10.{(i >> 8) & 255}.{i & 255}.0/24", routes))
    return nht, feed


def bgp_burst(be, feed, n_peers: int, count: int, seed: int = BGP_BURST_SEED):
    """An UPDATE burst: ``count`` prefixes, each re-announced by every peer
    that announces it with fresh attributes."""
    rng = np.random.default_rng(seed)
    return [(feed[i][0], [(addr, bgp_attrs(be, rng, n_peers), rt, rid)
                          for addr, _attrs, rt, rid in feed[i][1]])
            for i in sorted(int(i) for i in rng.choice(len(feed), size=count, replace=False))]


def bgp_announce(be, eng, prefix: str, routes, backend) -> None:
    """Install ``routes`` as the peers' Adj-RIB-In routes of ``prefix``
    (next hops tracked), queue the prefix and note it to the backend."""
    table = eng.tables[BGP_AFS]
    dest = table.prefixes.setdefault(prefix, be.Destination())
    for addr, attrs, route_type, rid in routes:
        adj = dest.adj_rib.setdefault(addr, be.AdjRib())
        if adj.in_post is not None:
            eng._nexthop_untrack(table, prefix, adj.in_post)
        adj.in_post = be.Route(origin=be.RouteOrigin(identifier=rid, remote_addr=addr),
                               attrs=attrs, route_type=route_type)
        eng._nexthop_track(table, prefix, adj.in_post)
    table.queued.add(prefix)
    if backend is not None:
        backend.note_route_change(BGP_AFS, prefix)


def bgp_snap(eng) -> dict:
    """The Loc-RIB as bench.py's parity gate takes it (:3390-3404), with the
    best route's origin: best route, next-hop set, every candidate's reject
    and ineligible reasons and igp_cost."""
    out = {}
    for prefix, dest in eng.tables[BGP_AFS].prefixes.items():
        loc = dest.local
        out[prefix] = (
            None if loc is None else (loc.origin, loc.attrs, loc.route_type, loc.igp_cost),
            dest.local_nexthops,
            tuple(sorted((a, adj.in_post.reject_reason, adj.in_post.ineligible_reason,
                          adj.in_post.igp_cost)
                         for a, adj in dest.adj_rib.items() if adj.in_post)),
        )
    return out


def nbias(a) -> np.ndarray:
    """u32 values as the BGP lanes hold them: ``u - 2**31`` as int32."""
    return (np.asarray(a, np.int64) - (1 << 31)).astype(np.int32)


def bgp_full_planes(rng, rows: int, cols: int, k: int) -> np.ndarray:
    """The full table at the lane level, as bench.py synthesizes it
    (:3430-3458): half the peer cells occupied and one more per row, the
    local column empty, 2% AS loops; empty cells all zero."""
    from holo_tpu_torch.ops import bgp_table as bt

    planes = np.zeros((bt.N_LANES, rows, cols), np.int32)
    occ = (rng.random((rows, cols)) < 0.5).astype(np.int32)
    occ[:, bt.LOCAL_COL] = 0
    occ[np.arange(rows), 1 + rng.integers(0, cols - 1, size=rows)] = 1
    planes[bt.L_OCC] = occ
    planes[bt.L_LP] = nbias(0xFFFFFFFF - rng.integers(50, 300, size=(rows, cols), dtype=np.int64))
    planes[bt.L_L1] = (rng.integers(1, 6, size=(rows, cols)) << 2) | rng.integers(
        0, 3, size=(rows, cols))
    planes[bt.L_MED] = nbias(rng.integers(0, 1000, size=(rows, cols), dtype=np.int64))
    planes[bt.L_FAS] = rng.integers(1, 64, size=(rows, cols))
    planes[bt.L_RT] = rng.integers(0, 2, size=(rows, cols))
    planes[bt.L_RID] = nbias(rng.integers(0, 1 << 32, size=(rows, cols), dtype=np.int64))
    planes[bt.L_HASRID] = 1
    planes[bt.L_NH] = rng.integers(0, k, size=(rows, cols))
    planes[bt.L_PATH] = rng.integers(0, 4096, size=(rows, cols))
    planes[bt.L_LOOP] = (rng.random((rows, cols)) < 0.02).astype(np.int32)
    planes *= occ
    planes[bt.L_OCC] = occ
    return planes


def fold_err(got, want) -> int:
    """Largest absolute difference over the fold's four outputs; raises
    where a dtype or shape differs."""
    err = 0
    for name, g, w in zip(("best_col", "reasons", "elig", "mp_sel"), got, want):
        require(g.dtype == w.dtype and g.shape == w.shape,
                f"bgp_fold {name}: {g.dtype} {tuple(g.shape)} against {w.dtype} "
                f"{tuple(w.shape)}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item())
                  if g.numel() else 0)
    return err


@contextlib.contextmanager
def keeping_decides(kept: list):
    """Within the block every ``ops.bgp_table.decide`` runs (and counts) as
    before, and its (inputs, outputs) are appended to ``kept``."""
    from holo_tpu_torch.ops import bgp_table as bt

    fn = bt.decide

    def keep(*args):
        out = fn(*args)
        kept.append((args, out))
        return out

    bt.decide = keep
    try:
        yield kept
    finally:
        bt.decide = fn


def fold_geometry(m: int, cols: int) -> dict:
    """The launch ``kernels.bgp.bgp_fold`` makes for ``m`` rows x ``cols``
    columns on this card."""
    from holo_tpu_torch.kernels import bgp as kb

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"rows": m, "cols": cols, **kb.geometry(m, cols, sms)._asdict()}


def geo_text(g: dict) -> str:
    return (f"{g['rows']} x {g['cols']}: {g['tile_rows']} rows a tile, {g['stages']} stages, "
            f"{g['group_rows']} rows a group, {g['warps']} fold warps, {g['blocks']} blocks, "
            f"{g['smem_bytes']} shared bytes a block, {g['copy']} copies")


def fold_bound(in_bytes: int, out) -> tuple[float, str, int, int]:
    """(ms, by, operations, bytes) of one fold: ``in_bytes`` of inputs read
    once, its outputs written once; BGP_CELL_OPS a cell."""
    ops = out[1].numel() * BGP_CELL_OPS
    byte_count = in_bytes + nbytes(*out)
    return (*bound(ops, byte_count), ops, byte_count)


def bgp_phase() -> dict:
    """Phase 3i: the BGP table.  The engine path (the parity feed at 32,768
    prefixes x 16 peers) decided by ``DecisionEngine`` on
    ``TorchBgpTableBackend()`` and by the oracle: cold, an UPDATE burst and
    NHT churn, each equal to the oracle (Loc-RIB and ibus stream), with the
    fold's launch count at 0 before it; the full table (524,288 x 64) folded
    alone and held to ``fold_plain``, timed; 40 UPDATE rounds (scatter +
    4,096-row decide), the last held; the rank sort against ``sorted``."""
    from holo_tpu_torch.kernels import bgp as kb
    from holo_tpu_torch.ops import bgp_table as bt
    from holo_tpu_torch.protocols import bgp_engine as be

    t_phase = time.perf_counter()
    x = {}
    t0 = time.perf_counter()
    nht, feed = bgp_feed(be, BGP_PREFIXES, BGP_PEERS)
    burst = bgp_burst(be, feed, BGP_PEERS, BGP_BURST)
    backend = bt.TorchBgpTableBackend()
    require(backend.device.type == "cuda", "TorchBgpTableBackend() does not run on the card")
    arms = {}
    for arm, tb in (("oracle", None), ("card", backend)):
        calls = []
        eng = be.DecisionEngine(asn=65000, table_backend=tb,
                                ibus_cb=lambda kind, payload, c=calls: c.append((kind, payload)))
        eng.multipath[BGP_AFS] = dict(BGP_MP)
        for addr, metric in nht.items():
            eng.tables[BGP_AFS].nht[addr] = be.NhtEntry(metric=metric)
        for prefix, routes in feed:
            bgp_announce(be, eng, prefix, routes, tb)
        arms[arm] = (eng, calls)
    n_routes = sum(len(routes) for _, routes in feed)
    print(f"BGP feed: {BGP_PREFIXES} prefixes x {BGP_PEERS} peers, {n_routes} routes, "
          f"built twice in {time.perf_counter() - t0:.1f} s", flush=True)

    x["engine_ms"] = {arm: {} for arm in arms}
    x["batch_prefixes"] = {}
    x["breakdown"] = {}
    # The card arm's batch split on the host clock: the lane marshal of the
    # noted rows, and the device batch (marshal, scatter, uploads, fold,
    # readback); the rest of a batch is the per-prefix replay.
    timers = Counter()

    def timed(name: str, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                timers[name] += (time.perf_counter() - t0) * 1e3
        return run

    backend._marshal_rows = timed("marshal_ms", backend._marshal_rows)
    backend._device_batch = timed("device_batch_ms", backend._device_batch)
    x["engine_err"] = 0
    x["served"] = {}
    x["geometry"] = {}
    kb.reset_launches()

    def batch(kind: str, change) -> None:
        served = Counter(backend.served)
        # The batch's decide is kept with its inputs and held to decide_plain
        # after the batch, before the next scatter changes the planes: the
        # kernel checked at the engine's own shapes.
        kept = []
        for arm, (eng, _calls) in arms.items():
            change(eng, arm)
            x["batch_prefixes"][kind] = len(eng.tables[BGP_AFS].queued)
            torch.cuda.synchronize()
            timers.clear()
            with keeping_decides(kept):
                t0 = time.perf_counter()
                eng.run_decision_process()
                torch.cuda.synchronize()
                x["engine_ms"][arm][kind] = (time.perf_counter() - t0) * 1e3
        x["breakdown"][kind] = dict(timers)
        require(len(kept) == 1, f"the {kind} batch launched {len(kept)} decides (one a batch)")
        (args, out), = kept
        x["geometry"][kind] = fold_geometry(args[1].shape[0], args[0].shape[2])
        err = fold_err(out, kb.decide_plain(*args))
        require(err == 0, f"bgp_fold of the {kind} batch differs from decide_plain on its "
                f"inputs ({args[1].shape[0]} rows x {args[0].shape[2]} columns)")
        x["engine_err"] = max(x["engine_err"], err)
        # The card decided every prefix of the batch: none but the poisoned
        # came from the oracle (off the CPU the backend raises on any other).
        d = {k: v - served[k] for k, v in backend.served.items() if v != served[k]}
        x["served"][kind] = d
        want = x["batch_prefixes"][kind] - d.get("best-poisoned", 0)
        require(d.get("best-device", 0) == want and not d.get("best-host")
                and not d.get("nexthops-host") and d.get("nexthops-device", 0) > 0,
                f"the {kind} batch's prefixes were not all decided on the card ({want} "
                f"expected): {d}")
        require(bgp_snap(arms["card"][0]) == bgp_snap(arms["oracle"][0]),
                f"BGP Loc-RIB after the {kind} batch differs from the oracle")
        require(arms["card"][1] == arms["oracle"][1],
                f"BGP ibus stream after the {kind} batch differs from the oracle")

    def scatters() -> int:
        return backend.stats()["tables"][BGP_AFS]["scatters"]

    batch("cold", lambda eng, arm: None)
    before = scatters()
    batch("burst", lambda eng, arm: [
        bgp_announce(be, eng, prefix, routes, eng.table_backend) for prefix, routes in burst])
    require(scatters() == before + 1, "the UPDATE burst did not scatter its rows once")
    before = scatters()
    batch("churn", lambda eng, arm: [eng.nexthop_update(a, m) for a, m in BGP_CHURN])
    require(scatters() == before, "NHT churn re-marshaled rows")
    x["launches"] = kb.launches["bgp_fold"]
    require(x["launches"] == 3, f"bgp_fold launched {x['launches']} times on the engine path "
            f"(one a batch: 3)")
    st = backend.stats()
    x["backend"] = st
    require(st["fallbacks"] == 0 and st["tables"][BGP_AFS]["poisoned"] == 0,
            f"BGP backend fallbacks or poisoned prefixes: {st}")
    for arm in arms:
        print(f"time BGP engine ({arm}): cold {x['engine_ms'][arm]['cold']:.3f} ms "
              f"({x['batch_prefixes']['cold']} prefixes), UPDATE burst "
              f"{x['engine_ms'][arm]['burst']:.3f} ms ({x['batch_prefixes']['burst']}), NHT "
              f"churn {x['engine_ms'][arm]['churn']:.3f} ms ({x['batch_prefixes']['churn']})",
              flush=True)
    print("breakdown BGP engine (card; host clock): " + "; ".join(
        f"{kind}: marshal {b.get('marshal_ms', 0.0):.3f} ms, device batch "
        f"{b['device_batch_ms']:.3f} ms (with the marshal), replay "
        f"{x['engine_ms']['card'][kind] - b['device_batch_ms']:.3f} ms"
        for kind, b in x["breakdown"].items()), flush=True)
    print(f"BGP engine path: Loc-RIB and ibus stream equal to the oracle cold, after the burst "
          f"and after the churn; bgp_fold launches {x['launches']}, each held bit-identical to "
          f"decide_plain on its inputs; backend {st['dispatches']} dispatches, "
          f"{st['tables'][BGP_AFS]['scatters']} scatters, 0 fallbacks, 0 poisoned; prefixes "
          f"served a batch: {x['served']}", flush=True)
    print("geometry bgp_fold, engine batches: " + "; ".join(
        f"{kind} {geo_text(g)}" for kind, g in x["geometry"].items()), flush=True)
    del arms, feed, burst

    # -- the full table folded alone
    t0 = time.perf_counter()
    rng = np.random.default_rng(BGP_PLANE_SEED)
    R, C, K = BGP_FULL_ROWS, BGP_FULL_COLS, BGP_NH_IDS
    planes_np = bgp_full_planes(rng, R, C, K)
    nht_enc = nbias(rng.integers(1, 65, size=K, dtype=np.int64))
    nht_res = (rng.random(K) < 0.9).astype(np.int32)
    nht_res[0] = 1
    vecs = (np.concatenate([np.arange(1, C), [0]]).astype(np.int32),  # order
            np.arange(C, dtype=np.int32),  # addr_rank
            (np.arange(C) != 0).astype(np.int32),  # has_addr
            nht_enc, nht_res, np.array([1, 2, 4], np.int32))
    args = [torch.from_numpy(v).to(DEVICE) for v in vecs]
    planes = torch.from_numpy(planes_np).to(DEVICE)
    torch.cuda.synchronize()
    print(f"BGP full table: {R} x {C} lanes synthesized and resident "
          f"({planes.numel() * 4 / 1e9:.3f} GB) in {time.perf_counter() - t0:.1f} s", flush=True)
    out = bt.fold_planes(planes, *args)
    plain = kb.fold_plain(planes, *args)
    torch.cuda.synchronize()
    x["max_abs_err"] = fold_err(out, plain)
    require(x["max_abs_err"] == 0, "bgp_fold differs from fold_plain on the full table")
    del plain
    x["ms"] = cuda_ms(lambda: bt.fold_planes(planes, *args), BGP_FOLD_REPS)
    # The kernel's own device time (fold_planes also launches its idx arange).
    times = device_times(lambda: [bt.fold_planes(planes, *args) for _ in range(BGP_FOLD_REPS)])
    x["device_ms"] = sum(ms for key, ms in times.items() if "bgp_fold" in key) / BGP_FOLD_REPS
    require(x["device_ms"] > 0, f"the profiler saw no bgp_fold kernel: {sorted(times)}")
    x["geometry"]["full"] = fold_geometry(R, C)
    x["plain_ms"] = cuda_ms(lambda: kb.fold_plain(planes, *args), 3)
    x["readback_ms"] = host_ms(lambda: [o.cpu() for o in out], 3)
    x["bound"] = fold_bound(nbytes(planes, *args), out)
    x["prefixes_per_s"] = R / x["ms"] * 1e3
    eligible = int(out[2].sum().item())
    print(f"geometry bgp_fold {R} x {C}: {geo_text(x['geometry']['full'])}", flush=True)
    print(f"time bgp_fold {R} x {C}: {x['ms']:.4f} ms (CUDA events, median of "
          f"{BGP_FOLD_REPS}), device {x['device_ms']:.4f} ms (profiler, launch excluded, "
          f"mean of {BGP_FOLD_REPS}), {x['prefixes_per_s']:.1f} prefixes/s; bound "
          f"{x['bound'][0]:.4f} ms by {x['bound'][1]} ({x['bound'][2]} operations, "
          f"{x['bound'][3]} bytes), {x['bound'][0] / x['ms']:.3f} of it; plain "
          f"{x['plain_ms']:.3f} ms; readback of the four outputs {x['readback_ms']:.3f} ms; "
          f"{eligible} eligible cells, held bit-identical to fold_plain", flush=True)
    del out

    # -- UPDATE rounds: a 1,024-row scatter and a 4,096-row decide
    rounds = []
    for _ in range(BGP_ROUNDS):
        rows = torch.from_numpy(
            rng.choice(R, size=BGP_UPDATE_ROWS, replace=False).astype(np.int32)).to(DEVICE)
        fresh = torch.from_numpy(
            planes_np[:, rng.integers(0, R, size=BGP_UPDATE_ROWS), :]).to(DEVICE)
        sub = torch.from_numpy(np.sort(rng.choice(R, size=BGP_RADIUS, replace=False))
                               .astype(np.int32)).to(DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bt.scatter_rows(planes, rows, fresh)
        res = bt.decide(planes, sub, *args)
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) * 1e3)
    kept = sorted(rounds[BGP_ROUNDS_DROPPED:])
    x["update_p99_ms"] = kept[min(len(kept) - 1, int(0.99 * len(kept)))]
    x["update_median_ms"] = statistics.median(kept)
    x["update_err"] = fold_err(res, kb.decide_plain(planes, sub, *args))
    require(x["update_err"] == 0, "the last UPDATE round's bgp_fold differs from decide_plain")
    x["update_ms"] = cuda_ms(lambda: bt.decide(planes, sub, *args), BGP_FOLD_REPS)
    x["geometry"]["update"] = fold_geometry(BGP_RADIUS, C)
    print(f"geometry bgp_fold {BGP_RADIUS} x {C}: {geo_text(x['geometry']['update'])}",
          flush=True)
    x["update_plain_ms"] = cuda_ms(lambda: kb.decide_plain(planes, sub, *args), 3)
    # The decide reads only the queued rows of the planes.
    x["update_bound"] = fold_bound(kb.N_LANES * BGP_RADIUS * C * 4 + nbytes(sub, *args), res)
    print(f"time BGP UPDATE round ({BGP_UPDATE_ROWS}-row scatter + {BGP_RADIUS}-row decide, "
          f"host clock, {BGP_ROUNDS} rounds, first {BGP_ROUNDS_DROPPED} dropped): p99 "
          f"{x['update_p99_ms']:.3f} ms, median {x['update_median_ms']:.3f} ms; bgp_fold at "
          f"{BGP_RADIUS} x {C}: {x['update_ms']:.4f} ms (CUDA events), bound "
          f"{x['update_bound'][0]:.5f} ms by {x['update_bound'][1]}, plain "
          f"{x['update_plain_ms']:.3f} ms; last round held to decide_plain", flush=True)
    x["update_busy"] = lambda: bt.decide(planes, sub, *args)  # phase 4: device time
    del planes_np

    # -- the decision-rank sort
    rng = np.random.default_rng(BGP_RANK_SEED)
    base = [(-int(rng.integers(50, 300)), int(rng.integers(1, 6)), int(rng.integers(0, 3)),
             int(rng.integers(0, 1000)), int(rng.integers(0, 3)), int(rng.integers(0, 1 << 32)))
            for _ in range(BGP_RANK_N // 2)]
    ranks = base + [base[int(i)] for i in rng.integers(0, len(base), BGP_RANK_N - len(base))]
    ranks = [ranks[int(i)] for i in rng.permutation(len(ranks))]
    rb = bt.DeviceRankBackend()
    require(rb.rank_order(ranks) == sorted(range(len(ranks)), key=ranks.__getitem__),
            "DeviceRankBackend's order differs from sorted()")
    x["rank_ms"] = host_ms(lambda: rb.rank_order(ranks), 3)
    require(rb.refusals == 0, "the rank backend refused a tuple of the feed")
    print(f"BGP rank sort: {BGP_RANK_N} tuples ({BGP_RANK_N - len(base)} duplicates drawn) "
          f"equal to sorted(); {x['rank_ms']:.3f} ms a call (host clock), 0 refusals; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return x


def _gathered(flat: torch.Tensor, pairs: torch.Tensor, n: int) -> torch.Tensor:
    """bool [N, chunk]: the (source, lane) entries that some set (slot,
    lane) pair of bool ``pairs`` [N, K, chunk] gathers (``flat``: the slots'
    sources, [N * K])."""
    hits = torch.zeros((n, pairs.shape[2]), dtype=torch.int32, device=pairs.device)
    hits.index_add_(0, flat, pairs.reshape(flat.numel(), -1).to(torch.int32))
    return hits > 0


def fused_work(ell, p, state, roots, frontier) -> dict:
    """What one ell_fused_round launch from ``state`` under ``frontier``
    must do, and its bounds: operations (FUSED_*_OPS) against the bytes the
    function must move, each input byte read once and each output written
    once, at the HBM rate.  That is a floor whatever share of the gathers L2
    serves, and the same in both layouts (``bound``: under the frontier;
    ``full_bound``: a full round, every (row, lane) recomputed).

    Reads: src and slot of every slot, cost and inc of the rows with a lane
    recomputed, the mask words of the (valid slot, word)s whose source's
    frontier word or the row's recompute word is set, the frontier and the
    roots; of the state, dist of the recomputed and copied (row, lane)s and
    of the sources that a usable pair of a recomputed lane gathers, hops and
    the words of the recomputed and copied (row, lane)s and of the sources
    that a DAG pair gathers; the direct words of the DAG slots whose source
    has hops 0.  Writes: the recomputed and copied (row, lane)s, the
    recomputed ones' parents, the frontier.  The full round reads every mask
    word of a valid slot and no frontier."""
    dist, hops, nh = ell.fused_planes(state)
    n, k = p.src.shape
    lanes, words = dist.shape[1], nh.shape[1]
    s = p.src.long()
    flat = s.reshape(-1)
    valid = p.slot >= 0
    rec_w, copy_w = ell.fused_row_frontier(p.src, p.slot, p.mask, frontier)
    cnt = Counter()
    direct = {pre: torch.zeros((n, k), dtype=torch.bool, device=s.device)
              for pre in ("", "rec_")}
    for sl in ell.lane_chunks(n, k, lanes):
        d_nbr = dist[:, sl][s]
        usable = ell._usable(p.slot, p.mask, sl) & (d_nbr < INF)
        cand = d_nbr + p.cost[:, :, None]
        dn = torch.minimum(dist[:, sl], torch.where(usable, cand, INF).amin(1))
        not_root = torch.arange(n, device=dist.device)[:, None, None] != roots[sl][None, None, :]
        dag = usable & (dn < INF)[:, None, :] & (cand == dn[:, None, :]) & not_root
        hop0 = dag & (hops[:, sl][s] == 0)
        del d_nbr, cand, dn, not_root
        rec = ell._unpack(rec_w, sl)
        everyone = torch.ones_like(rec)
        for pre, r, own in (("", everyone, everyone),
                            ("rec_", rec, rec | ell._unpack(copy_w, sl))):
            u, d = usable & r[:, None, :], dag & r[:, None, :]
            cnt[pre + "usable"] += int(u.sum())
            cnt[pre + "dag"] += int(d.sum())
            cnt[pre + "dist_reads"] += int((own | _gathered(flat, u, n)).sum())
            cnt[pre + "cell_reads"] += int((own | _gathered(flat, d, n)).sum())
            direct[pre] |= (hop0 & r[:, None, :]).any(2)
            del u, d
        del usable, dag, hop0, rec, everyone
    cnt["recomputed"] = int(ell._unpack(rec_w, slice(0, lanes)).sum())
    cnt["copied"] = int(ell._unpack(copy_w, slice(0, lanes)).sum())
    masked = {"": 0, "rec_": 0}  # mask words read
    if p.mask is not None:
        masked[""] = int(valid.sum()) * p.mask.shape[1]
        need = (frontier[s] != 0) | (rec_w != 0)[:, None, :]
        masked["rec_"] = int((need & valid[:, :, None]).sum())

    def work(pre: str, entries: int, written: int, rows: int, front_bytes: int):
        """(operations, bytes): ``entries`` (row, lane)s recomputed,
        ``written`` written, in ``rows`` rows."""
        ops = (FUSED_PAIR_OPS * cnt[pre + "usable"] + (FUSED_DAG_OPS + words) * cnt[pre + "dag"]
               + (FUSED_CELL_OPS + words) * entries)
        byte_count = (8 * n * k + 4 * rows * (k + 1) + 4 * masked[pre] + front_bytes + 4 * lanes
                      + 4 * cnt[pre + "dist_reads"] + 4 * (1 + words) * cnt[pre + "cell_reads"]
                      + 4 * words * int(direct[pre].sum()) + written * 4 * (2 + words)
                      + 4 * entries)
        return ops, byte_count

    cnt["full_ops"], cnt["full_bytes"] = work("", n * lanes, n * lanes, n, 0)
    cnt["ops"], cnt["bytes"] = work("rec_", cnt["recomputed"], cnt["recomputed"] + cnt["copied"],
                                    int((rec_w != 0).any(1).sum()), 2 * frontier.numel() * 4)
    cnt["full_bound"] = bound(cnt["full_ops"], cnt["full_bytes"])
    cnt["bound"] = bound(cnt["ops"], cnt["bytes"])
    return dict(cnt)


class FusedHolder:
    """Within ``holding_fused()``, every ell_fused_round launch runs (and
    counts) as before, given its frontier and a clone of the carried parent
    plane, timed by CUDA events, its work is counted (fused_work) and what
    the library launches on its planes is read (ell.fused_geometry); every
    launch, or with ``ends_only`` the first and the one that reports no
    change, is held at once bit-identical to fused_round_plain on the same
    state in all four outputs (the kernel writes another buffer and the
    clone)."""

    def __init__(self, ell, p, ends_only: bool = False):
        self.ell, self.p, self.ends_only = ell, p, ends_only
        self.err = 0
        self.launch_ms, self.plain_ms, self.work, self.geometry = [], [], [], []
        self.held = 0

    def wrap(self, fn):
        ell = self.ell

        def held_round(src, cost, slot, mask, direct, inc, roots, state, frontier, parent, out):
            args = (src, cost, slot, mask, direct, inc, roots)
            self.geometry.append(ell.fused_geometry(state, out))
            got, ms = cuda_call(lambda: fn(*args, state, frontier, parent.clone(), out))
            self.launch_ms.append(ms)
            last = not bool(got[2])
            if not self.ends_only or len(self.launch_ms) == 1 or last:
                want, plain_ms = cuda_call(lambda: ell.fused_round_plain(*args, state))
                flat = lambda r: (*((r[0],) if torch.is_tensor(r[0]) else r[0]), *r[1:])
                self.err = max(self.err, held("ell_fused_round",
                                              f"at {roots.shape[0]} lanes, launch "
                                              f"{len(self.launch_ms)}", flat(got), flat(want)))
                self.plain_ms.append(plain_ms)
                self.held += 1
            self.work.append(fused_work(ell, self.p, state, roots, frontier))
            return got

        return held_round


@contextlib.contextmanager
def holding_fused(ell, holder: FusedHolder):
    fn = ell.ell_fused_round
    ell.ell_fused_round = holder.wrap(fn)
    try:
        yield holder
    finally:
        ell.ell_fused_round = fn


def timed_call(fn) -> tuple:
    """(result, host ms, CUDA-event ms) of one call that ends in a readback."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


def engines_phase(ell, se, dev, topo, masks, gres, gone, oracle, compute_ref, n_atoms) -> dict:
    """Phase 3j: the fused, packed and hybrid engines on the k=90 fat tree.
    (a) With the ELL counts at 0 each engine's backend runs a cold and
    ENGINE_WARM_REPS warm compute_whatif (1024 lanes) and compute(), beside
    seq's, timed (host clock and CUDA events); its own kernels must launch
    (ell_fused_round in its layout; G1, G2 and M1 for hybrid) and G3 / G4
    not; scenarios 0-7 and compute() equal the oracle, every scenario
    seq's planes.  (b) Every ell_fused_round launch of a 64-lane and of a
    1-lane fused dispatch, and the first and last at 1024 lanes, held to
    fused_round_plain, each 1024-lane launch timed against its bound; the
    hybrid dispatch at 64 lanes with every G1, G2 and M1 launch held, at
    1024 lanes with M1's first and last launch held.  (c)
    max_iters 2 and 5 on the card equal to the CPU path.  (d) The tuner
    arm: 12 what-if and 12 compute() calls with the tuner armed, each equal
    to seq's; its table saved and picked cold; a DeltaPath chain with the
    depth cap from the tuned table."""
    import tempfile

    from holo_tpu_torch import pipeline
    from holo_tpu_torch.ops import graph
    from holo_tpu_torch.spf import synth
    from holo_tpu_torch.spf.backend import TorchSpfBackend

    t_phase = time.perf_counter()
    x = {"times": {}, "launches": {}}
    n = topo.n_vertices
    own = {"fused": ("ell_fused_round",), "packed": ("ell_fused_round",),
           "hybrid": ("ell_relax", "ell_first_parent", "ell_mp_round")}
    # (a) the main path of each engine, counted; seq beside it, timed alike.
    for engine in ("seq", *ENGINE_NAMES):
        ell.reset_launches()
        be = TorchSpfBackend(one_engine=engine, device=dev)
        walls = {"whatif": [], "compute": []}
        res = one = None
        for _ in range(1 + ENGINE_WARM_REPS):
            res, host, ev = timed_call(lambda: be.compute_whatif(topo, masks))
            walls["whatif"].append((host, ev))
            one, host, ev = timed_call(lambda: be.compute(topo))
            walls["compute"].append((host, ev))
        torch.cuda.synchronize()
        got, moved = dict(ell.launches), dict(ell.fused_layouts)
        x["launches"][engine] = got
        x["times"][engine] = walls
        if engine != "seq":
            for name in own[engine]:
                require(got[name] > 0, f"{engine}: kernel {name} never launched on its path")
            require(got["ell_nh_seed"] == got["ell_nh_round"] == 0,
                    f"{engine}: ell_nh_seed or ell_nh_round launched")
            layout = {"fused": "planar", "packed": "interleaved"}.get(engine)
            if layout:
                require(moved[layout] == got["ell_fused_round"] and sum(moved.values())
                        == moved[layout], f"{engine}: ell_fused_round ran another layout")
            else:
                require(got["ell_fused_round"] == 0, "hybrid launched ell_fused_round")
        x.setdefault("backends", {})[engine] = be
        require(len(res) == BATCH, f"{engine} batch size")
        for b in range(ORACLE_SCENARIOS):
            require(same_planes(res[b], oracle_result(oracle[b], n_atoms)),
                    f"{engine} scenario {b} differs from the scalar oracle")
        require(same_planes(one, oracle_result(compute_ref, n_atoms)),
                f"{engine} compute() differs from the scalar oracle")
        require(all(same_planes(a, b) for a, b in zip(res, gres)) and same_planes(one, gone),
                f"{engine}: a scenario or compute() differs from seq's planes")
        print(f"engine {engine}: launches {dict((k, v) for k, v in got.items() if v)} over "
              f"{1 + ENGINE_WARM_REPS} compute_whatif + compute() calls; scenarios "
              f"0-{ORACLE_SCENARIOS - 1} and compute() equal to the oracle, all {BATCH} "
              f"scenarios and compute() equal to seq's planes", flush=True)
        del res
    x["fused_launches"] = sum(x["launches"][e]["ell_fused_round"] for e in ENGINE_NAMES)
    x["layouts"] = {e: x["launches"][e]["ell_fused_round"] for e in ("fused", "packed")}
    require(x["fused_launches"] > 0, "ell_fused_round never launched on the engines' paths")

    # (b) the fused round held: every launch at 64 and 1 lanes, the ends at
    # 1024 (each 1024-lane launch timed and its work counted).
    eg = se.device_graph_from_ell(graph.build_ell(topo, n_atoms=n_atoms), dev)
    x["hold"] = {}
    for packed in (False, True):
        for lanes in (BATCH, FUSED_HOLD_LANES, ell.SMALL, 1):
            mask = se.pack_edge_masks(masks[:lanes], dev) if lanes > 1 else None
            roots = torch.full((lanes,), topo.root, dtype=torch.int32, device=dev)
            p = se.lane_planes(eg, mask)
            hold = FusedHolder(ell, p, ends_only=lanes == BATCH)
            with holding_fused(ell, hold):
                out = se.fused_lanes(eg, roots, mask, packed)
            torch.cuda.synchronize()
            ref = se.spf_lanes(eg, roots, mask)
            require(all(torch.equal(a, b) for a, b in zip(out, ref)),
                    f"fused_lanes packed={packed} at {lanes} lanes differs from spf_lanes")
            require(hold.held == len(hold.launch_ms) or (lanes == BATCH and hold.held >= 2),
                    f"ell_fused_round at {lanes} lanes: a launch was not held")
            x["hold"][(packed, lanes)] = hold
            geo = hold.geometry[0]
            require(all(g == geo for g in hold.geometry),
                    f"ell_fused_round at {lanes} lanes: launches of one dispatch took different "
                    f"forms {hold.geometry}")
            x.setdefault("geometry", {})[(packed, lanes)] = geo
            print(f"kernel ell_fused_round {'interleaved' if packed else 'planar'} at {lanes} "
                  f"lanes: {hold.held} of {len(hold.launch_ms)} launches held bit-identical to "
                  f"fused_round_plain in state, parent, changed and frontier (max_abs_err "
                  f"{hold.err}); recomputed / copied (row, lane)s a launch "
                  f"{[(w['recomputed'], w['copied']) for w in hold.work]}; {geo['form']} form, "
                  f"{geo['tiles']} tiles a warp, int4 vector {geo['vec4']}, "
                  f"{geo['registers']} registers; the dispatch equals spf_lanes", flush=True)
            if lanes == 1:
                fused_ms = lambda: sum(ms for name, ms in device_times(
                    lambda: se.fused_lanes(eg, roots, mask, packed)).items()
                    if "ell_fused" in name)
                x.setdefault("device_b1", {})[packed] = statistics.median(
                    fused_ms() for _ in range(3))
            del out, ref
    # Hybrid: at 64 lanes every G1, G2 and M1 launch held; at 1024 M1's
    # first and last (its G1 and G2 launches there see the inputs of seq's,
    # held every one in phase 2).
    hmask = se.pack_edge_masks(masks[:FUSED_HOLD_LANES], dev)
    hroots = torch.full((FUSED_HOLD_LANES,), topo.root, dtype=torch.int32, device=dev)
    ghold, mhold = GatherHolder(), Holder(ell)
    with holding_gather(ell, ghold), holding(ell, mhold):
        hout = se.hybrid_lanes(eg, hroots, hmask)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(hout, se.spf_lanes(eg, hroots, hmask))),
            f"hybrid_lanes differs from spf_lanes at {FUSED_HOLD_LANES} lanes")
    require(ghold.held_count("ell_relax") > 0 and ghold.held_count("ell_first_parent") == 1
            and mhold.held["ell_mp_round"] == mhold.mp_launches > 0,
            "the hybrid dispatch missed a kernel or left a launch unheld")
    del hout
    hmask = se.pack_edge_masks(masks, dev)
    hroots = torch.full((BATCH,), topo.root, dtype=torch.int32, device=dev)
    bhold = Holder(ell, ends_only=True)
    with holding(ell, bhold):
        hout = se.hybrid_lanes(eg, hroots, hmask)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(hout, se.spf_lanes(eg, hroots, hmask))),
            f"hybrid_lanes differs from spf_lanes at {BATCH} lanes")
    require(bhold.held["ell_mp_round"] >= 2 and set(bhold.lanes) == {("ell_mp_round", BATCH, False)},
            f"the first and last ell_mp_round launches at {BATCH} lanes were not held")
    x["hybrid_err"] = max(max(ghold.err.values()), mhold.err["ell_mp_round"],
                          bhold.err["ell_mp_round"])
    print(f"hybrid at {FUSED_HOLD_LANES} lanes: every ell_relax ({ghold.held_count('ell_relax')}), "
          f"ell_first_parent (1) and ell_mp_round ({mhold.held['ell_mp_round']}, no count "
          f"planes) launch held to its plain version; at {BATCH} lanes ell_mp_round's first "
          f"and last ({bhold.held['ell_mp_round']} of {bhold.mp_launches} launches held, no "
          f"count planes, with the full round); max_abs_err {x['hybrid_err']}; both equal "
          f"spf_lanes", flush=True)
    del eg, hout, hmask

    # (c) truncation: the card against the CPU path.
    sub = masks[:ENGINE_LIMIT_SCENARIOS]
    for engine in ENGINE_NAMES:
        for mi in ENGINE_LIMITS:
            card = TorchSpfBackend(one_engine=engine, max_iters=mi, incremental=False, device=dev)
            cpu = TorchSpfBackend(one_engine=engine, max_iters=mi, incremental=False,
                                  device="cpu")
            got = card.compute_whatif(topo, sub) + [card.compute(topo)]
            want = cpu.compute_whatif(topo, sub) + [cpu.compute(topo)]
            require(all(same_planes(a, b) for a, b in zip(got, want)),
                    f"{engine} at max_iters={mi} differs from the CPU path")
    print(f"truncation: fused, packed and hybrid at max_iters {list(ENGINE_LIMITS)} on the card "
          f"equal to the CPU path ({ENGINE_LIMIT_SCENARIOS} scenarios and compute())",
          flush=True)

    # (d) the tuner arm.
    path = Path(tempfile.mkdtemp()) / "tuner.json"
    tuner = pipeline.configure_engine_tuner(path=path, explore_rounds=2)
    try:
        tbe = TorchSpfBackend(device=dev)
        for i in range(TUNER_CALLS):
            res = tbe.compute_whatif(topo, masks)
            require(all(same_planes(a, b) for a, b in zip(res, gres)) and len(res) == BATCH,
                    f"tuned compute_whatif {i} differs from seq's planes")
            del res
        for i in range(TUNER_CALLS):
            require(same_planes(tbe.compute(topo), gone), f"tuned compute() {i} differs from seq")
        x["tuner_rows"] = tuner.ledger()
        x["tuner_decisions"] = tuner.stats()["decisions"]
        explored = {(k, e) for (k, e, _) in x["tuner_decisions"]}
        for kind in ("whatif", "one"):
            require((kind, "tropical") in explored, f"the tuner never ran tropical for {kind}")
        for row in x["tuner_rows"]:
            picks = {f"{e}/{ph}": c for (k, e, ph), c in x["tuner_decisions"].items()
                     if k == row["kind"]}
            print(f"tuner bucket {row['kind']} {row['bucket']}: winner {row['winner']} "
                  f"({row['basis']}); medians ms "
                  f"{ {e: v['median_ms'] for e, v in row['engines'].items()} }; samples "
                  f"{ {e: v['samples'] for e, v in row['engines'].items()} }; picks {picks}",
                  flush=True)
        require(tuner.save(), "the tuner table was not saved")
        cold = pipeline.EngineTuner(path=path)
        for kind, batch in (("whatif", BATCH), ("one", 1)):
            bucket = pipeline.shape_bucket(n, topo.n_edges, batch, None)
            require(cold.pick(kind, bucket) == tuner.current_winner(kind, bucket),
                    f"a cold tuner picks another {kind} engine")
        # The depth cap: full-rebuild walls (fresh clones), then a chain.
        dbe = TorchSpfBackend(device=dev)
        for t in [synth.clone_topology(topo) for _ in range(TUNER_REMARSHALS)]:
            dbe.compute(t)
        base = synth.clone_topology(topo)
        dbe.compute(base)
        chain = delta_chain(graph, synth, base, K)
        for i, (label, t) in enumerate(chain):
            paths = Counter(dbe.delta_paths)
            res = dbe.compute(t)
            paths = Counter(dbe.delta_paths) - paths
            require(paths.get((graph.delta_kind(t.delta_base), "incremental")) == 1,
                    f"tuned chain step {label} was not incremental: {dict(paths)}")
            if i in (0, len(chain) - 1):
                full = TorchSpfBackend(device=dev, incremental=False)
                require(same_planes(res, full.compute(synth.clone_topology(t))),
                        f"tuned chain step {label} differs from the full path")
        bucket = pipeline.shape_bucket(n, topo.n_edges, 1, None)
        cap = se.shared_graph_cache(dev)._depth_cap(topo)
        arms = tuner.snapshot()["depth"].get(json.dumps(list(bucket)), {})
        require(cap == tuner.max_delta_depth(bucket, default=256),
                "the graph cache's depth cap is not the tuned one")
        x["depth_cap"] = cap
        print(f"tuner depth cap: {cap} (delta walls {len(arms.get('delta', []))}, full walls "
              f"{len(arms.get('full', []))}; medians ms delta "
              f"{1e3 * statistics.median(arms['delta']):.3f}, full "
              f"{1e3 * statistics.median(arms['full']):.3f}); a cold tuner picks the saved "
              f"winners", flush=True)
    finally:
        pipeline.reset_engine_tuner()

    # Times: each engine's warm calls (medians) beside seq's, and the fused
    # round a launch against its bound.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    for engine, walls in x["times"].items():
        med = {kind: (statistics.median(h for h, _ in w[1:]), statistics.median(e for _, e in w[1:]),
                      w[0][0]) for kind, w in walls.items()}
        x["times"][engine] = med
        print(f"time engine {engine}: compute_whatif {med['whatif'][0]:.3f} ms host clock, "
              f"{med['whatif'][1]:.3f} ms between CUDA events (median of {ENGINE_WARM_REPS} warm; "
              f"cold {med['whatif'][2]:.3f} ms); compute() {med['compute'][0]:.3f} ms host, "
              f"{med['compute'][1]:.3f} ms events (cold {med['compute'][2]:.3f} ms); {smi}",
              flush=True)
    x["row"] = {}
    for packed, layout in ((False, "planar"), (True, "interleaved")):
        big, small = x["hold"][(packed, BATCH)], x["hold"][(packed, 1)]
        ops = sum(w["ops"] for w in big.work)
        byts = sum(w["bytes"] for w in big.work)
        geo, geo1 = x["geometry"][(packed, BATCH)], x["geometry"][(packed, 1)]
        row = {
            "ms": statistics.mean(big.launch_ms), "dispatch_ms": sum(big.launch_ms),
            "launch_ms": big.launch_ms, "plain_ms": statistics.mean(big.plain_ms),
            "bound_ms": statistics.mean(w["bound"][0] for w in big.work),
            "bound_by": bound(ops, byts)[1], "launch_bound_ms": [w["bound"][0] for w in big.work],
            "dispatch_bound_ms": sum(w["bound"][0] for w in big.work),
            "full_round_bound_ms": statistics.mean(w["full_bound"][0] for w in big.work),
            "recomputed_entries": [w["recomputed"] for w in big.work],
            "copied_entries": [w["copied"] for w in big.work],
            "ms_b1": statistics.mean(small.launch_ms), "plain_ms_b1": statistics.mean(small.plain_ms),
            "bound_ms_b1": statistics.mean(w["bound"][0] for w in small.work),
            "full_round_bound_ms_b1": statistics.mean(w["full_bound"][0] for w in small.work),
            "device_ms_b1": x["device_b1"][packed], "launches_b1": len(small.launch_ms),
            "form": geo["form"], "tiles": geo["tiles"], "registers": geo["registers"],
            "form_b1": geo1["form"], "registers_b1": geo1["registers"], "vec4_b1": geo1["vec4"],
            "max_abs_err": max(h.err for (pk, _), h in x["hold"].items() if pk == packed),
        }
        x["row"][layout] = row
        print(f"time ell_fused_round {layout}: {row['ms']:.3f} ms a launch at B={BATCH} (mean of "
              f"{len(big.launch_ms)}, CUDA events: {[round(t, 3) for t in big.launch_ms]}), "
              f"dispatch {row['dispatch_ms']:.3f} ms; frontier bound {row['bound_ms']:.4f} ms a "
              f"launch by {row['bound_by']} ({[round(b, 4) for b in row['launch_bound_ms']]}; "
              f"{ops} operations, {byts} bytes over the dispatch), full round "
              f"{row['full_round_bound_ms']:.4f} ms; plain {row['plain_ms']:.3f} ms; {geo['form']} "
              f"form, {geo['tiles']} tiles a warp, {geo['registers']} registers; at B=1 "
              f"{row['ms_b1']:.4f} ms a launch (host launch included, {row['launches_b1']} "
              f"launches), {row['device_ms_b1']:.4f} ms a dispatch on the device, frontier bound "
              f"{row['bound_ms_b1']:.5f} ms (full round {row['full_round_bound_ms_b1']:.5f}), "
              f"plain {row['plain_ms_b1']:.3f} ms, {geo1['form']} form, {geo1['registers']} "
              f"registers, int4 vector {geo1['vec4']}; {smi}", flush=True)
    x["phase_s"] = time.perf_counter() - t_phase
    print(f"engines phase checked in {x['phase_s']:.1f} s", flush=True)
    return x


class TropHolder:
    """Within ``holding_trop()``, every trop_relax call (the tile pass and,
    with repair pairs, the repair pass) runs (and counts) as before, timed
    by CUDA events, its work counted (trop_work), and is held at once:
    ``out`` is snapshotted before the launch and must equal ``dist`` outside
    the input frontier (the copy rule's precondition), and all three outputs
    (distances, changed flag, next frontier) must be bit-identical to
    trop_relax_plain's from the snapshot; the repair pairs' entries are held
    apart too (the repair pass's error)."""

    def __init__(self, kt):
        self.kt = kt
        self.err = self.repair_err = 0
        self.launch_ms, self.plain_ms, self.work = [], [], []

    def wrap(self, fn):
        kt = self.kt

        def held_relax(*args):
            tiles, _, dist, active, out, *rest = args
            lanes = dist.shape[1]
            front = kt._unpack(active, slice(0, lanes)).repeat_interleave(tiles.shape[2], 0)
            label = f"at {lanes} lanes, launch {len(self.launch_ms) + 1}"
            require(torch.equal(out[~front], dist[~front]),
                    f"trop_relax {label}: out differs from dist outside the input frontier")
            snap = out.clone()
            got, ms = cuda_call(lambda: fn(*args))
            want, plain_ms = cuda_call(lambda: kt.trop_relax_plain(*args[:4], snap, *rest))
            self.err = max(self.err, held("trop_relax", label, got, want))
            repair = rest[0] if rest else None
            if repair is not None and repair.pairs.shape[0]:
                r, s = repair.pairs.long().unbind(1)
                self.repair_err = max(self.repair_err, held(
                    "trop_repair", label, (got[0][r, s],), (want[0][r, s],)))
            self.launch_ms.append(ms)
            self.plain_ms.append(plain_ms)
            self.work.append(trop_work(*args[:4], snap, *rest, new=want[0]))
            return got

        return held_relax


@contextlib.contextmanager
def holding_trop(kt, holder: TropHolder):
    fn = kt.trop_relax
    kt.trop_relax = holder.wrap(fn)
    try:
        yield holder
    finally:
        kt.trop_relax = fn


def trop_work(tiles, cb, dist, active, out, repair=None, src=None, cost=None, slot=None,
              mask=None, perm=None, inv=None, new=None) -> dict:
    """What one trop_relax call must do, and its bound, a floor: operations
    (TROP_TILE_OPS per (tile entry, lane) of an active source block,
    TROP_REPAIR_OPS per (valid slot, lane) of a repair pair) against the
    bytes the function must move at the HBM rate, each input byte read once
    and each output byte written once.  Read: cb, the tiles of the slots
    whose source block is active in some lane, the frontier, the repair
    pairs, and of dist the rows of each (block, lane) that is in the
    frontier (the gathered sources, and what the copy rule copies) or has an
    active source (the old values); per repair row its perm entry and slot
    row, per valid slot up in one of its repair lanes the src, cost and inv
    entries and the source's dist entry, and one mask word for each (valid
    slot, lane word) its pairs touch.  Written: the next frontier, and of
    out (which holds dist outside the frontier) the frontier's entries and
    those that change (``new``, the round's result).  ``*_full_write``: the
    floor of the contract before the copy rule (dist read and out written
    whole, the repair plane read whole, the repair sources in dist's read).
    ``repair_*``: the repair pass's share."""
    from holo_tpu_torch.kernels import ell

    nb, tm, b, _ = tiles.shape
    npad, lanes = dist.shape
    act = ell._unpack(active, slice(0, lanes))  # [NB, S]
    real = cb < nb
    csafe = torch.where(real, cb, 0).long()
    per_slot = torch.where(real, act.sum(1)[csafe], 0)  # active lanes of each slot's source
    fed = torch.zeros_like(act)  # (row block, lane)s with an active source
    for t in range(tm):
        fed |= real[:, t, None] & act[csafe[:, t]]
    out_rows = act.repeat_interleave(b, 0)
    if new is not None:
        out_rows = out_rows | (new != dist)
    res = {"entry_lanes": b * b * int(per_slot.sum()), "active_slots": int((per_slot > 0).sum()),
           "front_block_lanes": int(act.sum()), "fed_block_lanes": int(fed.sum()),
           "written_entries": int(out_rows.sum())}
    ops = TROP_TILE_OPS * res["entry_lanes"]
    fixed = 4 * (cb.numel() + res["active_slots"] * b * b + 2 * active.numel())
    dist_read = 4 * b * int((act | fed).sum())
    res["repair_pairs"] = 0
    rep_ops = rep_bytes = rep_bytes_old = 0
    if repair is not None:
        bits = repair.bits
        rows = ell._unpack(bits, slice(0, lanes)).any(1).nonzero().squeeze(1)
        rep = bits[rows]  # [R, W] the repair rows' lane words
        edges = slot[perm[rows].long()].long()  # [R, K]
        valid = edges >= 0
        pairs = ell._unpack(rep, slice(0, lanes)).sum(1)  # repair lanes of each row
        res["repair_pairs"] = int(pairs.sum())
        rep_ops = TROP_REPAIR_OPS * int((valid.sum(1) * pairs).sum())
        if mask is None:
            up, mask_words = valid, 0
        else:
            words = mask[torch.where(valid, edges, 0)] & rep[:, None, :]  # [R, K, W]
            up = valid & (words != 0).any(2)
            mask_words = int((valid.sum(1) * (rep != 0).sum(1)).sum())
        per_row = rows.numel() * (1 + edges.shape[1]) + mask_words
        rep_bytes = 4 * (3 * res["repair_pairs"] + per_row + 4 * int(up.sum()))
        rep_bytes_old = 4 * (bits.numel() + per_row + 3 * int(up.sum()))
    byte_count = fixed + dist_read + 4 * res["written_entries"] + rep_bytes
    full = fixed + 2 * 4 * npad * lanes + rep_bytes_old
    res.update(ops=ops + rep_ops, bytes=byte_count, bound=bound(ops + rep_ops, byte_count),
               bytes_full_write=full, bound_full_write=bound(ops + rep_ops, full),
               repair_ops=rep_ops, repair_bytes=rep_bytes, repair_bound=bound(rep_ops, rep_bytes))
    return res


def trop_phase(ell, se, dev, topo, masks, gres, gone, gmr, mr_roots, oracle, compute_ref,
               mr_ref, n_atoms) -> dict:
    """Phase 3k: the tropical engine on the k=90 fat tree.  (a) The tile
    marshal.  (b) With the launch counts at 0 before each, a tropical
    backend's compute_whatif (1024 scenarios), compute(), compute_multiroot
    (64 roots), masked compute() and the DeltaPath chain, every trop_relax
    launch of the first of each (and of chain step 0) held to
    trop_relax_plain; trop_relax must launch on each; every scenario equals
    seq's planes, scenarios 0-7, compute(), roots 0-7 and chain steps 0-1 the
    oracle; every chain step is incremental on the tiles (tile deltas
    applied in place) and equals seq's.  (c) Warm what-if, compute() and
    multiroot of seq, fused and tropical, timed in turns.  (d) T1 a launch
    against its bound at 1024 lanes and at one, its full round, launch 1
    split, the repair pass, the launch geometry, and the repair set built on
    the card against the host's."""
    from holo_tpu_torch.kernels import tropical as kt
    from holo_tpu_torch.ops import graph
    from holo_tpu_torch.ops import tropical as trop
    from holo_tpu_torch.spf import synth
    from holo_tpu_torch.spf.backend import TorchSpfBackend
    from holo_tpu_torch.spf.scalar import spf_reference

    t_phase = time.perf_counter()
    x = {"launches": {}, "hold": {}}
    n = topo.n_vertices
    # (a) the tile marshal, from the ELL planes the graph cache mirrors.
    ell_np = graph.build_ell(topo, n_atoms=n_atoms)
    t0 = time.perf_counter()
    host, meta = trop.build_tiles_host(ell_np.in_src, ell_np.in_cost, ell_np.in_valid)
    x["marshal_ms"] = (time.perf_counter() - t0) * 1e3
    x["meta"] = {k: meta[k] for k in ("block", "nb", "tm", "pairs")}
    x["tile_mb"] = host.tiles.nbytes / 1e6
    print(f"tropical tiles: B {meta['block']}, NB {meta['nb']}, Tm {meta['tm']}, "
          f"{meta['pairs']} real tiles, tile plane {x['tile_mb']:.1f} MB; build_tiles_host "
          f"{x['marshal_ms']:.1f} ms (host clock)", flush=True)
    del host

    # (b) the main path, counted; the first call of each path held.
    be = TorchSpfBackend(one_engine="tropical", device=dev)

    def counted(label: str, fn, hold: bool):
        kt.reset_launches()
        ell.reset_launches()
        holder = TropHolder(kt) if hold else None
        with (holding_trop(kt, holder) if hold else contextlib.nullcontext()):
            out, host, ev = timed_call(fn)
        got = {"trop_relax": kt.launches["trop_relax"], "trop_repair": kt.launches["trop_repair"],
               **{k: v for k, v in ell.launches.items() if v}}
        require(got["trop_relax"] > 0, f"tropical {label}: trop_relax never launched")
        if label in ("whatif", "masked"):
            require(got["trop_repair"] > 0, f"tropical {label}: trop_repair never launched")
        x["launches"].setdefault(label, []).append(got)
        if hold:
            require(len(holder.launch_ms) == got["trop_relax"],
                    f"tropical {label}: a trop_relax launch was not held")
            x["hold"][label] = holder
        return out, host, ev

    res, _, _ = counted("whatif", lambda: be.compute_whatif(topo, masks), True)
    require(len(res) == BATCH and all(same_planes(a, b) for a, b in zip(res, gres)),
            "a tropical what-if scenario differs from seq's planes")
    for b in range(ORACLE_SCENARIOS):
        require(same_planes(res[b], oracle_result(oracle[b], n_atoms)),
                f"tropical scenario {b} differs from the scalar oracle")
    del res
    one, _, _ = counted("compute", lambda: be.compute(topo), True)
    require(same_planes(one, gone) and same_planes(one, oracle_result(compute_ref, n_atoms)),
            "tropical compute() differs from seq's or the oracle's planes")
    mr, _, _ = counted("multiroot", lambda: be.compute_multiroot(topo, mr_roots), True)
    for f in ("dist", "parent", "hops"):
        require(np.array_equal(getattr(mr, f), getattr(gmr, f)),
                f"tropical multiroot {f} differs from seq's")
        require(np.array_equal(getattr(mr, f)[:ORACLE_ROOTS], getattr(mr_ref, f)),
                f"tropical multiroot {f} differs from the scalar oracle")
    # Scenario 1's mask (scenario 0 fails nothing): its repair pairs at one lane.
    masked, _, _ = counted("masked", lambda: be.compute(topo, masks[1]), True)
    require(same_planes(masked, gres[1]) and same_planes(masked, oracle_result(oracle[1], n_atoms)),
            "tropical masked compute() differs from seq's or the oracle's planes")
    x["repair_pairs_masked"] = sum(w["repair_pairs"] for w in x["hold"]["masked"].work)
    print(f"tropical main path: launches {x['launches']}; all {BATCH} scenarios equal to seq's "
          f"planes, scenarios 0-{ORACLE_SCENARIOS - 1}, compute(), the masked compute() and roots "
          f"0-{ORACLE_ROOTS - 1} equal to the oracle, the {MULTIROOT} roots to seq's; every "
          f"trop_relax launch of each held to trop_relax_plain ("
          + ", ".join(f"{k} {len(h.launch_ms)}" for k, h in x["hold"].items()) + ")", flush=True)
    # The DeltaPath chain, seq's backend following it on the same cache.
    base = synth.clone_topology(topo)
    sbe = TorchSpfBackend(device=dev)
    be.compute(base)
    sbe.compute(base)
    be._gather_cache.tile_deltas.clear()
    chain = delta_chain(graph, synth, base, K)
    for i, (label, t) in enumerate(chain):
        paths = Counter(be.delta_paths)
        res, _, _ = counted("chain", lambda t=t: be.compute(t), i == 0)
        paths = Counter(be.delta_paths) - paths
        require(paths.get((graph.delta_kind(t.delta_base), "incremental")) == 1,
                f"tropical chain step {label} was not incremental: {dict(paths)}")
        require(same_planes(res, sbe.compute(t)), f"tropical chain step {label} differs from seq")
        if i < 2:
            require(same_planes(res, oracle_result(spf_reference(t), n_atoms)),
                    f"tropical chain step {label} differs from the oracle")
    x["tile_deltas"] = dict(be._gather_cache.tile_deltas)
    require(x["tile_deltas"] == {"apply": len(chain)},
            f"the chain's tile deltas were not all applied in place: {x['tile_deltas']}")
    print(f"tropical chain: {len(chain)} steps incremental on the tiles, each equal to seq's "
          f"(steps 0-1 the oracle); tile deltas {x['tile_deltas']}; launches a step "
          f"{[c['trop_relax'] for c in x['launches']['chain']]}", flush=True)
    snap = be.breaker.snapshot()
    require(not any(snap[k] for k in ("failures", "fallbacks", "refusals")),
            f"the tropical backend's breaker counted {snap}")

    # (c) warm calls of seq, fused and tropical, in turns.
    backends = {"seq": TorchSpfBackend(device=dev), "fused": TorchSpfBackend(
        one_engine="fused", device=dev), "tropical": be}
    calls = {"whatif": (lambda b: b.compute_whatif(topo, masks), TROP_WARM_REPS),
             "compute": (lambda b: b.compute(topo), COMPUTE_REPS),
             "multiroot": (lambda b: b.compute_multiroot(topo, mr_roots), TROP_WARM_REPS)}
    times = {e: {kind: [] for kind in calls} for e in backends}
    for b_ in backends.values():  # warm-up
        for fn, _ in calls.values():
            fn(b_)
    for kind, (fn, reps) in calls.items():
        for _ in range(reps):
            for e, b_ in backends.items():
                times[e][kind].append(timed_call(lambda: fn(b_))[1])
    x["times"] = {e: {kind: statistics.median(v) for kind, v in d.items()}
                  for e, d in times.items()}
    x["times_all"] = times

    # (d) T1 a launch: the held launches at 1024 lanes and at one, the full
    # round (every block active) at 1024, the repair set's build.
    eg = be.prepare(topo, need_edge_ids=True)
    tt = be._gather_cache.get_tropical(topo, n_atoms)
    mask_w = se.pack_edge_masks(masks, dev)
    lane_roots = torch.full((BATCH,), topo.root, dtype=torch.int32, device=dev)
    p = se.lane_planes(eg, mask_w)
    bits = trop.repair_bits(p.slot, mask_w, BATCH, tt)
    rep = kt.repair_set(bits, BATCH)
    dist, _ = trop.tile_relax(eg, tt, se.distance_seed(n, lane_roots)[0], mask_w)
    dist_p = dist[tt.perm.long()].contiguous()
    nb, _, b, _ = tt.tiles.shape
    full = ell.full_frontier(nb, BATCH, dev)
    ell_args = (p.src, p.cost, p.slot, p.mask, tt.perm, tt.inv)
    # The full round writes every entry (its frontier is all ones): any out.
    args = (tt.tiles, tt.cb, dist_p, full, torch.empty_like(dist_p), rep, *ell_args)
    kt.trop_relax(*args)  # warm-up
    x["full_ms"] = cuda_ms(lambda: kt.trop_relax(*args), KERNEL_REPS)
    want = kt.trop_relax_plain(*args[:4], torch.empty_like(dist_p), *args[5:])
    x["full_work"] = trop_work(*args, new=want[0])
    x["full_err"] = held("trop_relax", "full round at 1024 lanes", kt.trop_relax(*args), want)
    x["repair_ms"] = cuda_ms(lambda: trop.repair_bits(p.slot, mask_w, BATCH, tt), KERNEL_REPS)
    x["repair_list_ms"] = host_ms(lambda: kt.repair_set(bits, BATCH), KERNEL_REPS)
    # Where launch 1 of the what-if dispatch goes (the roots' block active,
    # out a copy of the seeds as tile_relax passes it): with its repair set,
    # without it, and with no block active and no repair row (the launch
    # itself); CUDA events and the profiler's device time of the kernels.
    # Repeated launches into one out give the same result: each rewrites
    # the frontier's entries and those that change.
    seed_p = se.distance_seed(n, lane_roots)[0][tt.perm.long()].contiguous()
    front1 = ell.pack_lane_bits((seed_p < INF).view(nb, b, BATCH).any(1))
    split = {"launch 1": (front1, rep), "launch 1 without repair": (front1, None),
             "no block, no repair": (torch.zeros_like(front1), None)}
    x["launch1"] = {}
    for label, (a_, r_) in split.items():
        args_ = (tt.tiles, tt.cb, seed_p, a_, seed_p.clone(), r_, *ell_args)
        kt.trop_relax(*args_)  # warm-up
        per = device_times(lambda: [kt.trop_relax(*args_) for _ in range(KERNEL_REPS)])
        want = kt.trop_relax_plain(*args_[:4], seed_p.clone(), *args_[5:])
        x["launch1"][label] = {
            "ms": cuda_ms(lambda: kt.trop_relax(*args_), KERNEL_REPS),
            "device_ms": sum(ms for key, ms in per.items() if "trop_" in key) / KERNEL_REPS,
            "repair_device_ms": sum(ms for key, ms in per.items()
                                    if "trop_repair" in key) / KERNEL_REPS,
            "bound_ms": trop_work(*args_, new=want[0])["bound"][0]}
    x["repair_plain_ms"] = cuda_ms(lambda: kt.repair_plain(seed_p, rep.pairs, *ell_args), KERNEL_REPS)
    # The launch geometry: the tile and row forms at k=90's B, and the
    # tile form of every B the kernel is built for, at 1024 lanes.
    x["geometry"] = {f"B={b} x {lanes}": kt.geometry(b, lanes, nb)
                     for lanes in (BATCH, MULTIROOT, 1)}
    x["geometry"].update({f"B={bb} x {BATCH}": kt.geometry(bb, BATCH, nb) for bb in kt.BLOCKS})
    for key, geo in x["geometry"].items():
        print(f"geometry trop_relax {key} (NB {nb}): {geo}", flush=True)
    t0 = time.perf_counter()
    rows = trop.repair_rows_host(topo.edge_dst, masks, n)
    x["repair_host_ms"] = (time.perf_counter() - t0) * 1e3
    require(not bool((bits & ~trop.rows_to_bits(rows, tt)).any()),
            "the card's repair set is not within the host's")
    x["repair_rows"] = (int(rep.pairs.shape[0]), int((rows < n).sum()))
    x["lane_prog"] = lambda: trop.tropical_lanes(eg, tt, lane_roots, mask_w)
    x["compute_call"] = lambda: be.compute(topo)
    x["phase_s"] = time.perf_counter() - t_phase
    print(f"tropical phase checked in {x['phase_s']:.1f} s", flush=True)
    return x


def count_work(cnt, cb, x, seed) -> dict:
    """What one trop_count_round call must do, and its bound, a floor:
    operations (TROP_COUNT_OPS per (nonzero count entry of a real slot,
    lane), TROP_COUNT_CELL_OPS per output entry) against the bytes the
    function must move at the HBM rate, each input byte read once and each
    output byte written once.  Read: the nonzero count entries of the real
    slots, each with a 4-byte index (the zero entries add nothing), the
    listed slots' cb, x whole (every row is a source or is compared for the
    changed flag) and the seed plane whole where there is one; written: out
    whole and the flag.  ``tile_bound`` is the looser floor that reads cb and
    every real tile's counts whole in place of the nonzero entries."""
    nb, _, b, _ = cnt.shape
    npad, lanes = x.shape
    real = cb < nb
    nz = (cnt != 0) & real[:, :, None, None]
    nnz = int(nz.sum())
    listed = int(nz.flatten(2).any(2).sum())
    ops = TROP_COUNT_OPS * nnz * lanes + TROP_COUNT_CELL_OPS * npad * lanes
    planes = 2 + (seed is not None)  # x, out and the seed
    dense = 4 * (planes * npad * lanes + 1)
    byte_count = 4 * (2 * nnz + listed) + dense
    tile_bytes = 4 * (cb.numel() + int(real.sum()) * b * b) + dense
    return {"nnz": nnz, "real_slots": int(real.sum()), "listed_slots": listed, "ops": ops,
            "bytes": byte_count, "bound": bound(ops, byte_count), "tile_bytes": tile_bytes,
            "tile_bound": bound(ops, tile_bytes)}


class CountHolder:
    """Within ``holding_count()``, every trop_count_round call (T2) runs (and
    counts) as before, timed by CUDA events, and is held at once: ``out``
    and the changed flag bit-identical to trop_count_plain's on the same
    CUDA inputs (``x``, which the round does not write, and a fresh out),
    each count list (one a fixpoint) to count_list's on CPU copies; its work
    is counted (count_work), and the first inputs of each lane width are
    kept."""

    def __init__(self, kt):
        self.kt = kt
        self.err = 0
        self.launch_ms, self.plain_ms, self.work, self.lanes = [], [], [], []
        self.inputs = {}
        self.lists = 0
        self._last_list = None

    def hold_list(self, cnt, cb, listed):
        want = self.kt.count_list(cnt.cpu(), cb.cpu())
        n = listed.n.cpu()
        require(torch.equal(n, want.n), "a count list's lengths differ from the CPU's")
        slots = listed.slots.cpu()
        keep = torch.arange(cb.shape[1])[None, :] < n[:, None]
        require(torch.equal(slots[keep], want.slots[keep]),
                "a count list's slots differ from the CPU's")
        self.lists += 1

    def wrap(self, fn):
        kt = self.kt

        def held_count(cnt, cb, listed, x, seed, out, root=-1):
            lanes = x.shape[1]
            label = f"at {lanes} lanes, launch {len(self.launch_ms) + 1}"
            if listed is not self._last_list:
                self.hold_list(cnt, cb, listed)
                self._last_list = listed
            got, ms = cuda_call(lambda: fn(cnt, cb, listed, x, seed, out, root))
            want, plain_ms = cuda_call(
                lambda: kt.trop_count_plain(cnt, cb, None, x, seed, torch.empty_like(x), root))
            self.err = max(self.err, held("trop_count", label, got, want))
            self.launch_ms.append(ms)
            self.plain_ms.append(plain_ms)
            self.lanes.append(lanes)
            self.work.append(count_work(cnt, cb, x, seed))
            if lanes not in self.inputs:
                self.inputs[lanes] = (cnt, cb, x.clone(), None if seed is None else seed.clone(),
                                      root)
            return got

        return held_count


@contextlib.contextmanager
def holding_count(kt, holder: CountHolder):
    fn = kt.trop_count_round
    kt.trop_count_round = holder.wrap(fn)
    try:
        yield holder
    finally:
        kt.trop_count_round = fn


def count_launch(kt, cnt, cb, x, seed, root) -> dict:
    """T2 alone on one held launch's inputs: CUDA-event ms of the kernel and
    of its plain version, of the count list's build (once a fixpoint), the
    floors, the launch geometry, and the one PyTorch call that computes the
    same contraction (a float64 ``einsum``: exact, every partial sum is an
    integer below 2**31 < 2**53; timed here, never on the path), held equal
    to the plain round once seeded, clamped and rooted."""
    nb, _, b, _ = cnt.shape
    npad, lanes = x.shape
    out = torch.empty_like(x)
    listed = kt.count_list(cnt, cb)

    def run():
        return kt.trop_count_round(cnt, cb, listed, x, seed, out, root)

    run()  # warm-up
    want = kt.trop_count_plain(cnt, cb, None, x, seed, torch.empty_like(x), root)
    real = cb < nb
    cf = torch.where(real[:, :, None, None], cnt, 0).double()
    xf = x.view(nb, b, lanes)[torch.where(real, cb, 0).long()].double()  # [NB, Tm, B, A]

    def library():
        return torch.einsum("rtij,rtja->ria", cf, xf)

    tot = library().round().long().view(npad, lanes)
    new = (tot if seed is None else tot + seed).clamp_max(kt.MP_SAT).to(torch.int32)
    if root >= 0:
        new[root] = 1
    require(torch.equal(new, want[0]), f"the float64 einsum at {lanes} lanes is not the round")
    err = held("trop_count", f"alone at {lanes} lanes", run(), want)
    return {"ms": cuda_ms(run, KERNEL_REPS),
            "plain_ms": cuda_ms(lambda: kt.trop_count_plain(cnt, cb, None, x, seed,
                                                            torch.empty_like(x), root),
                                KERNEL_REPS),
            "library_ms": cuda_ms(library, KERNEL_REPS), "work": count_work(cnt, cb, x, seed),
            "list_ms": cuda_ms(lambda: kt.count_list(cnt, cb), KERNEL_REPS),
            "list_run": lambda: kt.count_list(cnt, cb), "geometry": kt.count_geometry(b, lanes, nb),
            "err": err, "run": run}


def trop_mp_phase(ell, se, dev, topo, masks, m_ref, m_step_ref, n_atoms) -> dict:
    """Phase 3l: the tropical engine's multipath program on the k=90 fat
    tree.  (a) With the launch counts at 0 before each, a tropical backend's
    compute(multipath_k=4) and =8, a masked compute(masks[1], multipath_k=4)
    and the DeltaPath chain at multipath_k=4, each of which must launch
    trop_relax and trop_count (the masked one trop_repair too); every T2
    launch of each compute and of chain step 0 held to trop_count_plain, and
    their count lists to the CPU's; all nine planes equal a seq backend's mp
    planes, compute() and chain steps 0-1 the oracle's; every chain step
    incremental on the tiles, its tile delta applied in place.  (b) mp
    against mp_tropical compute(), in turns.  (c) T2 a launch at 1 and 32 W
    lanes against its floors, its plain version and a float64 einsum, with
    its geometry and the count list's build.  (d) A tuner armed: the kp = 4
    compute() bucket measures mp and mp_tropical."""
    from holo_tpu_torch import pipeline
    from holo_tpu_torch.kernels import tropical as kt
    from holo_tpu_torch.ops import graph
    from holo_tpu_torch.spf import synth
    from holo_tpu_torch.spf.backend import TorchSpfBackend

    t_phase = time.perf_counter()
    x = {"launches": {}, "hold": {}}
    be = TorchSpfBackend(one_engine="tropical", device=dev)
    sbe = TorchSpfBackend(device=dev)

    # (a) the main path, counted; the first call of each path held.
    def counted(label: str, fn, hold: bool):
        kt.reset_launches()
        ell.reset_launches()
        holder = CountHolder(kt) if hold else None
        with (holding_count(kt, holder) if hold else contextlib.nullcontext()):
            out = fn()
            torch.cuda.synchronize()
        got = {**kt.launches, **{k: v for k, v in ell.launches.items() if v}}
        for name in ("trop_relax", "trop_count") + (("trop_repair",) if label == "masked" else ()):
            require(got[name] > 0, f"mp_tropical {label}: {name} never launched")
        x["launches"].setdefault(label, []).append(got)
        if hold:
            require(len(holder.launch_ms) == got["trop_count"],
                    f"mp_tropical {label}: a trop_count launch was not held")
            require(holder.lists == 2, f"mp_tropical {label}: {holder.lists} count lists held, "
                                       f"not one a fixpoint")
            x["hold"][label] = holder
        return out

    for k in MP_KS:
        res = counted(f"compute k={k}", lambda k=k: be.compute(topo, multipath_k=k), True)
        require(same_nine(res, sbe.compute(topo, multipath_k=k)),
                f"mp_tropical compute(k={k}) differs from mp's planes")
        require(same_nine(res, m_ref[k]), f"mp_tropical compute(k={k}) differs from the oracle")
    res = counted("masked", lambda: be.compute(topo, masks[1], multipath_k=MP_K), True)
    require(same_nine(res, sbe.compute(topo, masks[1], multipath_k=MP_K)),
            "mp_tropical masked compute() differs from mp's planes")
    x["npaths_max"] = int(res.npaths.max())
    base = synth.clone_topology(topo)
    be.compute(base, multipath_k=MP_K)
    sbe.compute(base, multipath_k=MP_K)
    be._gather_cache.tile_deltas.clear()
    chain = delta_chain(graph, synth, base, K)
    for i, (label, t) in enumerate(chain):
        paths = Counter(be.delta_paths)
        res = counted("chain", lambda t=t: be.compute(t, multipath_k=MP_K), i == 0)
        paths = Counter(be.delta_paths) - paths
        require(paths.get((graph.delta_kind(t.delta_base), "incremental")) == 1,
                f"mp_tropical chain step {label} was not incremental: {dict(paths)}")
        require(same_nine(res, sbe.compute(t, multipath_k=MP_K)),
                f"mp_tropical chain step {label} differs from mp's planes")
        if i < len(m_step_ref):
            require(same_nine(res, m_step_ref[i]),
                    f"mp_tropical chain step {label} differs from the oracle")
    x["tile_deltas"] = dict(be._gather_cache.tile_deltas)
    require(x["tile_deltas"] == {"apply": len(chain)},
            f"the mp_tropical chain's tile deltas were not all applied in place: "
            f"{x['tile_deltas']}")
    snap = be.breaker.snapshot()
    require(not any(snap[k] for k in ("failures", "fallbacks", "refusals")),
            f"the mp_tropical backend's breaker counted {snap}")
    print(f"mp_tropical main path: launches {x['launches']}; compute(k={list(MP_KS)}), the "
          f"masked compute() and the {len(chain)} chain steps equal to mp's nine planes, "
          f"compute() and steps 0-{len(m_step_ref) - 1} to the oracle; every step incremental "
          f"on the tiles, tile deltas {x['tile_deltas']}; every trop_count launch of each held "
          f"to trop_count_plain ("
          + ", ".join(f"{k} {len(h.launch_ms)}" for k, h in x["hold"].items()) + ")", flush=True)

    # (b) mp against mp_tropical compute(), warm, in turns.
    backends = {"mp": sbe, "mp_tropical": be}
    times = {e: {k: [] for k in MP_KS} for e in backends}
    for b_ in backends.values():
        for k in MP_KS:
            b_.compute(topo, multipath_k=k)  # warm-up
    for _ in range(COMPUTE_REPS):
        for k in MP_KS:
            for e, b_ in backends.items():
                times[e][k].append(timed_call(lambda b_=b_, k=k: b_.compute(
                    topo, multipath_k=k))[1])
    x["times"] = {e: {k: statistics.median(v) for k, v in d.items()} for e, d in times.items()}
    x["times_all"] = times

    # (c) T2 alone at one lane (path counts) and 32 W lanes (weights).
    x["t2"] = {lanes: count_launch(kt, *inp)
               for lanes, inp in sorted(x["hold"][f"compute k={MP_K}"].inputs.items())}
    require(sorted(x["t2"]) == [1, 32 * ((n_atoms + 31) // 32)],
            f"T2's lane widths {sorted(x['t2'])}")

    # (d) the tuner: the kp = 4 compute() bucket measures both engines.
    tuner = pipeline.configure_engine_tuner(explore_rounds=2, reprobe_every=0)
    try:
        tbe = TorchSpfBackend(device=dev)
        want = sbe.compute(topo, multipath_k=MP_K)
        for i in range(TROP_MP_TUNER_CALLS):
            require(same_nine(tbe.compute(topo, multipath_k=MP_K), want),
                    f"tuned compute(multipath_k={MP_K}) {i} differs from mp's planes")
        bucket = list(pipeline.shape_bucket(topo.n_vertices, topo.n_edges, 1, None, k=MP_K))
        row = next(r for r in tuner.ledger() if r["kind"] == "one" and r["bucket"] == bucket)
        require({"mp", "mp_tropical"} <= set(row["engines"]),
                f"the kp={MP_K} bucket did not measure both engines: {row}")
        x["tuner_row"] = row
        print(f"tuner bucket one {bucket}: winner {row['winner']} ({row['basis']}); medians ms "
              f"{ {e: v['median_ms'] for e, v in row['engines'].items()} }; samples "
              f"{ {e: v['samples'] for e, v in row['engines'].items()} }", flush=True)
    finally:
        pipeline.reset_engine_tuner()
    x["compute_call"] = lambda: be.compute(topo, multipath_k=MP_K)
    x["mp_compute_call"] = lambda: sbe.compute(topo, multipath_k=MP_K)
    x["phase_s"] = time.perf_counter() - t_phase
    print(f"mp_tropical phase checked in {x['phase_s']:.1f} s", flush=True)
    return x


def pipeline_phase(ell, dev, topo, masks, gone, mask_ref, m_one, chain, d_steps) -> dict:
    """Phase 3m: the dispatch pipeline on the k=90 fat tree.  (a) Through
    AsyncSpfBackend(TorchSpfBackend(), DispatchPipeline(depth=2)), all
    submitted before any is forced: compute(), compute(masks[1]),
    compute(multipath_k=4), phase 3d's chain (root 6075) interleaved with a
    second chain (8 toggles on the tree rooted at edge(1, 0)), a tropical backend's
    compute() and compute(multipath_k=4), and an AsyncFrrEngine table with an
    SPF ticket of the same topology; each held bit for bit to the synchronous
    compute() of the same input on another backend (and so to the oracle
    where phase 3d holds it), the table to the synchronous one; G1-G4,
    M1-M3, T1 and T2 launched through the pipeline; its stats: one entry in
    flight per key, nothing failed, shed, abandoned or respawned.  (b) The
    two chains continued by toggles, interleaved through the pipeline
    against the same calls back to back, on the caller's thread and on a
    thread of their own, in turns.  (c) launch_one /
    finish_one called directly on each path, held the same way and timed."""
    from holo_tpu_torch.frr.kernel import TABLE_PLANES
    from holo_tpu_torch.frr.manager import FrrConfig, FrrEngine
    from holo_tpu_torch.kernels import tropical as kt
    from holo_tpu_torch.ops import graph
    from holo_tpu_torch.pipeline import AsyncFrrEngine, AsyncSpfBackend, DispatchPipeline
    from holo_tpu_torch.spf import synth
    from holo_tpu_torch.spf.backend import TorchSpfBackend

    t_phase = time.perf_counter()
    x = {}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()

    def force(lazy):
        return lazy._ticket.result(timeout=PIPE_WAIT_S)

    def same_table(got, want) -> bool:
        return all(getattr(got, f).dtype == getattr(want, f).dtype
                   and np.array_equal(getattr(got, f), getattr(want, f)) for f in TABLE_PLANES)

    # The synchronous references, each on a backend of its own.
    topo2 = synth.clone_topology(topo)
    topo2.root = PIPE_ROOT2
    synth.assign_direct_atoms(topo2)
    chain2 = list(enumerate(toggles(graph, synth, topo2, K, len(chain))))
    sync2 = TorchSpfBackend(device=dev)
    ref2 = [sync2.compute(topo2)] + [sync2.compute(t) for _, t in chain2]
    require(sum(v for (_, path), v in sync2.delta_paths.items() if path == "incremental")
            == len(chain2), "the second chain did not stay incremental")
    sref = TorchSpfBackend(device=dev)
    masked = sref.compute(topo, masks[1])
    require(same_planes(masked, mask_ref), "compute(masks[1]) differs from the scalar oracle")
    tsync = TorchSpfBackend(device=dev, one_engine="tropical")
    trop = tsync.compute(topo)
    trop_mp = tsync.compute(topo, multipath_k=MP_K)
    require(same_planes(trop, gone) and same_nine(trop_mp, m_one[MP_K]),
            "the tropical engine's compute() differs from seq's or mp's")
    frr_cfg = FrrConfig(**FRR_CFG)
    fsync = FrrEngine("torch", device=dev)
    fsync.set_policy(frr_cfg)
    table = fsync.compute(topo)

    # (a) the held results, all submitted ahead, counted.
    pipe = DispatchPipeline(depth=2)
    inner = TorchSpfBackend(device=dev)
    abe = AsyncSpfBackend(inner, pipe)
    tbe = AsyncSpfBackend(TorchSpfBackend(device=dev, one_engine="tropical"), pipe)
    afe = AsyncFrrEngine(FrrEngine("torch", device=dev), pipe)
    afe.set_policy(frr_cfg)
    torch.cuda.synchronize()
    ell.reset_launches()
    kt.reset_launches()
    t0 = time.perf_counter()
    # Every dispatch on topo before the chain that claims its graph.
    held_ = [("compute()", abe.compute(topo), gone, 1),
             ("compute(masks[1])", abe.compute(topo, masks[1]), masked, 1),
             (f"compute(multipath_k={MP_K})", abe.compute(topo, multipath_k=MP_K), m_one[MP_K],
              MP_K),
             ("tropical compute()", tbe.compute(topo), trop, 1),
             (f"tropical compute(multipath_k={MP_K})", tbe.compute(topo, multipath_k=MP_K),
              trop_mp, MP_K),
             ("the SPF ticket beside FRR", abe.compute(topo), gone, 1)]
    frr_lazy = afe.compute(topo)
    held_.append(("chain B base", abe.compute(topo2), ref2[0], 1))
    for i, ((label, t), (_, t2)) in enumerate(zip(chain, chain2)):  # interleaved
        held_.append((f"chain A step {i} {label}", abe.compute(t), d_steps[i][2], 1))
        held_.append((f"chain B step {i}", abe.compute(t2), ref2[i + 1], 1))
    submit_ms = (time.perf_counter() - t0) * 1e3
    for label, lazy, want, kp in held_:
        got = force(lazy)
        require(same_nine(got, want) if kp > 1 else same_planes(got, want),
                f"pipelined {label} differs from the synchronous compute()")
    require(same_table(force(frr_lazy), table), "the pipelined FRR table differs")
    torch.cuda.synchronize()
    x["wall_ms"] = (time.perf_counter() - t0) * 1e3
    launched = {**{k: v for k, v in ell.launches.items() if v}, **kt.launches}
    for name in ("ell_relax", "ell_first_parent", "ell_nh_seed", "ell_nh_round", "ell_mp_round",
                 "ell_parent_sets", "ell_parent_weights", "trop_relax", "trop_count"):
        require(launched.get(name, 0) > 0, f"kernel {name} never launched through the pipeline")
    st = pipe.stats()
    require(st["max-inflight-per-key"] <= 1, f"two entries of one key in flight: {st}")
    require(st["sheds"] == 0 and st["hangs"] == 0 and st["worker-respawns"] == 0
            and st["worker-crashes"] == 0, f"a ticket was shed or abandoned, or a respawn: {st}")
    require(st["completed"] == st["submitted"] == len(held_) + 1, f"tickets lost: {st}")
    require(sum(v for (_, path), v in inner.delta_paths.items() if path == "incremental")
            == 2 * len(chain), f"a pipelined chain step left DeltaPath: {dict(inner.delta_paths)}")
    x["stats"] = st
    print(f"pipeline held: {len(held_) + 1} tickets submitted in {submit_ms:.3f} ms, all forced "
          f"in {x['wall_ms']:.3f} ms, each bit-identical to the synchronous compute() of its "
          f"input (nine planes at multipath_k={MP_K}; the chains' steps also to the oracle "
          f"where phase 3d holds it), the FRR table to the synchronous one; launches {launched}",
          flush=True)
    print(f"pipeline stats: {json.dumps(st)}", flush=True)

    # (b) the two chains continued by toggles: interleaved through the
    # pipeline against the same calls back to back on the same backend, and
    # the same calls back to back on a thread of their own (what a second
    # thread alone costs), in turns; every result held to a third backend
    # following the chains.
    follow = TorchSpfBackend(device=dev)
    ends = [chain[-1][1], chain2[-1][1]]
    for t in ends:
        follow.compute(t)
    walls = {"pipelined": [], "synchronous": [], "thread": []}
    before = pipe.stats()
    for arm in ("pipelined", "synchronous", "thread", "thread", "synchronous", "pipelined") * 2 + (
            "pipelined", "synchronous", "thread"):
        steps = [toggles(graph, synth, end, K, PIPE_TURN_STEPS) for end in ends]
        order = [t for pair in zip(*steps) for t in pair]
        served = inner.delta_paths[("weight", "incremental")]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if arm == "pipelined":
            res = [force(lazy) for lazy in [abe.compute(t) for t in order]]
        elif arm == "synchronous":
            res = [inner.compute(t) for t in order]
        else:
            res = []
            th = threading.Thread(target=lambda: res.extend(inner.compute(t) for t in order))
            th.start()
            th.join()
        walls[arm].append((time.perf_counter() - t0) * 1e3)
        require(inner.delta_paths[("weight", "incremental")] == served + len(order),
                f"a {arm} turn left DeltaPath")
        for t, r in zip(order, res):
            require(same_planes(r, follow.compute(t)), f"a {arm} turn's result differs")
        ends = [s[-1] for s in steps]
    x["walls"] = walls
    st = pipe.stats()
    pipe.close()
    n_turn = st["completed"] - before["completed"]
    per_launch = (st["launch-seconds"] - before["launch-seconds"]) / n_turn * 1e3
    per_finish = (st["finish-seconds"] - before["finish-seconds"]) / n_turn * 1e3
    require(st["max-inflight-per-key"] <= 1 and st["sheds"] == 0 and st["worker-respawns"] == 0,
            f"the turns broke the pipeline's contract: {st}")
    x["stats_turns"] = st
    wall_ratio = statistics.median(walls["pipelined"]) / statistics.median(walls["synchronous"])
    print(f"time pipeline two chains interleaved: {statistics.median(walls['pipelined']):.3f} ms "
          f"pipelined against {statistics.median(walls['synchronous']):.3f} ms back to back "
          f"(pipelined / back to back {wall_ratio:.4f}) and "
          f"{statistics.median(walls['thread']):.3f} ms back to back on a thread of their own "
          f"(median of {len(walls['pipelined'])} turns each, {2 * PIPE_TURN_STEPS} delta-linked "
          f"compute() a turn; pipelined {[round(w, 3) for w in walls['pipelined']]}, "
          f"synchronous {[round(w, 3) for w in walls['synchronous']]}, thread "
          f"{[round(w, 3) for w in walls['thread']]}); the worker's launch {per_launch:.3f} ms "
          f"and finish {per_finish:.3f} ms an entry over the turns' {n_turn}; overlap "
          f"{st['overlap-seconds']:.6f} s of {st['overlap-seconds'] + st['finish-seconds']:.6f} s "
          f"(ratio {st['overlap-ratio']}), launch {st['launch-seconds']:.6f} s, finish "
          f"{st['finish-seconds']:.6f} s over {st['completed']} entries; {smi}", flush=True)

    # (c) launch_one / finish_one called directly on each path, timed.
    lbe = TorchSpfBackend(device=dev)
    ltr = TorchSpfBackend(device=dev, one_engine="tropical")
    paths = {"full": (lbe, (topo,), {}, gone), "masked": (lbe, (topo, masks[1]), {}, masked),
             "multipath": (lbe, (topo,), {"multipath_k": MP_K}, m_one[MP_K]),
             "tropical": (ltr, (topo,), {}, trop)}
    x["direct"] = {}
    for name, (be, args, kw, want) in paths.items():
        times = []
        for rep_ in range(PIPE_REPS + 1):  # the first warms the path
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = be.launch_one(*args, **kw)
            t1 = time.perf_counter()
            got = be.finish_one(h)
            t2 = time.perf_counter()
            require(same_nine(got, want) if kw else same_planes(got, want),
                    f"launch_one / finish_one ({name}) differs from compute()")
            if rep_:
                times.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3))
        x["direct"][name] = times
    dref = TorchSpfBackend(device=dev)
    base = ends[0]
    lbe.finish_one(lbe.launch_one(base))
    dref.compute(base)
    times = []
    for t in toggles(graph, synth, base, K, PIPE_REPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = lbe.launch_one(t)
        t1 = time.perf_counter()
        got = lbe.finish_one(h)
        t2 = time.perf_counter()
        require(same_planes(got, dref.compute(t)), "launch_one / finish_one (delta) differs")
        times.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3))
    require(lbe.delta_paths[("weight", "incremental")] == PIPE_REPS + 1,
            "a direct delta launch left DeltaPath")
    x["direct"]["delta"] = times[1:]
    for name, times in x["direct"].items():
        launch_ms = statistics.median(t[0] for t in times)
        finish_ms = statistics.median(t[1] for t in times)
        # The most device time a pipeline could hide behind other work: the
        # launch holds every round, so only the finish can overlap.
        print(f"time pipeline launch_one / finish_one {name}: launch {launch_ms:.3f} ms, "
              f"finish {finish_ms:.3f} ms, the finish's share "
              f"{finish_ms / (launch_ms + finish_ms):.4f} (median of {len(times)}; "
              f"launch {[round(t[0], 3) for t in times]}, finish "
              f"{[round(t[1], 3) for t in times]}); {smi}", flush=True)
    x["phase_s"] = time.perf_counter() - t_phase
    print(f"pipeline phase checked in {x['phase_s']:.1f} s", flush=True)
    return x


# The dispatch mesh (phase 3n): the engines of the 1-device mesh's what-if
# checks, the alternating turns of each timed what-if (mesh against none),
# the virtual meshes over the card.
MESH_ENGINES = ("seq", "fused", "packed", "hybrid", "tropical")
MESH_TURNS = 5
MESH_VIRTUAL = ((2, 2), (4, 1))


def launch_counts() -> dict:
    """Every kernel's launch count: the gather, multipath, fused, tropical
    and blocked wrappers' counters."""
    from holo_tpu_torch.kernels import blocked, ell
    from holo_tpu_torch.kernels import tropical as kt

    return {**ell.launches, **kt.launches, **blocked.launches}


def same_result(got, want) -> bool:
    """Two results of one call equal on every plane they carry (SpfResult,
    MultiRootResult, BackupTable or lists of them)."""
    if isinstance(got, list):
        return len(got) == len(want) and all(same_result(a, b) for a, b in zip(got, want))
    fields = [f for f in vars(want) if f != "inputs"]
    return all((getattr(got, f) is None and getattr(want, f) is None)
               or np.array_equal(getattr(got, f), getattr(want, f)) for f in fields)


def mesh_phase(dev, topo, masks, gres, gmr, mr_roots, oracle, mr_ref, n_atoms) -> dict:
    """Phase 3n: (a) under a 1-device mesh on the card, compute, a masked
    compute, compute_whatif on every engine and at multipath_k=4,
    compute_multiroot (seq and tropical), FrrEngine("torch").compute and a
    partitioned compute (the 10k hinted LSDB): each bit-identical to the same
    call with no mesh, its shard counter moved by one, every kernel launched
    the same number of times; (b) the paired overhead of the 1-device mesh on
    the 1024-lane what-if, in alternating turns; (c) virtual (2, 2) and (4, 1)
    meshes over the card: the what-if and multiroot equal to no mesh and to
    the oracle's scenarios and roots, the FRR table to the no-mesh table, each
    what-if timed beside no mesh; (d) the dry run over 4 entries of the
    card."""
    from holo_tpu_torch import graft_entry
    from holo_tpu_torch.frr.manager import FrrEngine
    from holo_tpu_torch.parallel import mesh as pm
    from holo_tpu_torch.spf import synth
    from holo_tpu_torch.spf.backend import TorchSpfBackend

    t_phase = time.perf_counter()
    x = {}
    n = topo.n_vertices
    t10 = synth.multiarea_topology(**PART_10K)
    require(pm.make_spf_mesh(devices=pm.virtual_devices(1, dev)).size == 1, "1-device mesh")
    # label -> (shard kind, a fresh backend or engine, its call)

    def spf(**kw):
        return lambda: TorchSpfBackend(device=dev, **kw)

    calls = {
        "compute": ("one", spf(), lambda be: be.compute(topo)),
        "masked compute": ("one", spf(), lambda be: be.compute(topo, masks[1])),
        **{f"whatif {e}": ("whatif", spf(one_engine=e),
                           lambda be: be.compute_whatif(topo, masks)) for e in MESH_ENGINES},
        "whatif multipath_k=4": ("whatif", spf(),
                                 lambda be: be.compute_whatif(topo, masks, multipath_k=MP_K)),
        "multiroot seq": ("multiroot", spf(), lambda be: be.compute_multiroot(topo, mr_roots)),
        "multiroot tropical": ("multiroot", spf(one_engine="tropical"),
                               lambda be: be.compute_multiroot(topo, mr_roots)),
        "frr": ("frr", lambda: FrrEngine("torch", device=dev), lambda eng: eng.compute(topo)),
        "partitioned 10k": ("partitioned", spf(partition_threshold=1),
                            lambda be: be.compute(t10)),
    }

    def counted(make, run):
        """(result, launches, shard dispatches) of one call on a fresh object."""
        obj = make()
        before = launch_counts()
        res = run(obj)
        torch.cuda.synchronize()
        after = launch_counts()
        return (res, {k: after[k] - before[k] for k in after if after[k] != before[k]},
                Counter(obj.shard_dispatches))

    # (a) the 1-device mesh against no mesh, call by call
    x["a"] = {}
    for label, (kind, make, run) in calls.items():
        plain, plain_launches, plain_shards = counted(make, run)
        pm.configure_process_mesh(1, 1, pm.virtual_devices(1, dev))
        try:
            got, launches, shards = counted(make, run)
        finally:
            pm.reset_process_mesh()
        require(not plain_shards and shards == Counter({kind: 1}),
                f"1-device mesh {label}: shard dispatches {dict(shards)} (no mesh: "
                f"{dict(plain_shards)})")
        require(same_result(got, plain), f"1-device mesh {label} differs from no mesh")
        require(launches == plain_launches and launches,
                f"1-device mesh {label}: launches {launches} against {plain_launches}")
        x["a"][label] = launches
        print(f"mesh (1, 1) {label}: bit-identical to no mesh, shard dispatches "
              f"{dict(shards)}, launches {launches} equal to no mesh's", flush=True)
        del plain, got
    # (b) the paired overhead on the 1024-lane what-if, alternating turns
    plain_be, mesh_be = TorchSpfBackend(device=dev), TorchSpfBackend(device=dev)
    plain_be.compute_whatif(topo, masks)
    pm.configure_process_mesh(1, 1, pm.virtual_devices(1, dev))
    try:
        mesh_be.compute_whatif(topo, masks)
    finally:
        pm.reset_process_mesh()
    turns = []
    for _ in range(MESH_TURNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_be.compute_whatif(topo, masks)
        t1 = time.perf_counter()
        pm.configure_process_mesh(1, 1, pm.virtual_devices(1, dev))
        try:
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            mesh_be.compute_whatif(topo, masks)
            t3 = time.perf_counter()
        finally:
            pm.reset_process_mesh()
        turns.append(((t1 - t0) * 1e3, (t3 - t2) * 1e3))
    p_ms = statistics.median(t[0] for t in turns)
    m_ms = statistics.median(t[1] for t in turns)
    x["b"] = {"plain_ms": p_ms, "mesh_ms": m_ms, "turns": turns,
              "overhead": (m_ms - p_ms) / p_ms}
    print(f"time mesh (1, 1) overhead on the {BATCH}-lane what-if: {m_ms:.3f} ms against "
          f"{p_ms:.3f} ms with no mesh, median of {MESH_TURNS} alternating turns "
          f"({x['b']['overhead'] * 100:+.2f}%; turns "
          f"{[(round(a, 3), round(b, 3)) for a, b in turns]})", flush=True)
    del plain_be, mesh_be
    # (c) virtual meshes over the card, each what-if timed in turns with no mesh
    frr_plain = FrrEngine("torch", device=dev).compute(topo)
    plain_be = TorchSpfBackend(device=dev)
    x["c"] = {}
    for shape in MESH_VIRTUAL:
        devices = pm.virtual_devices(shape[0] * shape[1], dev)
        pm.configure_process_mesh(*shape, devices)
        try:
            be = TorchSpfBackend(device=dev)
            res = be.compute_whatif(topo, masks)
            mr = be.compute_multiroot(topo, mr_roots)
            eng = FrrEngine("torch", device=dev)
            table = eng.compute(topo)
            rows = be.prepare(topo).in_src.shape[0]
        finally:
            pm.reset_process_mesh()
        turns = []
        for _ in range(MESH_TURNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain_be.compute_whatif(topo, masks)
            t1 = time.perf_counter()
            pm.configure_process_mesh(*shape, devices)
            try:
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                be.compute_whatif(topo, masks)
                t3 = time.perf_counter()
            finally:
                pm.reset_process_mesh()
            turns.append(((t1 - t0) * 1e3, (t3 - t2) * 1e3))
        plain_ms = statistics.median(t[0] for t in turns)
        mesh_ms = statistics.median(t[1] for t in turns)
        require(be.shard_dispatches == Counter({"whatif": MESH_TURNS + 1, "multiroot": 1})
                and eng.shard_dispatches == Counter({"frr": 1}), f"mesh {shape} shard counts")
        require(same_result(res, gres), f"mesh {shape} what-if differs from no mesh")
        require(same_result(mr, gmr), f"mesh {shape} multiroot differs from no mesh")
        require(same_result(table, frr_plain), f"mesh {shape} FRR table differs from no mesh")
        for b in range(ORACLE_SCENARIOS):
            ref = oracle[b]
            require(all(np.array_equal(getattr(res[b], f), getattr(ref, f))
                        for f in ("dist", "parent", "hops"))
                    and np.array_equal(res[b].nexthop_words, ref.nexthop_words(n_atoms)),
                    f"mesh {shape} scenario {b} differs from the oracle")
        for f in ("dist", "parent", "hops"):
            require(np.array_equal(getattr(mr, f)[:ORACLE_ROOTS], getattr(mr_ref, f)),
                    f"mesh {shape} multiroot {f} differs from the oracle")
        x["c"][shape] = {"mesh_ms": mesh_ms, "plain_ms": plain_ms, "rows": rows, "turns": turns}
        rounded = [(round(a, 3), round(b, 3)) for a, b in turns]
        print(f"time mesh {shape} over {len(devices)} entries of {devices[0]}: what-if "
              f"{mesh_ms:.3f} ms against {plain_ms:.3f} ms with no mesh (median of "
              f"{MESH_TURNS} alternating turns {rounded}; resident rows {rows} of {n}); "
              f"what-if, multiroot and FRR table "
              f"bit-identical to no mesh, scenarios 0-{ORACLE_SCENARIOS - 1} and roots "
              f"0-{ORACLE_ROOTS - 1} to the oracle", flush=True)
        del res, mr, table
    del plain_be
    # (d) the dry run over 4 entries of the card
    x["dryrun"] = graft_entry.dryrun_multichip(4)
    require(pm.process_mesh() is None, "the dry run left its mesh installed")
    x["seconds"] = time.perf_counter() - t_phase
    print(f"mesh phase checked in {x['seconds']:.1f} s", flush=True)
    return x


# Telemetry and runtime checks (phase 3o): the partitioned LSDB, the BGP
# feed and burst, the alternating turns of the overhead timing, the calls a
# turn, the pipelined chain's depth.
TEL_PART = PART_10K
TEL_BGP_PREFIXES, TEL_BGP_BURST = 2048, 256
TEL_TURNS = 5
TEL_COMPUTE_REPS, TEL_WHATIF_REPS = 5, 3
TEL_FLAG_ENGINES = ("seq", "fused", "packed", "hybrid", "tropical")


def telemetry_paths(dev, topo, masks, gres, gone, gmr, mr_roots, m_one, mask_ref, chain,
                    d_steps) -> SimpleNamespace:
    """The twelve paths phases 3o and 3p drive, with what each must give and
    the stage observations each makes: ``compute()``, ``compute(masks[1])``,
    ``compute(multipath_k=4)``, the 1024-lane what-if on seq and on the
    tropical engine, the 64-root multi-root, ``FrrEngine("torch").compute``
    (root 6075), a 1024-request CSPF batch, the partitioned 10k LSDB
    (hinted), a BGP table's cold batch and one UPDATE burst, phase 3d's
    8-event chain and the same chain pipelined through ``AsyncSpfBackend``;
    and the helpers both phases use (launch counts, stage counts, result
    equality)."""
    from holo_tpu_torch import telemetry
    from holo_tpu_torch.frr.manager import FrrEngine
    from holo_tpu_torch.kernels import bgp as kb
    from holo_tpu_torch.kernels import blocked, ell
    from holo_tpu_torch.kernels import tropical as kt
    from holo_tpu_torch.ops import bgp_table as bt
    from holo_tpu_torch.ops.cspf import Constraint, CspfEngine, LinkAttrs
    from holo_tpu_torch.pipeline import AsyncSpfBackend, DispatchPipeline
    from holo_tpu_torch.protocols import bgp_engine as bge
    from holo_tpu_torch.spf import synth
    from holo_tpu_torch.spf.backend import TorchSpfBackend

    n_atoms = max(64, topo.n_atoms())
    part_topo = synth.multiarea_topology(**TEL_PART)
    rng = np.random.default_rng(CSPF_SEED)  # phase 3g's draws
    attrs = LinkAttrs(affinity=rng.integers(0, 2**8, topo.n_edges, dtype=np.uint32),
                      bandwidth=rng.uniform(1.0, 10.0, topo.n_edges))
    cons = [Constraint(exclude_any=int(rng.integers(0, 4)),
                       min_bandwidth=float(rng.uniform(0.0, 2.0))) for _ in range(CSPF_BATCH)]
    dsts = [int(d) for d in rng.integers(0, topo.n_vertices, CSPF_BATCH)]
    cspf = CspfEngine(topo, attrs, device=dev)
    nht, feed = bgp_feed(bge, TEL_BGP_PREFIXES, BGP_PEERS)
    burst = bgp_burst(bge, feed, BGP_PEERS, TEL_BGP_BURST)

    def force(lazy):
        return lazy._ticket.result(timeout=PIPE_WAIT_S)

    def bgp_run():
        tb = bt.TorchBgpTableBackend(device=dev)
        eng = bge.DecisionEngine(asn=65000, table_backend=tb, ibus_cb=lambda *a: None)
        eng.multipath[BGP_AFS] = dict(BGP_MP)
        for addr, metric in nht.items():
            eng.tables[BGP_AFS].nht[addr] = bge.NhtEntry(metric=metric)
        for prefix, routes in feed:
            bgp_announce(bge, eng, prefix, routes, tb)
        eng.run_decision_process()
        for prefix, routes in burst:
            bgp_announce(bge, eng, prefix, routes, tb)
        eng.run_decision_process()
        require(tb.stats()["fallbacks"] == 0, "the BGP table fell back to the oracle")
        return bgp_snap(eng)

    def chain_run():
        be = TorchSpfBackend(device=dev)
        out = [be.compute(topo)] + [be.compute(t) for _, t in chain]
        require(be.delta_paths.get(("weight", "incremental"), 0) > 0,
                "the chain left DeltaPath")
        return out

    def pipelined_run():
        pipe = DispatchPipeline(depth=2)
        try:
            abe = AsyncSpfBackend(TorchSpfBackend(device=dev), pipe)
            lazies = [abe.compute(topo)] + [abe.compute(t) for _, t in chain]
            return [force(lz) for lz in lazies]
        finally:
            pipe.close()

    def sb():
        return TorchSpfBackend(device=dev)

    def planes(want):
        return lambda got: same_planes(got, want)

    def batch(want, same):
        return lambda got: len(got) == len(want) and all(same(a, b) for a, b in zip(got, want))

    def roots(got):
        return all(np.array_equal(getattr(got, f), getattr(gmr, f))
                   for f in ("dist", "parent", "hops"))

    chain_ref = [gone] + [s[2] for s in d_steps]
    one3 = {"marshal": 1, "device": 1, "readback": 1}
    chain_stages = {("spf.one", "marshal"): 1, ("spf.one", "delta"): len(chain),
                    ("spf.one", "device"): len(chain) + 1,
                    ("spf.one", "readback"): len(chain) + 1}
    part_stages = {("spf.partitioned", s): 1 for s in ("marshal", "solve", "bdist", "stitch",
                                                       "dist", "phase2")}
    # name -> (call, check against the earlier phases or None, expected
    # stage observations)
    paths = {
        "compute()": (lambda: sb().compute(topo), planes(gone),
                      {("spf.one", s): v for s, v in one3.items()}),
        "compute(masks[1])": (lambda: sb().compute(topo, masks[1]), planes(mask_ref),
                              {("spf.one", s): v for s, v in one3.items()}),
        f"compute(multipath_k={MP_K})": (lambda: sb().compute(topo, multipath_k=MP_K),
                                         lambda got: same_nine(got, m_one[MP_K]),
                                         {("spf.one", s): v for s, v in one3.items()}),
        "what-if seq": (lambda: sb().compute_whatif(topo, masks), batch(gres, same_planes),
                        {("spf.whatif", s): v for s, v in one3.items()}),
        "what-if tropical": (
            lambda: TorchSpfBackend(device=dev, one_engine="tropical").compute_whatif(topo, masks),
            batch(gres, same_planes), {("spf.whatif", s): v for s, v in one3.items()}),
        f"multiroot x{len(mr_roots)}": (lambda: sb().compute_multiroot(topo, mr_roots), roots,
                                         {("spf.multiroot", s): v for s, v in one3.items()}),
        "FRR": (lambda: FrrEngine("torch", device=dev).compute(topo), None,
                {("frr.batch", s): v for s, v in one3.items()}),
        f"CSPF x{CSPF_BATCH}": (lambda: cspf.compute(cons, dsts), None, {}),
        "partitioned 10k": (
            lambda: TorchSpfBackend(device=dev, partition_threshold=1).compute(part_topo), None,
            part_stages),
        "BGP burst": (bgp_run, None, {("bgp.table", s): 2 for s in one3}),
        "delta chain": (chain_run, batch(chain_ref, same_planes), chain_stages),
        "pipelined chain": (pipelined_run, batch(chain_ref, same_planes), chain_stages),
    }

    def same_any(got, want) -> bool:
        """Two runs of one path equal on every plane (results, lists of
        them, CSPF paths, BGP Loc-RIB snapshots)."""
        if isinstance(want, list):
            return len(got) == len(want) and all(same_any(g, w) for g, w in zip(got, want))
        if isinstance(want, dict):
            return got == want
        return same_result(got, want)

    def stage_counts() -> Counter:
        out = Counter()
        for k, v in telemetry.snapshot("holo_profile_stage_seconds").items():
            labels = dict(kv.split("=", 1) for kv in k[k.index("{") + 1:-1].split(","))
            if labels["device"] == "-":
                out[(labels["site"], labels["stage"])] += v["count"]
        return out

    def launches() -> dict:
        return {**launch_counts(), **kb.launches}

    def reset() -> None:
        ell.reset_launches()
        kt.reset_launches()
        blocked.reset_launches()
        kb.reset_launches()

    return SimpleNamespace(paths=paths, same_any=same_any, stage_counts=stage_counts,
                           launches=launches, reset=reset, sb=sb, force=force,
                           chain_run=chain_run, pipelined_run=pipelined_run,
                           part_topo=part_topo, n_atoms=n_atoms)


def telemetry_phase(dev, topo, masks, gres, gone, gmr, mr_roots, m_one, mask_ref, chain,
                    d_steps) -> dict:
    """Phase 3o: the port's telemetry and runtime checks on the k=90 fat tree.
    (a) One set of paths run with profiling armed and again disarmed:
    ``compute()``, ``compute(masks[1])``, ``compute(multipath_k=4)``, the
    1024-lane what-if on seq and on the tropical engine, the 64-root
    multi-root, ``FrrEngine("torch").compute`` (root 6075), a 1024-request
    CSPF batch, the partitioned 10k LSDB (hinted), a BGP table's cold batch
    and one UPDATE burst, phase 3d's 8-event chain and the same chain
    pipelined through ``AsyncSpfBackend``: every plane bit-identical between
    the arms and to the earlier phases' references, the kernel launches
    equal, each (site, stage) observed as often as the calls made it, each
    device stage's CUDA-event time at most its dispatch's wall, and no CUDA
    event recorded by the disarmed arm.  (b) The overhead: ``compute()``
    (median of 5) and the what-if (median of 3), armed against disarmed in 5
    alternating turns.  (c) Every path again under
    ``testing.no_implicit_transfers()``, with no unsanctioned sync (one that
    raises is run again with the mode at "warn" to list every site), and
    the sanctioned windows each path opened, the flag reads of one
    ``compute()`` per engine, ``mp`` and ``mp_tropical`` at multipath_k=4
    and a partitioned ``compute()``.  (d) The residency rows against an
    independent sum of the tensors each names, the total at most
    ``torch.cuda.memory_allocated()``.  (e) Phase 3d's chain and the
    pipeline's interleaved chains under ``testing.donation_guarded()``; a
    seeded stale read raises ``DonatedBufferError``.  (f) A
    ``capture_device_trace`` into a temporary directory holds the
    ``spf.one.*`` stage ranges and a gather kernel."""
    import tempfile
    import warnings

    from holo_tpu_torch import testing
    from holo_tpu_torch.analysis import runtime
    from holo_tpu_torch.ops import bgp_table as bt
    from holo_tpu_torch.ops import graph
    from holo_tpu_torch.ops import spf_engine as se
    from holo_tpu_torch.pipeline import AsyncSpfBackend, DispatchPipeline
    from holo_tpu_torch.spf import synth
    from holo_tpu_torch.spf.backend import TorchSpfBackend
    from holo_tpu_torch.telemetry import profiling, residency

    t_phase = time.perf_counter()
    x = {}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    tp = telemetry_paths(dev, topo, masks, gres, gone, gmr, mr_roots, m_one, mask_ref, chain,
                         d_steps)
    paths, same_any, stage_counts, launches, reset = (tp.paths, tp.same_any, tp.stage_counts,
                                                      tp.launches, tp.reset)
    sb, force, chain_run, pipelined_run = tp.sb, tp.force, tp.chain_run, tp.pipelined_run
    part_topo, n_atoms = tp.part_topo, tp.n_atoms

    # (a) armed and disarmed
    arms = {}
    for arm in ("armed", "disarmed"):
        profiling.set_device_profiling(arm == "armed")
        ev0, n0, st0 = profiling.event_records(), len(profiling.settled()), stage_counts()
        results, counts = {}, {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            for name, (call, _want, _st) in paths.items():
                reset()
                results[name] = call()
                torch.cuda.synchronize()
                counts[name] = {k: v for k, v in launches().items() if v}
        finally:
            profiling.set_device_profiling(False)
        arms[arm] = {"results": results, "launches": counts,
                     "events": profiling.event_records() - ev0,
                     "settled": profiling.settled()[n0:], "stages": stage_counts() - st0,
                     "s": time.perf_counter() - t0}
    a, d = arms["armed"], arms["disarmed"]
    for name, (_call, check, _st) in paths.items():
        require(same_any(a["results"][name], d["results"][name]),
                f"3o: {name} differs between the armed and the disarmed arm")
        if check is not None:
            require(check(a["results"][name]),
                    f"3o: {name} differs from the earlier phases' reference")
        require(a["launches"][name] == d["launches"][name],
                f"3o: {name} launches differ: armed {a['launches'][name]}, disarmed "
                f"{d['launches'][name]}")
    want_stages = Counter()
    for _call, _want, st in paths.values():
        want_stages.update(st)
    require(a["stages"] == want_stages,
            f"3o: stage observations {dict(a['stages'])} != calls made {dict(want_stages)}")
    require(d["events"] == 0 and not d["settled"] and not d["stages"],
            f"3o: the disarmed arm recorded {d['events']} CUDA events, settled "
            f"{len(d['settled'])} device stages, observed {dict(d['stages'])}")
    n_device = sum(v for (_site, stage), v in want_stages.items() if stage == "device")
    require(len(a["settled"]) == n_device and a["events"] == 2 * n_device,
            f"3o: {len(a['settled'])} device stages settled and {a['events']} events "
            f"recorded for {n_device} device stages")
    worst = max((dt / wall, site) for site, _dev, dt, _host, wall in a["settled"])
    require(all(0 < dt <= wall for _s, _d, dt, _h, wall in a["settled"]),
            f"3o: a device stage's event time exceeds its dispatch wall ({worst})")
    by_site = {}
    for site, _dev, dt, _host, wall in a["settled"]:
        by_site.setdefault(site, []).append((dt * 1e3, wall * 1e3))
    x["device_stages"] = by_site
    print(f"3o (a): {len(paths)} paths armed ({a['s']:.1f} s) and disarmed ({d['s']:.1f} s): "
          f"every plane bit-identical between the arms and to the earlier phases' references, "
          f"launches equal; stage observations {dict(sorted(want_stages.items()))} equal to "
          f"the calls made; {n_device} device stages on {a['events']} CUDA events, each at "
          f"most its dispatch's wall (largest share {worst[0]:.4f}, {worst[1]}); disarmed: "
          f"0 events; {smi}", flush=True)
    for site, rows in by_site.items():
        print(f"3o device stages {site}: " + ", ".join(
            f"{dt:.3f} of {wall:.3f} ms" for dt, wall in rows[:9]) + f"; {smi}", flush=True)

    # (b) the overhead, armed against disarmed in alternating turns
    ob = sb()
    ob.compute(topo)
    ob.compute_whatif(topo, masks)
    walls = {("compute", arm): [] for arm in ("armed", "disarmed")}
    walls.update({("whatif", arm): [] for arm in ("armed", "disarmed")})
    for turn in range(TEL_TURNS):
        order = ("armed", "disarmed") if turn % 2 == 0 else ("disarmed", "armed")
        for arm in order:
            profiling.set_device_profiling(arm == "armed")
            try:
                walls[("compute", arm)].append(host_ms(lambda: ob.compute(topo), TEL_COMPUTE_REPS))
                walls[("whatif", arm)].append(host_ms(lambda: ob.compute_whatif(topo, masks),
                                                      TEL_WHATIF_REPS))
            finally:
                profiling.set_device_profiling(False)
    x["overhead"] = {}
    for what in ("compute", "whatif"):
        on = statistics.median(walls[(what, "armed")])
        off = statistics.median(walls[(what, "disarmed")])
        x["overhead"][what] = (on, off)
        print(f"time 3o profiling overhead {what}: armed {on:.3f} ms, disarmed {off:.3f} ms "
              f"(armed / disarmed {on / off:.4f}; median of {TEL_TURNS} alternating turns, each "
              f"the median of {TEL_COMPUTE_REPS if what == 'compute' else TEL_WHATIF_REPS}; "
              f"armed {[round(w, 3) for w in walls[(what, 'armed')]]}, disarmed "
              f"{[round(w, 3) for w in walls[(what, 'disarmed')]]}); {smi}", flush=True)

    # (c) the sanitizer
    def survey(call) -> tuple:
        """``call``'s result and its unsanctioned sync sites: the mode at
        "warn", each warning's innermost frame in the port (or the
        script)."""
        sites = []

        def show(message, category, filename, lineno, file=None, line=None):
            import traceback

            frames = [f for f in traceback.extract_stack()[:-1]
                      if "holo_tpu_torch" in f.filename or f.filename.endswith("chip_smoke.py")]
            where = frames[-1] if frames else None
            sites.append(f"{where.filename.split('/holo_tpu_torch/')[-1]}:{where.lineno} "
                         f"{where.name}" if where else f"{filename}:{lineno}")

        runtime.ARMED_MODE = "warn"
        try:
            with warnings.catch_warnings():  # restores showwarning
                warnings.simplefilter("always")
                warnings.showwarning = show
                with testing.no_implicit_transfers():
                    out = call()
        finally:
            runtime.ARMED_MODE = "error"
        return out, sorted(Counter(sites).items())

    unsanctioned = {}

    def sanitized(name, call):
        """``call`` under the sanitizer; one that raises on a sync runs
        again with the mode at "warn" to list every site (checked after
        the last path, so one run lists them all)."""
        before = runtime.sanctioned_counts()
        try:
            with testing.no_implicit_transfers():
                out = call()
        except RuntimeError as exc:
            if "synchroniz" not in str(exc):
                raise
            torch.cuda.synchronize()
            out, unsanctioned[name] = survey(call)
        torch.cuda.synchronize()
        after = runtime.sanctioned_counts()
        return out, {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}

    x["sanctioned"] = {}
    for name, (call, _want, _st) in paths.items():
        out, delta = sanitized(name, call)
        require(same_any(out, a["results"][name]), f"3o (c): {name} differs under the sanitizer")
        x["sanctioned"][name] = delta
        print(f"3o (c) sanitized {name}: "
              f"{'unsanctioned syncs' if name in unsanctioned else 'no unsanctioned sync'}; "
              f"windows {dict(sorted(delta.items()))}", flush=True)
    flag_paths = {e: (lambda e=e: TorchSpfBackend(device=dev, one_engine=e).compute(topo))
                  for e in TEL_FLAG_ENGINES}
    flag_paths["mp"] = lambda: sb().compute(topo, multipath_k=MP_K)
    flag_paths["mp_tropical"] = lambda: TorchSpfBackend(
        device=dev, one_engine="tropical").compute(topo, multipath_k=MP_K)
    pwarm = TorchSpfBackend(device=dev, partition_threshold=1)
    pwarm.compute(part_topo)
    flag_paths["partitioned"] = lambda: pwarm.compute(part_topo)
    x["flags"] = {}
    for name, call in flag_paths.items():
        out, delta = sanitized(f"compute() {name}", call)
        flags = {k: v for k, v in sorted(delta.items()) if ".flag." in k}
        x["flags"][name] = flags
        print(f"3o (c) flag reads of one compute() {name}: {sum(flags.values())} "
              f"{flags}; {smi}", flush=True)
    require(not unsanctioned, f"3o (c): unsanctioned syncs, path -> [(site, count)]: "
            f"{unsanctioned}")

    # (d) the residency ledger
    torch.cuda.synchronize()
    rows = residency.rows()
    indep = dict.fromkeys(residency.PLANES, 0)
    host_held = [0]

    def add(plane, tensors) -> None:
        for t in tensors:
            if t is not None:
                indep[plane] += t.numel() * t.element_size()
                host_held[0] += 0 if t.is_cuda else t.numel() * t.element_size()

    for cache in list(se._SHARED_CACHES.values()):
        for e in list(cache._cache.values()):
            add("spf-graph", e.graph)
            if e.tropical is not None:
                add("tropical", e.tropical)
        for r in list(cache._part.values()):
            add("spf-graph-partitioned", r.graph)
    for ref in residency._SPF_BACKENDS:
        b = ref()
        for run in ([] if b is None else list(b._prev_one.values())):
            for part in (run if isinstance(run[0], tuple) else (run,)):
                add("spf-prev", part)
    for b in bt.live_backends():
        for dt in b._tables.values():
            add("bgp-table", (dt.planes,))
    got = {p: r["bytes"] for p, r in rows.items()}
    total = sum(got.values())
    allocated = torch.cuda.memory_allocated()
    require(got == indep, f"3o (d): residency rows {got} != the independent sums {indep}")
    require(total <= allocated, f"3o (d): resident {total} bytes > allocated {allocated}")
    x["residency"] = rows
    print(f"3o (d) residency: {json.dumps(rows)}; total {total} bytes ({host_held[0]} of them "
          f"in the CPU's caches) of {allocated} allocated on the card; each row equal to an "
          f"independent sum of its tensors; {smi}", flush=True)

    # (e) the donation guard
    with testing.donation_guarded():
        require(paths["delta chain"][1](chain_run()), "3o (e): the guarded chain differs")
        require(paths["pipelined chain"][1](pipelined_run()),
                "3o (e): the guarded pipelined chain differs")
        pipe = DispatchPipeline(depth=2)
        try:
            inner = TorchSpfBackend(device=dev)
            abe = AsyncSpfBackend(inner, pipe)
            topo2 = synth.clone_topology(topo)
            topo2.root = PIPE_ROOT2
            synth.assign_direct_atoms(topo2)
            ref2 = TorchSpfBackend(device=dev)
            ends = [topo, topo2]
            # Each turn is forced whole before its synchronous reference
            # runs: the reference reads the chains' resident graphs, which
            # the worker's next delta would rewrite under it.
            first = [force(lz) for lz in [abe.compute(t) for t in ends]]
            require(all(same_planes(r, ref2.compute(t)) for r, t in zip(first, ends)),
                    "3o (e): a guarded interleaved base differs")
            for _ in range(2):
                steps = [toggles(graph, synth, end, K, PIPE_TURN_STEPS) for end in ends]
                order = [t for pair in zip(*steps) for t in pair]
                res = [force(lz) for lz in [abe.compute(t) for t in order]]
                require(all(same_planes(r, ref2.compute(t)) for r, t in zip(res, order)),
                        "3o (e): a guarded interleaved chain step differs")
                ends = [s[-1] for s in steps]
            require(pipe.stats()["max-inflight-per-key"] <= 1, "3o (e): two of a key in flight")
        finally:
            pipe.close()
        # The seeded stale read: a lease on a resident graph taken for one
        # generation, then the next generation's delta applied to it in place.
        small = synth.fat_tree_topology(k=8)
        stale_be = TorchSpfBackend(device=dev)
        stale_be.compute(small)
        g = stale_be.prepare(small)
        lease = runtime.lease(g, generation=stale_be._gather_cache.key(small, n_atoms))
        stale_be.compute(toggles(graph, synth, small, 8, 1)[0])
        try:
            runtime.assert_live("chip_smoke.stale", lease)
            caught = None
        except runtime.DonatedBufferError as exc:
            caught = str(exc)
    require(caught is not None and "spf.graph.delta" in caught,
            f"3o (e): the seeded stale read was not caught ({caught})")
    consumed, donated = runtime.consumed_counts(), runtime.donated_counts()
    print(f"3o (e) donation guard: phase 3d's chain, its pipelined twin and two interleaved "
          f"pipelined chains ({2 * PIPE_TURN_STEPS} toggles a turn, 2 turns) under the guard, "
          f"each bit-identical to its synchronous run, no error; the seeded stale read raised "
          f"DonatedBufferError: {caught}; seams {donated}, hand-overs {consumed}", flush=True)

    # (f) the trace
    with tempfile.TemporaryDirectory() as tmp:
        row = profiling.capture_device_trace(tmp)
        require(row.get("captured"), f"3o (f): no trace captured: {row}")
        events = json.loads(Path(row["path"]).read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    stages = sorted(nm for nm in names if nm.startswith("spf.one."))
    kern = sorted(nm for nm in names if any(k in nm for k in (
        "ell_relax", "ell_first_parent", "ell_nh_seed", "ell_nh_round", "ell_fused")))
    require({"spf.one.marshal", "spf.one.device", "spf.one.readback"} <= set(stages),
            f"3o (f): the trace lacks the spf.one stage ranges: {stages}")
    require(kern, "3o (f): the trace holds no gather kernel")
    x["trace"] = {"stages": stages, "kernels": kern, "events": len(events)}
    print(f"3o (f) trace: {len(events)} events, stage ranges {stages}, gather kernels "
          f"{kern[:4]}{' ...' if len(kern) > 4 else ''} ({row['n_vertices']} vertices); {smi}",
          flush=True)
    x["phase_s"] = time.perf_counter() - t_phase
    print(f"telemetry phase 3o checked in {x['phase_s']:.1f} s", flush=True)
    x["paths"] = tp
    return x


ANALYTICS_TURNS = 5
ANALYTICS_SPLIT_TURNS = 9
ANALYTICS_SHARE_MAX = 1.05  # a roofline share past this is a miscounted bucket
ANALYTICS_FLIGHT = 8192  # flight-recorder ring entries


def analytics_phase(tp, topo, masks) -> dict:
    """Phase 3p: the dispatch analytics on the k=90 fat tree.  The twelve
    paths of phase 3o (:func:`telemetry_paths`) run with every analytics
    module disarmed, then armed (the flight recorder, the convergence
    tracker, the observatory with the card's peaks, the critical-path
    ledger and the SLO engine, device profiling too, so that each device
    stage is its CUDA-event time), each path one causal event from
    ``convergence.begin`` to ``fib_commit``.  (a) Every path bit-identical
    between the arms, launches equal.  (b) The observatory's observations,
    summed by (site, stage), equal to the stage observations made (the
    ``holo_profile_stage_seconds`` counts and the calls' expectation).  (c)
    Each bucket's roofline row: its cost entry (the kernels' work tally),
    device p50, achieved op/s and bytes/s, their shares of the peaks and
    the verdict; a share above ``ANALYTICS_SHARE_MAX`` fails.  (d) Each
    path's critical-path verdict and phases.  (e) The watchdog's budget per
    site from the p99, beside its fixed floor.  (f) ``compute()`` and the
    1024-lane what-if with the analytics armed (each call one event)
    against disarmed, in alternating turns.  (g) The SLO report and the
    flight recorder's ring.  The ledger and the postmortem directory are
    temporary."""
    import tempfile

    from holo_tpu_torch.resilience.watchdog import DispatchWatchdog
    from holo_tpu_torch.telemetry import convergence, critpath, flight, observatory
    from holo_tpu_torch.telemetry import profiling, slo

    t_phase = time.perf_counter()
    x = {}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    peaks = {"flops": INT32_OPS_S, "bytes": HBM_BYTES_S, "name": f"{smi} (int32 op/s, HBM)"}

    def arm(tmp) -> None:
        flight.configure(entries=ANALYTICS_FLIGHT, postmortem_dir=tmp)
        convergence.configure(capacity=1024)
        observatory.configure(check_every=32, ledger_path=Path(tmp) / "ledger.json",
                              peaks=peaks)
        critpath.configure(capacity=1024)
        slo.configure()

    def disarm() -> None:
        slo.configure(False)
        critpath.configure(0)
        observatory.configure(enabled=False)
        convergence.configure(0)
        flight.configure(entries=0)
        profiling.set_device_profiling(False)

    def event(name, call):
        """``call`` as one causal event, closed at its FIB commit (no-ops
        while disarmed)."""
        eid = convergence.begin("lsa", path=name)
        with convergence.activation(eid):
            out = call()
            convergence.observe(convergence.PHASE_SPF)
            convergence.observe(convergence.PHASE_RIB)
            convergence.fib_commit()
        return out

    with tempfile.TemporaryDirectory() as tmp:
        # (a) disarmed, then armed
        runs = {}
        for armed in (False, True):
            if armed:
                arm(tmp)
                profiling.set_device_profiling(True)
            st0 = tp.stage_counts()
            results, counts = {}, {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                for name, (call, _want, _st) in tp.paths.items():
                    tp.reset()
                    results[name] = event(name, call)
                    torch.cuda.synchronize()
                    counts[name] = {k: v for k, v in tp.launches().items() if v}
            finally:
                profiling.set_device_profiling(False)
            runs[armed] = {"results": results, "launches": counts,
                           "stages": tp.stage_counts() - st0, "s": time.perf_counter() - t0}
        a, d = runs[True], runs[False]
        for name in tp.paths:
            require(tp.same_any(a["results"][name], d["results"][name]),
                    f"3p: {name} differs between the armed and the disarmed arm")
            require(a["launches"][name] == d["launches"][name],
                    f"3p: {name} launches differ: armed {a['launches'][name]}, disarmed "
                    f"{d['launches'][name]}")
        print(f"3p (a): {len(tp.paths)} paths disarmed ({d['s']:.1f} s) and armed ({a['s']:.1f} "
              f"s), each one causal event: every plane bit-identical between the arms, launches "
              f"equal; {smi}", flush=True)

        # (b) the observatory's keys against the stage observations made
        obs = observatory.active()
        want = Counter()
        for _call, _want, st in tp.paths.values():
            want.update(st)
        by_stage = Counter()
        for (site, stage, _e, _b, _k), sk in obs._sketches.items():
            by_stage[(site, stage)] += sk.count
        require(by_stage == a["stages"] == want,
                f"3p (b): observatory observations {dict(by_stage)}, stage observations "
                f"{dict(a['stages'])}, calls made {dict(want)}")
        x["keys"] = {observatory.key_str(k): sk.count for k, sk in obs._sketches.items()}
        print(f"3p (b): {len(obs._sketches)} sketch keys, {sum(by_stage.values())} observations, "
              f"equal by (site, stage) to the stage observations made: "
              f"{json.dumps(x['keys'], sort_keys=True)}", flush=True)

        # (c) the roofline rows
        rows = obs.roofline()
        require(rows, "3p (c): no cost entry reached the observatory")
        x["roofline"] = []
        for r in rows:
            if "device_p50_s" not in r:
                continue
            op_share = r["achieved_flops_per_sec"] / INT32_OPS_S
            byte_share = r["achieved_bytes_per_sec"] / HBM_BYTES_S
            worst = max(op_share, byte_share, r["roofline_fraction"] or 0.0)
            row = {"site": r["site"], "engine": r["engine"], "kind": r["kind"],
                   "bucket": r["bucket"], "ops": r["flops"], "bytes": r["bytes"],
                   "device_p50_ms": r["device_p50_s"] * 1e3, "dispatches": r["dispatches"],
                   "op_per_s": r["achieved_flops_per_sec"],
                   "bytes_per_s": r["achieved_bytes_per_sec"], "op_share": op_share,
                   "byte_share": byte_share, "roofline_fraction": r["roofline_fraction"],
                   "verdict": r["verdict"]}
            x["roofline"].append(row)
            print(f"3p (c) roofline {r['site']} {r['kind']} {r['engine']} {r['bucket']}: cost "
                  f"{r['flops']:.0f} int32 ops, {r['bytes']:.0f} bytes (AI "
                  f"{r['ai_flops_per_byte']}); device p50 {row['device_p50_ms']:.4f} ms over "
                  f"{r['dispatches']} dispatches; {row['op_per_s']:.4g} op/s ({op_share:.5f} of "
                  f"peak), {row['bytes_per_s']:.4g} B/s ({byte_share:.5f} of peak), roofline "
                  f"fraction {r['roofline_fraction']}; {r['verdict']}; {smi}", flush=True)
            require(worst <= ANALYTICS_SHARE_MAX,
                    f"3p (c): {r['site']} {r['kind']} {r['engine']} shares {worst:.4f} of a peak")
        require(x["roofline"], "3p (c): no bucket joined a device sketch")

        # (d) the critical path of each path
        cp = critpath.active()
        water = cp.waterfalls()
        require(len(water) == len(tp.paths) and cp.stats()["completed"] == len(tp.paths),
                f"3p (d): {len(water)} waterfalls for {len(tp.paths)} events")
        x["critpath"] = {}
        for name, w in zip(tp.paths, water):
            require(abs(sum(w["phases"].values()) - w["wall"]) <= 1e-9 * max(w["wall"], 1.0),
                    f"3p (d): {name}'s phases do not sum to its wall")
            ms = {p: round(v * 1e3, 4) for p, v in w["phases"].items() if v}
            x["critpath"][name] = {"verdict": w["verdict"], "wall_ms": w["wall"] * 1e3,
                                   "phases_ms": ms}
            print(f"3p (d) critical path {name}: {w['verdict']}-bound, wall "
                  f"{w['wall'] * 1e3:.3f} ms, phases (ms) {ms}", flush=True)
        q = cp.phase_quantiles()
        print(f"3p (d) verdicts {cp.stats()['verdicts']}; phase p99 ms "
              f"{ {p: round(v['p99'] * 1e3, 4) for p, v in q.items()} }; host fraction of the "
              f"p99s {cp.host_fraction_p99()}; {smi}", flush=True)

        # (e) the watchdog's budgets
        wd = DispatchWatchdog(SimpleNamespace(name="3p"))
        sites = sorted({k[0] for k in obs._sketches})
        x["budgets"] = {s: (obs.site_p99(s), wd.budget(s), wd.floor) for s in sites}
        print("3p (e) watchdog budgets: " + "; ".join(
            f"{s} p99 {p99 * 1e3:.3f} ms -> budget {b:.3f} s (floor {f:.1f} s)"
            for s, (p99, b, f) in x["budgets"].items()) + f"; {smi}", flush=True)

        # (g) the SLO report and the flight ring
        report = slo.active().report()
        ring = flight.recorder().snapshot_ring()
        kinds = Counter(e[1] if e[0] == "event" else e[0] for e in ring)
        require(kinds["convergence"] == len(tp.paths),
                f"3p (g): {kinds['convergence']} convergence events in the ring")
        require(flight.recorder().stats()["dumps"] == 0, "3p (g): a postmortem was written")
        trig = next(r for r in report["objectives"] if r["objective"] == "trigger-fib")
        require(trig["events"] == len(tp.paths), f"3p (g): trigger-fib graded {trig['events']}")
        x["slo"] = report
        print(f"3p (g) SLO: {json.dumps(report['objectives'])}; sheds {report['sheds']}",
              flush=True)
        print(f"3p (g) flight ring: {len(ring)} entries, {dict(kinds)}", flush=True)
        observatory.active().checkpoint()
        disarm()

        # (f) the overhead: alternating turns, each call one event
        ob = tp.sb()
        ob.compute(topo)
        ob.compute_whatif(topo, masks)
        walls = {(what, armed): [] for what in ("compute", "whatif") for armed in (1, 0)}
        for turn in range(ANALYTICS_TURNS):
            for armed in ((1, 0) if turn % 2 == 0 else (0, 1)):
                if armed:
                    arm(tmp)
                try:
                    walls[("compute", armed)].append(host_ms(
                        lambda: event("compute()", lambda: ob.compute(topo)), TEL_COMPUTE_REPS))
                    walls[("whatif", armed)].append(host_ms(
                        lambda: event("what-if", lambda: ob.compute_whatif(topo, masks)),
                        TEL_WHATIF_REPS))
                finally:
                    disarm()
        x["overhead"] = {}
        for what in ("compute", "whatif"):
            on, off = walls[(what, 1)], walls[(what, 0)]
            m_on, m_off = statistics.median(on), statistics.median(off)
            spread = max(max(on) - min(on), max(off) - min(off))
            resolved = abs(m_on - m_off) > spread
            x["overhead"][what] = (m_on, m_off, spread, resolved)
            print(f"time 3p analytics overhead {what}: armed {m_on:.3f} ms, disarmed {m_off:.3f} "
                  f"ms (armed / disarmed {m_on / m_off:.4f}; median of {ANALYTICS_TURNS} "
                  f"alternating turns, each the median of "
                  f"{TEL_COMPUTE_REPS if what == 'compute' else TEL_WHATIF_REPS}; armed "
                  f"{[round(w, 3) for w in on]}, disarmed {[round(w, 3) for w in off]}; "
                  f"{'resolved' if resolved else 'unresolved: within the turns spread'} "
                  f"{spread:.3f} ms); {smi}", flush=True)
        # (f) where compute()'s armed cost goes: one module armed at a time
        # (the observatory brings the work tallies with it), in turns whose
        # order rotates
        from holo_tpu_torch.kernels import work

        arms = {"disarmed": lambda: None, "tallies": lambda: work.set_counting(True),
                "observatory": lambda: observatory.configure(check_every=32, peaks=peaks),
                "events": lambda: (convergence.configure(capacity=1024),
                                   critpath.configure(capacity=1024), slo.configure()),
                "flight": lambda: flight.configure(entries=ANALYTICS_FLIGHT),
                "all": lambda: arm(tmp)}
        split = {name: [] for name in arms}
        names = list(arms)
        for turn in range(ANALYTICS_SPLIT_TURNS):
            for name in names[turn % len(names):] + names[:turn % len(names)]:
                arms[name]()
                try:
                    split[name].append(host_ms(
                        lambda: event("compute()", lambda: ob.compute(topo)), TEL_COMPUTE_REPS))
                finally:
                    disarm()
                    work.set_counting(False)
        base = statistics.median(split["disarmed"])
        x["split"] = {name: statistics.median(w) for name, w in split.items()}
        print(f"time 3p analytics split compute(): " + "; ".join(
            f"{name} {statistics.median(w):.3f} ms ({statistics.median(w) / base:.4f}x, turns "
            f"{min(w):.3f}-{max(w):.3f})" for name, w in split.items())
            + f" (median of {ANALYTICS_SPLIT_TURNS} rotating turns, each the median of "
            f"{TEL_COMPUTE_REPS}); {smi}", flush=True)
    x["phase_s"] = time.perf_counter() - t_phase
    print(f"analytics phase 3p checked in {x['phase_s']:.1f} s", flush=True)
    return x


# The kernel-contract audit (phase 3q): the main-path seams run again at
# full width, and the value lanes they may make.
AUDIT_SEAMS = ("spf.one.seq", "spf.one.fused", "spf.one.packed", "spf.one.hybrid",
               "spf.whatif.batch", "spf.delta.apply", "spf.one.incremental")
VALUE_LANES = {"int32", "bool"}


def audit_phase(dev, topo, masks, chain, n_atoms) -> dict:
    """Phase 3q: the kernel-contract audit on the card (module docstring)."""
    import dataclasses

    from holo_tpu_torch.analysis import kernel_audit as ka
    from holo_tpu_torch.analysis.core import gate_findings
    from holo_tpu_torch.ops import spf_engine as se
    from holo_tpu_torch.ops.graph import build_ell

    t_phase = time.perf_counter()
    root = str(Path(__file__).resolve().parent)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    x = {}

    # (a) every registered program on the card, the sanitizer at "error".
    t0 = time.perf_counter()
    card = ka.run_audit(root, device="cuda")
    x["card_s"] = time.perf_counter() - t0
    for name in sorted(card.kernel_seconds):
        rows = [f.render() for f in card.kernel_findings.get(name, [])]
        print(f"3q (a) {name}: {card.kernel_seconds[name]:.3f} s, lanes "
              f"{card.kernel_lanes.get(name)}, findings {rows or 'none'}", flush=True)
    print(f"3q (a) kernel audit on the card: {card.kernels_checked} programs in "
          f"{x['card_s']:.1f} s, {len(card.findings)} findings "
          f"({len(gate_findings(card.findings))} at error tier), skipped {card.skipped} "
          f"({smi})", flush=True)
    require(card.kernels_checked == 33 and not card.skipped,
            f"3q (a): {card.kernels_checked} programs audited, skipped {card.skipped}")
    require(not gate_findings(card.findings),
            "3q (a): error-tier findings on the card: "
            + "; ".join(f.render() for f in gate_findings(card.findings)))

    # (c) the CPU's audit in this process: the same kernels, the same findings.
    t0 = time.perf_counter()
    cpu = ka.run_audit(root, device="cpu")
    x["cpu_s"] = time.perf_counter() - t0

    def view(result):
        return (sorted(result.kernel_seconds),
                sorted((f.context, f.rule, f.severity) for f in result.findings))

    require(view(card) == view(cpu), f"3q (c): the card's audit {view(card)} != the CPU's "
            f"{view(cpu)}")
    print(f"3q (c) the CPU's audit ({x['cpu_s']:.1f} s) lists the same {len(view(cpu)[0])} "
          f"programs and the same {len(cpu.findings)} findings as the card's", flush=True)

    # (b) the main-path seams at full width on the k=90 inputs.
    reg = ka.load_registry()
    g = se.device_graph_from_ell(build_ell(topo, n_atoms=n_atoms), dev)
    step = chain[0][1]
    delta = step.delta_base
    ell_d = build_ell(topo, n_atoms=n_atoms)
    g_d = se.device_graph_from_ell(ell_d, dev)
    ops = se.lower_delta(se._EllMirror(ell_d), delta, topo.n_vertices)
    g_new = se.device_graph_from_ell(build_ell(step, n_atoms=n_atoms), dev)
    prev = se.spf_one(g, topo.root)
    args = {f"spf.one.{e}": (g, topo.root, masks[1]) for e in ("seq", "fused", "packed",
                                                              "hybrid")}
    args["spf.whatif.batch"] = (g, topo.root, masks)
    args["spf.delta.apply"] = (g_d, ops)
    args["spf.one.incremental"] = (g_new, topo.root, prev, delta.seed_rows())
    torch.cuda.synchronize()
    x["seams"] = {}
    for name in AUDIT_SEAMS:
        entry = dataclasses.replace(reg[name], specs=lambda device, a=args[name]: a)
        rec = {}
        t0 = time.perf_counter()
        found, _ = ka.audit_kernel(entry, device="cuda", rec_out=rec)
        sec = time.perf_counter() - t0
        values = sorted(lane for lane in rec["lanes"] if lane != "int64 (index)")
        x["seams"][name] = {"lanes": rec["lanes"], "windows": rec["windows"], "s": sec,
                            "findings": [f.render() for f in found]}
        print(f"3q (b) {name} at k=90 ({'1024 lanes' if 'whatif' in name else 'one lane'}): "
              f"lanes {rec['lanes']}, windows {dict(sorted(rec['windows'].items()))}, "
              f"findings {[f.render() for f in found] or 'none'}, {sec:.3f} s", flush=True)
        require(not gate_findings(found), f"3q (b) {name}: error-tier findings {found}")
        require(set(values) <= VALUE_LANES, f"3q (b) {name}: value lanes {values}")
    x["phase_s"] = time.perf_counter() - t_phase
    print(f"audit phase 3q checked in {x['phase_s']:.1f} s ({smi})", flush=True)
    return x


def oracle_result(ref, n_atoms: int):
    """The oracle's planes under SpfResult's field names."""
    return type("Ref", (), {"dist": ref.dist, "parent": ref.parent, "hops": ref.hops,
                            "nexthop_words": ref.nexthop_words(n_atoms)})



def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from holo_tpu_torch.kernels import blocked as kernels
    from holo_tpu_torch.kernels import build, ell
    from holo_tpu_torch.ops import blocked as blk
    from holo_tpu_torch.ops import blocked_spf as bspf
    from holo_tpu_torch.ops import graph
    from holo_tpu_torch.ops import spf_engine as se
    from holo_tpu_torch.ops.graph import build_ell
    from holo_tpu_torch.spf.backend import ScalarSpfBackend, TorchSpfBackend
    from holo_tpu_torch.spf.scalar import spf_reference
    from holo_tpu_torch.spf import synth
    from holo_tpu_torch.spf.synth import fat_tree_topology, whatif_link_failure_masks

    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # -- 1. build
    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build.load()
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)
    print(f"sass: {fused_minadd_count(lib_path, build.nvcc())} VIADDMNMX "
          f"instructions in {lib_path.name}", flush=True)

    # -- 2. kernels against their plain versions, on real inputs
    t0 = time.perf_counter()
    topo = fat_tree_topology(k=K)
    masks = whatif_link_failure_masks(topo, BATCH, seed=MASK_SEED)
    print(f"topology: {topo.n_vertices} vertices, {topo.n_edges} edges, "
          f"{topo.n_atoms()} atoms; {BATCH} scenarios "
          f"({time.perf_counter() - t0:.1f} s to generate)", flush=True)
    dev = DEVICE
    g = bspf.marshal_block_spf(topo, n_atoms=max(64, topo.n_atoms()), device=dev)
    perm_of = g.orig2perm.cpu().numpy()
    fdst, fid = bspf.failed_edges_perm(perm_of, topo, masks, device=dev)
    npad = g.in_src.shape[0]
    nnz = int((g.w < blk.CAP).sum())
    require(nnz == g.crow.shape[0], "compact edge planes miss entries of w")
    print(f"planes: {g.w.shape[0]} block pairs, N_pad {npad}, K {g.in_src.shape[1]}, "
          f"W {g.n_words}, nonzero weights {nnz}", flush=True)

    calls = kernel_calls(kernels, blk, g, stage_inputs(blk, bspf, g, fdst, fid), nnz)
    rows = hold_to_plain(calls, f"at B={BATCH}")
    # compute()'s shapes: one scenario, no failed edge.
    none = torch.full((1, fdst.shape[1]), -1, dtype=torch.int32, device=dev)
    calls1 = kernel_calls(kernels, blk, g, stage_inputs(blk, bspf, g, none, none), nnz)
    rows1 = hold_to_plain(calls1, "at B=1")

    # K1's path: relax-only what-if distances, card against the CPU path.
    bg = blk.marshal_blocks(topo, device=dev)
    k1_fdst, k1_fid = blk.failed_edges_from_masks(topo, masks[:K1_SCENARIOS], device=dev)
    k1_card = blk.whatif_distances_blocked(bg, topo.root, k1_fdst, k1_fid).cpu()
    bg_cpu = type(bg)(*[x.cpu() if torch.is_tensor(x) else x for x in bg])
    k1_cpu = blk.whatif_distances_blocked(bg_cpu, topo.root, k1_fdst.cpu(), k1_fid.cpu())
    require(torch.equal(k1_card, k1_cpu), "whatif_distances_blocked card != CPU path")
    print(f"whatif_distances_blocked: {K1_SCENARIOS} scenarios bit-identical "
          f"to the CPU plain path", flush=True)
    del bg, bg_cpu

    # The gather kernels, at the same three shapes as its main path.
    n_atoms = max(64, topo.n_atoms())
    eg = se.device_graph_from_ell(build_ell(topo, n_atoms=n_atoms), dev)
    print(f"ELL planes: N {eg.in_src.shape[0]}, K {eg.in_src.shape[1]}, W "
          f"{eg.direct_nh_words.shape[2]}, valid slots {int(eg.in_valid.sum())} of "
          f"{eg.in_valid.numel()}", flush=True)
    mask_w = se.pack_edge_masks(masks, dev)
    lane_roots = torch.full((BATCH,), topo.root, dtype=torch.int32, device=dev)
    failed = int((~masks).sum())
    p, x = ell_inputs(ell, se, eg, lane_roots, mask_w)
    ecalls = ell_calls(ell, eg, p, x, lane_roots, failed, f"at B={BATCH}")
    erows = hold_to_plain(ecalls, f"at B={BATCH}")
    frows = hold_rounds(ell, p, x, f"at B={BATCH}")
    root1 = lane_roots[:1].clone()
    p1, x1 = ell_inputs(ell, se, eg, root1, None)
    ecalls1 = ell_calls(ell, eg, p1, x1, root1, 0, "at B=1")
    erows1 = hold_to_plain(ecalls1, "at B=1")
    hold_rounds(ell, p1, x1, "at B=1")
    mr_roots = np.sort(np.random.default_rng(ROOT_SEED).choice(
        topo.n_vertices, MULTIROOT, replace=False)).astype(np.int32)
    mr_t = torch.from_numpy(mr_roots).to(dev)
    pr, xr = ell_inputs(ell, se, eg, mr_t, None)
    ecallsr = ell_calls(ell, eg, pr, xr, mr_t, 0, f"at {MULTIROOT} roots")
    erowsr = hold_to_plain(ecallsr, f"at {MULTIROOT} roots")
    hold_rounds(ell, pr, xr, f"at {MULTIROOT} roots")

    # -- 3. the main path, counted
    kernels.reset_launches()
    be = TorchSpfBackend(engine="blocked", device=dev)
    t0 = time.perf_counter()
    res = be.compute_whatif(topo, masks)
    cold_ms = (time.perf_counter() - t0) * 1e3
    per_whatif = dict(kernels.launches)
    one = be.compute(topo)
    torch.cuda.synchronize()
    launched = dict(kernels.launches)
    per_compute = {k: launched[k] - per_whatif[k] for k in launched}
    print(f"main path launches: {launched} (compute_whatif {per_whatif}, "
          f"compute {per_compute})", flush=True)
    for name in kernels.launches:
        require(launched[name] > 0, f"kernel {name} never launched on the main path")

    n = topo.n_vertices
    require(len(res) == BATCH, "batch size")
    for r in [*res, one]:
        require(r.dist.shape == (n,) and r.nexthop_words.shape == (n, g.n_words),
                "output shapes")
        require(bool((r.dist >= 0).all()), "negative distance")
    oracle = [spf_reference(topo, masks[b]) for b in range(ORACLE_SCENARIOS)]
    checks = [(f"scenario {b}", res[b], oracle[b]) for b in range(ORACLE_SCENARIOS)]
    compute_ref = spf_reference(topo)
    checks.append(("compute()", one, compute_ref))
    for label, got, ref in checks:
        for field, want in (("dist", ref.dist), ("parent", ref.parent), ("hops", ref.hops),
                            ("nexthop_words", ref.nexthop_words(n_atoms))):
            require(np.array_equal(getattr(got, field), want),
                    f"{label} {field} differs from the scalar oracle")
    for b in range(K1_SCENARIOS):
        require(np.array_equal(k1_card[b].numpy(), oracle[b].dist),
                f"whatif_distances_blocked scenario {b} differs from the oracle")
    reached = int((res[ORACLE_SCENARIOS - 1].dist < (1 << 30)).sum())
    print(f"oracle: scenarios 0-{ORACLE_SCENARIOS - 1} and compute() bit-identical on "
          f"dist/parent/hops/nexthop_words ({reached}/{n} reached in scenario "
          f"{ORACLE_SCENARIOS - 1})", flush=True)
    require(be.routed_to_gather == 0, "the blocked engine sent a dispatch to the gather engine")
    print(f"blocked route to gather: {be.routed_to_gather} dispatches", flush=True)

    # -- 3b. the gather main path (the default engine), counted
    ell.reset_launches()
    gbe = TorchSpfBackend(device=dev)
    require(gbe.engine == "gather", "the default engine is not the gather engine")
    t0 = time.perf_counter()
    gres = gbe.compute_whatif(topo, masks)
    g_cold_ms = (time.perf_counter() - t0) * 1e3
    g_whatif = dict(ell.launches)
    gone = gbe.compute(topo)
    g_after = dict(ell.launches)
    gmr = gbe.compute_multiroot(topo, mr_roots)
    torch.cuda.synchronize()
    g_launched = dict(ell.launches)
    g_compute = {k: g_after[k] - g_whatif[k] for k in g_launched}
    g_multiroot = {k: g_launched[k] - g_after[k] for k in g_launched}
    print(f"gather main path launches: {g_launched} (compute_whatif {g_whatif}, compute "
          f"{g_compute}, compute_multiroot {g_multiroot})", flush=True)
    for name in ELL_REPLACES:
        require(g_launched[name] > 0, f"kernel {name} never launched on the gather main path")
    require(len(gres) == BATCH and gmr.dist.shape == (MULTIROOT, n), "gather batch sizes")
    checks = [(f"gather scenario {b}", gres[b], oracle[b]) for b in range(ORACLE_SCENARIOS)]
    checks.append(("gather compute()", gone, compute_ref))
    for label, got, ref in checks:
        for field, want in (("dist", ref.dist), ("parent", ref.parent), ("hops", ref.hops),
                            ("nexthop_words", ref.nexthop_words(n_atoms))):
            require(np.array_equal(getattr(got, field), want),
                    f"{label} {field} differs from the scalar oracle")
    mr_ref = ScalarSpfBackend().compute_multiroot(topo, mr_roots[:ORACLE_ROOTS])
    for field in ("dist", "parent", "hops"):
        require(np.array_equal(getattr(gmr, field)[:ORACLE_ROOTS], getattr(mr_ref, field)),
                f"gather multiroot {field} differs from the scalar oracle")
    print(f"gather oracle: scenarios 0-{ORACLE_SCENARIOS - 1}, compute() and roots "
          f"{mr_roots[:ORACLE_ROOTS].tolist()} bit-identical on every plane", flush=True)

    # -- 3c. empty batches on the card: the empty result, no kernel launched
    ell.reset_launches()
    kernels.reset_launches()
    for ebe in (gbe, be):
        require(ebe.compute_whatif(topo, masks[:0]) == [],
                f"empty compute_whatif ({ebe.engine}) is not []")
        emr = ebe.compute_multiroot(topo, mr_roots[:0])
        require(all(getattr(emr, f).shape == (0, n) for f in ("dist", "parent", "hops")),
                f"empty compute_multiroot ({ebe.engine}) is not (0, N)")
    torch.cuda.synchronize()
    require(not any(ell.launches.values()) and not any(kernels.launches.values()),
            "an empty batch launched a kernel")
    print("empty batches: compute_whatif [] and compute_multiroot (0, N) on both engines, "
          "no kernel launched", flush=True)

    # -- 3d. DeltaPath: the chain of events, counted
    dbe = TorchSpfBackend(device=dev)
    dbe.compute(topo)  # warm: keeps the run the first delta seeds from
    chain = delta_chain(graph, synth, topo, K)
    dbe.delta_stats = {}
    d_steps = []
    d_hold = Holder(ell)
    ell.reset_launches()
    with holding(ell, d_hold):
        for label, t in chain:
            paths = Counter(dbe.delta_paths)
            t0 = time.perf_counter()
            res = dbe.compute(t)
            ms = (time.perf_counter() - t0) * 1e3
            d_steps.append((label, t, res, ms, dict(dbe.delta_stats),
                            Counter(dbe.delta_paths) - paths))
    torch.cuda.synchronize()
    d_launched = dict(ell.launches)
    print(f"delta chain launches: {d_launched}", flush=True)
    for name in ("ell_relax", "ell_first_parent", "ell_mp_round"):
        require(d_launched[name] > 0, f"kernel {name} never launched on the DeltaPath chain")
    require(d_hold.held["ell_mp_round"] == d_launched["ell_mp_round"]
            and d_launched["ell_parent_sets"] == 0,
            "a DeltaPath ell_mp_round launch was not held, or the fused walk ran")
    require(set(d_hold.lanes) == {("ell_mp_round", 1, False)},
            "the single-path chain ran ell_mp_round with more than one lane or with counts")
    d_mp_err = d_hold.err["ell_mp_round"]
    print(f"kernel ell_mp_round single-path chain: all {d_launched['ell_mp_round']} launches "
          f"(one lane, no count or weight planes) bit-identical to mp_round_plain and the full "
          f"round (max_abs_err {d_mp_err})", flush=True)
    full_be = TorchSpfBackend(device=dev, incremental=False)
    for i, (label, t, res, ms, st, paths) in enumerate(d_steps):
        kind = graph.delta_kind(t.delta_base)
        require(paths == Counter({(kind, "apply"): 1, (kind, "incremental"): 1}),
                f"delta step {i} ({label}) did not take the incremental path: {dict(paths)}")
        require(same_planes(res, full_be.compute(synth.clone_topology(t))),
                f"delta step {i} ({label}) differs from the full path")
        if i < 2:
            require(same_planes(res, ScalarSpfBackend().compute(t)),
                    f"delta step {i} ({label}) differs from the scalar oracle")
        print(f"delta step {i} {label} ({kind}, {t.delta_base.n_ops} ops, "
              f"{len(graph.delta_seed_rows(t.delta_base))} seed rows): incremental, "
              f"bit-identical to the full path{' and the oracle' if i < 2 else ''}; affected "
              f"{st['affected_rows']} rows in {st['affected']} rounds ({st['affected_ms']:.3f} "
              f"ms), relax {st['relax']} rounds ({st['relax_ms']:.3f} ms), parent + hops/next "
              f"hops {st['hops_nh']} rounds ({st['hops_nh_ms']:.3f} ms); compute() "
              f"{ms:.3f} ms", flush=True)
    last = chain[-1][1]
    # A structural delta, then a what-if batch: the entry's edge ids are
    # stale, so the what-if rebuilds; a weight delta then applies in place.
    a, c = K * K // 4 + 8 * (K // 2), 0  # agg(8, 0) <-> core 0
    f, r = link_ids(last, a, c)
    keep = np.ones(last.n_edges, bool)
    keep[[f, r]] = False
    t_struct = linked(graph, last, synth.clone_topology(last, keep=keep))
    wmasks = whatif_link_failure_masks(t_struct, WHATIF_AFTER_DELTA, seed=MASK_SEED)
    t_weight = set_link_cost(graph, synth, t_struct, a + 1, K // 2, 8)  # agg(8,1) <-> core K/2
    for t, kind, want in ((t_struct, "struct", "full-edge-ids"), (t_weight, "weight", "apply")):
        paths, looks = Counter(dbe.delta_paths), Counter(dbe._gather_cache.lookups)
        got = dbe.compute_whatif(t, wmasks)
        paths = Counter(dbe.delta_paths) - paths
        looks = Counter(dbe._gather_cache.lookups) - looks
        require(paths == Counter({(kind, want): 1}),
                f"what-if after a {kind} delta: dispositions {dict(paths)}, not {want}")
        require(looks == Counter({"miss" if kind == "struct" else "delta": 1}),
                f"what-if after a {kind} delta: lookups {dict(looks)}")
        ref = full_be.compute_whatif(synth.clone_topology(t), wmasks)
        require(all(same_planes(x, y) for x, y in zip(got, ref)) and len(got) == len(ref),
                f"what-if after a {kind} delta differs from the full path")
        print(f"what-if after a {kind} delta: {dict(paths)}, graph lookup {dict(looks)}; "
              f"{len(got)} scenarios bit-identical to the full path", flush=True)
    del full_be

    # -- 3e. multipath: the kernels held to their plain versions, then the
    # multipath paths counted, every launch held
    t_mp = time.perf_counter()
    mx64 = mp_dispatch(ell, se, eg, lane_roots[:MP_HOLD_LANES].clone(),
                       se.pack_edge_masks(masks[:MP_HOLD_LANES], dev), MP_K, True,
                       f"at B={MP_HOLD_LANES}")
    del mx64
    # What a first touch of device memory costs: a fresh allocation the size
    # of the weight plane, taken from the CUDA runtime, filled; then filled again.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    aw_shape = (eg.in_src.shape[0], 32 * eg.direct_nh_words.shape[2], BATCH)
    fresh, touch_ms = cuda_call(lambda: torch.zeros(aw_shape, dtype=torch.int32, device=dev))
    touch_again_ms = cuda_call(lambda: fresh.zero_())[1]
    del fresh
    mx = mp_dispatch(ell, se, eg, lane_roots, mask_w, MP_K, False, f"at B={BATCH}")
    mb = parent_sets_bound(ell, mx, MP_K, int((p.slot >= 0).sum()) * BATCH - failed)
    mx1 = mp_dispatch(ell, se, eg, root1, None, MP_K, True, "at B=1")
    mb1 = parent_sets_bound(ell, mx1, MP_K, int((p1.slot >= 0).sum()))
    ps8_in = (*mx1["ps_in"][:-1], 8)
    p1_, d1_, r1_ = mx1["p"], mx1["dist"], mx1["fixed"][4]
    ps8_err = held("ell_parent_sets", "at B=1 kp=8", ell.ell_parent_sets(*ps8_in),
                   (*ell.first_parent_plain(*p1_, d1_, r1_),
                    *ell.parent_sets_plain(*p1_, d1_, torch.zeros_like(d1_), r1_, 8)[:2]))
    print(f"first touch: a fresh {aw_shape} int32 plane filled in {touch_ms:.3f} ms (CUDA "
          f"allocation included), again in {touch_again_ms:.3f} ms", flush=True)
    print(f"multipath kernels held in {time.perf_counter() - t_mp:.1f} s; admissible pairs "
          f"{mb['admissible']} at B={BATCH}, {mb1['admissible']} at B=1", flush=True)

    t_mp = time.perf_counter()
    ell.reset_launches()
    mbe = TorchSpfBackend(device=dev)
    m_hold = Holder(ell)
    with holding(ell, m_hold):
        m_one = {k: mbe.compute(topo, multipath_k=k) for k in MP_KS}
        torch.cuda.synchronize()
        m_compute = dict(ell.launches)
        m_batch = mbe.compute_whatif(topo, masks, multipath_k=MP_K)
        torch.cuda.synchronize()
        m_whatif = {k: ell.launches[k] - m_compute[k] for k in ell.launches}
        mdbe = TorchSpfBackend(device=dev)
        mdbe.compute(topo, multipath_k=MP_K)
        mdbe.delta_stats = {}
        m_steps = []
        before = dict(ell.launches)
        for label, t in delta_chain(graph, synth, topo, K):
            paths = Counter(mdbe.delta_paths)
            t0 = time.perf_counter()
            res = mdbe.compute(t, multipath_k=MP_K)
            m_steps.append((label, t, res, (time.perf_counter() - t0) * 1e3,
                            dict(mdbe.delta_stats), Counter(mdbe.delta_paths) - paths))
    torch.cuda.synchronize()
    m_launched = dict(ell.launches)
    m_chain = {k: m_launched[k] - before[k] for k in m_launched}
    require(all(m_hold.held[name] == m_launched[name] for name in MP_REPLACES),
            "a multipath launch was not held")
    m_chain_err = max(m_hold.err["ell_mp_round"], m_hold.err["ell_parent_sets"])
    print(f"kernels ell_mp_round / ell_parent_sets / ell_parent_weights on the multipath "
          f"paths: all {m_launched['ell_mp_round']} / {m_launched['ell_parent_sets']} / "
          f"{m_launched['ell_parent_weights']} launches (lanes, counts or kp: "
          f"{dict(m_hold.lanes)}) bit-identical to their plain versions (max_abs_err "
          f"{max(m_hold.err.values())})", flush=True)
    print(f"multipath path launches: {m_launched} (compute x{len(MP_KS)} {m_compute}, "
          f"compute_whatif {m_whatif}, delta chain {m_chain})", flush=True)
    for name in MP_REPLACES:
        require(m_compute[name] > 0 and m_whatif[name] > 0 and m_chain[name] > 0,
                f"kernel {name} missed multipath compute(), the what-if or the chain")
    require(m_launched["ell_first_parent"] == 0,
            "ell_first_parent launched on a multipath path (the fused walk replaces it)")
    m_k1 = mbe.compute(topo, multipath_k=1)
    mp_oracle = ScalarSpfBackend()
    m_ref = {k: mp_oracle.compute(topo, multipath_k=k) for k in MP_KS}  # phase 3l reads them too
    for k, res in m_one.items():
        require(res.parents.shape == (n, k) and res.nh_weights.shape == (n, n_atoms),
                f"multipath compute(k={k}) shapes")
        require(same_nine(res, m_ref[k]),
                f"multipath compute(k={k}) differs from the multipath oracle")
    require(same_planes(m_k1, gone) and all(getattr(m_k1, f) is None for f in MP_FIELDS),
            "multipath_k=1 is not the single-path compute()")
    require(len(m_batch) == BATCH, "multipath batch size")
    for b in range(MP_ORACLE_SCENARIOS):
        require(same_nine(m_batch[b], mp_oracle.compute(topo, masks[b], multipath_k=MP_K)),
                f"multipath scenario {b} differs from the multipath oracle")
    require(all(same_planes(a, b) for a, b in zip(m_batch, gres)),
            "a multipath scenario's single-path planes differ from the single-path batch")
    npaths_max = max(int(r.npaths.max()) for r in m_batch[:MP_ORACLE_SCENARIOS])
    print(f"multipath oracle: compute(k={list(MP_KS)}) and scenarios "
          f"0-{MP_ORACLE_SCENARIOS - 1} bit-identical in all nine planes (max npaths "
          f"{npaths_max}, {int((m_one[MP_K].parents < n).sum())} parent entries at k={MP_K}); "
          f"k=1 equals compute(); all {BATCH} scenarios' single-path planes equal the "
          f"single-path batch", flush=True)
    del m_batch
    m_full = TorchSpfBackend(device=dev, incremental=False)
    m_step_ref = []  # the oracle of the chain's first steps, phase 3l's too
    for i, (label, t, res, ms, st, paths) in enumerate(m_steps):
        kind = graph.delta_kind(t.delta_base)
        require(paths == Counter({(kind, "apply"): 1, (kind, "incremental"): 1}),
                f"multipath delta step {i} ({label}) did not take the incremental path: "
                f"{dict(paths)}")
        require(same_nine(res, m_full.compute(synth.clone_topology(t), multipath_k=MP_K)),
                f"multipath delta step {i} ({label}) differs from the full path")
        if i < MP_ORACLE_STEPS:
            m_step_ref.append(mp_oracle.compute(t, multipath_k=MP_K))
            require(same_nine(res, m_step_ref[i]),
                    f"multipath delta step {i} ({label}) differs from the oracle")
        print(f"multipath delta step {i} {label}: incremental, bit-identical to the full "
              f"path{' and the oracle' if i < MP_ORACLE_STEPS else ''}; affected "
              f"{st['affected_rows']} rows, relax {st['relax']} rounds, joint fixpoint "
              f"{st['hops_nh']} rounds; compute() {ms:.3f} ms", flush=True)
    del m_full
    print(f"multipath paths checked in {time.perf_counter() - t_mp:.1f} s", flush=True)

    # -- 3f. fast reroute: the all-roots matrix and the backup tables
    fx = frr_phase(ell, se, dev, topo)

    # -- 3g. CSPF: 1024 TE requests as one masked batch
    cx = cspf_phase(ell, topo)

    # -- 3h. partitioned SPF: the 100k multi-area LSDB, hinted and flat, and 10k
    px = partition_phase(ell, se, dev)

    # -- 3i. the BGP table: the engine path, the full-table fold, UPDATE rounds
    bx = bgp_phase()

    # -- 3j. the fused, packed and hybrid engines, the fused round, the tuner
    jx = engines_phase(ell, se, dev, topo, masks, gres, gone, oracle, compute_ref, n_atoms)

    # -- 3k. the tropical engine: the tiles, T1 and its four paths and chain
    kx = trop_phase(ell, se, dev, topo, masks, gres, gone, gmr, mr_roots, oracle, compute_ref,
                    mr_ref, n_atoms)

    # -- 3l. the tropical multipath program: T2 and its paths
    lx = trop_mp_phase(ell, se, dev, topo, masks, m_ref, m_step_ref, n_atoms)

    # -- 3m. the dispatch pipeline: held results, interleaved chains, launch/finish
    pipeline_phase(ell, dev, topo, masks, gone, oracle_result(oracle[1], n_atoms), m_one, chain,
                   d_steps)

    # -- 3n. the dispatch mesh: the 1-device mesh against no mesh, its
    # overhead, virtual meshes over the card, the dry run
    mesh_phase(dev, topo, masks, gres, gmr, mr_roots, oracle, mr_ref, n_atoms)

    # -- 4. timing (the profiler last: once it has run, host launches are
    # slower, which the host-clock times below would count)
    for name, (card, *_rest) in calls.items():
        card()  # warm-up
        rows[name]["ms"] = cuda_ms(card, KERNEL_REPS)
    for name, (card, *_rest) in calls1.items():
        card()
        rows1[name]["ms"] = cuda_ms(card, KERNEL_REPS)
    batch_ms = host_ms(lambda: be.compute_whatif(topo, masks), BATCH_REPS)
    compute_ms = host_ms(lambda: be.compute(topo), COMPUTE_REPS)
    scan_ms = host_ms(
        lambda: bspf.failed_edges_perm(perm_of, topo, masks, device=dev), BATCH_REPS
    )
    spf_ms = host_ms(lambda: bspf.whatif_spf_blocked(g, fdst, fid), BATCH_REPS)
    for table, gcalls in ((erows, ecalls), (erows1, ecalls1), (erowsr, ecallsr)):
        for name, (card, *_rest) in gcalls.items():
            card()
            table[name]["ms"] = cuda_ms(card, KERNEL_REPS)
    hop0_ms = cuda_ms(lambda: ell.pack_lane_bits(x["hops"] == 0), KERNEL_REPS)
    g_batch_ms = host_ms(lambda: gbe.compute_whatif(topo, masks), BATCH_REPS)
    g_compute_ms = host_ms(lambda: gbe.compute(topo), COMPUTE_REPS)
    g_mr_ms = host_ms(lambda: gbe.compute_multiroot(topo, mr_roots), BATCH_REPS)
    g_pack_ms = host_ms(lambda: se.pack_edge_masks(masks, dev), BATCH_REPS)
    g_spf_ms = host_ms(lambda: se.spf_lanes(eg, lane_roots, mask_w), BATCH_REPS)
    # The engines' lane programs at 1024 lanes (phase 3j's engines).
    t_j = time.perf_counter()
    j_prog = {e: (lambda e=e: se.LANE_ENGINES[e](eg, lane_roots, mask_w))
              for e in ("seq", *ENGINE_NAMES)}
    j_prog_ms = {e: host_ms(prog, BATCH_REPS) for e, prog in j_prog.items()}
    j_phase4_s = time.perf_counter() - t_j
    t_k = time.perf_counter()
    k_prog_ms = host_ms(kx["lane_prog"], BATCH_REPS)
    k_phase4_s = time.perf_counter() - t_k
    # DeltaPath: delta-linked compute() calls, each toggling one link's
    # cost, against a re-marshal (fresh clones) and a cached call.
    chain_t = toggles(graph, synth, t_weight, K, DELTA_TOGGLES)
    dbe.compute(t_weight)  # the toggles' base: its run is kept
    delta_times, toggle_stats = [], []
    for t in chain_t:
        t0 = time.perf_counter()
        dbe.compute(t)
        torch.cuda.synchronize()
        delta_times.append((time.perf_counter() - t0) * 1e3)
        toggle_stats.append(dict(dbe.delta_stats))
    require(dbe.delta_paths[("weight", "incremental")] >= DELTA_TOGGLES,
            "a timed delta-linked compute() left the incremental path")
    d_delta_ms = statistics.median(delta_times)
    fresh = [synth.clone_topology(chain_t[-1]) for _ in range(REMARSHAL_REPS)]
    remarshal_times = []
    for t in fresh:
        t0 = time.perf_counter()
        dbe.compute(t)
        torch.cuda.synchronize()
        remarshal_times.append((time.perf_counter() - t0) * 1e3)
    d_remarshal_ms = statistics.median(remarshal_times)
    d_cached_ms = host_ms(lambda: dbe.compute(fresh[-1]), COMPUTE_REPS)
    # The same toggles split into the host's delta lowering + slot scatter
    # (DeviceGraphCache.get) and the incremental SPF (host clock and CUDA
    # events), on a cache and a run of their own.
    split_base = synth.clone_topology(t_weight)
    split_chain = toggles(graph, synth, split_base, K, DELTA_TOGGLES)
    cache = se.DeviceGraphCache(dev, capacity=2)
    g_split, _ = cache.get(split_base, n_atoms)
    prev = se.spf_one(g_split, split_base.root)
    lower_ms, incr_ms, incr_ev_ms = [], [], []
    for t in split_chain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g_split, how = cache.get(t, n_atoms)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        require(how == "delta", "the split toggles' cache did not apply the delta")
        seeds = graph.delta_seed_rows(t.delta_base)
        last_in = (g_split, t.root, prev, seeds)
        prev, ev_ms = cuda_call(lambda: se.spf_one_incremental(*last_in))
        incr_ms.append((time.perf_counter() - t1) * 1e3)
        lower_ms.append((t1 - t0) * 1e3)
        incr_ev_ms.append(ev_ms)
    # Multipath: the kernels on their held inputs, compute(), the batch and
    # its program, delta toggles at multipath_k=4.
    work, work1 = mx["work"], mx1["work"]
    m_ops, m_bytes = sum(w["ops"] for w in work), sum(w["bytes"] for w in work)
    m_dispatch_bound = sum(w["bound_ms"] for w in work)
    m_rows = {"ell_mp_round": {
        "ms": statistics.mean(mx["round_ms"]), "dispatch_ms": sum(mx["round_ms"]),
        "launch_ms": mx["round_ms"], "ms_b1": statistics.mean(mx1["round_ms"]),
        "plain_ms": statistics.mean(mx["plain_ms"]),
        "max_abs_err": max(mx["err"], mx1["err"], d_mp_err, m_chain_err),
        "bound_ms": m_dispatch_bound / len(work), "bound_by": bound(m_ops, m_bytes)[1],
        "ops": m_ops, "bytes": m_bytes, "dispatch_bound_ms": m_dispatch_bound,
        "launch_bound_ms": [w["bound_ms"] for w in work],
        "recomputed_entries": [w["recomputed"] for w in work],
        "copied_entries": [w["copied"] for w in work],
        "full_round_bound_ms": mx["full_bound"][0],
        "bound_ms_b1": statistics.mean(w["bound_ms"] for w in work1),
        "bound_by_b1": bound(sum(w["ops"] for w in work1), sum(w["bytes"] for w in work1))[1],
    }}
    ps_b, ps_b1 = mb["ell_parent_sets"], mb1["ell_parent_sets"]
    pw_b, pw_b1 = mb["ell_parent_weights"], mb1["ell_parent_weights"]
    m_rows["ell_parent_sets"] = {
        "ms": cuda_ms(lambda: ell.ell_parent_sets(*mx["ps_in"]), KERNEL_REPS),
        "ms_b1": cuda_ms(lambda: ell.ell_parent_sets(*mx1["ps_in"]), KERNEL_REPS),
        "plain_ms": mx["ps_plain_ms"],
        "max_abs_err": max(mx["ps_err"], mx1["ps_err"], ps8_err, m_chain_err),
        "bound_ms": ps_b[0], "bound_by": ps_b[1], "ops": ps_b[2], "bytes": ps_b[3],
        "bound_ms_b1": ps_b1[0], "bound_by_b1": ps_b1[1],
    }
    # The library call: torch.gather of the padded path counts at the
    # parents (its int64 index built beforehand).
    pw_parents, pw_np = mx["pw_in"]
    pw_n, pw_kp, pw_lanes = pw_parents.shape
    pw_ext = torch.cat([pw_np, pw_np.new_zeros((1, pw_lanes))])
    pw_idx = pw_parents.reshape(pw_n * pw_kp, pw_lanes).long()
    m_rows["ell_parent_weights"] = {
        "ms": cuda_ms(lambda: ell.ell_parent_weights(*mx["pw_in"]), KERNEL_REPS),
        "ms_b1": cuda_ms(lambda: ell.ell_parent_weights(*mx1["pw_in"]), KERNEL_REPS),
        "plain_ms": mx["pw_plain_ms"],
        "library_ms": cuda_ms(lambda: torch.gather(pw_ext, 0, pw_idx), KERNEL_REPS),
        "max_abs_err": max(mx["pw_err"], mx1["pw_err"], m_hold.err["ell_parent_weights"]),
        "bound_ms": pw_b[0], "bound_by": pw_b[1], "ops": pw_b[2], "bytes": pw_b[3],
        "bound_ms_b1": pw_b1[0], "bound_by_b1": pw_b1[1],
    }
    del pw_ext, pw_idx
    m_compute_ms = host_ms(lambda: mbe.compute(topo, multipath_k=MP_K), COMPUTE_REPS)
    m_compute8_ms = host_ms(lambda: mbe.compute(topo, multipath_k=8), COMPUTE_REPS)
    m_batch_ms = host_ms(lambda: mbe.compute_whatif(topo, masks, multipath_k=MP_K), BATCH_REPS)
    m_lanes_ms = host_ms(lambda: se.mp_lanes(eg, lane_roots, mask_w, MP_K), BATCH_REPS)
    m_toggle_base = m_steps[-1][1]
    m_toggles = toggles(graph, synth, m_toggle_base, K, DELTA_TOGGLES)
    # The toggles' base: its graph left the shared cache since the chain ran
    # (3f empties it), so it is marshaled again; its run is kept.
    mdbe.compute(m_toggle_base, multipath_k=MP_K)
    m_served = mdbe.delta_paths[("weight", "incremental")]
    m_delta_times, m_toggle_stats = [], []
    for t in m_toggles:
        t0 = time.perf_counter()
        mdbe.compute(t, multipath_k=MP_K)
        torch.cuda.synchronize()
        m_delta_times.append((time.perf_counter() - t0) * 1e3)
        m_toggle_stats.append(dict(mdbe.delta_stats))
    require(mdbe.delta_paths[("weight", "incremental")] == m_served + DELTA_TOGGLES,
            "a timed multipath delta-linked compute() left the incremental path")
    m_delta_ms = statistics.median(m_delta_times)
    sel_ms = host_ms(fx["select"], FRR_WARM_REPS)
    for name, (card, *_rest) in calls1.items():
        rows1[name]["device_ms"] = device_ms_per_call(card, KERNEL_REPS)
    for name, (card, *_rest) in ecalls1.items():
        erows1[name]["device_ms"] = device_ms_per_call(card, KERNEL_REPS)
    busy_ms, top = device_busy(lambda: bspf.whatif_spf_blocked(g, fdst, fid))
    compute_busy_ms, compute_top = device_busy(lambda: be.compute(topo))
    g_busy_ms, g_top = device_busy(lambda: se.spf_lanes(eg, lane_roots, mask_w))
    t_j = time.perf_counter()
    j_busy = {e: (device_busy(prog), device_busy(lambda e=e: jx["backends"][e].compute(topo)))
              for e, prog in j_prog.items()}
    j_phase4_s += time.perf_counter() - t_j
    t_k = time.perf_counter()
    k_busy_ms, k_top = device_busy(kx["lane_prog"])
    k_prog_times = device_times(kx["lane_prog"])
    k_t1_ms = {name: sum(ms for key, ms in k_prog_times.items() if name in key)
               for name in ("trop_relax", "trop_repair")}
    k_c_busy_ms, k_c_top = device_busy(kx["compute_call"])
    k_t1_b1 = sum(ms for name, ms in device_times(kx["compute_call"]).items()
                  if "trop_relax" in name)
    k_phase4_s += time.perf_counter() - t_k
    t_l = time.perf_counter()
    l_busy = {e: device_busy(lx[key]) for e, key in (("mp_tropical", "compute_call"),
                                                      ("mp", "mp_compute_call"))}
    l_times = device_times(lx["compute_call"])
    l_t2_dispatch = sum(ms for name, ms in l_times.items() if "trop_count" in name)
    for lanes, v in lx["t2"].items():
        per = device_times(lambda v=v: [v["run"]() for _ in range(KERNEL_REPS)])
        v["device_ms"] = sum(ms for name, ms in per.items() if "trop_count" in name) / KERNEL_REPS
        per = device_times(lambda v=v: [v["list_run"]() for _ in range(KERNEL_REPS)])
        v["list_device_ms"] = sum(per.values()) / KERNEL_REPS
    l_phase4_s = time.perf_counter() - t_l
    g_compute_busy_ms, g_compute_top = device_busy(lambda: gbe.compute(topo))
    incr_busy_ms, incr_top = device_busy(lambda: se.spf_one_incremental(*last_in))
    m_rows["ell_parent_sets"]["device_ms_b1"] = device_ms_per_call(
        lambda: ell.ell_parent_sets(*mx1["ps_in"]), KERNEL_REPS)
    m_rows["ell_parent_weights"]["device_ms_b1"] = device_ms_per_call(
        lambda: ell.ell_parent_weights(*mx1["pw_in"]), KERNEL_REPS)
    m_busy_ms, m_top = device_busy(lambda: se.mp_lanes(eg, lane_roots, mask_w, MP_K))
    # One multipath compute(): its device busy, and M1's device time over
    # the dispatch's launches (row form, one lane).
    m1_before = ell.launches["ell_mp_round"]
    m_compute_times = device_times(lambda: mbe.compute(topo, multipath_k=MP_K))
    m1_b1_launches = ell.launches["ell_mp_round"] - m1_before
    m1_b1_ms = sum(ms for key, ms in m_compute_times.items() if "ell_mp_round" in key)
    m_rows["ell_mp_round"]["device_ms_b1"] = m1_b1_ms / max(m1_b1_launches, 1)
    m_rows["ell_mp_round"]["device_dispatch_ms_b1"] = m1_b1_ms
    m_compute_busy_ms = sum(m_compute_times.values())
    m_compute_top = [(key[:60], round(ms, 3)) for key, ms in
                     sorted(m_compute_times.items(), key=lambda kv: -kv[1])[:5]]
    frr_busy_ms, frr_top = device_busy(lambda: fx["engine"].compute(topo))
    sel_busy_ms, sel_top = device_busy(fx["select"])
    cspf_busy_ms, cspf_top = device_busy(cx.pop("busy"))
    part_busy = {arm: device_busy(r.pop("busy")) for arm, r in px["arms"].items()}
    mono100_busy_ms, mono100_top = device_busy(px.pop("mono_busy"))
    bx["update_device_ms"] = device_ms_per_call(bx.pop("update_busy"), KERNEL_REPS)
    print(f"time bgp_fold {BGP_RADIUS} x {BGP_FULL_COLS} device: {bx['update_device_ms']:.4f} ms "
          f"(profiler, launch excluded; {bx['update_ms']:.4f} ms by CUDA events), bound "
          f"{bx['update_bound'][0]:.5f} ms", flush=True)
    extra = toggles(graph, synth, fresh[-1], K, 1)[0]
    served = dbe.delta_paths[("weight", "incremental")]
    d_busy_ms, _ = device_busy(lambda: dbe.compute(extra))
    require(dbe.delta_paths[("weight", "incremental")] == served + 1,
            "the profiled delta-linked compute() left the incremental path")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    for name, row in rows.items():
        print(f"time {name}: {row['ms']:.3f} ms/launch at B={BATCH} (plain "
              f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms by "
              f"{row['bound_by']}, {row['ops']} operations, {row['bytes']} bytes); "
              f"launches per compute_whatif {per_whatif[name]}", flush=True)
    for name, row in rows1.items():
        dev_ms = f"{row['device_ms']:.4f} ms" if row["device_ms"] > 0 else "not measured"
        print(f"time {name}: {row['ms']:.4f} ms/launch at B=1 by CUDA events "
              f"(host launch included), {dev_ms} on the device "
              f"(profiler); plain {row['plain_ms']:.3f} ms, bound "
              f"{row['bound_ms']:.5f} ms by {row['bound_by']}; launches per compute "
              f"{per_compute[name]}", flush=True)
    print(f"time compute_whatif: {batch_ms:.3f} ms per {BATCH}-scenario batch "
          f"({BATCH / batch_ms * 1e3:.1f} scenario-SPFs/s; first call with "
          f"marshal {cold_ms:.1f} ms)", flush=True)
    print(f"time compute: {compute_ms:.3f} ms", flush=True)
    kernel1_ms = sum(per_compute[k] * rows1[k]["device_ms"] for k in rows1)
    print(f"breakdown compute: block kernels {kernel1_ms:.3f} ms on the device "
          f"(launches x device ms/launch at B=1); device busy {compute_busy_ms:.3f} ms "
          f"of {compute_ms:.3f} ms; top device ops: {compute_top}", flush=True)
    kernel_ms = sum(per_whatif[k] * rows[k]["ms"] for k in rows)
    print(f"breakdown compute_whatif: failed-edge scan {scan_ms:.3f} ms, "
          f"whatif_spf_blocked {spf_ms:.3f} ms (block kernels {kernel_ms:.3f} ms = "
          f"launches x ms/launch), readback and results "
          f"{batch_ms - scan_ms - spf_ms:.3f} ms", flush=True)
    if busy_ms > 0:
        print(f"profile whatif_spf_blocked: device busy {busy_ms:.3f} ms of "
              f"{spf_ms:.3f} ms wall (idle share {1 - busy_ms / spf_ms:.3f}); "
              f"top device ops: {top}", flush=True)
    else:
        print("profile whatif_spf_blocked: the profiler saw no device time; "
              "idle share not measured", flush=True)
    for name, row in erows.items():
        print(f"time {name}: {row['ms']:.3f} ms/launch at B={BATCH} (plain "
              f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms by "
              f"{row['bound_by']}, {row['ops']} operations, {row['bytes']} bytes); "
              f"launches per compute_whatif {g_whatif[name]}", flush=True)
    for name, row in erows1.items():
        dev_ms = f"{row['device_ms']:.4f} ms" if row["device_ms"] > 0 else "not measured"
        print(f"time {name}: {row['ms']:.4f} ms/launch at B=1 by CUDA events "
              f"(host launch included), {dev_ms} on the device "
              f"(profiler); plain {row['plain_ms']:.3f} ms, bound "
              f"{row['bound_ms']:.5f} ms by {row['bound_by']}; launches per compute "
              f"{g_compute[name]}", flush=True)
    for name, row in erowsr.items():
        print(f"time {name}: {row['ms']:.4f} ms/launch at {MULTIROOT} roots (plain "
              f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.5f} ms by "
              f"{row['bound_by']}); launches per compute_multiroot {g_multiroot[name]}",
              flush=True)
    fp, ns = erows["ell_first_parent"], erows["ell_nh_seed"]
    print(f"time ell_first_parent + hop0 pack + ell_nh_seed: "
          f"{fp['ms'] + hop0_ms + ns['ms']:.3f} ms per dispatch at B={BATCH} ({fp['ms']:.3f} "
          f"+ {hop0_ms:.4f} + {ns['ms']:.3f}; kernel bounds {fp['bound_ms']:.4f} + "
          f"{ns['bound_ms']:.4f} ms)", flush=True)
    print(f"time gather compute_whatif: {g_batch_ms:.3f} ms per {BATCH}-scenario batch "
          f"({BATCH / g_batch_ms * 1e3:.1f} scenario-SPFs/s; first call with marshal "
          f"{g_cold_ms:.1f} ms)", flush=True)
    print(f"time gather compute: {g_compute_ms:.3f} ms", flush=True)
    print(f"time gather compute_multiroot: {g_mr_ms:.3f} ms for {MULTIROOT} roots",
          flush=True)
    g_kernel1_ms = sum(g_compute[k] * erows1[k]["device_ms"] for k in erows1)
    print(f"breakdown gather compute: ELL kernels {g_kernel1_ms:.3f} ms on the device "
          f"(launches x device ms/launch at B=1); device busy {g_compute_busy_ms:.3f} ms "
          f"of {g_compute_ms:.3f} ms; top device ops: {g_compute_top}", flush=True)
    # The frontier kernels' launches differ round by round: their dispatch sums.
    g_kernel_ms = sum(frows[k]["dispatch_ms"] if k in frows else g_whatif[k] * erows[k]["ms"]
                      for k in erows)
    print(f"breakdown gather compute_whatif: mask upload and packing {g_pack_ms:.3f} ms, "
          f"fixpoint driver (spf_lanes) {g_spf_ms:.3f} ms (ELL kernels {g_kernel_ms:.3f} "
          f"ms = dispatch sums, launches x ms/launch), transpose, readback and results "
          f"{g_batch_ms - g_pack_ms - g_spf_ms:.3f} ms", flush=True)
    if g_busy_ms > 0:
        print(f"profile gather spf_lanes: device busy {g_busy_ms:.3f} ms of "
              f"{g_spf_ms:.3f} ms wall (idle share {1 - g_busy_ms / g_spf_ms:.3f}); "
              f"top device ops: {g_top}", flush=True)
    else:
        print("profile gather spf_lanes: the profiler saw no device time; "
              "idle share not measured", flush=True)
    for e, ((busy_ms, top), (c_busy_ms, c_top)) in j_busy.items():
        c_ms = jx["times"][e]["compute"][0]
        print(f"profile engine {e}: lane program at B={BATCH} {j_prog_ms[e]:.3f} ms host clock "
              f"(median of {BATCH_REPS}), device busy {busy_ms:.3f} ms (idle share "
              f"{1 - busy_ms / j_prog_ms[e]:.3f}); top device ops: {top}; compute() device busy "
              f"{c_busy_ms:.3f} ms of {c_ms:.3f} ms (phase 3j's median; idle share "
              f"{1 - c_busy_ms / c_ms:.3f}); top device ops: {c_top}", flush=True)
    kt_ = kx["times"]
    for kind in ("whatif", "compute", "multiroot"):
        print(f"time tropical {kind}: " + ", ".join(
            f"{e} {kt_[e][kind]:.3f} ms" for e in ("seq", "fused", "tropical"))
            + f" (host clock, medians of {TROP_WARM_REPS if kind != 'compute' else COMPUTE_REPS} "
            f"warm calls taken in turns: "
            + "; ".join(f"{e} {[round(t, 3) for t in kx['times_all'][e][kind]]}"
                        for e in ("seq", "fused", "tropical")) + f"); {smi}", flush=True)
    big, small = kx["hold"]["whatif"], kx["hold"]["compute"]
    k_c_launches = kx["launches"]["compute"][0]["trop_relax"]
    k_w_launches = kx["launches"]["whatif"][0]
    trow = {
        "ms": statistics.mean(big.launch_ms), "plain_ms": statistics.mean(big.plain_ms),
        "bound_ms": statistics.mean(w["bound"][0] for w in big.work),
        "bound_by": bound(sum(w["ops"] for w in big.work), sum(w["bytes"] for w in big.work))[1],
        "launch_ms": big.launch_ms, "launch_bound_ms": [w["bound"][0] for w in big.work],
        "dispatch_ms": sum(big.launch_ms), "dispatch_bound_ms": sum(w["bound"][0] for w in big.work),
        "bound_full_write_ms": statistics.mean(w["bound_full_write"][0] for w in big.work),
        "dispatch_bound_full_write_ms": sum(w["bound_full_write"][0] for w in big.work),
        "active_slots": [w["active_slots"] for w in big.work],
        "written_entries": [w["written_entries"] for w in big.work],
        "device_ms": k_t1_ms["trop_relax"] / k_w_launches["trop_relax"],
        "full_round_ms": kx["full_ms"], "full_round_bound_ms": kx["full_work"]["bound"][0],
        "full_round_bound_by": kx["full_work"]["bound"][1],
        "ms_b1": statistics.mean(small.launch_ms), "plain_ms_b1": statistics.mean(small.plain_ms),
        "bound_ms_b1": statistics.mean(w["bound"][0] for w in small.work),
        "device_ms_b1": k_t1_b1 / k_c_launches, "launches_b1": k_c_launches,
        "repair_set_ms": kx["repair_ms"], "repair_list_ms": kx["repair_list_ms"],
        "repair_rows_host_ms": kx["repair_host_ms"], "launch1_split": kx["launch1"],
        "geometry": kx["geometry"],
        "max_abs_err": max(kx["full_err"], *(h.err for h in kx["hold"].values())),
    }
    rwork = [w for w in big.work if w["repair_pairs"]]
    rrow = {
        "ms": k_t1_ms["trop_repair"] / k_w_launches["trop_repair"],
        "plain_ms": kx["repair_plain_ms"],
        "bound_ms": statistics.mean(w["repair_bound"][0] for w in rwork),
        "bound_by": bound(sum(w["repair_ops"] for w in rwork),
                          sum(w["repair_bytes"] for w in rwork))[1],
        "pairs": rwork[0]["repair_pairs"],
        "max_abs_err": max(h.repair_err for h in kx["hold"].values()),
    }
    print(f"time trop_relax: {trow['ms']:.4f} ms a launch at B={BATCH} (mean of "
          f"{len(big.launch_ms)}, CUDA events: {[round(t, 4) for t in big.launch_ms]}), bound "
          f"{trow['bound_ms']:.4f} ms a launch by {trow['bound_by']} "
          f"({[round(b, 4) for b in trow['launch_bound_ms']]}; active slots "
          f"{trow['active_slots']}), plain {trow['plain_ms']:.3f} ms; full round (every block "
          f"active) {kx['full_ms']:.4f} ms, bound {trow['full_round_bound_ms']:.4f} ms by "
          f"{trow['full_round_bound_by']} ({kx['full_work']['ops']} operations, "
          f"{kx['full_work']['bytes']} bytes); on the device {trow['device_ms']:.4f} ms a "
          f"launch (the lane program's tile passes); before the copy rule the floor was "
          f"{trow['bound_full_write_ms']:.4f} ms a launch, "
          f"{trow['dispatch_bound_full_write_ms']:.4f} a dispatch (entries written "
          f"{trow['written_entries']}); at B=1 {trow['ms_b1']:.4f} ms a launch (host "
          f"launch included, {k_c_launches} launches a compute()), {trow['device_ms_b1']:.4f} ms "
          f"on the device, bound {trow['bound_ms_b1']:.6f} ms, plain {trow['plain_ms_b1']:.3f} "
          f"ms; max_abs_err {trow['max_abs_err']}; {smi}", flush=True)
    print("time trop_relax launch 1 at B=" + str(BATCH) + ": " + "; ".join(
        f"{label} {v['ms']:.4f} ms (CUDA events, median of {KERNEL_REPS}), "
        + (f"{v['device_ms']:.4f} ms on the device" if v["device_ms"] > 0
           else "device time not measured") + f", bound {v['bound_ms']:.5f} ms"
        for label, v in kx["launch1"].items()) + f"; {smi}", flush=True)
    print(f"time trop_repair: {rrow['ms']:.4f} ms a launch on the device at B={BATCH} "
          f"({k_w_launches['trop_repair']} launches a dispatch, {rrow['pairs']} pairs, a warp "
          f"each), bound {rrow['bound_ms']:.5f} ms by {rrow['bound_by']}, plain "
          f"{rrow['plain_ms']:.3f} ms; max_abs_err {rrow['max_abs_err']}; {smi}", flush=True)
    print(f"time tropical repair set: built on the card from the mask words "
          f"{kx['repair_ms']:.4f} ms, listed {kx['repair_list_ms']:.4f} ms (host clock, one sync; "
          f"{kx['repair_rows'][0]} (row, lane) pairs), repair_rows_host "
          f"on the host {kx['repair_host_ms']:.1f} ms ({kx['repair_rows'][1]} rows); tile "
          f"marshal {kx['marshal_ms']:.1f} ms (host); {smi}", flush=True)
    if k_busy_ms > 0:
        k_c_ms = kt_["tropical"]["compute"]
        print(f"profile tropical: lane program at B={BATCH} {k_prog_ms:.3f} ms host clock "
              f"(median of {BATCH_REPS}), device busy {k_busy_ms:.3f} ms (idle share "
              f"{1 - k_busy_ms / k_prog_ms:.3f}); top device ops: {k_top}; compute() device busy "
              f"{k_c_busy_ms:.3f} ms of {k_c_ms:.3f} ms (phase 3k's median; idle share "
              f"{1 - k_c_busy_ms / k_c_ms:.3f}); top device ops: {k_c_top}", flush=True)
    else:
        print("profile tropical: the profiler saw no device time; idle share not measured",
              flush=True)
    print(f"tropical share of the script: phase 3k {kx['phase_s']:.1f} s + its phase-4 "
          f"timings and profiles {k_phase4_s:.1f} s", flush=True)
    lt = lx["times"]
    for k in MP_KS:
        print(f"time mp_tropical compute(multipath_k={k}): mp {lt['mp'][k]:.3f} ms, mp_tropical "
              f"{lt['mp_tropical'][k]:.3f} ms (host clock, medians of {COMPUTE_REPS} warm calls "
              f"taken in turns: " + "; ".join(f"{e} {[round(t, 3) for t in lx['times_all'][e][k]]}"
                                              for e in ("mp", "mp_tropical")) + f"); {smi}",
              flush=True)
    l_hold = lx["hold"][f"compute k={MP_K}"]
    l_launches = lx["launches"][f"compute k={MP_K}"][0]["trop_count"]
    for lanes, v in sorted(lx["t2"].items()):
        w = v["work"]
        print(f"time trop_count at {lanes} lanes: {v['ms']:.4f} ms a launch (CUDA events, median "
              f"of {KERNEL_REPS}), " + (f"{v['device_ms']:.4f} ms on the device" if v["device_ms"]
                                       else "device time not measured")
              + f", floor {w['bound'][0]:.5f} ms by {w['bound'][1]} ({w['ops']} operations, "
              f"{w['bytes']} bytes; {w['nnz']} nonzero counts in {w['listed_slots']} listed of "
              f"{w['real_slots']} real tiles), the floor over every real tile's counts "
              f"{w['tile_bound'][0]:.5f} ms by {w['tile_bound'][1]} ({w['tile_bytes']} bytes), "
              f"plain {v['plain_ms']:.3f} ms, float64 einsum {v['library_ms']:.4f} ms; {smi}",
              flush=True)
        print(f"time trop_count count list at {lanes} lanes: {v['list_ms']:.4f} ms a build (one "
              f"a fixpoint; CUDA events, median of {KERNEL_REPS}), "
              + (f"{v['list_device_ms']:.4f} ms on the device" if v["list_device_ms"]
                 else "device time not measured") + f"; geometry {v['geometry']}; {smi}",
              flush=True)
    print(f"time trop_count a dispatch: compute(multipath_k={MP_K}) launches {l_launches} "
          f"(by lanes {dict(Counter(l_hold.lanes))}), held launches "
          f"{[round(t, 4) for t in l_hold.launch_ms]} ms by events, "
          f"{l_t2_dispatch:.4f} ms on the device in all; {smi}", flush=True)
    for e, (busy_ms, top) in l_busy.items():
        c_ms = lt[e][MP_K]
        print(f"profile mp_tropical: {e} compute(multipath_k={MP_K}) device busy "
              + (f"{busy_ms:.3f} ms of {c_ms:.3f} ms (phase 3l's median; idle share "
                 f"{1 - busy_ms / c_ms:.3f}); top device ops: {top}" if busy_ms > 0
                 else "not measured (the profiler saw no device time)"), flush=True)
    print(f"mp_tropical share of the script: phase 3l {lx['phase_s']:.1f} s + its phase-4 "
          f"profiles {l_phase4_s:.1f} s", flush=True)
    print(f"engines' share of the script: phase 3j {jx['phase_s']:.1f} s + its phase-4 "
          f"timings and profiles {j_phase4_s:.1f} s = {jx['phase_s'] + j_phase4_s:.1f} s",
          flush=True)
    print(f"time gather compute delta: {d_delta_ms:.3f} ms (median of {DELTA_TOGGLES} "
          f"delta-linked compute() calls toggling one link's cost; "
          f"{[round(t, 3) for t in delta_times]})", flush=True)
    phase = {key: statistics.median(st[key] for st in toggle_stats)
             for key in ("affected", "affected_ms", "relax", "relax_ms", "hops_nh", "hops_nh_ms",
                         "affected_rows")}
    print(f"breakdown gather compute delta phases (medians over the toggles): affected set "
          f"{phase['affected_rows']} rows, {phase['affected']} rounds, "
          f"{phase['affected_ms']:.3f} ms; relax {phase['relax']} rounds, "
          f"{phase['relax_ms']:.3f} ms; parent + hops/next hops {phase['hops_nh']} rounds, "
          f"{phase['hops_nh_ms']:.3f} ms (host clock, each phase ends on a host sync)",
          flush=True)
    print(f"time gather compute remarshal: {d_remarshal_ms:.3f} ms (median of "
          f"{REMARSHAL_REPS} compute() calls of fresh clones: build_ell, upload, full SPF; "
          f"{[round(t, 3) for t in remarshal_times]})", flush=True)
    print(f"time gather compute cached: {d_cached_ms:.3f} ms (the last clone again, "
          f"median of {COMPUTE_REPS})", flush=True)
    print(f"breakdown gather compute delta: lower_delta + slot scatter "
          f"{statistics.median(lower_ms):.3f} ms (host clock, median of {DELTA_TOGGLES}), "
          f"spf_one_incremental {statistics.median(incr_ms):.3f} ms host clock / "
          f"{statistics.median(incr_ev_ms):.3f} ms between CUDA events; device busy "
          f"{incr_busy_ms:.3f} ms in one spf_one_incremental, {d_busy_ms:.3f} ms in one "
          f"delta-linked compute(); top device ops: {incr_top}", flush=True)
    for name, row in m_rows.items():
        dev_b1 = (f"{row['device_ms_b1']:.4f} ms" if row["device_ms_b1"] > 0
                  else "not measured")
        print(f"time {name}: {row['ms']:.3f} ms/launch at B={BATCH} (plain "
              f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms by "
              f"{row['bound_by']}, {row['ops']} operations, {row['bytes']} bytes); "
              f"{row['ms_b1']:.4f} ms/launch at B=1 by CUDA events, {dev_b1} on the device "
              f"(profiler), bound {row['bound_ms_b1']:.5f} ms by {row['bound_by_b1']}; "
              f"launches per multipath compute_whatif {m_whatif[name]}, per "
              f"{len(MP_KS)} compute() calls {m_compute[name]}, on the delta chain "
              f"{m_chain[name]}", flush=True)
    m1, m2, m3 = (m_rows[k] for k in MP_REPLACES)
    print(f"time ell_mp_round dispatch: {m1['dispatch_ms']:.3f} ms over {len(m1['launch_ms'])} "
          f"launches at B={BATCH} (frontier bound {m1['dispatch_bound_ms']:.4f} ms, a full "
          f"round's bound {m1['full_round_bound_ms']:.4f} ms); at B=1 "
          f"{m1['device_dispatch_ms_b1']:.4f} ms on the device over {m1_b1_launches} launches "
          f"of one multipath compute()", flush=True)
    print(f"time ell_parent_sets + ell_parent_weights: {m2['ms'] + m3['ms']:.3f} ms at "
          f"B={BATCH} kp={MP_K} ({m2['ms']:.3f} + {m3['ms']:.4f}; bounds "
          f"{m2['bound_ms']:.4f} + {m3['bound_ms']:.4f} ms; torch.gather "
          f"{m3['library_ms']:.4f} ms)", flush=True)
    m_kernel_ms = (m_rows["ell_mp_round"]["dispatch_ms"]
                   + m_whatif["ell_parent_sets"] * m_rows["ell_parent_sets"]["ms"]
                   + m_whatif["ell_parent_weights"] * m_rows["ell_parent_weights"]["ms"])
    print(f"time multipath compute: {m_compute_ms:.3f} ms at multipath_k={MP_K}, "
          f"{m_compute8_ms:.3f} ms at 8 (single-path gather compute {g_compute_ms:.3f} ms); "
          f"device busy {m_compute_busy_ms:.3f} ms; top device ops: {m_compute_top}",
          flush=True)
    print(f"time multipath compute_whatif: {m_batch_ms:.3f} ms per {BATCH}-scenario batch at "
          f"multipath_k={MP_K} ({BATCH / m_batch_ms * 1e3:.1f} scenario-SPFs/s; single-path "
          f"gather batch {g_batch_ms:.3f} ms)", flush=True)
    print(f"breakdown multipath compute_whatif: program (mp_lanes) {m_lanes_ms:.3f} ms (multipath "
          f"kernels {m_kernel_ms:.3f} ms = the M1 dispatch + launches x ms/launch; device "
          f"busy {m_busy_ms:.3f} ms, "
          f"idle share {1 - m_busy_ms / m_lanes_ms:.3f}), mask packing, transposes, readback "
          f"and results {m_batch_ms - m_lanes_ms:.3f} ms; top device ops: {m_top}", flush=True)
    m_phase = {key: statistics.median(st[key] for st in m_toggle_stats)
               for key in ("affected", "relax", "hops_nh", "hops_nh_ms")}
    print(f"time multipath compute delta: {m_delta_ms:.3f} ms (median of {DELTA_TOGGLES} "
          f"delta-linked compute(multipath_k={MP_K}) calls toggling one link's cost; "
          f"{[round(t, 3) for t in m_delta_times]}; single-path {d_delta_ms:.3f} ms); phase "
          f"medians: affected {m_phase['affected']} rounds, relax {m_phase['relax']} rounds, "
          f"first parent + joint fixpoint ({m_phase['hops_nh']} rounds) + parent sets "
          f"{m_phase['hops_nh_ms']:.3f} ms", flush=True)
    st, cst = fx["stages"], fx["cold_stats"]
    print(f"time FRR compute: {fx['warm_ms']:.3f} ms warm (median of {FRR_WARM_REPS}: "
          f"{[round(t, 3) for t in fx['warm_all_ms']]}), {fx['cold_ms']:.3f} ms cold (graph "
          f"marshal included); device busy {frr_busy_ms:.3f} ms (idle share "
          f"{1 - frr_busy_ms / fx['warm_ms']:.3f}); peak device memory {fx['peak_mb']:.1f} MiB "
          f"above the resident; top device ops: {frr_top}", flush=True)
    print(f"breakdown FRR compute (medians of {FRR_WARM_REPS} warm, host clock, each stage "
          f"ended by a sync): marshal_frr {st['marshal_ms']:.3f} ms, D {st['d_ms']:.3f} ms "
          f"({st['d_launches']} ell_relax launches at B={topo.n_vertices}), post batch "
          f"{st['post_ms']:.3f} ms, LFA + remote LFA {st['lfa_rlfa_ms']:.3f} ms, TI-LFA "
          f"{st['tilfa_ms']:.3f} ms ({st['tilfa_rounds']} rounds), readback "
          f"{st['readback_ms']:.3f} ms; cold: " + ", ".join(
              f"{k} {cst[k]:.3f}" for k in FRR_STAGES), flush=True)
    print(f"time FRR selection (frr_select on the card's D and post planes: LFA, remote LFA, "
          f"TI-LFA): {sel_ms:.3f} ms host clock (median of {FRR_WARM_REPS}), device busy "
          f"{sel_busy_ms:.3f} ms (idle share {1 - sel_busy_ms / sel_ms:.3f}); top device ops: "
          f"{sel_top}", flush=True)
    del fx["select"]
    dmb = fx["d_main_bound"]
    print(f"time FRR D: {fx['d_ms']:.3f} ms by CUDA events (median of {FRR_WARM_REPS}), "
          f"{fx['d_rounds']} ell_relax launches at B={topo.n_vertices}; launch {fx['d_main']} "
          f"(largest frontier) {fx['d_main_ms']:.3f} ms, bound {dmb[0]:.4f} ms by {dmb[1]} "
          f"({dmb[2]} operations, {dmb[3]} bytes)", flush=True)
    print(f"time CSPF batch: {cx['batch_ms']:.3f} ms per {CSPF_BATCH}-request batch "
          f"({cx['requests_per_sec']:.1f} requests/s; median of {CSPF_WARM_REPS}: "
          f"{[round(t, 3) for t in cx['warm_all_ms']]}), first batch {cx['cold_ms']:.3f} ms, "
          f"engine marshal {cx['marshal_ms']:.3f} ms; device busy {cspf_busy_ms:.3f} ms (idle "
          f"share {1 - cspf_busy_ms / cx['batch_ms']:.3f}); top device ops: {cspf_top}",
          flush=True)
    for arm, r in px["arms"].items():
        busy_ms, busy_top = part_busy[arm]
        ph, st = r["phases"], r["stats"]
        print(f"time partitioned compute {arm} (100k): {r['warm_ms']:.3f} ms warm (median of "
              f"{PART_WARM_REPS}: {[round(t, 3) for t in r['warm_all_ms']]}), first call "
              f"{r['cold_ms']:.3f} ms (plan and marshal included); phases (medians, host "
              f"clock, each ended by a sync): boundary solve {ph['bdist_ms']:.3f} ms "
              f"({r['rounds']['bdist']} rounds at {st['boundary-lanes']} lanes), stitch "
              f"{ph['stitch_ms']:.3f} ms, final solve {ph['dist_ms']:.3f} ms "
              f"({r['rounds']['dist']} rounds), exchange {ph['exchange_ms']:.3f} ms "
              f"({r['rounds']['exchange']} iterations of {r['rounds']['exchange_inner']} M1 "
              f"rounds), assemble {ph['assemble_ms']:.3f} ms; device busy {busy_ms:.3f} ms "
              f"(idle share {1 - busy_ms / r['warm_ms']:.3f}); peak device memory "
              f"{r['peak_mb']:.1f} MiB above the resident; top device ops: {busy_top}",
              flush=True)
    print(f"time monolithic compute (100k): {px['mono_ms']:.3f} ms warm (median of "
          f"{PART_WARM_REPS}), first call {px['mono_cold_ms']:.3f} ms (marshal included); "
          f"launches {px['mono_launches']}; device busy {mono100_busy_ms:.3f} ms (idle share "
          f"{1 - mono100_busy_ms / px['mono_ms']:.3f}); top device ops: {mono100_top}",
          flush=True)
    pb = px["bdist_main_bound"]
    print(f"time partitioned boundary solve (flat): {px['bdist_ms']:.3f} ms by CUDA events, "
          f"{px['bdist_launches']} ell_relax launches at {px['bdist_lanes']} lanes; launch "
          f"{px['bdist_main']} (largest frontier) {px['bdist_main_ms']:.4f} ms, bound "
          f"{pb[0]:.4f} ms by {pb[1]} ({pb[2]} operations, {pb[3]} bytes)", flush=True)
    entries = [
        (name, SOURCE, REPLACES[name], launched[name], row, (rows1[name],))
        for name, row in rows.items()
    ] + [
        (name, ELL_SOURCE, ELL_REPLACES[name], g_launched[name], row,
         (erows1[name], erowsr[name]))
        for name, row in erows.items()
    ]
    kernel_rows = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": count,
         "max_abs_err": max(row["max_abs_err"], *(r["max_abs_err"] for r in others)),
         "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": None}
        for name, source, replaces, count, row, others in entries
    ]
    for krow in kernel_rows:
        if krow["name"] in frows:  # the frontier kernels: a whole dispatch, a full round
            krow["dispatch_ms"] = frows[krow["name"]]["dispatch_ms"]
            krow["full_round_ms"] = frows[krow["name"]]["full_round_ms"]
        if krow["name"] in d_launched:  # launches on the DeltaPath chain
            krow["delta_chain_launches"] = d_launched[krow["name"]]
        if krow["name"] in fx["held_err"]:  # the cold FRR compute's, each held
            krow["frr_launches"] = fx["launches"][krow["name"]]
            krow["max_abs_err"] = max(krow["max_abs_err"], fx["held_err"][krow["name"]])
        if krow["name"] == "ell_relax":  # the all-roots D dispatch, B = N lanes
            krow.update(frr_d_launches=fx["d_rounds"], frr_d_ms=fx["d_ms"],
                        frr_d_main_launch_ms=fx["d_main_ms"],
                        frr_d_main_launch_bound_ms=dmb[0])
        if krow["name"] in cx["held_err"]:  # the cold CSPF batch's, each held
            krow["cspf_launches"] = cx["launches"][krow["name"]]
            krow["max_abs_err"] = max(krow["max_abs_err"], cx["held_err"][krow["name"]])
        if krow["name"] in px["held_err"]:  # the cold partitioned computes' (hinted + flat)
            krow["partitioned_launches"] = sum(r["launches"][krow["name"]]
                                               for r in px["arms"].values())
            krow["max_abs_err"] = max(krow["max_abs_err"], px["held_err"][krow["name"]],
                                      px["mp_err"].get(krow["name"], 0))
        if krow["name"] == "ell_relax":  # the flat boundary solve's largest launch
            krow.update(partitioned_bdist_launches=px["bdist_launches"],
                        partitioned_bdist_lanes=px["bdist_lanes"],
                        partitioned_bdist_main_launch_ms=px["bdist_main_ms"],
                        partitioned_bdist_main_launch_bound_ms=pb[0])
    for name, row in m_rows.items():
        kernel_rows.append({
            "name": name, "route": "cuda", "source": MP_SOURCE, "replaces": MP_REPLACES[name],
            "launches": m_launched[name],
            "max_abs_err": max(row["max_abs_err"], px["mp_err"][name],
                               px["held_err"].get(name, 0)),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row.get("library_ms"),
            "ms_b1": row["ms_b1"],
            "launches_whatif": m_whatif[name], "launches_compute": m_compute[name],
            "delta_chain_launches": m_chain[name],
            "single_path_chain_launches": d_launched[name],
            "partitioned_launches": sum(r["launches"][name] for r in px["arms"].values()),
            "partitioned_mp_launches": px["mp_launches"][name],
            **{key: row[key] for key in (
                "dispatch_ms", "dispatch_bound_ms", "launch_ms", "launch_bound_ms",
                "recomputed_entries", "copied_entries", "full_round_bound_ms",
                "device_ms_b1") if key in row},
        })
    ub = bx["update_bound"]
    kernel_rows.append({
        "name": "bgp_fold", "route": "cuda", "source": BGP_SOURCE, "replaces": BGP_REPLACES,
        "launches": bx["launches"], "max_abs_err": max(bx["max_abs_err"], bx["update_err"], bx["engine_err"]),
        "ms": bx["ms"], "plain_ms": bx["plain_ms"], "bound_ms": bx["bound"][0],
        "bound_by": bx["bound"][1], "library_ms": None, "device_ms": bx["device_ms"],
        "geometry": bx["geometry"],
        "prefixes_per_s": bx["prefixes_per_s"], "readback_ms": bx["readback_ms"],
        "ms_update": bx["update_ms"], "plain_ms_update": bx["update_plain_ms"],
        "bound_ms_update": ub[0], "device_ms_update": bx["update_device_ms"],
        "update_round_p99_ms": bx["update_p99_ms"],
    })
    jr = jx["row"]
    kernel_rows.append({
        "name": "ell_fused_round", "route": "cuda", "source": FUSED_SOURCE,
        "replaces": FUSED_REPLACES, "launches": jx["fused_launches"],
        "max_abs_err": max(jr["planar"]["max_abs_err"], jr["interleaved"]["max_abs_err"]),
        "ms": jr["planar"]["ms"], "plain_ms": jr["planar"]["plain_ms"],
        "bound_ms": jr["planar"]["bound_ms"], "bound_by": jr["planar"]["bound_by"],
        "library_ms": None, "launches_planar": jx["layouts"]["fused"],
        "launches_interleaved": jx["layouts"]["packed"],
        **{f"{key}_interleaved": jr["interleaved"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "ms_b1", "plain_ms_b1", "bound_ms_b1",
            "dispatch_ms", "dispatch_bound_ms", "full_round_bound_ms", "device_ms_b1",
            "recomputed_entries", "copied_entries", "form", "tiles", "registers", "form_b1",
            "registers_b1", "vec4_b1")},
        **{key: jr["planar"][key] for key in (
            "ms_b1", "plain_ms_b1", "bound_ms_b1", "dispatch_ms", "launch_ms", "launch_bound_ms",
            "dispatch_bound_ms", "full_round_bound_ms", "full_round_bound_ms_b1", "device_ms_b1",
            "recomputed_entries", "copied_entries", "form", "tiles", "registers", "form_b1",
            "registers_b1")},
        "engine_ms": jx["times"],
    })
    kernel_rows.append({
        "name": "trop_relax", "route": "cuda", "source": TROP_SOURCE, "replaces": TROP_REPLACES,
        "launches": sum(c["trop_relax"] for runs in kx["launches"].values() for c in runs),
        "library_ms": None,
        **{key: trow[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "launch_ms",
            "launch_bound_ms", "dispatch_ms", "dispatch_bound_ms", "bound_full_write_ms",
            "dispatch_bound_full_write_ms", "written_entries", "device_ms", "full_round_ms",
            "full_round_bound_ms", "ms_b1", "plain_ms_b1", "bound_ms_b1", "device_ms_b1",
            "repair_set_ms", "repair_list_ms", "repair_rows_host_ms", "launch1_split",
            "geometry")},
        "launches_by_path": {k: [c["trop_relax"] for c in runs]
                             for k, runs in kx["launches"].items()},
        "tiles": kx["meta"], "tile_deltas": kx["tile_deltas"], "engine_ms": kx["times"],
    })
    kernel_rows.append({
        "name": "trop_repair", "route": "cuda", "source": TROP_SOURCE,
        "replaces": TROP_REPAIR_REPLACES,
        "launches": sum(c["trop_repair"] for runs in kx["launches"].values() for c in runs),
        "library_ms": None, **rrow,
        "launches_by_path": {k: [c["trop_repair"] for c in runs]
                             for k, runs in kx["launches"].items()},
    })
    t2 = lx["t2"]
    a_lanes = max(t2)
    kernel_rows.append({
        "name": "trop_count", "route": "cuda", "source": TROP_SOURCE,
        "replaces": TROP_COUNT_REPLACES,
        "launches": sum(c["trop_count"] for runs in lx["launches"].values() for c in runs),
        "max_abs_err": max(*(h.err for h in lx["hold"].values()), *(v["err"] for v in t2.values())),
        "ms": t2[a_lanes]["ms"], "plain_ms": t2[a_lanes]["plain_ms"],
        "bound_ms": t2[a_lanes]["work"]["bound"][0], "bound_by": t2[a_lanes]["work"]["bound"][1],
        "library_ms": t2[a_lanes]["library_ms"], "lanes": a_lanes,
        "device_ms": t2[a_lanes]["device_ms"],
        "ms_a1": t2[1]["ms"], "plain_ms_a1": t2[1]["plain_ms"],
        "bound_ms_a1": t2[1]["work"]["bound"][0], "bound_by_a1": t2[1]["work"]["bound"][1],
        "library_ms_a1": t2[1]["library_ms"], "device_ms_a1": t2[1]["device_ms"],
        "bound_ms_tiles": t2[a_lanes]["work"]["tile_bound"][0],
        "bound_by_tiles": t2[a_lanes]["work"]["tile_bound"][1],
        "bound_ms_tiles_a1": t2[1]["work"]["tile_bound"][0],
        "bound_by_tiles_a1": t2[1]["work"]["tile_bound"][1],
        "list_ms": t2[a_lanes]["list_ms"], "list_device_ms": t2[a_lanes]["list_device_ms"],
        "list_ms_a1": t2[1]["list_ms"], "list_device_ms_a1": t2[1]["list_device_ms"],
        "geometry": t2[a_lanes]["geometry"], "geometry_a1": t2[1]["geometry"],
        "launches_by_path": {k: [c["trop_count"] for c in runs]
                             for k, runs in lx["launches"].items()},
        "dispatch_launches": l_launches, "dispatch_device_ms": l_t2_dispatch,
        "dispatch_launch_ms": l_hold.launch_ms, "dispatch_lanes": l_hold.lanes,
        "engine_ms": lt, "tuner": {e: v["median_ms"] for e, v in lx["tuner_row"]["engines"].items()},
        "tuner_winner": lx["tuner_row"]["winner"], "tile_deltas": lx["tile_deltas"],
    })
    # -- 3o. the telemetry and the runtime checks: armed against disarmed,
    # the overhead, the sanitizer, the residency ledger, the donation guard
    # and a trace (after phase 4's timings: it arms and runs the profiler)
    tel = telemetry_phase(dev, topo, masks, gres, gone, gmr, mr_roots, m_one,
                          oracle_result(oracle[1], n_atoms), chain, d_steps)
    # -- 3p. the dispatch analytics over the same twelve paths: armed against
    # disarmed, the observatory's keys and roofline rows, the critical path,
    # the watchdog's budgets, the overhead, the SLO report and the ring
    analytics_phase(tel["paths"], topo, masks)
    # -- 3q. the kernel-contract audit on the card: every registered program
    # under the recorder and the sanitizer, the main-path seams at k=90, and
    # the CPU's audit of the same registry
    audit_phase(dev, topo, masks, chain, n_atoms)

    # (e) every dispatch of the run ran on the card: every breaker the run
    # built (every SPF backend, FRR engine and BGP table and rank backend)
    # counted no failure, fallback or refusal.
    from holo_tpu_torch.resilience import breakers, tallies

    require(not tallies(), f"breaker failures, fallbacks or refusals in the run: {tallies()}")
    live = breakers()
    require(all(not any(b.snapshot()[k] for k in ("failures", "fallbacks", "refusals"))
                for b in live.values()), "a live breaker counted a failure")
    print(f"breakers: {len(live)} live, no failure, fallback or refusal in the run",
          flush=True)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(smi, flush=True)
    print(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
