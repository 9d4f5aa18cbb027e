"""The port's CUDA kernels on the card (skipped where there is no GPU).

This file imports only the port, torch and numpy, so it runs on a machine
without JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Each kernel is held bit-identical to its plain PyTorch version on real
mid-fixpoint inputs at lane counts on both sides of the edge-walk kernels'
per-row/tile switch (8) and across their 32- and 64-lane tiles, on a fat
tree, whose uniform degree the edge walk sees in every column, on a block
pair with more edges than the kernels stage in shared memory, where many
parents tie on distance, and where a block has no in-edges; dmin_parent's
parent output is held against the plain parent fed the plain, uncorrected
dmin.  The backend is held to the scalar oracle with every kernel
launched.

The gather engine's kernels (kernels/ell.py) are held bit-identical to their
plain versions on real mid-fixpoint inputs at 1, 8, 33 and 1024 lanes
(scenario masks) and at 64 roots (no mask), on a k=8 fat tree and on a
graph whose K (40) is not a multiple of 32; ell_first_parent (parent and
DAG bits) and ell_nh_seed (seed and inherit bits) also at 1, 5, 33, 64 and
1024 lanes with lanes reached only at their root, at K up to 136, and on a
graph with hops-0 networks and a row of only padding slots; ell_relax and
ell_nh_round in
every round of a real dispatch, with its frontier and with an all-ones one,
at 1, 8, 33, 257 and 1024 lanes with and without masks, also on a graph
whose K (136) spans five 32-slot chunks; the card driver is held to the CPU
path under max_iters truncation; the gather backend to the oracle.

Multipath: ell_mp_round (with the count and weight planes and without them)
is held bit-identical to its plain version (same frontier, same out buffer)
and to the plain full round on every launch of a real multipath dispatch,
also under an all-ones frontier, and the fused ell_parent_sets to its plain
version and to ell_first_parent's and the parent sets' plain versions, and
ell_parent_weights to its plain version and the parent sets' pweight, for
kp 2, 4 and 8, at 1, 5, 8, 33 and 64 lanes (row and tile forms) on a k=8 fat tree, K 40 and 136, the hops-0
networks graph (also with four next-hop words), the saturating ladder and a
graph with parallel links; the backend's multipath compute, what-if and a
delta chain at multipath_k=4 are held to the CPU path and the oracle.

DeltaPath: a delta chain on a k=24 fat tree (cost changes, link removals and
restorations, an overload strike) is held to the CPU path step by step,
with ell_relax and ell_first_parent launched; apply_delta_slots writes CUDA
planes in place equal to the CPU planes; an entry whose edge ids went stale
rebuilds for a what-if batch and for a masked compute on the card.

Fast reroute: the all-roots matrix (ell_relax at one lane per vertex, 250
lanes, also truncated at max_iters 1-2) and FrrEngine("torch")'s tables on a
LAN topology, with the policies off and on, are held to the CPU path and the
oracle; graft_entry.entry() on the card equals its CPU run.

Partitioned SPF and CSPF: a partition-armed backend on a 6-area LSDB, with
its hint and with a flat cut, at multipath_k 1 and 4, under max_iters 2, and
through a delta chain across gateway links, is held to the CPU path (its
dispositions too) and the oracle; CspfEngine's batch on a k=12 fat tree is
held to the CPU path.

The tropical engine: trop_relax (T1, the tile pass and the repair pass) is
held bit-identical to its plain version on every launch of a real tile
relax, out snapshotted before the launch and equal to dist outside the
input frontier (and its full round, an all-ones frontier into a noise
buffer, to the same distances) at tile sizes 8 to 128, at 1, 5, 8, 9, 33,
64, 65, 127, 129, 255 and 257 lanes (row and tile forms, across the tile
form's lanes a warp and a block), with and without masks (the repair rows
built on the card); the launch geometry is the tile shape (5,064 blocks at
k=90's 1024 lanes); explicit repair rows equal the card-built set; the backend's compute (masked too), compute_whatif, compute_multiroot
and a delta chain (tiles updated in place) equal the CPU path.  Its
multipath program: trop_count_round (T2) is held bit-identical to its plain
version on every launch of a masked kp = 4 dispatch at tile sizes 8 to 128
(one lane for the path counts, 32 W for the weights) and on seeded carries
near MP_SAT at 1 to 257 lanes (row and lane forms) and tile sizes 8 to 128,
with and without a seed plane and a root row, counts up to 9, an empty row
block and a padding slot of junk counts (its count list held to the CPU's
on every launch; a malformed list refused); the backend's mp_tropical compute (kp 2, 4, 8, masked,
max_iters 1 and 2) and a kp = 4 delta chain equal the CPU path.

The fused, packed and hybrid engines: ell_fused_round in both layouts
(planar and interleaved, with W = 2, and with W = 7, two chunks of
next-hop words) is held bit-identical to fused_round_plain on every
launch of a real fused dispatch (each launch's state, frontier and carried
parent as it ran, the first spare buffer noise), in the state, the parent,
the changed flag and the frontier, at 1, 8, 9, 64 and 1024 lanes (row and
tile forms) on the fat tree, K 40 and 136 and the hops-0 networks graph;
each engine's compute and compute_whatif on the card equal the CPU path, also
under max_iters 0, 2 and 5, and an armed tuner's picks equal seq.

BGP table: bgp_fold is held bit-identical to its plain version on the same
CUDA tensors and to the CPU path at (M, C) from (1, 2) to (20,000, 64): C =
32 and 64 (TMA bulk copies) and C = 2 and 17 (cp.async), C = 1024 (one row a
tile), more tiles than resident blocks (every slot of the ring reused), an
M that is not a multiple of the tile rows, padded idx, idx with repeated
rows, unassigned columns and a MED-cycle row; the kernel's shared-memory
layout equals the wrapper's geometry; TorchBgpTableBackend() on the card decides chip_smoke's feed
(2,048 prefixes x 8 peers) equal to the oracle cold, after an UPDATE burst
and after NHT churn.
"""

import numpy as np
import pytest
import torch

from holo_tpu_torch.kernels import blocked as kernels
from holo_tpu_torch.kernels import ell
from holo_tpu_torch.ops import blocked as blk
from holo_tpu_torch.ops import blocked_spf as bspf
from holo_tpu_torch.ops import graph
from holo_tpu_torch.ops import spf_engine as se
from holo_tpu_torch.ops.graph import Topology, build_ell
from holo_tpu_torch.spf import synth
from holo_tpu_torch.spf.backend import ScalarSpfBackend, TorchSpfBackend

pytestmark = pytest.mark.cuda
INF = 1 << 30


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(batch, dev, topo=None, permute="auto"):
    if topo is None:
        topo = synth.random_ospf_topology(
            n_routers=560, n_networks=60, extra_p2p=900, seed=batch
        )
    masks = synth.whatif_link_failure_masks(topo, batch, seed=batch + 1)
    g = bspf.marshal_block_spf(topo, permute=permute, device=dev)
    fdst, fid = bspf.failed_edges_perm(g.orig2perm.cpu().numpy(), topo, masks, device=dev)
    npad = g.in_src.shape[0]
    x = {"dist_mid": blk.distance_fixpoint(g, g.rootp, fdst, fid, limit=2)}
    x["dist"] = blk.distance_fixpoint(g, g.rootp, fdst, fid, limit=npad)
    x["dmin"], parent_o = bspf.first_parent(g, x["dist"], fdst, fid)
    hops = bspf.hops_fixpoint(g, parent_o, npad)
    x["gate"] = (hops > 0).to(torch.int32)
    x["direct"] = bspf.direct_words(g, x["dist"], hops, fid)
    x["nh"] = bspf.nexthop_fixpoint(g, x["dist"], hops, x["direct"], fdst, fid, limit=1)
    return g, x


def _assert_kernels_match(g, x):
    pl = (g.w, g.bsrc, g.bdst)
    edges = blk.edges_of(g)
    # dmin_parent is K3 and K4 fed K3's output: the uncorrected dmin, not
    # the corrected x["dmin"] that first_parent returns.
    dmin, parent = kernels.dmin_parent(*pl, g.seg, x["dist"], g.orig_id, edges=edges)
    dmin_ref = kernels.dmin_plain(*pl, x["dist"])
    pairs = {
        "relax": (kernels.relax(*pl, g.seg, x["dist_mid"], edges=edges),
                  kernels.relax_plain(*pl, x["dist_mid"])),
        "dmin_parent.dmin": (dmin, dmin_ref),
        "dmin_parent.parent": (parent, kernels.parent_plain(*pl, x["dist"], dmin_ref,
                                                            g.orig_id)),
        "nh_or": (kernels.nh_or(*pl, g.seg, x["dist"], x["gate"], x["nh"], x["direct"],
                                edges=edges),
                  kernels.nh_or_plain(*pl, x["dist"], x["gate"], x["nh"], x["direct"])),
    }
    torch.cuda.synchronize()
    for name, (got, want) in pairs.items():
        assert torch.equal(got, want), name


@pytest.mark.parametrize("batch", [1, 5, 33, 70, 257])
def test_kernels_match_plain_versions(batch):
    _assert_kernels_match(*_inputs(batch, _card()))


def test_kernels_match_plain_versions_on_a_fat_tree():
    _assert_kernels_match(*_inputs(40, _card(), synth.fat_tree_topology(k=8)))


def test_kernels_match_plain_versions_past_the_staged_entries():
    # One block pair of 11,302 edges: more than any tile kernel stages in
    # shared memory (at most 9,984), so each also reads entries from
    # device memory.
    topo = synth.random_ospf_topology(n_routers=240, n_networks=10, extra_p2p=6000, seed=3)
    _assert_kernels_match(*_inputs(40, _card(), topo))


@pytest.mark.parametrize("batch", [1, 40])
def test_kernels_match_plain_versions_where_parents_tie(batch):
    # Costs 1-2: many vertices have several DAG parents at the min distance.
    topo = synth.random_ospf_topology(
        n_routers=560, n_networks=60, extra_p2p=900, max_cost=2, seed=5
    )
    _assert_kernels_match(*_inputs(batch, _card(), topo))


@pytest.mark.parametrize("batch", [1, 40])
def test_kernels_match_plain_versions_with_an_unreached_block(batch):
    # 600 vertices = 3 blocks; block 2 has no in-edges (its one pair has
    # empty columns), so each of its rows keeps (CAP, PBIG).
    src = np.r_[np.arange(0, 511), np.arange(512, 600)]
    dst = np.r_[np.arange(1, 512), np.arange(0, 88)]
    topo = Topology(n_vertices=600, is_router=np.ones(600, bool), edge_src=src,
                    edge_dst=dst, edge_cost=np.arange(src.size) % 7 + 1, root=0)
    g, x = _inputs(batch, _card(), topo, permute=False)
    _assert_kernels_match(g, x)
    dmin, parent = kernels.dmin_parent(g.w, g.bsrc, g.bdst, g.seg, x["dist"], g.orig_id,
                                       edges=blk.edges_of(g))
    assert (dmin[512:] == blk.CAP).all() and (parent[512:] == bspf.PBIG).all()


def test_backend_on_the_card_matches_scalar():
    _card()
    topo = synth.random_ospf_topology(n_routers=260, n_networks=40, extra_p2p=400, seed=0)
    masks = synth.whatif_link_failure_masks(topo, 6, seed=7)
    kernels.reset_launches()
    got = TorchSpfBackend(engine="blocked").compute_whatif(topo, masks)
    assert all(v > 0 for v in kernels.launches.values()), kernels.launches
    for a, b in zip(got, ScalarSpfBackend().compute_whatif(topo, masks)):
        for f in ("dist", "parent", "hops", "nexthop_words"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_wrappers_refuse_bad_planes():
    dev = _card()
    w = torch.zeros((1, 256, 256), dtype=torch.int32, device=dev)
    idx = torch.zeros(1, dtype=torch.int32, device=dev)
    seg = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    dist = torch.zeros((256, 4), dtype=torch.int32, device=dev)
    oid = torch.zeros(256, dtype=torch.int32, device=dev)
    cptr = torch.zeros((1, 257), dtype=torch.int32, device=dev)
    edges = (cptr, idx, idx, idx)
    with pytest.raises(ValueError, match="int32"):
        kernels.dmin_parent(w, idx, idx, seg, dist.long(), oid, edges=edges)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.dmin_parent(w, idx, idx, seg, dist.T, oid, edges=edges)
    with pytest.raises(ValueError, match="shapes disagree"):
        kernels.dmin_parent(w, idx, idx, seg, dist[:128], oid, edges=edges)
    with pytest.raises(ValueError, match="orig_id"):
        kernels.dmin_parent(w, idx, idx, seg, dist, oid[:128], edges=edges)
    with pytest.raises(ValueError, match="edges="):
        kernels.dmin_parent(w, idx, idx, seg, dist, oid)
    with pytest.raises(ValueError, match="edge planes"):
        kernels.dmin_parent(w, idx, idx, seg, dist, oid, edges=(cptr[:, :256], idx, idx, idx))


# ---------------------------------------------------------------------------
# The gather engine's kernels.


def _k40_topology():
    # Vertex 0 fans out to 40 routers that all reach vertex 41: K = 40.
    src = np.r_[np.zeros(40, int), np.arange(1, 41), np.arange(1, 41), np.full(40, 41)]
    dst = np.r_[np.arange(1, 41), np.zeros(40, int), np.full(40, 41), np.arange(1, 41)]
    cost = np.r_[np.ones(80, int), np.arange(40) % 3 + 1, np.ones(40, int)]
    topo = Topology(n_vertices=42, is_router=np.ones(42, bool), edge_src=src, edge_dst=dst,
                    edge_cost=cost, root=0)
    synth.assign_direct_atoms(topo)
    return topo


def _k130_topology():
    # Root 0 -- hub 1, which fans out to 130 routers that all reach vertex
    # 132: K = 136 (padded), five 32-slot chunks of the round kernels.
    fan = np.arange(2, 132)
    src = np.r_[0, 1, np.ones(130, int), fan, fan, np.full(130, 132)]
    dst = np.r_[1, 0, fan, np.ones(130, int), np.full(130, 132), fan]
    cost = np.r_[1, 1, np.ones(260, int), fan % 3 + 1, np.ones(130, int)]
    topo = Topology(n_vertices=133, is_router=np.ones(133, bool), edge_src=src, edge_dst=dst,
                    edge_cost=cost, root=0)
    synth.assign_direct_atoms(topo)
    return topo


def _networks_topology():
    # A random OSPF topology whose root neighbours three transit networks
    # (hops-0 sources other than the root), plus a router with only
    # out-edges: a row of only padding slots.
    t = synth.random_ospf_topology(n_routers=60, n_networks=15, extra_p2p=80, max_cost=3,
                                   seed=10)
    n = t.n_vertices
    topo = Topology(n_vertices=n + 1, is_router=np.r_[t.is_router, True],
                    edge_src=np.r_[t.edge_src, n, n], edge_dst=np.r_[t.edge_dst, t.root, n - 1],
                    edge_cost=np.r_[t.edge_cost, 1, 2], root=t.root)
    synth.assign_direct_atoms(topo)
    return topo


_SHAPES = {"fat_tree_k8": lambda: synth.fat_tree_topology(k=8), "k40": _k40_topology,
           "k130": _k130_topology, "networks": _networks_topology}


def _dark_masks(topo, lanes):
    """What-if masks in which some lanes have every edge down (reached only
    at the root): every third lane, lanes 32-63 (a whole tile) and 256-511
    (a whole 256-lane group)."""
    masks = synth.whatif_link_failure_masks(topo, lanes, seed=lanes)
    b = np.arange(lanes)
    masks[(b % 3 == 1) | ((b >= 32) & (b < 64)) | ((b >= 256) & (b < 512))] = False
    return masks


def _ell_inputs(topo, lanes, dev, roots=None, masked=True, masks=None):
    """(graph, planes, roots, x): one gather dispatch on the card, with each
    ell_relax / ell_nh_round launch's (plane, frontier) input in
    x["relax"] / x["round"]; scenario masks (``masks``, or drawn) unless
    ``roots`` or not ``masked``."""
    g = se.device_graph_from_ell(build_ell(topo, n_atoms=64), dev)
    mask = None
    if roots is None:
        if masked:
            if masks is None:
                masks = synth.whatif_link_failure_masks(topo, lanes, seed=lanes)
            mask = se.pack_edge_masks(masks, dev)
        roots = torch.full((lanes,), topo.root, dtype=torch.int32, device=dev)
    else:
        roots = torch.as_tensor(roots, dtype=torch.int32, device=dev)
    p = se.lane_planes(g, mask)
    n = topo.n_vertices
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
    return g, p, roots, x


def _assert_ell_kernels_match(g, p, roots, x):
    seed_in = (p.src, x["dag"], x["hop0"], g.direct_nh_words, roots.shape[0])
    dist_mid, front_mid = x["relax"][min(2, len(x["relax"]) - 1)]
    nh_mid, nh_front = x["round"][min(1, len(x["round"]) - 1)]
    pairs = {
        "ell_relax": (ell.ell_relax(*p, dist_mid, front_mid),
                      ell.relax_plain(*p, dist_mid, front_mid)),
        "ell_first_parent": (ell.ell_first_parent(*p, x["dist"], roots),
                             ell.first_parent_plain(*p, x["dist"], roots)),
        "ell_nh_seed": (ell.ell_nh_seed(*seed_in), ell.nh_seed_plain(*seed_in)),
        "ell_nh_round": (ell.ell_nh_round(p.src, x["inherit"], nh_mid, nh_front),
                         ell.nh_round_plain(p.src, x["inherit"], nh_mid, nh_front)),
    }
    torch.cuda.synchronize()
    for name, (got, want) in pairs.items():
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), f"{name} output {i}"


def _assert_every_round_matches(p, x):
    """Each launch of the dispatch, with its real frontier and with an
    all-ones one: (out, changed, frontier_out) equal to the plain full
    round."""
    for kind in ("relax", "round"):
        for r, (plane, front) in enumerate(x[kind]):
            ones = ell.pack_lane_bits(torch.ones((plane.shape[0], plane.shape[-1]),
                                                 dtype=torch.bool, device=plane.device))
            for label, f in (("real", front), ("all-ones", ones)):
                if kind == "relax":
                    got = ell.ell_relax(*p, plane, f)
                    want = ell.relax_plain(*p, plane, f)
                else:
                    got = ell.ell_nh_round(p.src, x["inherit"], plane, f)
                    want = ell.nh_round_plain(p.src, x["inherit"], plane, f)
                torch.cuda.synchronize()
                for i, (a, b) in enumerate(zip(got, want)):
                    assert torch.equal(a, b), f"{kind} round {r + 1} {label} output {i}"


@pytest.mark.parametrize("lanes", [1, 8, 33, 1024])
@pytest.mark.parametrize("shape", ["fat_tree_k8", "k40"])
def test_ell_kernels_match_plain_versions(shape, lanes):
    topo = synth.fat_tree_topology(k=8) if shape == "fat_tree_k8" else _k40_topology()
    _assert_ell_kernels_match(*_ell_inputs(topo, lanes, _card()))


@pytest.mark.parametrize("shape", ["fat_tree_k8", "k40", "networks"])
def test_ell_kernels_match_plain_versions_on_root_lanes(shape):
    topo = _SHAPES[shape]()
    roots = np.random.default_rng(0).integers(0, topo.n_vertices, 64)
    _assert_ell_kernels_match(*_ell_inputs(topo, 64, _card(), roots=roots))


@pytest.mark.parametrize("lanes", [1, 5, 33, 64, 1024])
@pytest.mark.parametrize("shape", ["k40", "k130", "networks"])
def test_dag_kernels_match_plain_versions(shape, lanes):
    # ell_first_parent's parent and DAG bits and ell_nh_seed's seed and
    # inherit bits, with lanes reached only at the root (dark in every
    # other row), K up to five 32-slot chunks, and, on "networks", hops-0
    # sources other than the root and a row of only padding slots.
    topo = _SHAPES[shape]()
    g, p, roots, x = _ell_inputs(topo, lanes, _card(), masks=_dark_masks(topo, lanes))
    _assert_ell_kernels_match(g, p, roots, x)
    dark = torch.from_numpy(_dark_masks(topo, lanes).sum(1) == 0).to(x["dist"].device)
    assert bool((x["dist"][:, dark] < INF).sum(0).le(1).all())  # the root alone
    if shape == "networks":
        n = topo.n_vertices
        assert not bool(p.slot[n - 1].ge(0).any())  # the padding row
        assert bool(x["hop0"][:n - 1][~g.is_router[:n - 1]].ne(0).any())


@pytest.mark.parametrize("max_iters", [1, 2, 3])
def test_ell_driver_on_the_card_matches_cpu_when_truncated(max_iters):
    dev = _card()
    topo = synth.random_ospf_topology(n_routers=260, n_networks=40, extra_p2p=400, seed=2)
    masks = synth.whatif_link_failure_masks(topo, 40, seed=3)
    g = se.device_graph_from_ell(build_ell(topo, n_atoms=64), "cpu")
    gc = se.DeviceGraph(*(t.to(dev) for t in g))
    for one, cpu in ((se.spf_whatif_batch(gc, topo.root, masks, max_iters),
                      se.spf_whatif_batch(g, topo.root, masks, max_iters)),
                     (se.spf_one(gc, topo.root, None, max_iters),
                      se.spf_one(g, topo.root, None, max_iters))):
        for a, b in zip(one, cpu):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("lanes", [1, 8, 33, 257, 1024])
@pytest.mark.parametrize("shape", ["fat_tree_k8", "k40", "k130"])
@pytest.mark.parametrize("masked", [True, False])
def test_frontier_rounds_match_the_full_round(shape, lanes, masked):
    g, p, roots, x = _ell_inputs(_SHAPES[shape](), lanes, _card(), masked=masked)
    _assert_every_round_matches(p, x)


def test_ell_wrappers_refuse_mixed_devices():
    dev = _card()
    g, p, roots, x = _ell_inputs(synth.fat_tree_topology(k=8), 4, dev)
    dist, front = x["relax"][1]
    nh, nh_front = x["round"][0]
    with pytest.raises(ValueError, match="CUDA device"):
        ell.ell_relax(*p, dist.cpu(), front)
    with pytest.raises(ValueError, match="CUDA device"):
        ell.ell_first_parent(p.src.cpu(), p.cost, p.slot, p.mask, x["dist"], roots)
    with pytest.raises(ValueError, match="int32"):
        ell.ell_nh_round(p.src, x["inherit"], nh.long(), nh_front)
    with pytest.raises(ValueError, match="planes disagree"):
        ell.ell_relax(*p, dist[:-1].contiguous(), front[:-1].contiguous())
    with pytest.raises(ValueError, match="planes disagree"):
        ell.ell_nh_seed(p.src, x["dag"], x["hop0"][:-1].contiguous(), g.direct_nh_words, 4)


def test_ell_wrappers_refuse_a_bad_frontier():
    dev = _card()
    g, p, roots, x = _ell_inputs(synth.fat_tree_topology(k=8), 40, dev)
    dist, front = x["relax"][1]
    nh, nh_front = x["round"][0]
    for call, f in ((lambda f: ell.ell_relax(*p, dist, f), front),
                    (lambda f: ell.ell_nh_round(p.src, x["inherit"], nh, f), nh_front)):
        with pytest.raises(ValueError, match="frontier"):
            call(f[:, :1].contiguous())  # one word where 40 lanes need two
        with pytest.raises(ValueError, match="frontier"):
            call(f[:-1].contiguous())
        with pytest.raises(ValueError, match="int32"):
            call(f.long())
        with pytest.raises(ValueError, match="CUDA device"):
            call(f.cpu())


def test_gather_backend_on_the_card_matches_scalar():
    _card()
    topo = synth.random_ospf_topology(n_routers=260, n_networks=40, extra_p2p=400, seed=0)
    masks = synth.whatif_link_failure_masks(topo, 40, seed=7)
    ell.reset_launches()
    be, sc = TorchSpfBackend(), ScalarSpfBackend()
    got = be.compute_whatif(topo, masks)
    one = be.compute(topo)
    single_path = ("ell_relax", "ell_first_parent", "ell_nh_seed", "ell_nh_round")
    assert all(ell.launches[k] > 0 for k in single_path), ell.launches
    for a, b in zip([*got, one], [*sc.compute_whatif(topo, masks), sc.compute(topo)]):
        for f in ("dist", "parent", "hops", "nexthop_words"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    roots = [0, 5, 77, 259]
    mr, mr_ref = be.compute_multiroot(topo, roots), sc.compute_multiroot(topo, roots)
    for f in ("dist", "parent", "hops"):
        np.testing.assert_array_equal(getattr(mr, f), getattr(mr_ref, f), err_msg=f)


def _linked(base, nxt, delta=None):
    nxt.link_delta(graph.diff_topologies(base, nxt) if delta is None else delta)
    return nxt


def _link(topo, e):
    """bool[E]: both directions of edge e's link."""
    s, d = int(topo.edge_src[e]), int(topo.edge_dst[e])
    return ((topo.edge_src == s) & (topo.edge_dst == d)) | (
        (topo.edge_src == d) & (topo.edge_dst == s))


def _delta_chain(topo, steps, seed, strike_at=None):
    """Topologies, each linked to the one before: cost changes, link
    removals and restorations, and an overload strike at ``strike_at``."""
    rng = np.random.default_rng(seed)
    cur, removed, out = topo, [], []
    for i in range(steps):
        e = int(rng.integers(0, cur.n_edges))
        s, d = int(cur.edge_src[e]), int(cur.edge_dst[e])
        link = _link(cur, e)
        if i == strike_at:
            v = s if s != cur.root else d
            nxt = _linked(cur, synth.clone_topology(cur, keep=cur.edge_src != v),
                          graph.TopologyDelta(base_key=cur.cache_key, overload=np.int32([v]),
                                              ids_stable=False))
        elif i % 3 == 1:
            removed.append([[int(cur.edge_src[x]), int(cur.edge_dst[x]), int(cur.edge_cost[x]),
                             int(cur.edge_direct_atom[x])] for x in np.nonzero(link)[0]])
            nxt = _linked(cur, synth.clone_topology(cur, keep=~link))
        elif i % 3 == 2 and removed:
            nxt = _linked(cur, synth.clone_topology(cur, extra=removed.pop()))
        else:
            cost = {int(x): int(rng.integers(1, 9)) for x in np.nonzero(link)[0]}
            nxt = _linked(cur, synth.clone_topology(cur, cost=cost))
        out.append(nxt)
        cur = nxt
    return out


def _same_result(a, b, label):
    for f in ("dist", "parent", "hops", "nexthop_words"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{label} {f}")


def test_delta_chain_on_the_card_matches_the_cpu_path():
    _card()
    topo = synth.fat_tree_topology(k=24)
    card, cpu = TorchSpfBackend(), TorchSpfBackend(device="cpu")
    _same_result(card.compute(topo), cpu.compute(topo), "base")
    chain = _delta_chain(topo, 9, seed=1, strike_at=4)
    ell.reset_launches()
    got = [card.compute(t) for t in chain]
    torch.cuda.synchronize()
    assert ell.launches["ell_relax"] > 0 and ell.launches["ell_first_parent"] > 0, ell.launches
    for i, (t, res) in enumerate(zip(chain, got)):
        _same_result(res, cpu.compute(t), f"step {i}")
    _same_result(got[-1], ScalarSpfBackend().compute(chain[-1]), "last step, oracle")
    assert card.delta_paths == cpu.delta_paths
    assert sum(v for (_, p), v in card.delta_paths.items() if p == "incremental") == len(chain)


def test_apply_delta_slots_in_place_on_the_card():
    dev = _card()
    topo = synth.random_ospf_topology(n_routers=260, n_networks=40, extra_p2p=400, seed=4)
    eg = build_ell(topo, n_atoms=64)
    card = se.device_graph_from_ell(eg, dev)
    cpu = se.device_graph_from_ell(eg, "cpu")
    mirror = se._EllMirror(eg)
    ptrs = [t.data_ptr() for t in card]
    v = int(topo.edge_src[np.nonzero(topo.edge_src != topo.root)[0][3]])
    t1 = synth.clone_topology(topo, cost={3: 40, 9: 1, 20: 7})
    t2 = synth.clone_topology(t1, keep=~_link(t1, 30))
    # an added edge carrying atom 31: bit 31 of word 0, the sign bit
    t3 = synth.clone_topology(t2, extra=[[topo.root, 5, 2, 31]])
    deltas = [graph.diff_topologies(topo, t1), graph.diff_topologies(t1, t2),
              graph.diff_topologies(t2, t3),
              graph.TopologyDelta(base_key=t3.cache_key, overload=np.int32([v]),
                                  ids_stable=False)]
    for d in deltas:
        ops = se.lower_delta(mirror, d, topo.n_vertices)
        se.apply_delta_slots(card, ops)
        se.apply_delta_slots(cpu, ops)
        for f in se.DeviceGraph._fields:
            assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), (d.kind, f)
    assert [t.data_ptr() for t in card] == ptrs
    assert int(card.direct_nh_words.min()) == -(1 << 31)
    np.testing.assert_array_equal(card.in_valid.cpu().numpy(), mirror.in_valid)


def test_stale_edge_ids_rebuild_for_masked_dispatches_on_the_card():
    _card()
    topo = synth.random_ospf_topology(n_routers=260, n_networks=40, extra_p2p=400, seed=6)
    be, sc = TorchSpfBackend(), ScalarSpfBackend()
    be._gather_cache.clear()  # the card's shared cache: this test's entries only
    be.compute(topo)
    chain = _delta_chain(topo, 5, seed=3)
    for i, t in enumerate(chain):
        be.compute(t)  # incremental; after a link removal the entry's ids are stale
        if i not in (1, 4):  # the two link removals
            continue
        assert be._gather_cache.stats()["stale-id-entries"] == 1
        misses = be._gather_cache.lookups["miss"]
        masks = synth.whatif_link_failure_masks(t, 8, seed=4)
        if i == 1:
            got, want = be.compute_whatif(t, masks), sc.compute_whatif(t, masks)
        else:
            got, want = [be.compute(t, masks[5])], [sc.compute(t, masks[5])]
        assert be._gather_cache.lookups["miss"] == misses + 1
        for j, (a, b) in enumerate(zip(got, want)):
            _same_result(a, b, f"step {i} scenario {j}")
    assert be.delta_paths[("struct", "incremental")] >= 2


# ---------------------------------------------------------------------------
# Multipath


def _ladder_topology():
    # Parallel equal-cost ladders: path counts reach MP_SAT (2^17).
    n = 44
    src, dst = [], []
    for i in range(0, n - 2, 2):
        for a in (i, i + 1):
            for b in (i + 2, i + 3):
                src += [a, b]
                dst += [b, a]
    topo = Topology(n_vertices=n, is_router=np.ones(n, bool), edge_src=np.array(src),
                    edge_dst=np.array(dst), edge_cost=np.ones(len(src), int), root=0)
    synth.assign_direct_atoms(topo)
    return topo


def _parallel_topology():
    # A tied random topology with a second edge beside every fifth one.
    t = synth.random_ospf_topology(60, n_networks=10, extra_p2p=90, max_cost=4, seed=3)
    e = np.arange(0, t.n_edges, 5)
    topo = Topology(n_vertices=t.n_vertices, is_router=t.is_router,
                    edge_src=np.r_[t.edge_src, t.edge_src[e]],
                    edge_dst=np.r_[t.edge_dst, t.edge_dst[e]],
                    edge_cost=np.r_[t.edge_cost, t.edge_cost[e] + (e // 5) % 2], root=t.root)
    synth.assign_direct_atoms(topo)
    return topo


_MP_SHAPES = {**_SHAPES, "ladder": _ladder_topology, "parallel": _parallel_topology}


def _mp_inputs(topo, lanes, dev, n_atoms=64):
    """(planes, fixed planes, dist, launches, npaths): one multipath
    dispatch on the card (scenario masks past one lane); launches lists
    each ell_mp_round launch's input as copies (state, frontier, the out
    buffer before the launch)."""
    g = se.device_graph_from_ell(build_ell(topo, n_atoms=n_atoms), dev)
    mask = None
    if lanes > 1:
        mask = se.pack_edge_masks(_dark_masks(topo, lanes), dev)
    roots = torch.full((lanes,), topo.root, dtype=torch.int32, device=dev)
    p = se.lane_planes(g, mask)
    n = topo.n_vertices
    dist = se.distance_fixpoint(p, roots, n)
    parent, dag = ell.ell_first_parent(*p, dist, roots)
    state, before, front = se.mp_start(n, g.direct_nh_words.shape[2], roots)
    inc = g.is_router.to(torch.int32)
    fixed = (p.src, dag, g.direct_nh_words, inc, roots, parent)
    launches = []
    while True:
        launches.append((_clone(state), front.clone(), _clone(before)))
        changed, front = ell.ell_mp_round(*fixed, state, front, before)
        state, before = before, state
        if not bool(changed):
            break
    return p, fixed, dist, launches, state[2]


def _clone(planes):
    return tuple(None if x is None else x.clone() for x in planes)


def _hops_nh(planes):
    return (*planes[:2], None, None)


@pytest.mark.parametrize("lanes", [1, 5, 8, 33, 64])
@pytest.mark.parametrize("shape", sorted(_MP_SHAPES) + ["networks_w4"])
def test_mp_kernels_match_plain_versions(shape, lanes):
    # networks_w4: 100 atoms, four next-hop words and 128 weight lanes.
    topo = _MP_SHAPES[shape.removesuffix("_w4")]()
    p, fixed, dist, launches, npaths = _mp_inputs(topo, lanes, _card(),
                                                  100 if shape.endswith("_w4") else 64)
    assert fixed[2].shape[2] == (4 if shape.endswith("_w4") else 2)
    assert len(launches) >= 2
    ones = ell.pack_lane_bits(torch.ones(fixed[5].shape, dtype=torch.bool, device=npaths.device))
    for r, (state, front, before) in enumerate(launches):
        # The dispatch's frontier, and an all-ones one (a full round).
        for label, st, f, out in (("mp", state, front, before),
                                  ("hops+nh", _hops_nh(state), front, _hops_nh(before)),
                                  ("mp all-ones", state, ones, before)):
            got, want = _clone(out), _clone(out)
            res = ell.ell_mp_round(*fixed, st, f, got)
            ref = ell.mp_round_plain(*fixed, st, f, want)
            full = ell.mp_round_full(*fixed, st)
            torch.cuda.synchronize()
            for i, (a, b, c) in enumerate(zip((*got, *res), (*want, *ref), full)):
                assert (a is None and b is None and c is None) or (
                    torch.equal(a, b) and torch.equal(a, c)), \
                    f"ell_mp_round {label} round {r + 1} output {i}"
    roots = fixed[4]
    for kp in (2, 4, 8):
        got = ell.ell_parent_sets(*p, dist, roots, kp)
        want = ell.first_parent_sets_plain(*p, dist, roots, kp)
        ref = (*ell.first_parent_plain(*p, dist, roots),
               *ell.parent_sets_plain(*p, dist, npaths, roots, kp)[:2])
        torch.cuda.synchronize()
        for i, (a, b, c) in enumerate(zip(got, want, ref)):
            assert torch.equal(a, b) and torch.equal(a, c), f"ell_parent_sets kp={kp} output {i}"
        got = ell.ell_parent_weights(got[2], npaths)
        torch.cuda.synchronize()
        assert torch.equal(got, ell.parent_weights_plain(want[2], npaths))
        assert torch.equal(got, ell.parent_sets_plain(*p, dist, npaths, roots, kp)[2])
    if shape == "ladder":
        assert int(npaths.max()) == 1 << 17  # saturated


def test_mp_wrappers_refuse_bad_planes():
    dev = _card()
    p, fixed, dist, launches, npaths = _mp_inputs(synth.fat_tree_topology(k=8), 40, dev)
    state, front, before = launches[0]
    hops, nh, np_, aw = state
    with pytest.raises(ValueError, match="both npaths and aw"):
        ell.ell_mp_round(*fixed, (hops, nh, np_, None), front, before)
    with pytest.raises(ValueError, match="planes disagree"):
        ell.ell_mp_round(*fixed, (hops, nh, np_, aw[:, :32].contiguous()), front,
                         (*before[:3], before[3][:, :32].contiguous()))
    with pytest.raises(ValueError, match="CUDA device"):
        ell.ell_mp_round(*fixed, (hops.cpu(), nh, np_, aw), front, before)
    with pytest.raises(ValueError, match="frontier"):
        ell.ell_mp_round(*fixed, state, front[:, :1].contiguous(), before)
    with pytest.raises(ValueError, match="kp=3"):
        ell.ell_parent_sets(*p, dist, fixed[4], 3)
    with pytest.raises(ValueError, match="disagree"):
        ell.ell_parent_sets(*p, dist[:, :1].contiguous(), fixed[4], 4)
    parents = ell.ell_parent_sets(*p, dist, fixed[4], 4)[2]
    with pytest.raises(ValueError, match="npaths"):
        ell.ell_parent_weights(parents, npaths[:, :1].contiguous())


_MP_FIELDS = ("dist", "parent", "hops", "nexthop_words", "parents", "pdist", "pweight",
              "npaths", "nh_weights")


def test_multipath_backend_on_the_card_matches_cpu_and_oracle():
    _card()
    topo = synth.random_ospf_topology(n_routers=260, n_networks=40, extra_p2p=400, max_cost=4,
                                      seed=1)
    masks = synth.whatif_link_failure_masks(topo, 40, seed=2)
    ell.reset_launches()
    card, cpu, sc = TorchSpfBackend(), TorchSpfBackend(device="cpu"), ScalarSpfBackend()
    got = [card.compute(topo, multipath_k=k) for k in (2, 3, 8)]
    batch = card.compute_whatif(topo, masks, multipath_k=4)
    torch.cuda.synchronize()
    assert ell.launches["ell_mp_round"] > 0 and ell.launches["ell_parent_sets"] == 4
    assert ell.launches["ell_first_parent"] == 0  # the fused walk takes its place
    for k, res in zip((2, 3, 8), got):
        for want, label in ((cpu.compute(topo, multipath_k=k), "cpu"),
                            (sc.compute(topo, multipath_k=k), "oracle")):
            for f in _MP_FIELDS:
                np.testing.assert_array_equal(getattr(res, f), getattr(want, f),
                                              err_msg=f"k={k} {label} {f}")
    want = cpu.compute_whatif(topo, masks, multipath_k=4)
    for b, (x, y) in enumerate(zip(batch, want)):
        for f in _MP_FIELDS:
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f), err_msg=f"b={b} {f}")
    for b in range(3):
        ref = sc.compute(topo, masks[b], multipath_k=4)
        for f in _MP_FIELDS:
            np.testing.assert_array_equal(getattr(batch[b], f), getattr(ref, f), err_msg=f)


def test_multipath_delta_chain_on_the_card_matches_the_cpu_path():
    _card()
    topo = synth.fat_tree_topology(k=12)
    card, cpu = TorchSpfBackend(), TorchSpfBackend(device="cpu")
    card.compute(topo, multipath_k=4)
    cpu.compute(topo, multipath_k=4)
    chain = _delta_chain(topo, 7, seed=2, strike_at=3)
    ell.reset_launches()
    got = [card.compute(t, multipath_k=4) for t in chain]
    torch.cuda.synchronize()
    assert ell.launches["ell_mp_round"] > 0 and ell.launches["ell_parent_sets"] == len(chain)
    assert ell.launches["ell_first_parent"] == 0
    for i, (t, res) in enumerate(zip(chain, got)):
        want = cpu.compute(t, multipath_k=4)
        for f in _MP_FIELDS:
            np.testing.assert_array_equal(getattr(res, f), getattr(want, f),
                                          err_msg=f"step {i} {f}")
    assert card.delta_paths == cpu.delta_paths
    assert sum(v for (_, p), v in card.delta_paths.items() if p == "incremental") == len(chain)


# -- fast reroute: the all-roots matrix at B = N lanes and the backup tables


def _frr_lan():
    topo = synth.random_ospf_topology(n_routers=200, n_networks=50, extra_p2p=300, seed=23)
    topo.edge_srlg = np.random.default_rng(5).integers(0, 8, topo.n_edges).astype(np.uint32)
    return topo


def test_all_roots_matrix_on_the_card_matches_the_cpu_path():
    """D runs ell_relax with one lane per vertex (250: not a multiple of 32),
    no mask; every launch equals the CPU path's."""
    from holo_tpu_torch.frr import kernel as fk

    dev = _card()
    topo = _frr_lan()
    g = se.device_graph_from_ell(build_ell(topo), dev)
    gc = se.device_graph_from_ell(build_ell(topo), "cpu")
    ell.reset_launches()
    d = fk.all_roots(g)
    torch.cuda.synchronize()
    assert ell.launches["ell_relax"] > 0 and d.shape == (topo.n_vertices, topo.n_vertices)
    assert torch.equal(d.cpu(), fk.all_roots(gc))
    for m in (1, 2):
        assert torch.equal(fk.all_roots(g, m).cpu(), fk.all_roots(gc, m))


@pytest.mark.parametrize("policy", [{}, {"node_protection": True, "srlg_disjoint": True}])
def test_frr_engine_on_the_card_matches_the_cpu_path_and_oracle(policy):
    from holo_tpu_torch.frr.manager import FrrConfig, FrrEngine
    from holo_tpu_torch.frr.scalar import frr_reference

    _card()
    topo = _frr_lan()
    cfg = FrrConfig(enabled=True, remote_lfa=True, ti_lfa=True, **policy)
    card, cpu = FrrEngine("torch"), FrrEngine("torch", device="cpu")
    assert card.device.type == "cuda"
    for eng in (card, cpu):
        eng.set_policy(cfg)
    got, want = card.compute(topo), cpu.compute(topo)
    oracle = frr_reference(topo, 64, **policy)
    for f in ("lfa_adj", "lfa_nodeprot", "rlfa_pq", "tilfa_p", "tilfa_q", "post_dist",
              "post_nh"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        np.testing.assert_array_equal(getattr(got, f), getattr(oracle, f), err_msg=f)
    assert card.dispatches == {"device": 1}
    assert card.breaker.snapshot()["fallbacks"] == {}


def test_graft_entry_on_the_card_matches_the_cpu_path():
    from holo_tpu_torch import graft_entry

    _card()
    fn, args = graft_entry.entry()
    assert args[0].in_src.device.type == "cuda"
    got = fn(*args)
    cfn, cargs = graft_entry.entry(device="cpu")
    want = cfn(*cargs)
    for f in ("dist", "parent", "hops", "nexthops"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


# -- partitioned SPF and CSPF


_PART_FIELDS = ("dist", "parent", "hops", "nexthop_words")


@pytest.mark.parametrize("cut", ["hinted", "flat"])
def test_partitioned_backend_on_the_card_matches_cpu_and_oracle(cut):
    _card()
    topo = synth.multiarea_topology(6, 16, 16, seed=7)
    if cut == "flat":
        topo.partition_hint = None
    kw = dict(partition_threshold=1, partition_max_part=256)
    card, cpu = TorchSpfBackend(**kw), TorchSpfBackend(device="cpu", **kw)
    ell.reset_launches()
    for k in (1, 4):
        got, want = card.compute(topo, multipath_k=k), cpu.compute(topo, multipath_k=k)
        ref = ScalarSpfBackend().compute(topo, multipath_k=k)
        for f in _PART_FIELDS + (_MP_FIELDS if k > 1 else ()):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    torch.cuda.synchronize()
    assert ell.launches["ell_relax"] > 0 and ell.launches["ell_mp_round"] > 0
    assert ell.launches["ell_first_parent"] == 1 and ell.launches["ell_parent_sets"] == 1
    short = TorchSpfBackend(max_iters=2, **kw).compute(topo)
    want = TorchSpfBackend(device="cpu", max_iters=2, **kw).compute(topo)
    for f in _PART_FIELDS:
        np.testing.assert_array_equal(getattr(short, f), getattr(want, f), err_msg=f)
    card.compute(topo)  # the chain's base, at multipath_k=1
    cpu.compute(topo)
    per, cur = 256, topo
    for i, (a, b) in enumerate([(3 * per + 17, 3 * per + 18), (5 * per + 16, 16 + 5),
                                (2 * per + 40, 2 * per + 56)]):
        fwd = int(np.nonzero((cur.edge_src == a) & (cur.edge_dst == b))[0][0])
        rev = int(np.nonzero((cur.edge_src == b) & (cur.edge_dst == a))[0][0])
        nxt = synth.clone_topology(cur, cost={fwd: 9 + i, rev: 9 + i})
        nxt.link_delta(graph.diff_topologies(cur, nxt))
        got, want = card.compute(nxt), cpu.compute(nxt)
        for f in _PART_FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f"step {i} {f}")
        cur = nxt
    assert card.delta_paths == cpu.delta_paths
    assert card.delta_paths[("weight", "partitioned-incremental")] == 3


def test_cspf_on_the_card_matches_the_cpu_path():
    from holo_tpu_torch.ops.cspf import Constraint, CspfEngine, LinkAttrs

    _card()
    topo = synth.fat_tree_topology(k=12)
    rng = np.random.default_rng(7)
    attrs = LinkAttrs(affinity=rng.integers(0, 2**8, topo.n_edges, dtype=np.uint32),
                      bandwidth=rng.uniform(1.0, 10.0, topo.n_edges))
    cons = [Constraint(exclude_any=int(rng.integers(0, 4)),
                       min_bandwidth=float(rng.uniform(0.0, 2.0))) for _ in range(64)]
    dsts = [int(d) for d in rng.integers(0, topo.n_vertices, 64)]
    ell.reset_launches()
    got = CspfEngine(topo, attrs).compute(cons, dsts)
    torch.cuda.synchronize()
    assert ell.launches["ell_relax"] > 0 and ell.launches["ell_nh_round"] > 0
    want = CspfEngine(topo, attrs, device="cpu").compute(cons, dsts)
    assert [(p.cost, p.vertices) for p in got] == [(p.cost, p.vertices) for p in want]
    assert any(p.cost is not None for p in got)


# ---------------------------------------------------------------------------
# The BGP table's fold (kernels/bgp.py over csrc/bgp_kernels.cu)


def _bgp_planes(rng, rows, cols, k):
    """Seeded lane planes (ops.bgp_table's lanes): every ladder rung varies
    over few values, router ids are present or not, next hops may not
    resolve or lie past K (clamped), local cells in column 0; row 0 holds a
    MED cycle in columns 1-3 where there are four columns."""
    from holo_tpu_torch.kernels import bgp as kb

    def nbias(a):
        return (np.asarray(a, np.int64) - (1 << 31)).astype(np.int32)

    shape = (rows, cols)
    p = np.zeros((kb.N_LANES, rows, cols), np.int32)
    occ = (rng.random(shape) < 0.7).astype(np.int32)
    p[kb.L_LP] = nbias(0xFFFFFFFF - rng.integers(99, 102, size=shape))
    p[kb.L_L1] = (rng.integers(1, 3, size=shape) << 2) | rng.integers(0, 2, size=shape)
    p[kb.L_MED] = nbias(rng.integers(0, 3, size=shape))
    p[kb.L_FAS] = rng.integers(0, 3, size=shape)
    p[kb.L_RT] = rng.integers(0, 2, size=shape)
    p[kb.L_IGP] = nbias(rng.integers(0, 3, size=shape))
    p[kb.L_RID] = nbias(rng.integers(0, 4, size=shape))
    p[kb.L_HASRID] = (rng.random(shape) < 0.8).astype(np.int32)
    p[kb.L_NH] = rng.integers(0, k + 2, size=shape)
    p[kb.L_PATH] = rng.integers(0, 3, size=shape)
    p[kb.L_LOOP] = (rng.random(shape) < 0.05).astype(np.int32)
    p[kb.L_LOCAL, :, 0] = (rng.random(rows) < 0.5).astype(np.int32)
    if cols >= 4:
        p[:, 0, :] = 0
        occ[0] = 0
        for c, (fas, med, rid) in zip((1, 2, 3), ((1, 100, 1), (2, 0, 2), (1, 0, 3))):
            p[kb.L_LP, 0, c], p[kb.L_L1, 0, c] = nbias(0xFFFFFFFF - 100), 4
            p[kb.L_FAS, 0, c], p[kb.L_MED, 0, c], p[kb.L_RT, 0, c] = fas, nbias(med), 1
            p[kb.L_RID, 0, c], p[kb.L_HASRID, 0, c], occ[0, c] = nbias(rid), 1, 1
    p *= occ
    p[kb.L_OCC] = occ
    return p


def _bgp_vectors(rng, cols, k):
    """order (some peer columns unassigned, the local column last),
    addr_rank, has_addr, nht_enc, nht_res (id 0 resolves), mp."""
    peers = rng.permutation(np.arange(1, cols))
    live = peers[: max(1, (3 * len(peers)) // 4)]
    order = np.concatenate([live, np.sort(peers[len(live):]), [0]]).astype(np.int32)
    rank = np.zeros(cols, np.int32)
    rank[live] = np.arange(len(live))
    has = np.zeros(cols, np.int32)
    has[live] = 1
    enc = (rng.integers(1, 4, size=k) - (1 << 31)).astype(np.int32)
    res = (rng.random(k) < 0.75).astype(np.int32)
    res[0] = 1
    mp = np.array([rng.integers(0, 2), rng.integers(1, 3), rng.integers(1, 4)], np.int32)
    return order, rank, has, enc, res, mp


@pytest.mark.parametrize("m,cols,rows", [
    (1, 2, "padded"), (33, 2, "padded"), (37, 17, "padded"), (300, 17, "padded"),
    (64, 64, "padded"), (4096, 64, "padded"), (40, 1024, "padded"),
    (20_000, 64, "exact"),  # 2,500 tiles on 396 blocks: every ring slot reused
    (32_768, 32, "padded"),  # the engine's width
    (5_003, 32, "exact"),  # a last tile of 11 of 16 rows
    (40_003, 17, "exact"),  # cp.async: 2,501 tiles of 16 rows on 396 blocks
    (999, 2, "exact"),
    (300, 1024, "exact"),
    (3_000, 64, "repeated"), (700, 17, "repeated"),
])
def test_bgp_fold_matches_plain(m, cols, rows):
    from holo_tpu_torch.kernels import bgp as kb

    dev = _card()
    rng = np.random.default_rng(m * 131 + cols)
    k = 8
    planes = _bgp_planes(rng, 2 * m, cols, k)
    if rows == "padded":
        live = rng.choice(2 * m, size=m, replace=False)
        idx = np.zeros(1 << (m - 1).bit_length(), np.int32)  # padded with row 0
        idx[:m] = live
    elif rows == "exact":
        idx = rng.choice(2 * m, size=m, replace=False).astype(np.int32)
    else:  # each row taken about twice, some in the same tile
        idx = rng.integers(0, m // 2, size=m).astype(np.int32)
        idx[1::7] = idx[::7][: len(idx[1::7])]
    geo = kb.geometry(len(idx), cols, torch.cuda.get_device_properties(dev).multi_processor_count)
    assert geo.copy == ("tma" if cols % 4 == 0 else "cp.async")
    if rows == "exact" and cols != 1024:  # a last group (and tile) cut short
        assert len(idx) % geo.group_rows or m == 20_000
    if m in (20_000, 40_003):
        assert -(-len(idx) // geo.tile_rows) > geo.stages * geo.blocks
    vecs = _bgp_vectors(rng, cols, k)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    kb.reset_launches()
    got = kb.bgp_fold(on(planes), on(idx), *map(on, vecs))
    torch.cuda.synchronize()
    assert kb.launches["bgp_fold"] == 1
    plain = kb.decide_plain(on(planes), on(idx), *map(on, vecs))
    cpu = kb.bgp_fold(torch.from_numpy(planes), torch.from_numpy(idx),
                      *map(torch.from_numpy, vecs))
    for name, g, w, c in zip(("best_col", "reasons", "elig", "mp_sel"), got, plain, cpu):
        assert g.dtype == w.dtype == c.dtype, name
        assert torch.equal(g, w), name
        assert torch.equal(g.cpu(), c), name
    if cols >= 4 and 0 in idx[:m]:  # the MED-cycle row decided
        assert got[2][int(np.nonzero(idx == 0)[0][0]), 1:4].all()


@pytest.mark.parametrize("cols", [1, 2, 17, 32, 64, 1024])
def test_bgp_fold_smem_matches_the_geometry(cols):
    """The kernel's shared-memory layout (holo_bgp_fold_smem) is the one the
    wrapper sizes its tiles by, at every tile height and ring depth."""
    from holo_tpu_torch.kernels import bgp as kb
    from holo_tpu_torch.kernels import build

    _card()
    lib = build.load()
    for group_rows, tile_rows in ((1, 1), (2, 2), (16, 8), (32, 8), (32, 4)):
        for stages in (2, 3):
            for warps in (1, 2, 4):
                assert lib.holo_bgp_fold_smem(cols, group_rows, tile_rows, stages, warps) == (
                    kb.smem_bytes(cols, group_rows, tile_rows, stages, warps))


def test_bgp_backend_on_the_card_matches_the_oracle():
    """chip_smoke's engine path at 2,048 prefixes x 8 peers: the card's
    backend and the oracle equal cold, after an UPDATE burst and after NHT
    churn, one bgp_fold launch a batch held to decide_plain on its inputs,
    every prefix of a batch decided on the card, no scatter for the churn."""
    import chip_smoke as cs
    from holo_tpu_torch.kernels import bgp as kb
    from holo_tpu_torch.ops.bgp_table import TorchBgpTableBackend
    from holo_tpu_torch.protocols import bgp_engine as be

    _card()
    nht, feed = cs.bgp_feed(be, 2048, 8)
    burst = cs.bgp_burst(be, feed, 8, 128)
    backend = TorchBgpTableBackend()
    arms = []
    for tb in (None, backend):
        calls = []
        eng = be.DecisionEngine(asn=65000, table_backend=tb,
                                ibus_cb=lambda kind, payload, c=calls: c.append((kind, payload)))
        eng.multipath[cs.BGP_AFS] = dict(cs.BGP_MP)
        for addr, metric in nht.items():
            eng.tables[cs.BGP_AFS].nht[addr] = be.NhtEntry(metric=metric)
        for prefix, routes in feed:
            cs.bgp_announce(be, eng, prefix, routes, tb)
        arms.append((eng, calls))
    kb.reset_launches()
    changes = (lambda eng: None,
               lambda eng: [cs.bgp_announce(be, eng, p, r, eng.table_backend) for p, r in burst],
               lambda eng: [eng.nexthop_update(a, m) for a, m in (("9.9.1.1", 40),
                                                                  ("9.9.5.1", 7))])
    for step, change in enumerate(changes):
        scatters = backend.stats()["tables"].get(cs.BGP_AFS, {}).get("scatters", 0)
        served = dict(backend.served)
        queued = 0
        kept = []
        with cs.keeping_decides(kept):
            for eng, _ in arms:
                change(eng)
                queued = len(eng.tables[cs.BGP_AFS].queued)
                eng.run_decision_process()
        torch.cuda.synchronize()
        assert len(kept) == 1, step
        (args, out), = kept
        for g, w in zip(out, kb.decide_plain(*args)):
            assert torch.equal(g, w), step
        assert backend.served["best-device"] - served.get("best-device", 0) == queued, step
        assert not backend.served["best-host"] and not backend.served["nexthops-host"]
        assert cs.bgp_snap(arms[1][0]) == cs.bgp_snap(arms[0][0]), step
        assert arms[1][1] == arms[0][1], step
        assert kb.launches["bgp_fold"] == step + 1
        if step == 2:
            assert backend.stats()["tables"][cs.BGP_AFS]["scatters"] == scatters
    st = backend.stats()
    assert st["fallbacks"] == 0 and st["tables"][cs.BGP_AFS]["poisoned"] == 0
    assert not backend.breaker.failures


# ---------------------------------------------------------------------------
# The fused, packed and hybrid engines.


def _held_fused_dispatch(topo, lanes, dev, packed, n_atoms=64):
    """One fused dispatch on the card as fused_lanes runs it (an all-ones
    first frontier, the parent plane carried, a spare buffer of noise), every
    ell_fused_round launch held to fused_round_plain on the state it ran
    from, in all four outputs: the number of launches."""
    g = se.device_graph_from_ell(build_ell(topo, n_atoms=n_atoms), dev)
    masks = _dark_masks(topo, lanes) if lanes > 1 else None
    mask = None if masks is None else se.pack_edge_masks(masks, dev)
    roots = torch.full((lanes,), topo.root, dtype=torch.int32, device=dev)
    p = se.lane_planes(g, mask)
    n = topo.n_vertices
    at_root = torch.arange(n, device=dev)[:, None] == roots.long()[None, :]
    state = ell.fused_state(torch.where(at_root, 0, INF).to(torch.int32),
                            torch.where(at_root, 0, n + 1).to(torch.int32),
                            torch.zeros((n, g.direct_nh_words.shape[2], lanes), dtype=torch.int32,
                                        device=dev), packed)
    gen = torch.Generator(device=dev).manual_seed(lanes)
    noise = lambda x: torch.randint(-INF, INF, x.shape, generator=gen, device=dev,
                                    dtype=torch.int32)
    spare = noise(state) if packed else tuple(map(noise, state))
    front = ell.full_frontier(n, lanes, dev)
    parent = torch.full((n, lanes), n, dtype=torch.int32, device=dev)
    inc = g.is_router.to(torch.int32)
    launches = 0
    before = dict(ell.fused_layouts)
    for _ in range(3 * n + 6):
        got = ell.ell_fused_round(*p, g.direct_nh_words, inc, roots, state, front, parent.clone(),
                                  spare)
        want = ell.fused_round_plain(*p, g.direct_nh_words, inc, roots, state)
        torch.cuda.synchronize()
        launches += 1
        for i, (a, b) in enumerate(zip(got, want)):
            for x, y in zip((a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b):
                assert torch.equal(x, y), f"launch {launches} output {i}"
        (state, parent, changed, front), spare = got, state
        if not bool(changed):
            break
    layout = "interleaved" if packed else "planar"
    assert ell.fused_layouts[layout] - before[layout] == launches
    return launches


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("lanes", [1, 8, 9, 64, 1024])
@pytest.mark.parametrize("shape", ["fat_tree_k8", "k40", "k130", "networks"])
def test_fused_round_matches_plain(shape, lanes, packed):
    dev = _card()
    assert _held_fused_dispatch(_SHAPES[shape](), lanes, dev, packed) > 2


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("lanes", [1, 33])
def test_fused_round_matches_plain_with_seven_words(lanes, packed):
    dev = _card()
    assert _held_fused_dispatch(_networks_topology(), lanes, dev, packed, n_atoms=200) > 2


def test_fused_round_refuses_bad_planes():
    dev = _card()
    topo = synth.fat_tree_topology(k=4)
    g = se.device_graph_from_ell(build_ell(topo, n_atoms=64), dev)
    p = se.lane_planes(g, None)
    n = topo.n_vertices
    roots = torch.zeros(4, dtype=torch.int32, device=dev)
    inc = g.is_router.to(torch.int32)
    planes = (torch.zeros((n, 4), dtype=torch.int32, device=dev),
              torch.zeros((n, 4), dtype=torch.int32, device=dev),
              torch.zeros((n, 2, 4), dtype=torch.int32, device=dev))
    front = ell.full_frontier(n, 4, dev)
    parent = torch.full((n, 4), n, dtype=torch.int32, device=dev)
    spare = tuple(map(torch.empty_like, planes))
    args = (*p, g.direct_nh_words, inc, roots)
    before = ell.launches["ell_fused_round"]
    with pytest.raises(ValueError, match="another buffer"):
        ell.ell_fused_round(*args, planes, front, parent, planes)
    with pytest.raises(ValueError, match="another buffer"):
        ell.ell_fused_round(*args, planes, front, planes[0], spare)
    with pytest.raises(ValueError, match="another buffer"):
        ell.ell_fused_round(*args, planes, front, spare[0], spare)
    with pytest.raises(ValueError, match="fused_round planes"):
        packed = planes[0][:, :, None].repeat(1, 1, 3)
        ell.ell_fused_round(*args, packed, front, parent, torch.empty_like(packed))
    with pytest.raises(ValueError, match="fused_round planes"):
        ell.ell_fused_round(*args, planes, front, parent[:, :3].contiguous(), spare)
    with pytest.raises(ValueError, match="fused_round planes"):
        ell.ell_fused_round(*args, planes, front, parent, spare[:2])
    with pytest.raises(ValueError, match="frontier"):
        ell.ell_fused_round(*args, planes, front[:-1], parent, spare)
    assert ell.launches["ell_fused_round"] == before


@pytest.mark.parametrize("engine", ["fused", "packed", "hybrid"])
def test_engines_on_the_card_match_the_cpu_path(engine):
    dev = _card()
    topo = synth.random_ospf_topology(n_routers=260, n_networks=40, extra_p2p=400, seed=0)
    masks = synth.whatif_link_failure_masks(topo, 40, seed=7)
    for mi in (None, 0, 2, 5):
        ell.reset_launches()
        card = TorchSpfBackend(one_engine=engine, max_iters=mi, incremental=False)
        cpu = TorchSpfBackend(one_engine=engine, max_iters=mi, incremental=False, device="cpu")
        got = card.compute_whatif(topo, masks) + [card.compute(topo)]
        want = cpu.compute_whatif(topo, masks) + [cpu.compute(topo)]
        for i, (a, b) in enumerate(zip(got, want)):
            _same_result(a, b, f"{engine} max_iters={mi} #{i}")
        if mi != 0:
            own = ("ell_fused_round",) if engine != "hybrid" else (
                "ell_relax", "ell_first_parent", "ell_mp_round")
            assert all(ell.launches[k] > 0 for k in own), ell.launches
            assert ell.launches["ell_nh_seed"] == ell.launches["ell_nh_round"] == 0


def test_tuned_backend_on_the_card_equals_seq(tmp_path):
    from holo_tpu_torch import pipeline

    dev = _card()
    topo = synth.random_ospf_topology(n_routers=200, n_networks=30, extra_p2p=300, seed=3)
    masks = synth.whatif_link_failure_masks(topo, 16, seed=2)
    ref = TorchSpfBackend(device=dev)
    want = ref.compute_whatif(topo, masks) + [ref.compute(topo)]
    tuner = pipeline.configure_engine_tuner(path=tmp_path / "tuner.json", explore_rounds=1)
    try:
        be = TorchSpfBackend(device=dev)
        for _ in range(6):
            got = be.compute_whatif(topo, masks) + [be.compute(topo)]
            for i, (a, b) in enumerate(zip(got, want)):
                _same_result(a, b, f"tuned #{i}")
        picked = {e for (_, e, _) in tuner.stats()["decisions"]}
        assert picked == set(pipeline.tuner.ENGINES)
    finally:
        pipeline.reset_engine_tuner()


# ---------------------------------------------------------------------------
# The tropical engine: trop_relax (T1) against its plain version on every
# launch of real dispatches, at each tile size the kernel is built for and
# on both sides of its row / tile switch; the backend against the CPU path.

_TROP_SHAPES = {
    "fat_tree_k8": lambda: synth.fat_tree_topology(k=8),
    "ospf": lambda: synth.random_ospf_topology(n_routers=300, n_networks=40, extra_p2p=500,
                                               seed=4),
}


def _trop_setup(shape, block, lanes, dev):
    from holo_tpu_torch.ops import tropical as trop

    topo = _TROP_SHAPES[shape]()
    ell_ = build_ell(topo, n_atoms=64)
    host, _ = trop.build_tiles_host(ell_.in_src, ell_.in_cost, ell_.in_valid, block)
    masks = synth.whatif_link_failure_masks(topo, lanes, seed=3)
    return (topo, se.device_graph_from_ell(ell_, dev), trop.tiles_on(host, dev), masks)


def _trop_cpu(args):
    """A trop_relax call's arguments on the CPU (a RepairSet's planes too)."""
    from holo_tpu_torch.kernels import tropical as kt

    return [None if a is None else kt.RepairSet(*(x.cpu() for x in a))
            if isinstance(a, kt.RepairSet) else a.cpu() for a in args]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lanes", [1, 5, 8, 9, 33, 64, 65, 127, 129, 255, 257])
@pytest.mark.parametrize("block", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("shape", sorted(_TROP_SHAPES))
def test_trop_relax_matches_plain_on_every_launch(shape, block, lanes, masked):
    """Every launch of a real tile relax, lane counts on both sides of the
    row / tile switch (8) and of the tile form's lanes a warp (64, 128) and
    a block (64, 128, 256): ``out`` is snapshotted before the launch, equals
    ``dist`` outside the input frontier (the copy rule's precondition), and
    the outputs equal the plain round's from the snapshot; an all-ones
    frontier writes every entry of a noise buffer, the same distances."""
    from holo_tpu_torch.kernels import tropical as kt
    from holo_tpu_torch.ops import tropical as trop

    dev = _card()
    topo, g, tt, masks = _trop_setup(shape, block, lanes, dev)
    mask = se.pack_edge_masks(masks, dev) if masked else None
    roots = torch.full((lanes,), topo.root, dtype=torch.int32, device=dev)
    if not masked:  # lanes of distinct roots
        roots = torch.arange(lanes, dtype=torch.int32, device=dev) * 7 % topo.n_vertices
    kernel, held, repairs = kt.trop_relax, [], []

    def hold(tiles, cb, dist, active, out, *rest):
        front = ell._unpack(active, slice(0, lanes)).repeat_interleave(block, 0)
        assert torch.equal(out[~front], dist[~front]), len(held)
        snap = out.clone()
        got = kernel(tiles, cb, dist, active, out, *rest)
        assert got[0] is out
        want = kt.trop_relax_plain(*_trop_cpu((tiles, cb, dist, active, snap, *rest)))
        for x, y, name in zip(got, want, ("dist", "changed", "active")):
            assert torch.equal(x.cpu(), y), (name, len(held))
        full = kernel(tiles, cb, dist, ell.full_frontier(tiles.shape[0], lanes, dev),
                      torch.full_like(dist, -7), *rest)
        assert torch.equal(full[0], got[0]), len(held)
        held.append(len(held))
        repairs.append(0 if rest[0] is None else rest[0].pairs.shape[0])
        return got

    kt.trop_relax = hold
    try:
        before = dict(kt.launches)
        dist0, _ = se.distance_seed(g.in_src.shape[0], roots)
        got, rounds = trop.tile_relax(g, tt, dist0, mask)
    finally:
        kt.trop_relax = kernel
    torch.cuda.synchronize()
    assert len(held) == rounds > 1 and kt.launches["trop_relax"] - before["trop_relax"] == 2 * rounds
    assert kt.launches["trop_repair"] - before["trop_repair"] == 2 * sum(r > 0 for r in repairs)
    assert len(set(repairs)) == 1 and (masked or repairs[0] == 0)  # fixed for the fixpoint
    want = se.distance_fixpoint(se.lane_planes(g, mask), roots, g.in_src.shape[0])
    assert torch.equal(got, want)


@pytest.mark.parametrize("lanes", [1, 8, 9, 64, 257, 1024])
@pytest.mark.parametrize("block", [8, 16, 32, 64, 128])
def test_trop_geometry_is_the_tile_shape(block, lanes):
    """The library's launch geometry: the row form up to 8 lanes, above that
    a block a (row block, lanes a block) chunk; k=90's B = 8 at 1024 lanes is
    1,266 x 4 = 5,064 blocks of 64 threads, 4 lanes and 8 rows a thread."""
    from holo_tpu_torch.kernels import tropical as kt

    _card()
    nb = 1266
    geo = kt.geometry(block, lanes, nb)
    assert geo["registers"] > 0 and geo["repair_registers"] > 0 and geo["blocks_per_sm"] >= 1
    if lanes <= 8:
        assert geo["form"] == "row" and geo["blocks"] == nb
        return
    words, per = (lanes + 31) // 32, geo["lanes_a_block"] // 32
    assert geo["form"] == "tile" and geo["blocks"] == nb * -(-words // per)
    assert geo["threads"] * geo["lanes_a_thread"] * geo["rows_a_thread"] == (
        geo["lanes_a_block"] * block)
    if block == 8 and lanes == 1024:
        assert (geo["blocks"], geo["threads"], geo["lanes_a_thread"],
                geo["rows_a_thread"]) == (5064, 64, 4, 8)


def test_trop_relax_explicit_rows_match_the_device_set_on_the_card():
    from holo_tpu_torch.ops import tropical as trop

    dev = _card()
    topo, g, tt, masks = _trop_setup("ospf", None, 40, dev)
    mask = se.pack_edge_masks(masks, dev)
    roots = torch.full((40,), topo.root, dtype=torch.int32, device=dev)
    dist0, _ = se.distance_seed(g.in_src.shape[0], roots)
    rows = trop.repair_rows_host(topo.edge_dst, masks, topo.n_vertices)
    a, _ = trop.tile_relax(g, tt, dist0, mask, rows)
    b, _ = trop.tile_relax(g, tt, dist0, mask)
    assert torch.equal(a, b)
    p = se.lane_planes(g, mask)
    assert torch.equal(trop.repair_bits(p.slot, mask, 40, tt).cpu(),
                       trop.repair_bits(p.slot.cpu(), mask.cpu(), 40,
                                        trop.TropicalTiles(*(x.cpu() for x in tt))))


def test_trop_relax_refuses_bad_planes():
    from holo_tpu_torch.kernels import tropical as kt

    dev = _card()
    topo, g, tt, _ = _trop_setup("fat_tree_k8", 8, 9, dev)
    nb = tt.tiles.shape[0]
    dist = torch.zeros((tt.perm.shape[0], 9), dtype=torch.int32, device=dev)
    out = torch.zeros_like(dist)
    front = ell.full_frontier(nb, 9, dev)
    before = kt.launches["trop_relax"]
    with pytest.raises(ValueError, match="trop_relax planes"):
        kt.trop_relax(tt.tiles, tt.cb, dist[:-1], front, out[:-1])
    with pytest.raises(ValueError, match="trop_relax planes"):
        kt.trop_relax(tt.tiles, tt.cb, dist, front[:-1], out)
    with pytest.raises(ValueError, match="trop_relax planes"):
        kt.trop_relax(tt.tiles[:, :, :4, :4].contiguous(), tt.cb, dist[: nb * 4], front,
                      out[: nb * 4])
    with pytest.raises(ValueError, match="trop_relax planes"):
        kt.trop_relax(tt.tiles, tt.cb, dist, front, out[:-1])
    with pytest.raises(ValueError, match="trop_relax planes"):
        kt.trop_relax(tt.tiles, tt.cb, dist, front, dist)
    with pytest.raises(ValueError, match="one CUDA device"):
        kt.trop_relax(tt.tiles, tt.cb.cpu(), dist, front, out)
    assert kt.launches["trop_relax"] == before


def test_tropical_backend_on_the_card_matches_the_cpu_path():
    from holo_tpu_torch.kernels import tropical as kt

    dev = _card()
    topo = synth.random_ospf_topology(n_routers=260, n_networks=40, extra_p2p=400, seed=0)
    masks = synth.whatif_link_failure_masks(topo, 40, seed=7)
    roots = np.arange(0, topo.n_vertices, 23, dtype=np.int32)
    for mi in (None, 0, 2, 5):
        kt.reset_launches()
        card = TorchSpfBackend(one_engine="tropical", max_iters=mi, incremental=False)
        cpu = TorchSpfBackend(one_engine="tropical", max_iters=mi, incremental=False,
                              device="cpu")
        got = card.compute_whatif(topo, masks) + [card.compute(topo), card.compute(topo, masks[3])]
        want = cpu.compute_whatif(topo, masks) + [cpu.compute(topo), cpu.compute(topo, masks[3])]
        for i, (a, b) in enumerate(zip(got, want)):
            _same_result(a, b, f"tropical max_iters={mi} #{i}")
        a, b = card.compute_multiroot(topo, roots), cpu.compute_multiroot(topo, roots)
        for f in ("dist", "parent", "hops"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert (kt.launches["trop_relax"] > 0) == (mi != 0)
    assert not any(card.breaker.snapshot()[k] for k in ("failures", "fallbacks", "refusals"))


def test_tropical_delta_chain_on_the_card_matches_the_cpu_path():
    dev = _card()
    topo = synth.fat_tree_topology(k=24)
    card = TorchSpfBackend(one_engine="tropical")
    cpu = TorchSpfBackend(one_engine="tropical", device="cpu")
    _same_result(card.compute(topo), cpu.compute(topo), "base")
    cur = topo
    for i in range(6):
        e = (i * 97) % cur.n_edges
        nxt = synth.clone_topology(cur, cost={e: int(cur.edge_cost[e]) + 3 + i})
        nxt.link_delta(graph.diff_topologies(cur, nxt))
        _same_result(card.compute(nxt), cpu.compute(nxt), f"step {i}")
        cur = nxt
    assert card.delta_paths[("weight", "incremental")] == 6
    assert card._gather_cache.tile_deltas == {"apply": 6} == cpu._gather_cache.tile_deltas
    assert card._gather_cache.get_tropical(cur, 64).tiles.device.type == dev.type


# ---------------------------------------------------------------------------
# The tropical multipath program: trop_count_round (T2) against its plain
# version on every launch of real dispatches at each tile size, and on
# seeded carries at lane counts on both sides of its row / lane switch; the
# backend's mp_tropical against the CPU path.

_MP_FIELDS = ("parents", "pdist", "pweight", "npaths", "nh_weights")


def _trop_count_holding(kernel, held):
    """A trop_count_round that holds each launch to the plain version on CPU
    copies of its inputs (out written whole, the changed flag), and its
    count list to count_list's on the CPU."""
    from holo_tpu_torch.kernels import tropical as kt

    def hold(cnt, cb, listed, x, seed, out, root=-1):
        got = kernel(cnt, cb, listed, x, seed, out, root)
        assert got[0] is out
        want_list = kt.count_list(cnt.cpu(), cb.cpu())
        assert torch.equal(listed.n.cpu(), want_list.n), len(held)
        for rb, n in enumerate(want_list.n.tolist()):
            assert torch.equal(listed.slots[rb, :n].cpu(), want_list.slots[rb, :n]), rb
        want = kt.trop_count_plain(cnt.cpu(), cb.cpu(), None, x.cpu(),
                                   None if seed is None else seed.cpu(),
                                   torch.full_like(x, -3).cpu(), root)
        for a, b, name in zip(got, want, ("out", "changed")):
            assert torch.equal(a.cpu(), b), (name, len(held), x.shape[1])
        held.append(x.shape[1])
        return got

    return hold


@pytest.mark.parametrize("block", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("shape", sorted(_TROP_SHAPES))
def test_trop_count_matches_plain_on_every_launch(shape, block):
    """Every T2 launch of a masked multipath dispatch at kp 4 (the path
    counts at one lane, the weights at 32 W) equals the plain round; the
    planes equal the CPU path's."""
    from holo_tpu_torch.kernels import tropical as kt
    from holo_tpu_torch.ops import tropical as trop

    dev = _card()
    topo, g, tt, masks = _trop_setup(shape, block, 2, dev)
    assert not masks[1].all()
    kernel, held = kt.trop_count_round, []
    kt.trop_count_round = _trop_count_holding(kernel, held)
    try:
        before = kt.launches["trop_count"]
        got = trop.tropical_spf_one_multipath(g, tt, topo.root, 4, masks[1])
    finally:
        kt.trop_count_round = kernel
    torch.cuda.synchronize()
    assert len(held) == kt.launches["trop_count"] - before > 2
    assert set(held) == {1, 32 * g.direct_nh_words.shape[2]}
    cpu = trop.tropical_spf_one_multipath(
        se.DeviceGraph(*(x.cpu() for x in g)), trop.TropicalTiles(*(x.cpu() for x in tt)),
        topo.root, 4, masks[1])
    for a, b in zip(got, cpu):
        for f in a._fields:
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f


@pytest.mark.parametrize("lanes", [1, 2, 8, 9, 32, 33, 64, 65, 257])
@pytest.mark.parametrize("block", [8, 16, 32, 64, 128])
def test_trop_count_matches_plain_on_seeded_carries(block, lanes):
    """Carries drawn up to MP_SAT (a quarter at MP_SAT - 1, so sums clamp),
    with and without a seed plane and a root row, on the count tiles of every
    valid slot, counts multiplied by 1-3 (parallel slots count 2 already),
    one row block emptied and a padding slot of junk counts appended (the
    list leaves it out, the plain round ignores it); lane counts on both
    sides of the row / lane switch (8) and of the lane form's lanes a block
    (32, 64)."""
    from holo_tpu_torch.kernels import tropical as kt
    from holo_tpu_torch.ops import tropical as trop

    dev = _card()
    _, g, tt, _ = _trop_setup("ospf", block, 1, dev)
    rng = np.random.default_rng(block + lanes)
    cnt = trop.count_tiles(g.in_src, tt, g.in_valid)
    nb, _, b, _ = cnt.shape
    cnt = cnt * torch.from_numpy(rng.integers(1, 4, tuple(cnt.shape)).astype(np.int32)).to(dev)
    empty = int(rng.integers(0, nb))
    cnt[empty] = 0
    junk = torch.from_numpy(rng.integers(1, 4, (nb, 1, b, b)).astype(np.int32)).to(dev)
    cnt = torch.cat([cnt, junk], 1).contiguous()
    cb = torch.cat([tt.cb, torch.full((nb, 1), nb, dtype=torch.int32, device=dev)], 1)
    cb = cb.contiguous()
    listed = kt.count_list(cnt, cb)
    assert int(listed.n[empty]) == 0 and int(cnt.max()) >= 3
    npad = tt.perm.shape[0]

    def carry():
        x = np.where(rng.random((npad, lanes)) < 0.25, kt.MP_SAT - 1,
                     rng.integers(0, kt.MP_SAT, (npad, lanes)))
        x[tt.inv.shape[0]:] = 0
        return torch.from_numpy(x.astype(np.int32)).to(dev)

    x = carry()
    for seed, root in ((None, 3), (carry(), -1), (None, -1)):
        out = torch.full_like(x, -9)
        got = kt.trop_count_round(cnt, cb, listed, x, seed, out, root)
        want = kt.trop_count_plain(cnt.cpu(), cb.cpu(), None, x.cpu(),
                                   None if seed is None else seed.cpu(),
                                   torch.empty_like(x).cpu(), root)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        assert int(got[0].max()) == kt.MP_SAT
        again = kt.trop_count_round(cnt, cb, listed, x, seed, torch.empty_like(x), root)
        assert torch.equal(again[0], got[0])  # no atomics in the sum: the same bits


@pytest.mark.parametrize("lanes", [1, 8, 9, 64, 257])
@pytest.mark.parametrize("block", [8, 16, 32, 64, 128])
def test_trop_count_geometry_is_the_lane_shape(block, lanes):
    """T2's launch geometry: the row form up to 8 lanes (a block a row block,
    a warp 8 rows), above that a block a (row block, lanes a block) chunk, a
    thread R rows of one lane; k=90's B = 8 at 64 lanes is 1,266 blocks of
    128 threads, 4 rows a thread."""
    from holo_tpu_torch.kernels import tropical as kt

    _card()
    nb = 1266
    geo = kt.count_geometry(block, lanes, nb)
    assert geo["registers"] > 0 and geo["blocks_per_sm"] >= 1
    if lanes <= 8:
        assert geo["form"] == "row" and geo["blocks"] == nb
        assert geo["threads"] % (32 * block // 8) == 0 and geo["rows_a_thread"] == 8
        return
    assert geo["form"] == "lane" and geo["blocks"] == nb * -(-lanes // geo["lanes_a_block"])
    assert geo["threads"] * geo["rows_a_thread"] == geo["lanes_a_block"] * block
    assert geo["shared_bytes"] >= 4 * geo["pairs_a_pass"] * (block + geo["lanes_a_block"])
    assert geo["tiles_a_chunk"] * block == 512
    if block == 8 and lanes == 64:
        assert (geo["blocks"], geo["threads"], geo["rows_a_thread"]) == (1266, 128, 4)


def test_trop_count_refuses_bad_planes():
    from holo_tpu_torch.kernels import tropical as kt
    from holo_tpu_torch.ops import tropical as trop

    dev = _card()
    _, g, tt, _ = _trop_setup("fat_tree_k8", 8, 1, dev)
    cnt = trop.count_tiles(g.in_src, tt, g.in_valid)
    listed = kt.count_list(cnt, tt.cb)
    x = torch.zeros((tt.perm.shape[0], 2), dtype=torch.int32, device=dev)
    before = kt.launches["trop_count"]
    for args in ((cnt, tt.cb, listed, x[:-1], None, x[:-1].clone()),
                 (cnt, tt.cb, listed, x, None, x),
                 (cnt, tt.cb, listed, x, x[:, :1].contiguous(), x.clone()),
                 (cnt, tt.cb[:, :-1].contiguous(), listed, x, None, x.clone()),
                 (cnt[:, :, :4, :4].contiguous(), tt.cb, listed, x, None, x.clone()),
                 (cnt, tt.cb, None, x, None, x.clone()),
                 (cnt, tt.cb, kt.CountList(listed.slots[:, :-1].contiguous(), listed.n), x, None,
                  x.clone()),
                 (cnt, tt.cb, kt.CountList(listed.slots, listed.n[:-1].contiguous()), x, None,
                  x.clone())):
        with pytest.raises(ValueError, match="trop_count planes"):
            kt.trop_count_round(*args)
    with pytest.raises(ValueError, match="trop_count planes"):
        kt.trop_count_round(cnt, tt.cb, listed, x, None, x.clone(), x.shape[0])
    with pytest.raises(ValueError, match="one CUDA device"):
        kt.trop_count_round(cnt, tt.cb.cpu(), listed, x, None, x.clone())
    with pytest.raises(ValueError, match="one CUDA device"):
        kt.trop_count_round(cnt, tt.cb, kt.CountList(*(p.cpu() for p in listed)), x, None,
                            x.clone())
    assert kt.launches["trop_count"] == before


def test_tropical_multipath_backend_on_the_card_matches_the_cpu_path():
    """mp_tropical on the card: compute at kp 2, 4 and 8 (masked too), under
    max_iters None, 1 and 2, and a DeltaPath chain at kp 4 (tiles updated in
    place), equal to the CPU path on all nine planes, T2 launched."""
    from holo_tpu_torch.kernels import tropical as kt

    dev = _card()
    topo = synth.random_ospf_topology(n_routers=260, n_networks=40, extra_p2p=400, max_cost=4,
                                      seed=0)
    masks = synth.whatif_link_failure_masks(topo, 4, seed=7)

    def same(a, b, label):
        _same_result(a, b, label)
        for f in _MP_FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{label} {f}")

    for mi in (None, 1, 2):
        kt.reset_launches()
        card = TorchSpfBackend(one_engine="tropical", max_iters=mi, incremental=False)
        cpu = TorchSpfBackend(one_engine="tropical", max_iters=mi, incremental=False,
                              device="cpu")
        for k in (2, 4, 8):
            same(card.compute(topo, multipath_k=k), cpu.compute(topo, multipath_k=k),
                 f"k={k} max_iters={mi}")
        same(card.compute(topo, masks[2], multipath_k=4), cpu.compute(topo, masks[2],
                                                                      multipath_k=4),
             f"masked max_iters={mi}")
        assert kt.launches["trop_count"] > 0 and kt.launches["trop_relax"] > 0
    card = TorchSpfBackend(one_engine="tropical")
    cpu = TorchSpfBackend(one_engine="tropical", device="cpu")
    same(card.compute(topo, multipath_k=4), cpu.compute(topo, multipath_k=4), "base")
    cur = topo
    for i in range(5):
        e = (i * 97) % cur.n_edges
        nxt = synth.clone_topology(cur, cost={e: int(cur.edge_cost[e]) + 2 + i})
        nxt.link_delta(graph.diff_topologies(cur, nxt))
        same(card.compute(nxt, multipath_k=4), cpu.compute(nxt, multipath_k=4), f"step {i}")
        cur = nxt
    assert card.delta_paths[("weight", "incremental")] == 5
    assert card._gather_cache.tile_deltas == {"apply": 5} == cpu._gather_cache.tile_deltas
    assert not any(card.breaker.snapshot()[k] for k in ("failures", "fallbacks", "refusals"))


# -- the dispatch pipeline and the split-phase dispatch on the card


def _same_nine(a, b, label):
    _same_result(a, b, label)
    for f in _MP_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), (label, f)
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f"{label} {f}")


@pytest.mark.parametrize("engine", ["seq", "fused", "tropical"])
def test_pipeline_launch_one_on_the_card_matches_the_cpu_path(engine):
    """launch_one / finish_one and the pipeline on the card equal the CPU
    path: full, masked, multipath, and a delta chain submitted ahead; the
    FRR table through AsyncFrrEngine too."""
    from holo_tpu_torch.frr.manager import FrrEngine
    from holo_tpu_torch.pipeline import AsyncFrrEngine, AsyncSpfBackend, DispatchPipeline

    dev = _card()
    topo = synth.random_ospf_topology(n_routers=120, n_networks=20, extra_p2p=200, seed=3)
    mask = synth.whatif_link_failure_masks(topo, 1, seed=4)[0]
    card = TorchSpfBackend(one_engine=engine, device=dev)
    cpu = TorchSpfBackend(one_engine=engine, device="cpu")
    for args, kw in (((), {}), ((mask,), {}), ((), {"multipath_k": 4})):
        h = card.launch_one(topo, *args, **kw)
        _same_nine(card.finish_one(h), cpu.compute(topo, *args, **kw), f"{engine} {kw} direct")
    chain, cur = [], topo
    for i in range(4):
        e = (i * 53) % cur.n_edges
        nxt = synth.clone_topology(cur, cost={e: int(cur.edge_cost[e]) + 3 + i})
        nxt.link_delta(graph.diff_topologies(cur, nxt))
        chain.append(nxt)
        cur = nxt
    pipe = DispatchPipeline(depth=2)
    try:
        inner = TorchSpfBackend(one_engine=engine, device=dev)
        abe = AsyncSpfBackend(inner, pipe)
        afe = AsyncFrrEngine(FrrEngine("torch", device=dev), pipe)
        lazies = [abe.compute(t) for t in (topo, *chain)]
        lazies.append(abe.compute(topo, multipath_k=4))
        table = afe.compute(topo)
        ref = TorchSpfBackend(one_engine=engine, device="cpu")
        for i, (t, lazy) in enumerate(zip((topo, *chain), lazies)):
            _same_result(lazy._ticket.result(timeout=120), ref.compute(t), f"{engine} step {i}")
        _same_nine(lazies[-1]._ticket.result(timeout=120), cpu.compute(topo, multipath_k=4),
                   f"{engine} pipelined multipath")
        want = FrrEngine("torch", device="cpu").compute(topo)
        got = table._ticket.result(timeout=120)
        from holo_tpu_torch.frr.kernel import TABLE_PLANES
        for f in TABLE_PLANES:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        st = pipe.stats()
    finally:
        pipe.close()
    assert st["max-inflight-per-key"] <= 1 and st["completed"] == len(lazies) + 1
    assert inner.delta_paths[("weight", "incremental")] == len(chain)
    assert not any(inner.breaker.snapshot()[k] for k in ("failures", "fallbacks", "refusals"))


@pytest.mark.parametrize("phase", ["launch", "finish"])
def test_pipeline_crash_on_the_card_reraises_and_never_serves_the_oracle(phase):
    """The card rule: a pipelined dispatch that fails on the card, at launch
    (the spf.dispatch crashpoint) or at finish, re-raises when its result is
    read, counted by the breaker, with no fallback; the open circuit then
    refuses."""
    from holo_tpu_torch.pipeline import AsyncSpfBackend, DispatchPipeline
    from holo_tpu_torch.resilience.breaker import CircuitBreaker, CircuitOpen
    from holo_tpu_torch.resilience.faults import FaultInjector, FaultPlan, InjectedFault, inject

    dev = _card()
    topo = synth.random_ospf_topology(n_routers=60, n_networks=10, extra_p2p=80, seed=5)
    br = CircuitBreaker(f"card-pipeline-{phase}", failure_threshold=1, recovery_timeout=1e9)
    inner = TorchSpfBackend(device=dev, breaker=br)
    assert not inner.fallback_serves()
    pipe = DispatchPipeline(depth=2)
    try:
        abe = AsyncSpfBackend(inner, pipe)
        if phase == "finish":
            def boom(h):
                raise RuntimeError("device lost in the finish")
            inner.finish_one = boom
            res, err = abe.compute(topo), RuntimeError
        else:
            with inject(FaultInjector(FaultPlan(dispatch_fail={"spf.dispatch": 1}))):
                res = abe.compute(topo)
                pipe.drain(timeout=120)
            err = InjectedFault
        with pytest.raises(err):
            _ = res.dist
        with pytest.raises(CircuitOpen):
            abe.compute(topo)
    finally:
        pipe.close()
    snap = br.snapshot()
    assert snap["failures"] == {"exception": 1} and snap["refusals"] == {"open": 1}
    assert not snap["fallbacks"]


def test_make_spf_mesh_takes_the_cards_and_raises_with_none(monkeypatch):
    """With no device list the mesh is laid over every visible card; with no
    card visible it raises, never dropping to the CPU."""
    from holo_tpu_torch.parallel import mesh as pm

    _card()
    mesh = pm.make_spf_mesh()
    assert mesh.shape == {"batch": torch.cuda.device_count(), "node": 1}
    assert [str(d) for d in mesh.devices.flat] == [
        f"cuda:{i}" for i in range(torch.cuda.device_count())]
    assert pm.virtual_devices(2) == [torch.device("cuda", torch.cuda.current_device())] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.make_spf_mesh()
    assert pm.process_mesh() is None


@pytest.mark.parametrize("site", ["spf.shard", "frr.shard"])
def test_mesh_on_the_card_matches_the_cpu_and_a_shard_failure_reraises(site):
    """A virtual (2, 2) mesh over the card: the what-if, multi-root and FRR
    dispatches equal the CPU path with no mesh; an injected shard failure is
    counted by the breaker and re-raises (the oracle never serves on the
    card), and the open circuit then refuses."""
    from holo_tpu_torch.frr.kernel import TABLE_PLANES
    from holo_tpu_torch.frr.manager import FrrEngine
    from holo_tpu_torch.parallel import mesh as pm
    from holo_tpu_torch.resilience.breaker import CircuitBreaker, CircuitOpen
    from holo_tpu_torch.resilience.faults import FaultInjector, FaultPlan, InjectedFault, inject

    dev = _card()
    topo = synth.random_ospf_topology(n_routers=60, n_networks=11, extra_p2p=80, seed=5)
    masks = synth.whatif_link_failure_masks(topo, 37, seed=6)
    roots = [0, 5, 9]
    cpu = TorchSpfBackend(device="cpu")
    want = cpu.compute_whatif(topo, masks)
    want_mr = cpu.compute_multiroot(topo, roots)
    want_frr = FrrEngine("torch", device="cpu").compute(topo)
    br = CircuitBreaker(f"card-mesh-{site}", failure_threshold=1, recovery_timeout=1e9)
    card = TorchSpfBackend(device=dev, breaker=br)
    eng = FrrEngine("torch", device=dev, breaker=br)
    pm.configure_process_mesh(2, 2, pm.virtual_devices(4))
    try:
        assert not card.fallback_serves() and not eng.fallback_serves()
        for i, (g, w) in enumerate(zip(card.compute_whatif(topo, masks), want)):
            _same_result(g, w, f"mesh whatif {i}")
        got_mr = card.compute_multiroot(topo, roots)
        for f in ("dist", "parent", "hops"):
            np.testing.assert_array_equal(getattr(got_mr, f), getattr(want_mr, f), err_msg=f)
        got = eng.compute(topo)
        for f in TABLE_PLANES:
            np.testing.assert_array_equal(getattr(got, f), getattr(want_frr, f), err_msg=f)
        assert card.shard_dispatches == {"whatif": 1, "multiroot": 1}
        assert eng.shard_dispatches == {"frr": 1}
        call = ((lambda: card.compute_whatif(topo, masks)) if site == "spf.shard"
                else (lambda: eng.compute(topo)))
        with inject(FaultInjector(FaultPlan(dispatch_fail={site: 1}))):
            with pytest.raises(InjectedFault):
                call()
        with pytest.raises(CircuitOpen):
            call()
    finally:
        pm.reset_process_mesh()
    snap = br.snapshot()
    assert snap["failures"] == {"exception": 1} and snap["refusals"] == {"open": 1}
    assert not snap["fallbacks"]


# -- telemetry and runtime checks on the card


def test_sanitizer_raises_on_an_unsanctioned_sync_and_passes_a_sanctioned_one():
    from holo_tpu_torch import testing
    from holo_tpu_torch.analysis import runtime

    dev = _card()
    t = torch.ones(4, device=dev)
    before = runtime.sanctioned_counts().get("card.test", 0)
    with testing.no_implicit_transfers():
        with pytest.raises(RuntimeError, match="synchroniz"):
            t.sum().item()
        with runtime.sanctioned_transfer("card.test"):
            assert t.sum().item() == 4.0
        assert runtime.read_flag("card.flag", (t > 0).any()) is True
    assert torch.cuda.get_sync_debug_mode() == 0
    assert runtime.sanctioned_counts()["card.test"] == before + 1


def test_sanitizer_windows_on_two_threads_keep_the_mode():
    """Thread A holds a window open across thread B's whole window: A's
    sync inside still passes, and after both close an unsanctioned sync
    raises again."""
    import threading

    from holo_tpu_torch import testing
    from holo_tpu_torch.analysis import runtime

    dev = _card()
    t = torch.ones(4, device=dev)
    a_open, b_done = threading.Event(), threading.Event()
    seen = {}

    def a():
        with runtime.sanctioned_transfer("card.a"):
            a_open.set()
            b_done.wait(10.0)
            seen["a"] = t.sum().item()

    with testing.no_implicit_transfers():
        th = threading.Thread(target=a)
        th.start()
        a_open.wait(10.0)
        with runtime.sanctioned_transfer("card.b"):
            seen["b"] = t.sum().item()
        b_done.set()
        th.join(10.0)
        with pytest.raises(RuntimeError, match="synchroniz"):
            t.sum().item()
    assert seen == {"a": 4.0, "b": 4.0}


def test_device_stage_on_events_is_at_most_its_dispatch_wall():
    from holo_tpu_torch.telemetry import profiling

    dev = _card()
    topo = synth.fat_tree_topology(k=8)
    be = TorchSpfBackend(device=dev)
    be.compute(topo)  # the kernel library and the marshal
    masks = synth.whatif_link_failure_masks(topo, 64, seed=1)
    profiling.set_device_profiling(True)
    n0, e0 = len(profiling.settled()), profiling.event_records()
    try:
        be.compute(topo, masks[1])
        be.compute_whatif(topo, masks)
        be.finish_one(be.launch_one(topo))
    finally:
        profiling.set_device_profiling(False)
    rows = profiling.settled()[n0:]
    assert [r[0] for r in rows] == ["spf.one", "spf.whatif", "spf.one"]
    assert profiling.event_records() - e0 == 6
    for site, _dev, dt, _host, wall in rows:
        assert 0 < dt <= wall, (site, dt, wall)


def test_disarmed_dispatch_records_no_event():
    from holo_tpu_torch.telemetry import profiling

    dev = _card()
    topo = synth.fat_tree_topology(k=8)
    be = TorchSpfBackend(device=dev)
    assert not profiling.device_profiling()
    e0, n0 = profiling.event_records(), len(profiling.settled())
    be.compute(topo)
    be.compute_whatif(topo, synth.whatif_link_failure_masks(topo, 8, seed=2))
    be.compute_multiroot(topo, np.arange(4, dtype=np.int32))
    assert profiling.event_records() == e0
    assert len(profiling.settled()) == n0
