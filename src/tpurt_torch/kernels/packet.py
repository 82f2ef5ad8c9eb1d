"""tpurt's packet engine (``method="packet"``): closest-hit, any-hit and
k-nearest walks of 1,024-ray packets over the packed layout (counterpart of
``traverse_packet``, ``occluded_packet`` and ``k_nearest_ids_packet`` in
``tpurt/accel/packet.py``).

``traverse_packet``, ``occluded_packet`` and ``k_nearest_ids_packet`` launch
the hand-written CUDA kernels in ``csrc/packet.cu`` (``packet_closest``,
``packet_occluded``, ``packet_knear``) for CUDA tensors and run their
plain-torch twins, ``traverse_packet_ref``, ``occluded_packet_ref`` and
``k_nearest_ids_packet_ref``, for CPU tensors.  There is no other route: a
CUDA tensor either reaches its kernel or the call raises.

The packet is part of the function, which is why no other engine gives
these results.  The rays are flattened and zero-padded to a multiple of
PACKET_RAYS; packet p is rays [1024 p, 1024 p + 1024).  A packet walks the
escape chain with one cursor from node 0: a node is wanted when any ray of
the packet passes its slab test against its own bound (the best hit's t for
the closest hit, t_max for the any-hit walk, min(k-th t, t_max) for the k
nearest), a wanted internal node moves the cursor to node + 1, anything
else to its escape link, and -1 ends the walk.  A wanted leaf's LEAF_CAP
triangles are tested against all 1,024 rays, whatever each ray's own slab
test said, so a ray can be hit through a neighbour: a direction component
in [-1e-30, 0) (whose inverse is 0, so its own slab tests all fail) and a
band hit outside the ray's own inflated box.  The pad rays (o = d = 0) vote
too: for the closest hit their bound is T_MAX, so they want every box that
holds the origin; the any-hit and k-nearest walks pad t_max with 0, so they
never do, and a padded packet's any-hit walk never ends early (it ends once
all 1,024 rays are blocked).

The twins step all packets in lockstep: a cursor per packet, the node
records gathered for the live packets and a (packets x 1,024) slab test a
step, a leaf's 8 slots tested together against the packets' rays and
merged by tpurt's selections, whose outcome the order of the slots does not
change (a leaf holds each triangle once).  Built without FMA contraction,
kernels and twins agree bit for bit.  Given a
``stats`` dict, a twin counts its walk in packet units (node visits, leaf
visits, distinct nodes and leaves; traverse8.walk_counts reads it): each
visit is 1,024 slab tests, each leaf visit 1,024 x LEAF_CAP triangle tests.

A walk's last steps, once few packets are left, cost the host a few hundred
launches a node while the card idles.  On the card the twins therefore take
their last TAIL_PACKETS packets in fixed-shape steps: every such packet
steps each time, a mask keeps a finished packet and a packet that enters no
leaf from changing anything, and TAIL_STEPS steps at a time replay as one
CUDA graph.  Each packet still meets the same nodes and leaves in the same
order, so the outputs and counts are bit for bit those of the compacting
loop (``tail=`` forces the masked steps, without a graph, on the CPU).
"""

from __future__ import annotations

import ctypes

import torch

from tpurt_torch.accel.intersect import DEFAULT_T_MIN, DET_EPS
from tpurt_torch.accel.packet import LEAF_CAP, PackedBVH
from tpurt_torch.accel.traverse_ref import BIG_ID, _tmax_flat, safe_inv
from tpurt_torch.core.geometry import Hit, Rays, T_MAX
from tpurt_torch.kernels import _build
from tpurt_torch.kernels._build import ptr as _ptr, stream as _stream
from tpurt_torch.kernels.traverse import _check_inputs, _packed_args, _raise_on

# Kernel launches per wrapper since the last reset_launches(); only a real
# CUDA launch counts.
LAUNCHES = {"packet_closest": 0, "packet_occluded": 0, "packet_knear": 0}
# Rays a packet (tpurt's PACKET_RAYS: an (8, 128) tile on the TPU, a thread
# block of 512 threads of 2 rays here).
PACKET_RAYS = 1024
# Largest k of the k-nearest kernel (its longest list).
KMAX = 16


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain-torch twins
# ---------------------------------------------------------------------------
class Packets:
    """Flat rays zero-padded to whole packets: o, d, inv (P, 1024, 3) and,
    given t_max, tm (P, 1024) padded with 0 (tpurt's pad); n real rays."""

    def __init__(self, rays: Rays, t_max=None):
        o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
        self.n = o.shape[0]
        pad = (-self.n) % PACKET_RAYS
        o, d = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (o, d))
        self.p = o.shape[0] // PACKET_RAYS
        self.o = o.reshape(self.p, PACKET_RAYS, 3)
        self.d = d.reshape(self.p, PACKET_RAYS, 3)
        self.inv = safe_inv(self.d)
        if t_max is not None:
            tm = torch.nn.functional.pad(_tmax_flat(rays, t_max), (0, pad))
            self.tm = tm.reshape(self.p, PACKET_RAYS)

    def flat(self, x: torch.Tensor) -> torch.Tensor:
        """(P, 1024, ...) -> the n real rays' (n, ...)."""
        return x.reshape(self.p * PACKET_RAYS, *x.shape[2:])[:self.n]


def _slab(o, inv, box, t_min, upper):
    """tpurt's packet _slab: rays (L, 1024, 3) against one box (L, 6) a
    packet, bound upper (L, 1024) -> (L, 1024) pass mask."""
    t0 = (box[:, None, 0:3] - o) * inv
    t1 = (box[:, None, 3:6] - o) * inv
    t_near = torch.maximum(torch.minimum(t0, t1).amax(dim=-1), t_min)
    t_far = torch.minimum(torch.maximum(t0, t1).amin(dim=-1), upper)
    return t_near <= t_far


def _cross(a, b):
    """a x b over the last axis of broadcast 3-vectors, in tpurt's order:
    (a_y b_z - a_z b_y, a_z b_x - a_x b_z, a_x b_y - a_y b_x)."""
    ay, az = a.roll(-1, -1), a.roll(1, -1)  # (a_y, a_z, a_x), (a_z, a_x, a_y)
    by, bz = b.roll(-1, -1), b.roll(1, -1)
    return ay * bz - az * by


def _dot(a, b):
    """(a_x b_x + a_y b_y) + a_z b_z over the last axis, in tpurt's order."""
    ab = a * b
    return (ab[..., 0] + ab[..., 1]) + ab[..., 2]


def _mt(o, d, tri):
    """Möller–Trumbore of rays (S, 1024, 3) against (S, 8, 9) triangles
    (v0, e1, e2) in tpurt's _mt_packet order -> t, u, v, det (S, 1024, 8):
    each of the (S, 1024, 8) pairs' 3-vectors on a last axis of 3."""
    v0, e1, e2 = (tri[:, None, :, 3 * i:3 * i + 3] for i in range(3))
    o, d = o[:, :, None], d[:, :, None]
    p = _cross(d, e2)
    det = _dot(e1, p)
    inv_det = det / (det * det + DET_EPS)
    tv = o - v0
    u = _dot(tv, p) * inv_det
    q = _cross(tv, e1)
    v = _dot(d, q) * inv_det
    t = _dot(e2, q) * inv_det
    return t, u, v, det


# Packets left when a twin on the card turns to its masked steps, and the
# steps a CUDA graph replays at once.
TAIL_PACKETS = 64
TAIL_STEPS = 32


def packet_walk(pk: Packets, packed: PackedBVH, t_min: float, upper, on_leaf, voters=None,
                done=None, stats: dict | None = None, tail: int | None = None) -> None:
    """All packets' walks in lockstep, one node a step each.  upper(live) is
    each ray's bound (L, 1024) at the start of the visit, voters(live) the
    rays that may vote (None: all), on_leaf(sel, o, d, tri, tid, mask) tests
    the wanted leaves' (S, 8, 9) triangles with ids (S, 8) against all rays
    of packets sel (mask: the packets of sel that entered their leaf; None:
    all), and done(live) ends packets before a visit.  tail: the packets
    left at which the masked steps take over (default TAIL_PACKETS on the
    card, none on the CPU)."""
    box = packed.node_f32[:, :6]
    escape = packed.node_i32[:, 0].long()
    is_leaf = packed.node_i32[:, 3] > 0
    leaf_row = packed.node_i32[:, 1].long()
    rows = packed.tri_rows[:, :LEAF_CAP * 9].unflatten(1, (LEAF_CAP, 9))
    dev = pk.o.device
    tmin = torch.tensor(t_min, dtype=torch.float32, device=dev)
    node = torch.zeros(pk.p, dtype=torch.int64, device=dev)
    live = torch.arange(pk.p, device=dev)
    if stats is not None and "visits" not in stats:
        stats.update(visits=0, rows=torch.zeros((), dtype=torch.int64, device=dev),
                     seen_nodes=torch.zeros(box.shape[0], dtype=torch.bool, device=dev),
                     seen_rows=torch.zeros(rows.shape[0], dtype=torch.bool, device=dev))
    if tail is None:
        tail = TAIL_PACKETS if dev.type == "cuda" else 0
    while live.numel():
        if done is not None:
            live = live[~done(live)]
            if not live.numel():
                break
        if live.numel() <= tail:
            _masked_walk(pk, packed, live, node, tmin, upper, on_leaf, voters, done, stats)
            return
        nd = node[live]
        boxed = _slab(pk.o[live], pk.inv[live], box[nd], tmin, upper(live))
        if voters is not None:
            boxed &= voters(live)
        want = boxed.any(dim=1)
        leaf = is_leaf[nd]
        enter = want & leaf
        nxt = torch.where(want & ~leaf, nd + 1, escape[nd])
        keep = nxt >= 0
        # one host sync a step: both masks' counts at once
        n_enter, n_keep = torch.stack([enter.sum(), keep.sum()]).tolist()
        pos = torch.nonzero_static(enter, size=n_enter)[:, 0]
        r = leaf_row[nd[pos]]
        if stats is not None:
            stats["visits"] += live.numel()
            stats["seen_nodes"][nd] = True
            stats["rows"] += n_enter
            stats["seen_rows"][r] = True
        if n_enter:
            sel = live[pos]
            on_leaf(sel, pk.o[sel], pk.d[sel], rows[r], packed.tri_ids[r], None)
        node[live] = nxt
        live = live[torch.nonzero_static(keep, size=n_keep)[:, 0]]


def _masked_walk(pk: Packets, packed: PackedBVH, live: torch.Tensor, node: torch.Tensor,
                 tmin: torch.Tensor, upper, on_leaf, voters, done, stats) -> None:
    """packet_walk's steps for the packets `live`, in fixed shapes: a packet
    steps while its cursor is >= 0 and done() does not end it, and only a
    stepping packet that wants a leaf enters it (on_leaf's mask).  On the
    card TAIL_STEPS steps replay as one CUDA graph (a finished walk's steps
    change nothing); the live packets are compacted, and the graph made
    again, once at most a quarter of them still step."""
    box = packed.node_f32[:, :6]
    escape = packed.node_i32[:, 0].long()
    is_leaf = packed.node_i32[:, 3] > 0
    leaf_row = packed.node_i32[:, 1].long()
    rows = packed.tri_rows[:, :LEAF_CAP * 9].unflatten(1, (LEAF_CAP, 9))
    dev = pk.o.device
    n_nodes, n_rows = box.shape[0], rows.shape[0]
    if stats is not None:
        # one slot past the end takes the marks of packets that do not count
        visits = torch.zeros((), dtype=torch.int64, device=dev)
        seen_nodes = torch.zeros(n_nodes + 1, dtype=torch.bool, device=dev)
        seen_rows = torch.zeros(n_rows + 1, dtype=torch.bool, device=dev)
        true = torch.ones((), dtype=torch.bool, device=dev)  # no host copy in a graph

    def stepping(live):
        act = node[live] >= 0
        return act if done is None else act & ~done(live)

    def step(live):
        act = stepping(live)
        nd_raw = node[live]
        nd = torch.clamp_min(nd_raw, 0)
        boxed = _slab(pk.o[live], pk.inv[live], box[nd], tmin, upper(live))
        if voters is not None:
            boxed &= voters(live)
        want = boxed.any(dim=1) & act
        leaf = is_leaf[nd]
        enter = want & leaf
        r = torch.where(enter, leaf_row[nd], 0)
        if stats is not None:
            visits.add_(act.sum())
            seen_nodes.index_put_((torch.where(act, nd, n_nodes),), true)
            stats["rows"] += enter.sum()
            seen_rows.index_put_((torch.where(enter, r, n_rows),), true)
        on_leaf(live, pk.o[live], pk.d[live], rows[r], packed.tri_ids[r], enter)
        node[live] = torch.where(act, torch.where(want & ~leaf, nd + 1, escape[nd]), nd_raw)

    while True:
        act = stepping(live)
        n_act = int(act.sum())
        if not n_act:
            break
        if 4 * n_act <= live.numel():
            live = live[act]
        if dev.type == "cuda":
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                step(live)  # a real step, which also warms the graph's kernels
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(graph):
                for _ in range(TAIL_STEPS):
                    step(live)
            while bool(stepping(live).any()):
                graph.replay()
                if 4 * int(stepping(live).sum()) <= live.numel():
                    break
            del graph
        else:
            for _ in range(TAIL_STEPS):
                step(live)
    if stats is not None:
        stats["visits"] += int(visits)
        stats["seen_nodes"] |= seen_nodes[:n_nodes]
        stats["seen_rows"] |= seen_rows[:n_rows]


def traverse_packet_ref(rays: Rays, packed: PackedBVH, t_min: float = DEFAULT_T_MIN,
                        stats: dict | None = None) -> Hit:
    """Plain-torch twin of packet_closest; same returns as traverse_packet."""
    pk = Packets(rays)
    shape = (pk.p, PACKET_RAYS)
    dev = pk.o.device
    tb = torch.full(shape, T_MAX, dtype=torch.float32, device=dev)
    ub = torch.zeros(shape, dtype=torch.float32, device=dev)
    vb = torch.zeros_like(ub)
    ib = torch.full(shape, -1, dtype=torch.int32, device=dev)

    def on_leaf(sel, o, d, tri, tid, mask):
        # tpurt's slot-by-slot `better` chain keeps the lexicographic (t, id)
        # minimum of the best so far and the accepted candidates (a leaf
        # holds each triangle once), taken here at once
        t, u, v, det = _mt(o, d, tri)
        idb = tid[:, None, :]
        ok = ((det.abs() > DET_EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t > t_min) & (idb >= 0))
        tm = torch.where(ok, t, float("inf")).amin(dim=-1, keepdim=True)
        cand = ok & (t == tm)
        im = torch.where(cand, idb, BIG_ID).amin(dim=-1, keepdim=True)
        j = (cand & (idb == im)).int().argmax(dim=-1, keepdim=True)
        bt, bi = tb[sel], ib[sel]
        tk, ik = tm[..., 0], im[..., 0]
        better = ok.any(dim=-1) & ((tk < bt) | ((tk == bt) & (ik < bi) & (bi >= 0)))
        if mask is not None:
            better = better & mask[:, None]
        tb[sel] = torch.where(better, tk, bt)
        ub[sel] = torch.where(better, u.gather(-1, j)[..., 0], ub[sel])
        vb[sel] = torch.where(better, v.gather(-1, j)[..., 0], vb[sel])
        ib[sel] = torch.where(better, ik, bi)

    packet_walk(pk, packed, t_min, lambda live: tb[live], on_leaf, stats=stats)
    s = rays.shape
    return Hit(t=pk.flat(tb).reshape(s), u=pk.flat(ub).reshape(s), v=pk.flat(vb).reshape(s),
               tri=pk.flat(ib).reshape(s))


def occluded_packet_ref(rays: Rays, packed: PackedBVH, t_max, t_min: float = DEFAULT_T_MIN,
                        stats: dict | None = None) -> torch.Tensor:
    """Plain-torch twin of packet_occluded; same returns as occluded_packet.
    A blocked ray no longer votes; a packet ends once all its rays (pad
    rays included) are blocked."""
    pk = Packets(rays, t_max)
    blocked = torch.zeros((pk.p, PACKET_RAYS), dtype=torch.bool, device=pk.o.device)

    def on_leaf(sel, o, d, tri, tid, mask):
        t, u, v, det = _mt(o, d, tri)
        tm = pk.tm[sel, :, None]
        hit = ((det.abs() > DET_EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
               & (t > t_min) & (t < tm) & (tid[:, None, :] >= 0))
        blocked[sel] |= hit.any(dim=-1) if mask is None else hit.any(dim=-1) & mask[:, None]

    packet_walk(pk, packed, t_min, lambda live: pk.tm[live], on_leaf,
                voters=lambda live: ~blocked[live], done=lambda live: blocked[live].all(dim=1),
                stats=stats)
    return pk.flat(blocked).reshape(rays.shape)


def k_nearest_ids_packet_ref(rays: Rays, packed: PackedBVH, k: int, band: float,
                             t_min: float = DEFAULT_T_MIN, t_max=T_MAX,
                             stats: dict | None = None) -> torch.Tensor:
    """Plain-torch twin of packet_knear; same returns as k_nearest_ids_packet.
    The lists are tpurt's: sorted by (t, id), no dedup, empty slots
    (T_MAX, -1)."""
    pk = Packets(rays, t_max)
    dev = pk.o.device
    ts = torch.full((pk.p, PACKET_RAYS, k), T_MAX, dtype=torch.float32, device=dev)
    ids = torch.full((pk.p, PACKET_RAYS, k), -1, dtype=torch.int32, device=dev)

    def on_leaf(sel, o, d, tri, tid, mask):
        # tpurt inserts the accepted candidates one at a time; the list that
        # leaves the leaf is the k smallest (t, id) of the list and the
        # candidates (distinct triangles), empty slots (T_MAX, -1) sorting
        # before any candidate at T_MAX: a stable sort by id, then by t
        t, u, v, det = _mt(o, d, tri)
        idb = tid[:, None, :].expand(t.shape)
        acc = ((det.abs() > DET_EPS) & (u >= -band) & (v >= -band) & (u + v <= 1.0 + band)
               & (t > t_min) & (t < pk.tm[sel, :, None]) & (idb >= 0))
        ct = torch.cat([ts[sel], torch.where(acc, t, T_MAX)], dim=-1)
        ci = torch.cat([ids[sel], torch.where(acc, idb, BIG_ID)], dim=-1)
        p = torch.sort(ci, dim=-1, stable=True).indices
        q = p.gather(-1, torch.sort(ct.gather(-1, p), dim=-1, stable=True).indices)[..., :k]
        if mask is None:
            ts[sel], ids[sel] = ct.gather(-1, q), ci.gather(-1, q)
        else:
            keep = mask[:, None, None]
            ts[sel] = torch.where(keep, ct.gather(-1, q), ct[..., :k])
            ids[sel] = torch.where(keep, ci.gather(-1, q), ci[..., :k])

    packet_walk(pk, packed, t_min, lambda live: torch.minimum(ts[live, :, k - 1], pk.tm[live]),
                on_leaf, stats=stats)
    return pk.flat(ids)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------
def traverse_packet(rays: Rays, packed: PackedBVH, t_min: float = DEFAULT_T_MIN) -> Hit:
    """Closest hit per ray by the packet walk: a Hit (t = T_MAX, u = v = 0,
    tri = -1 on a miss), ties to the lower triangle id."""
    o, d = _check_inputs(rays, packed)
    if o.device.type == "cpu":
        return traverse_packet_ref(rays, packed, t_min)
    lib = _build.load()
    n = o.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)
    t, u, v = (torch.empty(n, **f32) for _ in range(3))
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    with _build.on_device(o):
        err = lib.tpurt_packet_closest(
            *_packed_args(packed), _ptr(o), _ptr(d), n, ctypes.c_float(t_min),
            _ptr(t), _ptr(u), _ptr(v), _ptr(tri), packed.num_nodes, _stream(o.device))
    _raise_on(err, "packet_closest")
    LAUNCHES["packet_closest"] += 1
    s = rays.shape
    return Hit(t=t.reshape(s), u=u.reshape(s), v=v.reshape(s), tri=tri.reshape(s))


def occluded_packet(rays: Rays, packed: PackedBVH, t_max,
                    t_min: float = DEFAULT_T_MIN) -> torch.Tensor:
    """Any hit in (t_min, t_max) per ray by the packet walk -> bool (...).
    t_max is a scalar or per ray."""
    o, d = _check_inputs(rays, packed)
    if o.device.type == "cpu":
        return occluded_packet_ref(rays, packed, t_max, t_min)
    tmax = _tmax_flat(rays, t_max)
    lib = _build.load()
    n = o.shape[0]
    blk = torch.empty(n, dtype=torch.uint8, device=o.device)
    with _build.on_device(o):
        err = lib.tpurt_packet_occluded(
            *_packed_args(packed), _ptr(o), _ptr(d), _ptr(tmax), n,
            ctypes.c_float(t_min), _ptr(blk), packed.num_nodes, _stream(o.device))
    _raise_on(err, "packet_occluded")
    LAUNCHES["packet_occluded"] += 1
    return blk.bool().reshape(rays.shape)


def k_nearest_ids_packet(rays: Rays, packed: PackedBVH, k: int, band: float,
                         t_min: float = DEFAULT_T_MIN, t_max=T_MAX) -> torch.Tensor:
    """The k nearest band hits per flat ray by the packet walk -> (N, k)
    int32 triangle ids sorted by (t, id), -1 padded.  Accept: |det| >
    1e-12, u, v >= -band, u + v <= 1 + band, t_min < t < t_max (scalar or
    per ray); node boxes culled against min(k-th t, t_max).
    1 <= k <= KMAX."""
    if not 1 <= k <= KMAX:
        raise ValueError(f"k = {k} outside [1, {KMAX}]")
    o, d = _check_inputs(rays, packed)
    if o.device.type == "cpu":
        return k_nearest_ids_packet_ref(rays, packed, k, band, t_min, t_max)
    tmax = _tmax_flat(rays, t_max)
    lib = _build.load()
    n = o.shape[0]
    ids = torch.empty((n, k), dtype=torch.int32, device=o.device)
    with _build.on_device(o):
        err = lib.tpurt_packet_knear(
            *_packed_args(packed), _ptr(o), _ptr(d), _ptr(tmax), n,
            ctypes.c_float(t_min), k, ctypes.c_float(-band), ctypes.c_float(1.0 + band),
            _ptr(ids), packed.num_nodes, _stream(o.device))
    _raise_on(err, "packet_knear")
    LAUNCHES["packet_knear"] += 1
    return ids
