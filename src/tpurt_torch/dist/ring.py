"""Ring traversal over a partitioned scene (counterpart of
``tpurt/dist/ring.py``).

Rank r owns triangle chunk r (dist/scene_partition.py) and the r-th slice
of the flat ray batch.  Each ring step, every rank runs its resident rays
against its chunk (the local step: a walk, then a fold into the rays'
running answer) and passes the rays with their state to rank + 1, so after
W steps every ray has met every chunk and is home again; the answers then
go to every rank through one all-gather.  Rank 0's rays meet the chunks in
the order 0, 1, ..., W - 1.  At world 1 the rotation is the identity and
no point-to-point op is issued (collectives.ppermute_tree).

The local scene is the brute tuple (v0, v1, v2, gid) of the rank's chunk,
its WideBVH or its PackedBVH, their ids already global, and a local engine
walks it (ENGINES):
- "brute": the tuple, all pairs;
- "wide8": the WideBVH, the wide8 kernels (closest8, occluded8, knear8);
- "packet": the PackedBVH, tpurt's packet engine (kernels/packet.py:
  packet_closest, packet_occluded, packet_knear).  A local step hands the
  rank's whole resident block to the wrapper in one call, so packet p is
  the block's rays [1024 p, 1024 p + 1024), its end zero-padded, as tpurt's
  packet engine groups the block shard_map gives it; every resident ray is
  walked at every step, hit or blocked or not.  A ray can be hit through
  its packet (ROADMAP P1, P3), so the grouping is part of the result;
- "binary": the PackedBVH, the binary per-ray kernels (closest_bin,
  occluded_bin, knear_bin), tpurt's "pallas" walk, which tpurt's ring
  never runs: only a caller that names it gets it.
Without an engine, the tree picks tpurt's (engine_of): a tuple is brute, a
WideBVH wide8 and a PackedBVH packet.  The closest fold is tpurt's
lexicographic (t, gid) one and the k-nearest merge its two-key sort of
(t, id), the t of each candidate recomputed from the replicated (T, 15)
table, so the results do not depend on the order in which a ray meets the
chunks.  The local steps are plain functions (closest_step, occluded_step,
knear_step): the ring body calls them, and a caller can fold several chunks
through them on one card.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from tpurt_torch.accel.bvh8 import WideBVH
from tpurt_torch.accel.intersect import DEFAULT_T_MIN, DET_EPS, intersect_tri
from tpurt_torch.core.geometry import T_MAX, Hit, Rays
from tpurt_torch.core.math import cross, dot
from tpurt_torch.dist.collectives import all_gather_tree, ppermute_tree, rank_rows
from tpurt_torch.accel.packet import PackedBVH
from tpurt_torch.dist.scene_partition import BIG_ID, ScenePartition
from tpurt_torch.kernels.packet import k_nearest_ids_packet, occluded_packet, traverse_packet
from tpurt_torch.kernels.traverse import k_nearest_ids_packed, occluded_packed, traverse_packed
from tpurt_torch.kernels.traverse8 import (
    _lexsort, k_nearest_wide8, occluded_wide8, traverse_wide8)


# The local engines, and the tree each walks.
ENGINES = ("brute", "wide8", "binary", "packet")
_TREE = {"brute": tuple, "wide8": WideBVH, "binary": PackedBVH, "packet": PackedBVH}


def engine_of(scene_local, engine: str | None = None) -> str:
    """The local engine for scene_local: `engine` when given (checked
    against the tree), else tpurt's choice from the tree: a tuple is brute,
    a WideBVH wide8, a PackedBVH packet."""
    if engine is None:
        engine = next((e for e in ("brute", "wide8", "packet")
                       if isinstance(scene_local, _TREE[e])), None)
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} not in {ENGINES}")
    if not isinstance(scene_local, _TREE[engine]):
        raise ValueError(f"engine {engine!r} walks a {_TREE[engine].__name__}, "
                         f"not a {type(scene_local).__name__}")
    return engine


# ---------------------------------------------------------------------------
# The local walks: brute tuple, WideBVH or PackedBVH
# ---------------------------------------------------------------------------
def _local_closest(o, d, v0, v1, v2, gid, t_min):
    """Closest hit of rays (R, 3) against a raw chunk, ties to the lowest
    global id -> (t, u, v, gid), T_MAX and -1 on a miss."""
    t, u, v, hit = intersect_tri(o[:, None, :], d[:, None, :], v0[None], v1[None],
                                 v2[None], t_min)
    t = torch.where(hit & (gid >= 0)[None, :], t, T_MAX)
    tmin = t.amin(dim=1, keepdim=True)
    j = torch.argmin(torch.where(t == tmin, gid[None, :], BIG_ID), dim=1)
    r = torch.arange(t.shape[0], device=t.device)
    tb = t[r, j]
    ok = tb < T_MAX
    return (tb, torch.where(ok, u[r, j], 0.0), torch.where(ok, v[r, j], 0.0),
            torch.where(ok, gid[j], -1))


def _local_closest_any(o, d, scene_local, t_min, engine: str):
    if engine == "brute":
        return _local_closest(o, d, *scene_local, t_min)
    walk = {"wide8": traverse_wide8, "binary": traverse_packed,
            "packet": traverse_packet}[engine]
    hit = walk(Rays(o=o, d=d), scene_local, t_min)
    return hit.t, hit.u, hit.v, hit.tri


def _local_blocked(o, d, tmax, scene_local, t_min, engine: str):
    if engine == "brute":
        v0, v1, v2, gid = scene_local
        t, _, _, hit = intersect_tri(o[:, None, :], d[:, None, :], v0[None], v1[None],
                                     v2[None], t_min)
        return (hit & (gid >= 0)[None, :] & (t < tmax[:, None])).any(dim=1)
    walk = {"wide8": occluded_wide8, "binary": occluded_packed,
            "packet": occluded_packet}[engine]
    return walk(Rays(o=o, d=d), scene_local, tmax, t_min)


def _local_k_ids(o, d, tmax, scene_local, k, band, t_min, engine: str):
    """The chunk's k nearest band candidates per ray, global ids (R, k), -1
    padded."""
    if engine != "brute":
        walk = {"wide8": k_nearest_wide8, "binary": k_nearest_ids_packed,
                "packet": k_nearest_ids_packet}[engine]
        return walk(Rays(o=o, d=d), scene_local, k, band, t_min, tmax)
    v0, v1, v2, gid = scene_local
    e1, e2 = v1 - v0, v2 - v0
    pvec = cross(d[:, None, :], e2[None])
    det = dot(e1[None], pvec)
    inv = det / (det * det + DET_EPS)
    tvec = o[:, None, :] - v0[None]
    u = dot(tvec, pvec) * inv
    qvec = cross(tvec, e1[None])
    v = dot(d[:, None, :], qvec) * inv
    t = dot(e2[None], qvec) * inv
    ok = ((gid >= 0)[None, :] & (det.abs() > DET_EPS) & (u >= -band) & (v >= -band)
          & (u + v <= 1.0 + band) & (t > t_min) & (t < tmax[:, None]))
    t = torch.where(ok, t, T_MAX)
    kk = min(k, t.shape[1])
    # lax.top_k's order: ascending t, the lower index first among equals
    ts, idx = torch.sort(t, dim=1, stable=True)
    ids = torch.where(ts[:, :kk] < T_MAX, gid[idx[:, :kk]], -1).to(torch.int32)
    return torch.nn.functional.pad(ids, (0, k - kk), value=-1)


def _table_t(o, d, ids, table, t_min):
    """Each candidate's t from its replicated table row (the merge's order
    key only; no gradient)."""
    row = table[ids.clamp_min(0).long()]               # (R, k, 15)
    v0, e1, e2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    pvec = cross(d[:, None, :], e2)
    det = torch.sum(e1 * pvec, dim=-1)
    inv = det / (det * det + 1e-12)
    qvec = cross(o[:, None, :] - v0, e1)
    t = torch.sum(e2 * qvec, dim=-1) * inv
    return torch.where(ids >= 0, torch.clamp_min(t, t_min), T_MAX)


# ---------------------------------------------------------------------------
# The local steps: a walk, then the fold into the running answer
# ---------------------------------------------------------------------------
def closest_init(n: int, device) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {"t": torch.full((n,), T_MAX, **f32), "u": torch.zeros(n, **f32),
            "v": torch.zeros(n, **f32),
            "tri": torch.full((n,), -1, dtype=torch.int32, device=device)}


def closest_step(o, d, best: dict, scene_local, t_min: float = DEFAULT_T_MIN,
                 engine: str | None = None) -> dict:
    """Fold the chunk's closest hit into `best` (t, u, v, tri): the
    lexicographic (t, global id) winner.  engine: the local engine
    (ENGINES; None: engine_of the tree), as for occluded_step and
    knear_step."""
    engine = engine_of(scene_local, engine)
    t, u, v, g = _local_closest_any(o, d, scene_local, t_min, engine)
    bt, bg = best["t"], best["tri"]
    better = (t < bt) | ((t == bt) & (g < bg) & (bg >= 0))
    return {"t": torch.where(better, t, bt), "u": torch.where(better, u, best["u"]),
            "v": torch.where(better, v, best["v"]), "tri": torch.where(better, g, bg)}


def occluded_step(o, d, tmax, blocked, scene_local, t_min: float = DEFAULT_T_MIN,
                  engine: str | None = None):
    """blocked | any hit of the chunk in (t_min, tmax); every ray is walked,
    blocked already or not."""
    engine = engine_of(scene_local, engine)
    return blocked | _local_blocked(o, d, tmax, scene_local, t_min, engine)


def knear_init(n: int, k: int, device) -> tuple:
    return (torch.full((n, k), T_MAX, dtype=torch.float32, device=device),
            torch.full((n, k), BIG_ID, dtype=torch.int32, device=device))


def knear_step(o, d, tmax, ts, ids, scene_local, table, k: int, band: float,
               t_min: float = DEFAULT_T_MIN, engine: str | None = None):
    """Merge the chunk's k nearest candidates into the sorted (t, id)
    k-lists (ts, ids; BIG_ID pads): chunks are disjoint, so no dedup.  The
    local lists' -1 pads (the packet engine's empty slots, tpurt's (T_MAX,
    -1)) become BIG_ID before the merge."""
    engine = engine_of(scene_local, engine)
    lids = _local_k_ids(o, d, tmax, scene_local, k, band, t_min, engine)
    lts = _table_t(o, d, lids, table, t_min)
    lids = torch.where(lids >= 0, lids, BIG_ID)
    t2, i2 = _lexsort(torch.cat([ts, lts], dim=1), torch.cat([ids, lids], dim=1))
    return t2[:, :k], i2[:, :k]


# ---------------------------------------------------------------------------
# The rings
# ---------------------------------------------------------------------------
def _home(mesh: DeviceMesh, rays: Rays, part: ScenePartition, pbvh, *per_ray):
    """This rank's slice of the flat rays and of each per-ray tensor, and
    its local scene (the brute tuple of its chunk without pbvh)."""
    if part.n_parts != mesh.size():
        raise ValueError(f"partition has {part.n_parts} parts, mesh has {mesh.size()}")
    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    rows = rank_rows(o.shape[0], mesh)
    scene = part.local(mesh.get_local_rank()) if pbvh is None else pbvh
    return o[rows], d[rows], [x.reshape(-1)[rows] for x in per_ray], scene


def _rotate(mesh: DeviceMesh, state: dict, step) -> dict:
    """W ring steps: the local step, then the whole state to rank + 1."""
    for _ in range(mesh.size()):
        state = ppermute_tree(step(state), mesh)
    return state


@torch.no_grad()
def ring_trace(mesh: DeviceMesh, rays: Rays, part: ScenePartition,
               t_min: float = DEFAULT_T_MIN, pbvh=None, engine: str | None = None) -> Hit:
    """Global closest hit (original triangle ids) of the flat rays, whose
    count must divide by the mesh (pad with dist.shard.pad_rays), over the
    partitioned scene; the whole Hit on every rank.  pbvh: this rank's
    WideBVH or PackedBVH (build_partition_wides / _bvhs), else brute.
    engine: the local engine (ENGINES; None: tpurt's for the tree, so a
    PackedBVH gets "packet"), as for ring_occluded and ring_k_nearest."""
    o, d, _, scene = _home(mesh, rays, part, pbvh)
    engine = engine_of(scene, engine)

    def step(s):
        return {**s, **closest_step(s["o"], s["d"], s, scene, t_min, engine)}

    s = _rotate(mesh, {"o": o, "d": d, **closest_init(o.shape[0], o.device)}, step)
    full = all_gather_tree({k: s[k] for k in ("t", "u", "v", "tri")}, mesh)
    return Hit(**{k: x.reshape(rays.shape) for k, x in full.items()})


@torch.no_grad()
def ring_occluded(mesh: DeviceMesh, rays: Rays, part: ScenePartition, t_max,
                  t_min: float = DEFAULT_T_MIN, pbvh=None,
                  engine: str | None = None) -> torch.Tensor:
    """Any hit in (t_min, t_max) over every partition -> bool shaped as the
    rays, on every rank.  t_max: a scalar or per ray."""
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=rays.o.device).expand(rays.shape)
    o, d, (tm,), scene = _home(mesh, rays, part, pbvh, tm)
    engine = engine_of(scene, engine)

    def step(s):
        return {**s, "blocked": occluded_step(s["o"], s["d"], s["tm"], s["blocked"], scene,
                                              t_min, engine)}

    s = _rotate(mesh, {"o": o, "d": d, "tm": tm,
                       "blocked": torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)},
                step)
    return all_gather_tree({"b": s["blocked"]}, mesh)["b"].reshape(rays.shape)


@torch.no_grad()
def ring_k_nearest(mesh: DeviceMesh, rays: Rays, part: ScenePartition, table: torch.Tensor,
                   k: int, band: float, t_max=T_MAX, t_min: float = DEFAULT_T_MIN,
                   pbvh=None, engine: str | None = None) -> torch.Tensor:
    """The k nearest band candidates over the partitioned scene -> (N, k)
    int32 global ids over the flat rays, -1 padded, on every rank: each ray
    carries its sorted (t, id) k-list around the ring.  table: the
    replicated (T, 15) tri_table the candidates' t come from."""
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=rays.o.device).expand(rays.shape)
    o, d, (tm,), scene = _home(mesh, rays, part, pbvh, tm)
    engine = engine_of(scene, engine)
    ts, ids = knear_init(o.shape[0], k, o.device)

    def step(s):
        ts, ids = knear_step(s["o"], s["d"], s["tm"], s["ts"], s["ids"], scene, table, k,
                             band, t_min, engine)
        return {**s, "ts": ts, "ids": ids}

    s = _rotate(mesh, {"o": o, "d": d, "tm": tm, "ts": ts, "ids": ids}, step)
    ids = all_gather_tree({"ids": s["ids"]}, mesh)["ids"]
    return torch.where(ids == BIG_ID, -1, ids)
