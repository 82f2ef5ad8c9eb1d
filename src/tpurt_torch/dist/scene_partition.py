"""Spatial scene partitioning and ray routing (counterpart of
``tpurt/dist/scene_partition.py``).

When a scene is too large to replicate on every card, it is split into
``n_parts`` spatially coherent chunks: triangles are ordered by the Morton
code of their centroid (a stable sort, as JAX's argsort) and cut into equal
contiguous ranges of ceil(F / n_parts), the last padded with gid -1 rows
collapsed to the origin.  Rank r owns chunk r.  Each chunk gets its own
tree, whose leaf ids are rewritten to global triangle ids, so every walk
reports ids the replicated engines and the brute oracle agree on.

The padding rows are degenerate triangles at the origin and, as in tpurt,
enter their chunk's LBVH (the origin widens the centroid bounds that
quantise the Morton codes, and a zero-size leaf at the origin enters the
tree).  Their slots carry id -1 and all-zero rows: det = 0 makes the smooth
inverse give t = 0, which fails t > t_min, so they never hit.

tpurt stacks every partition's tree on a leading axis and pads them to a
common shape for ``shard_map``; a rank here holds only its own, so the
builders return one partition's structure (``index``) or the list of all.

``route_rays`` and ``alltoall_trace`` are the Ulysses-style routing path:
each ray goes to the partition whose box it enters first, over one
all-to-all, and comes back resolved when no other partition can beat that
answer.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpurt_torch.accel.bvh8 import build_wide, rows_from_tids
from tpurt_torch.accel.intersect import DEFAULT_T_MIN, intersect_tri
from tpurt_torch.accel.lbvh import build_lbvh
from tpurt_torch.accel.morton import triangle_morton_codes
from tpurt_torch.accel.packet import max_cut_leaves, pack_bvh
from tpurt_torch.core.geometry import T_MAX, Hit, Rays, Triangles
from tpurt_torch.core.math import cross
from tpurt_torch.dist.collectives import all_gather_tree, rank_rows

BIG_ID = 2**31 - 1


@dataclass
class ScenePartition:
    """A Morton-partitioned triangle soup, flat: every array has leading dim
    n_parts * chunk, and partition p owns rows [p * chunk, (p + 1) * chunk)."""

    v0: torch.Tensor       # (P*M, 3)
    v1: torch.Tensor       # (P*M, 3)
    v2: torch.Tensor       # (P*M, 3)
    albedo: torch.Tensor   # (P*M, 3) per-face albedo in partition order
    gid: torch.Tensor      # (P*M,) int32 original triangle id; -1 = padding
    lo: torch.Tensor       # (P, 3) partition box, over its valid corners
    hi: torch.Tensor       # (P, 3)
    n_parts: int

    @property
    def chunk(self) -> int:
        return self.gid.shape[0] // self.n_parts

    def rows(self, p: int) -> slice:
        return slice(p * self.chunk, (p + 1) * self.chunk)

    def local(self, p: int) -> tuple:
        """Partition p's (v0, v1, v2, gid): the ring's brute local scene."""
        r = self.rows(p)
        return self.v0[r], self.v1[r], self.v2[r], self.gid[r]


@torch.no_grad()
def partition_scene(tris: Triangles, n_parts: int) -> ScenePartition:
    """Split `tris` into n_parts equal Morton-ordered chunks; the gid mask,
    not geometry, keeps the padding rows out of every hit."""
    f = tris.num_tris
    order = torch.sort(triangle_morton_codes(tris), stable=True).indices
    chunk = -(-f // n_parts)
    pad = n_parts * chunk - f
    gid = torch.cat([order.to(torch.int32),
                     torch.full((pad,), -1, dtype=torch.int32, device=order.device)])
    safe = gid.clamp_min(0).long()
    mask = (gid >= 0)[:, None]
    v0, v1, v2 = (torch.where(mask, c[safe], 0.0) for c in tris.corners())
    pts = torch.stack([v0, v1, v2], dim=1).reshape(n_parts, chunk * 3, 3)
    valid = mask.reshape(n_parts, chunk).repeat_interleave(3, dim=1)[..., None]
    lo = torch.where(valid, pts, T_MAX).amin(dim=1)
    hi = torch.where(valid, pts, -T_MAX).amax(dim=1)
    return ScenePartition(v0=v0, v1=v1, v2=v2, albedo=tris.albedo[safe], gid=gid,
                          lo=lo, hi=hi, n_parts=n_parts)


def chunk_tris(part: ScenePartition, p: int) -> Triangles:
    """Partition p as its own soup, padding rows included: corners stacked
    [v0; v1; v2], face j = (j, chunk + j, 2 chunk + j), tpurt's layout."""
    m, r = part.chunk, part.rows(p)
    verts = torch.cat([part.v0[r], part.v1[r], part.v2[r]])
    j = torch.arange(m, dtype=torch.int32, device=verts.device)[:, None]
    faces = j + torch.tensor([[0, m, 2 * m]], dtype=torch.int32, device=verts.device)
    return Triangles(verts=verts, faces=faces, albedo=part.albedo[r],
                     emission=torch.zeros_like(part.albedo[r]))


def _to_global(local: torch.Tensor, gid_p: torch.Tensor) -> torch.Tensor:
    """Chunk-local triangle ids -> global ids (-1 stays -1; padding rows
    map to -1 through gid)."""
    return torch.where(local >= 0, gid_p[local.clamp_min(0).long()], -1).to(torch.int32)


def _parts(part: ScenePartition, index: int | None):
    return range(part.n_parts) if index is None else [index]


@torch.no_grad()
def build_partition_bvhs(part: ScenePartition, leaf_size: int = 8, band: float = 0.0,
                         index: int | None = None):
    """Partition `index`'s packed binary LBVH (the binary kernels' layout),
    or the list of every partition's when index is None.  Rows for the
    static bound max_cut_leaves(chunk, leaf_size), as tpurt packs them;
    tri_ids rewritten to global ids."""
    out = []
    for p in _parts(part, index):
        tris = chunk_tris(part, p)
        packed = pack_bvh(tris, build_lbvh(tris, leaf_size=leaf_size, band=band),
                          n_leaves=max_cut_leaves(part.chunk, leaf_size))
        out.append(dataclasses.replace(
            packed, tri_ids=_to_global(packed.tri_ids, part.gid[part.rows(p)])))
    return out if index is None else out[0]


@torch.no_grad()
def build_partition_wides(part: ScenePartition, tris: Triangles, band: float = 0.0,
                          index: int | None = None):
    """Partition `index`'s WideBVH (the wide8 kernels' layout), or the list
    of every partition's when index is None.  row_tids are rewritten to
    global ids and the triangle rows regathered from the full scene `tris`,
    so the id, albedo and emission lanes are the original triangles'."""
    out = []
    for p in _parts(part, index):
        local = chunk_tris(part, p)
        w = build_wide(local, build_lbvh(local, band=band))
        rt = _to_global(w.row_tids, part.gid[part.rows(p)])
        out.append(dataclasses.replace(w, row_tids=rt, tri_rows=rows_from_tids(tris, rt)))
    return out if index is None else out[0]


def aabb_entry_t(o: torch.Tensor, d: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """Slab-test entry distance of rays (R, 3) into boxes (P, 3) -> (R, P);
    T_MAX where the ray misses the box."""
    inv = torch.where(d.abs() > 1e-20, 1.0 / d, 1e20 * torch.sign(d) + 1e20)
    t0 = (lo[None] - o[:, None]) * inv[:, None]
    t1 = (hi[None] - o[:, None]) * inv[:, None]
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    near0 = torch.clamp_min(near, 0.0)
    hit = (far >= near0) & (far > 0.0)
    return torch.where(hit, near0, T_MAX)


def route_rays(rays: Rays, part: ScenePartition) -> torch.Tensor:
    """Owner partition per ray: the one whose box the ray enters first
    (rays that miss every box get 0, they miss everything anyway) -> int32
    shaped as the rays."""
    entry = aabb_entry_t(rays.o.reshape(-1, 3), rays.d.reshape(-1, 3), part.lo, part.hi)
    return torch.argmin(entry, dim=1).to(torch.int32).reshape(rays.shape)


def _u_of(o, d, v0, v1, v2, j):
    """(u, v) of ray i against its selected triangle j[i] (Möller–Trumbore,
    tpurt's op order)."""
    a = v0[j]
    e1 = v1[j] - a
    e2 = v2[j] - a
    pvec = cross(d, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    inv = det / (det * det + 1e-12)
    tvec = o - a
    u = torch.sum(tvec * pvec, dim=-1) * inv
    qvec = cross(tvec, e1)
    v = torch.sum(d * qvec, dim=-1) * inv
    return u, v


def _a2a(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """all_to_all_single over the mesh: block p of dim 0 goes to rank p."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=mesh.get_group())
    return out


@torch.no_grad()
def alltoall_trace(mesh: DeviceMesh, rays: Rays, part: ScenePartition,
                   capacity: int | None = None, t_min: float = DEFAULT_T_MIN):
    """Ulysses-style routing, executed: each rank sends its slice of the
    flat rays to the partitions they enter first (one all_to_all_single),
    the owner traces them brute-force against its chunk, and the results
    ride the reverse all-to-all home.

    A ray is resolved when its owner's hit (or miss) cannot be beaten by any
    other partition: hit t <= the entry t of every other partition.  Rays
    that overflow a destination bucket (more than `capacity`; default 2x the
    balanced share) are left unresolved, never dropped.  Returns (Hit,
    resolved bool), both over all the rays, on every rank."""
    n_dev = mesh.size()
    if part.n_parts != n_dev:
        raise ValueError(f"partition has {part.n_parts} parts, mesh has {n_dev}")
    shape = rays.shape
    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    rows = rank_rows(o.shape[0], mesh)
    o, d = o[rows], d[rows]
    rl, dev = o.shape[0], o.device
    c = max(1, (2 * rl) // n_dev) if capacity is None else capacity
    entry = aabb_entry_t(o, d, part.lo, part.hi)
    owner = torch.argmin(entry, dim=1)
    rr = torch.arange(rl, device=dev)
    second = entry.index_put((rr, owner), torch.tensor(T_MAX, device=dev)).amin(dim=1)
    onehot = owner[:, None] == torch.arange(n_dev, device=dev)[None, :]
    rank = onehot.to(torch.int32).cumsum(0).gather(1, owner[:, None])[:, 0] - 1
    ok = rank < c
    slot = torch.where(ok, rank, c).long()

    def send(x, fill):
        buf = torch.full((n_dev, c + 1) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=dev)
        buf[owner, slot] = x
        return buf[:, :c]

    send_o, send_d = send(o, 0.0), send(d, 0.0)
    send_src = send(rr.to(torch.int32), -1)
    send_valid = send(ok.to(torch.uint8), 0)
    recv_o = _a2a(send_o, mesh).reshape(n_dev * c, 3)
    recv_d = _a2a(send_d, mesh).reshape(n_dev * c, 3)
    recv_valid = _a2a(send_valid, mesh).reshape(n_dev * c).bool()

    v0, v1, v2, gid = part.local(mesh.get_local_rank())
    t, _, _, hit = intersect_tri(recv_o[:, None, :], recv_d[:, None, :], v0[None],
                                 v1[None], v2[None], t_min)
    t = torch.where(hit & (gid >= 0)[None, :] & recv_valid[:, None], t, T_MAX)
    tmin_ = t.amin(dim=1, keepdim=True)
    gkey = torch.where(t == tmin_, gid[None, :], BIG_ID)
    j = torch.argmin(gkey, dim=1)
    bt = t[torch.arange(t.shape[0], device=dev), j]
    hitm = bt < T_MAX
    uw, vw = _u_of(recv_o, recv_d, v0, v1, v2, j)
    back = {"t": bt, "u": torch.where(hitm, uw, 0.0), "v": torch.where(hitm, vw, 0.0),
            "g": torch.where(hitm, gid[j], -1)}
    back = {k: _a2a(x.reshape(n_dev, c), mesh) for k, x in back.items()}

    # scatter home through the send map (row rl drops what was not sent)
    idx = torch.where(send_valid.bool(), send_src, rl).reshape(-1).long()

    def home(val, fill):
        out = torch.full((rl + 1,), fill, dtype=val.dtype, device=dev)
        out[idx] = val.reshape(-1)
        return out[:rl]

    t_out, u_out, v_out = home(back["t"], T_MAX), home(back["u"], 0.0), home(back["v"], 0.0)
    g_out = home(back["g"], -1)
    final = torch.where(g_out >= 0, t_out <= second, second >= T_MAX)
    full = all_gather_tree({"t": t_out, "u": u_out, "v": v_out, "g": g_out,
                            "resolved": ok & final}, mesh)
    hit = Hit(t=full["t"].reshape(shape), u=full["u"].reshape(shape),
              v=full["v"].reshape(shape), tri=full["g"].reshape(shape))
    return hit, full["resolved"].reshape(shape)
