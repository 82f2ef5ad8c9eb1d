"""8-wide BVH: host-side collapse of the LBVH and packing of the node and
triangle rows (counterpart of ``tpurt/accel/bvh8.py``).

The layout is tpurt's, kept byte for byte so a WideBVH built by either
package can feed either package's traversal:

  one wide node = 64 f32 lanes, two wide nodes per (128,) row:
    lanes 6c..6c+5 : child c box (lox, loy, loz, hix, hiy, hiz), c in 0..7
    lanes 48+c     : child c meta (lane-coded int): >= 0 child wide id,
                     < 0 fat leaf with ~meta == (row0 << 3) | (n_rows - 1)
    lanes 56..61   : the node's own box
    lane  62       : escape wide id (-1 terminates)
    lane  63       : 1 if the node has internal children
  one triangle row = 128 lanes: 9j..9j+8 tri j's (v0, e1, e2), 72+j its id
  (lane-coded), 80+3j its albedo, 104+3j its emission.

Empty child slots hold the point box at +3e38, which fails every slab test.
Integers travel as f32 bit patterns through the lane codec below (tpurt
needed it because the TPU flushes denormals; here it only keeps the buffers
identical).  The numpy collapse helpers are tpurt's, copied.
"""

from __future__ import annotations

import dataclasses
import heapq
from dataclasses import dataclass

import numpy as np
import torch

from tpurt_torch.accel.lbvh import BVH
from tpurt_torch.core.geometry import Triangles

ENTRIES = 8          # children per wide node
FAT_TRIS = 16        # max triangles in a fat-leaf entry
R_MAX_ROWS = 3       # max tri rows a fat leaf can span: ceil((16-1+7)/8)+1
TRIS_PER_ROW = 8     # 8 tris x 9 floats = 72 lanes (+8 id lanes)
EMPTY_BOX = 3e38     # point box at +inf: fails every slab test

LANE_OFF = 1 << 25
LANE_MIN = -LANE_OFF + 1
LANE_MAX = 0x3F7FFFFF - LANE_OFF


def encode_lane_i32(v: torch.Tensor) -> torch.Tensor:
    """int -> f32 whose bit pattern is 0xC0000000 | ((v + 2^25) & 0x3FFFFFFF),
    a negative normal float for every v in [LANE_MIN, LANE_MAX]."""
    enc = ((v.to(torch.int64) + LANE_OFF) & 0x3FFFFFFF) | 0xC0000000
    return (enc - (1 << 32)).to(torch.int32).view(torch.float32)


def decode_lane_i32(e: torch.Tensor) -> torch.Tensor:
    """Inverse of encode_lane_i32 on the int32 view of a lane.  All-zero pad
    lanes decode to -LANE_OFF, an invalid id."""
    return (e & 0x3FFFFFFF) - LANE_OFF


@dataclass
class WideBVH:
    """Traversal-ready 8-wide BVH (DFS order).

    wrow:       (ceil(W/2) padded to 8, 128) f32 packed wide-node rows.
    tri_rows:   (R + pad, 128) f32 leaf-aligned triangle rows.
    entry_node: (W, 8) i32 raw binary node id per entry (-1 empty).
    entry_meta: (W, 8) i32 meta words (encoding in the module docstring).
    own_node:   (W,) i32 the wide node's anchor binary node.
    escape:     (W,) i32 DFS escape wide id (-1 terminates).
    has_int:    (W,) i32 1 when the wide node has internal children.
    row_tids:   (R, 8) i32 triangle id per row slot (-1 pad).
    max_stack:  worst-case stack occupancy of a walk (0 = not computed).
    max_rows:   max rows any fat leaf spans; the walks' leaf-loop extent.
    levels:     refit_levels of the topology (None = not computed).
    """

    wrow: torch.Tensor
    tri_rows: torch.Tensor
    entry_node: torch.Tensor
    entry_meta: torch.Tensor
    own_node: torch.Tensor
    escape: torch.Tensor
    has_int: torch.Tensor
    row_tids: torch.Tensor
    band: float = 0.0
    max_stack: int = 0
    max_rows: int = R_MAX_ROWS
    levels: tuple | None = None

    @property
    def num_wides(self) -> int:
        return self.entry_node.shape[0]

    @property
    def num_rows(self) -> int:
        return self.row_tids.shape[0]


def _leaf_meta(first: int, last: int) -> int:
    r0 = first // TRIS_PER_ROW
    n_rows = last // TRIS_PER_ROW - r0 + 1
    assert 1 <= n_rows <= R_MAX_ROWS
    return ~((r0 << 3) | (n_rows - 1))


def _split_rank(count: np.ndarray, priority: np.ndarray | None) -> np.ndarray:
    """Total split order: rank[node] = position in (priority desc, node id
    asc).  priority=None uses the subtree triangle count."""
    prio = count if priority is None else np.asarray(priority)
    m = prio.shape[0]
    order = np.lexsort((np.arange(m), -prio.astype(np.float64)))
    rank = np.empty(m, np.int64)
    rank[order] = np.arange(m)
    return rank


def _collapse8_serial(
    left: np.ndarray,
    right: np.ndarray,
    first: np.ndarray,
    last: np.ndarray,
    fat_tris: int = FAT_TRIS,
    priority: np.ndarray | None = None,
) -> tuple[np.ndarray, ...]:
    """Reference greedy collapse (per-anchor heap loop), the oracle for the
    vectorized `collapse8`.

    Returns (entry_node (W, 8) i32, entry_meta (W, 8) i32, own (W,) i32,
    escape (W,) i32, has_int (W,) i32).  Wide node 0 is the root.
    """
    n = (first.shape[0] + 1) // 2
    if n == 1 or int(last[0] - first[0] + 1) <= fat_tris:
        en = np.full((1, ENTRIES), -1, np.int32)
        em = np.zeros((1, ENTRIES), np.int32)
        en[0, 0] = 0  # root node (leaf when n == 1, internal otherwise)
        em[0, 0] = _leaf_meta(0, n - 1)
        return (en, em, np.zeros(1, np.int32),
                np.full(1, -1, np.int32), np.zeros(1, np.int32))

    count = (last.astype(np.int64) - first.astype(np.int64)) + 1
    rank = _split_rank(count, priority)
    leaf_base = n - 1
    anchors = [0]  # provisional (BFS) wide id == position in this list
    wide_entries: list[list[tuple[int, int, bool]]] = []
    qi = 0
    while qi < len(anchors):
        a = anchors[qi]
        qi += 1
        splits: list[tuple[int, int]] = [(int(rank[a]), a)]
        terms: list[int] = []
        total = 1
        while splits and total < ENTRIES:
            _, node = heapq.heappop(splits)
            total -= 1
            for ch in (int(left[node]), int(right[node])):
                if ch < leaf_base and count[ch] > fat_tris:
                    heapq.heappush(splits, (int(rank[ch]), ch))
                else:
                    terms.append(ch)
                total += 1
        ents: list[tuple[int, int, bool]] = []
        for _, node in splits:  # leftover splittables -> child wide nodes
            ents.append((node, len(anchors), False))
            anchors.append(node)
        for node in terms:  # small subtrees / raw leaves -> fat leaves
            ents.append((node, -1, True))
        ents.sort(key=lambda e: int(first[e[0]]))
        wide_entries.append(ents)

    # DFS preorder re-numbering + escape links.
    w = len(wide_entries)
    kids = [[wid for (_, wid, lf) in ents if not lf] for ents in wide_entries]
    size = np.ones(w, np.int64)
    for wi in range(w - 1, -1, -1):  # children have larger BFS ids
        for c in kids[wi]:
            size[wi] += size[c]
    new_of = np.empty(w, np.int32)
    esc = np.empty(w, np.int32)
    nxt = 0
    stack = [0]
    while stack:
        wi = stack.pop()
        new_of[wi] = nxt
        e = nxt + size[wi]
        esc[nxt] = e if e < w else -1
        nxt += 1
        stack.extend(reversed(kids[wi]))  # preorder, entry order preserved

    en = np.full((w, ENTRIES), -1, np.int32)
    em = np.zeros((w, ENTRIES), np.int32)
    own = np.empty(w, np.int32)
    has_int = np.zeros(w, np.int32)
    for wi, ents in enumerate(wide_entries):
        ni = int(new_of[wi])
        own[ni] = anchors[wi]
        for e, (node, wid, is_leaf) in enumerate(ents):
            en[ni, e] = node
            if is_leaf:
                em[ni, e] = _leaf_meta(int(first[node]), int(last[node]))
            else:
                em[ni, e] = new_of[wid]
                has_int[ni] = 1
    return en, em, own, esc, has_int


def collapse8(
    left: np.ndarray,
    right: np.ndarray,
    first: np.ndarray,
    last: np.ndarray,
    fat_tris: int = FAT_TRIS,
    priority: np.ndarray | None = None,
) -> tuple[np.ndarray, ...]:
    """Greedy binary->8-wide collapse, wave-synchronous numpy (host).

    Same greedy rule and identical output arrays as `_collapse8_serial`, but
    every per-anchor decision is a vectorized row operation over the whole
    BFS wave: each of the <= 7 split rounds replaces each active row's
    highest-`_split_rank` splittable entry with its two children.

    Returns (entry_node (W, 8) i32, entry_meta (W, 8) i32, own (W,) i32,
    escape (W,) i32, has_int (W,) i32).
    """
    n = (first.shape[0] + 1) // 2
    if n == 1 or int(last[0] - first[0] + 1) <= fat_tris:
        return _collapse8_serial(left, right, first, last, fat_tris, priority)

    count = (last.astype(np.int64) - first.astype(np.int64)) + 1
    rank = _split_rank(count, priority)
    m_nodes = rank.shape[0]
    leaf_base = n - 1

    def splittable(nodes):
        return (nodes < leaf_base) & (count[np.minimum(nodes, 2 * n - 2)]
                                      > fat_tris) & (nodes >= 0)

    # --- wave loop: split each anchor's frontier to <= 8 entries ----------
    waves = []     # per wave: (node (A,8), split (A,8), n_ent (A,))
    all_anc = []   # per wave: anchor node ids (A,)
    anc = np.zeros(1, np.int64)
    while anc.size:
        all_anc.append(anc)
        a = anc.size
        node = np.full((a, ENTRIES), -1, np.int64)
        node[:, 0] = anc
        split = np.zeros((a, ENTRIES), bool)
        split[:, 0] = True  # anchors are splittable by construction
        n_ent = np.ones(a, np.int64)
        for _ in range(ENTRIES - 1):
            active = split.any(axis=1) & (n_ent < ENTRIES)
            if not active.any():
                break
            # argmax key: highest _split_rank priority first (rank 0 = best)
            key = np.where(split, m_nodes - rank[np.maximum(node, 0)], -1)
            rows = np.nonzero(active)[0]
            j = np.argmax(key[rows], axis=1)
            sel = node[rows, j]
            l_ch, r_ch = left[sel].astype(np.int64), right[sel].astype(np.int64)
            node[rows, j] = l_ch
            split[rows, j] = splittable(l_ch)
            node[rows, n_ent[rows]] = r_ch
            split[rows, n_ent[rows]] = splittable(r_ch)
            n_ent[rows] += 1
        waves.append((node, split, n_ent))
        # leftover splittable entries -> next wave's anchors (row-major)
        wi_i, e_i = np.nonzero(split)
        anc = node[wi_i, e_i]

    # --- assemble provisional per-wide arrays (BFS wave order) ------------
    wave_sizes = [w[0].shape[0] for w in waves]
    w_total = int(sum(wave_sizes))
    base = np.cumsum([0] + wave_sizes)
    node_all = np.concatenate([w[0] for w in waves])         # (W, 8)
    split_all = np.concatenate([w[1] for w in waves])        # internal entry
    valid_all = node_all >= 0
    # child wide id (provisional): leftover splittables were appended
    # row-major per wave, matching the order np.nonzero scans them
    kidw_all = np.full((w_total, ENTRIES), -1, np.int64)
    for wv, (node, split, _) in enumerate(waves):
        wi_i, e_i = np.nonzero(split)
        kidw_all[base[wv] + wi_i, e_i] = base[wv + 1] + np.arange(wi_i.size)

    # sort entries of every row by Morton range start (empty slots last)
    skey = np.where(valid_all, first[np.maximum(node_all, 0)].astype(np.int64),
                    np.iinfo(np.int64).max)
    order = np.argsort(skey, axis=1, kind="stable")
    r_idx = np.arange(w_total)[:, None]
    node_all = node_all[r_idx, order]
    split_all = split_all[r_idx, order]
    valid_all = valid_all[r_idx, order]
    kidw_all = kidw_all[r_idx, order]

    # --- subtree sizes (waves deepest -> shallowest) ----------------------
    size = np.ones(w_total, np.int64)
    for wv in range(len(waves) - 2, -1, -1):
        rows = slice(base[wv], base[wv + 1])
        ksz = np.where(kidw_all[rows] >= 0,
                       size[np.maximum(kidw_all[rows], 0)], 0)
        size[rows] += ksz.sum(axis=1)

    # --- DFS preorder renumber (waves top -> bottom) ----------------------
    new_of = np.zeros(w_total, np.int64)
    for wv in range(len(waves) - 1):
        rows = slice(base[wv], base[wv + 1])
        kidw = kidw_all[rows]
        has_kid = kidw >= 0
        ksz = np.where(has_kid, size[np.maximum(kidw, 0)], 0)
        excl = np.cumsum(ksz, axis=1) - ksz
        kid_new = new_of[rows][:, None] + 1 + excl
        wi_i, e_i = np.nonzero(has_kid)
        new_of[kidw[wi_i, e_i]] = kid_new[wi_i, e_i]

    # --- final arrays indexed by the DFS ids ------------------------------
    en = np.full((w_total, ENTRIES), -1, np.int32)
    em = np.zeros((w_total, ENTRIES), np.int32)
    own = np.empty(w_total, np.int32)
    esc = np.empty(w_total, np.int32)
    has_int = np.empty(w_total, np.int32)
    esc64 = new_of + size
    esc[new_of] = np.where(esc64 < w_total, esc64, -1).astype(np.int32)
    is_leaf = valid_all & ~split_all
    nd = np.maximum(node_all, 0)
    r0 = first[nd].astype(np.int64) // TRIS_PER_ROW
    nr = last[nd].astype(np.int64) // TRIS_PER_ROW - r0 + 1
    assert (nr[is_leaf] <= R_MAX_ROWS).all()
    meta = np.where(
        is_leaf, ~((r0 << 3) | (nr - 1)),
        np.where(valid_all & split_all, new_of[np.maximum(kidw_all, 0)], 0),
    )
    en[new_of] = np.where(valid_all, node_all, -1).astype(np.int32)
    em[new_of] = meta.astype(np.int32)
    own[new_of] = np.concatenate(all_anc).astype(np.int32)
    has_int[new_of] = split_all.any(axis=1).astype(np.int32)
    return en, em, own, esc, has_int


def align_leaf_rows(
    en: np.ndarray, em: np.ndarray, first: np.ndarray, last: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rewrite fat-leaf metas onto leaf-aligned triangle rows: every leaf
    entry gets its own ceil(count/8) rows, allocated in (DFS wide id, entry)
    scan order; row j of a leaf covers sorted positions
    [first + 8j, min(first + 8j + 8, last + 1)).

    Returns (em_aligned, row_first (R,) i32 sorted-space row starts,
    row_len (R,) i32 live-triangle counts per row).
    """
    is_leaf = em < 0
    wi, ei = np.nonzero(is_leaf)  # row-major == DFS entry order
    nd = en[wi, ei].astype(np.int64)
    f = first[nd].astype(np.int64)
    count = last[nd].astype(np.int64) - f + 1
    nrows = -(-count // TRIS_PER_ROW)
    row0 = np.cumsum(nrows) - nrows
    em2 = em.copy()
    em2[wi, ei] = (~((row0 << 3) | (nrows - 1))).astype(np.int32)
    r_total = int(nrows.sum())
    leaf_of_row = np.repeat(np.arange(nrows.size), nrows)
    j_in_leaf = np.arange(r_total) - np.repeat(row0, nrows)
    row_first = (f[leaf_of_row] + TRIS_PER_ROW * j_in_leaf).astype(np.int32)
    row_len = np.minimum(
        count[leaf_of_row] - TRIS_PER_ROW * j_in_leaf, TRIS_PER_ROW
    ).astype(np.int32)
    return em2, row_first, row_len


def stack_bound(entry_meta: np.ndarray) -> int:
    """Worst-case stack occupancy of the stack walk for a collapsed
    topology, assuming every pushed subtree stays live: sp peaks at
    sdep(w) + n_internal_children(w) during w's visit, where sdep(child) =
    sdep(parent) + (number of earlier-pushed internal siblings).  Computed by
    pointer-jumping path sums over the parent links."""
    em = np.asarray(entry_meta)
    w = em.shape[0]
    if w == 0:
        return 0
    is_int = em > 0  # internal child ids are >= 1 (0 == root, never a child)
    par = np.full(w, -1, np.int64)
    rank = np.zeros(w, np.int64)
    wi_i, e_i = np.nonzero(is_int)
    kids = em[wi_i, e_i].astype(np.int64)
    par[kids] = wi_i
    rank[kids] = (np.cumsum(is_int, axis=1) - 1)[wi_i, e_i]
    sdep = rank
    anc = par
    while (anc >= 0).any():
        live = anc >= 0
        a = np.maximum(anc, 0)
        sdep = sdep + np.where(live, sdep[a], 0)
        anc = np.where(live, anc[a], -1)
    return int((sdep + is_int.sum(axis=1)).max())


def _pad_rows(rows: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([rows, rows.new_zeros((n, rows.shape[1]))])


def rows_from_tids(tris: Triangles, row_tids: torch.Tensor) -> torch.Tensor:
    """(R, 8) tri ids -> (R + R_MAX_ROWS rounded up to 8, 128) packed rows,
    lane map in the module docstring.  The zero pad rows keep the array
    byte-identical to tpurt's; the CUDA walk never reads them."""
    r = row_tids.shape[0]
    ok = (row_tids >= 0)[..., None]
    g = row_tids.clamp_min(0).long()
    v0, v1, v2 = tris.corners()
    a, b, c = v0[g], v1[g], v2[g]
    zero = torch.zeros((), dtype=torch.float32, device=row_tids.device)
    dat = torch.cat([torch.where(ok, a, zero), torch.where(ok, b - a, zero),
                     torch.where(ok, c - a, zero)], dim=-1).reshape(r, 72)
    alb = torch.where(ok, tris.albedo[g], zero).reshape(r, 24)
    emi = torch.where(ok, tris.emission[g], zero).reshape(r, 24)
    rows = torch.cat([dat, encode_lane_i32(row_tids), alb, emi], dim=-1)
    padded = r + R_MAX_ROWS
    return _pad_rows(rows, R_MAX_ROWS + (-padded) % 8)


def rows_from_table(table: torch.Tensor, row_tids: torch.Tensor) -> torch.Tensor:
    """rows_from_tids sourced from a (T, 15) tri_table [v0, e1, e2, albedo,
    emission] built at the same vertices: one row gather, no arithmetic, so
    the rows are the table's values bit for bit.  Pass a detached table:
    rows are kernel structure, not a gradient path."""
    r = row_tids.shape[0]
    ok = (row_tids >= 0)[..., None]
    full = torch.where(ok, table[row_tids.clamp_min(0).long()], 0.0)  # (r, 8, 15)
    rows = torch.cat([full[..., 0:9].reshape(r, 72), encode_lane_i32(row_tids),
                      full[..., 9:12].reshape(r, 24), full[..., 12:15].reshape(r, 24)],
                     dim=-1)
    return _pad_rows(rows, R_MAX_ROWS + (-(r + R_MAX_ROWS)) % 8)


def _wrow_from_boxes(lo, hi, valid, entry_meta, own_lo, own_hi, escape,
                     has_int) -> torch.Tensor:
    """Entry boxes (W, 8, 3) + metas + own box + escape/flag -> packed
    (ceil(W/2) rounded up to 8, 128) f32 rows; empty slots get EMPTY_BOX."""
    w = entry_meta.shape[0]
    valid = valid[..., None]
    box = torch.cat([torch.where(valid, lo, EMPTY_BOX),
                     torch.where(valid, hi, EMPTY_BOX)], dim=-1).reshape(w, 48)
    row64 = torch.cat([
        box, encode_lane_i32(entry_meta), own_lo, own_hi,
        encode_lane_i32(escape)[:, None], encode_lane_i32(has_int)[:, None],
    ], dim=-1)
    wrow = _pad_rows(row64, w % 2).reshape(-1, 128)
    return _pad_rows(wrow, (-wrow.shape[0]) % 8)


def _assemble_wrow(node_lo, node_hi, entry_node, entry_meta, own_node, escape,
                   has_int) -> torch.Tensor:
    """Binary node boxes gathered into the wide layout (_wrow_from_boxes)."""
    g = entry_node.clamp_min(0).long()
    own = own_node.long()
    return _wrow_from_boxes(node_lo[g], node_hi[g], entry_node >= 0, entry_meta,
                            node_lo[own], node_hi[own], escape, has_int)


def refit_levels(entry_node, entry_meta, device) -> tuple:
    """The wide tree's levels for refit_wide_direct's sweep, deepest first:
    per level below the root, (node ids, parent ids, parent entry slots) as
    int64 tensors on `device`.  Computed once on the host from the topology."""
    en, em = np.asarray(entry_node), np.asarray(entry_meta)
    internal = (en >= 0) & (em > 0)  # 0 is the root, never a child
    levels, frontier = [], np.zeros(1, np.int64)
    while True:
        rows, slots = np.nonzero(internal[frontier])
        if rows.size == 0:
            break
        parent = frontier[rows]
        kids = em[parent, slots].astype(np.int64)
        levels.append(tuple(torch.as_tensor(x, device=device)
                            for x in (kids, parent, slots.astype(np.int64))))
        frontier = kids
    return tuple(reversed(levels))


def refit_wide_direct(wide: WideBVH, tris: Triangles,
                      table: torch.Tensor | None = None) -> WideBVH:
    """Box and row refit after the vertices moved, topology frozen: triangle
    boxes (band-inflated as build_lbvh does) fold into row boxes, leaf-entry
    boxes, and up the wide tree in one bottom-up sweep, one level at a time
    from the deepest.  Every child's level is below its parent's, so the
    sweep is exact at any depth.  min and max are exact in f32, so the boxes
    equal tpurt's fold bit for bit wherever that fold converged (it stops
    after 64 passes).

    table: the (T, 15) tri_table at the same vertices; corners are then
    v0 + e1 and v0 + e2 as in tpurt, and the rows come from rows_from_table.
    Runs without autograd: boxes and rows are kernel structure."""
    with torch.no_grad():
        if table is not None:
            table = table.detach()
            v0 = table[:, 0:3]
            v1 = v0 + table[:, 3:6]
            v2 = v0 + table[:, 6:9]
        else:
            v0, v1, v2 = (c.detach() for c in tris.corners())
        tri_lo = torch.minimum(torch.minimum(v0, v1), v2)
        tri_hi = torch.maximum(torch.maximum(v0, v1), v2)
        if wide.band > 0.0:
            pad = wide.band * ((v1 - v0).abs() + (v2 - v0).abs()) + 1e-7
            tri_lo = tri_lo - pad
            tri_hi = tri_hi + pad
        big = 3.0e38

        rt = wide.row_tids
        ok = (rt >= 0)[..., None]
        g = rt.clamp_min(0).long()
        rlo = torch.where(ok, tri_lo[g], big).amin(dim=1)        # (R, 3)
        rhi = torch.where(ok, tri_hi[g], -big).amax(dim=1)

        em = wide.entry_meta
        valid = wide.entry_node >= 0
        is_leaf = valid & (em < 0)
        row0 = ((~em) >> 3).clamp_min(0).long()
        n_rows = ((~em) & 7) + 1
        elo = torch.full(em.shape + (3,), big, dtype=torch.float32, device=em.device)
        ehi = torch.full_like(elo, -big)
        for r in range(wide.max_rows):
            take = (is_leaf & (r < n_rows))[..., None]
            idx = (row0 + r).clamp_max(rlo.shape[0] - 1)
            elo = torch.where(take, torch.minimum(elo, rlo[idx]), elo)
            ehi = torch.where(take, torch.maximum(ehi, rhi[idx]), ehi)

        vm = valid[..., None]
        levels = wide.levels
        if levels is None:
            levels = refit_levels(wide.entry_node.cpu(), em.cpu(), em.device)
        for kids, parent, slot in levels:
            elo[parent, slot] = torch.where(vm[kids], elo[kids], big).amin(dim=1)
            ehi[parent, slot] = torch.where(vm[kids], ehi[kids], -big).amax(dim=1)

        wrow = _wrow_from_boxes(
            elo, ehi, valid, em, torch.where(vm, elo, big).amin(dim=1),
            torch.where(vm, ehi, -big).amax(dim=1), wide.escape, wide.has_int)
        rows = (rows_from_table(table, rt) if table is not None
                else rows_from_tids(tris, rt))
    return dataclasses.replace(wide, wrow=wrow, tri_rows=rows, levels=levels)


def pack_wide(tris: Triangles, bvh: BVH, entry_node, entry_meta, own_node,
              escape, has_int, row_first, row_len, max_rows: int) -> WideBVH:
    """Assemble the device arrays for a collapsed topology (numpy arrays
    from `collapse_wide`) on the triangles' device."""
    max_stack = stack_bound(entry_meta)
    levels = refit_levels(entry_node, entry_meta, tris.device)
    entry_node, entry_meta, own_node, escape, has_int, row_first, row_len = (
        torch.as_tensor(x, device=tris.device) for x in
        (entry_node, entry_meta, own_node, escape, has_int, row_first, row_len))
    nt = bvh.tri_order.shape[0]
    j = torch.arange(TRIS_PER_ROW, device=tris.device)[None, :]
    tid = bvh.tri_order[(row_first[:, None].long() + j).clamp(0, nt - 1)]
    row_tids = torch.where(j < row_len[:, None], tid, -1).to(torch.int32)
    return WideBVH(
        wrow=_assemble_wrow(bvh.node_lo, bvh.node_hi, entry_node, entry_meta,
                            own_node, escape, has_int),
        tri_rows=rows_from_tids(tris, row_tids),
        entry_node=entry_node, entry_meta=entry_meta, own_node=own_node,
        escape=escape, has_int=has_int, row_tids=row_tids, band=bvh.band,
        max_stack=max_stack, max_rows=max_rows, levels=levels,
    )


def _auto_fat(num_tris: int) -> int:
    """Fat-leaf capacity: 8 for large scenes, 16 below 2^18 triangles (the
    reference's choice, measured on its TPU; not yet re-decided here)."""
    return 8 if num_tris >= (1 << 18) else FAT_TRIS


def node_areas(node_lo, node_hi) -> np.ndarray:
    """Surface area of every node box in float64 on the host (tpurt's
    node_areas, the SAH split priority of its tests)."""
    lo, hi = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.float64)
              for x in (node_lo, node_hi))
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])


def node_area_priority(bvh: BVH) -> np.ndarray:
    """Surface area of every node box, computed in float32 on the device in
    tpurt's op order: the split priority must match it bit for bit, or ties
    and near-ties reorder the collapse."""
    d = torch.clamp_min(bvh.node_hi - bvh.node_lo, 0.0)
    area = 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])
    return area.cpu().numpy()


def collapse_wide(tris: Triangles, bvh: BVH, fat_tris: int | None = None,
                  split_rule: str = "area"):
    """The host half of build_wide: the greedy collapse and the leaf-aligned
    row map.  split_rule "area" (the default, tpurt's) splits the frontier
    node of largest surface area first; "count" the one with the most
    triangles.  Returns pack_wide's topology arguments: (entry_node,
    entry_meta, own_node, escape, has_int, row_first, row_len) as numpy
    arrays and max_rows."""
    if split_rule == "area":
        priority = node_area_priority(bvh)
    elif split_rule == "count":
        priority = None
    else:
        raise ValueError(split_rule)
    if fat_tris is None:
        fat_tris = _auto_fat(tris.num_tris)
    left, right, first, last = (x.cpu().numpy() for x in
                                (bvh.left, bvh.right, bvh.first, bvh.last))
    en, em, own, esc, has_int = collapse8(left, right, first, last, fat_tris, priority)
    em, row_first, row_len = align_leaf_rows(en, em, first, last)
    # Lane-codec range guard: a wrapped encoding would decode to a wrong
    # leaf row or triangle id with no error.
    for name, arr in (("entry_meta", em), ("escape", esc),
                      ("tri_id", tris.num_tris - 1)):
        a = np.asarray(arr)
        if a.min() < LANE_MIN or a.max() > LANE_MAX:
            raise ValueError(
                f"build_wide: {name} range [{a.min()}, {a.max()}] exceeds the "
                f"f32 lane codec range [{LANE_MIN}, {LANE_MAX}]")
    return (en, em, own, esc, has_int, row_first, row_len,
            -(-fat_tris // TRIS_PER_ROW))


def build_wide(tris: Triangles, bvh: BVH, fat_tris: int | None = None,
               split_rule: str = "area") -> WideBVH:
    """Collapse (host) + pack (on the triangles' device).  split_rule: see
    collapse_wide.  tpurt measured area 5-10% faster in closest-hit time
    than count on its TPU; on the card chip_smoke.py's [split_rule] times
    both."""
    return pack_wide(tris, bvh, *collapse_wide(tris, bvh, fat_tris, split_rule))


def refit_wide(wide: WideBVH, bvh: BVH, tris: Triangles,
               table: torch.Tensor | None = None) -> WideBVH:
    """Box and row update after the vertices moved, topology frozen: entry
    boxes gathered from an already-refit BVH (accel/refit.py refit_aabbs),
    rows from `table` (the (T, 15) tri_table at the same vertices, one row
    gather) or from the triangles.  refit_wide_direct computes the same
    boxes without the binary tree."""
    with torch.no_grad():
        if table is not None:
            table = table.detach()
        wrow = _assemble_wrow(bvh.node_lo, bvh.node_hi, wide.entry_node, wide.entry_meta,
                              wide.own_node, wide.escape, wide.has_int)
        rows = (rows_from_table(table, wide.row_tids) if table is not None
                else rows_from_tids(tris, wide.row_tids))
    return dataclasses.replace(wide, wrow=wrow, tri_rows=rows)


def wide_bytes(wide: WideBVH) -> int:
    return wide.wrow.numel() * 4


def tri_rows_bytes(wide: WideBVH) -> int:
    return wide.tri_rows.numel() * 4
