"""The packet engine's hard-frame kernels (csrc/packet.cu packet_closest,
packet_occluded) as designed for Hopper, rendered in numpy float32 and
held to their plain-torch twins, and the property of the packed layout
their window of node records relies on.

(1) The forward cursor.  In the packed layout an internal node's first
child is node + 1 and its second escape[node + 1], and every escape link
is -1 or lies past the node, so a packet's cursor only moves forward.
Checked against the LBVH's own children (BVH.left, right and dfs) on
cornell, bunny-3K, a 20K-triangle sponza, one triangle and 64 coincident
triangles, at band 0 and 0.08.

(2) The kernels' loops, statement for statement, one packet at a time:
kThreads = 1024 / R threads, each walking R rays (ray j of thread t is
ray 1024 p + j kThreads + t), one packet a CTA.  A visit reads its node's
record from the packet's window of kWindow records [base, base +
kWindow) in shared memory; a cursor outside it refills it from the cursor
on (the records below num_nodes; window_record).  Then the vote:
__syncthreads_or of each thread's OR over its R rays' slab tests (an
any-hit ray that is blocked does not vote).  A wanted leaf's row and ids
are staged, its 8 slots tested slot by slot against every ray; the
any-hit walk then ends once every ray, pad rays included, is blocked
(__syncthreads_and).  Rendered at the kernels' R and kWindow (read from
packet.cu) and at R = 1, on cornell 64^2 and bunny-3K 48^2 row-major
frames (the bunny's last packet holds 256 rays and 768 pad rays) and on
tests/test_torch_packet.py's bunny groups (P1's tiny negative components
among them), with a seeded per-ray t_max for the any-hit walk; held
bitwise to traverse_packet_ref / occluded_packet_ref, and their visit and
leaf-visit counts equal to the twins' stats.  Each record a visit reads
from the window is also held to the node's own record in the layout, and
a window slot past the layout's rows is never read.  The designs that
lost their turns on the card (PERF.md: successors' records and the
leaf row fetched before the vote, persistent CTAs) are not rendered.

(3) packet_knear's loop, the same walk with each ray's list of k (t, id)
pairs: the lists slot-major in the kernel's shared memory (slot s of ray j
of thread t at word s * 1024 + j * kThreads + t), each ray's k-th entry
read there (the visit's bound min(k-th t, t_max) and the candidate's
reject test), an accepted candidate inserted by tpurt's rule (position =
the count of live entries below it, the later ones shifted up).  Rendered at the kernel's R for each list bound KM (read
from packet.cu) and at the other R, at k = 1, 4, 8 and 16 on cornell 64^2 and
bunny-3K 48^2 (the bunny's last packet ragged), and on the bunny groups
at k = 4, where P3's band-corner candidates are found through the packet;
held bitwise to k_nearest_ids_packet_ref on the band-0.08 tree, with its
visit and leaf-visit counts.
"""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_packet import _inputs, _port_tris
from tests.test_torch_traverse8 import _mt_numpy_det, _trays
from tpurt_torch.accel.intersect import DEFAULT_T_MIN
from tpurt_torch.accel.lbvh import build_lbvh
from tpurt_torch.accel.packet import LEAF_CAP, max_cut_leaves, pack_bvh
from tpurt_torch.accel.traverse_ref import safe_inv
from tpurt_torch.core.geometry import T_MAX, Triangles
from tpurt_torch.core.scene import make_bunny_scene, make_cornell_box, make_sponza_scene
from tpurt_torch.kernels import packet as kp
from tpurt_torch.kernels import traverse as kb

f32 = np.float32
T_MIN = f32(DEFAULT_T_MIN)
PACKET_CU = pathlib.Path(kp.__file__).parent / "csrc" / "packet.cu"
BANDS = (0.0, 0.08)
CASES = ("cornell64", "bunny48", "groups")


def _kernel_constant(name: str) -> int:
    """A constexpr int of csrc/packet.cu (kRays, kWindow, ...)."""
    return int(re.search(rf"constexpr int {name} = (\d+);", PACKET_CU.read_text()).group(1))


RAYS, WINDOW = _kernel_constant("kRays"), _kernel_constant("kWindow")
BAND = 0.08


def knear_shape(km: int) -> tuple[int, int]:
    """(rays a thread, packets an SM) of packet_knear_kernel<km>, read from
    packet.cu's KnearShape."""
    src = PACKET_CU.read_text()
    body = src[src.index("struct KnearShape {"):]
    body = body[:body.index("};")]
    env = {"kRays": RAYS, "kPacket": kp.PACKET_RAYS, "kCtas": _kernel_constant("kCtas"),
           "KM": km}

    def value(name):
        expr = re.search(rf"{name} = (.+?);", body).group(1)
        expr = re.sub(r"(.+?) \? (.+?) : (.+)", r"(\2 if \1 else \3)", expr)
        return eval(expr, {}, env)  # noqa: S307 - a constant expression of the source

    return value("rays"), value("ctas")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (1) The forward cursor
# ---------------------------------------------------------------------------
def _scene_tris(name: str) -> Triangles:
    if name == "cornell":
        return make_cornell_box(device="cpu")[0].tris
    if name == "bunny3k":
        return make_bunny_scene(num_tris=3000, device="cpu")[0].tris
    if name == "sponza20k":
        return make_sponza_scene(num_tris=20_000, device="cpu")[0].tris
    verts = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    faces = np.zeros((1 if name == "one" else 64, 3), np.int32) + [0, 1, 2]
    return Triangles.create(verts, faces, device="cpu")


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("name", ("cornell", "bunny3k", "sponza20k", "one", "coincident"))
def test_cursor_only_moves_forward(name, band):
    tris = _scene_tris(name)
    bvh = build_lbvh(tris, band=band)
    packed = pack_bvh(tris, bvh, max_cut_leaves(tris.num_tris, LEAF_CAP))
    esc = packed.node_i32[:, 0].numpy()
    leaf = packed.node_i32[:, 3].numpy() > 0
    # the walk that wants every node visits each live node once, in order
    order, node = [], 0
    while node >= 0:
        order.append(node)
        node = esc[node] if leaf[node] else node + 1
    live = np.asarray(order)
    assert np.array_equal(live, np.arange(live.size))
    assert ((esc[live] == -1) | (esc[live] > live)).all()
    # an internal node's children, by the LBVH's own left and right
    dfs, left, right = bvh.dfs.numpy(), bvh.left.numpy(), bvh.right.numpy()
    n_internal = 0
    for r in range(tris.num_tris - 1):
        f = dfs[r]
        if f < live.size and not leaf[f]:
            n_internal += 1
            assert dfs[left[r]] == f + 1
            assert dfs[right[r]] == esc[f + 1]
    assert n_internal == (~leaf[live]).sum()
    # the live leaves' rows hold every triangle once
    ids = packed.tri_ids.numpy()[packed.node_i32[live[leaf[live]], 1].numpy()]
    assert np.array_equal(np.sort(ids[ids >= 0]), np.arange(tris.num_tris))


# ---------------------------------------------------------------------------
# (2) The kernels' loops in numpy
# ---------------------------------------------------------------------------
class Packet:
    """One packet's rays as the kernel holds them: (kThreads, R) arrays,
    ray j of thread t at index 1024 p + j kThreads + t, pad rays (o = d =
    0, inv = 1e30, t_max = 0) past n."""

    def __init__(self, o, d, tmax, p: int, rays: int):
        threads = kp.PACKET_RAYS // rays
        idx = p * kp.PACKET_RAYS + np.arange(rays)[None, :] * threads + np.arange(threads)[:, None]
        self.idx, self.real = idx, idx < o.shape[0]
        safe = np.where(self.real, idx, 0)
        self.o = np.where(self.real[..., None], o[safe], f32(0))
        self.d = np.where(self.real[..., None], d[safe], f32(0))
        self.inv = safe_inv(torch.from_numpy(self.d)).numpy()
        self.tmax = np.where(self.real, tmax[safe], f32(0)) if tmax is not None else None


def _slab(a, b, pk: Packet, upper):
    """slab_bin_n over every ray of the packet: a = (lo.x, lo.y, lo.z,
    hi.x), b = (hi.y, hi.z, 0, 0), nmin/nmax as NaN-propagating np.minimum
    and np.maximum."""
    o, inv = pk.o, pk.inv
    with np.errstate(over="ignore", invalid="ignore"):
        tx0, tx1 = (a[0] - o[..., 0]) * inv[..., 0], (a[3] - o[..., 0]) * inv[..., 0]
        ty0, ty1 = (a[1] - o[..., 1]) * inv[..., 1], (b[0] - o[..., 1]) * inv[..., 1]
        tz0, tz1 = (a[2] - o[..., 2]) * inv[..., 2], (b[1] - o[..., 2]) * inv[..., 2]
    mn, mx = np.minimum, np.maximum
    t_near = mx(mx(mn(tx0, tx1), mn(ty0, ty1)), mx(mn(tz0, tz1), T_MIN))
    t_far = mn(mn(mx(tx0, tx1), mx(ty0, ty1)), mn(mx(tz0, tz1), upper))
    return t_near <= t_far


def _mt(tri9, pk: Packet):
    """mt() of one triangle against every ray: t, u, v, det (kThreads, R)."""
    shape = pk.o.shape[:2]
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        t, u, v, det = _mt_numpy_det(pk.o.reshape(-1, 3), pk.d.reshape(-1, 3), tri9[None])
    return t.reshape(shape), u.reshape(shape), v.reshape(shape), det.reshape(shape)


class Layout:
    """The packed layout as the kernel reads it: a node's 48-byte record
    (node_f32 row, node_i32 row) and a leaf's row (72 floats) and ids."""

    def __init__(self, packed):
        self.nf, self.ni = packed.node_f32.numpy(), packed.node_i32.numpy()
        self.rows, self.ids = packed.tri_rows.numpy(), packed.tri_ids.numpy()
        self.num_nodes = self.nf.shape[0]

    def fetch_rec(self, node: int):
        return self.nf[node, :4], self.nf[node, 4:], self.ni[node]

    def fetch_leaf(self, row: int):
        return self.rows[row, :9 * LEAF_CAP].reshape(LEAF_CAP, 9), self.ids[row]


def _walk(lay: Layout, pk: Packet, upper, voters, on_leaf, done, counts):
    """The visit loop both kernels share: window_record, the vote, the
    staged leaf; on_leaf(tri, sid) tests a wanted leaf, done() is the
    any-hit walk's __syncthreads_and after it (None for the closest
    hit)."""
    win, base = [None] * WINDOW, -WINDOW  # s_win; base starts before node 0
    node = 0
    while node >= 0:
        if not 0 <= node - base < WINDOW:  # window_record: refill from the cursor on
            base = node
            for q in range(WINDOW):
                if base + q < lay.num_nodes:
                    win[q] = lay.fetch_rec(base + q)
        a, b, r = win[node - base]
        for got, want in zip((a, b, r), lay.fetch_rec(node)):
            assert np.array_equal(got, want)
        passes = _slab(a, b, pk, upper())
        if voters is not None:
            passes &= voters()
        any_t = passes.any(axis=1)  # each thread's OR over its R rays
        want = bool(any_t.any())    # __syncthreads_or
        leaf = r[3] > 0
        counts["visits"] += 1
        if want and leaf:
            counts["rows"] += 1
            on_leaf(*lay.fetch_leaf(r[1]))  # stage_leaf, then the slots
            if done is not None and done():  # __syncthreads_and
                break
        node = node + 1 if want and not leaf else int(r[0])


def closest_loop(lay: Layout, pk: Packet, counts):
    """packet_closest_kernel's closest_packet: (t, u, v, id) (kThreads, R)."""
    tb = np.full(pk.o.shape[:2], f32(T_MAX))
    ub, vb = np.zeros_like(tb), np.zeros_like(tb)
    ib = np.full(tb.shape, -1, np.int32)

    def on_leaf(tri, sid):
        for k in range(LEAF_CAP):  # slot by slot, every ray
            tid = sid[k]
            t, u, v, det = _mt(tri[k], pk)
            better = (t < tb) | ((t == tb) & (tid < ib) & (ib >= 0))
            ok = ((np.abs(det) > f32(1e-12)) & (u >= 0) & (v >= 0) & (u + v <= 1)
                  & (t > T_MIN) & better & (tid >= 0))
            tb[ok], ub[ok], vb[ok], ib[ok] = t[ok], u[ok], v[ok], tid

    _walk(lay, pk, lambda: tb, None, on_leaf, None, counts)
    return tb, ub, vb, ib


def occluded_loop(lay: Layout, pk: Packet, counts):
    """packet_occluded_kernel's occluded_packet: blocked (kThreads, R)."""
    blocked = np.zeros(pk.o.shape[:2], bool)

    def on_leaf(tri, sid):
        for k in range(LEAF_CAP):
            tid = sid[k]
            t, u, v, det = _mt(tri[k], pk)
            blocked[...] |= ((np.abs(det) > f32(1e-12)) & (u >= 0) & (v >= 0) & (u + v <= 1)
                             & (t > T_MIN) & (t < pk.tmax) & (tid >= 0))

    _walk(lay, pk, lambda: pk.tmax, lambda: ~blocked, on_leaf, lambda: blocked.all(), counts)
    return blocked


@pytest.fixture(scope="module", params=CASES)
def frame(request):
    jt, o, d, tmax, groups = _inputs(request.param)
    tris = _port_tris(jt)
    packed = pack_bvh(tris, build_lbvh(tris), max_cut_leaves(tris.num_tris, LEAF_CAP))
    return dict(name=request.param, o=o, d=d, tmax=tmax, packed=packed, groups=groups)


def _scatter(pk: Packet, out: np.ndarray, vals: np.ndarray) -> None:
    out[pk.idx[pk.real]] = vals[pk.real]


@pytest.mark.parametrize("rays", sorted({RAYS, 1}))
def test_closest_loop_matches_twin(frame, rays):
    o, d, packed = frame["o"], frame["d"], frame["packed"]
    n = o.shape[0]
    lay, counts = Layout(packed), dict(visits=0, rows=0)
    got = [np.zeros(n, f32), np.zeros(n, f32), np.zeros(n, f32), np.zeros(n, np.int32)]
    for p in range(-(-n // kp.PACKET_RAYS)):
        pk = Packet(o, d, None, p, rays)
        for out, vals in zip(got, closest_loop(lay, pk, counts)):
            _scatter(pk, out, vals)
    stats = {}
    ref = kp.traverse_packet_ref(_trays(o, d), packed, stats=stats)
    for g, r in zip(got[:3], (ref.t, ref.u, ref.v)):
        assert np.array_equal(g.view(np.int32), r.numpy().view(np.int32))
    assert np.array_equal(got[3], ref.tri.numpy())
    assert counts == {"visits": stats["visits"], "rows": int(stats["rows"])}
    assert (got[3] >= 0).any() and (got[3] < 0).any() or frame["name"] == "cornell64"
    if frame["groups"] is not None:  # P1: hit through the packet
        assert (got[3][frame["groups"]["tiny_neg31"]] >= 0).any()


@pytest.mark.parametrize("rays", sorted({RAYS, 1}))
def test_occluded_loop_matches_twin(frame, rays):
    o, d, tmax, packed = frame["o"], frame["d"], frame["tmax"], frame["packed"]
    n = o.shape[0]
    lay, counts = Layout(packed), dict(visits=0, rows=0)
    got = np.zeros(n, bool)
    for p in range(-(-n // kp.PACKET_RAYS)):
        pk = Packet(o, d, tmax, p, rays)
        _scatter(pk, got, occluded_loop(lay, pk, counts))
    stats = {}
    ref = kp.occluded_packet_ref(_trays(o, d), packed, torch.from_numpy(tmax), stats=stats)
    assert np.array_equal(got, ref.numpy())
    assert counts == {"visits": stats["visits"], "rows": int(stats["rows"])}
    assert 0 < got.mean() < 1


def test_kernels_take_the_rendered_shape():
    """The rendering's constants are the kernels': 1,024 rays a packet,
    kRays a thread, both hard-frame walks at __launch_bounds__(kThreads,
    kCtas) with kCtas packets' threads within an SM's 2,048, and stage_leaf
    (72 floats and 8 ids, one a thread) inside a CTA."""
    src = PACKET_CU.read_text()
    threads = _kernel_constant("kThreads")
    assert _kernel_constant("kPacket") == kp.PACKET_RAYS == threads * RAYS
    assert src.count("__launch_bounds__(kThreads, kCtas)") == 2
    assert _kernel_constant("kCtas") * threads <= 2048 and threads >= 72 + LEAF_CAP


def test_walk_ab_holds_packet_cells_bitwise():
    """chip_smoke.py's [walk_ab] fails a packet cell on any ray whose
    outputs differ in any bit (differing_bits): a t that differs only in
    the sign of a zero, or in a NaN's payload, counts; equal outputs do
    not."""
    tri = torch.tensor([3, -1, 7, 2], dtype=torch.int32)
    t = torch.tensor([1.5, T_MAX, 0.0, float("nan")])
    uv = torch.tensor([0.25, 0.0, 0.5, 0.125])
    ref = (tri, t, uv, uv)
    assert chip_smoke.differing_bits(ref, tuple(x.clone() for x in ref)) == 0
    t2 = t.clone()
    t2[2] = -0.0
    t2[3] = torch.tensor(0x7FC00001, dtype=torch.int32).view(torch.float32)
    assert chip_smoke.differing_bits(ref, (tri, t2, uv, uv)) == 2
    flags = torch.tensor([1, 0, 1], dtype=torch.uint8)
    assert chip_smoke.differing_bits((flags,), (torch.tensor([1, 1, 1], dtype=torch.uint8),)) == 1


# ---------------------------------------------------------------------------
# (3) packet_knear's loop
# ---------------------------------------------------------------------------
def knear_loop(lay: Layout, pk: Packet, k: int, km: int, counts):
    """packet_knear_kernel<km>'s walk: ids (kThreads, R, k)."""
    threads, rays = pk.o.shape[:2]
    # s_dyn: ts then li, slot s of ray j of thread t at s * 1024 + j * T + t
    word = np.arange(rays)[None, :] * threads + np.arange(threads)[:, None]
    ts = np.full(km * kp.PACKET_RAYS, f32(T_MAX))
    li = np.full(km * kp.PACKET_RAYS, -1, np.int32)
    kth = (k - 1) * kp.PACKET_RAYS + word  # each ray's k-th entry, (kThreads, R)
    neg_band, band_hi = f32(-BAND), f32(1.0 + BAND)

    def insert(th, j, t, tid):
        """list_insert for the threads th of ray j, each with candidate t."""
        at = [s * kp.PACKET_RAYS + j * threads + th for s in range(km)]
        pos = np.zeros(th.size, np.int64)
        for s in range(km):
            e = ts[at[s]]
            pos += (s < k) & ((e < t) | ((e == t) & (li[at[s]] < tid)))
        for s in range(km - 1, 0, -1):
            m = (s < k) & (s > pos)
            ts[at[s][m]] = ts[at[s - 1][m]]
            li[at[s][m]] = li[at[s - 1][m]]
        ts[pos * kp.PACKET_RAYS + j * threads + th] = t
        li[pos * kp.PACKET_RAYS + j * threads + th] = tid

    def on_leaf(tri, sid):
        for q in range(LEAF_CAP):
            tid = sid[q]
            t, u, v, det = _mt(tri[q], pk)
            for j in range(rays):  # the kernel's unrolled loop over a thread's rays
                tj, kt, kid = t[:, j], ts[kth[:, j]], li[kth[:, j]]
                ok = ((np.abs(det[:, j]) > f32(1e-12)) & (u[:, j] >= neg_band)
                      & (v[:, j] >= neg_band) & (u[:, j] + v[:, j] <= band_hi) & (tj > T_MIN)
                      & (tj < pk.tmax[:, j]) & (tid >= 0)
                      & ((tj < kt) | ((tj == kt) & (tid < kid))))
                th = np.nonzero(ok)[0]
                if th.size:
                    insert(th, j, tj[th], tid)

    _walk(lay, pk, lambda: np.minimum(ts[kth], pk.tmax), None, on_leaf, None, counts)
    return np.stack([li[s * kp.PACKET_RAYS + word] for s in range(k)], axis=-1)


@functools.cache
def _band_frame(name: str) -> dict:
    jt, o, d, tmax, groups = _inputs(name)
    tris = _port_tris(jt)
    packed = pack_bvh(tris, build_lbvh(tris, band=BAND), max_cut_leaves(tris.num_tris, LEAF_CAP))
    return dict(name=name, o=o, d=d, tmax=tmax, packed=packed, groups=groups)


@pytest.mark.parametrize("name,k", [(name, k) for name in ("cornell64", "bunny48")
                                    for k in (1, 4, 8, 16)] + [("groups", 4)])
def test_knear_loop_matches_twin(name, k):
    """The lists at the kernel's R for k's list bound; the k-nearest walk's
    t_max is each ray's own (seeded), so some rays take no candidate.  The
    bunny groups at k = 4 hold P3."""
    km = next(m for m in (4, 8, 16) if k <= m)
    _knear_matches_twin(_band_frame(name), k, km, knear_shape(km)[0])


@pytest.mark.parametrize("name,km", [(name, km) for name in ("cornell64", "bunny48")
                                     for km in (4, 16)])
def test_knear_loop_at_the_other_ray_count(name, km):
    """The lists at the R the kernel does not take for km (1 for KM 4, 2
    for KM 16): the results do not depend on which thread walks which
    ray."""
    _knear_matches_twin(_band_frame(name), km, km, 3 - knear_shape(km)[0])


def _knear_matches_twin(frame, k: int, km: int, rays: int) -> None:
    o, d, tmax, packed = frame["o"], frame["d"], np.abs(frame["tmax"]), frame["packed"]
    n = o.shape[0]
    lay, counts = Layout(packed), dict(visits=0, rows=0)
    got = np.zeros((n, k), np.int32)
    for p in range(-(-n // kp.PACKET_RAYS)):
        pk = Packet(o, d, tmax, p, rays)
        _scatter(pk, got, knear_loop(lay, pk, k, km, counts))
    stats = {}
    ref = kp.k_nearest_ids_packet_ref(_trays(o, d), packed, k, BAND,
                                      t_max=torch.from_numpy(tmax), stats=stats)
    assert np.array_equal(got, ref.numpy())
    assert counts == {"visits": stats["visits"], "rows": int(stats["rows"])}
    assert (got[:, 0] >= 0).any() and (got[:, -1] < 0).any()
    if frame["groups"] is not None:  # P3: band hits found through the packet
        per_ray = kb.k_nearest_ids_packed_ref(_trays(o, d), packed, k, BAND,
                                              t_max=torch.from_numpy(tmax)).numpy()
        p1 = np.zeros(n, bool)
        p1[frame["groups"]["tiny_neg31"]] = True
        assert ((got != per_ray).any(axis=1) & ~p1).any()


def test_knear_lists_take_the_rendered_layout():
    """The k-nearest kernel's shape: two packets an SM where two packets'
    lists (KM x 8 KB each) and windows fit the SM's 228 KB, one at KM 16;
    R rays a thread, kPacket / R threads; slot s of ray j of thread t at
    word s * 1024 + j * T + t puts a warp's 32 lanes on 32 banks for every
    s and j."""
    window = 48 * WINDOW + 4 * (72 + LEAF_CAP)
    for km in (4, 8, 16):
        rays, ctas = knear_shape(km)
        threads = kp.PACKET_RAYS // rays
        assert threads * rays == kp.PACKET_RAYS and threads >= 72 + LEAF_CAP
        assert ctas * (2 * km * kp.PACKET_RAYS * 4 + window + 1024) <= 228 * 1024
        assert ctas == (2 if km <= 8 else 1)
        lanes = np.arange(32)
        for s in range(km):
            for j in range(rays):
                assert np.unique((s * kp.PACKET_RAYS + j * threads + lanes) % 32).size == 32
