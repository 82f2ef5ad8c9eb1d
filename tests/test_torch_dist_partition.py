"""tpurt_torch's dist/ scene partition against tpurt's, in this process:
partition_scene, the per-partition trees, ray routing; and the dist paths
at world 1 (a gloo group of one process).

Bitwise, as tpurt's own arrays are exact: partition_scene's gid, corners,
albedo and boxes at n_parts 1, 2, 4 and 8, with and without padding rows;
each partition's WideBVH and PackedBVH at band 0 (tpurt's builders run a
jitted build_lbvh, which at band > 0 contracts the band pad into an FMA,
ROADMAP P4, so band trees are held through what their walks return in the
ring tests); aabb_entry_t and route_rays.  tpurt stacks the partitions'
WideBVHs padded to a common shape; each of the port's is held to its slice
cut to its own shape, and the padding tpurt adds is checked to be its fill.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests.dist_ranks import one_thread
from tpurt.core.geometry import Triangles as JTriangles
from tpurt.core.scene import make_bunny_scene as j_make_bunny_scene
from tpurt.dist import scene_partition as jsp
from tpurt.render.camera import gen_primary_rays as j_gen_primary_rays

from tpurt_torch.api import config as tconfig
from tpurt_torch.api.config import FitConfig, RenderConfig
from tpurt_torch.api.inverse import InverseRenderer
from tpurt_torch.api.renderer import Renderer
from tpurt_torch.core.geometry import Rays, Triangles
from tpurt_torch.core.scene import make_bunny_scene, make_cornell_box
from tpurt_torch.dist import scene_partition as tsp
from tpurt_torch.dist.ring import ring_trace
from tpurt_torch.dist.runtime import init_distributed, is_coordinator
from tpurt_torch.dist.shard import make_mesh, pad_rays, shard_render
from tpurt_torch.render.pipeline import make_tracer, render, tri_table

WIDE_FIELDS = ("wrow", "tri_rows", "entry_node", "entry_meta", "own_node", "escape",
               "has_int", "row_tids")
PACKED_FIELDS = ("node_f32", "node_i32", "tri_rows", "tri_ids")


def np_scene(js) -> dict:
    """A tpurt Scene as scene_from_numpy's arguments."""
    a = np.asarray
    return dict(verts=a(js.tris.verts), faces=a(js.tris.faces), albedo=a(js.tris.albedo),
                emission=a(js.tris.emission), light_pos=a(js.lights.pos),
                light_intensity=a(js.lights.intensity), background=a(js.background),
                ambient=a(js.ambient))


def np_cam(jc) -> dict:
    a = np.asarray
    return dict(eye=a(jc.eye), target=a(jc.target), up=a(jc.up), fov_y_deg=a(jc.fov_y_deg),
                width=jc.width, height=jc.height)


def np_tris(jt) -> dict:
    a = np.asarray
    return dict(verts=a(jt.verts), faces=a(jt.faces), albedo=a(jt.albedo),
                emission=a(jt.emission))


def port_tris(t: dict) -> Triangles:
    return Triangles.create(t["verts"], t["faces"], t["albedo"], t["emission"], device="cpu")


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def soup(f: int, seed: int = 7):
    """tpurt's dist test soup: f random triangles, and the same as the
    port's Triangles."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2, 2, (f, 3)).astype(np.float32)
    offs = rng.normal(0, 0.5, (f, 3, 3)).astype(np.float32)
    verts = (centers[:, None, :] + offs).reshape(-1, 3)
    faces = np.arange(3 * f).reshape(f, 3)
    jt = JTriangles.create(verts, faces)
    return jt, port_tris(np_tris(jt))


@pytest.fixture(scope="module")
def bunny():
    js, _ = j_make_bunny_scene(num_tris=2000)
    return js.tris, port_tris(np_tris(js.tris))


# n_parts, and the soup sizes: 37 leaves padding rows at 2, 4 and 8; 40 none
@pytest.mark.parametrize("n_parts", [1, 2, 4, 8])
@pytest.mark.parametrize("f", [37, 40])
def test_partition_scene_bitwise(n_parts, f):
    jt, tt = soup(f)
    jp, tp = jsp.partition_scene(jt, n_parts), tsp.partition_scene(tt, n_parts)
    assert tp.n_parts == jp.n_parts and tp.chunk == jp.chunk
    assert (tp.gid < 0).any() == (n_parts * tp.chunk > f)
    for field in ("v0", "v1", "v2", "albedo", "gid", "lo", "hi"):
        a, b = np.asarray(getattr(jp, field)), getattr(tp, field).numpy()
        assert a.shape == b.shape and np.array_equal(bits(a), bits(b)), field


def test_partition_scene_bitwise_on_the_bunny(bunny):
    jt, tt = bunny
    for n in (3, 4):
        jp, tp = jsp.partition_scene(jt, n), tsp.partition_scene(tt, n)
        for field in ("v0", "v1", "v2", "albedo", "gid", "lo", "hi"):
            assert np.array_equal(bits(getattr(jp, field)), bits(getattr(tp, field).numpy()))


@pytest.mark.parametrize("n_parts,f", [(2, 37), (4, 37), (3, 2000)])
def test_partition_wides_bitwise_at_band_0(bunny, n_parts, f):
    """Each partition's WideBVH equals tpurt's stacked slice, cut to its
    shape; what tpurt pads past it is its fill (-1 for ids, 0 else)."""
    jt, tt = bunny if f == 2000 else soup(f)
    jp, tp = jsp.partition_scene(jt, n_parts), tsp.partition_scene(tt, n_parts)
    jw = jsp.build_partition_wides(jp, jt)
    tws = tsp.build_partition_wides(tp, tt)
    assert len(tws) == n_parts
    for p, tw in enumerate(tws):
        one = tsp.build_partition_wides(tp, tt, index=p)
        for field in WIDE_FIELDS:
            got = getattr(tw, field).numpy()
            assert np.array_equal(got, getattr(one, field).numpy()), field
            ref = np.asarray(getattr(jw, field))[p]
            cut = ref[tuple(slice(0, s) for s in got.shape)]
            assert np.array_equal(bits(cut), bits(got)), (p, field)
            rest = ref.copy()
            rest[tuple(slice(0, s) for s in got.shape)] = (
                -1 if field in ("entry_node", "row_tids", "escape") else 0)
            fill = -1 if field in ("entry_node", "row_tids", "escape") else 0
            assert (rest == fill).all(), (p, field)
        assert tw.band == jw.band
        assert tw.max_stack <= jw.max_stack and tw.max_rows <= jw.max_rows
    assert max(w.max_stack for w in tws) == jw.max_stack
    # padding rows (gid -1) enter a partition's tree as -1 slots
    if n_parts * tp.chunk > f:
        assert (tws[-1].row_tids.numpy() == -1).sum() > 0


@pytest.mark.parametrize("n_parts,f", [(2, 37), (4, 37), (3, 2000)])
def test_partition_bvhs_bitwise_at_band_0(bunny, n_parts, f):
    jt, tt = bunny if f == 2000 else soup(f)
    jp, tp = jsp.partition_scene(jt, n_parts), tsp.partition_scene(tt, n_parts)
    jb = jsp.build_partition_bvhs(jp)
    for p, tb in enumerate(tsp.build_partition_bvhs(tp)):
        for field in PACKED_FIELDS:
            a, b = np.asarray(getattr(jb, field))[p], getattr(tb, field).numpy()
            assert a.shape == b.shape and np.array_equal(bits(a), bits(b)), (p, field)
        assert tb.band == jb.band


def test_aabb_entry_and_route_rays_bitwise(bunny):
    jt, tt = bunny
    jp, tp = jsp.partition_scene(jt, 4), tsp.partition_scene(tt, 4)
    js, jc = j_make_bunny_scene(num_tris=2000)
    r = j_gen_primary_rays(jc.replace(width=40, height=24))
    o, d = np.array(r.o), np.array(r.d)
    d[::7] *= -1.0            # rays that enter no box
    d[5::11, 1] = 0.0         # zero components: the 1e-20 guard
    d[6::13, 2] = -1e-25
    got = tsp.aabb_entry_t(torch.from_numpy(o), torch.from_numpy(d), tp.lo, tp.hi).numpy()
    ref = np.asarray(jsp.aabb_entry_t(jnp.asarray(o), jnp.asarray(d), jp.lo, jp.hi))
    assert np.array_equal(bits(ref), bits(got))
    assert (got >= 1e29).any() and (got < 1e29).any()
    from tpurt.core.geometry import Rays as JRays

    owner = tsp.route_rays(Rays(o=torch.from_numpy(o), d=torch.from_numpy(d)), tp)
    assert np.array_equal(np.asarray(jsp.route_rays(JRays(o=jnp.asarray(o),
                                                          d=jnp.asarray(d)), jp)),
                          owner.numpy())
    assert owner.dtype == torch.int32 and owner.shape == (o.shape[0],)


def test_dist_config_matches_tpurt():
    from tpurt.api import config as jconfig

    got = [(f.name, f.default) for f in dataclasses.fields(tconfig.DistConfig)]
    assert got == [(f.name, f.default) for f in dataclasses.fields(jconfig.DistConfig)]


# ---------------------------------------------------------------------------
# world 1: a gloo group of this process alone
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh1():
    owned = not dist.is_initialized()
    init_distributed(device="cpu")
    yield make_mesh("cpu")
    if owned:
        dist.destroy_process_group()


def test_world_1_group_and_mesh(mesh1):
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert mesh1.size() == 1 and mesh1.mesh_dim_names == ("rays",) and is_coordinator()


def test_world_1_ring_is_the_partitioned_scene(mesh1, bunny):
    """At world 1 the ring's rotation is the identity: ring_trace over the
    one partition's tree equals its walk, ids against tpurt's brute ring."""
    jt, tt = bunny
    _, jc = j_make_bunny_scene(num_tris=2000)
    r = j_gen_primary_rays(jc.replace(width=40, height=24))
    rays = Rays(o=torch.from_numpy(np.array(r.o)), d=torch.from_numpy(np.array(r.d)))
    part = tsp.partition_scene(tt, 1)
    wide = tsp.build_partition_wides(part, tt, index=0)
    brute = ring_trace(mesh1, rays, part)
    walked = ring_trace(mesh1, rays, part, pbvh=wide)
    assert torch.equal(brute.tri, walked.tri) and (brute.tri >= 0).any()
    from tpurt.core.geometry import Rays as JRays
    from tpurt.dist.ring import ring_trace as j_ring_trace
    from tpurt.dist.shard import make_mesh as j_make_mesh
    import jax

    ref = j_ring_trace(j_make_mesh(jax.devices()[:1]), JRays(o=r.o, d=r.d),
                       jsp.partition_scene(jt, 1))
    assert np.array_equal(np.asarray(ref.tri), walked.tri.numpy())


def test_world_1_shard_render_is_bitwise(mesh1):
    scene, cam = make_cornell_box(device="cpu")
    cam = dataclasses.replace(cam, width=20, height=12)
    tracer = make_tracer(scene, "bvh")
    assert torch.equal(shard_render(tracer, cam, mesh1), render(scene, cam, tracer=tracer))
    padded, n = pad_rays(Rays(o=torch.ones(5, 3), d=torch.ones(5, 3)), 4)
    assert n == 5 and padded.o.shape == (8, 3) and not padded.d[5:].any()


def test_world_1_renderer_and_fit_take_the_mesh(mesh1):
    """'auto' picks 'replicated' for a small scene; the mesh's render and
    fit equal the mesh-free ones at world 1."""
    scene, cam = make_bunny_scene(num_tris=2000, device="cpu")
    cam = dataclasses.replace(cam, width=16, height=12)
    r = Renderer(scene, RenderConfig(method="wide8"), mesh=mesh1)
    assert r.partition == "replicated"
    ref = Renderer(scene, RenderConfig(method="wide8")).render(cam)
    assert torch.equal(r.render(cam), ref)
    ring = Renderer(scene, RenderConfig(method="wide8"), mesh=mesh1, partition="ring")
    assert ring.tracer.method == "ring" and ring.tracer.pbvh is not None
    off = ((ring.render(cam) - ref).abs().amax(dim=-1) > 2e-3).float().mean()
    assert float(off) <= 0.003
    ring.update_scene(scene, rebuild_bvh=False)  # a ring partition is always rebuilt
    assert ring.tracer.part is not None
    rk = dict(method="brute", soft=True, k_layers=2, sharpness=40.0, band=0.15)
    sc, cm = make_cornell_box(device="cpu")
    cm = dataclasses.replace(cm, width=8, height=8)
    with torch.no_grad():
        tgt = render(sc, cm, **rk)
    fits = [InverseRenderer(sc, cm, fit=FitConfig(steps=2, grad_chunks=2, lr=1e-3),
                            render=RenderConfig(**rk), mesh=m).fit(tgt) for m in (None, mesh1)]
    assert fits[0].losses == fits[1].losses
    assert torch.equal(fits[0].params["verts"], fits[1].params["verts"])


@pytest.mark.parametrize("engine", ["wide8", "binary", "packet"])
def test_fold_over_a_padded_partition_matches_brute(bunny, engine):
    """The ring's local steps (closest, any hit, k nearest) over 4
    partitions of bunny-2K (1,986 triangles) in rank 0's order, through the
    kernels' twins of the engine named to each step ("binary" and "packet"
    walk the same PackedBVHs; 960 rays, one packet): the last partition
    holds 2 padding rows, so a leaf holds -1 slots and zero rows.  Closest ids and blocked flags equal the same fold over the
    brute tuples bitwise; no k-list holds a padding id, and each is sorted
    by (t, id); t within 1e-4."""
    from tpurt_torch.dist import ring

    jt, tt = bunny
    part = tsp.partition_scene(tt, 4)
    assert int((part.gid < 0).sum()) == 4 * part.chunk - tt.num_tris > 0
    _, jc = j_make_bunny_scene(num_tris=2000)
    r = j_gen_primary_rays(jc.replace(width=40, height=24))
    o, d = torch.from_numpy(np.array(r.o)), torch.from_numpy(np.array(r.d))
    tmax = torch.from_numpy(np.random.default_rng(5).uniform(0.5, 8.0, 960).astype(np.float32))
    if engine == "wide8":
        hard, soft = (tsp.build_partition_wides(part, tt, band=b) for b in (0.0, 0.08))
    else:
        hard, soft = (tsp.build_partition_bvhs(part, band=b) for b in (0.0, 0.08))
    assert (hard[-1].row_tids if engine == "wide8" else hard[-1].tri_ids).min() == -1
    brute = [part.local(p) for p in range(4)]

    def fold(trees, eng):
        best = ring.closest_init(960, "cpu")
        blocked = torch.zeros(960, dtype=torch.bool)
        for t in trees:
            best = ring.closest_step(o, d, best, t, engine=eng)
            blocked = ring.occluded_step(o, d, tmax, blocked, t, engine=eng)
        return best, blocked

    with one_thread():  # the packet twins' lockstep loops
        (got, got_blk), (ref, ref_blk) = fold(hard, engine), fold(brute, "brute")
    assert torch.equal(got["tri"], ref["tri"]) and (ref["tri"] >= 0).sum() > 100
    # the walks' Möller–Trumbore reads (v0, e1, e2) rows and sums in the
    # kernels' order, brute force in its own: t within the ring tests' 1e-4
    assert torch.allclose(got["t"], ref["t"], rtol=0, atol=1e-4)
    assert torch.equal(got_blk, ref_blk) and 0 < int(ref_blk.sum()) < 960
    table = tri_table(tt)
    ts, ids = ring.knear_init(960, 4, "cpu")
    with one_thread():
        for t in soft:
            ts, ids = ring.knear_step(o, d, torch.full((960,), 1e30), ts, ids, t, table, 4,
                                      0.08, engine=engine)
    valid = ids != tsp.BIG_ID
    assert valid[:, 0].sum() > 100 and (ids[valid] >= 0).all()
    assert (ts[:, 1:] >= ts[:, :-1]).all()
