"""tpurt_torch's ring over a partitioned scene against tpurt's, at world 2
(test_torch_dist_api.py runs the same cases at world 4).

The port runs in spawned gloo ranks (tests/dist_ranks.py through
tpurt_torch.dist.dryrun.run_ranks, a file:// rendezvous, a time limit);
tpurt's ring_trace, ring_occluded and ring_k_nearest run on
make_mesh(jax.devices()[:world]) of the 8-device CPU mesh.  Each of the
port's local engines, named to its ring functions, against its tpurt
counterpart:
- "brute": the brute tuple against tpurt's brute tuple;
- "wide8": the wide8 kernels' twins over the port's per-partition
  WideBVHs against tpurt's interpret-mode pallas8 kernels over its stacked
  ones;
- "binary": the binary per-ray kernels' twins over the PackedBVHs against
  tpurt's ring over its stacked PackedBVHs, which walks them with its packet
  engine: tpurt's ring has no per-ray binary engine, so this holds the
  binary ring where no packet effect shows (the 960 rays below: 480 a rank
  at world 2, less than one packet, and no P1 ray);
- "packet": the packet kernels' twins over the same PackedBVHs against
  tpurt's packet ring, on an input where the packets matter: bunny-3K's
  4,096 rays with test_torch_traverse8.py's groups (misses, origins inside
  the knot, zero and tiny negative direction components, random rays), 2
  packets a rank at world 2 and 1 at world 4, with its seeded t_max.
The other three engines take bunny-2K, its camera's 40x24 = 960 primary
rays, a seeded t_max per ray for the any-hit call; k = 4 at band 0.08 for
the k-nearest throughout.  tpurt builds its partition trees jitted, which
at band > 0 rounds the band pad with an FMA (ROADMAP P4): the band trees
are held through what their walks return.

Held: ids and blocked flags bitwise (the (t, gid) fold and the (t, id)
merge do not depend on the order in which a ray meets the chunks); every
rank's answer equal.  t, u, v: within 1e-4 for the first three (ROADMAP
P2: XLA's CPU backend contracts FMAs in tpurt's kernels and jitted ring,
the port does not); for "packet" bitwise equal to tpurt's own packet
Möller–Trumbore on the winning triangle evaluated op by op
(test_torch_packet.py's rule).  P2 also reaches the k-list merge: tpurt's
jitted ring computes each candidate's t (_table_t) with FMAs, so two
candidates whose t agree to ~1e-7 can merge in the other order (1 of the
960 rays at world 2).  The port's lists are held bitwise to tpurt's with
each list put in the order of tpurt's own _table_t evaluated op by op
(eagerly), which is the port's arithmetic; for "packet", a list that still
differs must be a P2 ray that test_torch_traverse_bin.py's _explain
accounts for (a t-tie or a band edge), at most 2e-3 of the rays.

P10 (ROADMAP queue 3): on the P1 rays the port's "binary" ring differs
from tpurt's packet ring, and its "packet" ring equals it.  A ring tracer
of engine "packet" (make_tracer(method="ring", ring_engine="packet")) at
world 2 renders bunny-3K at 48^2 with its primary rays in row-major order
and its shadow rays light-major after them, and its image equals tpurt's
render through its own packet ring by tests/golden/test_golden.py's _check
at frac 0.0.  alltoall_trace: the resolved rays equal brute force and
tpurt's resolved set and hits; with capacity 1 the overflow stays
unresolved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.dist_ranks import (
    alltoall_cases, np_tree, one_thread, packet_ring_render_cases, ring_cases)
from tests.golden.test_golden import _check
from tests.test_torch_dist_partition import np_cam, np_scene, np_tris
from tests.test_torch_packet import _assert_hits_match, _port_tris
from tests.test_torch_traverse8 import _bunny_rays
from tests.test_torch_traverse_bin import _explain
from tpurt.accel import packet as jp
from tpurt.accel.intersect import intersect_brute
from tpurt.core.geometry import Rays as JRays
from tpurt.core.scene import make_bunny_scene as j_make_bunny_scene
from tpurt.dist import ring as jring
from tpurt.dist import scene_partition as jsp
from tpurt.dist.shard import make_mesh as j_make_mesh
from tpurt.render.camera import gen_primary_rays as j_gen_primary_rays
from tpurt.render.pipeline import make_tracer as j_make_tracer
from tpurt.render.pipeline import render as j_render
from tpurt.render.pipeline import tri_table as j_tri_table

from tpurt_torch.dist.dryrun import run_ranks
from tpurt_torch.dist.scene_partition import BIG_ID

K, BAND = 4, 0.08
TUV_ATOL = 1e-4
SPAWN_TIMEOUT = 300.0
ENGINES = ("brute", "wide8", "binary", "packet")
# the engines run on the groups input (the packet ring, and the binary ring
# beside it for P10)
GROUP_ENGINES = ("binary", "packet")
MAX_TIE_FRAC = 2e-3


@pytest.fixture(scope="module")
def world():
    return 2


@pytest.fixture(scope="module")
def inputs():
    js, jc = j_make_bunny_scene(num_tris=2000)
    r = j_gen_primary_rays(jc.replace(width=40, height=24))
    o, d = np.array(r.o), np.array(r.d)
    tmax = np.random.default_rng(5).uniform(0.5, 8.0, o.shape[0]).astype(np.float32)
    return js.tris, o, d, tmax


@pytest.fixture(scope="module")
def groups():
    """bunny-3K's 64^2 primary rays with test_torch_traverse8.py's groups:
    (tpurt triangles, o, d, per-ray t_max, {group: ray indices})."""
    return _bunny_rays()


def _render_scene():
    js, jc = j_make_bunny_scene(num_tris=3000)
    return js, jc.replace(width=48, height=48)


@pytest.fixture(scope="module")
def port(world, inputs, groups):
    """Every rank's results (spawned once for the module)."""
    jt, o, d, tmax = inputs
    gt, go, gd, gtmax, _ = groups
    js, jc = _render_scene()
    out = run_ranks(_port_cases, world, np_tris(jt), o, d, tmax,
                    (np_tris(gt), go, gd, gtmax), np_scene(js), np_cam(jc), device="cpu",
                    timeout=SPAWN_TIMEOUT)
    return [np_tree(x) for x in out]


def group_cases(mesh, group_input):
    """The groups input through the ring's "binary" and "packet" engines
    (one intra-op thread: the packet twins' lockstep loops)."""
    with one_thread():
        return ring_cases(mesh, *group_input, K, BAND, GROUP_ENGINES)


def _port_cases(mesh, tris, o, d, tmax, group_input, scene, cam):
    return {"ring": ring_cases(mesh, tris, o, d, tmax, K, BAND),
            "groups": group_cases(mesh, group_input),
            "render": packet_ring_render_cases(mesh, scene, cam),
            "alltoall": alltoall_cases(mesh, tris, o, d)}


def _on(engine: str, inputs, groups):
    """(port results key, (tpurt triangles, o, d, t_max)) of the input an
    engine is held on: the groups for "packet", the 960 rays otherwise."""
    if engine == "packet":
        return "groups", groups[:4]
    return "ring", inputs


@pytest.fixture(scope="module")
def tpurt_ring(world, inputs, groups):
    """tpurt's ring results per engine, computed on first use: "binary" and
    "packet" both run tpurt's packet ring over its PackedBVHs (tpurt's only
    ring over them), each on its engine's input."""
    mesh = j_make_mesh(jax.devices()[:world])
    cache = {}

    def get(engine, fn, on=None):
        key, (jt, o, d, tmax) = _on(on or engine, inputs, groups)
        if (engine, fn, key) not in cache:
            part = jsp.partition_scene(jt, world)
            rays = JRays(o=jnp.asarray(o), d=jnp.asarray(d))
            if engine == "brute":
                pb = None
            elif fn == "knear":
                pb = (jsp.build_partition_wides(part, jt, band=BAND) if engine == "wide8"
                      else jsp.build_partition_bvhs(part, band=BAND))
            else:
                pb = (jsp.build_partition_wides(part, jt) if engine == "wide8"
                      else jsp.build_partition_bvhs(part))
            if fn == "trace":
                h = jring.ring_trace(mesh, rays, part, pbvh=pb)
                out = {f: np.asarray(getattr(h, f)) for f in ("t", "u", "v", "tri")}
            elif fn == "occluded":
                out = np.asarray(jring.ring_occluded(mesh, rays, part, jnp.asarray(tmax),
                                                     pbvh=pb))
            else:
                out = np.asarray(jring.ring_k_nearest(mesh, rays, part, j_tri_table(jt), K,
                                                      BAND, pbvh=pb))
            cache[engine, fn, key] = out
        return cache[engine, fn, key]

    return get


def _ranks_agree(port, *path):
    def at(x):
        for p in path:
            x = x[p]
        return x

    first = at(port[0])
    for other in port[1:]:
        o = at(other)
        if isinstance(first, dict):
            assert all(np.array_equal(first[k], o[k]) for k in first)
        else:
            assert np.array_equal(first, o)
    return first


def _case(jt, o, d) -> dict:
    """What test_torch_packet.py's _assert_hits_match and
    test_torch_traverse_bin.py's _explain read of a case."""
    return {"tt": _port_tris(jt), "o": o, "d": d}


@pytest.mark.parametrize("engine", ENGINES)
def test_ring_trace(port, tpurt_ring, inputs, groups, engine):
    key, (jt, o, d, _) = _on(engine, inputs, groups)
    got = _ranks_agree(port, key, engine, "trace")
    ref = tpurt_ring(engine, "trace")
    assert np.array_equal(got["tri"], ref["tri"])
    hit = ref["tri"] >= 0
    assert hit.sum() > 100 and (~hit).sum() > 100
    if engine == "packet":
        _assert_hits_match(_case(jt, o, d), {"x": ref["tri"]}, {"x": got["tri"], **got},
                           jp._mt_packet)
        return
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(got[f][hit], ref[f][hit], rtol=0, atol=TUV_ATOL)
    assert (got["t"][~hit] == ref["t"][~hit]).all()


@pytest.mark.parametrize("engine", ENGINES)
def test_ring_occluded(port, tpurt_ring, inputs, groups, engine):
    key, _ = _on(engine, inputs, groups)
    got = _ranks_agree(port, key, engine, "occluded")
    ref = tpurt_ring(engine, "occluded")
    assert got.dtype == bool and np.array_equal(got, ref)
    assert 0 < got.sum() < got.size


def op_by_op_order(ids, o, d, jt):
    """Each k-list in (t, id) order, t from tpurt's _table_t run eagerly
    (each op rounded on its own, no FMA); -1 pads stay last."""
    t = np.asarray(jring._table_t(jnp.asarray(o), jnp.asarray(d), jnp.asarray(ids),
                                  j_tri_table(jt), 1e-4))
    order = np.lexsort((np.where(ids >= 0, ids, BIG_ID), t), axis=-1)
    return np.take_along_axis(ids, order, axis=-1)


@pytest.mark.parametrize("engine", ENGINES)
def test_ring_k_nearest(port, tpurt_ring, inputs, groups, engine):
    key, (jt, o, d, _) = _on(engine, inputs, groups)
    got = _ranks_agree(port, key, engine, "knear")
    ref = tpurt_ring(engine, "knear")
    assert got.shape == ref.shape == (o.shape[0], K) and got.dtype == np.int32
    assert (got[:, 1] >= 0).sum() > 100
    ordered = op_by_op_order(ref, o, d, jt)
    if engine == "packet":
        bad = _explain(_case(jt, o, d), ordered, got, BAND)
        assert len(bad) <= MAX_TIE_FRAC * o.shape[0], bad
        return
    assert np.array_equal(got, ordered)
    assert (got != ref).any(axis=1).sum() <= 2


def test_p10_binary_ring_misses_p1_rays_packet_ring_does_not(port, tpurt_ring, groups):
    """P10: on the P1 rays (a direction component of -1e-31, whose inverse
    is 0, so every slab test of the ray's own fails) tpurt's packet ring
    hits rays through their packets.  The port's "binary" ring, a per-ray
    walk over the same PackedBVHs, misses them; its "packet" ring gives
    tpurt's ids on every one (and t, u, v by test_ring_trace's rule)."""
    p1 = groups[4]["tiny_neg31"]
    ref = tpurt_ring("packet", "trace")
    binary = _ranks_agree(port, "groups", "binary", "trace")
    packet = _ranks_agree(port, "groups", "packet", "trace")
    assert (ref["tri"][p1] >= 0).any()
    assert (binary["tri"][p1] != ref["tri"][p1]).any()
    assert (binary["tri"][p1] == -1).all()
    assert np.array_equal(packet["tri"][p1], ref["tri"][p1])


def test_packet_ring_render_row_major_equals_tpurt(port, world, tmp_path):
    """render() through make_tracer(method="ring", ring_engine="packet"):
    the ring gets the primary rays in row-major order and the shadow rays
    light-major over them (each from its primary ray's hit point), walked by
    the packet engine, and the image equals tpurt's render through its
    packet ring at tpurt's packet-golden threshold."""
    js, jc = _render_scene()
    r = _ranks_agree(port, "render", "img")
    rec = port[0]["render"]
    assert rec["ring_engine"] == "packet"
    seen, prim = rec["seen"], rec["primary"]
    n = prim["o"].shape[0]
    assert seen["trace"]["engine"] == seen["occluded"]["engine"] == "packet"
    assert np.array_equal(seen["trace"]["o"][:n], prim["o"])
    assert np.array_equal(seen["trace"]["d"][:n], prim["d"])
    n_l = int(np.asarray(js.lights.pos).shape[0])
    sh = seen["occluded"]["o"][:n_l * n].reshape(n_l, n, 3)
    assert all(np.array_equal(sh[0], sh[i]) for i in range(1, n_l))
    # a hit's shadow ray starts SHADOW_EPS (1e-3) off its primary ray
    hit = seen["trace"]["hit"][:n]
    along = np.cross(sh[0][hit] - prim["o"][hit], prim["d"][hit])
    assert 100 < hit.sum() < n
    assert np.linalg.norm(along, axis=-1).max() <= 1.5e-3
    mesh = j_make_mesh(jax.devices()[:world])
    ref = np.asarray(j_render(js, jc, tracer=j_make_tracer(js, "ring", mesh=mesh,
                                                           ring_engine="packet")))
    path = tmp_path / "tpurt_packet_ring.npy"
    np.save(path, ref)
    _check(r, str(path), frac=0.0)


def test_alltoall_trace_resolved_rays(port, inputs, world):
    """Resolved rays carry brute force's closest hit and tpurt's; tpurt's
    resolved set is the port's."""
    jt, o, d, _ = inputs
    got = _ranks_agree(port, "alltoall", "generous")
    rays = JRays(o=jnp.asarray(o), d=jnp.asarray(d))
    ref = intersect_brute(rays, jt)
    res = got["resolved"]
    assert res.any() and res.dtype == bool
    assert np.array_equal(got["tri"][res], np.asarray(ref.tri)[res])
    np.testing.assert_allclose(got["t"][res], np.asarray(ref.t)[res], rtol=1e-5)
    mesh = j_make_mesh(jax.devices()[:world])
    jhit, jres = jsp.alltoall_trace(mesh, rays, jsp.partition_scene(jt, world),
                                    capacity=o.shape[0])
    assert np.array_equal(np.asarray(jres), res)
    assert np.array_equal(np.asarray(jhit.tri), got["tri"])
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(np.asarray(getattr(jhit, f)), got[f], rtol=0,
                                   atol=TUV_ATOL)


def test_alltoall_overflow_left_unresolved(port, inputs, world):
    jt, o, d, _ = inputs
    gen = _ranks_agree(port, "alltoall", "generous")
    got = _ranks_agree(port, "alltoall", "overflow")
    res = got["resolved"]
    # at most one ray per (source rank, owner) pair is routed
    assert res.sum() <= world * world < gen["resolved"].sum()
    assert np.array_equal(got["tri"][res], gen["tri"][res])
    mesh = j_make_mesh(jax.devices()[:world])
    _, jres = jsp.alltoall_trace(mesh, JRays(o=jnp.asarray(o), d=jnp.asarray(d)),
                                 jsp.partition_scene(jt, world), capacity=1)
    assert np.array_equal(np.asarray(jres), res)
