"""tpurt_torch's ring over a partitioned scene against tpurt's, at world 2
(test_torch_dist_api.py runs the same cases at world 4).

The port runs in spawned gloo ranks (tests/dist_ranks.py through
tpurt_torch.dist.dryrun.run_ranks, a file:// rendezvous, a time limit);
tpurt's ring_trace, ring_occluded and ring_k_nearest run on
make_mesh(jax.devices()[:world]) of the 8-device CPU mesh.  The input:
bunny-2K, its camera's 40x24 = 960 primary rays, a seeded t_max per ray
for the any-hit call, k = 4 at band 0.08 for the k-nearest.  Each local
engine against its tpurt counterpart: the brute tuple against tpurt's brute
tuple, the wide8 kernels' twins over the port's per-partition WideBVHs
against tpurt's interpret-mode pallas8 kernels over its stacked ones, the
binary kernels' twins over the PackedBVHs against tpurt's packet engine.

Held: ids, blocked flags and k-lists bitwise (the (t, gid) fold and the
(t, id) merge do not depend on the order in which a ray meets the chunks);
t, u, v within 1e-4 (ROADMAP P2: XLA's CPU backend contracts FMAs in
tpurt's kernels and jitted ring, the port does not); every rank's answer
equal.  P2 also reaches the k-list merge: tpurt's jitted ring computes each
candidate's t (_table_t) with FMAs, so two candidates whose t agree to
~1e-7 can merge in the other order (1 of the 960 rays at world 2).  The
port's lists are held bitwise to tpurt's with each list put in the order of
tpurt's own _table_t evaluated op by op (eagerly), which is the port's
arithmetic.  alltoall_trace: the resolved rays equal brute force and tpurt's
resolved set and hits; with capacity 1 the overflow stays unresolved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.dist_ranks import alltoall_cases, np_tree, ring_cases
from tests.test_torch_dist_partition import np_tris
from tpurt.accel.intersect import intersect_brute
from tpurt.core.geometry import Rays as JRays
from tpurt.core.scene import make_bunny_scene as j_make_bunny_scene
from tpurt.dist import ring as jring
from tpurt.dist import scene_partition as jsp
from tpurt.dist.shard import make_mesh as j_make_mesh
from tpurt.render.camera import gen_primary_rays as j_gen_primary_rays
from tpurt.render.pipeline import tri_table as j_tri_table

from tpurt_torch.dist.dryrun import run_ranks
from tpurt_torch.dist.scene_partition import BIG_ID

K, BAND = 4, 0.08
TUV_ATOL = 1e-4
SPAWN_TIMEOUT = 300.0
ENGINES = ("brute", "wide8", "binary")


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
def port(world, inputs):
    """Every rank's results (spawned once for the module)."""
    jt, o, d, tmax = inputs


    out = run_ranks(_port_cases, world, np_tris(jt), o, d, tmax, device="cpu",
                    timeout=SPAWN_TIMEOUT)
    return [np_tree(x) for x in out]


def _port_cases(mesh, tris, o, d, tmax):
    return {"ring": ring_cases(mesh, tris, o, d, tmax, K, BAND),
            "alltoall": alltoall_cases(mesh, tris, o, d)}


@pytest.fixture(scope="module")
def tpurt_ring(world, inputs):
    """tpurt's ring results per engine, computed on first use."""
    jt, o, d, tmax = inputs
    mesh = j_make_mesh(jax.devices()[:world])
    part = jsp.partition_scene(jt, world)
    rays = JRays(o=jnp.asarray(o), d=jnp.asarray(d))
    cache = {}

    def get(engine, fn):
        if (engine, fn) not in cache:
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
            cache[engine, fn] = out
        return cache[engine, fn]

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


@pytest.mark.parametrize("engine", ENGINES)
def test_ring_trace(port, tpurt_ring, engine):
    got = _ranks_agree(port, "ring", engine, "trace")
    ref = tpurt_ring(engine, "trace")
    assert np.array_equal(got["tri"], ref["tri"])
    hit = ref["tri"] >= 0
    assert hit.sum() > 100 and (~hit).sum() > 100
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(got[f][hit], ref[f][hit], rtol=0, atol=TUV_ATOL)
    assert (got["t"][~hit] == ref["t"][~hit]).all()


@pytest.mark.parametrize("engine", ENGINES)
def test_ring_occluded(port, tpurt_ring, engine):
    got = _ranks_agree(port, "ring", engine, "occluded")
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
def test_ring_k_nearest(port, tpurt_ring, inputs, engine):
    jt, o, d, _ = inputs
    got = _ranks_agree(port, "ring", engine, "knear")
    ref = tpurt_ring(engine, "knear")
    assert got.shape == ref.shape == (960, K) and got.dtype == np.int32
    assert np.array_equal(got, op_by_op_order(ref, o, d, jt))
    assert (got != ref).any(axis=1).sum() <= 2
    assert (got[:, 1] >= 0).sum() > 100


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
