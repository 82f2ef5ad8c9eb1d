"""tpurt_torch's differentiable pieces and refit against tpurt's.

Inputs are made from numpy seeds and handed to both packages.  Tolerances,
with their reasons:
- intersect_tuv's forward and backward, the soft-visibility functions and
  their gradients: within 1e-5 of the reference's scale (rtol 1e-4 on
  elementwise values), because XLA's CPU backend contracts a*b+c into FMAs
  and rounds sigmoid, rsqrt and sums differently from torch.
- gather_verts' backward against tpurt's segment_accumulate: rtol 1e-5,
  atol 1e-6, the two sum the same rows in different orders.
- refit_wide_direct and rows_from_table: bitwise (only min, max, one
  subtraction per corner and gathers, all exact or identically rounded).
tpurt's own gather_verts cannot be differentiated (its custom_vjp forward
takes its arguments in the wrong order, ROADMAP fault F1); where tpurt's
gradient is the reference, the test binds tpurt's gather_verts to a plain
gather with monkeypatch, for that test only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.diff.gather_grad as j_gather_grad
from tpurt.accel.bvh8 import build_wide as j_build_wide
from tpurt.accel.bvh8 import refit_wide_direct as j_refit_wide_direct
from tpurt.accel.bvh8 import rows_from_table as j_rows_from_table
from tpurt.accel.lbvh import build_lbvh as j_build_lbvh
from tpurt.core import scene as jscene
from tpurt.diff import softvis as jsv
from tpurt.diff.intersect_vjp import intersect_tuv as j_intersect_tuv
from tpurt.render.pipeline import tri_table as j_tri_table

from tests.test_torch_traverse8 import _to_port
from tpurt_torch.accel import bvh8
from tpurt_torch.accel.bvh8 import (
    WideBVH, refit_levels, refit_wide_direct, rows_from_table, rows_from_tids)
from tpurt_torch.accel.intersect import intersect_tuv as plain_tuv
from tpurt_torch.accel.lbvh import build_lbvh
from tpurt_torch.core import scene as tscene
from tpurt_torch.core.geometry import Triangles
from tpurt_torch.diff import softvis as tsv
from tpurt_torch.diff.gather_grad import gather_corners, gather_verts
from tpurt_torch.diff.intersect_vjp import intersect_tuv
from tpurt_torch.render.pipeline import tri_table

RNG = np.random.default_rng


def _close(got, ref, rtol=1e-4, scale_atol=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=scale_atol * max(np.abs(ref).max(), 1e-30))


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


@pytest.fixture
def plain_tpurt_gather(monkeypatch):
    """tpurt's gather_verts as a plain gather (bypasses F1), this test only."""
    monkeypatch.setattr(j_gather_grad, "gather_verts",
                        lambda verts, idx, grad_cols=None: verts[idx])


# -- intersect_tuv ---------------------------------------------------------
def _mt_inputs(case):
    rng = RNG(5)
    if case == "same":
        shapes = [(64, 3)] * 5
    else:  # rays (N, 1, 3) against triangles (1, T, 3)
        shapes = [(16, 1, 3)] * 2 + [(1, 12, 3)] * 3
    o, d, v0 = (rng.normal(size=s).astype(np.float32) for s in shapes[:3])
    v1 = (v0 + rng.normal(size=shapes[3])).astype(np.float32)
    v2 = (v0 + rng.normal(size=shapes[4])).astype(np.float32)
    out_shape = np.broadcast_shapes(*shapes)[:-1]
    cots = [rng.normal(size=out_shape).astype(np.float32) for _ in range(3)]
    return (o, d, v0, v1, v2), cots


@pytest.mark.parametrize("case", ["same", "broadcast"])
def test_intersect_tuv_backward_matches_tpurt_vjp(case):
    xs, cots = _mt_inputs(case)
    jout, vjp = jax.vjp(j_intersect_tuv, *(jnp.asarray(x) for x in xs))
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))
    txs = [_t(x, grad=True) for x in xs]
    tout = intersect_tuv(*txs)
    tgrads = torch.autograd.grad(tout, txs, [_t(c) for c in cots])
    for a, b in zip(tout, jout):
        _close(a.detach(), b)
    for a, b in zip(tgrads, jgrads):
        assert a.shape == b.shape
        _close(a, b)


def test_intersect_tuv_backward_matches_autograd_in_float64():
    """The analytic backward against torch autograd of the plain forward."""
    xs, cots = _mt_inputs("same")
    a = [_t(x.astype(np.float64), grad=True) for x in xs]
    b = [_t(x.astype(np.float64), grad=True) for x in xs]
    ga = torch.autograd.grad(intersect_tuv(*a), a, [_t(c).double() for c in cots])
    gb = torch.autograd.grad(plain_tuv(*b)[:3], b, [_t(c).double() for c in cots])
    for x, y in zip(ga, gb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-9, atol=1e-9)


# -- gather_verts ----------------------------------------------------------
@pytest.mark.parametrize("grad_cols", [None, 12])
def test_gather_verts_backward_matches_segment_accumulate(grad_cols):
    rng = RNG(7)
    v_rows, n, c = 300, 4000, 15
    table = rng.normal(size=(v_rows, c)).astype(np.float32)
    idx = rng.integers(0, v_rows - 20, size=(40, n // 40)).astype(np.int32)
    cot = rng.normal(size=idx.shape + (c,)).astype(np.float32)
    tt = _t(table, grad=True)
    out = gather_verts(tt, torch.from_numpy(idx), grad_cols)
    assert torch.equal(out.detach(), torch.from_numpy(table[idx]))
    (g,) = torch.autograd.grad(out, tt, _t(cot))
    use = c if grad_cols is None else grad_cols
    ref = np.asarray(j_gather_grad.segment_accumulate(
        jnp.asarray(idx.reshape(-1)), jnp.asarray(cot.reshape(-1, c)[:, :use]), v_rows))
    np.testing.assert_allclose(g.numpy()[:, :use], ref, rtol=1e-5, atol=1e-6)
    assert not g[:, use:].any()            # trimmed columns are zero-filled
    assert not g[v_rows - 20:].any()       # rows never gathered get nothing


def test_gather_corners_and_tri_table_match_tpurt():
    js = jscene.make_bunny_scene(num_tris=3000)[0]
    ts = tscene.make_bunny_scene(num_tris=3000, device="cpu")[0]
    ref = np.asarray(j_tri_table(js.tris))
    got = tri_table(ts.tris)
    assert np.array_equal(got.numpy().view(np.int32), ref.view(np.int32))
    tid = torch.from_numpy(RNG(1).integers(0, 3000, size=(5, 7)))
    v0, v1, v2 = gather_corners(ts.tris.verts, ts.tris.faces, tid)
    c0, c1, c2 = (c[tid] for c in ts.tris.corners())
    assert torch.equal(v0, c0) and torch.equal(v1, c1) and torch.equal(v2, c2)


# -- soft visibility -------------------------------------------------------
def _soft_case(name):
    """(tpurt fn, port fn, numpy args, indices of differentiated args)."""
    rng = RNG(11)
    n = 2000
    if name == "coverage":
        u, v = (rng.uniform(-0.2, 1.2, n).astype(np.float32) for _ in range(2))
        valid = rng.uniform(size=n) < 0.9
        return (lambda u, v: jsv.coverage(u, v, 40.0, jnp.asarray(valid), 0.08),
                lambda u, v: tsv.coverage(u, v, 40.0, torch.from_numpy(valid), 0.08),
                (u, v), (0, 1))
    if name == "coverage_band0":
        u, v = (rng.uniform(-0.2, 1.2, n).astype(np.float32) for _ in range(2))
        ok = np.ones(n, bool)
        return (lambda u, v: jsv.coverage(u, v, 30.0, jnp.asarray(ok)),
                lambda u, v: tsv.coverage(u, v, 30.0, torch.from_numpy(ok)),
                (u, v), (0, 1))
    if name == "det_gate":
        c = rng.uniform(-0.05, 0.05, n).astype(np.float32)
        return jsv.det_gate, tsv.det_gate, (c,), (0,)
    if name == "shadow_t_ramp":
        tm = rng.uniform(0.5, 3.0, n).astype(np.float32)
        t = (tm * rng.uniform(-0.1, 1.1, n)).astype(np.float32)
        return jsv.shadow_t_ramp, tsv.shadow_t_ramp, (t, tm), (0, 1)
    if name == "composite":
        a = rng.uniform(0, 1, (n, 4)).astype(np.float32)
        a[::7, 1] = 1.0  # fully opaque layers: cumprod through zeros
        col = rng.uniform(0, 2, (n, 4, 3)).astype(np.float32)
        bg = np.array([0.3, 0.4, 0.6], np.float32)
        return (lambda a, c: jsv.composite(a, c, jnp.asarray(bg)),
                lambda a, c: tsv.composite(a, c, torch.from_numpy(bg)),
                (a, col), (0, 1))
    raise ValueError(name)


@pytest.mark.parametrize("name", ["coverage", "coverage_band0", "det_gate",
                                  "shadow_t_ramp", "composite"])
def test_soft_functions_and_grads_match_tpurt(name):
    jfn, tfn, args, diff = _soft_case(name)
    w = RNG(2).uniform(0.5, 1.5, np.asarray(jfn(*args)).shape).astype(np.float32)
    jval, jgrads = jax.value_and_grad(
        lambda *a: jnp.sum(jnp.asarray(w) * jfn(*a)), argnums=diff)(
        *(jnp.asarray(a) for a in args))
    targs = [_t(a, grad=i in diff) for i, a in enumerate(args)]
    out = tfn(*targs)
    _close(out.detach(), jfn(*args))
    tgrads = torch.autograd.grad(torch.sum(_t(w) * out), [targs[i] for i in diff])
    for a, b in zip(tgrads, jgrads):
        _close(a, b)


def test_small_soft_helpers_match_tpurt():
    rng = RNG(3)
    u, v = (rng.uniform(-0.3, 1.3, 500).astype(np.float32) for _ in range(2))
    valid = rng.uniform(size=500) < 0.8
    a = rng.uniform(0, 1, (500, 6)).astype(np.float32)
    assert np.array_equal(tsv.signed_edge_distance(_t(u), _t(v)).numpy(),
                          np.asarray(jsv.signed_edge_distance(u, v)))
    assert np.array_equal(tsv.hard_coverage(_t(u), _t(v), torch.from_numpy(valid)).numpy(),
                          np.asarray(jsv.hard_coverage(u, v, valid)))
    _close(tsv.transmittance(_t(a)), jsv.transmittance(a))
    x, y = rng.normal(size=(2, 3, 10)).astype(np.float32)
    assert np.array_equal(np.stack([c.numpy() for c in tsv.cross3(_t(x), _t(y))]),
                          np.stack([np.asarray(c) for c in jsv.cross3(x, y)]))
    _close(tsv.dot3(_t(x), _t(y)), jsv.dot3(x, y))


def test_soft_occlusion_layers_and_grads_match_tpurt(plain_tpurt_gather):
    """(R, K, L) transmittance from shared candidates, and its gradient with
    respect to origins, directions, segment lengths and the table."""
    rng = RNG(13)
    js = jscene.make_cornell_box()[0]
    table = np.asarray(j_tri_table(js.tris))
    r, k, n_l, c = 64, 3, 2, 6
    o = rng.uniform(0.1, 0.9, (r, k, 3)).astype(np.float32)
    lp = rng.uniform(0.2, 0.8, (n_l, 3)).astype(np.float32) + [0, 0.2, 0]
    delta = lp[None, None] - o[:, :, None]
    dist = np.linalg.norm(delta, axis=-1).astype(np.float32)
    d = (delta / dist[..., None]).astype(np.float32)
    ids = rng.integers(-1, table.shape[0], (r, n_l, c)).astype(np.int32)
    w = rng.uniform(0.5, 1.5, (r, k, n_l)).astype(np.float32)

    def jloss(o, d, tm, tb):
        return jnp.sum(w * jsv.soft_occlusion_layers(o, d, tm, jnp.asarray(ids), tb,
                                                     40.0, 0.08))

    args = (o, d, dist, table)
    jval = jsv.soft_occlusion_layers(*(jnp.asarray(a) for a in args[:3]),
                                     jnp.asarray(ids), jnp.asarray(table), 40.0, 0.08)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in args))
    targs = [_t(a, grad=True) for a in args]
    out = tsv.soft_occlusion_layers(*targs[:3], torch.from_numpy(ids), targs[3], 40.0, 0.08)
    assert out.shape == (r, k, n_l)
    _close(out.detach(), jval)
    assert 0.05 < float((out < 0.999).float().mean()) < 0.95  # some shadowing
    tgrads = torch.autograd.grad(torch.sum(_t(w) * out), targs)
    for a, b in zip(tgrads, jgrads):
        _close(a, b)


# -- refit and rows --------------------------------------------------------
@pytest.fixture(scope="module")
def refit_scenes():
    """tpurt and port triangles of cornell and bunny-3K, with a tpurt
    WideBVH built at band 0 and 0.08, and moved vertices."""
    out = {}
    for name, fn, kw in (("cornell", "make_cornell_box", {}),
                         ("bunny3k", "make_bunny_scene", {"num_tris": 3000})):
        jt = getattr(jscene, fn)(**kw)[0].tris
        verts = np.asarray(jt.verts)
        moved = (verts + RNG(17).normal(scale=0.02, size=verts.shape)).astype(np.float32)
        jm = jt.replace(verts=jnp.asarray(moved))
        tm = Triangles.create(moved, np.asarray(jt.faces), np.asarray(jt.albedo),
                              np.asarray(jt.emission), device="cpu")
        for band in (0.0, 0.08):
            out[name, band] = (jt, jm, tm, j_build_wide(jt, j_build_lbvh(jt, band=band)))
    return out


@pytest.mark.parametrize("use_table", [False, True])
@pytest.mark.parametrize("band", [0.0, 0.08])
@pytest.mark.parametrize("name", ["cornell", "bunny3k"])
def test_refit_wide_direct_bitwise(refit_scenes, name, band, use_table):
    _, jm, tm, jw = refit_scenes[name, band]
    ref = j_refit_wide_direct(jw, jm, table=j_tri_table(jm) if use_table else None)
    got = refit_wide_direct(_to_port(jw), tm, table=tri_table(tm) if use_table else None)
    for field in ("wrow", "tri_rows"):
        a, b = np.asarray(getattr(ref, field)), getattr(got, field).numpy()
        assert a.shape == b.shape
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), field
    assert got.band == band and got.levels is not None


def test_rows_from_table_bitwise(refit_scenes):
    _, jm, tm, jw = refit_scenes["bunny3k", 0.0]
    ref = np.asarray(j_rows_from_table(j_tri_table(jm), jw.row_tids))
    tw = _to_port(jw)
    got = rows_from_table(tri_table(tm), tw.row_tids).numpy()
    assert np.array_equal(ref.view(np.int32), got.view(np.int32))
    # the same rows as gathered from the triangles, shading lanes included
    assert np.array_equal(got[:, 72:], rows_from_tids(tm, tw.row_tids).numpy()[:, 72:])


def test_refit_at_build_vertices_reproduces_the_build():
    """Folding triangle boxes up the wide tree gives the LBVH's node boxes
    bit for bit: a refit at unmoved vertices changes nothing."""
    ts = tscene.make_bunny_scene(num_tris=3000, device="cpu")[0]
    for band in (0.0, 0.08):
        wide = bvh8.build_wide(ts.tris, build_lbvh(ts.tris, band=band))
        again = refit_wide_direct(wide, ts.tris)
        assert torch.equal(again.wrow.view(torch.int32), wide.wrow.view(torch.int32))
        assert torch.equal(again.tri_rows, wide.tri_rows)


def _chain_wide(depth: int, seed: int = 0):
    """A synthetic WideBVH whose nodes form a chain `depth` levels deep:
    node w holds its child w + 1 in entry 0 and a one-row fat leaf (row w,
    one triangle) in entry 1."""
    rng = RNG(seed)
    c = rng.uniform(-5, 5, (depth, 1, 3))
    verts = (c + rng.normal(scale=0.3, size=(depth, 3, 3))).reshape(-1, 3).astype(np.float32)
    tris = Triangles.create(verts, np.arange(3 * depth).reshape(-1, 3), device="cpu")
    en = np.full((depth, 8), -1, np.int32)
    em = np.zeros((depth, 8), np.int32)
    en[:, 1] = 1
    em[:, 1] = ~(np.arange(depth) << 3)
    en[:-1, 0] = 0
    em[:-1, 0] = np.arange(1, depth)
    rt = np.full((depth, 8), -1, np.int32)
    rt[:, 0] = np.arange(depth)
    rt_t = torch.from_numpy(rt)
    z = torch.zeros(depth, dtype=torch.int32)
    wide = WideBVH(wrow=torch.zeros(((depth + 1) // 2, 128)),
                   tri_rows=rows_from_tids(tris, rt_t), entry_node=torch.from_numpy(en),
                   entry_meta=torch.from_numpy(em), own_node=z, escape=z,
                   has_int=(torch.from_numpy(em[:, 0]) > 0).int(), row_tids=rt_t,
                   max_rows=1)
    return tris, wide, verts


@pytest.mark.parametrize("band", [0.0, 0.08])
def test_refit_sweep_is_exact_past_64_levels(band):
    """tpurt's fold stops after 64 passes (fault F2); the sweep visits every
    level, so an 80-deep chain gets every box right."""
    depth = 80
    tris, wide, verts = _chain_wide(depth)
    wide = dataclasses.replace(wide, band=band)
    assert len(refit_levels(wide.entry_node, wide.entry_meta, "cpu")) == depth - 1
    got = refit_wide_direct(wide, tris).wrow.reshape(-1, 64)[:depth].numpy()
    tri = verts.reshape(depth, 3, 3)
    lo, hi = tri.min(axis=1), tri.max(axis=1)
    if band > 0:
        e = np.abs(tri[:, 1:] - tri[:, :1]).sum(axis=1)
        pad = np.float32(band) * e + np.float32(1e-7)
        lo, hi = lo - pad, hi + pad
    sub_lo, sub_hi = lo.copy(), hi.copy()  # box of the subtree rooted at w
    for w in range(depth - 2, -1, -1):
        sub_lo[w] = np.minimum(lo[w], sub_lo[w + 1])
        sub_hi[w] = np.maximum(hi[w], sub_hi[w + 1])
    for w in range(depth):
        np.testing.assert_array_equal(got[w, 56:62], np.concatenate([sub_lo[w], sub_hi[w]]))
        np.testing.assert_array_equal(got[w, 6:12], np.concatenate([lo[w], hi[w]]))
        if w < depth - 1:
            np.testing.assert_array_equal(
                got[w, 0:6], np.concatenate([sub_lo[w + 1], sub_hi[w + 1]]))
