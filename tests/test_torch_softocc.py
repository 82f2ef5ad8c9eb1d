"""The soft shadow transmittance's hand-written backward (diff/softvis.py
SoftOcclusion, kernels/softocc.py -> csrc/softocc.cu).

On the CPU: softvis.py's plain rendering of the backward kernel's maths
(soft_occlusion_layers_vjp: the exclusive prefix and suffix products, the
chain through coverage, ramp, gate and Moller-Trumbore) is held to autograd
through the plain composition (soft_occlusion_layers_plain) at rtol 1e-5 of
the larger of the element and the median nonzero element (the two sum the
same terms in other orders, and torch.prod's backward divides where the
rendering multiplies); both are held to torch.autograd.gradcheck in float64.
The cases: K in {1, 4}, L in {1, 3}, C in {1, 8, 16}; -1 ids; hits outside
(t_min, 2 t_max); near-grazing incidence through the gate; a candidate
whose 1 - a is exactly 0 at a high sharpness.  soft_occlusion_layers_soa's
CPU route stays the composition.

On the card (marked `card`, skipped without one): the kernels against the
plain route on fit-shaped inputs (K 4, L 1, C 8 and the area and k = 16
shapes), a backward repeated bit for bit, the launch counts, and a C above
KMAX refused.  Run them there with
``PYTHONPATH=src python -m pytest --noconftest tests/test_torch_softocc.py -m card``
(the root conftest imports JAX, which the card's machine does not have).
This file imports no JAX.
"""

import ast
import pathlib
import re

import numpy as np
import pytest
import torch

from tpurt_torch.accel.intersect import DEFAULT_T_MIN, DET_EPS
from tpurt_torch.diff import softvis as sv
from tpurt_torch.diff.gather_grad import accumulate_rows, get_grad_backend, set_grad_backend
from tpurt_torch.kernels import softocc

SOFTOCC_PY = pathlib.Path(softocc.__file__)
SOFTOCC_CU = SOFTOCC_PY.parent / "csrc" / "softocc.cu"
SHARP, BAND = 40.0, 0.08


def _problem(k, n_l, c, r, seed=0, case="mixed", dtype=np.float32):
    """Seeded inputs in compact layout: (o 3 x (K, R), d 3 x (K, L, R),
    t_max (K, L, R), ids (L, C, R) int32, table (T, 15)).  Each (l, r)
    gets triangles on its layer-0 segment (the other layers start nearby, so
    they partly cover them too), others drawn at random, -1 ids, and, by
    case, hits outside (t_min, 2 t_max), faces seen nearly edge-on, or
    large face-on triangles that cover a segment completely (at a high
    sharpness, 1 - a = 0 exactly)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1.0, 1.0, (r, 3))
    o = base[None] + rng.normal(0.0, 0.03, (k, r, 3))
    light = rng.uniform(-1.0, 1.0, (n_l, 3)) + [0.0, 3.0, 0.0]
    delta = light[None, :, None] - o[:, None]                         # (K, L, R, 3)
    dist = np.linalg.norm(delta, axis=-1)
    d = delta / dist[..., None]
    t_max = dist * 0.999
    # triangles on the layer-0 segments: centre at a fraction of the length
    frac = {"mixed": rng.uniform(0.05, 0.95, (n_l, r)),
            "t_outside": rng.choice([-0.5, 0.0005, 1.5, 2.5, 3.0], (n_l, r)),
            "grazing": rng.uniform(0.2, 0.8, (n_l, r)),
            "opaque": np.full((n_l, r), 0.5),
            "invalid_ids": rng.uniform(0.05, 0.95, (n_l, r))}[case]
    p = o[0][None] + d[0] * (frac * dist[0])[..., None]              # (L, R, 3)
    dd = d[0]
    helper = np.where(np.abs(dd[..., :1]) < 0.9, [1.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    a1 = np.cross(dd, helper)
    a1 /= np.linalg.norm(a1, axis=-1, keepdims=True)
    a2 = np.cross(dd, a1)
    if case == "grazing":  # the face's normal nearly perpendicular to d: |cos| ~ 1e-3 .. 3e-2
        tilt = rng.uniform(1e-3, 3e-2, (n_l, r, 1)) * rng.choice([-1.0, 1.0], (n_l, r, 1))
        e1 = (a1 + tilt * dd) * 0.6
        e2 = dd * 0.6
    else:
        ang = rng.uniform(0.0, 2 * np.pi, (n_l, r, 1))
        e1 = (np.cos(ang) * a1 + np.sin(ang) * a2) * rng.uniform(0.1, 0.3, (n_l, r, 1))
        e2 = (np.cos(ang + 2.0) * a1 + np.sin(ang + 2.0) * a2 + 0.3 * dd) \
            * rng.uniform(0.1, 0.3, (n_l, r, 1))
    if case == "opaque":  # every other ray's own face large and face-on
        big = (np.arange(r) % 2 == 0)[None, :, None]
        e1, e2 = np.where(big, a1 * 4.0, e1), np.where(big, a2 * 4.0, e2)
    v0 = p - (e1 + e2) / 3.0 + rng.normal(0.0, 0.02, p.shape)
    own = np.concatenate([v0, e1, e2], axis=-1).reshape(-1, 9)       # (L * R, 9)
    extra = rng.normal(0.0, 0.6, (max(8, r // 2), 9))
    geo = np.concatenate([own, extra])
    table = np.concatenate([geo, rng.uniform(0.2, 0.9, (geo.shape[0], 3)),
                            np.zeros((geo.shape[0], 3))], axis=1)
    t = table.shape[0]
    ids = rng.integers(0, t, (n_l, c, r))
    ids[:, 0] = (np.arange(n_l)[:, None] * r + np.arange(r)[None]) % t  # the ray's own face
    if c > 1:
        ids[:, 1] = rng.integers(0, n_l * r, (n_l, r))                # another ray's face
    if c > 2:
        ids[:, -1] = -1
    if case == "invalid_ids":
        ids[rng.uniform(size=ids.shape) < 0.5] = -1
    t32 = lambda x: torch.tensor(np.ascontiguousarray(x), dtype=torch.float64 if dtype == np.float64 else torch.float32)  # noqa: E731
    return ([t32(o[..., i]) for i in range(3)], [t32(d[..., i]) for i in range(3)],
            t32(t_max), torch.tensor(ids, dtype=torch.int32), t32(table))


def _on(dev, o, d, tm, ids, table):
    return [x.to(dev) for x in o], [x.to(dev) for x in d], tm.to(dev), ids.to(dev), table.to(dev)


def _broadcast(o, d, t_max):
    return ([x[:, None, None, :] for x in o], [x[:, :, None, :] for x in d],
            t_max[:, :, None, :])


def _autograd(o, d, t_max, ids, table, g, sharp=SHARP, band=BAND):
    """Value and gradients [go (3), gd (3), gt_max, gtable] of the composition."""
    leaves = [x.clone().requires_grad_(True) for x in (*o, *d, t_max, table)]
    oc, dc, tm = _broadcast(leaves[0:3], leaves[3:6], leaves[6])
    vis = sv.soft_occlusion_layers_plain(oc, dc, tm, ids, leaves[7], sharp, band)
    return vis.detach(), list(torch.autograd.grad(torch.sum(vis * g), leaves))


def _rendered(o, d, t_max, ids, table, g, sharp=SHARP, band=BAND):
    """The rendering's [go (3), gd (3), gt_max, gtable], its rows summed
    into the table by the gather backward."""
    go, gd, gtm, rows = sv.soft_occlusion_layers_vjp(o, d, t_max, ids, table, sharp, band,
                                                     DEFAULT_T_MIN, g)
    gtab = accumulate_rows(ids.clamp_min(0).reshape(-1).long(), rows.reshape(-1, 9),
                           table.shape[0], table.shape[1])
    return [*go, *gd, gtm, gtab]


def _close_to_scale(got, ref, rtol):
    """|got - ref| <= rtol * max(|ref|, median of the nonzero |ref|)."""
    nz = ref.abs()[ref != 0]
    med = float(nz.median()) if nz.numel() else 0.0
    worst = float(((got - ref).abs() - rtol * ref.abs().clamp_min(med)).max())
    assert worst <= 0.0, (float((got - ref).abs().max()), med)


def _rel_err(got, truth):
    return float((got.double() - truth).norm() / truth.norm().clamp_min(1e-300))


def _as_accurate(got, plain, truth):
    """In f32 each gradient's relative L2 error against the float64
    evaluation is at most twice the plain f32 route's, plus 1e-6: the two
    round the same forward alike, and a gradient that cancels large
    terms (1 / det amplifies them) is off in both by far more than 1e-5
    elementwise, so the two f32 routes are each held to float64."""
    for x, y, t in zip(got, plain, truth):
        if float(t.abs().max()) > 0.0:
            assert _rel_err(x, t) <= 2.0 * _rel_err(y, t) + 1e-6, (_rel_err(x, t), _rel_err(y, t))


def _f64(o, d, tm, ids, table, g):
    return [x.double() for x in o], [x.double() for x in d], tm.double(), ids, table.double(), \
        g.double()


def _truth(o, d, tm, ids, table, g, sharp=SHARP):
    """autograd through the composition in float64, the gathered rows
    summed by 'scatter' (segsum sums float32 only on the card)."""
    saved = get_grad_backend()
    set_grad_backend("scatter")
    try:
        return _autograd(*_f64(o, d, tm, ids, table, g), sharp)
    finally:
        set_grad_backend(saved)


def _check_case(k, n_l, c, r, case, sharp=SHARP, seed=0):
    """The rendering against autograd through the composition: in float64
    elementwise at rtol 1e-5 (the maths); in float32 as accurate as
    autograd's f32 route against float64 (the rounding)."""
    o, d, tm, ids, table = _problem(k, n_l, c, r, seed=seed, case=case)
    g = torch.tensor(np.random.default_rng(seed + 1).uniform(0.5, 1.5, tm.shape),
                     dtype=torch.float32)
    _, truth = _truth(o, d, tm, ids, table, g, sharp)
    for x, y in zip(_rendered(*_f64(o, d, tm, ids, table, g), sharp), truth):
        _close_to_scale(x, y, 1e-5)
    vis, plain = _autograd(o, d, tm, ids, table, g, sharp)
    _as_accurate(_rendered(o, d, tm, ids, table, g, sharp), plain, truth)
    assert float(truth[7][:, :9].abs().max()) > 0.0   # the table's gradient is not empty
    assert torch.count_nonzero(truth[7][:, 9:]) == 0
    return o, d, tm, ids, table, vis


@pytest.mark.parametrize("c", [1, 8, 16])
@pytest.mark.parametrize("n_l", [1, 3])
@pytest.mark.parametrize("k", [1, 4])
def test_vjp_rendering_matches_autograd(k, n_l, c):
    *_, vis = _check_case(k, n_l, c, 48, "mixed", seed=k * 100 + n_l * 10 + c)
    assert 0.0 < float((vis < 0.999).float().mean())   # some shadowing


def _masks(o, d, tm, ids, table):
    """ok and |cos_dn| of every (K, L, C, R) element, as the composition has them."""
    row = table[:, :9][ids.clamp_min(0).long()]
    cr = [row[..., i][None] for i in range(9)]
    oc, dc, t_max = _broadcast(o, d, tm)
    v0, e1, e2 = cr[0:3], cr[3:6], cr[6:9]
    pv = sv.cross3(dc, e2)
    det = sv.dot3(e1, pv)
    inv = det / (det * det + DET_EPS)
    tv = [oc[i] - v0[i] for i in range(3)]
    qv = sv.cross3(tv, e1)
    u, v, t = sv.dot3(tv, pv) * inv, sv.dot3(dc, qv) * inv, sv.dot3(e2, qv) * inv
    nrm = sv.cross3(e1, e2)
    cos = det * torch.rsqrt(torch.clamp_min(sv.dot3(dc, dc) * sv.dot3(nrm, nrm), 1e-30))
    band_ok = (u >= -BAND) & (v >= -BAND) & (u + v <= 1.0 + BAND) & (det.abs() > DET_EPS)
    return ids[None] >= 0, band_ok, t, t_max, cos.abs()


@pytest.mark.parametrize("case", ["invalid_ids", "t_outside", "grazing", "opaque"])
def test_vjp_rendering_special_cases(case):
    """Each case is present in its inputs, and the rendering matches autograd."""
    sharp = 1000.0 if case == "opaque" else SHARP
    o, d, tm, ids, table, vis = _check_case(4, 3, 8, 64, case, sharp=sharp, seed=7)
    live, band_ok, t, t_max, cos = _masks(o, d, tm, ids, table)
    if case == "invalid_ids":
        assert float((ids < 0).float().mean()) > 0.4
    elif case == "t_outside":
        hit = live & band_ok
        assert bool((hit & (t <= DEFAULT_T_MIN)).any()) and bool((hit & (t >= 2 * t_max)).any())
    elif case == "grazing":
        assert bool((live & band_ok & (cos > sv.DET_GATE_LO) & (cos < sv.DET_GATE_HI)).any())
    else:
        assert bool((vis == 0.0).any())   # 1 - a == 0 exactly for some candidate


@pytest.mark.parametrize("case", ["mixed", "invalid_ids", "t_outside", "grazing", "opaque"])
def test_gradcheck_float64(case):
    """torch.autograd.gradcheck, float64, small shapes: the composition
    (autograd) and the SoftOcclusion node, whose CPU backward is the
    rendering and whose table gradient goes through the gather backward."""
    sharp = 1000.0 if case == "opaque" else SHARP
    o, d, tm, ids, table = _problem(2, 2, 4, 5, seed=3, case=case, dtype=np.float64)
    leaves = tuple(x.requires_grad_(True) for x in (*o, *d, tm, table))

    def plain(*x):
        oc, dc, t_max = _broadcast(x[0:3], x[3:6], x[6])
        return sv.soft_occlusion_layers_plain(oc, dc, t_max, ids, x[7], sharp, BAND)

    def node(*x):
        return sv.SoftOcclusion.apply(*x[:7], ids, x[7], sharp, BAND, DEFAULT_T_MIN)

    assert torch.equal(plain(*leaves), node(*leaves))
    assert torch.autograd.gradcheck(plain, leaves, eps=1e-6, atol=1e-6, rtol=1e-5)
    assert torch.autograd.gradcheck(node, leaves, eps=1e-6, atol=1e-6, rtol=1e-5)


def test_node_saves_no_klcr_tensor():
    """The node keeps its compact inputs only: nothing (K, L, C, R)-sized."""
    k, n_l, c, r = 4, 3, 8, 32
    o, d, tm, ids, table = _problem(k, n_l, c, r)
    leaves = [x.requires_grad_(True) for x in (*o, *d, tm, table)]
    vis = sv.SoftOcclusion.apply(*leaves[:7], ids, leaves[7], SHARP, BAND, DEFAULT_T_MIN)
    saved = vis.grad_fn.saved_tensors
    assert len(saved) == 9
    assert max(x.numel() for x in saved) <= max(k * n_l * r, n_l * c * r, table.numel())


def test_cpu_route_is_the_composition(monkeypatch):
    """soft_occlusion_layers_soa on CPU tensors is the plain composition,
    value and autograd graph; the node and the kernels are not reached."""
    monkeypatch.setattr(sv.SoftOcclusion, "apply",
                        lambda *a: pytest.fail("the node ran for CPU tensors"))
    o, d, tm, ids, table = _problem(3, 2, 8, 40)
    tab = table.clone().requires_grad_(True)
    oc, dc, t_max = _broadcast(o, d, tm)
    got = sv.soft_occlusion_layers_soa(oc, dc, t_max, ids, tab, SHARP, BAND)
    ref = sv.soft_occlusion_layers_plain(oc, dc, t_max, ids, tab, SHARP, BAND)
    assert torch.equal(got, ref)
    assert type(got.grad_fn) is type(ref.grad_fn)
    assert softocc.LAUNCHES == {"softocc_fwd": 0, "softocc_bwd": 0}


def test_other_devices_raise():
    o, d, tm, ids, table = _on("meta", *_problem(2, 1, 4, 8))
    oc, dc, t_max = _broadcast(o, d, tm)
    with pytest.raises(ValueError, match="unsupported device"):
        sv.soft_occlusion_layers_soa(oc, dc, t_max, ids, table, SHARP)
    with pytest.raises(ValueError, match="CUDA tensors"):
        softocc.forward(*_problem(2, 1, 4, 8), SHARP, BAND, DEFAULT_T_MIN)


def _cu_float(name: str) -> float:
    """A `constexpr float kName = ...;` of softocc.cu, evaluated as C++ does
    (the expression in double, then rounded to f32)."""
    m = re.search(rf"constexpr float {name} = ([^;]+);", SOFTOCC_CU.read_text())
    expr = m.group(1).replace("(float)", "").replace("f", "")
    return float(np.float32(eval(expr)))


def test_kernel_constants_are_softvis_constants():
    """The kernel's constants are softvis.py's, rounded as torch rounds a
    Python float operand."""
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    assert _cu_float("kDetEps") == f32(DET_EPS)
    assert _cu_float("kGateLo") == f32(sv.DET_GATE_LO)
    assert _cu_float("kGateSpan") == f32(sv.DET_GATE_HI - sv.DET_GATE_LO)
    assert _cu_float("kRampNear0") == f32(sv.RAMP_NEAR0)
    assert _cu_float("kRampNearSpan") == f32(sv.RAMP_NEAR1 - sv.RAMP_NEAR0)
    assert _cu_float("kRampFar1") == f32(sv.RAMP_FAR1)
    assert _cu_float("kRampFarSpan") == f32(sv.RAMP_FAR1 - sv.RAMP_FAR0)
    assert int(re.search(r"constexpr int kMaxC = (\d+);", SOFTOCC_CU.read_text()).group(1)) \
        == softocc.KMAX


def test_the_wrapper_has_no_fallback():
    tree = ast.parse(SOFTOCC_PY.read_text())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    assert not {n for n in names if n.endswith(("_plain", "_vjp", "_ref"))}


# -- on the card ----------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the softocc kernels run on the card only")
    softocc.reset_launches()
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("shape", [(4, 1, 8, 261_120), (4, 4, 8, 65_536), (1, 3, 16, 20_000),
                                   (4, 1, 1, 4_096)])
def test_card_kernels_match_the_plain_route(card, shape):
    """The forward within 1e-6 of the plain route on the card; every
    gradient as accurate against the float64 composition as the plain f32
    route (autograd through the composition on the card)."""
    o, d, tm, ids, table = _on(card, *_problem(*shape, seed=11))
    g = torch.rand(tm.shape, device=card) + 0.5
    vis, plain = _autograd(o, d, tm, ids, table, g)
    _, truth = _truth(o, d, tm, ids, table, g)
    softocc.reset_launches()
    leaves = [x.clone().requires_grad_(True) for x in (*o, *d, tm, table)]
    oc, dc, t_max = _broadcast(leaves[0:3], leaves[3:6], leaves[6])
    got_vis = sv.soft_occlusion_layers_soa(oc, dc, t_max, ids, leaves[7], SHARP, BAND)
    got = torch.autograd.grad(torch.sum(got_vis * g), leaves)
    assert softocc.LAUNCHES == {"softocc_fwd": 1, "softocc_bwd": 1}
    assert float((got_vis.detach() - vis).abs().max()) <= 1e-6
    assert 0.0 < float((vis < 0.999).float().mean())
    _as_accurate(got, plain, truth)


@pytest.mark.card
def test_card_backward_repeats_bit_for_bit(card):
    o, d, tm, ids, table = _on(card, *_problem(4, 1, 8, 261_120, seed=12))
    g = torch.rand(tm.shape, device=card)

    def grads():
        leaves = [x.clone().requires_grad_(True) for x in (*o, *d, tm, table)]
        vis = sv.SoftOcclusion.apply(*leaves[:7], ids, leaves[7], SHARP, BAND, DEFAULT_T_MIN)
        return torch.autograd.grad(torch.sum(vis * g), leaves)

    first, second = grads(), grads()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert softocc.LAUNCHES == {"softocc_fwd": 2, "softocc_bwd": 2}


@pytest.mark.card
def test_card_refuses_more_than_kmax_candidates(card):
    o, d, tm, ids, table = _on(card, *_problem(2, 1, softocc.KMAX + 1, 256))
    oc, dc, t_max = _broadcast(o, d, tm)
    with pytest.raises(ValueError, match="at most 16 candidates"):
        sv.soft_occlusion_layers_soa(oc, dc, t_max, ids, table, SHARP, BAND)
    assert softocc.LAUNCHES == {"softocc_fwd": 0, "softocc_bwd": 0}
