"""tpurt_torch's soft render, its gradients and its fit step against tpurt.

Scenes come from tpurt (cornell, and tests/grad/test_fdcheck.py's
generic_cornell: cornell with a seeded vertex jitter and an off-axis light)
and are handed to the port as numpy arrays, with the loss weights of
test_fdcheck.py's engine gate; other inputs are made with numpy seeds.
tpurt's gather_verts cannot be differentiated (ROADMAP fault F1), so
wherever tpurt's gradient is the reference, tpurt's gather_verts is bound
to a plain gather for that test only.

Tolerances, with their reasons:
- soft images against tpurt's golden: tests/golden/test_golden.py's
  thresholds (frac 0.0 brute, 0.003 the engine; atol 2e-3); the port's
  wide8 against tpurt's brute: rtol = atol = 2e-3, test_fdcheck.py's
  engine-against-brute bound.
- gradients against tpurt's brute jax.grad: atol 1e-5 of the largest
  gradient (measured 2.2e-7): sigmoid, rsqrt and sums round differently in
  XLA and torch.
- check_grads_fd: tpurt's thresholds (eps 1e-3, rtol 6e-2, atol 2e-3, 8
  probes per leaf, seed 1).
- 3 SGD steps against tpurt's fit: losses rtol 1e-4, parameters atol 1e-5
  (measured 7e-6 and 6e-7).  SGD is linear in the gradient; Adam's first
  step is ~lr * sign(g), which turns noise-level gradients into full steps,
  so Adam is held to optax on fixed gradients instead (atol 1e-6).  The
  same bounds hold with a tree rebuild after every step.
- Adam with and without rebuilds: rtol and atol 1e-6; the tree only decides
  which candidates a ray finds, and here both trees find the same ones.
- tree_quality: rtol 1e-5 (a sum of ~6K areas in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpurt.diff.gather_grad as j_gather_grad
import tpurt.render.pipeline as j_pipeline
from tests.golden.test_golden import _check
from tests.grad.test_fdcheck import SOFT, generic_cornell
from tpurt.api.config import FitConfig as JFitConfig
from tpurt.api.config import RenderConfig as JRenderConfig
from tpurt.api.inverse import InverseRenderer as JInverseRenderer
from tpurt.core import scene as jscene

from tpurt_torch.accel.bvh8 import refit_wide_direct
from tpurt_torch.api.config import FitConfig, RenderConfig
from tpurt_torch.api.inverse import InverseRenderer, make_optimizer
from tpurt_torch.core.convert import camera_from_numpy, scene_from_numpy
from tpurt_torch.core.scene import make_cornell_box
from tpurt_torch.diff.fdcheck import check_grads_fd
from tpurt_torch.render.pipeline import make_tracer, render, tri_table

RK = dict(soft=True, k_layers=4, sharpness=40.0, band=0.08, k_occ=8)


def _plain(verts, idx, grad_cols=None):
    return verts[idx]


def _to_port(js, jc):
    a = lambda x: np.asarray(x)  # noqa: E731
    scene = scene_from_numpy(
        verts=a(js.tris.verts), faces=a(js.tris.faces), albedo=a(js.tris.albedo),
        emission=a(js.tris.emission), light_pos=a(js.lights.pos),
        light_intensity=a(js.lights.intensity), background=a(js.background),
        ambient=a(js.ambient), device="cpu")
    cam = camera_from_numpy(eye=a(jc.eye), target=a(jc.target), up=a(jc.up),
                            fov_y_deg=a(jc.fov_y_deg), width=jc.width,
                            height=jc.height, device="cpu")
    return scene, cam


@pytest.fixture(scope="module")
def generic():
    """generic_cornell(16), tpurt's brute soft image and its jax.grad with
    respect to verts and albedo of mean(w * image) (F1 bypassed)."""
    js, jc = generic_cornell(16)
    # test_fdcheck.py's _engine_loss weights, so the FD gate probes tpurt's
    # own loss (with other weights one probe of 16 sits on curvature that
    # eps = 1e-3 does not resolve, on brute and wide8 alike)
    w = np.array(jax.random.uniform(jax.random.PRNGKey(3), (16, 16, 3),
                                    minval=0.2, maxval=1.0))

    def loss(params):
        verts, albedo = params
        sc = js.replace(tris=js.tris.replace(verts=verts, albedo=albedo))
        return jnp.mean(w * j_pipeline.render(sc, jc, method="brute", **SOFT))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_gather_grad, "gather_verts", _plain)
        mp.setattr(j_pipeline, "gather_verts", _plain)
        img = np.asarray(j_pipeline.render(js, jc, method="brute", **SOFT))
        grads = jax.grad(loss)((js.tris.verts, js.tris.albedo))
    ts, tc = _to_port(js, jc)
    return dict(js=js, jc=jc, ts=ts, tc=tc, w=w, img=img,
                grads=[np.asarray(g) for g in grads])


# -- soft images -----------------------------------------------------------
@pytest.mark.parametrize("method,frac", [("brute", 0.0), ("wide8", 0.003), ("bvh", 0.003),
                                         ("binary", 0.003)])
def test_golden_cornell_soft(method, frac):
    scene, cam = make_cornell_box(device="cpu")
    img = render(scene, dataclasses.replace(cam, width=48, height=48),
                 method=method, **RK)
    _check(img, "cornell_soft_48.npy", frac=frac)


@pytest.mark.parametrize("method", ["brute", "wide8"])
def test_soft_image_matches_tpurt_brute(generic, method):
    img = render(generic["ts"], generic["tc"], method=method, **SOFT)
    np.testing.assert_allclose(img.numpy(), generic["img"], rtol=2e-3, atol=2e-3)


# -- gradients -------------------------------------------------------------
def _port_loss(generic, method):
    """mean(w * image) as a function of (verts, albedo); for wide8 the
    band-inflated tree is built once and refit inside the loss, as the fit
    step does."""
    ts, tc = generic["ts"], generic["tc"]
    w = torch.from_numpy(generic["w"])
    tracer0 = make_tracer(ts, method, band=SOFT["band"])

    def loss(params):
        verts, albedo = params
        tris = dataclasses.replace(ts.tris, verts=verts, albedo=albedo)
        scene = dataclasses.replace(ts, tris=tris)
        tracer = tracer0
        if method == "wide8":
            frozen = dataclasses.replace(tris, verts=verts.detach())
            tracer = dataclasses.replace(tracer0, wide=refit_wide_direct(tracer0.wide, frozen))
        return torch.mean(w * render(scene, tc, tracer=tracer, **SOFT))

    return loss, (ts.tris.verts.clone(), ts.tris.albedo.clone())


@pytest.mark.parametrize("method", ["brute", "wide8"])
def test_soft_grads_match_tpurt_brute(generic, method):
    loss, params = _port_loss(generic, method)
    params = [p.requires_grad_(True) for p in params]
    grads = torch.autograd.grad(loss(params), params)
    for got, ref in zip(grads, generic["grads"]):
        assert np.isfinite(got.numpy()).all() and np.abs(ref).max() > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_wide8_grads_match_finite_differences(generic):
    loss, params = _port_loss(generic, "wide8")
    report = check_grads_fd(loss, params, eps=1e-3, rtol=6e-2, atol=2e-3,
                            max_probes_per_leaf=8, seed=1)
    assert report["ok"] and report["n_probes"] == 16


def test_albedo_gradient_sign(generic):
    """Lambertian shading is monotone in albedo: no negative gradient."""
    ts, tc = generic["ts"], generic["tc"]
    albedo = ts.tris.albedo.clone().requires_grad_(True)
    scene = dataclasses.replace(ts, tris=dataclasses.replace(ts.tris, albedo=albedo))
    (g,) = torch.autograd.grad(torch.sum(render(scene, tc, method="wide8", **SOFT)), albedo)
    assert (g >= -1e-6).all() and g.max() > 0.0


# -- the fit step ----------------------------------------------------------
@pytest.fixture(scope="module")
def fit_case(generic):
    """The albedo x 0.8 soft brute image of generic_cornell(16) as target."""
    js, jc = generic["js"], generic["jc"]
    dim = js.replace(tris=js.tris.replace(albedo=js.tris.albedo * 0.8))
    tgt = np.array(j_pipeline.render(dim, jc, method="brute", **RK))
    return dict(generic, target=tgt)


def test_sgd_fit_matches_tpurt(fit_case, monkeypatch):
    monkeypatch.setattr(j_gather_grad, "gather_verts", _plain)
    monkeypatch.setattr(j_pipeline, "gather_verts", _plain)
    fit = dict(steps=3, optimizer="sgd", lr=1e-6, grad_chunks=2)
    ref = JInverseRenderer(fit_case["js"], fit_case["jc"], fit=JFitConfig(**fit),
                           render=JRenderConfig(method="brute", **RK)).fit(fit_case["target"])
    got = InverseRenderer(fit_case["ts"], fit_case["tc"], fit=FitConfig(**fit),
                          render=RenderConfig(method="brute", **RK)).fit(
        torch.from_numpy(fit_case["target"]))
    assert got.steps_run == 3 and len(got.losses) == 3
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-4)
    for k in ("verts", "albedo"):
        moved = np.abs(np.asarray(ref.params[k]) - np.asarray(getattr(fit_case["js"].tris, k)))
        assert moved.max() > 1e-4, k  # the steps really moved the parameters
        np.testing.assert_allclose(got.params[k].numpy(), np.asarray(ref.params[k]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["bvh", "binary"])
def test_sgd_fit_binary_engines_match_tpurt_bvh(fit_case, monkeypatch, method):
    """tpurt's default engine, "bvh", in its fit step (refit_aabbs inside the
    step) against the port's "bvh" and "binary" (refit_aabbs, then
    refit_packed): the same trajectory, at the brute fit's tolerances."""
    monkeypatch.setattr(j_gather_grad, "gather_verts", _plain)
    monkeypatch.setattr(j_pipeline, "gather_verts", _plain)
    fit = dict(steps=3, optimizer="sgd", lr=1e-6, grad_chunks=2)
    ref = JInverseRenderer(fit_case["js"], fit_case["jc"], fit=JFitConfig(**fit),
                           render=JRenderConfig(method="bvh", **RK)).fit(fit_case["target"])
    inv = InverseRenderer(fit_case["ts"], fit_case["tc"], fit=FitConfig(**fit),
                          render=RenderConfig(method=method, **RK))
    got = inv.fit(torch.from_numpy(fit_case["target"]))
    assert (inv.tracer0.packed is not None) == (method == "binary")
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-4)
    for k in ("verts", "albedo"):
        moved = np.abs(np.asarray(ref.params[k]) - np.asarray(getattr(fit_case["js"].tris, k)))
        assert moved.max() > 1e-4, k
        np.testing.assert_allclose(got.params[k].numpy(), np.asarray(ref.params[k]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["bvh", "binary"])
def test_binary_fit_step_refits_inside_the_step(fit_case, monkeypatch, method):
    """Every step refits the LBVH's flat boxes (and, for "binary", the
    packed rows) from the build's tree at the step's vertices, without
    gradient; the build's tree itself is left as it was."""
    import tpurt_torch.api.inverse as inverse

    calls = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, kw.get("update_flat"), args[-1].verts.requires_grad))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(inverse, "refit_aabbs", spy("boxes", inverse.refit_aabbs))
    monkeypatch.setattr(inverse, "refit_packed", spy("rows", inverse.refit_packed))
    inv = InverseRenderer(fit_case["ts"], fit_case["tc"],
                          fit=FitConfig(steps=2, lr=1e-2, grad_chunks=1),
                          render=RenderConfig(method=method, **RK))
    flat0 = inv.tracer0.bvh.flat_lo.clone()
    inv.fit(torch.from_numpy(fit_case["target"]))
    rows = [("rows", None, False)] if method == "binary" else []
    assert calls == 2 * ([("boxes", True, False)] + rows)
    assert torch.equal(inv.tracer0.bvh.flat_lo, flat0)


def test_sgd_fit_with_rebuilds_matches_tpurt(fit_case, monkeypatch):
    """rebuild_ratio 0 rebuilds the tree after every step: the port's wide8
    fit carries on through three fresh topologies along tpurt's trajectory,
    and its last tree is the one built at the fitted vertices."""
    monkeypatch.setattr(j_gather_grad, "gather_verts", _plain)
    monkeypatch.setattr(j_pipeline, "gather_verts", _plain)
    fit = dict(steps=3, optimizer="sgd", lr=1e-6, grad_chunks=2, rebuild_every=1,
               rebuild_ratio=0.0)
    jinv = JInverseRenderer(fit_case["js"], fit_case["jc"], fit=JFitConfig(**fit),
                            render=JRenderConfig(method="brute", **RK))
    ref = jinv.fit(fit_case["target"])
    inv = InverseRenderer(fit_case["ts"], fit_case["tc"], fit=FitConfig(**fit),
                          render=RenderConfig(method="wide8", **RK))
    tree0 = inv.tracer0
    got = inv.fit(torch.from_numpy(fit_case["target"]))
    assert inv.rebuilds == jinv.rebuilds == 3 and inv.tracer0 is not tree0
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-4)
    for k in ("verts", "albedo"):
        np.testing.assert_allclose(got.params[k].numpy(), np.asarray(ref.params[k]),
                                   rtol=0, atol=1e-5)
    fresh = make_tracer(got.scene, "wide8", band=RK["band"]).wide
    assert torch.equal(inv.tracer0.wide.wrow, fresh.wrow)
    assert torch.equal(inv.tracer0.wide.tri_rows, fresh.tri_rows)


def test_adam_fit_unchanged_by_rebuilds(fit_case):
    """A rebuild swaps the tree, not the optimizer's state: Adam with a
    rebuild after every step follows the fit without rebuilds."""
    runs = [InverseRenderer(fit_case["ts"], fit_case["tc"],
                            fit=FitConfig(steps=3, lr=1e-3, grad_chunks=2,
                                          rebuild_every=every, rebuild_ratio=0.0),
                            render=RenderConfig(method="wide8", **RK))
            for every in (0, 1)]
    res = [inv.fit(torch.from_numpy(fit_case["target"])) for inv in runs]
    assert [inv.rebuilds for inv in runs] == [0, 3]
    np.testing.assert_allclose(res[1].losses, res[0].losses, rtol=1e-6)
    for k in ("verts", "albedo"):
        np.testing.assert_allclose(res[1].params[k].numpy(), res[0].params[k].numpy(),
                                   rtol=0, atol=1e-6)


def test_tree_quality_drift_and_rebuild_match_tpurt():
    """tpurt's rebuild-on-drift test (tests/unit/test_fit_rebuild.py) with
    numpy noise, held to tpurt's qualities: a large incoherent displacement
    degrades the refit tree, the trigger fires, and the tree rebuilt at the
    moved vertices has tpurt's rebuilt quality."""
    js, jc = jscene.make_bunny_scene(num_tris=400)
    jc = jc.replace(width=8, height=8)
    ts, tc = _to_port(js, jc)
    rk = dict(soft=True, k_layers=2, sharpness=40.0, band=0.1)
    fit = dict(steps=1, lr=5e-3, grad_chunks=1)
    jinv = JInverseRenderer(js, jc, fit=JFitConfig(**fit), render=JRenderConfig(method="bvh", **rk))
    tinv = InverseRenderer(ts, tc, fit=FitConfig(**fit), render=RenderConfig(method="wide8", **rk))
    v = np.array(js.tris.verts)
    moved = v + 3.0 * np.random.default_rng(0).uniform(-1, 1, v.shape).astype(np.float32)
    jp, tp = {"verts": jnp.asarray(moved)}, {"verts": torch.from_numpy(moved)}
    q = [(tinv.tree_quality({"verts": torch.from_numpy(v)}),
          jinv.tree_quality({"verts": jnp.asarray(v)}))]
    q.append((tinv.tree_quality(tp), jinv.tree_quality(jp)))
    assert q[1][0] > 1.5 * q[0][0]
    assert tinv._maybe_rebuild(tp) and jinv._maybe_rebuild(jp)
    assert tinv.rebuilds == jinv.rebuilds == 1
    q.append((tinv.tree_quality(tp), jinv.tree_quality(jp)))
    assert q[2][0] < q[1][0]
    for got, ref in q:
        assert got == pytest.approx(ref, rel=1e-5)
    assert not tinv._maybe_rebuild(tp)


def test_wide8_fit_equals_brute_fit(fit_case):
    """The engines find the same candidates on this scene, so the fits agree."""
    runs = [InverseRenderer(fit_case["ts"], fit_case["tc"],
                            fit=FitConfig(steps=2, lr=1e-3, grad_chunks=4),
                            render=RenderConfig(method=m, **RK)).fit(
        torch.from_numpy(fit_case["target"])) for m in ("brute", "wide8")]
    np.testing.assert_allclose(runs[1].losses, runs[0].losses, rtol=1e-5)
    np.testing.assert_allclose(runs[1].params["verts"].numpy(),
                               runs[0].params["verts"].numpy(), rtol=0, atol=1e-5)


def test_albedo_fit_lowers_the_loss(fit_case):
    got = InverseRenderer(fit_case["ts"], fit_case["tc"],
                          fit=FitConfig(steps=5, lr=1e-2, fit_verts=False, grad_chunks=2),
                          render=RenderConfig(method="wide8", **RK)).fit(
        torch.from_numpy(fit_case["target"]))
    assert got.losses[-1] < got.losses[0]
    assert len(got.grad_norms) == 5 and set(got.grad_norms[0]) == {"albedo"}
    assert all(np.isfinite(g["albedo"]) and g["albedo"] > 0 for g in got.grad_norms)
    assert float(got.scene.tris.albedo.max()) <= 1.0  # apply_params clamps


def test_adam_matches_optax_on_fixed_gradients():
    rng = np.random.default_rng(21)
    p0 = {"albedo": rng.uniform(0, 1, (30, 3)).astype(np.float32),
          "verts": rng.normal(size=(20, 3)).astype(np.float32)}
    gs = [{k: rng.normal(scale=s, size=v.shape).astype(np.float32) for k, v in p0.items()}
          for s in (1.0, 1e-3, 10.0, 0.5, 1e-6)]
    opt = optax.adam(1e-2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    params = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt = make_optimizer(FitConfig(lr=1e-2), params)
    for g in gs:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in p0:
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)


def test_tree_quality_matches_tpurt():
    js = jscene.make_bunny_scene(num_tris=3000)[0]
    jc = jscene.make_bunny_scene(num_tris=3000)[1].replace(width=8, height=8)
    ts, tc = _to_port(js, jc)
    moved = np.asarray(js.tris.verts) + np.random.default_rng(4).normal(
        scale=0.05, size=js.tris.verts.shape).astype(np.float32)
    jinv = JInverseRenderer(js, jc, render=JRenderConfig(method="bvh", **RK))
    tinv = InverseRenderer(ts, tc, render=RenderConfig(method="wide8", **RK))
    for v in (np.asarray(js.tris.verts), moved):
        ref = jinv.tree_quality({"verts": jnp.asarray(v)})
        got = tinv.tree_quality({"verts": torch.from_numpy(v)})
        assert got == pytest.approx(ref, rel=1e-5)
    assert InverseRenderer(ts, tc, render=RenderConfig(method="brute", **RK)).tree_quality(
        {"verts": ts.tris.verts}) == 1.0


@pytest.mark.parametrize("kw,match", [
    (dict(mesh=object()), "DeviceMesh"),
])
def test_unported_fit_options_raise(kw, match):
    """The data-parallel fit is ported: a mesh that is not a DeviceMesh is
    refused when the fit is set up."""
    scene, cam = make_cornell_box(device="cpu")
    with pytest.raises(TypeError, match=match):
        InverseRenderer(scene, cam, **{"render": RenderConfig(method="brute", **RK), **kw})


def test_fit_runs_and_ignores_light_samples():
    """A render config with light_samples > 0 fits (it was refused before
    area lights were ported): the fit passes no generator, so, as tpurt's
    fit passes no key, it samples no emitters and takes the steps of the
    same fit without them."""
    scene, cam = make_cornell_box(device="cpu")
    cam = dataclasses.replace(cam, width=8, height=8)
    with torch.no_grad():
        target = render(scene, cam, method="brute", **RK) * 0.9
    res = [InverseRenderer(scene, cam, fit=FitConfig(steps=2),
                           render=RenderConfig(method="brute", light_samples=s, **RK)).fit(target)
           for s in (2, 0)]
    assert res[0].losses == res[1].losses and len(res[0].losses) == 2


def test_hard_render_config_is_refused():
    scene, cam = make_cornell_box(device="cpu")
    with pytest.raises(ValueError, match="soft"):
        InverseRenderer(scene, cam, render=RenderConfig(method="brute"))


def test_table_backward_reaches_verts_and_albedo():
    """tri_table's gradient: verts through the corner gather (v0 gets
    -e1 - e2 + its own column), albedo directly, emission nothing."""
    scene, _ = make_cornell_box(device="cpu")
    verts = scene.tris.verts.clone().requires_grad_(True)
    albedo = scene.tris.albedo.clone().requires_grad_(True)
    tris = dataclasses.replace(scene.tris, verts=verts, albedo=albedo)
    cot = torch.from_numpy(np.random.default_rng(8).normal(
        size=(scene.num_tris, 15)).astype(np.float32))
    gv, ga = torch.autograd.grad(tri_table(tris), (verts, albedo), cot)
    assert torch.equal(ga, cot[:, 9:12])
    ref = torch.zeros_like(verts)
    f = scene.tris.faces.long()
    ref.index_add_(0, f[:, 0], cot[:, 0:3] - cot[:, 3:6] - cot[:, 6:9])
    ref.index_add_(0, f[:, 1], cot[:, 3:6])
    ref.index_add_(0, f[:, 2], cot[:, 6:9])
    torch.testing.assert_close(gv, ref, rtol=1e-5, atol=1e-5)
