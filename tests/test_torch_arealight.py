"""Area lights in tpurt_torch against tpurt on the CPU.

sample_emitters' samples and pdf, the radiometric anchor (a small area
light against the equivalent point light) and a penumbra, on the port
alone, as tpurt's tests/unit/test_arealight.py checks tpurt;
area_light_contrib, the hard and soft frames with light_samples on every
engine and the soft frame's gradients against tpurt; the Renderer's and the
CLI's seeded default; the soft-occlusion oracles against tpurt's.

jax.random and torch draw different numbers, so the frame tests inject the
same emitter samples into both packages: each binds sample_emitters in its
render.pipeline to a function returning the same fixed arrays, with pytest's
monkeypatch, for that test only.  tpurt's own gradient through this path
fails (ROADMAP fault F1), so the gradient test binds tpurt's gather_verts to
a plain gather the same way.  Tolerances: images and contributions rtol
1e-5, atol 1e-5 (the same f32 formulas); the soft frame and its gradients,
and the soft-occlusion oracles, within 1e-5 of the reference's largest
magnitude and rtol 1e-4 elementwise, because XLA's CPU backend contracts
a*b+c into FMAs and rounds sigmoid, rsqrt and sums differently from torch
(as tests/test_torch_diff.py states for the same functions).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.diff.gather_grad as j_gather_grad
import tpurt.render.pipeline as j_pipeline
from tpurt.accel.lbvh import build_lbvh as j_build_lbvh
from tpurt.accel.traverse_ref import soft_occlusion_ref as j_soft_occlusion_ref
from tpurt.core.geometry import Rays as JRays
from tpurt.core.geometry import Triangles as JTriangles
from tpurt.core.scene import make_cornell_box as j_make_cornell_box
from tpurt.diff import softvis as jsv
from tpurt.render.shade import area_light_contrib as j_area_light_contrib

import tpurt_torch.render.pipeline as t_pipeline
from tpurt_torch.accel.lbvh import build_lbvh
from tpurt_torch.accel.traverse_ref import soft_occlusion_ref
from tpurt_torch.api.config import RenderConfig
from tpurt_torch.api.renderer import Renderer
from tpurt_torch.cli.main import main
from tpurt_torch.core.convert import camera_from_numpy, scene_from_numpy
from tpurt_torch.core.geometry import PointLight, Rays, Triangles
from tpurt_torch.core.scene import Scene, make_cornell_box
from tpurt_torch.diff import softvis as tsv
from tpurt_torch.render.camera import gen_primary_rays
from tpurt_torch.render.pipeline import make_tracer, render, render_rays
from tpurt_torch.render.shade import area_light_contrib, sample_emitters

S = 3  # emitter samples a frame in the injected tests
SOFT = dict(soft=True, k_layers=4, sharpness=40.0, band=0.08, k_occ=8)
METHODS = ("brute", "bvh", "binary", "wide8")


def _gen(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _close(got, ref, rtol=1e-5, atol=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def _close_scaled(got, ref, rtol=1e-4, scale_atol=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=scale_atol * max(np.abs(ref).max(), 1e-30))


# -- scenes ------------------------------------------------------------------
def _floor_and_emitter(le=8.0, size=0.05, h=2.0):
    """tpurt's test scene: a floor quad at y = 0 and one small emissive
    triangle at height h, no point lights, black ambient and background."""
    verts = np.array([[-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5],
                      [-size, h, -size], [size, h, -size], [0, h, size]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6]], np.int32)
    emission = np.zeros((3, 3), np.float32)
    emission[2] = le
    tris = Triangles.create(verts, faces, albedo=0.7, emission=emission, device="cpu")
    lights = PointLight(pos=torch.zeros((0, 3)), intensity=torch.zeros((0, 3)))
    return Scene.create(tris, lights, background=(0, 0, 0), ambient=(0, 0, 0))


def _emissive_cornell(res=12):
    """tpurt's cornell box with its ceiling (two triangles at y = 1) made
    an emitter of Le = 1.5, and the eye moved off the box's axis (no ray
    runs through a wall seam): (tpurt scene, camera), (port scene, camera)."""
    js, jc = j_make_cornell_box()
    emission = np.asarray(js.tris.emission).copy()
    cen = np.asarray(js.tris.verts)[np.asarray(js.tris.faces)].mean(axis=1)
    emission[cen[:, 1] > 1.0 - 1e-4] = 1.5
    js = js.replace(tris=js.tris.replace(emission=jnp.asarray(emission)))
    jc = jc.replace(width=res, height=res, eye=jnp.array([0.5071, 0.4913, 2.2]))
    a = np.asarray
    ts = scene_from_numpy(
        verts=a(js.tris.verts), faces=a(js.tris.faces), albedo=a(js.tris.albedo),
        emission=emission, light_pos=a(js.lights.pos),
        light_intensity=a(js.lights.intensity), background=a(js.background),
        ambient=a(js.ambient), device="cpu")
    tc = camera_from_numpy(eye=a(jc.eye), target=a(jc.target), up=a(jc.up),
                           fov_y_deg=a(jc.fov_y_deg), width=res, height=res, device="cpu")
    return (js, jc), (ts, tc)


def _inject(monkeypatch, ts, n=S, seed=7):
    """Bind both packages' pipeline.sample_emitters to the same fixed
    samples, drawn once by the port's sampler from a seeded generator."""
    lp, ln_, le, pdf, _ = (x.numpy() for x in sample_emitters(_gen(seed), ts.tris, n))
    assert (pdf > 0).all()

    def j_fake(key, tris, num):
        assert num == n
        return (jnp.asarray(lp), jnp.asarray(ln_), jnp.asarray(le), jnp.asarray(pdf),
                jnp.asarray(True))

    def t_fake(generator, tris, num):
        assert num == n and generator is not None
        return (torch.from_numpy(lp), torch.from_numpy(ln_), torch.from_numpy(le),
                torch.from_numpy(pdf), torch.tensor(True))

    monkeypatch.setattr(j_pipeline, "sample_emitters", j_fake)
    monkeypatch.setattr(t_pipeline, "sample_emitters", t_fake)


def _rays(tc):
    """The camera's primary rays for both packages (the port's, handed to
    tpurt: the two ray generators may round an ulp apart)."""
    tr = gen_primary_rays(tc)
    return JRays(o=jnp.asarray(tr.o.numpy()), d=jnp.asarray(tr.d.numpy())), tr


# -- sample_emitters and area_light_contrib ----------------------------------
def test_sample_emitters_on_surface_and_pdf():
    """Every sample lies on the only emitter's plane y = 2, carries its Le,
    and has the uniform-area pdf 1 / area (tpurt's test)."""
    scene = _floor_and_emitter()
    p, nl, le, pdf, any_e = sample_emitters(_gen(0), scene.tris, 256)
    assert bool(any_e)
    np.testing.assert_allclose(p[:, 1].numpy(), 2.0, atol=1e-5)
    assert (le.numpy() > 0).all()
    np.testing.assert_allclose(np.abs(nl[:, 1].numpy()), 1.0, rtol=1e-6)
    v = scene.tris.verts.numpy()
    e_area = 0.5 * np.linalg.norm(np.cross(v[5] - v[4], v[6] - v[4]))
    np.testing.assert_allclose(pdf.numpy(), 1.0 / e_area, rtol=1e-4)


def test_sample_emitters_chooses_faces_by_area_times_emission():
    """Two emitters, the second with 3x the area x mean emission: about 3/4
    of the samples on it (within 5 sigma), the area-measure pdf of each
    sample its face's weight / (area x total weight), and points inside
    their triangle (the sqrt(r) warp's barycentrics in [0, 1])."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                      [0, 0, 5], [2, 0, 5], [0, 1, 5]], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    emission = np.array([[3, 3, 3], [4.5, 4.5, 4.5]], np.float32)
    tris = Triangles.create(verts, faces, emission=emission, device="cpu")
    n = 20_000
    p, _, le, pdf, _ = sample_emitters(_gen(1), tris, n)
    on_second = p[:, 2].numpy() > 2.5
    frac = on_second.mean()
    assert abs(frac - 0.75) < 5 * np.sqrt(0.75 * 0.25 / n)
    np.testing.assert_allclose(pdf.numpy()[~on_second], 0.25 / 0.5, rtol=1e-5)
    np.testing.assert_allclose(pdf.numpy()[on_second], 0.75 / 1.0, rtol=1e-5)
    np.testing.assert_allclose(le.numpy()[on_second], 4.5)
    q = p.numpy()[~on_second]
    assert (q[:, :2] >= -1e-6).all() and (q[:, 0] + q[:, 1] <= 1 + 1e-6).all()


def test_sample_emitters_without_emitters_adds_no_light():
    """No emissive triangle: pdf 0, any_emitter False, and the contribution
    is 0 (tpurt's pdf-safe weights), with nothing read back to the host."""
    scene, _ = make_cornell_box(device="cpu")
    lp, ln_, le, pdf, any_e = sample_emitters(_gen(2), scene.tris, 5)
    assert not bool(any_e) and torch.equal(pdf, torch.zeros(5))
    p = torch.rand((4, 3), generator=_gen(3))
    n = torch.tensor([[0.0, 1.0, 0.0]]).expand(4, 3)
    c = area_light_contrib(p, n, torch.ones(4, 3), lp, ln_, torch.ones(5, 3), pdf,
                           torch.ones(4, 5))
    assert torch.equal(c, torch.zeros(4, 3))


def test_area_light_contrib_matches_tpurt():
    rng = np.random.default_rng(4)
    r, s = 37, 5
    p, alb = rng.normal(size=(r, 3)), rng.uniform(size=(r, 3))
    n = rng.normal(size=(r, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    lp, le = rng.normal(size=(s, 3)) + [0, 3, 0], rng.uniform(1, 5, size=(s, 3))
    ln_ = rng.normal(size=(s, 3))
    ln_ /= np.linalg.norm(ln_, axis=-1, keepdims=True)
    pdf = rng.uniform(0.1, 2.0, size=s)
    pdf[1] = 0.0  # a sample of pdf 0 adds nothing
    vis = rng.uniform(size=(r, s))
    args = [x.astype(np.float32) for x in (p, n, alb, lp, ln_, le, pdf, vis)]
    ref = j_area_light_contrib(*(jnp.asarray(x) for x in args))
    got = area_light_contrib(*(torch.from_numpy(x) for x in args))
    _close(got.numpy(), ref)


def test_small_area_light_matches_equivalent_point_light():
    """A tiny emitter sampled by Monte Carlo agrees with the equivalent
    point light (I = Le A cos_l) to a few percent: the radiometric anchor
    (tpurt's test, its tolerance)."""
    le, size, h = 8.0, 0.05, 2.0
    scene = _floor_and_emitter(le, size, h)
    v = scene.tris.verts.numpy()
    e_area = 0.5 * np.linalg.norm(np.cross(v[5] - v[4], v[6] - v[4]))
    centroid = v[4:7].mean(axis=0)
    xs = np.linspace(-0.5, 0.5, 8, dtype=np.float32)
    o = np.stack([xs, np.full_like(xs, 3.0), np.zeros_like(xs)], -1)
    d = np.tile(np.array([[0, -1.0, 0]], np.float32), (8, 1))
    rays = Rays(o=torch.from_numpy(o), d=torch.from_numpy(d))
    img = render_rays(make_tracer(scene, "brute"), rays, light_samples=64, generator=_gen(1))
    n_e = np.cross(v[5] - v[4], v[6] - v[4])
    n_e /= np.linalg.norm(n_e)
    pr = np.stack([xs, np.zeros_like(xs), np.zeros_like(xs)], -1)
    delta = centroid[None] - pr
    r2 = (delta ** 2).sum(-1)
    wi = delta / np.sqrt(r2)[:, None]
    cos_s = np.maximum((wi * np.array([0, 1.0, 0])).sum(-1), 0.0)
    cos_l = np.abs((wi * n_e).sum(-1))
    expect = 0.7 / np.pi * le * e_area * cos_s * cos_l / r2
    np.testing.assert_allclose(img[:, 0].numpy(), expect, rtol=0.08)


@pytest.mark.parametrize("method", METHODS)
def test_area_light_penumbra_and_grads(method):
    """An occluder between floor and emitter: an umbra and a penumbra on
    the floor through every engine's any-hit walk, and the soft render's
    gradient through the area-light path is finite and nonzero (tpurt's
    test, which fails on tpurt itself from F1)."""
    scene = _floor_and_emitter(le=8.0, size=0.6, h=2.0)
    v = scene.tris.verts.numpy()
    occ_v = np.array([[-0.4, 1, -0.4], [0.4, 1, -0.4], [0.4, 1, 0.4],
                      [-0.4, 1, 0.4]], np.float32)
    verts = np.concatenate([v, occ_v])
    faces = np.concatenate([scene.tris.faces.numpy(), np.array([[7, 8, 9], [7, 9, 10]])])
    emission = np.concatenate([scene.tris.emission.numpy(), np.zeros((2, 3), np.float32)])
    tris = Triangles.create(verts, faces, albedo=0.7, emission=emission, device="cpu")
    scene = dataclasses.replace(scene, tris=tris)
    xs = np.linspace(-2.2, 2.2, 45, dtype=np.float32)
    o = np.stack([xs, np.full_like(xs, 0.8), np.zeros_like(xs)], -1)
    d = np.tile(np.array([[0, -1.0, 0]], np.float32), (45, 1))
    rays = Rays(o=torch.from_numpy(o), d=torch.from_numpy(d))
    img = render_rays(make_tracer(scene, method), rays, light_samples=128,
                      generator=_gen(2))[:, 0].numpy()
    lit, dark = img.max(), img.min()
    assert dark < 0.25 * lit
    mid = (img > dark + 0.2 * (lit - dark)) & (img < lit - 0.2 * (lit - dark))
    assert mid.any(), "no penumbra: the area light is not soft"
    verts_t = tris.verts.clone().requires_grad_(True)
    sc = dataclasses.replace(scene, tris=dataclasses.replace(tris, verts=verts_t))
    c = render_rays(make_tracer(sc, method, band=0.08), rays, light_samples=16,
                    generator=_gen(3), **SOFT)
    (g,) = torch.autograd.grad(c.sum(), verts_t)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


# -- frames with injected samples against tpurt ------------------------------
@pytest.mark.parametrize("method", METHODS)
def test_hard_frame_with_area_lights_matches_tpurt(method, monkeypatch):
    """The hard frame with S area-light samples through each engine's
    any-hit walk, against tpurt's brute frame with the same samples; it
    differs from the point-lit frame."""
    (js, jc), (ts, tc) = _emissive_cornell()
    _inject(monkeypatch, ts)
    jr, tr = _rays(tc)
    ref = j_pipeline.render_rays(j_pipeline.make_tracer(js, "brute"), jr,
                                 light_samples=S, key=jax.random.PRNGKey(0))
    got = render_rays(make_tracer(ts, method), tr, light_samples=S, generator=_gen(0))
    _close(got.numpy(), ref)
    point = render_rays(make_tracer(ts, method), tr)
    assert float((got - point).abs().max()) > 1e-3


@pytest.mark.parametrize("method", METHODS)
def test_soft_frame_and_grads_with_area_lights_match_tpurt(method, monkeypatch):
    """The soft frame with S samples (the candidate occluders toward each
    sample through each engine's k-nearest walk) and d/d(verts, albedo) of
    sum(w * color) against tpurt's brute soft frame and jax.grad, with the
    same samples and tpurt's gather_verts bound to a plain gather (F1)."""
    (js, jc), (ts, tc) = _emissive_cornell(res=10)
    _inject(monkeypatch, ts)
    plain = lambda verts, idx, grad_cols=None: verts[idx]  # noqa: E731
    monkeypatch.setattr(j_gather_grad, "gather_verts", plain)
    monkeypatch.setattr(j_pipeline, "gather_verts", plain)
    jr, tr = _rays(tc)
    w = np.random.default_rng(5).uniform(0.2, 1.0, (tr.o.shape[0], 3)).astype(np.float32)

    def j_loss(params):
        verts, albedo = params
        sc = js.replace(tris=js.tris.replace(verts=verts, albedo=albedo))
        c = j_pipeline.render_rays(j_pipeline.make_tracer(sc, "brute", band=0.08), jr,
                                   light_samples=S, key=jax.random.PRNGKey(0), **SOFT)
        return jnp.sum(jnp.asarray(w) * c), c

    (_, ref), jg = jax.value_and_grad(j_loss, has_aux=True)(
        (js.tris.verts, js.tris.albedo))
    verts = ts.tris.verts.clone().requires_grad_(True)
    albedo = ts.tris.albedo.clone().requires_grad_(True)
    sc = dataclasses.replace(ts, tris=dataclasses.replace(ts.tris, verts=verts, albedo=albedo))
    got = render_rays(make_tracer(sc, method, band=0.08), tr, light_samples=S,
                      generator=_gen(0), **SOFT)
    _close_scaled(got.detach().numpy(), ref)
    tg = torch.autograd.grad(torch.sum(torch.from_numpy(w) * got), (verts, albedo))
    for a, b in zip(tg, jg):
        _close_scaled(a.numpy(), b)
    point = render_rays(make_tracer(ts, method, band=0.08), tr, **SOFT)
    assert float((got.detach() - point).abs().max()) > 1e-3


def test_generator_less_render_samples_nothing():
    """light_samples > 0 without a generator renders the point-lit frame,
    as tpurt's render_rays without a key does."""
    _, (ts, tc) = _emissive_cornell(res=8)
    tr = gen_primary_rays(tc)
    for kw in ({}, SOFT):
        tracer = make_tracer(ts, "wide8", band=0.08 if kw else 0.0)
        assert torch.equal(render_rays(tracer, tr, light_samples=2, **kw),
                           render_rays(tracer, tr, **kw))


# -- the seeded defaults: Renderer and the CLI --------------------------------
def test_renderer_draws_from_a_generator_seeded_light_seed():
    """Renderer.render and render_rays with light_samples > 0 and no
    generator draw from one seeded light_seed: equal to render() with such
    a generator, the same on every call, different for another seed."""
    _, (ts, tc) = _emissive_cornell(res=8)
    r = Renderer(ts, RenderConfig(method="binary", light_samples=2, light_seed=5))
    img = r.render(tc)
    assert torch.equal(img, r.render(tc))
    assert torch.equal(img, render(ts, tc, method="binary", light_samples=2,
                                   generator=_gen(5)))
    other = Renderer(ts, RenderConfig(method="binary", light_samples=2, light_seed=6))
    assert not torch.equal(img, other.render(tc))
    rays = gen_primary_rays(tc)
    assert torch.equal(r.render_rays(rays), render_rays(r.tracer, rays, light_samples=2,
                                                        generator=_gen(5)))
    assert torch.equal(r.render_rays(rays, generator=_gen(6)), other.render_rays(rays))


def test_cli_render_seed_feeds_the_area_light_sampler(monkeypatch, tmp_path):
    """render --light-samples S --seed K: the sampler gets S and a
    generator seeded K, and its light reaches the written image."""
    seen = []
    real = t_pipeline.sample_emitters

    def spy(generator, tris, num):
        seen.append((generator.initial_seed(), num))
        lp, ln_, _, pdf, any_e = real(generator, tris, num)
        # cornell has no emitter: give the drawn points light of their own
        lp = torch.tensor([[0.5, 0.99, 0.5]]).expand(num, 3)
        ln_ = torch.tensor([[0.0, -1.0, 0.0]]).expand(num, 3)
        return lp, ln_, torch.full((num, 3), 2.0), torch.ones(num), any_e

    monkeypatch.setattr(t_pipeline, "sample_emitters", spy)
    out = [str(tmp_path / f"{k}.npy") for k in ("lit", "plain")]
    argv = ["render", "--width", "8", "--method", "wide8"]
    assert main(argv + ["--light-samples", "2", "--seed", "3", "-o", out[0]], device="cpu") == 0
    assert seen == [(3, 2)]
    assert main(argv + ["-o", out[1]], device="cpu") == 0
    lit, plain = (np.load(p) for p in out)
    assert lit.shape == plain.shape == (8, 8, 3)
    assert (lit >= plain - 1e-6).all() and (lit - plain).max() > 1e-3


# -- the soft-occlusion oracles ---------------------------------------------
def _random_scene(n_tris=60, n_rays=150, seed=13):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-3, 3, (n_tris, 1, 3))
    v = (centers + rng.normal(size=(n_tris, 3, 3)) * 0.4).reshape(-1, 3).astype(np.float32)
    f = np.arange(n_tris * 3, dtype=np.int32).reshape(n_tris, 3)
    o = rng.uniform(-6, 6, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_max = rng.uniform(2.0, 6.0, n_rays).astype(np.float32)
    return v, f, o, d, t_max


def test_soft_occlusion_brute_and_ref_match_tpurt():
    """soft_occlusion_brute and soft_occlusion_ref (band 0.2, k_occ 16, a
    BVH built with the band) against tpurt's, and against each other as
    tpurt's oracle test holds its pair."""
    band = 0.2
    v, f, o, d, t_max = _random_scene()
    jt, jr = JTriangles.create(jnp.asarray(v), jnp.asarray(f)), JRays(o=jnp.asarray(o),
                                                                       d=jnp.asarray(d))
    tt = Triangles.create(v, f, device="cpu")
    tr = Rays(o=torch.from_numpy(o), d=torch.from_numpy(d))
    tm = torch.from_numpy(t_max)
    j_bf = jsv.soft_occlusion_brute(jr, jt, 40.0, band=band, t_max=jnp.asarray(t_max))
    j_ref = j_soft_occlusion_ref(jr, jt, j_build_lbvh(jt, leaf_size=4, band=band), 40.0,
                                 band=band, t_max=jnp.asarray(t_max))
    t_bf = tsv.soft_occlusion_brute(tr, tt, 40.0, band=band, t_max=tm)
    t_ref = soft_occlusion_ref(tr, tt, build_lbvh(tt, leaf_size=4, band=band), 40.0,
                               band=band, t_max=tm)
    assert float(t_bf.min()) < 0.5  # some segments are shadowed
    _close_scaled(t_bf.numpy(), j_bf)
    _close_scaled(t_ref.numpy(), j_ref)
    _close_scaled(t_ref.numpy(), t_bf.numpy())


def test_soft_occlusion_from_ids_and_its_grad_match_tpurt():
    """soft_occlusion_from_ids over a shared id list (some -1 padded), its
    value and d/d verts against tpurt's (whose gather is plain indexing, so
    F1 does not reach it); with a scalar t_max too."""
    v, f, o, d, t_max = _random_scene()
    rng = np.random.default_rng(22)
    jr, tr = JRays(o=jnp.asarray(o), d=jnp.asarray(d)), Rays(o=torch.from_numpy(o),
                                                            d=torch.from_numpy(d))
    # each segment's 6 nearest band occluders, one in 5 of them dropped
    ids = tsv.k_nearest_brute(tr, Triangles.create(v, f, device="cpu"), k=6, band=0.3,
                              t_max=2.0 * torch.from_numpy(t_max)).tri.numpy()
    ids = np.where(rng.uniform(size=ids.shape) < 0.2, -1, ids).astype(np.int32)
    w = rng.uniform(0.5, 1.5, o.shape[0]).astype(np.float32)
    for tm in (t_max, 4.0):
        def j_loss(verts):
            vis = jsv.soft_occlusion_from_ids(
                jr, JTriangles.create(verts, jnp.asarray(f)), jnp.asarray(ids), 30.0,
                band=0.3, t_max=jnp.asarray(tm))
            return jnp.sum(jnp.asarray(w) * vis), vis

        (_, j_vis), j_g = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(v))
        verts = torch.from_numpy(v).requires_grad_(True)
        tris = dataclasses.replace(Triangles.create(v, f, device="cpu"), verts=verts)
        t_vis = tsv.soft_occlusion_from_ids(tr, tris, torch.from_numpy(ids), 30.0, band=0.3,
                                            t_max=torch.as_tensor(tm))
        (t_g,) = torch.autograd.grad(torch.sum(torch.from_numpy(w) * t_vis), verts)
        assert float(t_vis.detach().min()) < 0.9
        _close_scaled(t_vis.detach().numpy(), j_vis)
        _close_scaled(t_g.numpy(), j_g)
