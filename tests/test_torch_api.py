"""The api layer against tpurt's: Renderer images, multi-sample rendering
with injected jitter, the config dataclasses and checkpoints, including a
fit resumed from a checkpoint."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.golden.test_golden import _check
from tpurt.api import config as jconfig
from tpurt.api.renderer import Renderer as JRenderer
from tpurt.core.scene import make_cornell_box as j_make_cornell_box
from tpurt.render.camera import gen_primary_rays as j_gen_primary_rays

from tpurt_torch.api import config as tconfig
from tpurt_torch.api.checkpoint import latest_step, restore_ckpt, save_ckpt
from tpurt_torch.api.config import FitConfig, RenderConfig
from tpurt_torch.api.inverse import InverseRenderer, make_optimizer
from tpurt_torch.api.renderer import Renderer
from tpurt_torch.core.math import sample_square
from tpurt_torch.core.scene import make_cornell_box
from tpurt_torch.kernels import treebuild
from tpurt_torch.render.camera import gen_primary_rays

RES = 32
RK = dict(soft=True, k_layers=4, sharpness=40.0, band=0.08, k_occ=8)


@pytest.fixture(scope="module")
def tpurt_cornell():
    """tpurt's Renderer("bvh") image of cornell at 32^2, and its scene and
    camera."""
    js, jc = j_make_cornell_box()
    jc = jc.replace(width=RES, height=RES)
    r = JRenderer(js, jconfig.RenderConfig(method="bvh"))
    return js, jc, r, np.asarray(r.render(jc))


def _cornell(res=RES):
    scene, cam = make_cornell_box(device="cpu")
    return scene, dataclasses.replace(cam, width=res, height=res)


# -- Renderer --------------------------------------------------------------
@pytest.mark.parametrize("method", ["bvh", "wide8", "packet", "wave"])
def test_renderer_matches_tpurt(tpurt_cornell, method):
    """The port's Renderer against tpurt's at its engine golden threshold
    (tests/golden/test_golden.py: 0.3% of pixels off by more than 2e-3)."""
    scene, cam = _cornell()
    treebuild.reset_launches()
    r = Renderer(scene, RenderConfig(method=method))
    img = r.render(cam)
    assert img.shape == (RES, RES, 3) and torch.isfinite(img).all()
    bad = (np.abs(img.numpy() - tpurt_cornell[3]).max(axis=-1) > 2e-3).mean()
    assert bad <= 0.003
    assert r.tracer.method == method and r.tracer.bvh is not None
    assert treebuild.LAUNCHES == {"morton": 0, "radix": 0}  # CPU: the twins


def test_renderer_goldens_and_update_scene():
    """Renderer("wide8") holds cornell's brute golden at 64^2; update_scene
    rebuilds the tree, or with rebuild_bvh=False keeps it and takes the new
    scene's shading."""
    scene, cam = _cornell(64)
    r = Renderer(scene, RenderConfig(method="wide8"))
    _check(r.render(cam).numpy(), "cornell_brute_64.npy", frac=0.003)
    dim = dataclasses.replace(scene, tris=dataclasses.replace(
        scene.tris, albedo=scene.tris.albedo * 0.5))
    old_wide = r.tracer.wide
    r.update_scene(dim, rebuild_bvh=False)
    assert r.tracer.wide is old_wide and r.scene is dim
    assert r.tracer.table[:, 9:12].equal(dim.tris.albedo)
    r.update_scene(dim)
    assert r.tracer.wide is not old_wide
    brute = Renderer(dim, RenderConfig(method="brute")).render(cam)
    bad = (np.abs(r.render(cam).numpy() - brute.numpy()).max(axis=-1) > 2e-3).mean()
    assert bad <= 0.003


def test_renderer_soft_config_and_overrides():
    scene, cam = _cornell(16)
    soft = Renderer(scene, RenderConfig(method="wide8", **RK))
    assert soft.tracer.bvh.band == RK["band"]
    img = soft.render(cam)
    hard = soft.render(cam, soft=False)
    assert img.shape == hard.shape == (16, 16, 3)
    assert not torch.equal(img, hard)
    rays = gen_primary_rays(cam)
    assert torch.equal(soft.render_rays(rays, soft=False).reshape(16, 16, 3), hard)


@pytest.mark.parametrize("kw,err,match", [
    (dict(mesh=object()), TypeError, "DeviceMesh"),
    (dict(partition="ring"), ValueError, "mesh"),
    (dict(partition="sideways"), ValueError, "sideways"),
])
def test_renderer_refuses_what_is_not_ported(kw, err, match):
    """dist/ is ported: a mesh must be a DeviceMesh, and the ring needs
    one; an unknown partition is refused."""
    scene, _ = _cornell()
    with pytest.raises(err, match=match):
        Renderer(scene, RenderConfig(method="brute"), **kw)


def test_renderer_area_lights_raise_at_render():
    """Area lights render through the Renderer (they raised before they
    were ported): light_samples > 0 draws from a generator seeded
    light_seed, the same image each time; cornell has no emitter, so the
    image is the point-lit one."""
    scene, cam = _cornell(4)
    r = Renderer(scene, RenderConfig(method="brute", light_samples=2, light_seed=3))
    img = r.render(cam)
    assert torch.equal(img, r.render(cam))
    assert torch.equal(img, Renderer(scene, RenderConfig(method="brute")).render(cam))


# -- spp -------------------------------------------------------------------
def test_jittered_samples_match_tpurt_and_spp_is_their_mean(tpurt_cornell):
    """Each sample, with the same numpy jitter fed to both packages'
    gen_primary_rays, matches tpurt's render_rays (per-ray "bvh" walks,
    golden threshold); the port's spp render is the mean of its samples,
    drawn from a generator in the same order."""
    js, jc, jr, _ = tpurt_cornell
    scene, cam = _cornell()
    r = Renderer(scene, RenderConfig(method="bvh"))
    rng = np.random.default_rng(12)
    for _ in range(2):
        jit = rng.uniform(0, 1, (RES * RES, 2)).astype(np.float32)
        ref = np.asarray(jr.render_rays(j_gen_primary_rays(jc, jnp.asarray(jit))))
        got = r.render_rays(gen_primary_rays(cam, torch.from_numpy(jit))).numpy()
        assert (np.abs(got - ref).max(axis=-1) > 2e-3).mean() <= 0.003
    g = torch.Generator().manual_seed(5)
    img = r.render(cam, spp=3, generator=g)
    g2 = torch.Generator().manual_seed(5)
    acc = torch.zeros((RES * RES, 3))
    for _ in range(3):
        acc = acc + r.render_rays(gen_primary_rays(cam, sample_square(g2, (RES * RES,))))
    assert torch.equal(img, (acc / 3).reshape(RES, RES, 3))
    assert not torch.equal(img, r.render(cam))
    # the config's spp, with the default generator (seed 0)
    r3 = Renderer(scene, RenderConfig(method="bvh", spp=3))
    assert torch.equal(r3.render(cam), r.render(cam, spp=3, generator=torch.Generator().manual_seed(0)))


def test_sample_square_shape_range_and_seed():
    a = sample_square(torch.Generator().manual_seed(1), (7, 5))
    b = sample_square(torch.Generator().manual_seed(1), (7, 5))
    assert a.shape == (7, 5, 2) and a.dtype == torch.float32 and torch.equal(a, b)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0


# -- config ----------------------------------------------------------------
# tpurt's fields the port leaves out until a ported path reads them
UNREAD = {"RenderConfig": set(), "FitConfig": {"seed"}}


@pytest.mark.parametrize("cls", ["RenderConfig", "FitConfig"])
def test_config_fields_and_defaults_match_tpurt_but_the_engine(cls):
    tf = {f.name: f.default for f in dataclasses.fields(getattr(tconfig, cls))}
    jf = {f.name: f.default for f in dataclasses.fields(getattr(jconfig, cls))}
    assert set(jf) - set(tf) == UNREAD[cls] and set(tf) <= set(jf)
    assert {k: v for k, v in tf.items() if k != "method"} == \
        {k: v for k, v in jf.items() if k != "method" and k in tf}
    if cls == "RenderConfig":
        assert tf["method"] == "wide8" and jf["method"] == "bvh"


@pytest.mark.parametrize("kw", [
    {}, {"soft": True}, {"soft": True, "band": 0.25, "leaf_size": 4, "method": "binary"},
    {"k_layers": 6, "sharpness": 25.0, "k_occ": 4, "light_samples": 2, "spp": 3},
])
def test_tracer_and_render_kwargs_match_tpurt(kw):
    t, j = tconfig.RenderConfig(**kw), jconfig.RenderConfig(**kw)
    assert t.render_kwargs() == j.render_kwargs()
    assert {k: v for k, v in t.tracer_kwargs().items() if k != "method"} == \
        {k: v for k, v in j.tracer_kwargs().items() if k != "method"}
    assert t.tracer_kwargs()["method"] == kw.get("method", "wide8")


# -- checkpoints -----------------------------------------------------------
def test_checkpoint_round_trip(tmp_path):
    d = str(tmp_path / "ck")
    assert latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        restore_ckpt(d)
    gen = torch.Generator().manual_seed(3)
    params = {"verts": torch.randn(5, 3, generator=gen).requires_grad_(True),
              "albedo": torch.rand(4, 3, generator=gen).requires_grad_(True)}
    opt = make_optimizer(FitConfig(), params)
    (params["verts"].sum() + (params["albedo"] ** 2).sum()).backward()
    opt.step()
    state = {"params": {k: v.detach() for k, v in params.items()}, "opt": opt.state_dict()}
    for step in (2, 10, 4):
        save_ckpt(d, state, step)
    assert sorted(os.listdir(d)) == ["ckpt_00000002.pt", "ckpt_00000004.pt", "ckpt_00000010.pt"]
    assert latest_step(d) == 10
    back, step = restore_ckpt(d)
    assert step == 10
    for k in params:
        assert torch.equal(back["params"][k], state["params"][k])
    opt2 = make_optimizer(FitConfig(), {k: v.detach().clone().requires_grad_(True)
                                        for k, v in params.items()})
    opt2.load_state_dict(back["opt"])
    for i in (0, 1):
        s1, s2 = opt.state_dict()["state"][i], opt2.state_dict()["state"][i]
        assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert restore_ckpt(d, step=2)[1] == 2


def test_fit_resumed_from_a_checkpoint_matches_an_uninterrupted_fit(tmp_path):
    """Adam on cornell 16^2 (wide8, soft): 2 steps, a checkpoint, then a new
    InverseRenderer resuming to step 4, against 4 steps in one go: the same
    parameters and step losses, bit for bit."""
    scene, cam = _cornell(16)
    rcfg = RenderConfig(method="wide8", **RK)
    with torch.no_grad():
        target = Renderer(scene, rcfg).render(cam) * 0.9
    moved = dataclasses.replace(scene, tris=dataclasses.replace(
        scene.tris, verts=scene.tris.verts * 1.02))

    def fit(steps, path):
        cfg = FitConfig(steps=steps, lr=1e-2, ckpt_path=path, ckpt_every=2)
        return InverseRenderer(moved, cam, fit=cfg, render=rcfg).fit(target)

    full = fit(4, str(tmp_path / "a"))
    assert sorted(os.listdir(tmp_path / "a")) == ["ckpt_00000002.pt", "ckpt_00000004.pt"]
    first = fit(2, str(tmp_path / "b"))
    rest = fit(4, str(tmp_path / "b"))
    assert first.steps_run == 2 and rest.steps_run == 2
    assert first.losses + rest.losses == full.losses
    for k in full.params:
        assert torch.equal(rest.params[k], full.params[k]), k
    assert latest_step(str(tmp_path / "b")) == 4
    assert fit(4, str(tmp_path / "b")).steps_run == 0  # nothing left to run
