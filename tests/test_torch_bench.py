"""tpurt_torch.bench (the port's benchmark) against tpurt's bench.py.

The fwd_bwd step is held to tpurt's table-space step on a small sponza
(its inputs handed over as numpy), with the frame padded to whole chunks;
the rest is the benchmark's contract on the CPU: the headline row's keys,
the rows that fail, the flags that are not ported and the CLI's verb.

tpurt's gather_verts cannot be differentiated (ROADMAP fault F1), so
tpurt's step runs with it bound to a plain gather.  tpurt's reference
engine is "brute", whose band hits depend on no tree; the port's step runs
"wide8", as the benchmark does, with its refit in the step.  tpurt's step
is evaluated op by op (jax.disable_jit): jitted, XLA's CPU backend
contracts FMAs (ROADMAP P2) and a few near-tie layers of this scene's
clutter change order (gradients then differ by up to 1.1e-4 of the
largest).  Tolerances, as tests/test_torch_fit.py's: losses rtol 1e-4,
gradients atol 1e-5 of the largest (measured 1.7e-7).  tpurt's own step
(bench.py run_one, captured) and this file's copy of it, both jitted,
agree to 1e-6 of the largest gradient: the copy takes a chunk that
bench.py cannot set, so the frame can be padded.

The rows' tests time nothing they assert: bench.main runs with one call a
row (--iters 1 --warmup 0, MIN_SECONDS 0), the parity test with its rows
stubbed, and every test with one intra-op thread (the benchmark's small
tensor ops run many times slower when other test processes' threads
compete for the cores).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as j_bench
import tpurt.diff.gather_grad as j_gather_grad
import tpurt.render.pipeline as j_pipeline
from tpurt.core.geometry import Rays as JRays
from tpurt.core.scene import get_scene as j_get_scene
from tpurt.render.camera import gen_primary_rays as j_gen_primary_rays
from tpurt.render.camera import pixel_morton_perm as j_pixel_morton_perm

from tpurt_torch import bench
from tpurt_torch.cli.main import main as cli_main
from tpurt_torch.core.convert import camera_from_numpy, scene_from_numpy
from tpurt_torch.core.scene import get_scene
from tpurt_torch.kernels import packet as kp
from tpurt_torch.kernels import traverse as kb
from tpurt_torch.kernels import traverse8 as k8
from tpurt_torch.render.pipeline import make_tracer

RES, TRIS = 32, 2000
SMALL = ["--device", "cpu", "--scene", "sponza", "--tris", str(TRIS), "--width", str(RES),
         "--height", str(RES), "--skip-5m"]
# tpurt's bench.py headline keys that apply to the port (B3), and those it leaves out
HEADLINE = {"metric", "value", "unit", "method", "engine_ran", "scene", "tris", "bench_rays",
            "build_s", "compile_s", "value_fwd_bwd", "method_fwd_bwd", "engine_ran_fwd_bwd",
            "ms_per_call_fwd_bwd", "bench_rays_fwd_bwd", "grad_params", "device"}
NOT_PORTED = {"vs_baseline", "vs_baseline_fwd_bwd", "timing_suspect", "fwd_bwd_error"}
# one call a row: the first (compile_s) and one timed batch of one
ONE_CALL = ["--iters", "1", "--warmup", "0"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_call(monkeypatch):
    """time_calls stops after its first batch."""
    monkeypatch.setattr(bench, "MIN_SECONDS", 0.0)


def _plain(verts, idx, grad_cols=None):
    return verts[idx]


@pytest.fixture(scope="module")
def small():
    """tpurt's small sponza, its Morton-ordered primary rays as bench.py
    orders them, and the same scene, camera and rays for the port."""
    js, jc = j_get_scene("sponza", num_tris=TRIS, width=RES, height=RES)
    rays = j_gen_primary_rays(jc)
    perm, _ = j_pixel_morton_perm(jc.height, jc.width)
    o, d = (np.asarray(x.reshape(-1, 3)[perm]) for x in (rays.o, rays.d))
    a = np.asarray
    ts = scene_from_numpy(
        verts=a(js.tris.verts), faces=a(js.tris.faces), albedo=a(js.tris.albedo),
        emission=a(js.tris.emission), light_pos=a(js.lights.pos),
        light_intensity=a(js.lights.intensity), background=a(js.background),
        ambient=a(js.ambient), device="cpu")
    tc = camera_from_numpy(eye=a(jc.eye), target=a(jc.target), up=a(jc.up),
                           fov_y_deg=a(jc.fov_y_deg), width=jc.width, height=jc.height,
                           device="cpu")
    return dict(js=js, jc=jc, o=o, d=d, ts=ts, tc=tc)


def _tpurt_step(tracer, o, d, chunk):
    """bench.py run_one's fwd_bwd step (bench.py:257-347) for a tracer
    without a tree, at a given chunk, returning its loss beside the
    gradients (bench.py drops it)."""
    n_pad = (-o.shape[0]) % chunk
    o_c, d_c = (jnp.pad(x, ((0, n_pad), (0, 0))).reshape(-1, chunk, 3) for x in (o, d))
    rkw = dict(soft=True, k_layers=4, sharpness=40.0, band=0.08, k_occ=8)

    def table_of(tr, verts, albedo):
        return j_pipeline.tri_table(tr.scene.tris.replace(verts=verts, albedo=albedo))

    @jax.jit
    def chunk_vjp(tr, table, oc, dc):
        def closs(tb):
            colors = j_pipeline.render_rays(tr.replace(table=tb), JRays(o=oc, d=dc), **rkw)
            return jnp.sum(colors * colors)

        loss_c, vjp = jax.vjp(closs, table)
        return loss_c, vjp(jnp.float32(1.0))[0]

    verts, albedo = tracer.scene.tris.verts, tracer.scene.tris.albedo
    table = jax.jit(table_of)(tracer, verts, albedo)
    tr2 = tracer.replace(scene=tracer.scene.replace(tris=tracer.scene.tris.replace(
        verts=verts, albedo=albedo)))
    loss, tcot = 0.0, None
    for i in range(o_c.shape[0]):
        loss_c, tc = chunk_vjp(tr2, table, o_c[i], d_c[i])
        loss, tcot = loss + float(loss_c), tc if tcot is None else tcot + tc
    _, vjp = jax.vjp(lambda v, a: table_of(tracer, v, a), verts, albedo)
    gv, ga = vjp(tcot)
    return loss, np.asarray(gv), np.asarray(ga)


@pytest.fixture
def plain_gather(monkeypatch):
    monkeypatch.setattr(j_gather_grad, "gather_verts", _plain)
    monkeypatch.setattr(j_pipeline, "gather_verts", _plain)


def test_the_copy_is_tpurts_bench_step(small, plain_gather, monkeypatch):
    """_tpurt_step at bench.py's own chunk (the whole frame) gives what
    bench.py's run_one step gives, captured from its timer."""
    got = {}

    def capture(fn, args, *a, **kw):
        got["grads"] = fn(*args)
        return 1.0, 1.0, 0.0

    monkeypatch.setattr(j_bench, "_bench_chunk", capture)
    j_bench.run_one(small["js"], small["jc"], "brute", "fwd_bwd", RES * RES, 1, 0)
    tracer = j_pipeline.make_tracer(small["js"], method="brute", band=0.08)
    _, gv, ga = _tpurt_step(tracer, jnp.asarray(small["o"]), jnp.asarray(small["d"]), RES * RES)
    for ref, mine in ((got["grads"]["verts"], gv), (got["grads"]["albedo"], ga)):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.fixture(scope="module")
def tpurt_step(small):
    """tpurt's step over the whole frame in one chunk (no padding), op by
    op, F1 bypassed: (loss, d/dverts, d/dalbedo)."""
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(j_gather_grad, "gather_verts", _plain)
        mp.setattr(j_pipeline, "gather_verts", _plain)
        tracer = j_pipeline.make_tracer(small["js"], method="brute", band=0.08)
        return _tpurt_step(tracer, jnp.asarray(small["o"]), jnp.asarray(small["d"]), RES * RES)


def _port_step(small, chunk):
    port = make_tracer(small["ts"], "wide8", band=0.08)
    rays = torch.from_numpy(small["o"].copy()), torch.from_numpy(small["d"].copy())
    loss, grads = bench.fwd_bwd_step(port, *rays, chunk)()
    return float(loss), grads["verts"].numpy(), grads["albedo"].numpy()


def _assert_grads_match(got: tuple, ref: tuple) -> None:
    for g, r in zip(got, ref):
        assert np.isfinite(g).all() and np.abs(r).max() > 0
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * np.abs(r).max())


def test_fwd_bwd_step_matches_tpurt(small, tpurt_step):
    """The port's step (wide8, refit in the step) against tpurt's (brute):
    the summed loss and d/d(verts, albedo) of the whole frame."""
    loss, gv, ga = _port_step(small, RES * RES)
    assert loss == pytest.approx(tpurt_step[0], rel=1e-4)
    _assert_grads_match((gv, ga), tpurt_step[1:])


def test_padded_rays_add_the_background_only(small, tpurt_step, plain_gather):
    """Chunks of 384 pad the 1,024 rays to 1,152: the port's 128 zero rays
    add the background's square to the loss and nothing to the gradients.
    tpurt's turn NaN (ROADMAP P7, pinned): its soft render's rsqrt(max(|d|^2,
    1e-40)) meets a 1e-40 that XLA flushes to 0, so a zero ray's cos_dn is
    0 * inf, and the gradient of triangle 0 (whose row the ray's empty
    layers gather) is NaN."""
    loss, gv, ga = _port_step(small, 384)
    bg = float(np.sum(np.asarray(small["js"].background) ** 2))
    assert loss == pytest.approx(tpurt_step[0] + 128 * bg, rel=1e-4)
    _assert_grads_match((gv, ga), tpurt_step[1:])
    tracer = j_pipeline.make_tracer(small["js"], method="brute", band=0.08)
    j_loss, j_gv, j_ga = _tpurt_step(tracer, jnp.asarray(small["o"]), jnp.asarray(small["d"]), 384)
    corners = np.asarray(small["js"].tris.faces)[0]
    assert np.isnan(j_loss) and not np.isnan(j_ga).any()
    assert sorted({int(i) for i in np.argwhere(np.isnan(j_gv))[:, 0]}) == sorted(corners)


def test_frame_rays_are_tpurts_morton_order(small):
    o, d = bench.frame_rays(small["tc"])
    np.testing.assert_allclose(o.numpy(), small["o"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), small["d"], rtol=0, atol=1e-6)


def _last_row(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_headline_row_on_the_cpu(one_call, capsys):
    assert bench.main(SMALL + ONE_CALL) == 0
    row = _last_row(capsys.readouterr().out)
    assert HEADLINE <= set(row) and not NOT_PORTED & set(row) and "error" not in row
    assert row["engine_ran"] == row["engine_ran_fwd_bwd"] == row["method"] == "wide8"
    assert row["value"] > 0 and row["value_fwd_bwd"] > 0 and row["device"] == "cpu"
    assert row["bench_rays"] == row["bench_rays_fwd_bwd"] == RES * RES
    assert np.isfinite(row["loss_fwd_bwd"]) and row["loss_fwd_bwd"] > 0
    assert not any(k.endswith("_5m") for k in row)  # the 5M rows run on the card only


@pytest.mark.parametrize("method", ["packet", "wave"])
def test_headline_row_through_tpurts_own_engines(method, one_call, capsys):
    """--method packet and wave (tpurt's packet and wavefront engines) run
    both rows through the engine they name."""
    assert bench.main(SMALL + ONE_CALL + ["--method", method]) == 0
    row = _last_row(capsys.readouterr().out)
    assert "error" not in row and row["value"] > 0 and row["value_fwd_bwd"] > 0
    assert row["engine_ran"] == row["engine_ran_fwd_bwd"] == row["method"] == method
    assert np.isfinite(row["loss_fwd_bwd"]) and row["loss_fwd_bwd"] > 0


@pytest.mark.parametrize("argv,error", [
    (["--scene", "nosuch.obj"], "ValueError: unknown scene"),
    (["--method", "ring"], "needs a DeviceMesh"),
])
def test_a_failing_row_prints_error_and_returns_1(argv, error, capsys):
    assert bench.main(SMALL + argv) == 1
    row = _last_row(capsys.readouterr().out)
    assert error in row["error"] and row["value"] == 0.0


def test_a_row_whose_colors_are_not_finite_fails(monkeypatch, capsys):
    monkeypatch.setattr(bench, "render_rays",
                        lambda tracer, rays, **kw: torch.full_like(rays.o, float("nan")))
    assert bench.main(SMALL + ONE_CALL) == 1
    assert "FloatingPointError: fwd" in _last_row(capsys.readouterr().out)["error"]


def test_a_kernel_that_differs_from_its_twin_fails_parity(monkeypatch, capsys):
    """--parity on the CPU (each wrapper runs its twin, so nothing differs)
    reports every kernel; an any-hit wrapper that flips a flag fails it.
    The fwd and fwd_bwd rows, which this does not read, are stubbed."""
    monkeypatch.setattr(bench, "PARITY_BUNNY", dict(num_tris=2000))
    monkeypatch.setattr(bench, "PARITY_RAYS", 256)
    monkeypatch.setattr(bench, "run_one", lambda scene, cam, method, mode, *a, **kw: dict(
        rays_per_s=1.0, engine_ran=method, bench_rays=1, build_s=0.0, compile_s=0.0,
        ms_per_call=1.0, loss=1.0, peak_bytes=0))
    assert bench.main(SMALL + ["--parity"]) == 0
    row = _last_row(capsys.readouterr().out)
    kernels = set(k8.LAUNCHES) | set(kb.LAUNCHES) | set(kp.LAUNCHES)
    assert {k: row["parity"][k] for k in kernels} == dict.fromkeys(kernels, 0)
    assert all(row["parity"][f"rays_{e}"] == 256 for e in ("wide8", "binary", "packet"))

    flip = k8.occluded_wide8
    monkeypatch.setattr(k8, "occluded_wide8", lambda *a, **kw: ~flip(*a, **kw))
    assert bench.main(SMALL + ["--parity"]) == 1
    assert "occluded8" in _last_row(capsys.readouterr().out)["error"]


def test_staged_rows(monkeypatch, capsys):
    monkeypatch.setattr(bench, "STAGED", (("3-sponza", "sponza",
                                           dict(num_tris=TRIS, width=16, height=16)),))
    monkeypatch.setattr(bench, "FIT_RES", 8)
    assert bench.main(SMALL + ["--staged"]) == 0
    err = capsys.readouterr().err
    rows = [json.loads(ln) for ln in err.splitlines() if ln.startswith("{")]
    assert [(r["staged_config"], r.get("mode")) for r in rows] == [
        ("3-sponza", "fwd"), ("3-sponza", "fwd_bwd"), ("4-fit", None)]
    assert all(r["rays_per_s"] > 0 for r in rows[:2]) and rows[2]["steps_per_s"] > 0
    # the fwd / fwd_bwd rows run --method (auto resolves to wide8); the fit is pinned
    # to "bvh", as tpurt's _run_fit_staged pins it
    assert [(r["method"], r["engine_ran"]) for r in rows] == [
        ("wide8", "wide8"), ("wide8", "wide8"), ("bvh", "bvh")]


def test_5m_rows_on_a_small_scene(monkeypatch, capsys):
    """run_5m (the card's 5M rows) on a small sponza in its place: fwd,
    fwd_bwd and the ring at one partition on a world-1 gloo group, which
    it makes and destroys; each its own row before the headline's keys."""
    import torch.distributed as dist

    monkeypatch.setattr(bench, "get_scene", lambda name, device: get_scene(
        "sponza", device=device, num_tris=TRIS, width=16, height=16))
    args = bench.build_parser().parse_args(SMALL)
    args.method = "wide8"
    row = {}
    bench.run_5m(args, row, torch.device("cpu"))
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["metric"] for r in rows] == [f"primary_rays_per_s_per_chip_{m}"
                                           for m in ("fwd", "fwd_bwd", "fwd")]
    assert rows[2]["engine_ran"] == "ring+wide8" and not dist.is_initialized()
    for k in ("value_5m", "value_5m_fwd_bwd", "value_5m_ring"):
        assert row[k] > 0, k
    assert row["engine_ran_5m"] == "wide8" and row["peak_bytes_5m_fwd_bwd"] == 0


def test_cli_bench_verb_runs_main(monkeypatch):
    """The verb passes its own flags that were given, --method unless
    "auto" (as tpurt's cmd_bench forwards it), then the benchmark's."""
    calls = []
    monkeypatch.setattr(bench, "main", lambda argv: calls.append(argv) or 0)
    assert cli_main(["bench", "--tris", "2000", "--skip-5m", "--parity"], device="cpu") == 0
    assert cli_main(["bench", "--method", "binary", "--width", "64"], device="cpu") == 0
    assert calls == [
        ["--device", "cpu", "--scene", "sponza", "--tris", "2000", "--skip-5m", "--parity"],
        ["--device", "cpu", "--scene", "sponza", "--width", "64", "--method", "binary"]]
    with pytest.raises(SystemExit):  # the benchmark's flags belong to bench only
        cli_main(["render", "--skip-5m"], device="cpu")

