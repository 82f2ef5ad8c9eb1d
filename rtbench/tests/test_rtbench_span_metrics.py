"""The readers of the port's spans on traces built by hand: known glue and
idle, with the walks' kernels credited to the enclosing ranges and not,
a gap put down to a span by its midpoint at the span's edges, and
nothing to read where the spans are absent."""

import os
from types import SimpleNamespace

import pytest

from rtbench import harness
from rtbench.frozen.window import Kernel, Trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FRAMES = ("render_glue_ms_per_frame", "render_idle_ms_per_frame", "area_glue_ms_per_frame")
FIT = ("soft_glue_ms_per_step", "forward_idle_ms_per_step", "backward_idle_ms_per_step",
       "step_edges_idle_ms_per_step")


def _read(name, ctx):
    return harness.load_metric(ROOT, name)(ctx)


def _frames_ctx(trace, frames=2):
    return SimpleNamespace(kind="frames", trace=trace, frames_traced=frames)


def _fit_ctx(trace, steps=2):
    return SimpleNamespace(kind="fit", trace=trace, steps_traced=steps)


def _area_frames(credited: bool) -> Trace:
    """Two frames (µs, one clock): each a render_rays range over a closest
    walk (kernel 300), a point-light occluded walk (kernel 100) and an
    area range (sampling glue 50, its occluded walk 200, contribution glue
    30), with 400 of glue outside the area range.  Credited: each walk
    range holds its kernel's time and each enclosing range its children's;
    otherwise no range holds a walk's kernel."""
    kernels, ranges = [], []
    for f in range(2):
        t = 10_000.0 * f
        kernels += [Kernel("elementwise_kernel", t + 100, t + 300),       # glue 200
                    Kernel("closest8_kernel", t + 320, t + 620),
                    Kernel("reduce_kernel", t + 650, t + 850),             # glue 200
                    Kernel("occluded8_kernel", t + 900, t + 1000),
                    Kernel("searchsorted_kernel", t + 1100, t + 1150),     # area glue 50
                    Kernel("occluded8_kernel", t + 1200, t + 1400),
                    Kernel("elementwise_kernel", t + 1420, t + 1450)]      # area glue 30
        walk = (lambda us: us) if credited else (lambda us: 0.0)
        ranges += [("tpurt::render_rays", t + 50, t + 1500, 480 + walk(600)),
                   ("tpurt::walk.closest", t + 60, t + 200, walk(300)),
                   ("tpurt::walk.occluded", t + 400, t + 500, walk(100)),
                   ("tpurt::area", t + 600, t + 1460, 80 + walk(200)),
                   ("tpurt::area.sample", t + 610, t + 700, 50.0),
                   ("tpurt::walk.occluded", t + 800, t + 900, walk(200)),
                   ("rtbench.frame", t, t + 2000, 480 + walk(600)),
                   ("aten::empty", t + 5, t + 8, 0.0)]
    return Trace(kernels=kernels, ranges=ranges)


@pytest.mark.parametrize("credited", [True, False])
def test_glue_less_the_walks_whether_or_not_the_walks_are_credited(credited):
    ctx = _frames_ctx(_area_frames(credited))
    assert _read("render_glue_ms_per_frame", ctx) == pytest.approx(0.480)
    assert _read("area_glue_ms_per_frame", ctx) == pytest.approx(0.080)


def test_render_idle_counts_the_gaps_whose_midpoint_lies_in_render_rays():
    """Frame gaps: 20, 30, 50, 100, 50, 20 µs, all with their midpoints
    inside render_rays (50 to 1500); the gap between the frames (1450 to
    10100, midpoint 5775) lies outside every span."""
    ctx = _frames_ctx(_area_frames(True))
    assert _read("render_idle_ms_per_frame", ctx) == pytest.approx(0.270)


def test_a_gap_is_put_down_by_its_midpoint_edges_included():
    """render_rays from 100 to 200: a gap from 60 to 140 (midpoint 100, the
    span's start) and one from 190 to 210 (midpoint 200, its end) count; a
    gap from 196 to 216 (midpoint 206) starts inside and does not."""
    ranges = [("tpurt::render_rays", 100.0, 200.0, 0.0)]
    trace = Trace(kernels=[Kernel("k", 0, 60), Kernel("k", 140, 190), Kernel("k", 210, 220)],
                  ranges=ranges)
    assert trace.gaps() == [(60, 140), (190, 210)]
    assert _read("render_idle_ms_per_frame", _frames_ctx(trace, 1)) == pytest.approx(0.100)
    late = Trace(kernels=[Kernel("k", 0, 196), Kernel("k", 216, 300)], ranges=ranges)
    assert _read("render_idle_ms_per_frame", _frames_ctx(late, 1)) == 0.0


def _fit_steps(credited: bool) -> Trace:
    """Two fit steps 100,000 µs apart, each: the table (0 to 1,000) and
    the refit (to 2,000), two chunks of forward (10,000: glue kernels of
    1,000 and 2,000, a knear walk of 1,000) and backward (10,000), the
    update (42,000 to 44,000) and the readback (to 45,000), then the
    fit's callback.  The gaps of a step: 4 x 100 in table and refit;
    500 + 500 + 5,000 in each forward; 2,000 and then 100 (chunk 0) or 200
    (chunk 1: midpoint 42,000, the end of the backward and the start of the
    update, and the chunk's) in each backward; 500 in the update; the
    55,200 up to the next step outside every span."""
    kernels, ranges = [], []
    walk = (lambda us: us) if credited else (lambda us: 0.0)
    for step in range(2):
        t = 100_000.0 * step
        kernels += [Kernel("gather", t + 0, t + 400), Kernel("elementwise", t + 500, t + 900),
                    Kernel("refit", t + 1_000, t + 1_300), Kernel("refit", t + 1_400, t + 1_900)]
        ranges += [("tpurt::fit.table", t + 0, t + 1_000, 800.0),
                   ("tpurt::refit", t + 1_000, t + 2_000, 800.0)]
        for c0 in (t + 2_000, t + 22_000):
            kernels += [Kernel("elementwise", c0, c0 + 1_000),
                        Kernel("knear8_kernel", c0 + 1_500, c0 + 2_500),
                        Kernel("elementwise", c0 + 3_000, c0 + 5_000),
                        Kernel("segsum", c0 + 10_000, c0 + 15_000),
                        Kernel("cat", c0 + 17_000, c0 + 19_900)]
            ranges += [("tpurt::fit.forward", c0, c0 + 10_000, 3_000 + walk(1_000)),
                       ("tpurt::render_rays", c0 + 50, c0 + 9_000, 3_000 + walk(1_000)),
                       ("tpurt::walk.knear", c0 + 100, c0 + 200, walk(1_000)),
                       ("tpurt::fit.backward", c0 + 10_000, c0 + 20_000, 0.0)]
        kernels += [Kernel("adam", t + 42_100, t + 43_000), Kernel("norm", t + 43_500, t + 44_800)]
        ranges += [("tpurt::fit.update", t + 42_000, t + 44_000, 900.0),
                   ("tpurt::fit.readback", t + 44_000, t + 45_000, 1_300.0),
                   ("rtbench.callback", t + 45_000, t + 45_700, 0.0)]
    return Trace(kernels=kernels, ranges=ranges)


@pytest.mark.parametrize("credited", [True, False])
def test_fit_readers_on_two_known_steps(credited):
    trace = _fit_steps(credited)
    ctx = _fit_ctx(trace)
    assert _read("soft_glue_ms_per_step", ctx) == pytest.approx(6.0)
    assert _read("forward_idle_ms_per_step", ctx) == pytest.approx(12.0)
    assert _read("backward_idle_ms_per_step", ctx) == pytest.approx(4.3)
    assert _read("step_edges_idle_ms_per_step", ctx) == pytest.approx(0.9)
    busy, window = trace.busy_window_us()
    assert (window - busy) / 1e3 / 2 == pytest.approx(12.0 + 4.3 + 0.9 + 55.2 / 2)


def test_step_edges_leave_out_gaps_inside_a_chunk():
    """A rebuild check whose interval happens to hold a forward range: the
    gap inside both is the forward's, not an edge's."""
    trace = Trace(kernels=[Kernel("k", 0, 10), Kernel("k", 20, 30), Kernel("k", 40, 50)],
                  ranges=[("tpurt::fit.rebuild_check", 0.0, 50.0, 0.0),
                          ("tpurt::fit.forward", 10.0, 20.0, 0.0)])
    ctx = _fit_ctx(trace, 1)
    assert _read("forward_idle_ms_per_step", ctx) == pytest.approx(0.010)
    assert _read("step_edges_idle_ms_per_step", ctx) == pytest.approx(0.010)


@pytest.mark.parametrize("name", FRAMES + FIT)
def test_nothing_to_read_without_the_spans(name):
    """A trace of a program older than the spans (its only spans the
    build's and tpurt::refit), the other kind of cell, and no trace: None."""
    bare = Trace(kernels=[Kernel("closest8_kernel", 0, 10), Kernel("elementwise", 20, 30),
                          Kernel("refit", 40, 50), Kernel("refit", 60, 70)],
                 ranges=[("rtbench.render_rays", 0.0, 40.0, 20.0),
                         ("autograd::engine::evaluate_function: MulBackward0", 0.0, 5.0, 1.0),
                         ("tpurt::refit", 35.0, 75.0, 20.0),
                         ("lbvh.radix", 0.0, 1.0, 0.0)])
    ok, other = (_frames_ctx, _fit_ctx) if name in FRAMES else (_fit_ctx, _frames_ctx)
    assert _read(name, ok(bare)) is None
    assert _read(name, ok(None)) is None
    full = _area_frames(True) if name in FRAMES else _fit_steps(True)
    assert _read(name, other(full)) is None
    assert _read(name, ok(full)) is not None
