"""The sorted segment-sum (kernels/segsum.py) and the gather backward's
switch (diff/gather_grad.py) against tpurt's diff/gather_grad.py.

segment_accumulate_ref repeats tpurt's segment_accumulate in tpurt's order
of additions, so the two are held equal as floats (np.array_equal: +0 and
-0 compare equal), tpurt's run op by op (jax.disable_jit: jitted, XLA may
contract a multiply and an add into an FMA).  tpurt's sort is lax.sort,
stable on the CPU; the twin sorts with torch.sort(stable=True).  The
gather backward under 'scatter' sums in index_add_'s order and is held to
tpurt at rtol 1e-5, as tests/test_torch_diff.py holds it.  The CUDA
kernels run on the card only (chip_smoke.py [segsum] holds them to the
twin there); here their wrapper's route is checked by reading its source.
"""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.diff import gather_grad as j_gather_grad

from tests.launch_scan import launches_outside_on_device
from tpurt_torch.api.config import FitConfig, RenderConfig
from tpurt_torch.api.inverse import InverseRenderer
from tpurt_torch.core.scene import make_cornell_box
from tpurt_torch.diff import gather_grad
from tpurt_torch.diff.gather_grad import (
    gather_verts, get_grad_backend, segment_accumulate, set_grad_backend)
from tpurt_torch.kernels import segsum
from tpurt_torch.kernels.segsum import BLOCK, carry_passes, segment_accumulate_ref
from tpurt_torch.render.pipeline import render

V = 257  # tpurt's table rows in tests/grad/test_gather_grad.py
# tpurt's id patterns (tests/grad/test_gather_grad.py)
PATTERNS = {
    "uniform": lambda rng, n, v: rng.integers(0, v, n),
    "all_dup": lambda rng, n, v: np.full(n, 3),
    "two_hot": lambda rng, n, v: rng.choice([0, v - 1], n),
    "sorted": lambda rng, n, v: np.sort(rng.integers(0, v, n)),
    "clustered": lambda rng, n, v: rng.integers(0, 5, n) * (v // 7),
}


@pytest.fixture(autouse=True)
def _restore_backend():
    yield
    set_grad_backend("segsum")


def _tpurt(idx: np.ndarray, cot: np.ndarray, v: int) -> np.ndarray:
    with jax.disable_jit():
        return np.asarray(j_gather_grad.segment_accumulate(
            jnp.asarray(idx, jnp.int32), jnp.asarray(cot), v))


def _twin(idx: np.ndarray, cot: np.ndarray, v: int) -> np.ndarray:
    return segment_accumulate_ref(torch.from_numpy(idx), torch.from_numpy(cot), v).numpy()


@pytest.mark.parametrize("n", [4096, 4096 + 37])
@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_twin_equals_tpurt(pattern, n):
    rng = np.random.default_rng(7)
    idx = PATTERNS[pattern](rng, n, V).astype(np.int32)
    cot = rng.normal(size=(n, 3)).astype(np.float32)
    assert np.array_equal(_twin(idx, cot, V), _tpurt(idx, cot, V))


@pytest.mark.parametrize("use", [3, 9, 12])
def test_twin_equals_tpurt_on_the_first_columns_of_wide_rows(use):
    """The backward's input: the first `use` columns of 15-wide rows (a
    strided view), clustered ids."""
    rng = np.random.default_rng(use)
    n = 4096 + 37
    idx = PATTERNS["clustered"](rng, n, V).astype(np.int32)
    rows = rng.normal(size=(n, 15)).astype(np.float32)
    got = segment_accumulate_ref(torch.from_numpy(idx), torch.from_numpy(rows)[:, :use], V)
    assert np.array_equal(got.numpy(), _tpurt(idx, rows[:, :use], V))


def test_twin_equals_tpurt_on_a_segment_over_many_blocks():
    """One id holds 3,000 consecutive sorted rows (12 blocks of 256), among
    uniform ids on both sides; rows 200-256 of the table are never
    gathered and come out 0."""
    rng = np.random.default_rng(3)
    n = 4096 + 37
    idx = rng.integers(0, 200, n).astype(np.int32)
    idx[rng.permutation(n)[:3000]] = 100
    cot = rng.normal(size=(n, 9)).astype(np.float32)
    got = _twin(idx, cot, V)
    sid = np.sort(idx)
    first, last = np.searchsorted(sid, 100), np.searchsorted(sid, 100, side="right") - 1
    assert last // BLOCK - first // BLOCK > 8
    assert np.array_equal(got, _tpurt(idx, cot, V))
    assert not got[200:].any()


def test_twin_takes_no_rows_and_int64_ids():
    z = segment_accumulate_ref(torch.zeros(0, dtype=torch.int64), torch.zeros(0, 3), 5)
    assert z.shape == (5, 3) and not z.any()
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 40, 600)
    cot = torch.from_numpy(rng.normal(size=(600, 3)).astype(np.float32))
    assert torch.equal(segment_accumulate_ref(torch.from_numpy(idx), cot, 40),
                       segment_accumulate_ref(torch.from_numpy(idx.astype(np.int32)), cot, 40))


@pytest.mark.parametrize("nb,passes", [(0, 0), (1, 0), (2, 1), (3, 2), (4, 2), (5, 3),
                                       (4080, 12), (32640, 15)])
def test_carry_passes_are_the_shifts_below_nb(nb, passes):
    assert carry_passes(nb) == passes == sum(1 for s in range(20) if (1 << s) < nb)


# -- the gather backward's switch -------------------------------------------
def test_switch_rejects_unknown_backends_and_defaults_to_segsum():
    assert get_grad_backend() == "segsum"
    with pytest.raises(ValueError):
        set_grad_backend("atomic")
    set_grad_backend("scatter")
    assert get_grad_backend() == "scatter"
    assert gather_grad.segment_accumulate is segsum.segment_accumulate
    assert segment_accumulate is segsum.segment_accumulate


@pytest.mark.parametrize("backend", ["segsum", "scatter"])
@pytest.mark.parametrize("grad_cols", [None, 12])
def test_gather_backward_matches_tpurt(backend, grad_cols):
    """gather_verts' backward, 4,133 clustered ids into a (257, C) table, C
    12 (all summed) or 15 (grad_cols 12): within rtol 1e-5 of tpurt's
    segment_accumulate; under 'segsum' equal to the twin as floats; trimmed
    columns and rows never gathered are 0.  (The row counts are the twin
    tests', so tpurt's ops run at shapes it has already compiled.)"""
    set_grad_backend(backend)
    rng = np.random.default_rng(11)
    c = 12 if grad_cols is None else 15
    idx = rng.integers(0, V - 20, size=4096 + 37).astype(np.int32)
    cot = rng.normal(size=idx.shape + (c,)).astype(np.float32)
    table = torch.from_numpy(rng.normal(size=(V, c)).astype(np.float32)).requires_grad_()
    (g,) = torch.autograd.grad(gather_verts(table, torch.from_numpy(idx), grad_cols), table,
                               torch.from_numpy(cot))
    use = c if grad_cols is None else grad_cols
    flat_cot = cot[:, :use]
    np.testing.assert_allclose(g.numpy()[:, :use], _tpurt(idx, flat_cot, V),
                               rtol=1e-5, atol=1e-6)
    if backend == "segsum":
        assert np.array_equal(g.numpy()[:, :use], _twin(idx, flat_cot, V))
    assert not g[:, use:].any() and not g[V - 20:].any()


def test_segsum_fit_repeats_bit_for_bit():
    """Two 2-step Adam fits of cornell 8x8 (wide8, soft, 2 chunks) under
    'segsum': every parameter element equal."""
    scene, cam = make_cornell_box(device="cpu")
    cam = dataclasses.replace(cam, width=8, height=8)
    rk = dict(soft=True, k_layers=4, sharpness=40.0, band=0.08, k_occ=8)
    with torch.no_grad():
        dim = dataclasses.replace(scene, tris=dataclasses.replace(
            scene.tris, albedo=scene.tris.albedo * 0.8))
        target = render(dim, cam, method="wide8", **rk)

    def fit():
        return InverseRenderer(scene, cam, fit=FitConfig(steps=2, lr=1e-2, grad_chunks=2),
                               render=RenderConfig(method="wide8", **rk)).fit(target)

    a, b = fit(), fit()
    assert a.losses == b.losses
    for k in ("verts", "albedo"):
        assert torch.equal(a.params[k], b.params[k]), k
        assert not torch.equal(a.params[k], getattr(scene.tris, k)), k


# -- the CUDA route: launches only, no fallback ------------------------------
SEGSUM_PY = pathlib.Path(segsum.__file__)


def test_every_launch_is_on_its_tensors_card_and_nothing_falls_back():
    """The wrapper's three entry points are each called inside
    _build.on_device (the scan of tests/launch_scan.py, which
    tests/test_torch_closest_design.py also runs), and
    the module has no try: a failed build or launch raises."""
    tree = ast.parse(SEGSUM_PY.read_text())
    launches = {n.attr for n in ast.walk(tree)
                if isinstance(n, ast.Attribute) and n.attr.startswith("tpurt_")
                and n.attr != "tpurt_error_string"}
    assert launches == {"tpurt_segsum_scan", "tpurt_segsum_carry", "tpurt_segsum_ends"}
    assert launches_outside_on_device(SEGSUM_PY) == []
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def test_a_tensor_off_the_cpu_never_reaches_the_twin(monkeypatch):
    monkeypatch.setattr(segsum, "segment_accumulate_ref",
                        lambda *a: pytest.fail("the twin ran for a non-CPU tensor"))
    idx = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        segment_accumulate(idx, torch.zeros(4, 3, device="meta"), 2)
    assert segsum.LAUNCHES["segsum"] == 0
