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
twin there); here their wrapper's route is checked by reading its source,
and their dataflow is rendered in numpy float32 and held to the twin:
the scan a warp a column (each lane 8 consecutive sorted rows in registers,
y[j - sh] from the lane itself or from lane - ceil(sh / 8) by a shuffle
up), the output zeroed and each segment's last row written straight into
it, the carry's passes (in one CTA a column, or one launch a pass above
segsum.cu's kCarryMaxBlocks: the same operations) and the carries added in place at
the end rows.
"""

import ast
import dataclasses
import pathlib
import re

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
from tpurt_torch.kernels.segsum import (
    BLOCK, carry_passes, segment_accumulate_ref)
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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """The wrapper's two entry points are each called inside
    _build.on_device (the scan of tests/launch_scan.py, which
    tests/test_torch_closest_design.py also runs), and
    the module has no try: a failed build or launch raises."""
    tree = ast.parse(SEGSUM_PY.read_text())
    launches = {n.attr for n in ast.walk(tree)
                if isinstance(n, ast.Attribute) and n.attr.startswith("tpurt_")
                and n.attr != "tpurt_error_string"}
    assert launches == {"tpurt_segsum_scan", "tpurt_segsum_carry"}
    assert launches_outside_on_device(SEGSUM_PY) == []
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def test_a_tensor_off_the_cpu_never_reaches_the_twin(monkeypatch):
    monkeypatch.setattr(segsum, "segment_accumulate_ref",
                        lambda *a: pytest.fail("the twin ran for a non-CPU tensor"))
    idx = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        segment_accumulate(idx, torch.zeros(4, 3, device="meta"), 2)
    assert segsum.LAUNCHES["segsum"] == 0


# -- the kernels' dataflow in numpy (csrc/segsum.cu) --------------------------
SEGSUM_CU = SEGSUM_PY.parent / "csrc" / "segsum.cu"
f32 = np.float32
LANE_ROWS = 8  # consecutive sorted rows a lane holds


def _shfl_up(x: np.ndarray, q: int) -> np.ndarray:
    """__shfl_up_sync over the lane axis (1): lane l gets lane l - q's value,
    lanes below q their own."""
    return np.concatenate([x[:, :q], x[:, :-q]], axis=1)


def _scan_warps(y: np.ndarray, start: np.ndarray) -> np.ndarray:
    """segsum_scan_kernel's passes: y (nb, 32 lanes, 8 rows, C) and the
    segment starts (nb, 32, 8); each lane's rows in registers, w = y[j - sh]
    from before the pass (own registers, or a shuffle up by 1 or sh / 8
    lanes), blk from before the pass choosing y or y + w, then blk |=
    bpad.  Rows below sh are starts by then, so what lane 0 reads there
    is never added; its bpad bits there are set."""
    blk = start.copy()
    for p in range(8):
        sh = 1 << p
        if sh < LANE_ROWS:
            w = np.empty_like(y)
            w[:, :, sh:] = y[:, :, :LANE_ROWS - sh]
            w[:, :, :sh] = _shfl_up(y, 1)[:, :, LANE_ROWS - sh:]
            prev = _shfl_up(blk, 1)[:, :, LANE_ROWS - sh:].copy()
            prev[:, 0] = True
            bpad = np.concatenate([prev, blk[:, :, :LANE_ROWS - sh]], axis=2)
        else:
            q = sh // LANE_ROWS
            w = _shfl_up(y, q)
            bpad = _shfl_up(blk, q).copy()
            bpad[:, :q] = True
        with np.errstate(invalid="ignore", over="ignore"):
            y = np.where(blk[..., None], y, y + w)
        blk = blk | bpad
    return y


def _carry_passes(g: np.ndarray, a: np.ndarray) -> np.ndarray:
    """The carry's log-shift passes, every column at once: g (C, nb), a
    (nb,); g = g + a * g[b - sh]; a = a * a[b - sh], 0 past the front
    (segsum_carry_kernel's shared buffers and segsum_carry_pass's global
    ones compute the same)."""
    nb = a.shape[0]
    sh = 1
    while sh < nb:
        gp = np.concatenate([np.zeros_like(g[:, :sh]), g[:, :nb - sh]], axis=1)
        ap = np.concatenate([np.zeros(sh, f32), a[:nb - sh]])
        with np.errstate(invalid="ignore", over="ignore"):
            g = g + a[None] * gp
        a = a * ap
        sh *= 2
    return g


def segsum_kernels(idx: np.ndarray, cot: np.ndarray, num_rows: int) -> np.ndarray:
    """The memset, the scan, the carry (both routes: the passes are the same
    operations) and the end rows, as csrc/segsum.cu runs them."""
    order = np.argsort(idx.astype(np.int32), kind="stable")
    sid = idx.astype(np.int32)[order]
    n, use = cot.shape
    nb = -(-n // BLOCK)
    pad = nb * BLOCK - n
    s_sid = np.concatenate([sid, np.full(pad, num_rows, np.int32)]).reshape(nb, BLOCK)
    rows = np.concatenate([cot[order], np.zeros((pad, use), f32)]).reshape(nb, BLOCK, use)
    out = np.zeros((num_rows, use), f32)  # the memset
    # the scan: the segment starts as each lane's bits, a warp a column
    start = np.ones((nb, BLOCK), bool)
    start[:, 1:] = s_sid[:, 1:] != s_sid[:, :-1]
    y = _scan_warps(rows.reshape(nb, 32, LANE_ROWS, use),
                    start.reshape(nb, 32, LANE_ROWS)).reshape(nb, BLOCK, use)
    # each segment's last row into out[its id] (a row whose next sorted row,
    # in its block or the next, has another id)
    nxt = np.concatenate([sid[1:], [np.iinfo(np.int32).max]])
    is_end = (sid != nxt) & (sid >= 0) & (sid < num_rows)
    ends = np.nonzero(is_end)[0]
    out[sid[ends]] = y.reshape(-1, use)[ends]
    # cont, full; the last row into the next block's g and a
    head, tail = s_sid[:, 0], s_sid[:, -1]
    cont_next = np.zeros(nb, bool)
    cont_next[:-1] = tail[:-1] == head[1:]
    g = np.zeros((use, nb), f32)
    a = np.zeros(nb, f32)
    g[:, 1:] = np.where(cont_next[:-1, None], y[:-1, -1], f32(0)).T
    a[1:] = (cont_next[:-1] & (head[:-1] == tail[:-1])).astype(f32)
    # the carry, then the end rows: out[v] + carry * first, first = 1 for
    # the block's head id; first = 0 only where the carry is not finite
    carry = _carry_passes(g, a).T  # (nb, use)
    b = ends // BLOCK
    first = sid[ends] == head[b]
    cv = carry[b]
    touch = first[:, None] | ~np.isfinite(cv)
    with np.errstate(invalid="ignore", over="ignore"):
        new = out[sid[ends]] + cv * first[:, None].astype(f32)
    out[sid[ends]] = np.where(touch, new, out[sid[ends]])
    return out


def _kernels_hold(idx: np.ndarray, cot: np.ndarray, v: int) -> np.ndarray:
    got = segsum_kernels(idx, cot, v)
    assert np.array_equal(got, _twin(idx, cot, v), equal_nan=True)
    return got


@pytest.mark.parametrize("n", [4096, 4096 + 37])
@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_kernels_dataflow_equals_twin(pattern, n):
    rng = np.random.default_rng(7)
    idx = PATTERNS[pattern](rng, n, V).astype(np.int32)
    _kernels_hold(idx, rng.normal(size=(n, 3)).astype(f32), V)


@pytest.mark.parametrize("nb", [1, 2, 3, 257, 4080])
def test_kernels_dataflow_equals_twin_at_block_counts(nb):
    """nb blocks of 256 rows, the last one ragged (but for nb = 1, 2: 1 and
    511 rows), ids over a table larger than the rows (gaps of empty ids),
    12 columns as the soft-surface gather."""
    n = {1: 1, 2: 511}.get(nb, nb * BLOCK - 77)
    rng = np.random.default_rng(nb)
    v = max(2 * n // 3, 5)
    idx = np.sort(rng.integers(0, v, n)).astype(np.int32)[rng.permutation(n)]
    out = _kernels_hold(idx, rng.normal(size=(n, 12)).astype(f32), v)
    assert -(-n // BLOCK) == nb and (out == 0).all(axis=1).any()


def test_kernels_dataflow_on_a_segment_over_many_blocks():
    rng = np.random.default_rng(3)
    n = 4096 + 37
    idx = rng.integers(0, 200, n).astype(np.int32)
    idx[rng.permutation(n)[:3000]] = 100
    out = _kernels_hold(idx, rng.normal(size=(n, 9)).astype(f32), V)
    assert not out[200:].any()


@pytest.mark.parametrize("use", [3, 9, 12])
def test_kernels_dataflow_on_the_first_columns_of_wide_rows(use):
    rng = np.random.default_rng(use)
    n = 4096 + 37
    idx = PATTERNS["clustered"](rng, n, V).astype(np.int32)
    rows = rng.normal(size=(n, 15)).astype(f32)
    _kernels_hold(idx, np.ascontiguousarray(rows[:, :use]), V)


@pytest.mark.parametrize("pattern", ["uniform", "clustered"])
def test_kernels_dataflow_with_inf_nan_and_negative_zero(pattern):
    """inf, -inf and NaN in column 0 of some rows (a carry that is not
    finite reaches every end row of its block through carry * 0, and the
    blocks after it through the passes' a * g), -0 in column 1; column 2
    finite: every element equal to the twin's, NaN where it is NaN."""
    rng = np.random.default_rng(5)
    n = 16 * BLOCK + 9
    idx = PATTERNS[pattern](rng, n, V).astype(np.int32)
    cot = rng.normal(size=(n, 3)).astype(f32)
    bad = rng.permutation(n)[:6]
    cot[bad, 0] = [np.inf, -np.inf, np.nan, np.inf, np.nan, -np.inf]
    # and the last sorted row of block 3: its carry into block 4 is inf
    cot[np.argsort(idx, kind="stable")[4 * BLOCK - 1], 0] = np.inf
    cot[rng.permutation(n)[:n // 4], 1] = -0.0
    out = _kernels_hold(idx, cot, V)
    # uniform: the carries' NaN reaches ids with no bad row of their own
    assert np.isnan(out[:, 0]).sum() > (7 if pattern == "uniform" else 0)
    assert np.isfinite(out[:, 1:]).all()


def test_carry_size_rule():
    """The rule is on the block count alone and stated in segsum.cu only:
    the carry in one CTA a column while g and a (2 buffers each, 4 bytes a
    block) fit the 227 KB of shared memory a CTA may use, which holds the
    fit's shapes (4,080, 8,160 and 11,719 blocks), one launch a pass above;
    the carry's entry point chooses by that constant and nothing else, and
    the wrapper does not restate it.  (chip_smoke.py [segsum] counts the
    launches of each call on the card.)"""
    src = SEGSUM_CU.read_text()
    limit = int(re.search(r"constexpr int kCarryMaxBlocks = (\d+);", src).group(1))
    assert limit == 227 * 1024 // 16 and 11719 <= limit
    carry = src[src.index("int tpurt_segsum_carry("):]
    carry = carry[:carry.index("\n}\n")]
    assert re.findall(r"\bif \((.*?)\) \{", carry) == ["nb <= kCarryMaxBlocks"]
    assert str(limit) not in pathlib.Path(segsum.__file__).read_text().replace("_", "")
