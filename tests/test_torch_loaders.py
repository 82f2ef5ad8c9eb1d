"""The mesh loaders (core/scene.py load_obj, save_obj, load_ply) and the
mesh-file branch of get_scene against tpurt's, on the same bytes."""

import dataclasses
import io

import numpy as np
import pytest

from tpurt.core import scene as jscene

from tpurt_torch.core import scene as tscene


def _mesh(seed=0, n_quads=7):
    """Vertices and a mix of triangles and quads (fanned by the loaders)."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-2, 3, (4 * n_quads + 3, 3)).astype(np.float32)
    polys = [list(range(4 * k, 4 * k + 4)) for k in range(n_quads)]
    polys.append([4 * n_quads, 4 * n_quads + 1, 4 * n_quads + 2])
    return v, polys


def _obj_text(v, polys, negative=False):
    lines = ["# test mesh", "o thing"]
    lines += [f"v {x!r} {y!r} {z!r}" for x, y, z in v.tolist()]
    lines += ["vt 0.5 0.5", "vn 0 1 0"]
    for p in polys:
        if negative:  # relative indices, counted from the last vertex
            toks = [str(i - len(v)) for i in p]
        else:
            toks = [f"{i + 1}/1/1" for i in p]
        lines.append("f " + " ".join(toks))
    return "\n".join(lines) + "\n"


def _ply_bytes(v, polys, binary: bool, extra_prop: bool = True) -> bytes:
    props = "property float x\nproperty float y\nproperty float z\n"
    if extra_prop:
        props += "property uchar red\n"
    head = (f"ply\nformat {'binary_little_endian' if binary else 'ascii'} 1.0\n"
            f"element vertex {len(v)}\n{props}"
            f"element face {len(polys)}\nproperty list uchar int vertex_indices\n"
            "end_header\n").encode("ascii")
    if not binary:
        rows = [" ".join(repr(x) for x in p) + (" 200" if extra_prop else "") for p in v.tolist()]
        rows += [" ".join(str(i) for i in [len(p), *p]) for p in polys]
        return head + ("\n".join(rows) + "\n").encode("ascii")
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")] + ([("red", "u1")] if extra_prop else [])
    arr = np.zeros(len(v), dtype=np.dtype(fields))
    arr["x"], arr["y"], arr["z"] = v[:, 0], v[:, 1], v[:, 2]
    if extra_prop:
        arr["red"] = 200
    body = arr.tobytes()
    for p in polys:
        body += bytes([len(p)]) + np.asarray(p, "<i4").tobytes()
    return head + body


def _same(t, j):
    np.testing.assert_array_equal(t.verts.numpy(), np.asarray(j.verts))
    np.testing.assert_array_equal(t.faces.numpy(), np.asarray(j.faces))
    np.testing.assert_array_equal(t.albedo.numpy(), np.asarray(j.albedo))


@pytest.mark.parametrize("negative", [False, True])
def test_load_obj_matches_tpurt(tmp_path, negative):
    v, polys = _mesh()
    text = _obj_text(v, polys, negative)
    path = tmp_path / "m.obj"
    path.write_text(text)
    t = tscene.load_obj(str(path), albedo=(0.2, 0.3, 0.4), device="cpu")
    _same(t, jscene.load_obj(str(path), albedo=(0.2, 0.3, 0.4)))
    assert t.num_tris == 2 * 7 + 1
    _same(tscene.load_obj(io.StringIO(text), device="cpu"), jscene.load_obj(io.StringIO(text)))


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary_le"])
def test_load_ply_matches_tpurt(tmp_path, binary):
    v, polys = _mesh(seed=2)
    path = tmp_path / "m.ply"
    path.write_bytes(_ply_bytes(v, polys, binary))
    t = tscene.load_ply(str(path), device="cpu")
    _same(t, jscene.load_ply(str(path)))
    assert t.num_tris == 2 * 7 + 1


def test_load_ply_refuses_big_endian(tmp_path):
    v, polys = _mesh()
    path = tmp_path / "m.ply"
    path.write_bytes(_ply_bytes(v, polys, True).replace(b"binary_little_endian",
                                                         b"binary_big_endian"))
    with pytest.raises(ValueError, match="unsupported PLY format"):
        tscene.load_ply(str(path), device="cpu")


def test_save_obj_round_trip_matches_tpurt(tmp_path):
    scene, _ = tscene.make_bunny_scene(num_tris=600, device="cpu")
    tscene.save_obj(str(tmp_path / "a.obj"), scene.tris)
    jsc, _ = jscene.make_bunny_scene(num_tris=600)
    jscene.save_obj(str(tmp_path / "b.obj"), jsc.tris)
    assert (tmp_path / "a.obj").read_text() == (tmp_path / "b.obj").read_text()
    back = tscene.load_obj(str(tmp_path / "a.obj"), device="cpu")
    np.testing.assert_array_equal(back.faces.numpy(), scene.tris.faces.numpy())
    np.testing.assert_allclose(back.verts.numpy(), scene.tris.verts.numpy(), rtol=1e-6)


@pytest.mark.parametrize("ext", [".obj", ".ply"])
def test_get_scene_of_a_mesh_file_matches_tpurt(tmp_path, ext):
    v, polys = _mesh(seed=4)
    path = tmp_path / f"m{ext}"
    if ext == ".obj":
        path.write_text(_obj_text(v, polys))
    else:
        path.write_bytes(_ply_bytes(v, polys, True))
    ts, tc = tscene.get_scene(str(path), device="cpu")
    js, jc = jscene.get_scene(str(path))
    _same(ts.tris, js.tris)
    for f in ("background", "ambient"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    np.testing.assert_array_equal(ts.lights.pos.numpy(), np.asarray(js.lights.pos))
    np.testing.assert_array_equal(ts.lights.intensity.numpy(), np.asarray(js.lights.intensity))
    for f in ("eye", "target", "up", "fov_y_deg"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), err_msg=f)
    assert (tc.width, tc.height) == (jc.width, jc.height) == (512, 512)
    assert dataclasses.replace(tc, width=8).width == 8
