"""Rank functions for the dist tests (tests/test_torch_dist_*.py): each
runs in a spawned rank (tpurt_torch.dist.dryrun.run_ranks) and returns its
results as tensors.  Not a test module: it imports torch and tpurt_torch
only, because every spawned rank imports it by name."""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from tpurt_torch.api.config import FitConfig, RenderConfig
from tpurt_torch.api.inverse import InverseRenderer
from tpurt_torch.api.renderer import Renderer
from tpurt_torch.core.convert import camera_from_numpy, scene_from_numpy
from tpurt_torch.core.geometry import Rays, Triangles
from tpurt_torch.dist import collectives
from tpurt_torch.dist.ring import ring_k_nearest, ring_occluded, ring_trace
from tpurt_torch.dist.runtime import gather_film, is_coordinator
from tpurt_torch.dist.scene_partition import (
    alltoall_trace, build_partition_bvhs, build_partition_wides, partition_scene)
from tpurt_torch.dist.shard import shard_render, shard_render_rays
from tpurt_torch.render import pipeline
from tpurt_torch.render.camera import gen_primary_rays
from tpurt_torch.render.pipeline import make_tracer, render, render_rays, tri_table


@contextlib.contextmanager
def one_thread():
    """torch's intra-op threads set to 1 for the duration: the packet
    engine's twins are lockstep small-op loops, which other processes'
    threads slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _tris(t: dict) -> Triangles:
    return Triangles.create(t["verts"], t["faces"], t["albedo"], t["emission"], device="cpu")


def _rays(o, d) -> Rays:
    return Rays(o=torch.from_numpy(o), d=torch.from_numpy(d))


def _hit(h) -> dict:
    return {"t": h.t, "u": h.u, "v": h.v, "tri": h.tri}


def ring_cases(mesh, tris: dict, o, d, tmax, k: int, band: float,
               engines=("brute", "wide8", "binary")) -> dict:
    """ring_trace, ring_occluded and ring_k_nearest through each local
    engine named (the brute tuple; this rank's WideBVH for "wide8"; its
    PackedBVH for "binary" and "packet"), each engine passed by name:
    band-0 trees for the first two, band trees for the k-nearest."""
    scene_tris, rays = _tris(tris), _rays(o, d)
    tm = torch.from_numpy(tmax)
    part = partition_scene(scene_tris, mesh.size())
    r = mesh.get_local_rank()
    table = tri_table(scene_tris)

    def trees(engine):
        if engine == "brute":
            return None, None
        if engine == "wide8":
            return (build_partition_wides(part, scene_tris, index=r),
                    build_partition_wides(part, scene_tris, band=band, index=r))
        return build_partition_bvhs(part, index=r), build_partition_bvhs(part, band=band, index=r)

    out = {}
    for name in engines:
        hard, soft = trees(name)
        out[name] = {"trace": _hit(ring_trace(mesh, rays, part, pbvh=hard, engine=name)),
                     "occluded": ring_occluded(mesh, rays, part, tm, pbvh=hard, engine=name),
                     "knear": ring_k_nearest(mesh, rays, part, table, k, band, pbvh=soft,
                                             engine=name)}
    return out


def packet_ring_render_cases(mesh, scene: dict, cam: dict) -> dict:
    """render() through make_tracer(method="ring", ring_engine="packet"),
    hard, with the rays each ring call receives: ring_trace's (the primary
    rays) and ring_occluded's (the shadow rays)."""
    sc, cm = scene_from_numpy(**scene, device="cpu"), camera_from_numpy(**cam, device="cpu")
    tracer = make_tracer(sc, "ring", mesh=mesh, ring_engine="packet")
    seen = {}

    def recorded(name, fn):
        def run(mesh_, rays, *a, **kw):
            out = fn(mesh_, rays, *a, **kw)
            seen[name] = {"o": rays.o.clone(), "d": rays.d.clone(),
                          "engine": kw.get("engine"),
                          "hit": out.tri >= 0 if name == "trace" else out}
            return out
        return run

    saved = pipeline.ring_trace, pipeline.ring_occluded
    pipeline.ring_trace = recorded("trace", saved[0])
    pipeline.ring_occluded = recorded("occluded", saved[1])
    try:
        with one_thread():
            img = render(sc, cm, tracer=tracer)
    finally:
        pipeline.ring_trace, pipeline.ring_occluded = saved
    prim = gen_primary_rays(cm)
    return {"img": img, "seen": seen, "ring_engine": tracer.ring_engine,
            "primary": {"o": prim.o.reshape(-1, 3), "d": prim.d.reshape(-1, 3)}}


def alltoall_cases(mesh, tris: dict, o, d) -> dict:
    """alltoall_trace with a generous capacity and with capacity 1."""
    part = partition_scene(_tris(tris), mesh.size())
    rays = _rays(o, d)
    out = {}
    for name, cap in (("generous", o.shape[0]), ("overflow", 1)):
        hit, resolved = alltoall_trace(mesh, rays, part, capacity=cap)
        out[name] = {**_hit(hit), "resolved": resolved}
    return out


def renderer_cases(mesh, scene: dict, cam: dict, soft_scene: dict, soft_cam: dict,
                   soft: dict) -> dict:
    """Renderer(mesh, partition="ring") and the replicated Renderer on one
    mesh, hard (wide8 and binary engines) and soft; 'auto' on the soft
    (small) scene."""
    sc, cm = scene_from_numpy(**scene, device="cpu"), camera_from_numpy(**cam, device="cpu")
    out = {}
    for method in ("wide8", "binary"):
        cfg = RenderConfig(method=method)
        out[f"ring_{method}"] = Renderer(sc, cfg, mesh=mesh, partition="ring").render(cm)
        out[f"replicated_{method}"] = Renderer(sc, cfg, mesh=mesh,
                                               partition="replicated").render(cm)
    ssc = scene_from_numpy(**soft_scene, device="cpu")
    scm = camera_from_numpy(**soft_cam, device="cpu")
    cfg = RenderConfig(method="wide8", **soft)
    auto = Renderer(ssc, cfg, mesh=mesh)
    out["auto_partition"] = auto.partition
    out["soft_replicated"] = auto.render(scm)
    out["soft_ring"] = Renderer(ssc, cfg, mesh=mesh, partition="ring").render(scm)
    return out


def shard_cases(mesh, scene: dict, cam: dict, ragged: int, soft: dict) -> dict:
    """shard_render (hard, soft) and shard_render_rays on a ragged batch,
    each beside the same render in this process without the mesh."""
    sc, cm = scene_from_numpy(**scene, device="cpu"), camera_from_numpy(**cam, device="cpu")
    tracer = make_tracer(sc, "bvh")
    soft_tracer = make_tracer(sc, "bvh", band=soft["band"])
    rays = gen_primary_rays(cm)
    part = Rays(o=rays.o[:ragged], d=rays.d[:ragged])
    return {"hard": shard_render(tracer, cm, mesh),
            "hard_ref": render(sc, cm, tracer=tracer),
            "ragged": shard_render_rays(tracer, part, mesh),
            "ragged_ref": render_rays(tracer, part),
            "soft": shard_render(soft_tracer, cm, mesh, **soft),
            "soft_ref": render(sc, cm, tracer=soft_tracer, **soft)}


def fit_cases(mesh, scene: dict, cam: dict, target, rkw: dict, steps: int,
              chunks: int) -> dict:
    """The data-parallel fit (FitConfig(grad_chunks=chunks)): losses,
    parameters and the all-reduces of each step."""
    sc, cm = scene_from_numpy(**scene, device="cpu"), camera_from_numpy(**cam, device="cpu")
    inv = InverseRenderer(sc, cm, fit=FitConfig(steps=steps, lr=1e-3, grad_chunks=chunks),
                          render=RenderConfig(**rkw), mesh=mesh)
    per_step = []

    def count(i, loss):
        per_step.append(dict(collectives.COUNTS))
        collectives.reset_counts()

    collectives.reset_counts()
    res = inv.fit(torch.from_numpy(target), callback=count)
    return {"losses": res.losses, "verts": res.params["verts"],
            "albedo": res.params["albedo"], "counts": per_step}


def runtime_cases(mesh) -> dict:
    """is_coordinator, psum_tree / pmean_tree, all_gather_tree,
    ppermute_tree and gather_film on a (2 x 3) film shard per rank."""
    r, w = mesh.get_local_rank(), mesh.size()
    shard = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 100 * r
    flags = torch.tensor([r % 2 == 0, True])
    film = gather_film(shard)
    return {"coordinator": is_coordinator(),
            "psum": collectives.psum_tree({"x": torch.tensor([1.0 + r])}, mesh)["x"],
            "pmean": collectives.pmean_tree({"x": torch.tensor([1.0 + r])}, mesh)["x"],
            "gathered": collectives.all_gather_tree({"s": shard, "f": flags}, mesh),
            "rotated": collectives.ppermute_tree({"s": shard, "f": flags}, mesh),
            "film": None if film is None else torch.from_numpy(film), "world": w}


def chunked_grad_cases(mesh, scene: dict, cam: dict, rkw: dict, chunks: int) -> dict:
    """chunked_grad over this rank's shard of the rays with the mesh, and
    the all-reduces it issued."""
    from tpurt_torch.dist.collectives import chunked_grad, rank_rows

    sc, cm = scene_from_numpy(**scene, device="cpu"), camera_from_numpy(**cam, device="cpu")
    tracer = make_tracer(sc, "bvh", band=rkw["band"])
    rkw = {k: v for k, v in rkw.items() if k != "method"}
    rays = gen_primary_rays(cm)
    rows = rank_rows(rays.o.shape[0], mesh)
    verts = sc.tris.verts.clone().requires_grad_(True)

    def loss(v, o, d):
        tr = dataclasses.replace(tracer, table=tri_table(dataclasses.replace(sc.tris, verts=v)))
        return torch.sum(render_rays(tr, Rays(o=o, d=d), **rkw) ** 2)

    collectives.reset_counts()
    total, grad = chunked_grad(loss, verts, (rays.o[rows], rays.d[rows]), chunks, mesh=mesh)
    return {"loss": total.detach(), "grad": grad, "counts": dict(collectives.COUNTS)}


def np_tree(x):
    """Tensors of a returned tree as numpy arrays, for the comparisons."""
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    if isinstance(x, dict):
        return {k: np_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(np_tree(v) for v in x)
    return x
