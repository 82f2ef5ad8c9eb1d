"""The packet twins' masked tail steps (kernels/packet.py _masked_walk)
against their compacting steps.

On the card a packet twin takes its last TAIL_PACKETS packets in
fixed-shape steps replayed as CUDA graphs; here the same masked steps run
eagerly (packet_walk's tail=) and must give every output and every walk
count bit for bit as the compacting loop does: from the first step
(tail above the packet count), from the middle of a walk (tail 2), and
with the compaction inside the masked walk (6 packets).  Inputs: the
port's bunny-3K, its primary rays at 96x64 and at 64x40 (3 packets, the
last padded), each ray with a seeded t_max.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from tpurt_torch.accel.lbvh import build_lbvh
from tpurt_torch.accel.packet import max_cut_leaves, pack_bvh
from tpurt_torch.core.geometry import T_MAX, Rays
from tpurt_torch.core.scene import make_bunny_scene
from tpurt_torch.kernels import packet as kp
from tpurt_torch.kernels import traverse8 as k8
from tpurt_torch.render.camera import gen_primary_rays

BAND = 0.08
TAILS = (0, 2, 10**6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _inputs(width: int, height: int):
    scene, cam = make_bunny_scene(num_tris=3000, device="cpu")
    cam = dataclasses.replace(cam, width=width, height=height)
    r = gen_primary_rays(cam)
    rays = Rays(o=r.o.reshape(-1, 3).contiguous(), d=r.d.reshape(-1, 3).contiguous())
    tmax = np.random.default_rng(5).uniform(-1, 8, rays.o.shape[0]).astype(np.float32)
    tris = scene.tris
    trees = {band: pack_bvh(tris, build_lbvh(tris, band=band), max_cut_leaves(tris.num_tris, 8))
             for band in (0.0, BAND)}
    return rays, torch.from_numpy(tmax), trees


def _run(call: str, rays, tmax, trees, tail: int, monkeypatch, masked: list):
    monkeypatch.setattr(kp, "packet_walk", functools.partial(_WALK, tail=tail))
    monkeypatch.setattr(kp, "_masked_walk", lambda *a: masked.append(1) or _MASKED(*a))
    stats = {}
    if call == "closest":
        h = kp.traverse_packet_ref(rays, trees[0.0], stats=stats)
        out = torch.stack([h.t.view(torch.int32), h.u.view(torch.int32),
                           h.v.view(torch.int32), h.tri])
    elif call == "occluded":
        out = kp.occluded_packet_ref(rays, trees[0.0], tmax, stats=stats)
    else:
        k = int(call[1:])
        out = kp.k_nearest_ids_packet_ref(rays, trees[BAND], k, BAND,
                                          t_max=T_MAX if k == 4 else tmax, stats=stats)
    return out, k8.walk_counts(stats)


_WALK, _MASKED = kp.packet_walk, kp._masked_walk


@pytest.mark.parametrize("size", [(64, 40), (96, 64)])
@pytest.mark.parametrize("call", ["closest", "occluded", "k4", "k8", "k16"])
def test_masked_tail_matches_the_compacting_walk(call, size, monkeypatch):
    rays, tmax, trees = _inputs(*size)
    masked = []
    ref, ref_counts = _run(call, rays, tmax, trees, 0, monkeypatch, masked)
    assert ref_counts["visits"] > 0 and not masked
    for tail in TAILS[1:]:
        got, counts = _run(call, rays, tmax, trees, tail, monkeypatch, masked)
        assert masked, tail
        masked.clear()
        assert torch.equal(got, ref), tail
        assert counts == ref_counts, tail
