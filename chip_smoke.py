"""Smoke run of tpurt_torch on one NVIDIA GPU: the hard render and the fit
step of the 1M-triangle sponza scene through the hand-written BVH8 CUDA
kernels, and of the 70K-triangle bunny at 512x512 through the binary-BVH
kernels; tpurt's packet engine's kernels on both; the LBVH build through
the Morton and radix-tree kernels at 1M and 5M triangles, the port's
Renderer, area lights (hard and soft), the distributed paths (dist/, at
world 1 on NCCL), the CLI and the benchmark.

    python3 chip_smoke.py [--parent DIR] [--parent NAME=DIR ...]
    python3 chip_smoke.py --packet-ab --parent DIR [--parent NAME=DIR ...]

--packet-ab runs [device], [build] and then only [walk_ab]'s packet cells
(below), with the shadow rays from this build's hits, [knear_ab]'s packet
cells and [segsum_ab] on [segsum]'s inputs but the bunny fit's, and prints
no result line: the quick A/B of the packet and segsum kernels against
other trees.

Phases, one line each (any failure exits non-zero and prints no result):
  device   torch.cuda must be available; the card's name and power limit.
  build    nvcc builds the CUDA kernels from src/tpurt_torch/kernels/csrc,
           one process per source; each kernel's registers and spills (the
           walk kernels and radix must not spill).  With
           --parent, the kernels of each other source tree (a checkout of
           the parent commit, or of a variant of these kernels) are built
           alongside.
  scene    the 1M-triangle sponza scene at 1920x1088: scene, LBVH, collapse
           and pack seconds (band 0, the hard render's tree).
  parity   closest8 and occluded8 against their plain-torch twins on the
           card, on every ray of the Morton-ordered 1920x1088 frame and its
           shadow rays, for the scene's camera and for an overview of the
           courtyard (any differing blocked flag is printed and fails the
           script at its end); the twins' full-frame milliseconds and their
           walk counts, from which the kernels' bounds are computed ([bound]).
  subset_timing
           kernel and twin milliseconds on 65,536 of the frame's rays.
  scene_band
           the band-0.08 tree of the same scene (the soft path's).
  knear_parity
           knear8 against its twin on every ray of both views: k = 4 on the
           primary rays (t_max = T_MAX) and k = 8 on the shadow-candidate
           rays from layer 0's points (t_max = 2 x the segment), as the soft
           render calls it; the wrapper's ms (CUDA events), the kernel's
           device ms (bare launches, CUDA events), the twin's full-frame ms,
           walk counts.
  render   render(method="wide8") of the full frame through closest8 and
           occluded8, with the launch counts of that run.
  golden   cornell 64^2 and bunny-3K 48^2 renders on the card against the
           reference images in tests/golden.
  timing   per-kernel milliseconds (CUDA events) and full-frame rays/s,
           the main view and the overview.
  profile  torch.profiler over 5 hard frames: each kernel's and the torch
           glue's share of device time, the device's idle share; closest8 on
           row-major against Morton-ordered rays.
  walk_ab  the walk kernels against each other tree's (--parent): closest8
           and occluded8 on both views' frames and shadow rays; later
           closest_bin and occluded_bin on the 1M main view, the overview's
           first rays and the bunny; in [packet], packet_closest on the 1M
           main view's and overview's row-major frames and the bunny 512^2,
           packet_occluded on their shadow rays, each held bitwise (any ray
           whose id, flag or t/u/v bits differ fails).  Ids or flags equal
           (a differing flag fails the script at its end, a differing
           closest_bin id unless ROADMAP P6 explains it), t, u, v and
           shading lanes bitwise, then
           in turns other, new, new, other the call's ms (CUDA events) and
           the kernel's device ms (bare launches); without other trees, this
           build's alone.
  split_rule
           the 1M sponza's wide tree collapsed with build_wide's
           split_rule="count" beside the default "area" tree: closest8 and
           occluded8 on both views against their twins on the count tree
           (every id, flag and t/u/v and shading bit; a difference fails
           the script at its end), the bounds from the count tree's twin
           walk counts, then in turns area, count, count, area each
           kernel's ms, device ms and the hard frame's ms; count / area.
  fit      InverseRenderer.fit: 3 Adam steps of verts and albedo on the 1M
           scene at 1920x1088 (soft, k_layers 4, k_occ 8, 8 ray chunks)
           toward the albedo x 0.8 render; step seconds, fwd+bwd rays/s,
           losses, gradient norms, peak memory, the launch counts of the fit.
  refit_wide
           [fit]'s band tree refit at one fit step's vertices: tpurt's
           refit_wide (over refit_aabbs' binary boxes, rows from the table)
           against refit_wide_direct, wrow and tri_rows bitwise.
  fit_pieces
           knear8 as the fit calls it (the step's refit tree, row-major
           chunks of 261,120 rays): both calls on chunk 0 against the twin
           with their bounds (as knear_parity view=fit_chunk0); each call
           summed over the 8 chunks and as one launch over the whole
           row-major frame, by CUDA events and the kernel's device ms; the
           refit's ms.
  knear_ab (with --parent) knear8 against each other tree's, and against
           itself behind a Morton sort of the rays (morton_sorted), on the
           same refit tree: every id list equal, then in turns other, new,
           new, other the calls' ms (CUDA events) and each tree's kernel
           device ms (bare launches), over the fit's 8 row-major chunks, one
           row-major launch and the Morton frame, both calls; knear_bin the
           same on the bunny; in [packet], packet_knear (no Morton sort: the
           packet is part of its function) on [fit]'s chunk 0 (layers,
           occluders), the 1M main view's occluder call and the bunny
           512^2's layers, occluders and a k = 16 call.
  dist_fit the data-parallel fit: InverseRenderer(mesh=...) (a world-1
           NCCL group, dist_setup) on [fit]'s problem against [fit]'s
           mesh-free fit and a second mesh-free run: losses within rtol
           1e-4, the parameters' largest differences, the all-reduces a
           step (FIT_CHUNKS), their bytes, one all-reduce's ms, s/step.
  fit_check
           cornell 32^2 soft on the card: wide8 image against brute, wide8
           gradients against the same code on the CPU, finite differences,
           and a 5-step albedo fit whose loss falls.
  profile_fit
           torch.profiler over one fit step: the device-time shares of
           knear8, the backward (index_add_/scatter kernels, the segsum
           kernels and the radix sorts before them, and the rest), the refit
           and the forward glue; the device's idle share.
  segsum   the gather backward's segment_accumulate (csrc/segsum.cu) on the
           real inputs of one [fit] step (chunk 0's soft_surface gather,
           K x R rows x 12 of 15 columns, and its soft_occlusion gather,
           L x k_occ x R rows (L lights) x 9; the step's corner gather, 3T
           rows x 3), later of one [fit_bin] step, tpurt's five id
           patterns at 2^20 rows, a 2^20-row input with inf, -inf, NaN and
           -0 rows (non-finite carries) and one above the one-CTA carry's
           size (15M rows x 3 into 5M, the 5M corner gather's shape):
           the kernels against the twin on the card, every element equal as
           floats, NaN where the twin's is NaN (a differing one fails the
           script at its end); device ms by CUDA events of the sort, the
           kernels by bare launches (the memset and the scan; all four,
           the carry and the end rows being the difference), the wrapper
           call, the twin, index_add_ and index_add_ under deterministic algorithms;
           the kernel launches a call; the kernels' bound from the bytes
           their function moves on this input (sorted ids, permutation and
           the rows' `use` columns in, the sums out), the design's bytes
           beside.  With --parent, [segsum_ab]: each tree's kernels (by its
           own interface) on the same inputs, every output element equal to
           this build's, then their device ms in turns other, new, new,
           other (bare launches, the sort made before).
  segsum_rule
           the fit under 'scatter', 'segsum', 'segsum', 'scatter' in turns
           (later [fit_bin]'s too): step seconds, their ratio against
           SEGSUM_RULE, parameter elements that differ between the two runs
           of each backend; the ops a step under
           use_deterministic_algorithms(warn_only=True) warns about.
The binary-BVH engine (method="binary": closest_bin, occluded_bin and
knear_bin over the packed threaded tree):
  scene_bin
           LBVH (with its DFS thread) and pack seconds, node and row bytes,
           bound against live leaves: the 1M sponza's hard tree, the bunny's
           (70K triangles, 512x512) hard and band-0.08 trees.
  bin_parity
           each kernel against its twin on every ray: closest_bin and
           occluded_bin on the Morton-ordered frame and its shadow rays (the
           1M main view, the first 262,144 rays of the 1M overview, the
           bunny), knear_bin on the bunny as
           the soft render calls it (k = 4 on the primary rays, k = 8 on the
           layer-0 shadow candidates, t_max = 2 x the segment); mismatch
           fraction (a differing blocked flag fails the script at its end),
           max |t, u, v - twin's|, kernel and twin ms (knear_bin also its
           device ms).
  bound_bin
           each kernel's least time on the card from its twin's walk counts
           (the bunny frame, the 1M main view); closest_bin's and
           occluded_bin's from their near-first walks and from the parent's
           escape walks, the smaller their bound.
  render_bin
           render(method="binary") of the bunny's 512x512 hard frame, with
           the launch counts of that run, against the wide8 image; the
           goldens through "binary".
  timing_bin
           per-kernel and frame milliseconds (CUDA events) and rays/s of the
           binary hard frame, bunny and 1M main view (closest8 and occluded8
           beside the latter).
  profile_bin
           as profile, for the bunny's binary hard frame.
  fit_bin  InverseRenderer.fit with method="binary": 3 Adam steps on the
           bunny at 512x512 in one 262,144-ray chunk, the refit in the step;
           step seconds, fwd+bwd rays/s, losses, gradient norms, peak
           memory, knear_bin launches.
  profile_fit_bin
           as profile_fit, for one binary fit step on the bunny; then
           [segsum] and [segsum_rule] on the bunny's fit, [segsum]
           on the patterns, and [segsum_default]: the gather backward's
           default against the one SEGSUM_RULE picks.
The LBVH build (morton and radix; every make_tracer above ran them):
  treebuild_parity
           each kernel against its twin on the card, bitwise: N = 2 (distinct
           and equal codes), 2^20 equal codes, and the centroids of the bunny,
           the 1M and the 5M sponza (radix on their sorted codes); kernel and
           twin ms (morton's from a profile, radix's from bare launches, the
           wrapper call's and the twin's by CUDA events), the bound from this
           input (radix: the work of Karras's search for its tree), the
           phase's launches.  morton at 1M and 5M also from HBM: bare
           launches after a 128 MB read that leaves the L2 clean
           (l2_flushed_ms, the time held to its bound), after a 128 MB
           write (l2_write_flushed_ms: the launch also writes the dirty
           lines back, the yardstick the row was once read by), and an
           empty kernel under the same flush (launch_floor_ms); and morton
           on the edge inputs, N = 1, 2, 3, 5 and 2^20 + 3 seeded points,
           each also as a view 12 bytes past its tensor's base.
  build_stages
           a warm build_lbvh at 1M and 5M: seconds, launches, peak memory
           above what was allocated before it; each of its lbvh.* stage
           spans in a profile of 3 warm builds (its kernels' device ms, its
           device-side span, its host ms, the kernels in the span; the
           hand-written kernel alone); with --parent, the lbvh.radix span
           of the same builds through the parent's radix stage; the same
           build through the twins on the card, every BVH field bitwise
           equal; at 5M the wide collapse and pack seconds.
  renderer the main path as a user calls it: Renderer(scene, RenderConfig(
           "wide8")) on the 1M scene builds and renders the frame; its
           launch counts, its image against [render]'s.
  area     area lights: 64 seeded triangles of the 1M sponza and of the
           bunny made emitters (Le 8).  The hard frame through
           Renderer(light_samples=4).render (a generator seeded light_seed):
           wide8 on the 1M main view and the overview at 1920x1088
           (8,355,840 area shadow rays through occluded8), binary on the
           bunny (occluded_bin); launch counts, the image against the twin
           route's (every kernel wrapper swapped for its twin, on the card,
           the same seed), occluded8's flags on the area shadow rays against
           the twin's on every ray; frame ms split into closest, occluded
           and glue, area shadow rays a second; occluded8's bound on the
           area rays from its twin's walk counts ([bound] rays=area);
           [area_profile]: the frame's device-time shares, idle share and
           largest glue kernels.  [spp]: Renderer(spp=4, light_samples=4)
           on both 1M views (tpurt's converged soft shadows): the image
           bitwise the mean of its samples replayed from the same seeded
           generator, 4 closest8 and 8 occluded8 launches a frame, frame
           ms, area shadow rays a second.  The
           soft render with its d/d(verts, albedo): binary on the bunny
           (knear_bin), wide8 on one 261,120-ray chunk of the overview
           (knear8), against the twin route's image and gradients.  Then
           through Renderer(method="packet") the hard area frame of the
           bunny and the 1M main view (packet_occluded's flags on the area
           rays bitwise occluded_bin's, the image within tpurt's golden
           rule of the binary area frame, differing pixels counted, frame
           ms split) and the bunny's soft area render through
           packet_knear (finite, gradients finite, within the golden rule
           of the binary soft image).
  dist_fold
           the ring's local steps (dist/ring.py) over FOLD_PARTS Morton
           partitions of the 1M sponza on the one card, in the order rank
           0's rays meet them: the main view's and the overview's hard
           frames (closest8, occluded8), one fit chunk of the main view
           soft (knear8, k 4 and k_occ 8), and the bunny's hard frame and
           soft render through the binary kernels; each against the same
           fold through the twins on the card (0 differing ids, flags and
           k-lists) and the replicated render (the image rule), launches,
           ms.
  dist_shard
           shard_render and Renderer(mesh=...) of the bunny at world 1
           (the film back through NCCL's all-gather) bitwise equal to
           Renderer.render; alltoall_trace on cornell 32^2 against brute
           force.
tpurt's packet engine (method="packet": packet_closest, packet_occluded and
packet_knear, one CTA a 1,024-ray packet) and its wavefront
engine (method="wave"):
  packet   Renderer(scene, RenderConfig(method="packet")) on the 1M main
           view: init and render seconds, launch counts (a kernel never
           launched fails the script), the image against the wide8 frame
           (the image rule), the goldens through "packet" (bunny3k_packet_48
           at frac 0.0).  Then on the 1M main view, the overview and the
           bunny at 512^2, their row-major frames as the Renderer traces
           them: packet_closest on the frame, packet_occluded on its shadow
           rays (per-ray t_max), packet_knear with k = 4 on the frame and
           k_occ = 8 on the candidates from layer 0 (2 x the segment as
           t_max), on the band-0.08 tree (on the bunny also k = 16, the
           longest list); and packet_knear on chunk 0 of
           [fit]'s problem (261,120 rays).  Each against its twin on every
           ray (any differing id, flag, list entry or t/u/v bit fails the
           script at its end), the wrapper's ms (CUDA events), the kernel's
           device ms (bare launches), the twin's ms and the bound from its
           packet walk counts.  With --parent, [walk_ab]'s and [knear_ab]'s
           packet cells.
  packet_frame
           each hard frame's ms by CUDA events split into closest, occluded
           and glue, rays/s, beside this run's wide8 and binary frames; the
           rays whose closest hit or blocked flag differs from the binary
           per-ray kernels' on the same tree, by group (a direction
           component in [-1e-30, 0), a zero component, the rest).
  fit_packet
           as fit_bin, through method="packet" (packet_knear); then
           [profile_fit_packet], as profile_fit for one such step.  With
           --parent, [fit_packet_ab]: the fit with each tree's packet_knear
           in turns other, new, new, other (step seconds, parameter
           elements that differ from this build's fit: any fails) and
           one profiled step with each other tree's kernel.
  wave     render(method="wave") of the bunny's 512^2 hard frame and the
           1M main view at 1920x1088, each bitwise the "bvh" frame (a
           difference fails the script at its end), and the bunny's soft
           frame (wave_k_ids) within rtol = atol = 2e-3 of the "bvh" soft
           frame; wave and bvh seconds.
  sponza5m the 5M scene's generation seconds and its phases' seconds.
  dist_ring
           the 5M sponza at 3840x2160 through Renderer(mesh,
           partition="ring") against the replicated wide8 Renderer: init
           seconds (partition, builds), peak bytes, frame ms by CUDA events
           split into closest8, occluded8, the ring functions' own time
           (fold and all-gathers) and glue, the ratio of the frames, the
           images by the image rule, the ring frame's closest8 and
           occluded8 calls against their twins on the card (0 differing).
  build_ab morton and radix against each other tree's (--parent), radix on
           the sorted codes of the 1M and 5M sponza and on 2^20 equal codes,
           morton (the control) on the two scenes' centroids: every output
           of each tree's stage bitwise equal to this build's (a tree that
           differs fails the script at its end), then in turns other, new,
           new, other the kernel's device ms from bare launches and the
           stage's ms as each tree's wrapper makes it (the parent's: full,
           arange and two cats before its kernel); without other trees,
           this build's alone; morton's bare launches also with a clean
           L2 before each (flushed_ms), in the same turns.
  cli      `python -m tpurt_torch.cli.main` as subprocesses in a temporary
           directory: build-bvh on the 5M sponza (its metric line), render of
           the 5M sponza at 3840x2160 (shape, finite, hit fraction) and of the
           bunny through "binary", alone and with --shard (a world-1 NCCL
           group), each equal to the in-process Renderer's, fit
           on cornell 32^2 with checkpoints every 2 steps (6 steps, then a
           resumed run to 8), check-grads on cornell 24^2; the independent
           verbs started together.
  bench    `python -m tpurt_torch.cli.main bench --parity --staged
           --sort-bench --profile-dir DIR` in a subprocess (tpurt_torch.bench,
           the port's benchmark): the 1M fwd and fwd_bwd rows, the 5M fwd,
           fwd_bwd and ring rows, the staged rows, the kernels against their
           twins and the sort rows (torch.sort of 2^20 and 5 x 2^20 keys),
           each row printed; the headline's numbers on their own line.  It
           must exit 0 with wide8 as the engine that ran, no error, value,
           value_fwd_bwd and the three 5M values above 0, and both sort
           rows sorted.
Then the kernels' JSON line and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tpurt_torch.accel.bvh8 import (  # noqa: E402
    WideBVH, collapse_wide, pack_wide, refit_wide, refit_wide_direct, tri_rows_bytes, wide_bytes)
from tpurt_torch.accel.intersect import DEFAULT_T_MIN, intersect_brute  # noqa: E402
from tpurt_torch.accel import lbvh as lbvh_mod  # noqa: E402
from tpurt_torch.accel import morton as morton_mod  # noqa: E402
from tpurt_torch.accel.lbvh import BVH, build_lbvh  # noqa: E402
from tpurt_torch.accel.packet import max_cut_leaves, pack_bvh  # noqa: E402
from tpurt_torch.accel.refit import refit_aabbs  # noqa: E402
from tpurt_torch.accel.traverse_ref import (  # noqa: E402
    blocks, closest_walk, mt9, occluded_walk, safe_inv)
from tpurt_torch.api.config import FitConfig, RenderConfig  # noqa: E402
from tpurt_torch.api.inverse import InverseRenderer  # noqa: E402
from tpurt_torch.api.renderer import Renderer  # noqa: E402
from tpurt_torch.core.geometry import T_MAX, Camera, Hit, KHits, PointLight, Rays  # noqa: E402
from tpurt_torch.core.math import sample_square  # noqa: E402
from tpurt_torch.core.scene import (  # noqa: E402
    make_bunny_scene, make_cornell_box, make_sponza_scene)
from tpurt_torch.dist import collectives as coll_mod  # noqa: E402
from tpurt_torch.dist import ring as ring_mod  # noqa: E402
from tpurt_torch.dist.runtime import init_distributed  # noqa: E402
from tpurt_torch.dist.scene_partition import (  # noqa: E402
    BIG_ID, alltoall_trace, build_partition_bvhs, build_partition_wides, partition_scene)
from tpurt_torch.dist.shard import make_mesh, shard_render  # noqa: E402
from tpurt_torch.diff import gather_grad as gg_mod  # noqa: E402
from tpurt_torch.kernels import _build  # noqa: E402
from tpurt_torch.kernels import packet as kp  # noqa: E402
from tpurt_torch.kernels import traverse as kb  # noqa: E402
from tpurt_torch.kernels import segsum as ss  # noqa: E402
from tpurt_torch.kernels import traverse8 as k8  # noqa: E402
from tpurt_torch.kernels import treebuild as tb  # noqa: E402
from tpurt_torch.render import pipeline as pipeline_mod  # noqa: E402
from tpurt_torch.render.camera import gen_primary_rays, pixel_morton_perm  # noqa: E402
from tpurt_torch.diff.fdcheck import check_grads_fd  # noqa: E402
from tpurt_torch.render.pipeline import (  # noqa: E402
    Tracer, hit_surface, make_tracer, occluder_rays, render, render_rays,
    shadow_rays, soft_surface, tri_table)

NUM_TRIS = 1_000_000
WIDTH, HEIGHT = 1920, 1088
# The twins run over a frame in chunks of this many rays: a 1920x1088
# frame in one chunk, so each walk's host-bound tail (its last visits,
# with few rays left) is paid once a frame, not once every 262,144 rays.
# Their (rays, 8 * max_rows, 128) f32 row gathers then take up to ~8.6 GB.
PARITY_CHUNK = 1 << 21
# Kernel and twin timed side by side on every k-th ray of the frame.
SUBSET_RAYS = 65_536
# A kernel may disagree with its twin on at most this fraction of rays
# (ids / blocked flags); with -fmad=false the two should agree exactly.
MAX_MISMATCH_FRAC = 1e-4
# Where ids agree, t, u, v and the shading outputs must agree to this
# absolute tolerance: the kernel and its twin do the same f32 operations in
# the same order, so they are bit-identical.
MAX_ABS_ERR = 0.0
KERNEL_SRC = "src/tpurt_torch/kernels/csrc/traverse8.cu"
BIN_SRC = "src/tpurt_torch/kernels/csrc/traverse.cu"
TREEBUILD_SRC = "src/tpurt_torch/kernels/csrc/treebuild.cu"
SEGSUM_SRC = "src/tpurt_torch/kernels/csrc/segsum.cu"
PACKET_SRC = "src/tpurt_torch/kernels/csrc/packet.cu"
# The 1M scene's own camera faces a clutter box ~0.15 units away (every ray
# hits it and every shadow ray is blocked), so parity, [timing] and
# [walk_ab] also run on a view over the courtyard, which exercises deep
# walks, misses and lit points.
OVERVIEW_EYE, OVERVIEW_TARGET = (0.0, 22.0, 26.0), (0.0, 1.5, 0.0)
REPLACES = {"closest8": "src/tpurt/kernels/traverse8.py:425",
            "occluded8": "src/tpurt/kernels/traverse8.py:653",
            "knear8": "src/tpurt/kernels/traverse8.py:775",
            "closest_bin": "src/tpurt/kernels/traverse.py:342",
            "occluded_bin": "src/tpurt/kernels/traverse.py:446",
            "knear_bin": "src/tpurt/kernels/traverse.py:540",
            "morton": "src/tpurt/kernels/treebuild.py:53",
            "radix": "src/tpurt/kernels/treebuild.py:95",
            # no Pallas kernel: tpurt computes the segment-sum in XLA
            "segsum": "src/tpurt/diff/gather_grad.py:60",
            # no Pallas kernel: tpurt's packet engine is XLA (lax.map of a
            # while_loop a packet)
            "packet_closest": "src/tpurt/accel/packet.py:249",
            "packet_occluded": "src/tpurt/accel/packet.py:331",
            "packet_knear": "src/tpurt/accel/packet.py:398"}
# The binary engine's configuration: BASELINE config 2, tpurt's bench.py
# "2-bunny" (make_bunny_scene's 70K-triangle default at 512x512).
BUNNY_RES = 512
# The binary fit step: bench.py's 2-bunny fwd_bwd, the whole frame in one
# chunk of 262,144 rays.
BIN_FIT_STEPS, BIN_FIT_CHUNKS = 3, 1
# Parity of the binary kernels on the 1M overview covers its first this
# many Morton-ordered rays: their twins walk ~550 binary nodes a ray, and
# the whole overview frame would add ~25 s to the script.
BIN_OVERVIEW_RAYS = 262_144
# The soft path's settings (bench.py's fwd_bwd row): layers, edge sharpness,
# barycentric band, candidate occluders per (point, light).
SOFT = dict(soft=True, k_layers=4, sharpness=40.0, band=0.08, k_occ=8)
BAND = SOFT["band"]
FIT_STEPS, FIT_CHUNKS, FIT_LR = 3, 8, 1e-2
# [fit_check]: tpurt's gradient-gate settings (tests/grad/test_fdcheck.py)
# on cornell in generic position (seeded vertex jitter, off-axis light).
GATE = dict(soft=True, k_layers=8, sharpness=30.0, band=0.25, k_occ=8)
GATE_RES = 32
# Finite differences run at tpurt's own FD-gate resolution: at 32^2 the
# probe seed 1 picks (vertex 34, x) sits within eps = 1e-3 of a kink of the
# soft model, on brute and wide8 alike (the CPU twins, this scene: FD at
# eps 1e-4 agrees with autograd to 0.4%, at 1e-3 it does not).
FD_RES = 24
# wide8 against brute image: tpurt's engine threshold, atol on >= 99.7% of
# pixels (tpurt's image rule: at most IMAGE_OFF_FRAC of pixels off by more
# than IMAGE_ATOL).
IMAGE_ATOL, IMAGE_MIN_FRAC = 2e-3, 0.997
IMAGE_OFF_FRAC = 1.0 - IMAGE_MIN_FRAC
# wide8 gradients on the card against the same code on the CPU: atomics sum
# in another order and CUDA's exp, sqrt and division round differently, so
# they agree to this fraction of the largest gradient.
GRAD_DEVICE_RTOL = 1e-4
# The card's peak rates at 700 W: HBM bandwidth (NVIDIA's H100 SXM data
# sheet) and f32 instructions outside the tensor cores: 128 f32 add,
# multiply or multiply-add results a clock on each of 132 SMs at 1.98 GHz
# (NVIDIA's CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0).  The data sheet's 67 TFLOP/s counts an FMA as two
# operations; the walk counts below are instructions, and the kernels are
# built with -fmad=false, so nothing fuses and an instruction is one
# operation.  A bound is the larger of bytes over the rate and operations
# over the peak.
PEAK_F32_OPS, PEAK_BYTES_S = 128 * 132 * 1.98e9, 3.35e12
# Operations per test, read off traverse8.cu: a child slab test is 6 mul,
# 6 sub, 6 min/max per axis pair, 3 max, 3 min and a compare; a
# Möller–Trumbore test is 47 adds, multiplies and one division.
SLAB_OPS, MT_OPS = 25, 47
# Bytes a walk reads once per distinct node and leaf row, and slab tests per
# node visit: a BVH8 node record and triangle row; a binary node (node_f32
# and node_i32 rows) and leaf (72 floats of its row and its 8 ids).
WIDE = dict(node_bytes=256, row_bytes=512, slabs=8, row_tests=8)
BIN = dict(node_bytes=48, row_bytes=320, slabs=1, row_tests=8)
# The any-hit twins count half rows (4 tests each) as rows: their kernels
# end a walk at the first half row that blocks.
WIDE_HALF, BIN_HALF = dict(WIDE, row_tests=4), dict(BIN, row_tests=4)
# The packet walks, counted per packet: a visit is 1,024 slab tests, a leaf
# visit 1,024 x 8 Möller–Trumbore tests; a binary node and leaf row read.
PACKET = dict(BIN, slabs=1024, row_tests=8 * 1024)
# The build kernels' configuration: the 5M sponza at 3840x2160 (tpurt's
# get_scene("sponza5m"), BASELINE config 5's scene on one chip).
NUM_TRIS_5M, WIDTH_5M, HEIGHT_5M = 5_000_000, 3840, 2160
# The card's INT32 rate: 64 lanes a clock on each of 132 SMs at 1.98 GHz.
PEAK_INT32_OPS = 64 * 132 * 1.98e9
# Operations of the build functions.  morton, a point: per axis a subtract,
# multiply, max, min, multiply and convert (6), per expand 8, two shifts and
# two ors.  radix: a delta evaluation that loads a code (range test, xor,
# compare, clz and the index tie-break) about 10, a search step around it
# (candidate, index, compare, select) about 6, counted over the steps of
# Karras's search (exponential, then binary), which the function needs,
# not over the kernel's fixed 62-step ladder.
MORTON_OPS = 3 * 6 + 3 * 8 + 4
# flushed_ms's spin between the flush and the timed launch: ~100 us at the
# card's 1.98 GHz, longer than the host takes to enqueue the launch.
FLUSH_SPIN_CYCLES = 200_000
RADIX_DELTA_OPS, RADIX_STEP_OPS = 10, 6
# morton's edge inputs ([treebuild_parity] morton_edges): a point count
# below, at and past a whole vector of points, and a ragged one past 2^20.
MORTON_EDGE_N, MORTON_EDGE_SEED = (1, 2, 3, 5, (1 << 20) + 3), 5
# [area]: the generated scenes carry no emitters, so AREA_EMITTERS of their
# triangles (a seeded choice) get radiance AREA_LE; AREA_SAMPLES emitter
# samples a frame (8,355,840 area shadow rays at 1920x1088), drawn from a
# generator seeded AREA_SEED (RenderConfig.light_seed).
AREA_EMITTERS, AREA_LE, AREA_SAMPLES, AREA_SEED = 64, 8.0, 4, 11
# [spp]: jittered samples a pixel with the area lights (tpurt's converged
# soft shadows: render_image's spp > 1 with light_samples > 0).
SPP = 4
# [segsum]: tpurt's five id patterns (tests/grad/test_gather_grad.py) at
# 2^20 rows of 3 columns into its 257 table rows, made from a numpy seed;
# the gather backward's default is 'segsum' (tpurt's) while its fit step is
# at most SEGSUM_RULE x the 'scatter' step, on [fit]'s and [fit_bin]'s
# problems.
SEGSUM_PATTERN_ROWS, SEGSUM_PATTERN_V, SEGSUM_PATTERN_SEED = 1 << 20, 257, 7
SEGSUM_RULE = 1.03
# The launches of one segment_accumulate call, the sort aside and the
# memset included, on every [segsum] input but above_rule (the fits' block
# counts: the carry in one CTA a column).
SEGSUM_MAX_LAUNCHES = 4
# device_launches: the profiler window's host waits on each side (s), tried
# in turn until both marker kernels are seen, and the markers' length.  The
# profiler places device events on the host's clock with an offset that
# grows over a process's life, and drops those that land past its window's
# end: profile_fit waits the last of these after its step too.
LAUNCH_COUNT_WAITS = (0.01, 0.1, 1.0)
LAUNCH_MARK_CYCLES = 1000


KERNEL_NAMES = ("closest8_kernel", "occluded8_kernel", "knear8_kernel",
                "closest_bin_kernel", "occluded_bin_kernel", "knear_bin_kernel",
                "morton_kernel", "radix_kernel", "segsum_scan_kernel", "segsum_carry_kernel",
                "segsum_carry_pass", "segsum_ends_kernel", "packet_closest_kernel",
                "packet_occluded_kernel", "packet_knear_kernel")
WALK_KERNELS = ("closest8", "occluded8", "knear8", "closest_bin", "occluded_bin", "knear_bin")
# The packet engine's hard-frame kernels, which [walk_ab] also times.
PACKET_WALKS = ("packet_closest", "packet_occluded")
# The redesigned kernels, which [build] fails on if ptxas reports a spill.
NO_SPILL = ("knear8", "knear_bin", "closest8", "closest_bin", "occluded8", "occluded_bin",
            "radix", "morton", "segsum", "packet")
# Each kernel engine's hard-frame kernels (closest hit, any hit) and its
# closest-hit call as render_rays makes it.
HARD_KERNELS = {
    "wide8": (("closest8", "occluded8"),
              lambda rays, tr: k8.traverse_wide8(rays, tr.wide, shade_out=True)),
    "binary": (("closest_bin", "occluded_bin"),
               lambda rays, tr: kb.traverse_packed(rays, tr.packed)),
    "packet": (("packet_closest", "packet_occluded"),
               lambda rays, tr: kp.traverse_packet(rays, tr.packed))}
# Each ring engine's k-nearest kernel.
KNEAR_KERNEL = {"wide8": "knear8", "binary": "knear_bin", "packet": "packet_knear"}


def ptxas_report(log_path: str) -> dict:
    """Each kernel instance's registers and spill-store bytes, from the
    build's ptxas -v report."""
    out, cur = {}, None
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                name = next((k for k in KERNEL_NAMES if k in m.group(1)), None)
                tmpl = re.search(r"kernelIL[ib](\d+)E", m.group(1))
                cur = None if name is None else name + (f"<{tmpl.group(1)}>" if tmpl else "")
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and cur:
                out.setdefault(cur, {})["spill_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str, **kw) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def golden_check(img: torch.Tensor, name: str, frac: float, atol: float = 2e-3):
    """tests/golden/test_golden.py's _check: at most `frac` of pixels off by
    more than `atol` in any channel."""
    ref = np.load(os.path.join(HERE, "tests", "golden", name))
    img = img.cpu().numpy()
    if img.shape != ref.shape:
        fail(f"{name}: shape {img.shape} != {ref.shape}")
    bad = float((np.abs(img - ref).max(axis=-1) > atol).mean())
    if bad > frac:
        fail(f"{name}: {bad:.5f} of pixels differ (> {frac})")
    return bad


def goldens(dev, method: str) -> dict:
    """Cornell 64^2, bunny-3K 48^2 and cornell soft 48^2 rendered on the card
    through `method`, against tpurt's reference images at its engine
    threshold: the fraction of pixels off in each."""
    sc, cm = make_cornell_box(device=dev)
    sb, cb = make_bunny_scene(num_tris=3000, device=dev)

    def at(cam, res):
        return dataclasses.replace(cam, width=res, height=res)

    return {f"cornell_{method}_bad": golden_check(
                render(sc, at(cm, 64), method=method), "cornell_brute_64.npy", 0.003),
            f"bunny3k_{method}_bad": golden_check(
                render(sb, at(cb, 48), method=method), "bunny3k_packet_48.npy", 0.003),
            f"cornell_soft_{method}_bad": golden_check(
                render(sc, at(cm, 48), method=method, **SOFT), "cornell_soft_48.npy", 0.003)}


def morton_rays(cam: Camera) -> Rays:
    """Primary rays of the full frame in Morton pixel order (bench.py's
    order: a warp's rays fall on one small screen tile)."""
    rays = gen_primary_rays(cam)
    perm = torch.as_tensor(pixel_morton_perm(cam.height, cam.width)[0],
                           device=rays.o.device)
    return Rays(o=rays.o[perm].contiguous(), d=rays.d[perm].contiguous())


def rays_slice(rays: Rays, sl) -> Rays:
    return Rays(o=rays.o[sl].contiguous(), d=rays.d[sl].contiguous())


def chunked(fn, n: int):
    """Run fn(lo, hi) -> tuple of tensors over consecutive PARITY_CHUNK-ray
    chunks of n rays.  Returns the outputs concatenated and the device
    milliseconds of the whole loop (CUDA events)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    parts = [fn(lo, min(lo + PARITY_CHUNK, n)) for lo in range(0, n, PARITY_CHUNK)]
    end.record()
    torch.cuda.synchronize()
    return [torch.cat(xs) for xs in zip(*parts)], start.elapsed_time(end)


def parity(view: str, tracer: Tracer, frame: Rays, count: bool = False) -> dict:
    """Both kernels against their twins on every ray of the Morton-ordered
    frame and on the shadow rays built from its hits as _shade_layer builds
    them.  The twins run in chunks of the frame (their row gathers are
    (rays, 8 * max_rows, 128) f32); their loop is timed as plain_ms.  Fails
    on more than MAX_MISMATCH_FRAC of ids differing, on any value of an
    agreeing ray off by more than MAX_ABS_ERR, and on any differing blocked
    flag (strict_flags).  count: run the twins once more, untimed, counting
    their walks for the bounds."""
    wide, n = tracer.wide, frame.o.shape[0]
    hk, shk = k8.traverse_wide8(frame, wide, shade_out=True)

    def closest_twin(lo: int, hi: int, stats=None):
        h, sh = k8.traverse_wide8_ref(rays_slice(frame, slice(lo, hi)), wide,
                                      shade_out=True, stats=stats)
        return (h.t, h.u, h.v, h.tri, *sh)

    ref, plain_c = chunked(closest_twin, n)
    hr, shr = Hit(t=ref[0], u=ref[1], v=ref[2], tri=ref[3]), tuple(ref[4:])
    same = hk.tri == hr.tri
    id_bad = int((~same).sum())
    errs = {k: max_abs(a[same], b[same]) for k, a, b in (
        ("t", hk.t, hr.t), ("u", hk.u, hr.u), ("v", hk.v, hr.v),
        ("albedo", shk[0], shr[0]), ("emission", shk[1], shr[1]),
        ("normal", shk[2], shr[2]))}
    p, nrm, _, _ = hit_surface(tracer, frame, hr, shr)
    sh_rays, t_sh = shadow_rays(tracer.scene, p, nrm, hr.valid)
    n_sh = sh_rays.o.shape[0]
    bk = k8.occluded_wide8(sh_rays, wide, t_sh)
    def occluded_twin(lo: int, hi: int, stats=None):
        return (k8.occluded_wide8_ref(rays_slice(sh_rays, slice(lo, hi)), wide,
                                      t_sh[lo:hi], stats=stats),)

    (br,), plain_o = chunked(occluded_twin, n_sh)
    blk_bad = int((bk != br).sum())
    phase("parity", view=view, rays=n, shadow_rays=n_sh,
          hit_frac=f"{float(hr.valid.float().mean()):.4f}",
          id_mismatches=id_bad, blocked_mismatches=blk_bad,
          blocked_frac=f"{float(br.float().mean()):.4f}",
          **{f"max_abs_{k}": repr(v) for k, v in errs.items()},
          closest8_plain_ms=f"{plain_c:.1f}", occluded8_plain_ms=f"{plain_o:.1f}")
    if id_bad > MAX_MISMATCH_FRAC * n:
        fail(f"closest8 ({view}): {id_bad} id mismatches against its twin")
    strict_flags("parity", view, "occluded8", wide, sh_rays, bk, br)
    for k, v in errs.items():
        if not v <= MAX_ABS_ERR:
            fail(f"closest8 ({view}): max |{k} - twin's| = {v!r} > {MAX_ABS_ERR}")
    out = dict(sh_rays=sh_rays, t_sh=t_sh,
               plain_ms={"closest8": plain_c, "occluded8": plain_o},
               err={"closest8": max(errs.values()), "occluded8": float(blk_bad > 0)})
    if count:
        out["bound"] = {"closest8": bound(counted(closest_twin, n), n, 24, 52),
                        "occluded8": bound(counted(occluded_twin, n_sh), n_sh, 28, 1,
                                           WIDE_HALF)}
        for name, b in out["bound"].items():
            phase("bound", view=view, kernel=name, **b)
    return out


def strict_flags(name: str, view: str, kernel: str, tree, rays: Rays, got: torch.Tensor,
                 ref: torch.Tensor) -> None:
    """An any-hit kernel's flags against its twin's: the flag does not
    depend on the visit order, so every ray must agree.  Each differing ray
    is printed (differing_rays) and fails the script at its end; more than
    MAX_MISMATCH_FRAC of them fails it now."""
    bad = int((got != ref).sum())
    if not bad:
        return
    differing_rays(view, kernel, tree, "twin", rays, (got,), (ref,), phase_name=name)
    FAILURES.append(f"{kernel} ({view}): {bad} blocked flags differ from the twin's")
    if bad > MAX_MISMATCH_FRAC * got.numel():
        fail(FAILURES[-1])


def both_bounds(name: str, view: str, kernel: str, walks: dict, n_rays: int, in_bytes: int,
                out_bytes: int) -> dict:
    """A kernel's bound from each walk's counts where its visit order changed
    (walks: {"near_first": (counts, layout), "escape": (counts, layout)}, the
    binary kernels' order and the parent commit's), each printed; returns
    the smaller, the least work the function needs, with both beside it."""
    each = {walk: bound(c, n_rays, in_bytes, out_bytes, layout)
            for walk, (c, layout) in walks.items()}
    for walk, b in each.items():
        phase(name, view=view, kernel=kernel, walk=walk, **b)
    least = min(each.values(), key=lambda b: b["bound_ms"])
    return dict(least, **{f"{walk}_bound_ms": b["bound_ms"] for walk, b in each.items()})


def subset_timing(wide, frame: Rays, par: dict) -> None:
    """Kernel and twin milliseconds on every k-th ray of the frame
    (SUBSET_RAYS of them) and their shadow rays."""
    n = frame.o.shape[0]
    step = n // SUBSET_RAYS
    sub = rays_slice(frame, slice(None, step * SUBSET_RAYS, step))
    sh = par["sh_rays"]
    keep = torch.arange(0, step * SUBSET_RAYS, step, device=frame.o.device)
    keep = (keep[None] + n * torch.arange(sh.o.shape[0] // n, device=keep.device)[:, None]
            ).reshape(-1)  # the same rays' shadow rays, light-major
    sh_sub, t_sub = rays_slice(sh, keep), par["t_sh"][keep].contiguous()
    ms = {"closest8": cuda_ms(lambda: k8.traverse_wide8(sub, wide, shade_out=True)),
          "occluded8": cuda_ms(lambda: k8.occluded_wide8(sh_sub, wide, t_sub))}
    plain = {"closest8": cuda_ms(lambda: k8.traverse_wide8_ref(sub, wide, shade_out=True),
                                 iters=2, warmup=1),
             "occluded8": cuda_ms(lambda: k8.occluded_wide8_ref(sh_sub, wide, t_sub),
                                  iters=2, warmup=1)}
    phase("subset_timing", rays=SUBSET_RAYS,
          **{f"{k}_ms": f"{ms[k]:.4f}" for k in ms},
          **{f"{k}_plain_ms": f"{plain[k]:.4f}" for k in plain})


def frame_timing(view: str, tracer: Tracer, frame: Rays, par: dict) -> dict:
    """Full-frame kernel milliseconds and the whole hard frame's rays/s;
    shading is the frame minus the two kernels."""
    wide, n = tracer.wide, frame.o.shape[0]
    sh_rays, t_sh = par["sh_rays"], par["t_sh"]
    ms = {"closest8": cuda_ms(lambda: k8.traverse_wide8(frame, wide, shade_out=True)),
          "occluded8": cuda_ms(lambda: k8.occluded_wide8(sh_rays, wide, t_sh))}
    total = cuda_ms(lambda: render_rays(tracer, frame))
    phase("timing", view=view, rays=n, shadow_rays=sh_rays.o.shape[0],
          closest8_ms=f"{ms['closest8']:.4f}", occluded8_ms=f"{ms['occluded8']:.4f}",
          shading_ms_derived=f"{total - ms['closest8'] - ms['occluded8']:.4f}",
          frame_ms=f"{total:.4f}", rays_per_s=f"{n / (total * 1e-3):.1f}")
    return dict(ms, frame=total)


def device_spans(prof):
    """A profile's device kernels: (events, busy, window, total) in µs, where
    busy is the union of their intervals, window runs from the first one's
    start to the last one's end and total sums their durations.  The
    device-side copies of record_function ranges are not kernels: each spans
    its range's kernels and the gaps between them."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    if not spans:
        return events, 0.0, 0.0, 0.0
    busy, end = 0.0, spans[0][0]
    for s, e in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return events, busy, end - spans[0][0], sum(e - s for s, e in spans)


def device_launches(fn) -> dict:
    """The device work that one call of fn puts on the card, as
    torch.profiler sees it: {kernel or memset name: count}, each a launch.
    The call runs between two marker kernels (torch.cuda._sleep) in a
    profiler window padded by host waits: the profiler keeps only the
    device events that fall inside its window by its own clock, so the
    count is taken only when both markers are seen, the window widening
    over LAUNCH_COUNT_WAITS; empty if they never are."""
    from torch.profiler import ProfilerActivity, profile

    for wait in LAUNCH_COUNT_WAITS:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(wait)
            torch.cuda._sleep(LAUNCH_MARK_CYCLES)
            fn()
            torch.cuda._sleep(LAUNCH_MARK_CYCLES)
            torch.cuda.synchronize()
            time.sleep(wait)
        counts = {}
        for e in device_spans(prof)[0]:
            name = re.split(r"[(<]", e.name.replace("(anonymous namespace)::", "")
                            .removeprefix("void "))[0].strip()
            counts[name] = counts.get(name, 0) + 1
        marks = sum(c for name, c in counts.items() if name.endswith("spin_kernel"))
        if marks == 2:
            return {name: c for name, c in counts.items() if not name.endswith("spin_kernel")}
    return {}


def preceding_memsets(events: list, kernel: str) -> float:
    """The device time (µs) of the memsets that run just before each of
    `kernel`'s launches (one stream: the device event before it in start
    order), as segment_accumulate's memset of its output runs just before
    its scan."""
    order = sorted(events, key=lambda e: e.time_range.start)
    return sum(p.time_range.end - p.time_range.start for p, e in zip(order, order[1:])
               if kernel in e.name and p.name.startswith("Memset"))


def profile_frame(tracer: Tracer, cam: Camera, frame: Rays, frames: int = 5,
                  name: str = "profile") -> None:
    """Where a hard frame's device time goes (torch.profiler over `frames`
    back-to-back render_rays calls): the engine's two kernels' shares of
    device time, the torch glue's share, and the idle share of the device
    window (first device event's start to the last one's end).  Also the
    closest-hit kernel on the frame's rays in row-major order against Morton
    order."""
    from torch.profiler import ProfilerActivity, profile

    (closest, occluded), run = HARD_KERNELS[tracer.method]
    render_rays(tracer, frame)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            render_rays(tracer, frame)
        torch.cuda.synchronize()
    dev_events, busy, window, total = device_spans(prof)
    row_major = gen_primary_rays(cam)
    order = {f"{closest}_morton_ms": f"{cuda_ms(lambda: run(frame, tracer)):.4f}",
             f"{closest}_row_major_ms": f"{cuda_ms(lambda: run(row_major, tracer)):.4f}"}
    if not dev_events:
        phase(name, device_time="not measured (the profiler saw no device event)", **order)
        return
    share = {k: sum(e.time_range.end - e.time_range.start for e in dev_events
                    if f"{k}_kernel" in e.name)
             for k in (closest, occluded)}
    glue = total - sum(share.values())
    phase(name, frames=frames, device_window_ms=f"{window / 1e3 / frames:.4f}",
          device_busy_ms=f"{busy / 1e3 / frames:.4f}", idle_share=f"{1 - busy / window:.4f}",
          **{f"{k}_share": f"{v / total:.4f}" for k, v in share.items()},
          glue_share=f"{glue / total:.4f}", **order)


def counted(twin, n: int) -> dict:
    """A twin's walk counts over all n rays, from an untimed pass in
    PARITY_CHUNK chunks (twin(lo, hi, stats) accumulates into stats)."""
    stats = {}
    for lo in range(0, n, PARITY_CHUNK):
        twin(lo, min(lo + PARITY_CHUNK, n), stats)
    return k8.walk_counts(stats)


def bound(counts: dict, n_rays: int, in_bytes: int, out_bytes: int,
          layout: dict = WIDE) -> dict:
    """The least time the card could take for a walk kernel's work on this
    run's data: the larger of its bytes over PEAK_BYTES_S (each ray's inputs
    read and outputs written once, each distinct node and leaf row the walks
    touch read once) and its operations over PEAK_F32_OPS (layout's slab
    tests per node visit and Möller–Trumbore tests per counted row), from the
    twin's walk counts (the twins walk in the kernels' order)."""
    nbytes = (n_rays * (in_bytes + out_bytes)
              + layout["node_bytes"] * counts["distinct_nodes"]
              + layout["row_bytes"] * counts["distinct_rows"])
    ops = (layout["slabs"] * SLAB_OPS * counts["visits"]
           + layout["row_tests"] * MT_OPS * counts["rows"])
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_OPS * 1e3
    return dict(counts, bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def wide8_knear(wide):
    """knear8 and its twin over `wide`, as (kernel(rays, k, t_max),
    twin(rays, k, t_max, stats))."""
    return (lambda r, k, tm: k8.k_nearest_wide8(r, wide, k, BAND, t_max=tm),
            lambda r, k, tm, stats=None: k8.k_nearest_wide8_ref(r, wide, k, BAND, t_max=tm,
                                                                stats=stats))


def bin_knear(packed):
    """knear_bin and its twin over `packed`, as wide8_knear's pair."""
    return (lambda r, k, tm: kb.k_nearest_ids_packed(r, packed, k, BAND, t_max=tm),
            lambda r, k, tm, stats=None: kb.k_nearest_ids_packed_ref(r, packed, k, BAND,
                                                                     t_max=tm, stats=stats))


@torch.no_grad()
def knear_call(out: dict, view: str, call: str, walks, tree, rays: Rays, k: int, t_max,
               count: bool, name: str = "knear_parity", kernel: str = "knear8",
               layout: dict = WIDE) -> torch.Tensor:
    """A k-nearest kernel against its twin (walks = (kernel, twin), over
    `tree`) on every ray of `rays`: the twin in PARITY_CHUNK chunks, timed as
    plain_ms, the wrapper's ms by CUDA events, the kernel's device ms from
    bare launches (launch_ms), and with `count` the bound from the twin's
    walk counts; stored in out[key][call].  Fails on more than
    MAX_MISMATCH_FRAC of rays with differing id lists.  Returns the twin's
    ids."""
    run, twin_fn = walks
    n_r = rays.o.shape[0]
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=rays.o.device)
    tm = tm.expand(n_r).contiguous()

    def twin(lo: int, hi: int, stats=None):
        return (twin_fn(rays_slice(rays, slice(lo, hi)), k, tm[lo:hi], stats),)

    got = run(rays, k, tm)
    (ref,), plain = chunked(twin, n_r)
    bad = int((got != ref).any(dim=1).sum())
    ms = cuda_ms(lambda: run(rays, k, tm), iters=5)
    dev_ms = launch_ms(this_library(), kernel, tree, [(rays, k, tm)])
    out["ms"][call], out["plain_ms"][call] = ms, plain
    out.setdefault("device_ms", {})[call] = dev_ms
    out["mismatch_frac"][call] = bad / n_r
    out.setdefault("inputs", {})[call] = (rays, k, tm)
    extra = {}
    if count:
        extra = out["bound"][call] = bound(counted(twin, n_r), n_r, 28, 4 * k, layout)
    phase(name, view=view, call=call, k=k, rays=n_r,
          id_list_mismatches=bad, filled_frac=f"{float((ref >= 0).float().mean()):.4f}",
          **{f"{kernel}_ms": f"{ms:.4f}", f"{kernel}_device_ms": f"{dev_ms:.4f}",
             f"{kernel}_plain_ms": f"{plain:.1f}"}, **extra)
    if bad > MAX_MISMATCH_FRAC * n_r:
        fail(f"{kernel} ({view}, {call}): {bad} id lists differ from the twin's")
    return ref


def occluder_call(table, scene, rays: Rays, ids: torch.Tensor):
    """The soft render's second k-nearest call from a chunk's layer ids: the
    shadow-candidate rays from layer 0's points and the pipeline's
    2 x segment t_max."""
    _, _, cand, t_seg = occluder_rays(soft_surface(table, rays, ids), scene.lights.pos)
    return cand, (2.0 * t_seg).contiguous()


def knear_parity(view: str, tracer: Tracer, frame: Rays, count: bool = False,
                 name: str = "knear_parity", kernel: str = "knear8") -> dict:
    """The tracer's k-nearest kernel (knear8 for wide8, knear_bin for
    binary) against its twin on every ray of the frame, in both of the soft
    render's calls: k = 4 on the primary rays with t_max = T_MAX, and k = 8
    on the shadow-candidate rays from layer 0's points."""
    tree, layout = ((tracer.packed, BIN) if tracer.method == "binary"
                    else (tracer.wide, WIDE))
    walks = bin_knear(tree) if tracer.method == "binary" else wide8_knear(tree)
    out = {"ms": {}, "plain_ms": {}, "mismatch_frac": {}, "bound": {}}
    kw = dict(name=name, kernel=kernel, layout=layout)
    with torch.no_grad():
        ids = knear_call(out, view, "layers", walks, tree, frame, SOFT["k_layers"], T_MAX,
                         count, **kw)
        cand, tm = occluder_call(tracer.table, tracer.scene, frame, ids)
        knear_call(out, view, "occluders", walks, tree, cand, SOFT["k_occ"], tm, count, **kw)
    return out


def knear_calls(run, table, scene, rays: Rays, chunks: int) -> dict:
    """The soft render's two k-nearest calls, as the fit makes them on each
    of `chunks` consecutive chunks of `rays`, as (rays, k, t_max) inputs by
    call; run(rays, k, t_max) computes the layer ids the occluder rays
    start from."""
    m = rays.o.shape[0] // chunks
    out = {"layers": [], "occluders": []}
    for c in range(chunks):
        chunk = rays_slice(rays, slice(c * m, (c + 1) * m))
        cand, tm = occluder_call(table, scene, chunk, run(chunk, SOFT["k_layers"], T_MAX))
        out["layers"].append((chunk, SOFT["k_layers"], T_MAX))
        out["occluders"].append((cand, SOFT["k_occ"], tm))
    return out


def knear_loop(run, calls: list):
    """fn() running a k-nearest implementation run(rays, k, t_max) over
    `calls` back to back, as the fit's chunk loop launches it."""
    return lambda: [run(*c) for c in calls]


@torch.no_grad()
def fit_knear(inv: InverseRenderer, scene, cam: Camera) -> dict:
    """knear8 as InverseRenderer.fit calls it: on the step's refit tree and
    the fit's row-major ray chunks.  Both calls on chunk 0 against the twin,
    with their bounds ([knear_parity] view=fit_chunk0); each call over the
    frame's FIT_CHUNKS chunks, the wrapper calls' ms (CUDA events) and the
    kernel's device ms (launch_ms); each call as one launch over the whole
    row-major frame, to tell the chunks' launch tails from the row-major
    order's incoherence; the refit's ms."""
    table = tri_table(scene.tris)
    refit_ms = cuda_ms(lambda: refit_wide_direct(inv.tracer0.wide, scene.tris, table=table),
                       iters=5)
    wide = refit_wide_direct(inv.tracer0.wide, scene.tris, table=table)
    rays = gen_primary_rays(cam)
    m = rays.o.shape[0] // FIT_CHUNKS
    out = {"ms": {}, "plain_ms": {}, "mismatch_frac": {}, "bound": {}, "frame_ms": {},
           "frame_device_ms": {}, "row_major_ms": {}, "row_major_device_ms": {}}
    chunk = rays_slice(rays, slice(0, m))
    walks = wide8_knear(wide)
    ids = knear_call(out, "fit_chunk0", "layers", walks, wide, chunk, SOFT["k_layers"], T_MAX,
                     True)
    cand, tm = occluder_call(table, scene, chunk, ids)
    knear_call(out, "fit_chunk0", "occluders", walks, wide, cand, SOFT["k_occ"], tm, True)
    run = walks[0]
    chunks = knear_calls(run, table, scene, rays, FIT_CHUNKS)
    whole = knear_calls(run, table, scene, rays, 1)
    for call in ("layers", "occluders"):
        out["frame_ms"][call] = cuda_ms(knear_loop(run, chunks[call]), iters=5)
        out["frame_device_ms"][call] = launch_ms(this_library(), "knear8", wide,
                                                 chunks[call])
        out["row_major_ms"][call] = cuda_ms(knear_loop(run, whole[call]), iters=5)
        out["row_major_device_ms"][call] = launch_ms(this_library(), "knear8", wide,
                                                     whole[call])
    out["wide"], out["chunks"], out["whole"] = wide, chunks, whole
    phase("fit_pieces", refit_ms=f"{refit_ms:.4f}", chunk_rays=m,
          **{f"knear8_{call}_{key}": f"{out[field][call]:.4f}"
             for call in ("layers", "occluders")
             for key, field in (("ms", "ms"), ("device_ms", "device_ms"),
                                ("frame_ms", "frame_ms"),
                                ("frame_device_ms", "frame_device_ms"),
                                ("row_major_frame_ms", "row_major_ms"),
                                ("row_major_frame_device_ms", "row_major_device_ms"))})
    return out


# ---------------------------------------------------------------------------
# The k-nearest kernels against a parent commit's (--parent)
# ---------------------------------------------------------------------------
def tree_csrc(name: str, root: str) -> str:
    """The kernel sources of another source tree (a checkout of the parent
    commit, or of a variant of these kernels) at `root`."""
    csrc = os.path.join(root, "src", "tpurt_torch", "kernels", "csrc")
    if not os.path.isdir(csrc):
        fail(f"--parent {name}={root}: no {csrc}")
    return csrc


def bind_tree(root: str, path: str) -> ctypes.CDLL:
    """The kernel library at `path`, built from the source tree at `root`,
    with its walk entry points bound for bare launches by the tree's own
    interface: each with a ray counter before the stream where its source
    takes one (persistent warps), none where it does not (one thread a ray,
    as in earlier commits or variants); a packet walk also with the node
    count before it where its source takes one."""
    csrc = tree_csrc("tree", root)
    lib = ctypes.CDLL(path)
    lib.counter, lib.nodes = {}, {}
    for kernel in WALK_KERNELS + PACKET_WALKS + ("packet_knear",):
        src = ("traverse.cu" if kernel.endswith("_bin") else
               "packet.cu" if kernel.startswith("packet") else "traverse8.cu")
        with open(os.path.join(csrc, src)) as f:
            text = f.read()
        fn = f"tpurt_{kernel}"
        sig = text[text.index(f"int {fn}("):].split("{", 1)[0]
        lib.counter[fn] = "int* next" in sig
        lib.nodes[fn] = "int num_nodes" in sig
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # each entry point's arguments up to its outputs, the outputs' count
    head = {"knear8": ([ptr] * 5 + [i32, i32, f32, i32, f32, f32], 1),
            "knear_bin": ([ptr] * 7 + [i32, f32, i32, f32, f32], 1),
            "closest8": ([ptr] * 4 + [i32, i32, f32], 7),
            "occluded8": ([ptr] * 5 + [i32, i32, f32], 1),
            "closest_bin": ([ptr] * 6 + [i32, f32], 4),
            "occluded_bin": ([ptr] * 7 + [i32, f32], 1),
            "packet_closest": ([ptr] * 6 + [i32, f32], 4),
            "packet_occluded": ([ptr] * 7 + [i32, f32], 1),
            "packet_knear": ([ptr] * 7 + [i32, f32, i32, f32, f32], 1)}
    for kernel, (args, outs) in head.items():
        fn = getattr(lib, f"tpurt_{kernel}")
        fn.argtypes = (args + [ptr] * outs + [i32] * lib.nodes[f"tpurt_{kernel}"]
                       + [ptr] * (lib.counter[f"tpurt_{kernel}"] + 1))
        fn.restype = i32
    lib.tpurt_morton.argtypes = [ptr, ptr, ptr, f32, i32, ptr, ptr]
    lib.tpurt_radix.argtypes = [ptr, i32] + [ptr] * 6
    lib.tpurt_morton.restype = lib.tpurt_radix.restype = i32
    # segsum: three entry points in a tree whose scan writes the scanned rows
    # (scan, carry, ends), two in one whose scan writes the output (scan,
    # carry with the ends)
    with open(os.path.join(csrc, "segsum.cu")) as f:
        lib.segsum_ends = "int tpurt_segsum_ends(" in f.read()
    i64 = ctypes.c_longlong
    if lib.segsum_ends:
        lib.tpurt_segsum_scan.argtypes = [ptr] * 3 + [i64, i32, i32, i32] + [ptr] * 3
        lib.tpurt_segsum_carry.argtypes = [ptr, ptr, i32, i32] + [ptr] * 5
        lib.tpurt_segsum_ends.argtypes = [ptr] * 4 + [i32, i32, ptr, ptr]
        lib.tpurt_segsum_ends.restype = i32
    else:
        lib.tpurt_segsum_scan.argtypes = [ptr] * 3 + [i64, i32, i32, i32] + [ptr] * 4
        lib.tpurt_segsum_carry.argtypes = [ptr, i32, i32, i32] + [ptr] * 6
    lib.tpurt_segsum_scan.restype = lib.tpurt_segsum_carry.restype = i32
    return lib


@functools.cache
def this_library() -> ctypes.CDLL:
    """This checkout's kernels (built by _build.load()), bound by bind_tree
    for bare launches."""
    return bind_tree(HERE, _build.library_path())


def parent_library(name: str, root: str, path: str) -> ctypes.CDLL:
    """Another source tree's kernel library at `path`, built by the port's
    loader from its csrc/ and bound by bind_tree; prints its walk kernels'
    ptxas report."""
    lib = bind_tree(root, path)
    report = {k: v for k, v in ptxas_report(path[:-3] + ".log").items()
              if k.startswith(WALK_KERNELS + PACKET_WALKS + ("radix",))}
    phase("tree", tree=name, root=root, lib=os.path.relpath(path, HERE),
          counter=json.dumps(lib.counter), ptxas=json.dumps(report, separators=(",", ":")))
    return lib


def walk_launch(lib: ctypes.CDLL, kernel: str, tree, rays: Rays, t_max=None,
                k: int | None = None):
    """lib's walk kernel (closest8, occluded8, knear8 over a WideBVH;
    closest_bin, occluded_bin, knear_bin, packet_closest, packet_occluded,
    packet_knear over a PackedBVH) on `rays` (t_max:
    the any-hit and k-nearest kernels' window, k: the k-nearest list
    length), its arguments and outputs made as the wrappers make them:
    (launch, out), where launch(counter) enqueues the kernel on the current
    stream (counter: a zeroed int32 for a kernel that takes one, made as the
    wrapper makes it when not given) and out is its outputs (closest: id, t,
    u, v and closest8's shading lanes; any hit: the flags; k-nearest: the
    (n, k) ids)."""
    def ptr(x: torch.Tensor) -> ctypes.c_void_p:
        return ctypes.c_void_p(x.data_ptr())

    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    n, dev = o.shape[0], o.device
    wide = isinstance(tree, WideBVH)
    tm = None
    head = ((ptr(tree.wrow), ptr(tree.tri_rows)) if wide else
            (ptr(tree.node_f32), ptr(tree.node_i32), ptr(tree.tri_rows), ptr(tree.tri_ids)))
    rows = (tree.max_rows,) if wide else ()
    t_min = ctypes.c_float(DEFAULT_T_MIN)
    fn = getattr(lib, f"tpurt_{kernel}")
    nodes = (tree.num_nodes,) if lib.nodes.get(f"tpurt_{kernel}") else ()
    if "closest" in kernel:
        f32 = dict(dtype=torch.float32, device=dev)
        t, u, v = (torch.empty(n, **f32) for _ in range(3))
        tri = torch.empty(n, dtype=torch.int32, device=dev)
        sh = [torch.empty((n, 3), **f32) for _ in range(3)] if wide else []
        out = (tri, t, u, v, *sh)
        args = (*head, ptr(o), ptr(d), n, *rows, t_min, ptr(t), ptr(u), ptr(v), ptr(tri),
                *(ptr(x) for x in sh), *nodes)
    else:
        tm = torch.as_tensor(t_max, dtype=torch.float32, device=dev).reshape(-1).expand(n)
        tm = tm.contiguous()
        if "knear" in kernel:
            out = (torch.empty((n, k), dtype=torch.int32, device=dev),)
            tail = (k, ctypes.c_float(-BAND), ctypes.c_float(1.0 + BAND))
        else:
            out = (torch.empty(n, dtype=torch.uint8, device=dev),)
            tail = ()
        args = (*head, ptr(o), ptr(d), ptr(tm), n, *rows, t_min, *tail, ptr(out[0]), *nodes)
    counted = lib.counter.get(f"tpurt_{kernel}", False)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launch(counter: torch.Tensor | None = None) -> None:
        if counted and counter is None:
            counter = torch.zeros(1, dtype=torch.int32, device=dev)
        err = fn(*args, *([ptr(counter)] if counted else []), stream)
        if err:
            fail(f"{kernel} failed to launch: {err}")

    launch.keep = (o, d, tm, out, args)  # what the kernel reads and writes lives as long
    return launch, out


def knear_kernel(tree) -> str:
    return "knear8" if isinstance(tree, WideBVH) else "knear_bin"


def parent_knear(lib: ctypes.CDLL, tree, kernel: str | None = None):
    """run(rays, k, t_max) through another tree's k-nearest kernel (default:
    the per-ray one of tree's layout), a fresh counter for every launch, as
    the wrappers call them."""
    def run(rays: Rays, k: int, t_max) -> torch.Tensor:
        launch, (ids,) = walk_launch(lib, kernel or knear_kernel(tree), tree, rays, t_max, k)
        launch()
        return ids

    return run


def launch_ms(lib: ctypes.CDLL, kernel: str, tree, calls: list, passes: int = 5) -> float:
    """The device ms of one pass of lib's `kernel` over `calls` ((rays, k,
    t_max) each; k None but for the k-nearest kernels), launched bare: CUDA
    events around `passes` passes after a warm one, every argument, output
    and zeroed ray counter made before the first event, so the events time
    the kernels and the gaps between their launches, not the wrapper's
    checks, allocations and counter fill.  (torch.profiler drops the kernel
    events of whole sessions now and then, so it does not time these
    kernels.)"""
    launches = [walk_launch(lib, kernel, tree, rays, t_max, k)[0] for rays, k, t_max in calls]
    dev = calls[0][0].o.device
    counters = torch.zeros(((passes + 1) * len(calls), 1), dtype=torch.int32, device=dev)
    for i, launch in enumerate(launches):
        launch(counters[i])
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for p in range(1, passes + 1):
        for i, launch in enumerate(launches):
            launch(counters[p * len(calls) + i])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / passes


def morton_sorted(run):
    """run(rays, k, t_max) behind a sort of the rays by the Morton code of
    their origin, then of their direction (the port's morton kernel,
    torch.sort as glue), the ids scattered back into the caller's order: a
    lever measured by [knear_ab] and not used by the port."""
    def code(p: torch.Tensor) -> torch.Tensor:
        lo, hi = p.amin(0), p.amax(0)
        return tb.morton_codes(p, lo, tb.inv_extent(lo, hi))

    def sorted_run(rays: Rays, k: int, t_max) -> torch.Tensor:
        o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
        perm = torch.sort((code(o) << 30) | code(d)).indices
        tm = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(o.shape[0])
        ids = run(Rays(o=o[perm], d=d[perm]), k, tm[perm])
        return torch.empty_like(ids).index_copy_(0, perm, ids)

    return sorted_run


@torch.no_grad()
def knear_ab(kernel: str, tree, runs: dict, libs: dict, cells: dict) -> dict:
    """A k-nearest kernel against other trees' (the parent's first) on each
    cell (name -> list of (rays, k, t_max) calls over `tree`, run back to
    back): every call's ids equal (fails otherwise), then in turns other,
    new, new, other for each other tree, the whole cell's ms by CUDA events
    around the calls and, for each tree with a library, the kernel's device
    ms from bare launches (launch_ms).  runs: {"new": run, name: run, ...},
    each run(rays, k, t_max); libs: {"new": lib, name: lib, ...}."""
    out = {}
    for cell, calls in cells.items():
        fns = {name: knear_loop(run, calls) for name, run in runs.items()}
        got = {name: fn() for name, fn in fns.items()}
        bad = {name: sum(int((a != b).any(dim=1).sum()) for a, b in zip(got["new"], ids))
               for name, ids in got.items() if name != "new"}
        del got
        turns = [(name, cuda_ms(fns[name], iters=5))
                 for other in runs if other != "new" for name in (other, "new", "new", other)]
        dev_turns = [(name, launch_ms(libs[name], kernel, tree, calls))
                     for other in libs if other != "new"
                     for name in (other, "new", "new", other)] or [
            ("new", launch_ms(libs["new"], kernel, tree, calls))]
        mean = lambda ts, name: float(np.mean([t for s, t in ts if s == name]))  # noqa: E731
        out[cell] = {name: dict(ms=mean(turns, name),
                                device_ms=mean(dev_turns, name) if name in libs else None)
                     for name in runs}
        phase("knear_ab", kernel=kernel, cell=cell, launches=len(calls),
              rays=sum(c[0].o.shape[0] for c in calls),
              id_list_mismatches=json.dumps(bad),
              turns=json.dumps([[s, round(t, 4)] for s, t in turns]),
              device_turns=json.dumps([[s, round(t, 4)] for s, t in dev_turns]))
        if any(bad.values()):
            fail(f"{kernel} ({cell}): id lists differ from another tree's kernel: {bad}")
    return out


# ---------------------------------------------------------------------------
# The walk kernels against other trees' ([walk_ab])
# ---------------------------------------------------------------------------
def wrapper_call(kernel: str, tree, rays: Rays, t_max=None):
    """fn() calling this checkout's wrapper of `kernel` as the hard render
    calls it."""
    return {"closest8": lambda: k8.traverse_wide8(rays, tree, shade_out=True),
            "occluded8": lambda: k8.occluded_wide8(rays, tree, t_max),
            "closest_bin": lambda: kb.traverse_packed(rays, tree),
            "occluded_bin": lambda: kb.occluded_packed(rays, tree, t_max),
            "packet_closest": lambda: kp.traverse_packet(rays, tree),
            "packet_occluded": lambda: kp.occluded_packet(rays, tree, t_max)}[kernel]


@torch.no_grad()
def walk_ab(libs: dict, cells: dict) -> dict:
    """The walk kernels (closest hit and any hit) of this checkout ("new")
    against other trees' (libs: {"new": lib, name: lib, ...}: the parent
    commit's, variants) on each cell (name -> (kernel, tree, rays, t_max)):
    every tree's ids or flags equal to this build's, and where ids agree
    t, u, v and shading lanes bitwise; a tree that differs fails the script
    at its end, after the differing rays are printed (differing_rays),
    unless each differing id is explained there (a flag never is).
    Then in turns other, new, new, other for each other tree, the call's ms
    by CUDA events (this build through its wrapper, the others with their
    outputs made a call, as a wrapper makes them) and the kernel's device ms
    from bare launches (launch_ms).  Without other trees, this build's alone.
    A packet kernel's cell is held bitwise: a packet's hits are its own, so
    every ray whose id, flag or t/u/v bits differ fails, none explained."""
    out = {}
    for cell, (kernel, tree, rays, t_max) in cells.items():
        got = {}
        for name, lib in libs.items():
            launch, res = walk_launch(lib, kernel, tree, rays, t_max)
            launch()
            got[name] = res
        torch.cuda.synchronize()
        ref = got.pop("new")
        bad = {name: int((res[0] != ref[0]).sum()) for name, res in got.items()}
        unexplained = {name: differing_rays(cell, kernel, tree, name, rays, ref, res)
                       for name, res in got.items() if bad[name]}
        err = {name: max([0.0] + [max_abs(a[res[0] == ref[0]], b[res[0] == ref[0]])
                                  for a, b in zip(res[1:], ref[1:])])
               for name, res in got.items()}
        packet = kernel in PACKET_WALKS
        bits = {name: differing_bits(ref, res) for name, res in got.items()} if packet else {}
        del got, ref

        def call(name):
            if name == "new":
                return wrapper_call(kernel, tree, rays, t_max)
            return lambda: walk_launch(libs[name], kernel, tree, rays, t_max)[0]()

        order = [name for other in libs if other != "new"
                 for name in (other, "new", "new", other)] or ["new"]
        turns = [(name, cuda_ms(call(name), iters=5)) for name in order]
        dev_turns = [(name, launch_ms(libs[name], kernel, tree, [(rays, None, t_max)],
                                      passes=10)) for name in order]
        mean = lambda ts, name: float(np.mean([t for s, t in ts if s == name]))  # noqa: E731
        out[cell] = {name: dict(ms=mean(turns, name), device_ms=mean(dev_turns, name))
                     for name in libs}
        phase("walk_ab", kernel=kernel, cell=cell, rays=rays.o.reshape(-1, 3).shape[0],
              mismatches=json.dumps(bad), max_abs_err=json.dumps(err),
              **({"differing_bits": json.dumps(bits)} if packet else {}),
              **{f"{name}_ms": f"{v['ms']:.4f}" for name, v in out[cell].items()},
              **{f"{name}_device_ms": f"{v['device_ms']:.4f}" for name, v in out[cell].items()},
              turns=json.dumps([[s, round(t, 4)] for s, t in turns]),
              device_turns=json.dumps([[s, round(t, 4)] for s, t in dev_turns]))
        if any(unexplained.get(name) or err[name] > MAX_ABS_ERR or bits.get(name)
               for name in bad):
            FAILURES.append(f"{kernel} ({cell}): outputs differ from a --parent tree's "
                            f"kernel: {bad} ids ({unexplained} unexplained), {err}, "
                            f"{bits} rays with differing bits")
    return out


def differing_bits(ref: tuple, res: tuple) -> int:
    """The rays on which any output of res (ids or flags, t, u, v) differs
    from ref's in any bit."""
    n = ref[0].shape[0]
    differ = torch.zeros(n, dtype=torch.bool, device=ref[0].device)
    for a, b in zip(ref, res):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        differ |= (a != b).reshape(n, -1).any(dim=1)
    return int(differ.sum())


# Failures that stop the script at its end, after every measurement.
FAILURES = []
# Differing rays printed a cell at most (all are counted).
PRINTED_RAYS = 64


def differing_rays(cell: str, kernel: str, tree, name: str, rays: Rays, ref: tuple,
                   res: tuple, phase_name: str = "walk_ab") -> int:
    """The rays on which tree `name`'s ids or flags differ from this
    build's, the first PRINTED_RAYS each printed under phase_name as the
    bits of its floats (float.hex) with both kernels' id (or flag) and t.
    Only a closest_bin ray can be explained (ROADMAP P6): its visit
    order changed, and tpurt's smooth inverse det / (det^2 + 1e-12) shrinks
    t where |det| is near 1e-6, so a hit can lie before its own triangle's
    box along the ray, and whether a walk takes it then depends on the
    order.  Such a ray is explained when both hold: each kernel returns its
    own walk's id (the near-first twin this build's, the escape twin the
    parent commit's), and the better of the two hits lies outside its
    triangle's box (outside_box).  Any other differing ray, closest8's
    included, is not, nor any any-hit flag: the any-hit walks' window never
    shrinks, so their flags do not depend on the order.  Returns the number
    of differing rays not explained."""
    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    idx = torch.nonzero(res[0] != ref[0])[:, 0]
    twins = None
    if kernel == "closest_bin":
        sub = Rays(o=o[idx].contiguous(), d=d[idx].contiguous())
        twins = (kb.traverse_packed_ref(sub, tree), closest_walk(sub, kb.PackedLayout(tree)))
    unexplained = 0
    for j, i in enumerate(idx.tolist()):
        ids = (int(ref[0][i]), int(res[0][i]))
        twin_ids = outside = None
        if twins is not None:
            twin_ids = (int(twins[0].tri[j]), int(twins[1].tri[j]))
            outside = hit_outside_box(tree, o[i], d[i],
                                      *min((float(ref[1][i]), ids[0]), (float(res[1][i]), ids[1])))
        explained = twin_ids == ids and bool(outside)
        unexplained += not explained
        if j >= PRINTED_RAYS:
            continue
        phase(phase_name, cell=cell, tree=name, differing_ray=i,
              o=json.dumps([float(x).hex() for x in o[i].tolist()]),
              d=json.dumps([float(x).hex() for x in d[i].tolist()]),
              new_id=ids[0], other_id=ids[1],
              new_t=float(ref[1][i]).hex() if len(ref) > 1 else None,
              other_t=float(res[1][i]).hex() if len(res) > 1 else None,
              twin_ids=json.dumps(twin_ids), outside_box=outside, explained=explained)
    return unexplained


def hit_outside_box(packed, o: torch.Tensor, d: torch.Tensor, t: float, tri: int) -> bool:
    """Whether t lies outside the slab interval of triangle `tri`'s own box
    (from its packed row) along the ray, by the binary slab test."""
    row, slot = (int(x) for x in torch.nonzero(packed.tri_ids == tri)[0])
    v0, e1, e2 = packed.tri_rows[row, 9 * slot:9 * slot + 9].reshape(3, 3)
    corners = torch.stack([v0, v0 + e1, v0 + e2])
    inv = safe_inv(d)
    t0, t1 = (corners.amin(0) - o) * inv, (corners.amax(0) - o) * inv
    near = float(torch.minimum(t0, t1).max().clamp_min(DEFAULT_T_MIN))
    far = float(torch.maximum(t0, t1).min())
    return not near <= t <= far


# ---------------------------------------------------------------------------
# The binary-BVH engine
# ---------------------------------------------------------------------------
def bin_tracer(view: str, scene, band: float = 0.0) -> Tracer:
    """The binary engine's tracer, built stage by stage as make_tracer
    builds it ([scene_bin]): the LBVH with its DFS thread, then the packed
    layout with rows for the bound max_cut_leaves."""
    bvh, s_lbvh = sync_time(lambda: build_lbvh(scene.tris, band=band))
    bound_leaves = max_cut_leaves(scene.num_tris, bvh.leaf_size)
    packed, s_pack = sync_time(lambda: pack_bvh(scene.tris, bvh, bound_leaves))
    phase("scene_bin", view=view, band=band, tris=scene.num_tris, lbvh_s=f"{s_lbvh:.3f}",
          pack_s=f"{s_pack:.3f}", nodes=packed.num_nodes,
          node_bytes=packed.node_f32.nbytes + packed.node_i32.nbytes,
          leaf_rows=packed.num_leaves, tri_rows_bytes=packed.tri_rows.nbytes,
          tri_ids_bytes=packed.tri_ids.nbytes, bound_leaves=bound_leaves,
          live_leaves=int(bvh.flat_is_leaf.sum()))
    return Tracer(scene=scene, bvh=bvh, packed=packed, table=tri_table(scene.tris),
                  method="binary")


def bin_parity(view: str, tracer: Tracer, frame: Rays, count: bool = False,
               of_rays: int | None = None) -> dict:
    """closest_bin and occluded_bin against their twins on every ray of the
    Morton-ordered frame and on the shadow rays built from its hits as
    _shade_layer builds them (surface from the table); the twins in
    PARITY_CHUNK chunks, timed as plain_ms.  Fails on more than
    MAX_MISMATCH_FRAC of ids differing, on any t, u, v of an agreeing ray
    off by more than MAX_ABS_ERR, and on any differing blocked flag
    (strict_flags).  count: the twins' walk counts and the kernels' bounds
    ([bound_bin]), each from the near-first and the escape walk.  of_rays:
    the size of the frame that `frame` is the first part of, printed beside
    it."""
    packed, n = tracer.packed, frame.o.shape[0]
    hk = kb.traverse_packed(frame, packed)

    def closest_twin(lo: int, hi: int, stats=None):
        h = kb.traverse_packed_ref(rays_slice(frame, slice(lo, hi)), packed, stats=stats)
        return (h.t, h.u, h.v, h.tri)

    ref, plain_c = chunked(closest_twin, n)
    hr = Hit(t=ref[0], u=ref[1], v=ref[2], tri=ref[3])
    same = hk.tri == hr.tri
    id_bad = int((~same).sum())
    errs = {k: max_abs(a[same], b[same]) for k, a, b in (
        ("t", hk.t, hr.t), ("u", hk.u, hr.u), ("v", hk.v, hr.v))}
    p, nrm, _, _ = hit_surface(tracer, frame, hr)
    sh_rays, t_sh = shadow_rays(tracer.scene, p, nrm, hr.valid)
    n_sh = sh_rays.o.shape[0]
    bk = kb.occluded_packed(sh_rays, packed, t_sh)

    def occluded_twin(lo: int, hi: int, stats=None):
        return (kb.occluded_packed_ref(rays_slice(sh_rays, slice(lo, hi)), packed,
                                       t_sh[lo:hi], stats=stats),)

    (br,), plain_o = chunked(occluded_twin, n_sh)
    blk_bad = int((bk != br).sum())
    ms = {"closest_bin": cuda_ms(lambda: kb.traverse_packed(frame, packed)),
          "occluded_bin": cuda_ms(lambda: kb.occluded_packed(sh_rays, packed, t_sh))}
    part = {} if of_rays is None else {"of_rays": of_rays}
    phase("bin_parity", view=view, rays=n, **part, shadow_rays=n_sh,
          hit_frac=f"{float(hr.valid.float().mean()):.4f}",
          id_mismatch_frac=id_bad / n, blocked_mismatch_frac=blk_bad / n_sh,
          blocked_frac=f"{float(br.float().mean()):.4f}",
          **{f"max_abs_{k}": repr(v) for k, v in errs.items()},
          closest_bin_ms=f"{ms['closest_bin']:.4f}", closest_bin_plain_ms=f"{plain_c:.1f}",
          occluded_bin_ms=f"{ms['occluded_bin']:.4f}", occluded_bin_plain_ms=f"{plain_o:.1f}")
    if id_bad > MAX_MISMATCH_FRAC * n:
        fail(f"closest_bin ({view}): {id_bad} id mismatches against its twin")
    strict_flags("bin_parity", view, "occluded_bin", packed, sh_rays, bk, br)
    for k, v in errs.items():
        if not v <= MAX_ABS_ERR:
            fail(f"closest_bin ({view}): max |{k} - twin's| = {v!r} > {MAX_ABS_ERR}")
    out = dict(sh_rays=sh_rays, t_sh=t_sh, ms=ms,
               plain_ms={"closest_bin": plain_c, "occluded_bin": plain_o},
               err={"closest_bin": max(errs.values()), "occluded_bin": float(blk_bad > 0)},
               mismatch={"closest_bin": id_bad / n, "occluded_bin": blk_bad / n_sh})
    if count:
        def escape_closest(lo: int, hi: int, stats=None):
            closest_walk(rays_slice(frame, slice(lo, hi)), kb.PackedLayout(packed),
                         stats=stats)

        def escape_occluded(lo: int, hi: int, stats=None):
            occluded_walk(rays_slice(sh_rays, slice(lo, hi)), kb.PackedLayout(packed),
                          t_sh[lo:hi], stats=stats)

        out["bound"] = {
            "closest_bin": both_bounds("bound_bin", view, "closest_bin", {
                "near_first": (counted(closest_twin, n), BIN),
                "escape": (counted(escape_closest, n), BIN)}, n, 24, 16),
            "occluded_bin": both_bounds("bound_bin", view, "occluded_bin", {
                "near_first": (counted(occluded_twin, n_sh), BIN_HALF),
                "escape": (counted(escape_occluded, n_sh), BIN)}, n_sh, 28, 1)}
    return out


def bin_timing(view: str, tracer: Tracer, frame: Rays, par: dict, beside: dict | None = None):
    """The binary hard frame: kernel ms (from [bin_parity]), the whole
    render_rays frame by CUDA events, the glue as their difference, rays/s;
    beside: the same frame's BVH8 numbers from [timing]."""
    n = frame.o.shape[0]
    total = cuda_ms(lambda: render_rays(tracer, frame))
    ms = par["ms"]
    extra = {} if beside is None else {
        "closest8_ms": f"{beside['closest8']:.4f}", "occluded8_ms": f"{beside['occluded8']:.4f}",
        "wide8_frame_ms": f"{beside['frame']:.4f}"}
    phase("timing_bin", view=view, rays=n, shadow_rays=par["sh_rays"].o.shape[0],
          closest_bin_ms=f"{ms['closest_bin']:.4f}", occluded_bin_ms=f"{ms['occluded_bin']:.4f}",
          glue_ms_derived=f"{total - ms['closest_bin'] - ms['occluded_bin']:.4f}",
          frame_ms=f"{total:.4f}", rays_per_s=f"{n / (total * 1e-3):.1f}", **extra)
    return total


def render_bin(scene, cam: Camera, dev, tracer: Tracer, frame: Rays) -> dict:
    """The binary hard render through its entry point, render(method=
    "binary"), with the launch counts of that call; its image against the
    wide8 engine's on the same frame (tpurt's engine threshold), and the
    goldens through "binary"."""
    reset_launches()
    img, s_render = sync_time(lambda: render(scene, cam, method="binary"))
    launches = launch_counts()
    ref = render(scene, cam, method="wide8")
    off = float(((img - ref).abs().amax(dim=-1) > 2e-3).float().mean())
    hit_frac = float(kb.traverse_packed(frame, tracer.packed).valid.float().mean())
    finite = bool(torch.isfinite(img).all())
    phase("render_bin", shape=tuple(img.shape), seconds=f"{s_render:.3f}", finite=finite,
          hit_frac=f"{hit_frac:.4f}", vs_wide8_off_frac=f"{off:.5f}",
          launches=json.dumps(launches), mean=f"{float(img.mean()):.5f}")
    if tuple(img.shape) != (cam.height, cam.width, 3) or not finite:
        fail("the binary image is not a finite (H, W, 3) array")
    if not 0.1 < hit_frac < 1.0:
        fail(f"binary hit fraction {hit_frac} outside (0.1, 1.0)")
    if off > 0.003:
        fail(f"the binary image differs from the wide8 one on {off} of pixels")
    for name in ("closest_bin", "occluded_bin"):
        if launches[name] <= 0:
            fail(f"the binary render never launched {name}")
    phase("golden_bin", **goldens(dev, "binary"))
    return launches


def reset_launches() -> None:
    k8.reset_launches()
    kb.reset_launches()
    kp.reset_launches()
    tb.reset_launches()
    ss.reset_launches()


def launch_counts() -> dict:
    return {**k8.LAUNCHES, **kb.LAUNCHES, **kp.LAUNCHES, **tb.LAUNCHES, **ss.LAUNCHES}


def fit_problem(scene, cam: Camera, method: str = "wide8", chunks: int = FIT_CHUNKS,
                steps: int = FIT_STEPS) -> tuple:
    """The fit's InverseRenderer (soft, `method`) and its target, the
    albedo x 0.8 render: (inv, target, init s, target s)."""
    inv, s_init = sync_time(lambda: InverseRenderer(
        scene, cam, fit=FitConfig(steps=steps, grad_chunks=chunks, lr=FIT_LR),
        render=RenderConfig(method=method, **SOFT)))
    with torch.no_grad():
        dim = dataclasses.replace(scene, tris=dataclasses.replace(
            scene.tris, albedo=scene.tris.albedo * 0.8))
        target, s_target = sync_time(lambda: render(dim, cam, tracer=inv.tracer0, **SOFT))
    return inv, target, s_init, s_target


def fit_phase(scene, cam: Camera, method: str = "wide8", chunks: int = FIT_CHUNKS,
              steps: int = FIT_STEPS, name: str = "fit", kernel: str = "knear8") -> dict:
    """The fit step, through InverseRenderer.fit, with its launch counts:
    `kernel` (the engine's k-nearest kernel) must run twice a chunk."""
    inv, target, s_init, s_target = fit_problem(scene, cam, method, chunks, steps)
    torch.cuda.reset_peak_memory_stats()
    secs, t_last = [], [0.0]

    def on_step(i: int, loss: float) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        secs.append(now - t_last[0])
        t_last[0] = now

    reset_launches()
    torch.cuda.synchronize()
    t_last[0] = time.perf_counter()
    res = inv.fit(target, callback=on_step)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n = cam.width * cam.height
    rays_s = n / float(np.mean(secs[1:])) if len(secs) > 1 else n / secs[0]
    ok = (all(np.isfinite(x) for x in res.losses)
          and all(np.isfinite(g[k]) and g[k] > 0 for g in res.grad_norms for k in g)
          and set(res.grad_norms[0]) == {"verts", "albedo"})
    phase(name, tris=scene.num_tris, rays=n, steps=steps, chunks=chunks,
          chunk_rays=n // chunks, init_s=f"{s_init:.3f}", target_s=f"{s_target:.3f}",
          step_s=[round(x, 4) for x in secs], fwd_bwd_rays_per_s=f"{rays_s:.1f}",
          losses=[round(x, 6) for x in res.losses], loss_fell=res.losses[-1] < res.losses[0],
          grad_norms=json.dumps(res.grad_norms), peak_mem_bytes=peak,
          launches=json.dumps(launches), finite_nonzero=ok)
    if not ok:
        fail(f"{name}: a fit loss or gradient is not finite, or a gradient is zero")
    if launches[kernel] < 2 * chunks * steps:
        fail(f"{name}: the fit launched {kernel} {launches[kernel]} times "
             f"(< {2 * chunks * steps})")
    return dict(inv=inv, target=target, launches=launches, result=res,
                step_s=[round(x, 4) for x in secs])


def generic_cornell(dev, res: int = GATE_RES):
    """Cornell in generic position (tests/grad/test_fdcheck.py's recipe with
    a numpy seed): vertices jittered by up to 0.015, an off-axis light, so
    no face sits exactly on a shading kink."""
    scene, cam = make_cornell_box(device=dev)
    jit = np.random.default_rng(9).uniform(-0.015, 0.015, tuple(scene.tris.verts.shape))
    tris = dataclasses.replace(scene.tris, verts=scene.tris.verts + torch.tensor(
        jit, dtype=torch.float32, device=dev))
    light = PointLight.create((0.43, 0.91, 0.56), (14.0,) * 3, device=dev)
    return (dataclasses.replace(scene, tris=tris, lights=light),
            dataclasses.replace(cam, width=res, height=res))


def gate_loss(scene, cam, method: str):
    """mean(w * image) as a function of (verts, albedo), the wide8 tree
    built once at band GATE['band'] and refit inside, as the fit step does."""
    dev = scene.tris.verts.device
    w = torch.tensor(np.random.default_rng(3).uniform(0.2, 1.0, (cam.height, cam.width, 3)),
                     dtype=torch.float32, device=dev)
    tracer0 = make_tracer(scene, method, band=GATE["band"])

    def loss(params):
        verts, albedo = params
        tris = dataclasses.replace(scene.tris, verts=verts, albedo=albedo)
        tracer = tracer0
        if method == "wide8":
            frozen = dataclasses.replace(tris, verts=verts.detach())
            tracer = dataclasses.replace(tracer0, wide=refit_wide_direct(tracer0.wide, frozen))
        return torch.mean(w * render(dataclasses.replace(scene, tris=tris), cam,
                                     tracer=tracer, **GATE))

    return loss, (scene.tris.verts.clone(), scene.tris.albedo.clone())


def gate_grads(dev):
    loss, params = gate_loss(*generic_cornell(dev), "wide8")
    params = [p.requires_grad_(True) for p in params]
    return [g.detach().cpu() for g in torch.autograd.grad(loss(params), params)]


def fit_check(dev) -> dict:
    """Small soft checks on the card: the wide8 image against brute, the
    wide8 gradients against the CPU, finite differences at tpurt's
    thresholds, and a 5-step albedo fit whose loss must fall."""
    scene, cam = generic_cornell(dev)
    with torch.no_grad():
        img_w = render(scene, cam, method="wide8", **GATE)
        img_b = render(scene, cam, method="brute", **GATE)
    ok_frac = float(((img_w - img_b).abs().amax(dim=-1) <= IMAGE_ATOL).float().mean())
    g_dev, g_cpu = gate_grads(dev), gate_grads(torch.device("cpu"))
    grad_err = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_dev, g_cpu)]
    loss, params = gate_loss(*generic_cornell(dev, FD_RES), "wide8")
    fd = check_grads_fd(loss, params, eps=1e-3, rtol=6e-2, atol=2e-3,
                        max_probes_per_leaf=8, seed=1)
    with torch.no_grad():
        dim = dataclasses.replace(scene, tris=dataclasses.replace(
            scene.tris, albedo=scene.tris.albedo * 0.8))
        target = render(dim, cam, method="brute", **SOFT)
    fit = InverseRenderer(scene, cam, fit=FitConfig(steps=5, lr=1e-2, fit_verts=False,
                                                    grad_chunks=2),
                          render=RenderConfig(method="wide8", **SOFT)).fit(target)
    phase("fit_check", res=GATE_RES, fd_res=FD_RES, image_ok_frac=f"{ok_frac:.5f}",
          grad_rel_err_verts=repr(grad_err[0]), grad_rel_err_albedo=repr(grad_err[1]),
          fd_probes=fd["n_probes"], fd_max_abs_err=f"{fd['max_abs_err']:.3e}",
          fd_max_rel_err=f"{fd['max_rel_err']:.3e}",
          albedo_fit_losses=[round(x, 6) for x in fit.losses])
    if ok_frac < IMAGE_MIN_FRAC:
        fail(f"wide8 soft image: only {ok_frac} of pixels within {IMAGE_ATOL} of brute")
    if max(grad_err) > GRAD_DEVICE_RTOL:
        fail(f"wide8 gradients on the card differ from the CPU's by {grad_err}")
    if not fit.losses[-1] < fit.losses[0]:
        fail(f"the albedo fit's loss did not fall: {fit.losses}")
    return dict(grad_err=grad_err)


def profile_fit(inv: InverseRenderer, target: torch.Tensor, name: str = "profile_fit",
                kernel: str = "knear8") -> None:
    """Where one fit step's device time goes (torch.profiler): the engine's
    k-nearest kernel, the backward (autograd's evaluate_function ranges;
    within it the index_add_/scatter kernels, the segsum kernels and the
    radix sorts before them; segsum's share counts the memset of its output
    before each scan, and prints it apart too), the refit (its
    record_function range) and the
    rest, the forward glue; and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inv.fit(target, steps=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        inv.fit(target, steps=1)
        torch.cuda.synchronize()
        time.sleep(LAUNCH_COUNT_WAITS[-1])  # the step's last kernels inside the window
    dev_events, busy, window, total = device_spans(prof)
    if not dev_events:
        phase(name, device_time="not measured (the profiler saw no device event)")
        return

    def kernel_time(*keys):
        return sum(e.time_range.end - e.time_range.start for e in dev_events
                   if any(k in e.name for k in keys))

    def range_time(pred):
        # the host-side range: the device time of the kernels launched in it
        return sum(a.device_time_total for a in prof.key_averages()
                   if a.device_type == DeviceType.CPU and pred(a.key))

    knear = kernel_time(f"{kernel}_kernel")
    scatter = kernel_time("indexFunc", "scatter")
    # segsum's kernels and the memset of its output before each scan
    segsum_memset = preceding_memsets(dev_events, "segsum_scan")
    segsum = kernel_time("segsum_") + segsum_memset
    sort = kernel_time("RadixSort")
    backward = range_time(lambda k: k.startswith("autograd::engine::evaluate_function"))
    refit = range_time(lambda k: k == "tpurt::refit")
    # the refit range's device-side copy: first kernel's start to last one's end
    refit_span = sum(e.time_range.end - e.time_range.start for e in prof.events()
                     if e.is_user_annotation and e.device_type == DeviceType.CUDA
                     and e.name == "tpurt::refit")
    glue = total - knear - backward - refit
    phase(name, device_window_ms=f"{window / 1e3:.3f}",
          device_busy_ms=f"{busy / 1e3:.3f}", idle_share=f"{1 - busy / window:.4f}",
          **{f"{kernel}_share": f"{knear / total:.4f}"}, backward_share=f"{backward / total:.4f}",
          index_add_scatter_share=f"{scatter / total:.4f}",
          segsum_share=f"{segsum / total:.4f}",
          segsum_memset_share=f"{segsum_memset / total:.4f}",
          segsum_sort_share=f"{sort / total:.4f}",
          grad_backend=gg_mod.get_grad_backend(),
          backward_rest_share=f"{(backward - scatter) / total:.4f}",
          refit_share=f"{refit / total:.4f}", refit_ms=f"{refit / 1e3:.4f}",
          refit_span_ms=f"{refit_span / 1e3:.4f}", forward_glue_share=f"{glue / total:.4f}",
          device_kernels=len(dev_events))



# ---------------------------------------------------------------------------
# The LBVH build: the morton and radix kernels
# ---------------------------------------------------------------------------
def build_bound(nbytes: int, ops: int) -> dict:
    """The least time for a build kernel's work: the larger of its bytes over
    PEAK_BYTES_S and its integer operations over PEAK_INT32_OPS."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_INT32_OPS * 1e3
    return dict(bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def morton_bound(n: int) -> dict:
    """Each point's 12 bytes read and 8-byte code written once, lo and inv
    read once; MORTON_OPS a point."""
    return build_bound(20 * n + 24, MORTON_OPS * n)


def karras_work(tree, n: int) -> tuple[int, int]:
    """The delta evaluations of Karras's search (2012, fig. 4) for this
    radix tree of n leaves: (those that load a code, all of them).  Per
    internal node i: its own code, delta(i, i + 1) and delta(i, i - 1)
    (delta_min is one of the two); l_max = 2, 4, ... while the candidate
    lies inside the node's range; a binary search below l_max for the range
    end l; delta(i, j); the split search over t = ceil(l/2), ceil(l/4), ...,
    1.  The predicate is monotone, so every step's outcome follows from the
    node's l and split s, read off the tree (first, last, left); a
    candidate outside [0, n) loads nothing."""
    left, _, _, first, last = (x.long() for x in tree)
    i = torch.arange(n - 1, device=left.device, dtype=torch.int64)
    lo, hi = first[: n - 1], last[: n - 1]
    d = torch.where(lo == i, 1, -1)
    l = hi - lo
    gamma = torch.where(left >= n - 1, left - (n - 1), left)
    s = torch.where(d > 0, gamma - i, i - 1 - gamma)

    def in_range(m):
        p = i + m * d
        return ((p >= 0) & (p < n)).long()

    loads = 2 + (i > 0).long() + 1  # own code, i + 1, i - 1; then delta(i, j)
    evals = torch.full_like(i, 3)
    lmax, on = torch.full_like(i, 2), torch.ones_like(i, dtype=torch.bool)
    while bool(on.any()):  # exponential: accepted while l_max <= l
        loads += in_range(lmax) * on
        evals += on.long()
        on = on & (lmax <= l)
        lmax = torch.where(on, lmax * 2, lmax)
    part, t = torch.zeros_like(i), lmax // 2
    while bool((t > 0).any()):  # binary: candidate part + t accepted iff <= l
        on = t > 0
        cand = part + t
        loads += in_range(cand) * on
        evals += on.long()
        part = torch.where(on & (cand <= l), cand, part)
        t = t // 2
    part, t, on = torch.zeros_like(i), l.clone(), torch.ones_like(i, dtype=torch.bool)
    while bool(on.any()):  # split: candidate part + t accepted iff <= s
        t = torch.where(on, (t + 1) // 2, t)
        cand = part + t
        loads += in_range(cand) * on
        evals += on.long()
        part = torch.where(on & (cand <= s), cand, part)
        on = on & (t > 1)
    return int(loads.sum()), int(evals.sum())


def radix_bound(n: int, loads: int, evals: int) -> dict:
    """The sorted codes read once (8 bytes each); left, right, first, last
    and the children's parent written once (24 bytes a node); Karras's
    search on this input (karras_work): RADIX_DELTA_OPS a delta evaluation
    that loads a code, RADIX_STEP_OPS a search step."""
    return build_bound(8 * n + 24 * (n - 1), RADIX_DELTA_OPS * loads + RADIX_STEP_OPS * evals)


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def treebuild_parity(view: str, points: torch.Tensor | None = None,
                     codes: torch.Tensor | None = None) -> dict:
    """morton on `points` (normalised by their bounds, as the build does)
    and radix on their stably sorted codes, or on `codes`, against the
    twins on the card, bitwise; the kernel's device ms (morton's from a
    profile, kernel_device_ms; radix's from bare launches, events_ms over
    build_launch, as torch.profiler drops kernel events now and then), the
    wrapper call's ms and the twin's (CUDA events, warm), the bound from
    this input, and the phase's launches (the calls through the wrapper,
    the timed ones included).  Fails on any element that differs."""
    out = {}
    tb.reset_launches()
    if points is not None:
        lo = points.amin(dim=0)
        inv = tb.inv_extent(lo, points.amax(dim=0))
        ref = tb.morton_codes_ref(points, lo, inv)
        got = tb.morton_codes(points, lo, inv)
        bare = build_launch(this_library(), "morton", (points, lo, inv))[0]
        out["morton"] = dict(
            n=points.shape[0], mismatches=int((got != ref).sum()), max_abs_err=max_abs(got, ref),
            ms=kernel_device_ms(lambda: tb.morton_codes(points, lo, inv), "morton_kernel"),
            l2_flushed_ms=flushed_ms(bare), l2_write_flushed_ms=flushed_ms(bare, write=True),
            launch_floor_ms=launch_floor_ms(),
            call_ms=cuda_ms(lambda: tb.morton_codes(points, lo, inv)),
            plain_ms=cuda_ms(lambda: tb.morton_codes_ref(points, lo, inv), iters=3, warmup=1),
            **morton_bound(points.shape[0]))
        codes = torch.sort(ref, stable=True).values
    n = codes.shape[0]
    ref = tb.radix_tree_ref(codes)
    got = tb.radix_tree(codes)
    loads, evals = karras_work(ref, n)
    out["radix"] = dict(
        n=n, mismatches=sum(int((a != b).sum()) for a, b in zip(got, ref)),
        max_abs_err=max(max_abs(a, b) for a, b in zip(got, ref)),
        ms=events_ms(build_launch(this_library(), "radix", codes)[0]),
        call_ms=cuda_ms(lambda: tb.radix_tree(codes)),
        plain_ms=cuda_ms(lambda: tb.radix_tree_ref(codes), iters=3, warmup=1),
        loads=loads, evals=evals, **radix_bound(n, loads, evals))
    for name, r in out.items():
        r["launches"] = tb.LAUNCHES[name]
        phase("treebuild_parity", view=view, kernel=name, n=r["n"],
              mismatches=r["mismatches"], ms=f"{r['ms']:.4f}", call_ms=f"{r['call_ms']:.4f}",
              **{k: f"{r[k]:.4f}" for k in ("l2_flushed_ms", "l2_write_flushed_ms",
                                            "launch_floor_ms") if k in r},
              plain_ms=f"{r['plain_ms']:.4f}",
              bound_ms=f"{r['bound_ms']:.6f}", bound_by=r["bound_by"], bytes=r["bytes"],
              ops=r["ops"], **{k: r[k] for k in ("loads", "evals") if k in r},
              launches=r["launches"])
        if r["mismatches"]:
            fail(f"{name} ({view}): {r['mismatches']} elements differ from its twin")
    return out


def morton_edges(dev) -> dict:
    """morton against its twin on the card, bitwise, at the sizes and bases
    that a kernel reading points in vectors must cover: N in MORTON_EDGE_N
    seeded points, each from a tensor's own base and as the view points[1:]
    of N + 1 points (its base 12 bytes past the allocation's).  Returns each
    input's differing codes; fails on any."""
    rng = np.random.default_rng(MORTON_EDGE_SEED)
    out = {}
    for n in MORTON_EDGE_N:
        pts = torch.as_tensor(rng.uniform(-3.0, 5.0, (n + 1, 3)).astype(np.float32),
                              device=dev)
        for view, p in ((f"n{n}", pts[:n].clone()), (f"n{n}_offset12", pts[1:])):
            lo = p.amin(dim=0)
            inv = tb.inv_extent(lo, p.amax(dim=0))
            got, ref = tb.morton_codes(p, lo, inv), tb.morton_codes_ref(p, lo, inv)
            out[view] = int((got != ref).sum()) + int(got.shape != ref.shape)
            phase("treebuild_parity", view=view, kernel="morton", n=n,
                  base_offset=p.data_ptr() % 16, mismatches=out[view])
    if any(out.values()):
        fail(f"morton differs from its twin on the edge inputs: {out}")
    return out


# ---------------------------------------------------------------------------
# The build kernels against other trees' ([build_ab])
# ---------------------------------------------------------------------------
RADIX_OUTPUTS = ("left", "right", "parent", "first", "last")


def differing_elements(got, ref) -> dict:
    """Per output (RADIX_OUTPUTS, or "codes" for one tensor), the number of
    elements whose bits differ; an output of another dtype or shape differs
    in all of its elements."""
    if isinstance(got, torch.Tensor):
        got, ref, names = (got,), (ref,), ("codes",)
    else:
        names = RADIX_OUTPUTS
    out = {}
    for name, a, b in zip(names, got, ref):
        if a.dtype != b.dtype or a.shape != b.shape:
            out[name] = max(a.numel(), b.numel())
        elif a.dtype == torch.float32:
            out[name] = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        else:
            out[name] = int((a != b).sum())
    return out


def prefilled_radix_outputs(n: int, dev) -> tuple:
    """The radix outputs as the wrapper made them before the kernel wrote
    the whole stage: left and right empty, parent -1, the leaves' halves of
    first and last their own index (the internal halves empty)."""
    i32 = dict(dtype=torch.int32, device=dev)
    leaves = torch.arange(n, **i32)
    return (torch.empty(n - 1, **i32), torch.empty(n - 1, **i32),
            torch.full((2 * n - 1,), -1, **i32),
            torch.cat([torch.empty(n - 1, **i32), leaves]),
            torch.cat([torch.empty(n - 1, **i32), leaves]))


def radix_launch(lib: ctypes.CDLL, codes: torch.Tensor, outs: tuple) -> None:
    """Enqueue lib's radix kernel on sorted codes into outs (left, right,
    parent, first, last) on the current stream."""
    err = lib.tpurt_radix(ctypes.c_void_p(codes.data_ptr()), codes.shape[0],
                          *(ctypes.c_void_p(x.data_ptr()) for x in outs),
                          ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        fail(f"radix failed to launch: {err}")


def radix_writes_all(lib: ctypes.CDLL, codes: torch.Tensor) -> bool:
    """Whether lib's radix kernel writes the leaves' first and last and the
    root's parent itself (this tree's kernel) or leaves them to its wrapper
    (earlier commits): one launch into outputs filled with a sentinel.
    Fails if it writes some of them and not the others."""
    n = codes.shape[0]
    outs = tuple(torch.full((m,), -7, dtype=torch.int32, device=codes.device)
                 for m in (n - 1, n - 1, 2 * n - 1, 2 * n - 1, 2 * n - 1))
    radix_launch(lib, codes, outs)
    leaves = torch.arange(n, dtype=torch.int32, device=codes.device)
    done = [bool(torch.equal(outs[3][n - 1:], leaves)),
            bool(torch.equal(outs[4][n - 1:], leaves)), int(outs[2][0]) == -1]
    if any(done) != all(done):
        fail(f"a radix kernel wrote only some of the leaves' halves and the root: {done}")
    return all(done)


def radix_stage(lib: ctypes.CDLL, codes: torch.Tensor, writes_all: bool = True) -> tuple:
    """lib's radix kernel on sorted codes, its outputs made as that tree's
    wrapper makes them (writes_all False: a kernel that leaves the leaves'
    halves and the root to its wrapper, prefilled_radix_outputs)."""
    n, dev = codes.shape[0], codes.device
    i32 = dict(dtype=torch.int32, device=dev)
    outs = (prefilled_radix_outputs(n, dev) if not writes_all else
            (torch.empty(n - 1, **i32), torch.empty(n - 1, **i32),
             *(torch.empty(2 * n - 1, **i32) for _ in range(3))))
    radix_launch(lib, codes, outs)
    return outs


def build_launch(lib: ctypes.CDLL, kernel: str, inputs, writes_all: bool = True):
    """(launch, stage): lib's morton kernel on inputs (points, lo, inv) or
    radix kernel on sorted codes.  launch() enqueues the kernel alone on
    outputs made once (bare launches); stage() makes the outputs as that
    tree's wrapper makes them (writes_all False: a radix kernel that leaves
    the leaves' halves and the root to its wrapper, which fills them with
    full, arange and cat first), launches, and returns the outputs."""
    if kernel == "morton":
        points, lo, inv = inputs
        once = torch.empty(points.shape[0], dtype=torch.int64, device=points.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def run(codes: torch.Tensor) -> torch.Tensor:
            err = lib.tpurt_morton(*(ctypes.c_void_p(x.data_ptr()) for x in (points, lo, inv)),
                                   ctypes.c_float(tb.MORTON_CLAMP_HI), points.shape[0],
                                   ctypes.c_void_p(codes.data_ptr()), stream)
            if err:
                fail(f"morton failed to launch: {err}")
            return codes

        def launch() -> None:
            run(once)

        def stage() -> torch.Tensor:
            return run(torch.empty_like(once))
    else:
        once = radix_stage(lib, inputs, writes_all)

        def launch() -> None:
            radix_launch(lib, inputs, once)

        def stage() -> tuple:
            return radix_stage(lib, inputs, writes_all)

    launch.keep = (inputs, once)
    return launch, stage


def flushed_ms(launch, passes: int = 20, flush_bytes: int = 128 << 20,
               write: bool = False) -> float:
    """The device ms of one bare launch with the L2 cache flushed before it,
    CUDA events bracketing the launch alone; the median of `passes`.  The
    flush reads flush_bytes (more than the card's 50 MB of L2) into a sum
    held in a preallocated 1-element tensor, so the launch finds its inputs
    in HBM and the L2 full of clean lines, which it evicts without writing
    them back.  write: the flush writes the buffer instead; the L2 is
    write-back, so the launch then also pays for evicting those dirty lines
    to HBM (the yardstick morton's row was once read by, printed beside the
    clean one).  A spin of FLUSH_SPIN_CYCLES follows the flush and touches
    no memory: the device is still busy when the host has enqueued the
    events and the launch, so they time the kernel and not the host."""
    buf = torch.ones(flush_bytes // 4, dtype=torch.float32, device="cuda")
    total = torch.empty((), dtype=torch.float32, device="cuda")
    launch()
    events = [tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
              for _ in range(passes)]
    for start, end in events:
        if write:
            buf.zero_()
        else:
            torch.sum(buf, dim=0, out=total)
        torch.cuda._sleep(FLUSH_SPIN_CYCLES)
        start.record()
        launch()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in events]))


def launch_floor_ms() -> float:
    """flushed_ms of an empty kernel (torch's spin kernel, 0 cycles, one
    thread): what a launch bracketed by the same events and flush costs
    with no work in it."""
    return flushed_ms(lambda: torch.cuda._sleep(0))


def events_ms(fn, passes: int = 20) -> float:
    """The ms of one fn() among `passes` back to back after a warm one, by
    CUDA events around them all."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(passes):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / passes


def build_inputs(view: str, points: torch.Tensor) -> dict:
    """[build_ab]'s cells of one scene: morton on its centroids (normalised
    by their bounds, as the build does) and radix on their stably sorted
    codes."""
    lo = points.amin(dim=0)
    inv = tb.inv_extent(lo, points.amax(dim=0))
    codes = torch.sort(tb.morton_codes_ref(points, lo, inv), stable=True).values
    return {f"radix_{view}": ("radix", codes), f"morton_{view}": ("morton", (points, lo, inv))}


@torch.no_grad()
def build_ab(libs: dict, cells: dict) -> dict:
    """The build kernels of this checkout ("new") against other trees'
    (libs: {"new": lib, name: lib, ...}) on each cell (name -> (kernel,
    inputs): "radix" on sorted codes, "morton" on (points, lo, inv)): every
    tree's outputs from its stage bitwise equal to this build's (a tree
    that differs fails the script at its end), then in turns other, new,
    new, other for each other tree the kernel's device ms from bare
    launches (events_ms over launch(): morton's inputs stay in L2, as the
    build's centroids come straight from the op before it), morton's also
    with a clean L2 before each launch (flushed_ms), and the stage's ms as
    that tree's wrapper makes it (events_ms over stage(): output
    allocation, the wrapper's fills, the launch)."""
    out = {}
    for cell, (kernel, inputs) in cells.items():
        codes = inputs if kernel == "radix" else None
        writes = {name: radix_writes_all(lib, codes) if codes is not None else True
                  for name, lib in libs.items()}
        if not writes["new"]:
            fail("this checkout's radix kernel leaves the leaves and the root unwritten")
        fns = {name: build_launch(lib, kernel, inputs, writes[name])
               for name, lib in libs.items()}
        ref = fns["new"][1]()
        bad = {name: differing_elements(f[1](), ref) for name, f in fns.items() if name != "new"}
        del ref
        order = [name for other in libs if other != "new"
                 for name in (other, "new", "new", other)] or ["new"]
        turns = {"device": [(name, events_ms(fns[name][0])) for name in order],
                 "stage": [(name, events_ms(fns[name][1])) for name in order]}
        if kernel == "morton":  # also from HBM with a clean L2 (flushed_ms)
            turns["flushed"] = [(name, flushed_ms(fns[name][0])) for name in order]
        mean = lambda ts, name: float(np.mean([t for s, t in ts if s == name]))  # noqa: E731
        out[cell] = {name: {f"{k}_ms": mean(ts, name) for k, ts in turns.items()}
                     for name in libs}
        n = (inputs if codes is not None else inputs[0]).shape[0]
        phase("build_ab", kernel=kernel, cell=cell, n=n,
              writes_leaves=json.dumps(writes), mismatches=json.dumps(bad),
              **{f"{k}_turns": json.dumps([[s, round(t, 5)] for s, t in ts])
                 for k, ts in turns.items()},
              **{f"{name}_{k}": f"{x:.5f}" for name, v in out[cell].items()
                 for k, x in v.items()})
        if any(sum(v.values()) for v in bad.values()):
            FAILURES.append(f"{kernel} ({cell}): outputs differ from another tree's: {bad}")
    return out


# build_lbvh's stage spans (accel/lbvh.py, accel/morton.py), in its order,
# and the warm builds a profile of its stages covers.
BUILD_STAGES = ("boxes", "centroid_bounds", "morton", "sort", "radix", "rmq",
                "thread_dfs", "flat_scatter")
STAGE_BUILDS = 3
BVH_TENSORS = tuple(f.name for f in dataclasses.fields(BVH)
                    if f.name not in ("leaf_size", "band"))


def device_kernels(prof) -> list:
    """A profile's device kernels as (start, end, name) in µs, in time
    order (the device-side copies of record_function ranges left out)."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation)


def kernel_device_ms(fn, kernel: str, calls: int = 30) -> float:
    """A hand-written kernel's own device time a call: torch.profiler over
    `calls` calls of fn after a warm one, the mean duration of the device
    events named `kernel`.  For a kernel of a few microseconds CUDA events
    around back-to-back calls time the host's launches instead (the
    wrapper's checks, allocations and ctypes call).  The profiler may miss
    the events of the first calls after it starts, and now and then most of
    a session's, so a third of them is enough and a session that holds
    fewer is repeated, twice at most."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        durs = [e - s for s, e, name in device_kernels(prof) if kernel in name]
        if len(durs) >= calls // 3:
            return sum(durs) / len(durs) / 1e3
    fail(f"three profiles of {calls} calls held too few {kernel} events "
         f"(the last: {len(durs)})")


def stage_times(tris, radix=None) -> dict:
    """build_lbvh's stages from a torch.profiler trace of STAGE_BUILDS + 1
    warm builds, a synchronize after each; the first build is dropped (the
    profiler misses events of the first calls after it starts).  Per stage, one reading a
    build: the device time of the kernels inside the device-side copy of its
    lbvh.* span (kernels: the stream runs them in order, so these are the
    stage's, the hand-written ones, launched through ctypes, included),
    that span from its first kernel's start to its last one's end (span: it
    also counts the device idle between them), and the span's host time
    (host, under the profiler), and the device kernels in the span
    (launches).  radix: a function that takes build_lbvh's radix_tree's
    place for these builds (another tree's radix stage)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    saved = lbvh_mod.radix_tree
    lbvh_mod.radix_tree = radix or saved
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(STAGE_BUILDS + 1):
                build_lbvh(tris)
                torch.cuda.synchronize()
    finally:
        lbvh_mod.radix_tree = saved
    events = prof.events()
    kernels = device_kernels(prof)

    def ranges(name, device):
        return sorted((e.time_range.start, e.time_range.end) for e in events
                      if e.name == name and e.device_type == device
                      and (device == DeviceType.CPU or e.is_user_annotation))

    out = {}
    for st in BUILD_STAGES:
        host = ranges(f"lbvh.{st}", DeviceType.CPU)
        if len(host) != STAGE_BUILDS + 1:
            fail(f"the profile of {STAGE_BUILDS + 1} builds holds {len(host)} lbvh.{st} spans")
        # each build's device-side span starts after its host range does and
        # before the next build's (a synchronize ends every build); None
        # where the profiler lost it
        dev_all = ranges(f"lbvh.{st}", DeviceType.CUDA)
        ends = [h[0] for h in host[2:]] + [float("inf")]
        host = host[1:]
        dev = [next((d for d in dev_all if h[0] <= d[0] < end), None)
               for h, end in zip(host, ends)]
        if all(d is None for d in dev):
            fail(f"the profile holds no device-side lbvh.{st} span")
        out[st] = dict(kernels=[None if d is None else
                                sum(e - s for s, e, _ in kernels if d[0] <= s < d[1]) / 1e3
                                for d in dev],
                       span=[None if d is None else (d[1] - d[0]) / 1e3 for d in dev],
                       launches=[None if d is None else
                                 sum(1 for s, _, _ in kernels if d[0] <= s < d[1])
                                 for d in dev],
                       host=[(b - a) / 1e3 for a, b in host])
        if st in ("morton", "radix"):  # the hand-written kernel alone
            out[st]["named"] = [(e - s) / 1e3 for s, e, name in kernels
                                if f"{st}_kernel" in name][-STAGE_BUILDS:]
    return out


def twin_route_build(tris) -> BVH:
    """build_lbvh with the morton and radix twins in place of the kernels on
    the card: the two names it calls through are swapped for the call."""
    saved = morton_mod.morton_codes, lbvh_mod.radix_tree
    morton_mod.morton_codes, lbvh_mod.radix_tree = tb.morton_codes_ref, tb.radix_tree_ref
    try:
        return build_lbvh(tris)
    finally:
        morton_mod.morton_codes, lbvh_mod.radix_tree = saved


def build_stages(view: str, scene, wide8: bool = False, parent=None) -> dict:
    """A warm build_lbvh: host seconds after a synchronize, its launches, its
    peak memory above what was allocated before it; its stages from a
    profile (stage_times); the same build through the twins on the card
    (warm host seconds), every BVH field bitwise equal to the kernel
    route's.  wide8: also the wide collapse and pack seconds of that tree.
    parent: another tree's kernel library, whose radix stage (radix_stage,
    its outputs made as its wrapper made them) is profiled in the same
    builds' place: the lbvh.radix span before and after this change."""
    tris = scene.tris
    build_lbvh(tris)  # warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tb.reset_launches()
    bvh, s_build = sync_time(lambda: build_lbvh(tris))
    launches = dict(tb.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    st = stage_times(tris)
    twin_route_build(tris)  # warm
    t_bvh, s_twin = sync_time(lambda: twin_route_build(tris))
    same = {f: bitwise_equal(getattr(t_bvh, f), getattr(bvh, f)) for f in BVH_TENSORS}
    del t_bvh
    extra = {}
    if wide8:
        topo, s_collapse = sync_time(lambda: collapse_wide(tris, bvh))
        wide, s_pack = sync_time(lambda: pack_wide(tris, bvh, *topo))
        extra = dict(collapse_s=f"{s_collapse:.3f}", pack_s=f"{s_pack:.3f}",
                     wides=wide.num_wides)
        del topo, wide

    def readings(xs):
        return ",".join("not measured" if x is None else f"{x:.4f}" for x in xs)

    per_build = [None if any(st[k]["kernels"][b] is None for k in BUILD_STAGES)
                 else sum(st[k]["kernels"][b] for k in BUILD_STAGES)
                 for b in range(STAGE_BUILDS)]
    phase("build_stages", view=view, tris=tris.num_tris, build_s=f"{s_build:.4f}",
          twin_route_build_s=f"{s_twin:.4f}", peak_extra_bytes=peak,
          launches=json.dumps(launches), bitwise=all(same.values()),
          stage_kernels_ms=readings(per_build), **extra)
    for k in BUILD_STAGES:
        phase("build_stages", view=view, stage=k, kernels_ms=readings(st[k]["kernels"]),
              span_ms=readings(st[k]["span"]), host_ms=readings(st[k]["host"]),
              launches=json.dumps(st[k]["launches"]),
              **({"kernel_by_name_ms": readings(st[k]["named"])} if "named" in st[k] else {}))
    if parent is not None:
        writes = radix_writes_all(parent, bvh.codes)
        pst = stage_times(tris, radix=lambda codes: radix_stage(parent, codes, writes))
        phase("build_stages", view=view, stage="radix", route="parent",
              kernels_ms=readings(pst["radix"]["kernels"]),
              span_ms=readings(pst["radix"]["span"]), host_ms=readings(pst["radix"]["host"]),
              launches=json.dumps(pst["radix"]["launches"]),
              kernel_by_name_ms=readings(pst["radix"]["named"]))
    if not all(same.values()):
        fail(f"build_stages ({view}): BVH fields differ: {[f for f, v in same.items() if not v]}")
    if launches != {"morton": 1, "radix": 1}:
        fail(f"build_stages ({view}): build_lbvh launched {launches}, not each kernel once")
    ms = {k: float(np.median([x for x in v["kernels"] if x is not None]))
          for k, v in st.items()}
    return dict(build_s=s_build, ms=ms, peak=peak, bvh=bvh)


def renderer_phase(scene, cam: Camera, ref: torch.Tensor) -> dict:
    """The slice's main path in process, as a user calls it:
    Renderer(scene, RenderConfig(method="wide8")) builds the tree
    (make_tracer -> build_lbvh through morton and radix, then the wide
    collapse) and renders the frame through closest8 and occluded8.  The
    launch counts of that run; its image against [render]'s."""
    reset_launches()
    r, s_init = sync_time(lambda: Renderer(scene, RenderConfig(method="wide8")))
    img, s_render = sync_time(lambda: r.render(cam))
    launches = launch_counts()
    diff = float((img - ref).abs().max())
    off = float(((img - ref).abs().amax(dim=-1) > 2e-3).float().mean())
    phase("renderer", tris=scene.num_tris, shape=tuple(img.shape), init_s=f"{s_init:.3f}",
          render_s=f"{s_render:.3f}", launches=json.dumps(launches),
          vs_render_max_abs=repr(diff), vs_render_off_frac=off)
    if off > 0.003:
        fail(f"the Renderer image differs from render()'s on {off} of pixels")
    for name in ("morton", "radix", "closest8", "occluded8"):
        if launches[name] <= 0:
            fail(f"Renderer(method='wide8') never launched {name}")
    return launches


# ---------------------------------------------------------------------------
# Area lights ([area]): the hard and soft paths with emitter samples
# ---------------------------------------------------------------------------
# The pipeline's kernel wrappers and their twins, swapped by twin_route.
TWINS = {"traverse_wide8": k8.traverse_wide8_ref, "occluded_wide8": k8.occluded_wide8_ref,
         "k_nearest_wide8": k8.k_nearest_wide8_ref, "traverse_packed": kb.traverse_packed_ref,
         "occluded_packed": kb.occluded_packed_ref,
         "k_nearest_ids_packed": kb.k_nearest_ids_packed_ref,
         "traverse_packet": kp.traverse_packet_ref, "occluded_packet": kp.occluded_packet_ref,
         "k_nearest_ids_packet": kp.k_nearest_ids_packet_ref}
# Each engine's any-hit and k-nearest wrapper names in the pipeline.
ANY_HIT = {"wide8": "occluded_wide8", "binary": "occluded_packed"}


def cat_outputs(parts: list):
    """Concatenate the chunks' outputs of a walk: tensors, Hit records and
    tuples of them."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts)
    if isinstance(first, Hit):
        return Hit(**{f.name: torch.cat([getattr(p, f.name) for p in parts])
                      for f in dataclasses.fields(Hit)})
    return type(first)(cat_outputs(list(xs)) for xs in zip(*parts))


def chunked_twin(fn, record: list | None = None):
    """fn (a twin, taking rays first) over PARITY_CHUNK-ray chunks: every
    per-ray tensor argument is cut with the rays, the outputs concatenated.
    record: a list to which each call appends (rays, its arguments, the
    output)."""
    def run(rays: Rays, *args, **kw):
        flat = Rays(o=rays.o.reshape(-1, 3), d=rays.d.reshape(-1, 3))
        n = flat.o.shape[0]

        def cut(x, lo, hi):
            per_ray = isinstance(x, torch.Tensor) and x.ndim > 0 and x.shape[0] == n
            return x[lo:hi] if per_ray else x

        parts = [fn(rays_slice(flat, slice(lo, min(lo + PARITY_CHUNK, n))),
                    *(cut(a, lo, lo + PARITY_CHUNK) for a in args),
                    **{k: cut(v, lo, lo + PARITY_CHUNK) for k, v in kw.items()})
                 for lo in range(0, n, PARITY_CHUNK)]
        out = cat_outputs(parts)
        if record is not None:
            record.append((flat, args, kw, out))
        return out

    return run


@contextlib.contextmanager
def twin_route(record: dict | None = None):
    """The render pipeline and the ring's local walks (dist/ring.py) with
    every kernel wrapper swapped for its twin (run over chunks,
    chunked_twin), and the gather backward's segment_accumulate for its
    twin, for the duration: the twin route on the card.  record:
    name -> list of each call's (rays, args, kwargs, out)."""
    saved = [(mod, name, getattr(mod, name)) for mod in (pipeline_mod, ring_mod)
             for name in TWINS]
    saved.append((gg_mod, "segment_accumulate", gg_mod.segment_accumulate))
    try:
        for mod, name, _ in saved[:-1]:
            rec = None if record is None else record.setdefault(name, [])
            setattr(mod, name, chunked_twin(TWINS[name], rec))
        gg_mod.segment_accumulate = ss.segment_accumulate_ref
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def with_emitters(scene, n: int = AREA_EMITTERS, le: float = AREA_LE, seed: int = AREA_SEED):
    """The scene with n of its triangles, drawn by a seeded numpy choice,
    made emitters of radiance le (the generated scenes carry none)."""
    ids = np.random.default_rng(seed).choice(scene.num_tris, n, replace=False)
    emission = scene.tris.emission.clone()
    emission[torch.as_tensor(ids, device=emission.device)] = le
    return dataclasses.replace(scene, tris=dataclasses.replace(scene.tris, emission=emission))


def seeded(dev) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(AREA_SEED)
    return g


def image_diff(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Bitwise equality, the largest |a - b| and the fraction of pixels off
    by more than the engines' image atol."""
    return dict(bitwise=bitwise_equal(a, b), max_abs=repr(max_abs(a, b)),
                off_frac=float(((a - b).abs().amax(dim=-1) > IMAGE_ATOL).float().mean()))


@torch.no_grad()
def area_profile(view: str, tracer: Tracer, frame: Rays, frames: int = 3) -> None:
    """Where the hard area-light frame's device time goes (torch.profiler
    over `frames` render_rays calls with AREA_SAMPLES samples): the
    engine's two kernels' shares, the glue's, the idle share of the device
    window, and the glue kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    names, _ = HARD_KERNELS[tracer.method]
    g = seeded(frame.o.device)
    render_rays(tracer, frame, light_samples=AREA_SAMPLES, generator=g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            render_rays(tracer, frame, light_samples=AREA_SAMPLES, generator=g)
        torch.cuda.synchronize()
    events, busy, window, total = device_spans(prof)
    if not events:
        phase("area_profile", view=view, device_time="not measured (no device event)")
        return
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.end - e.time_range.start
    share = {k: sum(v for name, v in by_name.items() if f"{k}_kernel" in name) for k in names}
    glue = sorted(((v, name) for name, v in by_name.items()
                   if not any(f"{k}_kernel" in name for k in names)), reverse=True)
    phase("area_profile", view=view, frames=frames,
          device_window_ms=f"{window / 1e3 / frames:.4f}",
          device_busy_ms=f"{busy / 1e3 / frames:.4f}", idle_share=f"{1 - busy / window:.4f}",
          **{f"{k}_share": f"{v / total:.4f}" for k, v in share.items()},
          glue_share=f"{(total - sum(share.values())) / total:.4f}",
          device_kernels=len(events) // frames,
          top_glue=json.dumps([[name[:60], round(v / 1e3 / frames, 4)] for v, name in glue[:6]]))


@torch.no_grad()
def area_hard(view: str, r: Renderer, cam: Camera) -> dict:
    """The hard area-light frame as a user renders it: r.render(cam) (the
    renderer's light_samples, a generator seeded its light_seed) through
    the engine's closest-hit and any-hit kernels, with that run's launch
    counts; the same render through the twins on the card, whose image it
    must match (off by more than IMAGE_ATOL on at most MAX_MISMATCH_FRAC of
    pixels) and whose any-hit calls are recorded: the kernel's flags on the
    recorded area shadow rays must equal the twin's on every ray
    (strict_flags).  Then the frame's time (render_rays on the Morton
    frame, CUDA events) split into closest hit, any hit (point-light and
    area shadow rays) and glue; the any-hit kernel's device ms on the area
    rays by bare launches; area shadow rays a second; where its device time
    goes (area_profile)."""
    method, tracer = r.config.method, r.tracer
    s = r.config.light_samples
    names, closest = HARD_KERNELS[method]
    tree = tracer.wide if method == "wide8" else tracer.packed
    reset_launches()
    img, s_render = sync_time(lambda: r.render(cam))
    launches = launch_counts()
    record = {}
    with twin_route(record):
        twin_img, s_twin = sync_time(lambda: r.render(cam))
    diff = image_diff(img, twin_img)
    calls = record[ANY_HIT[method]]
    (al_rays, (_, t_al), _, twin_flags), (pt_rays, (_, t_pt), _, _) = calls[-1], calls[0]
    n_area = al_rays.o.shape[0]
    any_hit = getattr(pipeline_mod, ANY_HIT[method])
    flags = any_hit(al_rays, tree, t_al)
    strict_flags("area", view, names[1], tree, al_rays, flags, twin_flags)
    area_bound = None
    if method == "wide8":
        def area_twin(lo: int, hi: int, stats=None):
            return (k8.occluded_wide8_ref(rays_slice(al_rays, slice(lo, hi)), tree,
                                          t_al[lo:hi], stats=stats),)

        area_bound = bound(counted(area_twin, n_area), n_area, 28, 1, WIDE_HALF)
        phase("bound", view=view, kernel=names[1], rays="area", **area_bound)
    frame = morton_rays(cam)
    n = frame.o.shape[0]
    g = seeded(frame.o.device)
    ms = {"frame": cuda_ms(lambda: render_rays(tracer, frame, light_samples=s, generator=g)),
          "closest": cuda_ms(lambda: closest(frame, tracer)),
          "occluded_point": cuda_ms(lambda: any_hit(pt_rays, tree, t_pt)),
          "occluded_area": cuda_ms(lambda: any_hit(al_rays, tree, t_al))}
    ms["occluded"] = ms["occluded_point"] + ms["occluded_area"]
    ms["glue"] = ms["frame"] - ms["closest"] - ms["occluded"]
    ms["area_device"] = launch_ms(this_library(), names[1], tree, [(al_rays, None, t_al)])
    area_profile(view, tracer, frame)
    finite = bool(torch.isfinite(img).all())
    phase("area", view=view, method=method, path="hard", rays=n, light_samples=s,
          area_shadow_rays=n_area, shape=tuple(img.shape), finite=finite,
          render_s=f"{s_render:.3f}", twin_render_s=f"{s_twin:.3f}",
          launches=json.dumps(launches), blocked_frac=f"{float(flags.float().mean()):.4f}",
          flag_mismatches=int((flags != twin_flags).sum()),
          vs_twin_bitwise=diff["bitwise"], vs_twin_max_abs=diff["max_abs"],
          vs_twin_off_frac=diff["off_frac"],
          **{f"{k}_ms": f"{v:.4f}" for k, v in ms.items()},
          area_rays_per_s=f"{n_area / (ms['frame'] * 1e-3):.1f}",
          area_kernel_rays_per_s=f"{n_area / (ms['area_device'] * 1e-3):.1f}",
          mean=f"{float(img.mean()):.5f}")
    if tuple(img.shape) != (cam.height, cam.width, 3) or not finite:
        fail(f"area ({view}): the image is not a finite (H, W, 3) array")
    any_hit_calls = 1 + (tracer.scene.lights.pos.shape[0] > 0)  # point lights, samples
    if n_area != s * n or launches[names[0]] != 1 or launches[names[1]] != any_hit_calls:
        fail(f"area ({view}): {n_area} area shadow rays, launches {launches}")
    if diff["off_frac"] > MAX_MISMATCH_FRAC:
        fail(f"area ({view}): the image differs from the twin route's on "
             f"{diff['off_frac']} of pixels")
    return dict(ms=ms, launches=launches, n_area=n_area, area_bound=area_bound)


def area_soft(view: str, tracer: Tracer, rays: Rays) -> dict:
    """The soft area-light render of `rays` as render_rays(soft=True) makes
    it (SOFT, AREA_SAMPLES samples from a generator seeded AREA_SEED: the
    candidate occluders toward each sample from layer 0 through the
    tracer's k-nearest kernel), and d/d(verts, albedo) of sum(w * color)
    (w seeded); its launch counts; the same through the twins on the card.
    The image must match the twin route's (off by more than IMAGE_ATOL on
    at most MAX_MISMATCH_FRAC of rays), the gradients to GRAD_DEVICE_RTOL
    of the largest (under the 'scatter' backend the backward's index_add_
    adds in another order each run).  The forward's ms (CUDA events)."""
    scene, dev = tracer.scene, rays.o.device
    n = rays.o.shape[0]
    w = torch.rand((n, 3), generator=seeded(dev), device=dev)

    def run():
        verts = scene.tris.verts.detach().clone().requires_grad_(True)
        albedo = scene.tris.albedo.detach().clone().requires_grad_(True)
        tris = dataclasses.replace(scene.tris, verts=verts, albedo=albedo)
        sc = dataclasses.replace(scene, tris=tris)
        tr = dataclasses.replace(tracer, scene=sc, table=tri_table(tris))
        color = render_rays(tr, rays, light_samples=AREA_SAMPLES, generator=seeded(dev), **SOFT)
        grads = torch.autograd.grad(torch.sum(w * color), (verts, albedo))
        return color.detach(), grads

    reset_launches()
    (img, grads), s_kernel = sync_time(run)
    launches = launch_counts()
    with twin_route():
        (t_img, t_grads), s_twin = sync_time(run)
    diff = image_diff(img, t_img)
    grad_err = [max_abs(a, b) / max(float(b.abs().max()), 1e-30) for a, b in zip(grads, t_grads)]
    g = seeded(dev)
    with torch.no_grad():
        ms = cuda_ms(lambda: render_rays(tracer, rays, light_samples=AREA_SAMPLES, generator=g,
                                         **SOFT), iters=3, warmup=1)
    knear = knear_kernel(tracer.wide if tracer.method == "wide8" else tracer.packed)
    finite = bool(torch.isfinite(img).all()) and all(bool(torch.isfinite(x).all()) for x in grads)
    phase("area", view=view, method=tracer.method, path="soft", rays=n,
          light_samples=AREA_SAMPLES, launches=json.dumps(launches), finite=finite,
          seconds=f"{s_kernel:.3f}", twin_seconds=f"{s_twin:.3f}",
          vs_twin_bitwise=diff["bitwise"], vs_twin_max_abs=diff["max_abs"],
          vs_twin_off_frac=diff["off_frac"], grad_rel_err_verts=repr(grad_err[0]),
          grad_rel_err_albedo=repr(grad_err[1]),
          grad_norms=json.dumps([float(x.norm()) for x in grads]), forward_ms=f"{ms:.4f}")
    # the layers' call, the point lights' occluders, the samples' occluders
    if not finite or launches[knear] != 2 + (scene.lights.pos.shape[0] > 0):
        fail(f"area ({view}, soft): finite {finite}, launches {launches}")
    if diff["off_frac"] > MAX_MISMATCH_FRAC or max(grad_err) > GRAD_DEVICE_RTOL:
        fail(f"area ({view}, soft): off the twin route's image on {diff['off_frac']} of rays, "
             f"gradients by {grad_err}")
    if not all(float(x.abs().max()) > 0 for x in grads):
        fail(f"area ({view}, soft): a gradient is zero")
    return dict(ms=ms, launches=launches, img=img)


def area_phase(scene, cam: Camera, bscene, bcam: Camera) -> dict:
    """[area]: the 1M sponza and the bunny with AREA_EMITTERS seeded
    triangles made emitters.  The hard frame through Renderer(light_samples
    AREA_SAMPLES): wide8 on the 1M main view and the overview (occluded8
    on the S x R area shadow rays), then [spp] on both views; binary on the
    bunny (occluded_bin); the soft render and its gradients: binary on the
    bunny (knear_bin), wide8 on one fit-sized chunk of the 1M overview's
    Morton rays (knear8); then the packet engine's area rows (area_packet,
    area_packet_soft) on the bunny and the 1M main view."""
    dev = cam.eye.device
    cfg = dict(light_samples=AREA_SAMPLES, light_seed=AREA_SEED)
    scene_e = with_emitters(scene)
    over_cam = Camera.create(eye=OVERVIEW_EYE, target=OVERVIEW_TARGET, fov_y_deg=50.0,
                             width=WIDTH, height=HEIGHT, device=dev)
    r, s_init = sync_time(lambda: Renderer(scene_e, RenderConfig(method="wide8", **cfg)))
    phase("area", tris=scene_e.num_tris, emitters=AREA_EMITTERS, le=AREA_LE,
          light_samples=AREA_SAMPLES, seed=AREA_SEED, renderer_init_s=f"{s_init:.3f}")
    out = {"main": area_hard("main", r, cam), "overview": area_hard("overview", r, over_cam)}
    del r
    t0 = time.perf_counter()
    r, s_init = sync_time(lambda: Renderer(scene_e, RenderConfig(method="wide8", spp=SPP,
                                                                 **cfg)))
    out["spp"] = {"main": spp_view("main", r, cam), "overview": spp_view("overview", r, over_cam)}
    del r
    phase("spp", renderer_init_s=f"{s_init:.3f}", seconds=f"{time.perf_counter() - t0:.1f}")
    bscene_e = with_emitters(bscene)
    out["bunny"] = area_hard("bunny", Renderer(bscene_e, RenderConfig(method="binary", **cfg)),
                             bcam)
    bsoft_rays = morton_rays(bcam)
    out["bunny_soft"] = area_soft("bunny", make_tracer(bscene_e, "binary", band=BAND),
                                  bsoft_rays)
    chunk = (WIDTH * HEIGHT) // FIT_CHUNKS
    out["overview_soft"] = area_soft("overview_chunk0", make_tracer(scene_e, "wide8", band=BAND),
                                     rays_slice(morton_rays(over_cam), slice(0, chunk)))
    t0 = time.perf_counter()
    out["packet"] = {"bunny": area_packet("bunny", bscene_e, bcam),
                     "main": area_packet("main", scene_e, cam)}
    out["packet"]["bunny_soft"] = area_packet_soft(
        "bunny", make_tracer(bscene_e, "packet", band=BAND), bsoft_rays,
        out["bunny_soft"].pop("img"))
    out["overview_soft"].pop("img")
    phase("area", method="packet", seconds=f"{time.perf_counter() - t0:.1f}")
    return out


@torch.no_grad()
def spp_view(view: str, r: Renderer, cam: Camera) -> dict:
    """[spp]: r.render(cam) with the renderer's spp and light samples, as a
    user renders converged soft shadows (the generator Renderer seeds with
    light_seed).  The image must be finite (H, W, 3) and bitwise the replay
    of render_image's loop: from a generator seeded the same, for each
    sample sample_square and then render_rays (whose emitter draw follows)
    on the Morton-ordered jittered rays, summed in order and divided once.
    closest8 must be launched once a sample and occluded8 twice (the point
    lights, then the area rays).  The frame's ms (CUDA events around
    r.render, 2 warm-ups, 10 calls: the host's Morton permutation of the
    pixels included, as a user pays it), its area shadow rays a second, and
    samples_ms, the replay's (the permutation made once)."""
    cfg, dev = r.config, cam.eye.device
    n = cam.num_pixels
    reset_launches()
    img, s_render = sync_time(lambda: r.render(cam))
    launches = launch_counts()
    perm, inv = (torch.as_tensor(x, device=dev) for x in pixel_morton_perm(cam.height, cam.width))

    def replay():
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.light_seed)
        acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        for _ in range(cfg.spp):
            rays = gen_primary_rays(cam, sample_square(g, (n,)))
            acc = acc + render_rays(r.tracer, Rays(o=rays.o[perm], d=rays.d[perm]), generator=g,
                                    **cfg.render_kwargs())[inv]
        return (acc / cfg.spp).reshape(cam.height, cam.width, 3)

    same = bitwise_equal(img, replay())
    ms = cuda_ms(lambda: r.render(cam))
    samples_ms = cuda_ms(replay)
    n_area = cfg.spp * cfg.light_samples * n
    finite = bool(torch.isfinite(img).all())
    any_hit_calls = 1 + (r.tracer.scene.lights.pos.shape[0] > 0)
    phase("spp", view=view, method=cfg.method, spp=cfg.spp, light_samples=cfg.light_samples,
          shape=tuple(img.shape), finite=finite, replay_bitwise=same,
          render_s=f"{s_render:.3f}", launches=json.dumps(launches), frame_ms=f"{ms:.4f}",
          samples_ms=f"{samples_ms:.4f}",
          area_shadow_rays=n_area, area_rays_per_s=f"{n_area / (ms * 1e-3):.1f}",
          mean=f"{float(img.mean()):.5f}")
    if tuple(img.shape) != (cam.height, cam.width, 3) or not finite:
        fail(f"spp ({view}): the image is not a finite (H, W, 3) array")
    if launches["closest8"] != cfg.spp or launches["occluded8"] != any_hit_calls * cfg.spp:
        fail(f"spp ({view}): launches {launches}, not {cfg.spp} closest8 and "
             f"{any_hit_calls * cfg.spp} occluded8")
    if not same:
        fail(f"spp ({view}): the image is not the mean of its replayed samples")
    return dict(ms=ms, samples_ms=samples_ms, launches=launches)


@torch.no_grad()
def area_packet(view: str, scene_e, cam: Camera) -> dict:
    """[area] through tpurt's packet engine: Renderer(method="packet",
    light_samples AREA_SAMPLES) renders the hard area frame as a user does
    (row-major rays), with that run's launches; packet_occluded's flags on
    the S x R area shadow rays (recorded from the render) must equal
    occluded_bin's on the same rays bitwise (an exact any-hit test either
    way); the image is held to the binary engine's area frame (the same
    emitters and seed) by tpurt's golden rule, and the pixels that differ
    at all are counted.  Frame ms (CUDA events) split into packet_closest
    on the row-major frame, packet_occluded on the point-light and area
    rays, and glue."""
    cfg = dict(light_samples=AREA_SAMPLES, light_seed=AREA_SEED)
    r, s_init = sync_time(lambda: Renderer(scene_e, RenderConfig(method="packet", **cfg)))
    tracer, packed = r.tracer, r.tracer.packed
    record = {}
    reset_launches()
    with recording(pipeline_mod, ["occluded_packet"], record):
        img, s_render = sync_time(lambda: r.render(cam))
    launches = launch_counts()
    calls = record["occluded_packet"]
    (al_rays, _, t_al), flags = calls[-1][0], calls[-1][2]
    (pt_rays, _, t_pt) = calls[0][0]
    bin_flags = kb.occluded_packed(al_rays, packed, t_al)
    flag_differ = int((flags != bin_flags).sum())
    unexplained = packet_flag_rays(view, packed, al_rays, t_al, flags, bin_flags)
    ref = Renderer(scene_e, RenderConfig(method="binary", **cfg)).render(cam)
    off = float(((img - ref).abs().amax(dim=-1) > IMAGE_ATOL).float().mean())
    differing = int((img != ref).any(dim=-1).sum())
    frame = gen_primary_rays(cam)
    ms = {"frame": cuda_ms(lambda: r.render(cam), iters=5, warmup=1),
          "closest": cuda_ms(lambda: kp.traverse_packet(frame, packed), iters=5, warmup=1),
          "occluded_point": cuda_ms(lambda: kp.occluded_packet(pt_rays, packed, t_pt),
                                    iters=5, warmup=1),
          "occluded_area": cuda_ms(lambda: kp.occluded_packet(al_rays, packed, t_al),
                                   iters=5, warmup=1)}
    ms["occluded"] = ms["occluded_point"] + ms["occluded_area"]
    ms["glue"] = ms["frame"] - ms["closest"] - ms["occluded"]
    n_area = al_rays.o.shape[0]
    finite = bool(torch.isfinite(img).all())
    phase("area", view=view, method="packet", path="hard", rays=cam.num_pixels,
          light_samples=AREA_SAMPLES, area_shadow_rays=n_area, shape=tuple(img.shape),
          finite=finite, init_s=f"{s_init:.3f}", render_s=f"{s_render:.3f}",
          launches=json.dumps(launches), blocked_frac=f"{float(flags.float().mean()):.4f}",
          vs_occluded_bin_flag_differing=flag_differ, flags_unexplained=unexplained,
          vs_binary_off_frac=off,
          vs_binary_differing_pixels=differing, **{f"{k}_ms": f"{v:.4f}" for k, v in ms.items()},
          area_rays_per_s=f"{n_area / (ms['frame'] * 1e-3):.1f}", mean=f"{float(img.mean()):.5f}")
    if tuple(img.shape) != (cam.height, cam.width, 3) or not finite:
        fail(f"area ({view}, packet): the image is not a finite (H, W, 3) array")
    any_hit_calls = 1 + (scene_e.lights.pos.shape[0] > 0)
    if (n_area != AREA_SAMPLES * cam.num_pixels or launches["packet_closest"] != 1
            or launches["packet_occluded"] != any_hit_calls):
        fail(f"area ({view}, packet): {n_area} area shadow rays, launches {launches}")
    if unexplained:
        FAILURES.append(f"area ({view}, packet): {unexplained} of the {flag_differ} area shadow "
                        f"ray flags that differ from occluded_bin's are not blocked through "
                        f"their packet")
    if off > IMAGE_OFF_FRAC:
        fail(f"area ({view}, packet): the image differs from the binary frame on {off} of "
             f"pixels")
    return dict(ms=ms, launches=launches, n_area=n_area)


def packet_flag_rays(view: str, packed, rays: Rays, t_max, got: torch.Tensor,
                     ref: torch.Tensor) -> int:
    """The rays whose packet_occluded flag (got) differs from occluded_bin's
    (ref), the first PRINTED_RAYS printed under [area] with their bits and
    blocking triangles.  A packet enters every leaf that any of its rays
    wants and tests all of its rays there, so a ray can be blocked through
    its packet by a triangle its own walk never reaches: one whose hit lies
    outside the triangle's box along the ray (ROADMAP P6), or any, for a
    ray whose own slab tests all fail (a direction component in
    [-1e-30, 0), P1).  Such a ray is explained when the packet flags it,
    the binary walk does not, the exact any-hit test over every triangle
    row of the tree (mt9 and blocks, the kernels' arithmetic) finds a
    blocker, and every blocker's hit lies outside its box, or the ray is
    P1's.  Returns the number not explained."""
    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(o.shape[0])
    p1 = ray_groups(rays)["p1_like"]
    rows = packed.tri_rows[:, :72].reshape(1, -1, 9)
    ids = packed.tri_ids.reshape(1, -1)
    unexplained = 0
    for j, i in enumerate(torch.nonzero(got != ref)[:, 0].tolist()):
        t, u, v, det = mt9(o[i:i + 1], d[i:i + 1], rows)
        hit = blocks(t, u, v, det, ids, DEFAULT_T_MIN, tm[i])[0]
        blockers = [(float(t[0, k]), int(ids[0, k])) for k in torch.nonzero(hit)[:, 0].tolist()]
        outside = [hit_outside_box(packed, o[i], d[i], tk, tri) for tk, tri in blockers]
        explained = (bool(got[i]) and not bool(ref[i]) and bool(blockers)
                     and (all(outside) or bool(p1[i])))
        unexplained += not explained
        if j < PRINTED_RAYS:
            phase("area", view=view, method="packet", differing_ray=i,
                  o=json.dumps([float(x).hex() for x in o[i].tolist()]),
                  d=json.dumps([float(x).hex() for x in d[i].tolist()]),
                  t_max=float(tm[i]).hex(), packet_flag=bool(got[i]), binary_flag=bool(ref[i]),
                  blockers=json.dumps([[tri, tk] for tk, tri in blockers]),
                  outside_box=json.dumps(outside), p1=bool(p1[i]), explained=explained)
    return unexplained


def area_packet_soft(view: str, tracer: Tracer, rays: Rays, ref_img: torch.Tensor) -> dict:
    """The soft area-light render through the packet engine (packet_knear)
    on the rays area_soft rendered through the binary engine, with its
    d/d(verts, albedo) of sum(w * color) as area_soft takes it: the forward
    and the gradients finite, packet_knear launched for the layers and each
    light set's occluders, the image within tpurt's golden rule of the
    binary soft image (ref_img); its launches and forward ms."""
    scene, dev = tracer.scene, rays.o.device
    w = torch.rand((rays.o.shape[0], 3), generator=seeded(dev), device=dev)
    verts = scene.tris.verts.detach().clone().requires_grad_(True)
    albedo = scene.tris.albedo.detach().clone().requires_grad_(True)
    tris = dataclasses.replace(scene.tris, verts=verts, albedo=albedo)
    tr = dataclasses.replace(tracer, scene=dataclasses.replace(scene, tris=tris),
                             table=tri_table(tris))
    reset_launches()
    t0 = time.perf_counter()
    color = render_rays(tr, rays, light_samples=AREA_SAMPLES, generator=seeded(dev), **SOFT)
    grads = torch.autograd.grad(torch.sum(w * color), (verts, albedo))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    img = color.detach()
    off = float(((img - ref_img).abs().amax(dim=-1) > IMAGE_ATOL).float().mean())
    g = seeded(dev)
    with torch.no_grad():
        ms = cuda_ms(lambda: render_rays(tracer, rays, light_samples=AREA_SAMPLES, generator=g,
                                         **SOFT), iters=3, warmup=1)
    finite = bool(torch.isfinite(img).all()) and all(bool(torch.isfinite(x).all()) for x in grads)
    phase("area", view=view, method="packet", path="soft", rays=rays.o.shape[0],
          light_samples=AREA_SAMPLES, launches=json.dumps(launches), finite=finite,
          seconds=f"{secs:.3f}", vs_binary_off_frac=off,
          vs_binary_differing_pixels=int((img != ref_img).any(dim=-1).sum()),
          grad_norms=json.dumps([float(x.norm()) for x in grads]), forward_ms=f"{ms:.4f}")
    if not finite or launches["packet_knear"] != 2 + (scene.lights.pos.shape[0] > 0):
        fail(f"area ({view}, packet soft): finite {finite}, launches {launches}")
    if off > IMAGE_OFF_FRAC:
        fail(f"area ({view}, packet soft): off the binary soft image on {off} of rays")
    return dict(ms=ms, launches=launches)


# ---------------------------------------------------------------------------
# tpurt's count split rule ([split_rule]) and refit_wide ([refit_wide])
# ---------------------------------------------------------------------------
@torch.no_grad()
def split_rule_phase(scene, bvh: BVH, area_wide: WideBVH, views: dict) -> dict:
    """[split_rule]: the 1M sponza's wide tree collapsed with split_rule
    "count" (the frontier node with the most triangles split first) beside
    the default "area" tree, on each view's Morton-ordered frame (views:
    name -> rays).  closest8 on the frame and occluded8 on its shadow rays
    against their twins on the count tree, every ray's id, flag and t/u/v
    and shading bits (any that differs fails the script at its end); the
    bound from the count tree's own twin walk counts; then in turns area,
    count, count, area each kernel's ms (CUDA events around the wrapper),
    its device ms (bare launches) and the hard frame's ms on each tree,
    and the count / area ratios.  The default stays "area"."""
    t0 = time.perf_counter()
    topo, s_collapse = sync_time(lambda: collapse_wide(scene.tris, bvh, split_rule="count"))
    wide, s_pack = sync_time(lambda: pack_wide(scene.tris, bvh, *topo))
    phase("split_rule", rule="count", wides=wide.num_wides, tri_rows=wide.num_rows,
          max_stack=wide.max_stack, area_wides=area_wide.num_wides,
          area_max_stack=area_wide.max_stack, collapse_s=f"{s_collapse:.3f}",
          pack_s=f"{s_pack:.3f}")
    trees = {"area": area_wide, "count": wide}
    tracers = {k: Tracer(scene=scene, bvh=bvh, wide=w, method="wide8") for k, w in trees.items()}
    lib, out = this_library(), {}
    for view, frame in views.items():
        n = frame.o.shape[0]
        hk, shk = k8.traverse_wide8(frame, wide, shade_out=True)
        stats_c, stats_o = {}, {}

        def closest_twin(lo: int, hi: int):
            h, sh = k8.traverse_wide8_ref(rays_slice(frame, slice(lo, hi)), wide,
                                          shade_out=True, stats=stats_c)
            return (h.tri, h.t, h.u, h.v, *sh)

        ref, plain_c = chunked(closest_twin, n)
        c_differ = differing_bits(tuple(ref), (hk.tri, hk.t, hk.u, hk.v, *shk))
        hr = Hit(tri=ref[0], t=ref[1], u=ref[2], v=ref[3])
        p, nrm, _, _ = hit_surface(tracers["count"], frame, hr, tuple(ref[4:]))
        sh_rays, t_sh = shadow_rays(scene, p, nrm, hr.valid)
        n_sh = sh_rays.o.shape[0]
        bk = k8.occluded_wide8(sh_rays, wide, t_sh)
        (br,), plain_o = chunked(lambda lo, hi: (k8.occluded_wide8_ref(
            rays_slice(sh_rays, slice(lo, hi)), wide, t_sh[lo:hi], stats=stats_o),), n_sh)
        o_differ = int((bk != br).sum())
        bounds = {"closest8": bound(k8.walk_counts(stats_c), n, 24, 52),
                  "occluded8": bound(k8.walk_counts(stats_o), n_sh, 28, 1, WIDE_HALF)}
        del ref, hr, p, nrm, bk, br
        turns = []
        for name in ("area", "count", "count", "area"):
            w = trees[name]
            turns.append((name, {
                "closest8": cuda_ms(lambda: k8.traverse_wide8(frame, w, shade_out=True), iters=5),
                "closest8_device": launch_ms(lib, "closest8", w, [(frame, None, None)], passes=10),
                "occluded8": cuda_ms(lambda: k8.occluded_wide8(sh_rays, w, t_sh), iters=5),
                "occluded8_device": launch_ms(lib, "occluded8", w, [(sh_rays, None, t_sh)],
                                              passes=10),
                "frame": cuda_ms(lambda: render_rays(tracers[name], frame), iters=5)}))
        mean = {name: {k: float(np.mean([t[k] for s, t in turns if s == name]))
                       for k in turns[0][1]} for name in trees}
        ratio = {k: mean["count"][k] / mean["area"][k] for k in turns[0][1]}
        out[view] = dict(ms=mean, ratio=ratio, bound=bounds, differ=c_differ + o_differ)
        phase("split_rule", view=view, rays=n, shadow_rays=n_sh, closest8_differing=c_differ,
              occluded8_differing=o_differ, closest8_plain_ms=f"{plain_c:.1f}",
              occluded8_plain_ms=f"{plain_o:.1f}",
              **{f"count_{k}_bound_ms": repr(b["bound_ms"]) for k, b in bounds.items()},
              **{f"{name}_{k}_ms": f"{v:.4f}" for name, m in mean.items() for k, v in m.items()},
              **{f"ratio_{k}": f"{v:.4f}" for k, v in ratio.items()},
              turns=json.dumps([[s, {k: round(v, 4) for k, v in t.items()}] for s, t in turns]))
        for name, b in bounds.items():
            phase("bound", view=f"count_{view}", kernel=name, **b)
        if c_differ or o_differ:
            FAILURES.append(f"split_rule ({view}): {c_differ} closest8 and {o_differ} occluded8 "
                            f"rays differ from the twins' on the count tree")
    phase("split_rule", seconds=f"{time.perf_counter() - t0:.1f}")
    return out


def refit_wide_phase(fit: dict) -> dict:
    """[refit_wide]: the band tree of [fit] (its InverseRenderer's tracer)
    refit at the vertices of one fit step, tpurt's two ways:
    refit_wide over the refit binary tree (refit_aabbs) with the rows from
    the step's table, and refit_wide_direct, which folds the same boxes up
    the wide tree.  tpurt's claim: the boxes are bitwise equal.  wrow must
    equal refit_wide_direct's from the triangles bitwise, and tri_rows
    refit_wide_direct's from the table (the fit's call, whose corners v0 +
    e1 may round an ulp off the vertices, so its wrow is compared and
    counted, not held); each route's ms (CUDA events)."""
    t0 = time.perf_counter()
    tr = fit["inv"].tracer0
    sc = fit["inv"].fit(fit["target"], steps=1).scene
    tris = dataclasses.replace(sc.tris, verts=sc.tris.verts.detach(),
                               albedo=sc.tris.albedo.detach())
    table = tri_table(tris)
    got = refit_wide(tr.wide, refit_aabbs(tr.bvh, tris), tris, table)
    direct = refit_wide_direct(tr.wide, tris)
    fit_route = refit_wide_direct(tr.wide, tris, table)

    def differ(a, b):
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())

    wrow_differ = differ(got.wrow, direct.wrow)
    rows_differ = differ(got.tri_rows, fit_route.tri_rows) + differ(got.tri_rows, direct.tri_rows)
    moved = differ(got.wrow, tr.wide.wrow)
    ms = {"refit_wide": cuda_ms(lambda: refit_wide(tr.wide, refit_aabbs(tr.bvh, tris), tris,
                                                   table), iters=3, warmup=1),
          "refit_wide_direct": cuda_ms(lambda: refit_wide_direct(tr.wide, tris, table),
                                       iters=3, warmup=1)}
    phase("refit_wide", tris=tris.num_tris, band=tr.wide.band, wrow_elements=got.wrow.numel(),
          wrow_differing=wrow_differ, tri_rows_differing=rows_differ,
          wrow_moved_elements=moved,
          table_route_wrow_differing=differ(got.wrow, fit_route.wrow),
          **{f"{k}_ms": f"{v:.4f}" for k, v in ms.items()},
          seconds=f"{time.perf_counter() - t0:.1f}")
    if wrow_differ or rows_differ or not moved:
        FAILURES.append(f"refit_wide: {wrow_differ} wrow and {rows_differ} tri_rows elements "
                        f"differ from refit_wide_direct's ({moved} moved)")
    return dict(ms=ms)


def cli_phase(bscene, bcam: Camera) -> None:
    """The port's verbs as users run them: `python -m tpurt_torch.cli.main`
    subprocesses in a temporary directory, each generating its own scene,
    the independent ones started together (the fit and its resumed run one
    after the other).  Each verb's exit code and seconds; the 5M build's
    metric line, the 4K image's shape, finiteness and hit fraction, the
    bunny image (and the same through render --shard, at world 1 on NCCL)
    against the in-process Renderer's, the fit's checkpoints and its
    resumed run."""
    tmp = tempfile.mkdtemp(prefix="tpurt_torch_cli_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(HERE, "src"), os.environ.get("PYTHONPATH")) if p))

    def call(verb: str, *argv: str):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "tpurt_torch.cli.main", verb, *argv],
                           cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        return verb, argv, p, time.perf_counter() - t0

    def report(done, gate: bool = True):
        verb, argv, p, seconds = done
        phase("cli", verb=verb, argv=json.dumps(list(argv)), rc=p.returncode,
              seconds=f"{seconds:.2f}")
        if gate and p.returncode != 0:
            fail(f"cli {verb} {argv}: exit {p.returncode}\n{p.stdout[-2000:]}\n{p.stderr[-4000:]}")
        return p

    ck = os.path.join(tmp, "ckpt")
    fit = ["--scene", "cornell", "--width", "32", "--method", "wide8", "--ckpt", ck,
           "--ckpt-every", "2"]

    def fit_then_resume():
        first = call("fit", *fit, "--steps", "6")
        saved = sorted(os.listdir(ck)) if os.path.isdir(ck) else []
        return first, saved, call("fit", *fit, "--steps", "8")

    try:
        with ThreadPoolExecutor(max_workers=6) as pool:
            jobs = {
                "build": pool.submit(call, "build-bvh", "--scene", "sponza5m"),
                "render5m": pool.submit(call, "render", "--scene", "sponza5m", "--method",
                                        "wide8", "-o", "x.npy"),
                "bunny": pool.submit(call, "render", "--scene", "bunny", "--method", "binary",
                                     "-o", "y.npy"),
                # --shard alone: a world-1 NCCL group, the rays sharded over it
                "shard": pool.submit(call, "render", "--shard", "--scene", "bunny", "--method",
                                     "binary", "-o", "z.npy"),
                "fit": pool.submit(fit_then_resume),
                "grads": pool.submit(call, "check-grads", "--scene", "cornell", "--width",
                                     str(FD_RES), "--method", "wide8")}
            ref = Renderer(bscene, RenderConfig(method="binary")).render(bcam).cpu().numpy()
            done = {name: job.result() for name, job in jobs.items()}
        p = report(done["build"])
        row = json.loads(p.stdout.strip().splitlines()[-1])
        phase("cli", verb="build-bvh", metric=row["metric"], tris=row["tris"],
              tris_per_s=f"{row['value']:.1f}", seconds=f"{row['seconds']:.4f}")
        report(done["render5m"])
        img = np.load(os.path.join(tmp, "x.npy"))
        bg = np.asarray([0.35, 0.45, 0.65], np.float32)
        hit = float(np.any(img != bg, axis=-1).mean())
        finite = bool(np.isfinite(img).all())
        phase("cli", verb="render", scene="sponza5m", shape=img.shape, finite=finite,
              hit_frac=f"{hit:.4f}", mean=f"{float(img.mean()):.5f}")
        if img.shape != (HEIGHT_5M, WIDTH_5M, 3) or not finite or not 0.0 < hit <= 1.0:
            fail(f"cli render sponza5m: shape {img.shape}, finite {finite}, hit {hit}")
        del img
        report(done["bunny"])
        img = np.load(os.path.join(tmp, "y.npy"))
        same = img.shape == ref.shape and bool(np.array_equal(img, ref))
        phase("cli", verb="render", scene="bunny", shape=img.shape, equal_to_renderer=same)
        if not same:
            fail("cli render bunny: the image differs from the in-process Renderer's")
        report(done["shard"])
        sharded = np.load(os.path.join(tmp, "z.npy"))
        phase("cli", verb="render --shard", scene="bunny",
              equal_to_renderer=bool(np.array_equal(sharded, ref)))
        if not np.array_equal(sharded, ref):
            fail("cli render --shard bunny: the image differs from the in-process Renderer's")
        first, saved, second = done["fit"]
        report(first)
        report(second, gate=False)  # two steps need not lower the loss
        resumed = sorted(set(os.listdir(ck)) - set(saved))
        phase("cli", verb="fit", checkpoints=json.dumps(saved), resumed_wrote=json.dumps(resumed))
        if saved != [f"ckpt_{s:08d}.pt" for s in (2, 4, 6)] or resumed != ["ckpt_00000008.pt"]:
            fail(f"cli fit: checkpoints {saved}, then {resumed}")
        report(done["grads"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# [bench]: the verb's flags beyond its defaults, the headline row's keys that
# must be positive, and the subprocess's time limit.
BENCH_FLAGS = ("--parity", "--staged", "--sort-bench")
BENCH_VALUES = ("value", "value_fwd_bwd", "value_5m", "value_5m_fwd_bwd", "value_5m_ring")
BENCH_TIMEOUT_S = 600
# --sort-bench's key counts on the card (tpurt's _run_sort_bench sizes).
SORT_BENCH_KEYS = (1 << 20, 5 << 20)


def bench_phase() -> dict:
    """[bench]: `python -m tpurt_torch.cli.main bench --parity --staged
    --sort-bench --profile-dir DIR` as a user runs it, in a subprocess in a
    temporary directory (the kernels it launches are this checkout's,
    already built): the 1M fwd and fwd_bwd rows, the 5M rows, the staged
    rows, the kernels' parity against their twins and the sort rows.  Each
    JSON row it printed, then the headline's numbers on their own line.
    Fails unless it exits 0 with a headline row last that parses, names
    wide8 as the engine that ran, carries no error and every BENCH_VALUES
    key above 0, its profile trace was written, and a sort row of each of
    SORT_BENCH_KEYS says its keys came out sorted."""
    tmp = tempfile.mkdtemp(prefix="tpurt_torch_bench_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(HERE, "src"), os.environ.get("PYTHONPATH")) if p))
    argv = [sys.executable, "-m", "tpurt_torch.cli.main", "bench", *BENCH_FLAGS,
            "--profile-dir", "trace"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        p = subprocess.run(argv, cwd=tmp, env=env, capture_output=True, text=True,
                           timeout=BENCH_TIMEOUT_S)
        traced = os.path.exists(os.path.join(tmp, "trace", "trace.json"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    out = p.stdout.strip().splitlines()
    for ln in out[:-1] + p.stderr.splitlines():  # the 5M rows, then the stderr rows
        if ln.startswith("{"):
            phase("bench", row=ln)
    try:
        row = json.loads(out[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"bench: no headline row (exit {p.returncode})\n{p.stdout[-2000:]}\n"
             f"{p.stderr[-4000:]}")
    phase("bench", argv=json.dumps(argv[3:]), rc=p.returncode, seconds=f"{seconds:.1f}",
          traced=traced, **{k: v for k, v in row.items() if not isinstance(v, dict)})
    bad = [k for k in BENCH_VALUES if not row.get(k, 0) > 0]
    if p.returncode != 0 or "error" in row or row.get("engine_ran") != "wide8" or bad or not traced:
        fail(f"bench: exit {p.returncode}, error {row.get('error')}, engine_ran "
             f"{row.get('engine_ran')}, values missing or <= 0 {bad}, trace written {traced}\n"
             f"{p.stderr[-4000:]}")
    sorts = [json.loads(ln) for ln in p.stderr.splitlines()
             if ln.startswith("{") and '"sort_bench"' in ln]
    if ([r["keys"] for r in sorts] != list(SORT_BENCH_KEYS)
            or not all(r["sorted"] and r["ms"] > 0 for r in sorts)):
        fail(f"bench: the --sort-bench rows are not {SORT_BENCH_KEYS} keys, each sorted: {sorts}")
    row["sort_bench"] = sorts
    return row


# ---------------------------------------------------------------------------
# The distributed paths ([dist_*]): dist/ at world 1 under NCCL
# ---------------------------------------------------------------------------
# [dist_fold]: the scene split into this many partitions on the one card,
# each walked and folded in the order rank 0's rays meet them; the bunny
# (69,940 triangles) into 3, whose last chunk then holds 2 padding rows, so
# the binary and packet kernels meet -1 slots and zero rows (the 1M
# sponza's 999,968 split into 4 have none).
FOLD_PARTS, FOLD_PARTS_BUNNY = 4, 3
# Whole packets of a block held to the twins where the twins of every ray
# would take minutes (the packet walk's twin took 38,793 ms on the 1M main
# view): packets are independent, so a sample of whole packets checks what
# the whole block would.
SAMPLE_PACKETS = 64


def dist_setup():
    """The process group and mesh every [dist_*] phase runs on: one card,
    so world 1, over NCCL (no fallback: a group that does not come up on
    NCCL fails the script)."""
    init_distributed(device="cuda")
    mesh = make_mesh("cuda")
    backend = dist.get_backend(mesh.get_group())
    phase("dist", backend=backend, world=dist.get_world_size(), mesh=tuple(mesh.mesh.shape),
          nccl=torch.cuda.nccl.version())
    if backend != "nccl" or mesh.size() != 1:
        fail(f"the dist phases need a world-1 NCCL group, got {backend} of {mesh.size()}")
    return mesh


@contextlib.contextmanager
def recording(module, names, record: dict, timed: bool = False):
    """module's functions `names` wrapped for the duration: each call's
    (args, kwargs, output) appended to record[name]; timed: its seconds
    (host clock between synchronizes) added to record[name + "_s"]."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(n, fn):
        def run(*a, **kw):
            if timed:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out = fn(*a, **kw)
            if timed:
                torch.cuda.synchronize()
                record[n + "_s"] = record.get(n + "_s", 0.0) + time.perf_counter() - t0
            record.setdefault(n, []).append((a, kw, out))
            return out
        return run

    try:
        for n in names:
            setattr(module, n, wrap(n, saved[n]))
        yield record
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


@dataclasses.dataclass
class FoldTracer(Tracer):
    """The ring's local steps (dist/ring.py closest_step, occluded_step,
    knear_step) over several partitions' trees on one card, in the order
    rank 0's rays meet them, each walked by the ring engine `engine`: the
    render pipeline's engine calls, each folded partition by partition.
    log: each call's folded output, by call; inputs: each hard call's rays
    (and t_max), by call."""

    parts: list = dataclasses.field(default_factory=list)
    engine: str | None = None
    log: dict = dataclasses.field(default_factory=dict)
    inputs: dict = dataclasses.field(default_factory=dict)

    def closest_shaded(self, rays: Rays):
        o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
        best = ring_mod.closest_init(o.shape[0], o.device)
        for p in self.parts:
            best = ring_mod.closest_step(o, d, best, p, engine=self.engine)
        self.log.setdefault("closest", []).append(best)
        self.inputs.setdefault("closest", []).append((o, d))
        return Hit(**{k: v.reshape(rays.shape) for k, v in best.items()}), None

    def visibility(self, rays: Rays, t_max) -> torch.Tensor:
        o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
        tm = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(rays.shape)
        tm = tm.reshape(-1)
        blocked = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        for p in self.parts:
            blocked = ring_mod.occluded_step(o, d, tm, blocked, p, engine=self.engine)
        self.log.setdefault("occluded", []).append(blocked)
        self.inputs.setdefault("occluded", []).append((o, d, tm))
        return 1.0 - blocked.reshape(rays.shape).float()

    def _knear(self, rays: Rays, t_max, k: int, band: float, call: str) -> torch.Tensor:
        o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
        tm = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(rays.shape)
        ts, ids = ring_mod.knear_init(o.shape[0], k, o.device)
        with torch.no_grad():
            for p in self.parts:
                ts, ids = ring_mod.knear_step(o, d, tm.reshape(-1), ts, ids, p, self.table,
                                              k, band, engine=self.engine)
        ids = torch.where(ids == BIG_ID, -1, ids)
        self.log.setdefault(call, []).append(ids)
        return ids

    def k_nearest(self, rays: Rays, k: int, band: float) -> KHits:
        ids = self._knear(rays, T_MAX, k, band, "layers")
        z = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
        return KHits(t=z, u=z, v=z, tri=ids.reshape(*rays.shape, k))

    def occluder_ids(self, rays: Rays, t_max, k_occ: int, band: float) -> torch.Tensor:
        return self._knear(rays, 2.0 * torch.as_tensor(t_max), k_occ, band, "occluders")


def fold_logs_equal(view: str, kernel_log: dict, twin_log: dict) -> dict:
    """The fold through the kernels against the same fold through their
    twins: differing ids, flags and k-lists (each fails the script), and
    the largest |t, u, v - twin's| on agreeing rays (must be 0)."""
    out = {}
    for call, outs in kernel_log.items():
        for got, ref in zip(outs, twin_log[call]):
            if call == "closest":
                same = got["tri"] == ref["tri"]
                out[f"{call}_differing"] = out.get(f"{call}_differing", 0) + int((~same).sum())
                out["max_abs_tuv"] = max([out.get("max_abs_tuv", 0.0)] + [
                    max_abs(got[k][same], ref[k][same]) for k in ("t", "u", "v")])
            else:
                bad = (got != ref).reshape(got.shape[0], -1).any(dim=1)
                out[f"{call}_differing"] = out.get(f"{call}_differing", 0) + int(bad.sum())
    for key, v in out.items():
        if v:
            FAILURES.append(f"dist_fold ({view}): {key} = {v} against the twins' fold")
    return out


def fold_tracers(scene, parts: list, engine: str) -> tuple:
    """A FoldTracer over `parts` walked by `engine` and its twin-route copy
    (its own log)."""
    table = tri_table(scene.tris)
    return tuple(FoldTracer(scene=scene, table=table, method="fold", parts=parts, engine=engine)
                 for _ in range(2))


def packet_sample(n: int, count: int = SAMPLE_PACKETS) -> torch.Tensor:
    """Ray indices of `count` whole packets of an n-ray block (packet p is
    rays [1024 p, 1024 p + 1024)), spread evenly over it, in order, the
    last one included: laid end to end they keep each packet's rays
    together, and a partial last packet stays last."""
    p = -(-n // kp.PACKET_RAYS)
    pk = torch.unique(torch.linspace(0, p - 1, min(count, p)).round().long())
    idx = (pk[:, None] * kp.PACKET_RAYS + torch.arange(kp.PACKET_RAYS)).reshape(-1)
    return idx[idx < n]


def sampled_fold(fold: FoldTracer, twin: FoldTracer) -> tuple[dict, dict]:
    """The twin fold (twin_route) of the hard calls that `fold` made, on
    SAMPLE_PACKETS whole packets of each call's rays: (the kernel fold's
    outputs on those rays, the twins'), as logs for fold_logs_equal."""
    got = {}
    for call, ((o, d, *tm),) in ((c, x[:1]) for c, x in fold.inputs.items()):
        idx = packet_sample(o.shape[0]).to(o.device)
        rays = Rays(o=o[idx], d=d[idx])
        with twin_route():
            if call == "closest":
                twin.closest_shaded(rays)
            else:
                twin.visibility(rays, tm[0][idx])
        out = fold.log[call][0]
        got[call] = [{k: v[idx] for k, v in out.items()} if call == "closest" else out[idx]]
    return got, {call: twin.log[call][:1] for call in got}


def fold_view(view: str, scene, frame: Rays, ref_tracer: Tracer, parts: list,
              soft_rays: Rays | None = None, soft_ref: Tracer | None = None,
              soft_parts: list | None = None, engine: str = "wide8",
              sample: bool = False) -> dict:
    """[dist_fold] on one view: the hard frame through the ring's local
    steps over `parts` walked by `engine` (closest and any hit), its
    launches, the same fold through the twins on the card (0 differing ids
    and flags; sample: on SAMPLE_PACKETS whole packets of each call, not on
    every ray), its image against ref_tracer's replicated render
    (IMAGE_ATOL on at most 0.3% of pixels) and its ms; with soft_rays, the
    soft render (SOFT) of those rays over soft_parts (band trees; the
    k-nearest calls k 4 and k_occ 8), its k-lists against the twins' fold
    and its image against soft_ref's."""
    fold, twin = fold_tracers(scene, parts, engine)
    with torch.no_grad():
        reset_launches()
        img = render_rays(fold, frame)
        launches = launch_counts()
        t0 = time.perf_counter()
        if sample:
            kernel_log, twin_log = sampled_fold(fold, twin)
        else:
            with twin_route():
                render_rays(twin, frame)
            kernel_log = {k: fold.log[k][:1] for k in fold.log}
            twin_log = {k: twin.log[k][:1] for k in twin.log}
        s_twin = time.perf_counter() - t0
        ref = render_rays(ref_tracer, frame)
        ms = cuda_ms(lambda: render_rays(fold, frame), iters=3, warmup=1)
        ref_ms = cuda_ms(lambda: render_rays(ref_tracer, frame), iters=3, warmup=1)
    diff = image_diff(img, ref)
    eq = fold_logs_equal(view, kernel_log, twin_log)
    names, _ = HARD_KERNELS[engine]
    out = {"launches": launches}
    held = ({call: int(x[0].shape[0] if call != "closest" else x[0]["tri"].shape[0])
             for call, x in kernel_log.items()})
    phase("dist_fold", view=view, engine=engine, path="hard", parts=len(parts),
          rays=frame.o.shape[0], launches=json.dumps(launches),
          twin_rays=json.dumps(held), twin_s=f"{s_twin:.1f}", **eq,
          vs_replicated_max_abs=diff["max_abs"], vs_replicated_off_frac=diff["off_frac"],
          fold_frame_ms=f"{ms:.4f}", replicated_frame_ms=f"{ref_ms:.4f}")
    if diff["off_frac"] > IMAGE_OFF_FRAC:
        fail(f"dist_fold ({view}): the fold's image differs on {diff['off_frac']} of pixels")
    for k in names:
        if launches[k] != len(parts):
            fail(f"dist_fold ({view}): {k} launched {launches[k]} times, not {len(parts)}")
    if soft_rays is None:
        return out
    fold, twin = fold_tracers(scene, soft_parts, engine)
    with torch.no_grad():
        reset_launches()
        color = render_rays(fold, soft_rays, **SOFT)
        out["soft_launches"] = launch_counts()
        t0 = time.perf_counter()
        with twin_route():
            render_rays(twin, soft_rays, **SOFT)
        s_twin = time.perf_counter() - t0
        ref = render_rays(soft_ref, soft_rays, **SOFT)
        ms = cuda_ms(lambda: render_rays(fold, soft_rays, **SOFT), iters=3, warmup=1)
    diff = image_diff(color, ref)
    eq = fold_logs_equal(view, fold.log, twin.log)
    kn = KNEAR_KERNEL[engine]
    phase("dist_fold", view=view, engine=engine, path="soft", parts=len(soft_parts),
          rays=soft_rays.o.shape[0], launches=json.dumps(out["soft_launches"]),
          twin_s=f"{s_twin:.1f}", **eq,
          nonempty_layer_lists=int((fold.log["layers"][0][:, 0] >= 0).sum()),
          vs_replicated_max_abs=diff["max_abs"], vs_replicated_off_frac=diff["off_frac"],
          fold_soft_ms=f"{ms:.4f}")
    if diff["off_frac"] > IMAGE_OFF_FRAC:
        fail(f"dist_fold ({view}, soft): the fold's colors differ on {diff['off_frac']} of rays")
    if out["soft_launches"][kn] != 2 * len(soft_parts):
        fail(f"dist_fold ({view}, soft): {kn} launched {out['soft_launches'][kn]} times")
    return out


def dist_fold(scene, cam: Camera, bscene, bcam: Camera) -> dict:
    """[dist_fold]: the 1M sponza split into FOLD_PARTS Morton partitions
    on the one card, each with its WideBVH (band 0 and band BAND), folded
    through the ring's local steps: the main view's and the overview's hard
    frames (closest8, occluded8), one fit chunk of the main view soft
    (knear8, k 4 and k_occ 8); then its PackedBVHs through the ring's
    "packet" engine, the main view's row-major hard frame (packet_closest,
    packet_occluded; the twins' fold on sampled whole packets).  The bunny
    the same through its PackedBVHs in FOLD_PARTS_BUNNY, hard and soft on
    its whole frame, through the "binary" engine (closest_bin,
    occluded_bin, knear_bin; Morton order) and the "packet" engine
    (packet_closest, packet_occluded, packet_knear; row-major, as the
    ring's packet tracer traces it).  This is where the kernels meet several
    partitions' trees, their -1 padding slots and zeroed rows included, on
    the card."""
    t0 = time.perf_counter()
    part = partition_scene(scene.tris, FOLD_PARTS)
    hard = build_partition_wides(part, scene.tris)
    soft = build_partition_wides(part, scene.tris, band=BAND)
    torch.cuda.synchronize()
    phase("dist_fold", scene="sponza1m", parts=FOLD_PARTS, chunk=part.chunk,
          padding_rows=int((part.gid < 0).sum()), build_s=f"{time.perf_counter() - t0:.3f}",
          wides=[w.num_wides for w in hard])
    rep, rep_soft = make_tracer(scene, "wide8"), make_tracer(scene, "wide8", band=BAND)
    over = Camera.create(eye=OVERVIEW_EYE, target=OVERVIEW_TARGET, fov_y_deg=50.0,
                         width=WIDTH, height=HEIGHT, device=cam.eye.device)
    frame = morton_rays(cam)
    chunk = rays_slice(gen_primary_rays(cam), slice(0, (WIDTH * HEIGHT) // FIT_CHUNKS))
    out = {"main": fold_view("main", scene, frame, rep, hard, chunk, rep_soft, soft),
           "overview": fold_view("overview", scene, morton_rays(over), rep, hard)}
    del hard, soft, rep, rep_soft
    t0 = t_pk = time.perf_counter()
    packed = build_partition_bvhs(part)
    torch.cuda.synchronize()
    phase("dist_fold", scene="sponza1m", engine="packet", parts=FOLD_PARTS,
          build_s=f"{time.perf_counter() - t0:.3f}", leaf_rows=[p.num_leaves for p in packed])
    out["main_packet"] = fold_view("main", scene, gen_primary_rays(cam),
                                   make_tracer(scene, "packet"), packed, engine="packet",
                                   sample=True)
    del packed
    s_packet = time.perf_counter() - t_pk
    bpart = partition_scene(bscene.tris, FOLD_PARTS_BUNNY)
    phase("dist_fold", scene="bunny", parts=FOLD_PARTS_BUNNY, chunk=bpart.chunk,
          padding_rows=int((bpart.gid < 0).sum()))
    bhard, bsoft = build_partition_bvhs(bpart), build_partition_bvhs(bpart, band=BAND)
    bframe = morton_rays(bcam)
    out["bunny"] = fold_view(
        "bunny", bscene, bframe, make_tracer(bscene, "binary"), bhard, bframe,
        make_tracer(bscene, "binary", band=BAND), bsoft, engine="binary")
    t_pk = time.perf_counter()
    brow = gen_primary_rays(bcam)
    out["bunny_packet"] = fold_view(
        "bunny", bscene, brow, make_tracer(bscene, "packet"), bhard, brow,
        make_tracer(bscene, "packet", band=BAND), bsoft, engine="packet")
    phase("dist_fold", engine="packet", seconds=f"{s_packet + time.perf_counter() - t_pk:.1f}")
    return out


def dist_shard(mesh, bscene, bcam: Camera) -> None:
    """[dist_shard]: the ray-sharded render at world 1 (rank 0 renders every
    ray, the film comes back through NCCL's all-gather): shard_render and
    Renderer(mesh=...) equal Renderer.render bitwise (the bunny, binary);
    alltoall_trace on cornell 32^2 (its local trace brute force, as
    tpurt's): at world 1 every ray is resolved, with brute force's hit."""
    single = Renderer(bscene, RenderConfig(method="binary"))
    ref = single.render(bcam)
    sharded = shard_render(single.tracer, bcam, mesh)
    meshed = Renderer(bscene, RenderConfig(method="binary"), mesh=mesh).render(bcam)
    sc, cm = make_cornell_box(device=bcam.eye.device)
    rays = gen_primary_rays(dataclasses.replace(cm, width=32, height=32))
    hit, resolved = alltoall_trace(mesh, rays, partition_scene(sc.tris, 1))
    brute = intersect_brute(rays, sc.tris)
    same = int((hit.tri[resolved] == brute.tri[resolved]).sum())
    ok = (bitwise_equal(sharded, ref) and bitwise_equal(meshed, ref)
          and bool(resolved.all()) and same == rays.o.shape[0])
    phase("dist_shard", shard_render_bitwise=bitwise_equal(sharded, ref),
          renderer_mesh_bitwise=bitwise_equal(meshed, ref), alltoall_rays=rays.o.shape[0],
          resolved=int(resolved.sum()), resolved_equal_brute=same,
          max_abs_t=repr(max_abs(hit.t[resolved], brute.t[resolved])))
    if not ok:
        fail("dist_shard: a sharded render or the all-to-all trace differs")


def dist_fit(mesh, scene, cam: Camera, fit: dict) -> dict:
    """[dist_fit]: InverseRenderer(mesh=...) on the 1M sponza at
    1920x1088, FIT_STEPS steps in FIT_CHUNKS chunks, on [fit]'s problem:
    s/step beside [fit]'s mesh-free fit, exactly FIT_CHUNKS all-reduces a
    step and their bytes, one all-reduce of that size by CUDA events; its
    losses and parameters against the mesh-free fit's.  Under the
    'scatter' backend the backward's atomic adds (index_add_) sum in
    another order on every run, and Adam's first steps turn a gradient near
    0 into a step of +-lr, so two runs of the same fit differ in the
    parameters by up to ~lr (printed: the mesh-free fit against a second
    run of itself, and the mesh's against it; [segsum_rule] counts the
    elements that differ under each backend).  The hold is made with
    PyTorch's deterministic algorithms on, under either backend: the mesh's
    fit and the mesh-free fit, losses and parameters within rtol 1e-4 (the
    largest differences printed)."""
    rcfg = RenderConfig(method="wide8", **SOFT)
    fcfg = FitConfig(steps=FIT_STEPS, grad_chunks=FIT_CHUNKS, lr=FIT_LR)
    per_step, secs, t_last = [], [], [0.0]

    def on_step(i: int, loss: float) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        secs.append(now - t_last[0])
        t_last[0] = now
        per_step.append(dict(coll_mod.COUNTS))
        coll_mod.reset_counts()

    def run(m, callback=None):
        return InverseRenderer(scene, cam, fit=fcfg, render=rcfg, mesh=m).fit(
            fit["target"], callback=callback)

    reset_launches()
    coll_mod.reset_counts()
    torch.cuda.synchronize()
    t_last[0] = time.perf_counter()
    res = run(mesh, on_step)
    launches = launch_counts()
    again = run(None)
    ref = fit["result"]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det = {"mesh": run(mesh), "mesh_free": run(None)}
    finally:
        torch.use_deterministic_algorithms(False)
    n_bytes = per_step[0]["all_reduce_bytes"] // max(per_step[0]["all_reduce"], 1)
    buf = torch.zeros(n_bytes // 4, dtype=torch.float32, device=cam.eye.device)
    ar_ms = cuda_ms(lambda: dist.all_reduce(buf, group=mesh.get_group()), iters=20)

    def loss_rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a.losses, b.losses))

    def params_diff(a, b, tag):
        out = {}
        for k in b.params:
            x, y = a.params[k], b.params[k]
            out[f"{tag}_{k}_max_abs"] = max_abs(x, y)
            out[f"{tag}_{k}_max_rel"] = float(((x - y).abs() / y.abs().clamp_min(1e-6)).max())
        return out

    det_close = all(bool(torch.allclose(det["mesh"].params[k], det["mesh_free"].params[k],
                                        rtol=1e-4, atol=1e-6)) for k in ref.params)
    det_loss = loss_rel(det["mesh"], det["mesh_free"])
    phase("dist_fit", tris=scene.num_tris, steps=FIT_STEPS, chunks=FIT_CHUNKS,
          step_s=[round(x, 4) for x in secs], mesh_free_step_s=fit["step_s"],
          losses=res.losses, mesh_free_losses=ref.losses,
          loss_max_rel=repr(loss_rel(res, ref)), rerun_loss_max_rel=repr(loss_rel(again, ref)),
          **{k: repr(v) for k, v in {**params_diff(res, ref, "mesh"),
                                     **params_diff(again, ref, "rerun")}.items()},
          deterministic_loss_max_rel=repr(det_loss),
          **{k: repr(v) for k, v in params_diff(det["mesh"], det["mesh_free"],
                                                "deterministic").items()},
          deterministic_params_within_rtol_1e4=det_close,
          all_reduces=[c["all_reduce"] for c in per_step], bytes_per_all_reduce=n_bytes,
          all_reduce_ms=f"{ar_ms:.4f}", launches=json.dumps(launches))
    if loss_rel(res, ref) > 1e-4 or det_loss > 1e-4 or not det_close:
        fail(f"dist_fit: the mesh's fit is off the mesh-free fit (losses "
             f"{loss_rel(res, ref)}, deterministic {det_loss}, params {det_close})")
    if any(c["all_reduce"] != FIT_CHUNKS for c in per_step):
        fail(f"dist_fit: all-reduces a step {per_step}, not {FIT_CHUNKS}")
    return dict(launches=launches, ar_ms=ar_ms, n_bytes=n_bytes)


def dist_ring(mesh, scene, cam: Camera) -> dict:
    """[dist_ring]: the 5M sponza at 3840x2160 through Renderer(mesh,
    partition="ring") (ring_engine wide8, the one partition's WideBVH)
    against the replicated wide8 Renderer: init seconds split into partition
    and build, peak bytes, the frame's ms by CUDA events (render_rays on the
    Morton frame) for both, the ring's split into closest8, occluded8, the
    ring functions' own time (fold, state and the all-gathers; the
    all-gather alone beside) and glue, the replicated's into closest8,
    occluded8 and glue; the images by the image rule; the ring frame's
    closest8 and occluded8 calls against their twins on the card (0
    differing ids and flags)."""
    frame = morton_rays(cam)
    n = frame.o.shape[0]
    builds = ("partition_scene", "build_partition_wides", "build_lbvh", "build_wide",
              "tri_table")
    out = {}
    for name, kw in (("replicated", {}), ("ring", dict(mesh=mesh, partition="ring"))):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        rec = {}
        with recording(pipeline_mod, builds, rec, timed=True):
            r, s_init = sync_time(lambda: Renderer(scene, RenderConfig(method="wide8"), **kw))
        init_launches = launch_counts()
        img, s_render = sync_time(lambda: r.render(cam))
        peak = torch.cuda.max_memory_allocated() - base
        calls = {}
        reset_launches()
        coll_mod.reset_counts()
        with torch.no_grad(), recording(ring_mod if name == "ring" else pipeline_mod,
                                        ("traverse_wide8", "occluded_wide8"), calls):
            render_rays(r.tracer, frame)
        launches, counts = launch_counts(), dict(coll_mod.COUNTS)
        with torch.no_grad():
            ms = {"frame": cuda_ms(lambda: render_rays(r.tracer, frame), iters=5, warmup=1)}
            (c_args, c_kw, _), (o_args, _, _) = (calls["traverse_wide8"][0],
                                                  calls["occluded_wide8"][0])
            tree = c_args[1]
            ms["closest8"] = cuda_ms(lambda: k8.traverse_wide8(*c_args, **c_kw), iters=5,
                                     warmup=1)
            ms["occluded8"] = cuda_ms(lambda: k8.occluded_wide8(*o_args), iters=5, warmup=1)
            if name == "ring":
                tr = r.tracer
                ms["ring_trace"] = cuda_ms(lambda: ring_mod.ring_trace(
                    mesh, frame, tr.part, pbvh=tr.pbvh), iters=5, warmup=1)
                ms["ring_occluded"] = cuda_ms(lambda: ring_mod.ring_occluded(
                    mesh, o_args[0], tr.part, o_args[2], pbvh=tr.pbvh), iters=5, warmup=1)
                hit = calls["traverse_wide8"][0][2]
                ms["all_gather"] = cuda_ms(lambda: coll_mod.all_gather_tree(
                    {"t": hit.t, "u": hit.u, "v": hit.v, "tri": hit.tri}, mesh), iters=5,
                    warmup=1)
                ms["fold"] = (ms["ring_trace"] - ms["closest8"] + ms["ring_occluded"]
                              - ms["occluded8"])
                ms["glue"] = ms["frame"] - ms["ring_trace"] - ms["ring_occluded"]
            else:
                ms["glue"] = ms["frame"] - ms["closest8"] - ms["occluded8"]
        # the ring's kernel calls against their twins (the replicated
        # frame's kernels are held to theirs by [parity])
        twin = {}
        if name == "ring":
            hit = calls["traverse_wide8"][0][2]
            with torch.no_grad():
                twin_hit = chunked_twin(k8.traverse_wide8_ref)(*c_args, **c_kw)
                twin_blk = chunked_twin(k8.occluded_wide8_ref)(*o_args)
            same = hit.tri == twin_hit.tri
            blk = calls["occluded_wide8"][0][2]
            twin = dict(closest8_id_mismatches=int((~same).sum()),
                        closest8_max_abs_tuv=max(max_abs(getattr(hit, f)[same],
                                                         getattr(twin_hit, f)[same])
                                                 for f in ("t", "u", "v")),
                        occluded8_flag_mismatches=int((blk != twin_blk).sum()))
            strict_flags("dist_ring", name, "occluded8", tree, o_args[0], blk, twin_blk)
            if twin["closest8_id_mismatches"] or twin["closest8_max_abs_tuv"] > MAX_ABS_ERR:
                FAILURES.append(f"dist_ring: closest8 against its twin: {twin}")
            del hit, twin_hit, twin_blk, blk
        s = {k[:-2]: round(v, 3) for k, v in rec.items() if k.endswith("_s")}
        phase("dist_ring", engine=name, tris=scene.num_tris, rays=n, init_s=f"{s_init:.3f}",
              init_split_s=json.dumps(s), render_s=f"{s_render:.3f}", peak_bytes=peak,
              init_launches=json.dumps(init_launches), launches=json.dumps(launches),
              collectives=json.dumps(counts), **{k: repr(v) for k, v in twin.items()},
              shadow_rays=o_args[0].o.shape[0],
              **{f"{k}_ms": f"{v:.4f}" for k, v in ms.items()},
              rays_per_s=f"{n / (ms['frame'] * 1e-3):.1f}")
        for k in ("closest8", "occluded8"):
            if launches[k] != 1:
                fail(f"dist_ring ({name}): {k} launched {launches[k]} times in a frame")
        out[name] = dict(img=img, ms=ms, launches=launches, init_launches=init_launches,
                         peak=peak, init_s=s_init, split=s)
        del r, calls, c_args, o_args, tree
    diff = image_diff(out["ring"].pop("img"), out["replicated"].pop("img"))
    ratio = out["ring"]["ms"]["frame"] / out["replicated"]["ms"]["frame"]
    phase("dist_ring", ring_over_replicated=f"{ratio:.4f}",
          vs_replicated_max_abs=diff["max_abs"], vs_replicated_off_frac=diff["off_frac"])
    if diff["off_frac"] > IMAGE_OFF_FRAC:
        fail(f"dist_ring: the ring's image differs on {diff['off_frac']} of pixels")
    out["ratio"] = ratio
    return out


def sampled_twin(kernel: str, tree, rays: Rays, got, t_max=None) -> dict:
    """A packet kernel's output `got` on `rays` (one call of the wrapper on
    the whole block) against its twin on SAMPLE_PACKETS whole packets of
    the block: differing ids, flags and t/u/v bits (must be 0); and an
    estimate of the call's bound: the sampled packets' walk counts scaled
    by the block's packets over the sampled ones (visits and leaf visits;
    the distinct nodes and rows are the sample's)."""
    n = rays.o.shape[0]
    idx = packet_sample(n).to(rays.o.device)
    sub = Rays(o=rays.o[idx], d=rays.d[idx])
    stats = {}
    t0 = time.perf_counter()
    if kernel == "packet_closest":
        ref = kp.traverse_packet_ref(sub, tree, stats=stats)
        differ = (hit_bits(Hit(**{f: getattr(got, f)[idx] for f in ("t", "u", "v", "tri")}))
                  != hit_bits(ref)).any(dim=-1)
        in_bytes, out_bytes = 24, 16
    else:
        ref = kp.occluded_packet_ref(sub, tree, t_max[idx], stats=stats)
        differ = got[idx] != ref
        in_bytes, out_bytes = 28, 1
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    counts = k8.walk_counts(stats)
    scale = -(-n // kp.PACKET_RAYS) / -(-idx.numel() // kp.PACKET_RAYS)
    est = bound(dict(counts, visits=round(counts["visits"] * scale),
                     rows=round(counts["rows"] * scale)), n, in_bytes, out_bytes, PACKET)
    return {f"{kernel}_sampled_rays": int(idx.numel()),
            f"{kernel}_differing": int(differ.sum()),
            f"{kernel}_twin_s": round(twin_s, 3),
            f"{kernel}_sampled_visits": counts["visits"],
            f"{kernel}_sampled_leaf_visits": counts["rows"],
            f"{kernel}_bound_ms_estimate": round(est["bound_ms"], 6),
            f"{kernel}_bound_by": est["bound_by"]}


def dist_ring_packet(mesh, scene, cam: Camera, wide8_ms: dict) -> dict:
    """[dist_ring]'s packet row: the 5M sponza at 3840x2160 through
    make_tracer(method="ring", ring_engine="packet") over the world-1 mesh
    (the one partition's PackedBVH, walked by the packet kernels) against
    the replicated make_tracer(method="packet") frame: init seconds split
    into partition and build, peak bytes, the row-major hard frame (the
    order render() traces a packet ring in) by CUDA events, split into
    packet_closest, packet_occluded, the ring functions' own time and glue,
    rays/s; the images by the image rule; the ring frame's packet_closest
    and packet_occluded calls against their twins on SAMPLE_PACKETS whole
    packets of each call (0 differing ids, flags or t/u/v bits).
    wide8_ms: the wide8 ring's and replicated frames' ms, printed beside."""
    frame = gen_primary_rays(cam)
    n = frame.o.shape[0]
    builds = ("partition_scene", "build_partition_bvhs", "build_lbvh", "pack_bvh",
              "tri_table")
    out = {}
    for name, kw in (("replicated_packet", dict(method="packet")),
                     ("ring_packet", dict(method="ring", mesh=mesh, ring_engine="packet"))):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        rec = {}
        with recording(pipeline_mod, builds, rec, timed=True):
            tracer, s_init = sync_time(lambda: make_tracer(scene, **kw))
        init_launches = launch_counts()
        if not tracer.packets:
            fail(f"dist_ring ({name}): the tracer does not trace in packets")
        img, s_render = sync_time(lambda: render(scene, cam, tracer=tracer))
        peak = torch.cuda.max_memory_allocated() - base
        calls = {}
        reset_launches()
        with torch.no_grad(), recording(ring_mod if name == "ring_packet" else pipeline_mod,
                                        ("traverse_packet", "occluded_packet"), calls):
            render_rays(tracer, frame)
        launches = launch_counts()
        (c_args, _, hit), (o_args, _, blk) = (calls["traverse_packet"][0],
                                              calls["occluded_packet"][0])
        with torch.no_grad():
            ms = {"frame": cuda_ms(lambda: render_rays(tracer, frame), iters=3, warmup=1),
                  "packet_closest": cuda_ms(lambda: kp.traverse_packet(*c_args), iters=3,
                                            warmup=1),
                  "packet_occluded": cuda_ms(lambda: kp.occluded_packet(*o_args), iters=3,
                                             warmup=1)}
            if name == "ring_packet":
                ms["ring_trace"] = cuda_ms(lambda: ring_mod.ring_trace(
                    mesh, frame, tracer.part, pbvh=tracer.pbvh, engine="packet"),
                    iters=3, warmup=1)
                ms["ring_occluded"] = cuda_ms(lambda: ring_mod.ring_occluded(
                    mesh, o_args[0], tracer.part, o_args[2], pbvh=tracer.pbvh,
                    engine="packet"), iters=3, warmup=1)
                ms["ring_own"] = (ms["ring_trace"] - ms["packet_closest"] + ms["ring_occluded"]
                                  - ms["packet_occluded"])
                ms["glue"] = ms["frame"] - ms["ring_trace"] - ms["ring_occluded"]
            else:
                ms["glue"] = ms["frame"] - ms["packet_closest"] - ms["packet_occluded"]
        twin = {}
        if name == "ring_packet":
            with torch.no_grad():
                twin.update(sampled_twin("packet_closest", c_args[1], c_args[0], hit))
                twin.update(sampled_twin("packet_occluded", o_args[1], o_args[0], blk,
                                         o_args[2]))
            for k in ("packet_closest", "packet_occluded"):
                if twin[f"{k}_differing"]:
                    FAILURES.append(f"dist_ring ({name}): {k} differs from its twin on "
                                    f"{twin[f'{k}_differing']} sampled rays")
        s = {k[:-2]: round(v, 3) for k, v in rec.items() if k.endswith("_s")}
        phase("dist_ring", engine=name, tris=scene.num_tris, rays=n, init_s=f"{s_init:.3f}",
              init_split_s=json.dumps(s), render_s=f"{s_render:.3f}", peak_bytes=peak,
              init_launches=json.dumps(init_launches), launches=json.dumps(launches),
              shadow_rays=o_args[0].o.shape[0], packets=-(-n // kp.PACKET_RAYS), **twin,
              **{f"{k}_ms": f"{v:.4f}" for k, v in ms.items()},
              rays_per_s=f"{n / (ms['frame'] * 1e-3):.1f}",
              hit_frac=f"{float((hit.tri >= 0).float().mean()):.4f}",
              blocked_frac=f"{float(blk.float().mean()):.4f}")
        for k in ("packet_closest", "packet_occluded"):
            if launches[k] != 1:
                fail(f"dist_ring ({name}): {k} launched {launches[k]} times in a frame")
        out[name] = dict(img=img, ms=ms, launches=launches, init_launches=init_launches,
                         peak=peak, init_s=s_init, split=s, twin=twin)
        del tracer, calls, c_args, o_args, hit, blk
    diff = image_diff(out["ring_packet"].pop("img"), out["replicated_packet"].pop("img"))
    ratio = out["ring_packet"]["ms"]["frame"] / out["replicated_packet"]["ms"]["frame"]
    phase("dist_ring", engine="packet", ring_over_replicated=f"{ratio:.4f}",
          vs_replicated_max_abs=diff["max_abs"], vs_replicated_off_frac=diff["off_frac"],
          **{f"{k}_frame_ms": f"{v:.4f}" for k, v in wide8_ms.items()})
    if diff["off_frac"] > IMAGE_OFF_FRAC:
        fail(f"dist_ring (packet): the ring's image differs on {diff['off_frac']} of pixels")
    out["ratio"] = ratio
    return out


# ---------------------------------------------------------------------------
# The gather backward: segment_accumulate (csrc/segsum.cu)
# ---------------------------------------------------------------------------
# The fit's gathers by the width of their backward: the K x R layer rows
# into the table (12 of 15 columns), the L x k_occ x R shared occluder
# candidates of the L lights (9), and tri_table's 3T corner rows into the
# vertices (3).
SEGSUM_KINDS = {12: "soft_surface", 9: "soft_occlusion", 3: "corners"}


@contextlib.contextmanager
def grad_backend(name: str):
    """The gather backward's backend set to `name` for the duration."""
    saved = gg_mod.get_grad_backend()
    gg_mod.set_grad_backend(name)
    try:
        yield
    finally:
        gg_mod.set_grad_backend(saved)


def record_segsum(inv: InverseRenderer, target: torch.Tensor, prefix: str) -> dict:
    """The real (idx, cot, num_rows) of segment_accumulate in one fit step
    under 'segsum': the first call of each width (SEGSUM_KINDS), so the
    first chunk's two gathers and the step's corner gather."""
    with grad_backend("segsum"), recording(gg_mod, ["segment_accumulate"], {}) as rec:
        inv.fit(target, steps=1)
    calls = {}
    for (idx, cot, num_rows), _, _ in rec["segment_accumulate"]:
        kind = SEGSUM_KINDS.get(cot.shape[1], f"use{cot.shape[1]}")
        calls.setdefault(f"{prefix}_{kind}", (idx, cot, num_rows))
    return calls


def segsum_patterns(dev) -> dict:
    """tpurt's five id patterns at SEGSUM_PATTERN_ROWS rows of 3 columns."""
    rng = np.random.default_rng(SEGSUM_PATTERN_SEED)
    n, v = SEGSUM_PATTERN_ROWS, SEGSUM_PATTERN_V
    ids = {"uniform": rng.integers(0, v, n), "all_dup": np.full(n, 3),
           "two_hot": rng.choice([0, v - 1], n), "sorted": np.sort(rng.integers(0, v, n)),
           "clustered": rng.integers(0, 5, n) * (v // 7)}
    cot = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=dev)
    return {f"pattern_{k}": (torch.tensor(x, dtype=torch.int64, device=dev), cot, v)
            for k, x in ids.items()}


def segsum_nonfinite(dev) -> dict:
    """A gather whose carries are not finite: 2^20 rows of 3 columns,
    tpurt's uniform ids into 257 rows (every block continues its tail id,
    so an inf or NaN in a block's last rows reaches the next block's carry,
    and through the passes' a * g every later block's), inf, -inf and NaN
    in column 0 of 6 seeded rows and -0 in a quarter of column 1's."""
    rng = np.random.default_rng(SEGSUM_PATTERN_SEED + 1)
    n, v = SEGSUM_PATTERN_ROWS, SEGSUM_PATTERN_V
    cot = rng.normal(size=(n, 3)).astype(np.float32)
    cot[rng.permutation(n)[:6], 0] = [np.inf, -np.inf, np.nan, np.inf, np.nan, -np.inf]
    cot[rng.permutation(n)[:n // 4], 1] = -0.0
    return {"nonfinite": (torch.tensor(rng.integers(0, v, n), dtype=torch.int64, device=dev),
                          torch.tensor(cot, device=dev), v)}


def segsum_above_rule(dev) -> dict:
    """A gather above the one-CTA carry's size (csrc/segsum.cu's
    kCarryMaxBlocks blocks, where the carry takes a launch a pass):
    the 5M sponza's corner gather's shape, 3T = 15,000,000 rows of 3 columns
    into 5M rows, ids seeded uniform."""
    rng = np.random.default_rng(SEGSUM_PATTERN_SEED + 2)
    n, v = 3 * NUM_TRIS_5M, NUM_TRIS_5M
    return {"above_rule": (torch.tensor(rng.integers(0, v, n), dtype=torch.int64, device=dev),
                           torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32,
                                        device=dev), v)}


def segsum_bytes(n: int, use: int, v: int) -> int:
    """The least bytes of the kernels' function: the sorted ids and the
    permutation read (4 + 8 a row), the `use` columns of every row read,
    (v, use) written."""
    return 12 * n + 4 * n * use + 4 * v * use


def segsum_design_bytes(n: int, use: int, v: int, ends: int) -> int:
    """What this design moves besides (a diagnostic, not the bound): the
    output rows of the ends ids written twice (the memset, then the end
    row), the sorted ids read again at the end rows, and the carry's g
    written, read and written back, a read and each block's head row read
    and written back, 24 bytes a block a column."""
    return segsum_bytes(n, use, v) + 4 * ends * use + 4 * n + 24 * -(-n // ss.BLOCK) * use


def float_differ(got: torch.Tensor, ref: torch.Tensor) -> int:
    """Elements that differ as floats (+0 and -0 equal), a NaN equal to a
    NaN."""
    return int(((got != ref) & ~(got.isnan() & ref.isnan())).sum())


def segsum_launch(lib: ctypes.CDLL, idx: torch.Tensor, cot: torch.Tensor, v: int):
    """lib's segsum kernels on one input, by the tree's interface
    (bind_tree): (launch, out), the sort and every buffer made once, as the
    wrapper makes them; launch() enqueues the kernels, not the sort."""
    n, use = cot.shape
    sid, perm = torch.sort(idx.to(torch.int32), stable=True)
    nb = -(-n // ss.BLOCK)
    f32 = dict(dtype=torch.float32, device=cot.device)
    out = torch.empty((v, use), **f32)
    g, a = torch.empty((2, nb * use), **f32), torch.empty((2, nb), **f32)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    if lib.segsum_ends:
        y = torch.empty((n, use), **f32)
        end = torch.empty(v, dtype=torch.int32, device=cot.device)
        calls = [(lib.tpurt_segsum_scan, (p(sid), p(perm), p(cot), cot.stride(0), n, use, v,
                                          p(y), p(end))),
                 (lib.tpurt_segsum_carry, (p(sid), p(y), n, use, p(g[0]), p(g[1]), p(a[0]),
                                           p(a[1]))),
                 (lib.tpurt_segsum_ends, (p(sid), p(end), p(y),
                                          p(g[ss.carry_passes(nb) % 2]), v, use, p(out)))]
        keep = (y, end)
    else:
        calls = [(lib.tpurt_segsum_scan, (p(sid), p(perm), p(cot), cot.stride(0), n, use, v,
                                          p(out), p(g[0]), p(a[0]))),
                 (lib.tpurt_segsum_carry, (p(sid), n, use, v, p(g[0]), p(g[1]), p(a[0]),
                                           p(a[1]), p(out)))]
        keep = ()

    def launch() -> None:
        for fn, args in calls:
            err = fn(*args, stream)
            if err:
                fail(f"segsum failed to launch: {err}")

    launch.keep = (sid, perm, g, a, keep, cot)
    return launch, out


def segsum_input(name: str, idx: torch.Tensor, cot: torch.Tensor, v: int) -> dict:
    """segment_accumulate's kernels against the twin on one input (every
    element equal as floats, NaN where the twin's is NaN; a differing one
    fails the script at its end), then device ms by CUDA events: the sort,
    the kernels by bare launches (scan: the memset and the scan; kernels:
    those, the carry and the end rows; carry the difference), the wrapper call, the twin, index_add_ (atomic) and
    index_add_ under torch.use_deterministic_algorithms (torch's
    deterministic route); the kernels' bound from this input's bytes
    (segsum_bytes), the call's from the ids as given instead of sorted
    (call_bound_ms), and the design's bytes beside (design_bound_ms); the
    launches of one call's kernels, the memset included (device_launches;
    more than SEGSUM_MAX_LAUNCHES on an input but above_rule fails the
    script at its end)."""
    n, use = cot.shape
    got = ss.segment_accumulate(idx, cot, v)
    ref = ss.segment_accumulate_ref(idx, cot, v)
    differ = float_differ(got, ref)
    finite = got.isfinite() & ref.isfinite()
    err = max_abs(got[finite], ref[finite])
    w = ss.prepare(idx, cot, v)
    ss.launch_scan(w)
    ss.launch_carry(w)
    differ += float_differ(w.out, ref)
    ends = int(torch.unique_consecutive(w.sid).numel())
    del got, ref, finite
    i32 = idx.to(torch.int32)
    def kernels():
        ss.launch_scan(w)
        ss.launch_carry(w)

    ms = {"sort": cuda_ms(lambda: torch.sort(i32, stable=True)),
          "scan": cuda_ms(lambda: ss.launch_scan(w)),
          "kernels": cuda_ms(kernels),
          "call": cuda_ms(lambda: ss.segment_accumulate(idx, cot, v)),
          "plain": cuda_ms(lambda: ss.segment_accumulate_ref(idx, cot, v), iters=3, warmup=1),
          "index_add": cuda_ms(lambda: cot.new_zeros((v, use)).index_add_(0, idx, cot))}
    torch.use_deterministic_algorithms(True)
    try:
        ms["index_add_deterministic"] = cuda_ms(
            lambda: cot.new_zeros((v, use)).index_add_(0, idx, cot), iters=3, warmup=1)
    finally:
        torch.use_deterministic_algorithms(False)
    # the carry rewrites g in place, so it is timed behind the scan that
    # makes g: its ms is the difference
    ms["carry"] = ms["kernels"] - ms["scan"]
    nbytes = segsum_bytes(n, use, v)
    bound = nbytes / PEAK_BYTES_S * 1e3
    call_bound = (idx.element_size() * n + 4 * n * use + 4 * v * use) / PEAK_BYTES_S * 1e3
    design_bound = segsum_design_bytes(n, use, v, ends) / PEAK_BYTES_S * 1e3
    launched = device_launches(kernels)
    launches = sum(launched.values()) or None
    phase("segsum", input=name, rows=n, use=use, num_rows=v, ends=ends, blocks=w.nb,
          carry_passes=ss.carry_passes(w.nb),
          launches=launches if launches else "not measured (the profiler missed a marker)",
          launched=json.dumps(launched), differing=differ, max_abs_err=err,
          **{f"{k}_ms": f"{x:.4f}" for k, x in ms.items()},
          bytes=nbytes, bound_ms=f"{bound:.6f}", bound_share=f"{bound / ms['kernels']:.4f}",
          call_bound_ms=f"{call_bound:.6f}", design_bound_ms=f"{design_bound:.6f}")
    if differ:
        FAILURES.append(f"segsum {name}: {differ} elements differ from the twin")
    if launches and name != "above_rule" and launches > SEGSUM_MAX_LAUNCHES:
        FAILURES.append(f"segsum {name}: {launches} launches a call over {w.nb} blocks")
    return dict(ms=ms, err=err, differ=differ, bound_ms=bound, call_bound_ms=call_bound,
                design_bound_ms=design_bound, launches=launches)


@torch.no_grad()
def segsum_ab(libs: dict, inputs: dict) -> dict:
    """[segsum_ab]: the segsum kernels of this checkout ("new") against
    other trees' (libs: {"new": lib, name: lib, ...}, each bound by its own
    interface, segsum_launch) on each input (name -> (idx, cot, v)): every
    tree's output equal to this one's as floats, NaN where it is NaN (a
    differing element fails the script at its end); then in turns other,
    new, new, other for each other tree, the kernels' device ms by CUDA
    events over bare launches (the sort made before)."""
    out = {}
    for cell, (idx, cot, v) in inputs.items():
        runs = {name: segsum_launch(lib, idx, cot, v) for name, lib in libs.items()}
        for launch, _ in runs.values():
            launch()
        torch.cuda.synchronize()
        ref = runs["new"][1]
        bad = {name: float_differ(res, ref) for name, (_, res) in runs.items() if name != "new"}
        order = [name for other in libs if other != "new"
                 for name in (other, "new", "new", other)] or ["new"]
        turns = [(name, events_ms(runs[name][0])) for name in order]
        mean = lambda name: float(np.mean([t for s, t in turns if s == name]))  # noqa: E731
        out[cell] = {name: dict(device_ms=mean(name)) for name in libs}
        phase("segsum_ab", input=cell, rows=cot.shape[0], use=cot.shape[1], num_rows=v,
              differing=json.dumps(bad),
              **{f"{name}_device_ms": f"{mean(name):.4f}" for name in libs},
              device_turns=json.dumps([[s, round(t, 4)] for s, t in turns]))
        if any(bad.values()):
            FAILURES.append(f"segsum ({cell}): outputs differ from a --parent tree's: {bad}")
        del runs, ref
    return out


def segsum_rule(name: str, inv: InverseRenderer, target: torch.Tensor) -> dict:
    """[segsum_rule]: the fit (inv's FitConfig, from its initial
    parameters each time) under 'scatter', 'segsum', 'segsum', 'scatter'
    in turns, deterministic algorithms off: each backend's step seconds
    (host clock between synchronizes, the mean of steps 2 on), their ratio
    against SEGSUM_RULE, the parameter elements that differ between the
    two runs of each backend; then one step under
    use_deterministic_algorithms(True, warn_only=True) and the ops it warns
    about."""
    runs = []
    for backend in ("scatter", "segsum", "segsum", "scatter"):
        secs, t_last = [], [0.0]

        def on_step(i: int, loss: float) -> None:
            torch.cuda.synchronize()
            now = time.perf_counter()
            secs.append(now - t_last[0])
            t_last[0] = now

        with grad_backend(backend):
            torch.cuda.synchronize()
            t_last[0] = time.perf_counter()
            res = inv.fit(target, callback=on_step)
        runs.append((backend, float(np.mean(secs[1:])), res))
    step = {b: float(np.mean([s for bb, s, _ in runs if bb == b])) for b in ("segsum", "scatter")}
    fits = {b: [r for bb, _, r in runs if bb == b] for b in ("segsum", "scatter")}
    differing = {b: sum(int((x.params[k] != y.params[k]).sum()) for k in x.params)
                 for b, (x, y) in fits.items()}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with grad_backend("segsum"):
                inv.fit(target, steps=1)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    warned = sorted({str(x.message).split(" does not have a deterministic")[0]
                     for x in caught if "does not have a deterministic" in str(x.message)})
    ratio = step["segsum"] / step["scatter"]
    phase("segsum_rule", fit=name, steps=inv.fit_cfg.steps, chunks=inv.fit_cfg.grad_chunks,
          turns=json.dumps([(b, round(s, 5)) for b, s, _ in runs]),
          segsum_step_s=f"{step['segsum']:.5f}", scatter_step_s=f"{step['scatter']:.5f}",
          ratio=f"{ratio:.4f}", within_rule=ratio <= SEGSUM_RULE,
          params=sum(p.numel() for p in fits["segsum"][0].params.values()),
          segsum_repeat_differing=differing["segsum"],
          scatter_repeat_differing=differing["scatter"],
          deterministic_warn_only_ops=json.dumps(warned))
    return dict(step=step, ratio=ratio, differing=differing, warned=warned)


# ---------------------------------------------------------------------------
# tpurt's packet engine ([packet]) and wavefront engine ([wave])
# ---------------------------------------------------------------------------
def packet_launch(kernel: str, packed, rays: Rays, t_max=None, k: int | None = None):
    """A bare launch of a packet kernel (packet_closest, packet_occluded,
    packet_knear) through the port's library, its arguments and outputs
    made once, as the wrapper makes them (walk_launch); launch() enqueues
    the kernel on the current stream."""
    return walk_launch(this_library(), kernel, packed, rays, t_max, k)[0]


def events(fn):
    """(fn(), device ms of the call by CUDA events)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def hit_bits(h: Hit) -> torch.Tensor:
    return torch.stack([h.tri, h.t.view(torch.int32), h.u.view(torch.int32),
                        h.v.view(torch.int32)], dim=-1)


def ray_groups(rays: Rays) -> dict:
    """Masks of the flat rays by direction: a component in [-1e-30, 0)
    (P1-like: its own slab tests all fail), a zero component, the rest."""
    d = rays.d.reshape(-1, 3)
    p1 = ((d < 0) & (d >= -1e-30)).any(dim=1)
    zero = (d == 0).any(dim=1) & ~p1
    return {"p1_like": p1, "zero": zero, "rest": ~(p1 | zero)}


def by_group(differ: torch.Tensor, groups: dict) -> dict:
    return {g: int((differ & m).sum()) for g, m in groups.items()}


def packet_call(out: dict, view: str, call: str, kernel: str, packed, rays: Rays, ref_fn,
                run_fn, in_bytes: int, out_bytes: int, t_max=None, k=None) -> torch.Tensor:
    """One packet kernel call against its twin on every ray: the wrapper's
    output (run_fn()) and the twin's (ref_fn(stats), its walk counted, its
    ms by CUDA events as plain_ms), every differing id, flag, list entry
    or t/u/v bit counted (any fails the script at its end), the wrapper's
    ms, the kernel's bare-launch device ms and its bound.  Returns the
    twin's output."""
    n = rays.o.shape[0]
    got = run_fn()
    stats = {}
    ref, plain = events(lambda: ref_fn(stats))
    if kernel == "packet_closest":
        differ = (hit_bits(got) != hit_bits(ref)).any(dim=-1)
    elif kernel == "packet_knear":
        differ = (got != ref).any(dim=-1)
    else:
        differ = got != ref
    bad = int(differ.sum())
    ms = cuda_ms(run_fn, iters=5, warmup=1)
    dev_ms = events_ms(packet_launch(kernel, packed, rays, t_max, k), passes=5)
    b = bound(k8.walk_counts(stats), n, in_bytes, out_bytes, PACKET)
    out[call] = dict(kernel=kernel, rays=n, differ=bad, ms=ms, device_ms=dev_ms, plain_ms=plain,
                     bound=b)
    phase("packet", view=view, call=call, kernel=kernel, rays=n, packets=-(-n // kp.PACKET_RAYS),
          differing=bad, ms=f"{ms:.4f}", device_ms=f"{dev_ms:.4f}", plain_ms=f"{plain:.1f}",
          **b)
    if bad:
        FAILURES.append(f"{kernel} ({view}, {call}): {bad} rays differ from the twin's")
    return ref


def packet_cells(view: str, packed, frame: Rays, sh: Rays, t_sh: torch.Tensor) -> dict:
    """[walk_ab]'s packet cells of one view: packet_closest on its row-major
    frame, packet_occluded on the frame's shadow rays."""
    return {f"packet_closest_{view}": ("packet_closest", packed, frame, None),
            f"packet_occluded_{view}": ("packet_occluded", packed, sh, t_sh)}


@torch.no_grad()
def knear_packet_ab(libs: dict, scene, cam: Camera, bscene, bcam: Camera) -> dict:
    """[knear_ab]'s packet cells: packet_knear against each other tree's on
    the band-0.08 packed trees, row-major rays as the soft render calls it:
    [fit]'s chunk 0 (k_layers, then k_occ on its candidates), the 1M main
    view's occluder call (k_occ on the candidates from the whole frame's
    layers), and the bunny 512^2's layers, occluders and one k = 16 call
    (the KM 16 list)."""
    kl, ko = SOFT["k_layers"], SOFT["k_occ"]
    out = {}
    for view, sc, c in (("sponza1m", scene, cam), ("bunny", bscene, bcam)):
        soft = make_tracer(sc, "packet", band=BAND).packed
        table = tri_table(sc.tris)
        frame = gen_primary_rays(c)
        cells = {}
        if view == "sponza1m":
            chunk = rays_slice(frame, slice(0, frame.o.shape[0] // FIT_CHUNKS))
            cand, tm = occluder_call(table, sc, chunk, kp.k_nearest_ids_packet(chunk, soft, kl,
                                                                               BAND))
            cells["fit_chunk0_layers"] = [(chunk, kl, T_MAX)]
            cells["fit_chunk0_occluders"] = [(cand, ko, tm)]
            cand, tm = occluder_call(table, sc, frame, kp.k_nearest_ids_packet(frame, soft, kl,
                                                                               BAND))
            cells["main_occluders"] = [(cand, ko, tm)]
        else:
            cand, tm = occluder_call(table, sc, frame, kp.k_nearest_ids_packet(frame, soft, kl,
                                                                               BAND))
            cells.update(bunny_layers=[(frame, kl, T_MAX)], bunny_occluders=[(cand, ko, tm)],
                         bunny_k16=[(frame, kp.KMAX, T_MAX)])
        runs = {"new": lambda rays, k, t_max, soft=soft: kp.k_nearest_ids_packet(
                    rays, soft, k, BAND, t_max=t_max),
                **{name: parent_knear(lib, soft, "packet_knear")
                   for name, lib in libs.items() if name != "new"}}
        out.update(knear_ab("packet_knear", soft, runs, libs, cells))
        del soft, table, frame, cells, cand, tm
    return out


@torch.no_grad()
def packet_ab(libs: dict, dev) -> None:
    """--packet-ab: [walk_ab]'s packet cells alone, on the 1M main view's and
    the overview's row-major frames and the bunny 512^2 (shadow rays from
    this build's hits), against each other tree; then [knear_ab]'s packet
    cells (knear_packet_ab) and [segsum_ab] on [segsum]'s inputs but the
    bunny fit's (the 1M fit's recorded gathers, tpurt's patterns, the
    non-finite and the above-rule inputs); no result line."""
    scene, cam = make_sponza_scene(num_tris=NUM_TRIS, width=WIDTH, height=HEIGHT, device=dev)
    over = Camera.create(eye=OVERVIEW_EYE, target=OVERVIEW_TARGET, fov_y_deg=50.0,
                         width=WIDTH, height=HEIGHT, device=dev)
    bscene, bcam = make_bunny_scene(device=dev)
    for view, sc, c in (("main", scene, cam), ("overview", scene, over),
                        ("bunny", bscene, bcam)):
        tracer = make_tracer(sc, "packet")
        frame = gen_primary_rays(c)
        h = kp.traverse_packet(frame, tracer.packed)
        p, nrm, _, _ = hit_surface(tracer, frame, h)
        sh, t_sh = shadow_rays(sc, p, nrm, h.valid)
        walk_ab(libs, packet_cells(view, tracer.packed, frame, sh, t_sh))
        del tracer, frame, h, p, nrm, sh, t_sh
    knear_packet_ab(libs, scene, cam, bscene, bcam)
    with torch.enable_grad():
        inv, target, _, _ = fit_problem(scene, cam)
        inputs = record_segsum(inv, target, "fit")
    del inv, target
    inputs.update(segsum_patterns(dev))
    inputs.update(segsum_nonfinite(dev))
    inputs.update(segsum_above_rule(dev))
    segsum_ab(libs, inputs)
    if FAILURES:
        fail("; ".join(FAILURES))


@torch.no_grad()
def packet_view(view: str, tracer: Tracer, soft_packed, frame: Rays,
                beside: dict | None = None, layers_twin: bool = True,
                libs: dict | None = None, ab: dict | None = None) -> dict:
    """The packet kernels on one frame (row-major primary rays, as the
    Renderer traces them for "packet"): packet_closest on the frame,
    packet_occluded on its shadow rays (per-ray t_max, built from the
    twin's hits as _shade_layer builds them), packet_knear as the soft
    render calls it on the band tree (k = 4 on the frame, then k_occ = 8 on
    the candidates from layer 0 with 2 x the segment as t_max; with
    layers_twin, k = 16 on the frame too), each
    against its twin (packet_call); the hard frame's ms split into closest,
    occluded and glue (CUDA events), beside the wide8 and binary frames of
    this run; the rays whose closest hit or flag differs from the binary
    per-ray kernels' on the same tree, by group (ray_groups).
    layers_twin False: the k = 4 call runs the kernel alone (its device ms
    printed) and feeds the occluder call, which is held to its twin; the
    1M frames' k = 4 twin would take ~100 s each, and packet_fit_chunk
    holds that call on the main view's first 255 packets.  libs (with
    --parent): packet_closest and packet_occluded against each other
    tree's on the frame and its shadow rays ([walk_ab], packet_cells),
    their results into ab."""
    packed, scene, n = tracer.packed, tracer.scene, frame.o.shape[0]
    out = {}
    href = packet_call(out, view, "closest", "packet_closest", packed, frame,
                       lambda st: kp.traverse_packet_ref(frame, packed, stats=st),
                       lambda: kp.traverse_packet(frame, packed), 24, 16)
    p, nrm, _, _ = hit_surface(tracer, frame, href)
    sh, t_sh = shadow_rays(scene, p, nrm, href.valid)
    bref = packet_call(out, view, "occluded", "packet_occluded", packed, sh,
                       lambda st: kp.occluded_packet_ref(sh, packed, t_sh, stats=st),
                       lambda: kp.occluded_packet(sh, packed, t_sh), 28, 1, t_max=t_sh)
    if libs is not None and len(libs) > 1:
        ab.update(walk_ab(libs, packet_cells(view, packed, frame, sh, t_sh)))

    def layers():
        return kp.k_nearest_ids_packet(frame, soft_packed, SOFT["k_layers"], BAND)

    if layers_twin:
        ids = packet_call(out, view, "layers", "packet_knear", soft_packed, frame,
                          lambda st: kp.k_nearest_ids_packet_ref(
                              frame, soft_packed, SOFT["k_layers"], BAND, stats=st),
                          layers, 24, 4 * SOFT["k_layers"], t_max=T_MAX, k=SOFT["k_layers"])
    else:
        ids = layers()
        dev_ms = events_ms(packet_launch("packet_knear", soft_packed, frame, T_MAX,
                                         SOFT["k_layers"]), passes=5)
        phase("packet", view=view, call="layers", kernel="packet_knear", rays=n,
              twin="not run", device_ms=f"{dev_ms:.4f}")
    cand, tm = occluder_call(tracer.table, scene, frame, ids)
    packet_call(out, view, "occluders", "packet_knear", soft_packed, cand,
                lambda st: kp.k_nearest_ids_packet_ref(cand, soft_packed, SOFT["k_occ"], BAND,
                                                       t_max=tm, stats=st),
                lambda: kp.k_nearest_ids_packet(cand, soft_packed, SOFT["k_occ"], BAND, t_max=tm),
                28, 4 * SOFT["k_occ"], t_max=tm, k=SOFT["k_occ"])
    del cand, tm, ids
    if layers_twin:  # the longest list (KM 16) on the frame
        packet_call(out, view, "k16", "packet_knear", soft_packed, frame,
                    lambda st: kp.k_nearest_ids_packet_ref(frame, soft_packed, kp.KMAX, BAND,
                                                           stats=st),
                    lambda: kp.k_nearest_ids_packet(frame, soft_packed, kp.KMAX, BAND),
                    24, 4 * kp.KMAX, t_max=T_MAX, k=kp.KMAX)
    # against the binary engine's per-ray kernels on the same tree
    hbin = kb.traverse_packed(frame, packed)
    bbin = kb.occluded_packed(sh, packed, t_sh)
    vs_bin = {"closest": by_group(hbin.tri != href.tri, ray_groups(frame)),
              "occluded": by_group(bbin != bref, ray_groups(sh)),
              "closest_packet_only_hits": int(((href.tri >= 0) & (hbin.tri < 0)).sum())}
    # the hard frame, by CUDA events
    ms = {"packet_closest": cuda_ms(lambda: kp.traverse_packet(frame, packed)),
          "packet_occluded": cuda_ms(lambda: kp.occluded_packet(sh, packed, t_sh))}
    total = cuda_ms(lambda: render_rays(tracer, frame), iters=5, warmup=1)
    extra = {f"{k}_ms": f"{v:.4f}" for k, v in (beside or {}).items()}
    phase("packet_frame", view=view, rays=n, shadow_rays=sh.o.shape[0],
          closest_ms=f"{ms['packet_closest']:.4f}", occluded_ms=f"{ms['packet_occluded']:.4f}",
          glue_ms_derived=f"{total - sum(ms.values()):.4f}", frame_ms=f"{total:.4f}",
          rays_per_s=f"{n / (total * 1e-3):.1f}", hit_frac=f"{float(href.valid.float().mean()):.4f}",
          blocked_frac=f"{float(bref.float().mean()):.4f}", vs_binary=json.dumps(vs_bin), **extra)
    out["frame"] = dict(ms, frame=total, vs_binary=vs_bin)
    return out


@torch.no_grad()
def packet_fit_chunk(scene, cam: Camera, soft_packed) -> dict:
    """packet_knear on one chunk of [fit]'s problem, as the fit's soft
    render calls it: the first FIT_CHUNKS-th of the row-major frame
    (261,120 rays at 1920x1088), k_layers, then k_occ on its candidates."""
    rays = gen_primary_rays(cam)
    m = rays.o.shape[0] // FIT_CHUNKS
    chunk = rays_slice(rays, slice(0, m))
    out = {}
    ids = packet_call(out, "fit_chunk0", "layers", "packet_knear", soft_packed, chunk,
                      lambda st: kp.k_nearest_ids_packet_ref(chunk, soft_packed, SOFT["k_layers"],
                                                             BAND, stats=st),
                      lambda: kp.k_nearest_ids_packet(chunk, soft_packed, SOFT["k_layers"], BAND),
                      24, 4 * SOFT["k_layers"], t_max=T_MAX, k=SOFT["k_layers"])
    cand, tm = occluder_call(tri_table(scene.tris), scene, chunk, ids)
    packet_call(out, "fit_chunk0", "occluders", "packet_knear", soft_packed, cand,
                lambda st: kp.k_nearest_ids_packet_ref(cand, soft_packed, SOFT["k_occ"], BAND,
                                                       t_max=tm, stats=st),
                lambda: kp.k_nearest_ids_packet(cand, soft_packed, SOFT["k_occ"], BAND, t_max=tm),
                28, 4 * SOFT["k_occ"], t_max=tm, k=SOFT["k_occ"])
    return out


@contextlib.contextmanager
def packet_knear_of(lib: ctypes.CDLL):
    """The render pipeline's k_nearest_ids_packet through lib's packet_knear
    (another tree's, bound by bind_tree) for the duration."""
    saved = pipeline_mod.k_nearest_ids_packet

    def run(rays: Rays, packed, k: int, band: float, t_min: float = DEFAULT_T_MIN,
            t_max=T_MAX) -> torch.Tensor:
        if band != BAND or t_min != DEFAULT_T_MIN:
            fail(f"packet_knear_of takes band {BAND} and the default t_min only")
        launch, (ids,) = walk_launch(lib, "packet_knear", packed, rays, t_max, k)
        launch()
        return ids

    pipeline_mod.k_nearest_ids_packet = run
    try:
        yield
    finally:
        pipeline_mod.k_nearest_ids_packet = saved


def fit_packet_ab(libs: dict, inv: InverseRenderer, target: torch.Tensor) -> dict:
    """[fit_packet] with each tree's packet_knear (the pipeline's wrapper
    swapped for the other trees', packet_knear_of) in turns other, new, new,
    other: step seconds (host clock between synchronizes, the mean of
    steps 2 on), the parameter elements that differ from the new kernel's
    fit; then one profiled step with each other tree's kernel
    (profile_fit_packet_<tree>, its packet_knear share)."""
    order = [name for other in libs if other != "new" for name in (other, "new", "new", other)]
    runs = []
    for name in order:
        secs, t_last = [], [0.0]

        def on_step(i: int, loss: float) -> None:
            torch.cuda.synchronize()
            now = time.perf_counter()
            secs.append(now - t_last[0])
            t_last[0] = now

        with packet_knear_of(libs[name]) if name != "new" else contextlib.nullcontext():
            torch.cuda.synchronize()
            t_last[0] = time.perf_counter()
            res = inv.fit(target, callback=on_step)
        runs.append((name, float(np.mean(secs[1:])), res))
    new = next(r for n, _, r in runs if n == "new")
    out = {}
    for name in libs:
        step = float(np.mean([t for n, t, _ in runs if n == name]))
        differ = sum(int((r.params[k] != new.params[k]).sum()) for n, _, r in runs if n == name
                     for k in r.params)
        out[name] = dict(step_s=step, differing=differ)
    phase("fit_packet_ab", turns=json.dumps([(n, round(t, 5)) for n, t, _ in runs]),
          **{f"{n}_step_s": f"{v['step_s']:.5f}" for n, v in out.items()},
          differing=json.dumps({n: v["differing"] for n, v in out.items()}))
    if any(v["differing"] for v in out.values()):
        FAILURES.append(f"fit_packet: a --parent tree's fit differs: {out}")
    for name in libs:
        if name != "new":
            with packet_knear_of(libs[name]):
                profile_fit(inv, target, name=f"profile_fit_packet_{name}", kernel="packet_knear")
    return out


def packet_phase(scene, cam: Camera, bscene, bcam: Camera, beside: dict,
                 libs: dict) -> dict:
    """tpurt's packet engine on the card ([packet]): Renderer(method=
    "packet") renders the 1M main view through the user's path (launch
    counts, the image against the wide8 frame by tpurt's image rule, the
    goldens); packet_view on the 1M main view, the overview and the bunny
    512^2; packet_fit_chunk; a 3-step InverseRenderer(method="packet") fit
    on the bunny ([fit_packet]); then tpurt's wavefront engine ([wave]):
    the bunny's hard frame through "wave", bitwise the "bvh" frame.
    beside: {view: {name: ms}} of the wide8 and binary frames; libs: the
    walk libraries, with --parent the other trees' ([walk_ab]'s packet
    cells on the 1M views and the bunny)."""
    t0 = time.perf_counter()
    dev = scene.tris.verts.device
    reset_launches()
    r, s_init = sync_time(lambda: Renderer(scene, RenderConfig(method="packet")))
    img, s_render = sync_time(lambda: r.render(cam))
    launches = launch_counts()
    with torch.no_grad():
        ref = render(scene, cam, method="wide8")
    off = float(((img - ref).abs().amax(dim=-1) > IMAGE_ATOL).float().mean())
    del ref
    finite = bool(torch.isfinite(img).all())
    sc, cm = make_cornell_box(device=dev)
    sb, cb = make_bunny_scene(num_tris=3000, device=dev)
    gold = {"cornell_packet_bad": golden_check(render(sc, dataclasses.replace(
                cm, width=64, height=64), method="packet"), "cornell_brute_64.npy", 0.003),
            "bunny3k_packet_bad": golden_check(render(sb, dataclasses.replace(
                cb, width=48, height=48), method="packet"), "bunny3k_packet_48.npy", 0.0),
            "cornell_soft_packet_bad": golden_check(render(sc, dataclasses.replace(
                cm, width=48, height=48), method="packet", **SOFT), "cornell_soft_48.npy",
                0.003)}
    phase("packet", path="Renderer", tris=scene.num_tris, shape=tuple(img.shape),
          init_s=f"{s_init:.3f}", render_s=f"{s_render:.3f}", finite=finite,
          vs_wide8_off_frac=off, launches=json.dumps(launches), **gold)
    if tuple(img.shape) != (cam.height, cam.width, 3) or not finite:
        fail("the packet image is not a finite (H, W, 3) array")
    if off > IMAGE_OFF_FRAC:
        fail(f"the packet image differs from the wide8 one on {off} of pixels")
    for name in ("packet_closest", "packet_occluded"):
        if launches[name] <= 0:
            fail(f"Renderer(method='packet') never launched {name}")
    del img
    soft = make_tracer(scene, "packet", band=BAND).packed
    ab = {}
    views = {"main": packet_view("main", r.tracer, soft, gen_primary_rays(cam), beside["main"],
                                 layers_twin=False, libs=libs, ab=ab)}
    over = Camera.create(eye=OVERVIEW_EYE, target=OVERVIEW_TARGET, fov_y_deg=50.0,
                         width=WIDTH, height=HEIGHT, device=dev)
    views["overview"] = packet_view("overview", r.tracer, soft, gen_primary_rays(over),
                                    beside["overview"], layers_twin=False, libs=libs, ab=ab)
    views["fit_chunk0"] = packet_fit_chunk(scene, cam, soft)
    del r, soft
    bt = make_tracer(bscene, "packet")
    bsoft = make_tracer(bscene, "packet", band=BAND).packed
    views["bunny"] = packet_view("bunny", bt, bsoft, gen_primary_rays(bcam), beside["bunny"],
                                 libs=libs, ab=ab)
    del bt, bsoft
    fitp = fit_phase(bscene, bcam, method="packet", chunks=BIN_FIT_CHUNKS, steps=BIN_FIT_STEPS,
                     name="fit_packet", kernel="packet_knear")
    profile_fit(fitp["inv"], fitp["target"], name="profile_fit_packet", kernel="packet_knear")
    launches_fit = fitp["launches"]
    fit_ab = fit_packet_ab(libs, fitp["inv"], fitp["target"]) if len(libs) > 1 else None
    del fitp
    # with --parent: [knear_ab]'s packet cells
    knear = knear_packet_ab(libs, scene, cam, bscene, bcam) if len(libs) > 1 else None
    phase("packet", seconds=f"{time.perf_counter() - t0:.1f}")
    wave_phase(scene, cam, bscene, bcam)
    return dict(views=views, launches=launches, fit_launches=launches_fit, ab=ab,
                knear_ab=knear, fit_ab=fit_ab)


@torch.no_grad()
def wave_phase(scene, cam: Camera, bscene, bcam: Camera) -> None:
    """[wave]: tpurt's wavefront engine through render(method="wave"): the
    bunny's 512^2 hard frame and the 1M main view at 1920x1088, each
    bitwise the "bvh" frame (a difference fails the script at its end),
    then the bunny's soft frame (wave_k_ids) against the "bvh" soft frame
    within the soft fit tests' rtol = atol = 2e-3; wave and bvh seconds."""
    t0 = time.perf_counter()
    for view, sc, cm, kw in (("bunny", bscene, bcam, {}), ("main", scene, cam, {}),
                             ("bunny_soft", bscene, bcam, SOFT)):
        wave, s_wave = sync_time(lambda: render(sc, cm, method="wave", **kw))
        per_ray, s_bvh = sync_time(lambda: render(sc, cm, method="bvh", **kw))
        same = bitwise_equal(wave, per_ray)
        close = bool(torch.allclose(wave, per_ray, rtol=2e-3, atol=2e-3))
        phase("wave", view=view, shape=tuple(wave.shape), soft=bool(kw), bitwise_bvh=same,
              differing_pixels=int((wave != per_ray).any(dim=-1).sum()),
              max_abs=repr(max_abs(wave, per_ray)), wave_s=f"{s_wave:.3f}",
              bvh_s=f"{s_bvh:.3f}", finite=bool(torch.isfinite(wave).all()),
              mean=f"{float(wave.mean()):.5f}")
        if not (close if kw else same) or not bool(torch.isfinite(wave).all()):
            FAILURES.append(f"the wave frame ({view}) differs from the bvh frame")
        del wave, per_ray
    phase("wave", seconds=f"{time.perf_counter() - t0:.1f}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", action="append", default=[], metavar="[NAME=]DIR",
                    help="a checkout of the parent commit (or, named, of a variant of "
                         "the kernels): time its k-nearest kernels against these in "
                         "turns ([knear_ab], [walk_ab]); repeatable")
    ap.add_argument("--packet-ab", action="store_true",
                    help="after [build], run only [walk_ab]'s and [knear_ab]'s packet cells "
                         "and [segsum_ab] against the --parent trees, and print no result "
                         "line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    phase("device", kind=json.dumps(kind), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    t_start = time.perf_counter()

    # -- build (the other trees' kernels alongside) -----------------------
    t0 = time.perf_counter()
    trees = dict(p.split("=", 1) if "=" in p else ("parent", p) for p in args.parent)
    with ThreadPoolExecutor() as pool:
        builds = {name: pool.submit(_build.build, tree_csrc(name, root))
                  for name, root in trees.items()}
        _build.load()
        built = {name: f.result() for name, f in builds.items()}
    lib = _build.library_path()
    ptxas = ptxas_report(lib[:-3] + ".log")
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}",
          lib=os.path.relpath(lib, HERE), ptxas=json.dumps(ptxas, separators=(",", ":")))
    spills = {k: v["spill_bytes"] for k, v in ptxas.items()
              if k.startswith(NO_SPILL) and v.get("spill_bytes", 0)}
    if spills:
        fail(f"kernels that must not spill spill: {spills}")
    others = {name: parent_library(name, root, built[name]) for name, root in trees.items()}
    walk_libs = {"new": this_library(), **others}
    if args.packet_ab:
        packet_ab(walk_libs, dev)
        return

    # -- scene and acceleration structure, stage by stage ----------------
    (scene, cam), s_scene = sync_time(lambda: make_sponza_scene(
        num_tris=NUM_TRIS, width=WIDTH, height=HEIGHT, device=dev))
    bvh, s_lbvh = sync_time(lambda: build_lbvh(scene.tris))
    topo, s_collapse = sync_time(lambda: collapse_wide(scene.tris, bvh))
    wide, s_pack = sync_time(lambda: pack_wide(scene.tris, bvh, *topo))
    tracer = Tracer(scene=scene, bvh=bvh, wide=wide, method="wide8")
    phase("scene", tris=scene.num_tris, wides=wide.num_wides,
          tri_rows=wide.num_rows, wide_bytes=wide_bytes(wide),
          tri_rows_bytes=tri_rows_bytes(wide), max_stack=wide.max_stack,
          max_rows=wide.max_rows, scene_s=f"{s_scene:.3f}",
          lbvh_s=f"{s_lbvh:.3f}", collapse_s=f"{s_collapse:.3f}",
          pack_s=f"{s_pack:.3f}")

    frame = morton_rays(cam)
    overview = morton_rays(Camera.create(
        eye=OVERVIEW_EYE, target=OVERVIEW_TARGET, fov_y_deg=50.0, width=WIDTH,
        height=HEIGHT, device=dev))
    main_par = parity("main", tracer, frame, count=True)
    over_par = parity("overview", tracer, overview, count=True)
    subset_timing(wide, frame, main_par)

    # -- the soft path's tree and knear8 against its twin ------------------
    soft_tracer, s_band = sync_time(lambda: make_tracer(scene, "wide8", band=BAND))
    phase("scene_band", band=BAND, wides=soft_tracer.wide.num_wides,
          tri_rows=soft_tracer.wide.num_rows, max_stack=soft_tracer.wide.max_stack,
          build_s=f"{s_band:.3f}")
    kn_main = knear_parity("main", soft_tracer, frame, count=True)
    kn_over = knear_parity("overview", soft_tracer, overview)
    del soft_tracer, kn_main["inputs"], kn_over["inputs"]

    # -- the main path, hard: render() through closest8 and occluded8 ------
    reset_launches()
    img, s_render = sync_time(lambda: render(scene, cam, method="wide8",
                                             tracer=tracer))
    launches = launch_counts()
    hit_frac = float(k8.traverse_wide8(frame, wide).valid.float().mean())
    finite = bool(torch.isfinite(img).all())
    phase("render", shape=tuple(img.shape), seconds=f"{s_render:.3f}",
          finite=finite, hit_frac=f"{hit_frac:.4f}",
          launches=json.dumps(launches), mean=f"{float(img.mean()):.5f}")
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not finite:
        fail("the rendered image is not a finite (H, W, 3) array")
    if not 0.5 < hit_frac <= 1.0:
        fail(f"hit fraction {hit_frac} outside (0.5, 1.0]")
    for name in ("closest8", "occluded8"):
        if launches[name] <= 0:
            fail(f"the hard render never launched {name}")

    # -- reference images (tpurt's goldens) on the card -------------------
    phase("golden", **goldens(dev, "wide8"))

    # -- full-frame timing and where its device time goes -----------------
    frame_ms = frame_timing("main", tracer, frame, main_par)
    over_ms = frame_timing("overview", tracer, overview, over_par)
    profile_frame(tracer, cam, frame)
    ab = walk_ab(walk_libs, cells={
        "closest8_main": ("closest8", wide, frame, None),
        "closest8_overview": ("closest8", wide, overview, None),
        "occluded8_main": ("occluded8", wide, main_par["sh_rays"], main_par["t_sh"]),
        "occluded8_overview": ("occluded8", wide, over_par["sh_rays"], over_par["t_sh"])})
    # -- tpurt's other split rule: the count tree beside the area tree -----
    split = split_rule_phase(scene, bvh, wide, {"main": frame, "overview": overview})
    del tracer, wide, main_par["sh_rays"], over_par["sh_rays"]

    # -- the binary kernels on the same 1M frame (hard only) --------------
    s_tracer = bin_tracer("sponza1m", scene)
    del bvh
    bin_main = bin_parity("sponza1m_main", s_tracer, frame, count=True)
    bin_over = bin_parity("sponza1m_overview", s_tracer,
                          rays_slice(overview, slice(0, BIN_OVERVIEW_RAYS)),
                          of_rays=overview.o.shape[0])
    bin_main["frame_ms"] = bin_timing("sponza1m_main", s_tracer, frame, bin_main,
                                      beside=frame_ms)
    ab.update(walk_ab(walk_libs, cells={
        "closest_bin_main": ("closest_bin", s_tracer.packed, frame, None),
        "closest_bin_overview": ("closest_bin", s_tracer.packed,
                                 rays_slice(overview, slice(0, BIN_OVERVIEW_RAYS)), None),
        "occluded_bin_main": ("occluded_bin", s_tracer.packed, bin_main["sh_rays"],
                              bin_main["t_sh"]),
        "occluded_bin_overview": ("occluded_bin", s_tracer.packed, bin_over["sh_rays"],
                                  bin_over["t_sh"])}))
    del s_tracer, bin_main["sh_rays"], bin_over["sh_rays"], overview

    # -- the main path, fit: InverseRenderer.fit through knear8 ------------
    fit = fit_phase(scene, cam)
    refit_wide_phase(fit)
    kn_fit = fit_knear(fit["inv"], scene, cam)
    ab8 = None
    if others:
        runs = {"new": wide8_knear(kn_fit["wide"])[0],
                **{name: parent_knear(lib, kn_fit["wide"]) for name, lib in others.items()}}
        runs["morton_sorted"] = morton_sorted(runs["new"])
        morton = knear_calls(runs["new"], tri_table(scene.tris), scene, frame, 1)
        ab8 = knear_ab("knear8", kn_fit["wide"], runs, {"new": this_library(), **others}, {
            f"{cell}_{call}": calls[call]
            for cell, calls in (("fit_chunks", kn_fit["chunks"]),
                                ("row_major_frame", kn_fit["whole"]),
                                ("morton_frame", morton))
            for call in ("layers", "occluders")})
        del morton
    del kn_fit["chunks"], kn_fit["whole"], kn_fit["inputs"], kn_fit["wide"]
    fit_check(dev)
    profile_fit(fit["inv"], fit["target"])
    fit_launches = fit["launches"]
    if gg_mod.get_grad_backend() == "segsum" and fit_launches["segsum"] == 0:
        fail("the fit's backward never launched the segsum kernels")
    # -- the gather backward: segsum on the fit's own inputs, both backends --
    seg_inputs = record_segsum(fit["inv"], fit["target"], "fit")
    seg = {k: segsum_input(k, *x) for k, x in seg_inputs.items()}
    seg_ab = segsum_ab(walk_libs, seg_inputs) if others else None
    del seg_inputs
    seg_rule = {"fit": segsum_rule("fit", fit["inv"], fit["target"])}
    # -- the distributed paths at world 1 (NCCL): the data-parallel fit --
    mesh = dist_setup()
    dfit = dist_fit(mesh, scene, cam, fit)
    del fit

    # -- the binary engine's configuration: the 70K bunny at 512x512 -------
    bscene, bcam = make_bunny_scene(device=dev)  # 70K triangles
    if (bcam.width, bcam.height) != (BUNNY_RES, BUNNY_RES):
        fail(f"the bunny's camera is {bcam.width}x{bcam.height}, not {BUNNY_RES}^2")
    b_tracer = bin_tracer("bunny", bscene)
    b_soft = bin_tracer("bunny", bscene, band=BAND)
    bframe = morton_rays(bcam)
    bin_b = bin_parity("bunny", b_tracer, bframe, count=True)
    ab.update(walk_ab(walk_libs, cells={
        "closest_bin_bunny": ("closest_bin", b_tracer.packed, bframe, None),
        "occluded_bin_bunny": ("occluded_bin", b_tracer.packed, bin_b["sh_rays"],
                               bin_b["t_sh"])}))
    kn_b = knear_parity("bunny", b_soft, bframe, count=True, name="bin_parity",
                        kernel="knear_bin")
    ab_bin = None
    if others:
        runs = {"new": bin_knear(b_soft.packed)[0],
                **{name: parent_knear(lib, b_soft.packed) for name, lib in others.items()}}
        runs["morton_sorted"] = morton_sorted(runs["new"])
        ab_bin = knear_ab("knear_bin", b_soft.packed, runs, {"new": this_library(), **others},
                          {f"bunny_{call}": [kn_b["inputs"][call]]
                           for call in ("layers", "occluders")})
    del kn_b["inputs"]
    for call in ("layers", "occluders"):
        phase("bound_bin", view="bunny", kernel="knear_bin", call=call, **kn_b["bound"][call])
    bin_launches = render_bin(bscene, bcam, dev, b_tracer, bframe)
    bin_b["frame_ms"] = bin_timing("bunny", b_tracer, bframe, bin_b)
    profile_frame(b_tracer, bcam, bframe, name="profile_bin")
    del b_tracer, b_soft
    fit_b = fit_phase(bscene, bcam, method="binary", chunks=BIN_FIT_CHUNKS,
                      steps=BIN_FIT_STEPS, name="fit_bin", kernel="knear_bin")
    profile_fit(fit_b["inv"], fit_b["target"], name="profile_fit_bin", kernel="knear_bin")
    seg_inputs = record_segsum(fit_b["inv"], fit_b["target"], "bunny")
    seg_inputs.update(segsum_patterns(dev))
    seg_inputs.update(segsum_nonfinite(dev))
    seg_inputs.update(segsum_above_rule(dev))
    seg.update({k: segsum_input(k, *x) for k, x in seg_inputs.items()})
    if others:
        seg_ab.update(segsum_ab(walk_libs, seg_inputs))
    del seg_inputs
    seg_rule["fit_bin"] = segsum_rule("fit_bin", fit_b["inv"], fit_b["target"])
    seg_picks = ("segsum" if all(r["ratio"] <= SEGSUM_RULE for r in seg_rule.values())
                 else "scatter")
    phase("segsum_default", default=gg_mod.get_grad_backend(), rule_picks=seg_picks,
          ratios=json.dumps({k: round(r["ratio"], 4) for k, r in seg_rule.items()}),
          fit_launches_per_step=fit_launches["segsum"] / FIT_STEPS,
          fit_bin_launches_per_step=fit_b["launches"]["segsum"] / BIN_FIT_STEPS)
    seg_fit_bin_launches = fit_b["launches"]["segsum"]

    def entry(name, launches_n, err, ms, plain, b, source=KERNEL_SRC, **extra):
        # library_ms: no single PyTorch call computes a BVH walk, Morton
        # codes or a radix tree
        return {"name": name, "route": "cuda", "source": source,
                "replaces": REPLACES[name], "launches": launches_n, "max_abs_err": err,
                "ms": round(ms, 4), "plain_ms": round(plain, 4),
                "bound_ms": round(b["bound_ms"], 6), "bound_by": b["bound_by"],
                "library_ms": None, **extra}

    # closest8 and occluded8: the main view's frame; ms by CUDA events
    # around the wrapper, device_ms the kernel's own from bare launches
    # ([walk_ab]); the same on the overview; parent: with --parent, each
    # other tree's ms and device ms in turns on the same cells ([walk_ab];
    # null without)
    def ab_of(prefix: str):
        if len(walk_libs) == 1:
            return None
        return {cell: v for cell, v in ab.items() if cell.startswith(prefix)}

    kernels = [entry(name, launches[name], max(main_par["err"][name], over_par["err"][name]),
                     frame_ms[name], main_par["plain_ms"][name], main_par["bound"][name],
                     device_ms=round(ab[f"{name}_main"]["new"]["device_ms"], 4),
                     overview_ms=round(over_ms[name], 4),
                     overview_device_ms=round(ab[f"{name}_overview"]["new"]["device_ms"], 4),
                     overview_plain_ms=round(over_par["plain_ms"][name], 4),
                     overview_bound_ms=round(over_par["bound"][name]["bound_ms"], 6),
                     parent=ab_of(name))
               for name in ("closest8", "occluded8")]
    # knear8: the layers call (k = 4) on the main view's Morton-ordered
    # frame, the occluders call beside it, and both calls as the fit makes
    # them (row-major chunk 0, summed over the fit's chunks, and one launch
    # over the row-major frame); ms by CUDA events around the wrapper,
    # device_ms the kernel's own from bare launches; max_abs_err is the fraction
    # of id lists that differ from the twin's, over every call, view and the
    # fit's chunk; parent: with --parent, the parent commit's kernel against
    # this one in turns on the same inputs (null without it)
    knear_err = max(v for kn in (kn_main, kn_over, kn_fit) for v in kn["mismatch_frac"].values())
    fit_keys = {}
    for call in ("layers", "occluders"):
        fit_keys.update({
            f"fit_chunk0_ms_{call}": round(kn_fit["ms"][call], 4),
            f"fit_chunk0_device_ms_{call}": round(kn_fit["device_ms"][call], 4),
            f"fit_chunk0_plain_ms_{call}": round(kn_fit["plain_ms"][call], 4),
            f"fit_chunk0_bound_ms_{call}": round(kn_fit["bound"][call]["bound_ms"], 6),
            f"fit_frame_ms_{call}": round(kn_fit["frame_ms"][call], 4),
            f"fit_frame_device_ms_{call}": round(kn_fit["frame_device_ms"][call], 4),
            f"row_major_frame_ms_{call}": round(kn_fit["row_major_ms"][call], 4),
            f"row_major_frame_device_ms_{call}": round(kn_fit["row_major_device_ms"][call], 4)})
    kernels.append(entry(
        "knear8", fit_launches["knear8"], knear_err, kn_main["ms"]["layers"],
        kn_main["plain_ms"]["layers"], kn_main["bound"]["layers"],
        id_mismatch_frac=knear_err, device_ms=round(kn_main["device_ms"]["layers"], 4),
        occluders_ms=round(kn_main["ms"]["occluders"], 4),
        occluders_device_ms=round(kn_main["device_ms"]["occluders"], 4),
        occluders_plain_ms=round(kn_main["plain_ms"]["occluders"], 4),
        occluders_bound_ms=round(kn_main["bound"]["occluders"]["bound_ms"], 6), **fit_keys,
        parent=ab8))
    # the binary kernels: the bunny frame (their configuration) first, the
    # 1M main view and the overview's first rays beside it; max_abs_err is
    # the largest |t, u, v - twin's| (closest_bin) or the mismatch fraction
    # (occluded_bin, knear_bin) over every view; the bound the smaller of the
    # near-first and escape walks' (both beside it); device_ms from
    # [walk_ab]; parent as closest8's
    for name in ("closest_bin", "occluded_bin"):
        kernels.append(entry(
            name, bin_launches[name],
            max(bin_b["err"][name], bin_main["err"][name], bin_over["err"][name]),
            bin_b["ms"][name], bin_b["plain_ms"][name], bin_b["bound"][name], source=BIN_SRC,
            mismatch_frac=max(p["mismatch"][name] for p in (bin_b, bin_main, bin_over)),
            device_ms=round(ab[f"{name}_bunny"]["new"]["device_ms"], 4),
            near_first_bound_ms=round(bin_b["bound"][name]["near_first_bound_ms"], 6),
            escape_bound_ms=round(bin_b["bound"][name]["escape_bound_ms"], 6),
            sponza1m_ms=round(bin_main["ms"][name], 4),
            sponza1m_device_ms=round(ab[f"{name}_main"]["new"]["device_ms"], 4),
            sponza1m_plain_ms=round(bin_main["plain_ms"][name], 4),
            sponza1m_bound_ms=round(bin_main["bound"][name]["bound_ms"], 6),
            sponza1m_bound_by=bin_main["bound"][name]["bound_by"],
            sponza1m_near_first_bound_ms=round(
                bin_main["bound"][name]["near_first_bound_ms"], 6),
            sponza1m_escape_bound_ms=round(bin_main["bound"][name]["escape_bound_ms"], 6),
            sponza1m_wide8_ms=round(frame_ms[name.replace("_bin", "8")], 4),
            overview_rays=BIN_OVERVIEW_RAYS, overview_ms=round(bin_over["ms"][name], 4),
            overview_device_ms=round(ab[f"{name}_overview"]["new"]["device_ms"], 4),
            parent=ab_of(name)))
    kn_err = max(kn_b["mismatch_frac"].values())
    kernels.append(entry(
        "knear_bin", fit_b["launches"]["knear_bin"], kn_err, kn_b["ms"]["layers"],
        kn_b["plain_ms"]["layers"], kn_b["bound"]["layers"], source=BIN_SRC,
        id_mismatch_frac=kn_err, device_ms=round(kn_b["device_ms"]["layers"], 4),
        occluders_ms=round(kn_b["ms"]["occluders"], 4),
        occluders_device_ms=round(kn_b["device_ms"]["occluders"], 4),
        occluders_plain_ms=round(kn_b["plain_ms"]["occluders"], 4),
        occluders_bound_ms=round(kn_b["bound"]["occluders"]["bound_ms"], 6), parent=ab_bin))
    # -- the LBVH build: morton and radix (every make_tracer above ran them) --
    tbp = {"n2": treebuild_parity("n2", codes=torch.tensor([3, 7], dtype=torch.int64,
                                                          device=dev)),
           "n2_equal": treebuild_parity("n2_equal", codes=torch.tensor(
               [5, 5], dtype=torch.int64, device=dev)),
           "all_equal": treebuild_parity("all_equal", codes=torch.full(
               (1 << 20,), 12345, dtype=torch.int64, device=dev)),
           "bunny": treebuild_parity("bunny", points=bscene.tris.centroids()),
           "sponza1m": treebuild_parity("sponza1m", points=scene.tris.centroids())}
    morton_edges(dev)
    parent_lib = others.get("parent")
    stages = {"sponza1m": build_stages("sponza1m", scene, parent=parent_lib)}
    del stages["sponza1m"]["bvh"]
    build_cells = build_inputs("sponza1m", scene.tris.centroids())
    build_cells["radix_all_equal"] = ("radix", torch.full((1 << 20,), 12345, dtype=torch.int64,
                                                          device=dev))
    # -- the main path as a user calls it: Renderer -> make_tracer -> build --
    main_launches = renderer_phase(scene, cam, img)
    # -- area lights, hard and soft: the 1M sponza and the bunny -----------
    area = area_phase(scene, cam, bscene, bcam)
    # -- the ring's local steps over 4 partitions on the card; sharding --
    fold = dist_fold(scene, cam, bscene, bcam)
    dist_shard(mesh, bscene, bcam)
    # -- tpurt's packet and wavefront engines: the 1M views and the bunny --
    pk = packet_phase(scene, cam, bscene, bcam, beside={
        "main": {"wide8_frame": frame_ms["frame"], "binary_frame": bin_main["frame_ms"]},
        "overview": {"wide8_frame": over_ms["frame"]},
        "bunny": {"binary_frame": bin_b["frame_ms"]}}, libs=walk_libs)
    del scene, img, fit_b
    torch.cuda.empty_cache()
    t5 = time.perf_counter()
    (scene5, cam5), s_scene5 = sync_time(lambda: make_sponza_scene(
        num_tris=NUM_TRIS_5M, width=WIDTH_5M, height=HEIGHT_5M, device=dev))
    tbp["sponza5m"] = treebuild_parity("sponza5m", points=scene5.tris.centroids())
    stages["sponza5m"] = build_stages("sponza5m", scene5, wide8=True, parent=parent_lib)
    build_cells.update(build_inputs("sponza5m", scene5.tris.centroids()))
    # -- the build kernels against the other trees' ------------------------
    ab_build = build_ab(walk_libs, build_cells)
    del build_cells
    phase("sponza5m", tris=scene5.num_tris, scene_s=f"{s_scene5:.3f}",
          seconds=f"{time.perf_counter() - t5:.1f}")
    del stages["sponza5m"]["bvh"]
    torch.cuda.empty_cache()
    # -- the partitioned ring on the 5M sponza against the replicated frame --
    ring5 = dist_ring(mesh, scene5, cam5)
    t_ringp = time.perf_counter()
    ring5p = dist_ring_packet(mesh, scene5, cam5, {
        "wide8_ring": ring5["ring"]["ms"]["frame"],
        "wide8_replicated": ring5["replicated"]["ms"]["frame"]})
    phase("dist_ring", engine="packet", seconds=f"{time.perf_counter() - t_ringp:.1f}")
    del scene5
    torch.cuda.empty_cache()
    t_cli = time.perf_counter()
    cli_phase(bscene, bcam)
    phase("cli", seconds=f"{time.perf_counter() - t_cli:.1f}")
    del bscene
    bench_phase()
    # morton and radix: the 1M sponza's centroids and codes first, the 5M
    # beside them; ms is the kernel's device time (radix: bare launches),
    # call_ms the wrapper call's (its host launch included); launches from
    # [renderer]; max_abs_err over every input; build_ab: [build_ab]'s
    # device and stage ms of each tree's kernel on each cell
    for name in ("morton", "radix"):
        one, five = tbp["sponza1m"][name], tbp["sponza5m"][name]
        kernels.append(entry(
            name, main_launches[name], max(p[name]["max_abs_err"] for p in tbp.values()
                                           if name in p),
            one.get("l2_flushed_ms", one["ms"]), one["plain_ms"], one, source=TREEBUILD_SRC,
            mismatches=sum(p[name]["mismatches"] for p in tbp.values() if name in p),
            call_ms=round(one["call_ms"], 4), sponza5m_ms=round(five["ms"], 4),
            sponza5m_call_ms=round(five["call_ms"], 4),
            sponza5m_plain_ms=round(five["plain_ms"], 4),
            sponza5m_bound_ms=round(five["bound_ms"], 6), sponza5m_bound_by=five["bound_by"],
            build_stage_ms=round(stages["sponza1m"]["ms"][name], 4),
            sponza5m_build_stage_ms=round(stages["sponza5m"]["ms"][name], 4),
            build_ab={cell: {t: {k: round(x, 5) for k, x in v.items()} for t, v in r.items()}
                      for cell, r in ab_build.items() if cell.startswith(name)},
            **({"l2_warm_ms": round(one["ms"], 4),
                **{f"{pre}{k}": round(r[k], 4) for pre, r in (("", one), ("sponza5m_", five))
                   for k in ("l2_flushed_ms", "l2_write_flushed_ms", "launch_floor_ms")}}
               if name == "morton" else {})))
    # the area-light path's launches of each walk kernel ([area]): closest8
    # and occluded8 in the 1M main view's hard frame, knear8 in the
    # overview chunk's soft render, the binary kernels in the bunny's
    for k in kernels:
        src = {"closest8": "main", "occluded8": "main", "knear8": "overview_soft",
               "closest_bin": "bunny", "occluded_bin": "bunny", "knear_bin": "bunny_soft"}
        if k["name"] in src:
            k["area_launches"] = area[src[k["name"]]]["launches"][k["name"]]
        # launches on the dist paths, each read from its run
        k["dist_launches"] = {cell: counts[k["name"]] for cell, counts in {
            "ring_frame_5m": ring5["ring"]["launches"],
            "ring_init_5m": ring5["ring"]["init_launches"],
            "fold_frame_1m": fold["main"]["launches"],
            "fold_soft_chunk_1m": fold["main"]["soft_launches"],
            "fold_frame_bunny": fold["bunny"]["launches"],
            "fold_soft_bunny": fold["bunny"]["soft_launches"],
            "dist_fit_1m": dfit["launches"]}.items() if counts[k["name"]]}
        if k["name"] == "occluded8":
            for view in ("main", "overview"):
                k[f"area_{view}_device_ms"] = round(area[view]["ms"]["area_device"], 4)
                k[f"area_{view}_bound_ms"] = round(area[view]["area_bound"]["bound_ms"], 6)
        # [spp]'s launches (the 1M main view at spp 4) and [split_rule]'s
        # count tree: its device ms and bound beside the area tree's, by view
        if k["name"] in ("closest8", "occluded8"):
            k["spp_launches"] = area["spp"]["main"]["launches"][k["name"]]
            k["count_tree"] = {view: {
                "device_ms": round(r["ms"]["count"][f"{k['name']}_device"], 4),
                "area_device_ms": round(r["ms"]["area"][f"{k['name']}_device"], 4),
                "ratio": round(r["ratio"][f"{k['name']}_device"], 4),
                "bound_ms": round(r["bound"][k["name"]]["bound_ms"], 6)}
                for view, r in split.items()}
    # the packet kernels: the 1M main view's frame (packet_closest,
    # packet_occluded) and [fit]'s chunk 0 (packet_knear, k_layers) first,
    # every other call beside; launches from the Renderer's frame and the
    # bunny's 3-step fit; max_abs_err the largest fraction of rays that
    # differ from the twin's (ids, flags, list entries, t/u/v bits)
    pv = pk["views"]
    for name, view, call in (("packet_closest", "main", "closest"),
                             ("packet_occluded", "main", "occluded"),
                             ("packet_knear", "fit_chunk0", "layers")):
        one = pv[view][call]
        calls = {f"{v}_{c}": {"rays": r["rays"], "ms": round(r["ms"], 4),
                              "device_ms": round(r["device_ms"], 4),
                              "plain_ms": round(r["plain_ms"], 4),
                              "bound_ms": round(r["bound"]["bound_ms"], 6), "differ": r["differ"]}
                 for v, per_call in pv.items() for c, r in per_call.items()
                 if c != "frame" and r["kernel"] == name}
        kernels.append({
            "name": name, "route": "cuda", "source": PACKET_SRC, "replaces": REPLACES[name],
            "launches": (pk["fit_launches"] if name == "packet_knear" else pk["launches"])[name],
            "max_abs_err": max(r["differ"] / r["rays"] for r in calls.values()),
            "ms": round(one["ms"], 4), "plain_ms": round(one["plain_ms"], 4),
            "bound_ms": round(one["bound"]["bound_ms"], 6), "bound_by": one["bound"]["bound_by"],
            "library_ms": None, "device_ms": round(one["device_ms"], 4),
            "view": f"{view}_{call}", "calls": calls,
            # with --parent: [walk_ab]'s cells of this kernel ([knear_ab]'s
            # for packet_knear, with [fit_packet]'s step seconds), each
            # tree's ms and device ms in turns (null without)
            "parent": ({cell: v for cell, v in pk["ab"].items() if cell.startswith(name)}
                       if name != "packet_knear" else
                       {**pk["knear_ab"], "fit_packet": pk["fit_ab"]})
            if pk["ab"] else None,
            # launches in [area]'s packet rows: the 1M main view's hard frame
            # (packet_closest, packet_occluded), the bunny's soft render
            "area_launches": (area["packet"]["bunny_soft"] if name == "packet_knear"
                              else area["packet"]["main"])["launches"][name],
            # launches on the ring's packet engine, each read from its run
            "dist_launches": {cell: counts[name] for cell, counts in {
                "ring_frame_5m": ring5p["ring_packet"]["launches"],
                "fold_frame_1m": fold["main_packet"]["launches"],
                "fold_frame_bunny": fold["bunny_packet"]["launches"],
                "fold_soft_bunny": fold["bunny_packet"]["soft_launches"]}.items()
                if counts[name]},
            **({f"ring_frame_5m_{k}": v for k, v in ring5p["ring_packet"]["twin"].items()
                if k.startswith(name)} if name != "packet_knear" else {})})
    # segsum: the soft_surface gather of [fit]'s first chunk (K x R rows,
    # 12 of 15 columns) as ms (the memset's and the kernels' device ms by
    # bare launches), plain_ms the twin's, library_ms index_add_'s (atomic);
    # launches from [fit] (3 steps), the bunny's fit, the soft area renders
    # and the dist paths; kernel_launches_per_call as the profiler counted
    # one call's (device_launches); every recorded input's ms and bound
    # under inputs
    main_seg = seg["fit_soft_surface"]
    kernels.append({
        "name": "segsum", "route": "cuda", "source": SEGSUM_SRC, "replaces": REPLACES["segsum"],
        "launches": fit_launches["segsum"], "max_abs_err": max(r["err"] for r in seg.values()),
        "ms": round(main_seg["ms"]["kernels"], 4), "plain_ms": round(main_seg["ms"]["plain"], 4),
        "bound_ms": round(main_seg["bound_ms"], 6), "bound_by": "bytes",
        "library_ms": round(main_seg["ms"]["index_add"], 4),
        "library_deterministic_ms": round(main_seg["ms"]["index_add_deterministic"], 4),
        "call_ms": round(main_seg["ms"]["call"], 4), "sort_ms": round(main_seg["ms"]["sort"], 4),
        "call_bound_ms": round(main_seg["call_bound_ms"], 6),
        "design_bound_ms": round(main_seg["design_bound_ms"], 6),
        "differing": sum(r["differ"] for r in seg.values()),
        "kernel_launches_per_call": main_seg["launches"],
        "launches_per_fit_step": fit_launches["segsum"] / FIT_STEPS,
        "fit_bin_launches": seg_fit_bin_launches,
        "area_launches": {v: area[v]["launches"]["segsum"] for v in ("bunny_soft",
                                                                     "overview_soft")},
        "dist_launches": {cell: counts["segsum"] for cell, counts in {
            "fold_soft_chunk_1m": fold["main"]["soft_launches"],
            "fold_soft_bunny": fold["bunny"]["soft_launches"],
            "dist_fit_1m": dfit["launches"]}.items() if counts["segsum"]},
        "default": gg_mod.get_grad_backend(), "rule_picks": seg_picks,
        "rule": {k: {"segsum_step_s": round(r["step"]["segsum"], 5),
                     "scatter_step_s": round(r["step"]["scatter"], 5),
                     "ratio": round(r["ratio"], 4), "repeat_differing": r["differing"]}
                 for k, r in seg_rule.items()},
        "inputs": {k: {**{m: round(x, 4) for m, x in r["ms"].items()},
                       "bound_ms": round(r["bound_ms"], 6), "launches": r["launches"]}
                   for k, r in seg.items()},
        # with --parent: [segsum_ab]'s device ms of each tree's kernels on
        # every input, in turns (null without)
        "parent": ({cell: {t: round(x["device_ms"], 4) for t, x in r.items()}
                    for cell, r in seg_ab.items()} if seg_ab else None)})
    phase("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    dist.destroy_process_group()
    if FAILURES:
        fail("; ".join(FAILURES))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
