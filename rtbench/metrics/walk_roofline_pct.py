"""The hard walks' share of their roofline over a traced stretch of frames.

The bound is the instruction time of the work the frames need, counted by
the reference's own walk (``reference/lbvh.py``: a binary LBVH with one
triangle a leaf, nearer child first) on a seeded sample of each traced
frame's pixels, their shadow rays and their area shadow rays, scaled to
the frame: box tests at SLAB_OPS instructions and triangle tests at
MT_OPS, over PEAK_F32_OPS.  It is divided by the device time of closest8
and occluded8, every launch of either in the stretch.  The same work
whatever walks it, so a change of tree or walk moves the share and not
the yardstick.
"""

import sys

# One slab test of a box: per axis two subtracts, two multiplies, a min
# and a max (18), the entry and exit across the axes and the ray's own
# interval (6), one compare.
SLAB_OPS = 25
# One Möller–Trumbore test: two cross products, four dot products, the
# origin's offset, a reciprocal and three scalings (adds, multiplies and
# one division; its compares not counted).
MT_OPS = 47
# The H100 SXM data sheet's 67 TFLOP/s of float32 counts an FMA as two;
# an instruction is one operation.
PEAK_F32_OPS = 67e12 / 2
WALKS = ("closest8_kernel", "occluded8_kernel")


def read(ctx):
    if ctx.kind != "frames" or ctx.trace is None or ctx.walk_work is None:
        return None
    walk_us = ctx.trace.kernel_us(lambda name: any(w in name for w in WALKS))
    if walk_us <= 0:
        return None
    boxes, tris = ctx.walk_work
    bound_s = (boxes * SLAB_OPS + tris * MT_OPS) / PEAK_F32_OPS
    print(f"walk_roofline_pct: bound {bound_s * 1e3:.4f} ms over walks "
          f"{walk_us / 1e3:.4f} ms ({ctx.frames_traced} frames; "
          f"{boxes:.6g} box tests, {tris:.6g} triangle tests); card {ctx.power_limit}",
          file=sys.stderr)
    return 100.0 * bound_s / (walk_us / 1e6)
