"""tpurt_torch — tpurt's hard and soft (differentiable) render and its fit
step in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The JAX package ``tpurt`` is the reference; this package keeps its
sub-package layout (``core/ accel/ kernels/ render/ diff/ api/``) and
function names so each piece has an obvious counterpart.  It imports torch
and numpy only.  Scenes and cameras are created on the CUDA device unless the
caller names another ``device`` (``device="cpu"`` runs the plain-torch twins
of the kernels); every function works on the device of the tensors it is
given.
"""

__version__ = "0.2.0"
