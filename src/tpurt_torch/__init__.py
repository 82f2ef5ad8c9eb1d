"""tpurt_torch — tpurt's hard-render path in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The JAX package ``tpurt`` is the reference; this package keeps its
sub-package layout (``core/ accel/ kernels/ render/``) and function names so
each piece has an obvious counterpart.  It imports torch and numpy only.
Nothing is moved to a device behind the caller's back: scenes and cameras are
created on the ``device`` the caller names, and every function works on the
device of the tensors it is given.
"""

__version__ = "0.1.0"
