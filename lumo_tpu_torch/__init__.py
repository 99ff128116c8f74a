"""PyTorch/CUDA port of the lumo_tpu spectral path tracer.

The package mirrors ``lumo_tpu``'s module tree: each module here is the
counterpart of the module of the same path there (``graft_entry`` that of
the JAX package's ``__graft_entry__.py``).  It imports torch, numpy and
the standard library only; the hand-written CUDA kernels (``csrc/``: BVH
and kd-tree traversal, the in-kernel loop probe) are built with nvcc at
first use.
"""
__version__ = "0.1.0"
