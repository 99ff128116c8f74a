"""PyTorch/CUDA port of the lumo_tpu spectral path tracer.

The package mirrors ``lumo_tpu``'s module tree: each module here is the
counterpart of the module of the same path there.  It imports torch,
numpy and the standard library only; the one hand-written CUDA kernel
(``csrc/bvh_traverse.cu``) is built with nvcc at first use.
"""
