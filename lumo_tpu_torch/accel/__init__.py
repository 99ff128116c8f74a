"""BVH construction (host) and traversal (CUDA kernel)."""
