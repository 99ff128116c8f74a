"""Counter-based random numbers and square-to-domain warps."""
