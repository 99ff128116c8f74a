"""Host I/O: Wavefront .obj/.mtl scenes and PNG/HDR images."""
