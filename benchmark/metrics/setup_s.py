"""Seconds from the process's start to the first timed unit: imports,
the CUDA context, the nvcc and g++ libraries, the scene build and one
warm-up unit."""


def read(run):
    return run.setup_s
