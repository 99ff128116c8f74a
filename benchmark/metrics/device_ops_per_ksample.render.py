"""Device operations of the traced render units per 1,000 camera samples:
the host's launch work a sample."""
from lumobench.trace import ops_per_ksample


def read(run):
    return ops_per_ksample(run, "render")
