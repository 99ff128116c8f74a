"""The device's idle share over the traced render units, in %."""
from lumobench.trace import idle_share


def read(run):
    return idle_share(run, "render")
