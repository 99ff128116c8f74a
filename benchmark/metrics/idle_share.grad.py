"""The device's idle share over the traced grad units, in %."""
from lumobench.trace import idle_share


def read(run):
    return idle_share(run, "grad")
