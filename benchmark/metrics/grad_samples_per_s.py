"""Camera samples of every gradient step the window completed, over the
window's wall time."""


def read(run):
    return run.samples / run.window_s if run.kind == "grad" else None
