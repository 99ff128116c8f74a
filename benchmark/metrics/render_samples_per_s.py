"""Camera samples (pixel x sample) of every pass the window completed,
over the window's wall time."""


def read(run):
    return run.samples / run.window_s if run.kind == "render" else None
