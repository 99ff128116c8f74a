"""Mean milliseconds of a gradient step's forward (``integrate`` and the
loss), each closed by a synchronize, over the traced run's steps."""


def read(run):
    t = run.spans.times.get("forward")
    return 1e3 * sum(t) / len(t) if run.kind == "grad" and t else None
