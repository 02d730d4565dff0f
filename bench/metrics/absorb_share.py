"""The share of the window inside the synchronised spans of ``extend``, the
worker's absorption of tool output."""


def read(run):
    inside = sum(b - a for kind, a, b in run.spans if kind == "absorption")
    if not run.trace or not inside:
        return None
    return 100.0 * inside / run.window_s
