"""1 - the device's busy seconds (the union of its operations' intervals in
the trace) over the window."""


def read(run):
    if "busy_s" not in run.device:
        return None
    return 100.0 * (1.0 - run.device["busy_s"] / run.device["window_s"])
