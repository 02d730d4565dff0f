"""The share of the window spent outside the spans around the calls into the
worker (each ending with a device synchronise in a traced run): the
orchestrator, the controller, the scheduler, the predictor and the backend."""


def read(run):
    if not run.trace or run.window_s <= 0:
        return None
    inside = sum(b - a for _, a, b in run.spans)
    return 100.0 * (1.0 - inside / run.window_s)
