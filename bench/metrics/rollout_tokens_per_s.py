"""Tokens the policy generated in the window over the window's seconds (tool
and prompt tokens excluded)."""


def read(run):
    return run.generated / run.window_s if run.window_s > 0 and run.generated else None
