"""problems_per_s: new wave-speed models built, prepared and solved to
tolerance over the window's seconds."""


def read(run):
    return sum(1 for r in run.requests if r["ok"]) / run.window_s
