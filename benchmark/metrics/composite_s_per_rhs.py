"""composite_s_per_rhs: the window's seconds over the right-hand sides solved
to the coupled system's tolerance."""


def read(run):
    solved = sum(r["n_rhs"] for r in run.requests if r["ok"])
    return run.window_s / solved if solved else None
