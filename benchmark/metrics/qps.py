"""qps: queries answered by the calls that completed inside the window,
over the window's seconds (host clock)."""


def read(run):
    return run.batch * len(run.calls) / run.seconds
