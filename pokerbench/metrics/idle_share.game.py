"""idle_share.game: 1 - the busy seconds of one traced call over the mean
untraced call of the window (timed before the profiler started)."""


def read(run):
    if run.trace is None or run.unit != "games":
        return None
    return 1 - run.trace.busy_s() / run.window.mean_call_s()
