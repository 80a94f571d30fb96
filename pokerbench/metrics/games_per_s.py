"""games_per_s: games whose whole round completed in the window over the
window's seconds."""


def read(run):
    return run.window.rate() if run.unit == "games" else None
