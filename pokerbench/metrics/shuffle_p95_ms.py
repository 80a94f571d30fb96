"""shuffle_p95_ms: the 95th percentile (nearest rank) of every request of
the window; a request is one deck's prove+verify, from the call's start
(its host randomness included) to its synchronised verdict."""


def read(run):
    return run.window.percentile_ms(95) if run.unit == "decks" else None
