"""shuffle_p50_ms: the median (nearest rank) of every request of the
window."""


def read(run):
    return run.window.percentile_ms(50) if run.unit == "decks" else None
