"""shuffle_pairs_per_s: decks proved and verified in the window over the
window's seconds."""


def read(run):
    return run.window.rate() if run.unit == "decks" else None
