"""fused_reruns: fused calls the program reran staged in the window
(`fused.FUSED_MISSES` at the window's end less at its start)."""


def read(run):
    if "fused_misses" not in run.counters_start:
        return None
    return run.counters_end["fused_misses"] - run.counters_start["fused_misses"]
