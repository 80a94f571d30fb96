"""fused_capture_s: host seconds of the fused graphs' warm-ups and
captures (the program's `fused.GRAPHS[*].capture_s`), summed."""


def read(run):
    if not run.counters_end.get("fused_graphs"):
        return None
    return run.counters_end["fused_capture_s"]
