"""device_ops_per_call.game: device operations of one traced call (kernels
and copies; `record_function` ranges excluded)."""


def read(run):
    if run.trace is None or run.unit != "games":
        return None
    return run.trace.ops()
