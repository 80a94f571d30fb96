"""kernels_device_ms.game: device ms of one traced call in the port's five
kernels, by their device-side names."""


def read(run):
    if run.trace is None or run.unit != "games":
        return None
    return run.trace.kernels_ms()
