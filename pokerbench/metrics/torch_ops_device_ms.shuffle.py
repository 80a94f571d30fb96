"""torch_ops_device_ms.shuffle: device ms of one traced call outside the
port's five kernels: the PyTorch operations (transcript, byte layouts, Fr
algebra) and copies."""


def read(run):
    if run.trace is None or run.unit != "decks":
        return None
    return run.trace.others_ms()
