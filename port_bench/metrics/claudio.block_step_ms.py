"""Block step (``_Resident.block_step``: cuFFT, ``ops/boundary``): the
sum over a file's blocks of ``timing["block_step_ms"]`` (CUDA events),
mean over the files completed in the traced window."""


def read(data):
    files = [t["block_step_ms"] for t in data["files"] if t["block_step_ms"]]
    if not files:
        return None
    return sum(sum(b) for b in files) / len(files)
