"""Df hunt (models/claudio._hunt, ops/doppler): ms per file, from ``timing["hunt_s"]`` of the
files completed in the traced window (mean).  Nothing without a file."""


def read(data):
    files = data["files"]
    if not files:
        return None
    return 1e3 * sum(t["hunt_s"] for t in files) / len(files)
