"""Host int8 quantize (models/claudio._quantize_q8): ms per file, from ``timing["quantize_s"]`` of the
files completed in the traced window (mean).  Nothing without a file."""


def read(data):
    files = data["files"]
    if not files:
        return None
    return 1e3 * sum(t["quantize_s"] for t in files) / len(files)
