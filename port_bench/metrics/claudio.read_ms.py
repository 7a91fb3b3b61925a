"""Raw read (utils/io.read_raw16, native/): ms per file, from ``timing["read_s"]`` of the
files completed in the traced window (mean).  Nothing without a file."""


def read(data):
    files = data["files"]
    if not files:
        return None
    return 1e3 * sum(t["read_s"] for t in files) / len(files)
