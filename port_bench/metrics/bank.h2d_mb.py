"""H2D upload (``BankedReceiver.upload_second``): the packed bytes a
second ships to the device, the mean ``bytes`` count of the program's
``bank.upload`` spans in the traced window, in MB (1e6 bytes)."""

import program_spans


def read(data):
    b = program_spans.counts(data, "bank.upload", "bytes")
    if not b:
        return None
    return sum(b) / len(b) / 1e6
