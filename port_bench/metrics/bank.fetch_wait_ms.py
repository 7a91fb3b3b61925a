"""bank step, the one fetch of the packed rows, which waits for the
device's step (``BankedReceiver._track_all``): the program's
``bank.fetch`` span, mean ms per second of the traced window."""

import program_spans


def read(data):
    return program_spans.per_second_ms(data, "bank.fetch")
