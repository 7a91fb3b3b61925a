"""bank step, the host's phase tables, state uploads and the track step's
launches (``BankedReceiver._track_all``): the program's
``bank.launch`` span, mean ms per second of the traced window."""

import program_spans


def read(data):
    return program_spans.per_second_ms(data, "bank.launch")
