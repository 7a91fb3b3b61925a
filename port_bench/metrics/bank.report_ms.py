"""bank step, the per-channel state updates, reports, ``.dat`` rows and
log lines (``BankedReceiver._track_all``): the program's
``bank.report`` span, mean ms per second of the traced window."""

import program_spans


def read(data):
    return program_spans.per_second_ms(data, "bank.report")
