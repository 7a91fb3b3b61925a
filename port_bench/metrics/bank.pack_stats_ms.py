"""host pack, each buffer row's noise power and the peak over all rows
(``BankedReceiver._pack_second``): the program's ``bank.pack.stats``
span, mean ms per second of the traced window."""

import program_spans


def read(data):
    return program_spans.per_second_ms(data, "bank.pack.stats")
