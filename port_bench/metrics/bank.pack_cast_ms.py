"""host pack, the cast or quantization to the transfer format
(``BankedReceiver._pack_second``): the program's ``bank.pack.cast``
span, mean ms per second of the traced window."""

import program_spans


def read(data):
    return program_spans.per_second_ms(data, "bank.pack.cast")
