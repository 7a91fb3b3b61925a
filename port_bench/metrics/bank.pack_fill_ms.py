"""host pack, the (2 n_phys, S, 2) float32 buffer filled: raw rows, their
SIC-half copy and any SIC cleaning (``BankedReceiver._pack_second``):
the program's ``bank.pack.fill`` span, mean ms per second of the
traced window."""

import program_spans


def read(data):
    return program_spans.per_second_ms(data, "bank.pack.fill")
