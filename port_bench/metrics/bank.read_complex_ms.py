"""sc16 read, the complex64 rows built from the float32 pairs
(``utils/io.read_sc16_epochs``): the program's
``io.read_sc16.to_complex`` span, mean ms per second of the traced
window."""

import program_spans


def read(data):
    return program_spans.per_second_ms(data, "io.read_sc16.to_complex")
