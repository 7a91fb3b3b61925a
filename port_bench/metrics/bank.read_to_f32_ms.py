"""sc16 read, its memory-map slice and int16 to float32 cast
(``utils/io.read_sc16_epochs``): the program's ``io.read_sc16.to_f32``
span, mean ms per second of the traced window."""

import program_spans


def read(data):
    return program_spans.per_second_ms(data, "io.read_sc16.to_f32")
