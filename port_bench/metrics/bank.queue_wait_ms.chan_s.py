"""prefetch queue (``BankedReceiver.run_stream``): the wait of
``bank.queue_wait_ms`` (a second's ``bank.upload`` end to its
``bank.process`` start, mean ms over the traced window's seconds) in the
cells where it moves ``chan_s_per_s``: the read and pack of the next
second, which fill the wait, run on the step's thread."""

import program_spans


def read(data):
    return program_spans.queue_wait_ms(data)
