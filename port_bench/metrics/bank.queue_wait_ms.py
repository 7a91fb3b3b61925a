"""prefetch queue (``BankedReceiver.run_stream``): how long a second's
samples wait on the device, uploaded, before the second is processed; the
mean over the traced window's seconds of the program's ``bank.process``
start minus the same second's ``bank.upload`` end, in ms.  Read where it
moves ``second_p90_ms``; ``bank.queue_wait_ms.chan_s`` is the same wait
where it moves ``chan_s_per_s``."""

import program_spans


def read(data):
    return program_spans.queue_wait_ms(data)
