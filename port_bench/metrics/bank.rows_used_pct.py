"""H2D upload (``BankedReceiver.upload_second``): the share of the
shipped buffer rows that some channel reads, 100 times the ``rows_used``
counts of the program's ``bank.upload`` spans in the traced window over
their ``rows`` counts, in percent."""

import program_spans


def read(data):
    used = program_spans.counts(data, "bank.upload", "rows_used")
    rows = program_spans.counts(data, "bank.upload", "rows")
    if not rows or len(used) != len(rows):
        return None
    return 100.0 * sum(used) / sum(rows)
