"""``BankedReceiver.process_second`` (track step, lag bank, fetch, report rows): the benchmark's span around each call in the traced
window, mean ms per call (one call a second)."""


def read(data):
    d = data["spans"].durations("process", data["t0"], data["t1"])
    if not d:
        return None
    return 1e3 * sum(d) / len(d)
