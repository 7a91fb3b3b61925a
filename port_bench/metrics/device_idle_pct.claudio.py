"""Share of the traced window (claudio cells) in which no operation ran
on the device: 100 minus the union of the profiler's device events over
the window's length, in percent."""


def read(data):
    trace = data["trace"]
    if trace is None or not trace.events:
        return None
    t0, t1 = data["t0"], data["t1"]
    return 100.0 * (1.0 - trace.busy_s(t0, t1) / (t1 - t0))
