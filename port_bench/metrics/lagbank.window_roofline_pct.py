"""The lag bank's window form against its least time.  A call launches
``lagbank_window_kernel`` and then ``lagbank_finalize_kernel``
(csrc/lagbank.cu), which writes the outputs; the call's device time is
the two launches', paired in launch order.  The share is the mean least
time of the calls' shapes (G, P, K, NL), by ``roofline.lagbank_window``,
over the mean device time of a call, in percent.  Nothing where the
trace holds no whole call."""

import roofline

WINDOW, FINALIZE = "lagbank_window_kernel", "lagbank_finalize_kernel"


def call_times(events, t0, t1):
    """Device seconds of each window-form call in [t0, t1]: a window
    launch with the finalize launch that follows it, before the next
    window launch."""
    evs = sorted((s, e, n) for n, s, e in events
                 if s >= t0 and e <= t1 and (WINDOW in n or FINALIZE in n))
    times, open_window = [], None
    for s, e, n in evs:
        if WINDOW in n:
            open_window = e - s
        elif open_window is not None:
            times.append(open_window + (e - s))
            open_window = None
    return times


def read(data):
    trace, shapes = data["trace"], data["lag_bank_shapes"]
    if trace is None or not shapes:
        return None
    times = call_times(trace.events, data["t0"], data["t1"])
    if not times:
        return None
    t_min = [roofline.lagbank_window(G, P, K, 2 * nlag + 1)["t_min_s"]
             for G, _two, P, K, nlag in shapes]
    return 100.0 * (sum(t_min) / len(t_min)) / (sum(times) / len(times))
