"""Share of the profiled slice (from the first request's start to the
last one's end) in which no kernel, copy or fill ran on the device."""


def read(rec):
    sl = rec["slice"]
    if not sl.window_us:
        return None
    return 100.0 * (1.0 - sl.busy_us / sl.window_us)
