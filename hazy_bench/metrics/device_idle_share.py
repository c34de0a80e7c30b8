"""1 − the union of the device operations' intervals over the profiled
slice's host seconds."""


def read(rec):
    t = rec["trace"]
    if not t or not t["window_s"] or not t["busy_s"]:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
