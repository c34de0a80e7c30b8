"""Training inserts whose group commit returned in the window, over the
window's seconds (host clock, from the first call to the last return)."""


def read(rec):
    return rec["rows"] / rec["window_s"] if rec["rows"] else None
