"""`insert_rows_per_s` where its runs spread too far to hold a bound
(`citeseer-k16.ingest`, whose rate follows the host's speed): training
inserts whose group commit returned in the traced run's window, over the
window's seconds (host clock; the profiled slice at the window's end is
inside it)."""


def read(rec):
    return rec["rows"] / rec["window_s"] if rec["rows"] else None
