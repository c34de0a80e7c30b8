"""Reorganizations (SKIING's and forced by an overflowing window) per
1,000 rows inserted in the window, from `skiing.reorgs`."""


def read(rec):
    return rec["counters"]["reorgs"] / (rec["rows"] / 1e3) if rec["rows"] \
        else None
