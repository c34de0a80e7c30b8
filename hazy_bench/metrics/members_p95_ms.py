"""95th percentile of every All-Members read in the window, from the
call until the sorted ids are on the host, in ms (host clock)."""
import numpy as np


def read(rec):
    lat = rec["lat"]["members"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
