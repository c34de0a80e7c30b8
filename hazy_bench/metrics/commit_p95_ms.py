"""95th percentile of every group commit in the window, from the call
until the device has finished its work, in ms (host clock)."""
import numpy as np


def read(rec):
    lat = rec["lat"]["commit"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
