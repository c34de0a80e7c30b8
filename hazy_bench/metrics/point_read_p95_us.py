"""95th percentile of the point reads (`point_labels_of`, every view's
label of one entity) before the profiled slice of a traced run, in us."""
import numpy as np


def read(rec):
    sp = rec["spans"]
    v = sp and sp["point_s"]
    return float(np.percentile(v, 95)) * 1e6 if v else None
