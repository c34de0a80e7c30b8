"""Device time of each reorganization (`ShardedMultiViewHazy._do_reorg`):
CUDA events recorded on the stream before and after the call, mean over
the traced run's window (the profiled slice holds too few), in ms."""
import numpy as np


def read(rec):
    v = rec["spans"] and rec["spans"]["reorg_device_s"]
    return float(np.mean(v)) * 1e3 if v else None
