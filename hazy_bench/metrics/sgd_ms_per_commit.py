"""Host training a commit: the benchmark's span around
`ShardedFacade.insert_examples` less its span around the driver's
`apply_models` inside it, mean over the commits before the profiled
slice, in ms."""
import numpy as np


def read(rec):
    sp = rec["spans"]
    if not sp or not sp["insert_s"]:
        return None
    return float(np.mean(np.subtract(sp["insert_s"], sp["apply_s"]))) * 1e3
