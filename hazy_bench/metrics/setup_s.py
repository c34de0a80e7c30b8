"""Seconds from the start of the process to the window: imports, the
table drawn and handed over, the facade built (its host table, holder_M,
the upload and first reorganization), kernels built when the checkout
has none yet, and the warm-up prefix of the insert stream."""


def read(rec):
    return rec["setup_s"]
