"""The multi-view band kernel's share of its roofline, in %: the least
time of each launch in the profiled slice (the larger of its bytes over
the HBM bandwidth and its operations over the fp32 rate of `peaks.json`)
summed, over the kernel's device time. Bytes a launch: each row of the
union of its windows read once (width × 4), a label byte written for
each window row, W, b and the windows read; operations: 2 × width a
window row. The windows are those each launch was given."""
import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json")
                   .read_text())


def least_s(union_rows, window_rows, k, d, peak):
    nbytes = union_rows * d * 4 + window_rows + k * d * 4 + k * 4 + 2 * k * 4
    flops = 2 * window_rows * d
    return max(nbytes / peak["hbm_bytes_per_s"],
               flops / peak["fp32_flops_per_s"])


def read(rec):
    t, peak = rec["trace"], PEAKS.get(rec["device"]["kind"])
    if not t or not peak:
        return None
    count, seconds = t["kernels"]["mv_band_reclassify"]
    if not count or count != len(t["launches"]):
        return None
    least = sum(least_s(*x, peak) for x in t["launches"])
    return least / seconds * 100.0
