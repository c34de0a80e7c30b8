"""Time `multiview_band_reclassify` of this tree beside that of another
tree on one GPU, in turns, at Forest's width (582,000 x 54 f32, k 7,
cap 291,008, block_n 16: the k-view path's tiles at cap_frac 0.5), in
three geometries of aligned windows:

  A  `chip_smoke.py` phase 3's 1% spread: view v's window starts at
     min(v * (n // k), n - cap), aligned down to block_n, 5,808 rows wide
     (views 4 to 6 are clamped to one window);
  B  the same rule at 10%: 58,192 rows a window (view 3's window
     overlaps the clamped one);
  C  the windows in the file `--windows` names, which `chip_smoke.py`
     phase 5 writes (`build/geometry_c.json`): the aligned windows that
     `covering_windows` gives on the Forest path's state at the end of
     its run.

    git archive <commit> | tar -x -C build/pair/A      # the other tree
    PYTHONPATH=src python3 -m repro_torch.launch.mv_band_pair \\
        --other build/pair/A [--windows build/geometry_c.json]

Both sources are built and loaded by `launch/pair.py`. The other tree's
C entry is called as that tree declares it: the first design's (12
arguments, its grid chosen in C) or this tree's (the plan from
`multiview_plan`). On each geometry the two kernels' labels are first
compared (equal but for proven fp32 ties: the designs sum a row in
different orders), then each is timed in the order other, this, this,
other: the median of CUDA-event times over 50 launches, each after 256 MB
were zeroed. One line a measurement; it exits non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from repro_torch.kernels.band_reclassify.kernel import (multiview_plan,
                                                        multiview_segments)
from repro_torch.launch.pair import (ORDER, build_kernel, card, events_ms,
                                     flush_buffer)

FOREST = (582_000, 54, 7)       # n, d, k
CAP, BLOCK_N = 291_008, 16      # core/sharded.py _mv_tiles(582,000, 0.5)
BYTES_PER_S = 3.35e12           # HBM3, H100 SXM data sheet
TIE_RTOL = 1e-6                 # chip_smoke.py's tie rule


def spread_windows(n, k, cap, block_n, frac):
    """(start_blocks, widths): a `frac` band a view, view v's window at
    min(v · (n // k), n − cap), aligned down to block_n."""
    width = max(block_n, int(frac * n)) // block_n * block_n
    return ([min(v * (n // k), n - cap) // block_n for v in range(k)],
            [width] * k)


def union_rows(start_blocks, widths, block_n):
    """(rows in the union of the windows, Σ window rows)."""
    lo = [s * block_n for s in start_blocks]
    hi = [a + max(0, w) for a, w in zip(lo, widths)]
    return (sum(m for _, m, _ in multiview_segments(lo, hi)),
            sum(max(0, w) for w in widths))


def band_bytes(rows, window_rows, k, d):
    """Bytes one relabel must move: `rows` rows of F read once, an int8
    label written for each window row, W, b and the windows read."""
    return rows * d * 4 + window_rows + k * d * 4 + k * 4 + 2 * k * 4


def _launch(lib, F, labels, W, b, sb, wd, *, cap, block_n):
    n, d = F.shape
    k = W.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    args = [F.data_ptr(), labels.data_ptr(), W.data_ptr(), b.data_ptr(),
            sb.data_ptr(), wd.data_ptr(), n, d, k]
    if len(lib.mv_band_reclassify.argtypes) == 12:      # the first design
        args += [cap, block_n]
    else:
        p = multiview_plan(k, d, cap, F.data_ptr() % 16)
        args += [block_n, p.chunk_bytes, p.lanes, p.grid, p.smem_bytes]
    err = lib.mv_band_reclassify(*args, stream)
    if err:
        raise RuntimeError(lib.band_reclassify_error_string(err).decode())


def _unproven(got, want, F, W, b):
    """Label disagreements whose float64 margin is not a proven tie."""
    v, r = torch.nonzero(got != want, as_tuple=True)
    f, w, bb = F[r].double(), W[v].double(), b[v].double()
    z = (f * w).sum(1) - bb
    tol = TIE_RTOL * (f.norm(dim=1) * w.norm(dim=1) + bb.abs())
    return int((z.abs() > tol).sum()), int(v.numel())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the other tree (holds src/repro_torch)")
    ap.add_argument("--windows", type=Path,
                    help="geometry C: JSON with start_blocks and widths")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mv_band_pair: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    print(card(), flush=True)
    here = Path(__file__).resolve().parents[3]
    libs = {"other": build_kernel(args.other, "band_reclassify", "other"),
            "this": build_kernel(here, "band_reclassify", "this")}

    n, d, k = FOREST
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    F = torch.randn(n, d, generator=gen, device=dev)
    W = torch.randn(k, d, generator=gen, device=dev) / d ** 0.5
    b = torch.randn(k, generator=gen, device=dev) * 0.1
    geometries = {"A": spread_windows(n, k, CAP, BLOCK_N, 0.01),
                  "B": spread_windows(n, k, CAP, BLOCK_N, 0.1)}
    if args.windows:
        c = json.loads(args.windows.read_text())
        geometries["C"] = (c["start_blocks"], c["widths"])
    flush = flush_buffer(dev)
    for geo, (sb, wd) in geometries.items():
        sbt = torch.tensor(sb, dtype=torch.int32, device=dev)
        wdt = torch.tensor(wd, dtype=torch.int32, device=dev)
        start = (torch.randint(0, 2, (k, n), generator=gen, device=dev)
                 * 2 - 1).to(torch.int8)
        out = {}
        for name, lib in libs.items():
            out[name] = start.clone()
            _launch(lib, F, out[name], W, b, sbt, wdt, cap=CAP,
                    block_n=BLOCK_N)
        torch.cuda.synchronize()
        bad, differ = _unproven(out["this"], out["other"], F, W, b)
        rows, window_rows = union_rows(sb, wd, BLOCK_N)
        bound = band_bytes(rows, window_rows, k, d) / BYTES_PER_S * 1e3
        print(f"geometry {geo}: union_rows {rows} window_rows "
              f"{window_rows} union_bound_ms {bound:.5f} labels_differ "
              f"{differ} unproven {bad}", flush=True)
        if bad:
            raise RuntimeError(f"geometry {geo}: {bad} labels differ "
                               f"between the trees (not ties)")
        labels = start.clone()
        for name in ORDER:
            ms = events_ms(lambda: _launch(
                libs[name], F, labels, W, b, sbt, wdt, cap=CAP,
                block_n=BLOCK_N), 50, flush)
            print(f"geometry {geo} {name} ms {ms:.5f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
