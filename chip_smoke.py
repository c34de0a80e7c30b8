#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (more for the kernel cases):

  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, and the full-fp32 matmul settings;
  2. build: every CUDA source of the port compiled with nvcc, in parallel;
  3. each kernel against its plain PyTorch version on the card, at the
     reference tests' shapes and at the main path's shapes; at the
     Forest, DBLife and Citeseer widths also nested, identical and
     one-view windows against the plain form that walks the kernel's plan
     (`multiview_band_reclassify_planned_ref`), each twice, bit for bit;
     then timed at a 1% band per view (geometry A; at Forest also a 10%
     band, geometry B) beside its bound over the union of the windows
     (and over their sum), 7 x `torch.mv` and one F[lo:hi] @ W.T over
     the union's span (a superset);
  4. the cora_like facade path on the CPU (plain versions) and on the GPU
     (kernels) over one stream: equal labels, counts, reorgs, overflows
     and hybrid-probe answers;
  5. the main path at full scale: Forest (582,000 x 54, 7 one-vs-all
     views) served through `make_sharded_facade` under the view driver's
     traffic mix, the golden invariant held at the end, and the kernel's
     launch count equal to the rounds that ran the update step; after
     the run, the kernel timed on the windows the next round would
     relabel (geometry C, written to build/geometry_c.json);
  6. the single-view kernels (`eps_affine`, `band_reclassify`) against
     their plain versions on the card: the reference tests' shapes and
     windows (f32 and bf16), the k = 1 multi-view equality, `eps_affine`
     at the edges of its tile plan (tails, d 3, 53 and 54 in f32 and
     bf16, views whose base is not 16-byte aligned), its count over
     repeated calls and its eps bit for bit across calls, and the Forest,
     DBLife and Citeseer widths, `band_reclassify` there at widths 0, 1,
     one wave − 1, one wave, one wave + 1, `cap` and the full table, in
     bf16 and on a view; then timed beside their bounds and a library
     yardstick at all three widths (DBLife also in bf16);
  7. the single-view engine `ShardedHazy` on the CPU (plain versions) and
     on the GPU (kernels) over the stream of the reference's single-view
     consistency test (forest_like(0.01)): equal labels, counts, reorgs,
     overflows and waters;
  8. the single-view path at full scale: DBLife (124,000 x 1024 hashed)
     through `ShardedHazy.apply_model` for 4,000 updates, the golden
     invariant and both launch-count identities held, then the same
     updates through the naive step (one `eps_affine` pass each), and a
     profiled window of each;
  9. the LM kernels (`flash_attention`, `decode_attention`) against their
     plain versions on the card at the reference tests' shapes (f32 and
     bf16), at tinyllama-1.1b's shapes, at ragged lengths, at lengths on
     either side of `flash_attention`'s 128-row tiles (hd 64 and 128),
     with q, k and v as strided views of one tensor, and at cache indices
     on either side of a 64-row tile edge; `decode_attention` in bf16 also
     at the edges of its splits (one row, a split boundary −1, 0 and +1,
     S no multiple of a split), at groups 1, 5 and 16, head dims 16 to
     128, strided k and v, NaN past cache_index (the output bit for bit
     the clean one's), against the plain split-and-combine form at its own
     split count, and twice on the same inputs (bit for bit equal); each
     case within the elementwise tolerance and the relative error norm;
     then timed at tinyllama's shapes and at qwen3-14b's heads (hd 128),
     `decode_attention` also at batch 8 (where it splits), beside their
     bounds and SDPA as the yardstick;
 10. the LM path on the CPU (plain versions) and on the GPU (kernels) with
     the same weights: an f32 twin of the tinyllama smoke config (prefill
     logits, 16 greedy decode steps with equal tokens) and the bf16 twin
     (logits within 2e-2, teacher-forced);
 11. LM serving at full scale: tinyllama-1.1b (22 layers, d 2048, bf16,
     random weights from seed 0 on the card): prefill of 8 prompts of
     2,048 tokens, then `serve_decode` at batch 64 for 2,048 steps over a
     2,048-position cache, with the launch counts (22 per prefill call and
     per decode step), a teacher-forced decode of a 256-token prompt
     against prefill, and a profiled window of 32 decode steps (which
     must show the split-KV kernel 22 times a step, and its combine as
     often as the split plan asks for it) and one prefill;
 12. the `wkv6` kernel against its plain version on the card: the
     reference tests' shapes (f32 and bf16 inputs) and model-path case,
     rwkv6-3b's prefill shape with decays where the exponent clip binds,
     ragged lengths (s 1, 63, 64, 65, 1,000 and 2,047: the last chunk
     through TMA's zero fill), every (chunk, head size) the wrapper takes,
     inputs read as views (every other head; the first K of wider rows),
     and an exact-regime case also held against the sequential
     recurrence; each within the reference test's elementwise tolerance
     and ‖got − want‖ / ‖want‖ ≤ 1e-5; two launches on the same inputs bit
     for bit equal; then timed at rwkv6-3b's prefill shape beside its
     bound;
 13. the ssm family on the CPU (plain versions) and on the GPU (kernels)
     with the same weights: f32 and bf16 twins of the rwkv6-3b smoke
     config (prefill logits, 16 greedy decode steps with equal f32 tokens,
     the RWKV state after them);
 14. RWKV-6 serving at full scale: rwkv6-3b (32 layers, d 2560, 48 padded
     heads of 64, bf16, random weights from seed 0 on the card): prefill
     of 8 prompts of 2,048 tokens, `serve_decode` at batch 64 for 256
     steps, the launch counts (`wkv6` 32 per prefill call, none per decode
     step), a teacher-forced decode of a 32-token prompt against prefill
     (the reference's chunked prefill and exact decode agree only before
     the exponent clip binds, about 40 tokens into a chunk at this init),
     and a profiled window of one prefill and 32 decode steps;
 15. the paper's host shells on the CPU (plain versions) and on the GPU
     (kernels) over one stream, modeled costs: `HazyEngine` under eager,
     lazy and hybrid (buffer_frac 0.01) and `NaiveEngine` on
     forest_like(0.01) with 400 updates of example_stream(seed=3), then
     the vectorized `MulticlassView` on cora_like; equal labels (tie
     rule), counts, reorg schedules, waters and probe answers, and
     `check_consistent()` true on the card; the single-view kernels
     launched, and no plain version on the GPU path;
 16. the single-view host engine at DBLife (124,000 x 1024, full size;
     `F` and `F_sorted` about 1.02 GB on the card) over phase 8's 4,000
     models: `HazyEngine(p=2, q=2)` eager in measured mode (the paper's
     choice) and in modeled mode, and `NaiveEngine` eager, each timed
     around all `apply_model` calls ending in a sync, with updates/s,
     reorgs, the mean band fraction, the launches of `eps_affine` and
     `band_reclassify`, the golden invariant and a profiled window of 500
     more updates;
 17. k views through the host facade at Forest (582,000 x 54, k = 7):
     `MultiViewFacade(MulticlassView)` under phase 5's traffic, inserts/s,
     reads/s, the golden invariant and a profiled window; then
     `repro_torch.launch.serve.main(["--mode", "view", ...])` at the
     reference's defaults (4,000 documents of 32 tokens, 3,000 requests),
     its req/s and "view exact";
 18. the storage tier at full size: DBLife (124,000 x 1024, 508 MB written
     as an `EntityStore` under build/storage/) through `HazyEngine`
     (hybrid, modeled, buffer_frac 0.05) over a `BufferPool` of 5% and
     10% of the table's bytes and of 10% with a `Prefetcher`, fed phase
     16's models with a count read every 500, then 5,000 seeded point
     reads; Forest (582,000 x 54, k = 7, 126 MB) through `MulticlassView`
     (hybrid, modeled) over a 10% pool, 250 group commits of 32, then
     5,000 `hybrid_labels_of` reads. Each run is held to an all-in-RAM
     eager twin on the card (tie rule), its tier counts reconciled with
     the pool's (`disk_touches` == misses without a prefetcher); printed:
     probes/s, tier shares, the pool's `stats()`, reorgs and rewarm time,
     the single-view kernels' launches and a profiled window's busy share;
 19. Layer 2 of core/engine.py on the card at Forest's size (k = 7), 24
     rounds of random drift under eager, lazy and hybrid (a catch-up every
     7th round, three probes every 5th), held to `MultiViewEngine` on the
     card in modeled mode: entity-order labels (tie rule), counts, pending
     masks and reorg schedules exactly, waters bit for bit; ms a round.

The line before the last is the `kernels` JSON record; the last line is
`{"ok": true, "device": {...}}`. Any failure raises and exits non-zero;
without a GPU the script exits non-zero before printing a result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12        # fp32 outside the tensor cores, data sheet
H100_BF16_FLOPS = 989e12       # dense bf16 tensor cores, data sheet
TIE_RTOL = 1e-6                # |w·f − b| ≤ 1e-6·(‖f‖‖w‖ + |b|) is a tie
FOREST = dict(n=582_000, d=54, k=7)      # paper Fig. 3, UCI Covertype
REQUESTS = 20_000
GROUP_COMMIT = 32              # launch/view_driver.py group commit
MIX = {"read": 0.55, "count": 0.05, "insert": 0.40}   # view_driver mix
EPS_RTOL = 1e-5                # |eps − plain| ≤ 1e-5·(‖f‖‖w‖ + |b|)
SV_UPDATES = 4_000             # single-view path: updates per run
SV_WINDOW = 500                # ... and per profiled window
LM_ARCH = "tinyllama-1.1b"     # the serving launcher's default model
LM_PREFILL = (8, 2048)         # prompts x tokens (the model's context)
LM_DECODE = (64, 2048, 2048)   # batch, cache positions, steps
LM_TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # tests/test_kernels.py _tol
LM_NORM_TOL = {"float32": 1e-5, "bfloat16": 1e-2}  # ‖got − want‖ / ‖want‖
VIEW_TABLE = (4_000, 128)       # serve --mode view: docs x 2·d_model
VIEW_ENCODE = (32, 32)          # ... its encoder's batch x tokens
VIEW_ENCODE_ATOL = 5e-3         # its features, card against CPU
WIDTHS = {"forest": (582_000, 54), "dblife": (124_000, 1024),
          "citeseer": (120_000, 4096)}     # Citeseer cut from 721,000 rows
SSM_ARCH = "rwkv6-3b"          # the ssm family's one config
SSM_PARAMS = 3_284_396_032     # rwkv6-3b with 48 padded heads
SSM_DECODE = (64, 256)         # batch, steps (a step's cost is flat in steps)
SSM_TEACHER = 32               # tokens: chunked prefill == exact decode
WKV_TOL = {"float32": 5e-4, "bfloat16": 2e-2}   # tests/test_kernels.py:207
WKV_NORM_TOL = 1e-5            # the recurrence is f32 for either input type


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


# ---------------------------------------------------------------------------
# comparison with the tie rule
# ---------------------------------------------------------------------------

def label_mismatches(got, want, F, W, b):
    """Compare (k, n) int8 label tensors whose rows are F's rows. A
    disagreement is a proven tie when the float64 margin satisfies
    |w·f − b| ≤ 1e-6·(‖f‖₂‖w‖₂ + |b|). Returns (ties, unproven)."""
    import torch
    v, r = torch.nonzero(got != want, as_tuple=True)
    if v.numel() == 0:
        return 0, 0
    f = F[r].double()
    w = W[v].double()
    bb = b.double()[v]
    z = (f * w).sum(1) - bb
    tol = TIE_RTOL * (f.norm(dim=1) * w.norm(dim=1) + bb.abs())
    ties = int((z.abs() <= tol).sum())
    return ties, int(v.numel()) - ties


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: stored eps would be off by ~1e-3")
    check(torch.get_float32_matmul_precision() == "highest",
          "fp32 matmul precision is not 'highest'")
    say("environment", device=torch.cuda.get_device_name(0),
        torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], allow_tf32=False,
        matmul_precision="highest")


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build()
    dt = time.perf_counter() - t0
    for name, log in logs.items():
        info = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "serialized" in ln]
        say("build", source=f"csrc/{name}.cu", ptxas=" | ".join(info))
    say("build", seconds=f"{dt:.2f}", sources=len(logs),
        dir=build.BUILD_DIR.relative_to(ROOT))


def _events_ms(fn, reps, flush, clean=False):
    """Median device time of `fn` over `reps` launches, each after the
    L2 cache was flushed (the main path finds the band cold after a
    round of host work and a reorganize): by zeroing `flush`, which
    leaves the cache full of dirty lines, or with `clean` by reading it."""
    import torch
    fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(reps):
        flush.sum() if clean else flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        marks.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in marks]))


def _bound(nbytes, flops, peak=H100_FP32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the `peak` rate (fp32 outside the tensor cores unless
    given)."""
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_ops = flops / peak * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _kernel_case(name, F, labels, W, b, starts, ends, *, cap, block_n,
                 expect_overflow=None):
    """Wrapper on the card vs the plain version on the same inputs."""
    import torch
    from repro_torch.kernels.band_reclassify import ops
    from repro_torch.kernels.band_reclassify.ref import (
        multiview_band_reclassify_ref)
    dev = F.device
    n = F.shape[0]
    starts = torch.as_tensor(starts, dtype=torch.int32, device=dev)
    ends = torch.as_tensor(ends, dtype=torch.int32, device=dev)
    got, overflow = ops.multiview_band_reclassify(
        F, labels.clone(), W, b, starts, ends, cap=cap, block_n=block_n,
        with_overflow=True)
    sb = torch.clamp(starts // block_n, 0, max(0, (n - cap) // block_n))
    req = ends - sb * block_n
    want = multiview_band_reclassify_ref(
        F, labels, W, b, sb, torch.clamp(req, 0, cap), cap=cap,
        block_n=block_n)
    torch.cuda.synchronize()
    check(torch.equal(overflow, req > cap), f"{name}: overflow flags differ")
    if expect_overflow is not None:
        check(overflow.cpu().tolist() == expect_overflow,
              f"{name}: overflow {overflow.cpu().tolist()} != "
              f"{expect_overflow}")
    ties, bad = label_mismatches(got, want, F, W, b)
    err = int((got.int() - want.int()).abs().max())
    say("kernel", case=name, k=W.shape[0], n=n, d=F.shape[1], cap=cap,
        block_n=block_n, rows=int(torch.clamp(req, 0, cap).sum()),
        ties=ties, mismatches=bad)
    check(bad == 0, f"{name}: {bad} label mismatches that are not ties")
    return ties, bad, err


def _planned_case(name, F, labels, W, b, start_blocks, widths, *, cap,
                  block_n):
    """The kernel on aligned windows against the plain form that walks its
    plan (`multiview_band_reclassify_planned_ref`), and a second launch on
    the same inputs bit for bit equal to the first."""
    import torch
    from repro_torch.kernels.band_reclassify import kernel
    from repro_torch.kernels.band_reclassify.kernel import multiview_plan
    from repro_torch.kernels.band_reclassify.ref import (
        multiview_band_reclassify_planned_ref)
    from repro_torch.launch.mv_band_pair import union_rows
    dev = F.device
    n, d = F.shape
    sbt = torch.tensor(start_blocks, dtype=torch.int32, device=dev)
    wdt = torch.tensor(widths, dtype=torch.int32, device=dev)
    got, again = (kernel.multiview_band_reclassify(
        F, labels.clone(), W, b, sbt, wdt, cap=cap, block_n=block_n)
        for _ in range(2))
    plan = multiview_plan(W.shape[0], d, cap, F.data_ptr() % 16)
    want = multiview_band_reclassify_planned_ref(
        F, labels, W, b, sbt, wdt, block_n=block_n, plan=plan)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{name}: two launches differ")
    ties, bad = label_mismatches(got, want, F, W, b)
    err = int((got.int() - want.int()).abs().max())
    rows, window_rows = union_rows(start_blocks, widths, block_n)
    say("kernel", case=name, k=W.shape[0], n=n, d=d, cap=cap,
        block_n=block_n, union_rows=rows, window_rows=window_rows,
        ties=ties, mismatches=bad, repeat_bitwise=True)
    check(bad == 0, f"{name}: {bad} label mismatches that are not ties")
    return ties, bad, err


def _timed(F, W, b, block_n, cap, windows, flush, geometry):
    """Kernel, plain version and two library yardsticks over the aligned
    windows (start_blocks, widths): 7 × `torch.mv`, one a window, and one
    F[lo:hi] @ Wᵀ over the union's span (a superset: every view on every
    row of the span). The bound counts each row of the union once, the
    one over Σ window rows stands beside it; `ms_clean` is the kernel
    after a read flush (clean L2 lines). Returns a timing record."""
    import torch
    from repro_torch.kernels.band_reclassify import kernel
    from repro_torch.kernels.band_reclassify.ref import (
        multiview_band_reclassify_ref)
    from repro_torch.launch.mv_band_pair import band_bytes, union_rows
    n, d = F.shape
    k = W.shape[0]
    sb, wd = windows
    dev = F.device
    sbt = torch.tensor(sb, dtype=torch.int32, device=dev)
    wt = torch.tensor(wd, dtype=torch.int32, device=dev)
    labels = torch.ones((k, n), dtype=torch.int8, device=dev)
    rows = [(s * block_n, s * block_n + w) for s, w in zip(sb, wd)]
    live = [(lo, hi) for lo, hi in rows if hi > lo]
    span = (min(lo for lo, _ in live), max(hi for _, hi in live)) if live \
        else (0, 0)

    def run_kernel():
        kernel.multiview_band_reclassify(F, labels, W, b, sbt, wt, cap=cap,
                                         block_n=block_n)

    def run_plain():
        multiview_band_reclassify_ref(F, labels, W, b, sbt, wt, cap=cap,
                                      block_n=block_n)

    def run_library():
        for v, (lo, hi) in enumerate(rows):
            torch.mv(F[lo:hi], W[v])

    def run_superset():
        F[span[0]:span[1]] @ W.T

    ms = _events_ms(run_kernel, 50, flush)
    ms_clean = _events_ms(run_kernel, 50, flush, clean=True)
    plain_ms = _events_ms(run_plain, 10, flush)
    library_ms = _events_ms(run_library, 50, flush)
    superset_ms = _events_ms(run_superset, 50, flush)
    union, window_rows = union_rows(sb, wd, block_n)
    flops = 2 * window_rows * d
    nbytes = band_bytes(union, window_rows, k, d)
    bound_ms, bound_by = _bound(nbytes, flops)
    bound_windows_ms = _bound(band_bytes(window_rows, window_rows, k, d),
                              flops)[0]
    rec = dict(ms=ms, ms_clean=ms_clean, plain_ms=plain_ms,
               library_ms=library_ms, superset_ms=superset_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               bound_windows_ms=bound_windows_ms, union_rows=union,
               window_rows=window_rows,
               bytes=nbytes)
    say("kernel-time", geometry=geometry, k=k, n=n, d=d,
        union_rows=union, window_rows=window_rows, ms=f"{ms:.5f}",
        ms_clean_l2=f"{ms_clean:.5f}", bound_ms=f"{bound_ms:.5f}",
        bound_windows_ms=f"{bound_windows_ms:.5f}",
        plain_ms=f"{plain_ms:.5f}", library_ms=f"{library_ms:.5f}",
        superset_ms=f"{superset_ms:.5f}",
        superset_rows=f"{span[1] - span[0]}(superset)",
        roofline_share=(f"{bound_ms / ms:.3f}" if union else "n/a"),
        bound_by=bound_by)
    return rec


def phase_kernels():
    """Kernel against its plain version on the card; returns the timing
    record at the main path's shape and the error totals."""
    import torch
    from repro_torch.core.sharded import _mv_tiles
    from repro_torch.launch.mv_band_pair import spread_windows
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def host(k, n, d):
        F = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32,
                         device=dev)
        lab = torch.tensor(rng.integers(0, 2, (k, n)) * 2 - 1,
                           dtype=torch.int8, device=dev)
        W = torch.tensor(rng.normal(size=(k, d)), dtype=torch.float32,
                         device=dev)
        b = torch.tensor(rng.normal(size=k), dtype=torch.float32, device=dev)
        return F, lab, W, b

    def card(k, n, d):
        F = torch.randn(n, d, generator=gen, device=dev)
        lab = torch.randint(0, 2, (k, n), generator=gen, device=dev).to(
            torch.int8) * 2 - 1
        W = torch.randn(k, d, generator=gen, device=dev) / d ** 0.5
        b = torch.randn(k, generator=gen, device=dev) * 0.1
        return F, lab, W, b

    results = []
    # the reference kernel tests' cases (tests/test_kernels.py:63-133)
    for k, n, d in [(4, 2048, 64), (7, 2048, 128), (16, 4096, 32)]:
        F, lab, W, b = host(k, n, d)
        starts = rng.integers(0, n, k)
        ends = np.minimum(starts + rng.integers(0, 1500, k), n)
        results.append(_kernel_case(f"sweep-{k}x{n}x{d}", F, lab, W, b,
                                    starts, ends, cap=2048, block_n=256))
    F, lab, W, b = host(4, 2048, 64)
    results.append(_kernel_case("empty", F, lab, W, b, [0, 512, 1024, 256],
                                [0, 512, 1000, 0], cap=1024, block_n=256,
                                expect_overflow=[False] * 4))
    results.append(_kernel_case("clamped", F, lab, W, b,
                                [1900, 2047, 1500, 0],
                                [2048, 2048, 2048, 2048], cap=1024,
                                block_n=256,
                                expect_overflow=[False, False, False, True]))
    F, lab, W, b = host(3, 2048, 32)
    results.append(_kernel_case("overflow", F, lab, W, b, [256, 256, 0],
                                [256 + 512 + 1, 256 + 512, 0], cap=512,
                                block_n=256,
                                expect_overflow=[True, False, False]))
    F, lab, W, b = host(1, 2048, 64)
    results.append(_kernel_case("single-view", F, lab, W, b, [300], [900],
                                cap=1024, block_n=256))

    # the main path's shapes: Forest, then the hashed widths of DBLife
    # (124,000 x 1024, full size) and Citeseer (cut to 120,000 x 4096)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    timing = {}
    for name, (n, d) in WIDTHS.items():
        k = 7
        _, block_n, cap = _mv_tiles(n, 0.5)
        F, lab, W, b = card(k, n, d)
        # overlapping windows through the one-pass kernel, against the plain
        # form that walks its plan: nested from the front (as the path's),
        # identical, and one view
        last = (n - cap) // block_n
        step = cap // k // block_n * block_n
        results.append(_planned_case(
            f"{name}-nested", F, lab, W, b, [0] * k,
            [step * (v + 1) for v in range(k)], cap=cap, block_n=block_n))
        results.append(_planned_case(
            f"{name}-identical", F, lab, W, b, [last // 3] * k,
            [cap // 5] * k, cap=cap, block_n=block_n))
        results.append(_planned_case(
            f"{name}-k1", F, lab[:1], W[:1].contiguous(), b[:1].contiguous(),
            [last // 2], [cap // 2 + 7], cap=cap, block_n=block_n))
        starts = torch.randint(0, n, (k,), generator=gen, device=dev)
        widths = torch.randint(0, cap + block_n, (k,), generator=gen,
                               device=dev)
        ends = torch.clamp(starts + widths, max=n)
        results.append(_kernel_case(f"{name}-random", F, lab, W, b, starts,
                                    ends, cap=cap, block_n=block_n))
        results.append(_kernel_case(f"{name}-full-cap", F, lab, W, b,
                                    [0] * k, [cap] * k, cap=cap,
                                    block_n=block_n))
        timing[name] = _timed(
            F, W, b, block_n, cap, spread_windows(n, k, cap, block_n, 0.01),
            flush, f"{name}-A")
        if name == "forest":            # geometry B: a 10% band a view
            timing["forest-B"] = _timed(
                F, W, b, block_n, cap,
                spread_windows(n, k, cap, block_n, 0.1), flush, "forest-B")
        del F, lab
    ties = sum(r[0] for r in results)
    bad = sum(r[1] for r in results)
    err = max(r[2] for r in results)
    say("kernel", cases=len(results), ties=ties, mismatches=bad,
        max_abs_err=err)
    return timing, ties, bad, err


def run_cora(device, commits, group, seed):
    """The cora_like facade path: `commits` group commits of `group`
    inserts, then hybrid point reads of every 37th entity."""
    from repro_torch.core.facade import make_sharded_facade
    from repro_torch.data import cora_like, multiclass_example_stream
    c = cora_like()
    fac = make_sharded_facade(c.features, c.num_classes, cap_frac=0.5,
                              device=device)
    stream = multiclass_example_stream(c, seed=seed)
    for _ in range(commits):
        ids, cls = zip(*(next(stream) for _ in range(group)))
        fac.insert_examples(ids, cls)
    n = fac.n
    gids = fac.state.gids.cpu().numpy()
    labels = np.empty((fac.num_views, n), np.int8)
    labels[:, gids] = fac.state.labels.cpu().numpy()
    probes = [fac.point_labels_of(i) for i in range(0, n, 37)]
    return dict(fac=fac, labels=labels, counts=fac.counts(),
                reorgs=fac.driver.skiing.reorgs,
                overflows=fac.driver.overflows,
                probe_labels=np.stack([p[0] for p in probes]),
                probe_tiers=[p[1] for p in probes])


def phase_cpu_vs_gpu(commits=40, group=16):
    import torch
    cpu = run_cora("cpu", commits, group, SEED)
    gpu = run_cora("cuda", commits, group, SEED)
    F = torch.tensor(cpu["fac"].F, dtype=torch.float64)
    W = torch.tensor(cpu["fac"].W, dtype=torch.float64)
    b = torch.tensor(cpu["fac"].b, dtype=torch.float64)
    check(np.array_equal(cpu["fac"].W, gpu["fac"].W)
          and np.array_equal(cpu["fac"].b, gpu["fac"].b),
          "cora: host models differ between the CPU and GPU runs")
    ties, bad = label_mismatches(torch.tensor(gpu["labels"]),
                                 torch.tensor(cpu["labels"]), F, W, b)
    check(bad == 0, f"cora: {bad} entity labels differ (not ties)")
    for run in (cpu, gpu):
        check(np.array_equal(run["counts"], (run["labels"] == 1).sum(1)),
              "cora: counts() != positive labels")
        check(np.array_equal(run["probe_labels"],
                             run["labels"][:, ::37].T),
              "cora: hybrid-probe labels != maintained labels")
    check(np.abs(cpu["counts"] - gpu["counts"]).sum() <= ties,
          f"cora: counts {cpu['counts']} != {gpu['counts']}")
    check(cpu["reorgs"] == gpu["reorgs"], "cora: reorg counts differ")
    check(cpu["overflows"] == gpu["overflows"], "cora: overflows differ")
    check(cpu["probe_tiers"] == gpu["probe_tiers"], "cora: probe tiers differ")
    check(cpu["counts"].min() > 0 and cpu["counts"].max() < cpu["fac"].n,
          "cora: degenerate views")
    water = sum(t.count("water") for t in gpu["probe_tiers"])
    say("cpu-vs-gpu", corpus="cora_like", n=cpu["fac"].n, k=7,
        commits=commits, group=group, counts=gpu["counts"].tolist(),
        reorgs=gpu["reorgs"], overflows=gpu["overflows"],
        probes=len(gpu["probe_tiers"]), water_resolved=water,
        label_ties=ties, equal=True)


def serve(fac, classes, kinds, rng, top_every=0):
    """Serve `kinds` through the facade: point reads, count reads, and
    inserts applied in group commits of GROUP_COMMIT (a partial group is
    applied at the end). Returns per-kind counts and host seconds."""
    n, k = fac.n, fac.num_views
    st = {"served": {kind: 0 for kind in MIX}, "rounds": 0, "tops": 0,
          "insert_s": 0.0, "read_s": 0.0, "count_s": 0.0}
    pending = []

    def commit():
        t = time.perf_counter()
        fac.insert_examples(*zip(*pending))
        st["insert_s"] += time.perf_counter() - t
        st["rounds"] += 1
        pending.clear()

    for j, kind in enumerate(kinds):
        if kind == "read":
            i = int(rng.integers(0, n))
            t = time.perf_counter()
            lab, _ = fac.point_labels_of(i)
            st["read_s"] += time.perf_counter() - t
            check(lab.shape == (k,) and set(np.unique(lab)) <= {-1, 1},
                  f"bad point read {lab}")
        elif kind == "count":
            t = time.perf_counter()
            fac.counts()
            st["count_s"] += time.perf_counter() - t
        else:
            i = int(rng.integers(0, n))
            pending.append((i, int(classes[i])))
            if len(pending) == GROUP_COMMIT:
                commit()
        st["served"][kind] += 1
        if top_every and j % top_every == top_every - 1:
            ids, z, _ = fac.top_margins(st["tops"] % k, 10)
            check(len(ids) == 10 and np.all(np.diff(z) <= 0),
                  "top_margins not sorted")
            st["tops"] += 1
    if pending:
        commit()
    return st


def golden_invariant(fac, features):
    """Labels in entity order == sign(F·Wᵀ − b) under the facade's
    models (tie rule), and counts() == their positive counts."""
    import torch
    from repro_torch.core.engine import classify
    dev = fac.driver.device
    st = fac.state
    labels = torch.empty_like(st.labels)
    labels[:, st.gids.long()] = st.labels
    F = torch.tensor(features, device=dev)
    W = torch.tensor(fac.W, device=dev)
    b32 = torch.tensor(fac.b.astype(np.float32), device=dev)
    want = classify((W @ F.T) - b32[:, None])
    ties, bad = label_mismatches(labels, want, F, W, b32)
    check(bad == 0, f"golden invariant: {bad} labels wrong (not ties)")
    counts = fac.counts()
    check(np.array_equal(counts, (labels == 1).sum(1).cpu().numpy()),
          "counts() != positive labels")
    check(counts.min() > 0 and counts.max() < fac.n, "degenerate views")
    return counts, ties


def _device_time(prof, wall_s, kernels):
    """Summary of a profiled window: wall time, device-busy time (kernels
    and copies) and its share, the five largest device operations, and
    for each name in `kernels` the launches, time per launch, total time
    and share of the device-busy time of the device operations whose name
    holds it ("not measured" where none does)."""
    import torch
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    out = dict(wall_ms=f"{wall_s * 1e3:.3f}",
               device_ops=sum(e.count for e in dev),
               device_busy_ms=(f"{busy_us / 1e3:.3f}" if busy_us
                               else "not measured"),
               device_busy_share=(f"{busy_us / 1e6 / wall_s:.4f}" if busy_us
                                  else "not measured"))
    for label, match in kernels.items():
        sel = [e for e in dev if match in e.key]
        us = sum(e.self_device_time_total for e in sel)
        count = sum(e.count for e in sel)
        out[f"{label}_launches"] = count
        out[f"{label}_ms_per_launch"] = (f"{us / count / 1e3:.5f}" if count
                                         else "not measured")
        out[f"{label}_ms"] = f"{us / 1e3:.3f}" if count else "not measured"
        out[f"{label}_share"] = (f"{us / busy_us:.4f}" if count and busy_us
                                 else "not measured")
    out["top_device"] = " | ".join(
        f"{e.key[:48]}:{e.self_device_time_total / 1e3:.3f}ms"
        f"x{e.count}" for e in top)
    return out


def profile_window(fac, classes, kinds, rng):
    """The same mix under torch.profiler: wall time, device-busy time
    (kernels and copies) and the kernels that took most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        st = serve(fac, classes, kinds, rng)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    say("main-path-profile", requests=len(kinds), rounds=st["rounds"],
        **_device_time(prof, wall_s, {"band_kernel": "band_reclassify"}))


def phase_main_path(requests=REQUESTS, seed=SEED, device=None):
    """Forest at full scale through the facade under the view driver's
    mix; holds the golden invariant and the launch count, then profiles
    a further window of the same mix."""
    import torch
    from repro_torch.core.facade import make_sharded_facade
    from repro_torch.data import multiclass_corpus
    from repro_torch.kernels.band_reclassify import kernel
    t0 = time.perf_counter()
    c = multiclass_corpus("FC", FOREST["n"], FOREST["d"], FOREST["k"],
                          seed=seed)
    fac = make_sharded_facade(c.features, FOREST["k"], p=2.0, q=2.0, lr=0.1,
                              l2=1e-4, cap_frac=0.5, device=device)
    cuda = fac.driver.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "the driver left TF32 matmuls on")
    drv = fac.driver
    rng = np.random.default_rng(seed + 1)
    kinds = rng.choice(list(MIX), size=requests, p=list(MIX.values()))
    reorgs0, over0 = drv.skiing.reorgs, drv.overflows
    incr0 = drv.skiing.total_incremental

    kernel.multiview_band_reclassify.launches = 0
    st = serve(fac, c.classes, kinds, rng, top_every=requests // 4)
    launches = kernel.multiview_band_reclassify.launches

    reorgs = drv.skiing.reorgs - reorgs0
    overflows = drv.overflows - over0
    skiing_reorgs = reorgs - overflows     # these launch nothing
    update_rounds = st["rounds"] - skiing_reorgs
    if cuda:
        check(0 < launches == update_rounds,
              f"kernel launches {launches} != update-step rounds "
              f"{update_rounds} (or none)")
    counts, ties = golden_invariant(fac, c.features)
    incr = update_rounds - overflows
    served = st["served"]
    say("main-path", corpus="forest", n=fac.n, d=fac.d, k=fac.num_views,
        cap=drv.cap, block_n=drv.block_n, requests=requests,
        served=served, setup_s=f"{setup_s:.2f}", rounds=st["rounds"],
        update_rounds=update_rounds, launches=launches, reorgs=reorgs,
        overflows=overflows,
        mean_band_fraction=(
            f"{(drv.skiing.total_incremental - incr0) / incr:.6f}"
            if incr else "n/a"),
        ms_per_round=f"{st['insert_s'] / st['rounds'] * 1e3:.3f}",
        inserts_per_s=f"{served['insert'] / st['insert_s']:.1f}",
        point_reads_per_s=f"{served['read'] / st['read_s']:.1f}",
        count_reads_per_s=f"{served['count'] / st['count_s']:.1f}",
        top_margins=st["tops"], tier_hits=fac.tier_hits,
        counts=counts.tolist(), golden_ties=ties, golden_ok=True)
    geometry_c = None
    if cuda:
        window = rng.choice(list(MIX), size=2000, p=list(MIX.values()))
        profile_window(fac, c.classes, window, rng)
        golden_invariant(fac, c.features)
        geometry_c = time_path_windows(drv, fac)
    return launches, geometry_c


def time_path_windows(drv, fac):
    """Geometry C, after the run and outside its timed and profiled
    windows: the aligned windows that `covering_windows` gives on the
    path's end state under the current waters of `drv` (the rows the
    next round would relabel), timed on that state's table and models.
    The windows go to build/geometry_c.json for
    `launch/mv_band_pair.py`."""
    import torch
    from repro_torch.core.engine import covering_windows
    st = fac.state
    dev = drv.device
    n = st.F.shape[0]
    start, end, _ = covering_windows(
        st.eps, torch.tensor(drv.lw, dtype=torch.float32, device=dev),
        torch.tensor(drv.hw, dtype=torch.float32, device=dev))
    sb = torch.clamp(start // drv.block_n, 0,
                     max(0, (n - drv.cap) // drv.block_n))
    wd = torch.clamp(end - sb * drv.block_n, 0, drv.cap)
    windows = (sb.tolist(), wd.tolist())
    out = ROOT / "build" / "geometry_c.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"start_blocks": windows[0],
                               "widths": windows[1], "n": n,
                               "cap": drv.cap, "block_n": drv.block_n}))
    say("geometry-c", start_rows=[s * drv.block_n for s in windows[0]],
        widths=windows[1], file=out.relative_to(ROOT))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    W = torch.tensor(fac.W, dtype=torch.float32, device=dev)
    b = torch.tensor(fac.b.astype(np.float32), device=dev)
    return _timed(st.F, W, b, drv.block_n, drv.cap, windows, flush,
                  "forest-C")


# ---------------------------------------------------------------------------
# single view: eps_affine and band_reclassify, ShardedHazy
# ---------------------------------------------------------------------------

def _one(w, b):
    """A single view's model as the (1, d) / (1,) pair of label_mismatches."""
    return w[None], b.reshape(1)


def _labels_case(name, got, want, F, w, b, **fields):
    """Single-view labels from a kernel against its plain version."""
    ties, bad = label_mismatches(got[None], want[None], F, *_one(w, b))
    err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
    say("kernel", case=name, n=F.shape[0], d=F.shape[1],
        dtype=str(F.dtype).replace("torch.", ""), **fields, ties=ties,
        mismatches=bad)
    check(bad == 0, f"{name}: {bad} label mismatches that are not ties")
    return ties, bad, err


def _eps_case(name, F, w, b):
    """`eps_affine` on the card against `eps_affine_ref`: labels up to the
    tie rule, the count up to those ties, eps within EPS_RTOL of the dot
    product's scale ‖f‖₂‖w‖₂ + |b|."""
    import torch
    from repro_torch.kernels.eps_affine import ops
    from repro_torch.kernels.eps_affine.ref import eps_affine_ref
    eps, lab, cnt = ops.eps_affine(F, w, b)
    want_eps, want_lab, want_cnt = eps_affine_ref(F, w, b)
    torch.cuda.synchronize()
    scale = (F.float().norm(dim=1) * w.norm() + b.abs()).clamp_min(1e-30)
    rel = float(((eps - want_eps).abs() / scale).max())
    ties, bad, _ = _labels_case(name, lab, want_lab, F, w, b, kernel=
                                "eps_affine", count=int(cnt),
                                eps_rel_err=f"{rel:.3e}")
    check(rel <= EPS_RTOL, f"{name}: eps off by {rel:.3e} of its scale")
    check(int(cnt) == int((lab == 1).sum()),
          f"{name}: count {int(cnt)} != positive labels")
    check(abs(int(cnt) - int(want_cnt)) <= ties,
          f"{name}: count {int(cnt)} != plain {int(want_cnt)}")
    return ties, bad, float((eps - want_eps).abs().max())


def _band_wave(d, itemsize):
    """Rows the single-view band kernel has in flight in one wave at row
    width d: rows a block at most, times the grid's limit."""
    from repro_torch.kernels.band_reclassify.kernel import (
        BAND_RESIDENT, BAND_THREADS, SMS, band_plan)
    return BAND_THREADS // band_plan(1, d, itemsize).lanes * SMS * \
        BAND_RESIDENT


def _eps_edge_cases(rng, put):
    """`eps_affine` where its tile plan has edges: n no multiple of the
    rows of a tile (a tail of one 12-byte row, and longer ones), d = 53 and
    54 in f32 and bf16, a view whose base is not 16-byte aligned (F[1:]),
    the count exact over two calls and after a call on another table (the
    ticket back at 0), and equal eps bits over two calls."""
    import torch
    from repro_torch.kernels.eps_affine import kernel, ops
    from repro_torch.kernels.eps_affine.kernel import tile_plan
    out = []
    for d, dt in [(3, torch.float32), (53, torch.float32),
                  (54, torch.float32), (53, torch.bfloat16),
                  (54, torch.bfloat16)]:
        size = 2 if dt == torch.bfloat16 else 4
        R = tile_plan(1, d, size).rows_per_tile
        for n in (5 * R + 1, 7 * R + R // 2, R - 1):
            F = put(rng.normal(size=(n + 1, d))).to(dt)
            w, b = put(rng.normal(size=d)), put(rng.normal())
            tag = f"eps-edge-{n}x{d}-{str(dt)[6:]}"
            out.append(_eps_case(tag, F[:n], w, b))
            out.append(_eps_case(tag + "-view", F[1:], w, b))
    # two calls, a call on another table, and a third: counts exact,
    # eps bits equal, the ticket left at 0
    F = put(rng.normal(size=(124_000, 64)))
    G = put(rng.normal(size=(5_000, 54)))
    w, b = put(rng.normal(size=64)), put(0.25)
    wg, bg = put(rng.normal(size=54)), put(-0.5)
    e1, l1, c1 = ops.eps_affine(F, w, b)
    e2, l2, c2 = ops.eps_affine(F, w, b)
    _, lg, cg = ops.eps_affine(G, wg, bg)
    e3, _, c3 = ops.eps_affine(F, w, b)
    torch.cuda.synchronize()
    tickets = [int(t[0]) for t in kernel._scratch.values()]
    check(torch.equal(e1.view(torch.int32), e2.view(torch.int32))
          and torch.equal(e1.view(torch.int32), e3.view(torch.int32))
          and torch.equal(l1, l2), "eps_affine: two calls differ in bits")
    check(int(c1) == int(c2) == int(c3) == int((l1 == 1).sum()),
          f"eps_affine: counts {int(c1)}, {int(c2)}, {int(c3)} over three "
          f"calls, {int((l1 == 1).sum())} positive labels")
    check(int(cg) == int((lg == 1).sum()), "eps_affine: count of table 2")
    check(tickets and not any(tickets), f"eps_affine tickets {tickets}")
    say("kernel", case="eps-repeat", kernel="eps_affine",
        counts=[int(c1), int(c2), int(cg), int(c3)], equal_bits=True,
        tickets=tickets)
    return out


def _random_labels(n, gen):
    """n labels of ±1 (int8), drawn on the card."""
    import torch
    return torch.randint(0, 2, (n,), generator=gen,
                         device=gen.device).to(torch.int8) * 2 - 1


def _band_rows_cases(name, F, lab, w, b, windows):
    """`band_reclassify_rows` over each {case: (start, width)} window of F
    against its plain version."""
    from repro_torch.kernels.band_reclassify import ops as band_ops
    from repro_torch.kernels.band_reclassify.ref import (
        band_reclassify_rows_ref)
    out = []
    for case, (start, width) in windows.items():
        start = min(start, F.shape[0] - width)
        got = band_ops.band_reclassify_rows(F, lab.clone(), w, b, start,
                                            width)
        want = band_reclassify_rows_ref(F, lab, w, b, start, width)
        out.append(_labels_case(f"band-{name}-{case}", got, want, F, w, b,
                                kernel="band_reclassify", rows=width))
    return out


def _timed_single(name, F, w, b, flush, frac=0.01):
    """Both single-view kernels, their plain versions and a library
    yardstick: `eps_affine` over every row, `band_reclassify` over a
    `frac` band. Returns {kernel: timing record}."""
    import torch
    from repro_torch.kernels.band_reclassify import kernel as band
    from repro_torch.kernels.band_reclassify.ref import (
        band_reclassify_rows_ref)
    from repro_torch.kernels.eps_affine import kernel as eps
    from repro_torch.kernels.eps_affine.ref import eps_affine_ref
    n, d = F.shape
    size = F.element_size()
    width = max(1, int(frac * n))
    lo = n // 3
    labels = torch.ones(n, dtype=torch.int8, device=F.device)
    w_lib = w.to(F.dtype)            # torch.mv takes one dtype
    runs = {
        "eps_affine": (lambda: eps.eps_affine(F, w, b),
                       lambda: eps_affine_ref(F, w, b),
                       lambda: torch.mv(F, w_lib),
                       n * d * size + n * 5 + d * 4 + 4 + 4, 2 * n * d, n),
        "band_reclassify": (
            lambda: band.band_reclassify(F, labels, w, b, lo, width),
            lambda: band_reclassify_rows_ref(F, labels, w, b, lo, width),
            lambda: torch.mv(F[lo:lo + width], w_lib),
            width * d * size + width + d * 4 + 4, 2 * width * d, width)}
    recs = {}
    for kname, (kern, plain, lib, nbytes, flops, rows) in runs.items():
        ms = _events_ms(kern, 50, flush)
        plain_ms = _events_ms(plain, 10, flush)
        library_ms = _events_ms(lib, 50, flush)
        bound_ms, bound_by = _bound(nbytes, flops)
        recs[kname] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by, rows=rows,
                           bytes=nbytes)
        say("kernel-time", kernel=kname, shape=name, n=n, d=d, rows=rows,
            ms=f"{ms:.5f}", bound_ms=f"{bound_ms:.5f}",
            plain_ms=f"{plain_ms:.5f}", library_ms=f"{library_ms:.5f}",
            roofline_share=f"{bound_ms / ms:.3f}", bound_by=bound_by)
    return recs


def phase_single_view_kernels():
    """`eps_affine` and the single-view `band_reclassify` against their
    plain versions on the card, then timed. Returns per kernel its timing
    record at DBLife's width (the single-view main path's) and its error
    totals."""
    import torch
    from repro_torch.kernels.band_reclassify import ops as band_ops
    from repro_torch.kernels.band_reclassify.ref import (
        band_reclassify_ref, band_reclassify_rows_ref)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 2)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    res = {"eps_affine": [], "band_reclassify": []}

    def put(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=dev)

    # eps_affine at the reference test's shapes (tests/test_kernels.py:24)
    for n, d in [(256, 54), (1000, 128), (513, 300)]:
        F = rng.normal(size=(n, d)).astype(np.float32)
        w, b = put(rng.normal(size=d)), put(rng.normal())
        for dt in (torch.float32, torch.bfloat16):
            res["eps_affine"].append(_eps_case(
                f"eps-{n}x{d}-{str(dt)[6:]}", put(F).to(dt), w, b))
    # band_reclassify at tests/test_kernels.py:39-61's windows, through the
    # tile-aligned wrapper, against the tile-window plain version
    for n, d, start, end in [(2048, 64, 300, 700), (2048, 64, 0, 1),
                             (2048, 64, 1500, 2048), (4096, 200, 100, 4000)]:
        F = put(np.sort(rng.normal(size=(n, d)), axis=0))
        lab = put(rng.integers(0, 2, n) * 2 - 1, torch.int8)
        w, b, block_n = put(rng.normal(size=d)), put(0.1), 256
        cap = min(4096 if end - start > 1024 else 1024, n)
        sb = min(max(0, start // block_n), max(0, (n - cap) // block_n))
        width = int(np.clip(end - sb * block_n, 0, cap))
        got = band_ops.band_reclassify(F, lab.clone(), w, b, start, end,
                                       cap=cap, block_n=block_n)
        want = band_reclassify_ref(F, lab[:, None], w, b, sb, width,
                                   cap=cap, block_n=block_n)[:, 0]
        res["band_reclassify"].append(_labels_case(
            f"band-{n}x{d}-{start}-{end}", got, want, F, w, b,
            kernel="band_reclassify", rows=width))
    # a k = 1 multi-view launch equals the single-view kernel
    # (tests/test_kernels.py:120-133)
    F = put(np.sort(rng.normal(size=(2048, 64)), axis=0))
    lab = put(rng.integers(0, 2, 2048) * 2 - 1, torch.int8)
    w, b = put(rng.normal(size=64)), put(0.1)
    single = band_ops.band_reclassify(F, lab.clone(), w, b, 300, 900,
                                      cap=1024, block_n=256)
    multi = band_ops.multiview_band_reclassify(
        F, lab[None].clone(), w[None], b.reshape(1), [300], [900],
        cap=1024, block_n=256)[0]
    res["band_reclassify"].append(_labels_case(
        "band-k1-multiview", single, multi, F, w, b,
        kernel="band_reclassify"))

    res["eps_affine"] += _eps_edge_cases(rng, put)

    # the full widths, on data made on the card
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    timing = {}
    for name, (n, d) in WIDTHS.items():
        F = torch.randn(n, d, generator=gen, device=dev)
        w = torch.randn(d, generator=gen, device=dev) / d ** 0.5
        b = torch.randn((), generator=gen, device=dev) * 0.1
        res["eps_affine"].append(_eps_case(f"eps-{name}", F, w, b))
        if name == "dblife":
            res["eps_affine"].append(_eps_case(
                f"eps-{name}-bf16", F.to(torch.bfloat16), w, b))
        lab = _random_labels(n, gen)
        cap = max(64, n // 64)
        lo = int(torch.randint(0, n - cap, (), generator=gen, device=dev))
        wave = _band_wave(d, 4)
        res["band_reclassify"] += _band_rows_cases(name, F, lab, w, b, {
            "random": (lo, cap), "full": (0, n), "empty": (lo, 0),
            "one-row": (lo, 1), "wave-1": (lo, wave - 1),
            "wave": (lo, wave), "wave+1": (lo, wave + 1)})
        if name != "citeseer":     # bf16; F[1:] is 8-byte aligned at d 54
            for case, (G, L) in {"bf16": (F.to(torch.bfloat16), lab),
                                 "view": (F[1:], lab[1:])}.items():
                got = band_ops.band_reclassify_rows(G, L.clone(), w, b, lo,
                                                    cap)
                want = band_reclassify_rows_ref(G, L, w, b, lo, cap)
                res["band_reclassify"].append(_labels_case(
                    f"band-{name}-{case}", got, want, G, w, b,
                    kernel="band_reclassify", rows=cap))
        timing[name] = _timed_single(name, F, w, b, flush)
        if name == "dblife":
            _timed_single(f"{name}-bf16", F.to(torch.bfloat16), w, b, flush)
        del F, lab

    # serve --mode view's table (phase 17): 4,000 unit-norm rows of 128,
    # and bands of its hot-buffer size (1%), 10%, the whole table and its
    # tail
    n, d = VIEW_TABLE
    F = torch.randn(n, d, generator=gen, device=dev)
    F /= F.norm(dim=1, keepdim=True)
    w = torch.randn(d, generator=gen, device=dev)
    b = torch.randn((), generator=gen, device=dev) * 0.1
    res["eps_affine"].append(_eps_case("eps-view", F, w, b))
    res["band_reclassify"] += _band_rows_cases(
        "view", F, _random_labels(n, gen), w, b, {
            "1%": (1_733, n // 100), "10%": (1_200, n // 10),
            "full": (0, n), "empty": (900, 0), "one-row": (3_999, 1),
            "tail": (n - 417, 417)})

    out = {}
    for kname, cases in res.items():
        out[kname] = dict(timing["dblife"][kname],
                          ties=sum(c[0] for c in cases),
                          mismatches=sum(c[1] for c in cases),
                          max_abs_err=max(c[2] for c in cases))
        say("kernel", kernel=kname, cases=len(cases),
            ties=out[kname]["ties"], mismatches=out[kname]["mismatches"],
            max_abs_err=out[kname]["max_abs_err"])
    return out


def _sgd_models(corpus, count, seed=3, **stream_kw):
    """The host model after each of `count` examples of the corpus's
    stream (sgd_step, lr 0.02, l2 1e-3, as the reference's single-view
    consistency test trains)."""
    from repro_torch.core.linear_model import sgd_step, zero_model
    from repro_torch.data import example_stream
    model = zero_model(corpus.features.shape[1])
    stream = example_stream(corpus, seed=seed, **stream_kw)
    models = []
    for _, f, y in (next(stream) for _ in range(count)):
        model = sgd_step(model, f, y, lr=0.02, l2=1e-3)
        models.append(model)
    return models


def run_single_view(device, F, models, M, cap_frac):
    """`ShardedHazy` over the models; its end state, as host values."""
    from repro_torch.core.sharded import ShardedHazy
    n, d = F.shape
    sh = ShardedHazy(n=n, d=d, M=M, p=2.0, cap_frac=cap_frac, device=device)
    state = sh.init_state(F)
    for m in models:
        state = sh.apply_model(state, m.w, m.b)
    return dict(labels=sh.labels_in_entity_order(state),
                members=sh.all_members(state), reorgs=sh.skiing.reorgs,
                overflows=sh.overflows, lw=sh.lw, hw=sh.hw,
                a=sh.skiing.a)


def phase_cpu_vs_gpu_single_view(updates=400):
    """The stream of the reference's single-view consistency test
    (tests/test_distributed.py:103-130) on the CPU and on the GPU."""
    import torch
    from repro_torch.data import forest_like
    c = forest_like(scale=0.01)
    F = np.ascontiguousarray(c.features)
    models = _sgd_models(c, updates, label_noise=0.0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)         # tiny CPU products: threads only cost
    try:
        cpu = run_single_view("cpu", F, models, 1.0, 1 / 4)
    finally:
        torch.set_num_threads(threads)
    gpu = run_single_view("cuda", F, models, 1.0, 1 / 4)
    m = models[-1]
    Ft = torch.tensor(F)
    w, b = torch.tensor(m.w), torch.tensor(np.float32(m.b))
    ties, bad = label_mismatches(torch.tensor(gpu["labels"])[None],
                                 torch.tensor(cpu["labels"])[None], Ft,
                                 *_one(w, b))
    check(bad == 0, f"single view: {bad} entity labels differ (not ties)")
    truth = np.where(F @ m.w - m.b >= 0, 1, -1)
    check(np.array_equal(cpu["labels"], truth),
          "single view: CPU labels != sign(F·w − b)")
    check(abs(cpu["members"] - gpu["members"]) <= ties,
          f"single view: members {cpu['members']} != {gpu['members']}")
    for key in ("reorgs", "overflows", "lw", "hw", "a"):
        check(cpu[key] == gpu[key],
              f"single view: {key} {cpu[key]} != {gpu[key]}")
    say("cpu-vs-gpu-single-view", corpus="forest_like(0.01)", n=F.shape[0],
        d=F.shape[1], updates=updates, members=gpu["members"],
        reorgs=gpu["reorgs"], overflows=gpu["overflows"], lw=gpu["lw"],
        hw=gpu["hw"], label_ties=ties, equal=True)


def single_view_golden(sh, state, F_dev, model):
    """Labels in entity order == sign(F·w − b) under `model` (tie rule),
    and all_members == their positives."""
    import torch
    from repro_torch.core.engine import classify
    dev = F_dev.device
    labels = torch.tensor(sh.labels_in_entity_order(state), device=dev)
    w = torch.tensor(model.w, device=dev)
    b = torch.tensor(np.float32(model.b), device=dev)
    want = classify(torch.mv(F_dev, w) - b)
    ties, bad = label_mismatches(labels[None], want[None], F_dev,
                                 *_one(w, b))
    check(bad == 0, f"single-view golden invariant: {bad} labels wrong")
    members = sh.all_members(state)
    check(members == int((labels == 1).sum()),
          "all_members != positive labels")
    check(0 < members < sh.n, "degenerate view")
    return members, ties


def _profile_updates(step, state, models):
    """`state = step(state, m.w, m.b)` over the models under
    torch.profiler; returns the end state and the window's summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for m in models:
            state = step(state, m.w, m.b)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    return state, _device_time(prof, wall_s, {
        "band_kernel": "band_reclassify_kernel",
        "eps_kernel": "eps_affine_kernel"})


def phase_single_view_path(updates=SV_UPDATES, window=SV_WINDOW):
    """DBLife at full size through `ShardedHazy.apply_model` (the paper's
    incremental path under SKIING), then the same updates through the
    naive step; holds the golden invariant and the launch counts, and
    profiles a window of each. Returns the launches of the incremental
    run per kernel."""
    import torch
    from repro_torch.core.sharded import ShardedHazy
    from repro_torch.core.waters import holder_M
    from repro_torch.data import dblife_like
    from repro_torch.kernels.band_reclassify import kernel as band
    from repro_torch.kernels.eps_affine import kernel as eps
    t0 = time.perf_counter()
    c = dblife_like()
    F = c.features
    n, d = F.shape
    sh = ShardedHazy(n=n, d=d, M=holder_M(F, 2.0), p=2.0, cap_frac=1 / 64)
    F_dev = torch.tensor(F, device=sh.device)       # entity order, checks
    t = time.perf_counter()
    models = _sgd_models(c, updates + window)
    sgd_s = time.perf_counter() - t

    band.band_reclassify.launches = 0
    eps.eps_affine.launches = 0
    state = sh.init_state(F)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0 - sgd_s
    t = time.perf_counter()
    for m in models[:updates]:
        state = sh.apply_model(state, m.w, m.b)
    torch.cuda.synchronize()
    incr_s = time.perf_counter() - t
    launches = {"band_reclassify": band.band_reclassify.launches,
                "eps_affine": eps.eps_affine.launches}

    reorgs, overflows = sh.skiing.reorgs, sh.overflows
    rounds = updates - reorgs            # banded rounds that kept labels
    check(0 < launches["band_reclassify"] == rounds,
          f"band_reclassify launches {launches['band_reclassify']} != "
          f"incremental rounds without overflow {rounds}")
    check(launches["eps_affine"] == reorgs + 1,
          f"eps_affine launches {launches['eps_affine']} != reorgs "
          f"{reorgs} + 1")
    members, ties = single_view_golden(sh, state, F_dev, models[updates - 1])
    say("single-view-path", corpus="dblife", n=n, d=d, cap=sh.cap,
        updates=updates, setup_s=f"{setup_s:.2f}",
        sgd_ms_per_update=f"{sgd_s / len(models) * 1e3:.4f}",
        rounds=updates, incremental_rounds=rounds, reorgs=reorgs,
        overflows=overflows, launches=launches,
        mean_band_fraction=(f"{sh.skiing.total_incremental / rounds:.6f}"
                            if rounds else "n/a"),
        updates_per_s=f"{updates / incr_s:.1f}",
        ms_per_update=f"{incr_s / updates * 1e3:.4f}", members=members,
        golden_ties=ties, golden_ok=True)

    eps.eps_affine.launches = 0
    naive = state
    t = time.perf_counter()
    for m in models[:updates]:
        naive = sh.apply_model_naive(naive, m.w, m.b)
    torch.cuda.synchronize()
    naive_s = time.perf_counter() - t
    check(eps.eps_affine.launches == updates,
          f"naive: eps_affine launches {eps.eps_affine.launches} != "
          f"{updates}")
    n_members, n_ties = single_view_golden(sh, naive, F_dev,
                                           models[updates - 1])
    check(abs(n_members - members) <= ties + n_ties,
          "naive and incremental counts differ")
    say("single-view-naive", corpus="dblife", updates=updates,
        launches=eps.eps_affine.launches,
        updates_per_s=f"{updates / naive_s:.1f}",
        ms_per_update=f"{naive_s / updates * 1e3:.4f}",
        incremental_over_naive=f"{naive_s / incr_s:.3f}",
        members=n_members, golden_ok=True)

    tail = models[updates:]
    state, prof = _profile_updates(sh.apply_model, state, tail)
    say("single-view-profile", step="incremental", updates=len(tail), **prof)
    naive, prof = _profile_updates(sh.apply_model_naive, naive, tail)
    say("single-view-profile", step="naive", updates=len(tail), **prof)
    single_view_golden(sh, state, F_dev, tail[-1])
    single_view_golden(sh, naive, F_dev, tail[-1])
    return launches


# ---------------------------------------------------------------------------
# LM serving: flash_attention and decode_attention, the dense model
# ---------------------------------------------------------------------------

def _within(name, got, want, dtype, norm=False, tol=None, norm_tol=None,
            **fields):
    """|got − want| ≤ tol + tol·|want| elementwise, tol from LM_TOL (the
    reference kernel tests' tolerance) unless given; with `norm`, also
    ‖got − want‖ / ‖want‖ ≤ LM_NORM_TOL (or `norm_tol`), a limit rounding
    stays well below but a kernel that reads one row too many or too few
    does not reach (it moves a 700-row average by about 1/700 against
    values of about 1/√700). Returns the largest |got − want|."""
    import torch
    name_dt = str(dtype).replace("torch.", "")
    tol = LM_TOL[name_dt] if tol is None else tol
    norm_tol = LM_NORM_TOL[name_dt] if norm_tol is None else norm_tol
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    bad = int(((g - w).abs() > tol + tol * w.abs()).sum())
    finite = bool(torch.isfinite(g).all())
    rel = float(torch.linalg.vector_norm(g - w)
                / torch.linalg.vector_norm(w).clamp_min(1e-30))
    if norm:
        fields.update(rel_norm_err=f"{rel:.3e}", norm_tol=norm_tol)
    say("lm-kernel", case=name, dtype=name_dt, **fields,
        max_abs_err=f"{err:.3e}", tol=tol, violations=bad)
    check(finite and bad == 0,
          f"{name}: {bad} elements outside {tol} (finite={finite})")
    check(not norm or rel <= norm_tol,
          f"{name}: relative error norm {rel:.3e} over {norm_tol}")
    return err


def phase_lm_kernels():
    """Both LM kernels against their plain versions on the card, then
    timed at tinyllama's shapes. Returns {kernel: record}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, decode_attention_split_ref)
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 4)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)

    def host(shape, dtype):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=dev).to(dtype)

    def card(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def flash_plain(q, k, v):
        return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2)).transpose(1, 2)

    errs = {"flash_attention": [], "decode_attention": []}
    bf16, f32 = torch.bfloat16, torch.float32
    # tests/test_kernels.py:136-140, then tinyllama's prefill and a ragged s
    flash_cases = [((1, 128, 4, 4, 32), d, host) for d in (f32, bf16)]
    flash_cases += [((2, 256, 8, 2, 32), d, host) for d in (f32, bf16)]
    flash_cases += [((1, 512, 6, 1, 64), d, host) for d in (f32, bf16)]
    flash_cases += [((8, 2048, 32, 4, 64), bf16, card),
                    ((8, 1000, 32, 4, 64), bf16, card),
                    ((8, 65, 32, 4, 64), bf16, card)]   # one row past a tile
    # the other head dims the kernels are built for, at ragged lengths
    flash_cases += [((2, 333, 8, 2, 128), d, card) for d in (f32, bf16)]
    flash_cases += [((1, 77, 4, 2, 16), d, card) for d in (f32, bf16)]
    # serve --mode view's encoder (phase 17): the smoke twin's heads at its
    # batch of 32 documents of 32 tokens
    flash_cases += [((VIEW_ENCODE[0], VIEW_ENCODE[1], 4, 2, 16), bf16, card)]
    # the wgmma kernel's 128-row tile edges, at tinyllama's heads (hd 64)
    # and qwen3-14b's (hd 128)
    flash_cases += [((2, s, nq, nkv, hd), bf16, card)
                    for nq, nkv, hd in ((32, 4, 64), (40, 8, 128))
                    for s in (1, 127, 128, 129, 255, 2047)]
    flash_cases += [((8, 2048, 40, 8, 128), bf16, card)]   # timed below
    # q, k and v as strided views: head slices of one fused tensor
    flash_cases += [((2, 300, nq, nkv, hd), bf16, "fused")
                    for nq, nkv, hd in ((32, 4, 64), (40, 8, 128))]
    for (b, s, nq, nkv, hd), dt, make in flash_cases:
        if make == "fused":
            qkv = card((b, s, nq + 2 * nkv, hd), dt)
            q, k, v = qkv.split((nq, nkv, nkv), dim=2)
        else:
            q, k, v = (make((b, s, h, hd), dt) for h in (nq, nkv, nkv))
        got = fk.flash_attention(q, k, v)
        errs["flash_attention"].append(_within(
            f"flash-{b}x{s}x{nq}/{nkv}x{hd}"
            + ("-strided" if make == "fused" else ""), got,
            flash_plain(q, k, v), dt, norm=True))
    # tests/test_kernels.py:153-155, then tinyllama's decode and a ragged S
    decode_cases = [((2, 1024, 8, 2, 32), 700), ((1, 512, 4, 4, 64), 0),
                    ((2, 2048, 16, 8, 32), 2047)]
    decode_cases = [(c, i, d, host) for c, i in decode_cases
                    for d in (f32, bf16)]
    # ... cache_index 1, and 63 / 64 on either side of a 64-row tile edge
    decode_cases += [((64, 2048, 32, 4, 64), i, bf16, card)
                     for i in (0, 1, 63, 64, 700, 2047)]
    decode_cases += [((64, 1000, 32, 4, 64), 999, bf16, card),
                     ((3, 100, 40, 8, 128), 57, f32, card),
                     ((2, 50, 4, 2, 16), 49, f32, card)]
    # the bf16 kernel's split edges at tinyllama's heads and batch 8
    # (b · nkv 32, 8 splits at most): cache_index 1,535 gives 8 splits of
    # 192 rows, 1,534 a last split one row short, 1,536 7 splits of 256 and
    # a last split of one row; 1,000 is no multiple of a tile, and S 777 no
    # multiple of a split
    decode_cases += [((8, 2048, 32, 4, 64), i, bf16, card)
                     for i in (1534, 1535, 1536, 1000, 2047)]
    decode_cases += [((8, 777, 32, 4, 64), 776, bf16, card)]
    # group 1, group 5 (qwen3-14b's heads, the hd-128 timing shape), group
    # 16, and head dims 16 and 32
    decode_cases += [((8, 1024, 8, 8, 64), 1000, bf16, card),
                     ((64, 2048, 40, 8, 128), 2047, bf16, card),
                     ((4, 600, 40, 8, 128), 555, bf16, card),
                     ((8, 1024, 32, 2, 64), 900, bf16, card),
                     ((8, 1024, 32, 2, 128), 333, bf16, card),
                     ((8, 1024, 32, 4, 16), 1023, bf16, card),
                     ((8, 1024, 32, 4, 32), 640, bf16, card)]
    # k and v as strided views of one (b, S, 2 nkv, hd) tensor; NaN in
    # every cache row past cache_index
    decode_cases += [((16, 2048, 32, 4, 64), 1500, bf16, "fused"),
                     ((16, 1024, 40, 8, 128), 700, bf16, "fused"),
                     ((16, 2048, 32, 4, 64), 1234, bf16, "nan")]
    for (b, S, nq, nkv, hd), idx, dt, make in decode_cases:
        draw = card if isinstance(make, str) else make
        q = draw((b, nkv, nq // nkv, hd), dt)
        if make == "fused":
            K, V = draw((b, S, 2 * nkv, hd), dt).split(nkv, dim=2)
        else:
            K, V = (draw((b, S, nkv, hd), dt) for _ in "kv")
        got = dk.decode_attention(q, K, V, idx)
        if make == "nan":
            Kn, Vn = K.clone(), V.clone()
            Kn[:, idx + 1:] = float("nan")
            Vn[:, idx + 1:] = float("nan")
            dirty = dk.decode_attention(q, Kn, Vn, idx)
            check(torch.equal(dirty, got), "decode: NaN past cache_index "
                  "changed the output")
        name = f"decode-{b}x{S}x{nq}/{nkv}x{hd}@{idx}" + (
            f"-{'strided' if make == 'fused' else make}"
            if isinstance(make, str) else "")
        errs["decode_attention"].append(_within(
            name, got, decode_attention_ref(q, K, V, idx), dt, norm=True))
        if dt == bf16:                  # the plain split-and-combine form
            splits, rows = dk.split_plan(idx + 1, b * nkv)
            _within(name + f"-vs-{splits}-splits", got,
                    decode_attention_split_ref(q, K, V, idx, splits, rows),
                    dt, norm=True, splits=splits, rows=rows)
    # a bf16 call (8 splits and their combine) is bit for bit the same
    # from run to run
    q = card((8, 4, 8, 64), bf16)
    K, V = (card((8, 2048, 4, 64), bf16) for _ in "kv")
    check(torch.equal(dk.decode_attention(q, K, V, 2047),
                      dk.decode_attention(q, K, V, 2047)),
          "decode: two calls on the same inputs differ")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    recs = {}
    runs = {}
    # tinyllama-1.1b's prefill, then qwen3-14b's heads at the same length
    for name, (nq, nkv, hd) in (("flash_attention", (32, 4, 64)),
                                ("flash_attention_hd128", (40, 8, 128))):
        b, s = LM_PREFILL
        q, k, v = (card((b, s, h, hd), bf16) for h in (nq, nkv, nkv))
        causal = b * nq * s * (s + 1) // 2          # (query, key) pairs
        runs[name] = (
            lambda q=q, k=k, v=v: fk.flash_attention(q, k, v),
            lambda q=q, k=k, v=v: flash_plain(q, k, v),
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True),
            (2 * q.numel() + 2 * k.numel()) * 2, 4 * causal * hd,
            f"b {b}, s {s}, {nq}/{nkv} heads, hd {hd}")
    # tinyllama-1.1b's decode at the end of the context, then qwen3-14b's
    # heads at the same batch and length, then tinyllama's at batch 8 (8
    # splits and their combine; one split at batch 64)
    _, S, _ = LM_DECODE
    idx = S - 1
    mask = torch.ones(1, 1, 1, S, dtype=torch.bool, device=dev)
    mask[..., idx + 1:] = False
    for name, (bd, nq, nkv, hd) in (
            ("decode_attention", (LM_DECODE[0], 32, 4, 64)),
            ("decode_attention_hd128", (LM_DECODE[0], 40, 8, 128)),
            ("decode_attention_b8", (8, 32, 4, 64))):
        qd = card((bd, nkv, nq // nkv, hd), bf16)
        K, V = (card((bd, S, nkv, hd), bf16) for _ in "kv")
        runs[name] = (
            lambda qd=qd, K=K, V=V: dk.decode_attention(qd, K, V, idx),
            lambda qd=qd, K=K, V=V: decode_attention_ref(qd, K, V, idx),
            lambda qd=qd, K=K, V=V, bd=bd, nq=nq, hd=hd:
                F.scaled_dot_product_attention(
                    qd.reshape(bd, 1, nq, hd).transpose(1, 2),
                    K.transpose(1, 2), V.transpose(1, 2), attn_mask=mask,
                    enable_gqa=True),
            (2 * qd.numel() + 2 * bd * (idx + 1) * nkv * hd) * 2,
            4 * bd * nq * (idx + 1) * hd,
            f"b {bd}, S {S}, cache_index {idx}, {nq}/{nkv} heads, hd {hd}")
    for name, (kern, plain, lib, nbytes, flops, shape) in runs.items():
        ms = _events_ms(kern, 20, flush)
        plain_ms = _events_ms(plain, 5, flush)
        library_ms = _events_ms(lib, 20, flush)
        bound_ms, bound_by = _bound(nbytes, flops, H100_BF16_FLOPS)
        recs[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        if name in errs:                # a kernel's record, not a timing row
            recs[name].update(max_abs_err=max(errs[name]),
                              cases=len(errs[name]))
        say("lm-kernel-time", kernel=name, shape=shape, bytes=nbytes,
            flops=flops, ms=f"{ms:.5f}", bound_ms=f"{bound_ms:.5f}",
            bound_by=bound_by, plain_ms=f"{plain_ms:.5f}",
            library_ms=f"{library_ms:.5f}",
            roofline_share=f"{bound_ms / ms:.4f}")
    say("lm-kernel", cases={n: len(e) for n, e in errs.items()},
        max_abs_err={n: f"{max(e):.3e}" for n, e in errs.items()})
    return recs


def _lm_twin(dtype):
    import dataclasses
    from repro_torch.configs import smoke_config
    return dataclasses.replace(smoke_config(LM_ARCH), dtype=dtype,
                               param_dtype=dtype)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_lm_cpu_vs_gpu(steps=16, batch=2, prompt=64):
    """The same weights (the port's init on the CPU, copied to the card)
    through the plain versions on the CPU and the kernels on the GPU."""
    import torch
    from repro_torch.models import build
    from repro_torch.models.params import init_params
    from repro_torch.models.steps import init_cache, make_prefill_step
    rng = np.random.default_rng(SEED + 5)
    for dtype in ("float32", "bfloat16"):
        mdl = build(_lm_twin(dtype))
        tol = LM_TOL[dtype]
        p_cpu = init_params(mdl.param_tree, SEED, "cpu")
        p_gpu = _to(p_cpu, "cuda")
        toks = rng.integers(0, mdl.cfg.vocab_size, (batch, prompt)).astype(
            np.int32)
        pre = make_prefill_step(mdl)
        l_cpu = pre(p_cpu, {"tokens": torch.tensor(toks)})
        l_gpu = pre(p_gpu, {"tokens": torch.tensor(toks, device="cuda")})
        pre_err = float((l_gpu.cpu().float() - l_cpu.float()).abs().max())
        check(pre_err <= tol, f"{dtype}: prefill logits differ by {pre_err}")
        c_cpu = init_cache(mdl, batch, steps, device="cpu")
        c_gpu = init_cache(mdl, batch, steps, device="cuda")
        t_cpu = torch.zeros((batch, 1), dtype=torch.int32)
        t_gpu = t_cpu.cuda()
        dec_err = 0.0
        for i in range(steps):
            lc, c_cpu = mdl.decode(p_cpu, c_cpu, t_cpu, i)
            lg, c_gpu = mdl.decode(p_gpu, c_gpu, t_gpu, i)
            dec_err = max(dec_err, float(
                (lg.cpu().float() - lc.float()).abs().max()))
            t_cpu = lc[:, -1].argmax(-1).to(torch.int32)[:, None]
            if dtype == "float32":      # each feeds itself: tokens equal
                t_gpu = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
                check(torch.equal(t_cpu, t_gpu.cpu()),
                      f"f32 decode step {i}: tokens differ")
            else:                       # teacher-forced: the CPU's tokens
                t_gpu = t_cpu.cuda()
        check(dec_err <= tol, f"{dtype}: decode logits differ by {dec_err}")
        cache_err = float((c_gpu["blocks"]["pos0"]["k"].cpu().float()
                           - c_cpu["blocks"]["pos0"]["k"].float()).abs().max())
        check(cache_err <= tol, f"{dtype}: caches differ by {cache_err}")
        say("lm-cpu-vs-gpu", model=mdl.cfg.name, dtype=dtype,
            layers=mdl.cfg.num_layers, batch=batch, prompt=prompt,
            decode_steps=steps, prefill_max_abs_err=f"{pre_err:.3e}",
            decode_logits_max_abs_err=f"{dec_err:.3e}",
            cache_max_abs_err=f"{cache_err:.3e}", tol=tol,
            tokens_equal=dtype == "float32" or "teacher-forced")


def phase_lm_serving():
    """tinyllama-1.1b at full width and depth, bf16, random weights from
    seed 0 drawn on the card: prefill, `serve_decode`, the launch counts,
    a teacher-forced check against prefill, and a profiled window.
    Returns the launches of each kernel on this path."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import decode_loop, serve_decode
    from repro_torch.models import build
    from repro_torch.models.steps import (init_cache, init_serving_params,
                                          make_decode_step,
                                          make_prefill_step)
    cfg = get_config(LM_ARCH)
    mdl = build(cfg)
    L, vp = cfg.num_layers, cfg.padded_vocab()
    t = time.perf_counter()
    params = init_serving_params(mdl, SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(x.numel() for x in _leaves(params))
    weight_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    rng = np.random.default_rng(SEED + 6)
    b, s = LM_PREFILL
    prompts = torch.tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                           dtype=torch.int32, device="cuda")
    prefill = make_prefill_step(mdl)

    # prefill: one warm call, then timed calls, each ending in a sync
    logits = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    calls = 5
    fk.flash_attention.launches = 0
    dk.decode_attention.launches = 0
    call_s = []
    for _ in range(calls):
        t = time.perf_counter()
        logits = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t)
    prefill_s = float(np.median(call_s))
    flash_launches = fk.flash_attention.launches
    check(flash_launches == L * calls and dk.decode_attention.launches == 0,
          f"prefill launches: flash {flash_launches} != {L} x {calls}")
    check(logits.shape == (b, vp) and bool(torch.isfinite(logits).all()),
          "prefill logits not finite or misshapen")
    say("lm-prefill", model=cfg.name, layers=L, d_model=cfg.d_model,
        params=n_params, weight_bytes=weight_bytes, init_s=f"{init_s:.2f}",
        prompts=b, tokens_per_prompt=s, calls=calls,
        ms_per_call=[f"{x * 1e3:.3f}" for x in call_s],
        median_ms=f"{prefill_s * 1e3:.3f}",
        tokens_per_s=f"{b * s / prefill_s:.1f}",
        flash_launches=flash_launches, flash_per_call=flash_launches // calls)

    # decode: the serving launcher's loop at batch 64 over 2,048 positions
    bd, cache_len, steps = LM_DECODE
    fk.flash_attention.launches = 0
    dk.decode_attention.launches = 0
    run = serve_decode(LM_ARCH, steps, bd, cache_len, params=params)
    decode_launches = dk.decode_attention.launches
    check(decode_launches == L * steps and fk.flash_attention.launches == 0,
          f"decode launches {decode_launches} != {L} x {steps}")
    toks = run.tokens
    check(toks.shape == (bd, steps) and bool(((toks >= 0) & (toks < vp))
                                             .all()),
          "decode tokens outside the padded vocab")
    tail = 256
    tail_ms = sum(run.step_ms[-tail:])
    say("lm-decode", model=cfg.name, batch=bd, cache_len=cache_len,
        steps=steps, seconds=f"{run.seconds:.3f}",
        tokens_per_s=f"{steps * bd / run.seconds:.1f}",
        ms_per_step=f"{run.seconds / steps * 1e3:.4f}",
        device_ms_per_step=f"{sum(run.step_ms) / steps:.4f}",
        step_ms_median=f"{np.median(run.step_ms):.4f}",
        step_ms_p99=f"{np.percentile(run.step_ms, 99):.4f}",
        last_steps=tail, last_ms_per_step=f"{tail_ms / tail:.4f}",
        last_tokens_per_s=f"{tail * bd / tail_ms * 1e3:.1f}",
        weight_read_bound_ms=f"{weight_bytes / H100_BYTES_PER_S * 1e3:.4f}",
        decode_launches=decode_launches,
        launches_per_step=decode_launches // steps,
        distinct_tokens=int(toks.unique().numel()))
    del run

    # teacher forcing: decode over a 256-token prompt == prefill on it
    tf = 256
    prompt = prompts[:, :tf]
    want = prefill(params, {"tokens": prompt})
    cache = init_cache(mdl, b, tf)
    for i in range(tf):
        got, cache = mdl.decode(params, cache, prompt[:, i:i + 1], i)
    tf_err = _within("teacher-forced-256", got[:, -1], want, torch.bfloat16,
                     prompts=b)
    agree = float((got[:, -1].argmax(-1) == want.argmax(-1)).float().mean())
    del cache

    # profiled window: 32 decode steps at the end of the context, 1 prefill
    window = 32
    cache = init_cache(mdl, bd, cache_len)
    dec = make_decode_step(mdl)
    tok = toks[:, -1:].contiguous()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        decode_loop(dec, params, cache, tok, cache_len - window, window)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    rec = _device_time(prof, wall_s, {"decode_split": "decode_split_kernel",
                                      "decode_combine":
                                          "decode_combine_kernel",
                                      "decode_all": "decode_",
                                      "flash_kernel": "flash_"})
    say("lm-profile", step="decode", steps=window,
        start_index=cache_len - window, **rec)
    combines = L * sum(dk.split_plan(i + 1, bd * cfg.num_kv_heads)[0] > 1
                       for i in range(cache_len - window, cache_len))
    check(rec["decode_split_launches"] == L * window
          and rec["decode_combine_launches"] == combines,
          f"profiled decode window: split-KV kernel launches "
          f"{rec['decode_split_launches']} (expected {L * window}), "
          f"combine {rec['decode_combine_launches']} (expected {combines})")
    del cache
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    say("lm-profile", step="prefill", prompts=b, tokens_per_prompt=s,
        **_device_time(prof, wall_s, {"flash_kernel": "flash_"}))
    say("lm-serving", teacher_forced_max_abs_err=f"{tf_err:.3e}",
        teacher_forced_argmax_agree=f"{agree:.4f}",
        peak_memory_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    return {"flash_attention": flash_launches,
            "decode_attention": decode_launches}


# ---------------------------------------------------------------------------
# the ssm family: wkv6 and rwkv6-3b serving
# ---------------------------------------------------------------------------

def _wkv_bound(b, s, H, K, chunk):
    """(bytes, operations) of one WKV6 launch: four f32 inputs read once,
    the f32 output written once, and the work the function needs per
    (batch row, head, chunk of c rows): the inter-chunk and state products
    (2cK² each), the strictly lower triangle of the intra-chunk attention
    and its product with v (2K·c(c−1)/2 each), and the bonus (6cK)."""
    nbytes = 5 * b * s * H * K * 4 + H * K * 4
    flops = 0
    for c0 in range(0, s, chunk):
        c = min(chunk, s - c0)
        flops += 4 * c * K * K + 2 * K * c * (c - 1) + 6 * c * K
    return nbytes, flops * b * H


def phase_wkv6_kernel():
    """`wkv6` against its plain version on the card, then timed at
    rwkv6-3b's prefill shape. Returns its record."""
    import torch
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.kernels.wkv6 import ops
    from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref, wkv6_ref
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 7)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    f32, bf16 = torch.float32, torch.bfloat16

    def host(shape, dtype, decay):
        """r, k, v, la from numpy (la = -exp(N(-decay, 0.5))), u (H, K)."""
        xs = [rng.normal(size=shape) for _ in "rkv"]
        xs.append(-np.exp(rng.normal(size=shape) * 0.5 - decay))
        t = [torch.tensor(x, dtype=f32, device=dev).to(dtype) for x in xs]
        return t + [torch.tensor(rng.normal(size=shape[2:]), dtype=f32,
                                 device=dev)]

    def card(shape, dtype, decay):
        xs = [torch.randn(shape, generator=gen, device=dev) for _ in "rkv"]
        xs.append(-torch.exp(torch.randn(shape, generator=gen, device=dev)
                             * 0.5 - decay))
        return [x.to(dtype) for x in xs] + [
            torch.randn(shape[2:], generator=gen, device=dev)]

    # tests/test_kernels.py:188-211 (decay e^-2 a token), :214-228 (e^-1,
    # chunk 16); rwkv6-3b's prefill at about -1 a token (the reference's
    # init: the clip binds some 40 tokens into every chunk); ragged s
    cases = [((2, 128, 3, 16), 32, d, 2.0, host) for d in (f32, bf16)]
    cases += [((1, 64, 2, 32), 64, d, 2.0, host) for d in (f32, bf16)]
    cases += [((2, 96, 1, 16), 32, d, 2.0, host) for d in (f32, bf16)]
    cases += [((2, 64, 2, 16), 16, f32, 1.0, host),
              ((8, 2048, 48, 64), 64, f32, 0.0, card),
              ((8, 2048, 48, 64), 64, bf16, 0.0, card)]
    cases += [((2, s, 48, 64), 64, f32, 0.0, card)
              for s in (1, 63, 64, 65, 1000, 2047)]
    # every (chunk, head size) the wrapper takes, ragged
    cases += [((2, 100, 3, K), c, f32, 1.0, card)
              for c in wk.CHUNKS for K in wk.HEAD_SIZES]
    errs = []
    for shape, chunk, dt, decay, make in cases:
        r, k, v, la, u = make(shape, dt, decay)
        got = ops.wkv6(r, k, v, la, u, chunk=chunk)
        want, _ = wkv6_chunked_ref(r, k, v, la, u, chunk)
        name = str(dt).replace("torch.", "")
        errs.append(_within(
            f"wkv6-{'x'.join(map(str, shape))}-c{chunk}", got, want, dt,
            norm=True, tol=WKV_TOL[name], norm_tol=WKV_NORM_TOL,
            decay=f"-e^{-decay:g}"))
    # views read through their strides, no copy: every other head of a
    # tensor with twice the heads, and the first K channels of rows K + 16
    # wide
    for how in ("heads", "rows"):
        b, s, H, K = 2, 130, 4, 64
        wide = (b, s, 2 * H, K) if how == "heads" else (b, s, H, K + 16)
        r, k, v, la, u = card(wide, f32, 0.0)
        cut = ((lambda t: t[:, :, ::2]) if how == "heads"
               else (lambda t: t[..., :K]))
        r, k, v, la = (cut(t) for t in (r, k, v, la))
        u = u[:H, :K].contiguous()
        check(not r.is_contiguous(), f"wkv6 {how} view is contiguous")
        got = wk.wkv6(r, k, v, la, u, chunk=64)
        want, _ = wkv6_chunked_ref(r, k, v, la, u, 64)
        errs.append(_within(f"wkv6-view-{how}-{b}x{s}x{H}x{K}-c64", got,
                            want, f32, norm=True, tol=WKV_TOL["float32"],
                            norm_tol=WKV_NORM_TOL, strides=str(r.stride())))
    # exact regime: the kernel also equals the sequential recurrence
    r, k, v, la, u = host((1, 256, 4, 64), f32, 2.0)
    got = ops.wkv6(r, k, v, la, u, chunk=64)
    exact = wkv6_ref(*(t.transpose(1, 2) for t in (r, k, v, la)),
                     u).transpose(1, 2)
    errs.append(_within("wkv6-exact-1x256x4x64", got, exact, f32, norm=True,
                        tol=WKV_TOL["float32"], norm_tol=WKV_NORM_TOL,
                        against="wkv6_ref (sequential)"))

    # timed at the path's shape: rwkv6-3b's prefill, f32 as time_mix makes
    b, s, H, K, chunk = LM_PREFILL[0], LM_PREFILL[1], 48, 64, 64
    r, k, v, la, u = card((b, s, H, K), f32, 0.0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = _events_ms(lambda: wk.wkv6(r, k, v, la, u, chunk=chunk), 20, flush)
    plain_ms = _events_ms(lambda: wkv6_chunked_ref(r, k, v, la, u, chunk),
                          3, flush)
    nbytes, flops = _wkv_bound(b, s, H, K, chunk)
    bound_ms, bound_by = _bound(nbytes, flops)
    # two launches on the same inputs agree bit for bit (a fixed order of
    # sums, no atomics)
    first = wk.wkv6(r, k, v, la, u, chunk=chunk)
    same = bool(torch.equal(first, wk.wkv6(r, k, v, la, u, chunk=chunk)))
    say("wkv6-repeat", shape=f"{b}x{s}x{H}x{K}-c{chunk}", bit_equal=same)
    check(same, "wkv6: two launches on the same inputs differ")
    say("wkv6-time", shape=f"b {b}, s {s}, {H} heads, K {K}, chunk {chunk}",
        bytes=nbytes, flops=flops, ms=f"{ms:.5f}", bound_ms=f"{bound_ms:.5f}",
        bound_by=bound_by, plain_ms=f"{plain_ms:.5f}", library_ms=None,
        library="no single PyTorch call computes WKV6",
        roofline_share=f"{bound_ms / ms:.4f}")
    say("wkv6", cases=len(errs), max_abs_err=f"{max(errs):.3e}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, max_abs_err=max(errs),
                cases=len(errs))


def _state_err(a, b):
    """Largest difference over the RWKV state (S, last, cm_last)."""
    return max(float((a["blocks"]["pos0"][key].cpu().float()
                      - b["blocks"]["pos0"][key].cpu().float()).abs().max())
               for key in ("S", "last", "cm_last"))


def phase_ssm_cpu_vs_gpu(steps=16, batch=2, prompt=128):
    """The same weights through the plain versions on the CPU and the
    kernels on the GPU, for the f32 and bf16 rwkv6-3b smoke twins: prefill
    over two chunks, greedy decode, and the state after it."""
    import dataclasses
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models import build
    from repro_torch.models.params import init_params
    from repro_torch.models.steps import init_cache, make_prefill_step
    rng = np.random.default_rng(SEED + 8)
    for dtype in ("float32", "bfloat16"):
        mdl = build(dataclasses.replace(smoke_config(SSM_ARCH), dtype=dtype,
                                        param_dtype=dtype))
        tol = LM_TOL[dtype]
        p_cpu = init_params(mdl.param_tree, SEED, "cpu")
        p_gpu = _to(p_cpu, "cuda")
        toks = rng.integers(0, mdl.cfg.vocab_size, (batch, prompt)).astype(
            np.int32)
        pre = make_prefill_step(mdl)
        l_cpu = pre(p_cpu, {"tokens": torch.tensor(toks)})
        l_gpu = pre(p_gpu, {"tokens": torch.tensor(toks, device="cuda")})
        pre_err = float((l_gpu.cpu().float() - l_cpu.float()).abs().max())
        check(pre_err <= tol, f"{dtype}: prefill logits differ by {pre_err}")
        c_cpu = init_cache(mdl, batch, 0, device="cpu")
        c_gpu = init_cache(mdl, batch, 0, device="cuda")
        t_cpu = torch.zeros((batch, 1), dtype=torch.int32)
        t_gpu = t_cpu.cuda()
        dec_err = 0.0
        for i in range(steps):
            lc, c_cpu = mdl.decode(p_cpu, c_cpu, t_cpu, i)
            lg, c_gpu = mdl.decode(p_gpu, c_gpu, t_gpu, i)
            dec_err = max(dec_err, float(
                (lg.cpu().float() - lc.float()).abs().max()))
            t_cpu = lc[:, -1].argmax(-1).to(torch.int32)[:, None]
            if dtype == "float32":      # each feeds itself: tokens equal
                t_gpu = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
                check(torch.equal(t_cpu, t_gpu.cpu()),
                      f"f32 decode step {i}: tokens differ")
            else:                       # teacher-forced: the CPU's tokens
                t_gpu = t_cpu.cuda()
        check(dec_err <= tol, f"{dtype}: decode logits differ by {dec_err}")
        state_err = _state_err(c_gpu, c_cpu)
        check(state_err <= tol, f"{dtype}: RWKV states differ by {state_err}")
        say("ssm-cpu-vs-gpu", model=mdl.cfg.name, dtype=dtype,
            layers=mdl.cfg.num_layers, batch=batch, prompt=prompt,
            decode_steps=steps, prefill_max_abs_err=f"{pre_err:.3e}",
            decode_logits_max_abs_err=f"{dec_err:.3e}",
            state_max_abs_err=f"{state_err:.3e}", tol=tol,
            tokens_equal=dtype == "float32" or "teacher-forced")


def phase_ssm_serving():
    """rwkv6-3b at full width and depth, bf16, random weights from seed 0
    drawn on the card: prefill, `serve_decode`, the launch counts, a
    teacher-forced check against prefill, and a profiled window. Returns
    the `wkv6` launches of the prefill calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.launch.serve import decode_loop, serve_decode
    from repro_torch.models import build
    from repro_torch.models.steps import (init_cache, init_serving_params,
                                          make_decode_step,
                                          make_prefill_step)
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(SSM_ARCH)
    mdl = build(cfg)
    L, vp = cfg.num_layers, cfg.padded_vocab()
    t = time.perf_counter()
    params = init_serving_params(mdl, SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(x.numel() for x in _leaves(params))
    weight_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    check(n_params == SSM_PARAMS, f"{n_params} parameters != {SSM_PARAMS}")
    rng = np.random.default_rng(SEED + 9)
    b, s = LM_PREFILL
    prompts = torch.tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                           dtype=torch.int32, device="cuda")
    prefill = make_prefill_step(mdl)

    # prefill: one warm call, then timed calls, each ending in a sync
    logits = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    calls = 5
    wk.wkv6.launches = 0
    call_s = []
    for _ in range(calls):
        t = time.perf_counter()
        logits = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t)
    prefill_s = float(np.median(call_s))
    wkv_launches = wk.wkv6.launches
    check(wkv_launches == L * calls,
          f"prefill launches: wkv6 {wkv_launches} != {L} x {calls}")
    check(logits.shape == (b, vp) and bool(torch.isfinite(logits).all()),
          "prefill logits not finite or misshapen")
    say("ssm-prefill", model=cfg.name, layers=L, d_model=cfg.d_model,
        heads=f"{cfg.rwkv_num_heads} padded to {cfg.head_pad_to}",
        params=n_params, weight_bytes=weight_bytes, init_s=f"{init_s:.2f}",
        prompts=b, tokens_per_prompt=s, calls=calls,
        ms_per_call=[f"{x * 1e3:.3f}" for x in call_s],
        median_ms=f"{prefill_s * 1e3:.3f}",
        tokens_per_s=f"{b * s / prefill_s:.1f}",
        wkv6_launches=wkv_launches, wkv6_per_call=wkv_launches // calls)

    # decode: the serving launcher's loop at batch 64 from a zero state
    bd, steps = SSM_DECODE
    wk.wkv6.launches = 0
    run = serve_decode(SSM_ARCH, steps, bd, steps, params=params)
    check(wk.wkv6.launches == 0,
          f"decode launched wkv6 {wk.wkv6.launches} times")
    toks = run.tokens
    check(toks.shape == (bd, steps) and bool(((toks >= 0) & (toks < vp))
                                             .all()),
          "decode tokens outside the padded vocab")
    state_bytes = sum(x.numel() * x.element_size() for x in _leaves(
        init_cache(mdl, 1, 0)["blocks"])) * bd
    say("ssm-decode", model=cfg.name, batch=bd, steps=steps,
        seconds=f"{run.seconds:.3f}",
        tokens_per_s=f"{steps * bd / run.seconds:.1f}",
        ms_per_step=f"{run.seconds / steps * 1e3:.4f}",
        device_ms_per_step=f"{sum(run.step_ms) / steps:.4f}",
        step_ms_median=f"{np.median(run.step_ms):.4f}",
        step_ms_p99=f"{np.percentile(run.step_ms, 99):.4f}",
        state_bytes=state_bytes,
        weight_read_bound_ms=f"{weight_bytes / H100_BYTES_PER_S * 1e3:.4f}",
        wkv6_launches=0, distinct_tokens=int(toks.unique().numel()))
    del run

    # teacher forcing: decode over a 32-token prompt == prefill on it
    tf = SSM_TEACHER
    prompt = prompts[:, :tf]
    want = prefill(params, {"tokens": prompt})
    cache = init_cache(mdl, b, 0)
    for i in range(tf):
        got, cache = mdl.decode(params, cache, prompt[:, i:i + 1], i)
    tf_err = _within(f"teacher-forced-{tf}", got[:, -1], want,
                     torch.bfloat16, prompts=b)
    agree = float((got[:, -1].argmax(-1) == want.argmax(-1)).float().mean())
    del cache

    # profiled window: 32 decode steps, then one prefill
    window = 32
    cache = init_cache(mdl, bd, 0)
    dec = make_decode_step(mdl)
    tok = toks[:, -1:].contiguous()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        decode_loop(dec, params, cache, tok, steps, window)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    say("ssm-profile", step="decode", steps=window,
        **_device_time(prof, wall_s, {"wkv6_kernel": "wkv6_kernel"}))
    del cache
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    say("ssm-profile", step="prefill", prompts=b, tokens_per_prompt=s,
        **_device_time(prof, wall_s, {"wkv6_kernel": "wkv6_kernel"}))
    say("ssm-serving", teacher_forced_tokens=tf,
        teacher_forced_max_abs_err=f"{tf_err:.3e}",
        teacher_forced_argmax_agree=f"{agree:.4f}",
        peak_memory_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    return wkv_launches


# ---------------------------------------------------------------------------
# the paper's host engines: HazyEngine / NaiveEngine, MultiViewEngine,
# the views and facades, serve --mode view
# ---------------------------------------------------------------------------

HOST_POLICIES = {"eager": {}, "lazy": {}, "hybrid": dict(buffer_frac=0.01)}


class no_plain_versions:
    """Inside the block the single-view kernels' public wrappers cannot
    fall back to their plain versions: a call of one raises."""

    def __enter__(self):
        from repro_torch.kernels.band_reclassify import ops as band_ops
        from repro_torch.kernels.eps_affine import ops as eps_ops

        def refuse(*_a, **_k):
            raise SmokeFailure("a plain version ran on the GPU path")

        self.saved = [(band_ops, "band_reclassify_rows_ref"),
                      (eps_ops, "eps_affine_ref")]
        self.saved = [(m, n, getattr(m, n)) for m, n in self.saved]
        for m, n, _ in self.saved:
            setattr(m, n, refuse)
        return self

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)
        return False


def _sv_counters(zero=False):
    """The single-view kernels' launch counts (set to 0 first if `zero`)."""
    from repro_torch.kernels.band_reclassify import kernel as band
    from repro_torch.kernels.eps_affine import kernel as eps
    if zero:
        band.band_reclassify.launches = 0
        eps.eps_affine.launches = 0
    return {"eps_affine": eps.eps_affine.launches,
            "band_reclassify": band.band_reclassify.launches}


def host_entity_labels(eng):
    """A HazyEngine's labels in entity order, as a tensor on its device."""
    return eng.labels_sorted[eng.inv_perm]


def host_golden(eng, F_dev, name):
    """The golden invariant of a HazyEngine or NaiveEngine: its labels in
    entity order == sign(F·w − b) under the current model (tie rule), its
    count == their positives, and `check_consistent()` where the engine
    has one (it compares the maintained labels with `eps_affine`'s of
    the same rows: a difference there must also be a proven tie). Returns
    (ties, check_consistent)."""
    import torch
    from repro_torch.core.engine import classify
    dev = F_dev.device
    w = torch.tensor(eng.model.w, device=dev)
    b = torch.tensor(np.float32(eng.model.b), device=dev)
    labels = (host_entity_labels(eng) if hasattr(eng, "inv_perm")
              else eng.labels)
    want = classify(torch.mv(F_dev, w) - b)
    ties, bad = label_mismatches(labels[None], want[None], F_dev,
                                 *_one(w, b))
    check(bad == 0, f"{name}: golden invariant: {bad} labels wrong")
    members = eng.all_members()
    check(members == int((labels == 1).sum()),
          f"{name}: all_members != positive labels")
    check(0 < members < F_dev.shape[0], f"{name}: degenerate view")
    consistent = True
    if hasattr(eng, "check_consistent"):
        consistent = eng.check_consistent()
        if not consistent:
            from repro_torch.kernels.eps_affine.ops import eps_affine
            _, truth, _ = eps_affine(eng.F_sorted, eng._w, eng._b)
            _, bad = label_mismatches(
                eng.labels_sorted[None], truth[None], eng.F_sorted,
                *_one(w, b))
            check(bad == 0, f"{name}: check_consistent: {bad} labels "
                  f"differ from eps_affine's (not ties)")
    return ties, consistent


def run_host_single(device, F, models, policy, opts, naive=False):
    """A HazyEngine (or NaiveEngine) over the models on `device`, modeled
    costs; its end state as host values."""
    from repro_torch.core.hazy import HazyEngine, NaiveEngine
    if naive:
        eng = NaiveEngine(F, device=device)
    else:
        eng = HazyEngine(F, p=2.0, q=2.0, policy=policy, cost_mode="modeled",
                         device=device, **opts)
    for m in models:
        eng.apply_model(m)
    members = eng.all_members()
    labels = (host_entity_labels(eng) if not naive else eng.labels)
    out = dict(eng=eng, members=members, labels=labels.cpu().numpy())
    if not naive:
        out.update(reorgs=eng.skiing.reorgs, a=eng.skiing.a,
                   lw=eng.waters.lw, hw=eng.waters.hw,
                   tuples=eng.stats.tuples_reclassified,
                   probes=[eng.hybrid_label(i) for i in range(0, eng.n, 61)]
                   if policy == "hybrid" else None)
    return out


def phase_host_cpu_vs_gpu(updates=400, commits=40, group=16):
    """The host shells on the CPU (plain versions) and on the GPU
    (kernels) over one stream: HazyEngine under eager, lazy and hybrid
    and NaiveEngine on forest_like(0.01) with 400 updates of
    example_stream(seed=3), then the vectorized MulticlassView on
    cora_like; modeled costs, so labels, counts, reorg schedules, waters
    and probe answers must be equal, and `check_consistent()` true on the
    card. Returns the kernels' launches in the GPU runs."""
    import torch
    from repro_torch.core.multiclass import MulticlassView
    from repro_torch.data import (cora_like, forest_like,
                                  multiclass_example_stream)
    c = forest_like(scale=0.01)
    F = np.ascontiguousarray(c.features)
    models = _sgd_models(c, updates)
    Ft = torch.tensor(F)
    m = models[-1]
    w, b = torch.tensor(m.w), torch.tensor(np.float32(m.b))
    launches = _sv_counters(zero=True)
    cases = [(p, o, False) for p, o in HOST_POLICIES.items()]
    cases.append(("eager", {}, True))
    threads = torch.get_num_threads()
    for policy, opts, naive in cases:
        name = "naive" if naive else policy
        torch.set_num_threads(1)      # tiny CPU products: threads only cost
        try:
            cpu = run_host_single("cpu", F, models, policy, opts, naive)
        finally:
            torch.set_num_threads(threads)
        with no_plain_versions():
            gpu = run_host_single("cuda", F, models, policy, opts, naive)
            consistent = (gpu["eng"].check_consistent() if not naive
                          else True)
        ties, bad = label_mismatches(torch.tensor(gpu["labels"])[None],
                                     torch.tensor(cpu["labels"])[None], Ft,
                                     *_one(w, b))
        check(bad == 0, f"host {name}: {bad} entity labels differ")
        check(abs(cpu["members"] - gpu["members"]) <= ties,
              f"host {name}: members {cpu['members']} != {gpu['members']}")
        for key in ("reorgs", "a", "lw", "hw", "tuples", "probes"):
            check(cpu.get(key) == gpu.get(key),
                  f"host {name}: {key} {cpu.get(key)} != {gpu.get(key)}")
        check(consistent, f"host {name}: check_consistent() false on the "
              f"card")
        say("host-cpu-vs-gpu", engine="NaiveEngine" if naive else
            "HazyEngine", policy=name, corpus="forest_like(0.01)",
            n=F.shape[0], d=F.shape[1], updates=updates,
            members=gpu["members"], reorgs=gpu.get("reorgs", "n/a"),
            tuples_reclassified=gpu.get("tuples", "n/a"), label_ties=ties,
            check_consistent=consistent, equal=True)
    launches = _sv_counters()
    check(launches["eps_affine"] > 0 and launches["band_reclassify"] > 0,
          f"host shells launched no kernel: {launches}")

    cora = cora_like()
    runs = {}
    for device in ("cpu", "cuda"):
        torch.set_num_threads(1 if device == "cpu" else threads)
        try:
            mc = MulticlassView(cora.features, cora.num_classes, p=2.0, q=2.0,
                                lr=0.1, cost_mode="modeled", device=device)
            stream = multiclass_example_stream(cora, seed=SEED)
            for _ in range(commits):
                mc.insert_examples(*zip(*(next(stream)
                                          for _ in range(group))))
            eng = mc.engine
            runs[device] = dict(
                mc=mc, counts=mc.class_counts(),
                reorgs=eng.reorg_counts.tolist(),
                labels=torch.gather(eng.labels_sorted, 1,
                                    eng.inv_perm).cpu(),
                lw=eng.lw.tolist(), hw=eng.hw.tolist(),
                tuples=eng.stats.tuples_reclassified,
                consistent=mc.check_consistent())
        finally:
            torch.set_num_threads(threads)
    cpu, gpu = runs["cpu"], runs["cuda"]
    Fc = torch.tensor(cora.features, dtype=torch.float64)
    W = torch.tensor(cpu["mc"].W, dtype=torch.float64)
    bb = torch.tensor(cpu["mc"].b, dtype=torch.float64)
    check(np.array_equal(cpu["mc"].W, gpu["mc"].W), "cora: models differ")
    ties, bad = label_mismatches(gpu["labels"], cpu["labels"], Fc, W, bb)
    check(bad == 0, f"cora (host): {bad} entity labels differ (not ties)")
    check(sum(abs(x - y) for x, y in zip(cpu["counts"], gpu["counts"]))
          <= ties, f"cora (host): counts {cpu['counts']} != {gpu['counts']}")
    for key in ("reorgs", "lw", "hw", "tuples"):
        check(cpu[key] == gpu[key], f"cora (host): {key} differ")
    check(gpu["consistent"] and cpu["consistent"],
          "cora (host): check_consistent() false")
    say("host-cpu-vs-gpu", engine="MulticlassView(vectorized)",
        corpus="cora_like", n=cora.features.shape[0], k=cora.num_classes,
        commits=commits, group=group, counts=gpu["counts"],
        reorgs=gpu["reorgs"], label_ties=ties, check_consistent=True,
        equal=True)
    return launches


def _host_run(name, make, models, F_dev, window):
    """One host engine at full size: the models through `apply_model`,
    timed on the host clock ending in a sync, counted, held to the golden
    invariant; then `window` more under the profiler. Returns its
    summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t = time.perf_counter()
    eng = make()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    updates = len(models) - window
    _sv_counters(zero=True)
    with no_plain_versions():
        t = time.perf_counter()
        for m in models[:updates]:
            eng.apply_model(m)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
    launches = _sv_counters()
    ties, consistent = host_golden(eng, F_dev, name)
    rec = dict(run=name, updates=updates, setup_s=f"{setup_s:.2f}",
               updates_per_s=f"{updates / run_s:.1f}",
               ms_per_update=f"{run_s / updates * 1e3:.4f}",
               launches=launches, golden_ties=ties,
               check_consistent=consistent)
    if hasattr(eng, "skiing"):
        st = eng.stats
        banded = st.rounds - st.reorgs
        rec.update(reorgs=st.reorgs, banded_rounds=banded,
                   mean_band_fraction=(
                       f"{st.tuples_reclassified / banded / eng.n:.6f}"
                       if banded else "n/a"),
                   S=f"{eng.skiing.S:.6g}")
        check(launches["eps_affine"] == st.reorgs,
              f"{name}: eps_affine launches {launches['eps_affine']} != "
              f"reorgs {st.reorgs}")
        check(0 < launches["band_reclassify"] <= banded,
              f"{name}: band_reclassify launches "
              f"{launches['band_reclassify']} not in (0, {banded}]")
    else:
        check(launches["eps_affine"] == updates,
              f"{name}: eps_affine launches {launches['eps_affine']} != "
              f"{updates}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for m in models[updates:]:
            eng.apply_model(m)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    host_golden(eng, F_dev, name)
    prof_rec = _device_time(prof, wall_s, {
        "band_kernel": "band_reclassify_kernel",
        "eps_kernel": "eps_affine_kernel"})
    say("host-single-view", **rec)
    say("host-single-view-profile", run=name, updates=window, **prof_rec)
    return rec


def phase_host_single_view_path(updates=SV_UPDATES, window=SV_WINDOW):
    """DBLife (124,000 x 1024, full size) through the paper's host shell:
    `HazyEngine(p=2, q=2)` eager in measured mode (the paper's choice) and
    in modeled mode, and `NaiveEngine` eager, each over the 4,000 models
    of phase 8's stream, then a profiled window of 500 more. Returns the
    kernels' launches per run."""
    import torch
    from repro_torch.core.hazy import HazyEngine, NaiveEngine
    from repro_torch.data import dblife_like
    c = dblife_like()
    F = np.ascontiguousarray(c.features)
    F_dev = torch.tensor(F, device="cuda")
    models = _sgd_models(c, updates + window)
    runs = {
        "hazy_measured": lambda: HazyEngine(F, p=2.0, q=2.0),
        "hazy_modeled": lambda: HazyEngine(F, p=2.0, q=2.0,
                                           cost_mode="modeled"),
        "naive": lambda: NaiveEngine(F)}
    out = {}
    for name, make in runs.items():
        out[name] = _host_run(name, make, models, F_dev, window)["launches"]
        torch.cuda.empty_cache()
    return out


def phase_host_multiview_path(requests=REQUESTS, seed=SEED):
    """Forest (582,000 x 54, k = 7, full size) through
    `MultiViewFacade(MulticlassView)` under phase 5's traffic (55% point
    reads, 5% counts, 40% inserts in group commits of 32), the golden
    invariant at the end and a profiled window."""
    import torch
    from repro_torch.core.engine import classify
    from repro_torch.core.facade import MultiViewFacade
    from repro_torch.core.multiclass import MulticlassView
    from repro_torch.data import multiclass_corpus
    t0 = time.perf_counter()
    c = multiclass_corpus("FC", FOREST["n"], FOREST["d"], FOREST["k"],
                          seed=seed)
    fac = MultiViewFacade(MulticlassView(c.features, FOREST["k"], p=2.0,
                                         q=2.0, lr=0.1, l2=1e-4))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    eng = fac.engine
    rng = np.random.default_rng(seed + 1)
    kinds = rng.choice(list(MIX), size=requests, p=list(MIX.values()))
    st = serve(fac, c.classes, kinds, rng, top_every=requests // 4)
    F = torch.tensor(c.features, device="cuda")
    W = torch.tensor(fac.mc.W, device="cuda")
    b32 = torch.tensor(fac.mc.b.astype(np.float32), device="cuda")
    labels = torch.gather(eng.labels_sorted, 1, eng.inv_perm)
    want = classify(W @ F.T - b32[:, None])
    ties, bad = label_mismatches(labels, want, F, W, b32)
    check(bad == 0, f"host forest: golden invariant: {bad} labels wrong")
    counts = fac.counts()
    check(np.array_equal(counts, (labels == 1).sum(1).cpu().numpy()),
          "host forest: counts() != positive labels")
    check(counts.min() > 0 and counts.max() < fac.n,
          "host forest: degenerate views")
    consistent = fac.mc.check_consistent()
    check(consistent or ties > 0,
          "host forest: check_consistent() false without a tie")
    served = st["served"]
    say("host-multiview-path", corpus="forest", n=fac.n, d=fac.d,
        k=fac.num_views, policy=fac.policy, cost_mode=eng.cost_mode,
        requests=requests, served=served, setup_s=f"{setup_s:.2f}",
        rounds=st["rounds"], reorgs=int(eng.reorg_counts.sum()),
        reorg_counts=eng.reorg_counts.tolist(),
        ms_per_round=f"{st['insert_s'] / st['rounds'] * 1e3:.3f}",
        inserts_per_s=f"{served['insert'] / st['insert_s']:.1f}",
        point_reads_per_s=f"{served['read'] / st['read_s']:.1f}",
        count_reads_per_s=f"{served['count'] / st['count_s']:.1f}",
        top_margins=st["tops"], counts=counts.tolist(), golden_ties=ties,
        check_consistent=consistent, golden_ok=True)
    from torch.profiler import ProfilerActivity, profile
    window = rng.choice(list(MIX), size=2000, p=list(MIX.values()))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        wst = serve(fac, c.classes, window, rng)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    say("host-multiview-profile", requests=len(window), rounds=wst["rounds"],
        **_device_time(prof, wall_s, {}))
    del fac, eng, F, W, labels, want
    torch.cuda.empty_cache()


def phase_serve_view_path(requests=3000):
    """`serve --mode view` through the entry point at the reference's
    defaults (4,000 documents of 32 tokens, `requests` requests, hybrid),
    then its end state held to plain versions: the encoder's features
    against the same documents encoded on the CPU with the same weights
    (plain attention), and the view's labels in entity order against
    sign(F·w − b) from `torch.mv` (tie rule). Returns the launches on the
    path."""
    import contextlib
    import io
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import view_driver
    from repro_torch.models import build
    from repro_torch.models.steps import init_serving_params
    fk.flash_attention.launches = 0
    _sv_counters(zero=True)
    buf = io.StringIO()
    with no_plain_versions(), contextlib.redirect_stdout(buf):
        t = time.perf_counter()
        view = serve_mod.main(["--mode", "view", "--requests",
                               str(requests)])
        torch.cuda.synchronize()
        view_s = time.perf_counter() - t
    text = buf.getvalue()
    for line in text.splitlines():
        say("serve-view", out=line)
    launches = dict(_sv_counters(), flash_attention=fk.flash_attention.launches)
    check("view exact" in text and view.engine.device.type == "cuda",
          "serve --mode view did not end in 'view exact' on the card")
    check(min(launches.values()) > 0,
          f"serve --mode view launched no kernel: {launches}")
    check(view.F.shape == VIEW_TABLE, f"view table {view.F.shape}")

    # the encoder: serve_view's weights (seed 0, drawn on the card), here
    # on the CPU through the plain attention; the limit is the CPU parity
    # test's (tests/test_torch_view_driver.py)
    encode_cpu, cfg = view_driver.make_backbone_encoder(
        params=_to(init_serving_params(build(smoke_config(LM_ARCH)), 0,
                                       "cuda"), "cpu"), device="cpu")
    tokens, _ = view_driver.make_topic_docs(cfg, VIEW_TABLE[0], 32)
    enc_err = float(np.abs(encode_cpu(tokens) - view.F).max())
    check(enc_err <= VIEW_ENCODE_ATOL,
          f"serve --mode view: features off the CPU encoder's by {enc_err}")
    F_dev = torch.tensor(view.F, device="cuda")
    ties, consistent = host_golden(view.engine, F_dev, "serve-view")
    check(consistent, "serve --mode view: check_consistent() false")
    say("serve-view-path", requests=requests, docs=VIEW_TABLE[0],
        doc_len=32, seconds=f"{view_s:.2f}",
        reorgs=view.engine.skiing.reorgs, launches=launches,
        encoder_max_abs_err=f"{enc_err:.3e}", encoder_atol=VIEW_ENCODE_ATOL,
        golden_ties=ties, view_exact=True)
    return launches


# ---------------------------------------------------------------------------
# the storage tier (phase 18) and Layer 2 of core/engine.py (phase 19)
# ---------------------------------------------------------------------------

STORAGE_READS = 5_000          # seeded point reads per budgeted run (cut
                               # from 20,000 to keep the script's time)
STORAGE_RUNS = ((0.05, False), (0.10, False), (0.10, True))   # budget, prefetcher
STORAGE_COUNT_EVERY = 500      # DBLife: an All-Members read every 500 updates
STORAGE_ROUNDS = 250           # Forest: group commits of 32 (phase 17's count)
STORAGE_WINDOW = (100, 1_000)  # profiled: updates, reads
L2_ROUNDS = 24                 # tests/test_engine_core.py's longest case
CARD = "cuda"                  # phases 18-19's device


def _store(F, name):
    """F written as an `EntityStore` file under build/storage/ (the
    checkout's local disk; the caller removes it)."""
    from repro_torch.storage import EntityStore
    path = ROOT / "build" / "storage" / f"{name}.f32"
    path.parent.mkdir(parents=True, exist_ok=True)
    return EntityStore.from_array(F, path=str(path))


def _drop_store(store):
    path = Path(store.path)
    store.close()
    path.unlink(missing_ok=True)


def _timed_rewarms(eng):
    """Wrap the engine's `_rewarm_store` to record each call's host time
    (it ends in the copy of the new order to the host, so it includes the
    device work queued before it); returns the list it appends to."""
    log, inner = [], eng._rewarm_store

    def timed():
        t = time.perf_counter()
        inner()
        log.append(time.perf_counter() - t)

    eng._rewarm_store = timed
    return log


def _reconcile(name, eng, pool, p0, tiers, calls, prefetch):
    """The per-tier counts against the pool's: every buffer, pool or disk
    answer is one pool call (`calls` of them), and with no prefetcher a
    cold read is exactly one miss. A prefetcher's worker may hold a page
    in flight: a probe that waits on it is `coalesced` and a disk touch."""
    st = pool.stats()
    check(st["hits"] + st["misses"] + st["coalesced"] == st["probes"],
          f"{name}: hits + misses + coalesced != probes: {st}")
    d = {key: st[key] - p0[key] for key in ("probes", "hits", "misses")}
    check(d["probes"] == calls, f"{name}: pool probes {d['probes']} != "
          f"{calls} calls from the tiers {tiers}")
    if prefetch:
        check(st["misses"] <= eng.disk_touches
              <= st["misses"] + st["coalesced"],
              f"{name}: disk_touches {eng.disk_touches} outside "
              f"[misses, misses + coalesced] of {st}")
    else:
        check(st["coalesced"] == 0 and eng.disk_touches == st["misses"],
              f"{name}: disk_touches {eng.disk_touches} != misses {st}")
        check(d["misses"] == tiers["disk"]
              and d["hits"] == calls - tiers["disk"],
              f"{name}: pool hits/misses {d} do not match the tiers "
              f"{tiers}")
    return st


def _storage_single(F, F_dev, models, twin, frac, prefetch, reads, seed):
    """DBLife through `HazyEngine(policy="hybrid", cost_mode="modeled",
    buffer_frac=0.05)` over a `BufferPool` of `frac` of the table's bytes
    (with a `Prefetcher` if asked): the models with an All-Members read
    every STORAGE_COUNT_EVERY, then `reads` seeded point reads, each held
    to the all-in-RAM eager `twin` under the tie rule; counters
    reconciled, then a profiled window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.hazy import HazyEngine
    from repro_torch.storage import BufferPool, Prefetcher
    name = f"dblife-{frac:.2f}{'-prefetch' if prefetch else ''}"
    t_run = time.perf_counter()
    store = _store(F, "dblife")
    pool = BufferPool(store, int(frac * store.nbytes))
    pre = Prefetcher(pool) if prefetch else None
    try:
        _sv_counters(zero=True)
        with no_plain_versions():
            t = time.perf_counter()
            eng = HazyEngine(F, p=2.0, q=2.0, policy="hybrid",
                             cost_mode="modeled", buffer_frac=0.05,
                             store=pool, device=CARD)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t
            rewarms = _timed_rewarms(eng)
            updates = len(models) - STORAGE_WINDOW[0]
            t = time.perf_counter()
            for j, m in enumerate(models[:updates]):
                eng.apply_model(m)
                if j % STORAGE_COUNT_EVERY == STORAGE_COUNT_EVERY - 1:
                    eng.all_members()
            torch.cuda.synchronize()
            update_s = time.perf_counter() - t
            if pre is not None:
                check(pre.drain(120), f"{name}: prefetcher never idle")
            rng = np.random.default_rng(seed)
            ids = rng.integers(0, eng.n, reads)
            p0 = pool.stats()
            got = np.empty(reads, np.int8)
            tiers = {"water": 0, "buffer": 0, "pool": 0, "disk": 0}
            t = time.perf_counter()
            for j, i in enumerate(ids.tolist()):
                got[j], how = eng.hybrid_label(i)
                tiers[how] += 1
            read_s = time.perf_counter() - t
            members = eng.all_members()         # catch-up: band_reclassify
        launches = _sv_counters()
        reorgs, rewarms = eng.stats.reorgs, list(rewarms)
        check(launches["eps_affine"] == reorgs + 1,
              f"{name}: eps_affine launches {launches['eps_affine']} != "
              f"reorgs {reorgs} + the initial organization")
        if pre is not None:
            check(pre.drain(120), f"{name}: prefetcher never idle")
        calls = tiers["buffer"] + tiers["pool"] + tiers["disk"]
        st = _reconcile(name, eng, pool, p0, tiers, calls, prefetch)
        m = models[updates - 1]
        w = torch.tensor(m.w, device=CARD)
        b = torch.tensor(np.float32(m.b), device=CARD)
        ids_t = torch.tensor(ids, device=CARD)
        want = twin[ids_t]
        ties, bad = label_mismatches(torch.tensor(got, device=CARD)[None],
                                     want[None], F_dev[ids_t], *_one(w, b))
        check(bad == 0, f"{name}: {bad} point reads differ from the eager "
              f"twin (not ties)")
        labels = host_entity_labels(eng)
        all_ties, bad = label_mismatches(labels[None], twin[None], F_dev,
                                         *_one(w, b))
        check(bad == 0, f"{name}: {bad} labels differ from the eager twin")
        check(abs(members - int((twin == 1).sum())) <= all_ties,
              f"{name}: members {members} != the twin's")
        check(launches["eps_affine"] > 0 and launches["band_reclassify"] > 0,
              f"{name}: the path launched no kernel: {launches}")
        consistent = eng.check_consistent()
        check(consistent or all_ties > 0,
              f"{name}: check_consistent() false without a tie")
        resolved = (reads - tiers["disk"]) / reads
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for m in models[updates:]:
                eng.apply_model(m)
            for i in rng.integers(0, eng.n, STORAGE_WINDOW[1]).tolist():
                eng.hybrid_label(i)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t
        say("storage-path", run=name, n=eng.n, d=eng.d,
            table_bytes=store.nbytes, budget_bytes=pool.budget_bytes,
            run_s=f"{time.perf_counter() - t_run:.2f}",
            setup_s=f"{setup_s:.2f}", updates=updates,
            updates_per_s=f"{updates / update_s:.1f}", reads=reads,
            probes_per_s=f"{reads / read_s:.1f}",
            tier_shares={k: round(v / reads, 6) for k, v in tiers.items()},
            resolved_share=f"{resolved:.6f}",
            reference_bar_90=("met" if resolved >= 0.9 else "missed")
            if frac == 0.10 else "n/a",
            reorgs=reorgs, rewarms=len(rewarms),
            rewarm_ms_mean=f"{np.mean(rewarms) * 1e3:.3f}" if rewarms
            else "n/a", rewarm_s_total=f"{sum(rewarms):.3f}",
            disk_touches=eng.disk_touches, launches=launches,
            read_ties=ties, label_ties=all_ties,
            check_consistent=consistent)
        say("storage-pool", run=name, stats=json.dumps(st),
            prefetcher=json.dumps(pre.stats()) if pre else "none")
        say("storage-profile", run=name, updates=STORAGE_WINDOW[0],
            reads=STORAGE_WINDOW[1], **_device_time(prof, wall_s, {
                "band_kernel": "band_reclassify_kernel",
                "eps_kernel": "eps_affine_kernel"}))
        return launches
    finally:
        if pre is not None:
            pre.close(30)
            check(not pre.alive, f"{name}: prefetcher thread still alive")
        pool.close()
        _drop_store(store)


def _storage_multi(c, frac, reads, seed):
    """Forest (k = 7) through `MulticlassView(policy="hybrid",
    cost_mode="modeled")` over a `BufferPool` of `frac` of the table's
    bytes, beside its all-in-RAM eager twin on the same stream (group
    commits of 32, a count read every 25); then `reads` seeded
    `hybrid_labels_of` reads, each held to the twin (tie rule), the tier
    counts reconciled with the pool's; then a profiled window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import (TIER_BUFFER, TIER_DISK, TIER_POOL,
                                         TIER_WATER)
    from repro_torch.core.multiclass import MulticlassView
    from repro_torch.data import multiclass_example_stream
    from repro_torch.storage import BufferPool
    name = f"forest-{frac:.2f}"
    t_run = time.perf_counter()
    k = c.num_classes
    store = _store(c.features, "forest")
    pool = BufferPool(store, int(frac * store.nbytes))
    opts = dict(p=2.0, q=2.0, lr=0.1, l2=1e-4, cost_mode="modeled")
    try:
        twin = MulticlassView(c.features, k, policy="eager", device=CARD,
                              **opts)
        t = time.perf_counter()
        hyb = MulticlassView(c.features, k, policy="hybrid", store=pool,
                             device=CARD, **opts)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t
        eng = hyb.engine
        check(eng.buffer_F is None, f"{name}: hot rows materialized")
        rewarms = _timed_rewarms(eng)
        stream = multiclass_example_stream(c, seed=seed)
        batches = [list(zip(*(next(stream) for _ in range(GROUP_COMMIT))))
                   for _ in range(STORAGE_ROUNDS + STORAGE_WINDOW[0] // 10)]
        insert_s = 0.0
        for j, batch in enumerate(batches[:STORAGE_ROUNDS]):
            twin.insert_examples(*batch)
            t = time.perf_counter()
            hyb.insert_examples(*batch)
            if j % 25 == 24:
                hyb.class_counts()
            torch.cuda.synchronize()
            insert_s += time.perf_counter() - t
        check(np.array_equal(hyb.W, twin.W) and np.array_equal(hyb.b, twin.b),
              f"{name}: models differ from the twin's")
        want = torch.gather(twin.engine.labels_sorted, 1,
                            twin.engine.inv_perm)
        rng = np.random.default_rng(seed)
        ids = rng.integers(0, c.features.shape[0], reads)
        p0, h0 = pool.stats(), eng.hybrid_hits.copy()
        got = np.empty((k, reads), np.int8)
        hows = np.empty((k, reads), np.int8)
        t = time.perf_counter()
        for j, i in enumerate(ids.tolist()):
            got[:, j], hows[:, j] = eng.hybrid_labels_of(i)
        read_s = time.perf_counter() - t
        reorgs, rewarms = int(eng.reorg_counts.sum()), list(rewarms)
        dh = eng.hybrid_hits - h0
        tiers = {"water": int(dh[TIER_WATER]), "buffer": int(dh[TIER_BUFFER]),
                 "pool": int(dh[TIER_POOL]), "disk": int(dh[TIER_DISK])}
        check(dh.sum() == k * reads, f"{name}: tiers {tiers} do not add up")
        buffered = (hows == TIER_BUFFER).any(0)
        touched = ((hows == TIER_POOL) | (hows == TIER_DISK)).any(0)
        cold = (hows == TIER_DISK).any(0)
        calls = int(buffered.sum() + touched.sum())
        st = _reconcile(name, eng, pool, p0,
                        dict(tiers, disk=int(cold.sum())), calls, False)
        F = torch.tensor(c.features, device=CARD)
        W = torch.tensor(hyb.W, device=CARD)
        b32 = torch.tensor(hyb.b.astype(np.float32), device=CARD)
        ids_t = torch.tensor(ids, device=CARD)
        ties, bad = label_mismatches(torch.tensor(got, device=CARD),
                                     want[:, ids_t], F[ids_t], W, b32)
        check(bad == 0, f"{name}: {bad} point reads differ from the eager "
              f"twin (not ties)")
        counts = hyb.class_counts()
        labels = torch.gather(eng.labels_sorted, 1, eng.inv_perm)
        all_ties, bad = label_mismatches(labels, want, F, W, b32)
        check(bad == 0, f"{name}: {bad} labels differ from the eager twin")
        check(sum(abs(x - y) for x, y in zip(counts, twin.class_counts()))
              <= all_ties, f"{name}: counts differ from the twin's")
        consistent = hyb.check_consistent()
        check(consistent or all_ties > 0,
              f"{name}: check_consistent() false without a tie")
        resolved = (k * reads - tiers["disk"]) / (k * reads)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for batch in batches[STORAGE_ROUNDS:]:
                hyb.insert_examples(*batch)
            for i in rng.integers(0, c.features.shape[0],
                                  STORAGE_WINDOW[1]).tolist():
                eng.hybrid_labels_of(i)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t
        say("storage-path", run=name, n=eng.n, d=eng.d, k=k,
            table_bytes=store.nbytes, budget_bytes=pool.budget_bytes,
            run_s=f"{time.perf_counter() - t_run:.2f}",
            setup_s=f"{setup_s:.2f}", rounds=STORAGE_ROUNDS,
            inserts_per_s=f"{STORAGE_ROUNDS * GROUP_COMMIT / insert_s:.1f}",
            reads=reads, probes_per_s=f"{reads / read_s:.1f}",
            view_probes_per_s=f"{k * reads / read_s:.1f}",
            tier_shares={key: round(v / (k * reads), 6)
                         for key, v in tiers.items()},
            resolved_share=f"{resolved:.6f}",
            reference_bar_90=("met" if resolved >= 0.9 else "missed")
            if frac == 0.10 else "n/a",
            reorgs=reorgs, rewarms=len(rewarms),
            rewarm_ms_mean=f"{np.mean(rewarms) * 1e3:.3f}" if rewarms
            else "n/a", rewarm_s_total=f"{sum(rewarms):.3f}",
            disk_touches=eng.disk_touches, read_ties=ties,
            label_ties=all_ties, check_consistent=consistent)
        say("storage-pool", run=name, stats=json.dumps(st))
        say("storage-profile", run=name, rounds=len(batches) - STORAGE_ROUNDS,
            reads=STORAGE_WINDOW[1], **_device_time(prof, wall_s, {}))
        del twin, hyb, eng, F, want, labels
    finally:
        pool.close()
        _drop_store(store)
        torch.cuda.empty_cache()


def phase_storage_path(reads=STORAGE_READS, seed=SEED, scale=1.0):
    """Phase 18: the storage tier at full size. DBLife (124,000 x 1024,
    508 MB on the checkout's disk) through `HazyEngine` hybrid over a pool
    at 5% and 10% of the table's bytes and at 10% with a `Prefetcher`,
    fed phase 16's models, each held to an all-in-RAM eager twin on the
    card; then Forest (582,000 x 54, k = 7, 126 MB) through
    `MultiViewEngine` hybrid at 10%, read with `hybrid_labels_of`.
    Returns the single-view kernels' launches per DBLife run."""
    import torch
    from repro_torch.core.hazy import HazyEngine
    from repro_torch.data import dblife_like, multiclass_corpus
    c = dblife_like(scale)
    F = np.ascontiguousarray(c.features)
    F_dev = torch.tensor(F, device=CARD)
    models = _sgd_models(c, SV_UPDATES + STORAGE_WINDOW[0])
    t = time.perf_counter()
    twin = HazyEngine(F, p=2.0, q=2.0, cost_mode="modeled", device=CARD)
    for m in models[:SV_UPDATES]:
        twin.apply_model(m)
    ties, _ = host_golden(twin, F_dev, "storage twin")
    say("storage-twin", table="dblife", policy="eager", updates=SV_UPDATES,
        reorgs=twin.stats.reorgs, golden_ties=ties,
        seconds=f"{time.perf_counter() - t:.2f}")
    twin_labels = host_entity_labels(twin)
    del twin
    torch.cuda.empty_cache()
    out = {}
    for frac, prefetch in STORAGE_RUNS:
        key = f"storage_dblife_{int(frac * 100)}pct" + (
            "_prefetch" if prefetch else "")
        out[key] = _storage_single(F, F_dev, models, twin_labels, frac,
                                   prefetch, reads, seed + 18)
    del F_dev, twin_labels
    torch.cuda.empty_cache()
    forest = multiclass_corpus("FC", FOREST["n"], FOREST["d"], FOREST["k"],
                               seed=seed)
    _storage_multi(forest, 0.10, reads, seed + 18)
    return out


def phase_layer2(rounds=L2_ROUNDS, seed=SEED):
    """Phase 19: Layer 2 of core/engine.py on the card at Forest's full
    size (k = 7), `rounds` rounds of `_parity_trajectory`'s random drift
    under eager, lazy and hybrid (catch-up every 7th round, three probes
    every 5th), held to `MultiViewEngine` on the card in modeled mode on
    the same stream: entity-order labels (tie rule), counts, pending
    masks and reorg schedule exactly, waters bit for bit."""
    import torch
    import repro_torch.core.engine as E
    from repro_torch.core.multiview import MultiViewEngine
    from repro_torch.data import multiclass_corpus
    c = multiclass_corpus("FC", FOREST["n"], FOREST["d"], FOREST["k"],
                          seed=seed)
    F = np.ascontiguousarray(c.features)
    n, d, k = F.shape[0], F.shape[1], FOREST["k"]
    F_dev = torch.tensor(F, device=CARD)
    ones = np.ones(k, bool)
    for policy in ("eager", "lazy", "hybrid"):
        r = np.random.default_rng(seed + 19)
        bf = 0.06 if policy == "hybrid" else 0.0
        shell = MultiViewEngine(F, k, p=2.0, q=2.0, alpha=1.0, policy=policy,
                                cost_mode="modeled", buffer_frac=bf,
                                device=CARD)
        params = E.make_params(F, p=2.0, q=2.0, alpha=1.0, buffer_frac=bf)
        check(params.M == shell.M, f"layer2 {policy}: M differs")
        torch.cuda.synchronize()
        t = time.perf_counter()
        st = E.init_state(F, k, params, device=CARD)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        W = np.zeros((k, d), np.float32)
        b = np.zeros(k, np.float64)
        reorgs = np.zeros(k, np.int64)
        l2_s, probes, ties = 0.0, 0, 0

        def timed(step, *args, **kw):
            nonlocal l2_s
            t0 = time.perf_counter()
            out = step(*args, **kw)
            torch.cuda.synchronize()
            l2_s += time.perf_counter() - t0
            return out

        def entity_labels(labels, perm):
            return torch.empty_like(labels).scatter_(1, perm, labels)

        def hold(counts):
            got = entity_labels(st.labels, st.perm)
            want = entity_labels(shell.labels_sorted, shell.perm)
            Wd = torch.tensor(W, device=CARD)
            bd = torch.tensor(b, device=CARD)
            tie, bad = label_mismatches(got, want, F_dev, Wd, bd)
            check(bad == 0, f"layer2 {policy}: {bad} labels differ from the "
                  f"shell's (not ties)")
            check(np.abs(np.asarray(counts) - st.pos_count).sum() <= tie,
                  f"layer2 {policy}: counts {st.pos_count} != {counts}")
            return tie

        for j in range(rounds):
            W = (W + r.normal(size=(k, d)) * 0.05).astype(np.float32)
            b = b + r.normal(size=k) * 0.02
            shell.apply_models(W, b)
            st, info = timed(E.apply_model, st, W, b, params, policy=policy)
            reorgs += info["reorged"]
            check(np.array_equal(st.lw, shell.lw)
                  and np.array_equal(st.hw, shell.hw),
                  f"layer2 {policy}: waters differ at round {j}")
            if j % 7 == 3:
                counts = shell.all_members()
                st, info = timed(E.catch_up, st, ones, params)
                reorgs += info["reorged"]
                ties = max(ties, hold(counts))
            if policy == "hybrid" and j % 5 == 2:
                for e in r.integers(0, n, 3).tolist():
                    labs, hows = shell.hybrid_labels_of(e)
                    st, lab, tier = timed(E.hybrid_probe, st, e, params)
                    probes += 1
                    check(np.array_equal(tier, hows),
                          f"layer2 {policy}: probe tiers {tier} != {hows}")
                    if not np.array_equal(lab, labs):
                        f = F_dev[e][None]
                        _, bad = label_mismatches(
                            torch.tensor(lab, device=CARD)[:, None],
                            torch.tensor(labs, device=CARD)[:, None], f,
                            torch.tensor(W, device=CARD),
                            torch.tensor(b, device=CARD))
                        check(bad == 0, f"layer2 {policy}: probe labels "
                              f"{lab} != {labs}")
        counts = shell.all_members()
        st, info = timed(E.catch_up, st, ones, params)
        reorgs += info["reorged"]
        ties = max(ties, hold(counts))
        check(np.array_equal(st.pending, shell.pending),
              f"layer2 {policy}: pending masks differ")
        check(np.array_equal(st.lw, shell.lw) and np.array_equal(st.hw,
                                                                 shell.hw),
              f"layer2 {policy}: waters differ")
        check(np.array_equal(reorgs, shell.reorg_counts),
              f"layer2 {policy}: reorgs {reorgs} != {shell.reorg_counts}")
        check(shell.check_consistent(), f"layer2 {policy}: shell "
              f"inconsistent")
        say("layer2", policy=policy, n=n, d=d, k=k, rounds=rounds,
            init_ms=f"{init_s * 1e3:.3f}",
            ms_per_round=f"{l2_s / rounds * 1e3:.3f}",
            reorgs=reorgs.tolist(), probes=probes, label_ties=ties,
            counts=st.pos_count.tolist(), waters_bitwise=True, equal=True)
        del st, shell
        torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    # fail before printing anything where the port's sources are missing
    import repro_torch.kernels.band_reclassify.kernel  # noqa: F401
    import repro_torch.kernels.eps_affine.kernel  # noqa: F401
    import repro_torch.kernels.wkv6.kernel  # noqa: F401
    import repro_torch.launch.serve  # noqa: F401
    phase_environment()
    phase_build()
    timing, ties, bad, err = phase_kernels()
    phase_cpu_vs_gpu()
    launches, geometry_c = phase_main_path()
    single = phase_single_view_kernels()
    phase_cpu_vs_gpu_single_view()
    sv_launches = phase_single_view_path()
    lm = phase_lm_kernels()
    phase_lm_cpu_vs_gpu()
    lm_launches = phase_lm_serving()
    wkv = phase_wkv6_kernel()
    phase_ssm_cpu_vs_gpu()
    wkv_launches = phase_ssm_serving()
    host_launches = {"cpu_vs_gpu": phase_host_cpu_vs_gpu()}
    host_launches.update(phase_host_single_view_path())
    phase_host_multiview_path()
    view_launches = phase_serve_view_path()
    host_launches["serve_view"] = {k: view_launches[k]
                                   for k in ("eps_affine", "band_reclassify")}
    host_launches.update(phase_storage_path())
    phase_layer2()
    a = timing["forest"]
    recs = [{"name": "multiview_band_reclassify", "route": "cuda",
             "source": "src/repro_torch/csrc/band_reclassify.cu",
             "replaces": "src/repro/kernels/band_reclassify/kernel.py:50",
             "launches": launches, "max_abs_err": err,
             "ms": a["ms"], "plain_ms": a["plain_ms"],
             "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
             "library_ms": a["library_ms"], "mismatches": bad,
             "ties": ties, "bound_windows_ms": a["bound_windows_ms"],
             "geometries": {
                 geo: {key: rec[key] for key in (
                     "ms", "ms_clean", "bound_ms", "bound_windows_ms",
                     "library_ms", "superset_ms", "union_rows",
                     "window_rows")}
                 for geo, rec in (("A", a), ("B", timing["forest-B"]),
                                  ("C", geometry_c))}}]
    for name, source, replaces in [
            ("band_reclassify", "src/repro_torch/csrc/band_reclassify.cu",
             "src/repro/kernels/band_reclassify/kernel.py:97"),
            ("eps_affine", "src/repro_torch/csrc/eps_affine.cu",
             "src/repro/kernels/eps_affine/kernel.py:31")]:
        r = single[name]
        recs.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": sv_launches[name],
                     "launches_host_paths": {
                         path: counts[name]
                         for path, counts in host_launches.items()},
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"],
                     "mismatches": r["mismatches"], "ties": r["ties"]})
    for name, source, replaces in [
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:59"),
            ("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention/kernel.py:55")]:
        r = lm[name]
        extra = ({"launches_serve_view": view_launches["flash_attention"]}
                 if name == "flash_attention" else {})
        recs.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": lm_launches[name],
                     **extra,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "cases": r["cases"]})
    recs.append({"name": "wkv6", "route": "cuda",
                 "source": "src/repro_torch/csrc/wkv6.cu",
                 "replaces": "src/repro/kernels/wkv6/kernel.py:65",
                 "launches": wkv_launches, "max_abs_err": wkv["max_abs_err"],
                 "ms": wkv["ms"], "plain_ms": wkv["plain_ms"],
                 "bound_ms": wkv["bound_ms"], "bound_by": wkv["bound_by"],
                 "library_ms": None,
                 "library_ms_why": "no single PyTorch call computes WKV6",
                 "cases": wkv["cases"]})
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
