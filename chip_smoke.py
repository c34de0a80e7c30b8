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
     2,048 tokens, then `serve_decode` at batch 64 for 256 steps over
     the first eighth of a 2,048-position cache, with the launch counts (22 per prefill call and
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
     of 8 prompts of 2,048 tokens, `serve_decode` at batch 64 for 128
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
     10% of the table's bytes and of 10% with a `Prefetcher`, fed the first
     2,000 of phase 16's models with a count read every 500, then 2,500
     seeded point
     reads; Forest (582,000 x 54, k = 7, 126 MB) through `MulticlassView`
     (hybrid, modeled) over a 10% pool, 250 group commits of 32, then
     2,500 `hybrid_labels_of` reads. Each run is held to an all-in-RAM
     eager twin on the card (tie rule), its tier counts reconciled with
     the pool's (`disk_touches` == misses without a prefetcher); printed:
     probes/s, tier shares, the pool's `stats()`, reorgs and rewarm time,
     the single-view kernels' launches and a profiled window's busy share;
 19. Layer 2 of core/engine.py on the card at Forest's size (k = 7), 24
     rounds of random drift under eager, lazy and hybrid (a catch-up every
     7th round, three probes every 5th), held to `MultiViewEngine` on the
     card in modeled mode: entity-order labels (tie rule), counts, pending
     masks and reorg schedules exactly, waters bit for bit; ms a round;
 20. the SQL front end (`repro_torch.rdbms`) on the CPU (plain versions)
     and on the GPU over one seeded script of 600 statements: cora_like
     (k = 7, `engine = multiview` hybrid and `engine = sharded`) and
     forest_like(0.01) (hazy eager, lazy and hybrid, a memory_budget =
     0.25 view, a derived view, a target_lag view ticked on a modeled
     clock every 40 statements, a second table for DELETE), with UPDATE
     MODEL, prepared statements, EXPLAIN ANALYZE and SHOW SCHEDULE: every
     `Result` equal (tie rule for labels, margins within the fp32 bound
     of the dot), the same refresh schedule, the WAL files byte for byte
     equal, every view's end state equal and its golden invariant held on
     both;
 21. the SQL front end at full size on the card: Forest (582,000 x 54,
     k = 7) created with SQL as `engine = sharded` and served 10,000
     statements of phase 5's mix through `Executor(group_commit=32)`
     (golden invariant; `multiview_band_reclassify` launches == update
     rounds; a profiled window of 2,000 more); DBLife (124,000 x 1024)
     as a hybrid view over a 10% memory budget: 2,000 INSERTs (a count
     every 500), then 2,500 point SELECTs (`eps_affine` == reorgs + 1,
     tiers reconciled with the pool, golden invariant); a swarm of 64
     wire sessions x 50 operations (95% prepared point reads) on Forest
     with a hybrid `topics` view over a 25% pool and a lagged sharded
     `audit` view refreshed by the freshness daemon, the WAL then
     replayed serially into a fresh catalog on the card (every view
     equal); then `serve --mode sql --execute` and `view_driver --sql`
     (3,000 requests, "view exact"). Printed: statements/s by kind, ms
     per commit, the swarm's p50/p99 by kind and QPS, the share of
     statement time in each executor span, launches, and a busy share;
 22. the moe and hybrid families on the CPU (plain versions) and on the
     GPU (kernels) with the same weights: the smoke twins of
     llama4-scout-17b-a16e (top-1, a shared expert), dbrx-132b (top-2)
     and jamba-v0.1-52b (attention, mamba, dense and MoE FFNs) in f32 and
     bf16: prefill logits, 16 greedy decode steps (f32 tokens equal, bf16
     teacher-forced), the cache after them (k/v, mamba h and conv), each
     within LM_TOL elementwise (jamba in bf16 by the noise rule: the
     card's as close to an f32 CPU run as the CPU's bf16, within 1.5x),
     and each MoE call's routing re-run on the CPU from the card's input:
     a token routed to other experts is a fault unless the two logits lie
     within the f32 bound of the router's d-term dot (a tie, counted);
 23. jamba-v0.1-52b at full width, 16 of its 32 layers (two periods of
     its 8-layer plan: 2 attention, 14 mamba, 8 MoE; 26.05 B parameters,
     bf16, random weights from seed 0 on the card): prefill of 8 x 2,048
     (`flash_attention` 2 a call, 3 timed calls), `decode_loop` at batch
     64 over the last 128 positions of a 2,048-position cache
     (`decode_attention` 2 a
     step), a teacher-forced decode of a 32-token prompt against a prefill
     with room for every token (decode never drops a route; held to
     ‖err‖/‖want‖ ≤ 5e-2: its bf16 noise passes 2e-2 in some logits), the
     first MoE layer's routing at full width held to the CPU's, profiled
     windows with the mamba scan's and the MoE einsums' shares of device
     time, peak memory; then `serve --mode decode --smoke --arch
     jamba-v0.1-52b` through the CLI;
 24. llama4-scout-17b-a16e at full width, 12 of its 48 layers (40 q heads
     over 8 kv heads, every layer MoE with a shared expert; 28.50 B
     parameters): the same readings (`flash_attention` 12 a prefill call,
     `decode_attention` 12 a step; the teacher-forced check elementwise
     within 2e-2);
 25. the audio and vlm families and the f8 KV cache on the CPU (plain
     versions) and on the GPU (kernels) with the same weights: the smoke
     twins of whisper-tiny (with seeded `frames`), pixtral-12b (with
     seeded `img_embeds`) and qwen1.5-32b (an f8 e4m3fn cache) in f32
     and bf16: prefill logits, 16 greedy decode steps (f32 tokens equal,
     bf16 teacher-forced), the cache after them within LM_TOL, the f32
     f8 cache bytes equal (qwen1.5's bf16 twin by the noise rule against
     an f32 CPU run); the f8 cast on the card byte for byte XLA's on the
     edge values (±448, the 464 tie, ±inf, subnormals, NaN) and the
     CPU's on 10^5 seeded values; `decode_attention` on an f8 cache
     against its plain version and bit for bit the kernel on the
     dequantized cache (same split plan) at qwen1.5-32b's heads (40/40
     of 128, b 32, S 2,048), at group 1 hd 64, across split edges, head
     dims, strided views, an f32 q and NaN rows past cache_index; then
     timed at qwen1.5-32b's decode shape beside its bound (the cache at
     1 byte an element), the bf16 path on the dequantized copy, its plain
     version and the dequantize-then-SDPA yardstick, and
     `flash_attention` at whisper's and pixtral's prefill shapes and
     `decode_attention` at whisper's cross-attention;
 26. whisper-tiny whole (56.64 M parameters): prefill of 16 x (1,500
     frames, 448 tokens) (`flash_attention` 4 a call, the encoder's plain
     attention), a teacher-forced decode of 32 tokens against a cross
     cache filled from `encode_kv` (held to the forward's logits
     position by position, elementwise within 2e-2 and in norm within
     1e-2), 256 greedy steps at batch 64
     (`decode_attention` 8 a step: a self and a cross one a layer),
     profiled windows, peak memory, and `serve --mode decode --arch
     whisper-tiny`;
 27. pixtral-12b at full width and depth (40 layers, 12.25 B): prefill of
     8 x (1,024 seeded image embeddings, 1,024 tokens) (`flash_attention`
     40 a call), a teacher-forced decode of 32 text tokens against
     prefill (elementwise within 2e-2), decode at batch 64 over the last
     128 positions of a 2,048 cache (40 a step); then qwen1.5-32b at full
     width, 24 of 64 layers (14.17 B, its f8 cache 16.1 GB at b 32 x
     2,048): 128 decode steps over the last 128 positions (24 a step);
     each against its weight-plus-cache byte bound, with a profiled
     window's busy share and the peak memory;
 28. the backward of `flash_attention` (`flash_attention_bwd`, three
     kernels a call: D, dK/dV, dQ) against its plain version
     (`flash_attention_bwd_ref`) and autograd through the plain forward on
     the card: the head layouts of every registered config (qwen3-14b's
     and qwen1.5-32b's also at their 48-head padding), hd 16 and 32, s 1,
     lengths on either side of its 64-row tiles, f32 and bf16 (f32
     elementwise within 2e-4 and 1e-5 in norm; bf16 within 1e-2 in norm);
     each forward kernel's logsumexp against the plain one (within 1e-5)
     with its output bit for bit the serving call's; two calls bit for bit
     equal; then timed at tinyllama's training shape (b 8, s 2,048, 32/4
     heads, hd 64, bf16) and at hd 128 (b 8, s 2,048, 32/8 heads: jamba's
     and pixtral's) beside its bound (2.5x the forward's FLOPs at 989
     TFLOP/s bf16 dense), its plain version and SDPA's backward; at each
     the C library's count of calls that launched the TMA + wgmma kernels
     (`flash_bwd_dkdv_wgmma_kernel`, `flash_bwd_dq_wgmma_kernel`) shows
     that bf16 at hd 64 and 128 took them, and three profiled calls
     (a PyTorch kernel first in the window, which keeps the profiler's
     records of kernels launched through ctypes) split the device time
     between its three kernels by name;
 29. the training step of every smoke twin on the CPU (plain versions)
     and on the card (the flash forward and backward kernels; for the
     rwkv6 twin `wkv6` and its backward), f32 and bf16, from the same
     state and batch: f32 loss, grad_norm, params, m and v within 1e-4;
     bf16 the scalars within 2e-2 and the gradient (m) by the noise rule
     against an f32 CPU step; then `decode_attention` under autograd on
     the card raises (it has no backward kernel: fault F5's guard), and
     `wkv6` builds its `WKV6` node;
 30. tinyllama-1.1b trained at full width and depth (22 layers, d 2,048,
     1.10 B parameters, bf16, seed 0) on the synthetic TokenStream (batch
     8 x 2,048, vocab 32,000) with `make_train_step` at its defaults and
     remat "full": one warm-up and 5 timed steps, a finite loss each
     step, every leaf's gradient finite and not all zero, 44 forward and
     22 backward flash launches a step, layer 0's wq/wk/wv gradients
     against the plain attention on the card, ms a step, tokens/s, peak
     memory and a profiled step; then, on that state, phase 33 (a);
 31. the backward of `wkv6` (`wkv6_bwd`: a state pass, the reverse pass,
     the sum of du) against its plain version (`wkv6_chunked_bwd_ref`) and
     autograd through the plain forward on the card: head sizes 16, 32
     and 64 at chunks 16, 32 and 64, s below the chunk, decays at which
     the exponent clip binds, exponents planted at exactly ±40 (the
     clip's derivative 1/2, as jax gives it), rwkv6-3b's training shape;
     f32 within 5e-4 elementwise and ‖err‖/‖want‖ ≤ 1e-5, du too; two
     calls bit for bit equal; timed at b 8, s 2,048, 48 heads of 64
     beside its bound (operations; the bytes bound beside it) and the
     plain version, and its time split between the state pass, the
     reverse pass and du's sum (a profiled window, or CUDA events around
     a trace build where the profiler sees no device work);
 32. rwkv6-3b trained at full width and depth (32 layers, d 2,560, 48
     padded heads of 64, vocab 65,536, 3.28 B parameters, bf16, seed 0)
     on the synthetic TokenStream (batch 8 x 2,048) under remat "full":
     one warm-up and 5 timed steps, a finite loss each step, every leaf's
     gradient finite and not all zero, `wkv6` 64 and `wkv6_bwd` 32
     launches a step, layer 0's time-mix gradients against the plain
     version on the card, ms a step, tokens/s, peak memory and a profiled
     step;
 33. checkpoints and the launcher: (a) right after phase 30, its whole
     train state (about 11 GB) saved with `save_checkpoint` into a
     temporary directory, restored bit for bit, both timed, the
     directory removed; (b) `python -m repro_torch.launch.train --arch
     tinyllama-1.1b --smoke` on the card sent SIGTERM after its first
     checkpoint (exit 0), relaunched ("resumed at step"), its end
     checkpoint held to two uninterrupted runs (bit for bit if they
     agree, else within 1.5x their distance); (c) the launcher at full
     size (batch 8 x 2,048, 4 steps) and its tokens/s line;
 34. the engines and the training step on a `torch.distributed` mesh:
     (a) the NCCL process group at world 1 and a (1, 1) mesh on the card:
     Forest (582,000 x 54, k = 7) through `make_sharded_facade` over 300
     group commits, DBLife (124,000 x 1024) through `ShardedHazy` over
     400 updates and two steps of tinyllama-1.1b at 8 x 2,048 through
     `make_train_step`, each with the mesh and without, equal bit for bit
     (labels, order, eps, counts, schedules, waters; every leaf of the
     train state); ms a round, an update and a step for each; (b) eight
     gloo ranks as a (4, 2) ("data", "model") mesh, all on the one card
     with CUDA tensors (NCCL refuses two ranks on one GPU), started as
     fresh interpreters: Forest cut to 581,632 rows (4 shards of 145,408,
     284 x 512) over 100 group commits, each shard's golden invariant and
     the labels in entity order equal to a one-shard card run's (tie
     rule); DBLife's single view at 31,000 x 512 a rank over 200 updates,
     labels by perm == sign(F·w − b); 3 steps of the f32 dense smoke twin
     against a one-process card run (1e-4); every rank's launches of
     `multiview_band_reclassify`, `eps_affine` and `flash_attention`
     above 0;
 35. the train state held in blocks over a (4, 2) ("data", "model")
     mesh by the reference's rules, eight gloo ranks on the one card:
     (a) the f32 smoke twins of tinyllama, pixtral, llama4-scout, dbrx
     (2 microbatches), rwkv6, jamba and whisper one step each,
     tensor-parallel over "model" and gathering the FSDP blocks over
     "data": loss, metrics and every rank's blocks within 1e-4 of a
     one-process CPU step, `flash_attention` and its backward (`wkv6` and
     `wkv6_bwd` for rwkv6) launched on each rank's own heads; (c)
     whisper-tiny at full width and depth in f32 (4 + 4 layers, d 384, 6
     heads, 3 a rank; 8 x 448 tokens over 1,500 frames) one step against
     a one-process card step the same way; (b) tinyllama-1.1b at
     full width in bf16 (`TP_TRAIN_LAYERS` of its 22 layers), 2 steps at
     8 x 2,048, the loss after each within 2^-8 relative of a one-process
     card run from the same seed, each rank's state bytes, ms a step,
     collectives by group, the host time and bytes inside them, and
     launches (16 q and 2 kv heads a rank); in (b) and (c) the residual
     stream is split over "model" along its sequence (the reference's
     `seq_sp` rule): each prints the stream's positions a rank, the
     calls and bytes over "model" by op and `max_memory_allocated` a
     rank, and checks that the stream's reduce-scatters ran;
 36. the dry run and the decode cache in blocks: (a) `decode_attention`
     with its logsumexp output and a row offset (a rank's block of a
     cache split over its rows) against its plain version
     (`decode_attention_block_ref`) at the per-rank blocks of
     `decode_32k` on (16, 16) (tinyllama's heads) and of `long_500k`
     (jamba's), across split counts, partial and empty blocks, f32 and an
     f8 cache; the null-lse call bit for bit the lse call's output; both
     timed; (b) `launch.dryrun` on the host, on meta tensors, of phases
     30's and 35's cells (tinyllama-1.1b at 8 x 2,048, no mesh and (4, 2)
     rank 0 at phase 35's layers): two forward and one backward flash
     call a layer and step, the
     collective calls and bytes a rank a step equal to phase 35's
     records, and the predicted peak held to phase 30's
     `max_memory_allocated` within `DRY_PEAK_RATIO`; (c) eight gloo ranks
     at (4, 2) decode with the cache in the reference's blocks: the f32
     twins of six families against one process (1e-5), and
     tinyllama-1.1b teacher-forced `DM_LM` steps at the end of a
     2,048-row cache against one bf16 process (tokens, and the logits by
     the noise rule against f32), ms a step and the share in all-reduces;
     (b) also dry-runs whisper-tiny's train_4k and decode_32k cells on
     (16, 16) rank 0 (kernel calls, the encoder and decoder units), (c)
     adds the whisper twin (its cross cache filled from `encode` on the
     mesh), and (d) decodes whisper-tiny at full width and depth in f32
     (self and cross caches over its 16 padded heads, 8 a rank), 8
     steps teacher-forced with one card process's greedy tokens against
     a cross cache filled from seeded frames: logits within 1e-5,
     tokens where the margin is clear.

The card's name and power limit (nvidia-smi) come first and again just
before the `kernels` JSON record, the line before the last; the last
line is `{"ok": true, "device": {...}}`. Any failure raises and exits
non-zero; without a GPU the script exits non-zero before printing a
result.
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
LM_DECODE = (64, 2048, 256)    # batch, cache positions, steps (the first
                               # eighth: phase 36 fits in the time limit)
LM_TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # tests/test_kernels.py _tol
LM_NORM_TOL = {"float32": 1e-5, "bfloat16": 1e-2}  # ‖got − want‖ / ‖want‖
VIEW_TABLE = (4_000, 128)       # serve --mode view: docs x 2·d_model
VIEW_ENCODE = (32, 32)          # ... its encoder's batch x tokens
VIEW_ENCODE_ATOL = 5e-3         # its features, card against CPU
WIDTHS = {"forest": (582_000, 54), "dblife": (124_000, 1024),
          "citeseer": (120_000, 4096)}     # Citeseer cut from 721,000 rows
SSM_ARCH = "rwkv6-3b"          # the ssm family's one config
SSM_PARAMS = 3_284_396_032     # rwkv6-3b with 48 padded heads
SSM_DECODE = (64, 128)         # batch, steps (a step's cost is flat in steps)
SSM_TEACHER = 32               # tokens: chunked prefill == exact decode
WKV_TOL = {"float32": 5e-4, "bfloat16": 2e-2}   # tests/test_kernels.py:207
WKV_NORM_TOL = 1e-5            # the recurrence is f32 for either input type
MOE_TWINS = ("llama4-scout-17b-a16e", "dbrx-132b", "jamba-v0.1-52b")
# full width, depth cut to fit one 80 GB card: jamba two whole periods of
# its 8-layer plan (attention, mamba, dense MLP and MoE all present),
# llama4-scout 12 of its 48 layers (every one attention + MoE)
HYBRID = ("jamba-v0.1-52b", 16, 26_053_595_136)     # arch, layers, params
MOE = ("llama4-scout-17b-a16e", 12, 28_496_163_840)
MOE_DECODE = (64, 2048, 128)   # batch, cache positions, steps (the last
                               # 128; 256 until phase 36 needed the time)
MOE_TEACHER = 32               # tokens of the teacher-forced check
MOE_WINDOW = 16                # decode steps of a profiled window
F32_U = 2.0 ** -24             # unit roundoff of f32
HYBRID_TF_NORM_TOL = 5e-2      # jamba decode vs prefill, bf16, in norm


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

def card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return smi.strip().splitlines()[0]


def phase_environment():
    import torch
    print(card_line(), flush=True)
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


def _bound(cost, peak=H100_FP32_FLOPS):
    """(bound_ms, bound_by) of a kernel call's `Cost` (its kernel.py's
    cost function): the larger of its bytes over the memory rate and its
    operations over the `peak` rate (fp32 outside the tensor cores unless
    given)."""
    by_bytes = cost.bytes / H100_BYTES_PER_S * 1e3
    by_ops = cost.flops / peak * 1e3
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
    from repro_torch.launch.mv_band_pair import union_rows
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
    cost = kernel.multiview_band_reclassify_cost(union, window_rows, k, d,
                                                 F.element_size())
    bound_ms, bound_by = _bound(cost)
    bound_windows_ms = _bound(kernel.multiview_band_reclassify_cost(
        window_rows, window_rows, k, d, F.element_size()))[0]
    rec = dict(ms=ms, ms_clean=ms_clean, plain_ms=plain_ms,
               library_ms=library_ms, superset_ms=superset_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               bound_windows_ms=bound_windows_ms, union_rows=union,
               window_rows=window_rows,
               bytes=cost.bytes)
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
        _, block_n, cap = _mv_tiles(None, n, 0.5)
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


def _device_time(prof, wall_s, kernels, ranges=()):
    """Summary of a profiled window: wall time, device-busy time (kernels
    and copies) and its share, the five largest device operations, and
    for each name in `kernels` the launches, time per launch, total time
    and share of the device-busy time of the device operations whose name
    holds it ("not measured" where none does). `ranges` are the labels of
    `record_function` ranges, whose device-side spans are no operations."""
    import torch
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0 and e.key not in ranges]
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
                       eps.eps_affine_cost(n, d, size), n),
        "band_reclassify": (
            lambda: band.band_reclassify(F, labels, w, b, lo, width),
            lambda: band_reclassify_rows_ref(F, labels, w, b, lo, width),
            lambda: torch.mv(F[lo:lo + width], w_lib),
            band.band_reclassify_cost(width, d, size), width)}
    recs = {}
    for kname, (kern, plain, lib, cost, rows) in runs.items():
        ms = _events_ms(kern, 50, flush)
        plain_ms = _events_ms(plain, 10, flush)
        library_ms = _events_ms(lib, 50, flush)
        bound_ms, bound_by = _bound(cost)
        recs[kname] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by, rows=rows,
                           bytes=cost.bytes)
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
            elementwise=True, **fields):
    """|got − want| ≤ tol + tol·|want| elementwise, tol from LM_TOL (the
    reference kernel tests' tolerance) unless given; with `norm`, also
    ‖got − want‖ / ‖want‖ ≤ LM_NORM_TOL (or `norm_tol`), a limit rounding
    stays well below but a kernel that reads one row too many or too few
    does not reach (it moves a 700-row average by about 1/700 against
    values of about 1/√700). Without `elementwise` the elements outside
    the limit are counted but only the norm is held. Returns the largest
    |got − want|."""
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
    check(finite and (bad == 0 or not elementwise),
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
    # jamba's prefill (phase 23; llama4-scout's, phase 24, is the one above)
    flash_cases += [((8, 2048, 32, 8, 128), bf16, card)]
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
    # jamba's and llama4-scout's decode (phases 23-24: the last 256
    # positions of a 2,048 cache)
    decode_cases += [((64, 2048, nq, 8, 128), i, bf16, card)
                     for nq in (32, 40) for i in (1792, 2047)]
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
    # tinyllama-1.1b's prefill, then qwen3-14b's (and llama4-scout's)
    # heads at the same length, then jamba's
    for name, (nq, nkv, hd) in (("flash_attention", (32, 4, 64)),
                                ("flash_attention_hd128", (40, 8, 128)),
                                ("flash_attention_jamba", (32, 8, 128))):
        b, s = LM_PREFILL
        q, k, v = (card((b, s, h, hd), bf16) for h in (nq, nkv, nkv))
        runs[name] = (
            lambda q=q, k=k, v=v: fk.flash_attention(q, k, v),
            lambda q=q, k=k, v=v: flash_plain(q, k, v),
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True),
            fk.flash_attention_cost(b, s, nq, nkv, hd, 2),
            f"b {b}, s {s}, {nq}/{nkv} heads, hd {hd}")
    # tinyllama-1.1b's decode at the end of the context, then qwen3-14b's
    # (and llama4-scout's) heads at the same batch and length, then
    # tinyllama's at batch 8 (8 splits and their combine; one split at
    # batch 64), then jamba's heads at batch 64
    _, S, _ = LM_DECODE
    idx = S - 1
    mask = torch.ones(1, 1, 1, S, dtype=torch.bool, device=dev)
    mask[..., idx + 1:] = False
    for name, (bd, nq, nkv, hd) in (
            ("decode_attention", (LM_DECODE[0], 32, 4, 64)),
            ("decode_attention_hd128", (LM_DECODE[0], 40, 8, 128)),
            ("decode_attention_b8", (8, 32, 4, 64)),
            ("decode_attention_jamba", (LM_DECODE[0], 32, 8, 128))):
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
            dk.decode_attention_cost(bd, nkv, nq // nkv, hd, idx + 1, 2, 2),
            f"b {bd}, S {S}, cache_index {idx}, {nq}/{nkv} heads, hd {hd}")
    for name, (kern, plain, lib, cost, shape) in runs.items():
        ms = _events_ms(kern, 20, flush)
        plain_ms = _events_ms(plain, 5, flush)
        library_ms = _events_ms(lib, 20, flush)
        bound_ms, bound_by = _bound(cost, H100_BF16_FLOPS)
        recs[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        if name in errs:                # a kernel's record, not a timing row
            recs[name].update(max_abs_err=max(errs[name]),
                              cases=len(errs[name]))
        say("lm-kernel-time", kernel=name, shape=shape, bytes=cost.bytes,
            flops=cost.flops, ms=f"{ms:.5f}", bound_ms=f"{bound_ms:.5f}",
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

    # decode: the serving launcher's loop at batch 64 over the first 256
    # positions of a 2,048-position cache
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
    cost = wk.wkv6_cost(b, s, H, K, chunk)
    bound_ms, bound_by = _bound(cost)
    # two launches on the same inputs agree bit for bit (a fixed order of
    # sums, no atomics)
    first = wk.wkv6(r, k, v, la, u, chunk=chunk)
    same = bool(torch.equal(first, wk.wkv6(r, k, v, la, u, chunk=chunk)))
    say("wkv6-repeat", shape=f"{b}x{s}x{H}x{K}-c{chunk}", bit_equal=same)
    check(same, "wkv6: two launches on the same inputs differ")
    say("wkv6-time", shape=f"b {b}, s {s}, {H} heads, K {K}, chunk {chunk}",
        bytes=cost.bytes, flops=cost.flops, ms=f"{ms:.5f}",
        bound_ms=f"{bound_ms:.5f}",
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
    """Inside the block the single-view kernels' public wrappers (with
    `attention`, the LM attention wrappers' too) cannot fall back to their
    plain versions: a call of one raises."""

    def __init__(self, attention=False):
        self.attention = attention

    def __enter__(self):
        from repro_torch.kernels.band_reclassify import ops as band_ops
        from repro_torch.kernels.decode_attention import ops as decode_ops
        from repro_torch.kernels.eps_affine import ops as eps_ops
        from repro_torch.kernels.flash_attention import ops as flash_ops

        def refuse(*_a, **_k):
            raise SmokeFailure("a plain version ran on the GPU path")

        self.saved = [(band_ops, "band_reclassify_rows_ref"),
                      (eps_ops, "eps_affine_ref")]
        if self.attention:
            self.saved += [(flash_ops, "flash_attention_ref"),
                           (decode_ops, "decode_attention_ref")]
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

STORAGE_READS = 2_500          # seeded point reads per budgeted run (cut
                               # from 20,000, then 5,000, for the time)
STORAGE_UPDATES = 2_000        # DBLife updates per run (phase 16's 4,000,
                               # cut for the time)
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
    models = _sgd_models(c, STORAGE_UPDATES + STORAGE_WINDOW[0])
    t = time.perf_counter()
    twin = HazyEngine(F, p=2.0, q=2.0, cost_mode="modeled", device=CARD)
    for m in models[:STORAGE_UPDATES]:
        twin.apply_model(m)
    ties, _ = host_golden(twin, F_dev, "storage twin")
    say("storage-twin", table="dblife", policy="eager",
        updates=STORAGE_UPDATES,
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


# ---------------------------------------------------------------------------
# the SQL front end (phases 20-21)
# ---------------------------------------------------------------------------

SQL_STATEMENTS = 10_000        # Forest: statements under phase 5's mix
                               # (20,000 until phase 36 needed the time)
SQL_DBLIFE = (2_000, 500, 2_500)   # DBLife: inserts, a count every, reads
                                   # (4,000 and 5,000 before phase 36)
SQL_SWARM = (64, 50, 0.95)     # sessions, operations each (100 before
                               # phase 36), point-read share
SQL_GROUP = 32                 # group commit (launch/view_driver.py's)
SQL_WINDOW = 2_000             # Forest statements in the profiled window
SQL_SCRIPT = 600               # phase 20: statements of the seeded script
SQL_TICK_EVERY = 40            # ... a scheduler tick (0.4 s modeled) every
JOIN_S = 300                   # every join and barrier wait of the swarm
SPANS = ("parse", "gate.wait", "flush.read_your_writes", "execute", "plan",
         "wal.commit")


class FakeClock:
    """Modeled freshness time: advances only when told."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _sql_device():
    """The device argument the SQL phases give a catalog: None (the
    entry points' default, the GPU) unless CARD names another device."""
    return None if CARD == "cuda" else CARD


def _mv_counter(zero=False):
    from repro_torch.kernels.band_reclassify import kernel
    if zero:
        kernel.multiview_band_reclassify.launches = 0
    return kernel.multiview_band_reclassify.launches


def _close_catalog(catalog):
    """Close every prefetcher, pool and entity store of a catalog (a
    budgeted view's store is a temp file until then)."""
    for vd in catalog.views.values():
        pool = getattr(getattr(vd.facade, "engine", None), "store", None)
        if pool is not None:
            if getattr(pool, "prefetcher", None) is not None:
                pool.prefetcher.close()
            pool.close()
    for t in catalog.tables.values():
        for es in t.stores.values():
            es.close()


def _view_labels(facade):
    """(k, n) int8 labels of a view in entity order, on its device."""
    import torch
    if hasattr(facade, "state"):                     # ShardedFacade
        st = facade.state
        out = torch.empty_like(st.labels)
        out[:, st.gids.long()] = st.labels
        return out
    eng = facade.engine
    if hasattr(eng, "k"):                            # MultiViewEngine
        eng._catch_up()
        return torch.gather(eng.labels_sorted, 1, eng.inv_perm)
    if eng._defers:
        eng._lazy_catch_up()
    return host_entity_labels(eng)[None]


def _view_models(facade):
    """(W (k, d) f32, b (k,) f32) of a view's current models, on the host."""
    if hasattr(facade, "state"):
        return facade.W, facade.b.astype(np.float32)
    if hasattr(facade, "mc"):
        return facade.mc.W, facade.mc.b.astype(np.float32)
    m = facade.view.model
    return m.w[None], np.array([m.b], np.float32)


def _same_view_state(name, a, b, F):
    """Two facades of one view (say, CPU and GPU): labels in entity order
    (tie rule, under a's models), counts exact. Returns the ties."""
    import torch
    W, bb = _view_models(a)
    la, lb = _view_labels(a).cpu(), _view_labels(b).cpu()
    ties, bad = label_mismatches(lb, la, torch.tensor(F), torch.tensor(W),
                                 torch.tensor(bb))
    check(bad == 0, f"{name}: {bad} labels differ (not ties)")
    check(np.array_equal(np.asarray(a.counts()), np.asarray(b.counts())),
          f"{name}: counts {a.counts()} != {b.counts()}")
    return ties


def _view_golden(name, facade, F):
    """The golden invariant of one view on its device."""
    import torch
    from repro_torch.core.engine import classify
    dev = _view_labels(facade).device
    W, bb = _view_models(facade)
    F_dev = torch.tensor(F, device=dev)
    W_dev, b_dev = torch.tensor(W, device=dev), torch.tensor(bb, device=dev)
    want = classify(W_dev @ F_dev.T - b_dev[:, None])
    ties, bad = label_mismatches(_view_labels(facade), want, F_dev, W_dev,
                                 b_dev)
    check(bad == 0, f"{name}: golden invariant: {bad} labels wrong")
    check(np.array_equal(np.asarray(facade.counts()),
                         (want == 1).sum(1).cpu().numpy())
          or ties > 0, f"{name}: counts != positive labels")
    eng = getattr(facade, "engine", None)
    if eng is not None and hasattr(eng, "check_consistent"):
        check(eng.check_consistent(), f"{name}: check_consistent() false")
    return ties


def _sql_phase20_script(seed, n_forest, n_papers, forest_labels,
                        papers_classes, count=SQL_SCRIPT):
    """Phase 20's seeded statement list (None marks a scheduler tick)."""
    rng = np.random.default_rng(seed)
    singles = ("sv_eager", "sv_lazy", "sv_hybrid", "sv_budget", "derived",
               "lagged")
    out = ["PREPARE pt AS SELECT id, label FROM sv_hybrid WHERE id = ?",
           "PREPARE mvp AS SELECT id, view, label FROM mv WHERE id = ?",
           "PREPARE cnt AS SELECT count(*) FROM sv_lazy WHERE label = ?"]
    for j in range(count):
        u = rng.random()
        i = int(rng.integers(0, n_forest))
        p = int(rng.integers(0, n_papers))
        if u < 0.30:
            out.append(f"INSERT INTO forest (id, label) VALUES "
                       f"({i}, {int(forest_labels[i])})")
        elif u < 0.45:
            out.append(f"INSERT INTO papers (id, class) VALUES "
                       f"({p}, {int(papers_classes[p])})")
        elif u < 0.50:
            out.append(f"INSERT INTO forest2 (id, label) VALUES "
                       f"({i}, {int(forest_labels[i])})")
        elif u < 0.51:
            out.append(f"DELETE FROM forest2 WHERE id = {i}")
        elif u < 0.66:
            v = singles[int(rng.integers(0, len(singles)))]
            out.append(f"SELECT id, label FROM {v} WHERE id = {i}")
        elif u < 0.72:
            out.append(f"SELECT id, view, label FROM "
                       f"{'mv' if rng.random() < 0.5 else 'sh'} "
                       f"WHERE id = {p}")
        elif u < 0.76:
            out.append(f"EXECUTE pt ({i})" if rng.random() < 0.5
                       else f"EXECUTE mvp ({p})")
        elif u < 0.82:
            v = singles[int(rng.integers(0, len(singles)))]
            out.append(f"SELECT count(*) FROM {v} WHERE label = 1")
        elif u < 0.85:
            out.append(f"SELECT count(*) FROM "
                       f"{'mv' if rng.random() < 0.5 else 'sh'} "
                       f"WHERE class = {int(rng.integers(0, 7))}")
        elif u < 0.87:
            out.append("EXECUTE cnt (-1)")
        elif u < 0.89:
            out.append("SELECT id, label FROM sv_lazy WHERE label = 1 "
                       "LIMIT 40")
        elif u < 0.91:
            out.append("SELECT id, margin FROM sv_eager ORDER BY margin "
                       "DESC LIMIT 8")
        elif u < 0.93:
            out.append(f"EXPLAIN ANALYZE SELECT id, label FROM sv_budget "
                       f"WHERE id IN ({i}, {(i * 7) % n_forest})")
        elif u < 0.95:
            out.append("UPDATE MODEL ON sv_eager" if rng.random() < 0.5
                       else "UPDATE MODEL ON sh")
        elif u < 0.96:
            out.append("SHOW SCHEDULE")
        elif u < 0.97:
            out.append(f"UPDATE forest SET label = "
                       f"{-int(forest_labels[i])} WHERE id = {i}")
        else:
            out.append(f"EXPLAIN SELECT id, label FROM sv_hybrid "
                       f"WHERE id = {i}")
        if j % SQL_TICK_EVERY == SQL_TICK_EVERY - 1:
            out.append(None)
    out += ["COMMIT", "SHOW SCHEDULE", "SHOW VIEWS", "SHOW STORAGE",
            "EXPLAIN ANALYZE SELECT count(*) FROM sv_lazy WHERE label = 1"]
    return out


_TIMING_COLUMNS = ("actual_us",)
_PREPARED_VIEWS = {"pt": "sv_hybrid", "mvp": "mv", "cnt": "sv_lazy"}


def _stmt_view(sql):
    """The view a phase-20 read statement reads."""
    if sql.startswith("EXECUTE "):
        return _PREPARED_VIEWS[sql.split()[1]]
    return sql.split(" FROM ")[1].split()[0]


def _same_sql_result(sql, a, b, cat_a, tol):
    """CPU result `a` against GPU result `b` of one statement: equal but
    for timing cells, margins (within `tol`) and label cells of proven
    ties (under cat_a's current models). Returns the ties."""
    import torch
    check(a.columns == b.columns and len(a.rows) == len(b.rows)
          and a.epoch == b.epoch and a.tiers_used == b.tiers_used,
          f"{sql!r}: results differ: {a} / {b}")
    if a.plan is not None or b.plan is not None:
        check(a.plan == b.plan, f"{sql!r}: plans differ: {a.plan} / {b.plan}")
    ties = 0
    for ra, rb in zip(a.rows, b.rows):
        for col, x, y in zip(a.columns, ra, rb):
            if col in _TIMING_COLUMNS or x == y:
                continue
            if col == "margin":
                check(abs(x - y) <= tol, f"{sql!r}: margin {x} / {y}")
                continue
            check(col == "label" and "id" in a.columns,
                  f"{sql!r}: {col} {x} != {y}")
            view = _stmt_view(sql)
            f = cat_a.view(view).facade
            i = int(ra[a.columns.index("id")])
            v = int(ra[a.columns.index("view")]) if "view" in a.columns else 0
            W, bb = _view_models(f)
            _, bad = label_mismatches(
                torch.tensor([[y]], dtype=torch.int8),
                torch.tensor([[x]], dtype=torch.int8),
                torch.tensor(cat_a.table(cat_a.view(view).table)
                             .features[[i]]),
                torch.tensor(W[[v]]), torch.tensor(bb[[v]]))
            check(bad == 0, f"{sql!r}: label of {i} differs (not a tie)")
            ties += 1
    return ties


def phase_sql_cpu_vs_gpu(seed=SEED):
    """Phase 20: one seeded SQL script through `Executor(device="cpu")`
    and through `Executor()` on the card, over cora_like (k = 7:
    `engine = multiview` hybrid and `engine = sharded`) and
    forest_like(0.01) (hazy eager, lazy and hybrid, a memory_budget =
    0.25 view, a derived view, a target_lag view ticked on a modeled
    clock, a second table for DELETE); UPDATE MODEL, prepared
    statements, EXPLAIN ANALYZE and SHOW SCHEDULE among the statements.
    Every result equal (tie rule for labels, margins within the fp32
    bound of the dot), the WAL files byte for byte equal, the end states
    equal and the golden invariant on both. Returns the GPU run's
    launches."""
    import torch
    from repro_torch.data import cora_like, forest_like
    from repro_torch.rdbms import Catalog, Executor
    from repro_torch.scheduler import FreshnessScheduler
    t0 = time.perf_counter()
    forest, papers = forest_like(scale=0.01), cora_like()
    Ff = np.ascontiguousarray(forest.features, np.float32)
    Fp = np.ascontiguousarray(papers.features, np.float32)
    script = _sql_phase20_script(seed + 20, Ff.shape[0], Fp.shape[0],
                                 forest.labels, papers.classes)
    wal_dir = ROOT / "build" / "sql"
    wal_dir.mkdir(parents=True, exist_ok=True)
    runs = {}
    for dev in ("cpu", "cuda"):
        cat = Catalog(device="cpu" if dev == "cpu" else _sql_device())
        cat.clock = FakeClock()
        cat.register_table("forest", Ff, truth=forest.labels)
        cat.register_table("forest2", Ff, truth=forest.labels)
        cat.register_table("papers", Fp, truth=papers.classes,
                           num_classes=papers.num_classes)
        wal = wal_dir / f"phase20-{dev}.jsonl"
        wal.unlink(missing_ok=True)
        ex = Executor(cat, group_commit=8, wal_path=str(wal))
        for sql in (
                "CREATE CLASSIFICATION VIEW sv_eager ON forest USING MODEL "
                "svm WITH (policy = eager, cost_mode = modeled)",
                "CREATE CLASSIFICATION VIEW sv_lazy ON forest USING MODEL "
                "svm WITH (policy = lazy, cost_mode = modeled)",
                "CREATE CLASSIFICATION VIEW sv_hybrid ON forest USING MODEL "
                "svm WITH (policy = hybrid, cost_mode = modeled)",
                "CREATE CLASSIFICATION VIEW sv_budget ON forest USING MODEL "
                "svm WITH (policy = hybrid, cost_mode = modeled, "
                "buffer_frac = 0.02, memory_budget = 0.25, "
                "page_bytes = 1024)",
                "CREATE CLASSIFICATION VIEW derived ON sv_eager USING MODEL "
                "svm WITH (cost_mode = modeled)",
                "CREATE CLASSIFICATION VIEW lagged ON forest USING MODEL "
                "svm WITH (policy = eager, cost_mode = modeled, "
                "target_lag = '2 s')",
                "CREATE CLASSIFICATION VIEW mv ON papers USING MODEL svm "
                "WITH (k = 7, engine = multiview, policy = hybrid, "
                "cost_mode = modeled)",
                "CREATE CLASSIFICATION VIEW sh ON papers USING MODEL svm "
                "WITH (k = 7, engine = sharded, cap_frac = 0.5)",
                "CREATE CLASSIFICATION VIEW solo ON forest2 USING MODEL svm "
                "WITH (cost_mode = modeled)"):
            ex.execute_one(sql)
        sched = FreshnessScheduler(ex, clock=cat.clock)
        runs[dev] = dict(cat=cat, ex=ex, sched=sched, wal=wal)
    cpu, gpu = runs["cpu"], runs["cuda"]
    for name, vd in gpu["cat"].views.items():
        eng = getattr(vd.facade, "engine", None) or vd.facade.driver
        check(eng.device.type == CARD, f"view {name} is not on the card")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny CPU products: threads only cost
    _sv_counters(zero=True)
    _mv_counter(zero=True)
    ties = ticks = 0
    tol = 0.0
    try:
        for sql in script:
            if sql is None:
                for run in (cpu, gpu):
                    run["cat"].clock.t += 0.4
                    run["sched"].tick()
                ticks += 1
                continue
            a = cpu["ex"].execute_one(sql)
            b = gpu["ex"].execute_one(sql)
            if "margin" in a.columns:
                W, bb = _view_models(cpu["cat"].view("sv_eager").facade)
                mass = np.abs(Ff.astype(np.float64) * W[0]).sum(1)
                tol = float((2 * (Ff.shape[1] + 1) * 2.0 ** -24
                             * (mass + abs(float(bb[0])))).max())
            ties += _same_sql_result(sql, a, b, cpu["cat"], tol)
        check(cpu["sched"].schedule_log == gpu["sched"].schedule_log,
              "phase 20: the schedulers refreshed at other ticks")
        check(any(names for _, names in gpu["sched"].schedule_log),
              "phase 20: the lagged view was never refreshed by a tick")
        for run in (cpu, gpu):
            run["ex"].refresh_views()
            run["ex"].log.close()
        launches = dict(_sv_counters(),
                        multiview_band_reclassify=_mv_counter())
        check(cpu["wal"].read_bytes() == gpu["wal"].read_bytes(),
              "phase 20: the WAL files differ")
        check(cpu["ex"].log.commits == gpu["ex"].log.commits > 0,
              "phase 20: commit counts differ")
        state_ties = golden = 0
        for name, vd in cpu["cat"].views.items():
            F = (Fp if vd.table == "papers" else
                 vd.facade.view.F if vd.source is not None else Ff)
            state_ties += _same_view_state(name, vd.facade,
                                           gpu["cat"].view(name).facade, F)
            for run in (cpu, gpu):
                golden += _view_golden(name, run["cat"].view(name).facade, F)
        check(min(launches.values()) > 0,
              f"phase 20: a kernel was never launched: {launches}")
    finally:
        torch.set_num_threads(threads)
        for run in (cpu, gpu):
            _close_catalog(run["cat"])
            run["wal"].unlink(missing_ok=True)
    say("sql-cpu-vs-gpu", statements=sum(s is not None for s in script),
        ticks=ticks, commits=gpu["ex"].log.commits,
        views=len(gpu["cat"].views), refreshes=sum(
            len(n) for _, n in gpu["sched"].schedule_log),
        label_ties=ties, state_ties=state_ties, golden_ties=golden,
        launches=launches, wal_equal=True, equal=True,
        seconds=f"{time.perf_counter() - t0:.2f}")
    return launches


def _span_shares(results):
    """Share of the statements' time in each executor span (SPANS)."""
    total = sum(r.trace.duration_us for r in results)
    return {name: f"{sum(r.trace.sum_us(name) for r in results) / total:.4f}"
            for name in SPANS}


def _ms_per_commit(ex, commits):
    """Host ms a commit: the executor's `wal.commit` spans (each holds one
    group's engine rounds) over the commits they made."""
    h = ex.metrics_snapshot()["histograms"]["span.wal.commit.seconds"]
    return f"{h['sum'] / max(1, commits) * 1e3:.3f}"


def _rates(kinds, seconds):
    return {k: f"{kinds[k] / seconds[k]:.1f}" for k in kinds if seconds[k]}


def _sql_forest(ex, c, statements, rng, window=False):
    """`statements` SQL statements on Forest under phase 5's mix (point
    reads of every view, counts of a class, inserts). Returns per-kind
    counts and seconds and the results."""
    n, k = c.features.shape[0], FOREST["k"]
    kinds = rng.choice(list(MIX), size=statements, p=list(MIX.values()))
    served = {kind: 0 for kind in MIX}
    secs = {kind: 0.0 for kind in MIX}
    results = []
    for kind in kinds:
        i = int(rng.integers(0, n))
        if kind == "read":
            sql = f"SELECT id, view, label FROM topics WHERE id = {i}"
        elif kind == "count":
            sql = (f"SELECT count(*) FROM topics WHERE class = "
                   f"{int(rng.integers(0, k))}")
        else:
            sql = (f"INSERT INTO forest (id, class) VALUES "
                   f"({i}, {int(c.classes[i])})")
        t = time.perf_counter()
        res = ex.execute_one(sql)
        secs[kind] += time.perf_counter() - t
        served[kind] += 1
        if kind == "read":
            check(len(res.rows) == k, f"bad point read {res.rows}")
        results.append(res)
    return served, secs, results


def _sql_forest_path(seed):
    """Phase 21, Forest: `engine = sharded` through SQL, SQL_STATEMENTS
    statements, the golden invariant and the launch identity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import multiclass_corpus
    from repro_torch.rdbms import Catalog, Executor
    t0 = time.perf_counter()
    c = multiclass_corpus("FC", FOREST["n"], FOREST["d"], FOREST["k"],
                          seed=seed)
    cat = Catalog(device=_sql_device())
    cat.register_table("forest", c.features, truth=c.classes,
                       num_classes=FOREST["k"])
    ex = Executor(cat, group_commit=SQL_GROUP)
    ex.execute_one("CREATE CLASSIFICATION VIEW topics ON forest USING MODEL "
                   "svm WITH (engine = sharded, k = 7, cap_frac = 0.5, "
                   "p = 2, q = 2)")
    fac = cat.view("topics").facade
    drv = fac.driver
    check(drv.device.type == CARD, "the sharded view is not on the card")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 21)
    reorgs0, over0, commits0 = drv.skiing.reorgs, drv.overflows, \
        ex.log.commits
    _mv_counter(zero=True)
    t = time.perf_counter()
    served, secs, results = _sql_forest(ex, c, SQL_STATEMENTS, rng)
    ex.execute_one("COMMIT")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = _mv_counter()
    commits = ex.log.commits - commits0
    reorgs = drv.skiing.reorgs - reorgs0
    overflows = drv.overflows - over0
    update_rounds = commits - (reorgs - overflows)
    check(0 < launches == update_rounds,
          f"sql forest: launches {launches} != update rounds "
          f"{update_rounds}")
    counts, ties = golden_invariant(fac, c.features)
    say("sql-forest", n=fac.n, d=fac.d, k=fac.num_views,
        statements=SQL_STATEMENTS, served=served, setup_s=f"{setup_s:.2f}",
        seconds=f"{wall:.2f}", statements_per_s=f"{SQL_STATEMENTS / wall:.1f}",
        per_s_by_kind=_rates(served, secs), commits=commits,
        ms_per_commit=_ms_per_commit(ex, ex.log.commits),
        rows_per_commit=f"{served['insert'] / max(1, commits):.2f}",
        update_rounds=update_rounds, launches=launches, reorgs=reorgs,
        overflows=overflows, span_shares=_span_shares(results),
        counts=counts.tolist(), golden_ties=ties, golden_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        served_w, _, _ = _sql_forest(ex, c, SQL_WINDOW, rng)
        torch.cuda.synchronize()
        wall_w = time.perf_counter() - t
    say("sql-forest-profile", statements=SQL_WINDOW, served=served_w,
        **_device_time(prof, wall_w, {"band_kernel": "band_reclassify"}))
    golden_invariant(fac, c.features)
    return launches


def _sql_dblife_path(seed):
    """Phase 21, DBLife: a hybrid single view over a 10% memory budget
    through SQL: inserts in group commits of 32 with a count every 500,
    then point reads; launch identities, tiers reconciled with the pool,
    the golden invariant."""
    import torch
    from repro_torch.data import dblife_like, example_stream
    from repro_torch.rdbms import Catalog, Executor
    inserts, count_every, reads = SQL_DBLIFE
    t0 = time.perf_counter()
    c = dblife_like()
    F = np.ascontiguousarray(c.features)
    cat = Catalog(device=_sql_device())
    cat.register_table("dblife", F, truth=c.labels)
    ex = Executor(cat, group_commit=SQL_GROUP)
    try:
        _sv_counters(zero=True)
        with no_plain_versions():
            ex.execute_one("CREATE CLASSIFICATION VIEW dbv ON dblife USING "
                           "MODEL svm WITH (engine = hazy, policy = hybrid, "
                           "cost_mode = modeled, memory_budget = 0.1)")
            fac = cat.view("dbv").facade
            eng, pool = fac.view.engine, fac.view.engine.store
            check(eng.device.type == CARD and pool is not None,
                  "the DBLife view is not on the card over a pool")
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            stream = example_stream(c, seed=3)
            kinds = {"insert": 0, "count": 0, "read": 0}
            secs = {"insert": 0.0, "count": 0.0, "read": 0.0}
            results = []
            commits0 = ex.log.commits
            for j in range(inserts):
                i, _, y = next(stream)
                t = time.perf_counter()
                results.append(ex.execute_one(
                    f"INSERT INTO dblife (id, label) VALUES ({i}, {int(y)})"))
                secs["insert"] += time.perf_counter() - t
                kinds["insert"] += 1
                if j % count_every == count_every - 1:
                    t = time.perf_counter()
                    results.append(ex.execute_one(
                        "SELECT count(*) FROM dbv WHERE label = 1"))
                    secs["count"] += time.perf_counter() - t
                    kinds["count"] += 1
            ex.execute_one("COMMIT")
            commits = ex.log.commits - commits0
            p0, tiers0 = pool.stats(), dict(fac.tier_hits)
            rng = np.random.default_rng(seed + 21)
            for _ in range(reads):
                i = int(rng.integers(0, F.shape[0]))
                t = time.perf_counter()
                res = ex.execute_one(f"SELECT id, label FROM dbv "
                                     f"WHERE id = {i}")
                secs["read"] += time.perf_counter() - t
                kinds["read"] += 1
                results.append(res)
            torch.cuda.synchronize()
        tiers = {k: fac.tier_hits[k] - tiers0[k] for k in fac.tier_hits}
        check(tiers["map"] == 0 and sum(tiers.values()) == reads,
              f"sql dblife: tiers {tiers}")
        calls = tiers["buffer"] + tiers["pool"] + tiers["disk"]
        st = _reconcile("sql-dblife", eng, pool, p0, tiers, calls, False)
        launches = _sv_counters()
        reorgs = eng.stats.reorgs
        check(launches["eps_affine"] == reorgs + 1,
              f"sql dblife: eps_affine launches {launches['eps_affine']} "
              f"!= reorgs + 1 ({reorgs + 1})")
        check(launches["band_reclassify"] > 0,
              "sql dblife: band_reclassify never launched")
        F_dev = torch.tensor(F, device=CARD)
        ties, consistent = host_golden(eng, F_dev, "sql-dblife")
        check(consistent, "sql dblife: check_consistent() false")
        del F_dev
        say("sql-dblife", n=F.shape[0], d=F.shape[1], inserts=inserts,
            counts=kinds["count"], reads=reads, setup_s=f"{setup_s:.2f}",
            per_s_by_kind=_rates(kinds, secs), commits=commits,
            ms_per_commit=_ms_per_commit(ex, ex.log.commits),
            reorgs=reorgs, launches=launches,
            tiers={k: f"{v / reads:.4f}" for k, v in tiers.items()},
            pool={k: st[k] for k in ("probes", "hits", "misses",
                                     "evictions", "budget_bytes")},
            span_shares=_span_shares(results), golden_ties=ties,
            view_exact=True)
        return launches
    finally:
        _close_catalog(cat)


def _swarm_catalog(c, seed):
    """Forest with the swarm's two views: `topics` (k = 7 over
    `MultiViewEngine`, hybrid, 25% memory budget) and the lagged `audit`
    (`engine = sharded`, target_lag 2 s)."""
    from repro_torch.rdbms import Catalog
    cat = Catalog(device=_sql_device())
    cat.register_table("forest", c.features, truth=c.classes,
                       num_classes=FOREST["k"])
    cat.create_view("topics", "forest", "svm",
                    {"k": FOREST["k"], "policy": "hybrid",
                     "buffer_frac": 0.02, "memory_budget": 0.25,
                     "cost_mode": "modeled"})
    cat.create_view("audit", "forest", "svm",
                    {"k": FOREST["k"], "engine": "sharded",
                     "target_lag": "2 s"})
    return cat


def _sql_swarm(seed):
    """Phase 21, the swarm: SQL_SWARM sessions against the wire server
    with the freshness scheduler running; then the WAL replayed serially
    into a fresh catalog on the card, every view equal to the served
    one."""
    import threading
    import torch
    from repro_torch.data import multiclass_corpus
    from repro_torch.rdbms import (Executor, SqlClient, UpdateLog,
                                   start_server_thread)
    from repro_torch.scheduler import FreshnessScheduler
    sessions, ops, read_share = SQL_SWARM
    c = multiclass_corpus("FC", FOREST["n"], FOREST["d"], FOREST["k"],
                          seed=seed)
    n, k = FOREST["n"], FOREST["k"]
    cat = _swarm_catalog(c, seed)
    replay = None
    try:
        ex = Executor(cat, group_commit=SQL_GROUP)
        audit = cat.view("audit").facade
        topics = cat.view("topics").facade
        rewarms = _timed_rewarms(topics.engine)
        reorgs0, over0 = audit.driver.skiing.reorgs, audit.driver.overflows
        treorgs0 = int(topics.engine.reorg_counts.sum())
        _mv_counter(zero=True)
        daemon = FreshnessScheduler(ex).start()
        handle = start_server_thread(ex)
        lat = {"read": [], "insert": []}
        errors = []
        barrier = threading.Barrier(sessions + 1, timeout=JOIN_S)

        def worker(idx):
            rng = np.random.default_rng(seed + 1000 + idx)
            mine = {"read": [], "insert": []}
            try:
                with SqlClient.connect(*handle.address,
                                       timeout=JOIN_S) as cl:
                    cl.prepare("pt", "SELECT label FROM topics WHERE id = ? "
                               "AND view = ?")
                    barrier.wait()
                    for _ in range(ops):
                        i = int(rng.integers(0, n))
                        t = time.perf_counter()
                        if rng.random() < read_share:
                            cl.run_prepared("pt", [i, int(rng.integers(0, k))])
                            mine["read"].append(time.perf_counter() - t)
                        else:
                            cl.run(f"INSERT INTO forest (id, class) VALUES "
                                   f"({i}, {int(c.classes[i])})")
                            mine["insert"].append(time.perf_counter() - t)
            except Exception as e:              # noqa: BLE001
                errors.append((idx, repr(e)))
                barrier.abort()
            for key in lat:
                lat[key].extend(mine[key])

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(sessions)]
        for th in threads:
            th.start()
        try:
            barrier.wait()
            t0 = time.perf_counter()
            for th in threads:
                th.join(JOIN_S)
            wall = time.perf_counter() - t0
            # the daemon, not the barrier below, drains what the sessions
            # queued: it refreshes `audit` once its staleness passes half
            # its lag (the wait is bounded)
            rt = cat.view("audit").runtime
            t = time.perf_counter()
            while rt.inbox and time.perf_counter() - t < 30:
                time.sleep(0.05)
        finally:
            handle.stop()
            daemon.stop()
        check(not any(th.is_alive() for th in threads),
              "swarm: a session did not finish within its limit")
        check(not errors, f"swarm: {errors[:3]}")
        daemon_launches = _mv_counter()
        refreshes = ex.metrics.counter("scheduler.refreshes").value
        hist = ex.metrics_snapshot()["histograms"]
        where = {key: "{count}x mean {mean:.3e} p50 {p50:.3e} p99 {p99:.3e} "
                      "sum {sum:.3f}".format(**hist[key])
                 for key in ("statement.seconds", "span.request.seconds",
                             "gate.shared_wait_seconds",
                             "gate.exclusive_wait_seconds",
                             "span.wal.commit.seconds") if key in hist}
        ex.execute_one("COMMIT")
        barrier_names = ex.refresh_views()
        torch.cuda.synchronize()
        launches = _mv_counter()
        reorgs = audit.driver.skiing.reorgs - reorgs0
        overflows = audit.driver.overflows - over0
        check(launches == rt.batches_applied - (reorgs - overflows),
              f"swarm: audit launches {launches} != its update rounds "
              f"{rt.batches_applied} - {reorgs - overflows}")
        check(daemon_launches > 0 and refreshes > 0,
              f"swarm: the daemon refreshed nothing ({refreshes}) or "
              f"launched nothing ({daemon_launches})")
        history = list(ex.log.history)
        replay = _swarm_catalog(c, seed)
        log = UpdateLog.replay_into(history, replay)
        Executor(replay).refresh_views()
        check(log.commits == ex.log.commits, "swarm: commit counts differ")
        ties = 0
        for name in ("topics", "audit"):
            a, b = cat.view(name), replay.view(name)
            ties += _same_view_state(f"swarm {name}", a.facade, b.facade,
                                     c.features)
            check(a.runtime.batches_applied == b.runtime.batches_applied
                  and a.runtime.rows_applied == b.runtime.rows_applied,
                  f"swarm {name}: {a.runtime.batches_applied} batches / "
                  f"{b.runtime.batches_applied} in the replay")
            for v in range(k):
                check(np.array_equal(np.sort(a.facade.members(v)),
                                     np.sort(b.facade.members(v))),
                      f"swarm {name}: members of view {v} differ")
        golden = sum(_view_golden(f"swarm {name}", cat.view(name).facade,
                                  c.features) for name in ("topics", "audit"))
        total = sum(len(v) for v in lat.values())
        pct = {f"{key}_ms_p50_p99": (
                   f"{np.percentile(v, 50) * 1e3:.3f}/"
                   f"{np.percentile(v, 99) * 1e3:.3f}" if v else "-")
               for key, v in lat.items()}
        say("sql-swarm", sessions=sessions, ops=total,
            reads=len(lat["read"]), inserts=len(lat["insert"]),
            seconds=f"{wall:.2f}", qps=f"{total / wall:.1f}", **pct,
            commits=ex.log.commits, daemon_refreshes=refreshes,
            daemon_launches=daemon_launches, launches=launches,
            barrier=barrier_names, audit_batches=rt.batches_applied,
            tier_hits=topics.tier_hits,
            topics_reorgs=int(topics.engine.reorg_counts.sum()) - treorgs0,
            rewarm_s=f"{sum(rewarms):.3f}", rewarms=len(rewarms),
            server_side=where, replay_equal=True, label_ties=ties,
            golden_ties=golden)
        return {"daemon": daemon_launches, "all": launches}
    finally:
        _close_catalog(cat)
        if replay is not None:
            _close_catalog(replay)


def phase_sql_path(seed=SEED, requests=3000):
    """Phase 21: the SQL front end at full size on the card: Forest
    (`engine = sharded`), DBLife (hybrid over a 10% pool), the swarm
    against the wire server with the freshness scheduler running, then
    `serve --mode sql --execute` and `view_driver --sql`. Returns the
    launches on each path."""
    import contextlib
    import io
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import view_driver
    t0 = time.perf_counter()
    out = {"forest": _sql_forest_path(seed)}
    torch.cuda.empty_cache()
    out["dblife"] = _sql_dblife_path(seed)
    torch.cuda.empty_cache()
    out["swarm"] = _sql_swarm(seed)
    torch.cuda.empty_cache()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ex = serve_mod.main([
            "--mode", "sql", "--device", CARD, "--execute",
            "CREATE TABLE papers FROM CORPUS cora_like WITH (scale = 1.0); "
            "CREATE CLASSIFICATION VIEW topics ON papers USING MODEL svm "
            "WITH (k = 7, engine = sharded); "
            "INSERT INTO papers (id, class) VALUES (0, 3), (1, 0), (2, 6); "
            "SELECT id, view, label FROM topics WHERE id = 0; "
            "SELECT count(*) FROM topics WHERE class = 3; SHOW TABLES"])
    text = buf.getvalue()
    check("(7 rows)" in text and ex.catalog.device.type == CARD
          and ex.log.commits == 1,
          f"serve --mode sql --execute: unexpected output {text[-500:]}")
    say("sql-serve-execute", commits=ex.log.commits,
        rows=text.count("rows)"), device=ex.catalog.device)
    fk.flash_attention.launches = 0
    _sv_counters(zero=True)
    buf = io.StringIO()
    with no_plain_versions(), contextlib.redirect_stdout(buf):
        t = time.perf_counter()
        ex = view_driver.main(["--sql", "--requests", str(requests),
                               "--device", CARD])
        torch.cuda.synchronize()
        vd_s = time.perf_counter() - t
    text = buf.getvalue()
    for line in text.splitlines():
        say("sql-view-driver", out=line)
    vd = dict(_sv_counters(), flash_attention=fk.flash_attention.launches)
    check(text.rstrip().endswith("view exact ✓"),
          "view_driver --sql did not end in 'view exact'")
    check(min(vd.values()) > 0, f"view_driver --sql launched {vd}")
    F_dev = torch.tensor(ex.catalog.tables["docs"].features, device=CARD)
    ties, consistent = host_golden(ex.catalog.view("topic").facade.view.engine,
                                   F_dev, "sql-view-driver")
    check(consistent, "view_driver --sql: check_consistent() false")
    out["view_driver"] = vd
    say("sql-path", seconds=f"{time.perf_counter() - t0:.2f}",
        view_driver_s=f"{vd_s:.2f}", launches=out, golden_ties=ties)
    return out


# ---------------------------------------------------------------------------
# the moe and hybrid families: llama4-scout, dbrx and jamba (phases 22-24)
# ---------------------------------------------------------------------------

class _moe_inputs:
    """Within the block, every `moe.moe` call records (router, a copy of
    its input x, cfg), so that its routing can be held to the CPU's."""

    def __enter__(self):
        from repro_torch.models import moe
        self.calls, self.saved = [], moe.moe

        def spy(p, cfg, x):
            self.calls.append((p["router"], x.detach().clone(), cfg))
            return self.saved(p, cfg, x)

        moe.moe = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.moe = self.saved
        return False


def _routing_vs_cpu(calls):
    """Each recorded MoE input routed on its device and on the CPU (plain
    torch), from the same x. A token routed to other experts is a fault
    unless the two experts' router logits lie within the f32 rounding
    bound of their d-term dots (γ_d·Σ|x_i·w_i| each, γ_d = d·u/(1 − d·u),
    plus 4 ulps of each logit for the softmax): a tie. In a group (batch
    row) with no differing choice the kept slots must be equal too.
    Returns (routes, ties, faults, dropped routes on the device)."""
    import torch
    from repro_torch.models.moe import route
    routes = ties = faults = dropped = 0
    for router, x, cfg in calls:
        rd = route(router, cfg, x)
        rc = route(router.cpu(), cfg, x.cpu())
        cd, cc = rd.choices.cpu(), rc.choices
        kept_d = rd.combine.cpu() > 0
        routes += cc.numel()
        dropped += cc.numel() - int(kept_d.sum())
        xf, w = x.cpu().float(), router.cpu().float()
        d = xf.shape[-1]
        logits = xf @ w
        bound = (d * F32_U / (1 - d * F32_U) * (xf.abs() @ w.abs())
                 + 4 * F32_U * logits.abs())
        diff = cd != cc
        for g in range(cc.shape[0]):
            if not diff[g].any():
                check(torch.equal(kept_d[g], rc.combine[g] > 0),
                      f"{cfg.name}: kept slots differ in group {g} with "
                      f"equal choices")
        for g, s, j in diff.nonzero().tolist():
            a, b = int(cd[g, s, j]), int(cc[g, s, j])
            gap = float((logits[g, s, a] - logits[g, s, b]).abs())
            if gap <= float(bound[g, s, a] + bound[g, s, b]):
                ties += 1
            else:
                faults += 1
    return routes, ties, faults, dropped


NOISE_RATIO = 1.5   # hybrid bf16: ‖card − f32‖ ≤ 1.5 · ‖CPU − f32‖


def _hold(name, got, want, tol, anchor=None):
    """`got` (the card's) against `want` (the CPU's), each a tensor or a
    list of them: elementwise |got − want| ≤ tol + tol·|want|, or, given
    `anchor` (the same computation in f32 on the CPU), the bf16 noise
    rule ‖got − anchor‖ ≤ NOISE_RATIO · ‖want − anchor‖: the card's bf16
    as close to the f32 result as the CPU's bf16. Returns (largest
    |got − want|, elements outside the elementwise limit, noise ratio or
    None)."""
    import torch

    def flat(xs):
        return torch.cat([x.detach().cpu().float().reshape(-1)
                          for x in (xs if isinstance(xs, list) else [xs])])

    g, w = flat(got), flat(want)
    err = float((g - w).abs().max())
    bad = int(((g - w).abs() > tol + tol * w.abs()).sum())
    check(bool(torch.isfinite(g).all()), f"{name}: not finite")
    if anchor is None:
        check(bad == 0, f"{name}: {bad} elements outside {tol} "
              f"(largest difference {err:.3e})")
        return err, bad, None
    a = flat(anchor)
    ratio = float(torch.linalg.vector_norm(g - a)
                  / torch.linalg.vector_norm(w - a).clamp_min(1e-30))
    check(ratio <= NOISE_RATIO, f"{name}: the card's bf16 is {ratio:.3f}x "
          f"as far from f32 as the CPU's (limit {NOISE_RATIO})")
    return err, bad, ratio


def phase_moe_cpu_vs_gpu(steps=16, batch=2, prompt=64):
    """The smoke twins of llama4-scout (top-1, a shared expert), dbrx
    (top-2) and jamba (hybrid: attention, mamba, MoE) in f32 and bf16: the
    same weights through the plain versions on the CPU and the kernels on
    the GPU. Prefill logits, 16 greedy decode steps (f32 tokens equal,
    bf16 teacher-forced), the cache after them (k/v, and jamba's h and
    conv), each within LM_TOL elementwise (tol + tol·|want|); jamba in
    bf16 by the noise rule against an f32 run of the same weights on the
    CPU (its bf16 noise passes 2e-2 in a few elements, as the reference's
    own bf16 does against its f32). Every MoE call's routing is held to
    the CPU's on the same input (tie rule)."""
    import dataclasses
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models import build
    from repro_torch.models.params import init_params
    from repro_torch.models.steps import init_cache, make_prefill_step
    rng = np.random.default_rng(SEED + 22)
    total = dict(routes=0, ties=0, faults=0)
    for arch in MOE_TWINS:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(smoke_config(arch), dtype=dtype,
                                      param_dtype=dtype)
            mdl, tol = build(cfg), LM_TOL[dtype]
            p_cpu = init_params(mdl.param_tree, SEED, "cpu")
            runs = {"cpu": (mdl, p_cpu), "gpu": (mdl, _to(p_cpu, "cuda"))}
            if dtype == "bfloat16" and cfg.family == "hybrid":
                runs["f32"] = (build(dataclasses.replace(
                    cfg, dtype="float32", param_dtype="float32")),
                    _cast(p_cpu, torch.float32))
            toks = rng.integers(0, cfg.vocab_size, (batch, prompt))
            logits = {k: [] for k in runs}
            caches = {}
            feed = torch.zeros((batch, 1), dtype=torch.int32)
            with _moe_inputs() as rec:
                for key, (m, p) in runs.items():
                    dev = "cuda" if key == "gpu" else "cpu"
                    logits[key].append(make_prefill_step(m)(
                        p, {"tokens": torch.tensor(toks, device=dev)}))
                    caches[key] = init_cache(m, batch, steps, device=dev)
                cur = {k: feed for k in runs}
                for i in range(steps):
                    for key, (m, p) in runs.items():
                        dev = "cuda" if key == "gpu" else "cpu"
                        lg, caches[key] = m.decode(p, caches[key],
                                                   cur[key].to(dev), i)
                        logits[key].append(lg[:, -1])
                    t_cpu = logits["cpu"][-1].argmax(-1).to(torch.int32)
                    cur = {k: t_cpu[:, None] for k in runs}
                    if dtype == "float32":  # each feeds itself
                        cur["gpu"] = logits["gpu"][-1].argmax(-1).to(
                            torch.int32)[:, None]
                        check(torch.equal(cur["gpu"].cpu(), cur["cpu"]),
                              f"{arch} f32 decode step {i}: tokens differ")
            routes, ties, faults, dropped = _routing_vs_cpu(
                [c for c in rec.calls if c[1].is_cuda])
            check(faults == 0, f"{arch} {dtype}: {faults} tokens routed to "
                  f"other experts on the card without a tie")
            anchor = "f32" in runs
            res = {}
            for what, sel in (("prefill", lambda x: x[0]),
                              ("decode", lambda x: x[1:])):
                res[what] = _hold(
                    f"{arch} {dtype} {what} logits", sel(logits["gpu"]),
                    sel(logits["cpu"]), tol,
                    sel(logits["f32"]) if anchor else None)
            res["cache"] = _hold(
                f"{arch} {dtype} cache", _leaves(caches["gpu"]),
                _leaves(caches["cpu"]), tol,
                _leaves(caches["f32"]) if anchor else None)
            for key, n in (("routes", routes), ("ties", ties),
                           ("faults", faults)):
                total[key] += n
            say("moe-cpu-vs-gpu", model=cfg.name, dtype=dtype,
                layers=cfg.num_layers, batch=batch, prompt=prompt,
                decode_steps=steps, tol=tol,
                rule="noise" if anchor else "elementwise",
                **{f"{w}_max_abs_err": f"{r[0]:.3e}" for w, r in res.items()},
                **{f"{w}_outside_tol": r[1] for w, r in res.items()},
                **({f"{w}_noise_ratio": f"{r[2]:.4f}"
                    for w, r in res.items()} if anchor else {}),
                moe_calls=sum(c[1].is_cuda for c in rec.calls),
                routes=routes, dropped_routes=dropped, routing_ties=ties,
                routing_faults=faults,
                tokens_equal=dtype == "float32" or "teacher-forced")
    say("moe-cpu-vs-gpu", **total)
    return total


def _cast(tree, dtype):
    """Every bf16 leaf of a tree cast to `dtype` (exact for f32)."""
    import torch
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.dtype == torch.bfloat16 else tree


class _annotated:
    """Within the block each (module, function name, label) runs inside a
    `torch.profiler.record_function` range of its label, so a profile
    gives the device time of the kernels launched inside it."""

    def __init__(self, targets):
        self.targets = targets

    def __enter__(self):
        import torch
        self.saved = []
        for mod, name, label in self.targets:
            fn = getattr(mod, name)

            def wrapped(*a, _fn=fn, _label=label, **k):
                with torch.profiler.record_function(_label):
                    return _fn(*a, **k)

            setattr(mod, name, wrapped)
            self.saved.append((mod, name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def _range_shares(prof, labels, busy_ms):
    """Device time (ms, share of busy) inside each `record_function`
    label: the time the device spent on operations within the device-side
    spans of its calls (a span runs from the call's first operation to its
    last, so in a host-bound window it also covers idle time, which is
    left out). "not measured" where the profile gives none."""
    import bisect
    import torch
    spans = {label: [] for label in labels}
    ops = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        r = (ev.time_range.start, ev.time_range.end)
        if ev.name in spans:
            spans[ev.name].append(r)
        elif not ev.is_user_annotation:
            ops.append(r)
    ops.sort()
    starts = [a for a, _ in ops]
    ms, out = {}, {}
    for label in labels:
        us = 0.0
        for a, b in spans[label]:
            for s0, s1 in ops[bisect.bisect_left(starts, a):
                              bisect.bisect_left(starts, b)]:
                us += min(s1, b) - s0
        ms[label] = us / 1e3
        out[f"{label}_ms"] = f"{ms[label]:.3f}" if us else "not measured"
        out[f"{label}_share"] = (f"{ms[label] / busy_ms:.4f}"
                                 if us and busy_ms else "not measured")
    return out, ms


def _profiled(tag, step, fn, cfg):
    """`fn` under torch.profiler with the mamba and MoE functions
    annotated: the device-time summary, and the shares of the mamba scan
    (`_discretize` and `_scan`), the whole mamba blocks, the MoE layers,
    their routing and their einsums (the MoE layers less routing and, for
    llama4-scout, its shared expert's MLP)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import layers, mamba, moe
    targets = [(mamba, "mamba", "mamba.prefill"),
               (mamba, "mamba_decode", "mamba.decode"),
               (mamba, "_discretize", "mamba.discretize"),
               (mamba, "_scan", "mamba.scan"), (moe, "moe", "moe"),
               (moe, "route", "moe.route"), (layers, "mlp", "mlp")]
    labels = [label for _, _, label in targets]
    torch.cuda.synchronize()
    with _annotated(targets), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    rec = _device_time(prof, wall_s, {"flash_kernel": "flash_",
                                      "decode_kernel": "decode_split"},
                       ranges=labels)
    busy = (float(rec["device_busy_ms"])
            if rec["device_busy_ms"] != "not measured" else 0.0)
    shares, ms = _range_shares(prof, labels, busy)
    shared = ms.get("mlp", 0.0) if cfg.num_shared_experts else 0.0
    einsums = ms.get("moe", 0.0) - ms.get("moe.route", 0.0) - shared
    scan = ms.get("mamba.discretize", 0.0) + ms.get("mamba.scan", 0.0)
    say(f"{tag}-profile", step=step, **rec, **shares,
        moe_einsums_ms=f"{einsums:.3f}" if ms.get("moe") else "not measured",
        moe_einsums_share=(f"{einsums / busy:.4f}" if ms.get("moe") and busy
                           else "not measured"),
        mamba_scan_share=(f"{scan / busy:.4f}" if scan and busy
                          else "not measured"))


def _cut_lm_serving(tag, arch, num_layers, n_expected):
    """`arch` at full width cut to `num_layers` (bf16, random weights from
    seed 0 drawn on the card), through the serving entry points: prefill
    of 8 x 2,048 (one warm call, 3 timed), `decode_loop` at batch 64 over
    the last 128 positions of a 2,048-position cache, the kernels' launch
    counts, a teacher-forced decode of a 32-token prompt against a
    prefill without capacity drops, profiled windows, peak memory.
    Returns the launches of each kernel on this path."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import decode_loop
    from repro_torch.models import build
    from repro_torch.models.steps import (init_cache, init_serving_params,
                                          make_decode_step,
                                          make_prefill_step)
    from repro_torch.models.transformer import _layer_plan
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(arch), num_layers=num_layers)
    mdl = build(cfg)
    plan, n_scan = _layer_plan(cfg)
    n_attn = n_scan * sum(kind == "attn" for kind, _ in plan)
    n_moe = n_scan * sum(ffn == "moe" for _, ffn in plan)
    vp = cfg.padded_vocab()
    t = time.perf_counter()
    params = init_serving_params(mdl, SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(x.numel() for x in _leaves(params))
    weight_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    check(n_params == n_expected, f"{n_params} parameters != {n_expected}")
    rng = np.random.default_rng(SEED + 23)
    b, s = LM_PREFILL
    prompts = torch.tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                           dtype=torch.int32, device="cuda")
    prefill = make_prefill_step(mdl)

    with no_plain_versions(attention=True):
        logits = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        calls = 3               # 5 until phase 36 needed the time
        fk.flash_attention.launches = 0
        dk.decode_attention.launches = 0
        call_s = []
        for _ in range(calls):
            t = time.perf_counter()
            logits = prefill(params, {"tokens": prompts})
            torch.cuda.synchronize()
            call_s.append(time.perf_counter() - t)
        flash_launches = fk.flash_attention.launches
        check(flash_launches == n_attn * calls
              and dk.decode_attention.launches == 0,
              f"prefill launches: flash {flash_launches} != {n_attn} x "
              f"{calls}")
        check(logits.shape == (b, vp) and bool(torch.isfinite(logits).all()),
              "prefill logits not finite or misshapen")
        prefill_s = float(np.median(call_s))
        say(f"{tag}-prefill", model=cfg.name, layers=num_layers,
            plan="/".join(f"{k}+{f}" for k, f in plan), blocks=n_scan,
            attention_layers=n_attn, moe_layers=n_moe, d_model=cfg.d_model,
            heads=f"{cfg.num_heads}/{cfg.num_kv_heads}x{cfg.head_dim}",
            params=n_params, weight_bytes=weight_bytes,
            init_s=f"{init_s:.2f}", prompts=b, tokens_per_prompt=s,
            calls=calls, ms_per_call=[f"{x * 1e3:.3f}" for x in call_s],
            median_ms=f"{prefill_s * 1e3:.3f}",
            tokens_per_s=f"{b * s / prefill_s:.1f}",
            flash_launches=flash_launches,
            flash_per_call=flash_launches // calls)
        del logits

        # decode: batch 64, the last MOE_DECODE[2] positions of a 2,048
        # cache
        bd, cache_len, steps = MOE_DECODE
        start = cache_len - steps
        cache = init_cache(mdl, bd, cache_len)
        dec = make_decode_step(mdl)
        tok = torch.tensor(rng.integers(0, cfg.vocab_size, (bd, 1)),
                           dtype=torch.int32, device="cuda")
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(steps + 1)]
        fk.flash_attention.launches = 0
        dk.decode_attention.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        toks, cache = decode_loop(dec, params, cache, tok, start, steps,
                                  marks)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        decode_launches = dk.decode_attention.launches
        check(decode_launches == n_attn * steps
              and fk.flash_attention.launches == 0,
              f"decode launches {decode_launches} != {n_attn} x {steps}")
        check(toks.shape == (bd, steps)
              and bool(((toks >= 0) & (toks < vp)).all()),
              "decode tokens outside the padded vocab")
        step_ms = [a.elapsed_time(e) for a, e in zip(marks, marks[1:])]
        bound_ms = weight_bytes / H100_BYTES_PER_S * 1e3
        say(f"{tag}-decode", model=cfg.name, batch=bd, cache_len=cache_len,
            positions=f"{start}..{cache_len - 1}", steps=steps,
            seconds=f"{seconds:.3f}",
            tokens_per_s=f"{steps * bd / seconds:.1f}",
            ms_per_step=f"{seconds / steps * 1e3:.4f}",
            device_ms_per_step=f"{sum(step_ms) / steps:.4f}",
            step_ms_median=f"{np.median(step_ms):.4f}",
            step_ms_p99=f"{np.percentile(step_ms, 99):.4f}",
            weight_read_bound_ms=f"{bound_ms:.4f}",
            bound_share=f"{bound_ms / (seconds / steps * 1e3):.4f}",
            decode_launches=decode_launches,
            launches_per_step=decode_launches // steps,
            distinct_tokens=int(toks.unique().numel()))
        del cache

        # teacher forcing: decode routes each token alone (C = 1, never a
        # drop), while a prefill of 32 tokens drops the routes past its
        # capacity; so decode is held to a prefill whose capacity factor
        # E / k gives every expert room for every token
        tf = MOE_TEACHER
        prompt = prompts[:, :tf]
        with _moe_inputs() as rec:
            prefill(params, {"tokens": prompt})
        # the first MoE layer's routing at full width, held to the CPU's
        routes, ties, faults, drops = _routing_vs_cpu(rec.calls[:1])
        check(faults == 0, f"{tag}: {faults} tokens routed to other experts "
              f"on the card than on the CPU without a tie")
        roomy = build(dataclasses.replace(
            cfg, moe_capacity_factor=cfg.num_experts
            / cfg.num_experts_per_tok))
        want = make_prefill_step(roomy)(params, {"tokens": prompt})
        cache = init_cache(mdl, b, tf)
        for i in range(tf):
            got, cache = mdl.decode(params, cache, prompt[:, i:i + 1], i)
        # the hybrid family is held to the norm of the difference: decode
        # and prefill round the mamba inputs to bf16 after products of
        # other shapes, and through 14 mamba layers that noise passes 2e-2
        # in some logits, as the reference's own bf16 forward leaves its
        # f32 one (tests/test_torch_lm.py::test_bf16_noise_premise); a
        # stale or missing state moves the logits by far more than 5e-2
        hybrid = cfg.family == "hybrid"
        tf_err = _within(f"{tag}-teacher-forced-{tf}", got[:, -1], want,
                         torch.bfloat16, norm=hybrid,
                         norm_tol=HYBRID_TF_NORM_TOL, elementwise=not hybrid,
                         prompts=b, first_moe_layer_routes=routes,
                         routing_ties=ties, dropped_routes=drops)
        agree = float((got[:, -1].argmax(-1) == want.argmax(-1)).float()
                      .mean())
        del cache, want, got

        # profiled windows: decode steps at the end of the context, then
        # one prefill
        cache = init_cache(mdl, bd, cache_len)
        window = MOE_WINDOW
        _profiled(tag, "decode", lambda: decode_loop(
            dec, params, cache, toks[:, -1:].contiguous(),
            cache_len - window, window), cfg)
        del cache
        _profiled(tag, "prefill",
                  lambda: prefill(params, {"tokens": prompts}), cfg)
    say(f"{tag}-serving", teacher_forced_tokens=tf,
        teacher_forced_max_abs_err=f"{tf_err:.3e}",
        teacher_forced_argmax_agree=f"{agree:.4f}",
        peak_memory_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    return {"flash_attention": flash_launches,
            "decode_attention": decode_launches}


def phase_hybrid_serving():
    """jamba-v0.1-52b at full width, 16 of its 32 layers (two whole
    periods of its 8-layer plan), then `serve --mode decode --smoke
    --arch jamba-v0.1-52b` through the CLI on the card."""
    import contextlib
    import io
    import torch
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.launch import serve
    out = _cut_lm_serving("hybrid", *HYBRID)
    buf = io.StringIO()
    dk.decode_attention.launches = 0
    with no_plain_versions(attention=True), contextlib.redirect_stdout(buf):
        run = serve.main(["--mode", "decode", "--smoke", "--arch", HYBRID[0],
                          "--steps", "16", "--batch", "4", "--cache-len",
                          "64"])
    torch.cuda.synchronize()
    check("16 steps x batch 4" in buf.getvalue() and run.step_ms,
          "serve --mode decode --smoke --arch jamba: no result")
    say("hybrid-serve-cli", arch=HYBRID[0], line=buf.getvalue().strip(),
        decode_attention_launches=dk.decode_attention.launches)
    check(dk.decode_attention.launches == 2 * 16,
          "serve --smoke jamba: decode_attention not launched 2 x 16 times")
    out["serve_cli_decode_attention"] = dk.decode_attention.launches
    return out


def phase_moe_serving():
    """llama4-scout-17b-a16e at full width, 12 of its 48 layers."""
    return _cut_lm_serving("moe", *MOE)


# ---------------------------------------------------------------------------
# phases 25-27: the audio and vlm families and the f8 KV cache
# ---------------------------------------------------------------------------

LAST_TWINS = ("whisper-tiny", "pixtral-12b", "qwen1.5-32b")
WHISPER = ("whisper-tiny", 56_640_000)          # arch, params (whole)
WHISPER_PREFILL = (16, 448)    # batch, prompt tokens (after 1,500 frames)
WHISPER_DECODE = (64, 448, 256)    # batch, cache positions, steps from 0
WHISPER_TEACHER = 32           # tokens of the teacher-forced check
PIXTRAL = ("pixtral-12b", 40, 12_247_782_400)   # arch, layers (all), params
VLM_PREFILL = (8, 1024)        # prompts x text tokens after 1,024 images
QWEN = ("qwen1.5-32b", 24, 14_172_124_160)      # arch, layers of 64, params
QWEN_DECODE = (32, 2048, 128)  # batch, cache positions, steps (the last
                               # 128; 256 until phase 36 needed the time)
DENSE_WINDOW = 8               # decode steps of a profiled window
# (value, e4m3fn byte) as XLA casts f32 (tests/test_torch_lm_layers.py
# F8_EDGES): ±448, the 464 tie, past it, ±inf, subnormals, NaN
F8_EDGES = [(0.0, 0x00), (-0.0, 0x80), (448.0, 0x7E), (-448.0, 0xFE),
            (456.0, 0x7E), (464.0, 0x7E), (-464.0, 0xFE), (464.1, 0x7F),
            (465.0, 0x7F), (-465.0, 0xFF), (480.0, 0x7F), (1e6, 0x7F),
            (-1e6, 0xFF), (float("inf"), 0x7F), (float("-inf"), 0xFF),
            (2.0 ** -10, 0x00), (3 * 2.0 ** -10, 0x02),
            (-3 * 2.0 ** -10, 0x82), (2.0 ** -9, 0x01), (2.0 ** -6, 0x08),
            (1.0625, 0x38), (1.1875, 0x3A), (float("nan"), 0x7F),
            (-float("nan"), 0xFF)]


def _twin_batch(cfg, toks, rng, device):
    """A prefill batch of `toks` with the family's extra input (seeded f32
    `frames` or `img_embeds`), on `device`."""
    import torch
    batch = {"tokens": torch.tensor(toks, dtype=torch.int32, device=device)}
    b = toks.shape[0]
    if cfg.family == "audio":
        batch["frames"] = rng((b, cfg.encoder_seq_len, cfg.d_model))
    if cfg.family == "vlm":
        batch["img_embeds"] = rng((b, cfg.num_image_tokens, cfg.d_model))
    return {k: v.to(device) for k, v in batch.items()}


def _f8_kernel_checks():
    """`decode_attention` on an f8 cache: against its plain version, and
    bit for bit the kernel on the dequantized cache (the same split plan),
    at qwen1.5-32b's heads, at group 1 hd 64 (whisper's self and cross
    caches), across split edges, head dims, strided views, an f32 q (the
    CUDA-core kernel) and rows past cache_index that hold NaN; then timed
    at qwen1.5-32b's decode shape. The cast's bytes on the card are XLA's
    on the edge values and the CPU's on 10^5 seeded values. Returns the
    f8 shape's record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.layers import to_cache_dtype
    f8, bf16, f32 = torch.float8_e4m3fn, torch.bfloat16, torch.float32
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    x = torch.tensor([v for v, _ in F8_EDGES], dtype=f32, device=dev)
    got = to_cache_dtype(x, f8).view(torch.uint8).cpu().tolist()
    check(got == [b for _, b in F8_EDGES],
          f"f8 cast on the card: {[hex(v) for v in got]}")
    rng = np.random.default_rng(SEED + 25)
    xs = (np.sign(rng.normal(size=100_000))
          * 2.0 ** rng.uniform(-14, 10, 100_000)).astype(np.float32)
    for dt in (f32, bf16):
        on_card = to_cache_dtype(torch.tensor(xs, device=dev).to(dt), f8)
        on_cpu = to_cache_dtype(torch.tensor(xs).to(dt), f8)
        check(torch.equal(on_card.view(torch.uint8).cpu(),
                          on_cpu.view(torch.uint8)),
              f"f8 cast from {dt}: card and CPU bytes differ")
    saturated = x.to(f8).view(torch.uint8).cpu().tolist()
    say("f8-cast", edges=len(F8_EDGES), seeded=len(xs), equal_xla=True,
        torch_cuda_cast_differs=saturated != got)

    def cache(shape):
        return to_cache_dtype(
            4 * torch.randn(shape, generator=gen, device=dev), f8)

    errs = []
    # (b, S, nq, nkv, hd, cache_index, q dtype, make)
    cases = [(32, 2048, 40, 40, 128, i, bf16, "") for i in (0, 63, 64, 2047)]
    cases += [(64, 448, 6, 6, 64, 255, bf16, ""),        # whisper's self
              (64, 1500, 6, 6, 64, 1499, bf16, ""),      # ... and cross
              (8, 2048, 40, 40, 128, 1535, bf16, ""),    # several splits
              (8, 1024, 32, 8, 128, 1000, bf16, ""),     # group 4
              (8, 777, 32, 2, 64, 776, bf16, ""),        # group 16
              (4, 300, 8, 8, 16, 299, bf16, ""),
              (4, 300, 8, 4, 32, 130, bf16, ""),
              (16, 1024, 40, 40, 128, 700, bf16, "strided"),
              (16, 1024, 6, 6, 64, 1000, bf16, "nan"),
              (4, 600, 40, 40, 128, 555, f32, ""),
              (4, 600, 6, 6, 64, 599, f32, ""),
              (2, 50, 4, 2, 16, 49, f32, ""),
              (2, 70, 4, 4, 32, 69, f32, "")]
    for b, S, nq, nkv, hd, idx, dt, make in cases:
        q = torch.randn((b, nkv, nq // nkv, hd), generator=gen,
                        device=dev).to(dt)
        if make == "strided":
            K, V = cache((b, S, 2 * nkv, hd)).split(nkv, dim=2)
        else:
            K, V = cache((b, S, nkv, hd)), cache((b, S, nkv, hd))
        got = dk.decode_attention(q, K, V, idx)
        if make == "nan":               # e4m3's NaN in every row past idx
            Kn, Vn = K.clone(), V.clone()
            Kn.view(torch.uint8)[:, idx + 1:] = 0x7F
            Vn.view(torch.uint8)[:, idx + 1:] = 0xFF
            check(torch.equal(dk.decode_attention(q, Kn, Vn, idx), got),
                  "decode f8: NaN past cache_index changed the output")
        deq = dk.decode_attention(q, K.to(dt), V.to(dt), idx)
        name = (f"decode-f8-{b}x{S}x{nq}/{nkv}x{hd}@{idx}-"
                f"{str(dt).replace('torch.', '')}" + (f"-{make}" if make
                                                      else ""))
        check(torch.equal(got, deq), f"{name}: not bit for bit the kernel "
              f"on the dequantized cache")
        errs.append(_within(name, got, decode_attention_ref(q, K, V, idx),
                            dt, norm=True,
                            splits=dk.split_plan(idx + 1, b * nkv)[0]
                            if dt == bf16 else 1, bit_equal_dequantized=True))

    # timed at qwen1.5-32b's decode (b 32, S 2,048, 40/40 heads of 128)
    b, S, _ = QWEN_DECODE
    nq = nkv = 40
    hd, idx = 128, S - 1
    q = torch.randn((b, nkv, 1, hd), generator=gen, device=dev).to(bf16)
    K, V = cache((b, S, nkv, hd)), cache((b, S, nkv, hd))
    Kb, Vb = K.to(bf16), V.to(bf16)
    mask = torch.ones(1, 1, 1, S, dtype=torch.bool, device=dev)
    mask[..., idx + 1:] = False

    def library():                      # dequantize, then SDPA
        return F.scaled_dot_product_attention(
            q.reshape(b, 1, nq, hd).transpose(1, 2),
            K.to(bf16).transpose(1, 2), V.to(bf16).transpose(1, 2),
            attn_mask=mask)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = _events_ms(lambda: dk.decode_attention(q, K, V, idx), 20, flush)
    bf16_ms = _events_ms(lambda: dk.decode_attention(q, Kb, Vb, idx), 20,
                         flush)
    plain_ms = _events_ms(lambda: decode_attention_ref(q, K, V, idx), 5,
                          flush)
    library_ms = _events_ms(library, 20, flush)
    cost = dk.decode_attention_cost(b, nkv, nq // nkv, hd, idx + 1, 2,
                                    1)                   # 1 B a k/v
    bound_ms, bound_by = _bound(cost, H100_BF16_FLOPS)
    rec = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by, bf16_cache_ms=bf16_ms,
               max_abs_err=max(errs), cases=len(errs),
               shape=f"b {b}, S {S}, cache_index {idx}, {nq}/{nkv} heads, "
                     f"hd {hd}, f8 e4m3fn cache, bf16 q")
    say("lm-kernel-time", kernel="decode_attention_f8", shape=rec["shape"],
        bytes=cost.bytes, flops=cost.flops, ms=f"{ms:.5f}",
        bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
        bf16_cache_ms=f"{bf16_ms:.5f}", plain_ms=f"{plain_ms:.5f}",
        library_ms=f"{library_ms:.5f}",
        library="cache .to(bfloat16), then SDPA (length mask)",
        roofline_share=f"{bound_ms / ms:.4f}")
    return rec


def _time_last_shapes():
    """`flash_attention` at whisper-tiny's prefill (b 16, s 448, 6/6
    heads of 64) and pixtral-12b's (b 8, s 2,048, 32/8 of 128), and
    `decode_attention` at whisper's cross-attention (b 64, 1,500 rows,
    6/6 of 64), each beside its bound, its plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    bf16 = torch.bfloat16

    def card(shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    recs = {}
    for name, (b, s, nq, nkv, hd) in (
            ("flash_attention_whisper", (16, 448, 6, 6, 64)),
            ("flash_attention_pixtral", (8, 2048, 32, 8, 128))):
        q, k, v = (card((b, s, h, hd)) for h in (nq, nkv, nkv))
        got = fk.flash_attention(q, k, v)
        plain = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2)).transpose(1, 2)
        err = _within(f"flash-{b}x{s}x{nq}/{nkv}x{hd}", got, plain, bf16,
                      norm=True)
        recs[name] = dict(
            ms=_events_ms(lambda: fk.flash_attention(q, k, v), 20, flush),
            plain_ms=_events_ms(lambda: flash_attention_ref(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
                5, flush),
            library_ms=_events_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True), 20, flush),
            cost=fk.flash_attention_cost(b, s, nq, nkv, hd, 2),
            max_abs_err=err,
            shape=f"b {b}, s {s}, {nq}/{nkv} heads, hd {hd}")
    b, S, nq, nkv, hd = 64, 1500, 6, 6, 64
    q = card((b, nkv, 1, hd))
    K, V = card((b, S, nkv, hd)), card((b, S, nkv, hd))
    err = _within(f"decode-{b}x{S}x{nq}/{nkv}x{hd}@{S - 1}-cross",
                  dk.decode_attention(q, K, V, S - 1),
                  decode_attention_ref(q, K, V, S - 1), bf16, norm=True)
    recs["decode_attention_whisper_cross"] = dict(
        ms=_events_ms(lambda: dk.decode_attention(q, K, V, S - 1), 20,
                      flush),
        plain_ms=_events_ms(lambda: decode_attention_ref(q, K, V, S - 1), 5,
                            flush),
        library_ms=_events_ms(lambda: F.scaled_dot_product_attention(
            q.reshape(b, 1, nq, hd).transpose(1, 2), K.transpose(1, 2),
            V.transpose(1, 2)), 20, flush),
        cost=dk.decode_attention_cost(b, nkv, nq // nkv, hd, S, 2, 2),
        max_abs_err=err,
        shape=f"b {b}, S {S}, cache_index {S - 1}, {nq}/{nkv} heads, "
              f"hd {hd}")
    for name, r in recs.items():
        r["bound_ms"], r["bound_by"] = _bound(r.pop("cost"), H100_BF16_FLOPS)
        say("lm-kernel-time", kernel=name, shape=r["shape"],
            ms=f"{r['ms']:.5f}", bound_ms=f"{r['bound_ms']:.5f}",
            bound_by=r["bound_by"], plain_ms=f"{r['plain_ms']:.5f}",
            library_ms=f"{r['library_ms']:.5f}",
            roofline_share=f"{r['bound_ms'] / r['ms']:.4f}")
    return recs


def phase_last_cpu_vs_gpu(steps=16, batch=2, prompt=64):
    """The smoke twins of whisper-tiny (with `frames`), pixtral-12b (with
    `img_embeds`) and qwen1.5-32b (its f8 cache) in f32 and bf16: the same
    weights through the plain versions on the CPU and the kernels on the
    GPU. Prefill logits, 16 greedy decode steps (f32 tokens equal, bf16
    teacher-forced), the cache after them, each within LM_TOL
    elementwise; qwen1.5's f32 f8 cache bytes equal, its bf16 twin by the
    noise rule against an f32 CPU run (k and v a bf16 ulp apart land on
    neighbouring e4m3 values, as between the two packages on the CPU:
    tests/test_torch_lm.py NOISY). Then the f8 path of `decode_attention`
    (`_f8_kernel_checks`) and the new shapes' timings. Returns the
    kernel records."""
    import dataclasses
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models import build
    from repro_torch.models.params import init_params
    from repro_torch.models.steps import init_cache, make_prefill_step
    rng = np.random.default_rng(SEED + 25)

    def draw(shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32)

    for arch in LAST_TWINS:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(smoke_config(arch), dtype=dtype,
                                      param_dtype=dtype)
            mdl, tol = build(cfg), LM_TOL[dtype]
            f8 = cfg.cache_dtype == "float8_e4m3fn"
            p_cpu = init_params(mdl.param_tree, SEED, "cpu")
            runs = {"cpu": (mdl, p_cpu), "gpu": (mdl, _to(p_cpu, "cuda"))}
            if dtype == "bfloat16" and f8:
                runs["f32"] = (build(dataclasses.replace(
                    cfg, dtype="float32", param_dtype="float32")),
                    _cast(p_cpu, torch.float32))
            toks = rng.integers(0, cfg.vocab_size, (batch, prompt))
            batch_cpu = _twin_batch(cfg, toks, draw, "cpu")
            logits = {k: [] for k in runs}
            caches = {}
            for key, (m, p) in runs.items():
                dev = "cuda" if key == "gpu" else "cpu"
                logits[key].append(make_prefill_step(m)(
                    p, {k: v.to(dev) for k, v in batch_cpu.items()}))
                caches[key] = init_cache(m, batch, steps, device=dev)
            feed = torch.zeros((batch, 1), dtype=torch.int32)
            cur = {k: feed for k in runs}
            for i in range(steps):
                for key, (m, p) in runs.items():
                    dev = "cuda" if key == "gpu" else "cpu"
                    lg, caches[key] = m.decode(p, caches[key],
                                               cur[key].to(dev), i)
                    logits[key].append(lg[:, -1])
                t_cpu = logits["cpu"][-1].argmax(-1).to(torch.int32)
                cur = {k: t_cpu[:, None] for k in runs}
                if dtype == "float32":      # each feeds itself
                    cur["gpu"] = logits["gpu"][-1].argmax(-1).to(
                        torch.int32)[:, None]
                    check(torch.equal(cur["gpu"].cpu(), cur["cpu"]),
                          f"{arch} f32 decode step {i}: tokens differ")
            anchor = "f32" in runs
            res = {}
            for what, sel in (("prefill", lambda x: x[0]),
                              ("decode", lambda x: x[1:])):
                res[what] = _hold(
                    f"{arch} {dtype} {what} logits", sel(logits["gpu"]),
                    sel(logits["cpu"]), tol,
                    sel(logits["f32"]) if anchor else None)
            # the f8 leaves of an f32 twin by their bytes below, the rest
            # (and a noisy twin's all) by LM_TOL or the noise rule
            held = [i for i, g in enumerate(_leaves(caches["gpu"]))
                    if anchor or g.dtype != torch.float8_e4m3fn]
            if held:
                res["cache"] = _hold(
                    f"{arch} {dtype} cache",
                    *[[_leaves(caches[k])[i] for i in held] for k in
                      ("gpu", "cpu")], tol,
                    [_leaves(caches["f32"])[i] for i in held]
                    if anchor else None)
            f8_bytes = "no f8 cache"
            if f8:
                f8_bytes = _f8_bytes_vs_cpu(arch, dtype, caches, anchor)
            say("last-cpu-vs-gpu", model=cfg.name, family=cfg.family,
                dtype=dtype, layers=cfg.num_layers, batch=batch,
                prompt=prompt, decode_steps=steps, tol=tol,
                cache_dtype=cfg.cache_dtype,
                rule="noise" if anchor else "elementwise",
                **{f"{w}_max_abs_err": f"{r[0]:.3e}" for w, r in res.items()},
                **{f"{w}_outside_tol": r[1] for w, r in res.items()},
                **({f"{w}_noise_ratio": f"{r[2]:.4f}"
                    for w, r in res.items()} if anchor else {}),
                f8_cache_bytes=f8_bytes,
                tokens_equal=dtype == "float32" or "teacher-forced")
    recs = {"decode_attention_f8": _f8_kernel_checks()}
    recs.update(_time_last_shapes())
    return recs


def _f8_bytes_vs_cpu(arch, dtype, caches, noisy):
    """The f8 leaves (k and v) of the card's cache against the CPU's, byte
    for byte: an f32 twin's must be equal but where the two codes are
    neighbours (a k or v within the f32 rounding of the two devices'
    products of an e4m3 rounding midpoint: counted, and reported); a
    bf16 twin's (held by the noise rule) are counted only."""
    import torch
    pairs = [(g, c) for g, c in zip(_leaves(caches["gpu"]),
                                    _leaves(caches["cpu"]))
             if g.dtype == torch.float8_e4m3fn]
    check(len(pairs) == 2, f"{arch}: {len(pairs)} f8 cache leaves")
    differ = far = 0
    for g, c in pairs:
        gb = g.view(torch.uint8).cpu().to(torch.int16)
        cb = c.view(torch.uint8).to(torch.int16)
        d = gb != cb
        differ += int(d.sum())
        # neighbours: the same sign bit and codes one apart
        far += int((d & (((gb ^ cb) & 0x80).bool()
                         | ((gb - cb).abs() != 1))).sum())
    check(noisy or far == 0, f"{arch} {dtype}: {far} f8 cache bytes more "
          f"than one e4m3 step from the CPU's")
    total = sum(g.numel() for g, _ in pairs)
    return f"{differ} of {total} differ, {far} by more than one step"


def _window(tag, step, fn, **fields):
    """`fn` under torch.profiler: the device-time summary (busy share, the
    attention kernels' launches and shares)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    rec = _device_time(prof, wall_s, {"flash_kernel": "flash_",
                                      "decode_kernel": "decode_split"})
    say(f"{tag}-profile", step=step, **fields, **rec)
    return rec


def _decode_run(tag, mdl, params, cache, tok, start, steps, n_launches,
                bound_bytes):
    """`decode_loop` of `steps` from `start`; the launch count, tokens in
    the padded vocab, and the rates beside the byte bound. Returns
    (tokens, launches)."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import decode_loop
    from repro_torch.models.steps import make_decode_step
    bd = tok.shape[0]
    dec = make_decode_step(mdl)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    fk.flash_attention.launches = 0
    dk.decode_attention.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks, cache = decode_loop(dec, params, cache, tok, start, steps, marks)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = dk.decode_attention.launches
    check(launches == n_launches * steps and fk.flash_attention.launches == 0,
          f"{tag} decode launches {launches} != {n_launches} x {steps}")
    vp = mdl.cfg.padded_vocab()
    check(toks.shape == (bd, steps) and bool(((toks >= 0) & (toks < vp))
                                             .all()),
          f"{tag}: decode tokens outside the padded vocab")
    step_ms = [a.elapsed_time(e) for a, e in zip(marks, marks[1:])]
    bound_ms = bound_bytes / H100_BYTES_PER_S * 1e3
    say(f"{tag}-decode", model=mdl.cfg.name, batch=bd,
        positions=f"{start}..{start + steps - 1}", steps=steps,
        seconds=f"{seconds:.3f}",
        tokens_per_s=f"{steps * bd / seconds:.1f}",
        ms_per_step=f"{seconds / steps * 1e3:.4f}",
        device_ms_per_step=f"{sum(step_ms) / steps:.4f}",
        step_ms_median=f"{np.median(step_ms):.4f}",
        step_ms_p99=f"{np.percentile(step_ms, 99):.4f}",
        bound_bytes=bound_bytes, bound_ms=f"{bound_ms:.4f}",
        bound_share=f"{bound_ms / (seconds / steps * 1e3):.4f}",
        decode_launches=launches, launches_per_step=launches // steps,
        distinct_tokens=int(toks.unique().numel()))
    return toks, launches


def _prefill_run(tag, mdl, params, batch, n_flash, calls=5, **fields):
    """One warm prefill call, then `calls` timed ones; `flash_attention`
    `n_flash` a call and no `decode_attention`. Returns the launches."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models.steps import make_prefill_step
    prefill = make_prefill_step(mdl)
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    fk.flash_attention.launches = 0
    dk.decode_attention.launches = 0
    call_s = []
    for _ in range(calls):
        t = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t)
    launches = fk.flash_attention.launches
    check(launches == n_flash * calls and dk.decode_attention.launches == 0,
          f"{tag} prefill launches: flash {launches} != {n_flash} x {calls}")
    vp = mdl.cfg.padded_vocab()
    b = batch["tokens"].shape[0]
    check(logits.shape == (b, vp) and bool(torch.isfinite(logits).all()),
          f"{tag}: prefill logits not finite or misshapen")
    s = batch["tokens"].shape[1] + (batch["img_embeds"].shape[1]
                                    if "img_embeds" in batch else 0)
    med = float(np.median(call_s))
    say(f"{tag}-prefill", model=mdl.cfg.name, prompts=b, positions=s,
        calls=calls, ms_per_call=[f"{x * 1e3:.3f}" for x in call_s],
        median_ms=f"{med * 1e3:.3f}", tokens_per_s=f"{b * s / med:.1f}",
        flash_launches=launches, flash_per_call=launches // calls, **fields)
    return launches


def _weights(params):
    return (sum(x.numel() for x in _leaves(params)),
            sum(x.numel() * x.element_size() for x in _leaves(params)))


def phase_audio_serving():
    """whisper-tiny whole (4 encoder and 4 decoder layers, d 384, 6 heads
    of 64; bf16, random weights from seed 0 drawn on the card): prefill of
    16 x (1,500 frames, 448 tokens); a teacher-forced decode of the first
    32 prompt tokens against a cross cache filled from `encode_kv`, held
    to the forward's logits position by position (LM_TOL elementwise,
    LM_NORM_TOL in norm); 256 greedy steps at
    batch 64 over a cross cache filled the same way; the launches (4
    `flash_attention` a prefill call; 8 `decode_attention` a step, a self
    and a cross one a layer); profiled windows; peak memory; then
    `serve --mode decode --arch whisper-tiny` through the CLI."""
    import contextlib
    import io
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.launch import serve
    from repro_torch.models import build
    from repro_torch.models.steps import (init_cache, init_serving_params,
                                          make_decode_step,
                                          make_prefill_step)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    arch, n_expected = WHISPER
    cfg = get_config(arch)
    mdl = build(cfg)
    L = cfg.num_layers
    params = init_serving_params(mdl, SEED)
    n_params, weight_bytes = _weights(params)
    check(n_params == n_expected, f"{n_params} parameters != {n_expected}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    rng = np.random.default_rng(SEED + 26)

    def frames(b):
        return torch.randn((b, cfg.encoder_seq_len, cfg.d_model),
                           generator=gen, device="cuda")

    b, s = WHISPER_PREFILL
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                                    dtype=torch.int32, device="cuda"),
             "frames": frames(b)}
    with no_plain_versions(attention=True):
        flash = _prefill_run("audio", mdl, params, batch, L,
                             frames=cfg.encoder_seq_len, parameters=n_params,
                             weight_bytes=weight_bytes)
        _window("audio", "prefill", lambda: make_prefill_step(mdl)(
            params, batch), prompts=b, positions=s)

        # teacher forcing against the forward over the same frames
        tf = WHISPER_TEACHER
        prompt = batch["tokens"][:, :tf]
        want, _ = mdl.forward(params, {"tokens": prompt,
                                       "frames": batch["frames"]})
        cache = mdl.fill_cross_cache(params, init_cache(mdl, b, tf),
                                     batch["frames"])
        got = []
        for i in range(tf):
            lg, cache = mdl.decode(params, cache, prompt[:, i:i + 1], i)
            got.append(lg[:, -1])
        got = torch.stack(got, 1)
        tf_err = _within(f"audio-teacher-forced-{tf}", got, want,
                         torch.bfloat16, norm=True, prompts=b)
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        del cache, want, got

        bd, cache_len, steps = WHISPER_DECODE
        cache = mdl.fill_cross_cache(params, init_cache(mdl, bd, cache_len),
                                     frames(bd))
        tok = torch.tensor(rng.integers(0, cfg.vocab_size, (bd, 1)),
                           dtype=torch.int32, device="cuda")
        cache_bytes = sum(x.numel() * x.element_size()
                          for x in _leaves(cache))
        toks, launches = _decode_run(
            "audio", mdl, params, cache, tok, 0, steps, 2 * L,
            weight_bytes + cache_bytes)
        _window("audio", "decode", lambda: serve.decode_loop(
            make_decode_step(mdl), params, cache,
            toks[:, -1:].contiguous(), steps, DENSE_WINDOW),
            steps=DENSE_WINDOW, batch=bd)
        del cache
        buf = io.StringIO()
        dk.decode_attention.launches = 0
        with contextlib.redirect_stdout(buf):
            run = serve.main(["--mode", "decode", "--arch", arch, "--steps",
                              "16", "--batch", "4", "--cache-len", "64"])
        torch.cuda.synchronize()
    check("16 steps x batch 4" in buf.getvalue() and run.step_ms,
          "serve --mode decode --arch whisper-tiny: no result")
    cli = dk.decode_attention.launches
    check(cli == 2 * L * 16, f"serve --arch whisper-tiny: decode_attention "
          f"{cli} != {2 * L} x 16")
    say("audio-serving", teacher_forced_tokens=tf,
        teacher_forced_max_abs_err=f"{tf_err:.3e}",
        teacher_forced_argmax_agree=f"{agree:.4f}", cache_bytes=cache_bytes,
        serve_cli=buf.getvalue().strip(), serve_cli_decode_attention=cli,
        peak_memory_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    return {"flash_attention": flash, "decode_attention": launches,
            "serve_cli_decode_attention": cli}


def phase_vlm_f8_serving():
    """pixtral-12b at full width and depth (40 layers, 12.25 B, bf16,
    random weights from seed 0 drawn on the card): prefill of 8 x (1,024
    seeded image embeddings, 1,024 tokens), a teacher-forced decode of a
    32-token text prompt against prefill, 128 decode steps at batch 64
    over the last 128 positions of a 2,048 cache; then qwen1.5-32b at full
    width, 24 of its 64 layers (the depth whose weights and f8 cache at
    b 32 x 2,048 fit one card), 128 decode steps at batch 32 over the
    last 128 positions of a 2,048-position f8 cache. Each: tokens/s, ms a
    step against its weight-plus-cache byte bound, busy share, peak
    memory."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build
    from repro_torch.models.steps import (init_cache, init_serving_params,
                                          make_decode_step,
                                          make_prefill_step)
    out = {}
    rng = np.random.default_rng(SEED + 27)
    for tag, (arch, layers_, n_expected) in (("vlm", PIXTRAL),
                                             ("f8", QWEN)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=layers_)
        mdl = build(cfg)
        t = time.perf_counter()
        params = init_serving_params(mdl, SEED)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        n_params, weight_bytes = _weights(params)
        check(n_params == n_expected, f"{n_params} parameters != "
              f"{n_expected}")
        say(f"{tag}-model", model=cfg.name, layers=f"{layers_} of "
            f"{full.num_layers}", d_model=cfg.d_model,
            heads=f"{cfg.num_heads}/{cfg.num_kv_heads}x{cfg.head_dim}",
            cache_dtype=cfg.cache_dtype, params=n_params,
            weight_bytes=weight_bytes, init_s=f"{init_s:.2f}")
        rec = {}
        with no_plain_versions(attention=True):
            if cfg.family == "vlm":
                b, s = VLM_PREFILL
                gen = torch.Generator(device="cuda").manual_seed(SEED + 27)
                batch = {
                    "tokens": torch.tensor(
                        rng.integers(0, cfg.vocab_size, (b, s)),
                        dtype=torch.int32, device="cuda"),
                    "img_embeds": torch.randn(
                        (b, cfg.num_image_tokens, cfg.d_model),
                        generator=gen, device="cuda").to(torch.bfloat16)}
                rec["flash_attention"] = _prefill_run(
                    tag, mdl, params, batch, layers_,
                    image_tokens=cfg.num_image_tokens)
                _window(tag, "prefill", lambda: make_prefill_step(mdl)(
                    params, batch), prompts=b)
                del batch
                tf = MOE_TEACHER
                prompt = torch.tensor(
                    rng.integers(0, cfg.vocab_size, (LM_PREFILL[0], tf)),
                    dtype=torch.int32, device="cuda")
                want = make_prefill_step(mdl)(params, {"tokens": prompt})
                cache = init_cache(mdl, LM_PREFILL[0], tf)
                for i in range(tf):
                    got, cache = mdl.decode(params, cache,
                                            prompt[:, i:i + 1], i)
                rec["tf_err"] = _within(f"{tag}-teacher-forced-{tf}",
                                        got[:, -1], want, torch.bfloat16,
                                        prompts=LM_PREFILL[0])
                del cache, want, got
                bd, cache_len, steps = MOE_DECODE
            else:
                bd, cache_len, steps = QWEN_DECODE
            cache = init_cache(mdl, bd, cache_len)
            kind = cache["blocks"]["pos0"]["k"].dtype
            check(kind == torch.float8_e4m3fn or cfg.family == "vlm",
                  f"{tag}: the cache is {kind}")
            cache_bytes = sum(x.numel() * x.element_size()
                              for x in _leaves(cache))
            tok = torch.tensor(rng.integers(0, cfg.vocab_size, (bd, 1)),
                               dtype=torch.int32, device="cuda")
            start = cache_len - steps
            toks, rec["decode_attention"] = _decode_run(
                tag, mdl, params, cache, tok, start, steps, layers_,
                weight_bytes + cache_bytes)
            if cfg.cache_dtype == "float8_e4m3fn":   # the written rows
                rows = cache["blocks"]["pos0"]["k"][0, :, start:].float()
                check(bool(torch.isfinite(rows).all())
                      and bool((rows != 0).any()),
                      f"{tag}: f8 cache rows not finite or never written")
                del rows
            _window(tag, "decode", lambda: serve.decode_loop(
                make_decode_step(mdl), params, cache,
                toks[:, -1:].contiguous(), cache_len - DENSE_WINDOW,
                DENSE_WINDOW), steps=DENSE_WINDOW, batch=bd)
            del cache, toks
        say(f"{tag}-serving", model=cfg.name, cache_bytes=cache_bytes,
            peak_memory_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
            **({"teacher_forced_max_abs_err": f"{rec['tf_err']:.3e}"}
               if "tf_err" in rec else {}))
        del params
        out[arch] = rec
    return out



# the training slice: phases 28-30
TRAIN_ARCH = "tinyllama-1.1b"  # the training path's model, full width and depth
TRAIN_BATCH = (8, 2048)        # sequences x tokens a step (its context)
TRAIN_STEPS = 5                # timed steps after one warm-up step
LSE_TOL = 1e-5                 # |lse − plain| ≤ 1e-5 + 1e-5·|plain|
# the head layouts (q heads / kv heads, head dim) of every registered
# config that has attention, as the port runs them (padded q heads are
# not run; qwen3-14b's and qwen1.5-32b's 48-head padding is run as well)
# the backward's timed shapes: tinyllama's training shape, and b 8 x 2,048
# at jamba's and pixtral's heads for hd 128
BWD_TIMED = {"tinyllama-1.1b": (8, 2048, 32, 4, 64),
             "hd128": (8, 2048, 32, 8, 128)}
BWD_HEADS = {"tinyllama-1.1b": (32, 4, 64), "granite-3-2b": (32, 8, 64),
             "qwen3-14b": (40, 8, 128), "qwen3-14b-padded": (48, 8, 128),
             "qwen1.5-32b": (40, 40, 128), "qwen1.5-32b-padded": (48, 48, 128),
             "llama4-scout-17b-a16e": (40, 8, 128), "dbrx-132b": (48, 8, 128),
             "jamba-v0.1-52b": (32, 8, 128), "pixtral-12b": (32, 8, 128),
             "whisper-tiny": (6, 6, 64), "smoke-hd16": (4, 2, 16),
             "smoke-hd32": (4, 2, 32)}


def _profiled_split(fn, calls, parts):
    """Device time a call of `fn` by kernel, from `calls` calls under
    torch.profiler: (split, names), where names lists the device
    operations whose name holds a fragment of `parts` and split maps each
    part to the ms a call of those holding its fragment ("not measured"
    where the profiler saw none). One PyTorch kernel is launched first in
    the window: a window holding only kernels launched through ctypes
    lost some of their records once the process had run a minute of
    device work outside the profiler, and kept them all with that launch
    first. In full runs of this script these windows (phases 28 and 31)
    still come back empty, with that launch or with host sleeps around
    the calls, while phase 32's window in the same process keeps its
    records; why is not known (PERF.md §7)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev_ops = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and any(m in e.key for m in parts.values())]
    names = [e.key for e in dev_ops]
    split = {part: (sum(e.self_device_time_total for e in dev_ops
                        if match in e.key) / (calls * 1e3)
                    if names else "not measured")
             for part, match in parts.items()}
    return split, names


def _grads_plain(q, k, v, do):
    """(dq, dk, dv) by autograd through the plain forward, model layout."""
    import torch
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    xs = [x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v)]
    out = flash_attention_ref(*xs)
    grads = torch.autograd.grad(out, xs, do.transpose(1, 2))
    return [g.transpose(1, 2) for g in grads]


def phase_flash_bwd_kernel():
    """Phase 28: the backward kernel against its plain version
    (`flash_attention_bwd_ref`) and against autograd through the plain
    forward on the card, at every registered config's head layout (b 2,
    ragged s 333, bf16; f32 at three of them), hd 16 and 32, lengths on
    either side of the 64-row tiles and s 1; the logsumexp of each forward
    kernel (f32 CUDA cores, bf16 mma.sync at hd 16/32, bf16 wgmma at hd
    64/128) against the plain one, its output bit for bit the serving
    call's; two calls bit for bit equal; then timed at both `BWD_TIMED`
    shapes beside its bound, the plain version and SDPA's backward; at
    each, fails unless the C library counts the call as one that launched
    the wgmma kernels, and splits the device time of three profiled calls
    between D, dK/dV and dQ by kernel name (`_profiled_split`; "not
    measured" where the profiler sees no device work).
    Returns the kernel record (tinyllama's shape at its top level)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    bf16, f32 = torch.bfloat16, torch.float32

    def card(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def heads_first(*xs):
        return [x.transpose(1, 2) for x in xs]

    cases = [((2, 333, nq, nkv, hd), bf16, name)
             for name, (nq, nkv, hd) in BWD_HEADS.items()]
    cases += [((2, 333, *BWD_HEADS[n]), f32, n)
              for n in ("tinyllama-1.1b", "jamba-v0.1-52b", "smoke-hd16")]
    cases += [((2, s, 32, 4, 64), bf16, "tile-edge") for s in (1, 63, 64, 65,
                                                             127, 129)]
    cases += [((1, s, 40, 8, 128), bf16, "tile-edge") for s in (31, 33, 64)]
    cases += [((2, 100, 4, 2, hd), f32, "tile-edge") for hd in (32, 128)]
    cases += [((2, 2048, 32, 4, 64), bf16, "tinyllama-s2048")]
    errs, lse_err = [], 0.0
    for (b, s, nq, nkv, hd), dt, name in cases:
        q, k, v = (card((b, s, h, hd), dt) for h in (nq, nkv, nkv))
        do = card((b, s, nq, hd), dt)
        lse = torch.empty((b, nq, s), dtype=f32, device=dev)
        out = fk.flash_attention(q, k, v, lse=lse)
        check(torch.equal(out, fk.flash_attention(q, k, v)),
              f"flash-bwd {name}: the forward's output changed with lse")
        _, want_lse = flash_attention_fwd_ref(*heads_first(q, k, v))
        e = float((lse - want_lse).abs().max())
        check(bool(((lse - want_lse).abs()
                    <= LSE_TOL + LSE_TOL * want_lse.abs()).all()),
              f"flash-bwd {name}: lse off by {e:.3e}")
        lse_err = max(lse_err, e)
        got = fk.flash_attention_bwd(q, k, v, out, lse, do)
        plain = [g.transpose(1, 2) for g in flash_attention_bwd_ref(
            *heads_first(q, k, v, out), lse, do.transpose(1, 2))]
        auto = _grads_plain(q, k, v, do) if s <= 512 else None
        tag = f"flash-bwd-{name}-{b}x{s}x{nq}/{nkv}x{hd}"
        for gname, g, w, a in zip(("dq", "dk", "dv"), got, plain,
                                  auto or (None,) * 3):
            # s = 1: dq and dk are 0 (P = 1, dS = dP − D = 0), held to
            # the elementwise limit alone
            norm = not (s == 1 and gname != "dv")
            errs.append(_within(f"{tag}-{gname}", g, w, dt, norm=norm,
                                elementwise=dt == f32 or not norm,
                                lse_err=f"{e:.2e}"))
            if a is not None:
                _within(f"{tag}-{gname}-vs-autograd", g, a, dt, norm=norm,
                        elementwise=dt == f32 or not norm)
    # two calls on the same inputs: bit for bit (no atomics)
    q, k, v = (card((2, 700, h, 64), bf16) for h in (32, 4, 4))
    do = card((2, 700, 32, 64), bf16)
    lse = torch.empty((2, 32, 700), dtype=f32, device=dev)
    out = fk.flash_attention(q, k, v, lse=lse)
    one = fk.flash_attention_bwd(q, k, v, out, lse, do)
    two = fk.flash_attention_bwd(q, k, v, out, lse, do)
    check(all(torch.equal(x, y) for x, y in zip(one, two)),
          "flash-bwd: two calls on the same inputs differ")

    # timed at each BWD_TIMED shape; a profiled call splits it by kernel
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    parts = {"D": "flash_bwd_dot_kernel", "dK/dV": "flash_bwd_dkdv",
             "dQ": "flash_bwd_dq"}
    timed = {}
    for label, (b, s, nq, nkv, hd) in BWD_TIMED.items():
        q, k, v = (card((b, s, h, hd), bf16) for h in (nq, nkv, nkv))
        do = card((b, s, nq, hd), bf16)
        lse = torch.empty((b, nq, s), dtype=f32, device=dev)
        out = fk.flash_attention(q, k, v, lse=lse)
        lib = [x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib, is_causal=True,
                                                 enable_gqa=True)
        ms = _events_ms(lambda: fk.flash_attention_bwd(q, k, v, out, lse, do),
                        20, flush)
        plain_ms = _events_ms(lambda: flash_attention_bwd_ref(
            *heads_first(q, k, v, out), lse, do.transpose(1, 2)), 5, flush)
        library_ms = _events_ms(lambda: torch.autograd.grad(
            lib_out, lib, do.transpose(1, 2), retain_graph=True), 20, flush)
        fwd_ms = _events_ms(lambda: fk.flash_attention(q, k, v, lse=lse), 20,
                            flush)
        del lib, lib_out
        # the route, by the C library's count of calls that launched the
        # wgmma kernels; then the time by kernel name in a profiled window
        calls = fk.flash_bwd_wgmma_calls()
        fk.flash_attention_bwd(q, k, v, out, lse, do)
        torch.cuda.synchronize()
        check(fk.flash_bwd_wgmma_calls() == calls + 1,
              f"flash-bwd {label}: bf16 at hd {hd} did not launch the "
              f"wgmma kernels")
        torch.cuda.empty_cache()
        split, names = _profiled_split(
            lambda: fk.flash_attention_bwd(q, k, v, out, lse, do), 3, parts)
        check(not names or (
              any("flash_bwd_dkdv_wgmma_kernel" in n for n in names)
              and any("flash_bwd_dq_wgmma_kernel" in n for n in names)
              and not any("flash_bwd_dkdv_kernel" in n
                          or "flash_bwd_dq_kernel" in n for n in names)),
              f"flash-bwd {label}: bf16 at hd {hd} ran other kernels than "
              f"the wgmma ones: {names}")
        cost = fk.flash_attention_bwd_cost(b, s, nq, nkv, hd, 2)
        bound_ms, bound_by = _bound(cost, H100_BF16_FLOPS)
        say("flash-bwd-time", shape=f"b {b}, s {s}, {nq}/{nkv} heads, "
            f"hd {hd}", bytes=cost.bytes, flops=cost.flops,
            peak="989e12 bf16 dense",
            ms=f"{ms:.5f}", bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
            plain_ms=f"{plain_ms:.5f}", library_ms=f"{library_ms:.5f}",
            forward_with_lse_ms=f"{fwd_ms:.5f}",
            roofline_share=f"{bound_ms / ms:.4f}",
            kernels=" | ".join(n.replace("(anonymous namespace)::", "")
                               .split("(")[0] for n in names),
            **{f"{part}_ms": t if isinstance(t, str) else f"{t:.5f}"
               for part, t in split.items()})
        timed[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            forward_with_lse_ms=fwd_ms, split_ms=split,
                            shape=[b, s, nq, nkv, hd])
        del q, k, v, do, lse, out
    say("flash-bwd", cases=len(cases), max_abs_err=f"{max(errs):.3e}",
        lse_max_abs_err=f"{lse_err:.3e}")
    return dict(timed[TRAIN_ARCH], max_abs_err=max(errs), cases=len(cases),
                lse_max_abs_err=lse_err, hd128=timed["hd128"])


TRAIN_TWINS = ("tinyllama-1.1b", "granite-3-2b", "qwen3-14b", "qwen1.5-32b",
               "llama4-scout-17b-a16e", "dbrx-132b", "jamba-v0.1-52b",
               "whisper-tiny", "pixtral-12b", "rwkv6-3b")
TRAIN_TOL = 1e-4               # f32: card against CPU, params, m, v, loss


def _train_batch(cfg, rng, b=2, s=32):
    """A seeded CPU training batch of the twin's family."""
    import torch
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
             "targets": rng.integers(0, cfg.vocab_size, (b, s))}
    batch = {k: torch.tensor(v, dtype=torch.int32) for k, v in batch.items()}
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.tensor(
            rng.normal(size=(b, cfg.num_image_tokens, cfg.d_model)),
            dtype=torch.float32)
    if cfg.family == "audio":
        batch["frames"] = torch.tensor(
            rng.normal(size=(b, cfg.encoder_seq_len, cfg.d_model)),
            dtype=torch.float32)
    return batch


def _state_to(state, device, dtype=None):
    """A copy of a train state on `device` (params requiring grad), its
    bf16 leaves cast to `dtype` where given."""
    import torch

    def put(x, leaf_grad):
        y = x.detach().to(device)
        if dtype is not None and y.dtype == torch.bfloat16:
            y = y.to(dtype)
        y = y.clone()
        return y.requires_grad_() if leaf_grad else y

    def walk(t, grad):
        if isinstance(t, dict):
            return {k: walk(v, grad) for k, v in t.items()}
        return put(t, grad)
    return {"params": walk(state["params"], True),
            "opt": walk(state["opt"], False), "step": walk(state["step"],
                                                          False)}


def phase_train_cpu_vs_gpu():
    """Phase 29: the smoke twins of every family in f32 and bf16, one
    `make_train_step` from the same state and batch on the CPU (plain
    versions) and on the card (kernels: the flash forward and backward,
    and for the rwkv6 twin `wkv6` and its backward): f32 loss, grad_norm,
    params, m and v within 1e-4; bf16 the scalars within 2e-2 and the
    gradient (m) by the noise rule against an f32 CPU step on the same
    weights. Then the F5 guard: `decode_attention` (serving only) raises
    under autograd on the card, and `wkv6` under autograd builds its
    `WKV6` node. Returns the backward kernels' launches over the twins."""
    import dataclasses
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.kernels.wkv6 import ops as wops
    from repro_torch.models import build
    from repro_torch.models.steps import init_train_state, make_train_step
    from repro_torch.optim import tree_leaves
    rng = np.random.default_rng(SEED + 29)
    dev = torch.device("cuda", 0)
    fk.flash_attention_bwd.launches = 0
    wk.wkv6_bwd.launches = 0
    for arch in TRAIN_TWINS:
        bwd = (wk.wkv6_bwd if smoke_config(arch).family == "ssm"
               else fk.flash_attention_bwd)
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(smoke_config(arch), dtype=dtype,
                                      param_dtype=dtype)
            mdl = build(cfg)
            state = init_train_state(mdl, SEED, device="cpu")
            batch = _train_batch(cfg, rng)
            runs = {"card": (_state_to(state, dev),
                             {k: v.to(dev) for k, v in batch.items()}, mdl)}
            if dtype == "bfloat16":
                cfg32 = dataclasses.replace(cfg, dtype="float32",
                                            param_dtype="float32")
                runs["f32"] = (_state_to(state, "cpu", torch.float32), batch,
                               build(cfg32))
            runs["cpu"] = (state, batch, mdl)
            out = {}
            for where, (st, bt, m) in runs.items():
                before = bwd.launches
                new, met = make_train_step(m)(st, bt)
                torch.cuda.synchronize()
                if where == "card":
                    check(bwd.launches > before,
                          f"train {arch}: no backward kernel launched")
                out[where] = (new, {k: float(v) for k, v in met.items()})
            (cn, cm), (gn, gm) = out["cpu"], out["card"]
            for key in ("loss", "nll", "aux", "grad_norm", "lr"):
                tol = TRAIN_TOL if dtype == "float32" else LM_TOL[dtype]
                check(np.isfinite(gm[key]) and abs(gm[key] - cm[key])
                      <= tol + tol * abs(cm[key]),
                      f"train {arch} {dtype}: {key} {gm[key]} vs {cm[key]}")
            fields = {}
            if dtype == "float32":
                for part in ("params", "m", "v"):
                    pick = ((lambda t: t["params"]) if part == "params"
                            else (lambda t, p=part: t["opt"][p]))
                    err, _, _ = _hold(f"train {arch} {part}",
                                      tree_leaves(pick(gn)),
                                      tree_leaves(pick(cn)), TRAIN_TOL)
                    fields[f"{part}_max_abs_err"] = f"{err:.3e}"
            else:
                anchor = out["f32"][0]["opt"]["m"]
                err, bad, ratio = _hold(
                    f"train {arch} m", tree_leaves(gn["opt"]["m"]),
                    tree_leaves(cn["opt"]["m"]), LM_TOL[dtype],
                    anchor=tree_leaves(anchor))
                fields.update(m_max_abs_err=f"{err:.3e}",
                              m_noise_ratio=f"{ratio:.3f}")
            say("train-cpu-vs-gpu", arch=arch, dtype=dtype,
                loss=f"{gm['loss']:.6f}", cpu_loss=f"{cm['loss']:.6f}",
                grad_norm=f"{gm['grad_norm']:.6f}",
                cpu_grad_norm=f"{cm['grad_norm']:.6f}", **fields)
    # F5: only decode_attention has no backward; it raises under autograd
    # on the card, and wkv6 builds its autograd node
    x = torch.randn(2, 1, 4, 16, device=dev, requires_grad=True)
    cache = torch.randn(2, 8, 2, 16, device=dev)
    try:
        dops.decode_attention(x, cache, cache, 7)
    except RuntimeError as e:
        check("decode_attention has no backward kernel" in str(e),
              f"decode_attention: {e}")
    else:
        raise SmokeFailure("decode_attention ran under autograd on the card")
    with torch.no_grad():
        dops.decode_attention(x, cache, cache, 7)
    xs = [torch.randn(1, 8, 2, 16, device=dev, requires_grad=True)
          for _ in range(4)]
    out = wops.wkv6(*xs, torch.randn(2, 16, device=dev))
    check(isinstance(out.grad_fn, wops.WKV6._backward_cls),
          f"wkv6 under autograd: grad_fn {out.grad_fn}")
    say("train-f5", raised="decode_attention", wkv6_grad_fn="WKV6",
        flash_attention_bwd_launches=fk.flash_attention_bwd.launches,
        wkv6_bwd_launches=wk.wkv6_bwd.launches)
    return {"flash_attention_bwd": fk.flash_attention_bwd.launches,
            "wkv6_bwd": wk.wkv6_bwd.launches}


def _layer0_attention_grads(mdl, params, batch, plain):
    """Gradients of layer 0's wq, wk and wv for the loss Σ y·dY of its
    attention sublayer on the batch's embeddings (dY seeded), through the
    kernels or, with `plain`, through `flash_attention_ref` on the card."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import layers
    from repro_torch.models.transformer import apply_norm
    cfg = mdl.cfg
    p = {k: v[0] for k, v in params["blocks"]["pos0"]["attn"].items()}
    x = layers.embed(params["tok"], batch["tokens"]).detach()
    h = apply_norm(cfg, {k: v[0].detach() for k, v in
                         params["blocks"]["pos0"]["ln1"].items()}, x)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    gen = torch.Generator(device=x.device).manual_seed(SEED + 30)
    dy = torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)
    real = ops.flash_attention
    if plain:
        ops.flash_attention = lambda q, k, v: flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2)).transpose(1, 2)
    try:
        y = layers.causal_attention(p, cfg, h, pos)
        leaves = [params["blocks"]["pos0"]["attn"][n] for n in
                  ("wq", "wk", "wv")]
        grads = torch.autograd.grad((y.float() * dy.float()).sum(), leaves)
    finally:
        ops.flash_attention = real
    return [g[0] for g in grads]


def phase_train_path():
    """Phase 30: tinyllama-1.1b trained at full width and depth on the
    card: `init_train_state` (bf16, seed 0), the synthetic TokenStream
    (vocab 32,000, batch 8, seq 2,048, seed 0), `make_train_step` at its
    defaults under remat "full", one warm-up step and 5 timed steps. Held:
    a finite loss every step; every leaf's gradient finite and not all
    zero (read off the first moment after the first step, m = 0.1·g);
    the flash forward twice and its backward once a layer a step; layer
    0's wq/wk/wv gradients against a recompute of that layer through
    `flash_attention_ref` on the card (bf16 noise, in norm). Printed: ms a
    step, tokens/s, peak memory, a profiled step's busy share and top
    device operations. Returns the launch counts of the run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import build
    from repro_torch.models.steps import init_train_state, make_train_step
    from repro_torch.optim import tree_leaves
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(TRAIN_ARCH)
    check(cfg.remat_policy == "full", f"{TRAIN_ARCH} remat {cfg.remat_policy}")
    mdl = build(cfg)
    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(mdl, SEED, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    b, s = TRAIN_BATCH
    ds = TokenStream(vocab_size=cfg.vocab_size, batch=b, seq_len=s, seed=SEED)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in ds.batch_at(i).items()}
               for i in range(TRAIN_STEPS + 2)]
    step = make_train_step(mdl)
    L = cfg.num_layers
    fk.flash_attention.launches = 0
    fk.flash_attention_bwd.launches = 0
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, met = step(state, batches[i])
        loss = float(met["loss"])               # synchronizes
        step_ms.append((time.perf_counter() - t) * 1e3)
        check(np.isfinite(loss), f"train step {i}: loss {loss}")
        losses.append(loss)
        if i == 0:                      # m = 0.1 · clipped g after step 1
            for (path, m) in _named_leaves(state["opt"]["m"]):
                check(bool(torch.isfinite(m).all()) and bool(m.any()),
                      f"train: gradient of {path} not finite or all zero")
    launches = {"flash_attention": fk.flash_attention.launches,
                "flash_attention_bwd": fk.flash_attention_bwd.launches}
    steps = TRAIN_STEPS + 1
    check(launches["flash_attention"] == 2 * L * steps
          and launches["flash_attention_bwd"] == L * steps,
          f"train: launches {launches} over {steps} steps of {L} layers")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timed = step_ms[1:]
    mean_ms = float(np.mean(timed))
    # layer 0's attention gradients against the plain attention, 2 rows
    sub = {k: v[:2] for k, v in batches[-1].items()}
    got = _layer0_attention_grads(mdl, state["params"], sub, plain=False)
    want = _layer0_attention_grads(mdl, state["params"], sub, plain=True)
    for name, g, w in zip(("wq", "wk", "wv"), got, want):
        _within(f"train-layer0-d{name}", g, w, torch.bfloat16, norm=True,
                elementwise=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, met = step(state, batches[-1])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    rec = _device_time(prof, wall_s, {"flash_fwd": "flash_wgmma",
                                      "flash_bwd": "flash_bwd"})
    say("train-path", arch=TRAIN_ARCH, params=n_params, layers=L,
        batch=f"{b}x{s}", remat=cfg.remat_policy, steps=TRAIN_STEPS,
        warmup_ms=f"{step_ms[0]:.1f}", ms_per_step=f"{mean_ms:.1f}",
        ms_steps=",".join(f"{x:.1f}" for x in timed),
        tokens_per_s=f"{b * s / mean_ms * 1e3:.0f}",
        peak_memory_gb=f"{peak_gb:.2f}",
        losses=",".join(f"{x:.4f}" for x in losses),
        flash_fwd_per_step=launches["flash_attention"] // steps,
        flash_bwd_per_step=launches["flash_attention_bwd"] // steps)
    say("train-path-profile", **rec)
    return dict(launches, ms_per_step=mean_ms,
                tokens_per_s=b * s / mean_ms * 1e3, peak_memory_gb=peak_gb,
                mdl=mdl, state=state)


# the ssm family's training and the launcher: phases 31-33
WKV_BWD_TOL = 5e-4             # f32 elementwise, tol + tol·|want|
SSM_TRAIN_LAYERS = 32          # rwkv6-3b trained at full depth (phase 32)
LAUNCH_SMOKE_STEPS = 100       # the preempted launcher run (phase 33b;
                               # cut from 300 for the time)
LAUNCH_FULL = (8, 2048, 4)     # batch, seq, steps of the full-size launch


def phase_wkv6_bwd_kernel():
    """Phase 31: `wkv6_bwd` against its plain version
    (`wkv6_chunked_bwd_ref`) on the card: head sizes 16, 32 and 64 at
    chunks 16, 32 and 64 on a ragged s, s below the chunk (1, 37, 63),
    decays at which the exponent clip binds, exponents planted at exactly
    ±40 (where the derivative of the clip is 1/2), and rwkv6-3b's training
    shape; every gradient (dr, dk, dv, dla, du) within 5e-4 elementwise
    and ‖err‖/‖want‖ ≤ 1e-5, and also against autograd through
    `wkv6_chunked_ref` wherever the clip is not at its bound (s ≤ 512);
    two calls bit for bit equal; then timed at rwkv6-3b's training shape
    beside its bound (operations, with the bytes bound beside it) and the
    plain version, and its time split between its three kernels
    (`_profiled_split`, else CUDA events around a -DWKV6_BWD_TRACE build).
    Returns its record."""
    import torch
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.kernels.wkv6.ref import (wkv6_chunked_bwd_ref,
                                              wkv6_chunked_ref)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    f32 = torch.float32
    names = ("dr", "dk", "dv", "dla", "du")

    def card(shape, decay):
        """r, k, v, la (−exp(N(−decay, 0.5)); None: la = −20 on the first
        two rows of every chunk of 32 and 0 elsewhere, so a = −40 and
        a_prev = −40 exactly), u (H, K) and do."""
        xs = [torch.randn(shape, generator=gen, device=dev) for _ in "rkv"]
        if decay is None:
            la = torch.zeros(shape, device=dev)
            la[:, 0::32] = -20.0
            la[:, 1::32] = -20.0
        else:
            la = -torch.exp(torch.randn(shape, generator=gen, device=dev)
                            * 0.5 - decay)
        return xs + [la, torch.randn(shape[2:], generator=gen, device=dev),
                     torch.randn(shape, generator=gen, device=dev)]

    cases = [((2, 100, 3, K), c, 1.0) for c in wk.CHUNKS
             for K in wk.HEAD_SIZES]
    cases += [((2, s, 4, 64), 64, 0.0) for s in (1, 37, 63)]
    cases += [((2, 300, 4, 64), 64, d) for d in (0.0, -1.0)]
    cases += [((2, 130, 4, 64), 32, None), ((1, 70, 2, 16), 32, None)]
    cases += [((LM_PREFILL[0], LM_PREFILL[1], 48, 64), 64, 0.0)]
    errs = []
    for shape, chunk, decay in cases:
        r, k, v, la, u, do = card(shape, decay)
        got = wk.wkv6_bwd(r, k, v, la, u, do, chunk=chunk)
        want = wkv6_chunked_bwd_ref(r, k, v, la, u, do, chunk)
        auto = None
        if decay is not None and shape[1] <= 512:
            xs = [t.clone().requires_grad_() for t in (r, k, v, la, u)]
            auto = torch.autograd.grad(wkv6_chunked_ref(*xs, chunk)[0], xs,
                                       do)
        tag = (f"wkv6-bwd-{'x'.join(map(str, shape))}-c{chunk}-"
               f"{'planted40' if decay is None else f'e^{-decay:g}'}")
        for i, (n, g, w) in enumerate(zip(names, got, want)):
            # s = 1: la changes nothing (dla = 0), held elementwise alone
            norm = bool(w.abs().max() > 0)
            errs.append(_within(f"{tag}-{n}", g, w, f32, norm=norm,
                                tol=WKV_BWD_TOL, norm_tol=WKV_NORM_TOL))
            if auto is not None:
                _within(f"{tag}-{n}-vs-autograd", g, auto[i], f32,
                        norm=norm, tol=WKV_BWD_TOL, norm_tol=WKV_NORM_TOL)

    # two calls on the same inputs: bit for bit (no atomics); then timed
    b, s, H, K, chunk = LM_PREFILL[0], LM_PREFILL[1], 48, 64, 64
    r, k, v, la, u, do = card((b, s, H, K), 0.0)
    one = wk.wkv6_bwd(r, k, v, la, u, do, chunk=chunk)
    two = wk.wkv6_bwd(r, k, v, la, u, do, chunk=chunk)
    same = all(torch.equal(x, y) for x, y in zip(one, two))
    say("wkv6-bwd-repeat", shape=f"{b}x{s}x{H}x{K}-c{chunk}", bit_equal=same)
    check(same, "wkv6_bwd: two calls on the same inputs differ")
    del one, two
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = _events_ms(lambda: wk.wkv6_bwd(r, k, v, la, u, do, chunk=chunk),
                    10, flush)
    plain_ms = _events_ms(lambda: wkv6_chunked_bwd_ref(r, k, v, la, u, do,
                                                       chunk), 3, flush)
    fwd_ms = _events_ms(lambda: wk.wkv6(r, k, v, la, u, chunk=chunk), 10,
                        flush)
    cost = wk.wkv6_bwd_cost(b, s, H, K, chunk)
    bound_ms, bound_by = _bound(cost)
    bytes_ms = cost.bytes / H100_BYTES_PER_S * 1e3
    ops_ms = cost.flops / H100_FP32_FLOPS * 1e3
    scratch = b * H * (-(-s // chunk)) * K * K * 4
    # the time of its three kernels: a profiled window, or where the
    # profiler sees no device work, CUDA events around a trace build's
    parts = {"states": "wkv6_states_kernel", "reverse": "wkv6_bwd_kernel",
             "du": "wkv6_du_kernel"}
    split, names = _profiled_split(
        lambda: wk.wkv6_bwd(r, k, v, la, u, do, chunk=chunk), 3, parts)
    split_from = "profiler"
    if not names:
        from repro_torch.launch.pair import build_kernel
        from repro_torch.launch.wkv6_bwd_pair import trace
        lib = build_kernel(ROOT, "wkv6_bwd", "trace", ["-DWKV6_BWD_TRACE"])
        split = dict(zip(parts, trace(lib, (r, k, v, la, u, do))[0]))
        split_from = "CUDA events, -DWKV6_BWD_TRACE build"
    say("wkv6-bwd-time", shape=f"b {b}, s {s}, {H} heads, K {K}, chunk "
        f"{chunk}", bytes=cost.bytes, state_scratch_bytes=scratch,
        flops=cost.flops,
        ms=f"{ms:.5f}", bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
        ops_bound_ms=f"{ops_ms:.5f}", bytes_bound_ms=f"{bytes_ms:.5f}",
        plain_ms=f"{plain_ms:.5f}", forward_ms=f"{fwd_ms:.5f}",
        library_ms=None,
        library="no single PyTorch call computes the WKV6 backward",
        roofline_share=f"{bound_ms / ms:.4f}", split_from=split_from,
        **{f"{part}_ms": t if isinstance(t, str) else f"{t:.5f}"
           for part, t in split.items()})
    say("wkv6-bwd", cases=len(cases), max_abs_err=f"{max(errs):.3e}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes_bound_ms=bytes_ms,
                library_ms=None, max_abs_err=max(errs), cases=len(cases),
                forward_ms=fwd_ms, split_ms=split, split_from=split_from)


def _layer0_time_mix_grads(mdl, params, batch, plain):
    """Gradients of layer 0's time-mix weights (wr, wk, wv, wg, w0, u)
    for the loss Σ y·dY of its time-mix sublayer on the batch's embeddings
    (dY seeded), through the kernels or, with `plain`, through autograd of
    `wkv6_chunked_ref` on the card."""
    import torch
    from repro_torch.kernels.wkv6 import ops
    from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref
    from repro_torch.models import rwkv6
    from repro_torch.models.transformer import apply_norm
    cfg = mdl.cfg
    block = params["blocks"]["pos0"]
    p = {k: v[0] for k, v in block["tm"].items()}
    x = mdl._embed(params, batch["tokens"]).detach()
    h = apply_norm(cfg, {k: v[0].detach() for k, v in block["ln1"].items()},
                   x)
    gen = torch.Generator(device=x.device).manual_seed(SEED + 32)
    dy = torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)
    real = ops.wkv6
    if plain:
        ops.wkv6 = lambda r, k, v, la, u, chunk=64: wkv6_chunked_ref(
            r, k, v, la, u, chunk)[0]
    try:
        y = rwkv6.time_mix(p, cfg, h)
        leaves = [block["tm"][n] for n in ("wr", "wk", "wv", "wg", "w0",
                                           "u")]
        grads = torch.autograd.grad((y.float() * dy.float()).sum(), leaves)
    finally:
        ops.wkv6 = real
    return [g[0] for g in grads]


def phase_ssm_train_path():
    """Phase 32: rwkv6-3b trained at full width on the card (d 2,560, 48
    padded heads of 64, vocab 65,536, bf16, seed 0; SSM_TRAIN_LAYERS of
    its 32 layers) on the synthetic TokenStream (batch 8 × 2,048) with
    `make_train_step` at its defaults under the config's remat "full":
    one warm-up step and 5 timed steps. Held: a finite loss every step;
    every leaf's gradient finite and not all zero (read off the first
    moment after the first step); `wkv6` launched twice and `wkv6_bwd`
    once a layer a step; layer 0's time-mix gradients against a recompute
    through the plain version on the card (bf16 noise, in norm). Printed:
    ms a step, tokens/s, peak memory, a profiled step's busy share and top
    device operations. Returns the launch counts of the run."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.models import build
    from repro_torch.models.steps import init_train_state, make_train_step
    from repro_torch.optim import tree_leaves
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(SSM_ARCH)
    check(cfg.remat_policy == "full", f"{SSM_ARCH} remat {cfg.remat_policy}")
    cfg = dataclasses.replace(cfg, num_layers=SSM_TRAIN_LAYERS)
    mdl = build(cfg)
    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(mdl, SEED, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    b, s = TRAIN_BATCH
    ds = TokenStream(vocab_size=cfg.vocab_size, batch=b, seq_len=s, seed=SEED)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in ds.batch_at(i).items()}
               for i in range(TRAIN_STEPS + 2)]
    step = make_train_step(mdl)
    L = cfg.num_layers
    wk.wkv6.launches = 0
    wk.wkv6_bwd.launches = 0
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, met = step(state, batches[i])
        loss = float(met["loss"])               # synchronizes
        step_ms.append((time.perf_counter() - t) * 1e3)
        check(np.isfinite(loss), f"ssm train step {i}: loss {loss}")
        losses.append(loss)
        if i == 0:                      # m = 0.1 · clipped g after step 1
            for (path, m) in _named_leaves(state["opt"]["m"]):
                check(bool(torch.isfinite(m).all()) and bool(m.any()),
                      f"ssm train: gradient of {path} not finite or all "
                      f"zero")
    launches = {"wkv6": wk.wkv6.launches, "wkv6_bwd": wk.wkv6_bwd.launches}
    steps = TRAIN_STEPS + 1
    check(launches["wkv6"] == 2 * L * steps
          and launches["wkv6_bwd"] == L * steps,
          f"ssm train: launches {launches} over {steps} steps of {L} layers")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timed = step_ms[1:]
    mean_ms = float(np.mean(timed))
    # layer 0's time-mix gradients against the plain version, 2 rows
    sub = {k: v[:2] for k, v in batches[-1].items()}
    got = _layer0_time_mix_grads(mdl, state["params"], sub, plain=False)
    want = _layer0_time_mix_grads(mdl, state["params"], sub, plain=True)
    for name, g, w in zip(("wr", "wk", "wv", "wg", "w0", "u"), got, want):
        _within(f"ssm-train-layer0-d{name}", g, w, torch.bfloat16, norm=True,
                elementwise=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, met = step(state, batches[-1])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    rec = _device_time(prof, wall_s, {"wkv6_fwd": "wkv6_kernel",
                                      "wkv6_bwd": "wkv6_bwd_kernel",
                                      "wkv6_states": "wkv6_states_kernel"})
    say("ssm-train-path", arch=SSM_ARCH, params=n_params, layers=L,
        batch=f"{b}x{s}", remat=cfg.remat_policy, steps=TRAIN_STEPS,
        warmup_ms=f"{step_ms[0]:.1f}", ms_per_step=f"{mean_ms:.1f}",
        ms_steps=",".join(f"{x:.1f}" for x in timed),
        tokens_per_s=f"{b * s / mean_ms * 1e3:.0f}",
        peak_memory_gb=f"{peak_gb:.2f}",
        losses=",".join(f"{x:.4f}" for x in losses),
        wkv6_per_step=launches["wkv6"] // steps,
        wkv6_bwd_per_step=launches["wkv6_bwd"] // steps)
    say("ssm-train-path-profile", **rec)
    del state, met, batches
    torch.cuda.empty_cache()
    return dict(launches, ms_per_step=mean_ms, layers=L,
                tokens_per_s=b * s / mean_ms * 1e3, peak_memory_gb=peak_gb)


def phase_checkpoint(mdl, state):
    """Phase 33 (a), run on phase 30's state as soon as it is done:
    tinyllama-1.1b's whole train state (bf16 params, f32 moments, about
    11 GB) written with `save_checkpoint` into a temporary directory (the
    free disk space printed first), restored with `restore_checkpoint`
    from `train_state_specs` onto the card and held equal bit for bit,
    params requiring grad; the save and the restore timed; the directory
    removed."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                        save_checkpoint)
    from repro_torch.models.steps import train_state_specs
    root = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    leaves = _named_leaves(state)
    nbytes = sum(t.numel() * t.element_size() for _, t in leaves)
    free_gb = shutil.disk_usage(root).free / 1e9
    say("ckpt-disk", dir=root, free_gb=f"{free_gb:.1f}",
        state_gb=f"{nbytes / 1e9:.3f}", leaves=len(leaves))
    try:
        step = int(state["step"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        save_checkpoint(root, state, step)
        save_s = time.perf_counter() - t
        check(latest_step(root) == step, f"ckpt: latest {latest_step(root)}")
        t = time.perf_counter()
        restored, got_step = restore_checkpoint(root, train_state_specs(mdl))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        check(got_step == step, f"ckpt: restored step {got_step} != {step}")
        for (path, a), (_, b) in zip(leaves, _named_leaves(restored)):
            check(a.dtype == b.dtype and a.shape == b.shape
                  and b.device == a.device
                  and bool(torch.equal(a.detach(), b.detach())),
                  f"ckpt: {path} restored unequal")
        check(all(p.requires_grad for p in _leaves(restored["params"])),
              "ckpt: restored params do not require grad")
        del restored
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say("ckpt", arch=TRAIN_ARCH, step=step, state_gb=f"{nbytes / 1e9:.3f}",
        save_s=f"{save_s:.2f}", restore_s=f"{restore_s:.2f}",
        save_gb_per_s=f"{nbytes / 1e9 / save_s:.3f}",
        restore_gb_per_s=f"{nbytes / 1e9 / restore_s:.3f}", bit_equal=True)
    return dict(save_s=save_s, restore_s=restore_s, state_gb=nbytes / 1e9)


def _train_cli(args):
    """`python -m repro_torch.launch.train` on the card, started."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train",
                             *args], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _finish(proc, timeout=600):
    """(exit code, output) of a started launcher; killed at `timeout`."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise SmokeFailure(f"launcher timed out: {out[-2000:]}")
    return proc.returncode, out


def _ckpt_leaves(directory, step):
    """The f32 leaves of a checkpoint, by path, read without the port."""
    import json
    path = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    out = {}
    for leaf in manifest["leaves"]:
        arr = np.load(path / leaf["file"])
        if leaf["dtype"] == "bfloat16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[leaf["path"]] = arr.astype(np.float64)
    return out


def _ckpt_distance(a, b):
    """‖a − b‖ over every leaf of two checkpoints of one model."""
    check(sorted(a) == sorted(b), "checkpoints hold other leaves")
    return float(np.sqrt(sum(np.square(a[k] - b[k]).sum() for k in a)))


def phase_launcher():
    """Phase 33 (b, c): the training launcher on the card. (b) The
    tinyllama smoke twin for LAUNCH_SMOKE_STEPS steps (batch 2 × 16, a
    checkpoint every 5): SIGTERM after its first checkpoint, exit 0 with
    "preemption signal"; the relaunch prints "resumed at step N" and ends
    at the last step.
    Two uninterrupted runs beside it: if their end checkpoints are equal
    bit for bit, the resumed run's must be too; otherwise it lies within
    1.5× their distance (the embedding's backward adds with atomics). (c)
    tinyllama-1.1b at full size, `--batch 8 --seq 2048 --steps 4
    --log-every 2`, no checkpoint directory: its tokens/s line."""
    import shutil
    import signal
    import tempfile
    import torch
    from repro_torch.checkpoint import latest_step
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix="chip-smoke-launch-"))
    n = LAUNCH_SMOKE_STEPS
    smoke = ["--arch", TRAIN_ARCH, "--smoke", "--steps", str(n), "--batch",
             "2", "--seq", "16", "--ckpt-every", "5", "--log-every", "50"]
    procs = []
    try:
        dirs = {k: str(root / k) for k in ("cut", "whole_a", "whole_b")}
        cut = _train_cli(smoke + ["--ckpt-dir", dirs["cut"]])
        procs.append(cut)
        wholes = [_train_cli(smoke + ["--ckpt-dir", dirs[k]])
                  for k in ("whole_a", "whole_b")]
        procs += wholes
        deadline = time.time() + 300
        while time.time() < deadline and cut.poll() is None:
            if latest_step(dirs["cut"]) is not None:
                break
            time.sleep(0.1)
        cut.send_signal(signal.SIGTERM)
        rc, out = _finish(cut)
        check(rc == 0 and "preemption signal" in out,
              f"launcher: SIGTERM gave rc {rc}: {out[-2000:]}")
        cut_at = latest_step(dirs["cut"])
        check(cut_at is not None and 0 < cut_at < n,
              f"launcher: checkpoint at {cut_at} after SIGTERM")
        again = _train_cli(smoke + ["--ckpt-dir", dirs["cut"]])
        procs.append(again)
        rc, out2 = _finish(again)
        check(rc == 0 and f"[train] resumed at step {cut_at}" in out2
              and f"[train] done at step {n}" in out2,
              f"launcher: relaunch rc {rc}: {out2[-2000:]}")
        for w in wholes:
            rc, out3 = _finish(w)
            check(rc == 0 and f"[train] done at step {n}" in out3,
                  f"launcher: uninterrupted run rc {rc}: {out3[-2000:]}")
        ends = {k: _ckpt_leaves(d, n) for k, d in dirs.items()}
        noise = _ckpt_distance(ends["whole_a"], ends["whole_b"])
        dist = _ckpt_distance(ends["cut"], ends["whole_a"])
        dist_b = _ckpt_distance(ends["cut"], ends["whole_b"])
        if noise == 0:
            check(dist == 0, f"launcher: resumed run {dist:.3e} from two "
                  f"bit-equal uninterrupted runs")
        else:
            check(dist <= 1.5 * noise, f"launcher: resumed run {dist:.3e} "
                  f"from an uninterrupted one, which are {noise:.3e} apart")
        say("launcher-preemption", arch=f"{TRAIN_ARCH} smoke", steps=n,
            sigterm_checkpoint=cut_at, exit_code=0, resumed=cut_at,
            uninterrupted_distance=f"{noise:.6e}",
            resumed_distance=f"{dist:.6e}",
            resumed_distance_b=f"{dist_b:.6e}",
            bit_equal=dist == 0 and noise == 0)
        b, s, steps = LAUNCH_FULL
        t = time.perf_counter()
        full = _train_cli(["--arch", TRAIN_ARCH, "--batch", str(b), "--seq",
                           str(s), "--steps", str(steps), "--log-every",
                           "2"])
        procs.append(full)
        rc, out4 = _finish(full)
        wall_s = time.perf_counter() - t
        lines = [ln for ln in out4.splitlines() if ln.startswith("[train]")]
        check(rc == 0 and f"[train] done at step {steps}" in out4,
              f"launcher at full size: rc {rc}: {out4[-2000:]}")
        last = [ln for ln in lines if ln.startswith(f"[train] step {steps} ")]
        check(len(last) == 1, f"launcher at full size: {lines}")
        tok_s = float(last[0].split()[-2])
        say("launcher-full", arch=TRAIN_ARCH, batch=f"{b}x{s}", steps=steps,
            line=last[0], tokens_per_s=f"{tok_s:.0f}",
            wall_s=f"{wall_s:.1f}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)
    return dict(cut_at=cut_at, noise=noise, dist=dist, tokens_per_s=tok_s)


# the paper's engines and the training step on a torch.distributed mesh:
# phase 34
MESH_SHAPE = (4, 2)            # 34b: ("data", "model"), eight gloo ranks
MESH_FOREST_ROUNDS = (300, 100)    # group commits of 32 inserts: 34a, 34b
MESH_FOREST_CUT = 581_632      # 34b: 4 shards of 145,408 = 284 x 512 rows
MESH_DBLIFE_UPDATES = (400, 200)   # 34a, 34b
MESH_TRAIN_STEPS = (2, 3)      # 34a: tinyllama-1.1b at 8 x 2,048; 34b: twin
MESH_TWIN_BATCH = (8, 64)      # 34b: the f32 dense smoke twin's batch
MESH_RANK_TIMEOUT = 420        # s, the eight ranks of 34b together


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _forest_rounds(classes, n, rounds, seed=SEED):
    """The view driver's inserts: `rounds` group commits of GROUP_COMMIT
    seeded entity ids below n with their classes, (rounds, 32) each."""
    ids = np.random.default_rng(seed + 34).integers(
        0, n, size=(rounds, GROUP_COMMIT))
    return ids, np.asarray(classes)[ids]


def _forest_run(F, k, ids, cls, device, mesh=None):
    """`make_sharded_facade` over F (on `mesh`, or one shard) fed the
    rounds; (facade, ms a round, kernel launches)."""
    from repro_torch.core.facade import make_sharded_facade
    from repro_torch.kernels.band_reclassify import kernel
    fac = make_sharded_facade(F, k, p=2.0, q=2.0, lr=0.1, l2=1e-4,
                              cap_frac=0.5, device=device, mesh=mesh)
    kernel.multiview_band_reclassify.launches = 0
    _sync(device)
    t = time.perf_counter()
    for i, c in zip(ids.tolist(), cls.tolist()):
        fac.insert_examples(i, c)
    _sync(device)
    ms = (time.perf_counter() - t) / len(ids) * 1e3
    return fac, ms, kernel.multiview_band_reclassify.launches


def _dblife_run(F, models, M, device, mesh=None):
    """`ShardedHazy` over the models; (driver, state, ms an update,
    launches of eps_affine and band_reclassify)."""
    from repro_torch.core.sharded import ShardedHazy
    from repro_torch.kernels.band_reclassify import kernel as band
    from repro_torch.kernels.eps_affine import kernel as eps
    n, d = F.shape
    sh = ShardedHazy(n=n, d=d, M=M, p=2.0, cap_frac=1 / 64, device=device,
                     mesh=mesh)
    band.band_reclassify.launches = eps.eps_affine.launches = 0
    state = sh.init_state(F)
    _sync(device)
    t = time.perf_counter()
    for w, b in models:
        state = sh.apply_model(state, w, b)
    _sync(device)
    ms = (time.perf_counter() - t) / len(models) * 1e3
    return sh, state, ms, {"eps_affine": eps.eps_affine.launches,
                           "band_reclassify": band.band_reclassify.launches}


def _train_run(mdl, batches, device, mesh=None):
    """`make_train_step` from `init_train_state(seed 0)` over the batches;
    (state, per-step metrics as floats, ms of each step, flash
    launches)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models.steps import init_train_state, make_train_step
    state = init_train_state(mdl, SEED, device=device)
    step = make_train_step(mdl, mesh=mesh)
    fk.flash_attention.launches = fk.flash_attention_bwd.launches = 0
    metrics, ms = [], []
    for batch in batches:
        _sync(device)
        t = time.perf_counter()
        state, met = step(state, batch)
        metrics.append({k: float(v) for k, v in met.items()})   # syncs
        ms.append((time.perf_counter() - t) * 1e3)
    return state, metrics, ms, {
        "flash_attention": fk.flash_attention.launches,
        "flash_attention_bwd": fk.flash_attention_bwd.launches}


def _rendezvous(directory):
    """A fresh `file://` rendezvous under `directory` (no TCP port)."""
    import os
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"rendezvous-{os.getpid()}-{time.time_ns()}"
    return "file://" + str(path)


def phase_mesh_world1(forest_n=FOREST["n"], dblife_scale=1.0,
                      train_cfg=None, train_batch=TRAIN_BATCH,
                      device="cuda"):
    """Phase 34a: the NCCL process group at world 1 and a (1, 1) ("data",
    "model") mesh on the card, each path run with the mesh and without:
    Forest (582,000 x 54, k = 7) through `make_sharded_facade` over 300
    group commits of the view driver's inserts; DBLife (124,000 x 1024)
    through `ShardedHazy` over 400 updates; two steps of tinyllama-1.1b
    at full width (8 x 2,048) through `make_train_step`. Held bit for
    bit: labels, gids or perm, eps, counts, reorgs, overflows and waters,
    and every leaf of the train state and every metric. Printed: ms a
    round, an update or a step with and without the mesh."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.waters import holder_M
    from repro_torch.data import TokenStream, dblife_like, multiclass_corpus
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.models import build
    t0 = time.perf_counter()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()       # what earlier phases left cached
    dev = init_process_group(device, init_method=_rendezvous(
        ROOT / "build" / "mesh"), rank=0, world_size=1)
    backend = dist.get_backend()
    try:
        mesh = make_host_mesh((1, 1))
        out = {"backend": backend}
        c = multiclass_corpus("FC", forest_n, FOREST["d"], FOREST["k"],
                              seed=SEED)
        ids, cls = _forest_rounds(c.classes, forest_n, MESH_FOREST_ROUNDS[0])
        a, a_ms, a_n = _forest_run(c.features, FOREST["k"], ids, cls, dev)
        b, b_ms, b_n = _forest_run(c.features, FOREST["k"], ids, cls, dev,
                                   mesh)
        for f in ("F", "gids", "eps", "labels"):
            check(torch.equal(getattr(a.state, f), getattr(b.state, f)),
                  f"mesh-world1: forest {f} differ with the mesh")
        da, db = a.driver, b.driver
        check(np.array_equal(a.counts(), b.counts())
              and (da.skiing.reorgs, da.overflows,
                   da.skiing.total_incremental)
              == (db.skiing.reorgs, db.overflows,
                  db.skiing.total_incremental)
              and np.array_equal(da.lw, db.lw)
              and np.array_equal(da.hw, db.hw),
              "mesh-world1: forest counts, schedules or waters differ")
        cuda = dev.type == "cuda"
        check(a_n == b_n and (a_n > 0 or not cuda),
              f"mesh-world1: launches {a_n}, {b_n}")
        out["forest"] = dict(ms=a_ms, mesh_ms=b_ms, launches=a_n,
                             mesh_launches=b_n)
        say("mesh-world1", path="forest", backend=backend, n=forest_n,
            rounds=len(ids), ms_per_round=f"{a_ms:.4f}",
            mesh_ms_per_round=f"{b_ms:.4f}", reorgs=da.skiing.reorgs,
            overflows=da.overflows, launches=a_n, mesh_launches=b_n,
            counts=b.counts().tolist(), bit_equal=True)
        del a, b

        db_c = dblife_like(scale=dblife_scale)
        F = db_c.features
        M = holder_M(F, 2.0)
        models = [(m.w, m.b) for m in _sgd_models(
            db_c, MESH_DBLIFE_UPDATES[0])]
        sa, xa, a_ms, a_n = _dblife_run(F, models, M, dev)
        sb, xb, b_ms, b_n = _dblife_run(F, models, M, dev, mesh)
        for f in ("F", "eps", "labels", "perm"):
            check(torch.equal(getattr(xa, f), getattr(xb, f)),
                  f"mesh-world1: dblife {f} differ with the mesh")
        check(sa.all_members(xa) == sb.all_members(xb)
              and (sa.skiing.reorgs, sa.overflows, sa.lw, sa.hw)
              == (sb.skiing.reorgs, sb.overflows, sb.lw, sb.hw),
              "mesh-world1: dblife counts, schedules or waters differ")
        check(a_n == b_n and (min(a_n.values()) > 0 or not cuda),
              f"mesh-world1: dblife launches {a_n}, {b_n}")
        out["dblife"] = dict(ms=a_ms, mesh_ms=b_ms, launches=a_n,
                             mesh_launches=b_n)
        say("mesh-world1", path="dblife", n=F.shape[0], d=F.shape[1],
            updates=len(models), ms_per_update=f"{a_ms:.4f}",
            mesh_ms_per_update=f"{b_ms:.4f}", reorgs=sa.skiing.reorgs,
            overflows=sa.overflows, members=sb.all_members(xb),
            launches=a_n, mesh_launches=b_n, bit_equal=True)
        del sa, xa, sb, xb, F, db_c

        cfg = train_cfg or get_config(TRAIN_ARCH)
        mdl = build(cfg)
        bsz, seq = train_batch
        ds = TokenStream(vocab_size=cfg.vocab_size, batch=bsz, seq_len=seq,
                         seed=SEED)
        batches = [{k: torch.from_numpy(v).to(dev)
                    for k, v in ds.batch_at(i).items()}
                   for i in range(MESH_TRAIN_STEPS[0])]
        ta, ma, a_ms, a_n = _train_run(mdl, batches, dev)
        tb, mb, b_ms, b_n = _train_run(mdl, batches, dev, mesh)
        check(ma == mb, f"mesh-world1: train metrics {ma} != {mb}")
        for (path, x), (_, y) in zip(_named_leaves(ta), _named_leaves(tb)):
            check(torch.equal(x.detach(), y.detach()),
                  f"mesh-world1: train leaf {path} differs with the mesh")
        check(a_n == b_n and (min(a_n.values()) > 0 or not cuda),
              f"mesh-world1: train launches {a_n}, {b_n}")
        out["train"] = dict(ms=a_ms, mesh_ms=b_ms, launches=a_n,
                            mesh_launches=b_n)
        say("mesh-world1", path="train", arch=cfg.name,
            batch=f"{bsz}x{seq}", steps=len(batches),
            ms_steps=",".join(f"{x:.1f}" for x in a_ms),
            mesh_ms_steps=",".join(f"{x:.1f}" for x in b_ms),
            losses=",".join(f"{m['loss']:.6f}" for m in mb),
            launches=a_n, bit_equal=True)
        del ta, tb
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    say("mesh-world1", seconds=f"{out['seconds']:.2f}")
    return out


def _twin_cfg():
    import dataclasses
    from repro_torch.configs import smoke_config
    return dataclasses.replace(smoke_config(TRAIN_ARCH), dtype="float32",
                               param_dtype="float32")


def _twin_batches(cfg, device):
    import torch
    from repro_torch.data import TokenStream
    bsz, seq = MESH_TWIN_BATCH
    ds = TokenStream(vocab_size=cfg.vocab_size, batch=bsz, seq_len=seq,
                     seed=SEED)
    return [{k: torch.from_numpy(v).to(device)
             for k, v in ds.batch_at(i).items()}
            for i in range(MESH_TRAIN_STEPS[1])]


def mesh_rank():
    """One rank of phase 34b, started by `phase_mesh_ranks` in a fresh
    interpreter: gloo on the card (several ranks on one GPU), the (4, 2)
    mesh, then the k-view Forest cut, DBLife's single view and the f32
    dense twin's steps, each rank on its block; its results pickled for
    the parent."""
    import os
    import pickle
    from datetime import timedelta
    import torch
    from repro_torch.core.engine import classify
    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.models import build
    torch.set_num_threads(1)
    d = Path(os.environ["MESH_DIR"])
    device = os.environ["MESH_DEVICE"]
    dev = init_process_group(device, backend="gloo",
                             init_method=os.environ["MESH_INIT"],
                             timeout=timedelta(seconds=120))
    mesh = make_mesh(MESH_SHAPE, ("data", "model"))
    out = {"coords": mesh.coords}

    F = np.load(d / "forest.npy", mmap_mode="r")
    r = np.load(d / "forest_rounds.npz")
    fac, ms, n = _forest_run(F, FOREST["k"], r["ids"], r["classes"], dev,
                             mesh)
    st = fac.state
    Wd = torch.tensor(fac.W, device=dev)
    bd = torch.tensor(fac.b.astype(np.float32), device=dev)
    want = classify(Wd @ st.F.T - bd[:, None])       # this shard, fp32
    ties, bad = label_mismatches(st.labels, want, st.F, Wd, bd)
    out["forest"] = dict(
        gids=st.gids.cpu().numpy(), labels=st.labels.cpu().numpy(),
        counts=fac.counts(), reorgs=fac.driver.skiing.reorgs,
        overflows=fac.driver.overflows, ms=ms, launches=n, ties=ties,
        bad=bad, cap=fac.driver.cap, block_n=fac.driver.block_n)
    del fac, st, F

    F = np.load(d / "dblife.npy", mmap_mode="r")
    m = np.load(d / "dblife_models.npz")
    sh, st, ms, n = _dblife_run(F, list(zip(m["w"], m["b"])), float(m["M"]),
                                dev, mesh)
    perm = st.perm.cpu().numpy()
    w, b = m["w"][-1].astype(np.float64), float(m["b"][-1])
    rows = np.asarray(F[perm], np.float64)
    z = rows @ w - b
    truth = np.where(z >= 0, 1, -1)
    off = truth != st.labels.cpu().numpy()
    tie = np.abs(z) <= TIE_RTOL * (np.linalg.norm(rows, axis=1)
                                   * np.linalg.norm(w) + abs(b))
    out["dblife"] = dict(
        rows=(sh.rows.start, sh.rows.stop), cols=(sh.cols.start, sh.cols.stop),
        members=sh.all_members(st), reorgs=sh.skiing.reorgs,
        overflows=sh.overflows, ms=ms, launches=n,
        ties=int((off & tie).sum()), bad=int((off & ~tie).sum()))
    del sh, st, F, rows

    mdl = build(_twin_cfg())
    state, metrics, ms, n = _train_run(mdl, _twin_batches(mdl.cfg, dev), dev,
                                       mesh)
    out["train"] = dict(metrics=metrics, ms=ms[-1], launches=n,
                        leaves=[(p, t.detach().cpu().numpy())
                                for p, t in _named_leaves(state)])
    with open(d / f"rank{mesh.rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def phase_mesh_ranks(forest_n=MESH_FOREST_CUT, dblife_scale=1.0,
                     device="cuda"):
    """Phase 34b: eight gloo ranks as a (4, 2) ("data", "model") mesh, all
    on the one card with CUDA tensors (NCCL refuses two ranks on one
    GPU), started as fresh interpreters after the kernels were built:
    Forest cut to 581,632 rows (4 shards of 145,408 = 284 x 512, so
    block_n stays 512) through `make_sharded_facade(mesh=...)` over 100
    group commits; DBLife's single view at (4, 2) (31,000 x 512 a rank)
    over 200 updates; 3 steps of the f32 dense smoke twin (tinyllama's,
    batch 8 x 64). Held: each Forest shard's golden invariant and the
    labels in entity order equal to a one-shard card run's (tie rule),
    the ranks along "model" alike; each DBLife rank's labels by perm ==
    sign(F·w − b) (tie rule); the twin's loss, grad_norm and params within
    1e-4 of a one-process card run's; every rank's launches of
    `multiview_band_reclassify`, `eps_affine` and `flash_attention` above
    0. A rank that fails or runs past its time fails the phase."""
    import os
    import pickle
    import shutil
    import torch
    from repro_torch.core.waters import holder_M
    from repro_torch.data import dblife_like, multiclass_corpus
    from repro_torch.models import build
    t0 = time.perf_counter()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()       # leave the card to the eight ranks
    d = ROOT / "build" / "mesh" / f"ranks-{os.getpid()}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    procs = []
    try:
        c = multiclass_corpus("FC", FOREST["n"], FOREST["d"], FOREST["k"],
                              seed=SEED)
        F = np.ascontiguousarray(c.features[:forest_n])
        ids, cls = _forest_rounds(c.classes, forest_n, MESH_FOREST_ROUNDS[1])
        np.save(d / "forest.npy", F)
        np.savez(d / "forest_rounds.npz", ids=ids, classes=cls)
        db_c = dblife_like(scale=dblife_scale)
        np.save(d / "dblife.npy", db_c.features)
        models = _sgd_models(db_c, MESH_DBLIFE_UPDATES[1])
        np.savez(d / "dblife_models.npz",
                 w=np.stack([m.w for m in models]),
                 b=np.array([m.b for m in models], np.float64),
                 M=holder_M(db_c.features, 2.0))
        del db_c
        world = int(np.prod(MESH_SHAPE))
        init = _rendezvous(d)
        env = dict(os.environ, MESH_DIR=str(d), MESH_DEVICE=device,
                   MESH_INIT=init, WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
            "PYTHONPATH", "")
        for r in range(world):
            log = open(d / f"log{r}.txt", "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-c",
                 "import chip_smoke as c; c.mesh_rank()"],
                cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT,
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r))), log))

        # meanwhile, the one-shard and one-process runs on the same device
        one, one_ms, one_n = _forest_run(F, FOREST["k"], ids, cls, device)
        one_labels = np.empty((FOREST["k"], forest_n), np.int8)
        one_labels[:, one.state.gids.cpu().numpy()] = (
            one.state.labels.cpu().numpy())
        W = torch.tensor(one.W, device=device)
        b = torch.tensor(one.b.astype(np.float32), device=device)
        F_dev = torch.tensor(F, device=device)
        cfg = _twin_cfg()
        twin, twin_metrics, twin_ms, _ = _train_run(
            build(cfg), _twin_batches(cfg, device), device)
        twin_ms = twin_ms[-1]
        twin_leaves = [(p, t.detach().cpu().numpy())
                       for p, t in _named_leaves(twin)]

        deadline = time.monotonic() + MESH_RANK_TIMEOUT
        for r, (p, log) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                for q, _ in procs:
                    q.kill()
                tails = "\n".join(
                    f"--- rank {i}\n" + (d / f"log{i}.txt").read_text()[-1500:]
                    for i in range(world))
                raise SmokeFailure(f"mesh-ranks: rank {r} ended with {rc}\n"
                                   + tails)
        outs = []
        for r in range(world):
            with open(d / f"rank{r}.pkl", "rb") as f:
                outs.append(pickle.load(f))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
            log.close()

    rows, model = MESH_SHAPE
    k = FOREST["k"]
    got = np.zeros((k, forest_n), np.int8)
    for r, o in enumerate(outs):
        check(o["coords"] == {"data": r // model, "model": r % model},
              f"mesh-ranks: rank {r} coords {o['coords']}")
        fo = o["forest"]
        check(fo["bad"] == 0, f"mesh-ranks: rank {r} forest golden "
                              f"invariant, {fo['bad']} unproven mismatches")
        check(forest_n != MESH_FOREST_CUT or fo["block_n"] == 512,
              f"mesh-ranks: rank {r} block_n {fo['block_n']}")
        check(np.array_equal(fo["counts"], outs[0]["forest"]["counts"]),
              f"mesh-ranks: rank {r} counts differ from rank 0's")
        twin_rank = outs[r ^ 1]["forest"]
        check(np.array_equal(fo["labels"], twin_rank["labels"])
              and np.array_equal(fo["gids"], twin_rank["gids"]),
              f"mesh-ranks: ranks {r} and {r ^ 1} (one data shard) differ")
        got[:, fo["gids"]] = fo["labels"]
    ties, bad = label_mismatches(
        torch.tensor(got, device=device), torch.tensor(one_labels,
                                                       device=device),
        F_dev, W, b)
    check(bad == 0, f"mesh-ranks: forest labels in entity order differ "
                    f"from the one-shard run ({bad} unproven)")
    check(np.array_equal(outs[0]["forest"]["counts"], (got == 1).sum(1)),
          "mesh-ranks: forest counts differ from the gathered labels")
    fo = [o["forest"] for o in outs]
    say("mesh-ranks", path="forest", backend="gloo", device=device,
        mesh=MESH_SHAPE, n=forest_n, shard=forest_n // rows,
        block_n=fo[0]["block_n"], cap=fo[0]["cap"], rounds=len(ids),
        ms_per_round=",".join(f"{x['ms']:.3f}" for x in fo),
        one_shard_ms_per_round=f"{one_ms:.4f}",
        launches=[x["launches"] for x in fo], one_shard_launches=one_n,
        reorgs=fo[0]["reorgs"], one_shard_reorgs=one.driver.skiing.reorgs,
        overflows=fo[0]["overflows"], golden_ties=sum(x["ties"] for x in fo),
        entity_order_ties=ties, counts=fo[0]["counts"].tolist())
    dl = [o["dblife"] for o in outs]
    for r, x in enumerate(dl):
        check(x["bad"] == 0, f"mesh-ranks: rank {r} dblife labels by perm, "
                             f"{x['bad']} unproven mismatches")
        check(x["members"] == dl[0]["members"] and x["reorgs"]
              == dl[0]["reorgs"], f"mesh-ranks: rank {r} dblife host state")
    (r0, r1), (c0, c1) = dl[0]["rows"], dl[0]["cols"]
    say("mesh-ranks", path="dblife", shard=f"{r1 - r0}x{c1 - c0}",
        updates=MESH_DBLIFE_UPDATES[1],
        ms_per_update=",".join(f"{x['ms']:.3f}" for x in dl),
        members=dl[0]["members"], reorgs=dl[0]["reorgs"],
        overflows=dl[0]["overflows"], golden_ties=sum(x["ties"] for x in dl),
        launches=[x["launches"] for x in dl])
    tr = [o["train"] for o in outs]
    for r, x in enumerate(tr):
        for got_m, want_m in zip(x["metrics"], twin_metrics):
            for key in ("loss", "grad_norm"):
                check(abs(got_m[key] - want_m[key])
                      <= TRAIN_TOL * (1 + abs(want_m[key])),
                      f"mesh-ranks: rank {r} twin {key} {got_m[key]} "
                      f"vs {want_m[key]}")
        for (path, g), (_, w) in zip(x["leaves"], twin_leaves):
            check(np.allclose(g, w, rtol=TRAIN_TOL, atol=TRAIN_TOL),
                  f"mesh-ranks: rank {r} twin {path} off the one process")
            check(np.array_equal(g, dict(tr[0]["leaves"])[path]),
                  f"mesh-ranks: rank {r} twin {path} differs from rank 0's")
    say("mesh-ranks", path="train", arch=f"{TRAIN_ARCH} f32 twin",
        batch="x".join(map(str, MESH_TWIN_BATCH)), steps=MESH_TRAIN_STEPS[1],
        ms_last_step=",".join(f"{x['ms']:.1f}" for x in tr),
        one_process_ms_last_step=f"{twin_ms:.1f}",
        losses=",".join(f"{m['loss']:.6f}" for m in tr[0]["metrics"]),
        launches=[x["launches"]["flash_attention"] for x in tr])
    launches = {
        "multiview_band_reclassify": [x["launches"] for x in fo],
        "eps_affine": [x["launches"]["eps_affine"] for x in dl],
        "band_reclassify": [x["launches"]["band_reclassify"] for x in dl],
        "flash_attention": [x["launches"]["flash_attention"] for x in tr],
        "flash_attention_bwd": [x["launches"]["flash_attention_bwd"]
                                for x in tr]}
    if torch.device(device).type == "cuda":
        for name in ("multiview_band_reclassify", "eps_affine",
                     "flash_attention"):
            check(min(launches[name]) > 0,
                  f"mesh-ranks: {name} launches {launches[name]}")
    shutil.rmtree(d, ignore_errors=True)
    seconds = time.perf_counter() - t0
    say("mesh-ranks", seconds=f"{seconds:.2f}")
    return dict(launches=launches, seconds=seconds,
                forest_ms=[x["ms"] for x in fo], one_shard_ms=one_ms)


# the train state held in blocks over ("data", "model"): phase 35
TP_SHAPE = (4, 2)              # ("data", "model"), eight gloo ranks
TP_TWINS = {"dense": ("tinyllama-1.1b", 1), "vlm": ("pixtral-12b", 1),
            "moe": ("llama4-scout-17b-a16e", 1),
            "moe_mb2": ("dbrx-132b", 2), "ssm": ("rwkv6-3b", 1),
            "hybrid": ("jamba-v0.1-52b", 1), "audio": ("whisper-tiny", 1)}
TP_TWIN_BATCH = (8, 64)        # 35a: the f32 twins' global batch
# 35c: whisper-tiny at full width and depth (4 + 4 layers, d 384, 6 heads
# split 3 a rank over "model"), f32, so that the mesh is held to one
# process on the card as the twins are (TRAIN_TOL, TP_GRAD_RTOL): a batch
# of 8 sequences of 448 tokens (its decoder's context) over 1,500 frames
TP_AUDIO = "whisper-tiny"
TP_AUDIO_BATCH = (8, 448)
TP_AUDIO_SMOKE = (8, 32)       # ... in the CPU rehearsal
TP_TRAIN_LAYERS = 11           # 35b: tinyllama-1.1b's layers, 11 of its
                               # 22 (cut from 22 for the script's time)
TP_TRAIN_STEPS = 2             # 35b: bf16 steps at TRAIN_BATCH
# 35a: each block of m within TP_GRAD_RTOL of its norm, v within twice
# that (v ∝ g²): at the step's first rate (3e-6) the params move below
# the elementwise TRAIN_TOL, so the gradient is held through the moments.
# An H100 read at most 9.4e-6 (the rwkv6 twin: wkv6 and its backward in
# 3xTF32 against the CPU's f32), the other twins 2.7e-6 (PERF.md).
TP_GRAD_RTOL = 2e-5
# 35b steps at the peak rate from its first step (warm-up 1), so that one
# update moves the loss and grad_norm well past bf16's noise and the
# control can fail
TP_WARMUP = 1
# 35b: the mesh's bf16 run against a one-process bf16 run on the card
# from the same drawn state and batches. The first step differs only
# where bf16 rounds in another order (a row-parallel product rounded on
# each rank before the sum over "model", the vocab-parallel softmax's
# sums); the later ones also start from updates that rounded apart. So
# the loss and grad_norm are held relative, (first step, later steps),
# limits set from an H100's readings (PERF.md: the loss 5.5e-7 and
# 9.9e-5, grad_norm 3.3e-4 and 3.6e-3; one process's own gaps to f32
# 2.4e-4 and 2.5e-3 at the second step; the control 1.1e-2 and 0.80);
# the CPU rehearsal's bf16 smoke twin by its own readings (1.9e-5 and
# 5.3e-6, 1.1e-3 both; its control 8.7e-4 and 1.4e-2). m after the last
# step (the first and last layer of every stacked leaf, the other leaves
# whole) by the bf16 noise rule against an f32 run from the same drawn
# state: ‖mesh − f32‖ ≤ NOISE_RATIO · ‖one process − f32‖ over them all
# and for each leaf of at least TP_M_LEAF_MIN elements (a norm scale's
# few thousand carry a noise ratio that wanders, 1.38 for final_norm).
# The control (the state left unchanged: the last step's loss and
# grad_norm of the drawn state, m zero) must fail the loss and m checks.
TP_LIMITS = {"card": {"loss": (1e-5, 1e-3), "grad_norm": (2e-3, 2e-2)},
             "rehearsal": {"loss": (1e-4, 1e-4),
                           "grad_norm": (5e-3, 5e-3)}}
TP_M_LEAF_MIN = 1 << 16
TP_RANK_TIMEOUT = 480          # s, the eight ranks of phase 35 together


def _tp_twin_cfg(case):
    import dataclasses
    from repro_torch.configs import smoke_config
    arch, mb = TP_TWINS[case]
    return dataclasses.replace(smoke_config(arch), dtype="float32",
                               param_dtype="float32", microbatches=mb)


def _tp_train_cfg(layers, smoke=False):
    """35b's model: tinyllama-1.1b at `layers` of its 22, or (`smoke`, a
    CPU rehearsal) its bf16 smoke twin."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_config
    cfg = smoke_config(TRAIN_ARCH) if smoke else get_config(TRAIN_ARCH)
    return dataclasses.replace(cfg, num_layers=layers)


def _tp_train_batches(cfg, device, smoke=False):
    import torch
    from repro_torch.data import TokenStream
    bsz, seq = TP_TWIN_BATCH if smoke else TRAIN_BATCH
    ds = TokenStream(vocab_size=cfg.vocab_size, batch=bsz, seq_len=seq,
                     seed=SEED)
    return [{k: torch.from_numpy(v).to(device)
             for k, v in ds.batch_at(i).items()}
            for i in range(TP_TRAIN_STEPS)]


def _tp_audio(dev, smoke, mesh=None):
    """35c: one f32 step of whisper-tiny at full width and depth from
    SEED's state (the rank's blocks on `mesh`) on its global batch (of
    which the step takes the rank's rows). Returns the metrics, ms, the
    collective calls, the kernel launches and the state's leaves on the
    host."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import build
    from repro_torch.models.steps import init_train_state, make_train_step
    cfg = dataclasses.replace(get_config(TP_AUDIO), dtype="float32",
                              param_dtype="float32")
    mdl = build(cfg)
    b, s = TP_AUDIO_SMOKE if smoke else TP_AUDIO_BATCH
    batch = {k: v.to(dev) for k, v in _train_batch(
        cfg, np.random.default_rng(SEED + 351), b=b, s=s).items()}
    state = init_train_state(mdl, SEED, device=dev, mesh=mesh)
    step = make_train_step(mdl, mesh=mesh)
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    _kernel_counts(zero=True)
    mesh_lib.CALLS.clear()
    mesh_lib.BYTES.clear()
    _sync(dev)
    t = time.perf_counter()
    state, met = step(state, batch)
    metrics = {k: float(v) for k, v in met.items()}          # syncs
    ms = (time.perf_counter() - t) * 1e3
    named = _named_leaves(state)
    out = dict(mdl=mdl, metrics=metrics, ms=ms, calls=dict(mesh_lib.CALLS),
               bytes=dict(mesh_lib.BYTES), launches=_kernel_counts(),
               paths=[p for p, _ in named],
               leaves=[t.detach().cpu().numpy() for _, t in named],
               positions=_tp_positions(cfg, b, s, mesh),
               enc_positions=_tp_positions(cfg, b, cfg.encoder_seq_len,
                                           mesh),
               peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                        if cuda else 0.0))
    del state, step
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return out


def _tp_positions(cfg, b, s, mesh):
    """The residual stream's positions a rank of b sequences of s
    positions on `mesh` (all s without one): s / "model" where the
    reference's `seq_sp` rule splits the stream (`params.seq_parallel`)."""
    from repro_torch.models.params import seq_parallel
    if seq_parallel((b, s, cfg.d_model), mesh):
        return s // mesh.size("model")
    return s


def _tp_model_ops(calls, nbytes):
    """{op: (calls, bytes)} of the collectives over "model" alone."""
    return {op: (n, nbytes.get((axes, op), 0))
            for (axes, op), n in sorted(calls.items()) if axes == ("model",)}


def _tp_m_sample(m):
    """35b's sample of m, on the host in f32, by path: the first and last
    layer of every leaf stacked over the layers (its first dimension,
    never sharded), the other leaves whole (or the rank's block)."""
    return {path: (t[[0, t.shape[0] - 1]] if path.startswith("blocks.")
                   else t).detach().float().cpu()
            for path, t in _named_leaves(m)}


def _tp_one_process(cfg, dev, smoke, dtype=None, steps=None):
    """35b on one process: `cfg`'s state drawn from SEED (its bf16 leaves
    cast to `dtype` where given, the model built in it), `steps` of
    TP_TRAIN_STEPS' batches (all by default). Returns the losses,
    grad_norms, ms a step, the state's bytes and the m sample."""
    import dataclasses
    import torch
    from repro_torch.models import build
    from repro_torch.models.steps import init_train_state, make_train_step
    state = init_train_state(build(cfg), SEED, device=dev)
    if dtype is not None:
        state = _state_to(state, dev, dtype)
        cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(state))
    step = make_train_step(build(cfg), warmup=TP_WARMUP)
    batches = _tp_train_batches(cfg, dev, smoke)
    out = dict(losses=[], gnorms=[], ms=[], state_bytes=nbytes)
    for i in (range(len(batches)) if steps is None else steps):
        _sync(dev)
        t = time.perf_counter()
        state, met = step(state, batches[i])
        out["losses"].append(float(met["loss"]))
        out["ms"].append((time.perf_counter() - t) * 1e3)
        out["gnorms"].append(float(met["grad_norm"]))
    out["m"] = _tp_m_sample(state["opt"]["m"])
    del state, step
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return out


def _tp_noise(blocks, one, f32, mdl, coords):
    """35b's m against the one-process and f32 runs: for every sampled
    leaf, Σ over ranks of ‖mesh − f32‖², ‖one − f32‖², ‖mesh − one‖²,
    ‖one‖² and ‖f32‖² on each rank's block. Returns {path: sums}."""
    import torch
    sums = {}
    for got, c in zip(blocks, coords):
        slices = dict(zip([p for p, _ in _named_leaves(mdl.param_tree)],
                          _tp_blocks(mdl, c, params_only=True)))
        for path, g in got.items():
            sl = slices[path]
            if path.startswith("blocks."):
                check(sl[0] == slice(0, mdl.cfg.num_layers),
                      f"tp-ranks: {path} sharded over its layers {sl}")
                sl = (slice(None),) + sl[1:]
            w, a = one[path][sl], f32[path][sl]
            check(g.shape == w.shape and bool(torch.isfinite(g).all()),
                  f"tp-ranks: m {path} {tuple(g.shape)} vs "
                  f"{tuple(w.shape)} or not finite")
            acc = sums.setdefault(path, np.zeros(5))
            acc += [float((x.double() ** 2).sum()) for x in
                    (g - a, w - a, g - w, w, a)]
    return sums


def _kernel_counts(zero=False):
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.wkv6 import kernel as wk
    fns = {"flash_attention": fk.flash_attention,
           "flash_attention_bwd": fk.flash_attention_bwd,
           "wkv6": wk.wkv6, "wkv6_bwd": wk.wkv6_bwd}
    if zero:
        for f in fns.values():
            f.launches = 0
    return {k: f.launches for k, f in fns.items()}


def tp_rank():
    """One rank of phase 35, started by `phase_tp_ranks` in a fresh
    interpreter: gloo on the card, the (4, 2) mesh; (a) one step of each
    f32 twin from its blocks (drawn on the CPU as the one-process run
    draws them, then moved); (b) tinyllama-1.1b's blocks drawn on the
    card and TP_TRAIN_STEPS bf16 steps at 8 x 2,048, the m sample after
    them; results pickled."""
    import os
    import pickle
    from datetime import timedelta
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import build
    from repro_torch.models.steps import init_train_state, make_train_step
    torch.set_num_threads(1)
    d = Path(os.environ["TP_DIR"])
    dev = mesh_lib.init_process_group(os.environ["TP_DEVICE"],
                                      backend="gloo",
                                      init_method=os.environ["TP_INIT"],
                                      timeout=timedelta(seconds=300))
    mesh = mesh_lib.make_mesh(TP_SHAPE, ("data", "model"))
    out = {"coords": mesh.coords, "twins": {}}
    with open(d / "twin_batches.pkl", "rb") as f:
        twin_batches = pickle.load(f)
    for case in TP_TWINS:
        mdl = build(_tp_twin_cfg(case))
        state = _state_to(init_train_state(mdl, SEED, device="cpu",
                                           mesh=mesh), dev)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in twin_batches[case].items()}
        _kernel_counts(zero=True)
        mesh_lib.CALLS.clear()
        state, met = make_train_step(mdl, mesh=mesh)(state, batch)
        out["twins"][case] = dict(
            metrics={k: float(v) for k, v in met.items()},
            calls=dict(mesh_lib.CALLS), launches=_kernel_counts(),
            leaves=[t.detach().cpu().numpy()
                    for _, t in _named_leaves(state)])
        del state

    smoke = os.environ["TP_SMOKE"] == "1"
    audio = _tp_audio(dev, smoke, mesh)
    audio.pop("mdl")
    out["audio"] = audio
    cfg = _tp_train_cfg(int(os.environ["TP_LAYERS"]), smoke)
    mdl = build(cfg)
    state = init_train_state(mdl, SEED, device=dev, mesh=mesh)
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(state))
    step = make_train_step(mdl, mesh=mesh, warmup=TP_WARMUP)
    batches = _tp_train_batches(cfg, dev, smoke)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _kernel_counts(zero=True)
    mesh_lib.CALLS.clear()
    mesh_lib.BYTES.clear()
    # every collective of the port is a blocking `dist.all_reduce` (gloo
    # waits for the tensor's stream, copies it to the host, runs the ring
    # and copies back): the host time inside them and the bytes they move
    reduce, inside = torch.distributed.all_reduce, {"s": 0.0, "bytes": 0}

    def timed(t, *a, **kw):
        t0 = time.perf_counter()
        out = reduce(t, *a, **kw)
        inside["s"] += time.perf_counter() - t0
        inside["bytes"] += t.numel() * t.element_size()
        return out

    torch.distributed.all_reduce = timed
    losses, gnorms, ms = [], [], []
    for batch in batches:
        _sync(dev)
        t = time.perf_counter()
        state, met = step(state, batch)
        losses.append(float(met["loss"]))                 # syncs
        ms.append((time.perf_counter() - t) * 1e3)
        gnorms.append(float(met["grad_norm"]))
    torch.distributed.all_reduce = reduce
    bsz, seq = TP_TWIN_BATCH if smoke else TRAIN_BATCH
    out["train"] = dict(losses=losses, gnorms=gnorms, ms=ms,
                        m=_tp_m_sample(state["opt"]["m"]),
                        positions=_tp_positions(cfg, bsz, seq, mesh),
                        state_bytes=nbytes,
                        calls=dict(mesh_lib.CALLS),
                        bytes=dict(mesh_lib.BYTES),
                        all_reduce_s=inside["s"],
                        all_reduce_bytes=inside["bytes"],
                        launches=_kernel_counts(),
                        peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                                 if dev.type == "cuda" else 0.0))
    with open(d / f"rank{mesh.rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def _tp_held(case, r, got, want, coords, names):
    """A rank's one step of phase 35 (a) or (c) against one process's:
    its metrics within TRAIN_TOL, each of its blocks within TRAIN_TOL of
    that block of the whole state, each block of m and v within
    TP_GRAD_RTOL of its norm (v twice that), a sum over "model", and the
    kernels `names` launched. Returns (the largest elementwise error, the
    largest moment error as a share of its limit)."""
    worst = moment = 0.0
    for key, w in want["metrics"].items():
        check(abs(got["metrics"][key] - w) <= TRAIN_TOL * (1 + abs(w)),
              f"tp-ranks: {case} rank {r} {key} {got['metrics'][key]} "
              f"vs {w}")
    for path, g, w, sl in zip(want["paths"], got["leaves"], want["leaves"],
                              _tp_blocks(want["mdl"], coords)):
        check(g.shape == w[sl].shape
              and np.allclose(g, w[sl], rtol=TRAIN_TOL, atol=TRAIN_TOL),
              f"tp-ranks: {case} rank {r} a block off the one process "
              f"({g.shape} vs {w[sl].shape})")
        if g.size:
            worst = max(worst, float(np.abs(g - w[sl]).max()))
        if path.startswith(("opt.m.", "opt.v.")):
            rtol = TP_GRAD_RTOL * (2 if path[4] == "v" else 1)
            err = np.linalg.norm((g - w[sl]).astype(np.float64))
            norm = np.linalg.norm(w[sl].astype(np.float64))
            check(err <= rtol * norm,
                  f"tp-ranks: {case} rank {r} {path} ‖err‖ {err:.3e} of "
                  f"‖want‖ {norm:.3e} (limit {rtol})")
            moment = max(moment, err / max(norm, 1e-30) / rtol)
    check(got["calls"].get((("model",), "sum"), 0) > 0,
          f"tp-ranks: {case} rank {r} no sum over model {got['calls']}")
    for name in names:
        check(got["launches"][name] > 0,
              f"tp-ranks: {case} rank {r} {name} launches "
              f"{got['launches']}")
    return worst, moment


def _tp_blocks(mdl, coords, params_only=False):
    """The block slices of every state leaf (sorted-key order; of the
    params only with `params_only`) of a rank at `coords` on TP_SHAPE, by
    the reference's rules, without a process group."""
    import types
    from repro_torch.models.params import (LOGICAL_RULES_TP, ParamSpec,
                                           block_slices, resolve_axes)
    from repro_torch.optim import opt_specs
    axes = ("data", "model")
    m = types.SimpleNamespace(axis_names=axes,
                              devices=np.empty(TP_SHAPE),
                              shape=dict(zip(axes, TP_SHAPE)), coords=coords)
    specs = _named_leaves(mdl.param_tree if params_only else {
        "params": mdl.param_tree, "opt": opt_specs(mdl.param_tree),
        "step": ParamSpec((), "float32", ())})
    return [block_slices(s.shape, resolve_axes(s.axes, s.shape, m,
                                               LOGICAL_RULES_TP), m)
            for _, s in specs]


def phase_tp_ranks(device="cuda", layers=TP_TRAIN_LAYERS, smoke=False):
    """Phase 35: the train state held in blocks over a (4, 2) ("data",
    "model") mesh, eight gloo ranks on the one card with CUDA tensors,
    started as fresh interpreters after the kernels were built. (a) The
    f32 smoke twins of tinyllama, pixtral, llama4-scout, dbrx (2
    microbatches), rwkv6, jamba and whisper take one step each from their
    blocks:
    loss, metrics, grad_norm and every rank's blocks within 1e-4 of a
    one-process CPU step, the sums over "model" counted, the flash
    kernels (and for rwkv6 `wkv6` and `wkv6_bwd`) launched on the ranks'
    own heads, each block of m and v within TP_GRAD_RTOL of its norm.
    (c) whisper-tiny at full width and depth in f32 (`_tp_audio`, 6 heads
    split 3 a rank) one step at TP_AUDIO_BATCH over 1,500 frames, held
    the same way to a one-process step on the card made first.
    (b) tinyllama-1.1b at full width (d 2,048, 32/4 heads, d_ff 5,632,
    vocab 32,000; `layers` of its 22), bf16, its blocks drawn on the card
    from seed 0: TP_TRAIN_STEPS steps at 8 x 2,048 against one-process
    card runs from the same seed (run first, alone on the card): the loss
    after each and grad_norm within TP_LIMITS of the bf16 run's, m after
    the last step by the noise rule against the f32 run's, and the
    unchanged-state control failing the loss and m checks; each rank's state bytes, ms a step, collectives by
    group and kernel launches (16 q and 2 kv heads a rank). A rank that
    fails or passes TP_RANK_TIMEOUT fails the phase. A CPU rehearsal: `phase_tp_ranks(device="cpu", layers=4,
    smoke=True)` (plain versions; (b) on the bf16 smoke twin at 8 x
    64)."""
    import os
    import pickle
    import shutil
    import torch
    from repro_torch.models import build
    from repro_torch.models.steps import init_train_state, make_train_step
    t0 = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    d = ROOT / "build" / "tp" / f"ranks-{os.getpid()}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)

    # (b)'s runs on one process first, alone on the card: bf16, the
    # control (the drawn state's last step) and f32 from the same state
    cfg = _tp_train_cfg(layers, smoke)
    mdl = build(cfg)
    if cuda:
        torch.cuda.empty_cache()
    ref = _tp_one_process(cfg, dev, smoke)
    one_losses, one_ms = ref["losses"], ref["ms"]
    whole_bytes = ref["state_bytes"]
    ctrl = _tp_one_process(cfg, dev, smoke, steps=[TP_TRAIN_STEPS - 1])
    f32 = _tp_one_process(cfg, dev, smoke, dtype=torch.float32)
    audio_one = _tp_audio(dev, smoke)

    rng = np.random.default_rng(SEED + 35)
    bsz, seq = TP_TWIN_BATCH
    twin_batches = {case: {k: v.numpy() for k, v in _train_batch(
        _tp_twin_cfg(case), rng, b=bsz, s=seq).items()}
        for case in TP_TWINS}
    with open(d / "twin_batches.pkl", "wb") as f:
        pickle.dump(twin_batches, f)
    world = int(np.prod(TP_SHAPE))
    env = dict(os.environ, TP_DIR=str(d), TP_DEVICE=device,
               TP_INIT=_rendezvous(d), TP_LAYERS=str(layers),
               TP_SMOKE="1" if smoke else "0",
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    procs = []
    try:
        for r in range(world):
            log = open(d / f"log{r}.txt", "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", "import chip_smoke as c; c.tp_rank()"],
                cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT,
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r))), log))
        # meanwhile, (a)'s one-process steps on the CPU
        one = {}
        threads = torch.get_num_threads()
        torch.set_num_threads(4)
        for case in TP_TWINS:
            tmdl = build(_tp_twin_cfg(case))
            st = init_train_state(tmdl, SEED, device="cpu")
            batch = {k: torch.from_numpy(v)
                     for k, v in twin_batches[case].items()}
            st, met = make_train_step(tmdl)(st, batch)
            named = _named_leaves(st)
            one[case] = dict(mdl=tmdl, metrics={k: float(v)
                                                for k, v in met.items()},
                             paths=[p for p, _ in named],
                             leaves=[t.detach().numpy() for _, t in named])
        torch.set_num_threads(threads)
        deadline = time.monotonic() + TP_RANK_TIMEOUT
        for r, (p, log) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                for q, _ in procs:
                    q.kill()
                tails = "\n".join(
                    f"--- rank {i}\n" + (d / f"log{i}.txt").read_text()[-1500:]
                    for i in range(world))
                raise SmokeFailure(f"tp-ranks: rank {r} ended with {rc}\n"
                                   + tails)
        outs = []
        for r in range(world):
            with open(d / f"rank{r}.pkl", "rb") as f:
                outs.append(pickle.load(f))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
            log.close()

    model = TP_SHAPE[1]
    twin_launches = {}
    for case in TP_TWINS:
        want = one[case]
        worst = moment = 0.0
        for r, o in enumerate(outs):
            check(o["coords"] == {"data": r // model, "model": r % model},
                  f"tp-ranks: rank {r} coords {o['coords']}")
            names = (("wkv6", "wkv6_bwd") if case == "ssm" else
                     ("flash_attention", "flash_attention_bwd"))
            w, m = _tp_held(case, r, o["twins"][case], want, o["coords"],
                            names if cuda else ())
            worst, moment = max(worst, w), max(moment, m)
        twin_launches[case] = [o["twins"][case]["launches"] for o in outs]
        say("tp-ranks", path="twin", case=case, arch=TP_TWINS[case][0],
            microbatches=TP_TWINS[case][1], mesh=TP_SHAPE,
            batch="x".join(map(str, TP_TWIN_BATCH)),
            loss=f"{outs[0]['twins'][case]['metrics']['loss']:.6f}",
            one_process_loss=f"{want['metrics']['loss']:.6f}",
            aux=f"{outs[0]['twins'][case]['metrics']['aux']:.6f}",
            max_abs_err=f"{worst:.3e}",
            moments_of_limit=f"{moment:.3f}",
            launches_rank0=twin_launches[case][0],
            calls_rank0={f"{'.'.join(a)}:{op}": n for (a, op), n in
                         sorted(outs[0]["twins"][case]["calls"].items())})

    # 35c: whisper-tiny at full width against one process on the card
    worst = moment = 0.0
    for r, o in enumerate(outs):
        w, m = _tp_held("whisper-tiny", r, o["audio"], audio_one,
                        o["coords"], ("flash_attention",
                                      "flash_attention_bwd") if cuda else ())
        worst, moment = max(worst, w), max(moment, m)
        wq = o["audio"]["leaves"][audio_one["paths"].index(
            "params.dec_blocks.attn.wq")]
        check(wq.shape[2] == 3, f"tp-ranks: whisper-tiny rank {r} holds "
              f"{wq.shape[2]} of the 6 q heads")
    audio = [o["audio"] for o in outs]
    say("tp-ranks", path="audio", arch=TP_AUDIO, dtype="float32",
        mesh=TP_SHAPE, batch="x".join(map(
            str, TP_AUDIO_SMOKE if smoke else TP_AUDIO_BATCH)),
        frames=audio_one["mdl"].cfg.encoder_seq_len,
        loss=f"{audio[0]['metrics']['loss']:.6f}",
        one_process_loss=f"{audio_one['metrics']['loss']:.6f}",
        grad_norm=f"{audio[0]['metrics']['grad_norm']:.6f}",
        one_process_grad_norm=f"{audio_one['metrics']['grad_norm']:.6f}",
        max_abs_err=f"{worst:.3e}", moments_of_limit=f"{moment:.3f}",
        ms_rank0=f"{audio[0]['ms']:.1f}",
        ms=",".join(f"{x['ms']:.1f}" for x in audio),
        one_process_ms=f"{audio_one['ms']:.1f}",
        stream_positions_a_rank=audio[0]["positions"],
        encoder_positions_a_rank=audio[0]["enc_positions"],
        peak_gb=",".join(f"{x['peak_gb']:.3f}" for x in audio),
        one_process_peak_gb=f"{audio_one['peak_gb']:.3f}",
        model_calls_bytes_rank0=_tp_model_ops(audio[0]["calls"],
                                              audio[0]["bytes"]),
        launches_rank0=audio[0]["launches"],
        one_process_launches=audio_one["launches"],
        calls_rank0={f"{'.'.join(a)}:{op}": n for (a, op), n in
                     sorted(audio[0]["calls"].items())})
    for r, x in enumerate(audio):
        split = x["positions"] < audio_one["positions"]
        check(split == (x["calls"].get((("model",), "reduce_scatter"), 0)
                        > 0), f"tp-ranks: whisper-tiny rank {r} keeps "
              f"{x['positions']} of {audio_one['positions']} positions, "
              f"calls {x['calls']}")

    tr = [o["train"] for o in outs]
    lim = TP_LIMITS["rehearsal" if smoke else "card"]

    def gap(got, want):
        return abs(got - want) / abs(want) if np.isfinite(got) else np.inf

    def gaps(key, want):        # the worst (first step, later steps)
        g = [max(gap(x[key][i], w) for x in tr) for i, w in enumerate(want)]
        return g[0], max(g[1:], default=0.0)

    # m by the noise rule, leaf by leaf; the control's m is zero
    sums = _tp_noise([x["m"] for x in tr], ref["m"], f32["m"], mdl,
                     [o["coords"] for o in outs])
    ratios = {p: float(np.sqrt(a[0] / max(a[1], 1e-300)))
              for p, a in sums.items()}
    sizes = {p: t.numel() for p, t in ref["m"].items()}
    ctrl_ratios = {p: float(np.sqrt(a[4] / max(a[1], 1e-300)))
                   for p, a in sums.items()}
    total = [float(np.sqrt(sum(a[i] for a in sums.values())))
             for i in range(5)]
    # the control, a sharded step that never updated its state: the last
    # step's loss and grad_norm of the drawn state, m zero
    last = TP_TRAIN_STEPS - 1
    ctrl_gaps = dict(loss=gap(ctrl["losses"][0], one_losses[last]),
                     grad_norm=gap(ctrl["gnorms"][0], ref["gnorms"][last]))
    ctrl_fails = dict(loss=ctrl_gaps["loss"] > lim["loss"][1],
                      grad_norm=ctrl_gaps["grad_norm"] > lim["grad_norm"][1],
                      m=all(v > NOISE_RATIO for v in ctrl_ratios.values()))
    loss_gap = gaps("losses", one_losses)
    gnorm_gap = gaps("gnorms", ref["gnorms"])
    say("tp-ranks", path="train-checks", arch=cfg.name,
        grad_norms=",".join(f"{v:.6f}" for v in tr[0]["gnorms"]),
        one_process_grad_norms=",".join(f"{v:.6f}" for v in ref["gnorms"]),
        f32_grad_norms=",".join(f"{v:.6f}" for v in f32["gnorms"]),
        grad_norm_rel_gap=",".join(f"{v:.3e}" for v in gnorm_gap),
        grad_norm_limit=",".join(f"{v:.0e}" for v in lim["grad_norm"]),
        f32_losses=",".join(f"{v:.6f}" for v in f32["losses"]),
        m_leaves=len(ratios), m_noise_ratio_max=f"{max(ratios.values()):.4f}",
        m_noise_ratio_all=f"{total[0] / total[1]:.4f}",
        m_rel_gap_one_process=f"{total[2] / total[3]:.3e}",
        m_rel_gap_f32=f"{total[1] / total[3]:.3e}",
        control_loss=f"{ctrl['losses'][0]:.6f}",
        control_loss_rel_gap=f"{ctrl_gaps['loss']:.3e}",
        control_grad_norm=f"{ctrl['gnorms'][0]:.6f}",
        control_grad_norm_rel_gap=f"{ctrl_gaps['grad_norm']:.3e}",
        control_m_noise_ratio_min=f"{min(ctrl_ratios.values()):.2f}",
        control_fails=ctrl_fails,
        f32_ms_steps=",".join(f"{v:.1f}" for v in f32["ms"]))
    say("tp-ranks", path="train-m", **{p.replace(".", "/"): f"{v:.4f}"
                                       for p, v in sorted(ratios.items())})
    say("tp-ranks", path="train", arch=cfg.name, layers=layers,
        of_layers=22, dtype="bfloat16", mesh=TP_SHAPE,
        batch="x".join(map(str, TP_TWIN_BATCH if smoke else TRAIN_BATCH)),
        steps=len(one_losses), warmup=TP_WARMUP,
        losses=",".join(f"{v:.6f}" for v in tr[0]["losses"]),
        one_process_losses=",".join(f"{v:.6f}" for v in one_losses),
        rel_gap=",".join(f"{v:.3e}" for v in loss_gap),
        limit=",".join(f"{v:.0e}" for v in lim["loss"]),
        ms_steps_rank0=",".join(f"{v:.1f}" for v in tr[0]["ms"]),
        ms_last_step=",".join(f"{x['ms'][-1]:.1f}" for x in tr),
        one_process_ms_steps=",".join(f"{v:.1f}" for v in one_ms),
        state_bytes=[x["state_bytes"] for x in tr],
        whole_state_bytes=whole_bytes,
        stream_positions_a_rank=tr[0]["positions"],
        model_calls_bytes_rank0=_tp_model_ops(tr[0]["calls"],
                                              tr[0]["bytes"]),
        peak_gb=",".join(f"{x['peak_gb']:.3f}" for x in tr),
        launches_rank0=tr[0]["launches"],
        all_reduce_share=",".join(
            f"{x['all_reduce_s'] * 1e3 / sum(x['ms']):.4f}" for x in tr),
        all_reduce_gb_a_step=f"{tr[0]['all_reduce_bytes'] / len(one_losses) / 1e9:.3f}",
        calls_rank0={f"{'.'.join(a)}:{op}": n for (a, op), n in
                     sorted(tr[0]["calls"].items())})

    for key, got in (("loss", loss_gap), ("grad_norm", gnorm_gap)):
        check(all(g <= t for g, t in zip(got, lim[key])),
              f"tp-ranks: tinyllama {key} {got} from one process's "
              f"(limits {lim[key]})")
    for p, v in ratios.items():
        check(v <= NOISE_RATIO or sizes[p] < TP_M_LEAF_MIN,
              f"tp-ranks: m {p} is {v:.3f}x as far from f32 as one "
              f"process's (limit {NOISE_RATIO})")
    check(total[0] <= NOISE_RATIO * total[1],
          f"tp-ranks: m {total[0]:.3e} from f32, one process {total[1]:.3e}")
    check(ctrl_fails["loss"] and ctrl_fails["m"],
          f"tp-ranks: the unchanged-state control passes a check "
          f"{ctrl_fails}")
    n = len(one_losses)
    for r, x in enumerate(tr):
        check(x["losses"] == tr[0]["losses"]
              and x["gnorms"] == tr[0]["gnorms"],
              f"tp-ranks: rank {r} losses or grad_norms differ from "
              f"rank 0's")
        if cuda:
            check(x["launches"]["flash_attention"] == 2 * layers * n
                  and x["launches"]["flash_attention_bwd"] == layers * n,
                  f"tp-ranks: rank {r} flash launches {x['launches']}")
        check(x["state_bytes"] < whole_bytes / 4,
              f"tp-ranks: rank {r} holds {x['state_bytes']} of "
              f"{whole_bytes} bytes")
        check(x["positions"] == (TP_TWIN_BATCH if smoke else TRAIN_BATCH)[1]
              // TP_SHAPE[1] and x["calls"].get(
                  (("model",), "reduce_scatter"), 0) > 0,
              f"tp-ranks: rank {r} keeps {x['positions']} positions of the "
              f"stream, calls {x['calls']}")
    shutil.rmtree(d, ignore_errors=True)
    seconds = time.perf_counter() - t0
    say("tp-ranks", seconds=f"{seconds:.2f}")
    return dict(
        seconds=seconds, twin_launches=twin_launches,
        audio_launches={name: [x["launches"][name] for x in audio]
                        for name in ("flash_attention",
                                     "flash_attention_bwd")},
        launches={name: [x["launches"][name] for x in tr]
                  for name in ("flash_attention", "flash_attention_bwd")},
        ssm_launches={name: [x["wkv6"] if name == "wkv6" else
                             x["wkv6_bwd"] for x in twin_launches["ssm"]]
                      for name in ("wkv6", "wkv6_bwd")},
        losses=tr[0]["losses"], one_losses=one_losses,
        ms=[x["ms"] for x in tr], state_bytes=[x["state_bytes"] for x in tr],
        all_reduce_s=[x["all_reduce_s"] for x in tr],
        steps=len(one_losses), layers=layers, calls=tr[0]["calls"],
        bytes=tr[0]["bytes"], all_reduce_bytes=tr[0]["all_reduce_bytes"])


# ---------------------------------------------------------------------------
# phase 36: the dry run and the decode cache in blocks
# ---------------------------------------------------------------------------

DM_SHAPE = (4, 2)              # 36c: ("data", "model"), eight gloo ranks
DM_TWINS = {"dense": ("tinyllama-1.1b", {}),
            "mha": ("qwen1.5-32b", dict(num_kv_heads=4, head_pad_to=6,
                                        kv_cache_dtype="")),
            "mha_f8": ("qwen1.5-32b", dict(num_kv_heads=4, head_pad_to=6,
                                           kv_cache_dtype="float8_e4m3fn")),
            "moe": ("llama4-scout-17b-a16e", {}),
            "ssm": ("rwkv6-3b", {}),
            "hybrid": ("jamba-v0.1-52b", {}),
            "audio": ("whisper-tiny", {})}
DM_TWIN_RUN = (8, 4, 8, 16)    # the f32 twins: batch, prompt, greedy steps,
                               # cache positions
DM_TOL = 1e-5                  # the f32 twins, mesh against one process
# an f8 cache turns a last-bit difference of the card's head-sliced
# products (a rank projects its heads alone) into a neighbouring code
# where a value lies at a rounding edge, and the logits move with it:
# held by tokens and codes, the logits' gap reported
DM_F8 = ("mha_f8",)
DM_LM = (8, 2048, 16)          # tinyllama-1.1b: batch, cache rows, steps at
                               # the cache's end (cut from 32 for the time)
DM_LM_LAYERS = 1               # ... of its 22: every step gathers the
                               # FSDP blocks of its weights over "data",
                               # whose gloo all-reduces stage through the
                               # host (about 0.3 GB/s in phase 35)
DM_LM_SMOKE = (8, 64, 8)       # ... its bf16 smoke twin's (CPU rehearsal)
# 36d: whisper-tiny at full width and depth in f32 (its self and cross
# caches over its 16 padded heads, 8 a rank): batch, cache rows (its
# decoder's context), greedy steps from position 0, against a cross cache
# filled from `encode` of seeded frames
DM_AUDIO = (8, 448, 8)
DM_AUDIO_SMOKE = (8, 32, 8)    # ... in the CPU rehearsal
# its logits, mesh against one process, both f32 on the card: the twins'
# limit (the CPU rehearsal read 1.8e-7 at full width, 8 steps)
DM_AUDIO_TOL = DM_TOL
DM_RANK_TIMEOUT = 300          # s, the eight ranks of 36c together
# 36b: phase 30's max_memory_allocated over the dry run's predicted peak
# (arguments + the step's live peak on meta tensors: 20.49 GB), set from
# the card's readings (PERF.md: 21.26-21.40 GB, ratios 1.037-1.044): the
# count sees no allocator rounding, cuBLAS workspace or cached blocks,
# which only add
DRY_PEAK_RATIO = (1.0, 1.1)


def _lse_kernel_checks():
    """36a: `decode_attention` with its logsumexp and a row offset (a
    rank's block of a cache split over its rows) against
    `decode_attention_block_ref`, then timed beside the null-lse call.
    Returns the record."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_block_ref)
    f32, bf16, f8 = torch.float32, torch.bfloat16, torch.float8_e4m3fn
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 36)

    def card(shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    # (name, b, nkv, group, hd, block rows, row0, index, q, cache):
    # decode_32k on (16, 16) at tinyllama's heads: 8 rows a rank, 2,048 of
    # 32,768 positions a block; long_500k at jamba's heads: batch 1,
    # 2,048 of 524,288 a block (8 kv heads, so the split plan combines)
    blk = 2048
    cases = [
        ("decode_32k-last-block", 8, 4, 8, 64, blk, 15 * blk, 32767, bf16,
         bf16),
        ("decode_32k-full-block", 8, 4, 8, 64, blk, 7 * blk, 32767, bf16,
         bf16),
        ("decode_32k-partial-block", 8, 4, 8, 64, blk, 7 * blk,
         7 * blk + 1000, bf16, bf16),
        ("decode_32k-empty-block", 8, 4, 8, 64, blk, 8 * blk,
         7 * blk + 1000, bf16, bf16),
        ("long_500k-full-block", 1, 8, 4, 128, blk, 100 * blk, 524287, bf16,
         bf16),
        ("long_500k-partial-block", 1, 8, 4, 128, blk, 255 * blk,
         255 * blk + 77, bf16, bf16),
        ("f32-partial-block", 2, 4, 8, 64, 512, 512, 700, f32, f32),
        ("f8-full-block", 8, 4, 8, 64, blk, 3 * blk, 32767, bf16, f8),
    ]
    errs, lse_errs = [], []
    for name, b, nkv, g, hd, S, row0, index, qdt, kvdt in cases:
        q = card((b, nkv, g, hd), qdt)
        K, V = card((b, S, nkv, hd), qdt).to(kvdt), card(
            (b, S, nkv, hd), qdt).to(kvdt)
        before = dk.decode_attention.launches
        out, lse = dk.decode_attention(q, K, V, index, with_lse=True,
                                       row0=row0)
        launched = dk.decode_attention.launches - before
        want, want_lse = decode_attention_block_ref(q, K, V, index, row0)
        torch.cuda.synchronize()
        n = min(index - row0 + 1, S)
        if n <= 0:
            check(launched == 0 and torch.all(out == 0)
                  and torch.all(lse == float("-inf")),
                  f"{name}: an empty block launched or gave nonzero out "
                  f"or a finite lse")
            say("lse-kernel", case=name, rows=0, launched=launched)
            continue
        splits = dk.split_plan(n, b * nkv)[0] if qdt == bf16 else 1
        errs.append(_within(f"lse-{name}", out, want, qdt, norm=True,
                            splits=splits, rows=n))
        e = (lse - want_lse).abs()
        lse_err = float(e.max())
        check(bool((e <= LSE_TOL + LSE_TOL * want_lse.abs()).all()),
              f"{name}: lse off its plain version by {lse_err:.3e}")
        lse_errs.append(lse_err)
        again = dk.decode_attention(q, K, V, index, row0=row0)
        check(torch.equal(out, again),
              f"{name}: the null-lse call's output differs from the lse "
              f"call's")
        say("lse-kernel", case=name, rows=n, splits=splits,
            lse_max_abs_err=f"{lse_err:.3e}", launched=launched)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    timed = {}
    for name, b, nkv, g, hd in (("decode_32k", 8, 4, 8, 64),
                                ("long_500k", 1, 8, 4, 128)):
        q = card((b, nkv, g, hd), bf16)
        K, V = card((b, blk, nkv, hd), bf16), card((b, blk, nkv, hd), bf16)
        index = 10 * blk                     # past the block: all rows
        ms = _events_ms(lambda: dk.decode_attention(q, K, V, index, row0=0),
                        50, flush)
        lse_ms = _events_ms(lambda: dk.decode_attention(
            q, K, V, index, with_lse=True, row0=0), 50, flush)
        plain_ms = _events_ms(lambda: decode_attention_block_ref(
            q, K, V, index, 0), 5, flush)
        bound_ms, bound_by = _bound(dk.decode_attention_cost(
            b, nkv, g, hd, blk, 2, 2, lse=True), H100_BF16_FLOPS)
        timed[name] = dict(ms=ms, lse_ms=lse_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           shape=f"b {b}, block {blk} rows, {nkv * g}/{nkv} "
                                 f"heads, hd {hd}")
        say("lse-kernel-time", block=name, shape=timed[name]["shape"],
            null_lse_ms=f"{ms:.5f}", lse_ms=f"{lse_ms:.5f}",
            plain_ms=f"{plain_ms:.5f}", bound_ms=f"{bound_ms:.5f}",
            bound_by=bound_by, lse_over_null=f"{lse_ms / ms:.4f}")
    return dict(max_abs_err=max(errs), lse_max_abs_err=max(lse_errs),
                cases=len(cases), timed=timed)


def _dry_checks(train=None, tp=None):
    """36b: the dry run of phases 30's and 35's cells on the host, on meta
    tensors: tinyllama-1.1b at TRAIN_BATCH without a mesh and at
    TP_SHAPE rank 0 (at phase 35's layers). The flash calls a step; where
    the script ran them, the collective calls and bytes a step against
    phase 35's rank 0 and the predicted peak against phase 30's. Returns
    the record."""
    import dataclasses
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_stats import collective_bytes, records
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.roofline import param_counts
    shape = ShapeConfig("phase30", TRAIN_BATCH[1], TRAIN_BATCH[0], "train")
    active = param_counts()[TRAIN_ARCH][1]
    full = get_config(TRAIN_ARCH)
    out = {}
    for tag, mesh, cfg in (
            ("one", None, full),
            ("tp", mesh_lib.Mesh.abstract(TP_SHAPE, ("data", "model"), 0),
             dataclasses.replace(full, num_layers=TP_TRAIN_LAYERS if tp is
                                 None else tp["layers"]))):
        t = time.perf_counter()
        lowered, _, _ = dryrun.lower_lm_cell(TRAIN_ARCH, shape, mesh,
                                             cfg=cfg)
        m = dryrun.measure(lowered["train_step"][0])
        recs = records(mesh_lib.CALLS, mesh_lib.BYTES)
        k = {name: v["calls"] for name, v in m["kernels"].items()}
        check(k == {"flash_attention": 2 * cfg.num_layers,
                    "flash_attention_bwd": cfg.num_layers},
              f"dry run ({tag}): flash calls a step {k}")
        mem = m["memory"]
        out[tag] = dict(flops=m["flops"], bytes=m["bytes"],
                        collectives=m["collectives"], records=recs,
                        argument_bytes=mem["argument_bytes"],
                        temp_bytes=mem["temp_bytes"],
                        peak_bytes=mem["argument_bytes"] + mem["temp_bytes"],
                        seconds=time.perf_counter() - t, kernels=k)
        say("dry-run", cell=f"{TRAIN_ARCH} {TRAIN_BATCH[0]}x{TRAIN_BATCH[1]}",
            mesh=("none" if mesh is None else f"{TP_SHAPE} rank 0"),
            layers=cfg.num_layers,
            flops=f"{m['flops']:.6e}", bytes=f"{m['bytes']:.6e}",
            model_flops_6NT=f"{6 * active * TRAIN_BATCH[0] * TRAIN_BATCH[1]:.6e}",
            collective_bytes=m["collectives"].get("total", 0),
            argument_bytes=mem["argument_bytes"],
            temp_bytes=mem["temp_bytes"], kernels=k,
            seconds=f"{out[tag]['seconds']:.2f}")
    if tp is not None:
        steps = tp["steps"]
        want = records(tp["calls"], tp["bytes"])
        got = {key: {"calls": r["calls"] * steps, "bytes": r["bytes"] * steps}
               for key, r in out["tp"]["records"].items()}
        check(got == want, f"dry run: collectives a step {got} != phase "
              f"35's rank 0 {want} / {steps}")
        per_step = collective_bytes(out["tp"]["records"])["total"]
        check(per_step * steps == tp["all_reduce_bytes"],
              f"dry run: {per_step} bytes a step, phase 35 moved "
              f"{tp['all_reduce_bytes']} in {steps} steps")
        say("dry-run", check="collectives", per_step_bytes=per_step,
            phase35_bytes_a_step=tp["all_reduce_bytes"] // steps,
            equal=True)
    out["audio"] = _dry_audio()
    if train is not None:
        measured = train["peak_memory_gb"] * 1e9
        ratio = measured / out["one"]["peak_bytes"]
        out["peak_ratio"] = ratio
        say("dry-run", check="peak", predicted_gb=f"{out['one']['peak_bytes'] / 1e9:.3f}",
            measured_gb=f"{measured / 1e9:.3f}", ratio=f"{ratio:.4f}",
            limit=DRY_PEAK_RATIO)
        check(DRY_PEAK_RATIO[0] <= ratio <= DRY_PEAK_RATIO[1],
              f"dry run: phase 30's peak is {ratio:.4f} of the predicted "
              f"(limits {DRY_PEAK_RATIO})")
    return out


# 36b: whisper-tiny's cells on the single-pod mesh (16, 16), rank 0:
# "model" 16 does not divide its 6 heads (its layers whole on every
# rank), its cache over its 16 padded heads (one a rank); the kernel calls
# a step (the flash forward twice a decoder layer under remat "full") and
# the units of the split
DRY_AUDIO = {"train_4k": ({"flash_attention": 8, "flash_attention_bwd": 4},
                          {"block_enc_blocks", "block_dec_blocks", "loss"}),
             "decode_32k": ({"decode_attention": 8}, {"decode_dec_blocks"})}


def _dry_audio():
    """36b: the dry run of whisper-tiny's train_4k and decode_32k cells
    (`dryrun.run_cell`, nothing written): the reference's keys, the kernel
    calls and the units of DRY_AUDIO. Returns {shape: record}."""
    from repro_torch.launch import dryrun
    out = {}
    for shape, (kernels, units) in DRY_AUDIO.items():
        t = time.perf_counter()
        rec = dryrun.run_cell(TP_AUDIO, shape, False, "")
        step, = rec["steps"]
        corr = step["loop_corrected"]
        k = {name: v["calls"] for name, v in step["kernels"].items()}
        check(rec["ok"] and {"flops_per_device", "bytes_per_device",
                             "collectives", "memory"} <= set(step),
              f"dry run: {TP_AUDIO} {shape} record {sorted(step)}")
        check(k == kernels and set(corr["detail"]) == units,
              f"dry run: {TP_AUDIO} {shape} kernel calls {k}, units "
              f"{sorted(corr['detail'])}")
        mem = step["memory"]
        out[shape] = dict(flops=step["flops_per_device"],
                          bytes=step["bytes_per_device"],
                          collective_bytes=step["collectives"].get(
                              "total", 0),
                          argument_bytes=mem["argument_bytes"],
                          temp_bytes=mem["temp_bytes"], kernels=k,
                          fixed_flops=corr["fixed"]["flops"],
                          seconds=time.perf_counter() - t)
        say("dry-run", cell=f"{TP_AUDIO} {shape}", mesh="(16, 16) rank 0",
            flops=f"{out[shape]['flops']:.6e}",
            bytes=f"{out[shape]['bytes']:.6e}",
            collective_bytes=out[shape]["collective_bytes"],
            argument_bytes=mem["argument_bytes"],
            temp_bytes=mem["temp_bytes"], kernels=k,
            units=sorted(corr["detail"]),
            fixed_flops=corr["fixed"]["flops"],
            seconds=f"{out[shape]['seconds']:.2f}")
    return out


def _dm_twin_cfg(case):
    import dataclasses
    from repro_torch.configs import smoke_config
    arch, extra = DM_TWINS[case]
    return dataclasses.replace(smoke_config(arch), dtype="float32",
                               param_dtype="float32", **extra)


def _dm_decode(mdl, params, cache, forced, start, greedy=0, mesh=None,
               spec=None, timed=False):
    """Decode from index `start`: the tokens of `forced` (b, n) one a step,
    then `greedy` greedy steps. Returns the logits (steps, b, vocab) f32
    and the argmax tokens (steps, b) as numpy, and the ms of each step."""
    import contextlib
    import torch
    logits, ms = [], []
    tok = forced[:, :1]
    dev = forced.device
    for i in range(forced.shape[1] + greedy):
        _sync(dev)
        t = time.perf_counter()
        with torch.no_grad(), (mesh if mesh is not None
                               else contextlib.nullcontext()):
            lg, cache = mdl.decode(params, cache, tok, start + i, spec)
        nxt = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        _sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
        logits.append(lg[:, -1].float().cpu().numpy())
        tok = forced[:, i + 1:i + 2] if i + 1 < forced.shape[1] else nxt
    return np.stack(logits), np.stack(logits).argmax(-1), ms, cache


def _dm_leaves(tree, path=""):
    import torch
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _dm_leaves(tree[k], f"{path}/{k}")]
    t = tree.detach().cpu()
    return [(path, t.view(torch.uint8).numpy() if t.dtype ==
             torch.float8_e4m3fn else t.numpy())]


def _dm_twin(case, dev, mesh=None):
    """One f32 twin: the prompt teacher-forced into an empty cache, then
    greedy steps; logits, tokens and the cache's leaves."""
    import torch
    from repro_torch.launch.mesh import row_block
    from repro_torch.models import build, layers
    from repro_torch.models.params import init_params
    from repro_torch.models.steps import init_cache
    b, prompt, steps, S = DM_TWIN_RUN
    mdl = build(_dm_twin_cfg(case))
    rng = np.random.default_rng(SEED + 36)
    toks = torch.tensor(rng.integers(0, mdl.cfg.vocab_size, (b, prompt)),
                        dtype=torch.int32, device=dev)
    spec = None
    if mesh is not None:
        toks = toks[row_block(mesh, b)]
        spec = layers.cache_spec(mdl.cfg, b, S, mesh)
    params = init_params(mdl.param_tree, SEED, dev, mesh)
    cache = init_cache(mdl, b, S, dev, mesh=mesh)
    if mdl.cfg.family == "audio":
        _dm_cross(mdl, params, cache, rng, b, dev, mesh, spec)
    logits, tokens, _, cache = _dm_decode(mdl, params, cache, toks, 0, steps,
                                          mesh, spec)
    return dict(logits=logits, tokens=tokens, cache=_dm_leaves(cache))


def _dm_cross(mdl, params, cache, rng, b, dev, mesh=None, spec=None):
    """The audio family's cross cache from `encode` of seeded frames (b,
    encoder_seq_len, d), the rank's rows and heads on `mesh`."""
    import contextlib
    import torch
    from repro_torch.launch.mesh import row_block
    frames = torch.tensor(rng.normal(size=(b, mdl.cfg.encoder_seq_len,
                                           mdl.cfg.d_model)),
                          dtype=torch.float32, device=dev)
    if mesh is not None:
        frames = frames[row_block(mesh, b)]
    with torch.no_grad(), (mesh if mesh is not None
                           else contextlib.nullcontext()):
        mdl.fill_cross_cache(params, cache, frames, spec)


def _dm_audio(dev, smoke, forced=None, mesh=None):
    """36d: whisper-tiny (f32, full width and depth) from SEED, its cross
    cache filled from seeded frames; greedy steps from position 0 (one
    process), or on `mesh` teacher-forced with `forced`, one process's
    tokens. Returns the logits, tokens, ms a step and the decode
    launches."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.launch.mesh import row_block
    from repro_torch.models import build, layers
    from repro_torch.models.params import init_params
    from repro_torch.models.steps import init_cache
    b, S, steps = DM_AUDIO_SMOKE if smoke else DM_AUDIO
    mdl = build(dataclasses.replace(get_config(TP_AUDIO), dtype="float32",
                                    param_dtype="float32"))
    rng = np.random.default_rng(SEED + 362)
    start = torch.tensor(rng.integers(0, mdl.cfg.vocab_size, (b, 1)),
                         dtype=torch.int32, device=dev)
    spec = None if mesh is None else layers.cache_spec(mdl.cfg, b, S, mesh)
    params = init_params(mdl.param_tree, SEED, dev, mesh)
    cache = init_cache(mdl, b, S, dev, mesh=mesh)
    _dm_cross(mdl, params, cache, rng, b, dev, mesh, spec)
    dk.decode_attention.launches = 0
    if mesh is None:
        logits, tokens, ms, _ = _dm_decode(mdl, params, cache, start, 0,
                                           steps - 1)
    else:
        forced = torch.from_numpy(forced).to(dev)[row_block(mesh, b)]
        logits, tokens, ms, _ = _dm_decode(mdl, params, cache, forced, 0,
                                           0, mesh, spec)
    return dict(logits=logits, tokens=tokens, ms=ms,
                start=start.cpu().numpy(), layers=mdl.cfg.num_layers,
                launches=dk.decode_attention.launches)


def _dm_lm(smoke):
    return DM_LM_SMOKE if smoke else DM_LM


def _dm_lm_state(dev, mesh=None, dtype=None, smoke=False):
    """tinyllama-1.1b's params (`smoke`: its bf16 smoke twin's) drawn from
    SEED and a cache of DM_LM rows filled with N(0, 1) values (its k/v
    drawn as `normal` leaves of std 1 from SEED + 36), whole or the rank's
    blocks; cast to `dtype` where given (the f32 anchor, its model built
    in f32)."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import build
    from repro_torch.models.params import ParamSpec, init_params, \
        tree_map_specs
    cfg = (smoke_config(TRAIN_ARCH) if smoke else dataclasses.replace(
        get_config(TRAIN_ARCH), num_layers=DM_LM_LAYERS))
    mdl = build(cfg)
    b, S, _ = _dm_lm(smoke)
    params = init_params(mdl.param_tree, SEED, dev, mesh)
    specs = tree_map_specs(lambda s: ParamSpec(s.shape, s.dtype, s.axes,
                                               "normal", 50.0),
                           mdl.cache_specs(b, S, padded=mesh is not None))
    cache = init_params(specs, SEED + 36, dev, mesh)
    if dtype is not None:
        params = _cast(params, dtype)
        cache = _cast(cache, dtype)
        mdl = build(dataclasses.replace(cfg, dtype="float32",
                                        param_dtype="float32"))
    return mdl, params, cache


def dm_rank():
    """One rank of phase 36c, started by `phase_decode_mesh` in a fresh
    interpreter: gloo on the card, the (4, 2) mesh; the f32 twins, then
    tinyllama-1.1b's decode teacher-forced with one process's tokens, the
    host time inside `dist.all_reduce`; results pickled."""
    import os
    import pickle
    from datetime import timedelta
    import torch
    from repro_torch.device import full_fp32
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.mesh import row_block
    from repro_torch.models import layers
    torch.set_num_threads(1)
    full_fp32()
    d = Path(os.environ["DM_DIR"])
    smoke = os.environ["DM_SMOKE"] == "1"
    dev = mesh_lib.init_process_group(os.environ["DM_DEVICE"],
                                      backend="gloo",
                                      init_method=os.environ["DM_INIT"],
                                      timeout=timedelta(seconds=300))
    mesh = mesh_lib.make_mesh(DM_SHAPE, ("data", "model"))
    out = {"coords": mesh.coords, "twins": {}}
    for case in DM_TWINS:
        out["twins"][case] = _dm_twin(case, dev, mesh)
    out["audio"] = _dm_audio(dev, smoke, np.load(d / "audio_forced.npy"),
                             mesh)
    mdl, params, cache = _dm_lm_state(dev, mesh, smoke=smoke)
    b, S, steps = _dm_lm(smoke)
    forced = torch.from_numpy(np.load(d / "forced.npy")).to(dev)
    forced = forced[row_block(mesh, b)]
    spec = layers.cache_spec(mdl.cfg, b, S, mesh)
    reduce, inside = torch.distributed.all_reduce, {"s": 0.0, "n": 0}

    def timed(t, *a, **kw):
        t0 = time.perf_counter()
        r = reduce(t, *a, **kw)
        inside["s"] += time.perf_counter() - t0
        inside["n"] += 1
        return r

    from repro_torch.kernels.decode_attention import kernel as dk
    dk.decode_attention.launches = 0
    mesh_lib.CALLS.clear()
    torch.distributed.all_reduce = timed
    logits, tokens, ms, _ = _dm_decode(mdl, params, cache, forced, S - steps,
                                       0, mesh, spec)
    torch.distributed.all_reduce = reduce
    out["lm"] = dict(logits=logits, tokens=tokens, ms=ms,
                     all_reduce_s=inside["s"], all_reduce_n=inside["n"],
                     calls=dict(mesh_lib.CALLS),
                     decode_launches=dk.decode_attention.launches)
    with open(d / f"rank{mesh.rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def _dm_blocks(mdl, batch, S, coords):
    """The block slices of every cache leaf (sorted paths) of a rank at
    `coords` on DM_SHAPE, and each leaf's mesh-layout shape."""
    import types
    from repro_torch.models.params import (LOGICAL_RULES_TP, block_slices,
                                           resolve_axes)
    axes = ("data", "model")
    m = types.SimpleNamespace(axis_names=axes, devices=np.empty(DM_SHAPE),
                              shape=dict(zip(axes, DM_SHAPE)), coords=coords)

    def walk(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in walk(tree[k])]
        spec = resolve_axes(tree.axes, tree.shape, m, LOGICAL_RULES_TP)
        return [(tree.shape, block_slices(tree.shape, spec, m))]
    return walk(mdl.cache_specs(batch, S, padded=True))


def phase_decode_mesh(train=None, tp=None, device="cuda", smoke=False):
    """Phase 36: (a) `_lse_kernel_checks`; (b) `_dry_checks` against
    phases 30 and 35 (their records, where the script ran them); (c)
    eight gloo ranks at DM_SHAPE on the one card decode with the cache in
    the reference's blocks: the f32 twins of DM_TWINS against one process
    on the card (tokens equal, logits within DM_TOL, each rank's cache
    blocks equal to one process's, an f8 code at most its neighbour), and
    tinyllama-1.1b at full width and DM_LM_LAYERS of its layers (bf16, a
    cache of DM_LM rows filled with N(0, 1) values, DM_LM steps at its
    end) teacher-forced with one bf16
    process's greedy tokens: the argmax equal to them wherever their top
    two logits lie further apart than the mesh moved any logit of that
    row, and the logits by the noise rule against an f32 process; ms a
    step and the share of it inside `dist.all_reduce`. Returns the
    record. (b) also dry-runs whisper-tiny's cells (`_dry_audio`); (c)
    holds the whisper twin too, and (d) whisper-tiny at full width and
    depth in f32 (`_dm_audio`, DM_AUDIO: the caches over its padded heads)
    teacher-forced with one card process's greedy tokens, the logits
    within DM_AUDIO_TOL. A CPU rehearsal: `phase_decode_mesh(device="cpu",
    smoke=True)` ((a) needs the card and is left out; (c) on tinyllama's
    bf16 smoke twin at DM_LM_SMOKE, (d) at DM_AUDIO_SMOKE)."""
    import os
    import pickle
    import shutil
    import torch
    from repro_torch.device import full_fp32
    from repro_torch.models import build
    t0 = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    rec = {"lse": _lse_kernel_checks() if cuda else None}
    say("decode-mesh", part="lse", seconds=f"{time.perf_counter() - t0:.2f}")
    rec["dry"] = _dry_checks(train, tp)
    say("decode-mesh", part="dry", seconds=f"{time.perf_counter() - t0:.2f}")
    full_fp32()
    d = ROOT / "build" / "dm" / f"ranks-{os.getpid()}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    # one process first, alone on the card: the twins, tinyllama's greedy
    # bf16 run, and its f32 anchor teacher-forced with those tokens
    one = {case: _dm_twin(case, dev) for case in DM_TWINS}
    audio_one = _dm_audio(dev, smoke)
    np.save(d / "audio_forced.npy", np.concatenate(
        [audio_one["start"], audio_one["tokens"][:-1].T],
        axis=1).astype(np.int32))
    b, S, steps = _dm_lm(smoke)
    mdl, params, cache = _dm_lm_state(dev, smoke=smoke)
    start = torch.tensor(np.random.default_rng(SEED + 36).integers(
        0, mdl.cfg.vocab_size, (b, 1)), dtype=torch.int32, device=dev)
    lm_logits, lm_tokens, one_ms, _ = _dm_decode(mdl, params, cache, start,
                                                 S - steps, steps - 1)
    forced = np.concatenate([start.cpu().numpy(), lm_tokens[:-1].T],
                            axis=1).astype(np.int32)
    del params, cache
    mdl32, params, cache = _dm_lm_state(dev, dtype=torch.float32,
                                        smoke=smoke)
    f32_logits, _, _, _ = _dm_decode(mdl32, params, cache,
                                     torch.from_numpy(forced).to(dev),
                                     S - steps)
    del params, cache
    if cuda:
        torch.cuda.empty_cache()
    say("decode-mesh", part="one-process",
        seconds=f"{time.perf_counter() - t0:.2f}")
    np.save(d / "forced.npy", forced)
    world = int(np.prod(DM_SHAPE))
    env = dict(os.environ, DM_DIR=str(d), DM_DEVICE=device,
               DM_INIT=_rendezvous(d), WORLD_SIZE=str(world),
               DM_SMOKE="1" if smoke else "0", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    procs = []
    try:
        for r in range(world):
            log = open(d / f"log{r}.txt", "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", "import chip_smoke as c; c.dm_rank()"],
                cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT,
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r))), log))
        deadline = time.monotonic() + DM_RANK_TIMEOUT
        for r, (p, log) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                for q, _ in procs:
                    q.kill()
                tails = "\n".join(
                    f"--- rank {i}\n" + (d / f"log{i}.txt").read_text()[-1500:]
                    for i in range(world))
                raise SmokeFailure(f"decode-mesh: rank {r} ended with {rc}\n"
                                   + tails)
        outs = []
        for r in range(world):
            with open(d / f"rank{r}.pkl", "rb") as f:
                outs.append(pickle.load(f))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
            log.close()
    say("decode-mesh", part="ranks", seconds=f"{time.perf_counter() - t0:.2f}")

    tb = DM_TWIN_RUN[0] // DM_SHAPE[0]
    for case in DM_TWINS:
        mdl_c = build(_dm_twin_cfg(case))
        worst = 0.0
        for r, o in enumerate(outs):
            got, want = o["twins"][case], one[case]
            rows = slice(o["coords"]["data"] * tb,
                         (o["coords"]["data"] + 1) * tb)
            check(np.array_equal(got["tokens"], want["tokens"][:, rows]),
                  f"decode-mesh: {case} rank {r} tokens differ")
            err = float(np.abs(got["logits"] - want["logits"][:, rows])
                        .max())
            check(err <= DM_TOL or case in DM_F8, f"decode-mesh: {case} "
                  f"rank {r} logits off by {err:.3e}")
            worst = max(worst, err)
            for (path, g), (_, w), (shape, sl) in zip(
                    got["cache"], want["cache"],
                    _dm_blocks(mdl_c, DM_TWIN_RUN[0], DM_TWIN_RUN[3],
                               o["coords"])):
                if w.shape != tuple(shape):       # the padded heads: zero
                    pad = np.zeros(shape, w.dtype)
                    pad[..., :w.shape[-2], :] = w
                    w = pad
                w = w[sl]
                if g.dtype == np.uint8:
                    diff = np.abs(g.astype(np.int16) - w.astype(np.int16))
                    check(diff.max(initial=0) <= 1,
                          f"decode-mesh: {case} rank {r} {path} f8 codes "
                          f"off by {diff.max()}")
                else:
                    check(np.allclose(g, w, rtol=DM_TOL, atol=DM_TOL),
                          f"decode-mesh: {case} rank {r} {path} off the "
                          f"one process's block")
        say("decode-mesh", path="twin", case=case, arch=DM_TWINS[case][0],
            mesh=DM_SHAPE, run="x".join(map(str, DM_TWIN_RUN)),
            cache=DM_TWINS[case][1].get("kv_cache_dtype") or "float32",
            max_abs_err=f"{worst:.3e}",
            tol="tokens and codes" if case in DM_F8 else DM_TOL)

    # 36d: whisper-tiny teacher-forced with one process's greedy tokens
    ab, _, asteps = DM_AUDIO_SMOKE if smoke else DM_AUDIO
    aud = [o["audio"] for o in outs]
    a_logits = np.concatenate([x["logits"] for x, o in zip(aud, outs)
                               if o["coords"]["model"] == 0], axis=1)
    alb = ab // DM_SHAPE[0]
    for o, x in zip(outs, aud):
        rows = slice(o["coords"]["data"] * alb,
                     (o["coords"]["data"] + 1) * alb)
        check(np.array_equal(x["logits"], a_logits[:, rows]),
              "decode-mesh: whisper-tiny's model ranks' logits differ")
        check(not cuda or x["launches"] == 2 * x["layers"] * asteps,
              f"decode-mesh: whisper-tiny decode launches {x['launches']}")
    a_delta = np.abs(a_logits - audio_one["logits"])
    a_err = float(a_delta.max())
    top2 = np.sort(audio_one["logits"], axis=-1)[..., -2:]
    a_clear = top2[..., 1] - top2[..., 0] > 2 * a_delta.max(-1)
    a_agree = a_logits.argmax(-1) == audio_one["tokens"]
    check(a_err <= DM_AUDIO_TOL, f"decode-mesh: whisper-tiny logits off "
          f"one process's by {a_err:.3e}")
    check(bool(a_agree[a_clear].all()),
          f"decode-mesh: whisper-tiny {int((~a_agree & a_clear).sum())} "
          f"tokens differ where the margin exceeds the mesh's change")
    say("decode-mesh", path="audio", arch=TP_AUDIO, dtype="float32",
        mesh=DM_SHAPE, batch=ab, cache_rows=(DM_AUDIO_SMOKE if smoke
                                             else DM_AUDIO)[1],
        steps=asteps, frames=1500,
        tokens_agree=f"{int(a_agree.sum())}/{a_agree.size}",
        clear_margin=int(a_clear.sum()), max_abs_err=f"{a_err:.3e}",
        tol=DM_AUDIO_TOL,
        ms_per_step_rank0=f"{np.mean(aud[0]['ms']):.3f}",
        one_process_ms_per_step=f"{np.mean(audio_one['ms']):.3f}",
        decode_launches_rank0=aud[0]["launches"],
        one_process_decode_launches=audio_one["launches"])

    lb = b // DM_SHAPE[0]
    mesh_logits = np.concatenate(
        [o["lm"]["logits"] for o in outs if o["coords"]["model"] == 0],
        axis=1)
    for o in outs:                   # the model ranks agree with each other
        rows = slice(o["coords"]["data"] * lb, (o["coords"]["data"] + 1) * lb)
        check(np.array_equal(o["lm"]["logits"], mesh_logits[:, rows]),
              "decode-mesh: the model ranks' logits differ")
    delta = np.abs(mesh_logits - lm_logits).max(-1)        # (steps, b)
    top2 = np.sort(lm_logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    clear = margin > 2 * delta
    agree = mesh_logits.argmax(-1) == lm_tokens
    check(bool(agree[clear].all()),
          f"decode-mesh: {int((~agree & clear).sum())} tokens differ where "
          f"the margin exceeds the mesh's change")
    noise = float(np.linalg.norm(mesh_logits - f32_logits))
    base = float(np.linalg.norm(lm_logits - f32_logits))
    check(noise <= NOISE_RATIO * base,
          f"decode-mesh: tinyllama logits {noise:.4e} from f32, one process "
          f"{base:.4e}")
    lm = [o["lm"] for o in outs]
    ms = [float(np.mean(x["ms"])) for x in lm]
    share = [x["all_reduce_s"] * 1e3 / sum(x["ms"]) for x in lm]
    for r, x in enumerate(lm):
        check(not cuda or x["decode_launches"] == mdl.cfg.num_layers * steps,
              f"decode-mesh: rank {r} decode launches {x['decode_launches']}")
    seconds = time.perf_counter() - t0
    say("decode-mesh", path="lm", arch=TRAIN_ARCH,
        layers=mdl.cfg.num_layers, mesh=DM_SHAPE, batch=b, cache_rows=S, steps=steps, positions=f"{S - steps}..{S - 1}",
        tokens_agree=f"{int(agree.sum())}/{agree.size}",
        clear_margin=int(clear.sum()),
        noise_ratio=f"{noise / base:.4f}", limit=NOISE_RATIO,
        ms_per_step_rank0=f"{ms[0]:.3f}",
        ms_per_step=",".join(f"{v:.2f}" for v in ms),
        one_process_ms_per_step=f"{np.mean(one_ms):.3f}",
        all_reduce_share=",".join(f"{v:.4f}" for v in share),
        all_reduces_a_step=lm[0]["all_reduce_n"] // steps,
        decode_launches_rank0=lm[0]["decode_launches"],
        calls_rank0={f"{'.'.join(a)}:{op}": n for (a, op), n in
                     sorted(lm[0]["calls"].items())})
    shutil.rmtree(d, ignore_errors=True)
    say("decode-mesh", seconds=f"{seconds:.2f}")
    rec.update(seconds=seconds, launches=[x["decode_launches"] for x in lm],
               audio_launches=[x["launches"] for x in aud],
               audio_max_abs_err=a_err,
               ms=ms, all_reduce_share=share, noise_ratio=noise / base)
    return rec


def _named_leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], f"{path}.{k}")]
    return [(path.lstrip("."), tree)]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _phase(fn, *args):
    """Run one phase and print its seconds (`[phase-time]`)."""
    t = time.perf_counter()
    out = fn(*args)
    say("phase-time", name=fn.__name__,
        seconds=f"{time.perf_counter() - t:.2f}")
    return out


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
    _phase(phase_build)
    timing, ties, bad, err = _phase(phase_kernels)
    _phase(phase_cpu_vs_gpu)
    launches, geometry_c = _phase(phase_main_path)
    single = _phase(phase_single_view_kernels)
    _phase(phase_cpu_vs_gpu_single_view)
    sv_launches = _phase(phase_single_view_path)
    lm = _phase(phase_lm_kernels)
    _phase(phase_lm_cpu_vs_gpu)
    lm_launches = _phase(phase_lm_serving)
    wkv = _phase(phase_wkv6_kernel)
    _phase(phase_ssm_cpu_vs_gpu)
    wkv_launches = _phase(phase_ssm_serving)
    host_launches = {"cpu_vs_gpu": _phase(phase_host_cpu_vs_gpu)}
    host_launches.update(_phase(phase_host_single_view_path))
    _phase(phase_host_multiview_path)
    view_launches = _phase(phase_serve_view_path)
    host_launches["serve_view"] = {k: view_launches[k]
                                   for k in ("eps_affine", "band_reclassify")}
    host_launches.update(_phase(phase_storage_path))
    _phase(phase_layer2)
    sql20 = _phase(phase_sql_cpu_vs_gpu)
    sql21 = _phase(phase_sql_path)
    _phase(phase_moe_cpu_vs_gpu)
    hybrid_launches = _phase(phase_hybrid_serving)
    moe_launches = _phase(phase_moe_serving)
    last = _phase(phase_last_cpu_vs_gpu)
    audio_launches = _phase(phase_audio_serving)
    dense_launches = _phase(phase_vlm_f8_serving)
    bwd = _phase(phase_flash_bwd_kernel)
    bwd_twin_launches = _phase(phase_train_cpu_vs_gpu)
    train = _phase(phase_train_path)
    ckpt = _phase(phase_checkpoint, train.pop("mdl"), train.pop("state"))
    wkv_bwd = _phase(phase_wkv6_bwd_kernel)
    ssm_train = _phase(phase_ssm_train_path)
    launcher = _phase(phase_launcher)
    mesh1 = _phase(phase_mesh_world1)
    mesh8 = _phase(phase_mesh_ranks)
    tp = _phase(phase_tp_ranks)
    dm = _phase(phase_decode_mesh, train, tp)
    host_launches["sql_cpu_vs_gpu"] = sql20
    host_launches["sql_dblife"] = sql21["dblife"]
    host_launches["sql_view_driver"] = sql21["view_driver"]
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
                                  ("C", geometry_c))},
             "launches_sql": {
                 "cpu_vs_gpu": sql20["multiview_band_reclassify"],
                 "forest": sql21["forest"],
                 "swarm": sql21["swarm"]["all"],
                 "swarm_daemon": sql21["swarm"]["daemon"]},
             "launches_mesh_world1": mesh1["forest"]["mesh_launches"],
             "launches_mesh_ranks": mesh8["launches"][
                 "multiview_band_reclassify"],
             "mesh_ms_per_round": {
                 "world1": mesh1["forest"]["mesh_ms"],
                 "world1_no_mesh": mesh1["forest"]["ms"],
                 "ranks_4x2": mesh8["forest_ms"],
                 "one_shard_cut": mesh8["one_shard_ms"]}}]
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
                     "mismatches": r["mismatches"], "ties": r["ties"],
                     "launches_mesh_world1": mesh1["dblife"][
                         "mesh_launches"][name],
                     "launches_mesh_ranks": mesh8["launches"][name]})
    for name, source, replaces in [
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:59"),
            ("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention/kernel.py:55")]:
        r = lm[name]
        extra = ({"launches_serve_view": view_launches["flash_attention"],
                  "launches_sql_view_driver":
                      sql21["view_driver"]["flash_attention"]}
                 if name == "flash_attention" else
                 {"launches_serve_cli_jamba_smoke":
                      hybrid_launches["serve_cli_decode_attention"]})
        jamba = lm[f"{name}_jamba"]
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        extra.update(
            launches_jamba_16_layers=hybrid_launches[name],
            launches_llama4_scout_12_layers=moe_launches[name],
            launches_whisper_tiny=audio_launches[name],
            launches_pixtral_12b=dense_launches["pixtral-12b"][name],
            jamba_shape={k: jamba[k] for k in keys})
        if name == "flash_attention":
            extra.update(
                launches_train_tinyllama=train["flash_attention"],
                launches_mesh_world1=mesh1["train"]["mesh_launches"][name],
                launches_mesh_ranks=mesh8["launches"][name],
                launches_tp_ranks=tp["launches"][name],
                launches_tp_whisper_tiny=tp["audio_launches"][name],
                launches_tp_twins={case: [x[name] for x in v] for case, v
                                   in tp["twin_launches"].items()
                                   if case != "ssm"},
                whisper_shape={k: last["flash_attention_whisper"][k]
                               for k in keys + ("shape",)},
                pixtral_shape={k: last["flash_attention_pixtral"][k]
                               for k in keys + ("shape",)})
        else:
            f8 = last["decode_attention_f8"]
            extra.update(
                launches_decode_mesh_tinyllama=dm["launches"],
                launches_decode_mesh_whisper_tiny=dm["audio_launches"],
                lse_path=dict(max_abs_err=dm["lse"]["max_abs_err"],
                              lse_max_abs_err=dm["lse"]["lse_max_abs_err"],
                              cases=dm["lse"]["cases"],
                              blocks=dm["lse"]["timed"]),
                launches_qwen1_5_32b_24_layers=dense_launches[
                    "qwen1.5-32b"][name],
                launches_serve_cli_whisper=audio_launches[
                    "serve_cli_decode_attention"],
                f8_shape={k: f8[k] for k in keys + (
                    "bf16_cache_ms", "max_abs_err", "cases", "shape")},
                whisper_cross_shape={
                    k: last["decode_attention_whisper_cross"][k]
                    for k in keys + ("shape",)})
        recs.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": lm_launches[name],
                     **extra,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "cases": r["cases"]})
    recs.append({"name": "flash_attention_bwd", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
                 "replaces": "src/repro/kernels/flash_attention/kernel.py:59",
                 "replaces_note": "the backward of the forward kernel's "
                                  "port; the reference differentiates its "
                                  "plain jnp attention",
                 "launches": train["flash_attention_bwd"],
                 "launches_train_twins": bwd_twin_launches[
                     "flash_attention_bwd"],
                 "launches_mesh_world1": mesh1["train"]["mesh_launches"][
                     "flash_attention_bwd"],
                 "launches_mesh_ranks": mesh8["launches"][
                     "flash_attention_bwd"],
                 "launches_tp_ranks": tp["launches"]["flash_attention_bwd"],
                 "launches_tp_whisper_tiny": tp["audio_launches"][
                     "flash_attention_bwd"],
                 "max_abs_err": bwd["max_abs_err"], "ms": bwd["ms"],
                 "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
                 "bound_by": bwd["bound_by"],
                 "library_ms": bwd["library_ms"],
                 "library_call": "scaled_dot_product_attention backward",
                 "cases": bwd["cases"],
                 "lse_max_abs_err": bwd["lse_max_abs_err"],
                 "split_ms": bwd["split_ms"],
                 "hd128": {key: bwd["hd128"][key] for key in (
                     "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "split_ms")},
                 "train_ms_per_step": train["ms_per_step"],
                 "train_tokens_per_s": train["tokens_per_s"]})
    recs.append({"name": "wkv6", "route": "cuda",
                 "source": "src/repro_torch/csrc/wkv6.cu",
                 "replaces": "src/repro/kernels/wkv6/kernel.py:65",
                 "launches": wkv_launches,
                 "launches_train_rwkv6": ssm_train["wkv6"],
                 "launches_tp_ranks_rwkv6_twin": tp["ssm_launches"]["wkv6"],
                 "max_abs_err": wkv["max_abs_err"],
                 "ms": wkv["ms"], "plain_ms": wkv["plain_ms"],
                 "bound_ms": wkv["bound_ms"], "bound_by": wkv["bound_by"],
                 "library_ms": None,
                 "library_ms_why": "no single PyTorch call computes WKV6",
                 "cases": wkv["cases"]})
    recs.append({"name": "wkv6_bwd", "route": "cuda",
                 "source": "src/repro_torch/csrc/wkv6_bwd.cu",
                 "replaces": "src/repro/kernels/wkv6/kernel.py:65",
                 "replaces_note": "the backward of the forward kernel's "
                                  "port; the reference differentiates its "
                                  "plain wkv_chunked "
                                  "(src/repro/models/rwkv6.py:127)",
                 "launches": ssm_train["wkv6_bwd"],
                 "launches_train_twins": bwd_twin_launches["wkv6_bwd"],
                 "launches_tp_ranks_rwkv6_twin": tp["ssm_launches"][
                     "wkv6_bwd"],
                 "max_abs_err": wkv_bwd["max_abs_err"], "ms": wkv_bwd["ms"],
                 "plain_ms": wkv_bwd["plain_ms"],
                 "bound_ms": wkv_bwd["bound_ms"],
                 "bound_by": wkv_bwd["bound_by"], "library_ms": None,
                 "library_ms_why": "no single PyTorch call computes the "
                                   "WKV6 backward",
                 "cases": wkv_bwd["cases"],
                 "bytes_bound_ms": wkv_bwd["bytes_bound_ms"],
                 "split_ms": wkv_bwd["split_ms"],
                 "split_from": wkv_bwd["split_from"],
                 "train_layers": ssm_train["layers"],
                 "train_ms_per_step": ssm_train["ms_per_step"],
                 "train_tokens_per_s": ssm_train["tokens_per_s"],
                 "train_peak_memory_gb": ssm_train["peak_memory_gb"],
                 "checkpoint_save_s": ckpt["save_s"],
                 "checkpoint_restore_s": ckpt["restore_s"],
                 "launcher_tokens_per_s": launcher["tokens_per_s"]})
    print(card_line(), flush=True)     # again, beside the records
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
