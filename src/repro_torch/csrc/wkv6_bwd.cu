// The backward of the RWKV-6 chunked WKV recurrence; hand-written for
// Hopper (sm_90a): its products on the tensor cores in 3xTF32, its tiles
// brought by TMA.
//
// No Pallas kernel has a backward: the reference trains through `jax.grad`
// of its plain chunked form (`src/repro/models/rwkv6.py:127`
// `wkv_chunked`, the ±40 exponent clip at :151-152, called by `time_mix`
// at :183). This computes that gradient, the gradient of the forward
// kernel `wkv6.cu`, as `kernels/wkv6/ref.py` `wkv6_chunked_bwd_ref`
// writes it out: for r/k/v/la/do (b, s, H, K) f32 and u (H, K) f32, chunks
// of CH rows from position 0 (a ragged last chunk and a sequence shorter
// than CH zero-filled: zero rows change no gradient of a real row), and
// per chunk, with a = cumsum(la), a_prev = a − la, a_last its last row,
// S the state the chunk starts from and dS the gradient of the state it
// hands on (0 after the last chunk):
//   r_in = r ⊙ e^{a_prev}, r_f = r ⊙ e^{clip(a_prev)}, k_f = k ⊙ e^{clip(−a)},
//   k_dec = k ⊙ e^{a_last − a}, att = tril₋₁(r_f k_fᵀ), datt = tril₋₁(do vᵀ),
//   β_t = Σ r u k, dβ_t = Σ do v,
//   dv    = k_dec dS + attᵀ do + β ⊙ do
//   dr    = (do Sᵀ) ⊙ e^{a_prev} + (datt k_f) ⊙ e^{clip(a_prev)} + dβ u k
//   dk    = (v dSᵀ) ⊙ e^{a_last − a} + (dattᵀ r_f) ⊙ e^{clip(−a)} + dβ r u
//   d_ap  = (do Sᵀ) ⊙ r_in + (datt k_f) ⊙ r_f ⊙ clip′(a_prev)
//   d_a   = −(v dSᵀ) ⊙ k_dec − (dattᵀ r_f) ⊙ k_f ⊙ clip′(−a)
//           (+ on the last row: Σ_v dS S ⊙ e^{a_last} + Σ_t (v dSᵀ) ⊙ k_dec)
//   dla_t = Σ_{t' ≥ t} (d_a + d_ap)_{t'} − d_ap_t,   du = Σ dβ r k
//   dS   <- diag(e^{a_last}) dS + r_inᵀ do
// where clip′ is jax's derivative of jnp.clip: 1 inside, 1/2 at exactly
// ±40, 0 outside.
//
// Three kernels, one stream, no atomics (two calls give equal bits):
//   1. `wkv6_states_kernel`, one block per (head, batch row): walks the
//      chunks forward and writes the state each chunk starts from into an
//      f32 scratch (b, H, n_chunks, K, K) (201 MB at rwkv6-3b's training
//      shape). The forward kernel is left as it is (its output and speed
//      stay those of the serving path), so the backward rebuilds them.
//   2. `wkv6_bwd_kernel`, one block per (head, batch row): carries dS in
//      shared memory over the chunks in reverse and writes dr, dk, dv and
//      dla; it leaves its share of du in a per-block slot.
//   3. `wkv6_du_kernel`: du = the slots summed over the batch rows in
//      order.
//
// What bounds it: at rwkv6-3b's training shape (b 8, s 2,048, 48 heads of
// 64, chunk 64) the function needs 5.0e10 operations, 0.75 ms on the f32
// CUDA cores, and reads and writes 1.81 GB, 0.54 ms. Rebuilding the states
// adds 0.8 GB of traffic (k, v and la read again, the scratch written and
// read). Run on the CUDA cores, the products took 5.2 ms (register tiles
// fed from shared memory at a quarter of the FMA rate); here they run in
// 3xTF32 on `mma.sync.m16n8k8` (mma_sync.cuh `split_tf32`, `mma_3xtf32`):
// each f32 operand is split into hi and lo = x − hi, and lo·hi′ + hi·lo′ +
// hi·hi′ is accumulated in f32. One TF32 product leaves ~4e-4 relative
// error, over the 1e-5 limit the card holds this kernel to; three leave
// under 1e-6. Every operand is r, k, v, do, S or dS scaled by a factor ≤ 1
// or by e^{clip(−a)} ≤ e^40 ≈ 2^58, well inside TF32's 8-bit exponent.
// `wgmma` is not used: PTX allows its transposes only for 16-bit types,
// and six of the ten products read an operand that is not K-major in its
// tile (datt·k_f, k_dec·dS, dattᵀ·r_f, attᵀ·do, r_inᵀ·do, k_decᵀ·v);
// mma.sync loads a fragment from either orientation by address.
//
// The unit of work stays one block per (head, batch row), 384 blocks at
// that shape (2.9 waves of 132): a chunk-parallel split would read the
// inputs twice and write and read two 201 MB scratches, about 4.4 GB
// against 2.2 GB.
//
// Reverse pass (`Bwd` has the byte table): 256 threads, 8 warps of one
// role, one block an SM (214,072 bytes at chunk 64, K 64). Thread 0 issues
// every load; no warp is set aside to produce, because one would only
// wait on the barriers below and cost the math warps registers (256
// threads may hold 255 each). Thirteen tiles at the pitches the fragments
// need would not fit with a buffer to load ahead, so tiles are rewritten
// in place as they die: a over a scratch tile, r_f over r, k_f over k,
// d_a + d_ap over k_dec, d_ap over r_in. The five inputs arrive as
// 4-D TMA boxes over the model layout read through its strides (rows past
// s as zeros), each chunk's S as a box of the scratch that is K + 4 wide
// (one bulk copy would land it at pitch K, where every fragment load of
// the 8 rows it spans hits one bank eight times), all on mbarriers. Each
// buffer is loaded for chunk n − 1 as soon as chunk n's last read of it is
// done: la after (1), S after (3), r, k and v after (5); do has two
// buffers, so chunk n − 1's do lands while chunk n runs. Per chunk:
//   (1) a = cumsum(la) down each column in row order, from row 0 (the
//       forward's sum, so the clip binds on exactly the elements the
//       forward clipped): thread p of a column sums rows 0 .. its part's
//       last, every thread of the block busy; β, dβ and Σ_v dS·S as warp
//       reductions whose rows share their shuffles (`lanes_sum`);
//   (2) each thread, for the elements of the CH x K products it owns (the
//       mma accumulator layout of (4)-(5)), computes e^{a_prev},
//       e^{clip(−a)} and e^{a_last − a} once (e^{clip(a_prev)} is
//       e^{a_prev} inside the clip and e^{±40} outside), writes r_in, r_f,
//       k_f and k_dec, and keeps the factors, the clip's side and the dβ
//       terms of dr and dk in registers for its epilogues;
//   (3) att (β on its diagonal, so attᵀ·do carries β ⊙ do) and datt on
//       the 16-row blocks on or below the diagonal, and do·Sᵀ;
//   (4) datt·k_f, then dr and d_ap;
//   (5) v·dSᵀ and dattᵀ·r_f, then dk, d_a + d_ap and Σ_t (v dSᵀ) ⊙ k_dec
//       (a fixed butterfly over the lanes of a column, then the warps in
//       order);
//   (6) dv = k_dec·dS + attᵀ·do, and r_inᵀ·do;
//   (7) dS' = diag(e^{a_last}) dS + r_inᵀ·do in place, then dla: thread p
//       of a column sums d_a + d_ap from the last row down to its part's
//       rows, every thread busy.
// Products whose factor is triangular skip the 16-row blocks past the
// diagonal. Every product's k-step loop unrolls whole, its ranges fixed
// when the kernel is compiled (a warp's pair of row blocks picks one of
// two instantiations of each triangular product): a rolled loop consumes
// each step's loads by register moves within the step and recomputes its
// addresses, which held the products to a third of the tensor pipe's TF32
// rate (on an H100 at 700 W, 2.63 ms a call rolled, 2.22 unrolled, at
// rwkv6-3b's training shape). Fragments read along rows come by
// `ldmatrix` (`ld_a`, `ld_b_nk`): one instruction for four or two loads,
// 2.11 ms a call. At chunk 64, K 64 the reverse pass takes
// all 255 registers a thread with 64 bytes of spills: the factors, clip
// sides and dβ terms of a thread's 16 elements stay live from (2) to (5).
// Pitches: K + 4 for tiles read along rows (r/r_f, k/k_f, v,
// la, do, S, k_dec) and K + 8 for those read along columns (r_in, dS),
// CH + 8 for att and CH + 4 for datt, which puts the 32 lanes of a
// fragment load along the pitch's own direction on 32 banks. Five tiles
// are read both ways, and their other direction costs two-way conflicts:
// r_f (dattᵀ·r_f), k_f (datt·k_f), do (attᵀ·do, r_inᵀ·do) and datt
// (dattᵀ·r_f) along columns, dS (v·dSᵀ) along rows.
//
// State pass (`States`): 256 threads, two blocks an SM, a 2-stage TMA
// ring of k, v and la at pitch K + 8; each thread sums its column's la in
// row order, writes k_dec over k, and ΔS = k_decᵀ·v runs in 3xTF32; the
// state stays in registers (each warp owns its tiles) and goes out with
// plain stores that overlap the next chunk's wait.
//
// Head sizes 16, 32 and 64 and chunks 16, 32 and 64 take the same layout;
// at the small sizes fewer warps own product tiles (`Split`, `OSplit`).
//
// Built with -DWKV6_BWD_TRACE, both kernels sum the cycles of each phase
// of block (0, 0) per warp, the C entry records CUDA events around its
// three kernels, and `wkv6_bwd_trace` copies both out
// (`launch/wkv6_bwd_pair.py --trace` prints them).
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 256;                   // 8 warps, one role
constexpr int kWarps = kThreads / 32;
constexpr int kStatesStages = 2;                // the state pass's ring
constexpr int kPhases = 8;                      // traced phases a kernel
constexpr float kClip = 40.f;
// A failed tensor-map encode is returned as kMapError + the CUresult.
constexpr int kMapError = 100000;

// Shared memory of the reverse pass, in bytes, each tile region a multiple
// of 128 (TMA's alignment). The five inputs (r, k, v, la, do) arrive at
// pitch PR; do has two buffers. `kKd` holds a_prev, then k_dec, then
// d_a + d_ap; `kRin` holds a, then r_in, then d_ap.
template <int CH, int K>
struct Bwd {
  static constexpr int PR = K + 4;              // read along rows
  static constexpr int PC = K + 8;              // read along columns
  static constexpr int PA = CH + 8;             // att: along columns
  static constexpr int PD = CH + 4;             // datt: both ways
  static constexpr int kTileR = CH * PR * 4;
  static constexpr int kR = 0;                  // r, then r_f
  static constexpr int kK = kR + kTileR;        // k, then k_f
  static constexpr int kV = kK + kTileR;
  static constexpr int kLa = kV + kTileR;
  static constexpr int kDo = kLa + kTileR;      // two
  static constexpr int kS = kDo + 2 * kTileR;   // K x PR
  static constexpr int kKd = kS + K * PR * 4;
  static constexpr int kRin = kKd + kTileR;     // CH x PC
  static constexpr int kDS = kRin + CH * PC * 4;     // K x PC
  static constexpr int kAtt = kDS + K * PC * 4;      // CH x PA
  static constexpr int kDatt = kAtt + CH * PA * 4;   // CH x PD
  // β, dβ (CH each); u, a_last, e^{a_last}, Σ_v dS·S (K each); two rows
  // of column partials (2K)
  static constexpr int kVec = kDatt + CH * PD * 4;
  static constexpr int kBars = kVec + (2 * CH + 6 * K) * 4;
  static constexpr int kBytes = kBars + 7 * 8;  // 7 mbarriers
};

// Shared memory of the state pass, in bytes: a ring of stages of k (then
// k_dec), v and la tiles at pitch P, e^{a_last}, the stages' mbarriers.
template <int CH, int K>
struct States {
  static constexpr int P = K + 8;
  static constexpr int kTile = CH * P * 4;
  static constexpr int kStage = 3 * kTile;
  static constexpr int kLast = kStatesStages * kStage;
  static constexpr int kBars = kLast + K * 4;
  static constexpr int kBytes = kBars + 8 * kStatesStages;
};

// The tiles of an M16 x N8 product (16-row blocks, 8-column tiles) that
// warp w computes: tiles w·kPer .. w·kPer + kPer − 1 (none past the end),
// all in one row block so that they share their A fragments.
template <int M16, int N8>
struct Split {
  static constexpr int kTiles = M16 * N8;
  static constexpr int kPer = (kTiles + kWarps - 1) / kWarps;
  static_assert(N8 % kPer == 0, "a warp's tiles share one row block");
  static constexpr bool kGuard = kTiles % kWarps != 0;
  __device__ static int row_block(int w) { return w * kPer / N8; }
  __device__ static int col_tile(int w, int i) { return (w * kPer + i) % N8; }
  __device__ static bool has(int w) { return !kGuard || w * kPer < kTiles; }
};

// The att and datt tiles that warp w computes. At 64 rows, only the 20
// tiles on or left of the diagonal's 16-row blocks (rows 0..3 need 2, 4,
// 6 and 8 column tiles), at most three a warp, each warp in one row block;
// a warp with two computes its first again in the third slot and does not
// write it. Otherwise every tile, as Split.
template <int CH>
struct ASplit {
  using Full = Split<CH / 16, CH / 8>;
  static constexpr bool kTri = CH == 64;
  static constexpr int kPer = kTri ? 3 : Full::kPer;
  __device__ static int count(int w) { return (0x23333222 >> 4 * w) & 15; }
  __device__ static int row_block(int w) {
    if constexpr (kTri) return (0x33322110 >> 4 * w) & 15;
    return Full::row_block(w);
  }
  __device__ static int col_tile(int w, int i) {
    if constexpr (kTri)
      return ((0x63030200 >> 4 * w) & 15) + (i < count(w) ? i : 0);
    return Full::col_tile(w, i);
  }
  __device__ static bool writes(int w, int i) {
    if constexpr (kTri) return i < count(w);
    return true;
  }
  __device__ static bool has(int w) { return kTri || Full::has(w); }
};

// The tiles of the CH x K products (MB 16-row blocks, N8 8-column tiles)
// that warp w computes, and so the elements whose epilogue it runs: with
// two or more row blocks, warps go in groups, each taking a pair of row
// blocks rb and MB − 1 − rb, which together need the same number of steps
// of a product whose factor is triangular; a warp takes kCols column
// tiles of both rows.
template <int MB, int N8>
struct OSplit {
  static constexpr int kRows = MB >= 2 ? 2 : 1;         // row blocks a warp
  static constexpr int kGroups = MB / kRows;
  static constexpr int kPerGroup = kWarps / kGroups;
  static constexpr int kCols = (N8 + kPerGroup - 1) / kPerGroup;
  static constexpr bool kGuard = N8 % kPerGroup != 0;
  __device__ static int group(int w) { return w / kPerGroup; }
  __device__ static int row_block(int w, int j) {
    return j == 0 ? w / kPerGroup : MB - 1 - w / kPerGroup;
  }
  __device__ static int col_tile(int w, int i) {
    return w % kPerGroup * kCols + i;
  }
  __device__ static bool has(int w) {
    return !kGuard || w % kPerGroup * kCols < N8;
  }
};

#ifdef WKV6_BWD_TRACE
// cycles per phase summed over the chunks of block (0, 0), per warp: the
// state pass's (0) and the reverse pass's (1)
__device__ unsigned long long wkv6_bwd_trace_cycles[2 * kWarps * kPhases];
#define WKV6_BWD_MARK(i)                           \
  do {                                             \
    const unsigned long long now = clock64();      \
    trace[i] += now - mark;                        \
    mark = now;                                    \
  } while (0)
#define WKV6_BWD_TRACE_FLUSH(kernel)                                       \
  do {                                                                     \
    if (blockIdx.x == 0 && blockIdx.y == 0 && lane == 0)                   \
      for (int i = 0; i < kPhases; ++i)                                    \
        wkv6_bwd_trace_cycles[((kernel) * kWarps + warp) * kPhases + i] =  \
            trace[i];                                                      \
  } while (0)
#else
#define WKV6_BWD_MARK(i) \
  do {                   \
  } while (0)
#define WKV6_BWD_TRACE_FLUSH(kernel) \
  do {                               \
  } while (0)
#endif

__device__ __forceinline__ float clip(float x) {
  return fminf(fmaxf(x, -kClip), kClip);
}

// Where x stands against the clip: 0 inside, 1 at exactly ±40, 2 below,
// 3 above
__device__ __forceinline__ uint32_t clip_side(float x) {
  if (x > -kClip && x < kClip) return 0;
  if (fabsf(x) == kClip) return 1;
  return x < -kClip ? 2 : 3;
}

// jax.grad of jnp.clip(x, −40, 40) from x's side: max and min each split
// a tie evenly
__device__ __forceinline__ float clip_grad(uint32_t side) {
  return side == 0 ? 1.f : (side == 1 ? 0.5f : 0.f);
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The sums over the 32 lanes of N values (N a power of two up to 32), in
// a fixed order: each round halves the values a lane keeps and adds its
// partner's copy of them, then the last one is summed over the remaining
// lanes. Returns the total of value `idx` in v[0]; idx is the same for
// the lanes that differ only in the bits below 32 / N.
template <int N>
__device__ __forceinline__ void lanes_sum(float (&v)[N], int lane, int& idx) {
  idx = 0;
  int n = N;
#pragma unroll
  for (int step = 16; step >= 1; step >>= 1) {
    if (n > 1) {
      const bool up = lane & step;
      n /= 2;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        if (i < n) {
          const float send = up ? v[i] : v[i + n];
          const float keep = up ? v[i + n] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, step);
        }
      }
      if (up) idx += n;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], step);
    }
  }
}

// the sum over the 8 lanes of one t (lane = 4 g + t): an mma column's rows
__device__ __forceinline__ float rows_sum(float x) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int N>
__device__ __forceinline__ void add_to(float (&acc)[N][4],
                                       const float (&sml)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += sml[i][j];
}

// Raw fragment values of m16n8k8 (lane = 4 g + t) from shared memory:
// the A fragment (16 rows x 8 of k) of a row-major tile at pitch P, or of
// the transpose of one (A[m][k] = p[k][m]); a B fragment (8 of k x 8
// columns) of a tile stored n-major (B[k][n] = p[n][k]) or k-major. Read
// along rows, a fragment is two or four 8 x 4 f32 matrices (rows 0-7 and
// 8-15, k 0-3 and 4-7), which one `ldmatrix` reads as 8 x 8 b16 ones,
// lane l giving the address of row l % 8 of matrix l / 8: lane 4 g + t
// gets word t of row g of each, the fragment's own layout.
__device__ __forceinline__ void ld_a(const float* p, int P, int lane,
                                     float (&x)[4]) {
  uint32_t r[4];
  mma::ldmatrix_x4(r, p + ((lane >> 3 & 1) * 8 + (lane & 7)) * P +
                          (lane >> 4) * 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(r[i]);
}
__device__ __forceinline__ void ld_b_nk(const float* p, int P, int lane,
                                        float (&x)[2]) {
  uint32_t r[2];
  mma::ldmatrix_x2(r, p + (lane & 7) * P + (lane >> 3 & 1) * 4);
  x[0] = __uint_as_float(r[0]);
  x[1] = __uint_as_float(r[1]);
}
__device__ __forceinline__ void ld_at(const float* p, int P, int g, int t,
                                      float (&x)[4]) {
  x[0] = p[t * P + g];
  x[1] = p[t * P + g + 8];
  x[2] = p[(t + 4) * P + g];
  x[3] = p[(t + 4) * P + g + 8];
}
__device__ __forceinline__ void ld_b_kn(const float* p, int P, int g, int t,
                                        float (&x)[2]) {
  x[0] = p[t * P + g];
  x[1] = p[(t + 4) * P + g];
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma::split_tf32(x[i], hi[i], lo[i]);
}

// The k-step ranges [lo, hi) of a product's row tiles (up to two), known
// when the kernel is compiled, so that its loop unrolls whole: each step's
// addresses fold into immediates and its loads are scheduled ahead.
template <int L0, int H0, int L1 = L0, int H1 = H0>
struct Ranges {
  static constexpr int k0 = L0 < L1 ? L0 : L1;
  static constexpr int k1 = H0 > H1 ? H0 : H1;
  __host__ __device__ static constexpr bool on(int ks, int j) {
    return (j == 0 ? L0 : L1) <= ks && ks < (j == 0 ? H0 : H1);
  }
};

// acc[j][i] += Σ_{lo(j) ≤ ks < hi(j)} A(ks, j) · B(ks, i) for NR row tiles
// and NC column tiles, in 3xTF32; lda(ks, j, x) and ldb(ks, i, x) load the
// raw fragments of k-step ks (8 of the contraction). Each step's fragments
// are loaded while the step before multiplies.
template <int NR, int NC, class Rg, class LA, class LB>
__device__ __forceinline__ void product(float (&acc)[NR][NC][4], LA&& lda,
                                        LB&& ldb) {
  constexpr int k0 = Rg::k0, k1 = Rg::k1;
  if constexpr (k0 < k1) {
    float sml[NR][NC][4] = {};
    float a[NR][4] = {}, b[NC][2];
#pragma unroll
    for (int j = 0; j < NR; ++j)
      if (Rg::on(k0, j)) lda(k0, j, a[j]);
#pragma unroll
    for (int i = 0; i < NC; ++i) ldb(k0, i, b[i]);
#pragma unroll
    for (int ks = k0; ks < k1; ++ks) {
      uint32_t ah[NR][4], al[NR][4], bh[NC][2], bl[NC][2];
#pragma unroll
      for (int j = 0; j < NR; ++j)
        if (Rg::on(ks, j)) split(a[j], ah[j], al[j]);
#pragma unroll
      for (int i = 0; i < NC; ++i) split(b[i], bh[i], bl[i]);
      if (ks + 1 < k1) {
#pragma unroll
        for (int j = 0; j < NR; ++j)
          if (Rg::on(ks + 1, j)) lda(ks + 1, j, a[j]);
#pragma unroll
        for (int i = 0; i < NC; ++i) ldb(ks + 1, i, b[i]);
      }
#pragma unroll
      for (int j = 0; j < NR; ++j)
        if (Rg::on(ks, j))
          mma::mma_3xtf32(acc[j], sml[j], ah[j], al[j], bh, bl);
    }
#pragma unroll
    for (int j = 0; j < NR; ++j) add_to(acc[j], sml[j]);
  }
}

// f(G) with the warp's group G (OSplit::group) as a compile-time constant:
// its row blocks G and MB − 1 − G fix the ranges of the triangular products
template <int Groups, class F>
__device__ __forceinline__ void with_group(int grp, F&& f) {
  if constexpr (Groups == 2) {
    if (grp == 0)
      f(std::integral_constant<int, 0>{});
    else
      f(std::integral_constant<int, 1>{});
  } else {
    f(std::integral_constant<int, 0>{});
  }
}

__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <int CH, int K>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_states_kernel(const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_la,
                   float* __restrict__ states, int s) {
  using C = States<CH, K>;
  constexpr int P = C::P;
  using SS = Split<K / 16, K / 8>;               // ΔS (K x K)
  constexpr int NP = kThreads / K < CH ? kThreads / K : CH;   // parts
  constexpr int RP = CH / NP;                   // rows a part
  static_assert(NP * K == kThreads, "every thread takes a part of a column");
  extern __shared__ __align__(128) unsigned char sm[];
  float* const elast = reinterpret_cast<float*>(sm + C::kLast);
  const uint32_t bars = hopper::smem_addr(sm + C::kBars);
  const int h = blockIdx.x, H = gridDim.x, bi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_chunks = (s + CH - 1) / CH;

  auto issue = [&](int n) {                     // chunk n's k, v, la
    const int st = n % kStatesStages;
    const uint32_t base = hopper::smem_addr(sm + st * C::kStage);
    const uint32_t bar = bars + 8 * st;
    hopper::mbar_expect_tx(bar, 3 * C::kTile);
    hopper::tma_load_4d(base, &tm_k, bar, 0, h, n * CH, bi);
    hopper::tma_load_4d(base + C::kTile, &tm_v, bar, 0, h, n * CH, bi);
    hopper::tma_load_4d(base + 2 * C::kTile, &tm_la, bar, 0, h, n * CH, bi);
  };
  if (tid == 0) {
    if (hopper::smem_addr(sm) & 127) __trap();   // TMA needs 128-byte tiles
    for (int st = 0; st < kStatesStages; ++st)
      hopper::mbar_init(bars + 8 * st, 1);
    hopper::mbar_fence_init();
    hopper::tma_prefetch_map(&tm_k);
    hopper::tma_prefetch_map(&tm_v);
    hopper::tma_prefetch_map(&tm_la);
    for (int n = 0; n < kStatesStages && n < n_chunks; ++n) issue(n);
  }
  __syncthreads();
#ifdef WKV6_BWD_TRACE
  unsigned long long trace[kPhases] = {}, mark = clock64();
#endif

  const int mb = SS::row_block(warp);
  const int j = tid % K, part = tid / K;
  float S[1][SS::kPer][4] = {};                 // the state's own tiles
  float* const out =
      states + static_cast<int64_t>(bi * H + h) * n_chunks * K * K;
  for (int n = 0; n < n_chunks; ++n) {
    const int st = n % kStatesStages;
    float* const kt = reinterpret_cast<float*>(sm + st * C::kStage);
    const float* const vt = kt + CH * P;
    const float* const lat = vt + CH * P;
    // the state chunk n starts from; the stores overlap the wait
    if (SS::has(warp)) {
#pragma unroll
      for (int i = 0; i < SS::kPer; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 16 * mb + g + 8 * half;
          st2(out + static_cast<int64_t>(n) * K * K + row * K +
                  8 * SS::col_tile(warp, i) + 2 * t,
              S[0][i][2 * half], S[0][i][2 * half + 1]);
        }
    }
    WKV6_BWD_MARK(3);
    hopper::mbar_wait(bars + 8 * st, (n / kStatesStages) & 1);
    WKV6_BWD_MARK(0);

    // a = cumsum(la) down column j in row order: every row (for a_last),
    // this part's rows kept; then k_dec = k ⊙ e^{a_last − a} over k
    float acc = 0.f, a_r[RP] = {};
#pragma unroll
    for (int pp = 0; pp < NP; ++pp)
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        acc += lat[(pp * RP + i) * P + j];
        a_r[i] = pp == part ? acc : a_r[i];
      }
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      const int row = part * RP + i;
      kt[row * P + j] *= expf(acc - a_r[i]);
    }
    if (part == 0) elast[j] = expf(acc);
    fence_async_smem();                         // before TMA's next writes
    __syncthreads();
    WKV6_BWD_MARK(1);

    // S' = diag(e^{a_last}) S + k_decᵀ v, on each warp's own tiles
    if (SS::has(warp)) {
      float dS[1][SS::kPer][4] = {};
      product<1, SS::kPer, Ranges<0, CH / 8>>(
          dS,
          [&](int ks, int, float(&x)[4]) {
            ld_at(kt + 8 * ks * P + 16 * mb, P, g, t, x);
          },
          [&](int ks, int i, float(&x)[2]) {
            ld_b_kn(vt + 8 * ks * P + 8 * SS::col_tile(warp, i), P, g, t, x);
          });
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float d = elast[16 * mb + g + 8 * half];
#pragma unroll
        for (int i = 0; i < SS::kPer; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = S[0][i][2 * half + e];
            x = __fadd_rn(__fmul_rn(x, d), dS[0][i][2 * half + e]);
          }
      }
    }
    __syncthreads();                            // the stage is read
    if (tid == 0 && n + kStatesStages < n_chunks) issue(n + kStatesStages);
    WKV6_BWD_MARK(2);
  }
  WKV6_BWD_TRACE_FLUSH(0);
}

template <int CH, int K>
__global__ void __launch_bounds__(kThreads, 1)
wkv6_bwd_kernel(const __grid_constant__ CUtensorMap tm_r,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_la,
                const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_s,
                const float* __restrict__ u, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dla, float* __restrict__ du_part,
                int s) {
  using B = Bwd<CH, K>;
  constexpr int PR = B::PR, PC = B::PC, PA = B::PA, PD = B::PD;
  constexpr int MB = CH / 16;
  using SA = ASplit<CH>;                        // att, datt (CH x CH)
  using SO = OSplit<MB, K / 8>;                 // the CH x K products
  using SS = Split<K / 16, K / 8>;              // r_inᵀ·do (K x K)
  constexpr int NR = SO::kRows, NC = SO::kCols;
  constexpr int NP = kThreads / K < CH ? kThreads / K : CH;   // parts
  constexpr int RP = CH / NP;                   // rows a part
  static_assert(NP * K == kThreads, "every thread takes a part of a column");
  extern __shared__ __align__(128) unsigned char sm[];
  auto tile = [&](int off) { return reinterpret_cast<float*>(sm + off); };
  float* const R = tile(B::kR);                 // r, then r_f
  float* const Kt = tile(B::kK);                // k, then k_f
  float* const V = tile(B::kV);
  float* const LA = tile(B::kLa);
  float* const S = tile(B::kS);
  float* const KD = tile(B::kKd);               // a_prev, k_dec, d_a + d_ap
  float* const RIN = tile(B::kRin);             // a, r_in, d_ap
  float* const DS = tile(B::kDS);
  float* const ATT = tile(B::kAtt);
  float* const DATT = tile(B::kDatt);
  float* const beta = tile(B::kVec);
  float* const dbeta = beta + CH;
  float* const uv = dbeta + CH;
  float* const alast = uv + K;
  float* const elast = alast + K;
  float* const dsS = elast + K;                 // Σ_v dS S, by row of S
  float* const cols = dsS + K;                  // [group][K] partials
  const uint32_t bars = hopper::smem_addr(sm + B::kBars);
  // one mbarrier a buffer: r, k, v, la, S, do (two)
  enum { kBarR, kBarK, kBarV, kBarLa, kBarS, kBarDo };
  auto bar = [&](int i) { return bars + 8 * i; };

  const int h = blockIdx.x, H = gridDim.x, bi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_chunks = (s + CH - 1) / CH;
  const int bh = bi * H + h;
  // element (row, j) of this block's gradients: contiguous (b, s, H, K)
  auto at = [&](int row, int j) {
    return (static_cast<int64_t>(bi) * s + row) * H * K + h * K + j;
  };

  auto issue = [&](const CUtensorMap* map, int off, int b, int n) {
    hopper::mbar_expect_tx(bar(b), B::kTileR);
    hopper::tma_load_4d(hopper::smem_addr(sm + off), map, bar(b), 0, h,
                        n * CH, bi);
  };
  auto issue_s = [&](int n) {
    hopper::mbar_expect_tx(bar(kBarS), K * PR * 4);
    hopper::tma_load_4d(hopper::smem_addr(S), &tm_s, bar(kBarS), 0, 0, n,
                        bh);
  };
  auto issue_do = [&](int n, int buf) {
    issue(&tm_do, B::kDo + buf * B::kTileR, kBarDo + buf, n);
  };
  if (tid == 0) {
    if (hopper::smem_addr(sm) & 127) __trap();   // TMA needs 128-byte tiles
    for (int i = 0; i < 7; ++i) hopper::mbar_init(bar(i), 1);
    hopper::mbar_fence_init();
    hopper::tma_prefetch_map(&tm_r);
    hopper::tma_prefetch_map(&tm_k);
    hopper::tma_prefetch_map(&tm_v);
    hopper::tma_prefetch_map(&tm_la);
    hopper::tma_prefetch_map(&tm_do);
    hopper::tma_prefetch_map(&tm_s);
    const int n = n_chunks - 1;
    issue(&tm_r, B::kR, kBarR, n);
    issue(&tm_k, B::kK, kBarK, n);
    issue(&tm_v, B::kV, kBarV, n);
    issue(&tm_la, B::kLa, kBarLa, n);
    issue_s(n);
    issue_do(n, 0);
    if (n >= 1) issue_do(n - 1, 1);
  }
  for (int i = tid; i < K * PC; i += kThreads) DS[i] = 0.f;
  if (tid < K) uv[tid] = __ldg(u + h * K + tid);
  const float e_lo = expf(-kClip), e_hi = expf(kClip);   // e^{clip} outside
  // the CH x K elements this thread owns: rows 16 rb[j] + g (+ 8), columns
  // 8 ct[i] + 2t (+ 1), held as mma accumulators [j][i][4]
  const bool owns = SO::has(warp);
  int rb[NR], ct[NC];
#pragma unroll
  for (int j = 0; j < NR; ++j) rb[j] = SO::row_block(warp, j);
#pragma unroll
  for (int i = 0; i < NC; ++i) ct[i] = SO::col_tile(warp, i);
  const int grp = SO::group(warp);
  float du_acc[NC][2] = {};                     // Σ dβ k r, own columns
  __syncthreads();
#ifdef WKV6_BWD_TRACE
  unsigned long long trace[kPhases] = {}, mark = clock64();
#endif

  for (int n = n_chunks - 1; n >= 0; --n) {
    const int it = n_chunks - 1 - n;            // chunks done before n
    const int buf = it & 1;
    float* const DO = tile(B::kDo + buf * B::kTileR);
    const int t0 = n * CH;
    hopper::mbar_wait(bar(kBarR), it & 1);
    hopper::mbar_wait(bar(kBarK), it & 1);
    hopper::mbar_wait(bar(kBarV), it & 1);
    hopper::mbar_wait(bar(kBarLa), it & 1);
    hopper::mbar_wait(bar(kBarS), it & 1);
    hopper::mbar_wait(bar(kBarDo + buf), (it >> 1) & 1);
    WKV6_BWD_MARK(0);

    // (1) a = cumsum(la) down each column in row order from row 0 (part
    // p of column j sums rows 0 .. its last), a into RIN and a_prev =
    // a − la into KD; β, dβ and Σ_v dS S
    {
      // (unrolled over every row, so that the loads run ahead of the
      // chain of adds; rows past this part's are not added)
      const int j = tid % K, part = tid / K, last = part * RP + RP;
      float acc = 0.f;
#pragma unroll
      for (int row = 0; row < CH; ++row) {
        const float l = LA[row * PR + j];
        if (row < last) acc += l;
        if (row >= last - RP && row < last) {
          RIN[row * PC + j] = acc;
          KD[row * PR + j] = acc - l;
        }
      }
      if (part == NP - 1) {
        alast[j] = acc;
        elast[j] = expf(acc);
      }
    }
    {
      // a warp's rows side by side, so that their shuffles overlap
      constexpr int RB = CH / kWarps, RS = K / kWarps, L = (K + 31) / 32;
      float bs[RB], dbs[RB], ss[RS];
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int row = warp + kWarps * q;
        bs[q] = dbs[q] = 0.f;
#pragma unroll
        for (int c = 0; c < L; ++c) {
          const int j = lane + 32 * c;
          if (j < K) {
            bs[q] += R[row * PR + j] * uv[j] * Kt[row * PR + j];
            dbs[q] += DO[row * PR + j] * V[row * PR + j];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < RS; ++q) {
        const int row = warp + kWarps * q;
        ss[q] = 0.f;
#pragma unroll
        for (int c = 0; c < L; ++c) {
          const int j = lane + 32 * c;
          if (j < K) ss[q] += DS[row * PC + j] * S[row * PR + j];
        }
      }
      // β and dβ of the warp's rows share their shuffles, as do its rows
      // of Σ_v dS S
      float bd[2 * RB];
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        bd[q] = bs[q];
        bd[RB + q] = dbs[q];
      }
      int ib, is;
      lanes_sum(bd, lane, ib);
      lanes_sum(ss, lane, is);
      if ((lane & (32 / (2 * RB) - 1)) == 0)
        (ib < RB ? beta : dbeta)[warp + kWarps * (ib % RB)] = bd[0];
      if ((lane & (32 / RS - 1)) == 0) dsS[warp + kWarps * is] = ss[0];
    }
    __syncthreads();
    if (tid == 0 && n >= 1) issue(&tm_la, B::kLa, kBarLa, n - 1);
    WKV6_BWD_MARK(1);

    // (2) the factors of the owned elements, each exponential once; the
    // scaled tiles written over a, a_prev, r and k
    float e_ap[NR][NC][4], e_kf[NR][NC][4], e_dec[NR][NC][4];
    float gr_p[NR][NC][4], gk_p[NR][NC][4];     // dβ u k, dβ r u
    uint32_t side[NR][NC] = {};                 // clip sides, 4 bits each
    if (owns) {
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int i = 0; i < NC; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = 16 * rb[j] + g + 8 * half;
            const int col = 8 * ct[i] + 2 * t;
            const float2 a2 = ld2(RIN + row * PC + col);
            const float2 ap2 = ld2(KD + row * PR + col);
            const float2 r2 = ld2(R + row * PR + col);
            const float2 k2 = ld2(Kt + row * PR + col);
            const float db = dbeta[row];
            float rin[2], rf[2], kf[2], kd[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int q = 2 * half + e;
              const float a = e ? a2.y : a2.x, ap = e ? ap2.y : ap2.x;
              const float r = e ? r2.y : r2.x, k = e ? k2.y : k2.x;
              const float uu = uv[col + e];
              const uint32_t sp = clip_side(ap), sa = clip_side(-a);
              const float ea = expf(ap);
              const float erf = sp <= 1 ? ea : (sp == 2 ? e_lo : e_hi);
              const float ek = expf(clip(-a));
              const float ed = expf(alast[col + e] - a);
              e_ap[j][i][q] = ea;
              e_kf[j][i][q] = ek;
              e_dec[j][i][q] = ed;
              side[j][i] |= (sp | sa << 2) << (4 * q);
              rin[e] = r * ea;
              rf[e] = r * erf;
              kf[e] = k * ek;
              kd[e] = k * ed;
              const float dbk = db * k;
              gr_p[j][i][q] = dbk * uu;
              gk_p[j][i][q] = db * (r * uu);
              du_acc[i][e] += dbk * r;
            }
            st2(RIN + row * PC + col, rin[0], rin[1]);
            st2(R + row * PR + col, rf[0], rf[1]);
            st2(Kt + row * PR + col, kf[0], kf[1]);
            st2(KD + row * PR + col, kd[0], kd[1]);
          }
    }
    fence_async_smem();                         // r_f, k_f before TMA's r, k
    __syncthreads();
    WKV6_BWD_MARK(2);

    // (3) att (β on the diagonal, 0 above) and datt (0 on and above the
    // diagonal) on the 16-row blocks on or below it; do Sᵀ
    if (SA::has(warp)) {
      const int ra = SA::row_block(warp);
      float acc[1][SA::kPer][4] = {}, dacc[1][SA::kPer][4] = {};
      product<1, SA::kPer, Ranges<0, K / 8>>(
          acc,
          [&](int ks, int, float(&x)[4]) {
            ld_a(R + 16 * ra * PR + 8 * ks, PR, lane, x);
          },
          [&](int ks, int i, float(&x)[2]) {
            ld_b_nk(Kt + 8 * SA::col_tile(warp, i) * PR + 8 * ks, PR, lane,
                    x);
          });
      product<1, SA::kPer, Ranges<0, K / 8>>(
          dacc,
          [&](int ks, int, float(&x)[4]) {
            ld_a(DO + 16 * ra * PR + 8 * ks, PR, lane, x);
          },
          [&](int ks, int i, float(&x)[2]) {
            ld_b_nk(V + 8 * SA::col_tile(warp, i) * PR + 8 * ks, PR, lane, x);
          });
#pragma unroll
      for (int i = 0; i < SA::kPer; ++i) {
        if (!SA::writes(warp, i)) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 16 * ra + g + 8 * half;
          const int col = 8 * SA::col_tile(warp, i) + 2 * t;
          const float b = beta[row];
          st2(ATT + row * PA + col,
              col < row ? acc[0][i][2 * half] : (col == row ? b : 0.f),
              col + 1 < row ? acc[0][i][2 * half + 1]
                            : (col + 1 == row ? b : 0.f));
          st2(DATT + row * PD + col, col < row ? dacc[0][i][2 * half] : 0.f,
              col + 1 < row ? dacc[0][i][2 * half + 1] : 0.f);
        }
      }
    }
    float drin[NR][NC][4] = {};
    if (owns) {
      product<NR, NC, Ranges<0, K / 8>>(
          drin,
          [&](int ks, int j, float(&x)[4]) {
            ld_a(DO + 16 * rb[j] * PR + 8 * ks, PR, lane, x);
          },
          [&](int ks, int i, float(&x)[2]) {
            ld_b_nk(S + 8 * ct[i] * PR + 8 * ks, PR, lane, x);
          });
    }
    __syncthreads();
    if (tid == 0 && n >= 1) issue_s(n - 1);
    WKV6_BWD_MARK(3);

    // (4) datt k_f (datt's columns past the row block's diagonal are 0 and
    // skipped); dr and d_ap
    float d_ap[NR][NC][4];
    if (owns) {
      float drf[NR][NC][4] = {};
      with_group<SO::kGroups>(grp, [&](auto G) {
        constexpr int r0 = decltype(G)::value, r1 = MB - 1 - r0;
        product<NR, NC, Ranges<0, 2 * r0 + 2, 0, 2 * r1 + 2>>(
            drf,
            [&](int ks, int j, float(&x)[4]) {
              ld_a(DATT + 16 * (j ? r1 : r0) * PD + 8 * ks, PD, lane, x);
            },
            [&](int ks, int i, float(&x)[2]) {
              ld_b_kn(Kt + 8 * ks * PR + 8 * ct[i], PR, g, t, x);
            });
      });
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int i = 0; i < NC; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = 16 * rb[j] + g + 8 * half;
            const int col = 8 * ct[i] + 2 * t;
            const float2 rin2 = ld2(RIN + row * PC + col);
            float gr[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int q = 2 * half + e;
              const uint32_t sp = (side[j][i] >> (4 * q)) & 3;
              const float ea = e_ap[j][i][q];
              const float erf = sp <= 1 ? ea : (sp == 2 ? e_lo : e_hi);
              const float a = drin[j][i][q], b = drf[j][i][q];
              gr[e] = a * ea + b * erf + gr_p[j][i][q];
              // inside the clip or on it, r_f is r_in bit for bit
              const float rin = e ? rin2.y : rin2.x;
              d_ap[j][i][q] = a * rin + (sp <= 1 ? b * rin * clip_grad(sp)
                                                  : 0.f);
            }
            if (t0 + row < s) st2(dr + at(t0 + row, col), gr[0], gr[1]);
          }
    }
    WKV6_BWD_MARK(4);

    // (5) v dSᵀ and dattᵀ r_f (datt's rows above the row block are 0 and
    // skipped); dk, d_a + d_ap, and Σ_t (v dSᵀ) ⊙ k_dec by column
    float d_tot[NR][NC][4];
    if (owns) {
      float dkd[NR][NC][4] = {}, dkf[NR][NC][4] = {};
      product<NR, NC, Ranges<0, K / 8>>(
          dkd,
          [&](int ks, int j, float(&x)[4]) {
            ld_a(V + 16 * rb[j] * PR + 8 * ks, PR, lane, x);
          },
          [&](int ks, int i, float(&x)[2]) {
            ld_b_nk(DS + 8 * ct[i] * PC + 8 * ks, PC, lane, x);
          });
      with_group<SO::kGroups>(grp, [&](auto G) {
        constexpr int r0 = decltype(G)::value, r1 = MB - 1 - r0;
        product<NR, NC, Ranges<2 * r0, CH / 8, 2 * r1, CH / 8>>(
            dkf,
            [&](int ks, int j, float(&x)[4]) {
              ld_at(DATT + 8 * ks * PD + 16 * (j ? r1 : r0), PD, g, t, x);
            },
            [&](int ks, int i, float(&x)[2]) {
              ld_b_kn(R + 8 * ks * PR + 8 * ct[i], PR, g, t, x);
            });
      });
      float ysum[NC][2] = {};
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int i = 0; i < NC; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = 16 * rb[j] + g + 8 * half;
            const int col = 8 * ct[i] + 2 * t;
            const float2 kf2 = ld2(Kt + row * PR + col);
            const float2 kd2 = ld2(KD + row * PR + col);
            float gk[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int q = 2 * half + e;
              const uint32_t sa = (side[j][i] >> (4 * q + 2)) & 3;
              const float a = dkd[j][i][q], b = dkf[j][i][q];
              const float kd = e ? kd2.y : kd2.x, kf = e ? kf2.y : kf2.x;
              gk[e] = a * e_dec[j][i][q] + b * e_kf[j][i][q] + gk_p[j][i][q];
              const float y = a * kd;
              ysum[i][e] += y;
              d_tot[j][i][q] = (-y - b * kf * clip_grad(sa)) + d_ap[j][i][q];
            }
            if (t0 + row < s) st2(dk + at(t0 + row, col), gk[0], gk[1]);
          }
#pragma unroll
      for (int i = 0; i < NC; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y = rows_sum(ysum[i][e]);
          if (g == 0) cols[grp * K + 8 * ct[i] + 2 * t + e] = y;
        }
    }
    __syncthreads();
    if (tid == 0 && n >= 1) {
      issue(&tm_r, B::kR, kBarR, n - 1);
      issue(&tm_k, B::kK, kBarK, n - 1);
      issue(&tm_v, B::kV, kBarV, n - 1);
    }
    WKV6_BWD_MARK(5);

    // (6) dv = k_dec dS + attᵀ do (att's rows above the row block are 0
    // and skipped; β ⊙ do from its diagonal); r_inᵀ do
    if (owns) {
      float acc[NR][NC][4] = {};
      product<NR, NC, Ranges<0, K / 8>>(
          acc,
          [&](int ks, int j, float(&x)[4]) {
            ld_a(KD + 16 * rb[j] * PR + 8 * ks, PR, lane, x);
          },
          [&](int ks, int i, float(&x)[2]) {
            ld_b_kn(DS + 8 * ks * PC + 8 * ct[i], PC, g, t, x);
          });
      with_group<SO::kGroups>(grp, [&](auto G) {
        constexpr int r0 = decltype(G)::value, r1 = MB - 1 - r0;
        product<NR, NC, Ranges<2 * r0, CH / 8, 2 * r1, CH / 8>>(
            acc,
            [&](int ks, int j, float(&x)[4]) {
              ld_at(ATT + 8 * ks * PA + 16 * (j ? r1 : r0), PA, g, t, x);
            },
            [&](int ks, int i, float(&x)[2]) {
              ld_b_kn(DO + 8 * ks * PR + 8 * ct[i], PR, g, t, x);
            });
      });
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int i = 0; i < NC; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = 16 * rb[j] + g + 8 * half;
            if (t0 + row < s)
              st2(dv + at(t0 + row, 8 * ct[i] + 2 * t),
                  acc[j][i][2 * half], acc[j][i][2 * half + 1]);
          }
    }
    const int mb = SS::row_block(warp);
    float dsn[1][SS::kPer][4] = {};
    if (SS::has(warp)) {
      product<1, SS::kPer, Ranges<0, CH / 8>>(
          dsn,
          [&](int ks, int, float(&x)[4]) {
            ld_at(RIN + 8 * ks * PC + 16 * mb, PC, g, t, x);
          },
          [&](int ks, int i, float(&x)[2]) {
            ld_b_kn(DO + 8 * ks * PR + 8 * SS::col_tile(warp, i), PR, g, t,
                    x);
          });
    }
    __syncthreads();                            // dS, att, k_dec, r_in, do read
    if (tid == 0 && n >= 2) issue_do(n - 2, buf);
    WKV6_BWD_MARK(6);

    // (7) dS' = diag(e^{a_last}) dS + r_inᵀ do; d_a + d_ap and d_ap
    // parked for the column pass; then dla
    if (SS::has(warp)) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * mb + g + 8 * half;
        const float d = elast[row];
#pragma unroll
        for (int i = 0; i < SS::kPer; ++i) {
          float* const p = DS + row * PC + 8 * SS::col_tile(warp, i) + 2 * t;
          const float2 old = ld2(p);
          st2(p, __fadd_rn(__fmul_rn(old.x, d), dsn[0][i][2 * half]),
              __fadd_rn(__fmul_rn(old.y, d), dsn[0][i][2 * half + 1]));
        }
      }
    }
    if (owns) {
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int i = 0; i < NC; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = 16 * rb[j] + g + 8 * half;
            const int col = 8 * ct[i] + 2 * t;
            st2(KD + row * PR + col, d_tot[j][i][2 * half],
                d_tot[j][i][2 * half + 1]);
            st2(RIN + row * PC + col, d_ap[j][i][2 * half],
                d_ap[j][i][2 * half + 1]);
          }
    }
    __syncthreads();
    {
      // part p of column j sums d_a + d_ap from the last row down to its
      // rows, a_last's gradient first
      const int j = tid % K, part = tid / K;
      float ys = cols[j];
#pragma unroll
      for (int q = 1; q < SO::kGroups; ++q) ys += cols[q * K + j];
      float acc = dsS[j] * elast[j] + ys;
#pragma unroll 16
      for (int row = CH - 1; row >= (part + 1) * RP; --row)
        acc += KD[row * PR + j];
#pragma unroll
      for (int i = RP - 1; i >= 0; --i) {
        const int row = part * RP + i;
        acc += KD[row * PR + j];
        if (t0 + row < s) dla[at(t0 + row, j)] = acc - RIN[row * PC + j];
      }
    }
    __syncthreads();                            // KD and RIN read
    WKV6_BWD_MARK(7);
  }

  // du: this block's share, the owners of a column summed in a fixed order
  if (owns) {
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = rows_sum(du_acc[i][e]);
        if (g == 0) cols[grp * K + 8 * ct[i] + 2 * t + e] = x;
      }
  }
  __syncthreads();
  if (tid < K) {
    float acc = cols[tid];
#pragma unroll
    for (int q = 1; q < SO::kGroups; ++q) acc += cols[q * K + tid];
    du_part[static_cast<int64_t>(bh) * K + tid] = acc;
  }
  WKV6_BWD_TRACE_FLUSH(1);
}

// du[e] = Σ_bi du_part[bi][e], in batch order
__global__ void wkv6_du_kernel(const float* __restrict__ part,
                               float* __restrict__ du, int b, int hk) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= hk) return;
  float acc = 0.f;
  for (int bi = 0; bi < b; ++bi)
    acc += part[static_cast<int64_t>(bi) * hk + e];
  du[e] = acc;
}

#ifdef WKV6_BWD_TRACE
// events around the three kernels of the last call
cudaEvent_t trace_events[4];
bool trace_events_made = false;
void trace_event(int i, cudaStream_t stream) {
  if (!trace_events_made) {
    for (cudaEvent_t& e : trace_events) cudaEventCreate(&e);
    trace_events_made = true;
  }
  cudaEventRecord(trace_events[i], stream);
}
#else
void trace_event(int, cudaStream_t) {}
#endif

// 4-D map of the state scratch (b·H, n_chunks, K, K) f32, dims innermost
// first, boxes of one K x K state `cols` columns wide (the columns past K
// arrive as zeros, which pads each row in shared memory to `cols`)
int encode_states_map(CUtensorMap* map, void* base, int K, int n_chunks,
                      int bh, int cols) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t kk = static_cast<cuuint64_t>(K);
  const cuuint64_t dims[4] = {kk, kk, static_cast<cuuint64_t>(n_chunks),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[3] = {kk * 4, kk * kk * 4,
                                 static_cast<cuuint64_t>(n_chunks) * kk *
                                     kk * 4};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(K), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <int CH, int K>
int launch(const void* const* x, const int64_t* st, const float* u,
           float* states, float* part, float* const* grads, float* du, int b,
           int s, int H, cudaStream_t stream) {
  using BW = Bwd<CH, K>;
  using SP = States<CH, K>;
  const int n_chunks = (s + CH - 1) / CH;
  const dim3 grid(H, b);
  // r, k, v, la, do for the reverse pass; k, v, la for the state pass
  CUtensorMap maps[5], smaps[3], tm_s;
  for (int i = 0; i < 5; ++i) {
    const int e = hopper::encode_heads_map(
        &maps[i], x[i], b, s, H, K, st[3 * i], st[3 * i + 1], st[3 * i + 2],
        CH, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, BW::PR,
        CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e != 0) return kMapError + e;
  }
  for (int i = 0; i < 3; ++i) {
    const int e = hopper::encode_heads_map(
        &smaps[i], x[i + 1], b, s, H, K, st[3 * i + 3], st[3 * i + 4],
        st[3 * i + 5], CH, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, SP::P,
        CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e != 0) return kMapError + e;
  }
  const int e_s = encode_states_map(&tm_s, states, K, n_chunks, b * H, BW::PR);
  if (e_s != 0) return kMapError + e_s;

  auto states_kernel = wkv6_states_kernel<CH, K>;
  cudaError_t e = cudaFuncSetAttribute(
      states_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SP::kBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(states_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto bwd_kernel = wkv6_bwd_kernel<CH, K>;
  e = cudaFuncSetAttribute(bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           BW::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  trace_event(0, stream);
  states_kernel<<<grid, kThreads, SP::kBytes, stream>>>(smaps[0], smaps[1],
                                                        smaps[2], states, s);
  trace_event(1, stream);
  bwd_kernel<<<grid, kThreads, BW::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], tm_s, u, grads[0],
      grads[1], grads[2], grads[3], part, s);
  trace_event(2, stream);
  const int hk = H * K;
  wkv6_du_kernel<<<(hk + 255) / 256, 256, 0, stream>>>(part, du, b, hk);
  trace_event(3, stream);
  return static_cast<int>(cudaGetLastError());
}

template <int CH>
int dispatch_k(const void* const* x, const int64_t* st, const float* u,
               float* states, float* part, float* const* g, float* du, int b,
               int s, int H, int K, cudaStream_t stream) {
  switch (K) {
    case 16:
      return launch<CH, 16>(x, st, u, states, part, g, du, b, s, H, stream);
    case 32:
      return launch<CH, 32>(x, st, u, states, part, g, du, b, s, H, stream);
    case 64:
      return launch<CH, 64>(x, st, u, states, part, g, du, b, s, H, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry for ctypes. r/k/v/la/do are device pointers to f32
// (b, s, H, K) tensors with a unit stride on K, their batch, sequence and
// head strides in elements in that order (r, k, v, la, do; bases and
// strides 16-byte aligned, as TMA takes them); u a contiguous (H, K) f32
// tensor. `states` is f32 scratch of b·H·ceil(s / chunk)·K·K elements and
// `du_part` of b·H·K; dr, dk, dv and dla are contiguous (b, s, H, K) f32
// outputs and du a contiguous (H, K) one. Chunks of `chunk` rows (16, 32
// or 64) from position 0, K 16, 32 or 64. Launches the three kernels
// asynchronously on `stream` and returns the first CUDA error,
// kMapError + the CUresult of a refused tensor-map encode, or 0.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* la, const void* dout, const void* u,
                        void* states, void* du_part, void* dr, void* dk,
                        void* dv, void* dla, void* du, int b, int s, int H,
                        int K, int chunk, int64_t rsb, int64_t rss,
                        int64_t rsh, int64_t ksb, int64_t kss, int64_t ksh,
                        int64_t vsb, int64_t vss, int64_t vsh, int64_t lsb,
                        int64_t lss, int64_t lsh, int64_t dsb, int64_t dss,
                        int64_t dsh, void* stream) {
  if (b <= 0 || s <= 0 || H <= 0 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const x[5] = {r, k, v, la, dout};
  const int64_t st[15] = {rsb, rss, rsh, ksb, kss, ksh, vsb, vss,
                          vsh, lsb, lss, lsh, dsb, dss, dsh};
  float* const g[4] = {static_cast<float*>(dr), static_cast<float*>(dk),
                       static_cast<float*>(dv), static_cast<float*>(dla)};
  const float* const uf = static_cast<const float*>(u);
  float* const sf = static_cast<float*>(states);
  float* const pf = static_cast<float*>(du_part);
  float* const duf = static_cast<float*>(du);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 16: return dispatch_k<16>(x, st, uf, sf, pf, g, duf, b, s, H, K, cs);
    case 32: return dispatch_k<32>(x, st, uf, sf, pf, g, duf, b, s, H, K, cs);
    case 64: return dispatch_k<64>(x, st, uf, sf, pf, g, duf, b, s, H, K, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef WKV6_BWD_TRACE
// The last call's traced cycles (2 kernels x 8 warps x 8 phases, the state
// pass first) into `cycles`, and the device time of its three kernels in
// milliseconds (state pass, reverse pass, du) into `ms`; waits for the
// call to end.
extern "C" int wkv6_bwd_trace(unsigned long long* cycles, float* ms) {
  cudaError_t e = cudaEventSynchronize(trace_events[3]);
  for (int i = 0; i < 3 && e == cudaSuccess; ++i)
    e = cudaEventElapsedTime(ms + i, trace_events[i], trace_events[i + 1]);
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(cycles, wkv6_bwd_trace_cycles,
                             sizeof(wkv6_bwd_trace_cycles));
  return static_cast<int>(e);
}
#endif

extern "C" const char* wkv6_bwd_error_string(int err) {
  if (err >= kMapError) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
