// RWKV-6 chunked WKV recurrence; hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `wkv6` / `_wkv_kernel`
// (src/repro/kernels/wkv6/kernel.py:28-92) and its padding, transposing
// wrapper (src/repro/kernels/wkv6/ops.py): the time mix of every prefill of
// the ssm family (`models/rwkv6.py` time_mix, rwkv6-3b).
//
// What it computes, for r/k/v/la (b, s, H, K) f32 and u (H, K) f32, per
// (batch row, head), from a zero K x K state S, chunk by chunk of CH rows
// from position 0 (a = cumsum(la) within the chunk, a_prev = a − la):
//   o     = (r ⊙ e^{a_prev}) S
//         + tril₋₁[(r ⊙ e^{clip(a_prev)}) (k ⊙ e^{clip(−a)})ᵀ] v
//         + (Σ_j r ⊙ u ⊙ k) v
//   S    <- diag(e^{a_last}) S + (k ⊙ e^{a_last − a})ᵀ v
// with clip to ±40, all in f32, as the TPU kernel does; out (b, s, H, K)
// f32. The clip makes the result depend on where the chunks start, so the
// chunking is the TPU kernel's own: CH rows from position 0, a ragged last
// chunk zero-filled (la = 0 neither decays nor adds, exactly the TPU
// wrapper's padding), and a sequence shorter than CH one chunk of s rows.
//
// What bounds it: at rwkv6-3b's prefill (b 8, s 2048, 48 heads, K 64,
// chunk 64) a launch reads 805 MB and writes 201 MB (0.300 ms at
// 3.35 TB/s) and does 19.5 GFLOP (0.29 ms on the f32 CUDA cores): the
// bytes set the bound. The state stays on chip, one block per (head,
// batch row) walking its chunks in order: a split into chunk-parallel
// passes would write and read a 16 KB state for every chunk, 201 MB each
// way, and the 384 blocks already fill the 132 SMs three times over.
//
// Layout: 512 threads, one block an SM (216,144 bytes of shared memory for
// chunk 64, K 64). Two prep warpgroups get chunk n + 1 ready while two
// math warpgroups multiply chunk n; they hand stages over on mbarriers.
// TMA brings each chunk's r, k, la and v tiles, read in the model layout
// through their strides, into a ring of two stages (a ragged last chunk
// arrives zero-filled); r, k and la are loaded again as soon as the math
// group is done with them (after o), v after ΔS. The boxes are wider than
// K, so the rows land padded: pitch K + 4 for tiles whose fragments are
// read along rows, K + 8 for those read along columns (v, and the kd tile
// and the state written here), which puts the 32 lanes of every fragment
// load in 32 distinct banks.
//   prep (1): a, each thread summing its channel's la from row 0 in row
//        order (the reference's sequential cumsum), and β_t = Σ_j r u k;
//   prep (2): the four scaled tiles, written in place over r, k and la
//        (kd into a buffer of its own, one a stage);
//   math (3): on the tensor cores, att = r_f·k_fᵀ on the 16-row blocks on
//        or left of the diagonal (three 16 x 8 tiles a warp), written over
//        r_f with β on its diagonal; o = r_s·S + att·v straight to device
//        memory, row blocks paired so that every warp does the same work;
//        ΔS = k_dᵀ·v and S' = diag(e^{a_last}) S + ΔS into the other of
//        two state buffers.
//
// The products run in 3xTF32 on `mma.sync.m16n8k8`: each f32 operand is
// split into hi and lo = x − hi, and lo·hi′ + hi·lo′ + hi·hi′ is
// accumulated in f32 (mma_sync.cuh `split_tf32`, `mma_3xtf32`). Range is
// not what limits TF32: k ⊙ e^{clip(−a)} reaches e^40 ≈ 2^58, well inside
// its 8-bit exponent. Its 10-bit mantissa is: one TF32 product leaves ~4e-4
// relative error, over the 1e-5 limit the card holds the kernel to, where
// three leave under 1e-6. Every operand is scaled relative to r or k
// (e^{clip(a_prev)} ≤ 1, e^{a_last − a} ≤ 1, each clipped pairwise factor
// ≤ 1), so the relative error of a product stays relative in every term.
//
// Built with -DWKV6_TRACE, the kernel sums the cycles of each phase of
// block (0, 0) per warp, and `wkv6_trace` copies them out
// (`launch/wkv6_pair.py --trace` prints them).
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

// Four warpgroups: two prepare chunk n + 1 (the cumulative decay, β and
// the scaled tiles) while two multiply chunk n on the tensor cores.
constexpr int kPrep = 256;                      // threads of the prep group
constexpr int kWarps = 8;                       // math warps
constexpr int kMath = 32 * kWarps;
constexpr int kThreads = kPrep + kMath;
constexpr int kStages = 2;
constexpr float kClip = 40.f;
// A failed tensor-map encode is returned as kMapError + the CUresult.
constexpr int kMapError = 100000;

// Shared-memory layout for CH-row chunks of K-wide heads, in bytes, each
// region a multiple of 128. A stage holds the r (then r_s), k (then k_f),
// la (then r_f, then att) and v tiles of one chunk; kd, β and a_last come
// in two buffers, one a stage, and the state in two, read and written.
template <int CH, int K>
struct Cfg {
  static constexpr int PK = K + 4;              // r, k: read along rows
  static constexpr int PA = (K > CH ? K : CH) + 4;  // la / r_f / att
  static constexpr int PV = K + 8;              // v, kd, S: along columns
  static constexpr int kR = CH * PK * 4;
  static constexpr int kLa = CH * PA * 4;
  static constexpr int kV = CH * PV * 4;
  static constexpr int kStage = 2 * kR + kLa + kV;
  static constexpr int kKd = kStages * kStage;  // two
  static constexpr int kS = kKd + 2 * CH * PV * 4;    // two
  static constexpr int kBeta = kS + 2 * K * PV * 4;   // two
  static constexpr int kLast = kBeta + 2 * CH * 4;    // two
  static constexpr int kBars = kLast + 2 * K * 4;
  static constexpr int kBytes = kBars + 5 * 8 * kStages;   // 5 mbarriers
};

// The tiles of one product that a consumer warp computes: a product with
// M16 16-row blocks and N8 8-column tiles is cut into M16·N8 tiles, and
// warp w takes tiles w·kPer .. w·kPer + kPer − 1 (fewer past the end), all
// in the row block `row_block`, so that they share their A fragments.
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

#ifdef WKV6_TRACE
// cycles per phase summed over the chunks of block (0, 0), per warp
__device__ unsigned long long wkv6_trace_cycles[kThreads / 32 * 6];
#endif

__device__ __forceinline__ float clip(float x) {
  return fminf(fmaxf(x, -kClip), kClip);
}

// named barrier over `count` threads (id 0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// acc += sml, elementwise
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
// columns) of a tile stored n-major (B[k][n] = p[n][k]) or k-major.
__device__ __forceinline__ void ld_a(const float* p, int P, int g, int t,
                                     float (&x)[4]) {
  x[0] = p[g * P + t];
  x[1] = p[(g + 8) * P + t];
  x[2] = p[g * P + t + 4];
  x[3] = p[(g + 8) * P + t + 4];
}
__device__ __forceinline__ void ld_at(const float* p, int P, int g, int t,
                                      float (&x)[4]) {
  x[0] = p[t * P + g];
  x[1] = p[t * P + g + 8];
  x[2] = p[(t + 4) * P + g];
  x[3] = p[(t + 4) * P + g + 8];
}
__device__ __forceinline__ void ld_b_nk(const float* p, int P, int g, int t,
                                        float (&x)[2]) {
  x[0] = p[g * P + t];
  x[1] = p[g * P + t + 4];
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

// acc[j][i] += Σ_{ks0 ≤ ks < ks1} A(ks, j) · B(ks, i) for NR row tiles and
// NC column tiles, in 3xTF32; lda(ks, j, x) and ldb(ks, i, x) load the raw
// fragments. Each step's fragments are loaded while the step before
// multiplies.
template <int NR, int NC, class LA, class LB>
__device__ __forceinline__ void product(float (*acc)[NC][4], int ks0, int ks1,
                                        LA&& lda, LB&& ldb) {
  if (ks0 >= ks1) return;
  float sml[NR][NC][4] = {};
  float a[NR][4], b[NC][2];
#pragma unroll
  for (int j = 0; j < NR; ++j) lda(ks0, j, a[j]);
#pragma unroll
  for (int i = 0; i < NC; ++i) ldb(ks0, i, b[i]);
#pragma unroll
  for (int ks = ks0; ks < ks1; ++ks) {
    uint32_t ah[NR][4], al[NR][4], bh[NC][2], bl[NC][2];
#pragma unroll
    for (int j = 0; j < NR; ++j) split(a[j], ah[j], al[j]);
#pragma unroll
    for (int i = 0; i < NC; ++i) split(b[i], bh[i], bl[i]);
    if (ks + 1 < ks1) {
#pragma unroll
      for (int j = 0; j < NR; ++j) lda(ks + 1, j, a[j]);
#pragma unroll
      for (int i = 0; i < NC; ++i) ldb(ks + 1, i, b[i]);
    }
#pragma unroll
    for (int j = 0; j < NR; ++j)
      mma::mma_3xtf32(acc[j], sml[j], ah[j], al[j], bh, bl);
  }
#pragma unroll
  for (int j = 0; j < NR; ++j) add_to(acc[j], sml[j]);
}

// The att tiles that consumer warp w computes. At 64 rows, only the 20
// tiles on or left of the diagonal's 16-row blocks (rows 0..3 need 2, 4,
// 6 and 8 column tiles), at most three a warp, each warp in one row block
// so that its tiles share A; a warp with two computes its first again in
// the third slot and does not write it. Otherwise every tile, as Split.
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

// The o tiles (CH x K) that consumer warp w computes: with two or more row
// blocks, warps go in groups, each taking a pair of row blocks, rb and
// MB − 1 − rb, which together need the same number of att · v products
// (the att columns past a row block's diagonal are 0 and skipped); a warp
// takes kCols column tiles of both rows, sharing B fragments between rows
// and A fragments between columns.
template <int MB, int N8>
struct OSplit {
  static constexpr int kRows = MB >= 2 ? 2 : 1;         // row blocks a warp
  static constexpr int kGroups = MB / kRows;
  static constexpr int kPerGroup = kWarps / kGroups;
  static constexpr int kCols = (N8 + kPerGroup - 1) / kPerGroup;
  static constexpr bool kGuard = N8 % kPerGroup != 0;
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

template <int CH, int K>
__global__ void __launch_bounds__(kThreads, 1)
wkv6_kernel(const __grid_constant__ CUtensorMap tm_r,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_la,
            const __grid_constant__ CUtensorMap tm_v,
            const float* __restrict__ u, float* __restrict__ out, int s) {
  using C = Cfg<CH, K>;
  constexpr int PK = C::PK, PA = C::PA, PV = C::PV;
  using SA = ASplit<CH>;                        // att (CH x CH)
  using SO = OSplit<CH / 16, K / 8>;            // o (CH x K)
  using SS = Split<K / 16, K / 8>;              // ΔS (K x K)
  extern __shared__ __align__(128) unsigned char sm[];
  const uint32_t bars = hopper::smem_addr(sm + C::kBars);
  // per stage: r, k, la landed; v landed; prep done (a chunk's scaled
  // tiles are ready); the math group done with r, k, la (after o); and
  // with v and kd (after ΔS)
  auto full_p = [&](int st) { return bars + 8 * st; };
  auto full_v = [&](int st) { return bars + 8 * (2 + st); };
  auto prepped = [&](int st) { return bars + 8 * (4 + st); };
  auto rel_p = [&](int st) { return bars + 8 * (6 + st); };
  auto rel_v = [&](int st) { return bars + 8 * (8 + st); };
  auto tile = [&](int st, int off) {
    return reinterpret_cast<float*>(sm + st * C::kStage + off);
  };
  auto kd_of = [&](int st) {
    return reinterpret_cast<float*>(sm + C::kKd) + st * CH * PV;
  };
  auto beta_of = [&](int st) {
    return reinterpret_cast<float*>(sm + C::kBeta) + st * CH;
  };
  auto last_of = [&](int st) {
    return reinterpret_cast<float*>(sm + C::kLast) + st * K;
  };

  const int h = blockIdx.x;
  const int H = gridDim.x;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int n_chunks = (s + CH - 1) / CH;

  auto issue_p = [&](int n) {                   // chunk n's r, k, la
    const int st = n % kStages;
    hopper::mbar_expect_tx(full_p(st), 2 * C::kR + C::kLa);
    const uint32_t base = hopper::smem_addr(sm + st * C::kStage);
    hopper::tma_load_4d(base, &tm_r, full_p(st), 0, h, n * CH, bi);
    hopper::tma_load_4d(base + C::kR, &tm_k, full_p(st), 0, h, n * CH, bi);
    hopper::tma_load_4d(base + 2 * C::kR, &tm_la, full_p(st), 0, h, n * CH,
                        bi);
  };
  auto issue_v = [&](int n) {                   // and its v
    const int st = n % kStages;
    hopper::mbar_expect_tx(full_v(st), C::kV);
    hopper::tma_load_4d(
        hopper::smem_addr(sm + st * C::kStage + 2 * C::kR + C::kLa), &tm_v,
        full_v(st), 0, h, n * CH, bi);
  };
  if (tid == 0) {
    if (hopper::smem_addr(sm) & 127) __trap();   // TMA needs 128-byte tiles
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(full_p(st), 1);
      hopper::mbar_init(full_v(st), 1);
      hopper::mbar_init(prepped(st), kPrep / 32);
      hopper::mbar_init(rel_p(st), kWarps);
      hopper::mbar_init(rel_v(st), kWarps);
    }
    hopper::mbar_fence_init();
    hopper::tma_prefetch_map(&tm_r);
    hopper::tma_prefetch_map(&tm_k);
    hopper::tma_prefetch_map(&tm_la);
    hopper::tma_prefetch_map(&tm_v);
    for (int n = 0; n < kStages && n < n_chunks; ++n) {
      issue_p(n);
      issue_v(n);
    }
  }
  for (int i = tid; i < K * PV; i += kThreads)
    reinterpret_cast<float*>(sm + C::kS)[i] = 0.f;
  __syncthreads();
#ifdef WKV6_TRACE
  unsigned long long trace[6] = {}, mark = clock64();
#define WKV6_MARK(i)                               \
  do {                                             \
    const unsigned long long now = clock64();      \
    trace[i] += now - mark;                        \
    mark = now;                                    \
  } while (0)
#else
#define WKV6_MARK(i) \
  do {               \
  } while (0)
#endif

  if (tid < kPrep) {
    // ---- prep: chunk n's a, β and scaled tiles, once the math group is
    // done with chunk n − 2 (the same stage and buffers)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::: "memory");
    // thread tid < P·K takes channel tid % K, rows RP·p .. RP·p + RP − 1
    // of part p = tid / K; for β, TPR threads a row
    constexpr int P = kPrep / K < CH ? kPrep / K : CH;
    constexpr int RP = CH / P;
    constexpr int TPR0 = kPrep / CH < 32 ? kPrep / CH : 32;
    constexpr int TPR = TPR0 < K ? TPR0 : K;
    const int jc = tid % K;
    const int part = tid / K;
    const bool scans = tid < P * K;
    const int row_b = tid / TPR;
    const int q = tid % TPR;
    const bool sums = row_b < CH;
    for (int n = 0; n < n_chunks; ++n) {
      const int st = n % kStages;
      float* const r_s = tile(st, 0);           // r, then r ⊙ e^{a_prev}
      float* const k_s = tile(st, C::kR);       // k, then k_f
      float* const la_s = tile(st, 2 * C::kR);  // la, then r_f
      float* const kd_s = kd_of(st);
      float* const beta_s = beta_of(st);
      float* const last_s = last_of(st);
      hopper::mbar_wait(full_p(st), (n / kStages) & 1);
      WKV6_MARK(0);

      // (1) a = cumsum(la) over rows 0 .. this part's last, in row order
      // (the reference's sequential sum), and β_t = Σ_j r u k
      float a_r[RP];
      if (scans) {
        float acc = 0.f;
#pragma unroll 16
        for (int i = 0; i < part * RP; ++i) acc += la_s[i * PA + jc];
#pragma unroll
        for (int i = 0; i < RP; ++i) {
          acc += la_s[(part * RP + i) * PA + jc];
          a_r[i] = acc;
        }
        if (part == P - 1) last_s[jc] = acc;
      }
      if (sums) {
        float bsum = 0.f;
#pragma unroll
        for (int m = 0; m < K / TPR; ++m) {
          const int e = row_b * PK + q + TPR * m;
          bsum += r_s[e] * __ldg(u + h * K + q + TPR * m) * k_s[e];
        }
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1)
          bsum += __shfl_xor_sync(0xffffffffu, bsum, o);
        if (q == 0) beta_s[row_b] = bsum;
      }
      bar_sync(2, kPrep);                       // la read, a_last written
      WKV6_MARK(1);
      // kd's buffer is free once the math group's ΔS of chunk n − 2 is done
      if (n >= kStages) hopper::mbar_wait(rel_v(st), (n / kStages - 1) & 1);
      WKV6_MARK(2);

      // (2) the scaled tiles, in place (a thread rewrites only its own
      // elements of r, k and la)
      if (scans) {
        const float alast = last_s[jc];
#pragma unroll
        for (int i = 0; i < RP; ++i) {
          const int row = part * RP + i;
          const float a = a_r[i];
          const float ap = a - la_s[row * PA + jc];   // a_prev = a − la
          const float rr = r_s[row * PK + jc];
          const float kk = k_s[row * PK + jc];
          r_s[row * PK + jc] = rr * expf(ap);
          la_s[row * PA + jc] = rr * expf(clip(ap));
          k_s[row * PK + jc] = kk * expf(clip(-a));
          kd_s[row * PV + jc] = kk * expf(alast - a);
        }
      }
      // these writes to the stage come before TMA's next ones there
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(prepped(st));
      WKV6_MARK(3);
    }
#ifdef WKV6_TRACE
    if (blockIdx.x == 0 && blockIdx.y == 0 && lane == 0)
      for (int i = 0; i < 6; ++i)
        wkv6_trace_cycles[(tid / 32) * 6 + i] = trace[i];
#endif
    return;
  }

  // ---- math: chunk n's products, once prep is done with it
  asm volatile("setmaxnreg.inc.sync.aligned.u32 184;\n" ::: "memory");
  const int warp = (tid - kPrep) / 32;          // math warp 0 .. 7
  const int g = lane / 4;
  const int t = lane % 4;
  const int64_t os = static_cast<int64_t>(H) * K;     // out's row stride
  float* const ob = out + (static_cast<int64_t>(bi) * s * H + h) * K;
  float* const S0 = reinterpret_cast<float*>(sm + C::kS);

  for (int n = 0; n < n_chunks; ++n) {
    const int st = n % kStages;
    const int t0 = n * CH;
    const float* const r_s = tile(st, 0);
    const float* const k_s = tile(st, C::kR);
    float* const la_s = tile(st, 2 * C::kR);    // r_f, then att
    const float* const v_s = tile(st, 2 * C::kR + C::kLa);
    const float* const kd_s = kd_of(st);
    const float* const beta_s = beta_of(st);
    const float* const last_s = last_of(st);
    const float* const S_cur = S0 + (n & 1) * K * PV;   // S before chunk n
    float* const S_nxt = S0 + ((n + 1) & 1) * K * PV;
    hopper::mbar_wait(prepped(st), (n / kStages) & 1);
    WKV6_MARK(0);
    float decay[2] = {};                        // e^{a_last}, ΔS's rows
    if (SS::has(warp)) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        decay[half] = expf(last_s[16 * SS::row_block(warp) + g + 8 * half]);
    }

    // (3a) att = r_f · k_fᵀ, written over r_f: its strictly lower part, β
    // on the diagonal, 0 above
    {
      const int rb = SA::row_block(warp);
      float acc[SA::kPer][4] = {};
      if (SA::has(warp))
        product<1, SA::kPer>(
            &acc, 0, K / 8,
            [&](int ks, int, float(&x)[4]) {
              ld_a(la_s + 16 * rb * PA + 8 * ks, PA, g, t, x);
            },
            [&](int ks, int i, float(&x)[2]) {
              ld_b_nk(k_s + 8 * SA::col_tile(warp, i) * PK + 8 * ks, PK, g, t,
                      x);
            });
      bar_sync(1, kMath);                       // r_f all read
      if (SA::has(warp)) {
#pragma unroll
        for (int i = 0; i < SA::kPer; ++i) {
          if (!SA::writes(warp, i)) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = 16 * rb + g + 8 * half;
            const int col = 8 * SA::col_tile(warp, i) + 2 * t;
            const float b = beta_s[row];
            float2 w;
            w.x = col < row ? acc[i][2 * half] : (col == row ? b : 0.f);
            w.y = col + 1 < row ? acc[i][2 * half + 1]
                                : (col + 1 == row ? b : 0.f);
            *reinterpret_cast<float2*>(la_s + row * PA + col) = w;
          }
        }
      }
      bar_sync(1, kMath);                       // att written
    }
    hopper::mbar_wait(full_v(st), (n / kStages) & 1);
    WKV6_MARK(1);
    // (3b) o = r_s · S + att · v (β on att's diagonal; the att columns
    // past the row block's diagonal are 0 and skipped), to device memory
    if (SO::has(warp)) {
      constexpr int NR = SO::kRows, NC = SO::kCols;
      int rb[NR];
#pragma unroll
      for (int j = 0; j < NR; ++j) rb[j] = SO::row_block(warp, j);
      float acc[NR][NC][4] = {};
      auto ldb = [&](const float* b_base) {
        return [=](int ks, int i, float(&x)[2]) {
          ld_b_kn(b_base + 8 * ks * PV + 8 * SO::col_tile(warp, i), PV, g, t,
                  x);
        };
      };
      product<NR, NC>(
          acc, 0, K / 8,
          [&](int ks, int j, float(&x)[4]) {
            ld_a(r_s + 16 * rb[j] * PK + 8 * ks, PK, g, t, x);
          },
          ldb(S_cur));
      // att · v: both rows up to the first one's diagonal, then the second
      float sml[NR][NC][4] = {};
      auto intra = [&](int ks, int j0, int j1) {
        uint32_t bh[NC][2], bl[NC][2];
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          float x[2];
          ld_b_kn(v_s + 8 * ks * PV + 8 * SO::col_tile(warp, i), PV, g, t, x);
          split(x, bh[i], bl[i]);
        }
#pragma unroll
        for (int j = j0; j < j1; ++j) {
          float x[4];
          uint32_t ah[4], al[4];
          ld_a(la_s + 16 * rb[j] * PA + 8 * ks, PA, g, t, x);
          split(x, ah, al);
          mma::mma_3xtf32(acc[j], sml[j], ah, al, bh, bl);
        }
      };
      int ks = 0;
      for (; ks < 2 * (rb[0] + 1); ++ks) intra(ks, 0, NR);
      for (; ks < 2 * (rb[NR - 1] + 1); ++ks) intra(ks, NR - 1, NR);
#pragma unroll
      for (int j = 0; j < NR; ++j) add_to(acc[j], sml[j]);
#pragma unroll
      for (int j = 0; j < NR; ++j) {
#pragma unroll
        for (int i = 0; i < NC; ++i) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = t0 + 16 * rb[j] + g + 8 * half;
            if (row < s)
              *reinterpret_cast<float2*>(ob + row * os +
                                         8 * SO::col_tile(warp, i) + 2 * t) =
                  make_float2(acc[j][i][2 * half], acc[j][i][2 * half + 1]);
          }
        }
      }
    }
    // the att writes to the stage come before TMA's next ones there
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(rel_p(st));
    if (warp == 0 && lane == 0 && n + kStages < n_chunks) {
      hopper::mbar_wait(rel_p(st), (n / kStages) & 1);
      issue_p(n + kStages);
    }
    WKV6_MARK(2);

    // (3c) ΔS = k_dᵀ · v, then S' = diag(e^{a_last}) S + ΔS into the other
    // state buffer (no one reads it this chunk)
    if (SS::has(warp)) {
      const int mb = SS::row_block(warp);
      float acc[SS::kPer][4] = {};
      product<1, SS::kPer>(
          &acc, 0, CH / 8,
          [&](int ks, int, float(&x)[4]) {
            ld_at(kd_s + 8 * ks * PV + 16 * mb, PV, g, t, x);
          },
          [&](int ks, int i, float(&x)[2]) {
            ld_b_kn(v_s + 8 * ks * PV + 8 * SS::col_tile(warp, i), PV, g, t,
                    x);
          });
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * mb + g + 8 * half;
        const float d = decay[half];
#pragma unroll
        for (int i = 0; i < SS::kPer; ++i) {
          const int e = row * PV + 8 * SS::col_tile(warp, i) + 2 * t;
          const float2 old = *reinterpret_cast<const float2*>(S_cur + e);
          *reinterpret_cast<float2*>(S_nxt + e) = make_float2(
              __fadd_rn(__fmul_rn(old.x, d), acc[i][2 * half]),
              __fadd_rn(__fmul_rn(old.y, d), acc[i][2 * half + 1]));
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(rel_v(st));
    if (warp == 0 && lane == 0 && n + kStages < n_chunks) {
      hopper::mbar_wait(rel_v(st), (n / kStages) & 1);
      issue_v(n + kStages);
    }
    WKV6_MARK(3);
  }
#ifdef WKV6_TRACE
  if (blockIdx.x == 0 && blockIdx.y == 0 && lane == 0)
    for (int i = 0; i < 6; ++i)
      wkv6_trace_cycles[(tid / 32) * 6 + i] = trace[i];
#endif
}

template <int CH, int K>
int launch(const void* r, const void* k, const void* v, const void* la,
           const void* u, void* out, int b, int s, int H, const int64_t* st,
           cudaStream_t stream) {
  using C = Cfg<CH, K>;
  CUtensorMap maps[4];
  const void* ptrs[4] = {r, k, la, v};
  const int64_t* strides[4] = {st, st + 3, st + 9, st + 6};
  const int cols[4] = {C::PK, C::PK, C::PA, C::PV};
  for (int i = 0; i < 4; ++i) {
    const int e = hopper::encode_heads_map(
        &maps[i], ptrs[i], b, s, H, K, strides[i][0], strides[i][1],
        strides[i][2], CH, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, cols[i],
        CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e != 0) return kMapError + e;
  }
  auto kernel = wkv6_kernel<CH, K>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(H, b), kThreads, C::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(u),
      static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

template <int CH>
int dispatch_k(const void* r, const void* k, const void* v, const void* la,
               const void* u, void* out, int b, int s, int H, int K,
               const int64_t* st, cudaStream_t stream) {
  switch (K) {
    case 16: return launch<CH, 16>(r, k, v, la, u, out, b, s, H, st, stream);
    case 32: return launch<CH, 32>(r, k, v, la, u, out, b, s, H, st, stream);
    case 64: return launch<CH, 64>(r, k, v, la, u, out, b, s, H, st, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry for ctypes. r/k/v/la/u/out are device pointers to f32; the
// strides are in elements, for the batch, sequence and head axes of r, k,
// v and la (the K axis is contiguous; bases and strides 16-byte aligned,
// as TMA takes them); u is a contiguous (H, K) tensor and out a contiguous
// (b, s, H, K) one. Chunks of `chunk` rows (16, 32 or 64) from position 0,
// K 16, 32 or 64. Launches asynchronously on `stream` and returns the
// first CUDA error, kMapError + the CUresult of a refused tensor-map
// encode, or 0.
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const void* la, const void* u, void* out, int b, int s,
                    int H, int K, int chunk, int64_t rsb, int64_t rss,
                    int64_t rsh, int64_t ksb, int64_t kss, int64_t ksh,
                    int64_t vsb, int64_t vss, int64_t vsh, int64_t lsb,
                    int64_t lss, int64_t lsh, void* stream) {
  if (b <= 0 || s <= 0 || H <= 0 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[12] = {rsb, rss, rsh, ksb, kss, ksh,
                          vsb, vss, vsh, lsb, lss, lsh};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 16: return dispatch_k<16>(r, k, v, la, u, out, b, s, H, K, st, cs);
    case 32: return dispatch_k<32>(r, k, v, la, u, out, b, s, H, K, st, cs);
    case 64: return dispatch_k<64>(r, k, v, la, u, out, b, s, H, K, st, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef WKV6_TRACE
extern "C" int wkv6_trace(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, wkv6_trace_cycles, sizeof(wkv6_trace_cycles)));
}
#endif

extern "C" const char* wkv6_error_string(int err) {
  if (err >= kMapError) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
