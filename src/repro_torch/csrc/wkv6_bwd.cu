// The backward of the RWKV-6 chunked WKV recurrence; hand-written for
// Hopper (sm_90a), f32 on the CUDA cores.
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
//      shared memory over the chunks in reverse; per chunk it loads r, k,
//      v, la and do, rebuilds att and the scaled tiles, runs the eight
//      products above as register-tiled loops over shared memory (a thread
//      owns rows ty + 16 i and columns tx + 16 j of each product, so the
//      four CH x K gradient products land in the same registers as the
//      elementwise step that combines them) and writes dr, dk, dv and dla;
//      it leaves its share of du, summed over its chunks, in a per-block
//      slot.
//   3. `wkv6_du_kernel`: du = the slots summed over the batch rows in
//      order.
// Tiles have a pitch of width + 1 (≡ 1 mod 32 at widths 32 and 64), so
// rows and columns of a tile are read without bank conflicts.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kClip = 40.f;

__device__ __forceinline__ float clip(float x) {
  return fminf(fmaxf(x, -kClip), kClip);
}

// jax.grad of jnp.clip(x, −40, 40): max and min each split a tie evenly
__device__ __forceinline__ float clip_grad(float x) {
  if (x > -kClip && x < kClip) return 1.f;
  return fabsf(x) == kClip ? 0.5f : 0.f;
}

// acc[i][j] += Σ_{l < L} a(ty + 16 i, l) · b(l, tx + 16 j)
template <int R, int C, int L, class FA, class FB>
__device__ __forceinline__ void product(float (&acc)[R][C], int ty, int tx,
                                        FA&& a, FB&& b) {
#pragma unroll 4
  for (int l = 0; l < L; ++l) {
    float av[R], bv[C];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = a(ty + 16 * i, l);
#pragma unroll
    for (int j = 0; j < C; ++j) bv[j] = b(l, tx + 16 * j);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// A (b, s, H, K) tensor's rows t0 .. t0 + CH − 1 of batch row bi, head h
// into a CH x (K + 1) tile; rows past s are zero.
struct Strided {
  const float* p;
  int64_t sb, ss, sh;
};

template <int CH, int K>
__device__ __forceinline__ void load_tile(float* dst, Strided x, int bi,
                                          int h, int t0, int s, int tid) {
  constexpr int P = K + 1;
  const float* base = x.p + bi * x.sb + h * x.sh;
  for (int e = tid; e < CH * K; e += kThreads) {
    const int t = e / K, j = e % K;
    const int row = t0 + t;
    dst[t * P + j] = row < s ? __ldg(base + row * x.ss + j) : 0.f;
  }
}

// a = cumsum(la) down each column, in row order (threads < K; `a` may be
// `la`)
template <int CH, int K>
__device__ __forceinline__ void cumsum_columns(const float* la, float* a,
                                               int tid) {
  constexpr int P = K + 1;
  if (tid < K) {
    float acc = 0.f;
    for (int t = 0; t < CH; ++t) {
      acc += la[t * P + tid];
      a[t * P + tid] = acc;
    }
  }
}

template <int CH, int K>
__global__ void __launch_bounds__(kThreads)
wkv6_states_kernel(Strided k, Strided v, Strided la,
                   float* __restrict__ states, int s, int n_chunks) {
  constexpr int P = K + 1;
  constexpr int C = K / 16;
  extern __shared__ float sm[];
  float* const kt = sm;                   // k, then k ⊙ e^{a_last − a}
  float* const vt = kt + CH * P;
  float* const at = vt + CH * P;          // la, then a
  float* const St = at + CH * P;          // K x P
  const int h = blockIdx.x, H = gridDim.x, bi = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float* const out =
      states + static_cast<int64_t>(bi * H + h) * n_chunks * K * K;
  for (int e = tid; e < K * P; e += kThreads) St[e] = 0.f;
  __syncthreads();
  for (int n = 0; n < n_chunks; ++n) {
    const int t0 = n * CH;
    load_tile<CH, K>(kt, k, bi, h, t0, s, tid);
    load_tile<CH, K>(vt, v, bi, h, t0, s, tid);
    load_tile<CH, K>(at, la, bi, h, t0, s, tid);
    for (int e = tid; e < K * K; e += kThreads)     // the state before n
      out[static_cast<int64_t>(n) * K * K + e] = St[(e / K) * P + e % K];
    __syncthreads();
    cumsum_columns<CH, K>(at, at, tid);
    __syncthreads();
    const float* const alast = at + (CH - 1) * P;
    for (int e = tid; e < CH * K; e += kThreads) {
      const int t = e / K, j = e % K;
      kt[t * P + j] *= expf(alast[j] - at[t * P + j]);
    }
    __syncthreads();
    // S' = diag(e^{a_last}) S + k_decᵀ v, each thread its own elements
    float acc[C][C] = {};
    product<C, C, CH>(
        acc, ty, tx, [&](int row, int l) { return kt[l * P + row]; },
        [&](int l, int col) { return vt[l * P + col]; });
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int row = ty + 16 * i;
      const float d = expf(alast[row]);
#pragma unroll
      for (int j = 0; j < C; ++j) {
        float* const e = St + row * P + tx + 16 * j;
        *e = __fadd_rn(__fmul_rn(*e, d), acc[i][j]);
      }
    }
    __syncthreads();
  }
}

// Shared memory of the reverse pass, in floats: nine CH x (K + 1) tiles
// (r, k, v, do, a, la, r_in, r_f, k_f; the last three are reused for
// k_dec and the step's d_ap, d_a + d_ap and dk_dec ⊙ k_dec), two CH x
// (CH + 1) (att, datt), two K x (K + 1) (S, dS), and β, dβ, e^{a_last}
// and Σ_v dS S.
template <int CH, int K>
struct Bwd {
  static constexpr int P = K + 1, PC = CH + 1;
  static constexpr int kTile = CH * P;
  static constexpr int kAtt = 9 * kTile;
  static constexpr int kS = kAtt + 2 * CH * PC;
  static constexpr int kVec = kS + 2 * K * P;
  static constexpr int kFloats = kVec + 2 * CH + 2 * K;
  static constexpr int kBytes = kFloats * 4;
};

template <int CH, int K>
__global__ void __launch_bounds__(kThreads, 1)
wkv6_bwd_kernel(Strided r, Strided k, Strided v, Strided la, Strided dout,
                const float* __restrict__ u,
                const float* __restrict__ states, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dla, float* __restrict__ du_part, int s,
                int n_chunks) {
  using B = Bwd<CH, K>;
  constexpr int P = B::P, PC = B::PC;
  constexpr int RT = CH / 16, CK = K / 16;   // a thread's rows, columns
  extern __shared__ float sm[];
  float* const R = sm;
  float* const KT = R + B::kTile;
  float* const V = KT + B::kTile;
  float* const DO = V + B::kTile;
  float* const A = DO + B::kTile;
  float* const LA = A + B::kTile;
  float* const RIN = LA + B::kTile;       // r_in, then d_ap
  float* const RF = RIN + B::kTile;       // r_f, then d_a + d_ap
  float* const KF = RF + B::kTile;        // k_f, then k_dec, dk_dec ⊙ k_dec
  float* const ATT = sm + B::kAtt;
  float* const DATT = ATT + CH * PC;
  float* const S = sm + B::kS;
  float* const DS = S + K * P;
  float* const beta = sm + B::kVec;
  float* const dbeta = beta + CH;
  float* const elast = dbeta + CH;        // e^{a_last}
  float* const dsS = elast + K;           // Σ_v dS S, a row of the state

  const int h = blockIdx.x, H = gridDim.x, bi = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const float* const uh = u + h * K;
  const float* const st =
      states + static_cast<int64_t>(bi * H + h) * n_chunks * K * K;
  // the gradients' element (t, j) of this block: contiguous (b, s, H, K)
  auto at = [&](int row, int j) {
    return (static_cast<int64_t>(bi) * s + row) * H * K + h * K + j;
  };
  for (int e = tid; e < K * P; e += kThreads) DS[e] = 0.f;
  float du_acc = 0.f;                      // thread j < K: du[j]

  for (int n = n_chunks - 1; n >= 0; --n) {
    const int t0 = n * CH;
    load_tile<CH, K>(R, r, bi, h, t0, s, tid);
    load_tile<CH, K>(KT, k, bi, h, t0, s, tid);
    load_tile<CH, K>(V, v, bi, h, t0, s, tid);
    load_tile<CH, K>(DO, dout, bi, h, t0, s, tid);
    load_tile<CH, K>(LA, la, bi, h, t0, s, tid);
    for (int e = tid; e < K * K; e += kThreads)
      S[(e / K) * P + e % K] = __ldg(st + static_cast<int64_t>(n) * K * K + e);
    __syncthreads();

    // (1) a = cumsum(la), β, dβ and Σ_v dS S
    cumsum_columns<CH, K>(LA, A, tid);
    for (int row = warp; row < CH; row += kWarps) {
      float bs = 0.f, dbs = 0.f;
      for (int j = lane; j < K; j += 32) {
        bs += R[row * P + j] * uh[j] * KT[row * P + j];
        dbs += DO[row * P + j] * V[row * P + j];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        bs += __shfl_xor_sync(0xffffffffu, bs, o);
        dbs += __shfl_xor_sync(0xffffffffu, dbs, o);
      }
      if (lane == 0) {
        beta[row] = bs;
        dbeta[row] = dbs;
      }
    }
    for (int row = warp; row < K; row += kWarps) {
      float acc = 0.f;
      for (int j = lane; j < K; j += 32)
        acc += DS[row * P + j] * S[row * P + j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) dsS[row] = acc;
    }
    __syncthreads();
    const float* const alast = A + (CH - 1) * P;

    // (2) the scaled tiles
    for (int e = tid; e < CH * K; e += kThreads) {
      const int i = (e / K) * P + e % K;
      const float a = A[i], ap = a - LA[i];
      RIN[i] = R[i] * expf(ap);
      RF[i] = R[i] * expf(clip(ap));
      KF[i] = KT[i] * expf(clip(-a));
    }
    if (tid < K) elast[tid] = expf(alast[tid]);
    __syncthreads();

    // (3) att and datt (strictly lower), do Sᵀ and v dSᵀ
    {
      float acc[RT][RT] = {};
      product<RT, RT, K>(
          acc, ty, tx, [&](int row, int l) { return RF[row * P + l]; },
          [&](int l, int col) { return KF[col * P + l]; });
      float dacc[RT][RT] = {};
      product<RT, RT, K>(
          dacc, ty, tx, [&](int row, int l) { return DO[row * P + l]; },
          [&](int l, int col) { return V[col * P + l]; });
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const int t = ty + 16 * i, c = tx + 16 * j;
          ATT[t * PC + c] = c < t ? acc[i][j] : 0.f;
          DATT[t * PC + c] = c < t ? dacc[i][j] : 0.f;
        }
    }
    float drin[RT][CK] = {};
    product<RT, CK, K>(
        drin, ty, tx, [&](int row, int l) { return DO[row * P + l]; },
        [&](int l, int col) { return S[col * P + l]; });
    float dkdec[RT][CK] = {};
    product<RT, CK, K>(
        dkdec, ty, tx, [&](int row, int l) { return V[row * P + l]; },
        [&](int l, int col) { return DS[col * P + l]; });
    __syncthreads();

    // (4) datt k_f and dattᵀ r_f
    float drf[RT][CK] = {};
    product<RT, CK, CH>(
        drf, ty, tx, [&](int row, int l) { return DATT[row * PC + l]; },
        [&](int l, int col) { return KF[l * P + col]; });
    float dkf[RT][CK] = {};
    product<RT, CK, CH>(
        dkf, ty, tx, [&](int row, int l) { return DATT[l * PC + row]; },
        [&](int l, int col) { return RF[l * P + col]; });
    __syncthreads();

    // (5) k_dec over k_f
    for (int e = tid; e < CH * K; e += kThreads) {
      const int t = e / K, j = e % K;
      KF[t * P + j] = KT[t * P + j] * expf(alast[j] - A[t * P + j]);
    }
    __syncthreads();

    // (6) dv = k_dec dS + attᵀ do + β ⊙ do; dS' = diag(e^{a_last}) dS +
    // r_inᵀ do (kept in registers until every read of dS is done)
    {
      float acc[RT][CK] = {};
      product<RT, CK, K>(
          acc, ty, tx, [&](int row, int l) { return KF[row * P + l]; },
          [&](int l, int col) { return DS[l * P + col]; });
      product<RT, CK, CH>(
          acc, ty, tx, [&](int row, int l) { return ATT[l * PC + row]; },
          [&](int l, int col) { return DO[l * P + col]; });
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int t = ty + 16 * i;
        if (t0 + t >= s) continue;
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          const int c = tx + 16 * j;
          dv[at(t0 + t, c)] = acc[i][j] + beta[t] * DO[t * P + c];
        }
      }
    }
    float dsn[CK][CK] = {};
    product<CK, CK, CH>(
        dsn, ty, tx, [&](int row, int l) { return RIN[l * P + row]; },
        [&](int l, int col) { return DO[l * P + col]; });
    __syncthreads();

    // (7) the new dS, dr and dk; d_ap, d_a + d_ap and dk_dec ⊙ k_dec for
    // the column pass (each thread rewrites only its own elements)
#pragma unroll
    for (int i = 0; i < CK; ++i) {
      const int row = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        float* const e = DS + row * P + tx + 16 * j;
        *e = *e * elast[row] + dsn[i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int t = ty + 16 * i;
      const float db = dbeta[t];
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int c = tx + 16 * j;
        const int x = t * P + c;
        const float a = A[x], ap = a - LA[x];
        const float rr = R[x], kk = KT[x], uu = uh[c];
        const float e_ap = expf(ap), e_rf = expf(clip(ap));
        const float e_kf = expf(clip(-a)), e_dec = expf(alast[c] - a);
        const float gr = drin[i][j] * e_ap + drf[i][j] * e_rf + db * kk * uu;
        const float gk =
            dkdec[i][j] * e_dec + dkf[i][j] * e_kf + db * (rr * uu);
        const float d_ap = drin[i][j] * (rr * e_ap) +
                           drf[i][j] * (rr * e_rf) * clip_grad(ap);
        const float k_dec = KF[x];
        const float d_a = -dkdec[i][j] * k_dec -
                          dkf[i][j] * (kk * e_kf) * clip_grad(-a);
        if (t0 + t < s) {
          dr[at(t0 + t, c)] = gr;
          dk[at(t0 + t, c)] = gk;
        }
        RIN[x] = d_ap;
        RF[x] = d_a + d_ap;
        KF[x] = dkdec[i][j] * k_dec;
      }
    }
    __syncthreads();

    // (8) dla: the reverse cumulative sum down each column, less d_ap,
    // the last row taking a_last's gradient; du
    if (tid < K) {
      const int j = tid;
      float dal = 0.f;
      for (int t = 0; t < CH; ++t) dal += KF[t * P + j];
      dal += dsS[j] * elast[j];
      float acc = 0.f;
      for (int t = CH - 1; t >= 0; --t) {
        acc += RF[t * P + j] + (t == CH - 1 ? dal : 0.f);
        if (t0 + t < s) dla[at(t0 + t, j)] = acc - RIN[t * P + j];
      }
      for (int t = 0; t < CH; ++t)
        du_acc += dbeta[t] * KT[t * P + j] * R[t * P + j];
    }
    __syncthreads();
  }
  if (tid < K) du_part[static_cast<int64_t>(bi * H + h) * K + tid] = du_acc;
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

template <int CH, int K>
int launch(const Strided* x, const float* u, float* states, float* part,
           float* const* g, float* du, int b, int s, int H,
           cudaStream_t stream) {
  const int n_chunks = (s + CH - 1) / CH;
  const dim3 grid(H, b);
  constexpr int kStatesBytes = (3 * CH + K) * (K + 1) * 4;
  auto states_kernel = wkv6_states_kernel<CH, K>;
  cudaError_t e = cudaFuncSetAttribute(
      states_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStatesBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  states_kernel<<<grid, kThreads, kStatesBytes, stream>>>(
      x[1], x[2], x[3], states, s, n_chunks);
  auto bwd_kernel = wkv6_bwd_kernel<CH, K>;
  e = cudaFuncSetAttribute(bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Bwd<CH, K>::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_kernel<<<grid, kThreads, Bwd<CH, K>::kBytes, stream>>>(
      x[0], x[1], x[2], x[3], x[4], u, states, g[0], g[1], g[2], g[3], part,
      s, n_chunks);
  const int hk = H * K;
  wkv6_du_kernel<<<(hk + 255) / 256, 256, 0, stream>>>(part, du, b, hk);
  return static_cast<int>(cudaGetLastError());
}

template <int CH>
int dispatch_k(const Strided* x, const float* u, float* states, float* part,
               float* const* g, float* du, int b, int s, int H, int K,
               cudaStream_t stream) {
  switch (K) {
    case 16: return launch<CH, 16>(x, u, states, part, g, du, b, s, H, stream);
    case 32: return launch<CH, 32>(x, u, states, part, g, du, b, s, H, stream);
    case 64: return launch<CH, 64>(x, u, states, part, g, du, b, s, H, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry for ctypes. r/k/v/la/do are device pointers to f32
// (b, s, H, K) tensors with a unit stride on K, their batch, sequence and
// head strides in elements in that order (r, k, v, la, do); u a contiguous
// (H, K) f32 tensor. `states` is f32 scratch of b·H·ceil(s / chunk)·K·K
// elements and `du_part` of b·H·K; dr, dk, dv and dla are contiguous
// (b, s, H, K) f32 outputs and du a contiguous (H, K) one. Chunks of
// `chunk` rows (16, 32 or 64) from position 0, K 16, 32 or 64. Launches
// the three kernels asynchronously on `stream` and returns the first CUDA
// error or 0.
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
  const Strided x[5] = {
      {static_cast<const float*>(r), rsb, rss, rsh},
      {static_cast<const float*>(k), ksb, kss, ksh},
      {static_cast<const float*>(v), vsb, vss, vsh},
      {static_cast<const float*>(la), lsb, lss, lsh},
      {static_cast<const float*>(dout), dsb, dss, dsh}};
  float* const g[4] = {static_cast<float*>(dr), static_cast<float*>(dk),
                       static_cast<float*>(dv), static_cast<float*>(dla)};
  const float* const uf = static_cast<const float*>(u);
  float* const sf = static_cast<float*>(states);
  float* const pf = static_cast<float*>(du_part);
  float* const duf = static_cast<float*>(du);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 16: return dispatch_k<16>(x, uf, sf, pf, g, duf, b, s, H, K, cs);
    case 32: return dispatch_k<32>(x, uf, sf, pf, g, duf, b, s, H, K, cs);
    case 64: return dispatch_k<64>(x, uf, sf, pf, g, duf, b, s, H, K, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* wkv6_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
