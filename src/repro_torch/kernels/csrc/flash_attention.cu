// Flash attention and mass-weighted centroid attention, for Hopper (sm_90a).
//
// Replaces two TPU kernels of repro/kernels/flash_attention.py:
//
// - flash_attention replaces flash_attention (the Pallas `_kernel` under
//   `flash_attention`): the causal or non-causal GQA forward
//   softmax(q k^T / sqrt(dh)) v, float32 inside, output in q's dtype; key
//   tiles past the causal frontier are skipped; a row's result is
//   acc / max(l, 1e-30). The LM's prefill runs it (B = 1, Hq = 16, Hkv = 8,
//   S = 2,048, dh = 64, bf16, causal for Qwen3-0.6B). Two routines,
//   dispatched on the element type:
//   * bf16 q, k, v (the prefill): flash_attention_bf16_kernel, on the
//     tensor cores (below);
//   * float32 (the sweeps only): flash_attention_kernel, float32 FMA on
//     the CUDA cores through online_softmax_tile.
// - flash_centroid_kernel replaces flash_centroid_attention: the
//   clustered-KV decode step softmax_K(q c^T / sqrt(dh) + log_mass) v_cent
//   over K centroids, GQA by head index, log_mass = -1e30 marking dead
//   centroids (once per attention layer per decode step: B = 1, S = 1,
//   Hq = 16, Hkv = 8, K = 65, dh = 64). The TPU kernel folds log_mass into
//   an augmented dh+1 feature lane so that it can reuse the flash kernel's
//   body; here the bias is added directly after the q c^T / sqrt(dh) product.
//   It and the float32 flash routine share online_softmax_tile.
// - flash_centroid_decode_kernel is the same function for the decode step
//   alone (S = 1), as the clustered decode runs it once per attention
//   layer per step: it reads the layer's stacked float32 state in place
//   (centroids, value centroids, mass and validity, (Hkv, K, dh) and
//   (Hkv, K)) and the step's fresh K/V row through two more pointers, with
//   log-mass 0, so the caller builds no log-mass and concatenates nothing.
//   The log-mass is head_state's rule: log(max(mass, 1e-9)) where the
//   center is valid and its mass > 0, else -1e30 (logf, not __logf). One
//   block of 256 threads per kv head serves the G = Hq / Hkv query heads of
//   its group, so each state row is read once: the rows are staged in
//   shared memory RC = 128 at a time (k_max + 1 = 65 rows in one pass on
//   the main path), one thread per (query head, row) takes a dot product,
//   one warp per query head the softmax (its max starts at -FLT_MAX, so
//   rows that are all dead give the mean of the values, as the plain
//   softmax does), one thread per (query head, feature) the weighted sum.
//   Bound: the state's bytes once (~34 KB at K = 65, dh = 64): a few
//   microseconds of latency, not bandwidth.
//
// Bound on this card. The prefill's causal half at S = 2,048 is 8.6 GFLOP
// against 12.6 MB moved: above the bf16 tensor cores' ridge, so it is bound
// by operations. The decode step is 16 x 65 x 64 x 4 flops against ~50 KB:
// bound by latency (one launch, a few microseconds), far below either roof.
//
// The bf16 routine, flash_attention_bf16_kernel (FlashAttention-2's
// shape on mma.sync). One block of 4 warps per (64 query rows, query
// head, batch), 16 rows a warp; heads vary fastest in the grid and the
// q-tiles come heaviest first under the causal mask, which shortens the
// tail. The Q tile is loaded once into registers as mma A-fragments
// (ldmatrix; reloaded per key tile at dh = 128, where the fragments would
// not fit beside the rest without spilling). K and V tiles of 64 keys are
// staged as bf16 in shared memory by cp.async, double-buffered: tile t+1
// is in flight while tile t computes. S = Q K^T runs on
// mma.sync.m16n8k16 bf16 x bf16 -> f32; the products of bf16 values are
// exact in float32, so the scores stay float32 inside. The softmax runs in
// base 2 (scores scaled by log2(e) / sqrt(dh), one ex2 per weight: the
// library expf takes some fifteen instructions, which made the tile loop
// instruction-bound); row max and sum live in registers, reduced over the
// 4 threads of a quad by shuffles. P V also runs on mma.sync, V fragments
// by ldmatrix.trans, the score accumulators reused as A-fragments.
//
// Precision, the trap of this kernel: the plain version keeps P in
// float32, and rounding P to bf16 moves an output by up to 2^-9 of each
// weight, past the one-ulp tolerance. So P enters as a sum of three bf16
// parts, bf16(P), bf16 of the rest, bf16 of what is left, three mmas per
// step: at most 2^-27 of each weight. (Two parts, 2^-18, still missed the
// tolerance on a few near-zero outputs of short causal rows, on the card
// and in the plain emulation of tests/test_torch_flash_attention.py.) Each
// key tile's P V goes into fresh accumulators, folded into the running
// one by one float32 FMA (acc * corr + tile), which is also the online
// rescale. Mask semantics are online_softmax_tile's (below). dh is padded
// to 32, 64 or 128 in shared memory; ragged S is masked here. Tiles are
// copied 16 bytes a thread when every row is 16-byte aligned (dh a
// multiple of 8, strides too), else element by element, synchronously.
//
// The float32 routine and the centroid kernel, simple first: one block of
// 256 threads per (query tile of 64 rows, query head, batch); the kv head
// is h / (Hq / Hkv). The block stages its queries once, transposed, in
// shared memory, then walks the key tiles of 64 rows (up to the causal
// frontier): keys (transposed) and values are staged in shared memory as
// float32, each thread computes a 4 x 4 tile of scores by FMA (float32 on
// the CUDA cores), the 16 threads that share a query row reduce its max
// and sum by warp shuffles, and the probabilities go through shared
// memory into each thread's 4 rows x dh/16 columns of the float32
// accumulator. dh is any width up to 128, padded with zeros to 32, 64 or
// 128 in shared memory (a template). Ragged S and K are masked here, not
// padded by the caller. Mask arithmetic never makes an infinity: see
// online_softmax_tile.
#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // keys per tile
constexpr int THREADS = 256;
constexpr int TM = 4;               // query rows per thread
constexpr int TN = 4;               // keys per thread in the score tile
constexpr int LANES = BK / TN;      // 16 threads share a query row
constexpr int PAD = 4;              // keeps float4 reads aligned
constexpr float NEG = -1e30f;       // the reference's mask constant
static_assert(BQ == BK && (BQ / TM) * LANES == THREADS, "tile shape");

// Shared memory of one block, in floats.
template <int DHP>
struct Layout {
  static constexpr int LQ = BQ + PAD;        // row length of Qt, Kt and Ps
  static constexpr int LV = DHP + PAD;       // row length of Vs
  static constexpr int QT = 0;               // Qt[DHP][LQ]: queries, transposed
  static constexpr int KT = QT + DHP * LQ;   // Kt[DHP][LQ]: keys, transposed
  static constexpr int VS = KT + DHP * LQ;   // Vs[BK][LV]: values
  static constexpr int PS = VS + BK * LV;    // Ps[BK][LQ]: probabilities, transposed
  static constexpr int BIAS = PS + BK * LQ;  // bias[BK]
  static constexpr int FLOATS = BIAS + BK;
  static constexpr int DPT = DHP / LANES;    // accumulator columns per thread
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Rows [row0, row0 + 64) of a (rows, dh) matrix with row stride rs, as
// float32 into the transposed tile dst[d * LQ + r]; zeros past `rows` and
// past dh. Called by every thread of the block.
template <typename T, int DHP>
__device__ __forceinline__ void stage_transposed(float* dst, const T* src,
                                                 long long rs, int row0,
                                                 int rows, int dh) {
  for (int i = threadIdx.x; i < BQ * DHP; i += THREADS) {
    const int r = i / DHP, d = i % DHP;
    float x = 0.f;
    if (row0 + r < rows && d < dh) x = ld(src + (long long)(row0 + r) * rs + d);
    dst[d * Layout<DHP>::LQ + r] = x;
  }
}

template <int DHP>
__device__ __forceinline__ void init_state(float (&m)[TM], float (&l)[TM],
                                           float (&acc)[TM][Layout<DHP>::DPT]) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < Layout<DHP>::DPT; ++e) acc[i][e] = 0.f;
  }
}

// One key tile of the online softmax, shared by both kernels. Stages keys
// [k0, k0 + BK) and their values, scores them against the block's queries
// (already in Qt) as dot * scale + bias (bias null: 0), masks, and folds
// the tile into each query row's running max m, sum l and accumulator acc.
//
// Masks: a key at or past nk (the ragged edge) weighs exactly 0. A key
// inside [0, nk) that is masked (causal: a key past its query) has its
// score REPLACED by -1e30, and a dead centroid scores dot * scale - 1e30,
// which rounds to -1e30 in float32. No infinity is ever formed: while a
// row has a live key, m is a real score and exp(-1e30 - m) is exactly 0;
// while it has none, m = -1e30 and every in-range key weighs exp(0) = 1,
// so a row whose keys are all dead averages the values uniformly, as the
// plain softmax does. A live key arriving later rescales by
// exp(-1e30 - m_new) = 0, dropping that average.
template <typename T, int DHP>
__device__ __forceinline__ void online_softmax_tile(
    float* smem, const T* kp, long long ks, const T* vp, long long vs,
    const float* bias, int k0, int nk, int dh, bool causal, int q0,
    float scale, float (&m)[TM], float (&l)[TM],
    float (&acc)[TM][Layout<DHP>::DPT]) {
  using Lay = Layout<DHP>;
  constexpr int DPT = Lay::DPT;
  const float* Qt = smem + Lay::QT;
  float* Kt = smem + Lay::KT;
  float* Vs = smem + Lay::VS;
  float* Ps = smem + Lay::PS;
  float* bs = smem + Lay::BIAS;
  const int tid = threadIdx.x, tx = tid % LANES, ty = tid / LANES;

  __syncthreads();  // the queries are staged; the previous tile is done
  stage_transposed<T, DHP>(Kt, kp, ks, k0, nk, dh);
  for (int i = tid; i < BK * DHP; i += THREADS) {
    const int j = i / DHP, d = i % DHP;
    float x = 0.f;
    if (k0 + j < nk && d < dh) x = ld(vp + (long long)(k0 + j) * vs + d);
    Vs[j * Lay::LV + d] = x;
  }
  if (tid < BK)
    bs[tid] = (bias != nullptr && k0 + tid < nk) ? bias[k0 + tid] : 0.f;
  __syncthreads();

  float s[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DHP; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(Qt + d * Lay::LQ + ty * TM);
    const float4 b = *reinterpret_cast<const float4*>(Kt + d * Lay::LQ + tx * TN);
    const float av[TM] = {a.x, a.y, a.z, a.w};
    const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qi = q0 + ty * TM + i;
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int kj = k0 + tx * TN + j;
      float x = s[i][j] * scale + bs[tx * TN + j];
      if (kj >= nk || (causal && kj > qi)) x = NEG;
      s[i][j] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float mn = fmaxf(m[i], mx);
    const float corr = expf(m[i] - mn);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float p = (k0 + tx * TN + j < nk) ? expf(s[i][j] - mn) : 0.f;
      s[i][j] = p;
      rs += p;
    }
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1)
      rs += __shfl_xor_sync(0xffffffffu, rs, off);
    l[i] = l[i] * corr + rs;
    m[i] = mn;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] *= corr;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j)
    *reinterpret_cast<float4*>(Ps + (tx * TN + j) * Lay::LQ + ty * TM) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
  __syncthreads();

#pragma unroll 4
  for (int j = 0; j < BK; ++j) {
    const float4 p = *reinterpret_cast<const float4*>(Ps + j * Lay::LQ + ty * TM);
    const float pv[TM] = {p.x, p.y, p.z, p.w};
    const float* vr = Vs + j * Lay::LV + tx * DPT;
    float vv[DPT];
    if constexpr (DPT % 4 == 0) {
#pragma unroll
      for (int e = 0; e < DPT; e += 4) {
        const float4 w = *reinterpret_cast<const float4*>(vr + e);
        vv[e] = w.x; vv[e + 1] = w.y; vv[e + 2] = w.z; vv[e + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < DPT; ++e) vv[e] = vr[e];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
  }
}

// acc / max(l, 1e-30) of the block's rows into the (S, dh) output rows.
template <typename T, int DHP>
__device__ __forceinline__ void write_rows(T* o, int q0, int S, int dh,
                                           const float (&l)[TM],
                                           const float (&acc)[TM][Layout<DHP>::DPT]) {
  constexpr int DPT = Layout<DHP>::DPT;
  const int tx = threadIdx.x % LANES, ty = threadIdx.x / LANES;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty * TM + i;
    if (r >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = tx * DPT + e;
      if (d < dh) st(o + (long long)r * dh + d, acc[i][e] / den);
    }
  }
}

// Strides in elements: [q b, h, s,  k b, h, s,  v b, h, s]; the feature
// axis is contiguous. Output (B, Hq, S, dh) contiguous.
struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs;
};

template <typename T, int DHP>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int Hq, int group, int S, int dh, Strides st,
                           int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  using Lay = Layout<DHP>;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  stage_transposed<T, DHP>(smem + Lay::QT, q + b * st.qb + h * st.qh, st.qs,
                           q0, S, dh);
  float m[TM], l[TM], acc[TM][Lay::DPT];
  init_state<DHP>(m, l, acc);
  int tiles = (S + BK - 1) / BK;
  if (causal) tiles = min(tiles, (min(q0 + BQ, S) - 1) / BK + 1);
  const T* kp = k + b * st.kb + hk * st.kh;
  const T* vp = v + b * st.vb + hk * st.vh;
  for (int t = 0; t < tiles; ++t)
    online_softmax_tile<T, DHP>(smem, kp, st.ks, vp, st.vs, nullptr, t * BK,
                                S, dh, causal != 0, q0, scale, m, l, acc);
  write_rows<T, DHP>(out + ((long long)b * Hq + h) * S * dh, q0, S, dh, l, acc);
}

template <typename T, int DHP>
__global__ void __launch_bounds__(THREADS)
    flash_centroid_kernel(const T* __restrict__ q, const T* __restrict__ c,
                          const T* __restrict__ vc,
                          const float* __restrict__ log_mass,
                          T* __restrict__ out, int Hq, int group, int S, int K,
                          int dh, Strides st, long long lb, long long lh,
                          float scale) {
  extern __shared__ __align__(16) float smem[];
  using Lay = Layout<DHP>;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  stage_transposed<T, DHP>(smem + Lay::QT, q + b * st.qb + h * st.qh, st.qs,
                           q0, S, dh);
  float m[TM], l[TM], acc[TM][Lay::DPT];
  init_state<DHP>(m, l, acc);
  const T* cp = c + b * st.kb + hk * st.kh;
  const T* vp = vc + b * st.vb + hk * st.vh;
  const float* bias = log_mass + b * lb + hk * lh;
  for (int k0 = 0; k0 < K; k0 += BK)
    online_softmax_tile<T, DHP>(smem, cp, st.ks, vp, st.vs, bias, k0, K, dh,
                                false, q0, scale, m, l, acc);
  write_rows<T, DHP>(out + ((long long)b * Hq + h) * S * dh, q0, S, dh, l, acc);
}

template <int DHP>
constexpr int smem_bytes() {
  return Layout<DHP>::FLOATS * (int)sizeof(float);
}

template <typename T, int DHP>
cudaError_t launch_attention(const void* q, const void* k, const void* v,
                             void* out, const long long* dims, Strides st,
                             int causal, float scale, cudaStream_t stream) {
  const int B = (int)dims[0], Hq = (int)dims[1], Hkv = (int)dims[2];
  const int S = (int)dims[3], dh = (int)dims[4];
  auto kern = flash_attention_kernel<T, DHP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<DHP>());
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)Hq, (unsigned)B);
  kern<<<grid, THREADS, smem_bytes<DHP>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hq / Hkv, S, dh, st,
      causal, scale);
  return cudaGetLastError();
}

template <typename T, int DHP>
cudaError_t launch_centroid(const void* q, const void* c, const void* vc,
                            const float* log_mass, void* out,
                            const long long* dims, Strides st, long long lb,
                            long long lh, float scale, cudaStream_t stream) {
  const int B = (int)dims[0], Hq = (int)dims[1], Hkv = (int)dims[2];
  const int S = (int)dims[3], K = (int)dims[4], dh = (int)dims[5];
  auto kern = flash_centroid_kernel<T, DHP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<DHP>());
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)Hq, (unsigned)B);
  kern<<<grid, THREADS, smem_bytes<DHP>(), stream>>>(
      (const T*)q, (const T*)c, (const T*)vc, log_mass, (T*)out, Hq, Hq / Hkv,
      S, K, dh, st, lb, lh, scale);
  return cudaGetLastError();
}

Strides strides_of(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8]};
}

// ---------------------------------------------------------------------------
// The decode routine of the centroid attention (see the file's header).
// ---------------------------------------------------------------------------

namespace dec {

constexpr int THREADS = 256;
constexpr int RC = 128;               // state rows staged per pass

struct Args {
  const void* q;                      // (B, 1, Hq, dh), T
  long long qb, qh;                   // its batch and head strides
  const float* c;                     // (Hkv, K, dh) key centroids
  const float* vc;                    // (Hkv, K, dh) value centroids
  const float* mass;                  // (Hkv, K)
  const unsigned char* valid;         // (Hkv, K) bool
  const void* xk;                     // (B, 1, Hkv, dh) fresh key, T, or null
  const void* xv;                     // its value
  long long xb, xh;                   // their batch and head strides
  void* out;                          // (B, 1, Hq, dh) contiguous, T
  int Hq, Hkv, K, dh;
  float scale;
};

// Shared memory in floats: one staged pass of RC rows, the group's
// queries, their scores (then weights) over every row, their outputs, and
// their softmax sums.
__host__ __device__ inline int smem_floats(int G, int rows, int dh) {
  return RC * (dh + 1) + G * dh + G * rows + G * dh + G;
}

// One block per (kv head, batch row): the G = Hq / Hkv query heads of the
// group against the head's K centroid rows and the fresh row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_centroid_decode_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int hk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int G = a.Hq / a.Hkv, dh = a.dh, lds = dh + 1, K = a.K;
  const bool extra = a.xk != nullptr;
  const int rows = K + (extra ? 1 : 0);
  float* buf = smem;                  // [RC][dh + 1]: odd rows, no conflicts
  float* qs = buf + RC * lds;         // [G][dh]
  float* sc = qs + G * dh;            // [G][rows]
  float* os = sc + G * rows;          // [G][dh]
  float* ls = os + G * dh;            // [G]
  const T* qp = static_cast<const T*>(a.q) + b * a.qb + (long long)hk * G * a.qh;
  for (int i = tid; i < G * dh; i += THREADS) {
    qs[i] = ld(qp + (i / dh) * a.qh + i % dh);
    os[i] = 0.f;
  }
  const long long head = (long long)hk * K;
  const float* cp = a.c + head * dh;
  const float* vp = a.vc + head * dh;
  const long long xo = b * a.xb + (long long)hk * a.xh;
  const T* xk = extra ? static_cast<const T*>(a.xk) + xo : nullptr;
  const T* xv = extra ? static_cast<const T*>(a.xv) + xo : nullptr;
  // rows [r0, r0 + nr) of the state (row K: the fresh row) into buf
  const auto stage = [&](const float* state, const T* fresh, int r0, int nr) {
    for (int i = tid; i < nr * dh; i += THREADS) {
      const int r = i / dh, e = i % dh, j = r0 + r;
      buf[r * lds + e] = j < K ? state[(long long)j * dh + e] : ld(fresh + e);
    }
  };

  // scores: q . c * scale + log-mass, head_state's rule computed here
  for (int r0 = 0; r0 < rows; r0 += RC) {
    const int nr = min(RC, rows - r0);
    __syncthreads();                  // the queries are in; buf is free
    stage(cp, xk, r0, nr);
    __syncthreads();
    for (int i = tid; i < G * nr; i += THREADS) {
      const int g = i / nr, r = i % nr, j = r0 + r;
      const float* cr = buf + r * lds;
      const float* qg = qs + g * dh;
      float dot = 0.f;
      for (int e = 0; e < dh; ++e) dot = fmaf(qg[e], cr[e], dot);
      float bias = 0.f;               // the fresh row: log-mass 0
      if (j < K) {
        const float w = a.mass[head + j];
        bias = (a.valid[head + j] != 0 && w > 0.f) ? logf(fmaxf(w, 1e-9f))
                                                   : NEG;
      }
      sc[g * rows + j] = dot * a.scale + bias;
    }
  }
  __syncthreads();

  // softmax over every row, one warp per query head of the group
  const int warp = tid / 32, lane = tid % 32;
  for (int g = warp; g < G; g += THREADS / 32) {
    float* s = sc + g * rows;
    float m = -FLT_MAX;
    for (int j = lane; j < rows; j += 32) m = fmaxf(m, s[j]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int j = lane; j < rows; j += 32) {
      const float p = expf(s[j] - m);
      s[j] = p;
      l += p;
    }
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) ls[g] = l;
  }

  // weights times value rows, one thread per (query head, feature)
  for (int r0 = 0; r0 < rows; r0 += RC) {
    const int nr = min(RC, rows - r0);
    __syncthreads();                  // the weights are in; buf is free
    stage(vp, xv, r0, nr);
    __syncthreads();
    for (int i = tid; i < G * dh; i += THREADS) {
      const float* p = sc + (i / dh) * rows + r0;
      const int e = i % dh;
      float acc = os[i];
      for (int r = 0; r < nr; ++r) acc = fmaf(p[r], buf[r * lds + e], acc);
      os[i] = acc;
    }
  }
  __syncthreads();
  T* op = static_cast<T*>(a.out) + ((long long)b * a.Hq + (long long)hk * G) * dh;
  for (int i = tid; i < G * dh; i += THREADS)
    st(op + i, os[i] / fmaxf(ls[i / dh], 1e-30f));
}

template <typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  const int rows = a.K + (a.xk != nullptr ? 1 : 0);
  const int bytes = smem_floats(G, rows, a.dh) * (int)sizeof(float);
  auto kern = flash_centroid_decode_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3((unsigned)a.Hkv, (unsigned)B), THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace dec

// ---------------------------------------------------------------------------
// The bf16 routine on the tensor cores (see the file's header).
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 64;                // query rows per block, 16 a warp
constexpr int BK = 64;                // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int P_PARTS = 3;            // bf16 parts that P enters P V as
static_assert(BQ == WARPS * 16, "one m16 row block per warp");

// Shared memory in bf16 elements: Q[BQ][LD], then K and V, each two
// buffers of [BK][LD]. Rows are DHP + 8 long: the 16 bytes of padding put
// the 8 rows an ldmatrix reads in distinct banks, and keep rows 16-byte
// aligned for cp.async.
template <int DHP>
struct Smem {
  static constexpr int LD = DHP + 8;
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * LD;
  static constexpr int V = K + 2 * BK * LD;
  static constexpr int ELEMS = V + 2 * BK * LD;
  static constexpr int BYTES = ELEMS * 2;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronous; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (relative error about 2^-22); 2^-1e30 is 0, 2^0 is 1.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// The weights of k-step ks (keys 16 ks .. 16 ks + 15: score n-tiles 2 ks
// and 2 ks + 1) as mma A-fragments of P_PARTS bf16 parts: bf16(P), then
// bf16 of what is left, and so on.
__device__ __forceinline__ void split_p(const float (&s)[BK / 8][4], int ks,
                                        unsigned (&pa)[P_PARTS][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float x0 = s[2 * ks + r / 2][2 * (r % 2)];
    float x1 = s[2 * ks + r / 2][2 * (r % 2) + 1];
#pragma unroll
    for (int part = 0; part < P_PARTS; ++part) {
      const __nv_bfloat162 hv = __floats2bfloat162_rn(x0, x1);
      pa[part][r] = pack(hv);
      x0 -= __low2float(hv);
      x1 -= __high2float(hv);
    }
  }
}

// Rows [row0, row0 + BK) of a (rows, dh) bf16 matrix with row stride rs
// into dst[r * LD + c], c < DHP; zeros past `rows` and past dh. vec: 16
// bytes a thread by cp.async (every row 16-byte aligned, dh % 8 == 0);
// else element by element through registers. Called by every thread.
template <int DHP>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, long long rs,
                                      int row0, int rows, int dh, bool vec) {
  constexpr int LD = Smem<DHP>::LD;
  if (vec) {
    constexpr int CH = DHP / 8;
    static_assert(BK * CH % THREADS == 0, "whole copies per thread");
#pragma unroll
    for (int it = 0; it < BK * CH / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = row0 + r < rows && c < dh;
      cp_async16(dst + r * LD + c,
                 ok ? src + (long long)(row0 + r) * rs + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < BK * DHP; i += THREADS) {
      const int r = i / DHP, c = i % DHP;
      __nv_bfloat16 x = __float2bfloat16_rn(0.f);
      if (row0 + r < rows && c < dh) x = src[(long long)(row0 + r) * rs + c];
      dst[r * LD + c] = x;
    }
  }
}

template <int DHP>
__global__ void __launch_bounds__(THREADS)
    flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                __nv_bfloat16* __restrict__ out, int Hq,
                                int group, int S, int dh, Strides st,
                                int causal, float scale, int vec) {
  using L = Smem<DHP>;
  constexpr int LD = L::LD;
  constexpr int KS = DHP / 16;                // k-steps of Q K^T
  constexpr int DC = DHP < 64 ? DHP : 64;     // P V columns per pass
  constexpr int NC = DC / 8;                  // n-tiles per pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  // blocks start in index order, heads fastest: under the causal mask the
  // q-tiles with the most key tiles go first
  const int nqt = (S + BQ - 1) / BQ;
  const int qt = causal ? nqt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * BQ, h = blockIdx.x, b = blockIdx.z, hk = h / group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const __nv_bfloat16* qp = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kp = k + b * st.kb + hk * st.kh;
  const __nv_bfloat16* vp = v + b * st.vb + hk * st.vh;
  int tiles = (S + BK - 1) / BK;
  if (causal) tiles = min(tiles, (min(q0 + BQ, S) - 1) / BK + 1);

  stage<DHP>(sm + L::Q, qp, st.qs, q0, S, dh, vec != 0);
  stage<DHP>(sm + L::K, kp, st.ks, 0, S, dh, vec != 0);
  stage<DHP>(sm + L::V, vp, st.vs, 0, S, dh, vec != 0);
  cp_async_commit();

  // Q's A-fragments stay in registers; at DHP = 128 they would take 32
  // more than the tile fits without spilling, so they are read again from
  // the resident Q tile for every key tile
  constexpr bool QREG = DHP <= 64;
  unsigned qf[KS][4];
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[DHP / 8][4];
#pragma unroll
  for (int n = 0; n < DHP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float scale2 = scale * 1.4426950408889634f;   // log2(e) / sqrt(dh)
  const int wrow = q0 + warp * 16;        // this warp's first query row
  const int row_lo = wrow + g, row_hi = wrow + g + 8;   // e < 2, e >= 2

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      stage<DHP>(sm + L::K + (buf ^ 1) * BK * LD, kp, st.ks, (t + 1) * BK, S,
                 dh, vec != 0);
      stage<DHP>(sm + L::V + (buf ^ 1) * BK * LD, vp, st.vs, (t + 1) * BK, S,
                 dh, vec != 0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and, at t = 0, the queries) is in place
    if (t == 0 || !QREG) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], sm + L::Q + (warp * 16 + (lane % 8) +
                                     ((lane / 8) % 2) * 8) * LD +
                            kk * 16 + (lane / 16) * 8);
    }
    const __nv_bfloat16* Ks = sm + L::K + buf * BK * LD;
    const __nv_bfloat16* Vs = sm + L::V + buf * BK * LD;
    const int k0 = t * BK;

    // S = Q K^T: n-tile j holds keys k0 + 8j .. 8j + 7; a thread holds
    // rows g (e = 0, 1) and g + 8 (e = 2, 3), keys 8j + 2tq + (e & 1)
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < BK / 16; ++jp) {
        unsigned kb[4];
        ldsm_x4(kb, Ks + ((2 * jp + lane / 16) * 8 + lane % 8) * LD +
                        kk * 16 + ((lane / 8) % 2) * 8);
        mma(s[2 * jp], qf[kk], kb[0], kb[1]);
        mma(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scale and mask (online_softmax_tile's rules, in base 2: scores are
    // scaled by log2(e) / sqrt(dh), so exp becomes one ex2), running max
    // and sum
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > wrow);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale2;
        if (edge) {
          const int key = k0 + 8 * j + 2 * tq + (e & 1);
          if (key >= S || (causal && key > (e < 2 ? row_lo : row_hi)))
            x = NEG;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      corr[i] = exp2_approx(m[i] - mn);
      m[i] = mn;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = !edge || k0 + 8 * j + 2 * tq + (e & 1) < S;
        const float p = in ? exp2_approx(s[j][e] - m[e >> 1]) : 0.f;
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * corr[i] + rs[i];
    }

    // O += P V, DC columns a pass into fresh accumulators, folded into
    // acc as acc * corr + tile
#pragma unroll
    for (int dc = 0; dc < DHP / DC; ++dc) {
      float o[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        unsigned pa[P_PARTS][4];
        split_p(s, ks, pa);
#pragma unroll
        for (int np = 0; np < NC / 2; ++np) {
          unsigned vb[4];
          ldsm_x4_trans(vb, Vs + (ks * 16 + ((lane / 8) % 2) * 8 + lane % 8) *
                                     LD +
                                 dc * DC + (2 * np + lane / 16) * 8);
#pragma unroll
          for (int part = 0; part < P_PARTS; ++part) {
            mma(o[2 * np], pa[part], vb[0], vb[1]);
            mma(o[2 * np + 1], pa[part], vb[2], vb[3]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[dc * NC + n][e] = fmaf(acc[dc * NC + n][e], corr[e >> 1],
                                     o[n][e]);
    }
    __syncthreads();  // every warp is done with buffer `buf`
  }

  // acc / max(l, 1e-30) as bf16 into the (S, dh) output rows
  __nv_bfloat16* op = out + ((long long)b * Hq + h) * S * dh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i == 0 ? row_lo : row_hi;
    if (r >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = op + (long long)r * dh;
#pragma unroll
    for (int n = 0; n < DHP / 8; ++n) {
      const int d = 8 * n + 2 * tq;
      const float a0 = acc[n][2 * i] / den, a1 = acc[n][2 * i + 1] / den;
      if (d + 1 < dh && dh % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(a0, a1);
      } else {
        if (d < dh) orow[d] = __float2bfloat16_rn(a0);
        if (d + 1 < dh) orow[d + 1] = __float2bfloat16_rn(a1);
      }
    }
  }
}

template <int DHP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const long long* dims, Strides st, int causal, float scale,
                   cudaStream_t stream) {
  const int B = (int)dims[0], Hq = (int)dims[1], Hkv = (int)dims[2];
  const int S = (int)dims[3], dh = (int)dims[4];
  // 16-byte copies need every row start 16-byte aligned
  const auto al = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const bool vec = dh % 8 == 0 && al(q) && al(k) && al(v) && st.qb % 8 == 0 &&
                   st.qh % 8 == 0 && st.qs % 8 == 0 && st.kb % 8 == 0 &&
                   st.kh % 8 == 0 && st.ks % 8 == 0 && st.vb % 8 == 0 &&
                   st.vh % 8 == 0 && st.vs % 8 == 0;
  auto kern = flash_attention_bf16_kernel<DHP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<DHP>::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)Hq, (unsigned)((S + BQ - 1) / BQ), (unsigned)B);
  kern<<<grid, THREADS, Smem<DHP>::BYTES, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, Hq, Hq / Hkv, S, dh, st,
      causal, scale, vec ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace tc


}  // namespace

// dtype: 0 float32 (the CUDA-core routine), 1 bfloat16 (the tensor-core
// routine); q, k, v and out share it. dims: B, Hq,
// Hkv, S, dh (Hkv | Hq, dh <= 128). strides: q, k, v (b, h, s) in
// elements. Returns a CUDA error code, 0 on success.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int dtype,
                                     const long long* dims,
                                     const long long* strides, int causal,
                                     float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides st = strides_of(strides);
  const cudaStream_t s = (cudaStream_t)stream;
  const long long dh = dims[4];
  if (dh < 1 || dh > 128) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (dh <= 32) err = launch_attention<float, 32>(q, k, v, out, dims, st, causal, scale, s);
    else if (dh <= 64) err = launch_attention<float, 64>(q, k, v, out, dims, st, causal, scale, s);
    else err = launch_attention<float, 128>(q, k, v, out, dims, st, causal, scale, s);
  } else if (dtype == 1) {
    if (dh <= 32) err = tc::launch<32>(q, k, v, out, dims, st, causal, scale, s);
    else if (dh <= 64) err = tc::launch<64>(q, k, v, out, dims, st, causal, scale, s);
    else err = tc::launch<128>(q, k, v, out, dims, st, causal, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// dims: B, Hq, Hkv, S, K, dh. strides: q, centers, v_cent (b, h, s) then
// log_mass (b, h) in elements; log_mass is float32 whatever dtype is.
extern "C" int repro_flash_centroid_attention(
    const void* q, const void* c, const void* vc, const float* log_mass,
    void* out, int dtype, const long long* dims, const long long* strides,
    float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides st = strides_of(strides);
  const long long lb = strides[9], lh = strides[10];
  const cudaStream_t s = (cudaStream_t)stream;
  const long long dh = dims[5];
  if (dh < 1 || dh > 128) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (dh <= 32) err = launch_centroid<float, 32>(q, c, vc, log_mass, out, dims, st, lb, lh, scale, s);
    else if (dh <= 64) err = launch_centroid<float, 64>(q, c, vc, log_mass, out, dims, st, lb, lh, scale, s);
    else err = launch_centroid<float, 128>(q, c, vc, log_mass, out, dims, st, lb, lh, scale, s);
  } else if (dtype == 1) {
    if (dh <= 32) err = launch_centroid<__nv_bfloat16, 32>(q, c, vc, log_mass, out, dims, st, lb, lh, scale, s);
    else if (dh <= 64) err = launch_centroid<__nv_bfloat16, 64>(q, c, vc, log_mass, out, dims, st, lb, lh, scale, s);
    else err = launch_centroid<__nv_bfloat16, 128>(q, c, vc, log_mass, out, dims, st, lb, lh, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// The decode routine. dims: B, Hq, Hkv, K, dh (Hkv | Hq, dh <= 128).
// strides: q (b, h), then the fresh rows (b, h), in elements; the feature
// axis of each is contiguous. c, vc (Hkv, K, dh), mass and valid (Hkv, K)
// contiguous, read in place. xk and xv may be null (no fresh row). dtype:
// 0 float32, 1 bfloat16, for q, xk, xv and out alike. Returns a CUDA error
// code, 0 on success.
extern "C" int repro_flash_centroid_decode(
    const void* q, const float* c, const float* vc, const float* mass,
    const unsigned char* valid, const void* xk, const void* xv, void* out,
    int dtype, const long long* dims, const long long* strides, float scale,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dec::Args a{q,     strides[0], strides[1], c,          vc,
                    mass,  valid,      xk,         xv,         strides[2],
                    strides[3], out,   (int)dims[1], (int)dims[2],
                    (int)dims[3], (int)dims[4], scale};
  const int B = (int)dims[0];
  if (a.dh < 1 || a.dh > 128 || a.Hkv < 1 || a.Hq % a.Hkv != 0 ||
      (xk == nullptr) != (xv == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) err = dec::launch<float>(a, B, s);
  else if (dtype == 1) err = dec::launch<__nv_bfloat16>(a, B, s);
  else return (int)cudaErrorInvalidValue;
  return (int)err;
}
