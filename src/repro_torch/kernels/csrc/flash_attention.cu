// Flash attention and mass-weighted centroid attention, for Hopper (sm_90a).
//
// Replaces two TPU kernels of repro/kernels/flash_attention.py:
//
// - flash_attention_kernel replaces flash_attention (the Pallas `_kernel`
//   under `flash_attention`): the causal or non-causal GQA forward
//   softmax(q k^T / sqrt(dh)) v, float32 inside, output in q's dtype; key
//   tiles past the causal frontier are skipped; a row's result is
//   acc / max(l, 1e-30). The LM's prefill runs it (B = 1, Hq = 16, Hkv = 8,
//   S = 2,048, dh = 64, bf16, causal for Qwen3-0.6B).
// - flash_centroid_kernel replaces flash_centroid_attention: the
//   clustered-KV decode step softmax_K(q c^T / sqrt(dh) + log_mass) v_cent
//   over K centroids, GQA by head index, log_mass = -1e30 marking dead
//   centroids (once per attention layer per decode step: B = 1, S = 1,
//   Hq = 16, Hkv = 8, K = 65, dh = 64). The TPU kernel folds log_mass into
//   an augmented dh+1 feature lane so that it can reuse the flash kernel's
//   body; here the bias is added directly after the q c^T / sqrt(dh) product.
//
// Both kernels run one device function, online_softmax_tile, for every key
// tile, so the two cannot drift apart.
//
// Bound on this card. The prefill's causal half at S = 2,048 is 8.6 GFLOP
// against 12.6 MB moved: above the bf16 tensor cores' ridge, so it is bound
// by operations. The decode step is 16 x 65 x 64 x 4 flops against ~50 KB:
// bound by latency (one launch, a few microseconds), far below either roof.
//
// Design, simple first: one block of 256 threads per (query tile of 64
// rows, query head, batch); the kv head is h / (Hq / Hkv). The block
// stages its queries once, transposed, in shared memory, then walks the
// key tiles of 64 rows (up to the causal frontier): keys (transposed) and
// values are staged in shared memory as float32, each thread computes a
// 4 x 4 tile of scores by FMA (float32 on the CUDA cores: no tensor cores,
// no TMA yet), the 16 threads that share a query row reduce its max and
// sum by warp shuffles, and the probabilities go through shared memory
// into each thread's 4 rows x dh/16 columns of the float32 accumulator.
// dh is any width up to 128, padded with zeros to 32, 64 or 128 in shared
// memory (a template). Ragged S and K are masked here, not padded by the
// caller. Mask arithmetic never makes an infinity: see online_softmax_tile.
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

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out share it). dims: B, Hq,
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
    if (dh <= 32) err = launch_attention<__nv_bfloat16, 32>(q, k, v, out, dims, st, causal, scale, s);
    else if (dh <= 64) err = launch_attention<__nv_bfloat16, 64>(q, k, v, out, dims, st, causal, scale, s);
    else err = launch_attention<__nv_bfloat16, 128>(q, k, v, out, dims, st, causal, scale, s);
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
