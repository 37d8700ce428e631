// Fused squared-L2 distance + argmin over centers, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/distance_argmin.py::_l2_kernel
// (distance_argmin_l2 with accumulate=False): for every row x, the argmin
// over valid centers c of ||x||^2 - 2 x.c + ||c||^2, and that minimum
// clamped at 0. Invalid centers count as FLT_MAX; ties go to the lowest
// center index (jnp.argmin / torch.argmin), so a row with no valid center
// gets label 0 and FLT_MAX.
//
// Bound on this card: O(n k d) float32 FMAs against O((n + k) d) bytes, so
// at the main path's shapes (1M x 1024 x 128) it is bound by operations
// (67 TFLOP/s float32 outside the tensor cores), not by memory.
//
// Design. The TPU kernel carries a running (min, argmin) in scratch
// across a sequential grid axis over center tiles; CUDA blocks cannot
// carry state from one to the next, so each block owns BN rows and loops
// over ALL centers itself. Row and center tiles are staged in shared
// memory BD dims at a time; each of the 256 threads accumulates a 4 x 4
// register tile of dot products in float32 FMA (no TF32, no tensor cores
// yet) and keeps, per row, a running (d2, index) best. The 16 threads
// that share a row then reduce their bests through warp shuffles, comparing
// (d2, index) lexicographically: the lowest index wins ties whatever the
// order of the candidates. ||x||^2 is computed here; ||c||^2 comes from the
// caller, as the reference computes it outside its kernel.
//
// The accumulating variant replaces _l2_acc_kernel (distance_argmin_l2
// with accumulate=True), the assignment step of a Lloyd refine sweep: the
// same labels and d2, plus per-cluster float32 sums one-hot(labels)^T @ x
// (k, d) and counts (k,) in the same pass over x. Both kernels run the one
// per-tile argmin below, l2_argmin_tile, so their labels and d2 are the
// same bits (held on the card at every shape chip_smoke.py sweeps). The TPU kernel adds each tile into one (k, d)
// accumulator carried across its sequential grid; here blocks run in no
// order, and float atomics would make the sums change from call to call.
// So a fixed grid of ACC_SLOTS blocks (a constant, fewer only when there
// are fewer row tiles) walks the 64-row tiles in grid stride, and each
// block adds its rows, in row order, into its own (k, d) slot: one thread
// per column, read-modify-write with no other writer. A second kernel sums
// the slots in slot order. The sums are therefore the same on every call.
// The extra work is n*d adds and the slots' k*d*ACC_SLOTS floats, small
// beside the n*k*d FMAs of the argmin.
#include <cfloat>
#include <cmath>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64;                  // rows per block
constexpr int BK = 64;                  // centers per tile
constexpr int BD = 32;                  // feature dims per staged chunk
constexpr int TM = 4;                   // rows per thread
constexpr int TN = 4;                   // centers per thread
constexpr int THREADS = (BN / TM) * (BK / TN);  // 256
constexpr int PAD = 4;                  // keeps float4 reads aligned, breaks store conflicts

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// The argmin of the BN rows from row0: writes labels[row], d2_out[row]
// and, when tile_labels is not null, the tile's labels to that shared
// array. Called by every thread of a block.
__device__ __forceinline__ void l2_argmin_tile(
    const float* __restrict__ x, const float* __restrict__ c,
    const float* __restrict__ csq, const int* __restrict__ valid, int n,
    int k, int d, long long row0, int* __restrict__ labels,
    float* __restrict__ d2_out, int* tile_labels) {
  __shared__ __align__(16) float xs[BD][BN + PAD];
  __shared__ __align__(16) float cs[BD][BK + PAD];
  __shared__ float xsq_s[BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BK / TN);       // center lane: centers tx*TN ..
  const int ty = tid / (BK / TN);       // row lane: rows ty*TM ..
  __syncthreads();  // a previous tile of this block is done with xsq_s

  // ||x||^2 of the block's rows: one warp per row, lanes stride over d
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BN; r += THREADS / 32) {
    const long long row = row0 + r;
    float s = 0.f;
    if (row < n) {
      const float* xr = x + row * d;
      for (int j = lane; j < d; j += 32) s = fmaf(xr[j], xr[j], s);
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) xsq_s[r] = s;
  }

  float best[TM];
  int best_i[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = INFINITY;
    best_i[i] = INT_MAX;
  }

  for (int k0 = 0; k0 < k; k0 += BK) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += BD) {
      __syncthreads();  // the previous chunk is consumed (and xsq_s written)
      for (int e = tid; e < BN * BD; e += THREADS) {
        const int r = e / BD, j = e % BD;
        const long long row = row0 + r;
        const int col = d0 + j;
        xs[j][r] = (row < n && col < d) ? x[row * d + col] : 0.f;
      }
      for (int e = tid; e < BK * BD; e += THREADS) {
        const int r = e / BD, j = e % BD;
        const int cen = k0 + r, col = d0 + j;
        cs[j][r] = (cen < k && col < d) ? c[(long long)cen * d + col] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int j = 0; j < BD; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[j][ty * TM]);
        const float4 b = *reinterpret_cast<const float4*>(&cs[j][tx * TN]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int jj = 0; jj < TN; ++jj)
            acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
      }
    }

#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int cen = k0 + tx * TN + jj;
      if (cen < k) {
        const float cq = csq[cen];
        const bool ok = valid[cen] != 0;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float v = ok ? xsq_s[ty * TM + i] - 2.f * acc[i][jj] + cq
                             : FLT_MAX;
          if (better(v, cen, best[i], best_i[i])) {
            best[i] = v;
            best_i[i] = cen;
          }
        }
      }
    }
  }

  // the 16 threads of a row are the 16 lanes of one half-warp
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float v = best[i];
    int bi = best_i[i];
    for (int o = (BK / TN) / 2; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, v, bi)) {
        v = ov;
        bi = oi;
      }
    }
    const long long row = row0 + ty * TM + i;
    if (tx == 0 && row < n) {
      labels[row] = bi;
      d2_out[row] = fmaxf(v, 0.f);
    }
    if (tx == 0 && tile_labels != nullptr) tile_labels[ty * TM + i] = bi;
  }
}

// The accumulating kernel calls the tile through this copy that is not
// inlined: ptxas then allocates the tile as it does in l2_argmin_kernel,
// where inlining it beside the accumulation made that kernel slower on the
// card (PERF.md, section 6).
__device__ __noinline__ void l2_argmin_tile_call(
    const float* __restrict__ x, const float* __restrict__ c,
    const float* __restrict__ csq, const int* __restrict__ valid, int n,
    int k, int d, long long row0, int* __restrict__ labels,
    float* __restrict__ d2_out, int* tile_labels) {
  l2_argmin_tile(x, c, csq, valid, n, k, d, row0, labels, d2_out,
                 tile_labels);
}

__global__ void __launch_bounds__(THREADS)
l2_argmin_kernel(const float* __restrict__ x, const float* __restrict__ c,
                 const float* __restrict__ csq, const int* __restrict__ valid,
                 int n, int k, int d, int* __restrict__ labels,
                 float* __restrict__ d2_out) {
  l2_argmin_tile(x, c, csq, valid, n, k, d, (long long)blockIdx.x * BN,
                 labels, d2_out, nullptr);
}

// One block per slot: zero the slot, then for each of its row tiles (grid
// stride) the tile's argmin, and the tile's rows added into the slot's
// (k, d) sums and (k,) counts in row order.
__global__ void __launch_bounds__(THREADS)
l2_argmin_acc_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     const float* __restrict__ csq,
                     const int* __restrict__ valid, int n, int k, int d,
                     int* __restrict__ labels, float* __restrict__ d2_out,
                     float* __restrict__ slot_sums,
                     float* __restrict__ slot_cnt) {
  __shared__ int tile_lab[BN];
  const int tid = threadIdx.x;
  float* ps = slot_sums + (size_t)blockIdx.x * k * d;
  float* pc = slot_cnt + (size_t)blockIdx.x * k;
  for (long long e = tid; e < (long long)k * d; e += THREADS) ps[e] = 0.f;
  for (int e = tid; e < k; e += THREADS) pc[e] = 0.f;
  const long long tiles = ((long long)n + BN - 1) / BN;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * BN;
    // begins with a barrier: the zeroing and the last tile's adds are done
    l2_argmin_tile_call(x, c, csq, valid, n, k, d, row0, labels, d2_out,
                        tile_lab);
    __syncthreads();  // tile_lab is complete
    const int rows = (int)min((long long)BN, (long long)n - row0);
    for (int col = tid; col < d; col += THREADS) {
      const float* xc = x + row0 * d + col;
      for (int r = 0; r < rows; ++r)
        ps[(size_t)tile_lab[r] * d + col] += xc[(long long)r * d];
    }
    if (tid == 0)
      for (int r = 0; r < rows; ++r) pc[tile_lab[r]] += 1.f;
  }
}

// out[e] = sum over slots s = 0, 1, ... of part[s * m + e], in slot order.
__global__ void sum_slots_kernel(const float* __restrict__ part, int slots,
                                 long long m, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  float s = 0.f;
  for (int g = 0; g < slots; ++g) s += part[(size_t)g * m + e];
  out[e] = s;
}


}  // namespace

// x (n, d), c (k, d), csq (k,) float32; valid (k,) int32; all contiguous
// on `device`. Writes labels (n,) int32 and d2 (n,) float32. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int repro_l2_argmin_f32(const float* x, const float* c,
                                   const float* csq, const int* valid, int n,
                                   int k, int d, int* labels, float* d2,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + BN - 1) / BN);
  l2_argmin_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, c, csq, valid, n, k, d, labels, d2);
  return (int)cudaGetLastError();
}

// The accumulating variant: as repro_l2_argmin_f32, plus sums (k, d) and
// cnt (k,) float32. slot_sums (slots, k, d) and slot_cnt (slots, k) are
// the caller's scratch; slots is the grid (at most the row tiles). Three
// launches on `stream`; returns the first cudaGetLastError() that is not 0.
extern "C" int repro_l2_argmin_acc_f32(const float* x, const float* c,
                                       const float* csq, const int* valid,
                                       int n, int k, int d, int* labels,
                                       float* d2, float* slot_sums,
                                       float* slot_cnt, int slots,
                                       float* sums, float* cnt, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  l2_argmin_acc_kernel<<<slots, THREADS, 0, st>>>(
      x, c, csq, valid, n, k, d, labels, d2, slot_sums, slot_cnt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long m = (long long)k * d;
  sum_slots_kernel<<<(unsigned)((m + 255) / 256), 256, 0, st>>>(
      slot_sums, slots, m, sums);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_slots_kernel<<<(unsigned)((k + 255) / 256), 256, 0, st>>>(
      slot_cnt, slots, (long long)k, cnt);
  return (int)cudaGetLastError();
}
