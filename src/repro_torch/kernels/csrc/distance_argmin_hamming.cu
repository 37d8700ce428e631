// Hamming distance + argmin over centers, for Hopper (sm_90a): the
// attribute-equality form and the bit-packed form.
//
// Replaces the TPU kernels repro/kernels/distance_argmin.py::_ham_kernel
// (distance_argmin_hamming) and ::_ham_packed_kernel
// (distance_argmin_hamming_packed). For every row, the argmin over valid
// centers of the number of mismatching attributes, and that number:
//   equality: codes (n, d) int32 vs centers (k, d) int32, d - #equal;
//   packed:   words (n, w) uint32 vs centers (k, w) uint32, each word
//             holding 32/BITS fields of BITS bits: XOR, OR-fold every
//             field onto its lowest bit, mask with the field-LSB
//             constant, __popc, summed over the words.
// The contract is the reference's main path (repro/core/assign.py
// assign_hamming, assign_hamming_packed): an invalid center counts `big`
// (d + 1, or INT32_MAX for the packed form without d), so a row with no
// valid center gets label 0 and count `big`; ties go to the lowest
// center index. Counts are exact integers: no -1/-2 pad sentinels are
// subtracted back out, as the TPU kernel had to.
//
// Bound on this card: operations. At the main paths' shapes (2M x 1024
// centers x 9 codes; 2.4M x 1024 x 32 words) every input byte is read
// once while each (row, center) pair costs d compare-adds or w
// xor/fold/popc/add chains of 32-bit integer work, which Hopper issues
// at 64 a clock per SM (__popc at 16).
//
// Design. As in distance_argmin.cu, the TPU's sequential grid axis over
// center tiles (running min in scratch) becomes a loop inside the block:
// one thread owns one row and walks all centers in ascending order,
// keeping (count, index) with a strict '<', so the first index wins ties
// without a cross-thread reduction. Per block, 256 rows and a tile of BK
// centers are staged in shared memory DC columns at a time; a thread
// copies its row's chunk into registers and reads the center tile as
// 16-byte broadcasts (every thread reads the same address). The chunk
// width DC (8, 16 or 32 columns) is a template parameter picked from d,
// so short rows (9 hetero codes, one 4-bit word) do not pay for 32.
// Columns past d are padded so that they never count: -1 against -2 for
// equality, zero words on both sides for the packed form. A tile of
// centers with none valid is skipped, so the work follows k*, not k_max.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // rows per block, one per thread
constexpr int BK = 32;        // centers per staged tile

struct Equality {
  static constexpr int32_t kPadX = -1, kPadC = -2;
  __device__ __forceinline__ static int term(int32_t a, int32_t b) {
    return a == b;
  }
  __device__ __forceinline__ static int finish(int acc, int d) {
    return d - acc;
  }
};

template <int BITS>
struct Packed {
  static constexpr int32_t kPadX = 0, kPadC = 0;
  static constexpr uint32_t kLsb = BITS == 1   ? 0xFFFFFFFFu
                                   : BITS == 2 ? 0x55555555u
                                   : BITS == 4 ? 0x11111111u
                                   : BITS == 8 ? 0x01010101u
                                   : BITS == 16 ? 0x00010001u
                                                : 0x00000001u;
  __device__ __forceinline__ static int term(int32_t a, int32_t b) {
    uint32_t z = (uint32_t)a ^ (uint32_t)b;
#pragma unroll
    for (int s = BITS >> 1; s > 0; s >>= 1) z |= z >> s;
    return __popc(z & kLsb);
  }
  __device__ __forceinline__ static int finish(int acc, int /*d*/) {
    return acc;
  }
};

// stage columns [c0, c0 + DC) of the block's rows into xs, padded
template <class Op, int DC>
__device__ __forceinline__ void stage_rows(const int32_t* __restrict__ x,
                                           int32_t (*xs)[DC + 1],
                                           long long row0, int n, int cols,
                                           int c0, int tid) {
  for (int e = tid; e < THREADS * DC; e += THREADS) {
    const int r = e / DC, j = e % DC;
    const long long rr = row0 + r;
    const int col = c0 + j;
    xs[r][j] = (rr < n && col < cols) ? x[rr * cols + col] : (int32_t)Op::kPadX;
  }
}

template <class Op, int DC>
__global__ void __launch_bounds__(THREADS)
hamming_argmin_kernel(const int32_t* __restrict__ x,
                      const int32_t* __restrict__ c,
                      const int32_t* __restrict__ valid, int n, int k,
                      int cols, int d, int big, int32_t* __restrict__ labels,
                      int32_t* __restrict__ counts) {
  __shared__ int32_t xs[THREADS][DC + 1];          // +1: conflict-free rows
  __shared__ __align__(16) int32_t cs[BK][DC];
  __shared__ int32_t vs[BK];

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * THREADS;
  const long long row = row0 + tid;
  const int nchunks = (cols + DC - 1) / DC;

  int32_t xr[DC];
  int best = big, best_i = 0;

  if (nchunks == 1) {  // the whole row fits one chunk: load it once
    stage_rows<Op, DC>(x, xs, row0, n, cols, 0, tid);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < DC; ++j) xr[j] = xs[tid][j];
  }

  for (int k0 = 0; k0 < k; k0 += BK) {
    // a tile without a valid center cannot change (best, best_i): skip it
    // (the fitted modes' valid rows are a prefix, k* of k_max). The
    // barrier also ends the previous tile's reads of shared memory.
    if (!__syncthreads_or(tid < BK && k0 + tid < k && valid[k0 + tid] != 0))
      continue;
    int acc[BK];
#pragma unroll
    for (int i = 0; i < BK; ++i) acc[i] = 0;

    for (int ch = 0; ch < nchunks; ++ch) {
      const int c0 = ch * DC;
      __syncthreads();  // the previous tile and row chunk are consumed
      if (nchunks > 1) stage_rows<Op, DC>(x, xs, row0, n, cols, c0, tid);
      for (int e = tid; e < BK * DC; e += THREADS) {
        const int r = e / DC, j = e % DC;
        const int cen = k0 + r, col = c0 + j;
        cs[r][j] = (cen < k && col < cols) ? c[(long long)cen * cols + col]
                                           : (int32_t)Op::kPadC;
      }
      if (ch == 0 && tid < BK)
        vs[tid] = (k0 + tid < k) ? valid[k0 + tid] : 0;
      __syncthreads();
      if (nchunks > 1) {
#pragma unroll
        for (int j = 0; j < DC; ++j) xr[j] = xs[tid][j];
      }
#pragma unroll
      for (int i = 0; i < BK; ++i) {
#pragma unroll
        for (int j = 0; j < DC; j += 4) {
          const int4 v = *reinterpret_cast<const int4*>(&cs[i][j]);
          acc[i] += Op::term(xr[j], v.x) + Op::term(xr[j + 1], v.y) +
                    Op::term(xr[j + 2], v.z) + Op::term(xr[j + 3], v.w);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < BK; ++i) {
      if (vs[i] != 0) {  // also 0 past k
        const int dist = Op::finish(acc[i], d);
        if (dist < best) {
          best = dist;
          best_i = k0 + i;
        }
      }
    }
  }

  if (row < n) {
    labels[row] = best_i;
    counts[row] = best;
  }
}

template <class Op>
void launch(const int32_t* x, const int32_t* c, const int32_t* valid, int n,
            int k, int cols, int d, int big, int32_t* labels, int32_t* counts,
            cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  if (cols <= 8)
    hamming_argmin_kernel<Op, 8><<<blocks, THREADS, 0, stream>>>(
        x, c, valid, n, k, cols, d, big, labels, counts);
  else if (cols <= 16)
    hamming_argmin_kernel<Op, 16><<<blocks, THREADS, 0, stream>>>(
        x, c, valid, n, k, cols, d, big, labels, counts);
  else
    hamming_argmin_kernel<Op, 32><<<blocks, THREADS, 0, stream>>>(
        x, c, valid, n, k, cols, d, big, labels, counts);
}

}  // namespace

// codes (n, d) int32, centers (k, d) int32, valid (k,) int32, all
// contiguous on `device`. Writes labels (n,) int32 and mismatch counts
// (n,) int32 (d + 1 where no center is valid). Launches on `stream` and
// returns cudaGetLastError().
extern "C" int repro_hamming_argmin_i32(const int32_t* codes,
                                        const int32_t* centers,
                                        const int32_t* valid, int n, int k,
                                        int d, int32_t* labels,
                                        int32_t* counts, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  launch<Equality>(codes, centers, valid, n, k, d, d, d + 1, labels, counts,
                   (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// words (n, w) and centers (k, w): uint32 words as int32 storage, fields
// of `bits` bits in {1, 2, 4, 8, 16, 32}; valid (k,) int32. `big` is the
// count of an invalid center (the unpacked width + 1, or INT32_MAX).
// Writes labels (n,) int32 and mismatch counts (n,) int32.
extern "C" int repro_hamming_packed_argmin_u32(const int32_t* words,
                                               const int32_t* centers,
                                               const int32_t* valid, int n,
                                               int k, int w, int bits, int big,
                                               int32_t* labels,
                                               int32_t* counts, int device,
                                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bits) {
    case 1: launch<Packed<1>>(words, centers, valid, n, k, w, 0, big, labels, counts, st); break;
    case 2: launch<Packed<2>>(words, centers, valid, n, k, w, 0, big, labels, counts, st); break;
    case 4: launch<Packed<4>>(words, centers, valid, n, k, w, 0, big, labels, counts, st); break;
    case 8: launch<Packed<8>>(words, centers, valid, n, k, w, 0, big, labels, counts, st); break;
    case 16: launch<Packed<16>>(words, centers, valid, n, k, w, 0, big, labels, counts, st); break;
    case 32: launch<Packed<32>>(words, centers, valid, n, k, w, 0, big, labels, counts, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
