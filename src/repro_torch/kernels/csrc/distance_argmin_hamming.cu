// Hamming distance + argmin over centers, for Hopper (sm_90a): the
// attribute-equality form and the bit-packed form.
//
// Replaces the TPU kernels repro/kernels/distance_argmin.py::_ham_kernel
// (distance_argmin_hamming) and ::_ham_packed_kernel
// (distance_argmin_hamming_packed). For every row, the argmin over valid
// centers of the number of mismatching attributes, and that number:
//   equality: codes (n, d) int32 vs centers (k, d) int32, d - #equal;
//   packed:   words (n, w) uint32 vs centers (k, w) uint32, each word
//             holding 32/BITS fields of BITS bits: z = a ^ c, then the
//             SWAR field test v = (((z & low) + low) | z) & high, where
//             `high` holds each field's top bit and low = ~high. The top
//             bit of a field of v is set iff that field of z is not zero,
//             every other bit of v is clear, and __popc(v) counts the
//             word's mismatching fields (BITS = 1: __popc(z); 32: z != 0).
// The contract is the reference's main path (repro/core/assign.py
// assign_hamming, assign_hamming_packed): an invalid center counts `big`
// (d + 1, or INT32_MAX for the packed form without d), so a row with no
// valid center gets label 0 and count `big`; ties go to the lowest
// center index. Counts are exact integers: no -1/-2 pad sentinels are
// subtracted back out, as the TPU kernel had to, and the field test
// counts what the reference's OR-fold (repro/kernels/pack.py) counts,
// word for word.
//
// Bound on this card: operations. At the main paths' shapes (2M x 1024
// centers x 9 codes; 2.4M x 1024 x 32 words) every input byte is read
// once while each (row, center) pair costs d compare-adds or w field
// tests of 32-bit integer work, which Hopper issues at 64 a clock per SM
// (adds also on the FMA pipe; __popc at 16, on a pipe of its own). The
// reference's OR-fold costs 11 integer operations a 16-bit word (xor,
// 4 x (shift, or), and, add), all on the integer pipe. The field test
// costs three LOP3 (xor, and, the or-and), the add (VIADD) and half an
// IADD3 (the count's add, two words at a time), plus a __popc, and ran
// 2.3x faster than the OR-fold at 16-bit fields on an H100. The least
// time counts only the three LOP3 on the integer pipe: the adds can go
// to the FMA pipe as IMAD, and a quarter of the popcs can become IMAD.HI
// shift-adds (chip_smoke.py PACKED_OPS). This kernel takes ~1.6x that;
// variants that move the adds and popcs off as the bound does, or that
// raise the blocks an SM holds, were not faster, and what holds it back
// is not known (tools/kernel_variants.py --kernel packed).
//
// Design. As in distance_argmin.cu, the TPU's sequential grid axis over
// center tiles (running min in scratch) becomes a loop inside the block:
// one thread owns one row and walks all centers in ascending order,
// keeping (count, index) with a strict '<', so the first index wins ties
// without a cross-thread reduction. Per block, 256 rows and a tile of BK
// centers are staged in shared memory DC columns at a time; a thread
// copies its row's chunk into registers and reads the center tile as
// 16-byte broadcasts (every thread reads the same address). Two rows a
// thread would share each center load, but need 64 row and 64 count
// registers at w = 32 and run 1.6x slower (tools/kernel_variants.py
// --kernel packed). The chunk
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
  // the top bit of every BITS-bit field (BITS in 2..16), and the rest
  static constexpr uint32_t kHigh = BITS == 2   ? 0xAAAAAAAAu
                                    : BITS == 4 ? 0x88888888u
                                    : BITS == 8 ? 0x80808080u
                                                : 0x80008000u;
  static constexpr uint32_t kLow = ~kHigh;
  // each field's top bit set iff that field of z is not zero: (z & low) +
  // low stays below 2^BITS in every field, so no carry crosses a field
  __device__ __forceinline__ static uint32_t nonzero_fields(uint32_t z) {
    return (((z & kLow) + kLow) | z) & kHigh;
  }
  __device__ __forceinline__ static int term(int32_t a, int32_t b) {
    const uint32_t z = (uint32_t)a ^ (uint32_t)b;
    if constexpr (BITS == 1) return __popc(z);
    else if constexpr (BITS == 32) return z != 0u;
    else return __popc(nonzero_fields(z));
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
