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
// center index. Codes are any int32 values. Counts are exact integers: no
// -1/-2 pad sentinels are subtracted back out, as the TPU kernel had to,
// and the field test counts what the reference's OR-fold
// (repro/kernels/pack.py) counts, word for word.
//
// Bound on this card: operations. At the main paths' shapes (2M x 1024
// centers x 9 codes; 2.4M x 1024 x 32 words) every input byte is read
// once while each (row, center) pair costs d compares and adds or w field
// tests of 32-bit integer work, plus the running minimum. Hopper issues
// compares, logic and min at 64 a clock per SM on the integer pipe, and
// integer multiply-adds at 64 on the FMA pipe, where an add can go as an
// IMAD (__popc at 16, on a pipe of its own). The least time
// (chip_smoke.py EQUALITY_OPS, PACKED_OPS) counts the integer pipe: d
// compares, or the field test's three LOP3 a word, and one min (VIMNMX)
// a pair.
//
// Equality, d <= 32 (equality_argmin_kernel<D>, the main path's d = 9).
// The width is a template parameter, so a row compares its own d columns
// and no pad. Each thread keeps EQ_ROWS rows in registers, and one
// shared-memory load of a center's columns serves them all. A center's
// count and index go into one key, count * BK + (index in its tile of
// BK): the center's staged offset, d * BK + i when valid and (2d + 1) *
// BK + i when not (or past k), less BK for every equal column; the least
// key of a tile (one min) is its least count, first index on ties, and an
// invalid center's key never counts below d + 1. Each tile's least key is
// merged into the row's (count, index) with a strict '<', tiles in
// ascending order, so the first index wins ties across tiles too. The
// block stages as many centers as EQ_SMEM holds (every center of the main
// path: two barriers a block), with a flag per tile of BK; a tile with no
// valid center is skipped, so the work follows k*, not k_max. Its SASS at
// d = 9 is the least time's mix: a pair costs 9 ISETP, 9 VIADD predicated
// on them (off the integer pipe) and one VIMNMX, and a center's three
// shared loads serve 4 pairs; it runs at ~1.2x its least time. 1, 2 or 8
// rows a thread, 32-center stages, a tile's centers wholly unrolled and
// the add as a predicated IMAD were slower (tools/kernel_variants.py
// --kernel equality).
//
// Packed, and equality with d > 32 (hamming_argmin_kernel<Op, DC>). As
// in distance_argmin.cu, the TPU's sequential grid axis over center tiles
// (running min in scratch) becomes a loop inside the block: one thread
// owns one row and walks all centers in ascending order, keeping (count,
// index) with a strict '<', so the first index wins ties without a
// cross-thread reduction. Per block, 256 rows and a tile of BK centers
// are staged in shared memory DC columns at a time; a thread copies its
// row's chunk into registers and reads the center tile as 16-byte
// broadcasts (every thread reads the same address). The chunk width DC
// (8, 16 or 32 words) is a template parameter picked from w; columns past
// w are padded so that they never count: zero words on both sides for the
// packed form, -1 against -2 for equality (whose d > 32 always runs
// 32-column chunks). Two rows a thread would share each center load, but
// need 64 row and 64 count registers at w = 32 and run 1.6x slower
// (tools/kernel_variants.py --kernel packed). The packed form costs three
// LOP3 (xor, and, the or-and), the add (VIADD) and half an IADD3 (the
// count's add, two words at a time) a word, plus a __popc, against the
// reference's OR-fold's 11 integer operations; it takes ~1.6x its least
// time, and variants that move the adds and popcs to other pipes, or that
// raise the blocks an SM holds, were not faster.
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

constexpr int EQ_ROWS = 4;              // rows a thread
constexpr int EQ_UNROLL = 8;            // centers a step of the inner loop
constexpr int EQ_SMEM = 64 * 1024;      // bytes of staged centers, at most

// a staged center: its D codes, its key offset, padding to 16 bytes
template <int D>
__host__ __device__ constexpr int eq_stride() {
  return (D + 1 + 3) / 4 * 4;
}

// fold a key (count * BK + index in the tile at `base`) into the row's
// (count, index): a strict '<', in ascending center order
__device__ __forceinline__ void merge(int& best, int& best_i, int key,
                                      int base) {
  const int cnt = (int)((unsigned)key / BK);
  if (cnt < best) {
    best = cnt;
    best_i = base + (int)((unsigned)key % BK);
  }
}

// one equal column takes BK off the key
__device__ __forceinline__ int take(int key, int32_t a, int32_t b) {
  return a == b ? key - BK : key;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
equality_argmin_kernel(const int32_t* __restrict__ x,
                       const int32_t* __restrict__ c,
                       const int32_t* __restrict__ valid, int n, int k,
                       int stage, int32_t* __restrict__ labels,
                       int32_t* __restrict__ counts) {
  constexpr int S = eq_stride<D>();
  extern __shared__ __align__(16) int32_t cs[];  // stage x S, then flags
  int* live = cs + stage * S;                     // a flag per tile of BK

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * (THREADS * EQ_ROWS) + tid;
  int32_t xr[EQ_ROWS][D];
  int best[EQ_ROWS], best_i[EQ_ROWS];
#pragma unroll
  for (int r = 0; r < EQ_ROWS; ++r) {
    const long long row = row0 + (long long)r * THREADS;
#pragma unroll
    for (int j = 0; j < D; ++j) xr[r][j] = row < n ? x[row * D + j] : 0;
    best[r] = D + 1;
    best_i[r] = 0;
  }

  for (int k0 = 0; k0 < k; k0 += stage) {
    const int len = min(stage, k - k0);
    const int tiles = (len + BK - 1) / BK;
    __syncthreads();  // the previous stage is consumed
    const int32_t* cg = c + (long long)k0 * D;
    for (int e = tid; e < len * D; e += THREADS) {
      const int i = e / D;
      cs[i * S + e - i * D] = cg[e];
    }
    // a tile of BK centers is one warp's pass: its ballot is the flag
    for (int i = tid; i < tiles * BK; i += THREADS) {
      const bool v = i < len && valid[k0 + i] != 0;
      cs[i * S + D] = (v ? D : 2 * D + 1) * BK + i % BK;
      const unsigned any = __ballot_sync(0xffffffffu, v);
      if (tid % 32 == 0) live[i / BK] = any != 0u;
    }
    __syncthreads();

    for (int t = 0; t < tiles; ++t) {
      if (!live[t]) continue;  // no valid center: (best, best_i) stays
      int tmin[EQ_ROWS];
#pragma unroll
      for (int r = 0; r < EQ_ROWS; ++r) tmin[r] = INT_MAX;
      const int32_t* ct = cs + t * BK * S;
#pragma unroll EQ_UNROLL
      for (int i = 0; i < BK; ++i) {
        int32_t cv[S];
#pragma unroll
        for (int q = 0; q < S; q += 4)
          *reinterpret_cast<int4*>(&cv[q]) =
              *reinterpret_cast<const int4*>(&ct[i * S + q]);
#pragma unroll
        for (int r = 0; r < EQ_ROWS; ++r) {
          int key = cv[D];
#pragma unroll
          for (int j = 0; j < D; ++j) key = take(key, xr[r][j], cv[j]);
          tmin[r] = min(tmin[r], key);
        }
      }
#pragma unroll
      for (int r = 0; r < EQ_ROWS; ++r)
        merge(best[r], best_i[r], tmin[r], k0 + t * BK);
    }
  }

#pragma unroll
  for (int r = 0; r < EQ_ROWS; ++r) {
    const long long row = row0 + (long long)r * THREADS;
    if (row < n) {
      labels[row] = best_i[r];
      counts[row] = best[r];
    }
  }
}

// the equality kernel at width D = d (d <= 32)
template <int D>
cudaError_t launch_equality(const int32_t* x, const int32_t* c,
                            const int32_t* valid, int n, int k, int d,
                            int32_t* labels, int32_t* counts,
                            cudaStream_t stream) {
  if constexpr (D < 32) {
    if (d > D)
      return launch_equality<D + 1>(x, c, valid, n, k, d, labels, counts,
                                    stream);
  }
  constexpr int per_tile = BK * eq_stride<D>() * 4 + 4;
  const int tiles = (k + BK - 1) / BK, most = EQ_SMEM / per_tile;
  const int stage = (tiles < most ? tiles : most) * BK;
  const size_t bytes = (size_t)(stage / BK) * per_tile;
  const auto kern = equality_argmin_kernel<D>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks =
      (unsigned)(((long long)n + THREADS * EQ_ROWS - 1) / (THREADS * EQ_ROWS));
  kern<<<blocks, THREADS, bytes, stream>>>(x, c, valid, n, k, stage, labels,
                                           counts);
  return cudaGetLastError();
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
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 32)
    return (int)launch_equality<1>(codes, centers, valid, n, k, d, labels,
                                   counts, st);
  const unsigned blocks = (unsigned)(((long long)n + THREADS - 1) / THREADS);
  hamming_argmin_kernel<Equality, 32><<<blocks, THREADS, 0, st>>>(
      codes, centers, valid, n, k, d, d, d + 1, labels, counts);
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
