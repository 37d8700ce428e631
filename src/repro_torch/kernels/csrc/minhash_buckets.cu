// K-fold MinHash signatures of buckets held as contiguous segments (CSR),
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/minhash_buckets.py::_kernel
// (minhash_even_buckets): for every bucket, K times the min over its ids
// of fmix(id * a + b), the K minima mixed into one uint32 signature, with
// the exact uint32 arithmetic of repro/utils/hashing.py (hash_u32,
// mix_u32). An empty segment mixes UINT32_MAX, the identity of the
// reference's uint32 segment-min.
//
// Bound on this card: every id is read once (4 bytes) for ~10 integer
// operations per hash, so it is bound by memory: 160 MB of ids per SILK
// round at the main path's 1M x 40 tables.
//
// Design. The TPU kernel takes (num_buckets, bucket_size) rows, which
// needs equal bucket sizes; this one takes CSR offsets, so the ragged
// buckets of an even rank partition with t not dividing n need no
// padding. One warp per segment: lanes stride over its ids (coalesced,
// UNROLL loads in flight per lane to cover memory latency), each lane
// keeps K running minima in registers (K is a template parameter), then
// __reduce_min_sync folds the lanes and lane 0 mixes and writes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;   // segments per block
constexpr int UNROLL = 8;  // ids in flight per lane

__device__ __forceinline__ uint32_t hash_u32(uint32_t x, uint32_t a,
                                             uint32_t b) {
  uint32_t h = x * a + b;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t mix_u32(uint32_t acc, uint32_t v) {
  return (acc * 0x01000193u) ^ (v + 0x9E3779B9u + (acc << 6) + (acc >> 2));
}

template <int K>
__global__ void __launch_bounds__(WARPS * 32)
minhash_segments_kernel(const int32_t* __restrict__ ids,
                        const int32_t* __restrict__ offsets, int num_segments,
                        const uint32_t* __restrict__ keys,
                        uint32_t* __restrict__ sig) {
  const int seg = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (seg >= num_segments) return;  // uniform across the warp

  uint32_t ka[K], kb[K], mins[K];
#pragma unroll
  for (int h = 0; h < K; ++h) {
    ka[h] = keys[2 * h];
    kb[h] = keys[2 * h + 1];
    mins[h] = 0xFFFFFFFFu;
  }
  const int lo = offsets[seg], hi = offsets[seg + 1];
  for (int p0 = lo + lane; p0 < hi; p0 += 32 * UNROLL) {
    uint32_t v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = p0 + 32 * u;
      v[u] = p < hi ? (uint32_t)__ldg(ids + p) : 0u;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (p0 + 32 * u < hi) {
#pragma unroll
        for (int h = 0; h < K; ++h)
          mins[h] = min(mins[h], hash_u32(v[u], ka[h], kb[h]));
      }
    }
  }
  uint32_t s = 0u;
#pragma unroll
  for (int h = 0; h < K; ++h)
    s = mix_u32(s, __reduce_min_sync(0xffffffffu, mins[h]));
  if (lane == 0) sig[seg] = s;
}

template <int K>
void launch(const int32_t* ids, const int32_t* offsets, int num_segments,
            const uint32_t* keys, uint32_t* sig, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((num_segments + WARPS - 1) / WARPS);
  minhash_segments_kernel<K><<<blocks, WARPS * 32, 0, stream>>>(
      ids, offsets, num_segments, keys, sig);
}

}  // namespace

// ids (P,) int32; offsets (S+1,) int32, non-decreasing within [0, P];
// keys (K, 2) uint32 (a, b) pairs with 1 <= K <= 8; sig (S,) uint32. All on
// `device`.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int repro_minhash_segments_u32(const int32_t* ids,
                                          const int32_t* offsets,
                                          int num_segments,
                                          const uint32_t* keys, int K,
                                          uint32_t* sig, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 1: launch<1>(ids, offsets, num_segments, keys, sig, st); break;
    case 2: launch<2>(ids, offsets, num_segments, keys, sig, st); break;
    case 3: launch<3>(ids, offsets, num_segments, keys, sig, st); break;
    case 4: launch<4>(ids, offsets, num_segments, keys, sig, st); break;
    case 5: launch<5>(ids, offsets, num_segments, keys, sig, st); break;
    case 6: launch<6>(ids, offsets, num_segments, keys, sig, st); break;
    case 7: launch<7>(ids, offsets, num_segments, keys, sig, st); break;
    case 8: launch<8>(ids, offsets, num_segments, keys, sig, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
