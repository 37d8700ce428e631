// K-fold MinHash signatures of buckets held as contiguous segments (CSR),
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/minhash_buckets.py::_kernel
// (minhash_even_buckets): for every bucket, K times the min over its ids
// of fmix(id * a + b), the K minima mixed into one uint32 signature, with
// the exact uint32 arithmetic of repro/utils/hashing.py (hash_u32,
// mix_u32). An empty segment mixes UINT32_MAX, the identity of the
// reference's uint32 segment-min. Each signature is written as the int64
// carrier the port keeps uint32 values in (zero-extended).
//
// Bound on this card: bytes. Every id and offset is read once (4 bytes
// each) and every signature written once (8 bytes), for ~10 integer
// operations a hash.
//
// Design. The work follows the ids and the segments together, whatever
// their sizes. Two layouts reach this kernel on the main paths:
// - even partitions (dense fits, the LM cell's per-head fits): every
//   segment holds tens to tens of thousands of ids. One warp takes a
//   segment (minhash_warp_kernel): lanes stride over its ids, coalesced,
//   UNROLL loads in flight a lane, K running minima in registers, then
//   __reduce_min_sync folds the lanes.
// - signature partitions (code-space fits): L tables of n buckets each,
//   most of them empty, about one id a segment on average, a few buckets
//   of thousands. One lane takes a segment (minhash_lane_kernel,
//   LANE_SEGS segments a lane, the offsets and the first ids of all of
//   them loaded at once): a segment of at most short_max ids is hashed by
//   its lane; a longer one is cut into jobs of at most `chunk` ids,
//   appended to a device work list by a warp-aggregated atomicAdd.
//   minhash_chunk_kernel then gives each job a warp (a grid-stride loop
//   over the list, so no count is read on the host; the next job loaded
//   while the current one is hashed). A segment of one job
//   is written by its warp; a segment of several folds its jobs' minima
//   by atomicMin into a slot, and the job that finishes last mixes and
//   writes it.
// The wrapper (kernels/minhash_buckets.py) picks the layout from the mean
// segment length and passes short_max and chunk.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;       // warps a block
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 8;      // ids in flight a lane, warp loops
constexpr int LANE_SEGS = 4;   // segments a lane, the lane route
constexpr int LANE_IDS = 2;    // a short segment's ids loaded up front
constexpr int MAX_K = 8;
// a slot: MAX_K minima, the jobs done, the jobs in all
constexpr int SLOT = MAX_K + 2;
constexpr unsigned FULL = 0xffffffffu;

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
__device__ __forceinline__ void load_keys(const uint32_t* __restrict__ keys,
                                          uint32_t (&ka)[K],
                                          uint32_t (&kb)[K]) {
#pragma unroll
  for (int h = 0; h < K; ++h) {
    ka[h] = keys[2 * h];
    kb[h] = keys[2 * h + 1];
  }
}

template <int K>
__device__ __forceinline__ void take(uint32_t (&mins)[K], uint32_t v,
                                     const uint32_t (&ka)[K],
                                     const uint32_t (&kb)[K]) {
#pragma unroll
  for (int h = 0; h < K; ++h)
    mins[h] = min(mins[h], hash_u32(v, ka[h], kb[h]));
}

template <int K>
__device__ __forceinline__ uint32_t mixed(const uint32_t (&mins)[K]) {
  uint32_t s = 0u;
#pragma unroll
  for (int h = 0; h < K; ++h) s = mix_u32(s, mins[h]);
  return s;
}

// The K minima of ids[lo, hi) over the warp's lanes, in every lane.
template <int K>
__device__ __forceinline__ void warp_mins(const int32_t* __restrict__ ids,
                                          int lo, int hi, int lane,
                                          const uint32_t (&ka)[K],
                                          const uint32_t (&kb)[K],
                                          uint32_t (&mins)[K]) {
#pragma unroll
  for (int h = 0; h < K; ++h) mins[h] = 0xFFFFFFFFu;
  for (int p0 = lo + lane; p0 < hi; p0 += 32 * UNROLL) {
    uint32_t v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = p0 + 32 * u;
      v[u] = p < hi ? (uint32_t)__ldg(ids + p) : 0u;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (p0 + 32 * u < hi) take(mins, v[u], ka, kb);
  }
#pragma unroll
  for (int h = 0; h < K; ++h) mins[h] = __reduce_min_sync(FULL, mins[h]);
}

// One warp a segment.
template <int K>
__global__ void __launch_bounds__(THREADS)
minhash_warp_kernel(const int32_t* __restrict__ ids,
                    const int32_t* __restrict__ offsets, int num_segments,
                    const uint32_t* __restrict__ keys,
                    unsigned long long* __restrict__ sig) {
  const int seg = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (seg >= num_segments) return;  // uniform across the warp
  uint32_t ka[K], kb[K], mins[K];
  load_keys(keys, ka, kb);
  warp_mins(ids, offsets[seg], offsets[seg + 1], lane, ka, kb, mins);
  if (lane == 0) sig[seg] = mixed(mins);
}

// The lane route's device work list. header[0]: jobs, header[1]: slots,
// both zero before minhash_lane_kernel. A job is (segment, first id, end,
// slot or -1).
struct Work {
  int* header;
  int4* jobs;
  uint32_t* slots;
};

// One lane a segment; segments longer than short_max go to the list.
template <int K>
__global__ void __launch_bounds__(THREADS)
minhash_lane_kernel(const int32_t* __restrict__ ids,
                    const int32_t* __restrict__ offsets, int num_segments,
                    const uint32_t* __restrict__ keys,
                    unsigned long long* __restrict__ sig, int short_max,
                    int chunk, Work work) {
  const int lane = threadIdx.x % 32;
  const long long first =
      (long long)blockIdx.x * THREADS * LANE_SEGS + threadIdx.x;
  uint32_t ka[K], kb[K];
  load_keys(keys, ka, kb);

  int lo[LANE_SEGS], hi[LANE_SEGS];
#pragma unroll
  for (int r = 0; r < LANE_SEGS; ++r) {
    const long long seg = first + (long long)r * THREADS;
    lo[r] = hi[r] = 0;
    if (seg < num_segments) {
      lo[r] = __ldg(offsets + seg);
      hi[r] = __ldg(offsets + seg + 1);
    }
  }
  // the first LANE_IDS ids of every short segment, all in flight at once
  uint32_t v[LANE_SEGS][LANE_IDS];
#pragma unroll
  for (int r = 0; r < LANE_SEGS; ++r) {
    const int size = hi[r] - lo[r];
#pragma unroll
    for (int u = 0; u < LANE_IDS; ++u)
      v[r][u] = (u < size && size <= short_max)
                    ? (uint32_t)__ldg(ids + lo[r] + u) : 0u;
  }

#pragma unroll
  for (int r = 0; r < LANE_SEGS; ++r) {
    const long long seg = first + (long long)r * THREADS;
    const int size = hi[r] - lo[r];
    if (seg < num_segments && size <= short_max) {
      uint32_t mins[K];
#pragma unroll
      for (int h = 0; h < K; ++h) mins[h] = 0xFFFFFFFFu;
#pragma unroll
      for (int u = 0; u < LANE_IDS; ++u)
        if (u < size) take(mins, v[r][u], ka, kb);
      for (int p0 = lo[r] + LANE_IDS; p0 < hi[r]; p0 += LANE_IDS) {
        uint32_t w[LANE_IDS];
#pragma unroll
        for (int u = 0; u < LANE_IDS; ++u)
          w[u] = p0 + u < hi[r] ? (uint32_t)__ldg(ids + p0 + u) : 0u;
#pragma unroll
        for (int u = 0; u < LANE_IDS; ++u)
          if (p0 + u < hi[r]) take(mins, w[u], ka, kb);
      }
      sig[seg] = mixed(mins);
    }
    // a longer segment: its jobs appended, one atomicAdd a warp
    const bool longer = seg < num_segments && size > short_max;
    if (__any_sync(FULL, longer)) {
      const int nj = longer ? (size - 1) / chunk + 1 : 0;
      const int ns = nj > 1 ? 1 : 0;
      int sj = nj, ss = ns;  // inclusive scans over the lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int a = __shfl_up_sync(FULL, sj, o);
        const int b = __shfl_up_sync(FULL, ss, o);
        if (lane >= o) {
          sj += a;
          ss += b;
        }
      }
      int jbase = 0, sbase = 0;
      if (lane == 31) {
        jbase = atomicAdd(work.header, sj);
        sbase = atomicAdd(work.header + 1, ss);
      }
      jbase = __shfl_sync(FULL, jbase, 31) + sj - nj;
      sbase = __shfl_sync(FULL, sbase, 31) + ss - ns;
      if (longer) {
        const int slot = ns ? sbase : -1;
        if (ns) {
          uint32_t* s = work.slots + (size_t)slot * SLOT;
#pragma unroll
          for (int h = 0; h < K; ++h) s[h] = 0xFFFFFFFFu;
          s[MAX_K] = 0u;
          s[MAX_K + 1] = (uint32_t)nj;
        }
        for (int j = 0; j < nj; ++j) {
          const int a = lo[r] + j * chunk;
          work.jobs[jbase + j] =
              make_int4((int)seg, a, (int)min((long long)a + chunk,
                                              (long long)hi[r]), slot);
        }
      }
    }
  }
}

// One warp a job of the list, grid-stride.
template <int K>
__global__ void __launch_bounds__(THREADS)
minhash_chunk_kernel(const int32_t* __restrict__ ids,
                     const uint32_t* __restrict__ keys,
                     unsigned long long* __restrict__ sig, Work work) {
  const int lane = threadIdx.x % 32;
  const int jobs = work.header[0];
  uint32_t ka[K], kb[K], mins[K];
  load_keys(keys, ka, kb);
  // the warp's next job is loaded while it hashes the current one
  const int stride = gridDim.x * WARPS;
  int j = blockIdx.x * WARPS + threadIdx.x / 32;
  int4 next = j < jobs ? work.jobs[j] : make_int4(0, 0, 0, 0);
  for (; j < jobs; j += stride) {
    const int4 job = next;
    if (j + stride < jobs) next = work.jobs[j + stride];
    warp_mins(ids, job.y, job.z, lane, ka, kb, mins);
    if (lane != 0) continue;
    if (job.w < 0) {
      sig[job.x] = mixed(mins);
      continue;
    }
    uint32_t* s = work.slots + (size_t)job.w * SLOT;
#pragma unroll
    for (int h = 0; h < K; ++h) atomicMin(s + h, mins[h]);
    __threadfence();
    if (atomicAdd(s + MAX_K, 1u) + 1u == s[MAX_K + 1]) {
      __threadfence();  // the last job: every other job's minima are in
#pragma unroll
      for (int h = 0; h < K; ++h) mins[h] = atomicOr(s + h, 0u);
      sig[job.x] = mixed(mins);
    }
  }
}

int sm_count(int device) {
  static int count[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (count[device] == 0)
    cudaDeviceGetAttribute(&count[device], cudaDevAttrMultiProcessorCount,
                           device);
  return count[device] > 0 ? count[device] : 132;
}

template <int K>
void launch(const int32_t* ids, const int32_t* offsets, int num_segments,
            const uint32_t* keys, unsigned long long* sig, int short_max,
            int chunk, int* work, long long max_jobs, int device,
            cudaStream_t stream) {
  if (work == nullptr) {
    const unsigned blocks = (unsigned)((num_segments + WARPS - 1) / WARPS);
    minhash_warp_kernel<K><<<blocks, THREADS, 0, stream>>>(
        ids, offsets, num_segments, keys, sig);
    return;
  }
  // header (4 ints), then the jobs (int4, 16-byte aligned), then the slots
  Work w{work, reinterpret_cast<int4*>(work + 4),
         reinterpret_cast<uint32_t*>(work + 4 + 4 * max_jobs)};
  const long long per_block = (long long)THREADS * LANE_SEGS;
  const unsigned blocks =
      (unsigned)((num_segments + per_block - 1) / per_block);
  minhash_lane_kernel<K><<<blocks, THREADS, 0, stream>>>(
      ids, offsets, num_segments, keys, sig, short_max, chunk, w);
  const long long most = (max_jobs + WARPS - 1) / WARPS;
  const long long full = (long long)sm_count(device) * (2048 / THREADS);
  minhash_chunk_kernel<K><<<(unsigned)(most < full ? most : full), THREADS,
                            0, stream>>>(ids, keys, sig, w);
}

}  // namespace

// Workspace ints for the lane layout (`work`): 4 + 4 * max_jobs + SLOT *
// max_slots, its first 4 zero. A segment longer than short_max gives
// ceil(size / chunk) jobs and, with more than one, a slot; so max_jobs =
// P / chunk + P / (short_max + 1) + 1 and max_slots = P / (chunk + 1) + 1
// suffice for P ids.
extern "C" int repro_minhash_slot_ints(void) { return SLOT; }

// ids (P,) int32; offsets (S+1,) int32, non-decreasing within [0, P];
// keys (K, 2) uint32 (a, b) pairs with 1 <= K <= 8; sig (S,) uint64. All on
// `device`. `work` null: one warp a segment; else the lane layout with
// `short_max` and `chunk` (>= 1), `work` as above.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int repro_minhash_segments_u32(const int32_t* ids,
                                          const int32_t* offsets,
                                          int num_segments,
                                          const uint32_t* keys, int K,
                                          unsigned long long* sig,
                                          int short_max, int chunk, int* work,
                                          long long max_jobs, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (work != nullptr && (chunk < 1 || short_max < 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_MH_CASE(k)                                                   \
  case k:                                                                  \
    launch<k>(ids, offsets, num_segments, keys, sig, short_max, chunk,     \
              work, max_jobs, device, st);                                 \
    break;
  switch (K) {
    REPRO_MH_CASE(1)
    REPRO_MH_CASE(2)
    REPRO_MH_CASE(3)
    REPRO_MH_CASE(4)
    REPRO_MH_CASE(5)
    REPRO_MH_CASE(6)
    REPRO_MH_CASE(7)
    REPRO_MH_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_MH_CASE
  return (int)cudaGetLastError();
}
