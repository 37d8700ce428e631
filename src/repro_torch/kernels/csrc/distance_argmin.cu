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
// (67 TFLOP/s float32 outside the tensor cores), not by memory; the work
// the data needs is 2 n k* d, k* the valid centers.
//
// Design. The TPU kernel carries a running (min, argmin) in scratch
// across a sequential grid axis over center tiles; CUDA blocks cannot
// carry state from one to the next, so each block of 128 threads owns
// BN = 128 rows and loops over the center tiles itself, keeping per row a
// running (d2, index) best. What it does about the bound:
// - Dead tiles are skipped. When the block starts it sets one bit per
//   tile of BK = 64 centers that holds a valid center (a ballot over the
//   validity flags: mark_live), and walks the set bits only (next_live).
//   A fitted model's live centers sit at the front of k_max
//   (centroid_centers fills groups 0..k*-1), so most tiles are dead. A
//   dead tile's exact candidate is (FLT_MAX, its first index): every
//   center in it would give FLT_MAX and the lowest index wins. That
//   candidate is folded in instead of the tile's loads and FMAs, so the
//   work follows k*, not k.
// - Rows are resident. For d <= 256 the block's rows are read from device
//   memory once, into shared memory, chunk by chunk with the first live
//   tile, and stay there across every center tile; ||x||^2 is computed
//   from them. Center tiles stream through a cp.async double buffer, BD
//   dims at a time: chunk s + 1 is in flight while chunk s computes.
//   Larger d stages rows and centers BD dims at a time, double-buffered
//   the same way (the RES template parameter).
// - Each thread keeps an 8 x 8 register tile (rows ty + 16i, centers
//   tx + 8j) and reads it from shared memory as float4s over 4 dims: four
//   consecutive rows and eight consecutive centers a warp, in distinct
//   banks. Products are float32 FMA on the CUDA cores (TF32 would break
//   the tolerance), each (row, center) dot accumulated in d order.
// The 8 threads that share a row then reduce their bests through warp
// shuffles, comparing (d2, index) lexicographically: the lowest index
// wins ties whatever the order of the candidates. ||c||^2 comes from the
// caller, as the reference computes it outside its kernel.
//
// The head-batched entry (repro_l2_argmin_heads_f32) routes the new keys
// of all kv heads of one attention layer in one launch, in the decode step
// of the KV-cache clustering: grid (row tiles, heads), each block the tile
// routine below on its head's slices, so each head's result has the bits
// of one launch on that head.
//
// The accumulating variant replaces _l2_acc_kernel (distance_argmin_l2
// with accumulate=True), the assignment step of a Lloyd refine sweep: the
// same labels and d2, plus per-cluster float32 sums one-hot(labels)^T @ x
// (k, d) and counts (k,) in the same pass over x. Both kernels run the one
// per-tile argmin below, l2_argmin_tile, so their labels and d2 are the
// same bits (held on the card at every shape chip_smoke.py sweeps). The
// TPU kernel adds each tile into one (k, d) accumulator carried across its
// sequential grid; here blocks run in no order, and float atomics would
// make the sums change from call to call. So a fixed grid of ACC_SLOTS
// blocks (a constant, fewer only when there are fewer row tiles) walks the
// BN-row tiles in grid stride, and each block adds its rows, in row order,
// into its own slot; a second kernel sums the slots in slot order. The
// sums are therefore the same on every call. Bound: the argmin's
// operations plus n*d adds. What the design does about the sums:
// - A slot holds only the live clusters: the valid centers and the first
//   invalid one (the only invalid label the argmin can give: every dead
//   candidate is (FLT_MAX, its index) and the first wins). Each block maps
//   labels to that compact index once (live_map), so a slot is
//   live * d floats, not k * d, and zeroing and summing the slots touch
//   slots * live * d floats.
// - Rows are added from shared memory, where the tile routine has just
//   staged them (resident rows, d <= 256), not read again from x.
// - No serial read-modify-write chain: the tile's rows are grouped by
//   label in row order (a stable rank sort of 128 keys), and each (label,
//   column) is one register chain, started from the slot's value and
//   stored once; GB groups go at once (add_groups), four columns a thread
//   where the rows and the slot are 16-byte aligned.
// So slot s adds the rows of tiles s, s + slots, ... in row order from 0,
// and the slots are summed in slot order from 0 (ref.py's
// distance_argmin_l2_acc_sums_ref rebuilds this order in plain float32;
// the kernel's sums are held to it bit for bit).
//
// The decode step's absorb (repro_l2_absorb_heads_f32) replaces the TPU
// kernel distance_argmin_l2 as the KV-cache clustering's decode step calls
// it, through repro/serve/kv_cluster.py: route (predict) of each kv head's
// one new key, then ema_update of the hit cluster. One launch a layer does
// both for every head, in place of the route launch and the ~60 small
// PyTorch ops of the plain EMA. Bound: bytes (the fresh rows, the
// valid centers' rows and ||c||^2, a byte a flag, the hit rows read and
// written, labels), a few kilobytes: in practice one launch's latency and
// a few dependent memory round trips. Design: a warp per head, no tiles;
// lanes run over the centers, a dead center's candidate (FLT_MAX, index)
// taken without a load; each valid center's dot product one fmaf chain in
// d order from a row loaded into registers at once, ||x||^2 and the
// combination as l2_argmin_tile computes them, so labels and d2 are
// l2_argmin_heads_kernel's bits; a (d2, index) shuffle reduction; then the
// same warp updates the hit rows with the plain EMA's roundings, one
// rounding an op (__fmul_rn, __fadd_rn: no contraction).
#include <cfloat>
#include <cmath>
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 128;                 // rows per block
constexpr int BK = 64;                  // centers per tile
constexpr int BD = 64;                  // feature dims per staged chunk
constexpr int TM = 8;                   // rows per thread: ty + 16 i
constexpr int TN = 8;                   // centers per thread: tx + 8 j
constexpr int LANES = 8;                // threads that share a row
constexpr int THREADS = 128;
constexpr int ROWL = THREADS / LANES;   // row lanes (16)
constexpr int PAD = 4;                  // keeps rows 16-byte aligned
constexpr int LC = BD + PAD;            // row length of a staged chunk
constexpr int RES_MAX_D = 256;          // rows stay resident up to this d
static_assert(BN == TM * ROWL && BK == TN * LANES, "tiling");

// Shared memory of one block, in 4-byte words: the rows (resident: all of
// d, padded to BD; else two buffers of one chunk), two buffers of one
// center chunk, ||x||^2 of the rows, and one bit per center tile, set when
// the tile holds a valid center.
struct Layout {
  int lx, xs, cs, xsq, live, words;
};

__host__ __device__ inline Layout layout(bool res, int d, int k) {
  Layout L;
  L.lx = res ? (d + BD - 1) / BD * BD + PAD : LC;
  L.xs = 0;
  L.cs = L.xs + (res ? BN * L.lx : 2 * BN * LC);
  L.xsq = L.cs + 2 * BK * LC;
  L.live = L.xsq + BN;
  L.words = L.live + ((k + BK - 1) / BK + 31) / 32;
  return L;
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
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

// Rows [0, nr) x columns [c0, c0 + nc) of the row-major matrix src (row
// stride d, `avail` rows) into dst[r * ld + c - c0], zeros past `avail`
// and past d, asynchronously. vec: 16 bytes a copy (d % 4 == 0 and src
// 16-byte aligned), else 4. Called by every thread.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      long long avail, int nr, int c0,
                                      int nc, int d, bool vec) {
  if (vec) {
    const int per = nc / 4;
    for (int i = threadIdx.x; i < nr * per; i += THREADS) {
      const int r = i / per, c = c0 + (i % per) * 4;
      const bool ok = r < avail && c < d;
      cp_async16(dst + r * ld + c - c0, ok ? src + (long long)r * d + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < nr * nc; i += THREADS) {
      const int r = i / nc, c = c0 + i % nc;
      const bool ok = r < avail && c < d;
      cp_async4(dst + r * ld + c - c0, ok ? src + (long long)r * d + c : src,
                ok ? 4 : 0);
    }
  }
}

// Sets the bit of every center tile that holds a valid center: a ballot
// over 32 consecutive centers (one tile's half) a warp. Called by every
// thread; ends with a barrier.
__device__ __forceinline__ void mark_live(const int* __restrict__ valid,
                                          int k, unsigned* live) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int words = ((k + BK - 1) / BK + 31) / 32;
  for (int w = threadIdx.x; w < words; w += THREADS) live[w] = 0u;
  __syncthreads();
  for (long long c0 = (long long)warp * 32; c0 < k; c0 += THREADS) {
    const long long cen = c0 + lane;
    if (__ballot_sync(0xffffffffu, cen < k && valid[cen] != 0) && lane == 0) {
      const int t = (int)(c0 / BK);
      atomicOr(live + t / 32, 1u << (t % 32));
    }
  }
  __syncthreads();
}

// The first center tile at or after `from` whose bit is set, or the tile
// count when there is none. Every thread computes the same answer.
__device__ __forceinline__ int next_live(const unsigned* live, int k,
                                         int from) {
  const int tiles = (k + BK - 1) / BK;
  for (int w = from / 32; w * 32 < tiles; ++w) {
    const unsigned bits =
        live[w] & (w == from / 32 ? ~0u << (from % 32) : ~0u);
    if (bits) return min(w * 32 + __ffs(bits) - 1, tiles);
  }
  return tiles;
}

// Folds in the exact candidate of a run of dead tiles starting at tile t:
// (FLT_MAX, t * BK). The run's later tiles give (FLT_MAX, a higher index),
// which can never win over it.
__device__ __forceinline__ void fold_dead(float (&best)[TM],
                                          int (&best_i)[TM], int t) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
    if (better(FLT_MAX, t * BK, best[i], best_i[i])) {
      best[i] = FLT_MAX;
      best_i[i] = t * BK;
    }
}

// The argmin of the BN rows from row0 over all k centers: writes
// labels[row], d2_out[row] and, when tile_labels is not null, the rows'
// labels to that shared array. sm is the block's dynamic shared memory
// (layout(RES, d)). Called by every thread of a block.
template <bool RES>
__device__ __forceinline__ void l2_argmin_tile(
    float* sm, const float* __restrict__ x, const float* __restrict__ c,
    const float* __restrict__ csq, const int* __restrict__ valid, int n,
    int k, int d, long long row0, int* __restrict__ labels,
    float* __restrict__ d2_out, int* tile_labels, bool vec) {
  const Layout L = layout(RES, d, k);
  float* xs = sm + L.xs;
  float* cs = sm + L.cs;
  float* xsq_s = sm + L.xsq;
  unsigned* live = reinterpret_cast<unsigned*>(sm + L.live);
  const int tid = threadIdx.x;
  const int tx = tid % LANES;           // centers tx + 8 j
  const int ty = tid / LANES;           // rows ty + 16 i
  const int warp = tid / 32, lane = tid % 32;
  const int chunks = (d + BD - 1) / BD;
  const int tiles = (k + BK - 1) / BK;
  const float* xb = x + row0 * d;
  __syncthreads();  // a previous call of this block is done with sm

  float best[TM];
  int best_i[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = INFINITY;
    best_i[i] = INT_MAX;
  }
  // ||x||^2 of the block's rows: one warp per row, lanes stride over d
  const auto row_norms = [&](const float* src, long long rs) {
    for (int r = warp; r < BN; r += THREADS / 32) {
      float s = 0.f;
      if (row0 + r < n) {
        const float* xr = src + r * rs;
        for (int j = lane; j < d; j += 32) s = fmaf(xr[j], xr[j], s);
      }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) xsq_s[r] = s;
    }
  };
  // the loads of stage (tile t, chunk ch) into buffer b; resident rows
  // come chunk by chunk with the first live tile's stages, so its first
  // chunk computes while the rest of the rows arrive
  mark_live(valid, k, live);
  const int first = next_live(live, k, 0);
  const auto issue = [&](int t, int ch, int b) {
    stage(cs + b * BK * LC, LC, c + (long long)t * BK * d,
          (long long)k - (long long)t * BK, BK, ch * BD, BD, d, vec);
    if (!RES)
      stage(xs + b * BN * LC, LC, xb, (long long)n - row0, BN, ch * BD, BD, d,
            vec);
    else if (t == first)
      stage(xs + ch * BD, L.lx, xb, (long long)n - row0, BN, ch * BD, BD, d,
            vec);
  };

  int t = first;
  if (t > 0) fold_dead(best, best_i, 0);
  if (!RES) row_norms(xb, d);
  if (t < tiles) {
    issue(t, 0, 0);
    cp_async_commit();
    float acc[TM][TN];
    for (int ch = 0, st = 0;; ++st) {
      int nt = t, nch = ch + 1;
      if (nch == chunks) {
        nch = 0;
        nt = next_live(live, k, t + 1);
        if (nt > t + 1) fold_dead(best, best_i, t + 1);
      }
      const bool more = nt < tiles;
      if (more) {
        issue(nt, nch, (st + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // stage st (and every earlier one) is in place
      if (RES && t == first && ch == chunks - 1) {
        row_norms(xs, L.lx);  // every chunk of the rows has arrived
        __syncthreads();
      }
      if (ch == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      }
      const float* xa = RES ? xs + ch * BD : xs + (st & 1) * BN * LC;
      const int lda = RES ? L.lx : LC;
      const float* ca = cs + (st & 1) * BK * LC;
      // unrolled twice: fully unrolled, the loop's code is eight times the
      // size and no faster on the card (tools/kernel_variants.py)
#pragma unroll 2
      for (int dd = 0; dd < BD; dd += 4) {
        float4 bv[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          bv[j] = *reinterpret_cast<const float4*>(ca + (tx + LANES * j) * LC +
                                                   dd);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(
              xa + (ty + ROWL * i) * lda + dd);
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[i][j] = fmaf(a.x, bv[j].x, acc[i][j]);
            acc[i][j] = fmaf(a.y, bv[j].y, acc[i][j]);
            acc[i][j] = fmaf(a.z, bv[j].z, acc[i][j]);
            acc[i][j] = fmaf(a.w, bv[j].w, acc[i][j]);
          }
        }
      }
      if (ch == chunks - 1) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int cen = t * BK + tx + LANES * j;
          if (cen < k) {
            const float cq = csq[cen];
            const bool ok = valid[cen] != 0;
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const float v =
                  ok ? xsq_s[ty + ROWL * i] - 2.f * acc[i][j] + cq
                     : FLT_MAX;
              if (better(v, cen, best[i], best_i[i])) {
                best[i] = v;
                best_i[i] = cen;
              }
            }
          }
        }
      }
      __syncthreads();  // every thread is done with buffer st & 1
      if (!more) break;
      t = nt;
      ch = nch;
    }
  }

  // the 8 threads of a row are 8 consecutive lanes of one warp
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float v = best[i];
    int bi = best_i[i];
    for (int o = LANES / 2; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, v, bi)) {
        v = ov;
        bi = oi;
      }
    }
    const int r = ty + ROWL * i;
    const long long row = row0 + r;
    if (tx == 0 && row < n) {
      labels[row] = bi;
      d2_out[row] = fmaxf(v, 0.f);
    }
    if (tx == 0 && tile_labels != nullptr) tile_labels[r] = bi;
  }
}

// The accumulating kernel calls the tile through this copy that is not
// inlined: ptxas then allocates the tile as it does in l2_argmin_kernel,
// where inlining it beside the accumulation made that kernel slower on the
// card (PERF.md, section 6).
template <bool RES>
__device__ __noinline__ void l2_argmin_tile_call(
    float* sm, const float* __restrict__ x, const float* __restrict__ c,
    const float* __restrict__ csq, const int* __restrict__ valid, int n,
    int k, int d, long long row0, int* __restrict__ labels,
    float* __restrict__ d2_out, int* tile_labels, bool vec) {
  l2_argmin_tile<RES>(sm, x, c, csq, valid, n, k, d, row0, labels, d2_out,
                      tile_labels, vec);
}

template <bool RES>
__global__ void __launch_bounds__(THREADS, 2)
l2_argmin_kernel(const float* __restrict__ x, const float* __restrict__ c,
                 const float* __restrict__ csq, const int* __restrict__ valid,
                 int n, int k, int d, int* __restrict__ labels,
                 float* __restrict__ d2_out, int vec) {
  extern __shared__ __align__(16) float smem[];
  l2_argmin_tile<RES>(smem, x, c, csq, valid, n, k, d,
                      (long long)blockIdx.x * BN, labels, d2_out, nullptr,
                      vec != 0);
}

// The head-batched entry: grid (row tiles, heads). Head h's rows, centers,
// ||c||^2, validity flags, labels and d2 are the h-th (n, d), (k, d), (k,),
// (k,), (n,) and (n,) slices of stacked arrays; each block runs the same
// tile routine as l2_argmin_kernel on its head's slices, so every head's
// labels and d2 are the bits of one l2_argmin_kernel launch on that head
// (first-index ties included: they never cross a head).
template <bool RES>
__global__ void __launch_bounds__(THREADS, 2)
l2_argmin_heads_kernel(const float* __restrict__ x,
                       const float* __restrict__ c,
                       const float* __restrict__ csq,
                       const int* __restrict__ valid, int n, int k, int d,
                       int* __restrict__ labels, float* __restrict__ d2_out,
                       int vec) {
  extern __shared__ __align__(16) float smem[];
  const long long h = blockIdx.y;
  l2_argmin_tile<RES>(smem, x + h * n * d, c + h * k * d, csq + h * k,
                      valid + h * k, n, k, d, (long long)blockIdx.x * BN,
                      labels + h * n, d2_out + h * n, nullptr, vec != 0);
}

constexpr int WARPS = THREADS / 32;
constexpr int GB = 8;                   // groups whose slot values load at once
static_assert(BN == THREADS, "the accumulation ranks one row a thread");

// The sum of v over the block. Called by every thread.
__device__ __forceinline__ int block_sum(int v, int* red) {
  const int warp = threadIdx.x / 32;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  __syncthreads();  // red may be written again
  return s;
}

// cmap[j] = j's index among the live clusters (the valid centers and the
// first invalid one) in index order, -1 for the rest; returns how many are
// valid. Called by every thread; ends with a barrier.
__device__ int live_map(const int* __restrict__ valid, int k, int* cmap,
                        int* red) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int first = k;  // this thread's first invalid center; then the block's
  for (int j = tid; j < k; j += THREADS)
    if (valid[j] == 0) {
      first = j;
      break;
    }
  for (int o = 16; o > 0; o >>= 1)
    first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
  if (lane == 0) red[warp] = first;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) first = min(first, red[w]);
  __syncthreads();
  int base = 0, nvalid = 0;
  for (int j0 = 0; j0 < k; j0 += THREADS) {
    const int j = j0 + tid;
    const bool ok = j < k && valid[j] != 0;
    const bool live = ok || (j < k && j == first);
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (lane == 0) red[warp] = __popc(m);
    __syncthreads();
    int at = base + __popc(m & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) at += red[w];
    for (int w = 0; w < WARPS; ++w) base += red[w];
    if (j < k) cmap[j] = live ? at : -1;
    __syncthreads();
    nvalid += ok;
  }
  return block_sum(nvalid, red);
}

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Adds a tile's groups into the slot ps (live, d): group g is the sorted
// rows gstart[g] .. gend[g] - 1 (srow: row of the tile), all of cluster
// gkey[g]; row r is src[r * rs ...]. T is float or float4: a thread takes
// T's columns, the d / |T| column vectors are spread over `per` threads,
// and the THREADS / per such lanes take every lanes-th group. Each (group,
// column) is one chain from the slot's value through the rows in row
// order; the slot values of GB groups load at once. Called by every
// thread.
template <typename T>
__device__ __forceinline__ void add_groups(
    const float* src, long long rs, float* ps, int d, int ng,
    const int* gkey, const int* gstart, const int* gend, const int* srow) {
  const int q = d / (int)(sizeof(T) / sizeof(float));
  const int per = q < THREADS ? q : THREADS;
  const int lanes = THREADS / per;
  const int glane = threadIdx.x / per;
  if (glane >= lanes) return;
  for (int cv = threadIdx.x % per; cv < q; cv += per)
    for (int g0 = glane; g0 < ng; g0 += lanes * GB) {
      T acc[GB];
#pragma unroll
      for (int b = 0; b < GB; ++b) {
        const int gb = g0 + b * lanes;
        if (gb < ng)
          acc[b] = reinterpret_cast<const T*>(ps + (size_t)gkey[gb] * d)[cv];
      }
#pragma unroll
      for (int b = 0; b < GB; ++b) {
        const int gb = g0 + b * lanes;
        if (gb < ng) {
          for (int i = gstart[gb]; i < gend[gb]; ++i)
            add_to(acc[b], reinterpret_cast<const T*>(src + srow[i] * rs)[cv]);
          reinterpret_cast<T*>(ps + (size_t)gkey[gb] * d)[cv] = acc[b];
        }
      }
    }
}

// One block per slot: map the labels to the live clusters, zero the
// slot's (live, d) sums and (live,) counts, then for each of its row
// tiles (grid stride) the tile's argmin, its rows grouped by label in row
// order, and each group added into the slot.
template <bool RES>
__global__ void __launch_bounds__(THREADS, 2)
l2_argmin_acc_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     const float* __restrict__ csq,
                     const int* __restrict__ valid, int n, int k, int d,
                     int live, int* __restrict__ labels,
                     float* __restrict__ d2_out,
                     float* __restrict__ slot_sums,
                     float* __restrict__ slot_cnt, int* __restrict__ cmap_out,
                     int vec, int vsums) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int tile_lab[BN], key_in[BN], skey[BN], srow[BN];
  __shared__ int gstart[BN], gend[BN], gkey[BN], red[WARPS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Layout Lt = layout(RES, d, k);
  int* cmap = reinterpret_cast<int*>(smem + Lt.words);
  const bool any_valid = live_map(valid, k, cmap, red) > 0;
  if (blockIdx.x == 0)
    for (int j = tid; j < k; j += THREADS) cmap_out[j] = cmap[j];
  float* ps = slot_sums + (size_t)blockIdx.x * live * d;
  float* pc = slot_cnt + (size_t)blockIdx.x * live;
  for (long long e = tid; e < (long long)live * d; e += THREADS) ps[e] = 0.f;
  for (int e = tid; e < live; e += THREADS) pc[e] = 0.f;
  // rows resident in shared memory once a live tile has staged them
  const bool from_smem = RES && any_valid;
  const float* xs = smem + Lt.xs;
  // four columns a thread when the rows and the slot are 16-byte aligned
  const bool quads = d % 4 == 0 && vsums != 0 && (from_smem || vec != 0);
  const long long tiles = ((long long)n + BN - 1) / BN;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * BN;
    // begins with a barrier: the zeroing and the last tile's adds are done
    l2_argmin_tile_call<RES>(smem, x, c, csq, valid, n, k, d, row0, labels,
                             d2_out, tile_lab, vec != 0);
    __syncthreads();  // tile_lab is complete
    const int rows = (int)min((long long)BN, (long long)n - row0);
    // a row's key: its live cluster, INT_MAX past the end (and for a label
    // that is no live cluster, which only a NaN distance leaves: INT_MAX)
    const int lab = tile_lab[tid];
    const int key = tid < rows && lab >= 0 && lab < k && cmap[lab] >= 0
                        ? cmap[lab] : INT_MAX;
    key_in[tid] = key;
    __syncthreads();
    int rank = 0;  // stable: equal keys keep their row order
#pragma unroll 8
    for (int q = 0; q < BN; ++q) {
      const int kq = key_in[q];
      rank += (kq < key) | ((kq == key) & (q < tid));
    }
    skey[rank] = key;
    srow[rank] = tid;
    __syncthreads();
    // groups: runs of one key among the sorted rows, numbered in order
    const int sk = skey[tid];
    const bool in = sk != INT_MAX;
    const bool head = in && (tid == 0 || skey[tid - 1] != sk);
    const bool tail = in && (tid == BN - 1 || skey[tid + 1] != sk);
    const unsigned hm = __ballot_sync(0xffffffffu, head);
    if (lane == 0) red[warp] = __popc(hm);
    __syncthreads();
    int g = __popc(hm & ((2u << lane) - 1u)) - 1;  // inclusive prefix - 1
    int ng = 0;
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) g += red[w];
      ng += red[w];
    }
    if (head) {
      gstart[g] = tid;
      gkey[g] = sk;
    }
    if (tail) gend[g] = tid + 1;
    __syncthreads();
    for (int gi = tid; gi < ng; gi += THREADS)
      pc[gkey[gi]] += (float)(gend[gi] - gstart[gi]);  // exact integers
    const float* src = from_smem ? xs : x + row0 * d;
    const long long rs = from_smem ? Lt.lx : d;
    if (quads)
      add_groups<float4>(src, rs, ps, d, ng, gkey, gstart, gend, srow);
    else
      add_groups<float>(src, rs, ps, d, ng, gkey, gstart, gend, srow);
  }
}

// out[e] for e = j * d + col over the k clusters: the sum over slots s =
// 0, 1, ... of part[(s * live + cmap[j]) * d + col], in slot order; 0 for
// a cluster that is not live.
__global__ void sum_slots_kernel(const float* __restrict__ part, int slots,
                                 const int* __restrict__ cmap, int k, int live,
                                 int d, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)k * d) return;
  const int j = (int)(e / d), col = (int)(e % d);
  const int cj = cmap[j];
  float s = 0.f;
  if (cj >= 0)
    for (int g = 0; g < slots; ++g)
      s += part[((size_t)g * live + cj) * d + col];
  out[e] = s;
}

// The decode step's absorb, one warp a head (blockIdx.x). Every pointer
// but the fresh rows is the layer's stacked state, head h's slice at
// h * k (* d); it is read and the hit rows written in place.
__device__ __forceinline__ float fresh(const void* p, long long i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(32)
l2_absorb_heads_kernel(const void* __restrict__ keys, long long k_stride,
                       const void* __restrict__ values, long long v_stride,
                       int bf16, float* centers, float* v_cent,
                       float* __restrict__ radius,
                       float* __restrict__ v_radius, float* __restrict__ mass,
                       const unsigned char* __restrict__ valid,
                       const float* __restrict__ csq, float* __restrict__ v_max,
                       const float* __restrict__ decay_p, int k, int d,
                       int vec, int* __restrict__ labels,
                       float* __restrict__ d2_out) {
  extern __shared__ __align__(16) float xv[];  // the key row, the value row
  float* xs = xv;
  float* vs = xv + d;
  const int lane = threadIdx.x;
  const long long h = blockIdx.x, hk = h * k;
  const float* cbase = centers + hk * d;
  for (int j = lane; j < d; j += 32) {
    xs[j] = fresh(keys, h * k_stride + j, bf16 != 0);
    vs[j] = fresh(values, h * v_stride + j, bf16 != 0);
  }
  __syncwarp();
  // ||x||^2 as l2_argmin_tile's row_norms: lanes stride over d, then a
  // butterfly (every lane ends with the same sum)
  float xsq = 0.f;
  for (int j = lane; j < d; j += 32) xsq = fmaf(xs[j], xs[j], xsq);
  for (int o = 16; o > 0; o >>= 1) xsq += __shfl_xor_sync(0xffffffffu, xsq, o);

  float best = INFINITY;
  int best_i = INT_MAX;
  for (int cen = lane; cen < k; cen += 32) {
    float v = FLT_MAX;  // a dead center's candidate, taken without a load
    if (valid[hk + cen]) {
      const float* cr = cbase + (long long)cen * d;
      float acc = 0.f;  // one fmaf chain in d order, as the tile's dot
      int t = 0;
      if (vec)
        for (; t + 64 <= d; t += 64) {
          float4 r[16];
#pragma unroll
          for (int q = 0; q < 16; ++q)
            r[q] = *reinterpret_cast<const float4*>(cr + t + 4 * q);
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            acc = fmaf(xs[t + 4 * q], r[q].x, acc);
            acc = fmaf(xs[t + 4 * q + 1], r[q].y, acc);
            acc = fmaf(xs[t + 4 * q + 2], r[q].z, acc);
            acc = fmaf(xs[t + 4 * q + 3], r[q].w, acc);
          }
        }
#pragma unroll 8
      for (; t < d; ++t) acc = fmaf(xs[t], cr[t], acc);
      v = xsq - 2.f * acc + csq[hk + cen];
    }
    if (better(v, cen, best, best_i)) {
      best = v;
      best_i = cen;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    if (better(ov, oi, best, best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  const int lab = best_i;
  if (lane == 0) {
    labels[h] = lab;
    d2_out[h] = fmaxf(best, 0.f);
  }
  if (lab < 0 || lab >= k) return;  // only NaN distances leave no label

  // the plain EMA of one routed row (m = 1): mean = 0 + x (index_add_ into
  // zeros, / 1), c' = c * decay + (1 - decay) * mean, one rounding an op
  const float decay = *decay_p;
  const float keep = __fsub_rn(1.f, decay);
  float* cr = centers + (hk + lab) * d;
  float* vr = v_cent + (hk + lab) * d;
  float drift_k = 0.f, drift_v = 0.f, far_k = 0.f, far_v = 0.f, vn = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float co = cr[j], vo = vr[j], xj = xs[j], yj = vs[j];
    const float cn = __fadd_rn(__fmul_rn(co, decay),
                               __fmul_rn(keep, __fadd_rn(0.f, xj)));
    const float wn = __fadd_rn(__fmul_rn(vo, decay),
                               __fmul_rn(keep, __fadd_rn(0.f, yj)));
    cr[j] = cn;
    vr[j] = wn;
    const float a = __fsub_rn(cn, co), b = __fsub_rn(wn, vo);
    const float e = __fsub_rn(xj, cn), f = __fsub_rn(yj, wn);
    drift_k = fmaf(a, a, drift_k);
    drift_v = fmaf(b, b, drift_v);
    far_k = fmaf(e, e, far_k);
    far_v = fmaf(f, f, far_v);
    vn = fmaf(yj, yj, vn);
  }
  for (int o = 16; o > 0; o >>= 1) {
    drift_k += __shfl_xor_sync(0xffffffffu, drift_k, o);
    drift_v += __shfl_xor_sync(0xffffffffu, drift_v, o);
    far_k += __shfl_xor_sync(0xffffffffu, far_k, o);
    far_v += __shfl_xor_sync(0xffffffffu, far_v, o);
    vn += __shfl_xor_sync(0xffffffffu, vn, o);
  }
  if (lane == 0) {
    // radii: max(radius + drift, the row's distance to the new centroid);
    // the norms' summation order is this kernel's own
    const long long i = hk + lab;
    radius[i] = fmaxf(__fadd_rn(radius[i], sqrtf(drift_k)), sqrtf(far_k));
    v_radius[i] = fmaxf(__fadd_rn(v_radius[i], sqrtf(drift_v)),
                        sqrtf(far_v));
    mass[i] = __fadd_rn(mass[i], 1.f);
    v_max[h] = fmaxf(v_max[h], sqrtf(vn));
  }
}

// Resident rows up to RES_MAX_D; 16-byte copies when every row and center
// starts 16-byte aligned. Sets the kernel's shared-memory limit (the tile
// routine's layout and `extra` words after it); returns its bytes through
// *bytes.
template <typename Kernel>
cudaError_t prepare(Kernel kern, bool res, int d, int k, size_t* bytes,
                    int extra = 0) {
  *bytes = ((size_t)layout(res, d, k).words + extra) * sizeof(float);
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

bool aligned(const float* x, const float* c, int d) {
  return d % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)c % 16 == 0;
}

}  // namespace

// x (n, d), c (k, d), csq (k,) float32; valid (k,) int32; all contiguous
// on `device`. Writes labels (n,) int32 and d2 (n,) float32. Launches on
// `stream` and returns the first CUDA error, 0 on success.
extern "C" int repro_l2_argmin_f32(const float* x, const float* c,
                                   const float* csq, const int* valid, int n,
                                   int k, int d, int* labels, float* d2,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool res = d <= RES_MAX_D;
  const auto kern = res ? l2_argmin_kernel<true> : l2_argmin_kernel<false>;
  size_t bytes;
  if ((err = prepare(kern, res, d, k, &bytes)) != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + BN - 1) / BN);
  kern<<<blocks, THREADS, bytes, (cudaStream_t)stream>>>(
      x, c, csq, valid, n, k, d, labels, d2, aligned(x, c, d) ? 1 : 0);
  return (int)cudaGetLastError();
}

// The head-batched variant: x (heads, n, d), c (heads, k, d), csq (heads,
// k) float32; valid (heads, k) int32; labels and d2 (heads, n); all
// contiguous. One launch for every head. Returns a CUDA error code.
extern "C" int repro_l2_argmin_heads_f32(const float* x, const float* c,
                                         const float* csq, const int* valid,
                                         int heads, int n, int k, int d,
                                         int* labels, float* d2, int device,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (heads > 65535) return (int)cudaErrorInvalidValue;
  const bool res = d <= RES_MAX_D;
  const auto kern =
      res ? l2_argmin_heads_kernel<true> : l2_argmin_heads_kernel<false>;
  size_t bytes;
  if ((err = prepare(kern, res, d, k, &bytes)) != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)heads);
  // with d % 4 == 0 every head's slice starts 16-byte aligned too
  kern<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      x, c, csq, valid, n, k, d, labels, d2, aligned(x, c, d) ? 1 : 0);
  return (int)cudaGetLastError();
}

// The accumulating variant: as repro_l2_argmin_f32, plus sums (k, d) and
// cnt (k,) float32. live is the number of live clusters (the valid
// centers, plus 1 when one is invalid); slot_sums (slots, live, d),
// slot_cnt (slots, live) and cmap (k,) int32 are the caller's scratch;
// slots is the grid (at most the row tiles). Three launches on `stream`;
// returns the first cudaGetLastError() that is not 0.
extern "C" int repro_l2_argmin_acc_f32(const float* x, const float* c,
                                       const float* csq, const int* valid,
                                       int n, int k, int d, int live,
                                       int* labels, float* d2,
                                       float* slot_sums, float* slot_cnt,
                                       int* cmap, int slots, float* sums,
                                       float* cnt, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (live < 1 || live > k) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool res = d <= RES_MAX_D;
  const auto kern =
      res ? l2_argmin_acc_kernel<true> : l2_argmin_acc_kernel<false>;
  size_t bytes;  // the label map (k ints) after the tile routine's layout
  if ((err = prepare(kern, res, d, k, &bytes, k)) != cudaSuccess)
    return (int)err;
  kern<<<slots, THREADS, bytes, st>>>(
      x, c, csq, valid, n, k, d, live, labels, d2, slot_sums, slot_cnt, cmap,
      aligned(x, c, d) ? 1 : 0,
      d % 4 == 0 && (uintptr_t)slot_sums % 16 == 0 ? 1 : 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long m = (long long)k * d;
  sum_slots_kernel<<<(unsigned)((m + 255) / 256), 256, 0, st>>>(
      slot_sums, slots, cmap, k, live, d, sums);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_slots_kernel<<<(unsigned)((k + 255) / 256), 256, 0, st>>>(
      slot_cnt, slots, cmap, k, live, 1, cnt);
  return (int)cudaGetLastError();
}

// The decode step's absorb of one layer: keys and values (heads, 1, d),
// float32 or bf16 (bf16 != 0), head h's row at h * k_stride / v_stride
// elements, each row contiguous; the state in place: centers and v_cent
// (heads, k, d), radius, v_radius, mass and csq (heads, k) float32,
// valid (heads, k) bool, v_max (heads,) float32, decay (1,)
// float32 the EMA's factor (1 - ema)^1. Writes labels (heads,) int32 and
// d2 (heads,) float32, and the hit rows. One launch; returns a CUDA error
// code.
extern "C" int repro_l2_absorb_heads_f32(
    const void* keys, long long k_stride, const void* values,
    long long v_stride, int bf16, float* centers, float* v_cent,
    float* radius, float* v_radius, float* mass, const unsigned char* valid,
    const float* csq, float* v_max, const float* decay, int heads, int k,
    int d, int* labels, float* d2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = 2 * (size_t)d * sizeof(float);
  if (heads < 1 || k < 1 || d < 1 || bytes > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const int vec = d % 4 == 0 && (uintptr_t)centers % 16 == 0 ? 1 : 0;
  l2_absorb_heads_kernel<<<heads, 32, bytes, (cudaStream_t)stream>>>(
      keys, k_stride, values, v_stride, bf16, centers, v_cent, radius,
      v_radius, mass, valid, csq, v_max, decay, k, d, vec, labels, d2);
  return (int)cudaGetLastError();
}
