// Exact k nearest neighbours (squared Euclidean, self excluded) with a
// running per-row top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernel graphmine_tpu/pallas_kernels/knn_pallas.py
// (knn_pallas, body _knn_kernel): a sequential grid of [TM, TC] distance
// tiles, each folded into a per-row top-k by k rounds of min-extraction.
// That fold costs O(k) vector work per candidate and does not carry over.
//
// The contract: every distance is bit-equal to the plain PyTorch version
// (graphmine_tpu_torch/ops/knn.py::_tiled_knn), so the two return equal
// indices even where distances tie (LOF's features are full of duplicate
// rows). Each distance is 2F+3 float32 operations in the plain version's
// order, each rounded on its own (__fmul_rn/__fadd_rn, --fmad=false):
// F products and F-1 sums for the cross term, the doubling, the two norm
// terms and the clamp. That rules out the tensor cores (TF32 rounds the
// inputs; even 3xTF32 does not give these bits, and a filter on them needs
// error margins, a candidate list and an exact second pass) and FMA.
//
// What bounds it: the FP32 instruction rate. Without FMA every operation is
// one instruction, so one H100 (132 SMs x 4 schedulers x 32 lanes, one
// warp instruction per scheduler per clock, ~33.5 T lane-instructions/s,
// half the 67 TFLOP/s peak that counts an FMA as two) needs at least
// 19 x N(N-1) / 33.5e12 = 38.98 ms at N = 262,144, F = 8: the floor of
// this arithmetic, twice chip_smoke.py's operations bound. Everything the
// kernel executes beyond those 19 instructions per pair (loads, checks,
// votes, top-k insertions) is time above the floor.
//
// Design (F <= 8 features, k <= 128):
// 1. A prologue kernel (pack_kernel) computes every point's squared norm
//    once, in _sq_norms' order, and writes the points tile by tile as
//    [f0..f3 x T][f4..f7 x T][norm x T], zero-padded to 8 features and to
//    a whole tile. Zero features add exact zeros; padded points get an
//    infinite norm, so their distance is +inf and never passes a
//    threshold. The main kernel recomputes no norm and reads no strided
//    row.
// 2. A ring of kStages tiles in dynamic shared memory, each filled by one
//    TMA bulk copy that completes the stage's mbarrier. While the warps
//    compute on one tile the next ones are in flight. Each warp waits on
//    the barrier of the stage it reads and releases the stage when done;
//    the last warp to release it starts the copy of the tile kStages
//    ahead into it. No warp waits on another except through a stage, so
//    warps may drift apart by up to kStages-1 tiles. That drift is what
//    the ring buys: two buffers with one __syncthreads a tile (filled by
//    cp.async or through registers) cost 12-15 ms more at the main
//    path's shape, since each tile then waits for the warp with the most
//    merges.
// 3. A block of kWarps warps owns kWarps*kRowsPerWarp query rows (96), 6
//    per warp, held in registers. Each lane takes one reference point per
//    step (two 16-byte and one 4-byte shared load, made a step ahead)
//    and computes its distance to the warp's rows, feature by feature
//    across the rows so that 6 independent sums are in flight: the loads
//    cost half an instruction per pair, and every block streams all N
//    points once for 96 rows. Six rows and 16 warps (124 registers, four
//    warps per scheduler) beat eight rows and 12 warps: the rare path
//    below is a chain of warp votes, shuffles and shared-memory round
//    trips, and more warps hide its latency.
// 4. The inner loop has no bounds or diagonal check. Padded points fail the
//    threshold by their infinite distance; the self pair (distance exactly
//    0, since the cross term repeats the norm's sum) passes it and is
//    dropped on the rare path, like padded query rows (threshold -inf).
//    The test is !(d2 >= threshold) on the unclamped distance: it lets
//    through every pair whose clamped distance is below the threshold (and
//    NaN, which the clamp maps to 0), and the rare path clamps and checks
//    again. One vote per step covers the warp's rows.
// 5. Each row keeps its top-k as kMaxK sorted keys in shared memory, a key
//    being the distance's bits over the column index (the plain version's
//    selection key, so ties go to the smaller index whatever the arrival
//    order), and a threshold in a register: the k-th key's distance. A
//    candidate below it is appended to the row's buffer of kBuf keys (one
//    ballot and one store for all the lanes of a step); a full buffer is
//    merged into the top-k by the warp at once (merge_buffer) and the
//    threshold drops. Between merges the threshold is stale, which only
//    lets more candidates into the buffer: a point it rejects has a larger
//    distance than k points already seen, or the same distance and a
//    larger index, so it is not among the k nearest.
//
// The general instance (any F >= 1, any 0 < k < N): the fast instance's
// shared memory and registers are sized for F <= 8 and k <= 128 (a ring of
// 4 x 18 KB tiles beside 96 rows x 160 keys is 197 KB of the 227 KB a block
// may have; kMaxK/32 keys a lane in registers while merging). The general
// instance keeps the contract (the same 2F+3 operations in the same order,
// keys of distance bits over index, ties to the smaller index, the self
// pair dropped on the rare path) and only has to be right:
// - A prologue (pack_general_kernel) computes the norms in _sq_norms' order
//   and copies the points into rows of F rounded up to 8, zero-padded. The
//   cross term runs over those 8-feature chunks, carrying the sum across
//   chunks in feature order; the padding adds exact zeros.
// - No ring: each lane reads its reference point's chunk and the warp's
//   query rows' chunk (one address for the warp, a broadcast) straight
//   from the packed copy, through L1 and L2; there is no tile padding, so
//   points past N are masked by `valid`.
// - 16 warps of R query rows (R = 6, 3 or 1, a template parameter). Each
//   row keeps kcap = k rounded up to 32 sorted keys: in shared memory while
//   16 R (kcap + 32) keys fit in 227 KB, else in device scratch that the
//   wrapper allocates (one row a warp). The wrapper picks R and the place
//   (kernels/knn_cuda.py::launch_plan) and passes them here.
// - merge_general walks the sorted keys in chunks of 32 from the top down
//   (every key moves up, so no chunk overwrites one not yet read), where
//   merge_buffer holds all kMaxK keys in registers.
//
// C interface (bound with ctypes): knn_topk_scratch_bytes gives the size
// of the packed copy the caller allocates; knn_topk_f32 launches the fast
// instance's prologue and main kernel on the given stream, and
// knn_general_f32 the general instance's; both return the first launch
// error (cudaGetLastError()), 0 if none. knn_general_smem_bytes gives the
// general kernel's dynamic shared memory for a plan.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kFeatPad = 8;
constexpr int kTile = 512;  // reference points per stage
constexpr int kStages = 4;
constexpr int kWarps = 16;
constexpr int kRowsPerWarp = 6;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kThreads = kWarps * 32;
constexpr int kTileFloats = kTile * (kFeatPad + 1);
constexpr unsigned kTileBytes = kTileFloats * sizeof(float);
constexpr int kMaxK = 128;  // top-k keys kept per row
constexpr int kKeysPerLane = kMaxK / 32;
constexpr int kBuf = 32;  // candidates buffered per row between merges
static_assert(kBuf == 32, "a merge sorts one key a lane, and one step may append 32");
// A key packs a distance's bits (monotone for distances >= 0) over its
// column index; the sentinel is (+inf, 0xffffffff), above every candidate.
constexpr uint64_t kSentinelKey = (uint64_t(0x7f800000u) << 32) | 0xffffffffu;
constexpr size_t kSmemBytes = size_t(kStages) * kTileBytes +
                              size_t(kRowsPerBlock) * (kMaxK + kBuf) * sizeof(uint64_t) +
                              kStages * (sizeof(uint64_t) + sizeof(unsigned));
constexpr unsigned kFull = 0xffffffffu;

int num_tiles(int n) { return (n + kTile - 1) / kTile; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One TMA bulk copy of a tile (kTileBytes contiguous bytes) into a stage;
// the copy's arrival completes the stage's full barrier.
__device__ __forceinline__ void load_tile(float* dst, const float* src, uint64_t* full) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(full)),
               "r"(kTileBytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(kTileBytes), "r"(smem_addr(full))
      : "memory");
}

// Packs the points tile by tile (see the note at the top) with their norms.
__global__ void pack_kernel(const float* __restrict__ pts, int n, int f, int n_pad,
                            float* __restrict__ tiles) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_pad) return;
  float x[kFeatPad];
#pragma unroll
  for (int c = 0; c < kFeatPad; ++c) x[c] = (j < n && c < f) ? pts[(size_t)j * f + c] : 0.f;
  float s = __fmul_rn(x[0], x[0]);
#pragma unroll
  for (int c = 1; c < kFeatPad; ++c) {
    if (c < f) s = __fadd_rn(s, __fmul_rn(x[c], x[c]));
  }
  if (j >= n) s = __int_as_float(0x7f800000);
  float* tile = tiles + (size_t)(j / kTile) * kTileFloats;
  const int t = j % kTile;
  reinterpret_cast<float4*>(tile)[t] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(tile + 4 * kTile)[t] = make_float4(x[4], x[5], x[6], x[7]);
  tile[8 * kTile + t] = s;
}

// Folds a row's candidate buffer (cnt <= kBuf keys, in no order) into its
// sorted top-k keys and returns the new threshold, the k-th key's
// distance. The warp sorts the buffer (bitonic, one key a lane), finds each
// candidate's rank among the top-k keys (binary search) and, for each top-k
// key, the number of smaller candidates (binary search over those ranks,
// which ascend over the lanes), then writes every key to its merged place.
// Keys are distinct, so the merged order is total.
__device__ __forceinline__ float merge_buffer(uint64_t* topk, const uint64_t* buf, int cnt, int k,
                                              int lane) {
  __syncwarp();
  uint64_t b = lane < cnt ? buf[lane] : kSentinelKey;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint64_t o = __shfl_xor_sync(kFull, b, stride);
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
      b = (o < b) == keep_min ? o : b;
    }
  }
  // A candidate passed d2 < threshold, the k-th key's distance, so fewer
  // than k <= kMaxK keys are below it.
  int rank = 0;
#pragma unroll
  for (int step = kMaxK / 2; step >= 1; step >>= 1) {
    if (topk[rank + step - 1] < b) rank += step;
  }
  const int rank_or_max = lane < cnt ? rank : kMaxK;
  const int last = __shfl_sync(kFull, rank_or_max, 31);
  uint64_t key[kKeysPerLane];
  int dest[kKeysPerLane];
#pragma unroll
  for (int s = 0; s < kKeysPerLane; ++s) {
    const int p = lane * kKeysPerLane + s;
    key[s] = topk[p];
    int below = 0;  // candidates smaller than key p: those of rank <= p
#pragma unroll
    for (int step = 16; step >= 1; step >>= 1) {
      if (__shfl_sync(kFull, rank_or_max, below + step - 1) <= p) below += step;
    }
    dest[s] = p + (last <= p ? 32 : below);
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kKeysPerLane; ++s) {
    if (dest[s] < kMaxK) topk[dest[s]] = key[s];
  }
  if (lane < cnt && lane + rank < kMaxK) topk[lane + rank] = b;
  __syncwarp();
  return __uint_as_float(static_cast<uint32_t>(topk[k - 1] >> 32));
}

__global__ void __launch_bounds__(kThreads, 1)
knn_topk_kernel(const float* __restrict__ pts, const float* __restrict__ tiles, int n, int f,
                int k, int n_tiles, float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* topk_keys = reinterpret_cast<uint64_t*>(smem + size_t(kStages) * kTileBytes);
  uint64_t* buf_keys = topk_keys + kRowsPerBlock * kMaxK;
  uint64_t* full = buf_keys + kRowsPerBlock * kBuf;
  unsigned* released = reinterpret_cast<unsigned*>(full + kStages);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int t = 0; t < kStages && t < n_tiles; ++t) {
      load_tile(ring + t * kTileFloats, tiles + (size_t)t * kTileFloats, &full[t]);
    }
  }
  __syncthreads();

  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  uint64_t* my_topk = topk_keys + warp * kRowsPerWarp * kMaxK;
  uint64_t* my_buf = buf_keys + warp * kRowsPerWarp * kBuf;
  for (int i = lane; i < kRowsPerWarp * kMaxK; i += 32) my_topk[i] = kSentinelKey;
  __syncwarp();

  const float inf = __int_as_float(0x7f800000);
  const unsigned lanes_below = (1u << lane) - 1;
  float q[kRowsPerWarp][kFeatPad];
  float q_sq[kRowsPerWarp];
  float thr[kRowsPerWarp];
  int cnt[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    const bool real = row < n;
#pragma unroll
    for (int c = 0; c < kFeatPad; ++c) q[r][c] = (real && c < f) ? pts[(size_t)row * f + c] : 0.f;
    // The prologue's norm; a padded row gets 0 and a threshold of -inf,
    // so its distances are finite and never pass.
    q_sq[r] = real ? tiles[(size_t)(row / kTile) * kTileFloats + 8 * kTile + row % kTile] : 0.f;
    thr[r] = real ? inf : -inf;
    cnt[r] = 0;
  }

  for (int t = 0, s = 0, phase = 0; t < n_tiles; ++t) {
    mbar_wait(&full[s], phase);
    const float4* fa = reinterpret_cast<const float4*>(ring + s * kTileFloats);
    const float4* fb = fa + kTile;
    const float* fn = reinterpret_cast<const float*>(fb + kTile);
    const int base = t * kTile;
    float4 a = fa[lane];
    float4 b = fb[lane];
    float c_sq = fn[lane];
    for (int t0 = 0; t0 < kTile; t0 += 32) {
      // The next step's point, loaded while this one computes (the last
      // step of a tile reloads the tile's first point, unused).
      const int next = (t0 + 32) % kTile + lane;
      const float4 a_next = fa[next];
      const float4 b_next = fb[next];
      const float c_sq_next = fn[next];
      const float x[kFeatPad] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      float d2[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) d2[r] = __fmul_rn(q[r][0], x[0]);
#pragma unroll
      for (int c = 1; c < kFeatPad; ++c) {
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) d2[r] = __fadd_rn(d2[r], __fmul_rn(q[r][c], x[c]));
      }
      bool hit = false;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        d2[r] = __fadd_rn(__fsub_rn(q_sq[r], __fmul_rn(2.f, d2[r])), c_sq);
        hit |= !(d2[r] >= thr[r]);
      }
      if (__any_sync(kFull, hit)) {
        const int j = base + t0 + lane;
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float nd = d2[r] > 0.f ? d2[r] : 0.f;  // the plain version's clamp
          bool pass = nd < thr[r] && j != row0 + r;
          unsigned mask = __ballot_sync(kFull, pass);
          if (!mask) continue;
          uint64_t* row_buf = my_buf + r * kBuf;
          if (cnt[r] + __popc(mask) > kBuf) {
            thr[r] = merge_buffer(my_topk + r * kMaxK, row_buf, cnt[r], k, lane);
            cnt[r] = 0;
            pass = pass && nd < thr[r];
            mask = __ballot_sync(kFull, pass);
          }
          if (pass) {
            row_buf[cnt[r] + __popc(mask & lanes_below)] =
                (uint64_t(__float_as_uint(nd)) << 32) | uint32_t(j);
          }
          cnt[r] += __popc(mask);
        }
      }
      a = a_next;
      b = b_next;
      c_sq = c_sq_next;
    }
    // Release the stage; the last warp to release it refills it with the
    // tile kStages ahead.
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&released[s], 1u) % kWarps == kWarps - 1 && t + kStages < n_tiles) {
        __threadfence_block();
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        load_tile(ring + s * kTileFloats, tiles + (size_t)(t + kStages) * kTileFloats, &full[s]);
      }
    }
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= n) continue;
    uint64_t* row_topk = my_topk + r * kMaxK;
    if (cnt[r] > 0) merge_buffer(row_topk, my_buf + r * kBuf, cnt[r], k, lane);
    for (int p = lane; p < k; p += 32) {
      const uint64_t key = row_topk[p];
      out_d[(size_t)row * k + p] = __uint_as_float(static_cast<uint32_t>(key >> 32));
      out_i[(size_t)row * k + p] = static_cast<int>(static_cast<uint32_t>(key));
    }
  }
}

// ---- the general instance (see the note at the top) ----------------------

constexpr int kGenWarps = 16;
constexpr int kGenThreads = kGenWarps * 32;
constexpr int kChunk = 8;  // features per step of the cross-term sum

size_t general_smem_bytes(int rows_per_warp, int kcap, bool global_topk) {
  return size_t(kGenWarps) * rows_per_warp * (kBuf + (global_topk ? 0 : kcap)) *
         sizeof(uint64_t);
}

// Norms in _sq_norms' order and the points copied into rows of fpad
// (F rounded up to 8) floats, zero-padded.
__global__ void pack_general_kernel(const float* __restrict__ pts, int n, int f, int fpad,
                                    float* __restrict__ packed, float* __restrict__ norms) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const float* p = pts + (size_t)j * f;
  float* out = packed + (size_t)j * fpad;
  float s = __fmul_rn(p[0], p[0]);
  out[0] = p[0];
  for (int c = 1; c < f; ++c) {
    const float x = p[c];
    out[c] = x;
    s = __fadd_rn(s, __fmul_rn(x, x));
  }
  for (int c = f; c < fpad; ++c) out[c] = 0.f;
  norms[j] = s;
}

// merge_buffer for any kcap (a multiple of 32): the same sort and ranks,
// then the sorted keys are walked in chunks of 32 from the top down, each
// chunk read whole before it is written; keys below the smallest
// candidate's rank stay in place. `topk` may point to shared or global
// memory.
__device__ float merge_general(uint64_t* topk, const uint64_t* buf, int cnt, int k, int kcap,
                               int lane) {
  __syncwarp();
  uint64_t b = lane < cnt ? buf[lane] : kSentinelKey;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint64_t o = __shfl_xor_sync(kFull, b, stride);
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
      b = (o < b) == keep_min ? o : b;
    }
  }
  int rank = 0;  // keys below b
  int top = 1;
  while (top * 2 <= kcap) top *= 2;
  for (int step = top; step >= 1; step >>= 1) {
    if (rank + step <= kcap && topk[rank + step - 1] < b) rank += step;
  }
  const int rank_or_max = lane < cnt ? rank : kcap;
  const int first = __shfl_sync(kFull, rank_or_max, 0);
  const int last = __shfl_sync(kFull, rank_or_max, 31);
  for (int base = kcap - 32; base >= (first / 32) * 32; base -= 32) {
    const int p = base + lane;
    const uint64_t key = topk[p];
    int below = 0;  // candidates smaller than key p: those of rank <= p
#pragma unroll
    for (int step = 16; step >= 1; step >>= 1) {
      if (__shfl_sync(kFull, rank_or_max, below + step - 1) <= p) below += step;
    }
    const int dest = p + (last <= p ? 32 : below);
    __syncwarp();
    if (dest < kcap) topk[dest] = key;
    __syncwarp();
  }
  if (lane < cnt && lane + rank < kcap) topk[lane + rank] = b;
  __syncwarp();
  return __uint_as_float(static_cast<uint32_t>(topk[k - 1] >> 32));
}

__device__ __forceinline__ void load8(const float* p, float x[kChunk]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

template <int R>
__global__ void __launch_bounds__(kGenThreads, 1)
knn_general_kernel(const float* __restrict__ packed, const float* __restrict__ norms, int n,
                   int fpad, int k, int kcap, uint64_t* __restrict__ topk_global,
                   float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* buf_keys = reinterpret_cast<uint64_t*>(smem);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = ((long long)blockIdx.x * kGenWarps + warp) * R;
  uint64_t* my_buf = buf_keys + warp * R * kBuf;
  uint64_t* my_topk = topk_global != nullptr
                          ? topk_global + (size_t)row0 * kcap
                          : buf_keys + kGenWarps * R * kBuf + (size_t)warp * R * kcap;
  for (int i = lane; i < R * kcap; i += 32) my_topk[i] = kSentinelKey;
  __syncwarp();

  const float inf = __int_as_float(0x7f800000);
  const unsigned lanes_below = (1u << lane) - 1;
  const int n_chunks = fpad / kChunk;
  float q_sq[R];
  float thr[R];
  int cnt[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool real = row0 + r < n;
    // a padded row reads the last real row and gets a threshold of -inf,
    // so nothing passes
    q_sq[r] = real ? norms[row0 + r] : 0.f;
    thr[r] = real ? inf : -inf;
    cnt[r] = 0;
  }

  for (long long base = 0; base < n; base += 32) {
    const long long j = base + lane;
    const bool valid = j < n;
    const float* pj = packed + (size_t)(valid ? j : 0) * fpad;
    float d2[R] = {};
    for (int c = 0; c < n_chunks; ++c) {
      float x[kChunk];
      load8(pj + c * kChunk, x);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const long long row = row0 + r < n ? row0 + r : n - 1;
        float q[kChunk];
        load8(packed + (size_t)row * fpad + c * kChunk, q);
        float s = c == 0 ? __fmul_rn(q[0], x[0]) : __fadd_rn(d2[r], __fmul_rn(q[0], x[0]));
#pragma unroll
        for (int e = 1; e < kChunk; ++e) s = __fadd_rn(s, __fmul_rn(q[e], x[e]));
        d2[r] = s;
      }
    }
    const float c_sq = valid ? norms[j] : inf;
    bool hit = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      d2[r] = __fadd_rn(__fsub_rn(q_sq[r], __fmul_rn(2.f, d2[r])), c_sq);
      hit |= valid && !(d2[r] >= thr[r]);
    }
    if (__any_sync(kFull, hit)) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float nd = d2[r] > 0.f ? d2[r] : 0.f;  // the plain version's clamp
        bool pass = valid && nd < thr[r] && j != row0 + r;
        unsigned mask = __ballot_sync(kFull, pass);
        if (!mask) continue;
        uint64_t* row_buf = my_buf + r * kBuf;
        if (cnt[r] + __popc(mask) > kBuf) {
          thr[r] = merge_general(my_topk + (size_t)r * kcap, row_buf, cnt[r], k, kcap, lane);
          cnt[r] = 0;
          pass = pass && nd < thr[r];
          mask = __ballot_sync(kFull, pass);
        }
        if (pass) {
          row_buf[cnt[r] + __popc(mask & lanes_below)] =
              (uint64_t(__float_as_uint(nd)) << 32) | uint32_t(j);
        }
        cnt[r] += __popc(mask);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row = row0 + r;
    if (row >= n) continue;
    uint64_t* row_topk = my_topk + (size_t)r * kcap;
    if (cnt[r] > 0) merge_general(row_topk, my_buf + r * kBuf, cnt[r], k, kcap, lane);
    for (int p = lane; p < k; p += 32) {
      const uint64_t key = row_topk[p];
      out_d[(size_t)row * k + p] = __uint_as_float(static_cast<uint32_t>(key >> 32));
      out_i[(size_t)row * k + p] = static_cast<int>(static_cast<uint32_t>(key));
    }
  }
}

template <int R>
int launch_general(const float* packed, const float* norms, int n, int fpad, int k, int kcap,
                   uint64_t* topk_global, float* out_d, int* out_i, size_t smem,
                   cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(knn_general_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows_per_block = kGenWarps * R;
  const unsigned blocks = static_cast<unsigned>((n + rows_per_block - 1) / rows_per_block);
  knn_general_kernel<R><<<blocks, kGenThreads, smem, s>>>(packed, norms, n, fpad, k, kcap,
                                                          topk_global, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of the packed copy (tiles of points and norms) knn_topk_f32 takes
// as `scratch`.
extern "C" size_t knn_topk_scratch_bytes(int n) { return size_t(num_tiles(n)) * kTileBytes; }

// points: float32 [n, f] row-major; out_d float32 [n, k]; out_i int32 [n, k];
// scratch: knn_topk_scratch_bytes(n) bytes, 16-byte aligned.
// Requires 0 < k < n, k <= 128, f <= 8 (checked by the Python wrapper).
extern "C" int knn_topk_f32(const float* points, int n, int f, int k, float* out_d, int* out_i,
                            float* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pad = num_tiles(n) * kTile;
  pack_kernel<<<(n_pad + 255) / 256, 256, 0, s>>>(points, n, f, n_pad, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(knn_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_topk_kernel<<<(n + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, kSmemBytes, s>>>(
      points, scratch, n, f, k, num_tiles(n), out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

// General instance (any f >= 1, 0 < k < n): rows_per_warp (6, 3 or 1) and
// kcap (k rounded up to 32) from the wrapper's launch plan; topk_scratch
// holds ceil(n / (16 rows_per_warp)) * 16 rows_per_warp * kcap keys, or is
// null to keep the keys in shared memory; smem_bytes must be
// knn_general_smem_bytes of the same plan. packed: n * fpad floats (f
// rounded up to 8), norms: n floats, both 16-byte aligned.
extern "C" size_t knn_general_smem_bytes(int rows_per_warp, int kcap, int global_topk) {
  return general_smem_bytes(rows_per_warp, kcap, global_topk != 0);
}

extern "C" int knn_general_f32(const float* points, int n, int f, int k, int rows_per_warp,
                               int kcap, size_t smem_bytes, float* packed, float* norms,
                               void* topk_scratch, float* out_d, int* out_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kcap < k || kcap % 32 != 0 || f < 1 || !(0 < k && k < n) ||
      smem_bytes != general_smem_bytes(rows_per_warp, kcap, topk_scratch != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int fpad = (f + kChunk - 1) / kChunk * kChunk;
  pack_general_kernel<<<(n + 255) / 256, 256, 0, s>>>(points, n, f, fpad, packed, norms);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  uint64_t* topk = static_cast<uint64_t*>(topk_scratch);
  switch (rows_per_warp) {
    case 6:
      return launch_general<6>(packed, norms, n, fpad, k, kcap, topk, out_d, out_i, smem_bytes, s);
    case 3:
      return launch_general<3>(packed, norms, n, fpad, k, kcap, topk, out_d, out_i, smem_bytes, s);
    case 1:
      return launch_general<1>(packed, norms, n, fpad, k, kcap, topk, out_d, out_i, smem_bytes, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
