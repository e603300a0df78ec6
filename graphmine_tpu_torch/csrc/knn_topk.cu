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
// The general instance (1 <= F <= 64, and k up to what its keys leave room
// for: 1,344): the fast instance's design at any feature count and key
// capacity, bound the same way, by the FP32 issue rate without FMA (2F+3
// instructions a pair). It replaced, at these shapes, the first wide kernel,
// which streamed every point from L2 once a warp. Against that kernel's five
// limits:
// 1. A shared tile. A prologue (pack_general_kernel) packs the points tile
//    by tile, each chunk of 8 features as [f0..f3 x T][f4..f7 x T], then
//    [norm x T], and a ring of 3 or 4 stages filled by TMA bulk copies
//    streams them once a block; each lane reads its point from shared
//    memory a step ahead. T is 512 at F <= 8 and halves as F grows, so that
//    a stage stays within kGenTileFloats (18 KB).
// 2. Queries read once. At F <= 8 a warp's R rows live in registers; past
//    that, the block's rows are staged in shared memory once, a row's
//    chunk is two broadcast loads, and each lane takes two points a step so
//    that every broadcast serves both; the cross term is carried across
//    chunks in feature order.
// 3. No masks. Padded features are zero, padded points carry an infinite
//    norm and padded rows a threshold of -inf, so the loop has no bounds
//    check.
// 4. A cheaper merge. merge_general is merge_buffer's sort and ranks for any
//    kcap in shared memory, inlined, with no search a key (see there). At
//    large k most steps carry a candidate of some row, so each row has its
//    own vote, and a row without a candidate costs that vote alone.
// 5. The grid. 16 warps of R = 8, 6, 4, 3, 2 or 1 rows: the most whose keys
//    fit beside the ring, then the most stages (kernels/knn_cuda.py::
//    launch_plan picks them and passes them here), one block an SM.
//
// The wide instance (F > 64, or keys that do not fit beside the general
// instance's ring): the same contract, bound the same way, by the FP32
// issue rate without FMA at 2F+3 instructions a pair, and past that by the
// top-k's merges at large k. The first wide kernel kept no tile in shared
// memory: each lane loaded its point's chunk and the warp's rows' chunks
// from L2 for every step (14 loads a 96 operations), zero-padded F to 8
// and kept a row of key scratch for every point past shared memory. This
// design keeps the data on the chip:
// 1. Chunked tiles in a TMA ring. pack_general_kernel, at F rounded up to 4
//    (fpad), packs tiles of T points as [f0..f3 x T][f4..f7 x T]...[norm x
//    T]. A chunk is at most 32 features (fpad spread evenly over the fewest
//    chunks), so a tile's chunk is one contiguous stretch and the last one
//    carries the norms. A ring of 2 to 4 stages, each one chunk of one tile
//    filled by TMA bulk copies under one barrier, streams the tiles chunk by
//    chunk; T is 64 where a tile takes several chunks (up to 256 at small
//    F), so a stage is at most kWideStageFloats (9 KB) and leaves room for
//    the keys. Padded points carry an infinite norm: no bounds check.
// 2. Cross terms in registers. Each lane takes two points of the tile and
//    carries the 2R partial sums from chunk to chunk in feature order; after
//    the last chunk it adds the norms and votes (wide_step). Features past F
//    are zero on both sides, so they add exact +0 products (a cross term of
//    -0 turns +0, which no distance tells apart after the doubling, the
//    subtraction from a norm >= +0 and the clamp): F = 65 costs 2 x 68 + 3 =
//    139 operations a pair against the plain version's 133. The loop keeps
//    its registers for the 2R sums, the R broadcast rows and the two points
//    (the rows' norms, thresholds and counts live in shared memory), so that
//    all R loads of a group are in flight at once.
// 3. Queries read once. The block's 16 R rows are staged whole in shared
//    memory once a row group, group-major (a group's R rows are R
//    consecutive broadcasts), where they fit beside the ring and the keys;
//    past that the rows' chunk rides in each stage, copied under the stage's
//    barrier. No row is read from L2 inside the loop.
// 4. Keys. Each row keeps kcap sorted keys in shared memory while they fit;
//    past that in device scratch for a persistent grid of at most
//    kWideResidentBlocks blocks that walk the row groups, so the scratch is
//    bounded by the resident blocks (132 x 16 R x kcap keys), not by N, and
//    L2 holds it (32 MiB at most past one row a warp). At one row a warp
//    (large k) a row buffers 128 candidates and merge_wide folds them in at
//    once: a merge rewrites the keys above its smallest candidate whatever
//    its fill, so this takes four times the candidates a rewrite of
//    merge_general's 32.
// 5. The plan (kernels/knn_cuda.py::wide_plan): the most rows a warp (8, 6,
//    4, 3, 2, 1; 8, 4, 2, 1 where the queries ride), the queries whole
//    before riding, the stages (3, 4 or 2; at one row a warp the most, up to
//    8, since a merge holds its warp for many steps and the ring's slack
//    keeps the other warps going), then the keys in shared memory before
//    scratch; the wrapper passes the plan here.
//
// C interface (bound with ctypes): knn_topk_scratch_bytes,
// knn_general_scratch_bytes and knn_wide_scratch_bytes give the size of the
// packed tiles the caller allocates for each instance; knn_topk_f32,
// knn_general_f32 and knn_wide_f32 launch an instance's prologue and main
// kernel on the given stream and return the first launch error
// (cudaGetLastError()), 0 if none; the last two return
// cudaErrorInvalidValue on a plan that is not theirs.

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
constexpr int kGenMaxF = 64;          // features the general instance takes at most
constexpr int kGenTileFloats = 4608;  // a stage's floats at most (the fast tile: 512 x 9)
constexpr int kGenMinStages = 3;
constexpr int kGenMaxStages = 4;
constexpr int kMergeKeysPerLane = 4;  // keys a lane moves per group of a merge
constexpr int kMergeGroup = 32 * kMergeKeysPerLane;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may opt into

int general_fpad(int f) { return (f + kFeatPad - 1) / kFeatPad * kFeatPad; }

// Points per stage: the most, as a power of two, whose features and norms
// fit in kGenTileFloats.
int general_tile(int fpad) {
  int tile = 512;
  while (tile * (fpad + 1) > kGenTileFloats) tile >>= 1;
  return tile;
}

// The ring, the rows' top-k keys and buffers, the staged query rows (when
// they do not live in registers) and the stages' barriers.
size_t general_smem_bytes(int fpad, int tile, int stages, int rows_per_warp, int kcap,
                          bool queries_in_registers) {
  const size_t rows = size_t(kGenWarps) * rows_per_warp;
  return size_t(stages) * tile * (fpad + 1) * sizeof(float) +
         rows * (kcap + kBuf) * sizeof(uint64_t) +
         (queries_in_registers ? 0 : rows * fpad * sizeof(float)) +
         size_t(stages) * (sizeof(uint64_t) + sizeof(unsigned));
}

// load_tile for a stage of `bytes` bytes.
__device__ __forceinline__ void load_stage(float* dst, const float* src, unsigned bytes,
                                           uint64_t* full) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(full)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(full))
      : "memory");
}

// Packs the points tile by tile: for each chunk of 8 features [f0..f3 x T]
// [f4..f7 x T], then [norm x T]; norms in _sq_norms' order, features past
// f zero, points past n zero with an infinite norm.
__global__ void pack_general_kernel(const float* __restrict__ pts, int n, int f, int fpad,
                                    int tile, unsigned n_pad, float* __restrict__ tiles) {
  const unsigned j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_pad) return;
  const bool real = j < unsigned(n);
  const float* p = pts + (size_t)j * f;
  float s = __int_as_float(0x7f800000);
  if (real) {
    s = __fmul_rn(p[0], p[0]);
    for (int c = 1; c < f; ++c) s = __fadd_rn(s, __fmul_rn(p[c], p[c]));
  }
  float* t = tiles + (size_t)(j / tile) * tile * (fpad + 1);
  const unsigned i = j % tile;
  for (int c = 0; c < fpad; c += 4) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = (real && c + e < f) ? p[c + e] : 0.f;
    reinterpret_cast<float4*>(t)[(c / 4) * tile + i] = make_float4(v[0], v[1], v[2], v[3]);
  }
  t[fpad * tile + i] = s;
}

// merge_buffer for any kcap (a multiple of 32) in shared memory, with no
// search a key. The warp sorts the buffer (bitonic, one key a lane) and
// finds each candidate's rank among the kcap sorted keys: lane i holds the
// last key of run i (kcap / 32 keys), a search over the lanes finds the
// candidate's run and a binary search in shared memory its place in the
// run. A candidate's slot in the merged keys is then its rank plus its
// lane. The slots are rewritten from the top down, kMergeGroup at a time
// (every key moves up, so no group overwrites one not yet read): for 32
// slots, one vote counts the candidates placed below them and one OR of
// the warp marks the slots that take a candidate; any other slot takes the
// key as many places down as there are candidates below it. Slots below
// the smallest candidate's keep their key.
__device__ __forceinline__ float merge_general(uint64_t* topk, const uint64_t* buf, int cnt, int k,
                                               int kcap, int lane) {
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
  const int run_len = kcap >> 5;
  const uint64_t run_last = topk[(lane + 1) * run_len - 1];
  int run = 0;  // runs whose last key is below b
#pragma unroll
  for (int step = 16; step >= 1; step >>= 1) {
    if (__shfl_sync(kFull, run_last, run + step - 1) < b) run += step;
  }
  if (__shfl_sync(kFull, run_last, 31) < b) run = 32;
  int rank = run * run_len;  // keys below b
  if (run < 32) {
    const int end = rank + run_len - 1;  // the run's last key is not below b
    for (int step = run_len > 1 ? 1 << (31 - __clz(run_len - 1)) : 0; step >= 1; step >>= 1) {
      if (rank + step <= end && topk[rank + step - 1] < b) rank += step;
    }
  }
  const int slot = lane < cnt ? rank + lane : kcap;  // kcap or past it: dropped
  const int first = __shfl_sync(kFull, slot, 0);
  const unsigned lanes_below = (1u << lane) - 1;
  for (int g = (kcap - 1) / kMergeGroup * kMergeGroup; g >= first / kMergeGroup * kMergeGroup;
       g -= kMergeGroup) {
    uint64_t key[kMergeKeysPerLane];
#pragma unroll
    for (int s = 0; s < kMergeKeysPerLane; ++s) {
      const int base = g + s * 32;
      if (base < kcap) {  // the same for every lane of the warp
        const int below = __popc(__ballot_sync(kFull, slot < base));
        const bool here = slot >= base && slot < base + 32;
        const unsigned taken = __reduce_or_sync(kFull, here ? 1u << (slot - base) : 0u);
        const int before = below + __popc(taken & lanes_below);  // candidates below this slot
        const uint64_t cand = __shfl_sync(kFull, b, before & 31);
        key[s] = (taken >> lane) & 1 ? cand : topk[base + lane - before];
      }
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < kMergeKeysPerLane; ++s) {
      if (g + s * 32 < kcap) topk[g + s * 32 + lane] = key[s];
    }
  }
  __syncwarp();
  return __uint_as_float(static_cast<uint32_t>(topk[k - 1] >> 32));
}

// One step of 32 points (j0 .. j0 + 31, one a lane) against a warp's R
// rows, from each row's cross term: the distances, one vote a row (a row
// with no candidate in the step costs its vote alone, where at large k
// most steps carry a candidate of some row), and the rare path of the
// fast instance for each row that has one.
template <int R>
__device__ __forceinline__ void take_step(float (&d2)[R], float c_sq, unsigned j0,
                                          const float (&q_sq)[R], float (&thr)[R], int (&cnt)[R],
                                          uint64_t* my_topk, uint64_t* my_buf, int row0, int k,
                                          int kcap, int lane) {
  unsigned hits[R];
  unsigned any = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    d2[r] = __fadd_rn(__fsub_rn(q_sq[r], __fmul_rn(2.f, d2[r])), c_sq);
    hits[r] = __ballot_sync(kFull, !(d2[r] >= thr[r]));
    any |= hits[r];
  }
  if (!any) return;
  const unsigned j = j0 + lane;
  const unsigned lanes_below = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!hits[r]) continue;
    const float nd = d2[r] > 0.f ? d2[r] : 0.f;  // the plain version's clamp
    bool pass = nd < thr[r] && j != unsigned(row0 + r);
    unsigned mask = __ballot_sync(kFull, pass);
    if (!mask) continue;
    uint64_t* row_buf = my_buf + r * kBuf;
    if (cnt[r] + __popc(mask) > kBuf) {
      thr[r] = merge_general(my_topk + r * kcap, row_buf, cnt[r], k, kcap, lane);
      cnt[r] = 0;
      pass = pass && nd < thr[r];
      mask = __ballot_sync(kFull, pass);
    }
    if (pass) {
      row_buf[cnt[r] + __popc(mask & lanes_below)] = (uint64_t(__float_as_uint(nd)) << 32) | j;
    }
    cnt[r] += __popc(mask);
  }
}

// kQReg: the warp's R query rows live in registers (fpad == 8); else the
// block's rows are staged in shared memory once and read as broadcasts.
template <bool kQReg, int R>
__global__ void __launch_bounds__(kGenThreads, 1)
knn_general_kernel(const float* __restrict__ pts, const float* __restrict__ tiles, int n, int f,
                   int fpad, int k, int kcap, int tile, int stages, int n_tiles,
                   float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int kRows = kGenWarps * R;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_floats = tile * (fpad + 1);
  const unsigned tile_bytes = tile_floats * sizeof(float);
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* topk_keys = reinterpret_cast<uint64_t*>(smem + size_t(stages) * tile_bytes);
  uint64_t* buf_keys = topk_keys + (size_t)kRows * kcap;
  float* q_rows = reinterpret_cast<float*>(buf_keys + kRows * kBuf);
  uint64_t* full = reinterpret_cast<uint64_t*>(q_rows + (kQReg ? 0 : kRows * fpad));
  unsigned* released = reinterpret_cast<unsigned*>(full + stages);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int t = 0; t < stages && t < n_tiles; ++t) {
      load_stage(ring + t * tile_floats, tiles + (size_t)t * tile_floats, tile_bytes, &full[t]);
    }
  }
  __syncthreads();

  const int row0 = blockIdx.x * kRows + warp * R;
  uint64_t* my_topk = topk_keys + (size_t)warp * R * kcap;
  uint64_t* my_buf = buf_keys + warp * R * kBuf;
  float* my_q = q_rows + warp * R * fpad;
  for (int i = lane; i < R * kcap; i += 32) my_topk[i] = kSentinelKey;
  if constexpr (!kQReg) {
    for (int i = lane; i < R * fpad; i += 32) {
      const int row = row0 + i / fpad, c = i % fpad;
      my_q[i] = (row < n && c < f) ? pts[(size_t)row * f + c] : 0.f;
    }
  }
  __syncwarp();

  const float inf = __int_as_float(0x7f800000);
  const int n_chunks = fpad / kFeatPad;
  float q[kQReg ? R : 1][kFeatPad];
  float q_sq[R];
  float thr[R];
  int cnt[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    const bool real = row < n;
    if constexpr (kQReg) {
#pragma unroll
      for (int c = 0; c < kFeatPad; ++c) q[r][c] = (real && c < f) ? pts[(size_t)row * f + c] : 0.f;
    }
    // The prologue's norm; a padded row gets 0 and a threshold of -inf,
    // so its distances are finite and never pass.
    q_sq[r] = real ? tiles[(size_t)(row / tile) * tile_floats + fpad * tile + row % tile] : 0.f;
    thr[r] = real ? inf : -inf;
    cnt[r] = 0;
  }

  for (int t = 0, s = 0, phase = 0; t < n_tiles; ++t) {
    mbar_wait(&full[s], phase);
    // chunk c of point i: fx[2c tile + i] (features 8c..8c+3) and
    // fx[(2c+1) tile + i] (8c+4..8c+7); its norm fn[i]
    const float4* fx = reinterpret_cast<const float4*>(ring + s * tile_floats);
    const float* fn = ring + s * tile_floats + fpad * tile;
    const unsigned base = unsigned(t) * tile;
    if constexpr (kQReg) {
      float4 a = fx[lane];
      float4 b = fx[tile + lane];
      float c_sq = fn[lane];
      for (int t0 = 0; t0 < tile; t0 += 32) {
        // The next step's point and norm, loaded while this one computes
        // (the last step of a tile reloads the tile's first point).
        const int next = t0 + 32 < tile ? t0 + 32 + lane : lane;
        const float4 a_next = fx[next];
        const float4 b_next = fx[tile + next];
        const float c_sq_next = fn[next];
        const float x[kFeatPad] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        float d2[R];
#pragma unroll
        for (int r = 0; r < R; ++r) d2[r] = __fmul_rn(q[r][0], x[0]);
#pragma unroll
        for (int c = 1; c < kFeatPad; ++c) {
#pragma unroll
          for (int r = 0; r < R; ++r) d2[r] = __fadd_rn(d2[r], __fmul_rn(q[r][c], x[c]));
        }
        take_step<R>(d2, c_sq, base + t0, q_sq, thr, cnt, my_topk, my_buf, row0, k, kcap, lane);
        a = a_next;
        b = b_next;
        c_sq = c_sq_next;
      }
    } else {
      // Two points a lane a step (64 a warp), so that each broadcast load
      // of a row's four features serves two points: the shared-memory
      // pipe, not the FP32 one, bounds the step otherwise. The cross term
      // runs feature by feature, carried across chunks.
      const float4* qx = reinterpret_cast<const float4*>(my_q);
      const int q_stride = fpad / 4;  // float4s a row
      for (int t0 = 0; t0 < tile; t0 += 64) {
        const int i = t0 + lane;
        float d2[2][R];
        float4 u[R];
        {
          const float4 x = fx[i];
          const float4 y = fx[i + 32];
#pragma unroll
          for (int r = 0; r < R; ++r) u[r] = qx[r * q_stride];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            d2[0][r] = __fmul_rn(u[r].x, x.x);
            d2[1][r] = __fmul_rn(u[r].x, y.x);
            d2[0][r] = __fadd_rn(d2[0][r], __fmul_rn(u[r].y, x.y));
            d2[1][r] = __fadd_rn(d2[1][r], __fmul_rn(u[r].y, y.y));
            d2[0][r] = __fadd_rn(d2[0][r], __fmul_rn(u[r].z, x.z));
            d2[1][r] = __fadd_rn(d2[1][r], __fmul_rn(u[r].z, y.z));
            d2[0][r] = __fadd_rn(d2[0][r], __fmul_rn(u[r].w, x.w));
            d2[1][r] = __fadd_rn(d2[1][r], __fmul_rn(u[r].w, y.w));
          }
        }
        for (int h = 1; h < 2 * n_chunks; ++h) {
          const float4 x = fx[h * tile + i];
          const float4 y = fx[h * tile + i + 32];
#pragma unroll
          for (int r = 0; r < R; ++r) u[r] = qx[r * q_stride + h];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            d2[0][r] = __fadd_rn(d2[0][r], __fmul_rn(u[r].x, x.x));
            d2[1][r] = __fadd_rn(d2[1][r], __fmul_rn(u[r].x, y.x));
            d2[0][r] = __fadd_rn(d2[0][r], __fmul_rn(u[r].y, x.y));
            d2[1][r] = __fadd_rn(d2[1][r], __fmul_rn(u[r].y, y.y));
            d2[0][r] = __fadd_rn(d2[0][r], __fmul_rn(u[r].z, x.z));
            d2[1][r] = __fadd_rn(d2[1][r], __fmul_rn(u[r].z, y.z));
            d2[0][r] = __fadd_rn(d2[0][r], __fmul_rn(u[r].w, x.w));
            d2[1][r] = __fadd_rn(d2[1][r], __fmul_rn(u[r].w, y.w));
          }
        }
        // the lower 32 points, then the upper: the scan stays in index order
#pragma unroll 1
        for (int half = 0; half < 2; ++half) {
          float v[R];
#pragma unroll
          for (int r = 0; r < R; ++r) v[r] = half ? d2[1][r] : d2[0][r];
          take_step<R>(v, fn[i + 32 * half], base + t0 + 32 * half, q_sq, thr, cnt, my_topk, my_buf,
                       row0, k, kcap, lane);
        }
      }
    }
    // Release the stage; the last warp to release it refills it with the
    // tile `stages` ahead.
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&released[s], 1u) % kGenWarps == kGenWarps - 1 && t + stages < n_tiles) {
        __threadfence_block();
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        load_stage(ring + s * tile_floats, tiles + (size_t)(t + stages) * tile_floats, tile_bytes,
                   &full[s]);
      }
    }
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row >= n) continue;
    uint64_t* row_topk = my_topk + r * kcap;
    if (cnt[r] > 0) merge_general(row_topk, my_buf + r * kBuf, cnt[r], k, kcap, lane);
    for (int p = lane; p < k; p += 32) {
      const uint64_t key = row_topk[p];
      out_d[(size_t)row * k + p] = __uint_as_float(static_cast<uint32_t>(key >> 32));
      out_i[(size_t)row * k + p] = static_cast<int>(static_cast<uint32_t>(key));
    }
  }
}

template <bool kQReg, int R>
int launch_general(const float* points, const float* tiles, int n, int f, int fpad, int k,
                   int kcap, int tile, int stages, int n_tiles, float* out_d, int* out_i,
                   size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(knn_general_kernel<kQReg, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = kGenWarps * R;
  knn_general_kernel<kQReg, R><<<(n + rows_per_block - 1) / rows_per_block, kGenThreads, smem, s>>>(
      points, tiles, n, f, fpad, k, kcap, tile, stages, n_tiles, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

// The rows a warp of the general instance may take: 6, 4, 3, 2 or 1 with
// the queries in registers, and 8 too with the queries in shared memory.
bool general_rows_ok(bool queries_in_registers, int rows_per_warp) {
  switch (rows_per_warp) {
    case 8:
      return !queries_in_registers;
    case 6:
    case 4:
    case 3:
    case 2:
    case 1:
      return true;
    default:
      return false;
  }
}


// ---- the wide instance (see the note at the top) -------------------------

constexpr int kWideWarps = 16;
constexpr int kWideThreads = kWideWarps * 32;
constexpr int kWideStageFloats = 2304;  // a stage's points at most, features and norms
constexpr int kWideMaxChunk = 32;       // features a chunk at most
constexpr int kWideMinStages = 2;
constexpr int kWideMaxStages = 8;
constexpr int kWidePackPoints = 256;       // points are packed in whole groups of this many
constexpr int kWideResidentBlocks = 132;   // a persistent grid: one block an SM of an H100 SXM
constexpr int kWideBigBuf = 128;  // a row's candidate buffer at one row a warp

int wide_fpad(int f) { return (f + 3) / 4 * 4; }

// Features a chunk: a tile's features spread evenly over the fewest chunks
// of at most kWideMaxChunk, rounded up to 4 (the last chunk takes the rest).
int wide_chunk(int fpad) {
  const int chunks = (fpad + kWideMaxChunk - 1) / kWideMaxChunk;
  return ((fpad + chunks - 1) / chunks + 3) / 4 * 4;
}

// Points a tile: the most, as a power of two up to 256, whose chunk and
// norms fit in kWideStageFloats (64 wherever a tile takes several chunks).
int wide_tile(int chunk) {
  int tile = 256;
  while (tile * (chunk + 1) > kWideStageFloats) tile >>= 1;
  return tile;
}

// The query tiles that ride in each stage beside the points' chunk: the
// block's rows (16, 32, 64 or 128) lie in one tile or fill whole ones.
__host__ __device__ __forceinline__ int wide_query_tiles(int rows, int tile, bool ride) {
  return ride ? (rows > tile ? rows / tile : 1) : 0;
}

// Candidates a row buffers between merges: kWideBigBuf at one row a warp
// (merge_wide), else kBuf (merge_general).
__host__ __device__ constexpr int wide_row_buf(int rows_per_warp) {
  return rows_per_warp == 1 ? kWideBigBuf : kBuf;
}

// The ring (each stage a points' chunk and the query tiles riding with
// it), the rows' top-k keys (unless in device scratch) and buffers, each
// row's norm, threshold and buffer count, the block's query rows (when
// staged whole) and the stages' barriers.
size_t wide_smem_bytes(int fpad, int chunk, int tile, int stages, int rows_per_warp, int kcap,
                       bool ride, bool keys_global) {
  const int rows = kWideWarps * rows_per_warp;
  const size_t stage = size_t(tile) * (chunk + 1) * (1 + wide_query_tiles(rows, tile, ride));
  return size_t(stages) * stage * sizeof(float) +
         size_t(rows) * ((keys_global ? 0 : kcap) + wide_row_buf(rows_per_warp)) * sizeof(uint64_t) +
         size_t(rows) * 3 * sizeof(float) + (ride ? 0 : size_t(rows) * fpad * sizeof(float)) +
         size_t(stages) * (sizeof(uint64_t) + sizeof(unsigned));
}

// The packed points: N rounded up to kWidePackPoints (a multiple of every
// tile and of every block's rows that ride), fpad features and a norm each.
size_t wide_packed_floats(int n, int f) {
  const size_t points = (size_t(n) + kWidePackPoints - 1) / kWidePackPoints * kWidePackPoints;
  return points * (wide_fpad(f) + 1);
}

// The rows a warp may take: 8, 6, 4, 3, 2 or 1 with the queries staged
// whole; 8, 4, 2 or 1 with them riding in the stages (a warp's rows then lie
// in one tile).
bool wide_rows_ok(bool ride, int rows_per_warp) {
  switch (rows_per_warp) {
    case 6:
    case 3:
      return !ride;
    case 8:
    case 4:
    case 2:
    case 1:
      return true;
    default:
      return false;
  }
}

// A bulk copy into a stage whose bytes its barrier already expects.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* full) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(full))
      : "memory");
}

// One group of 4 features of two points a lane (x_at[0] and x_at[32])
// against a warp's R rows (q_at[0 .. R-1]): the cross terms carried in
// feature order, or (kFirst) started by the group's first product.
template <int R, bool kFirst>
__device__ __forceinline__ void wide_group(float (&d2)[2][R], const float4* x_at,
                                           const float4* q_at) {
  const float4 x = x_at[0];
  const float4 y = x_at[32];
  float4 u[R];
#pragma unroll
  for (int r = 0; r < R; ++r) u[r] = q_at[r];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if constexpr (kFirst) {
      d2[0][r] = __fmul_rn(u[r].x, x.x);
      d2[1][r] = __fmul_rn(u[r].x, y.x);
    } else {
      d2[0][r] = __fadd_rn(d2[0][r], __fmul_rn(u[r].x, x.x));
      d2[1][r] = __fadd_rn(d2[1][r], __fmul_rn(u[r].x, y.x));
    }
    d2[0][r] = __fadd_rn(d2[0][r], __fmul_rn(u[r].y, x.y));
    d2[1][r] = __fadd_rn(d2[1][r], __fmul_rn(u[r].y, y.y));
    d2[0][r] = __fadd_rn(d2[0][r], __fmul_rn(u[r].z, x.z));
    d2[1][r] = __fadd_rn(d2[1][r], __fmul_rn(u[r].z, y.z));
    d2[0][r] = __fadd_rn(d2[0][r], __fmul_rn(u[r].w, x.w));
    d2[1][r] = __fadd_rn(d2[1][r], __fmul_rn(u[r].w, y.w));
  }
}

// merge_general for a buffer of up to kWideBigBuf candidates, the buffer of
// a row at one row a warp (there the keys are many and the merges
// frequent). A merge rewrites the keys above its smallest candidate
// whatever the buffer's fill, so a buffer four times as large takes four
// times the candidates a rewrite. The warp sorts the buffer (bitonic, four
// keys a lane: candidate e = 4 lane + s in b[s]) and writes it back sorted;
// candidate e's slot is its rank among the kcap keys (found as in
// merge_general) plus e, and the slots ascend with e. The slots are
// rewritten from the top down, 32 a step: a vote and a shuffle count the
// candidates below the step, one OR of the warp marks the step's slots that
// take a candidate (read back from the sorted buffer), and every other slot
// takes the key as many places down as there are candidates below it.
__device__ __forceinline__ float merge_wide(uint64_t* topk, uint64_t* buf, int cnt, int k,
                                            int kcap, int lane) {
  constexpr int kPer = kWideBigBuf / 32;
  __syncwarp();
  uint64_t b[kPer];
#pragma unroll
  for (int s = 0; s < kPer; ++s) b[s] = kPer * lane + s < cnt ? buf[kPer * lane + s] : kSentinelKey;
#pragma unroll
  for (int size = 2; size <= kWideBigBuf; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int s = 0; s < kPer; ++s) {
        const int e = kPer * lane + s;
        if (stride < kPer) {  // the partner is in this lane: exchange the pair once
          const int p = s ^ stride;
          if (p > s) {
            const bool up = (e & size) == 0;
            const uint64_t lo = b[s] < b[p] ? b[s] : b[p];
            const uint64_t hi = b[s] < b[p] ? b[p] : b[s];
            b[s] = up ? lo : hi;
            b[p] = up ? hi : lo;
          }
        } else {
          const uint64_t o = __shfl_xor_sync(kFull, b[s], stride / kPer);
          const bool keep_min = ((e & stride) == 0) == ((e & size) == 0);
          b[s] = (o < b[s]) == keep_min ? o : b[s];
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kPer; ++s) buf[kPer * lane + s] = b[s];
  const int run_len = kcap >> 5;
  const uint64_t run_last = topk[(lane + 1) * run_len - 1];
  const uint64_t top = __shfl_sync(kFull, run_last, 31);
  int slot[kPer];
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    int run = 0;  // runs whose last key is below b[s]
#pragma unroll
    for (int step = 16; step >= 1; step >>= 1) {
      if (__shfl_sync(kFull, run_last, run + step - 1) < b[s]) run += step;
    }
    if (top < b[s]) run = 32;
    int rank = run * run_len;  // keys below b[s]
    if (run < 32) {
      const int end = rank + run_len - 1;  // the run's last key is not below b[s]
      for (int step = run_len > 1 ? 1 << (31 - __clz(run_len - 1)) : 0; step >= 1; step >>= 1) {
        if (rank + step <= end && topk[rank + step - 1] < b[s]) rank += step;
      }
    }
    const int e = kPer * lane + s;
    slot[s] = e < cnt ? rank + e : kcap;  // kcap or past it: dropped
  }
  __syncwarp();
  const int first = __shfl_sync(kFull, slot[0], 0);
  const unsigned lanes_below = (1u << lane) - 1;
  for (int g = (kcap - 1) / kMergeGroup * kMergeGroup; g >= first / kMergeGroup * kMergeGroup;
       g -= kMergeGroup) {
    uint64_t key[kMergeKeysPerLane];
#pragma unroll
    for (int t = 0; t < kMergeKeysPerLane; ++t) {
      const int base = g + t * 32;
      if (base < kcap) {  // the same for every lane of the warp
        // candidates below the step: the lanes whose last slot is below it,
        // and the part of the next lane's
        const int full_lanes = __popc(__ballot_sync(kFull, slot[kPer - 1] < base));
        int part = 0;
        unsigned bits = 0;  // this lane's candidates in the step
#pragma unroll
        for (int s = 0; s < kPer; ++s) {
          part += slot[s] < base;
          const unsigned d = unsigned(slot[s] - base);
          if (d < 32u) bits |= 1u << d;
        }
        const int part_next = __shfl_sync(kFull, part, full_lanes & 31);
        const int below = kPer * full_lanes + (full_lanes < 32 ? part_next : 0);
        const unsigned taken = __reduce_or_sync(kFull, bits);
        const int before = below + __popc(taken & lanes_below);  // candidates below this slot
        key[t] = (taken >> lane) & 1 ? buf[before] : topk[base + lane - before];
      }
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < kMergeKeysPerLane; ++t) {
      if (g + t * 32 < kcap) topk[g + t * 32 + lane] = key[t];
    }
  }
  __syncwarp();
  return __uint_as_float(static_cast<uint32_t>(topk[k - 1] >> 32));
}

// A row's merge: merge_wide at one row a warp, else merge_general.
template <int R>
__device__ __forceinline__ float wide_merge(uint64_t* topk, uint64_t* buf, int cnt, int k,
                                            int kcap, int lane) {
  if constexpr (R == 1) {
    return merge_wide(topk, buf, cnt, k, kcap, lane);
  } else {
    return merge_general(topk, buf, cnt, k, kcap, lane);
  }
}

// take_step with the rows' norms, thresholds and buffer counts in shared
// memory (q_sq, thr, cnt: the warp's R entries, equal in every lane, each
// lane writing the value it reads back), so that the loop over features
// keeps its registers for the cross terms.
template <int R>
__device__ __forceinline__ void wide_step(float (&d2)[R], float c_sq, unsigned j0,
                                          const float* q_sq, float* thr, int* cnt,
                                          uint64_t* my_topk, uint64_t* my_buf, int row0, int k,
                                          int kcap, int lane) {
  unsigned hits[R];
  unsigned any = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    d2[r] = __fadd_rn(__fsub_rn(q_sq[r], __fmul_rn(2.f, d2[r])), c_sq);
    hits[r] = __ballot_sync(kFull, !(d2[r] >= thr[r]));
    any |= hits[r];
  }
  if (!any) return;
  const unsigned j = j0 + lane;
  const unsigned lanes_below = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!hits[r]) continue;
    const float nd = d2[r] > 0.f ? d2[r] : 0.f;  // the plain version's clamp
    float t = thr[r];
    bool pass = nd < t && j != unsigned(row0 + r);
    unsigned mask = __ballot_sync(kFull, pass);
    if (!mask) continue;
    uint64_t* row_buf = my_buf + r * wide_row_buf(R);
    int c = cnt[r];
    if (c + __popc(mask) > wide_row_buf(R)) {
      t = wide_merge<R>(my_topk + r * kcap, row_buf, c, k, kcap, lane);
      thr[r] = t;
      c = 0;
      pass = pass && nd < t;
      mask = __ballot_sync(kFull, pass);
    }
    if (pass) row_buf[c + __popc(mask & lanes_below)] = (uint64_t(__float_as_uint(nd)) << 32) | j;
    cnt[r] = c + __popc(mask);
  }
}

// kRide: the query rows' chunk rides in each stage; else the block's rows
// are staged whole in shared memory once a row group. topk_global: the
// rows' keys in device scratch (grid x 16 R x kcap keys), else in shared
// memory. Block b takes row groups b, b + grid, ...: one each unless the
// keys are in scratch.
template <bool kRide, int R>
__global__ void __launch_bounds__(kWideThreads, 1)
knn_wide_kernel(const float* __restrict__ pts, const float* __restrict__ packed, int n, int f,
                int fpad, int chunk, int tile, int stages, int k, int kcap, int n_groups,
                uint64_t* __restrict__ topk_global, float* __restrict__ out_d,
                int* __restrict__ out_i) {
  constexpr int kRows = kWideWarps * R;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tiles = (n + tile - 1) / tile;
  const int n_chunks = (fpad + chunk - 1) / chunk;
  const int last = fpad - (n_chunks - 1) * chunk;  // features of the last chunk
  const int pt_floats = tile * (chunk + 1);        // a stage's points, norms included
  const int q_tiles = wide_query_tiles(kRows, tile, kRide);
  const int stage_floats = pt_floats * (1 + q_tiles);
  const size_t tile_floats = size_t(tile) * (fpad + 1);  // a packed tile
  const bool keys_global = topk_global != nullptr;
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* topk_keys =
      reinterpret_cast<uint64_t*>(smem + size_t(stages) * stage_floats * sizeof(float));
  uint64_t* buf_keys = topk_keys + (keys_global ? 0 : size_t(kRows) * kcap);
  float* row_state =
      reinterpret_cast<float*>(buf_keys + kRows * wide_row_buf(R));  // q_sq, thr, cnt
  float* q_rows = row_state + 3 * kRows;
  uint64_t* full = reinterpret_cast<uint64_t*>(q_rows + (kRide ? 0 : kRows * fpad));
  unsigned* released = reinterpret_cast<unsigned*>(full + stages);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // The block's stream of stages: for each of its row groups, every tile's
  // chunks in order.
  const int per_group = n_tiles * n_chunks;
  const int my_groups = (n_groups - int(blockIdx.x) + int(gridDim.x) - 1) / int(gridDim.x);
  const long long total = (long long)my_groups * per_group;

  // Fill stage s with stream position g: the points' chunk, then the
  // chunk of each query tile riding with it, under one expected byte count.
  auto load = [&](long long g, int s) {
    const long long j = g / per_group;
    const int p = int(g % per_group);
    const int t = p / n_chunks, c = p % n_chunks;
    const unsigned bytes = unsigned((c + 1 < n_chunks ? chunk : last + 1) * tile * sizeof(float));
    const size_t off = size_t(c) * chunk * tile;
    float* dst = ring + size_t(s) * stage_floats;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     smem_addr(&full[s])),
                 "r"(bytes * (1 + q_tiles))
                 : "memory");
    bulk_copy(dst, packed + t * tile_floats + off, bytes, &full[s]);
    if constexpr (kRide) {
      const long long q0 = (blockIdx.x + j * gridDim.x) * kRows / tile;
      for (int q = 0; q < q_tiles; ++q) {
        bulk_copy(dst + (q + 1) * pt_floats, packed + (q0 + q) * tile_floats + off, bytes,
                  &full[s]);
      }
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int s = 0; s < stages && s < total; ++s) load(s, s);
  }
  __syncthreads();

  const float inf = __int_as_float(0x7f800000);
  uint64_t* my_buf = buf_keys + warp * R * wide_row_buf(R);
  float* q_sq = row_state + warp * R;
  float* thr = q_sq + kRows;
  int* cnt = reinterpret_cast<int*>(thr + kRows);
  // The warp's staged rows, group-major: group G of row r is float4
  // my_q[G * R + r], so a group's R rows are R consecutive broadcasts.
  float4* my_q = reinterpret_cast<float4*>(q_rows) + warp * R * (fpad / 4);
  // Row r's group h of the stage's chunk: qx[h * q_grp + r], from the
  // stage's query tiles (riding) or from the staged rows.
  const int q_grp = kRide ? tile : R;
  long long g = 0;
  for (int j = 0, s = 0, phase = 0; j < my_groups; ++j) {
    const int grp = blockIdx.x + j * gridDim.x;
    const int row0 = grp * kRows + warp * R;
    uint64_t* my_topk = keys_global
                            ? topk_global + (size_t(blockIdx.x) * kRows + warp * R) * kcap
                            : topk_keys + size_t(warp) * R * kcap;
    __syncwarp();
    for (int i = lane; i < R * kcap; i += 32) my_topk[i] = kSentinelKey;
    if constexpr (!kRide) {
      for (int i = lane; i < R * (fpad / 4); i += 32) {
        const int r = i % R, c = i / R * 4;
        const int row = row0 + r;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = (row < n && c + e < f) ? pts[(size_t)row * f + c + e] : 0.f;
        my_q[i] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    // The prologue's norm; a padded row gets 0 and a threshold of -inf, so
    // its distances are finite and never pass.
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      const bool real = row < n;
      q_sq[r] = real ? packed[(size_t)(row / tile) * tile_floats + size_t(fpad) * tile + row % tile]
                     : 0.f;
      thr[r] = real ? inf : -inf;
      cnt[r] = 0;
    }
    __syncwarp();
    // The warp's rows in the riding query tiles (float4s from the stage's
    // start): tile qi of the stage, point pi of it.
    const int p_w = int(size_t(grp) * kRows % tile) + warp * R;
    const int q_off = (1 + p_w / tile) * (pt_floats / 4) + p_w % tile;

    float d2[2][R];
    for (int t = 0; t < n_tiles; ++t) {
      const unsigned base = unsigned(t) * tile;
      for (int c = 0; c < n_chunks; ++c, ++g) {
        mbar_wait(&full[s], phase);
        const float* st = ring + size_t(s) * stage_floats;
        const float4* fx = reinterpret_cast<const float4*>(st);
        const bool last_chunk = c + 1 == n_chunks;
        const int groups = (last_chunk ? last : chunk) / 4;
        const float4* qx = kRide ? fx + q_off : my_q + c * (chunk / 4) * R;
        // Two points a lane a step (64 a warp); a tile of several chunks is
        // one step, so the cross terms carry over from stage to stage.
        for (int u = 0; u < tile; u += 64) {
          const int i = u + lane;
          int h = 0;
          if (c == 0) {
            wide_group<R, true>(d2, fx + i, qx);
            h = 1;
          }
          for (; h < groups; ++h) wide_group<R, false>(d2, fx + h * tile + i, qx + h * q_grp);
          if (last_chunk) {
            const float* fn = st + size_t(last) * tile;
            // the lower 32 points, then the upper: the scan stays in index order
#pragma unroll 1
            for (int half = 0; half < 2; ++half) {
              float v[R];
#pragma unroll
              for (int r = 0; r < R; ++r) v[r] = half ? d2[1][r] : d2[0][r];
              wide_step<R>(v, fn[i + 32 * half], base + u + 32 * half, q_sq, thr, cnt, my_topk,
                           my_buf, row0, k, kcap, lane);
            }
          }
        }
        // Release the stage; the last warp to release it refills it with the
        // stream position `stages` ahead.
        __syncwarp();
        if (lane == 0) {
          __threadfence_block();
          if (atomicAdd(&released[s], 1u) % kWideWarps == kWideWarps - 1 && g + stages < total) {
            __threadfence_block();
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            load(g + stages, s);
          }
        }
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }

    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      if (row >= n) continue;
      uint64_t* row_topk = my_topk + r * kcap;
      if (cnt[r] > 0) wide_merge<R>(row_topk, my_buf + r * wide_row_buf(R), cnt[r], k, kcap, lane);
      for (int p = lane; p < k; p += 32) {
        const uint64_t key = row_topk[p];
        out_d[(size_t)row * k + p] = __uint_as_float(static_cast<uint32_t>(key >> 32));
        out_i[(size_t)row * k + p] = static_cast<int>(static_cast<uint32_t>(key));
      }
    }
  }
}

template <bool kRide, int R>
int launch_wide(const float* points, const float* packed, int n, int f, int fpad, int chunk,
                int tile, int stages, int k, int kcap, uint64_t* topk_global, float* out_d,
                int* out_i, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(knn_wide_kernel<kRide, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = kWideWarps * R;
  const int n_groups = static_cast<int>((n + rows - 1) / rows);
  const int grid = topk_global != nullptr && n_groups > kWideResidentBlocks ? kWideResidentBlocks
                                                                             : n_groups;
  knn_wide_kernel<kRide, R><<<grid, kWideThreads, smem, s>>>(
      points, packed, n, f, fpad, chunk, tile, stages, k, kcap, n_groups, topk_global, out_d,
      out_i);
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

// Wide instance (any f >= 1, 0 < k < n), from the wrapper's launch plan:
// chunk (wide_chunk of f rounded up to 4), tile (wide_tile of the chunk),
// stages (2-8), rows_per_warp, queries_ride (the query rows' chunk rides in
// each stage; else they are staged whole), kcap (k rounded up to 32) and
// smem_bytes (wide_smem_bytes of the same plan, at most kSmemLimit).
// packed: knn_wide_scratch_bytes(n, f) bytes, 16-byte aligned; topk_scratch
// holds min(row groups, kWideResidentBlocks) x 16 rows_per_warp x kcap keys,
// or is null to keep the keys in shared memory. Returns
// cudaErrorInvalidValue on any other plan.
extern "C" size_t knn_wide_scratch_bytes(int n, int f) {
  return wide_packed_floats(n, f) * sizeof(float);
}

extern "C" int knn_wide_f32(const float* points, int n, int f, int k, int chunk, int tile,
                            int stages, int rows_per_warp, int queries_ride, int kcap,
                            size_t smem_bytes, float* packed, void* topk_scratch, float* out_d,
                            int* out_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ride = queries_ride != 0;
  uint64_t* topk = static_cast<uint64_t*>(topk_scratch);
  const int fpad = wide_fpad(f);
  if (f < 1 || !(0 < k && k < n) || kcap < k || kcap % 32 != 0 || chunk != wide_chunk(fpad) ||
      tile != wide_tile(chunk) || stages < kWideMinStages || stages > kWideMaxStages ||
      !wide_rows_ok(ride, rows_per_warp) ||
      smem_bytes != wide_smem_bytes(fpad, chunk, tile, stages, rows_per_warp, kcap, ride,
                                    topk != nullptr) ||
      smem_bytes > size_t(kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned n_pack = static_cast<unsigned>(wide_packed_floats(n, f) / (fpad + 1));
  pack_general_kernel<<<(n_pack + 255) / 256, 256, 0, s>>>(points, n, f, fpad, tile, n_pack,
                                                           packed);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
#define GW_LAUNCH(Q, R)                                                                   \
  return launch_wide<Q, R>(points, packed, n, f, fpad, chunk, tile, stages, k, kcap, topk, \
                           out_d, out_i, smem_bytes, s)
  if (ride) {
    switch (rows_per_warp) {
      case 8: GW_LAUNCH(true, 8);
      case 4: GW_LAUNCH(true, 4);
      case 2: GW_LAUNCH(true, 2);
      default: GW_LAUNCH(true, 1);
    }
  }
  switch (rows_per_warp) {
    case 8: GW_LAUNCH(false, 8);
    case 6: GW_LAUNCH(false, 6);
    case 4: GW_LAUNCH(false, 4);
    case 3: GW_LAUNCH(false, 3);
    case 2: GW_LAUNCH(false, 2);
    default: GW_LAUNCH(false, 1);
  }
#undef GW_LAUNCH
}

// General instance (1 <= f <= 64, 0 < k < n), from the wrapper's launch
// plan: tile (general_tile of f rounded up to 8), stages (2-4),
// rows_per_warp, queries_in_registers (exactly when f <= 8), kcap (k
// rounded up to 32) and smem_bytes (general_smem_bytes of the same plan,
// at most kSmemLimit). tiles: knn_general_scratch_bytes(n, f) bytes,
// 16-byte aligned. Returns cudaErrorInvalidValue on any other plan.
extern "C" size_t knn_general_scratch_bytes(int n, int f) {
  const int fpad = general_fpad(f);
  const int tile = general_tile(fpad);
  return size_t((n + tile - 1) / tile) * tile * (fpad + 1) * sizeof(float);
}

extern "C" int knn_general_f32(const float* points, int n, int f, int k, int tile, int stages,
                               int rows_per_warp, int queries_in_registers, int kcap,
                               size_t smem_bytes, float* tiles, float* out_d, int* out_i,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool q_reg = queries_in_registers != 0;
  const int fpad = general_fpad(f);
  if (f < 1 || f > kGenMaxF || !(0 < k && k < n) || kcap < k || kcap % 32 != 0 ||
      tile != general_tile(fpad) || stages < kGenMinStages || stages > kGenMaxStages ||
      q_reg != (fpad == kFeatPad) || !general_rows_ok(q_reg, rows_per_warp) ||
      smem_bytes != general_smem_bytes(fpad, tile, stages, rows_per_warp, kcap, q_reg) ||
      smem_bytes > size_t(kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = (n + tile - 1) / tile;
  const unsigned n_pad = unsigned(n_tiles) * tile;
  pack_general_kernel<<<(n_pad + 255) / 256, 256, 0, s>>>(points, n, f, fpad, tile, n_pad, tiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
#define GM_LAUNCH(Q, R)                                                                        \
  return launch_general<Q, R>(points, tiles, n, f, fpad, k, kcap, tile, stages, n_tiles, out_d, \
                              out_i, smem_bytes, s)
  if (q_reg) {
    switch (rows_per_warp) {
      case 6: GM_LAUNCH(true, 6);
      case 4: GM_LAUNCH(true, 4);
      case 3: GM_LAUNCH(true, 3);
      case 2: GM_LAUNCH(true, 2);
      default: GM_LAUNCH(true, 1);
    }
  }
  switch (rows_per_warp) {
    case 8: GM_LAUNCH(false, 8);
    case 6: GM_LAUNCH(false, 6);
    case 4: GM_LAUNCH(false, 4);
    case 3: GM_LAUNCH(false, 3);
    case 2: GM_LAUNCH(false, 2);
    default: GM_LAUNCH(false, 1);
  }
#undef GM_LAUNCH
}

