// The row mode of the bucketed LPA superstep for Hopper (sm_90a): every
// width class of a fused, unweighted BucketedModePlan in one launch per
// width tier.
//
// Replaces no Pallas kernel: the JAX package leaves this mode to XLA ops
// (graphmine_tpu/ops/bucketed_mode.py: a row sort, a scan and reductions a
// width class). The port first did the same in PyTorch
// (ops/bucketed_mode.py::_bucket_mode), which cost about 16 launches a
// wide class and 10 a narrow one, 600-750 a superstep on Graphalytics'
// graph500-22, and ran at 12x its gather floor there (22 ms a superstep
// against ~1.8 ms). This kernel was added for that.
//
// The contract is _bucket_mode's, bit for bit: each row of the plan's
// send_idx[b] ([n_b, w_b] int32 sender ids, padded with V) reads the
// senders' labels; the row's label is the most frequent one, ties to the
// smallest; an entry equal to the sentinel (INT32_MAX) is ignored by value,
// wherever it comes from (a padding slot reads it); a row with no other
// entry yields the sentinel. Labels are arbitrary int32. The result goes to
// out[vertex_ids[b][row]]; out is a copy of the labels, so rows the kernel
// does not own keep their value.
//
// What bounds it: the gather of one label per slot. The labels (4 V bytes,
// 9.6 MB on graph500-22) stay in L2, so each slot costs a random 4-byte L2
// read: at the card's measured 70 G slots/s, 128.3M slots (graph500-22) take
// ~1.8 ms, and reading the [n_b, w_b] sender matrices from HBM (~0.55 GB)
// ~0.16 ms beside it. On top of that each row counts its labels. The design
// keeps the count in registers or shared memory, so a slot is read once from
// HBM, gathered once from L2 and touched a few times on chip:
//
// - Narrow tier (w <= 32): a group of g lanes a row (g the power of two at
//   or above w, so a warp holds 32/g rows), one slot a lane.
//   __match_any_sync finds the lanes that hold the same label, a popcount
//   within the group is that label's count, and a shuffle reduction of
//   (count, smallest label) packed into 64 bits takes the group's best.
// - Mid tier (33 <= w <= 2048): whole warps a row (1, 2, 4 or 8 of a
//   block's 8), each row an open-addressing hash table in static shared
//   memory of at least 2w entries (so at most half full: a probe ends at a
//   free slot), 4096 entries a block. Lanes with the same label are merged
//   by __match_any_sync first, so the leader of each group inserts once
//   with the group's count: converged rows, whose slots mostly hold one
//   label, cost one shared atomic a warp step. The table is then scanned
//   for the best packed key.
// - Wide tier (2048 < w): a table of at most 8192 entries in dynamic
//   shared memory (64 KB, three blocks an SM; the narrow and mid tiers never
//   carry it). A row with more slots than the table may hold is split into
//   parts, each over the labels whose hash falls in one range of the 32-bit
//   hash space, and each part is a block of its own: every label is counted
//   in exactly one part, so the best of the parts is the row's. The parts
//   run side by side on several SMs (a serial pass per part would leave the
//   widest rows, up to 34,992 slots on graph500-22, running alone at the end
//   of the launch); each merges its best into a 64-bit slot of scratch by
//   atomicMax, and the last part to finish writes the row's label and
//   clears the slot for the next launch. A range that fills its table past
//   7/8 (labels chosen to collide) is redone in halves, and the range
//   doubles again after each half that fits: the hash is a bijection, so a
//   range narrow enough always fits and the result stays exact for any
//   labels.
//
// Each tier's classes run widest first, so the longest blocks start first.
//
// The host builds a descriptor a class once, with the plan
// (kernels/mode_cuda.py::plan_table): the pointers of its send_idx and
// vertex_ids (no copy of the plan's matrices), its width and rows, its rows
// a block, its first block within its tier's launch, its group lanes or
// table entries, its parts a row and its scratch (two 64-bit words a row of
// more than one part, zero between launches). A block finds its class by a
// binary search over its tier's first blocks.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int32_t kSentinel = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kNarrowThreads = 256;
constexpr int kMidThreads = 256;
constexpr int kMidTable = 4096;  // int32 keys + int32 counts: 32 KB a block
constexpr int kWideThreads = 512;
constexpr int kWideMaxTable = 8192;  // 64 KB of dynamic shared memory at most

// One class of the plan, as kernels/mode_cuda.py lays it out (int64 each).
struct ClassDesc {
  long long send;            // const int32_t* [rows, width], padded with V
  long long vids;            // const int32_t* [rows]
  long long width;
  long long rows;
  long long rows_per_block;
  long long first_block;     // within the tier's launch
  long long cap;             // narrow: lanes a row; mid, wide: table entries a row
  long long parts;           // wide: blocks (hash ranges) a row; else 1
  long long scratch;         // wide rows of several parts: unsigned long long [rows][2]
};

__device__ __forceinline__ int find_class(const ClassDesc* cls, int n, long long block) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (cls[mid].first_block <= block) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// (count, label) as one key whose maximum is the largest count, then the
// smallest label: the label's order-preserving unsigned form, inverted.
__device__ __forceinline__ unsigned long long mode_key(unsigned count, int32_t label) {
  return (static_cast<unsigned long long>(count) << 32) |
         static_cast<uint32_t>(~(static_cast<uint32_t>(label) ^ 0x80000000u));
}

__device__ __forceinline__ int32_t key_result(unsigned long long key) {
  if ((key >> 32) == 0) return kSentinel;  // the row held no label but the sentinel
  return static_cast<int32_t>(~static_cast<uint32_t>(key) ^ 0x80000000u);
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long key) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) key = umax64(key, __shfl_xor_sync(kFull, key, off));
  return key;
}

__device__ __forceinline__ int32_t slot_label(const int32_t* __restrict__ labels, int32_t sender,
                                              int32_t num_vertices) {
  return sender == num_vertices ? kSentinel : __ldg(labels + sender);
}

// murmur3's finaliser: a bijection of 32 bits that spreads neighbouring labels
__device__ __forceinline__ uint32_t hash32(int32_t label) {
  uint32_t h = static_cast<uint32_t>(label);
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// Adds each distinct label of the warp's lanes to a table of cap (a power of
// two) entries, once with its lanes' count. Lanes holding the sentinel add
// nothing. Returns false where a probe ran the whole table or the table
// passed `limit` claimed entries (the caller then redoes the pass); with
// limit >= cap and a table at most half full it always returns true.
__device__ __forceinline__ bool warp_insert(int32_t* keys, int32_t* counts, int cap,
                                            int32_t label, uint32_t h, int* claimed, int limit) {
  const unsigned same = __match_any_sync(kFull, label);
  if (label == kSentinel || (__ffs(same) - 1) != static_cast<int>(threadIdx.x & 31)) return true;
  volatile int32_t* vkeys = keys;
  uint32_t slot = h & (cap - 1);
  for (int probe = 0; probe < cap; ++probe) {
    int32_t k = vkeys[slot];
    if (k == kSentinel) {
      k = atomicCAS(keys + slot, kSentinel, label);
      if (k == kSentinel) {
        k = label;
        if (claimed != nullptr && atomicAdd(claimed, 1) >= limit) {
          atomicAdd(counts + slot, __popc(same));
          return false;
        }
      }
    }
    if (k == label) {
      atomicAdd(counts + slot, __popc(same));
      return true;
    }
    slot = (slot + 1) & (cap - 1);
  }
  return false;
}

// The best packed key among `cap` entries, strided over `stride` threads
// from `t`.
__device__ __forceinline__ unsigned long long scan_table(const int32_t* keys, const int32_t* counts,
                                                         int cap, int t, int stride) {
  unsigned long long best = 0;
  for (int i = t; i < cap; i += stride) {
    const int32_t c = counts[i];
    if (c > 0) best = umax64(best, mode_key(static_cast<unsigned>(c), keys[i]));
  }
  return best;
}

__global__ void __launch_bounds__(kNarrowThreads)
mode_narrow_kernel(const int32_t* __restrict__ labels, int32_t* __restrict__ out,
                   int32_t num_vertices, const ClassDesc* __restrict__ cls, int n_cls) {
  const ClassDesc d = cls[find_class(cls, n_cls, blockIdx.x)];
  const int w = static_cast<int>(d.width);
  const int g = static_cast<int>(d.cap);  // a power of two >= w, dividing 32
  const int lane = threadIdx.x & 31;
  const int j = threadIdx.x & (g - 1);
  const long long row = (blockIdx.x - d.first_block) * d.rows_per_block + threadIdx.x / g;
  const bool live = row < d.rows;
  int32_t label = kSentinel;
  if (live && j < w) {
    const int32_t* send = reinterpret_cast<const int32_t*>(d.send);
    label = slot_label(labels, send[row * w + j], num_vertices);
  }
  const unsigned group = g == 32 ? kFull : ((1u << g) - 1) << (lane & ~(g - 1));
  const unsigned same = __match_any_sync(kFull, label) & group;
  unsigned long long key = mode_key(label == kSentinel ? 0u : __popc(same), label);
  for (int off = g >> 1; off > 0; off >>= 1) key = umax64(key, __shfl_xor_sync(kFull, key, off));
  if (live && j == 0) out[reinterpret_cast<const int32_t*>(d.vids)[row]] = key_result(key);
}

__global__ void __launch_bounds__(kMidThreads)
mode_mid_kernel(const int32_t* __restrict__ labels, int32_t* __restrict__ out,
                int32_t num_vertices, const ClassDesc* __restrict__ cls, int n_cls) {
  __shared__ int32_t keys[kMidTable];
  __shared__ int32_t counts[kMidTable];
  __shared__ unsigned long long best[kMidThreads / 32];
  const ClassDesc d = cls[find_class(cls, n_cls, blockIdx.x)];
  const int w = static_cast<int>(d.width);
  const int cap = static_cast<int>(d.cap);  // a power of two >= 2w
  const int rows_per_block = static_cast<int>(d.rows_per_block);
  const int per_row = kMidThreads / rows_per_block;  // whole warps
  const int r = threadIdx.x / per_row;
  const int t = threadIdx.x % per_row;
  const long long row = (blockIdx.x - d.first_block) * rows_per_block + r;
  const bool live = row < d.rows;  // uniform over each warp
  int32_t* tk = keys + r * cap;
  int32_t* tc = counts + r * cap;
  for (int i = t; i < cap; i += per_row) {
    tk[i] = kSentinel;
    tc[i] = 0;
  }
  __syncthreads();
  if (live) {
    const int32_t* send = reinterpret_cast<const int32_t*>(d.send) + row * w;
    for (int j0 = 0; j0 < w; j0 += per_row) {
      const int j = j0 + t;
      const int32_t label = j < w ? slot_label(labels, send[j], num_vertices) : kSentinel;
      warp_insert(tk, tc, cap, label, hash32(label), nullptr, cap);
    }
  }
  __syncthreads();
  const unsigned long long k = warp_max(live ? scan_table(tk, tc, cap, t, per_row) : 0ull);
  if ((threadIdx.x & 31) == 0) best[threadIdx.x / 32] = k;
  __syncthreads();
  if (live && t == 0) {
    unsigned long long b = 0;
    for (int i = 0; i < per_row / 32; ++i) b = umax64(b, best[threadIdx.x / 32 + i]);
    out[reinterpret_cast<const int32_t*>(d.vids)[row]] = key_result(b);
  }
}

__global__ void __launch_bounds__(kWideThreads)
mode_wide_kernel(const int32_t* __restrict__ labels, int32_t* __restrict__ out,
                 int32_t num_vertices, const ClassDesc* __restrict__ cls, int n_cls) {
  extern __shared__ int32_t table[];
  __shared__ unsigned long long best[kWideThreads / 32];
  __shared__ int claimed;
  __shared__ int overflow;
  const ClassDesc d = cls[find_class(cls, n_cls, blockIdx.x)];
  const long long b = blockIdx.x - d.first_block;
  const long long row = b / d.parts;
  const long long part = b % d.parts;
  const int w = static_cast<int>(d.width);
  const int cap = static_cast<int>(d.cap);
  int32_t* keys = table;
  int32_t* counts = table + cap;
  const int limit = cap - cap / 8;
  const int32_t* send = reinterpret_cast<const int32_t*>(d.send) + row * w;
  constexpr unsigned long long kSpace = 1ull << 32;
  const unsigned long long span0 = (kSpace + d.parts - 1) / d.parts;
  const unsigned long long end = span0 * (part + 1) < kSpace ? span0 * (part + 1) : kSpace;
  unsigned long long span = span0, lo = span0 * part, part_best = 0;
  while (lo < end) {
    const unsigned long long hi = lo + span < end ? lo + span : end;
    for (int i = threadIdx.x; i < cap; i += kWideThreads) {
      keys[i] = kSentinel;
      counts[i] = 0;
    }
    if (threadIdx.x == 0) {
      claimed = 0;
      overflow = 0;
    }
    __syncthreads();
    for (int j0 = 0; j0 < w; j0 += kWideThreads) {
      if (__shfl_sync(kFull, *static_cast<volatile int*>(&overflow), 0)) break;
      const int j = j0 + threadIdx.x;
      int32_t label = j < w ? slot_label(labels, send[j], num_vertices) : kSentinel;
      const uint32_t h = hash32(label);
      if (h < lo || h >= hi) label = kSentinel;
      if (!warp_insert(keys, counts, cap, label, h, &claimed, limit)) overflow = 1;
    }
    __syncthreads();
    const bool redo = overflow != 0;
    if (!redo) {
      const unsigned long long k = warp_max(scan_table(keys, counts, cap, threadIdx.x,
                                                       kWideThreads));
      if ((threadIdx.x & 31) == 0) best[threadIdx.x / 32] = k;
    }
    __syncthreads();
    if (redo) {
      span = span > 1 ? span / 2 : 1;
    } else {
      for (int i = 0; i < kWideThreads / 32; ++i) part_best = umax64(part_best, best[i]);
      lo = hi;
      span = span < span0 / 2 ? span * 2 : span0;  // regrow after a dense range
    }
    __syncthreads();  // the next range clears the table, the flags and best
  }
  if (threadIdx.x != 0) return;
  const int32_t vertex = reinterpret_cast<const int32_t*>(d.vids)[row];
  if (d.parts == 1) {
    out[vertex] = key_result(part_best);
    return;
  }
  // the parts of a row meet in its scratch: the best key, then a count of
  // parts done; the last reads the key and leaves both zero
  unsigned long long* slot = reinterpret_cast<unsigned long long*>(d.scratch) + 2 * row;
  atomicMax(slot, part_best);
  __threadfence();
  if (atomicAdd(slot + 1, 1ull) == static_cast<unsigned long long>(d.parts - 1)) {
    __threadfence();
    const unsigned long long key = atomicExch(slot, 0ull);
    atomicExch(slot + 1, 0ull);
    out[vertex] = key_result(key);
  }
}

}  // namespace

// labels, out: int32 [num_vertices] on the device (out a copy of labels);
// table: the plan's descriptors, ClassDesc[narrow + mid + wide] in tier
// order on the device; *_blocks: each tier's grid (the last class's first
// block plus its blocks); wide_cap: the largest table of the wide tier's
// classes (entries). Launches each tier that has a class on `stream` and
// returns the first CUDA error, or cudaErrorInvalidValue for a tier shape
// the kernels do not take.
extern "C" int lpa_mode_rows(const int32_t* labels, int32_t* out, int num_vertices,
                             const void* table, int narrow_classes, long long narrow_blocks,
                             int mid_classes, long long mid_blocks, int wide_classes,
                             long long wide_blocks, int wide_cap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ClassDesc* cls = static_cast<const ClassDesc*>(table);
  const long long max_grid = 0x7fffffffLL;
  if (narrow_blocks > max_grid || mid_blocks > max_grid || wide_blocks > max_grid ||
      wide_cap < 0 || wide_cap > kWideMaxTable || (wide_cap & (wide_cap - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (narrow_classes > 0) {
    mode_narrow_kernel<<<static_cast<unsigned>(narrow_blocks), kNarrowThreads, 0, s>>>(
        labels, out, num_vertices, cls, narrow_classes);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cls += narrow_classes;
  if (mid_classes > 0) {
    mode_mid_kernel<<<static_cast<unsigned>(mid_blocks), kMidThreads, 0, s>>>(
        labels, out, num_vertices, cls, mid_classes);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cls += mid_classes;
  if (wide_classes > 0) {
    const int smem = 2 * wide_cap * static_cast<int>(sizeof(int32_t));
    err = cudaFuncSetAttribute(mode_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    mode_wide_kernel<<<static_cast<unsigned>(wide_blocks), kWideThreads, smem, s>>>(
        labels, out, num_vertices, cls, wide_classes);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
