// Exact k nearest neighbours (squared Euclidean, self excluded) with a
// running per-row top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernel graphmine_tpu/pallas_kernels/knn_pallas.py
// (knn_pallas, body _knn_kernel): a sequential grid of [TM, TC] distance
// tiles, each folded into a per-row top-k by k rounds of min-extraction.
// That fold costs O(k) vector work per candidate and does not carry over.
//
// What bounds it here: compute. At the pipeline's shape (N = 262,144
// points, F = 8 features, k = 128) the kernel evaluates N^2 = 6.9e10
// distances of 2F+3 float32 operations each, while it reads only N*F*4
// bytes and writes N*k*8. It stays on the FP32 pipes on purpose: the JAX
// package forces true float32 distances (TF32 or bf16 rounding moved
// neighbour indices), so there are no tensor cores, and every product and
// sum is rounded on its own (__fmul_rn/__fadd_rn: no FMA contraction) in
// the order of the plain PyTorch version (graphmine_tpu_torch/ops/knn.py),
// which makes the two bit-equal. PERF.md has its time beside that bound.
//
// Design (F <= 8 features, k <= 128): a block of 8 warps owns 32 query
// rows (4 per warp) and walks all reference points in ascending index
// order through a shared-memory tile (features stored feature-major so a
// warp's 32 lanes read 32 consecutive floats). Each lane takes one
// reference point per step and computes its distance to the warp's 4
// query rows, reusing the 9 shared loads across them. Each row's sorted
// top-k (distance, index) lives in registers, spread over the warp (lane
// l holds positions l*KPL .. l*KPL+KPL-1, KPL = 1 for k <= 32, else 4),
// with a threshold equal to the current k-th distance: most candidates fail
// `d2 < threshold` and cost one compare. A warp ballot collects the lanes
// that pass; they are inserted one at a time, lowest lane (smallest index)
// first, each re-checked against the shrinking threshold. An insertion
// counts the entries <= d2 (a warp reduction) and shifts the tail right
// by one with a lane shuffle. Inserting after equal entries, with
// candidates arriving in ascending index order, keeps ties on the smaller
// index: the reference's rule.
//
// C interface (bound with ctypes): knn_topk_f32 launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
// Features are padded to 8 in registers and in the shared tile; zero
// features add exact zeros to every sum, so distances do not change.
constexpr int kFeatPad = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int KPL>
__device__ __forceinline__ void insert_sorted(float (&d)[KPL], int (&ix)[KPL],
                                              float nd, int ni, int lane, int k) {
  int cnt = 0;
#pragma unroll
  for (int s = 0; s < KPL; ++s) {
    const int p = lane * KPL + s;
    cnt += (p < k && d[s] <= nd) ? 1 : 0;
  }
  const int pos = __reduce_add_sync(kFull, cnt);
  const float carry_d = __shfl_up_sync(kFull, d[KPL - 1], 1);
  const int carry_i = __shfl_up_sync(kFull, ix[KPL - 1], 1);
#pragma unroll
  for (int s = KPL - 1; s >= 0; --s) {
    const int p = lane * KPL + s;
    const float prev_d = s > 0 ? d[s > 0 ? s - 1 : 0] : carry_d;
    const int prev_i = s > 0 ? ix[s > 0 ? s - 1 : 0] : carry_i;
    if (p > pos) {
      d[s] = prev_d;
      ix[s] = prev_i;
    } else if (p == pos) {
      d[s] = nd;
      ix[s] = ni;
    }
  }
}

template <int KPL>
__device__ __forceinline__ float kth_distance(const float (&d)[KPL], int k) {
  const int owner = (k - 1) / KPL;
  const int slot = (k - 1) % KPL;
  float v = 0.f;
#pragma unroll
  for (int s = 0; s < KPL; ++s) {
    if (s == slot) v = d[s];
  }
  return __shfl_sync(kFull, v, owner);
}

template <int KPL>
__global__ void __launch_bounds__(kWarps * 32)
knn_topk_kernel(const float* __restrict__ pts, int n, int f, int k,
                float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int kTile = 1024;
  __shared__ float tile[kFeatPad][kTile];
  __shared__ float tile_sq[kTile];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const float inf = __int_as_float(0x7f800000);

  float q[kRowsPerWarp][kFeatPad];
  float q_sq[kRowsPerWarp];
  float thr[kRowsPerWarp];
  float best_d[kRowsPerWarp][KPL];
  int best_i[kRowsPerWarp][KPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int c = 0; c < kFeatPad; ++c) {
      q[r][c] = (row < n && c < f) ? pts[(size_t)row * f + c] : 0.f;
    }
    float s = __fmul_rn(q[r][0], q[r][0]);
#pragma unroll
    for (int c = 1; c < kFeatPad; ++c) s = __fadd_rn(s, __fmul_rn(q[r][c], q[r][c]));
    q_sq[r] = s;
    thr[r] = inf;
#pragma unroll
    for (int s2 = 0; s2 < KPL; ++s2) {
      best_d[r][s2] = inf;
      best_i[r][s2] = -1;
    }
  }

  for (int base = 0; base < n; base += kTile) {
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
      const int j = base + t;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kFeatPad; ++c) {
        const float v = (j < n && c < f) ? pts[(size_t)j * f + c] : 0.f;
        tile[c][t] = v;
        s = c == 0 ? __fmul_rn(v, v) : __fadd_rn(s, __fmul_rn(v, v));
      }
      tile_sq[t] = s;
    }
    __syncthreads();
    const int lim = min(kTile, n - base);
    for (int t0 = 0; t0 < lim; t0 += 32) {
      const int t = t0 + lane;
      const int j = base + t;
      float c[kFeatPad];
#pragma unroll
      for (int cc = 0; cc < kFeatPad; ++cc) c[cc] = tile[cc][t];
      const float c_sq = tile_sq[t];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        float cross = __fmul_rn(q[r][0], c[0]);
#pragma unroll
        for (int cc = 1; cc < kFeatPad; ++cc) cross = __fadd_rn(cross, __fmul_rn(q[r][cc], c[cc]));
        float d2 = __fadd_rn(__fsub_rn(q_sq[r], __fmul_rn(2.f, cross)), c_sq);
        d2 = d2 > 0.f ? d2 : 0.f;
        const int row = row0 + r;
        const bool cand = t < lim && row < n && j != row && d2 < thr[r];
        unsigned mask = __ballot_sync(kFull, cand);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const float nd = __shfl_sync(kFull, d2, src);
          if (nd < thr[r]) {
            insert_sorted<KPL>(best_d[r], best_i[r], nd, base + t0 + src, lane, k);
            thr[r] = kth_distance<KPL>(best_d[r], k);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= n) continue;
#pragma unroll
    for (int s = 0; s < KPL; ++s) {
      const int p = lane * KPL + s;
      if (p < k) {
        out_d[(size_t)row * k + p] = best_d[r][s];
        out_i[(size_t)row * k + p] = best_i[r][s];
      }
    }
  }
}

void launch(const float* pts, int n, int f, int k, float* out_d, int* out_i,
            cudaStream_t stream) {
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kWarps * 32);
  if (k <= 32) {
    knn_topk_kernel<1><<<grid, block, 0, stream>>>(pts, n, f, k, out_d, out_i);
  } else {
    knn_topk_kernel<4><<<grid, block, 0, stream>>>(pts, n, f, k, out_d, out_i);
  }
}

}  // namespace

// points: float32 [n, f] row-major; out_d float32 [n, k]; out_i int32 [n, k].
// Requires 0 < k < n, k <= 128, f <= 8 (checked by the Python wrapper).
extern "C" int knn_topk_f32(const float* points, int n, int f, int k,
                            float* out_d, int* out_i, void* stream) {
  launch(points, n, f, k, out_d, out_i, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
