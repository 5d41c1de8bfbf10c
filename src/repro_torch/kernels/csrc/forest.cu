// Oblivious-forest inference for Hopper (sm_90a): the ATLAS scoring kernels.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   forest_infer_kernel         <- repro/kernels/forest.py:forest_infer (_kernel)
//   forest_infer_grouped_kernel <- repro/kernels/forest.py:forest_infer_grouped
//                                  (_grouped_call, _grouped_kernel)
//
// What it computes.  Tree t of an oblivious forest tests, at level d,
// x[feat_idx[t, d]] > thresholds[t, d]; the D bits, level 0 first, index one
// of the tree's 2^D leaves.  A row's score is the mean leaf value over the
// trees.  The grouped kernel scores rows stacked segment by segment, each
// against only its own model's padded (T, D) block, and divides by that
// model's true tree count.
//
// Design.  One thread per row.  For each tree the thread gathers its D
// tested features, compares, builds the leaf index with integer shifts,
// gathers the leaf and adds it to a float32 accumulator in tree order
// 0..n-1, then divides once with correct rounding (__fdiv_rn).  That is the
// arithmetic of the numpy mirror ml.forest.forest_predict_np step for step,
// so the scores are bitwise equal to it at every batch size: scheduling
// decisions do not depend on batch size or device.  The TPU kernel's
// one-hot selector matmul is not carried over: it was a workaround for the
// TPU's gathers, and under TF32 it would round features and flip threshold
// bits.  Build without --use_fast_math, which would replace the division.
//
// What bounds it on this card.  Memory: a call reads R*F*4 bytes of x plus
// the model blocks (a few KB, read by every thread through the read-only
// cache) once and writes R*4 bytes.  At the scheduler's 1-13 rows per
// decision it is bound by launch latency, far below both the bytes and the
// operations bound; the design does nothing against that yet beyond keeping
// the model resident on the device, so that only x moves per call (the host
// caches the device copies).  The grouped kernel takes the segment offsets
// directly (a (M+1,) prefix sum; each row binary-searches its segment)
// instead of the TPU path's host-side per-segment padding copy.
//
// Each C entry point launches on the given stream, does not synchronise,
// and returns cudaGetLastError() so that a refused launch raises.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// Score of row xr against trees [0, n) of one (T_stride, D) block.
__device__ __forceinline__ float score_row(
    const float* __restrict__ xr, const int* __restrict__ fi,
    const float* __restrict__ th, const float* __restrict__ lv, int n, int D) {
  const int L = 1 << D;
  float acc = 0.0f;
  for (int t = 0; t < n; ++t) {
    const int* f = fi + t * D;
    const float* h = th + t * D;
    int leaf = 0;
    for (int d = 0; d < D; ++d) {
      leaf = (leaf << 1) | (xr[__ldg(f + d)] > __ldg(h + d) ? 1 : 0);
    }
    const float v = __ldg(lv + t * L + leaf);
    acc = (t == 0) ? v : acc + v;  // start from tree 0's vote, as numpy does
  }
  return __fdiv_rn(acc, static_cast<float>(n));
}

__global__ void forest_infer_kernel(
    const float* __restrict__ x, int B, int F, const int* __restrict__ fi,
    const float* __restrict__ th, const float* __restrict__ lv, int T, int D,
    float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  out[r] = score_row(x + static_cast<long long>(r) * F, fi, th, lv, T, D);
}

__global__ void forest_infer_grouped_kernel(
    const float* __restrict__ x, int R, int F,
    const int* __restrict__ seg_start, int M, const int* __restrict__ fi,
    const float* __restrict__ th, const float* __restrict__ lv,
    const int* __restrict__ n_trees, int T, int D, float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  // the last segment m with seg_start[m] <= r; empty segments repeat an
  // offset and are skipped by taking the last one
  int lo = 0, hi = M;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(seg_start + mid) <= r) lo = mid; else hi = mid;
  }
  const int m = lo;
  const long long blk = static_cast<long long>(m) * T;
  out[r] = score_row(x + static_cast<long long>(r) * F, fi + blk * D,
                     th + blk * D, lv + blk * (1 << D), __ldg(n_trees + m), D);
}

}  // namespace

extern "C" {

int forest_infer_launch(const void* x, int B, int F, const void* feat_idx,
                        const void* thresholds, const void* leaves, int T,
                        int D, void* out, void* stream) {
  if (B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    forest_infer_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), B, F, static_cast<const int*>(feat_idx),
        static_cast<const float*>(thresholds),
        static_cast<const float*>(leaves), T, D, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int forest_infer_grouped_launch(const void* x, int R, int F,
                                const void* seg_start, int M,
                                const void* feat_idx, const void* thresholds,
                                const void* leaves, const void* n_trees, int T,
                                int D, void* out, void* stream) {
  if (R > 0) {
    const int blocks = (R + kThreads - 1) / kThreads;
    forest_infer_grouped_kernel<<<blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), R, F,
        static_cast<const int*>(seg_start), M,
        static_cast<const int*>(feat_idx),
        static_cast<const float*>(thresholds),
        static_cast<const float*>(leaves), static_cast<const int*>(n_trees),
        T, D, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
