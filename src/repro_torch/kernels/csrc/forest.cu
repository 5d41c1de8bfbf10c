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
// What bounds it on this card.  Not bytes and not operations: a call reads
// R*F*4 bytes of x and a few KB of model and writes R*4 bytes (1.6 ns of
// HBM time at the scheduler's 13 rows), and does T*(D+1) compares and adds
// per row.  At the scheduler's 1-13 rows per decision (and the broker's ~300
// rows per flush) a call is bound by the launch and by the latency of the
// loads that depend on each other: a tree's feature index, then the feature,
// then the leaf.  Scoring a row's trees one after the other in one thread
// puts 3*T such round trips in a chain (about 72 for R.F.'s 24 trees), with
// one warp on one SM doing all the work of a decision.
//
// Design.
// - The trees of a row run on separate lanes: lane t of a row's lane group
//   computes tree t's vote (t, t+32, ... when T > 32).  Where T <= 16, one
//   warp scores 32/P rows, P the power of two >= T (a Tree, T = 1, scores 32
//   rows per warp).  D is a template parameter for D = 1..8, so the level
//   loop unrolls: a lane's D feature indices and thresholds load together,
//   then its D features, then the leaf.  Larger D takes the run-time-D
//   instance of the same template; no depth is refused.
// - The block stages what its rows read in shared memory with one round of
//   cp.async copies (16 bytes where both sides are aligned): the rows' x,
//   the model block (feature indices, thresholds, leaves) and, for the
//   grouped kernel, the segment table (M+1 offsets and M tree counts).  So
//   a call makes one round trip to L2 or device memory (the grouped kernel
//   two: the table, then the model block of the rows' segment); everything
//   after reads shared memory.  A part that does not fit its budget below
//   is read where it lies, through the cache, with the same arithmetic.
// - Grouped grid mapping: a block takes contiguous rows.  Its warps find
//   the block's first segment by binary search in the staged table, and the
//   block walks the segments its rows touch, staging each one's model block
//   in turn (the first n_trees[m] trees only); rows stacked by segment touch
//   one segment per block, or two at a boundary.
// - Bitwise equality with the numpy mirror (ml.forest.forest_predict_np):
//   the row's sum is the left fold in tree order, acc = v0, acc + v1, ...,
//   in float32 over the model's true tree count, then one __fdiv_rn.  The
//   votes are gathered from their lanes by T shuffles read in tree order,
//   not by a tree reduction (which would change the sum), and the fold
//   starts from v0 (0.0f + -0.0f would be +0.0f).  Build without
//   --use_fast_math, which would replace the division.
//
// Each C entry point launches on the given stream and returns the first
// CUDA error (cudaGetLastError() after the launch), so that a refused launch
// raises.  Given pinned host buffers, it also copies the rows in and the
// scores out around the launch on the same stream and waits for them: the
// host path of a decision is then one call.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps per block
constexpr int kModelBudget = 64 * 1024;       // shared-memory bytes, staged
constexpr int kRowsBudget = 32 * 1024;        // only when the part fits
constexpr int kSegBudget = 16 * 1024;
constexpr int kDefaultSmem = 48 * 1024;       // above: opt in per launch

__host__ __device__ constexpr int align4(int words) { return (words + 3) & ~3; }

// Lanes per row: the power of two >= T, at most 32.
__host__ __device__ inline int lanes_per_row(int T) {
  int p = 1;
  while (p < T && p < 32) p <<= 1;
  return p;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying n 4-byte words from device memory to shared memory, the
// whole block together; cp_async_wait_all + __syncthreads completes it.
__device__ __forceinline__ void stage(void* dst, const void* src, long long n) {
  const int tid = threadIdx.x;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) &
       15) == 0) {
    const long long n16 = n >> 2;
    for (long long i = tid; i < n16; i += blockDim.x)
      cp_async16(static_cast<int4*>(dst) + i,
                 static_cast<const int4*>(src) + i);
    done = n16 << 2;
  }
  for (long long i = done + tid; i < n; i += blockDim.x)
    cp_async4(static_cast<int*>(dst) + i, static_cast<const int*>(src) + i);
}

// Tree t's leaf value for row xr.  fi/th are (T, D) and lv (T, 2^D), in
// shared or device memory.  kD > 0 fixes D at compile time; kD == 0 reads it.
template <int kD>
__device__ __forceinline__ float tree_vote(const float* xr, const int* fi,
                                           const float* th, const float* lv,
                                           int t, int D) {
  const int depth = kD > 0 ? kD : D;
  const int* f = fi + static_cast<long long>(t) * depth;
  const float* h = th + static_cast<long long>(t) * depth;
  int leaf = 0;
  if constexpr (kD > 0) {
    int fv[kD];
    float hv[kD], xv[kD];
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      fv[d] = f[d];
      hv[d] = h[d];
    }
#pragma unroll
    for (int d = 0; d < kD; ++d) xv[d] = xr[fv[d]];
#pragma unroll
    for (int d = 0; d < kD; ++d) leaf = (leaf << 1) | (xv[d] > hv[d] ? 1 : 0);
  } else {
    for (int d = 0; d < depth; ++d)
      leaf = (leaf << 1) | (xr[f[d]] > h[d] ? 1 : 0);
  }
  return lv[(static_cast<long long>(t) << depth) + leaf];
}

// The mean over trees [0, n) of row xr, for every lane of a group of P
// lanes (slot = lane % P): lanes vote on trees slot, slot + P, ..., and the
// votes are folded in tree order after shuffles from their lanes.  Every
// lane of the warp must call this with the same n and P.
template <int kD>
__device__ __forceinline__ float row_mean(const float* xr, const int* fi,
                                          const float* th, const float* lv,
                                          int n, int D, int P, int slot) {
  float acc = 0.0f;
  for (int t0 = 0; t0 < n; t0 += P) {
    const int t = t0 + slot;
    const float v = t < n ? tree_vote<kD>(xr, fi, th, lv, t, D) : 0.0f;
    const int k_end = min(P, n - t0);
    for (int k = 0; k < k_end; ++k) {
      const float vk = __shfl_sync(0xffffffffu, v, k, P);
      acc = (t0 + k == 0) ? vk : acc + vk;    // start from tree 0's vote
    }
  }
  return __fdiv_rn(acc, static_cast<float>(n));
}

// What a launch stages in shared memory and the layout of it (in words).
struct Plan {
  int P, rows_per_block, blocks;
  bool model, rows, seg;
  int model_words, rows_words, seg_words;
  int smem_bytes() const {
    return 4 * (align4(model ? model_words : 0) + align4(rows ? rows_words : 0) +
                align4(seg ? seg_words : 0));
  }
};

Plan make_plan(int R, int F, int T, int D, int M, bool grouped) {
  Plan p;
  p.P = lanes_per_row(T);
  p.rows_per_block = (kThreads / 32) * (32 / p.P);
  p.blocks = (R + p.rows_per_block - 1) / p.rows_per_block;
  // feature indices | thresholds | leaves, each section 16-byte aligned
  const long long model =
      2LL * align4(T * D) + (static_cast<long long>(T) << D);
  const long long rows =
      static_cast<long long>(R < p.rows_per_block ? R : p.rows_per_block) * F;
  const long long seg = grouped ? 2LL * M + 1 : 0;
  p.model = 4 * model <= kModelBudget;
  p.rows = 4 * rows <= kRowsBudget;
  p.seg = grouped && 4 * seg <= kSegBudget;
  p.model_words = static_cast<int>(p.model ? model : 0);
  p.rows_words = static_cast<int>(p.rows ? rows : 0);
  p.seg_words = static_cast<int>(p.seg ? seg : 0);
  return p;
}

// The shared-memory sections, in the order model | rows | segment table.
struct Smem {
  int* fi;
  float* th;
  float* lv;
  float* x;
  int* seg;
};

__device__ __forceinline__ Smem carve(unsigned char* base, int T, int D,
                                      int model_words, int rows_words) {
  Smem s;
  float* w = reinterpret_cast<float*>(base);
  s.fi = reinterpret_cast<int*>(w);
  s.th = w + align4(T * D);
  s.lv = s.th + align4(T * D);
  s.x = w + align4(model_words);
  s.seg = reinterpret_cast<int*>(s.x + align4(rows_words));
  return s;
}

template <int kD>
__global__ void __launch_bounds__(kThreads) forest_infer_kernel(
    const float* __restrict__ x, int B, int F, const int* __restrict__ fi,
    const float* __restrict__ th, const float* __restrict__ lv, int T, int D,
    float* __restrict__ out, Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int depth = kD > 0 ? kD : D;
  const Smem s = carve(smem, T, depth, plan.model_words, plan.rows_words);
  const int r0 = blockIdx.x * plan.rows_per_block;
  const int nrows = min(plan.rows_per_block, B - r0);
  const float* xs = x + static_cast<long long>(r0) * F;
  if (plan.model) {
    stage(s.fi, fi, static_cast<long long>(T) * depth);
    stage(s.th, th, static_cast<long long>(T) * depth);
    stage(s.lv, lv, static_cast<long long>(T) << depth);
  }
  if (plan.rows) stage(s.x, xs, static_cast<long long>(nrows) * F);
  cp_async_wait_all();
  __syncthreads();
  const int* mfi = plan.model ? s.fi : fi;
  const float* mth = plan.model ? s.th : th;
  const float* mlv = plan.model ? s.lv : lv;
  if (plan.rows) xs = s.x;

  const int lane = threadIdx.x & 31;
  const int local = (threadIdx.x >> 5) * (32 / plan.P) + lane / plan.P;
  // a warp with no row of its own exits whole (its lanes shuffle together)
  if ((threadIdx.x >> 5) * (32 / plan.P) >= nrows) return;
  const bool live = local < nrows;
  const float* xr = xs + static_cast<long long>(live ? local : 0) * F;
  const float mean =
      row_mean<kD>(xr, mfi, mth, mlv, T, depth, plan.P, lane % plan.P);
  if (live && lane % plan.P == 0) out[r0 + local] = mean;
}

template <int kD>
__global__ void __launch_bounds__(kThreads) forest_infer_grouped_kernel(
    const float* __restrict__ x, int R, int F,
    const int* __restrict__ seg_start, int M, const int* __restrict__ fi,
    const float* __restrict__ th, const float* __restrict__ lv,
    const int* __restrict__ n_trees, int T, int D, float* __restrict__ out,
    Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int depth = kD > 0 ? kD : D;
  const Smem s = carve(smem, T, depth, plan.model_words, plan.rows_words);
  const int r0 = blockIdx.x * plan.rows_per_block;
  const int nrows = min(plan.rows_per_block, R - r0);
  const int r1 = r0 + nrows;
  const float* xs = x + static_cast<long long>(r0) * F;
  if (plan.rows) stage(s.x, xs, static_cast<long long>(nrows) * F);
  if (plan.seg) {
    stage(s.seg, seg_start, M + 1);
    stage(s.seg + M + 1, n_trees, M);
  }
  cp_async_wait_all();
  __syncthreads();
  if (plan.rows) xs = s.x;
  const int* seg = plan.seg ? s.seg : seg_start;
  const int* nt = plan.seg ? s.seg + M + 1 : n_trees;

  // the last segment m with seg[m] <= r0; empty segments repeat an offset
  // and are skipped by taking the last one
  int lo = 0, hi = M;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (seg[mid] <= r0) lo = mid; else hi = mid;
  }

  const int lane = threadIdx.x & 31;
  const int warp_first = (threadIdx.x >> 5) * (32 / plan.P);
  const int local = warp_first + lane / plan.P;
  const long long L = 1LL << depth;
  for (int m = lo; m < M && seg[m] < r1; ++m) {
    const int lo_r = max(seg[m], r0), hi_r = min(seg[m + 1], r1);
    if (hi_r <= lo_r) continue;                // empty, or not this block's
    const int n = nt[m];
    const long long blk = static_cast<long long>(m) * T;
    const int* mfi = fi + blk * depth;
    const float* mth = th + blk * depth;
    const float* mlv = lv + blk * L;
    if (plan.model) {
      __syncthreads();                         // the last segment is read
      stage(s.fi, mfi, static_cast<long long>(n) * depth);
      stage(s.th, mth, static_cast<long long>(n) * depth);
      stage(s.lv, mlv, static_cast<long long>(n) * L);
      cp_async_wait_all();
      __syncthreads();
      mfi = s.fi;
      mth = s.th;
      mlv = s.lv;
    }
    // a warp with no row in this segment skips it whole
    const int w_lo = r0 + warp_first, w_hi = w_lo + 32 / plan.P;
    if (w_hi <= lo_r || w_lo >= hi_r) continue;
    const int r = r0 + local;
    const bool live = r >= lo_r && r < hi_r;
    const float* xr = xs + static_cast<long long>(live ? local : lo_r - r0) * F;
    const float mean =
        row_mean<kD>(xr, mfi, mth, mlv, n, depth, plan.P, lane % plan.P);
    if (live && lane % plan.P == 0) out[r] = mean;
  }
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, const Plan& plan) {
  if (plan.smem_bytes() <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              plan.smem_bytes());
}

template <int kD>
cudaError_t launch_single(const float* x, int B, int F, const int* fi,
                          const float* th, const float* lv, int T, int D,
                          float* out, cudaStream_t stream) {
  const Plan plan = make_plan(B, F, T, D, 1, false);
  const cudaError_t rc = opt_in(forest_infer_kernel<kD>, plan);
  if (rc != cudaSuccess) return rc;
  forest_infer_kernel<kD><<<plan.blocks, kThreads, plan.smem_bytes(),
                            stream>>>(x, B, F, fi, th, lv, T, D, out, plan);
  return cudaGetLastError();
}

template <int kD>
cudaError_t launch_grouped(const float* x, int R, int F, const int* seg_start,
                           int M, const int* fi, const float* th,
                           const float* lv, const int* n_trees, int T, int D,
                           float* out, cudaStream_t stream) {
  const Plan plan = make_plan(R, F, T, D, M, true);
  const cudaError_t rc = opt_in(forest_infer_grouped_kernel<kD>, plan);
  if (rc != cudaSuccess) return rc;
  forest_infer_grouped_kernel<kD><<<plan.blocks, kThreads, plan.smem_bytes(),
                                    stream>>>(x, R, F, seg_start, M, fi, th,
                                              lv, n_trees, T, D, out, plan);
  return cudaGetLastError();
}

// D as a compile-time constant for D = 1..8; any other D runs the
// run-time-D instance.
#define FOREST_BY_DEPTH(FN, ...)             \
  switch (D) {                               \
    case 1: return FN<1>(__VA_ARGS__);       \
    case 2: return FN<2>(__VA_ARGS__);       \
    case 3: return FN<3>(__VA_ARGS__);       \
    case 4: return FN<4>(__VA_ARGS__);       \
    case 5: return FN<5>(__VA_ARGS__);       \
    case 6: return FN<6>(__VA_ARGS__);       \
    case 7: return FN<7>(__VA_ARGS__);       \
    case 8: return FN<8>(__VA_ARGS__);       \
    default: return FN<0>(__VA_ARGS__);      \
  }

cudaError_t dispatch_single(const float* x, int B, int F, const int* fi,
                            const float* th, const float* lv, int T, int D,
                            float* out, cudaStream_t stream) {
  FOREST_BY_DEPTH(launch_single, x, B, F, fi, th, lv, T, D, out, stream)
}

cudaError_t dispatch_grouped(const float* x, int R, int F,
                             const int* seg_start, int M, const int* fi,
                             const float* th, const float* lv,
                             const int* n_trees, int T, int D, float* out,
                             cudaStream_t stream) {
  FOREST_BY_DEPTH(launch_grouped, x, R, F, seg_start, M, fi, th, lv, n_trees,
                  T, D, out, stream)
}

#undef FOREST_BY_DEPTH

// A launch with the host's copies around it, all on one stream: host_in's
// in_bytes to dev_in first (when host_in is given), the launch, then
// out_bytes of out back to host_out and one wait for the stream (when
// host_out is given).  A scheduling decision is one such call: one copy
// each way, one synchronisation, and no host work in between.
template <typename Launch>
cudaError_t with_copies(void* dev_in, const void* host_in, long long in_bytes,
                        const void* out, void* host_out, long long out_bytes,
                        cudaStream_t stream, Launch launch) {
  cudaError_t rc = cudaSuccess;
  if (host_in != nullptr)
    rc = cudaMemcpyAsync(dev_in, host_in, in_bytes, cudaMemcpyHostToDevice,
                         stream);
  if (rc == cudaSuccess) rc = launch();
  if (rc == cudaSuccess && host_out != nullptr) {
    rc = cudaMemcpyAsync(host_out, out, out_bytes, cudaMemcpyDeviceToHost,
                         stream);
    if (rc == cudaSuccess) rc = cudaStreamSynchronize(stream);
  }
  return rc;
}

}  // namespace

extern "C" {

// host_in / host_out may be null: then the caller moves the rows and the
// scores itself.  Otherwise host_in (pinned) holds the in_bytes that go to
// x's address (the grouped call's rows, then its segment offsets), and the
// scores come back to host_out (pinned) before the call returns.
int forest_infer_launch(void* x, int B, int F, const void* feat_idx,
                        const void* thresholds, const void* leaves, int T,
                        int D, void* out, const void* host_in,
                        long long in_bytes, void* host_out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_copies(
      x, host_in, in_bytes, out, host_out, 4LL * B, s, [&] {
        if (B <= 0) return cudaGetLastError();
        return dispatch_single(
            static_cast<const float*>(x), B, F,
            static_cast<const int*>(feat_idx),
            static_cast<const float*>(thresholds),
            static_cast<const float*>(leaves), T, D, static_cast<float*>(out),
            s);
      }));
}

int forest_infer_grouped_launch(void* x, int R, int F, const void* seg_start,
                                int M, const void* feat_idx,
                                const void* thresholds, const void* leaves,
                                const void* n_trees, int T, int D, void* out,
                                const void* host_in, long long in_bytes,
                                void* host_out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_copies(
      x, host_in, in_bytes, out, host_out, 4LL * R, s, [&] {
        if (R <= 0) return cudaGetLastError();
        return dispatch_grouped(
            static_cast<const float*>(x), R, F,
            static_cast<const int*>(seg_start), M,
            static_cast<const int*>(feat_idx),
            static_cast<const float*>(thresholds),
            static_cast<const float*>(leaves),
            static_cast<const int*>(n_trees), T, D, static_cast<float*>(out),
            s);
      }));
}

}  // extern "C"
