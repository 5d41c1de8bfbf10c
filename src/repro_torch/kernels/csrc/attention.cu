// Attention kernels for Hopper (sm_90a): prefill and KV-cache decode of the
// dense LM serving path.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   flash_attention_kernel   <- repro/kernels/flash_attention.py:flash_attention
//                               (_kernel)
//   decode_attention_kernel  <- repro/kernels/decode_attention.py:
//   + decode_merge_kernel       decode_attention (_kernel)
//
// What they compute.  Softmax attention with GQA: q (B, S, H, D) against
// k/v (B, Skv, Hkv, D), query head h reading kv head h / G (G = H / Hkv).
// Scores are scaled by 1/sqrt(D).  flash: queries are right-aligned (query i
// sits at position i + Skv - S); causal keeps keys at or before the query,
// a window w keeps keys after position - w.  decode: one query token per
// sequence against a cache whose live prefix is kv_len[b] keys; a window w
// keeps the last w of them.  Scores, softmax and accumulators are float32
// (p stays float32 in the PV product, as the plain version's does; the
// Pallas kernel rounds p to v's type), the output is cast to q's type.
// Masked scores are NEG_INF = -0.7 * FLT_MAX and the denominator is floored
// at 1e-37, as in the reference.
//
// flash design.  One block per (query tile, kv head, batch row).  The block
// holds FA_ROWS = 64 rows, each one (query position, query head) pair of
// the kv head's G query heads, so every K/V tile is loaded into shared
// memory once for the whole GQA group.  It walks the key tiles that some
// row of the block can see (tiles wholly masked by causality or the window
// are never loaded) with a float32 online softmax: running max and
// denominator per row, the accumulator in registers.  256 threads: thread
// (tr, tc) owns rows tr + 16 i (i < 4) and, per tile, keys tc + 16 j
// (j < 4) of the score tile and output columns tc + 16 c (c < D / 16);
// the 16 threads of one row group are one half-warp, so row maxima and sums
// are shuffles.  Q and K rows are padded to D + 1 floats and P rows to 65,
// so the strided reads do not collide in shared-memory banks.  The query
// tile is 64 / G positions; S need not be a multiple of it (the ragged tail
// is masked), nor Skv of the key tile.
//
// decode design (split-K).  At the serving shape there are only B * Hkv =
// 32 (sequence, kv head) pairs for 132 SMs, so the live key range of each
// pair is cut into DA_CHUNK = 64-key chunks, one block each.  A block
// computes its chunk's scores for all G query heads (one warp per key, the
// lanes across D, a shuffle reduction), the chunk's own max, sum and
// unnormalised PV product, and writes them to a float32 scratch.  Chunks
// wholly outside the live range return at once, so keys past kv_len (and
// before the window) are never read.  decode_merge_kernel then rescales
// the chunks' partial results to their common max and divides once.
//
// What bounds them on this card.  flash at the prefill shape (B=4,
// S=Skv=1024, H=32, Hkv=8, D=128, causal, bf16) does 34.4 GFLOP on 84 MB:
// compute-bound on the tensor cores (34.8 us at 989 TFLOP/s).  This kernel
// runs its products on the float32 CUDA cores from shared memory, so it is
// bound by the FMA rate and the shared-memory loads that feed it (eight
// loads per 16 FMAs in the score loop, 12 per 32 in the PV loop at D =
// 128); tensor-core
// tiles (mma/wgmma), TMA and warp specialisation are left to a later
// change.  decode reads the live K/V (about 17.8 MB per layer at the
// serving shape, 5.3 us at 3.35 TB/s) and does 4 FLOP per byte: memory-
// bound.  Its design spreads the bytes over enough blocks to keep every SM
// loading, and each warp reads whole 2*D-byte key rows.
//
// Each C entry point launches on the given stream, does not synchronise,
// and returns cudaGetLastError() so that a refused launch raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float NEG_INF = -0.7f * 3.402823466e38f;
constexpr int FA_ROWS = 64;
constexpr int FA_BK = 64;
constexpr int FA_THREADS = 256;
constexpr int DA_CHUNK = 64;
constexpr int DA_THREADS = 128;
constexpr int DA_MAX_G = 16;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int D>
constexpr int flash_smem_bytes() {
  return 4 * (FA_ROWS * (D + 1) + FA_BK * (D + 1) + FA_BK * D +
              FA_ROWS * (FA_BK + 1));
}

// grid (ceil(S / bq), Hkv, B), FA_THREADS threads, flash_smem_bytes<D>()
template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int S, int Skv, int H, int Hkv, int causal,
    int window, float scale) {
  constexpr int QS = D + 1;       // Q and K row stride (floats)
  constexpr int PS = FA_BK + 1;   // P row stride
  constexpr int DC = D / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                    // FA_ROWS x QS, pre-scaled
  float* k_s = q_s + FA_ROWS * QS;      // FA_BK x QS
  float* v_s = k_s + FA_BK * QS;        // FA_BK x D
  float* p_s = v_s + FA_BK * D;         // FA_ROWS x PS

  const int G = H / Hkv;
  const int bq = FA_ROWS / G;           // query positions per block
  const int rows = bq * G;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int s0 = blockIdx.x * bq;
  const int s_end = min(s0 + bq, S);
  const int offset = Skv - S;
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;

  // rows r = qi * G + g: for one query position the G heads of kv head hk
  // are contiguous in q, so the load is contiguous per position
  for (int e = tid; e < FA_ROWS * D; e += FA_THREADS) {
    const int r = e / D, d = e % D;
    const int qi = r / G, g = r % G;
    float x = 0.0f;
    if (r < rows && s0 + qi < S)
      x = to_f32(q[((static_cast<long long>(b) * S + s0 + qi) * H + hk * G + g) * D + d]) * scale;
    q_s[r * QS + d] = x;
  }

  // the keys some row of this block can see
  const int pos_first = s0 + offset, pos_last = s_end - 1 + offset;
  const int k_end = causal ? min(Skv, pos_last + 1) : Skv;
  const int k_beg = window ? max(0, pos_first - window + 1) : 0;

  int qpos[4];
  bool row_live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    qpos[i] = s0 + r / G + offset;
    row_live[i] = r < rows && s0 + r / G < S;
  }
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = k_beg; kt < k_end; kt += FA_BK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < FA_BK * D; e += FA_THREADS) {
      const int j = e / D, d = e % D;
      const int key = kt + j;
      float kx = 0.0f, vx = 0.0f;
      if (key < k_end) {
        const long long at = ((static_cast<long long>(b) * Skv + key) * Hkv + hk) * D + d;
        kx = to_f32(k[at]);
        vx = to_f32(v[at]);
      }
      k_s[j * QS + d] = kx;
      v_s[j * D + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q_s[(tr + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = k_s[(tc + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt + tc + 16 * j;
        bool ok = key < k_end;
        if (causal) ok = ok && key <= qpos[i];
        if (window) ok = ok && key > qpos[i] - window;
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[(tr + 16 * i) * PS + tc + 16 * j] = p;
      }
      sum = half_warp_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < FA_BK; ++j) {
      float pa[4], vb[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = p_s[(tr + 16 * i) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vb[c] = v_s[j * D + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pa[i], vb[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_live[i]) continue;
    const int r = tr + 16 * i;
    const int qi = r / G, g = r % G;
    const float den = fmaxf(l[i], 1e-37f);
    T* o = out + ((static_cast<long long>(b) * S + s0 + qi) * H + hk * G + g) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tc + 16 * c] = from_f32<T>(acc[i][c] / den);
  }
}

// The live keys of sequence b: [lo, hi), within the cache.
__device__ __forceinline__ void live_range(const int* kv_len, int b, int Smax,
                                           int window, int* lo, int* hi) {
  const int n = kv_len[b];
  *hi = min(n, Smax);
  *lo = window ? max(0, n - window) : 0;
}

// grid (n_chunks, Hkv, B), DA_THREADS threads.  Partial results per chunk:
// part_m/part_l (B, Hkv, n_chunks, G), part_o (B, Hkv, n_chunks, G, D).
template <typename T, int D>
__global__ void __launch_bounds__(DA_THREADS) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kv_len, int Smax, int H, int Hkv, int window,
    float scale, float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_o) {
  constexpr int PER_LANE = D / 32;
  constexpr int NSUB = DA_THREADS / D;   // key subsets in the PV loop
  __shared__ float q_s[DA_MAX_G * D];
  __shared__ float s_s[DA_MAX_G * DA_CHUNK];
  __shared__ float red_s[DA_MAX_G * DA_THREADS];

  const int G = H / Hkv;
  const int c = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  int lo, hi;
  live_range(kv_len, b, Smax, window, &lo, &hi);
  const int j0 = max(lo, c * DA_CHUNK), j1 = min(hi, (c + 1) * DA_CHUNK);
  if (j0 >= j1) return;                  // the merge skips this chunk
  const int n = j1 - j0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < G * D; e += DA_THREADS)
    q_s[e] = to_f32(q[(static_cast<long long>(b) * H + hk * G) * D + e]) * scale;
  __syncthreads();

  // scores: one warp per key, lanes across D
  for (int j = warp; j < n; j += DA_THREADS / 32) {
    const T* kr = k + ((static_cast<long long>(b) * Smax + j0 + j) * Hkv + hk) * D + lane * PER_LANE;
    float kx[PER_LANE];
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) kx[e] = to_f32(kr[e]);
    for (int g = 0; g < G; ++g) {
      float dot = 0.0f;
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e)
        dot = fmaf(q_s[g * D + lane * PER_LANE + e], kx[e], dot);
      dot = warp_sum(dot);
      if (lane == 0) s_s[g * DA_CHUNK + j] = dot;
    }
  }
  __syncthreads();

  // the chunk's max and sum per query head: one warp per head
  const long long pm = ((static_cast<long long>(b) * Hkv + hk) * n_chunks + c) * G;
  for (int g = warp; g < G; g += DA_THREADS / 32) {
    float mx = NEG_INF;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, s_s[g * DA_CHUNK + j]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(s_s[g * DA_CHUNK + j] - mx);
      s_s[g * DA_CHUNK + j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      part_m[pm + g] = mx;
      part_l[pm + g] = sum;
    }
  }
  __syncthreads();

  // unnormalised PV: thread (sub, d) sums keys sub, sub + NSUB, ...
  const int d = tid % D, sub = tid / D;
  float acc[DA_MAX_G];
#pragma unroll
  for (int g = 0; g < DA_MAX_G; ++g) acc[g] = 0.0f;
  for (int j = sub; j < n; j += NSUB) {
    const float vx = to_f32(v[((static_cast<long long>(b) * Smax + j0 + j) * Hkv + hk) * D + d]);
#pragma unroll
    for (int g = 0; g < DA_MAX_G; ++g)
      if (g < G) acc[g] = fmaf(s_s[g * DA_CHUNK + j], vx, acc[g]);
  }
  float* po = part_o + pm * D;
  if constexpr (NSUB == 1) {
    for (int g = 0; g < G; ++g) po[g * D + d] = acc[g];
  } else {
#pragma unroll
    for (int g = 0; g < DA_MAX_G; ++g)
      if (g < G) red_s[(g * NSUB + sub) * D + d] = acc[g];
    __syncthreads();
    for (int e = tid; e < G * D; e += DA_THREADS) {
      const int g = e / D, dd = e % D;
      float t = 0.0f;
      for (int s = 0; s < NSUB; ++s) t += red_s[(g * NSUB + s) * D + dd];
      po[g * D + dd] = t;
    }
  }
}

// grid (Hkv, B), DA_THREADS threads: out[b, 0, hk*G + g, d] from the live
// chunks' partial results, rescaled to their common max.
template <typename T>
__global__ void __launch_bounds__(DA_THREADS) decode_merge_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_o, const int* __restrict__ kv_len,
    int Smax, int H, int Hkv, int D, int window, int n_chunks,
    T* __restrict__ out) {
  const int G = H / Hkv;
  const int hk = blockIdx.x, b = blockIdx.y;
  int lo, hi;
  live_range(kv_len, b, Smax, window, &lo, &hi);
  const int c0 = lo / DA_CHUNK;
  const int c1 = hi > lo ? (hi - 1) / DA_CHUNK + 1 : c0;
  const long long base = (static_cast<long long>(b) * Hkv + hk) * n_chunks;
  for (int e = threadIdx.x; e < G * D; e += DA_THREADS) {
    const int g = e / D, d = e % D;
    float mx = NEG_INF;
    for (int c = c0; c < c1; ++c) mx = fmaxf(mx, part_m[(base + c) * G + g]);
    float den = 0.0f, num = 0.0f;
    for (int c = c0; c < c1; ++c) {
      const float w = expf(part_m[(base + c) * G + g] - mx);
      den = fmaf(part_l[(base + c) * G + g], w, den);
      num = fmaf(part_o[((base + c) * G + g) * D + d], w, num);
    }
    out[(static_cast<long long>(b) * H + hk * G + g) * D + d] =
        from_f32<T>(num / fmaxf(den, 1e-37f));
  }
}

// 1/sqrt(D) rounded once to float32, as the plain version's scale is
float inv_sqrt(int D) {
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
}

template <typename T, int D>
int flash_launch(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int Skv, int H, int Hkv, int causal, int window,
                 cudaStream_t stream) {
  constexpr int smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bq = FA_ROWS / (H / Hkv);
  const dim3 grid((S + bq - 1) / bq, Hkv, B);
  flash_attention_kernel<T, D><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Skv, H, Hkv, causal,
      window, inv_sqrt(D));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int decode_launch(const void* q, const void* k, const void* v,
                  const void* kv_len, void* out, int B, int Smax, int H,
                  int Hkv, int window, void* part_m, void* part_l,
                  void* part_o, cudaStream_t stream) {
  const int n_chunks = (Smax + DA_CHUNK - 1) / DA_CHUNK;
  decode_attention_kernel<T, D><<<dim3(n_chunks, Hkv, B), DA_THREADS, 0,
                                  stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len), Smax, H, Hkv,
      window, inv_sqrt(D), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_o));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<T><<<dim3(Hkv, B), DA_THREADS, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_o), static_cast<const int*>(kv_len),
      Smax, H, Hkv, D, window, n_chunks, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int flash_by_dim(int D, const void* q, const void* k, const void* v,
                 void* out, int B, int S, int Skv, int H, int Hkv, int causal,
                 int window, cudaStream_t stream) {
  switch (D) {
    case 32: return flash_launch<T, 32>(q, k, v, out, B, S, Skv, H, Hkv, causal, window, stream);
    case 64: return flash_launch<T, 64>(q, k, v, out, B, S, Skv, H, Hkv, causal, window, stream);
    case 128: return flash_launch<T, 128>(q, k, v, out, B, S, Skv, H, Hkv, causal, window, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int decode_by_dim(int D, const void* q, const void* k, const void* v,
                  const void* kv_len, void* out, int B, int Smax, int H,
                  int Hkv, int window, void* part_m, void* part_l,
                  void* part_o, cudaStream_t stream) {
  switch (D) {
    case 32: return decode_launch<T, 32>(q, k, v, kv_len, out, B, Smax, H, Hkv, window, part_m, part_l, part_o, stream);
    case 64: return decode_launch<T, 64>(q, k, v, kv_len, out, B, Smax, H, Hkv, window, part_m, part_l, part_o, stream);
    case 128: return decode_launch<T, 128>(q, k, v, kv_len, out, B, Smax, H, Hkv, window, part_m, part_l, part_o, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  D in {32, 64, 128}; G = H / Hkv <= 64.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int Skv, int H, int Hkv,
                           int D, int dtype, int causal, int window,
                           void* stream) {
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
      ? flash_by_dim<float>(D, q, k, v, out, B, S, Skv, H, Hkv, causal, window, st)
      : flash_by_dim<__nv_bfloat16>(D, q, k, v, out, B, S, Skv, H, Hkv, causal, window, st);
}

// Number of key chunks, i.e. the scratch's chunk dimension, for Smax.
int decode_attention_chunks(int Smax) {
  return (Smax + DA_CHUNK - 1) / DA_CHUNK;
}

// dtype: 0 float32, 1 bfloat16.  D in {32, 64, 128}; G = H / Hkv <= 16.
// Scratch: part_m/part_l (B, Hkv, chunks, G), part_o (B, Hkv, chunks, G, D)
// float32.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* kv_len, void* out, int B, int Smax,
                            int H, int Hkv, int D, int dtype, int window,
                            void* part_m, void* part_l, void* part_o,
                            void* stream) {
  if (B == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
      ? decode_by_dim<float>(D, q, k, v, kv_len, out, B, Smax, H, Hkv, window, part_m, part_l, part_o, st)
      : decode_by_dim<__nv_bfloat16>(D, q, k, v, kv_len, out, B, Smax, H, Hkv, window, part_m, part_l, part_o, st);
}

}  // extern "C"
