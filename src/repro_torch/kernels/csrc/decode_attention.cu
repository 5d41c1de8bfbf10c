// Decode attention for Hopper (sm_90a): one query token per sequence
// against a KV cache.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py:
// decode_attention (_kernel).
//
// What it computes.  q (B, 1, H, D) against k/v caches (B, Smax, Hkv, D),
// query head h reading kv head h / G (G = H / Hkv <= 16).  The live keys of
// sequence b are [lo, hi): hi = min(kv_len[b], Smax), lo = kv_len[b] - w
// with a window w (else 0).  Scores scaled by 1/sqrt(D), softmax and
// accumulators in float32 (p stays float32 in the PV product, as the plain
// version's does), the output cast to q's type; the denominator is floored
// at 1e-37.  Keys outside the live range are never read.
//
// What bounds it on this card.  It reads the live K/V once (17.8 MB per
// layer at the nemo serving shape, 5.3 us at 3.35 TB/s) and does 4 FLOP
// per byte: memory-bound.  The design keeps enough bytes in flight on
// every SM, in one launch that allocates nothing:
//
// - One thread-block cluster per (sequence, kv head), launched with a
//   cluster dimension of n <= 8 blocks (attention.py:decode_blocks: at
//   least 128 live keys per block, and no more blocks than give the grid
//   two per SM).  Block r of the cluster takes keys [lo + r L / n,
//   lo + (r + 1) L / n) of the L live keys, so the live range is covered
//   exactly once and a short range leaves blocks empty, never a key read
//   twice.  At the serving shapes that is 32 x 8 (nemo) and 128 x 3
//   (zamba2) blocks on 132 SMs.
// - Each block streams its keys through a ring of tiles of DA_TK keys in
//   shared memory, filled by 16-byte cp.async copies: three tiles (bf16)
//   are in flight while one is scored.
// - LPK lanes own a key, E = D / LPK elements of it each, with the G query
//   rows' matching elements in registers: a score is E G FMAs per lane and
//   a short shuffle (for G <= 4 the G partial dots are reduce-scattered:
//   log2(LPK) + 1 shuffles for all four), not a full-warp reduction per key
//   and head.  LPK = D / 8 (E = 8, one 16-byte read of the ring) for D in
//   {32, 64, 128}; at D = 160 (stablelm-12b) D / 8 = 20 lanes is no power
//   of two and does not divide the warp, so 16 lanes take 10 elements each
//   (five 32-bit words in bf16, five 8-byte reads in float32), two keys a
//   warp; the ring still fills in 16-byte chunks, 20 (bf16) or 40
//   (float32) a row.
// - Each tile's scores go through one online-softmax update in shared
//   memory (a warp per query head, a lane per key); the PV product then
//   accumulates in registers, lanes on the same E columns as for K.
// - The partial (max, sum, output) of each block stays in its shared
//   memory.  After a cluster barrier, each block reads the partials of
//   its slice of the G x D outputs through distributed shared memory,
//   rescales them to their common max and writes them; a second barrier
//   keeps every block resident until all have.  No scratch in device
//   memory, no second launch.
//
// The partial mode (decode_attention_partial_launch) serves a cache whose
// sequence is cut into slices, one per device of a mesh axis.  The slice
// holds global positions [start, start + Smax); the live range stays in
// global positions (kv_len and the window are the whole cache's) and is
// clipped to the slice, so a slice may hold no live key.  Instead of the
// normalised output the cluster writes its merged partial: the float32
// output against its max m (not divided by the sum), m and the sum l per
// (sequence, query head); a slice with no live key writes o = 0, l = 0
// and m = -inf.  The caller merges the slices' partials
// (kernels/ref.py:merge_partials).
//
// The C entry points launch on the given stream, do not synchronise, and
// return the launch's error code so that a refused launch raises.

#include <cooperative_groups.h>

#include "attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

using attn::NEG_INF;

constexpr int DA_THREADS = 128;
constexpr int DA_WARPS = DA_THREADS / 32;
constexpr int DA_TK = 32;           // keys per tile: one per lane in softmax
constexpr int DA_MAX_BLOCKS = 8;    // the portable cluster size
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// ring depth: three tiles in flight in bf16 (a 64 KB ring at D = 128, so
// three blocks fit on an SM and a cluster of eight finds room; a six-stage
// ring, two blocks per SM, measured slower), two in float32
template <typename T>
__host__ __device__ constexpr int stages() {
  return sizeof(T) == 2 ? 4 : 3;
}

template <typename T, int D>
__host__ __device__ constexpr int ring_bytes() {
  return stages<T>() * 2 * DA_TK * D * static_cast<int>(sizeof(T));
}

// The G <= 4 partial dots of one key across the LPK lanes that own it,
// reduce-scattered: after log2(LPK) + 1 shuffles (not 4 log2(LPK)) lane c
// holds the full score of head 2 * bit(c, LPK/2) + bit(c, LPK/4).
template <int LPK>
__device__ __forceinline__ float scatter4(const float (&d)[4], int c) {
  const bool up = c & (LPK / 2);
  float k0 = up ? d[2] : d[0], k1 = up ? d[3] : d[1];
  k0 += __shfl_xor_sync(0xffffffffu, up ? d[0] : d[2], LPK / 2);
  k1 += __shfl_xor_sync(0xffffffffu, up ? d[1] : d[3], LPK / 2);
  const bool up2 = c & (LPK / 4);
  float k = up2 ? k1 : k0;
  k += __shfl_xor_sync(0xffffffffu, up2 ? k0 : k1, LPK / 4);
#pragma unroll
  for (int o = LPK / 8; o > 0; o >>= 1)
    k += __shfl_xor_sync(0xffffffffu, k, o);
  return k;
}

// the lanes that share a key at head_dim D (the header says why 160 differs)
template <int D>
__host__ __device__ constexpr int lanes_per_key() {
  return D == 160 ? 16 : D / 8;
}

// E consecutive elements of a row in shared memory, as float32: 16-byte
// reads where E is a multiple of 4 floats or 8 bf16 (E = 8), else 8-byte
// float32 pairs or 4-byte bf16 pairs (E = 10)
template <int E>
__device__ __forceinline__ void load_elems(float (&x)[E], const float* p) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 a = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = a.x; x[4 * i + 1] = a.y; x[4 * i + 2] = a.z;
      x[4 * i + 3] = a.w;
    }
  } else {
    static_assert(E % 2 == 0, "an even number of elements per lane");
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      const float2 a = reinterpret_cast<const float2*>(p)[i];
      x[2 * i] = a.x;
      x[2 * i + 1] = a.y;
    }
  }
}
template <int E>
__device__ __forceinline__ void load_elems(float (&x)[E],
                                           const __nv_bfloat16* p) {
  static_assert(E % 2 == 0, "an even number of elements per lane");
  unsigned w[E / 2];
  if constexpr (E % 8 == 0) {
#pragma unroll
    for (int i = 0; i < E / 8; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = u.x; w[4 * i + 1] = u.y; w[4 * i + 2] = u.z;
      w[4 * i + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E / 2; ++i)
      w[i] = reinterpret_cast<const unsigned*>(p)[i];
  }
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// grid (n, Hkv, B) in clusters of (n, 1, 1); DA_THREADS threads;
// ring_bytes<T, D>() of dynamic shared memory.  GB >= G is the register
// bucket of query heads per kv head.  po == nullptr: the normalised output
// into out; else the partial mode: the partial output into po (B, H, D)
// and its max and sum into pm, pl (B, H), all float32.
template <typename T, int D, int GB>
__global__ void __launch_bounds__(DA_THREADS) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kv_len, T* __restrict__ out,
    float* __restrict__ po, float* __restrict__ pm, float* __restrict__ pl,
    int Smax, int H, int Hkv, int window, int start, float scale) {
  constexpr int LPK = lanes_per_key<D>();    // lanes per key
  constexpr int E = D / LPK;                 // elements per lane
  constexpr int NKG = DA_THREADS / LPK;      // key groups per block
  constexpr int CPR = D * sizeof(T) / 16;    // 16-byte chunks per row
  constexpr int TILE = DA_TK * D;            // elements of one K or V tile
  constexpr int STAGES = stages<T>();
  static_assert(32 % LPK == 0 && E * LPK == D && DA_TK % NKG == 0 &&
                    2 * DA_TK * CPR % DA_THREADS == 0,
                "lane layout must tile the warp, the row and the ring");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // stage s: K, then V
  float* part_o = reinterpret_cast<float*>(smem_raw);  // after the loop
  __shared__ float s_s[GB][DA_TK];           // a tile's scores, then p
  __shared__ float m_s[GB], l_s[GB], alpha_s[GB];
  __shared__ float w_s[DA_MAX_BLOCKS][GB];   // block 0: partial weights
  __shared__ float den_s[GB];

  cg::cluster_group cluster = cg::this_cluster();
  const int G = H / Hkv;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % LPK, kg = tid / LPK;

  // this block's share of the live range, the global live keys
  // [len - window, len) clipped to the slice [start, start + Smax)
  const int len = kv_len[b];
  const int hi = min(len - start, Smax);
  const int lo = max(0, (window ? len - window : 0) - start);
  const int live = max(0, hi - lo);
  const int j0 = lo + rank * live / n_blocks;
  const int j1 = lo + (rank + 1) * live / n_blocks;
  const int n_tiles = (j1 - j0 + DA_TK - 1) / DA_TK;

  const long long row_stride = static_cast<long long>(Hkv) * D;
  const long long kv_off = static_cast<long long>(b) * Smax * row_stride +
                           static_cast<long long>(hk) * D;
  auto fetch = [&](int t) {
    if (t < n_tiles) {
      const int key0 = j0 + t * DA_TK;
      const int nv = min(DA_TK, j1 - key0);
      unsigned char* ks = smem_raw + (t % STAGES) * 2 * TILE * sizeof(T);
#pragma unroll
      for (int it = 0; it < 2 * DA_TK * CPR / DA_THREADS; ++it) {
        const int i = it * DA_THREADS + tid;
        const int which = i / (DA_TK * CPR);          // 0: K, 1: V
        const int r = (i / CPR) % DA_TK, ch = i % CPR;
        if (r < nv) {
          const T* row = (which ? v : k) + kv_off + (key0 + r) * row_stride;
          attn::cp_async16(
              ks + (which * TILE + r * D) * sizeof(T) + ch * 16,
              reinterpret_cast<const unsigned char*>(row) + ch * 16, true);
        }
      }
    }
    attn::cp_async_commit();          // empty groups keep the count fixed
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) fetch(t);

  // this thread's E elements of the G scaled query rows
  float qr[GB][E], acc[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[g][e] = 0.0f;
      acc[g][e] = 0.0f;
    }
    if (g < G) {
      const T* qp = q + (static_cast<long long>(b) * H + hk * G + g) * D + c * E;
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] = to_f32(qp[e]) * scale;
    }
  }
  if (tid < GB) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    attn::cp_async_wait<STAGES - 2>();
    __syncthreads();                  // tile t landed; tile t - 1 consumed
    fetch(t + STAGES - 1);
    const T* ks = ring + (t % STAGES) * 2 * TILE;
    const T* vs = ks + TILE;
    const int nv = min(DA_TK, j1 - (j0 + t * DA_TK));

    // scores: key group kg takes keys kg, kg + NKG, ...; every lane runs
    // every pass (the shuffles need the whole warp), keys past nv are
    // computed on stale rows and dropped
#pragma unroll
    for (int pass = 0; pass < DA_TK / NKG; ++pass) {
      const int j = kg + pass * NKG;
      float kx[E];
      load_elems(kx, ks + j * D + c * E);
      float dot[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        dot[g] = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot[g] = fmaf(qr[g][e], kx[e], dot[g]);
      }
      if constexpr (GB == 4) {
        const float x = scatter4<LPK>(dot, c);
        const int g = 2 * ((c & (LPK / 2)) != 0) + ((c & (LPK / 4)) != 0);
        if ((c & (LPK / 4 - 1)) == 0 && g < G && j < nv) s_s[g][j] = x;
      } else {
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g >= G) break;            // G is uniform across the warp
#pragma unroll
          for (int o = LPK / 2; o > 0; o >>= 1)
            dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
          if (c == 0 && j < nv) s_s[g][j] = dot[g];
        }
      }
    }
    __syncthreads();

    // one online-softmax update per query head: a warp per head, a lane
    // per key
    for (int g = warp; g < G; g += DA_WARPS) {
      const float s = lane < nv ? s_s[g][lane] : NEG_INF;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = lane < nv ? expf(s - m_new) : 0.0f;
      const float sum = warp_sum(p);
      s_s[g][lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // PV on the same lanes and columns
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < G) {
        const float alpha = alpha_s[g];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
      }
    }
    for (int j = kg; j < nv; j += NKG) {
      float vx[E];
      load_elems(vx, vs + j * D + c * E);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g < G) {
          const float p = s_s[g][j];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vx[e], acc[g][e]);
        }
      }
    }
  }
  attn::cp_async_wait<0>();
  __syncthreads();                    // the ring is free for the partials

  // the block's partial output: key groups of a warp by shuffles, the
  // warps through shared memory (part_o[w][g][d], then summed into w = 0)
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  }
  if (lane < LPK) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
      if (g < G) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          part_o[(warp * G + g) * D + c * E + e] = acc[g][e];
      }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += DA_THREADS) {
    float x = part_o[i];
#pragma unroll
    for (int w = 1; w < DA_WARPS; ++w) x += part_o[w * G * D + i];
    part_o[i] = x;
  }

  // every block's partial is written; each block merges a slice of the
  // G x D outputs, reading all partials through distributed shared memory
  cluster.sync();
  if (tid < G) {
    float mx = NEG_INF;
    for (int r = 0; r < n_blocks; ++r)
      mx = fmaxf(mx, *cluster.map_shared_rank(&m_s[tid], r));
    float den = 0.0f;
    for (int r = 0; r < n_blocks; ++r) {
      const float w = expf(*cluster.map_shared_rank(&m_s[tid], r) - mx);
      w_s[r][tid] = w;
      den = fmaf(*cluster.map_shared_rank(&l_s[tid], r), w, den);
    }
    den_s[tid] = den;
    if (po != nullptr && rank == 0) {
      const long long bh = static_cast<long long>(b) * H + hk * G + tid;
      pm[bh] = den > 0.0f ? mx : __int_as_float(0xff800000);  // -inf
      pl[bh] = den;
    }
  }
  __syncthreads();
  const int per = (G * D + n_blocks - 1) / n_blocks;
  const int i_end = min(G * D, (rank + 1) * per);
  const long long o_off = (static_cast<long long>(b) * H + hk * G) * D;
  for (int i = rank * per + tid; i < i_end; i += DA_THREADS) {
    const int g = i / D;
    float num = 0.0f;
    for (int r = 0; r < n_blocks; ++r)
      num = fmaf(*cluster.map_shared_rank(&part_o[i], r), w_s[r][g], num);
    if (po != nullptr)
      po[o_off + i] = num;
    else
      out[o_off + i] = from_f32<T>(num / fmaxf(den_s[g], 1e-37f));
  }
  cluster.sync();                     // keep every partial until it is read
}

template <typename T, int D, int GB>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* out, float* po, float* pm, float* pl, int B, int Smax,
           int H, int Hkv, int window, int start, int n_blocks,
           cudaStream_t stream) {
  constexpr int smem = ring_bytes<T, D>();
  auto kernel = decode_attention_kernel<T, D, GB>;
  // the attribute once per instantiation and device
  static unsigned ready = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!(ready & (1u << device))) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready |= 1u << device;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks, Hkv, B);
  cfg.blockDim = dim3(DA_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q),
                           static_cast<const T*>(k), static_cast<const T*>(v),
                           static_cast<const int*>(kv_len), static_cast<T*>(out),
                           po, pm, pl, Smax, H, Hkv, window, start,
                           attn::inv_sqrt(D));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the launch's arguments past the instance: the tensors, the shapes, the
// window, the slice's first position and the cluster size
struct Args {
  const void *q, *k, *v, *kv_len;
  void* out;
  float *po, *pm, *pl;
  int B, Smax, H, Hkv, window, start, n_blocks;
  cudaStream_t stream;
};

template <typename T, int D, int GB>
int launch_args(const Args& a) {
  return launch<T, D, GB>(a.q, a.k, a.v, a.kv_len, a.out, a.po, a.pm, a.pl,
                          a.B, a.Smax, a.H, a.Hkv, a.window, a.start,
                          a.n_blocks, a.stream);
}

template <typename T, int D>
int by_group(int G, const Args& a) {
  if (G == 1) return launch_args<T, D, 1>(a);
  if (G <= 4) return launch_args<T, D, 4>(a);
  return launch_args<T, D, DA_MAX_G>(a);
}

template <typename T>
int by_dim(int D, int G, const Args& a) {
  switch (D) {
    case 32: return by_group<T, 32>(G, a);
    case 64: return by_group<T, 64>(G, a);
    case 128: return by_group<T, 128>(G, a);
    case 160: return by_group<T, 160>(G, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(int D, int dtype, const Args& a) {
  if (a.B == 0) return static_cast<int>(cudaGetLastError());
  if (a.n_blocks < 1 || a.n_blocks > DA_MAX_BLOCKS || a.H % a.Hkv ||
      a.H / a.Hkv > DA_MAX_G)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = a.H / a.Hkv;
  return dtype == 0 ? by_dim<float>(D, G, a) : by_dim<__nv_bfloat16>(D, G, a);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  D in {32, 64, 128, 160}; G = H / Hkv <= 16;
// n_blocks in [1, 8] (the wrapper's
// kernels/attention.py:decode_blocks).  Allocates nothing.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* kv_len, void* out, int B, int Smax,
                            int H, int Hkv, int D, int dtype, int window,
                            int n_blocks, void* stream) {
  return dispatch(D, dtype,
                  Args{q, k, v, kv_len, out, nullptr, nullptr, nullptr, B,
                       Smax, H, Hkv, window, 0, n_blocks,
                       static_cast<cudaStream_t>(stream)});
}

// The partial mode on a slice of the cache holding global positions
// [start, start + Smax): kv_len (B,) and the window in global positions,
// any kv_len >= 0.  Writes po (B, H, D), pm and pl (B, H), float32.
int decode_attention_partial_launch(const void* q, const void* k,
                                    const void* v, const void* kv_len,
                                    void* po, void* pm, void* pl, int B,
                                    int Smax, int H, int Hkv, int D,
                                    int dtype, int window, int start,
                                    int n_blocks, void* stream) {
  return dispatch(D, dtype,
                  Args{q, k, v, kv_len, nullptr, static_cast<float*>(po),
                       static_cast<float*>(pm), static_cast<float*>(pl), B,
                       Smax, H, Hkv, window, start, n_blocks,
                       static_cast<cudaStream_t>(stream)});
}

}  // extern "C"
