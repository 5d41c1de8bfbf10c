// Recurrence kernels for Hopper (sm_90a): the prefill scans of the
// recurrent LM serving paths (RWKV6 and the Mamba2 layers of the hybrid).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   rwkv6_scan_kernel          <- repro/kernels/rwkv6_scan.py:rwkv6_scan
//   mamba2_ssd_chunked_kernel  <- repro/kernels/mamba2_ssd.py:mamba2_ssd
//     (bfloat16; float32 runs mamba2_ssd_kernel, the stepwise form)
//
// What they compute.  rwkv6: per (batch row b, head h) a Dh x Dh float32
// state S [key x value], and for t = 0 .. S-1
//     y_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t
// with r, k, v, w (B, S, H, Dh) and u (H, Dh) in the model's dtype.  mamba2:
// per (b, h) a P x N float32 state and
//     S <- exp(dt_t A_h) S + dt_t x_t B_t^T,   y_t = S C_t
// with x (B, S, H, P), dt (B, S, H), B and C (B, S, N) in the model's dtype
// and A (H,) float32.  Both take the initial state (float32) and return y in
// the inputs' dtype and the final state in float32.  Decays use expf (no
// fast-math intrinsics).  Any S is taken; the Pallas kernels need S to be a
// multiple of their chunk.
//
// rwkv6: the stepwise form, at several blocks per head.  RWKV's decay w is
// per channel and data dependent, and the model's w = exp(-exp(dec)) is
// exactly 0 for strong decays, so the exp-factored chunked form (ratios of
// cumulative decay products) is unsafe (repro/kernels/rwkv6_scan.py:6-10).
// What bounds it here: every state element is its own scalar recurrence,
// st <- w st + k v, and only y_t[v] sums over the key index; at the serving
// prefill (B=4, S=1024, H=32, Dh=64) that is 537 M element-steps of at
// least 3 float32 operations (50 M warp instructions, about 0.05 ms of the
// card's issue rate) against 88 MB of inputs and outputs (0.026 ms).  The
// first stepwise kernel, a block of 256 threads per head, 16 elements a
// thread, made one 16-byte shared load per element-step, so the shared-memory pipe,
// not the FMAs, took about 500 cycles a step: 0.445 ms.  The design here:
//   - a thread holds an RE x CE tile of the state (rows q RE .., columns
//     cg CE ..), so one 16-byte load of r, k or w serves CE elements and
//     one of v serves RE; a head's value columns are split over CS blocks;
//     (CS, RE, CE) are template parameters, (2, 4, 4) at Dh = 64
//     (kernels/recurrence.py:RWKV6_INSTANCE);
//   - y_t[v] = sum_k r_k (S_kv + u_k k_k v_v): the lane's partial sum per
//     column starts from (sum_i r_i u_i k_i) v_c, then adds r_i st; the
//     update stays st = fmaf(w, st, k v);
//   - RW_U = 8 steps run unrolled, then one reduce-scatter of their
//     RW_U x CE partial sums over the KS lanes of the column group
//     finishes them: log2(KS) rounds of paired shuffles for 8 steps instead
//     of a dependent butterfly per step (the ragged tail sums each column
//     by a butterfly with the same pairing, so the sums are the same bits);
//   - TC = 32 steps of r, k, w and v arrive in four TMA boxes (tensor maps
//     over (B, S, H Dh), rows past S zero) into a two-stage ring, the next
//     chunk in flight while this one runs; bf16 is widened at use; y goes
//     out through shared memory as 16-byte vectors, from a tile per chunk
//     parity: chunk ch's steps write one while the copy-out of chunk ch-1
//     reads the other, so the chunk's one barrier orders every access.
// Each step's arithmetic does not depend on where a call starts, so a
// sequence cut in two with the state carried equals one call bitwise.
//
// mamba2, bf16: the chunked "state-space dual" form on the tensor cores.
// The decay exp(dt_t A_h) is one number per (b, h, t), so within a chunk of
// L = 64 steps, with a_s = dt_s A_h and cs the inclusive cumulative sum of
// a over the chunk,
//     G = C B^T,   M[t, s] = G[t, s] exp(cs_t - cs_s) dt_s  (s <= t, else 0)
//     y = M X + diag(exp(cs)) C S_in^T
//     S_out = exp(cs_{L-1}) S_in + (diag(exp(cs_{L-1} - cs_s) dt_s) X)^T B
// All decays are exp of differences cs_t - cs_s <= 0 (A < 0, dt >= 0), so
// none overflows and an underflow is an exact 0: no ratio of cumulative
// products appears.  (RWKV's per-channel decay makes its chunk products
// channel-dependent, which is what needs the unsafe ratios there.)  Off the
// diagonal tile a decay is the product of two such exps through the tile's
// first row, both <= 1.  The stepwise kernel did 5 float32 CUDA-core
// operations per state element per step (5.4 GFLOP, 0.080 ms at 67
// TFLOP/s) in 1,024 dependent steps: 0.396 ms.  The chunked form is about
// 8.6 GFLOP of tensor-core products at the serving shape (0.009 ms at 989
// TFLOP/s, twice that with the pairs below), so the 77 MB of inputs and
// outputs bound it (0.023 ms).  A block per (b, h) of four warps walks the
// chunks in order with the P x N state in mma.sync accumulator registers
// (warp w owns state rows 16 w ..); per chunk x, B and C arrive as
// three TMA boxes, swizzled so that ldmatrix reads no bank twice, the next
// chunk in flight; warp 0 computes the next chunk's cs and decays at the
// end of this one; each warp computes its 16 rows of G (causal tiles
// only), of M in registers (G's accumulator layout is the A operand's),
// and of y; the state moves once.  x, B and C are bf16, so G is exact
// products; the float32 operands (M, the scaled X, S_in) enter each
// product as a bf16 pair hi + lo, which holds them to about 2^-17 (one
// bf16 rounding, 2^-9, misses the tolerances on y and on the state:
// ref.mamba2_ssd_chunked_ref mirrors this arithmetic on the CPU).  No
// atomics: a run is deterministic.
//
// float32 mamba2 keeps the stepwise kernel: QSPLIT = 4 threads per
// state row, the inputs of 32 steps staged as float32 in shared memory, the
// next chunk's loads in flight.
//
// Each C entry point picks the instance for its head and state sizes,
// encodes its tensor maps, launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (cudaErrorInvalidValue for a
// size it was not built for) so that a refused launch raises.  The
// *_geometry entry points report the launch each one makes, which
// kernels/recurrence.py computes too.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 x) {
  return __bfloat162float(x);
}

constexpr unsigned FULL = 0xffffffffu;

// 16 bytes of T from 16 / sizeof(T) floats
__device__ __forceinline__ void store16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void store16(bf16* dst, const float* src) {
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
    o[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  *reinterpret_cast<uint4*>(dst) = out;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------- TMA tensor copies

// The Tensor Memory Accelerator copies a box of a tensor, described by a
// tensor map made on the host, from global to shared memory; its bytes
// complete a transaction count on an mbarrier, whose phase the consumers
// wait on.  Every request holds up the warp that issues it, so a chunk is
// a few boxes, not a request per row (which measured slower: PERF.md).

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// the stages' barriers, initialised by thread 0 before any copy
__device__ __forceinline__ void mbar_init_all(uint64_t* bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// before the async proxy writes a stage the generic proxy has read
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one box of a three-dimensional tensor map, at coordinates (c0, c1, c2),
// to shared memory (128-byte aligned); elements outside the tensor are
// zeros, and the whole box counts towards the barrier's transaction bytes
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// the driver's tensor-map encoder, reached through the runtime, so that the
// library links against nothing but the CUDA runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a map over a (B, S, row) tensor (row elements per step, contiguous) whose
// boxes are `box` elements of `steps` steps of one batch row, landing in
// shared memory with the given swizzle
cudaError_t step_rows_map(CUtensorMap* map, const void* base, bool bf16_type,
                          int B, int S, int row, int box, int steps,
                          CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t esize = bf16_type ? 2 : 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(row),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {row * esize, S * row * esize};
  const cuuint32_t boxd[3] = {static_cast<cuuint32_t>(box),
                              static_cast<cuuint32_t>(steps), 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = encode(
      map, bf16_type ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(base), dims, strides, boxd, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- rwkv6

constexpr int RW_TC = 32;       // steps staged at a time
constexpr int RW_STAGES = 2;    // raw ring depth
constexpr int RW_U = 8;         // steps computed, then reduced, together

// CS blocks per head; each thread holds an RE x CE tile of the state (RE
// rows, CE neighbouring value columns)
template <int DH, int CS, int RE, int CE>
struct RwkvGeom {
  static constexpr int COLS = DH / CS;     // value columns per block
  static constexpr int KS = DH / RE;       // threads per column group
  static constexpr int NT = COLS / CE * KS;  // threads per block
  static constexpr int V = RW_U * CE / KS;   // y values a lane finishes
  static_assert(DH % CS == 0 && DH % RE == 0 && COLS % CE == 0,
                "instance must divide Dh");
  static_assert(KS <= 32 && 32 % KS == 0, "a column group shares a warp");
  static_assert(V >= 1 && V <= CE, "a lane finishes columns of one step");
  static_assert(NT % 32 == 0 && NT <= 1024, "whole warps");
  static_assert((RE == 2 || RE == 4) && (CE == 2 || CE == 4),
                "vector loads of 2 or 4 elements");
};

// mirrored by kernels/recurrence.py:rwkv6_smem_bytes
template <typename T, int DH, int CS>
constexpr int rwkv6_smem_bytes() {
  return 128                             // mbarriers, then aligned rows
         + RW_STAGES * 4 * RW_TC * DH * static_cast<int>(sizeof(T))
         + 2 * RW_TC * (DH / CS) * 4;   // y of the block's columns, 2 tiles
}

// N neighbouring elements of a staged row as float32
template <int N>
__device__ __forceinline__ void ld_row(float (&d)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    d[0] = v.x; d[1] = v.y;
  }
}
template <int N>
__device__ __forceinline__ void ld_row(float (&d)[N], const bf16* p) {
  uint32_t wd[N / 2];
  if constexpr (N == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    wd[0] = v.x; wd[1] = v.y;
  } else {
    wd[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {          // bf16 is float32's high half
    d[2 * i] = __uint_as_float(wd[i] << 16);
    d[2 * i + 1] = __uint_as_float(wd[i] & 0xffff0000u);
  }
}

// one reduce-scatter round over the lanes q, q ^ o: of the first M values
// the lane keeps the upper half if `upper`, the lower otherwise, adding
// its partner's copy of each; after it they are the first M / 2
template <int M, int N>
__device__ __forceinline__ void halve(float (&v)[N], int o, bool upper) {
#pragma unroll
  for (int i = 0; i < M / 2; ++i) {
    const float keep = upper ? v[M / 2 + i] : v[i];
    const float send = upper ? v[i] : v[M / 2 + i];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, o));
  }
}

// grid (B * H * CS), RwkvGeom::NT threads, rwkv6_smem_bytes() dynamic
// shared memory.  Block (b, h, part) owns value columns
// [part * COLS, (part + 1) * COLS); thread tid owns rows q RE .. q RE + RE-1
// (q = tid % KS) of columns cg CE .. cg CE + CE-1 (cg = tid / KS).  The
// maps cut r, k, w, v into boxes of one head's Dh elements by RW_TC steps.
template <typename T, int DH, int CS, int RE, int CE>
__global__ void __launch_bounds__(RwkvGeom<DH, CS, RE, CE>::NT, 2)
rwkv6_scan_kernel(const __grid_constant__ CUtensorMap map_r,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_v,
                  const T* __restrict__ u, const float* __restrict__ state0,
                  T* __restrict__ y, float* __restrict__ state_out, int S,
                  int H) {
  using G = RwkvGeom<DH, CS, RE, CE>;
  constexpr int COLS = G::COLS, KS = G::KS, NT = G::NT, V = G::V;
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // per 16 bytes
  constexpr int BOX = RW_TC * DH * static_cast<int>(sizeof(T));
  static_assert(COLS % VEC == 0, "y is written in 16-byte vectors");

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem);     // [STAGES]
  T* raw = reinterpret_cast<T*>(smem + 128);               // [STAGES][4][TC][DH]
  // [2][TC][COLS]: chunk ch's y in tile ch % 2
  float* s_y2 = reinterpret_cast<float*>(raw + RW_STAGES * 4 * RW_TC * DH);

  const int bh = blockIdx.x / CS;
  const int col0 = (blockIdx.x % CS) * COLS;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int cg = tid / KS, q = tid % KS;
  const int row0 = q * RE, c0 = col0 + cg * CE;   // c0 within the head
  const size_t step = static_cast<size_t>(H) * DH;       // between steps
  const size_t base = (static_cast<size_t>(b) * S * H + h) * DH;

  // which of a group's RW_U * CE partial sums the lane finishes: the
  // reduce-scatter keeps the upper half on round i if bit i of q is set
  int fin = 0;
#pragma unroll
  for (int i = 0, m = RW_U * CE; m > V; ++i, m >>= 1)
    fin += ((q >> i) & 1) * (m >> 1);
  const int fin_t = fin / CE, fin_c = c0 + fin % CE;

  float st[RE][CE], uu[RE];
  const float* s0 = state0 + static_cast<size_t>(bh) * DH * DH;
#pragma unroll
  for (int i = 0; i < RE; ++i) {
    ld_row(st[i], s0 + (row0 + i) * DH + c0);
    uu[i] = to_f32(u[h * DH + row0 + i]);
  }

  // (thread 0) chunk ch's r, k, w, v boxes into its stage: four requests;
  // steps past S arrive as zeros
  auto issue = [&](int ch) {
    uint64_t* bar = s_bar + ch % RW_STAGES;
    T* dst = raw + (ch % RW_STAGES) * 4 * RW_TC * DH;
    fence_proxy_async();
    mbar_expect_tx(bar, 4 * BOX);
    const CUtensorMap* maps[4] = {&map_r, &map_k, &map_w, &map_v};
#pragma unroll
    for (int a = 0; a < 4; ++a)
      tma_load_3d(dst + a * RW_TC * DH, maps[a], h * DH, ch * RW_TC, b, bar);
  };

  // y of the n steps of chunk ch, from its tile
  auto write_y = [&](int ch, int n) {
    const float* src = s_y2 + (ch & 1) * RW_TC * COLS;
    const int t0 = ch * RW_TC;
    for (int i = tid; i < n * (COLS / VEC); i += NT) {
      const int t = i / (COLS / VEC), c = (i % (COLS / VEC)) * VEC;
      store16(y + base + static_cast<size_t>(t0 + t) * step + col0 + c,
              src + t * COLS + c);
    }
  };

  mbar_init_all(s_bar, RW_STAGES);
  const int nch = (S + RW_TC - 1) / RW_TC;
  if (tid == 0 && nch > 0) issue(0);
  for (int ch = 0; ch < nch; ++ch) {
    const int t0 = ch * RW_TC;
    const int n = min(RW_TC, S - t0);
    mbar_wait(s_bar + ch % RW_STAGES, (ch / RW_STAGES) & 1);
    // chunk ch-1's steps are done: its y tile is whole and its stage free;
    // chunk ch-2's copy-out is done: tile ch % 2 is free
    __syncthreads();
    if (ch > 0) write_y(ch - 1, RW_TC);
    if (tid == 0 && ch + 1 < nch) issue(ch + 1);   // in flight meanwhile
    const T* pr = raw + (ch % RW_STAGES) * 4 * RW_TC * DH;
    const T* pk = pr + RW_TC * DH;
    const T* pw = pr + 2 * RW_TC * DH;
    const T* pv = pr + 3 * RW_TC * DH;
    float* s_y = s_y2 + (ch & 1) * RW_TC * COLS;

    // one step: the lane's partial sums of y_t over its RE rows, from the
    // state before the step (y_t[v] = sum_k r_k (S_kv + u_k k_k v_v)), then
    // the update st <- w st + k v
    auto run_step = [&](int t, float (&part)[CE]) {
      float rr[RE], kf[RE], wf[RE], vv[CE];
      ld_row(rr, pr + t * DH + row0);
      ld_row(kf, pk + t * DH + row0);
      ld_row(wf, pw + t * DH + row0);
      ld_row(vv, pv + t * DH + c0);
      float ruk = 0.f;
#pragma unroll
      for (int i = 0; i < RE; ++i) ruk = fmaf(__fmul_rn(rr[i], uu[i]), kf[i], ruk);
#pragma unroll
      for (int c = 0; c < CE; ++c) part[c] = __fmul_rn(ruk, vv[c]);
#pragma unroll
      for (int i = 0; i < RE; ++i)
#pragma unroll
        for (int c = 0; c < CE; ++c) {
          part[c] = fmaf(rr[i], st[i][c], part[c]);
          st[i][c] = fmaf(wf[i], st[i][c], __fmul_rn(kf[i], vv[c]));
        }
    };
    // RW_U steps, then one reduce-scatter of their RW_U x CE partial sums
    // over the group's KS lanes, each lane finishing V of them; the tail
    // sums each column over the same lanes in the same order (a butterfly)
    const int full = n / RW_U * RW_U;
#pragma unroll 1
    for (int tg = 0; tg < full; tg += RW_U) {
      float part[RW_U * CE];
#pragma unroll
      for (int i = 0; i < RW_U; ++i)
        run_step(tg + i, *reinterpret_cast<float(*)[CE]>(part + i * CE));
      if constexpr (RW_U * CE >= 2 * V) halve<RW_U * CE>(part, 1, q & 1);
      if constexpr (RW_U * CE >= 4 * V) halve<RW_U * CE / 2>(part, 2, (q >> 1) & 1);
      if constexpr (RW_U * CE >= 8 * V) halve<RW_U * CE / 4>(part, 4, (q >> 2) & 1);
      if constexpr (RW_U * CE >= 16 * V) halve<RW_U * CE / 8>(part, 8, (q >> 3) & 1);
      if constexpr (RW_U * CE >= 32 * V) halve<RW_U * CE / 16>(part, 16, (q >> 4) & 1);
#pragma unroll
      for (int i = 0; i < V; ++i)
        s_y[(tg + fin_t) * COLS + fin_c + i - col0] = part[i];
    }
#pragma unroll 1
    for (int t = full; t < n; ++t) {
      float part[CE];
      run_step(t, part);
#pragma unroll
      for (int c = 0; c < CE; ++c)
#pragma unroll
        for (int o = 1; o < KS; o <<= 1)
          part[c] = __fadd_rn(part[c], __shfl_xor_sync(FULL, part[c], o));
      if (q == 0)
#pragma unroll
        for (int c = 0; c < CE; ++c) s_y[t * COLS + c0 + c - col0] = part[c];
    }
  }
  __syncthreads();
  if (nch > 0) write_y(nch - 1, S - (nch - 1) * RW_TC);

  float* so = state_out + static_cast<size_t>(bh) * DH * DH;
#pragma unroll
  for (int i = 0; i < RE; ++i)
#pragma unroll
    for (int c = 0; c < CE; ++c) so[(row0 + i) * DH + c0 + c] = st[i][c];
}

// ------------------------------------------------- mamba2, bf16 (chunked)

constexpr int SSD_L = 64;         // steps per chunk
constexpr int SSD_THREADS = 128;  // four warps, 16 rows of each product

// mirrored by kernels/recurrence.py:mamba2_smem_bytes (bf16 elements;
// rows padded by 16 bytes so that ldmatrix's eight rows hit distinct banks)
template <int P, int N>
constexpr int mamba2_chunked_smem_bytes() {
  return 1024                            // slack to align the tiles to 1 KB
         + 2 * (2 * SSD_L * P            // x, two stages (TMA, swizzled)
                + 4 * SSD_L * N          // B and C, two stages
                + 2 * SSD_L * (P + 8)    // scaled x, hi and lo
                + 2 * P * (N + 8)        // S_in, hi and lo
                + SSD_L * (P + 8))       // y
         + 2 * 4 * (4 + SSD_L / 16) * SSD_L  // float rows, two chunks
         + 16;                           // two mbarriers
}

// the element offset of (row, col) in a tile of W bf16 per row that TMA
// wrote with the swizzle for W * 2-byte rows (128, 64 or 32 bytes): the
// 16-byte chunk index is XORed with bits 7.. of the byte offset, so the
// eight rows an ldmatrix reads fall in distinct banks
template <int W>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr int M = W == 64 ? 7 : W == 32 ? 3 : 1;
  const int off = row * W + col;
  return off ^ ((((off * 2) >> 7) & M) << 3);
}

constexpr CUtensorMapSwizzle swizzle_for(int W) {
  return W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : W == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&d)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a b: one m16n8k16 bf16 product, float32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as bf16 pairs: hi = bf16(x), lo = bf16(x - hi); x0 in the low half
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// grid (B * H), SSD_THREADS threads, mamba2_chunked_smem_bytes() dynamic
// shared memory.  Warp w takes the 16 chunk rows (and state rows) of tile
// w.  (Eight warps, splitting each tile's columns in halves, were timed
// and dropped: PERF.md.)  In each m16n8 accumulator a lane holds rows
// g, g + 8 and columns 2c, 2c + 1 (g = lane / 4, c = lane % 4).
template <int P, int N>
__global__ void __launch_bounds__(SSD_THREADS, 2) mamba2_ssd_chunked_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_c, const bf16* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ state0,
    bf16* __restrict__ y, float* __restrict__ state_out, int S, int H) {
  constexpr int L = SSD_L, NT = SSD_THREADS;
  constexpr int LX = P + 8, LB = N + 8;        // padded rows
  constexpr int PT = P / 8, NTL = N / 8;       // n8 tiles along P and N
  constexpr int NK = N / 16;                   // k16 steps along N
  constexpr int RT = L / 16;                   // row tiles of a chunk
  static_assert(NT == 32 * RT, "a warp per row tile");
  static_assert(P % 16 == 0 && N % 16 == 0, "whole k16 column pairs");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =                        // 1 KB aligned for the swizzle
      smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  bf16* s_x = reinterpret_cast<bf16*>(smem);   // [2][L][P] swizzled
  bf16* s_b = s_x + 2 * L * P;                 // [2][L][N] swizzled
  bf16* s_c = s_b + 2 * L * N;                 // [2][L][N] swizzled
  bf16* s_xh = s_c + 2 * L * N;                // [L][LX] scaled x, hi
  bf16* s_xl = s_xh + L * LX;                  //         and lo
  bf16* s_sh = s_xl + L * LX;                  // [P][LB] S_in, hi
  bf16* s_sl = s_sh + P * LB;                  //         and lo
  bf16* s_y = s_sl + P * LB;                   // [L][LX]
  // a chunk's float rows, double-buffered: warp 0 fills the next chunk's
  // at the end of this one.  Per buffer: dt_s, cs_t, exp(cs_t),
  // exp(cs_{L-1} - cs_s) dt_s, exp(cs_t - cs_{16 tile(t)}), and for each
  // tile edge i = 1 .. RT-1 exp(cs_{16 i} - cs_s) dt_s
  constexpr int ROWS = (4 + RT) * L;
  float* s_rows = reinterpret_cast<float*>(s_y + L * LX);  // [2][ROWS]
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_rows + 2 * ROWS);  // [2]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int rt = warp, r0 = rt * 16;           // this warp's 16 rows
  const float a_h = A[h];
  const size_t xstep = static_cast<size_t>(H) * P;
  const size_t xbase = (static_cast<size_t>(b) * S * H + h) * P;
  const size_t dtbase = static_cast<size_t>(b) * S * H + h;

  // the state: rows r0 + g (+ 8), columns 8 j + c2 (+ 1)
  const bool owner = rt < P / 16;
  float st[NTL][4];
  const float* s0 = state0 + static_cast<size_t>(bh) * P * N;
#pragma unroll
  for (int j = 0; j < NTL; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[j][e] = owner ? s0[(r0 + g + (e >> 1) * 8) * N + 8 * j + c2 + (e & 1)]
                       : 0.f;

  // S as hi and lo bf16 tiles [p][n] for the next chunk's C S^T
  auto stage_state = [&]() {
    if (!owner) return;
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t hi, lo;
        split2(st[j][2 * half], st[j][2 * half + 1], hi, lo);
        const int at = (r0 + g + half * 8) * LB + 8 * j + c2;
        *reinterpret_cast<uint32_t*>(s_sh + at) = hi;
        *reinterpret_cast<uint32_t*>(s_sl + at) = lo;
      }
  };

  // (thread 0) chunk ch's x, B and C boxes into its stage: three requests;
  // steps past S arrive as zeros (dt = 0 there too: they add and decay
  // nothing)
  auto issue = [&](int ch) {
    const int stage = ch & 1;
    uint64_t* bar = s_bar + stage;
    fence_proxy_async();
    mbar_expect_tx(bar, L * (P + 2 * N) * 2);
    tma_load_3d(s_x + stage * L * P, &map_x, h * P, ch * L, b, bar);
    tma_load_3d(s_b + stage * L * N, &map_b, 0, ch * L, b, bar);
    tma_load_3d(s_c + stage * L * N, &map_c, 0, ch * L, b, bar);
  };

  // (warp 0) dt of chunk ch, steps 2 lane and 2 lane + 1
  float dtv[2];
  auto fetch_dt = [&](int ch) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = ch * L + 2 * lane + i;
      dtv[i] = t < S ? __bfloat162float(dt[dtbase + static_cast<size_t>(t) * H])
                     : 0.f;
    }
  };

  // (warp 0) chunk ch's float rows from dtv: cs, the inclusive sum of dt A
  // over the chunk (two steps a lane, then a scan over the lanes), and
  // every decay the chunk needs, each exp of a difference <= 0
  auto rows_of = [&](int ch) {
    float* r_ = s_rows + (ch & 1) * ROWS;
    const float d0 = dtv[0], d1 = dtv[1];
    const float a0 = d0 * a_h, a1 = d1 * a_h;
    float tot = a0 + a1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(FULL, tot, o);
      if (lane >= o) tot += up;
    }
    float before = __shfl_up_sync(FULL, tot, 1);
    if (lane == 0) before = 0.f;
    const float cs0 = before + a0, cs1 = tot;
    const float last = __shfl_sync(FULL, tot, 31);
    const float start = __shfl_sync(FULL, cs0, lane & ~7);   // cs_{16 tile}
    const int s = 2 * lane;
    r_[s] = d0;
    r_[s + 1] = d1;
    r_[L + s] = cs0;
    r_[L + s + 1] = cs1;
    r_[2 * L + s] = expf(cs0);
    r_[2 * L + s + 1] = expf(cs1);
    r_[3 * L + s] = expf(last - cs0) * d0;
    r_[3 * L + s + 1] = expf(last - cs1) * d1;
    r_[4 * L + s] = expf(cs0 - start);
    r_[4 * L + s + 1] = expf(cs1 - start);
#pragma unroll
    for (int i = 1; i < RT; ++i) {
      const float edge = __shfl_sync(FULL, cs0, 8 * i);      // cs_{16 i}
      const bool before_edge = s < 16 * i;
      r_[(4 + i) * L + s] = before_edge ? expf(edge - cs0) * d0 : 0.f;
      r_[(4 + i) * L + s + 1] = before_edge ? expf(edge - cs1) * d1 : 0.f;
    }
  };

  mbar_init_all(s_bar, 2);
  const int nch = (S + L - 1) / L;
  stage_state();
  if (nch > 0) {
    if (tid == 0) issue(0);
    if (warp == 0) {
      fetch_dt(0);
      rows_of(0);
    }
  }
  for (int ch = 0; ch < nch; ++ch) {
    const int stage = ch & 1, t0 = ch * L;
    const bf16* cx = s_x + stage * L * P;
    const bf16* cb = s_b + stage * L * N;
    const bf16* cc = s_c + stage * L * N;
    const float* s_dt = s_rows + stage * ROWS;
    const float* s_cs = s_dt + L;
    const float* s_e = s_dt + 2 * L;
    const float* s_f = s_dt + 3 * L;
    const float* s_rf = s_dt + 4 * L;
    const float* s_bt = s_dt + 4 * L;            // edge i's row: s_bt + i L
    mbar_wait(s_bar + stage, (ch >> 1) & 1);
    __syncthreads();              // chunk ch landed, its rows ready; ch-1 done
    if (ch + 1 < nch) {           // in flight during this chunk
      if (tid == 0) issue(ch + 1);
      if (warp == 0) fetch_dt(ch + 1);
    }

    // scaled x: f_s x[s][p] as hi and lo
    for (int i = tid; i < L * (P / 2); i += NT) {
      const int s = i / (P / 2), p = (i % (P / 2)) * 2;
      const __nv_bfloat162 xv =
          *reinterpret_cast<const __nv_bfloat162*>(cx + swz<P>(s, p));
      const float f = s_f[s];
      uint32_t hi, lo;
      split2(f * __low2float(xv), f * __high2float(xv), hi, lo);
      *reinterpret_cast<uint32_t*>(s_xh + s * LX + p) = hi;
      *reinterpret_cast<uint32_t*>(s_xl + s * LX + p) = lo;
    }

    // C rows r0 .. r0 + 15 as A fragments, every k16 along N
    uint32_t ca[NK][4];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      ldsm_x4(ca[kk], cc + swz<N>(r0 + (lane & 15), kk * 16 + (lane >> 4) * 8));

    // y = exp(cs_t) C S_in^T ...
    float yacc[PT][4];
#pragma unroll
    for (int j = 0; j < PT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int pp = 0; pp < PT / 2; ++pp) {
        const int at =
            (pp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LB + kk * 16 +
            ((lane >> 3) & 1) * 8;
        uint32_t bh4[4], bl4[4];
        ldsm_x4(bh4, s_sh + at);
        ldsm_x4(bl4, s_sl + at);
        mma16816(yacc[2 * pp], ca[kk], bh4[0], bh4[1]);
        mma16816(yacc[2 * pp + 1], ca[kk], bh4[2], bh4[3]);
        mma16816(yacc[2 * pp], ca[kk], bl4[0], bl4[1]);
        mma16816(yacc[2 * pp + 1], ca[kk], bl4[2], bl4[3]);
      }
    const int t_lo = r0 + g, t_hi = r0 + g + 8;
    {
      const float e_lo = s_e[t_lo], e_hi = s_e[t_hi];
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        yacc[j][0] *= e_lo;
        yacc[j][1] *= e_lo;
        yacc[j][2] *= e_hi;
        yacc[j][3] *= e_hi;
      }
    }

    // ... + M X, M = (C B^T) o decay o dt on the causal tiles s <= t
    float gacc[L / 8][4];
#pragma unroll
    for (int j = 0; j < L / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[j][e] = 0.f;
#pragma unroll
    for (int j2 = 0; j2 < RT; ++j2) {
      if (j2 > rt) continue;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t bb[4];
        ldsm_x4(bb, cb + swz<N>(j2 * 16 + (lane & 7) + ((lane >> 4) << 3),
                                kk * 16 + ((lane >> 3) & 1) * 8));
        mma16816(gacc[2 * j2], ca[kk], bb[0], bb[1]);
        mma16816(gacc[2 * j2 + 1], ca[kk], bb[2], bb[3]);
      }
    }
    const float cs_lo = s_cs[t_lo], cs_hi = s_cs[t_hi];
    const float rf_lo = s_rf[t_lo], rf_hi = s_rf[t_hi];
    const float* bt = s_bt + rt * L;           // read only when rt > 0
#pragma unroll
    for (int ks = 0; ks < RT; ++ks) {
      if (ks > rt) continue;
      uint32_t ah[4], al[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * ks + half;
        const int s = 8 * j + c2;
        float m0, m1, m2, m3;
        if (ks < rt) {
          // s before the tile's first row 16 rt <= t: through the edge
          const float f0 = bt[s], f1 = bt[s + 1];
          m0 = gacc[j][0] * rf_lo * f0;
          m1 = gacc[j][1] * rf_lo * f1;
          m2 = gacc[j][2] * rf_hi * f0;
          m3 = gacc[j][3] * rf_hi * f1;
        } else {
          const float cs_s0 = s_cs[s], cs_s1 = s_cs[s + 1];
          const float dt0 = s_dt[s], dt1 = s_dt[s + 1];
          m0 = s <= t_lo ? gacc[j][0] * expf(cs_lo - cs_s0) * dt0 : 0.f;
          m1 = s + 1 <= t_lo ? gacc[j][1] * expf(cs_lo - cs_s1) * dt1 : 0.f;
          m2 = s <= t_hi ? gacc[j][2] * expf(cs_hi - cs_s0) * dt0 : 0.f;
          m3 = s + 1 <= t_hi ? gacc[j][3] * expf(cs_hi - cs_s1) * dt1 : 0.f;
        }
        // A fragment: a0/a1 the first k8 (rows g, g + 8), a2/a3 the second
        split2(m0, m1, ah[2 * half], al[2 * half]);
        split2(m2, m3, ah[2 * half + 1], al[2 * half + 1]);
      }
#pragma unroll
      for (int pp = 0; pp < PT / 2; ++pp) {
        uint32_t xb[4];
        ldsm_x4_t(xb, cx + swz<P>(ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                  pp * 16 + (lane >> 4) * 8));
        mma16816(yacc[2 * pp], ah, xb[0], xb[1]);
        mma16816(yacc[2 * pp + 1], ah, xb[2], xb[3]);
        mma16816(yacc[2 * pp], al, xb[0], xb[1]);
        mma16816(yacc[2 * pp + 1], al, xb[2], xb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int p = 8 * j + c2;
      *reinterpret_cast<__nv_bfloat162*>(s_y + t_lo * LX + p) =
          __floats2bfloat162_rn(yacc[j][0], yacc[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(s_y + t_hi * LX + p) =
          __floats2bfloat162_rn(yacc[j][2], yacc[j][3]);
    }
    __syncthreads();              // scaled x, y tile done; S_in reads done

    // S_out = exp(cs_{L-1}) S_in + (scaled x)^T B
    if (owner) {
      const float e_last = s_e[L - 1];
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] *= e_last;
#pragma unroll
      for (int ks = 0; ks < RT; ++ks) {
        const int at = (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * LX + r0 +
                       ((lane >> 3) & 1) * 8;
        uint32_t ah[4], al[4];
        ldsm_x4_t(ah, s_xh + at);
        ldsm_x4_t(al, s_xl + at);
#pragma unroll
        for (int nn = 0; nn < NTL / 2; ++nn) {
          uint32_t bb[4];
          ldsm_x4_t(bb, cb + swz<N>(ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                    nn * 16 + (lane >> 4) * 8));
          mma16816(st[2 * nn], ah, bb[0], bb[1]);
          mma16816(st[2 * nn + 1], ah, bb[2], bb[3]);
          mma16816(st[2 * nn], al, bb[0], bb[1]);
          mma16816(st[2 * nn + 1], al, bb[2], bb[3]);
        }
      }
    }
    stage_state();
    if (warp == 0 && ch + 1 < nch) rows_of(ch + 1);
    const int n = min(L, S - t0);
    for (int i = tid; i < n * (P / 8); i += NT) {
      const int t = i / (P / 8), c = (i % (P / 8)) * 8;
      *reinterpret_cast<uint4*>(y + xbase + static_cast<size_t>(t0 + t) * xstep + c) =
          *reinterpret_cast<const uint4*>(s_y + t * LX + c);
    }
  }

  if (owner) {
    float* so = state_out + static_cast<size_t>(bh) * P * N;
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        so[(r0 + g + (e >> 1) * 8) * N + 8 * j + c2 + (e & 1)] = st[j][e];
  }
}

// ----------------------------------------------- mamba2, float32 (stepwise)

constexpr int TC = 32;       // time steps staged in shared memory at once
constexpr int QSPLIT = 4;    // threads per state row

// the sum of x over the QSPLIT = 4 neighbouring lanes that share a row
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  x += __shfl_xor_sync(FULL, x, 2);
  return x;
}

// grid (B * H), QSPLIT * P threads.  Thread tid owns state row p = tid / 4,
// columns n = 4 j + q (q = tid % 4).
template <int P, int N>
__global__ void __launch_bounds__(QSPLIT * P) mamba2_ssd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ state0,
    float* __restrict__ y, float* __restrict__ state_out, int S, int H) {
  constexpr int NT = QSPLIT * P;
  constexpr int NQ = N / QSPLIT;                   // state columns per thread
  constexpr int PER_X = TC * P / NT;               // = TC / QSPLIT
  constexpr int PER_BC = (TC * N + NT - 1) / NT;
  __shared__ float2 s_bc[TC][N];                   // (B, C) at (step, n)
  __shared__ float s_x[TC][P];
  __shared__ float s_dt[TC], s_decay[TC];
  __shared__ float s_y[TC][P];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int p = tid / QSPLIT, q = tid % QSPLIT;
  const float a = A[h];
  const size_t xstep = static_cast<size_t>(H) * P;
  const size_t xbase = (static_cast<size_t>(b) * S * H + h) * P;
  const size_t bcbase = static_cast<size_t>(b) * S * N;
  const size_t dtbase = static_cast<size_t>(b) * S * H + h;

  float st[NQ];
  const float* s0 = state0 + static_cast<size_t>(bh) * P * N;
#pragma unroll
  for (int j = 0; j < NQ; ++j) st[j] = s0[p * N + j * QSPLIT + q];

  float pre_x[PER_X], pre_dt = 0.f;
  float2 pre_bc[PER_BC];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int it = 0; it < PER_X; ++it) {
      const int i = tid + it * NT;
      const int t = i / P, c = i % P;
      if (t0 + t < S)
        pre_x[it] = x[xbase + static_cast<size_t>(t0 + t) * xstep + c];
    }
#pragma unroll
    for (int it = 0; it < PER_BC; ++it) {
      const int i = tid + it * NT;
      const int t = i / N, c = i % N;
      if (t < TC && t0 + t < S) {
        const size_t at = bcbase + static_cast<size_t>(t0 + t) * N + c;
        pre_bc[it] = make_float2(Bm[at], Cm[at]);
      }
    }
    if (tid < TC && t0 + tid < S)
      pre_dt = dt[dtbase + static_cast<size_t>(t0 + tid) * H];
  };

  fetch(0);
  for (int t0 = 0; t0 < S; t0 += TC) {
    const int n = min(TC, S - t0);
    __syncthreads();                       // the last chunk is written out
#pragma unroll
    for (int it = 0; it < PER_X; ++it) {
      const int i = tid + it * NT;
      if (i / P < n) s_x[i / P][i % P] = pre_x[it];
    }
#pragma unroll
    for (int it = 0; it < PER_BC; ++it) {
      const int i = tid + it * NT;
      if (i / N < n) s_bc[i / N][i % N] = pre_bc[it];
    }
    if (tid < n) {
      s_dt[tid] = pre_dt;
      s_decay[tid] = expf(pre_dt * a);
    }
    __syncthreads();
    if (t0 + TC < S) fetch(t0 + TC);       // in flight during the steps
    for (int t = 0; t < n; ++t) {
      const float dec = s_decay[t];
      const float dtx = s_dt[t] * s_x[t][p];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float2 bc = s_bc[t][j * QSPLIT + q];
        st[j] = fmaf(dec, st[j], dtx * bc.x);
        acc = fmaf(st[j], bc.y, acc);
      }
      acc = quad_sum(acc);
      if (q == 0) s_y[t][p] = acc;
    }
    __syncthreads();
    for (int i = tid; i < n * P; i += NT) {
      const int t = i / P, c = i % P;
      y[xbase + static_cast<size_t>(t0 + t) * xstep + c] = s_y[t][c];
    }
  }

  float* so = state_out + static_cast<size_t>(bh) * P * N;
#pragma unroll
  for (int j = 0; j < NQ; ++j) so[p * N + j * QSPLIT + q] = st[j];
}

// ---------------------------------------------------------------- launchers

// the dynamic shared-memory attribute, once per kernel and device (``ready``
// is the caller's, one per instantiation)
template <typename K>
cudaError_t allow_smem(K kernel, int smem, unsigned& ready) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (!(ready & (1u << device))) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready |= 1u << device;
  }
  return cudaSuccess;
}

struct RwkvArgs {
  const void *r, *k, *v, *w, *u, *state0;
  void *y, *state;
  int B, S, H;
  cudaStream_t stream;
};

// geo set: report {blocks per (b, h), threads, dynamic shared bytes} there;
// else launch
template <typename T, int DH, int CS, int RE, int CE>
int rwkv6_run(const RwkvArgs& a, int* geo) {
  using G = RwkvGeom<DH, CS, RE, CE>;
  constexpr int smem = rwkv6_smem_bytes<T, DH, CS>();
  if (geo != nullptr) {
    geo[0] = CS; geo[1] = G::NT; geo[2] = smem;
    return 0;
  }
  constexpr bool is_bf16 = sizeof(T) == 2;
  CUtensorMap maps[4];
  const void* src[4] = {a.r, a.k, a.w, a.v};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = step_rows_map(&maps[i], src[i], is_bf16, a.B, a.S,
                                          a.H * DH, DH, RW_TC);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto kernel = rwkv6_scan_kernel<T, DH, CS, RE, CE>;
  static unsigned ready = 0;
  cudaError_t err = allow_smem(kernel, smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.B * a.H * CS, G::NT, smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const T*>(a.u),
      static_cast<const float*>(a.state0), static_cast<T*>(a.y),
      static_cast<float*>(a.state), a.S, a.H);
  return static_cast<int>(cudaGetLastError());
}

// the instance (CS, RE, CE) by Dh (kernels/recurrence.py:RWKV6_INSTANCE).
// At Dh = 64, (2, 4, 4) was timed against (2, 2, 4) and (2, 4, 2) and kept
// (PERF.md)
template <typename T>
int rwkv6_by_dh(int Dh, const RwkvArgs& a, int* geo) {
  switch (Dh) {
    case 16: return rwkv6_run<T, 16, 1, 2, 4>(a, geo);
    case 32: return rwkv6_run<T, 32, 1, 4, 4>(a, geo);
    case 64: return rwkv6_run<T, 64, 2, 4, 4>(a, geo);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

struct SsdArgs {
  const void *x, *dt, *A, *Bm, *Cm, *state0;
  void *y, *state;
  int B, S, H;
  cudaStream_t stream;
};

template <int P, int N>
int mamba2_chunked_run(const SsdArgs& a, int* geo) {
  constexpr int smem = mamba2_chunked_smem_bytes<P, N>();
  if (geo != nullptr) {
    geo[0] = 1; geo[1] = SSD_THREADS; geo[2] = smem;
    return 0;
  }
  CUtensorMap maps[3];
  cudaError_t err = step_rows_map(&maps[0], a.x, true, a.B, a.S, a.H * P, P,
                                  SSD_L, swizzle_for(P));
  if (err == cudaSuccess)
    err = step_rows_map(&maps[1], a.Bm, true, a.B, a.S, N, N, SSD_L,
                        swizzle_for(N));
  if (err == cudaSuccess)
    err = step_rows_map(&maps[2], a.Cm, true, a.B, a.S, N, N, SSD_L,
                        swizzle_for(N));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = mamba2_ssd_chunked_kernel<P, N>;
  static unsigned ready = 0;
  err = allow_smem(kernel, smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.B * a.H, SSD_THREADS, smem, a.stream>>>(
      maps[0], maps[1], maps[2], static_cast<const bf16*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const float*>(a.state0),
      static_cast<bf16*>(a.y), static_cast<float*>(a.state), a.S, a.H);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int N>
int mamba2_stepwise_run(const SsdArgs& a, int* geo) {
  if (geo != nullptr) {
    geo[0] = 1; geo[1] = QSPLIT * P; geo[2] = 0;
    return 0;
  }
  mamba2_ssd_kernel<P, N><<<a.B * a.H, QSPLIT * P, 0, a.stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const float*>(a.Bm),
      static_cast<const float*>(a.Cm), static_cast<const float*>(a.state0),
      static_cast<float*>(a.y), static_cast<float*>(a.state), a.S, a.H);
  return static_cast<int>(cudaGetLastError());
}

// float32: the stepwise kernel; bf16: the chunked one
template <int P>
int mamba2_by_n(int N, int dtype, const SsdArgs& a, int* geo) {
  switch (N) {
    case 16: return dtype == 0 ? mamba2_stepwise_run<P, 16>(a, geo)
                               : mamba2_chunked_run<P, 16>(a, geo);
    case 32: return dtype == 0 ? mamba2_stepwise_run<P, 32>(a, geo)
                               : mamba2_chunked_run<P, 32>(a, geo);
    case 64: return dtype == 0 ? mamba2_stepwise_run<P, 64>(a, geo)
                               : mamba2_chunked_run<P, 64>(a, geo);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int mamba2_by_p(int P, int N, int dtype, const SsdArgs& a, int* geo) {
  switch (P) {
    case 16: return mamba2_by_n<16>(N, dtype, a, geo);
    case 32: return mamba2_by_n<32>(N, dtype, a, geo);
    case 64: return mamba2_by_n<64>(N, dtype, a, geo);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (r, k, v, w, u and y); state0 and state
// float32 (B, H, Dh, Dh).  Dh in {16, 32, 64}.
int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                      const void* w, const void* u, const void* state0,
                      void* y, void* state, int B, int S, int H, int Dh,
                      int dtype, void* stream) {
  if (B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  const RwkvArgs a{r, k, v, w, u, state0, y, state, B, S, H,
                   static_cast<cudaStream_t>(stream)};
  return dtype == 0 ? rwkv6_by_dh<float>(Dh, a, nullptr)
                    : rwkv6_by_dh<bf16>(Dh, a, nullptr);
}

// dtype: 0 float32 (stepwise), 1 bfloat16 (chunked): x, dt, B, C and y; A
// float32 (H,); state0 and state float32 (B, H, P, N).  P, N in {16, 32,
// 64}.
int mamba2_ssd_launch(const void* x, const void* dt, const void* A,
                      const void* Bm, const void* Cm, const void* state0,
                      void* y, void* state, int B, int S, int H, int P,
                      int N, int dtype, void* stream) {
  if (B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  const SsdArgs a{x, dt, A, Bm, Cm, state0, y, state, B, S, H,
                  static_cast<cudaStream_t>(stream)};
  return mamba2_by_p(P, N, dtype, a, nullptr);
}

// the launch the entry points above make: out = {blocks per (b, h),
// threads per block, dynamic shared bytes}; 0, or cudaErrorInvalidValue
int rwkv6_scan_geometry(int Dh, int dtype, int* out) {
  const RwkvArgs a{};
  return dtype == 0 ? rwkv6_by_dh<float>(Dh, a, out)
                    : rwkv6_by_dh<bf16>(Dh, a, out);
}

int mamba2_ssd_geometry(int P, int N, int dtype, int* out) {
  return mamba2_by_p(P, N, dtype, SsdArgs{}, out);
}

}  // extern "C"
