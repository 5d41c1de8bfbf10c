// Flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention (_kernel).
//
// What it computes.  Softmax attention with GQA: q (B, S, H, D) against
// k/v (B, Skv, Hkv, D), query head h reading kv head h / G (G = H / Hkv).
// Scores are scaled by 1/sqrt(D).  Queries are right-aligned (query i sits
// at position i + Skv - S); causal keeps keys at or before the query, a
// window w keeps keys after position - w.  Scores, softmax state and
// accumulators are float32; the output is cast to q's type.  Masked scores
// are NEG_INF = -0.7 * FLT_MAX and the denominator is floored at 1e-37, as
// in the reference.  Any S and Skv: ragged tails are masked.  Skv < S (a
// negative offset, cross-attention to fewer keys than queries) comes only
// without a causal mask or a window, where no position is compared and
// every key tile is visited (the launcher checks).
//
// Two kernels, dispatched by dtype (both are the port's flash_attention):
//
// bfloat16: flash_attention_mma_kernel, on Hopper's tensor cores.  At the
// prefill shape (B=4, S=Skv=1024, H=32, Hkv=8, D=128, causal) the work is
// 34.4 GFLOP on 84 MB, about 410 FLOP per byte: compute-bound (34.8 us at
// 989 TFLOP/s).  One block of two warpgroups per (query head, batch row,
// 128-query tile); each warpgroup owns 64 query rows.  Both products are
// warpgroup MMAs (wgmma.mma_async m64nNk16, bf16 -> float32): S = Q K^T
// with Q and K K-major in shared memory, then O += P V with P taken from
// the score registers as the A operand (the accumulator layout of one
// product is the register A layout of the next) and V MN-major in shared
// memory.  The tiles are in wgmma's canonical layout: rows of 64 elements
// under the hardware's 128-byte swizzle where 64 divides D (D = 128 as two
// column atoms), else rows of 32 under the 64-byte swizzle (D = 32 as one
// atom, D = 160 as five).  They arrive by cp.async 16-byte copies, the next
// key tile's in flight while the current one is computed (two stages); a
// proxy fence makes them visible to wgmma.  The online softmax runs in
// registers between the two products, in log2 units (exp2 of the scores
// scaled by log2 e / sqrt(D) in the FMA that subtracts the running max);
// the row max and sum need two shuffles across the four lanes that share
// a row.  P enters the PV product as two bfloat16 fragments, hi = bf16(p)
// and lo = bf16(p - hi), in two products: 16 bits of p's mantissa.  With
// hi alone, the rounding the Pallas kernel applies (p to v's dtype,
// flash_attention.py:78), a 12B model's attention call drifted 0.5 from
// the float32-p plain version where the bf16 tolerance allows
// 0.02 + 0.02 |out| (large |v|, outputs that cancel); the pair keeps every
// call within it, for half as many tensor-core products again.  The
// denominator sums the float32 p.  K/V reuse across the G query heads of a
// group is left to L2: the G heads of a kv head are neighbouring blocks,
// and at 410 FLOP per byte the extra L2 reads cost nothing.  Tiles wholly
// masked by causality or the window are never loaded, tiles wholly
// visible skip the mask arithmetic, and the grid runs the heaviest (last)
// query tiles first so the last wave is not all short diagonal tiles.
// TMA loads from a producer warp, and softmax overlapped with the next
// tile's products, are the next step.
//
// D = 160 (stablelm-12b: 5120 / 32): S = Q K^T takes 10 k-steps of 16 on
// 32-element atoms, and O += P V one m64n160k16 product per k-step and
// fragment (the accumulator is 80 floats a thread).  With the 32 score
// floats and the fragments that is more than the 128 registers two blocks
// an SM allow, but its 123,904 bytes of shared memory fit only one block
// an SM anyway, so that instance is compiled for one.
//
// float32: flash_attention_f32_kernel, on the CUDA cores (TF32 tensor
// cores would break the float32 tolerances).  One block per (query tile,
// kv head, batch row) holding FA_ROWS = 64 (query position, query head)
// rows of the GQA group, so every K/V tile is loaded once per group;
// float32 FMAs from shared memory, products bound by the FMA rate and the
// shared-memory loads that feed them.
//
// The C entry point launches on the given stream, does not synchronise,
// and returns cudaGetLastError() so that a refused launch raises.

#include <cstdint>

#include "attention_common.cuh"

namespace {

using attn::NEG_INF;

// ---------------------------------------------------------------- float32

constexpr int FA_ROWS = 64;
constexpr int FA_BK = 64;
constexpr int FA_THREADS = 256;

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr int f32_smem_bytes() {
  return 4 * (FA_ROWS * (D + 1) + FA_BK * (D + 1) + FA_BK * D +
              FA_ROWS * (FA_BK + 1));
}

// grid (ceil(S / bq), Hkv, B), FA_THREADS threads, f32_smem_bytes<D>().
// Thread (tr, tc) owns rows tr + 16 i (i < 4) and, per tile, keys
// tc + 16 j (j < 4) of the score tile and output columns tc + 16 c; Q and K
// rows are padded to D + 1 floats and P rows to 65 against bank conflicts.
template <int D>
__global__ void __launch_bounds__(FA_THREADS) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int S, int Skv,
    int H, int Hkv, int causal, int window, float scale) {
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
      x = q[((static_cast<long long>(b) * S + s0 + qi) * H + hk * G + g) * D + d] * scale;
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
        kx = k[at];
        vx = v[at];
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
    float* o = out + ((static_cast<long long>(b) * S + s0 + qi) * H + hk * G + g) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tc + 16 * c] = acc[i][c] / den;
  }
}

// --------------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;

constexpr int MMA_BM = 128;      // query rows per block: 2 warpgroups x 64
constexpr int MMA_BN = 64;       // keys per tile
constexpr int MMA_THREADS = 256;

// Q, then two stages of (K, V), and room to align them to 1024 bytes
template <int D>
constexpr int mma_smem_bytes() {
  return 2 * (MMA_BM * D + 4 * MMA_BN * D) + 1024;
}

// blocks an SM the register budget is set for: two where their shared
// memory fits the SM's 228 KB (D <= 128), else one
template <int D>
constexpr int mma_min_blocks() {
  return 2 * (mma_smem_bytes<D>() + 1024) <= 228 * 1024 ? 2 : 1;
}

// The shared-memory tiles are in wgmma's canonical swizzled layout: rows
// of COLS elements, 64 (128 bytes) where 64 divides D, else 32 (64 bytes),
// a tile of ROWS rows stored as D / COLS column atoms one after another,
// and in each row the 16-byte chunk c at c ^ (row mod 8) (128-byte rows) or
// c ^ (row / 2 mod 4) (64-byte rows): the hardware's 128B / 64B swizzle.
template <int D>
struct Atom {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  static constexpr int COLS = D % 64 == 0 ? 64 : 32;
  static constexpr int ROW_BYTES = 2 * COLS;
  static constexpr uint64_t SWIZZLE = ROW_BYTES == 128 ? 1 : 2;  // B128 : B64
  static constexpr uint32_t GROUP = 8 * ROW_BYTES / 16;  // 8 rows, 16 B units
};

// Element offset of 16-byte chunk `chunk` of row `row` in a ROWS-row tile
template <int D, int ROWS>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int CPA = Atom<D>::COLS / 8;       // chunks per atom row
  const int atom = chunk / CPA, c = chunk % CPA;
  const int pc = CPA == 8 ? (c ^ (row & 7)) : (c ^ ((row >> 1) & 3));
  return (atom * ROWS + row) * Atom<D>::COLS + pc * 8;
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle mode
template <int D>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo & 0x3FFF) << 16) |
         (static_cast<uint64_t>(sbo & 0x3FFF) << 32) |
         (Atom<D>::SWIZZLE << 62);
}

// k step kk (16 columns) of a K-major operand: rows [row0, row0 + 64) of a
// ROWS-row tile at shared address base
template <int D, int ROWS>
__device__ __forceinline__ uint64_t k_major(uint32_t base, int row0, int kk) {
  constexpr int COLS = Atom<D>::COLS;
  const uint32_t addr = base + ((kk * 16 / COLS) * ROWS + row0) *
                                   Atom<D>::ROW_BYTES +
                        (kk * 16 % COLS) * 2;
  return gmma_desc<D>(addr, 1, Atom<D>::GROUP);
}

// k step kk (16 rows) of an MN-major operand, all D columns, of a ROWS-row
// tile at shared address base: the next column atom is ROWS rows on
template <int D, int ROWS>
__device__ __forceinline__ uint64_t mn_major(uint32_t base, int kk) {
  return gmma_desc<D>(base + kk * 16 * Atom<D>::ROW_BYTES,
                      ROWS * Atom<D>::ROW_BYTES / 16, Atom<D>::GROUP);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 64, float32) += A (64 x 16) B (16 x 64), A and B K-major in
// shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4],
                                           uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 32, float32) += A (64 x 16, in registers) B (16 x 32), B
// MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[4][4],
                                           const unsigned (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64, float32) += A (64 x 16, in registers) B (16 x 64), B
// MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                           const unsigned (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, float32) += A (64 x 16, in registers) B (16 x 128), B
// MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4],
                                           const unsigned (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 160, float32) += A (64 x 16, in registers) B (16 x 160), B
// MN-major in shared memory (five 32-column atoms, LBO apart)
__device__ __forceinline__ void wgmma_rs(float (&d)[20][4],
                                           const unsigned (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// 2^x in one instruction; results below the float32 normal range are 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x, y) as two bf16 pairs: hi the rounded values, lo the rounded
// remainders, so hi + lo carries 16 bits of each value's mantissa
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi,
                                           unsigned& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x - f.x, y - f.y);
  hi = *reinterpret_cast<unsigned*>(&h);
  lo = *reinterpret_cast<unsigned*>(&l);
}

// ROWS rows of D bf16 from src (row stride `stride` elements) into the
// swizzled tile dst by cp.async; rows at or past n_valid are zero-filled
// without being read.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int n_valid,
                                          int tid) {
  constexpr int CH = D / 8;
  static_assert(ROWS * CH % MMA_THREADS == 0, "tile copy must split evenly");
#pragma unroll
  for (int it = 0; it < ROWS * CH / MMA_THREADS; ++it) {
    const int i = it * MMA_THREADS + tid;
    const int r = i / CH, c = i % CH;
    const bool ok = r < n_valid;
    attn::cp_async16(dst + swz<D, ROWS>(r, c), ok ? src + r * stride + c * 8 : src,
                     ok);
  }
}

// grid (H, B, ceil(S / MMA_BM)), MMA_THREADS threads, mma_smem_bytes<D>().
// Query tile blockIdx.z counts from the last tile down.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS, mma_min_blocks<D>())
flash_attention_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int S, int Skv, int H,
    int Hkv, int causal, int window, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle is on address bits: tiles start on 1024-byte boundaries
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw + ((1024 - (raw & 1023)) & 1023));
  bf16* kv_s = q_s + MMA_BM * D;     // stage t: K, then V
  const uint32_t q_addr = static_cast<uint32_t>(__cvta_generic_to_shared(q_s));

  const int h = blockIdx.x, b = blockIdx.y;
  const int s0 = (gridDim.z - 1 - blockIdx.z) * MMA_BM;
  const int hk = h / (H / Hkv);
  const int offset = Skv - S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the keys some row of this block can see, in key tiles of MMA_BN
  const int s_end = min(s0 + MMA_BM, S);
  const int pos_first = s0 + offset, pos_last = s_end - 1 + offset;
  const int k_end = causal ? min(Skv, pos_last + 1) : Skv;
  const int k_beg = window ? max(0, pos_first - window + 1) : 0;
  const int n_tiles = (k_end - k_beg + MMA_BN - 1) / MMA_BN;

  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(Hkv) * D;
  const bf16* q_g = q + (static_cast<long long>(b) * S + s0) * q_stride +
                    static_cast<long long>(h) * D;
  const long long kv_off = static_cast<long long>(b) * Skv * kv_stride +
                           static_cast<long long>(hk) * D;
  const bf16* k_g = k + kv_off;
  const bf16* v_g = v + kv_off;

  auto load_kv = [&](int t) {
    const int kt = k_beg + t * MMA_BN;
    bf16* ks = kv_s + (t & 1) * 2 * MMA_BN * D;
    load_tile<D, MMA_BN>(ks, k_g + kt * kv_stride, kv_stride, k_end - kt, tid);
    load_tile<D, MMA_BN>(ks + MMA_BN * D, v_g + kt * kv_stride, kv_stride,
                         k_end - kt, tid);
  };
  load_tile<D, MMA_BM>(q_s, q_g, q_stride, s_end - s0, tid);
  load_kv(0);
  attn::cp_async_commit();

  const int m0 = warp * 16;             // this warp's first row
  const int wg_row0 = (warp >> 2) * 64; // this warpgroup's first row
  // query positions of this thread's two rows (accumulator rows lane/4
  // and lane/4 + 8 of the warp's 16)
  const int qp[2] = {s0 + m0 + (lane >> 2) + offset,
                     s0 + m0 + (lane >> 2) + 8 + offset};
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1);
      attn::cp_async_commit();
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    // the copies' writes made visible to wgmma's (async proxy) reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t k_addr = q_addr + (MMA_BM + (t & 1) * 2 * MMA_BN) * D * 2;
    const uint32_t v_addr = k_addr + MMA_BN * D * 2;
    const int kt = k_beg + t * MMA_BN;

    // S = Q K^T: 64 rows x MMA_BN keys per warpgroup, 16 rows per warp
    float s[MMA_BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < MMA_BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, k_major<D, MMA_BM>(q_addr, wg_row0, kk),
                   k_major<D, MMA_BN>(k_addr, 0, kk));
    wgmma_commit_and_wait();

    // the mask only where some (row, key) of the tile may be hidden: past
    // k_end, right of the first row's diagonal, or at or left of the last
    // row's window edge
    const bool edge = kt + MMA_BN > k_end ||
                      (causal && kt + MMA_BN - 1 > pos_first) ||
                      (window && kt <= pos_last - window);
#pragma unroll
    for (int nt = 0; nt < MMA_BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e];
        if (edge) {
          const int key = kt + nt * 8 + 2 * (lane & 3) + (e & 1);
          const int pos = qp[e >> 1];
          bool ok = key < k_end;
          if (causal) ok = ok && key <= pos;
          if (window) ok = ok && key > pos - window;
          if (!ok) x = NEG_INF;
        }
        s[nt][e] = x;
      }

    // online softmax per row, the scores scaled into log2 units inside the
    // exponent; the four lanes of a row hold its keys
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < MMA_BN / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = ex2((m[i] - m_new) * scale_log2);
      // a row that has seen no visible key yet (a window narrower than the
      // query tile) keeps p = 0: NEG_INF * scale_log2 is rounded, and the
      // fmaf below would put that rounding error (up to ~1e31) in the
      // exponent, an inf that alpha = 0 later turns into NaN
      const float m_log2 = m_new == NEG_INF ? 0.0f : m_new * scale_log2;
      m[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < MMA_BN / 8; ++nt)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          const float p = ex2(fmaf(s[nt][e], scale_log2, -m_log2));
          s[nt][e] = p;
          sum += p;
        }
      l[i] = l[i] * alpha + sum;       // this lane's share; summed at the end
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o[dt][2 * i] *= alpha;
        o[dt][2 * i + 1] *= alpha;
      }
    }

    // O += P V with P straight from the score registers (the accumulator
    // layout of one product is the register A layout of the next) as a
    // pair of bf16 fragments, hi + lo, two products on the same V
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MMA_BN / 16; ++kk) {
      unsigned hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
      const uint64_t vd = mn_major<D, MMA_BN>(v_addr, kk);
      wgmma_rs(o, hi, vd);
      wgmma_rs(o, lo, vd);
    }
    wgmma_commit_and_wait();
    __syncthreads();                    // this stage is free for tile t + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int r = m0 + (lane >> 2) + 8 * i;
    if (s0 + r >= S) continue;
    const float den = fmaxf(li, 1e-37f);
    bf16* dst = out + (static_cast<long long>(b) * S + s0 + r) * q_stride +
                static_cast<long long>(h) * D + 2 * (lane & 3);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<unsigned*>(dst + dt * 8) =
          pack_bf16(o[dt][2 * i] / den, o[dt][2 * i + 1] / den);
  }
}

// ---------------------------------------------------------------- launch

template <int D>
int f32_launch(const void* q, const void* k, const void* v, void* out, int B,
               int S, int Skv, int H, int Hkv, int causal, int window,
               cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bq = FA_ROWS / (H / Hkv);
  const dim3 grid((S + bq - 1) / bq, Hkv, B);
  flash_attention_f32_kernel<D><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, Skv, H, Hkv,
      causal, window, attn::inv_sqrt(D));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int mma_launch(const void* q, const void* k, const void* v, void* out, int B,
               int S, int Skv, int H, int Hkv, int causal, int window,
               cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (S + MMA_BM - 1) / MMA_BM);
  const float scale_log2 = attn::inv_sqrt(D) * 1.4426950408889634f;
  flash_attention_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, Skv, H, Hkv,
      causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 float32 (CUDA cores, G = H / Hkv <= 64), 1 bfloat16 (tensor
// cores).  D in {32, 64, 128, 160}.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int Skv, int H, int Hkv,
                           int D, int dtype, int causal, int window,
                           void* stream) {
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
      case 32: return f32_launch<32>(q, k, v, out, B, S, Skv, H, Hkv, causal, window, st);
      case 64: return f32_launch<64>(q, k, v, out, B, S, Skv, H, Hkv, causal, window, st);
      case 128: return f32_launch<128>(q, k, v, out, B, S, Skv, H, Hkv, causal, window, st);
      case 160: return f32_launch<160>(q, k, v, out, B, S, Skv, H, Hkv, causal, window, st);
    }
  } else {
    switch (D) {
      case 32: return mma_launch<32>(q, k, v, out, B, S, Skv, H, Hkv, causal, window, st);
      case 64: return mma_launch<64>(q, k, v, out, B, S, Skv, H, Hkv, causal, window, st);
      case 128: return mma_launch<128>(q, k, v, out, B, S, Skv, H, Hkv, causal, window, st);
      case 160: return mma_launch<160>(q, k, v, out, B, S, Skv, H, Hkv, causal, window, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
