// Recurrence kernels for Hopper (sm_90a): the prefill scans of the
// recurrent LM serving paths (RWKV6 and the Mamba2 layers of the hybrid).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   rwkv6_scan_kernel  <- repro/kernels/rwkv6_scan.py:rwkv6_scan (_kernel)
//   mamba2_ssd_kernel  <- repro/kernels/mamba2_ssd.py:mamba2_ssd (_kernel)
//
// What they compute.  rwkv6: per (batch row b, head h) a Dh x Dh float32
// state S [key x value], and for t = 0 .. S-1
//     y_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t
// with r, k, v, w (B, S, H, Dh) and u (H, Dh) in the model's dtype.  mamba2:
// per (b, h) a P x N float32 state and
//     S <- exp(dt_t A_h) S + dt_t x_t B_t^T,   y_t = S C_t
// with x (B, S, H, P), dt (B, S, H), B and C (B, S, N) in the model's dtype
// and A (H,) float32.  Both take the initial state (float32) and return y in
// the inputs' dtype and the final state in float32.  Everything is computed
// in float32; the decay is expf (no fast-math intrinsics), and the stepwise
// form is kept: the exp-factored chunked form is unsafe for RWKV's
// unbounded data-dependent decays (repro/kernels/rwkv6_scan.py:6-10).
//
// Design.  The Pallas kernels walk a sequential grid of time chunks with the
// state in VMEM scratch.  Here one block per (b, h) runs the whole sequence
// in a loop, with the state in registers: QSPLIT = 4 threads share one state
// column (rwkv6: value index v, rows k = 4j + q) or one state row (mamba2:
// position p, columns n = 4j + q), so each thread holds Dh/4 (or N/4)
// floats, and the 4 partial sums of y_t are joined by two shuffles inside the
// warp.  The inputs of TC = 32 steps at a time are staged in shared memory
// as float32 (rwkv6 packs (r, k, w, v) of one index into a float4, so a step
// costs one 16-byte shared load per state row; mamba2 packs (B, C) into a
// float2 and precomputes exp(dt A) once per step), and the next chunk's
// global loads are issued into registers before the current chunk is
// computed, so the sequential loop does not wait on device memory.  y is
// staged in shared memory and written back one chunk at a time, with
// neighbouring threads on neighbouring addresses.  Any S is taken (the
// last chunk is ragged); the Pallas kernels need S to be a multiple of
// their chunk.
//
// What bounds them on this card.  The recurrences are elementwise FMAs with
// no matrix product for the tensor cores.  rwkv6 at the serving prefill
// (B=4, S=1024, H=32, Dh=64, bf16) does about 7 float32 operations per state
// element per step, 3.8 GFLOP (56 us at 67 TFLOP/s) on 88 MB (26 us at
// 3.35 TB/s): operations.  mamba2 (B=4, S=1024, H=64, P=N=64) does about 5,
// 5.4 GFLOP (80 us) on 77 MB (23 us): operations.  But the work is
// sequential in t and parallel only over (b, h): 128 and 256 blocks of
// 4*Dh (4*P) threads, about one block per SM, so each SM runs 8 warps and
// each step is a short chain of dependent FMAs, shared-memory loads and two
// shuffles.  These kernels are bound by that latency, not by the FP rate;
// more parallelism needs a chunked (matrix) form of the scan, which is a
// later change.
//
// Each C entry point launches on the given stream, does not synchronise,
// and returns cudaGetLastError() so that a refused launch raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TC = 32;       // time steps staged in shared memory at once
constexpr int QSPLIT = 4;    // threads per rwkv6 state column / mamba2 row

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

// the sum of x over the QSPLIT = 4 neighbouring lanes that share a column
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// ---------------------------------------------------------------- rwkv6

// grid (B * H), QSPLIT * DH threads.  Thread tid owns state column
// col = tid / 4, rows k = 4 j + q (q = tid % 4).
template <typename T, int DH>
__global__ void __launch_bounds__(QSPLIT * DH) rwkv6_scan_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const T* __restrict__ u,
    const float* __restrict__ state0, T* __restrict__ y,
    float* __restrict__ state_out, int S, int H) {
  constexpr int NT = QSPLIT * DH;
  constexpr int KQ = DH / QSPLIT;          // state rows per thread
  constexpr int PER = TC * DH / NT;        // staged elements per thread
  __shared__ float4 s_in[TC][DH];          // (r, k, w, v) at (step, index)
  __shared__ float s_y[TC][DH];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int col = tid / QSPLIT, q = tid % QSPLIT;
  const size_t step = static_cast<size_t>(H) * DH;       // between steps
  const size_t base = (static_cast<size_t>(b) * S * H + h) * DH;

  float st[KQ], uk[KQ];
  const float* s0 = state0 + static_cast<size_t>(bh) * DH * DH;
#pragma unroll
  for (int j = 0; j < KQ; ++j) {
    const int kk = j * QSPLIT + q;
    st[j] = s0[kk * DH + col];
    uk[j] = to_f32(u[h * DH + kk]);
  }

  float4 pre[PER];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int it = 0; it < PER; ++it) {
      const int i = tid + it * NT;
      const int t = i / DH, c = i % DH;
      if (t0 + t < S) {
        const size_t at = base + static_cast<size_t>(t0 + t) * step + c;
        pre[it] = make_float4(to_f32(r[at]), to_f32(k[at]), to_f32(w[at]),
                              to_f32(v[at]));
      }
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < S; t0 += TC) {
    const int n = min(TC, S - t0);
    __syncthreads();                       // the last chunk is written out
#pragma unroll
    for (int it = 0; it < PER; ++it) {
      const int i = tid + it * NT;
      if (i / DH < n) s_in[i / DH][i % DH] = pre[it];
    }
    __syncthreads();
    if (t0 + TC < S) fetch(t0 + TC);       // in flight during the steps
    for (int t = 0; t < n; ++t) {
      const float vv = s_in[t][col].w;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < KQ; ++j) {
        const float4 e = s_in[t][j * QSPLIT + q];   // (r, k, w, -)
        const float kv = e.y * vv;
        acc = fmaf(e.x, fmaf(uk[j], kv, st[j]), acc);
        st[j] = fmaf(e.z, st[j], kv);
      }
      acc = quad_sum(acc);
      if (q == 0) s_y[t][col] = acc;
    }
    __syncthreads();
    for (int i = tid; i < n * DH; i += NT) {
      const int t = i / DH, c = i % DH;
      y[base + static_cast<size_t>(t0 + t) * step + c] = from_f32<T>(s_y[t][c]);
    }
  }

  float* so = state_out + static_cast<size_t>(bh) * DH * DH;
#pragma unroll
  for (int j = 0; j < KQ; ++j) so[(j * QSPLIT + q) * DH + col] = st[j];
}

// ---------------------------------------------------------------- mamba2

// grid (B * H), QSPLIT * P threads.  Thread tid owns state row p = tid / 4,
// columns n = 4 j + q (q = tid % 4).
template <typename T, int P, int N>
__global__ void __launch_bounds__(QSPLIT * P) mamba2_ssd_kernel(
    const T* __restrict__ x, const T* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ state0,
    T* __restrict__ y, float* __restrict__ state_out, int S, int H) {
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
        pre_x[it] = to_f32(x[xbase + static_cast<size_t>(t0 + t) * xstep + c]);
    }
#pragma unroll
    for (int it = 0; it < PER_BC; ++it) {
      const int i = tid + it * NT;
      const int t = i / N, c = i % N;
      if (t < TC && t0 + t < S) {
        const size_t at = bcbase + static_cast<size_t>(t0 + t) * N + c;
        pre_bc[it] = make_float2(to_f32(Bm[at]), to_f32(Cm[at]));
      }
    }
    if (tid < TC && t0 + tid < S)
      pre_dt = to_f32(dt[dtbase + static_cast<size_t>(t0 + tid) * H]);
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
      y[xbase + static_cast<size_t>(t0 + t) * xstep + c] = from_f32<T>(s_y[t][c]);
    }
  }

  float* so = state_out + static_cast<size_t>(bh) * P * N;
#pragma unroll
  for (int j = 0; j < NQ; ++j) so[p * N + j * QSPLIT + q] = st[j];
}

// ---------------------------------------------------------------- launchers

template <typename T, int DH>
int rwkv6_launch(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* state0, void* y, void* state,
                 int B, int S, int H, cudaStream_t stream) {
  rwkv6_scan_kernel<T, DH><<<B * H, QSPLIT * DH, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), static_cast<const float*>(state0),
      static_cast<T*>(y), static_cast<float*>(state), S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rwkv6_by_dim(int Dh, const void* r, const void* k, const void* v,
                 const void* w, const void* u, const void* state0, void* y,
                 void* state, int B, int S, int H, cudaStream_t stream) {
  switch (Dh) {
    case 16: return rwkv6_launch<T, 16>(r, k, v, w, u, state0, y, state, B, S, H, stream);
    case 32: return rwkv6_launch<T, 32>(r, k, v, w, u, state0, y, state, B, S, H, stream);
    case 64: return rwkv6_launch<T, 64>(r, k, v, w, u, state0, y, state, B, S, H, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int P, int N>
int mamba2_launch(const void* x, const void* dt, const void* A,
                  const void* Bm, const void* Cm, const void* state0, void* y,
                  void* state, int B, int S, int H, cudaStream_t stream) {
  mamba2_ssd_kernel<T, P, N><<<B * H, QSPLIT * P, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(state0),
      static_cast<T*>(y), static_cast<float*>(state), S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int mamba2_by_n(int N, const void* x, const void* dt, const void* A,
                const void* Bm, const void* Cm, const void* state0, void* y,
                void* state, int B, int S, int H, cudaStream_t stream) {
  switch (N) {
    case 16: return mamba2_launch<T, P, 16>(x, dt, A, Bm, Cm, state0, y, state, B, S, H, stream);
    case 32: return mamba2_launch<T, P, 32>(x, dt, A, Bm, Cm, state0, y, state, B, S, H, stream);
    case 64: return mamba2_launch<T, P, 64>(x, dt, A, Bm, Cm, state0, y, state, B, S, H, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int mamba2_by_dims(int P, int N, const void* x, const void* dt,
                   const void* A, const void* Bm, const void* Cm,
                   const void* state0, void* y, void* state, int B, int S,
                   int H, cudaStream_t stream) {
  switch (P) {
    case 16: return mamba2_by_n<T, 16>(N, x, dt, A, Bm, Cm, state0, y, state, B, S, H, stream);
    case 32: return mamba2_by_n<T, 32>(N, x, dt, A, Bm, Cm, state0, y, state, B, S, H, stream);
    case 64: return mamba2_by_n<T, 64>(N, x, dt, A, Bm, Cm, state0, y, state, B, S, H, stream);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
      ? rwkv6_by_dim<float>(Dh, r, k, v, w, u, state0, y, state, B, S, H, st)
      : rwkv6_by_dim<__nv_bfloat16>(Dh, r, k, v, w, u, state0, y, state, B, S, H, st);
}

// dtype: 0 float32, 1 bfloat16 (x, dt, B, C and y); A float32 (H,);
// state0 and state float32 (B, H, P, N).  P, N in {16, 32, 64}.
int mamba2_ssd_launch(const void* x, const void* dt, const void* A,
                      const void* Bm, const void* Cm, const void* state0,
                      void* y, void* state, int B, int S, int H, int P,
                      int N, int dtype, void* stream) {
  if (B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
      ? mamba2_by_dims<float>(P, N, x, dt, A, Bm, Cm, state0, y, state, B, S, H, st)
      : mamba2_by_dims<__nv_bfloat16>(P, N, x, dt, A, Bm, Cm, state0, y, state, B, S, H, st);
}

}  // extern "C"
