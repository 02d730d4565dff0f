// Backward of the selective scan (Mamba) for Hopper (sm_90a).
//
// The JAX package trains through its plain chunked scan
// (src/repro/models/layers.py:530, _mamba_scan_fused, differentiated by
// jax.grad with a jax.checkpoint per chunk of 512 steps); it has no Pallas
// backward.  This kernel is the port's own: its forward is the hand-written
// csrc/mamba_scan.cu, and a plain backward on the card would put a plain
// version on the training path.  It computes, for every batch row b, channel
// d < di and state n < N, with A = -exp(A_log), a_t = exp(dt_t A) and
// u_t = dt_t x_t (the forward's h_t = a_t h_{t-1} + u_t B_t, y_t = <h_t, C_t>),
// from the gradients g_y (B, S, di) of y and g_h (B, di, N) of the last state:
//
//   lambda_{S-1} = g_y,S-1 C_{S-1} + g_h,   lambda_t = g_y,t C_t + a_{t+1} lambda_{t+1}
//   dC_t[n]  = sum_d g_y,t[d] h_t[d, n]     dB_t[n] = sum_d lambda_t[d, n] u_t[d]
//   dx_t[d]  = dt_t[d] sum_n lambda_t[d, n] B_t[n]
//   ddt_t[d] = sum_n lambda_t[d, n] (A a_t h_{t-1} + x_t[d] B_t[n])
//   dA_log   = A sum_{b, t} lambda_t dt_t a_t h_{t-1}
//
// Shapes (contiguous, row-major), T = bf16 or f32 as in the forward:
//   dt (B, S, di) f32, bmat/cmat (B, S, N) T, x (B, S, di) T, a_log (di, N) f32,
//   g_y (B, S, di) f32 and g_h (B, di, N) f32, either null for zeros;
//   out: d_dt (B, S, di) f32, d_b/d_c (B, S, N) T, d_x (B, S, di) T, d_alog (di, N) f32.
// Any S (0 included) and any di (the last channel tile masked); N in {4, 8, 16, 32}.
//
// Bound.  At a jamba Mamba layer's admission shape (B 1, S 2,048, di 8,192,
// N 16; dt and g_y f32, x bf16) the bytes read and written once are dt 67.1
// + x 33.6 + g_y 67.1 + d_dt 67.1 + d_x 33.6 MB (+ B, C, dB, dC, A_log,
// dA_log and g_h, 1.8 MB): 270 MB, 0.081 ms at 3.35 TB/s.  The exponentials
// are one per (t, d, n), 268 M, 0.064 ms on the special-function units, and
// the f32 work 19 flops per (t, d, n), 0.076 ms at 67 TFLOP/s: the bytes
// bound it.  This first version recomputes the forward twice (below), so it
// runs three exponentials per (t, d, n) and cannot come near that bound.
//
// Design.  The states h_t are never stored whole (B S di N floats, 1.07 GB a
// layer at the shape above).  The forward's mapping is kept: 4 threads a
// channel, N / 4 states each in registers, 32 channels a block of 128
// threads, blocks over (channel tile, b), each looping over the sequence.
//
// 1. scan_bwd_states recomputes the forward and stores the state entering
//    each tile of kTile = 512 / N steps into a scratch hs (B, n_tiles, di, N)
//    f32 (33.5 MB at the shape above, with kTile 32).
// 2. scan_bwd_kernel walks the tiles in reverse.  For each it recomputes the
//    tile's states from hs into dynamic shared memory (the state before each
//    step, kTile x 128 threads x N / 4 floats = 64 KB for every N; each thread
//    reads back only what it wrote, so no barrier), then runs the adjoint
//    backwards with lambda in registers.  The recomputation is the
//    forward's exact arithmetic (ex2.approx.ftz of dt * A * log2(e), then
//    fmaf(a, h, u * B)), so the states are the forward kernel's.
// 3. The sums over channels of dB_t and dC_t span every channel tile.  Each
//    thread leaves its products in a shared buffer for kGroup steps; after a
//    barrier the block sums its 32 channels and writes one partial per
//    (b, t, channel tile, n) into pb / pc (B, S, di / 32, N) f32.  dA_log's
//    sum over t stays in registers, its sum over b goes through pa
//    (B, di, N).  scan_bwd_reduce then sums the partials in a fixed order:
//    no float atomics, so two runs on the same inputs are bit-equal.
// 4. dx and d_dt reduce over a channel's 4 lanes with two shuffle rounds;
//    lane 0 writes them.
//
// What bounds it now: 3.13 ms in bf16 at the shape above, 2.6% of the bound
// (H100 80GB HBM3, 700 W; chip_smoke.py phase 3).  The adjoint step takes 54
// registers at N 16, so the compiler does not hoist a group's global loads
// (dt, x, g_y, B_t, C_t) ahead of the recurrence: each step most likely waits
// on its loads, with 8 warps an SM to hide them (an inference from the
// register count, not a profile).  Staging each tile's inputs in shared
// memory once, as the forward's ring does, is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                 // threads per block
constexpr int kLanes = 4;                     // threads per channel
constexpr int kChannels = kThreads / kLanes;  // channels per block
constexpr int kGroup = 8;                     // steps whose dB, dC partials are summed together
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int N>
struct Bwd {
  static constexpr int kPer = N / kLanes;                   // states per thread
  static constexpr int kTile = 512 / N;                     // steps per tile
  static constexpr int kH = kTile * kThreads * kPer;        // floats of the tile's states
  static constexpr int kP = kGroup * kChannels * N;         // floats of one partial buffer
  static constexpr int kSmem = (kH + 2 * kP) * (int)sizeof(float);
  static_assert(N % kLanes == 0 && kTile % kGroup == 0, "whole states, whole groups");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The forward kernel's exponential (csrc/mamba_scan.cu, design note 4).
__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// kPer floats of shared memory at p (aligned to kPer floats) to or from v.
template <int kPer>
__device__ __forceinline__ void put(float* p, const float* v) {
  if constexpr (kPer % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kPer / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                                    v[4 * i + 3]);
  } else if constexpr (kPer == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <int kPer>
__device__ __forceinline__ void get(const float* p, float* v) {
  if constexpr (kPer % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kPer / 4; ++i) {
      const float4 w = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = w.x, v[4 * i + 1] = w.y, v[4 * i + 2] = w.z, v[4 * i + 3] = w.w;
    }
  } else if constexpr (kPer == 2) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    v[0] = w.x, v[1] = w.y;
  } else {
    v[0] = p[0];
  }
}

// Pass 1: the forward recurrence, storing the state that enters each tile.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
scan_bwd_states(const float* __restrict__ dt, const T* __restrict__ bmat,
                const T* __restrict__ x, const float* __restrict__ a_log,
                float* __restrict__ hs, int S, int di) {
  using K = Bwd<T, N>;
  constexpr int kPer = K::kPer;
  const int b = blockIdx.y;
  const int c = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int d = blockIdx.x * kChannels + c;
  const bool live = d < di;
  const int n0 = lane * kPer;
  const int n_tiles = (S + K::kTile - 1) / K::kTile;
  const size_t row0 = (size_t)b * S;

  float a2[kPer], h[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    a2[j] = live ? -expf(a_log[(size_t)d * N + n0 + j]) * kLog2e : 0.0f;
    h[j] = 0.0f;
  }
  for (int k = 0; k < n_tiles; ++k) {
    if (live) {
      float* out = hs + (((size_t)b * n_tiles + k) * di + d) * N + n0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[j] = h[j];
    }
    const int t0 = k * K::kTile, nt = min(K::kTile, S - t0);
#pragma unroll 8
    for (int tt = 0; tt < nt; ++tt) {
      const size_t r = row0 + t0 + tt;
      const float dv = live ? dt[r * di + d] : 0.0f;
      const float u = dv * (live ? to_f32(x[r * di + d]) : 0.0f);
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        h[j] = fmaf(ex2_approx(dv * a2[j]), h[j], u * to_f32(bmat[r * N + n0 + j]));
    }
  }
}

// Pass 2: per tile in reverse, recompute its states, then the adjoint.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
scan_bwd_kernel(const float* __restrict__ dt, const T* __restrict__ bmat,
                const T* __restrict__ cmat, const T* __restrict__ x,
                const float* __restrict__ a_log, const float* __restrict__ g_y,
                const float* __restrict__ g_h, const float* __restrict__ hs,
                float* __restrict__ d_dt, T* __restrict__ d_x, float* __restrict__ pb,
                float* __restrict__ pc, float* __restrict__ pa, int S, int di) {
  using K = Bwd<T, N>;
  constexpr int kPer = K::kPer;
  extern __shared__ __align__(16) float smem[];
  float* s_p = smem + K::kH;                 // [2][kGroup][kChannels][N]: dB, dC products

  const int b = blockIdx.y, nblk = gridDim.x;
  const int c = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int d = blockIdx.x * kChannels + c;
  const bool live = d < di;
  const int n0 = lane * kPer;
  const int n_tiles = (S + K::kTile - 1) / K::kTile;
  const size_t row0 = (size_t)b * S;
  // this thread's states: the one before tile step tt at my_h + tt * kThreads * kPer
  float* my_h = smem + threadIdx.x * kPer;

  // A (and A log2(e) for the exponential); a masked channel has A = 0, reads
  // dt = x = g_y = 0 and keeps lambda = 0, so its products are 0.
  float A[kPer], a2[kPer], carry[kPer], acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    A[j] = live ? -expf(a_log[(size_t)d * N + n0 + j]) : 0.0f;
    a2[j] = A[j] * kLog2e;
    carry[j] = live && g_h ? g_h[((size_t)b * di + d) * N + n0 + j] : 0.0f;
    acc[j] = 0.0f;
  }

  for (int k = n_tiles - 1; k >= 0; --k) {
    const int t0 = k * K::kTile, nt = min(K::kTile, S - t0);
    float h[kPer];
    const float* h_in = hs + (((size_t)b * n_tiles + k) * di + (live ? d : 0)) * N + n0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) h[j] = live ? h_in[j] : 0.0f;
#pragma unroll 8
    for (int tt = 0; tt < nt; ++tt) {
      const size_t r = row0 + t0 + tt;
      const float dv = live ? dt[r * di + d] : 0.0f;
      const float u = dv * (live ? to_f32(x[r * di + d]) : 0.0f);
      put<kPer>(my_h + tt * (kThreads * kPer), h);
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        h[j] = fmaf(ex2_approx(dv * a2[j]), h[j], u * to_f32(bmat[r * N + n0 + j]));
    }

    for (int g0 = (nt - 1) / kGroup * kGroup; g0 >= 0; g0 -= kGroup) {
#pragma unroll
      for (int g = kGroup - 1; g >= 0; --g) {
        const int tt = g0 + g;
        if (tt < nt) {                                  // the same for the whole block
          const size_t r = row0 + t0 + tt;
          const float dv = live ? dt[r * di + d] : 0.0f;
          const float xv = live ? to_f32(x[r * di + d]) : 0.0f;
          const float gy = live && g_y ? g_y[r * di + d] : 0.0f;
          const float u = dv * xv;
          float hp[kPer], vb[kPer], vc[kPer];
          get<kPer>(my_h + tt * (kThreads * kPer), hp);
          float du = 0.0f, dd = 0.0f;
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const float bv = to_f32(bmat[r * N + n0 + j]);
            const float cv = to_f32(cmat[r * N + n0 + j]);
            const float a = ex2_approx(dv * a2[j]);
            const float hv = fmaf(a, hp[j], u * bv);   // h_t, as the forward computes it
            const float lam = fmaf(gy, cv, carry[j]);
            vc[j] = gy * hv;
            vb[j] = lam * u;
            du = fmaf(lam, bv, du);
            const float q = lam * a * hp[j];
            dd = fmaf(q, A[j], dd);
            acc[j] = fmaf(q, dv, acc[j]);
            carry[j] = a * lam;
          }
          float* sp = s_p + (g * kChannels + c) * N + n0;
          put<kPer>(sp, vb);
          put<kPer>(sp + K::kP, vc);
#pragma unroll
          for (int o = 1; o < kLanes; o <<= 1) {
            du += __shfl_xor_sync(0xffffffffu, du, o);
            dd += __shfl_xor_sync(0xffffffffu, dd, o);
          }
          if (lane == 0 && live) {
            d_x[r * di + d] = from_f32<T>(dv * du);
            d_dt[r * di + d] = fmaf(xv, du, dd);
          }
        }
      }
      __syncthreads();                                  // the group's products are in s_p
      for (int e = threadIdx.x; e < 2 * kGroup * N; e += kThreads) {
        const int which = e / (kGroup * N), g = e / N % kGroup, n = e % N;
        if (g0 + g < nt) {
          const float* sp = s_p + which * K::kP + g * kChannels * N + n;
          float s = 0.0f;
#pragma unroll 8
          for (int cc = 0; cc < kChannels; ++cc) s += sp[cc * N];
          (which ? pc : pb)[((row0 + t0 + g0 + g) * nblk + blockIdx.x) * N + n] = s;
        }
      }
      __syncthreads();                                  // s_p is free for the next group
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) pa[((size_t)b * di + d) * N + n0 + j] = A[j] * acc[j];
  }
}

// dB, dC: the channel tiles' partials summed in order; dA_log: the rows'.
template <typename T>
__global__ void scan_bwd_reduce(const float* __restrict__ pb, const float* __restrict__ pc,
                                const float* __restrict__ pa, T* __restrict__ d_b,
                                T* __restrict__ d_c, float* __restrict__ d_alog, int B, int S,
                                int di, int N, int nblk) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n_bc = (size_t)B * S * N, n_a = (size_t)di * N;
  if (i < n_bc) {
    const size_t off = i / N * nblk * N + i % N;
    float sb = 0.0f, sc = 0.0f;
    for (int k = 0; k < nblk; ++k) {
      sb += pb[off + (size_t)k * N];
      sc += pc[off + (size_t)k * N];
    }
    d_b[i] = from_f32<T>(sb);
    d_c[i] = from_f32<T>(sc);
  } else if (i < n_bc + n_a) {
    const size_t e = i - n_bc;
    float s = 0.0f;
    for (int bb = 0; bb < B; ++bb) s += pa[bb * n_a + e];
    d_alog[e] = s;
  }
}

template <typename T, int N>
int run(const float* dt, const T* bmat, const T* cmat, const T* x, const float* a_log,
        const float* g_y, const float* g_h, float* d_dt, T* d_b, T* d_c, T* d_x,
        float* d_alog, float* scratch, int B, int S, int di, cudaStream_t s) {
  using K = Bwd<T, N>;
  auto kernel = scan_bwd_kernel<T, N>;
  // Dynamic shared memory above 48 KB: raise the cap once per instantiation and device.
  static unsigned long long done = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(done >> dev & 1ULL)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem);
    if (err != cudaSuccess) return (int)err;
    done |= 1ULL << dev;
  }
  const int nblk = (di + kChannels - 1) / kChannels;
  const int n_tiles = (S + K::kTile - 1) / K::kTile;
  // scratch: hs (B, n_tiles, di, N), pb and pc (B, S, nblk, N), pa (B, di, N), f32
  float* hs = scratch;
  float* pb = hs + (size_t)B * n_tiles * di * N;
  float* pc = pb + (size_t)B * S * nblk * N;
  float* pa = pc + (size_t)B * S * nblk * N;
  const dim3 grid((unsigned)nblk, (unsigned)B);
  if (B > 0) {
    if (S > 0) {
      scan_bwd_states<T, N><<<grid, kThreads, 0, s>>>(dt, bmat, x, a_log, hs, S, di);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, kThreads, K::kSmem, s>>>(dt, bmat, cmat, x, a_log, g_y, g_h, hs, d_dt, d_x,
                                            pb, pc, pa, S, di);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t total = (size_t)B * S * N + (size_t)di * N;
  if (total > 0) {
    scan_bwd_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
        pb, pc, pa, d_b, d_c, d_alog, B, S, di, N, nblk);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* dt, const void* bmat, const void* cmat, const void* x, const void* a_log,
           const void* g_y, const void* g_h, void* d_dt, void* d_b, void* d_c, void* d_x,
           void* d_alog, void* scratch, int B, int S, int di, int N, void* stream) {
  if (di == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* dtp = static_cast<const float*>(dt);
  const auto* bp = static_cast<const T*>(bmat);
  const auto* cp = static_cast<const T*>(cmat);
  const auto* xp = static_cast<const T*>(x);
  const auto* ap = static_cast<const float*>(a_log);
  const auto* gyp = static_cast<const float*>(g_y);
  const auto* ghp = static_cast<const float*>(g_h);
  auto* ddt = static_cast<float*>(d_dt);
  auto* db = static_cast<T*>(d_b);
  auto* dc = static_cast<T*>(d_c);
  auto* dx = static_cast<T*>(d_x);
  auto* da = static_cast<float*>(d_alog);
  auto* sc = static_cast<float*>(scratch);
  switch (N) {
    case 4: return run<T, 4>(dtp, bp, cp, xp, ap, gyp, ghp, ddt, db, dc, dx, da, sc, B, S, di, s);
    case 8: return run<T, 8>(dtp, bp, cp, xp, ap, gyp, ghp, ddt, db, dc, dx, da, sc, B, S, di, s);
    case 16: return run<T, 16>(dtp, bp, cp, xp, ap, gyp, ghp, ddt, db, dc, dx, da, sc, B, S, di, s);
    case 32: return run<T, 32>(dtp, bp, cp, xp, ap, gyp, ghp, ddt, db, dc, dx, da, sc, B, S, di, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes.  g_y and g_h may be null (zero
// gradients).  scratch holds B * (ceil(S / kTile) * di * N + 2 * S *
// ceil(di / 32) * N + di * N) floats, kTile = 512 / N
// (kernels/mamba_scan.py::bwd_scratch_bytes).  They launch on `stream` and
// return cudaGetLastError() after the launches (0 on success); they never
// synchronise and allocate nothing.
extern "C" int mamba_scan_bwd_bf16(const void* dt, const void* bmat, const void* cmat,
                                   const void* x, const void* a_log, const void* g_y,
                                   const void* g_h, void* d_dt, void* d_b, void* d_c, void* d_x,
                                   void* d_alog, void* scratch, int B, int S, int di, int N,
                                   void* stream) {
  return launch<__nv_bfloat16>(dt, bmat, cmat, x, a_log, g_y, g_h, d_dt, d_b, d_c, d_x, d_alog,
                               scratch, B, S, di, N, stream);
}

extern "C" int mamba_scan_bwd_f32(const void* dt, const void* bmat, const void* cmat,
                                  const void* x, const void* a_log, const void* g_y,
                                  const void* g_h, void* d_dt, void* d_b, void* d_c, void* d_x,
                                  void* d_alog, void* scratch, int B, int S, int di, int N,
                                  void* stream) {
  return launch<float>(dt, bmat, cmat, x, a_log, g_y, g_h, d_dt, d_b, d_c, d_x, d_alog,
                       scratch, B, S, di, N, stream);
}
