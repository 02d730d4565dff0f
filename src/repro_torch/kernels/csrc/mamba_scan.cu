// Selective scan (Mamba) for Hopper (sm_90a): discretise, recur and contract
// in one pass, the state resident in registers in f32.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan.py (mamba_scan_pallas,
// body _mamba_scan_kernel) and computes what it computes, for every batch row
// b, channel d < di and state n < N:
//
//   A       = -exp(A_log[d, n])
//   h_t     = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t[n]      (h_{-1} = 0)
//   y_t[d]  = sum_n h_t[n] * C_t[n]                                 (f32)
//
// and also writes the last state h_{S-1} (B, di, N), which the model keeps as
// the lane's recurrent state after a full-sequence admission.  It is not a
// copy of the Pallas grid (B, di_blocks, n_chunks): that grid walks the
// chunk axis in order on one TPU core and carries h in VMEM scratch.  Here
// blocks run in parallel over (d tile, b), and each thread block loops over
// the whole sequence itself.  Any S is taken (no chunk padding) and any di
// (the last tile is masked; no di % di_block limit).
//
// Shapes (all contiguous, row-major):
//   dt     (B, S, di)  f32        softplus'd step sizes
//   bmat   (B, S, N)   T          input projection B_t
//   cmat   (B, S, N)   T          output projection C_t
//   x      (B, S, di)  T          conv'd inputs
//   a_log  (di, N)     f32
//   y      (B, S, di)  f32        output
//   h_last (B, di, N)  f32        output: the state after the last step
// with T = bf16 (the model's path: dt f32, x/B/C bf16) or f32, and
// N in {4, 8, 16, 32}.
//
// Design (simple and right first): the N states of one (b, d) channel are
// split over 4 adjacent threads (N/4 each, in registers); y_t is their sum,
// reduced with two xor shuffles.  A block of 128 threads owns 32 channels of
// one batch row.  For each tile of 64 time steps the block stages dt,
// dt * x (read coalesced along d), B_t and C_t in shared memory, runs the
// recurrence over the tile, and writes the tile's y back coalesced along d.
// At B 1, di 8,192 that is 256 blocks of 128 threads on 132 SMs.
//
// Bound.  At the main path's shape (B 1, S 2,048, di 8,192, N 16; dt f32,
// x bf16) the bytes are dt 67.1 MB + x 33.6 MB + y 67.1 MB (+ B, C, A_log
// and h_last, 1.2 MB): 168.9 MB, 50.4 us at 3.35 TB/s.  The exponentials are
// S * di * N = 268 M, one per (t, d, n), on the special-function units
// (16 a clock per SM: 132 x 16 x 1.98 GHz = 4.18 T/s): 64.2 us.  The f32
// arithmetic is 6 operations per (t, d, n) (dt * A, (dt x) * B_n, an FMA for
// h, an FMA for y): 1.61 GFLOP, 24.0 us at 67 TFLOP/s.  So the exponentials
// bound it, then the bytes.  The sequential loop over S is the latency chain:
// one FMA per step per state; the rest of a step does not depend on h.
//
// What this design leaves on the table: the sequence runs in one pass per
// channel, so only di/32 x B blocks are in flight (about 2 per SM at B 1);
// staging goes through registers with no cp.async / TMA double buffer, and
// the block waits at two barriers per tile.  A chunked two-pass scan over S
// (per-chunk states, then a fix-up) would fill the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;                     // threads that share one channel's states
constexpr int kChannels = 32;                 // channels per block
constexpr int kThreads = kLanes * kChannels;  // 128
constexpr int kSteps = 64;                    // time steps staged per tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const float* __restrict__ dt, const T* __restrict__ bmat,
                  const T* __restrict__ cmat, const T* __restrict__ x,
                  const float* __restrict__ a_log, float* __restrict__ y,
                  float* __restrict__ h_last, int S, int di) {
  constexpr int kPer = N / kLanes;  // states per thread: n = lane * kPer + j
  __shared__ float s_dt[kSteps][kChannels];
  __shared__ float s_dx[kSteps][kChannels];  // dt * x
  __shared__ float s_y[kSteps][kChannels];
  __shared__ float s_b[kSteps][N];
  __shared__ float s_c[kSteps][N];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int c = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int d = d0 + c;

  // A in base 2: exp(dt * A) = exp2(dt * A * log2(e)).  A masked channel
  // (d >= di) keeps A = 0 and dt * x = 0, so its state stays 0.
  float a2[kPer], h[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    a2[j] = d < di ? -expf(a_log[(size_t)d * N + lane * kPer + j]) * kLog2e : 0.0f;
    h[j] = 0.0f;
  }

  const size_t row0 = (size_t)b * S;  // first time row of this batch row
  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const int nt = min(kSteps, S - t0);
    for (int e = threadIdx.x; e < kSteps * kChannels; e += kThreads) {
      const int tt = e / kChannels, cc = e % kChannels;
      float dv = 0.0f, xv = 0.0f;
      if (tt < nt && d0 + cc < di) {
        const size_t off = (row0 + t0 + tt) * di + d0 + cc;
        dv = dt[off];
        xv = to_f32(x[off]);
      }
      s_dt[tt][cc] = dv;
      s_dx[tt][cc] = dv * xv;
    }
    for (int e = threadIdx.x; e < kSteps * N; e += kThreads) {
      const int tt = e / N, n = e % N;
      float bv = 0.0f, cv = 0.0f;
      if (tt < nt) {
        const size_t off = (row0 + t0 + tt) * N + n;
        bv = to_f32(bmat[off]);
        cv = to_f32(cmat[off]);
      }
      s_b[tt][n] = bv;
      s_c[tt][n] = cv;
    }
    __syncthreads();

#pragma unroll 4
    for (int tt = 0; tt < nt; ++tt) {
      const float dv = s_dt[tt][c], dx = s_dx[tt][c];
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int n = lane * kPer + j;
        h[j] = fmaf(exp2f(dv * a2[j]), h[j], dx * s_b[tt][n]);
        acc = fmaf(h[j], s_c[tt][n], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (lane == 0) s_y[tt][c] = acc;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < nt * kChannels; e += kThreads) {
      const int tt = e / kChannels, cc = e % kChannels;
      if (d0 + cc < di) y[(row0 + t0 + tt) * di + d0 + cc] = s_y[tt][cc];
    }
    // The next tile's staging writes s_dt/s_dx/s_b/s_c, which every thread
    // finished reading before the barrier above; s_y is next written after
    // the next tile's first barrier, which every thread reaches only once
    // its stores above are done.
  }

  if (d < di) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) h_last[((size_t)b * di + d) * N + lane * kPer + j] = h[j];
  }
}

template <typename T>
int launch(const void* dt, const void* bmat, const void* cmat, const void* x, const void* a_log,
           void* y, void* h_last, int B, int S, int di, int N, void* stream) {
  if (B == 0 || di == 0) return 0;
  const dim3 grid((unsigned)((di + kChannels - 1) / kChannels), (unsigned)B), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* dtp = static_cast<const float*>(dt);
  const auto* bp = static_cast<const T*>(bmat);
  const auto* cp = static_cast<const T*>(cmat);
  const auto* xp = static_cast<const T*>(x);
  const auto* ap = static_cast<const float*>(a_log);
  auto* yp = static_cast<float*>(y);
  auto* hp = static_cast<float*>(h_last);
#define REPRO_SCAN_CASE(NN)                                                                 \
  if (N == NN) {                                                                            \
    mamba_scan_kernel<T, NN><<<grid, block, 0, s>>>(dtp, bp, cp, xp, ap, yp, hp, S, di);    \
    return (int)cudaGetLastError();                                                         \
  }
  REPRO_SCAN_CASE(4)
  REPRO_SCAN_CASE(8)
  REPRO_SCAN_CASE(16)
  REPRO_SCAN_CASE(32)
#undef REPRO_SCAN_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points, bound with ctypes.  They launch on `stream` and
// return cudaGetLastError() after the launch (0 on success); they never
// synchronise and allocate nothing.
extern "C" int mamba_scan_bf16(const void* dt, const void* bmat, const void* cmat, const void* x,
                               const void* a_log, void* y, void* h_last, int B, int S, int di,
                               int N, void* stream) {
  return launch<__nv_bfloat16>(dt, bmat, cmat, x, a_log, y, h_last, B, S, di, N, stream);
}

extern "C" int mamba_scan_f32(const void* dt, const void* bmat, const void* cmat, const void* x,
                              const void* a_log, void* y, void* h_last, int B, int S, int di,
                              int N, void* stream) {
  return launch<float>(dt, bmat, cmat, x, a_log, y, h_last, B, S, di, N, stream);
}
