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
// the whole sequence itself.  Any S is taken (0 included; no chunk padding)
// and any di (the last channel tile is masked).
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
// Bound.  At the main path's shape (B 1, S 2,048, di 8,192, N 16; dt f32,
// x bf16) the bytes are dt 67.1 MB + x 33.6 MB + y 67.1 MB (+ B, C, A_log
// and h_last, 1.2 MB): 168.9 MB, 50.4 us at 3.35 TB/s.  The exponentials are
// S * di * N = 268 M, one per (t, d, n), on the special-function units
// (16 a clock per SM: 132 x 16 x 1.98 GHz = 4.18 T/s): 64.2 us.  The rest of
// a (t, d, n) is four instructions (dt * A, (dt x) * B_n, an FMA for h, an
// FMA for y), so issue (one warp instruction a clock per scheduler) comes
// close behind the SFUs once the per-step work of a thread (loads of dt, x,
// B_t and C_t, bf16 conversions, the shuffles of the y sum) is added.  So the
// exponentials bound it, then issue, then the bytes.
//
// Design.  The first version of this kernel staged each 64-step tile through
// registers with plain loads, then waited at a barrier, recurred, waited
// again and wrote y: no load was in flight while a tile recurred, and at 2
// blocks of 4 warps an SM nothing hid that wait (all-f32 inputs took 45%
// longer for the same exponentials).  This one:
//
// 1. A cp.async tile ring in dynamic shared memory: kStages tiles of kSteps
//    time steps, each the block's dt (f32), x, B_t and C_t in their input
//    dtypes (dt * x is formed at use, so bf16 x keeps 2 bytes in shared
//    memory).  Tiles k+1 .. k+kStages-1 are in flight while tile k recurs;
//    one __syncthreads per tile both publishes tile k and frees the slot of
//    tile k-1 for the next copy.  The ragged last tile and the masked
//    channels are zero-filled through cp.async's src-size operand, so the
//    recurrence always runs kSteps steps with no branch: dt = 0 and x = 0
//    leave h unchanged (exp(0) = 1, no input), and a masked channel has A = 0
//    and stays 0.  No copy is issued past the last tile.  The copy width of
//    each operand (16, 8 or 4 bytes, or plain element loads where a bf16 row
//    is not 4-byte aligned) is chosen from its pointer and row stride by the
//    wrapper (kernels/mamba_scan.py::_scan_plan) and passed in.
// 2. y off the recurrence's path: a lane's partial sums of kGroup steps are
//    reduced across the channel's lanes together (reduce_scatter: log2(kLanes)
//    rounds of shuffles, each lane left with whole sums of kGroup / kLanes
//    steps), stored to a double-buffered y tile (static shared memory, so its
//    stores do not pin the ring's loads in place) and written out with
//    16-byte stores after the next barrier.  A store per step into the ring's
//    own array kept every step's loads behind the last step's store, and ran
//    markedly slower.
// 3. Warps: the N states of a channel are split over kLanes adjacent threads
//    (N / kLanes each, in registers), 128 threads a block.  kLanes 4 (32
//    channels a block, 256 blocks at B 1, di 8,192: 8 warps an SM) ran faster
//    than kLanes 8 (16 channels, 512 blocks, 16 warps an SM) at every N on the
//    H100: the per-step work of a thread (dt, x, B_t, C_t, the y sums) is
//    shared by fewer exponentials at 8 lanes, and that costs more than the
//    extra warps hide.  Only 4 is built; PERF.md keeps both times.
// 4. The bare exponential: ex2.approx.ftz.f32 on dt * A * log2(e), one MUFU
//    instruction.  Its argument is <= 0, so the factor lies in (0, 1]; a
//    factor below 2^-126 is flushed to 0, which changes h by less than
//    1.2e-38 |h|, far inside the 1e-4 tolerance the kernel is held to.
//
// What bounds it now: at about half its SFU bound, the SFUs are busy about
// half the time and the schedulers issue on about 60% of the clocks (an
// estimate from the instruction count, not a profile): with 8 warps an SM,
// two a scheduler, the latency of each group's loads, MUFU results and
// shuffle rounds is only partly hidden.  More warps at B 1 need more channels
// than di gives, so the next step is a chunked two-pass scan over S, which
// doubles the exponentials; it pays only while the latency, not the SFUs,
// sets the pace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                 // threads per block: kLanes x channels
constexpr int kLanes = 4;                     // threads per channel (N / kLanes states each)
constexpr int kSteps = 64;                    // time steps per tile
constexpr int kStages = 3;                    // tiles in the ring
constexpr int kGroup = 8;                     // steps whose y sums are reduced together
constexpr float kLog2e = 1.4426950408889634f;

// Copy widths in bytes, per operand, chosen by the wrapper.  A width equal to
// the element size means plain loads (bf16 rows not 4-byte aligned).
struct Widths {
  int dt, x, b, c, y;
};

template <typename T, int N>
struct Layout {
  static constexpr int kChannels = kThreads / kLanes;
  static constexpr int kDt = kSteps * kChannels * 4;                  // f32
  static constexpr int kX = kSteps * kChannels * (int)sizeof(T);
  static constexpr int kBC = kSteps * N * (int)sizeof(T);             // B or C
  static constexpr int kStage = kDt + kX + 2 * kBC;
  static constexpr int kRing = kStages * kStage;                      // dynamic smem
  static constexpr int kY = kSteps * kChannels;                       // one y tile (f32)
};

// Sum v[g] over the kLanes lanes of a channel for each of the G steps g,
// leaving lane l the sums of steps l * G / kLanes + i in v[i], i < G / kLanes
// (log2(kLanes) rounds; each halves the values a lane holds).
template <int G>
__device__ __forceinline__ void reduce_scatter(float (&v)[G], int lane) {
  static_assert(G % kLanes == 0, "each lane keeps whole sums");
#pragma unroll
  for (int o = kLanes / 2; o >= 1; o /= 2) {
    const int half = G * o / kLanes;
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// cp.async of W bytes, of which the first src_bytes are read and the rest
// zero-filled (src_bytes = 0 reads nothing).
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(W),
                 "r"(src_bytes) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage rows [0, kSteps) x columns [0, C) of a (rows, ld) matrix of E whose
// tile starts at g into s (kSteps x C, dense).  Rows >= nt and columns >= nc
// are zero-filled.  W bytes per copy; W == sizeof(E) < 4 means plain loads.
template <typename E, int C, int W>
__device__ __forceinline__ void stage_cols_w(E* s, const E* g, size_t ld, int nt, int nc) {
  constexpr int kPer = W / (int)sizeof(E);
  constexpr int kRow = C / kPer;                // copies per row
  constexpr int kCopies = kSteps * kRow;
#pragma unroll
  for (int i = 0; i < kCopies / kThreads; ++i) {  // kCopies is a multiple of kThreads
    const int e = i * kThreads + threadIdx.x;
    const int tt = e / kRow, cc = (e % kRow) * kPer;
    const int valid = tt < nt ? max(0, min(kPer, nc - cc)) : 0;
    const E* src = valid ? g + tt * ld + cc : g;
    if constexpr (W >= 4) {
      cp_async<W>(s + tt * C + cc, src, valid * (int)sizeof(E));
    } else {
      s[tt * C + cc] = valid ? *src : E(0.0f);
    }
  }
}

template <typename E, int C>
__device__ __forceinline__ void stage_cols(E* s, const E* g, size_t ld, int nt, int nc, int w) {
  if (w == 16) stage_cols_w<E, C, 16>(s, g, ld, nt, nc);
  else if (w == 8) stage_cols_w<E, C, 8>(s, g, ld, nt, nc);
  else if (w == 4) stage_cols_w<E, C, 4>(s, g, ld, nt, nc);
  else if constexpr (sizeof(E) == 2) stage_cols_w<E, C, 2>(s, g, ld, nt, nc);
}

// Stage the contiguous run g[0, kSteps * N) (B_t or C_t of one tile) into s;
// elements >= n_valid are zero-filled.
template <typename E, int N, int W>
__device__ __forceinline__ void stage_flat_w(E* s, const E* g, int n_valid) {
  constexpr int kPer = W / (int)sizeof(E);
  constexpr int kCopies = kSteps * N / kPer;
#pragma unroll
  for (int i = 0; i < (kCopies + kThreads - 1) / kThreads; ++i) {
    const int e = i * kThreads + threadIdx.x;
    if (kCopies % kThreads != 0 && e >= kCopies) break;
    const int off = e * kPer;
    const int valid = max(0, min(kPer, n_valid - off));
    const E* src = valid ? g + off : g;
    if constexpr (W >= 4) {
      cp_async<W>(s + off, src, valid * (int)sizeof(E));
    } else {
      s[off] = valid ? *src : E(0.0f);
    }
  }
}

template <typename E, int N>
__device__ __forceinline__ void stage_flat(E* s, const E* g, int n_valid, int w) {
  if (w == 16) stage_flat_w<E, N, 16>(s, g, n_valid);
  else if (w == 8) stage_flat_w<E, N, 8>(s, g, n_valid);
  else if (w == 4) stage_flat_w<E, N, 4>(s, g, n_valid);
  else if constexpr (sizeof(E) == 2) stage_flat_w<E, N, 2>(s, g, n_valid);
}

// kPer consecutive elements of shared memory, as f32 (vector loads: the
// offset is a multiple of kPer elements).
template <int kPer>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (kPer % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kPer / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = v.x, out[4 * i + 1] = v.y, out[4 * i + 2] = v.z, out[4 * i + 3] = v.w;
    }
  } else if constexpr (kPer == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  } else {
    out[0] = p[0];
  }
}

__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float* out) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}

template <int kPer>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* out) {
  if constexpr (kPer % 8 == 0) {
#pragma unroll
    for (int i = 0; i < kPer / 8; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      unpack_bf16x2(v.x, out + 8 * i), unpack_bf16x2(v.y, out + 8 * i + 2);
      unpack_bf16x2(v.z, out + 8 * i + 4), unpack_bf16x2(v.w, out + 8 * i + 6);
    }
  } else if constexpr (kPer == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    unpack_bf16x2(v.x, out), unpack_bf16x2(v.y, out + 2);
  } else if constexpr (kPer == 2) {
    unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p), out);
  } else {
    out[0] = __bfloat162float(p[0]);
  }
}

// Rows [0, nt) x columns [0, nc) of the y tile s (kSteps x C) to g (row
// stride ld), W bytes per store.
template <int C, int W>
__device__ __forceinline__ void write_y_w(float* g, const float* s, size_t ld, int nt, int nc) {
  constexpr int kPer = W / 4;
  constexpr int kRow = C / kPer;
#pragma unroll
  for (int i = 0; i < kSteps * kRow / kThreads; ++i) {  // a multiple of kThreads
    const int e = i * kThreads + threadIdx.x;
    const int tt = e / kRow, cc = (e % kRow) * kPer;
    if (tt < nt && cc < nc) {
      if constexpr (W == 16) {
        *reinterpret_cast<float4*>(g + tt * ld + cc) =
            *reinterpret_cast<const float4*>(s + tt * C + cc);
      } else if constexpr (W == 8) {
        *reinterpret_cast<float2*>(g + tt * ld + cc) =
            *reinterpret_cast<const float2*>(s + tt * C + cc);
      } else {
        g[tt * ld + cc] = s[tt * C + cc];
      }
    }
  }
}

template <int C>
__device__ __forceinline__ void write_y(float* g, const float* s, size_t ld, int nt, int nc,
                                        int w) {
  if (w == 16) write_y_w<C, 16>(g, s, ld, nt, nc);
  else if (w == 8) write_y_w<C, 8>(g, s, ld, nt, nc);
  else write_y_w<C, 4>(g, s, ld, nt, nc);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const float* __restrict__ dt, const T* __restrict__ bmat,
                  const T* __restrict__ cmat, const T* __restrict__ x,
                  const float* __restrict__ a_log, float* __restrict__ y,
                  float* __restrict__ h_last, int S, int di, Widths w) {
  using L = Layout<T, N>;
  constexpr int C = L::kChannels;
  constexpr int kPer = N / kLanes;  // states per thread: n = lane * kPer + j
  static_assert(N % kLanes == 0 && 32 % kLanes == 0, "whole states, a channel in one warp");
  extern __shared__ __align__(16) unsigned char smem[];  // the tile ring
  // The y tiles, an object of their own, so that their stores are not taken
  // to alias the ring's loads and the compiler may hoist those.
  __shared__ __align__(16) float s_yt[2][L::kY];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * C;
  const int nc = min(C, di - d0);  // channels of this block inside di
  const int c = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int d = d0 + c;
  const int n_tiles = (S + kSteps - 1) / kSteps;
  const size_t row0 = (size_t)b * S;  // first time row of this batch row

  // Stage tile k into ring slot k % kStages: one commit group per call.
  auto stage = [&](int k) {
    if (k < n_tiles) {
      unsigned char* st = smem + (k % kStages) * L::kStage;
      const int t0 = k * kSteps, nt = min(kSteps, S - t0);
      const size_t off = (row0 + t0) * di + d0;
      stage_cols<float, C>(reinterpret_cast<float*>(st), dt + off, di, nt, nc, w.dt);
      stage_cols<T, C>(reinterpret_cast<T*>(st + L::kDt), x + off, di, nt, nc, w.x);
      stage_flat<T, N>(reinterpret_cast<T*>(st + L::kDt + L::kX), bmat + (row0 + t0) * N,
                       nt * N, w.b);
      stage_flat<T, N>(reinterpret_cast<T*>(st + L::kDt + L::kX + L::kBC),
                       cmat + (row0 + t0) * N, nt * N, w.c);
    }
    cp_async_commit();  // empty past the last tile: the wait count stays exact
  };
  auto y_out = [&](int k) {
    const int t0 = k * kSteps;
    write_y<C>(y + (row0 + t0) * di + d0, s_yt[k & 1], di, min(kSteps, S - t0), nc, w.y);
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) stage(k);

  // A in base 2: exp(dt * A) = exp2(dt * A * log2(e)).  A masked channel
  // (d >= di) keeps A = 0 and is staged dt = 0, x = 0, so its state stays 0.
  float a2[kPer], h[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    a2[j] = d < di ? -expf(a_log[(size_t)d * N + lane * kPer + j]) * kLog2e : 0.0f;
    h[j] = 0.0f;
  }

  for (int k = 0; k < n_tiles; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile k have landed
    // Every thread's copies of tile k are visible; every thread is done with
    // tile k-1, so its ring slot takes tile k + kStages - 1, and its y tile is
    // whole.
    __syncthreads();
    stage(k + kStages - 1);
    if (k > 0) y_out(k - 1);

    const unsigned char* st = smem + (k % kStages) * L::kStage;
    const float* s_dt = reinterpret_cast<const float*>(st) + c;
    const T* s_x = reinterpret_cast<const T*>(st + L::kDt) + c;
    const T* s_b = reinterpret_cast<const T*>(st + L::kDt + L::kX) + lane * kPer;
    const T* s_c = s_b + kSteps * N;
    float* s_y = s_yt[k & 1] + c;
#pragma unroll 1
    for (int g0 = 0; g0 < kSteps; g0 += kGroup) {  // steps past S are zero-filled: h unchanged
      float v[kGroup];                              // this lane's share of y, step by step
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int tt = g0 + g;
        const float dv = s_dt[tt * C];
        const float dx = dv * to_f32(s_x[tt * C]);
        float bv[kPer], cv[kPer];
        load_f32<kPer>(s_b + tt * N, bv);
        load_f32<kPer>(s_c + tt * N, cv);
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          h[j] = fmaf(ex2_approx(dv * a2[j]), h[j], dx * bv[j]);
          acc = fmaf(h[j], cv[j], acc);
        }
        v[g] = acc;
      }
      reduce_scatter<kGroup>(v, lane);
#pragma unroll
      for (int i = 0; i < kGroup / kLanes; ++i)
        s_y[(g0 + lane * (kGroup / kLanes) + i) * C] = v[i];
    }
  }
  __syncthreads();
  if (n_tiles > 0) y_out(n_tiles - 1);

  if (d < di) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) h_last[((size_t)b * di + d) * N + lane * kPer + j] = h[j];
  }
}

// The widths are the wrapper's choice (kernels/mamba_scan.py::_scan_plan).
// A copy wider than the pointer's or the row stride's alignment would fault,
// so a width must divide both; a width below 4 bytes is bf16's plain loads.
bool width_ok(const void* p, long long stride_bytes, int w, int item) {
  const bool known = w == 16 || w == 8 || w == 4 || (w == 2 && item == 2);
  return known && ((unsigned long long)(uintptr_t)p | (unsigned long long)stride_bytes) % w == 0;
}

template <typename T, int N>
int run(const float* dt, const T* bmat, const T* cmat, const T* x, const float* a_log, float* y,
        float* h_last, int B, int S, int di, Widths w, cudaStream_t s) {
  auto kernel = mamba_scan_kernel<T, N>;
  using L = Layout<T, N>;
  // The default cap on dynamic shared memory is 48 KB less the static y
  // tiles: raise it, once per instantiation and device.
  static unsigned long long done = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(done >> dev & 1ULL)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kRing);
    if (err != cudaSuccess) return (int)err;
    done |= 1ULL << dev;
  }
  const dim3 grid((unsigned)((di + L::kChannels - 1) / L::kChannels), (unsigned)B);
  kernel<<<grid, kThreads, L::kRing, s>>>(dt, bmat, cmat, x, a_log, y, h_last, S, di, w);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* dt, const void* bmat, const void* cmat, const void* x, const void* a_log,
           void* y, void* h_last, int B, int S, int di, int N, Widths w, void* stream) {
  if (B == 0 || di == 0) return 0;
  const int item = (int)sizeof(T);
  if (!width_ok(dt, 4LL * di, w.dt, 4) || !width_ok(x, (long long)item * di, w.x, item) ||
      !width_ok(bmat, (long long)item * S * N, w.b, item) ||
      !width_ok(cmat, (long long)item * S * N, w.c, item) || !width_ok(y, 4LL * di, w.y, 4))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* dtp = static_cast<const float*>(dt);
  const auto* bp = static_cast<const T*>(bmat);
  const auto* cp = static_cast<const T*>(cmat);
  const auto* xp = static_cast<const T*>(x);
  const auto* ap = static_cast<const float*>(a_log);
  auto* yp = static_cast<float*>(y);
  auto* hp = static_cast<float*>(h_last);
  switch (N) {
    case 4: return run<T, 4>(dtp, bp, cp, xp, ap, yp, hp, B, S, di, w, s);
    case 8: return run<T, 8>(dtp, bp, cp, xp, ap, yp, hp, B, S, di, w, s);
    case 16: return run<T, 16>(dtp, bp, cp, xp, ap, yp, hp, B, S, di, w, s);
    case 32: return run<T, 32>(dtp, bp, cp, xp, ap, yp, hp, B, S, di, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes.  w_dt .. w_y are the copy widths
// in bytes of dt, x, B and C into the tile ring and of y out of the y tile
// (16, 8 or 4; 2 for plain loads of a bf16 row), as _scan_plan chooses them;
// a width that does not divide its pointer and row stride is refused.  They
// launch on `stream` and return cudaGetLastError() after the launch (0 on
// success); they never synchronise and allocate nothing.
extern "C" int mamba_scan_bf16(const void* dt, const void* bmat, const void* cmat, const void* x,
                               const void* a_log, void* y, void* h_last, int B, int S, int di,
                               int N, int w_dt, int w_x, int w_b, int w_c, int w_y,
                               void* stream) {
  return launch<__nv_bfloat16>(dt, bmat, cmat, x, a_log, y, h_last, B, S, di, N,
                               Widths{w_dt, w_x, w_b, w_c, w_y}, stream);
}

extern "C" int mamba_scan_f32(const void* dt, const void* bmat, const void* cmat, const void* x,
                              const void* a_log, void* y, void* h_last, int B, int S, int di,
                              int N, int w_dt, int w_x, int w_b, int w_c, int w_y,
                              void* stream) {
  return launch<float>(dt, bmat, cmat, x, a_log, y, h_last, B, S, di, N,
                       Widths{w_dt, w_x, w_b, w_c, w_y}, stream);
}
