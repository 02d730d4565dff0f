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
// bound it.  This design recomputes the forward twice (below), so it runs
// three exponentials per (t, d, n), and it moves its scratch (hs written and
// read, 67 MB; the dB, dC partials written and read, 134 MB) on top of the
// bytes above.
//
// Design.  The states h_t are never stored whole (B S di N floats, 1.07 GB a
// layer at the shape above).  The forward's mapping is kept: 4 threads a
// channel, N / 4 states each in registers, 32 channels a block of 128
// threads, blocks over (channel tile, b), each looping over the sequence.
// The sequence is cut into tiles of kTile = min(32, 512 / N) steps.
//
// 1. A cp.async tile ring in dynamic shared memory, as the forward's: kStages
//    slots, each one tile's dt, x, B_t, C_t and g_y for the block's 32
//    channels in their input dtypes.  Tiles k+1 .. k+kStages-1 (pass 1) or
//    k-1 .. k-kStages+1 (pass 2, walking in reverse) are in flight while tile
//    k is worked on.  The ragged last tile in time and the masked channels
//    are zero-filled through cp.async's src-size operand: a zero step (dt =
//    x = g_y = 0, B = C = 0) has a = 1 and u = 0, so it leaves h, lambda,
//    dA_log and every written gradient as they were, and the loops run whole
//    tiles with no branch.  The copy widths are the wrapper's
//    (kernels/mamba_scan.py::_scan_bwd_plan), refused unless each divides its
//    pointer and row stride.
// 2. scan_bwd_states walks the ring forwards and stores the state entering
//    each tile into a scratch hs (B, n_tiles, di, N) f32 (33.5 MB at the
//    shape above).
// 3. scan_bwd_kernel walks the tiles in reverse.  Each thread recomputes the
//    tile's states from hs into shared memory (the state before each step,
//    kTile x 128 threads x N / 4 floats, 64 KB at N 16; each thread reads
//    back only what it wrote), then runs the adjoint backwards with lambda in
//    registers; both read the one staged copy of the tile, so pass 2 reads
//    its inputs once.  The recomputation is the forward's exact arithmetic
//    (ex2.approx.ftz of dt * A * log2(e), then fmaf(a, h, u * B)), so the
//    states are the forward kernel's; h_t of the adjoint is the state the
//    step before it read back.  The entry state of the next tile is loaded
//    from hs into registers a tile ahead.
// 4. Sums, in a fixed order (no float atomics: two runs on the same inputs
//    are bit-equal).  dx and d_dt: each lane's share of kGroup steps is
//    reduced over the channel's 4 lanes together (two shuffle rounds that
//    leave each lane whole sums of 2 steps) and written over the step's dt
//    and x in the ring slot, which goes out with wide stores once the tile is
//    done.  dB_t and dC_t: the 2N products of a step are summed over the 8
//    channels of a warp by three shuffle rounds that halve the values a
//    thread holds, and each warp's 2N sums go over the states of that step
//    in its own part of the state buffer (its lanes have read them: a
//    __syncwarp).  After the next barrier the block sums its 4 warps and
//    writes one partial per (b, channel tile, t, n) into pb / pc (B, di /
//    32, S, N) f32; scan_bwd_reduce sums them over the channel tiles.
//    dA_log's sum over t stays in registers, its sum over b goes through pa
//    (B, di, N).
//
// Budget (dynamic shared memory of pass 2, at N 16): states 64 KB + 3 ring
// slots of 12 KB (bf16) or 16 KB (f32) = 100 or 112 KB, so two blocks an SM
// stay resident (228 KB an SM, 1 KB reserved a block), and all 256 blocks of
// the main shape are in flight at once; pass 1 takes 21 or 30 KB.  A
// separate 32 KB buffer of dB, dC products, as the first version kept, would
// have left one.  At N 32 the tile is 16 steps, so the states stay 64 KB; at
// N 4 and 8 they take 16 and 32 KB.  Measured at the main shape (H100 80GB
// HBM3, 700 W; tools/decode_timers.py): 2 ring slots ran as fast as 3 in bf16
// (1.5% faster all-f32), and 16-step tiles (32 KB of states, twice the tiles
// and barriers) 18% slower.
//
// What bounds it now: 0.66 ms in bf16 at the shape above, 12% of the bound:
// scan_bwd_states 0.10, scan_bwd_kernel 0.50 and scan_bwd_reduce 0.06 ms
// (torch.profiler).  In pass 2, taking out the tile recompute saves 0.087
// ms, the dB, dC shuffle sums 0.070 ms and the adjoint's exponential (an FMA
// in its place) only 0.016 ms: the special-function units are not the
// limit.  At 8 warps an SM, 2 a scheduler, the adjoint's ~100 instructions a
// step and thread (an estimate from the source, not a profile) come close to
// one instruction a clock per scheduler, so fewer instructions a step, not
// fewer bytes, is the next lever.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                 // threads per block
constexpr int kLanes = 4;                     // threads per channel
constexpr int kChannels = kThreads / kLanes;  // channels per block
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;                    // tiles in the ring
constexpr int kGroup = 8;                     // steps whose dx, d_dt sums are reduced together
constexpr float kLog2e = 1.4426950408889634f;

// Copy widths in bytes, per operand, chosen by the wrapper.  A width equal to
// the element size means plain loads or stores (bf16 rows not 4-byte aligned).
struct Widths {
  int dt, x, b, c, gy, ddt, dx;
};

template <typename T, int N>
struct Bwd {
  static constexpr int kPer = N / kLanes;                        // states per thread
  static constexpr int kTile = N <= 16 ? 32 : 512 / N;           // steps per tile
  static constexpr int kH = kTile * kThreads * kPer;             // floats of the tile's states
  // one ring slot: dt, x, B_t, C_t, g_y of a tile; pass 1 uses the first three
  static constexpr int kDt = kTile * kChannels * 4;
  static constexpr int kX = kTile * kChannels * (int)sizeof(T);
  static constexpr int kBC = kTile * N * (int)sizeof(T);
  static constexpr int kStage = kDt + kX + 2 * kBC + kTile * kChannels * 4;
  static constexpr int kStage1 = kDt + kX + kBC;
  static constexpr int kSmem1 = kStages * kStage1;               // pass 1, bytes
  static constexpr int kSmem = kH * 4 + kStages * kStage;        // pass 2, bytes
  static_assert(N % kLanes == 0 && kTile % kGroup == 0, "whole states, whole groups");
  static_assert(2 * N <= 32 * kPer, "a warp's dB, dC sums of a step fit its states of it");
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

// Stage rows [0, R) x columns [0, kChannels) of a (rows, ld) matrix of E
// whose tile starts at g into s (R x kChannels, dense).  Rows >= nt and
// columns >= nc are zero-filled.  W bytes per copy; W == sizeof(E) < 4 means
// plain loads.
template <typename E, int R, int W>
__device__ __forceinline__ void stage_cols_w(E* s, const E* g, size_t ld, int nt, int nc) {
  constexpr int kPer = W / (int)sizeof(E);
  constexpr int kRow = kChannels / kPer;        // copies per row
  constexpr int kCopies = R * kRow;
#pragma unroll
  for (int i = 0; i < (kCopies + kThreads - 1) / kThreads; ++i) {
    const int e = i * kThreads + threadIdx.x;
    if (kCopies % kThreads != 0 && e >= kCopies) break;
    const int tt = e / kRow, cc = (e % kRow) * kPer;
    const int valid = tt < nt ? max(0, min(kPer, nc - cc)) : 0;
    const E* src = valid ? g + tt * ld + cc : g;
    if constexpr (W >= 4) {
      cp_async<W>(s + tt * kChannels + cc, src, valid * (int)sizeof(E));
    } else {
      s[tt * kChannels + cc] = valid ? *src : E(0.0f);
    }
  }
}

template <typename E, int R>
__device__ __forceinline__ void stage_cols(E* s, const E* g, size_t ld, int nt, int nc, int w) {
  if (w == 16) stage_cols_w<E, R, 16>(s, g, ld, nt, nc);
  else if (w == 8) stage_cols_w<E, R, 8>(s, g, ld, nt, nc);
  else if (w == 4) stage_cols_w<E, R, 4>(s, g, ld, nt, nc);
  else if constexpr (sizeof(E) == 2) stage_cols_w<E, R, 2>(s, g, ld, nt, nc);
}

// Stage the contiguous run g[0, L) (B_t or C_t of one tile) into s; elements
// >= n_valid are zero-filled.
template <typename E, int L, int W>
__device__ __forceinline__ void stage_flat_w(E* s, const E* g, int n_valid) {
  constexpr int kPer = W / (int)sizeof(E);
  constexpr int kCopies = L / kPer;
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

template <typename E, int L>
__device__ __forceinline__ void stage_flat(E* s, const E* g, int n_valid, int w) {
  if (w == 16) stage_flat_w<E, L, 16>(s, g, n_valid);
  else if (w == 8) stage_flat_w<E, L, 8>(s, g, n_valid);
  else if (w == 4) stage_flat_w<E, L, 4>(s, g, n_valid);
  else if constexpr (sizeof(E) == 2) stage_flat_w<E, L, 2>(s, g, n_valid);
}

// Rows [0, nt) x columns [0, nc) of the tile s (R x kChannels) of E to g
// (row stride ld), W bytes per store.  W divides the row stride, so nc is a
// multiple of W / sizeof(E) and a store never crosses the end of a row.
template <typename E, int R, int W>
__device__ __forceinline__ void write_cols_w(E* g, const E* s, size_t ld, int nt, int nc) {
  constexpr int kPer = W / (int)sizeof(E);
  constexpr int kRow = kChannels / kPer;
  constexpr int kCopies = R * kRow;
#pragma unroll
  for (int i = 0; i < (kCopies + kThreads - 1) / kThreads; ++i) {
    const int e = i * kThreads + threadIdx.x;
    if (kCopies % kThreads != 0 && e >= kCopies) break;
    const int tt = e / kRow, cc = (e % kRow) * kPer;
    if (tt < nt && cc < nc) {
      if constexpr (W == 16) {
        *reinterpret_cast<uint4*>(g + tt * ld + cc) =
            *reinterpret_cast<const uint4*>(s + tt * kChannels + cc);
      } else if constexpr (W == 8) {
        *reinterpret_cast<uint2*>(g + tt * ld + cc) =
            *reinterpret_cast<const uint2*>(s + tt * kChannels + cc);
      } else if constexpr (W == 4) {
        *reinterpret_cast<uint32_t*>(g + tt * ld + cc) =
            *reinterpret_cast<const uint32_t*>(s + tt * kChannels + cc);
      } else {
        g[tt * ld + cc] = s[tt * kChannels + cc];
      }
    }
  }
}

template <typename E, int R>
__device__ __forceinline__ void write_cols(E* g, const E* s, size_t ld, int nt, int nc, int w) {
  if (w == 16) write_cols_w<E, R, 16>(g, s, ld, nt, nc);
  else if (w == 8) write_cols_w<E, R, 8>(g, s, ld, nt, nc);
  else if (w == 4) write_cols_w<E, R, 4>(g, s, ld, nt, nc);
  else if constexpr (sizeof(E) == 2) write_cols_w<E, R, 2>(g, s, ld, nt, nc);
}

// kPer floats at p (aligned to kPer floats; shared or global) to or from v.
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

__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float* out) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}

// kPer consecutive elements of shared memory, as f32 (the offset is a
// multiple of kPer elements).
template <int kPer>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  get<kPer>(p, out);
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

// Sum v[g] over the kLanes lanes of a channel for each of the G steps g,
// leaving lane l the sums of steps l * G / kLanes + i in v[i], i < G / kLanes
// (log2(kLanes) rounds; each halves the values a lane holds).
template <int G>
__device__ __forceinline__ void lane_sum(float (&v)[G], int lane) {
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

// Sum each of the V values of a thread over the 8 channels of its warp (the
// lane-index bits 4, 8 and 16).  A round halves the values a thread holds
// while it holds more than one, else adds its partner's.  Thread wl (its
// channel in the warp cw = wl / kLanes) is left the whole sums of values
// cw * V / 8 + i, i < max(1, V / 8); with V < 8, 8 / V threads hold each.
template <int V>
__device__ __forceinline__ void channel_sum(float (&v)[V], int wl) {
  int held = V;
#pragma unroll
  for (int o = 16; o >= kLanes; o /= 2) {
    if (held > 1) {
      const int half = held / 2;
      const bool upper = (wl & o) != 0;
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        if (i < half) {
          const float send = upper ? v[i] : v[i + half];
          const float keep = upper ? v[i + half] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      held = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
}

// Pass 1: the forward recurrence over the ring, storing the state that
// enters each tile.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
scan_bwd_states(const float* __restrict__ dt, const T* __restrict__ bmat,
                const T* __restrict__ x, const float* __restrict__ a_log,
                float* __restrict__ hs, int S, int di, Widths w) {
  using K = Bwd<T, N>;
  constexpr int kPer = K::kPer, kTile = K::kTile, C = kChannels;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * C, nc = min(C, di - d0);
  const int c = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int d = d0 + c;
  const int n0 = lane * kPer;
  const int n_tiles = (S + kTile - 1) / kTile;
  const size_t row0 = (size_t)b * S;

  auto stage = [&](int k) {
    if (k < n_tiles) {
      unsigned char* st = smem + (k % kStages) * K::kStage1;
      const int t0 = k * kTile, nt = min(kTile, S - t0);
      const size_t off = (row0 + t0) * di + d0;
      stage_cols<float, kTile>(reinterpret_cast<float*>(st), dt + off, di, nt, nc, w.dt);
      stage_cols<T, kTile>(reinterpret_cast<T*>(st + K::kDt), x + off, di, nt, nc, w.x);
      stage_flat<T, kTile * N>(reinterpret_cast<T*>(st + K::kDt + K::kX),
                               bmat + (row0 + t0) * N, nt * N, w.b);
    }
    cp_async_commit();  // empty past the last tile: the wait count stays exact
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) stage(k);

  float a2[kPer], h[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    a2[j] = d < di ? -expf(a_log[(size_t)d * N + n0 + j]) * kLog2e : 0.0f;
    h[j] = 0.0f;
  }
  for (int k = 0; k < n_tiles; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile k have landed
    __syncthreads();               // everyone's have; tile k-1's slot is free
    stage(k + kStages - 1);
    if (d < di) put<kPer>(hs + (((size_t)b * n_tiles + k) * di + d) * N + n0, h);
    const unsigned char* st = smem + (k % kStages) * K::kStage1;
    const float* s_dt = reinterpret_cast<const float*>(st) + c;
    const T* s_x = reinterpret_cast<const T*>(st + K::kDt) + c;
    const T* s_b = reinterpret_cast<const T*>(st + K::kDt + K::kX) + n0;
#pragma unroll 1
    for (int g0 = 0; g0 < kTile; g0 += kGroup) {  // steps past S are zero: h unchanged
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int tt = g0 + g;
        const float dv = s_dt[tt * C];
        const float u = dv * to_f32(s_x[tt * C]);
        float bv[kPer];
        load_f32<kPer>(s_b + tt * N, bv);
#pragma unroll
        for (int j = 0; j < kPer; ++j) h[j] = fmaf(ex2_approx(dv * a2[j]), h[j], u * bv[j]);
      }
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
                float* __restrict__ pc, float* __restrict__ pa, int S, int di, Widths w) {
  using K = Bwd<T, N>;
  constexpr int kPer = K::kPer, kTile = K::kTile, C = kChannels;
  constexpr int kRowH = kThreads * kPer;        // floats of one step's states
  constexpr int kKept = 2 * kPer >= 8 ? 2 * kPer / 8 : 1;  // dB, dC sums a thread keeps
  extern __shared__ __align__(16) unsigned char smem[];
  // [kTile][kThreads][kPer]: the state before each step of the tile; after
  // the adjoint, warp v's 2N dB, dC sums of step tt at s_h + tt * kRowH + v * 32 * kPer
  float* s_h = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + K::kH * 4;

  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int d0 = blk * C, nc = min(C, di - d0);
  const int c = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int wl = threadIdx.x % 32, cw = wl / kLanes, warp = threadIdx.x / 32;
  const int d = d0 + c;
  const bool live = d < di;
  const int n0 = lane * kPer;
  const int n_tiles = (S + kTile - 1) / kTile;
  const size_t row0 = (size_t)b * S;
  float* my_h = s_h + threadIdx.x * kPer;

  auto slot = [&](int k) { return ring + (k % kStages) * K::kStage; };
  auto stage = [&](int k) {
    if (k >= 0) {
      unsigned char* st = slot(k);
      const int t0 = k * kTile, nt = min(kTile, S - t0);
      const size_t off = (row0 + t0) * di + d0;
      stage_cols<float, kTile>(reinterpret_cast<float*>(st), dt + off, di, nt, nc, w.dt);
      stage_cols<T, kTile>(reinterpret_cast<T*>(st + K::kDt), x + off, di, nt, nc, w.x);
      stage_flat<T, kTile * N>(reinterpret_cast<T*>(st + K::kDt + K::kX),
                               bmat + (row0 + t0) * N, nt * N, w.b);
      stage_flat<T, kTile * N>(reinterpret_cast<T*>(st + K::kDt + K::kX + K::kBC),
                               cmat + (row0 + t0) * N, nt * N, w.c);
      // no g_y: zero-filled, reading nothing (from dt's tile, a valid address)
      stage_cols<float, kTile>(reinterpret_cast<float*>(st + K::kDt + K::kX + 2 * K::kBC),
                               g_y ? g_y + off : dt + off, di, g_y ? nt : 0, nc, w.gy);
    }
    cp_async_commit();  // empty before the first tile: the wait count stays exact
  };
  // Tile k's outputs, once every thread is done with it: d_dt and d_x from
  // its ring slot, the dB, dC partials (its 4 warps' sums, in order) from s_h.
  auto out = [&](int k) {
    unsigned char* st = slot(k);
    const int t0 = k * kTile, nt = min(kTile, S - t0);
    const size_t off = (row0 + t0) * di + d0;
    write_cols<float, kTile>(d_dt + off, reinterpret_cast<const float*>(st), di, nt, nc, w.ddt);
    write_cols<T, kTile>(d_x + off, reinterpret_cast<const T*>(st + K::kDt), di, nt, nc, w.dx);
    const size_t part = (((size_t)b * nblk + blk) * S + t0) * N;
    for (int e = threadIdx.x; e < 2 * kTile * N; e += kThreads) {
      const int which = e / (kTile * N), tt = e / N % kTile, n = e % N;
      if (tt < nt) {
        const float* p = s_h + tt * kRowH + which * N + n;
        float s = p[0];
#pragma unroll
        for (int v = 1; v < kWarps; ++v) s += p[v * 32 * kPer];
        (which ? pc : pb)[part + tt * N + n] = s;
      }
    }
  };

  // A (and A log2(e) for the exponential); a masked channel has A = 0, is
  // staged dt = x = g_y = 0 and keeps lambda = 0, so its products are 0.
  float A[kPer], a2[kPer], carry[kPer], acc[kPer], h_in[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    A[j] = live ? -expf(a_log[(size_t)d * N + n0 + j]) : 0.0f;
    a2[j] = A[j] * kLog2e;
    carry[j] = live && g_h ? g_h[((size_t)b * di + d) * N + n0 + j] : 0.0f;
    acc[j] = 0.0f;
  }
  // the state entering tile k, loaded a tile ahead
  auto load_h = [&](int k) {
    if (live && k >= 0) {
      get<kPer>(hs + (((size_t)b * n_tiles + k) * di + d) * N + n0, h_in);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) h_in[j] = 0.0f;
    }
  };

#pragma unroll
  for (int i = 1; i < kStages; ++i) stage(n_tiles - i);
  load_h(n_tiles - 1);

  for (int k = n_tiles - 1; k >= 0; --k) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile k have landed
    // Every thread's copies of tile k are visible, and every thread is done
    // with tile k+1: its slot holds its d_dt and d_x, s_h its dB, dC sums.
    __syncthreads();
    if (k + 1 < n_tiles) out(k + 1);
    __syncthreads();                // tile k+1's slot and s_h are read out
    stage(k - (kStages - 1));       // into tile k+1's slot
    unsigned char* st = slot(k);
    float* s_dt = reinterpret_cast<float*>(st) + c;
    T* s_x = reinterpret_cast<T*>(st + K::kDt) + c;
    const T* s_b = reinterpret_cast<const T*>(st + K::kDt + K::kX) + n0;
    const T* s_c = s_b + kTile * N;
    const float* s_gy = reinterpret_cast<const float*>(st + K::kDt + K::kX + 2 * K::kBC) + c;

    float h[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) h[j] = h_in[j];
    load_h(k - 1);
#pragma unroll 1
    for (int g0 = 0; g0 < kTile; g0 += kGroup) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int tt = g0 + g;
        const float dv = s_dt[tt * C];
        const float u = dv * to_f32(s_x[tt * C]);
        float bv[kPer];
        load_f32<kPer>(s_b + tt * N, bv);
        put<kPer>(my_h + tt * kRowH, h);
#pragma unroll
        for (int j = 0; j < kPer; ++j) h[j] = fmaf(ex2_approx(dv * a2[j]), h[j], u * bv[j]);
      }
    }

    // h is now the state after the tile's last step; each step's state
    // after is the one the step after it read back (hn).
#pragma unroll 1
    for (int g0 = kTile - kGroup; g0 >= 0; g0 -= kGroup) {
      float v_dt[kGroup], v_dx[kGroup], v_bc[kGroup][kKept];
#pragma unroll
      for (int g = kGroup - 1; g >= 0; --g) {
        const int tt = g0 + g;
        const float dv = s_dt[tt * C];
        const float xv = to_f32(s_x[tt * C]);
        const float gy = s_gy[tt * C];
        const float u = dv * xv;
        float hp[kPer], bv[kPer], cv[kPer], v[2 * kPer];
        get<kPer>(my_h + tt * kRowH, hp);
        load_f32<kPer>(s_b + tt * N, bv);
        load_f32<kPer>(s_c + tt * N, cv);
        float du = 0.0f, dd = 0.0f;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const float a = ex2_approx(dv * a2[j]);
          const float lam = fmaf(gy, cv[j], carry[j]);
          v[kPer + j] = gy * h[j];                      // dC: h_t, as the forward computed it
          v[j] = lam * u;                               // dB
          du = fmaf(lam, bv[j], du);
          const float q = lam * a * hp[j];
          dd = fmaf(q, A[j], dd);
          acc[j] = fmaf(q, dv, acc[j]);
          carry[j] = a * lam;
          h[j] = hp[j];
        }
        v_dt[g] = fmaf(xv, du, dd);
        v_dx[g] = dv * du;
        channel_sum<2 * kPer>(v, wl);
#pragma unroll
        for (int i = 0; i < kKept; ++i) v_bc[g][i] = v[i];
      }
      lane_sum<kGroup>(v_dt, lane);
      lane_sum<kGroup>(v_dx, lane);
      __syncwarp();  // every lane of the warp has read the group's dt, x and states
#pragma unroll
      for (int i = 0; i < kGroup / kLanes; ++i) {
        const int tt = g0 + lane * (kGroup / kLanes) + i;
        s_dt[tt * C] = v_dt[i];
        s_x[tt * C] = from_f32<T>(v_dx[i]);
      }
      if ((cw * 2 * kPer) % 8 == 0) {                 // one thread of each sum
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
#pragma unroll
          for (int i = 0; i < kKept; ++i) {
            const int item = cw * 2 * kPer / 8 + i;   // dB (< kPer) or dC of state n0 + item % kPer
            s_h[(g0 + g) * kRowH + warp * 32 * kPer + item / kPer * N + n0 + item % kPer] =
                v_bc[g][i];
          }
        }
      }
    }
  }
  __syncthreads();
  if (n_tiles > 0) out(0);
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
  const size_t row = (size_t)S * N, n_bc = (size_t)B * row, n_a = (size_t)di * N;
  if (i < n_bc) {
    const size_t off = i / row * nblk * row + i % row;
    float sb = 0.0f, sc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < nblk; ++k) {
      sb += pb[off + k * row];
      sc += pc[off + k * row];
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

// The widths are the wrapper's choice (kernels/mamba_scan.py::_scan_bwd_plan).
// A copy wider than the pointer's or the row stride's alignment would fault,
// so a width must divide both; a width below 4 bytes is bf16's plain loads.
bool width_ok(const void* p, long long stride_bytes, int w, int item) {
  const bool known = w == 16 || w == 8 || w == 4 || (w == 2 && item == 2);
  return known && ((unsigned long long)(uintptr_t)p | (unsigned long long)stride_bytes) % w == 0;
}

// Dynamic shared memory above 48 KB: raise each pass's cap, once per
// instantiation and device.
template <typename T, int N>
int set_smem() {
  using K = Bwd<T, N>;
  static unsigned long long done = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(done >> dev & 1ULL)) {
    cudaError_t err = cudaFuncSetAttribute(scan_bwd_states<T, N>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(scan_bwd_kernel<T, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem);
    if (err != cudaSuccess) return (int)err;
    done |= 1ULL << dev;
  }
  return 0;
}

template <typename T, int N>
int run(const float* dt, const T* bmat, const T* cmat, const T* x, const float* a_log,
        const float* g_y, const float* g_h, float* d_dt, T* d_b, T* d_c, T* d_x,
        float* d_alog, float* scratch, int B, int S, int di, Widths w, cudaStream_t s) {
  using K = Bwd<T, N>;
  const int err0 = set_smem<T, N>();
  if (err0) return err0;
  const int nblk = (di + kChannels - 1) / kChannels;
  const int n_tiles = (S + K::kTile - 1) / K::kTile;
  // scratch: hs (B, n_tiles, di, N), pb and pc (B, nblk, S, N), pa (B, di, N), f32
  float* hs = scratch;
  float* pb = hs + (size_t)B * n_tiles * di * N;
  float* pc = pb + (size_t)B * nblk * S * N;
  float* pa = pc + (size_t)B * nblk * S * N;
  const dim3 grid((unsigned)nblk, (unsigned)B);
  if (B > 0) {
    if (S > 0) {
      scan_bwd_states<T, N><<<grid, kThreads, K::kSmem1, s>>>(dt, bmat, x, a_log, hs, S, di, w);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    scan_bwd_kernel<T, N><<<grid, kThreads, K::kSmem, s>>>(
        dt, bmat, cmat, x, a_log, g_y, g_h, hs, d_dt, d_x, pb, pc, pa, S, di, w);
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
           void* d_alog, void* scratch, int B, int S, int di, int N, Widths w, void* stream) {
  if (di == 0) return 0;
  const int item = (int)sizeof(T);
  const long long row = 4LL * di, row_t = (long long)item * di, row_bc = (long long)item * S * N;
  if (!width_ok(dt, row, w.dt, 4) || !width_ok(x, row_t, w.x, item) ||
      !width_ok(bmat, row_bc, w.b, item) || !width_ok(cmat, row_bc, w.c, item) ||
      (g_y && !width_ok(g_y, row, w.gy, 4)) || !width_ok(d_dt, row, w.ddt, 4) ||
      !width_ok(d_x, row_t, w.dx, item))
    return (int)cudaErrorMisalignedAddress;
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
    case 4: return run<T, 4>(dtp, bp, cp, xp, ap, gyp, ghp, ddt, db, dc, dx, da, sc, B, S, di, w, s);
    case 8: return run<T, 8>(dtp, bp, cp, xp, ap, gyp, ghp, ddt, db, dc, dx, da, sc, B, S, di, w, s);
    case 16: return run<T, 16>(dtp, bp, cp, xp, ap, gyp, ghp, ddt, db, dc, dx, da, sc, B, S, di, w, s);
    case 32: return run<T, 32>(dtp, bp, cp, xp, ap, gyp, ghp, ddt, db, dc, dx, da, sc, B, S, di, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Each pass's dynamic shared memory (bytes) and the blocks an SM it allows.
template <typename T, int N>
int occupancy(int* out) {
  using K = Bwd<T, N>;
  const int err = set_smem<T, N>();
  if (err) return err;
  out[0] = K::kSmem1, out[2] = K::kSmem;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], scan_bwd_states<T, N>, kThreads, K::kSmem1);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], scan_bwd_kernel<T, N>, kThreads,
                                                      K::kSmem);
  return (int)e;
}

template <typename T>
int occupancy_n(int N, int* out) {
  switch (N) {
    case 4: return occupancy<T, 4>(out);
    case 8: return occupancy<T, 8>(out);
    case 16: return occupancy<T, 16>(out);
    case 32: return occupancy<T, 32>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes.  g_y and g_h may be null (zero
// gradients).  scratch holds B * (ceil(S / kTile) * di * N + 2 * S *
// ceil(di / 32) * N + di * N) floats, kTile = min(32, 512 / N)
// (kernels/mamba_scan.py::bwd_scratch_bytes).  w_dt .. w_dx are the copy
// widths in bytes of dt, x, B, C and g_y into the tile ring and of d_dt and
// d_x out of it (16, 8 or 4; 2 for plain loads of a bf16 row), as
// _scan_bwd_plan chooses them; a width that does not divide its pointer and
// row stride is refused.  They launch on `stream` and return
// cudaGetLastError() after the launches (0 on success); they never
// synchronise and allocate nothing.
extern "C" int mamba_scan_bwd_bf16(const void* dt, const void* bmat, const void* cmat,
                                   const void* x, const void* a_log, const void* g_y,
                                   const void* g_h, void* d_dt, void* d_b, void* d_c, void* d_x,
                                   void* d_alog, void* scratch, int B, int S, int di, int N,
                                   int w_dt, int w_x, int w_b, int w_c, int w_gy, int w_ddt,
                                   int w_dx, void* stream) {
  return launch<__nv_bfloat16>(dt, bmat, cmat, x, a_log, g_y, g_h, d_dt, d_b, d_c, d_x, d_alog,
                               scratch, B, S, di, N,
                               Widths{w_dt, w_x, w_b, w_c, w_gy, w_ddt, w_dx}, stream);
}

extern "C" int mamba_scan_bwd_f32(const void* dt, const void* bmat, const void* cmat,
                                  const void* x, const void* a_log, const void* g_y,
                                  const void* g_h, void* d_dt, void* d_b, void* d_c, void* d_x,
                                  void* d_alog, void* scratch, int B, int S, int di, int N,
                                  int w_dt, int w_x, int w_b, int w_c, int w_gy, int w_ddt,
                                  int w_dx, void* stream) {
  return launch<float>(dt, bmat, cmat, x, a_log, g_y, g_h, d_dt, d_b, d_c, d_x, d_alog,
                       scratch, B, S, di, N, Widths{w_dt, w_x, w_b, w_c, w_gy, w_ddt, w_dx},
                       stream);
}

// For x in bf16 (f32 = 0) or f32 (f32 = 1) and state size N: out[0] and
// out[2] the dynamic shared memory in bytes of a block of scan_bwd_states and
// scan_bwd_kernel, out[1] and out[3] the blocks an SM of the current device
// that each allows (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns
// a cudaError_t (0 on success); launches nothing.
extern "C" int mamba_scan_bwd_occupancy(int f32, int N, int* out) {
  return f32 ? occupancy_n<float>(N, out) : occupancy_n<__nv_bfloat16>(N, out);
}
