// One-token GQA decode attention for Hopper (sm_90a): the device body shared
// by the paged kernel (paged_decode_attention.cu) and the dense kernel
// (decode_attention.cu).  The two differ only in where token j's K/V row
// lies, which each passes in as a `Rows` functor.
//
// What the body computes, for one (lane b, KV head h): scores q.k^T / sqrt(hd)
// in f32 for the lane's first `vlen` tokens, an online softmax (running max m,
// denominator l, accumulator acc, all f32), and out = acc / max(l, 1e-30) cast
// to the input type -- what the Pallas kernels of
// src/repro/kernels/decode_attention.py compute.
//
// Design: a split over the sequence (flash-decoding) in one launch.  The grid
// is (B * KV, n_split); split s of (b, h) walks tokens [s * L, min((s + 1) * L,
// vlen)) with 8 warps, so B * KV * n_split blocks fill the card even where B *
// KV is small (the wrapper picks L and n_split from the shapes alone).
//   - Loads: a lane reads 16 bytes of a K or V row at a time (8 bf16 or 4
//     f32); LPR = min(32, hd * itemsize / 16) neighbouring lanes cover a row,
//     so one warp load covers 32 / LPR tokens, and a row's dot product is
//     reduced over LPR lanes in log2(LPR) shuffles.
//   - Softmax: a warp takes a tile of kLoads loads (4 to 16 tokens), computes
//     all its scores, takes the tile's max, rescales (m, l, acc) once, then
//     accumulates p * v: one exp per token and one per tile.
//   - Merge: the 8 warps' (m, l, acc) are merged through shared memory.  With
//     n_split = 1 the block writes out.  Otherwise it writes its partial (m,
//     l, acc[G][hd], f32) to the workspace, fences, and adds one to the
//     (b, h) counter; the block that brings it to n_split merges every
//     partial (log-sum-exp, skipping m = -inf: splits that saw no token),
//     writes out and sets the counter back to 0.  A split that starts at or
//     past vlen writes m = -inf and counts like any other.
//
// Contract: vlen >= 1.  Where no token is seen the output is 0, where the
// Pallas kernels average over a masked tile -- callers never pass vlen = 0.
// The counters start at 0 and are left at 0; a counter buffer belongs to one
// stream (two launches in flight at once on one buffer would share counts).
//
// What this design leaves on the table: loads go through registers, with no
// cp.async / TMA ring to keep more bytes in flight; the G x hd by hd x tokens
// products run on CUDA cores, not mma / wgmma; each lane of a row repeats
// the row's exp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace repro_decode {

constexpr int kWarps = 8;
constexpr int kLoads = 4;       // 16-byte row loads a lane issues per tile
constexpr int kMaxSplits = 64;  // the wrapper's cap on n_split

// (G, hd / 32) pairs built: G = 1..8 at hd 64 and 128, G = 1..4 at hd 256,
// i.e. G * hd <= 1024, which keeps the static shared memory (s_q and the 8
// warps' s_acc, 36 KB at the most) under 48 KB.  The Python wrapper's
// _SUPPORTED set is this list.
#define REPRO_DECODE_SHAPES(X)                                                       \
  X(1, 2) X(2, 2) X(3, 2) X(4, 2) X(5, 2) X(6, 2) X(7, 2) X(8, 2)                    \
  X(1, 4) X(2, 4) X(3, 4) X(4, 4) X(5, 4) X(6, 4) X(7, 4) X(8, 4)                    \
  X(1, 8) X(2, 8) X(3, 8) X(4, 8)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A 16-byte vector of T: its element count and its widening to f32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static __forceinline__ void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // a bf16 is the high half of an f32: the lower address is the low 16 bits
  __device__ static __forceinline__ void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// One split's work.  q and out point at this (b, h)'s G x HD rows; rows(j) is
// the element offset of token j's K (and V) row for this (b, h).  ws holds
// the partials of all B * KV * n_split blocks (m and l, then acc) and counter
// the B * KV counts; neither is read when n_split = 1.
template <typename T, int G, int HD, typename Rows>
__device__ __forceinline__ void decode_split(const T* __restrict__ q, const T* __restrict__ k,
                                             const T* __restrict__ v, T* __restrict__ out,
                                             float* __restrict__ ws, int* __restrict__ counter,
                                             int vlen, int split_len, const Rows& rows,
                                             float scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPR = HD / VEC < 32 ? HD / VEC : 32;  // lanes per row
  constexpr int RPW = 32 / LPR;                       // rows (tokens) per warp load
  constexpr int CH = HD / (LPR * VEC);                // 16-byte chunks a lane holds per row
  constexpr int E = CH * VEC;                         // elements a lane holds per row
  constexpr int TILE = kLoads * RPW;                  // tokens per warp tile
  __shared__ float s_q[G][HD];
  __shared__ float s_m[kWarps][G];
  __shared__ float s_l[kWarps][G];
  __shared__ float s_acc[kWarps][G][HD];
  __shared__ bool s_last;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane % LPR;  // chunk c of a row is elements [(c * LPR + r) * VEC, + VEC)
  const int t = lane / LPR;  // which token of a warp load
  const int bh = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int end = min((split + 1) * split_len, vlen);

  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) s_q[i / HD][i % HD] = to_f32(q[i]);
  __syncthreads();

  float qr[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int i = 0; i < VEC; ++i) qr[g][c * VEC + i] = s_q[g][(c * LPR + r) * VEC + i];

  // m is the same on every lane of the warp; lane (t, r) keeps l and acc over
  // the tokens it was given, summed across t after the loop
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int base = split * split_len + warp * TILE; base < end; base += kWarps * TILE) {
    uint4 kr[kLoads][CH], vr[kLoads][CH];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      // a token past the end loads the last valid row and is masked below
      const size_t row = rows(min(base + u * RPW + t, end - 1));
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const size_t off = row + (size_t)(c * LPR + r) * VEC;
        kr[u][c] = __ldg(reinterpret_cast<const uint4*>(k + off));
        vr[u][c] = __ldg(reinterpret_cast<const uint4*>(v + off));
      }
    }
    float s[kLoads][G];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      float kf[E];
#pragma unroll
      for (int c = 0; c < CH; ++c) Vec<T>::unpack(kr[u][c], kf + c * VEC);
      const bool valid = base + u * RPW + t < end;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[g][e], kf[e], d);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        s[u][g] = valid ? d * scale : -INFINITY;
      }
    }
    // the tile's max; its first token (base) is valid, so m_new is finite
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int u = 1; u < kLoads; ++u) mx = fmaxf(mx, s[u][g]);
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float corr = expf(m[g] - m_new);  // 0 on the warp's first tile
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= corr;
      m[g] = m_new;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      float vf[E];
#pragma unroll
      for (int c = 0; c < CH; ++c) Vec<T>::unpack(vr[u][c], vf + c * VEC);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = expf(s[u][g] - m[g]);  // 0 for a masked token
        l[g] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }

  // sum l and acc over the warp's token slots, then merge the warps
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          s_acc[warp][g][(c * LPR + r) * VEC + i] = acc[g][c * VEC + i];
    }
  }
  __syncthreads();

  const size_t n_part = (size_t)gridDim.x * n_split;  // partials: (B * KV, n_split, G)
  float* ws_m = ws;
  float* ws_l = ws + n_part * G;
  float* ws_acc = ws + 2 * n_part * G;
  const size_t part = (size_t)bh * n_split + split;
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (s_m[w][g] == -INFINITY) continue;  // warp saw no token
      const float c = expf(s_m[w][g] - mx);
      den += s_l[w][g] * c;
      num += s_acc[w][g][i % HD] * c;
    }
    if (n_split == 1) {
      out[i] = from_f32<T>(num / fmaxf(den, 1e-30f));
    } else {
      ws_acc[part * G * HD + i] = num;
      if (i % HD == 0) {
        ws_m[part * G + g] = mx;
        ws_l[part * G + g] = den;
      }
    }
  }
  if (n_split == 1) return;

  // the last of the (b, h)'s splits to finish merges them all
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(counter + bh, 1) == n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const size_t first = (size_t)bh * n_split;
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD;
    float mx = -INFINITY;
    for (int sp = 0; sp < n_split; ++sp) mx = fmaxf(mx, __ldcg(ws_m + (first + sp) * G + g));
    float den = 0.f, num = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const float ms = __ldcg(ws_m + (first + sp) * G + g);
      if (ms == -INFINITY) continue;  // split saw no token
      const float c = expf(ms - mx);
      den += __ldcg(ws_l + (first + sp) * G + g) * c;
      num += __ldcg(ws_acc + (first + sp) * G * HD + i) * c;
    }
    out[i] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
  if (threadIdx.x == 0) counter[bh] = 0;
}

}  // namespace repro_decode
