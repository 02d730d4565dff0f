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
// Design (simple and right first): one thread block per (b, h), 8 warps.  The
// block loads its G query rows into shared memory in f32.  Warp w takes tokens
// [4w, 4w + 4), then [4w + 32, 4w + 36), ...; lane i of a warp holds elements
// i, i + 32, ... of each head vector, so every load of a K or V row is one
// coalesced 32-wide access.  Each warp keeps its own online softmax per query
// row; at the end the warps' (m, l, acc) are merged through shared memory.
//
// Contract: vlen >= 1.  A warp that sees no token keeps m = -inf and is left
// out of the merge; if no warp saw one the output would be 0, where the Pallas
// kernels average over a masked tile -- callers never pass vlen = 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace repro_decode {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;  // tokens a warp loads before it computes

// (G, elements per thread) pairs built, hd = 32 * EPT: G = 1..8 at hd 64 and
// 128, G = 1..4 at hd 256, i.e. G * hd <= 1024, which keeps the static shared
// memory (s_q and the 8 warps' s_acc, 36 KB at the most) under 48 KB.  The
// Python wrappers' _SUPPORTED sets are this list.
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The block's work.  q and out point at this (b, h)'s G x HD rows; rows(j)
// is the element offset of token j's K (and V) row for this (b, h).
template <typename T, int G, int EPT, typename Rows>
__device__ __forceinline__ void decode_block(const T* __restrict__ q, const T* __restrict__ k,
                                             const T* __restrict__ v, T* __restrict__ out,
                                             int vlen, const Rows& rows, float scale) {
  constexpr int HD = 32 * EPT;
  __shared__ float s_q[G][HD];
  __shared__ float s_m[kWarps][G];
  __shared__ float s_l[kWarps][G];
  __shared__ float s_acc[kWarps][G][HD];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) s_q[i / HD][i % HD] = to_f32(q[i]);
  __syncthreads();

  float qr[G][EPT];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPT; ++e) qr[g][e] = s_q[g][lane + 32 * e];

  float m[G], l[G], acc[G][EPT];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[g][e] = 0.f;
  }

  for (int base = warp * kUnroll; base < vlen; base += kWarps * kUnroll) {
    float kr[kUnroll][EPT], vr[kUnroll][EPT];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u;
      if (j < vlen) {
        const size_t row = rows(j);
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          kr[u][e] = to_f32(k[row + lane + 32 * e]);
          vr[u][e] = to_f32(v[row + lane + 32 * e]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u < vlen) {  // the same on every lane of the warp
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < EPT; ++e) d += qr[g][e] * kr[u][e];
          const float s = warp_sum(d) * scale;
          const float m_new = fmaxf(m[g], s);
          const float corr = expf(m[g] - m_new);
          const float p = expf(s - m_new);
          l[g] = l[g] * corr + p;
#pragma unroll
          for (int e = 0; e < EPT; ++e) acc[g][e] = acc[g][e] * corr + p * vr[u][e];
          m[g] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPT; ++e) s_acc[warp][g][lane + 32 * e] = acc[g][e];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD, d = i % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (s_m[w][g] == -INFINITY) continue;  // warp saw no token
      const float c = expf(s_m[w][g] - mx);
      den += s_l[w][g] * c;
      num += s_acc[w][g][d] * c;
    }
    out[i] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

}  // namespace repro_decode
