// Paged decode attention for Hopper (sm_90a): one new token's GQA queries
// attend to a lane's KV cache, read through a page table.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (paged_decode_attention_pallas, body _paged_decode_attn_kernel) and
// computes what it computes: scores q.k^T / sqrt(hd) in f32, an online softmax
// (running max m, denominator l, accumulator acc, all f32) across the lane's
// pages, output acc / max(l, 1e-30) cast to the input type.
//
// Shapes (all contiguous, row-major):
//   q          (B, KV, G, hd)           bf16 or f32
//   k_pool     (NB, page_size, KV, hd)  same type as q (one period's pool)
//   v_pool     (NB, page_size, KV, hd)
//   page_table (B, num_pages) int32     block 0 is scratch
//   valid_len  (B,) int32               resident tokens per lane
//   out        (B, KV, G, hd)
//
// Contract: valid_len[b] >= 1.  The model always passes min(pos + 1, cap),
// so it holds on every call.  The Pallas kernel walks all num_pages pages and
// masks positions >= valid_len to -1e30; this kernel stops after
// ceil(valid_len / page_size) pages.  For valid_len >= 1 the two agree: a
// masked score adds exp(-1e30 - m) = 0 to l and acc.  valid_len above
// num_pages * page_size is clamped to it, as the Pallas mask does.
//
// Design (simple and right first): one thread block per (b, kv head), 8 warps.
// The block loads its G query rows into shared memory in f32.  Warp w takes
// tokens [4w, 4w + 4), then [4w + 32, 4w + 36), ... of the lane; lane i of
// a warp holds elements i, i + 32, ... of each head vector, so every load of
// a K or V row is one coalesced 32-wide access.  Each warp keeps its own
// online softmax per query row; at the end the warps' (m, l, acc) are merged
// through shared memory.  The page table is read by the block itself (there
// is no scalar prefetch on this card).
//
// Bound: memory.  The work reads K and V of sum_b valid_len_b tokens
// (KV * hd * itemsize bytes each) once, plus q and out.  At the main path's
// widths (8 lanes x 1,024 tokens, KV 8, hd 128, bf16) that is ~33.5 MB, so
// >= 10 us at 3.35 TB/s.
//
// What this design leaves on the table: only B x KV blocks are in flight
// (64 on 132 SMs at the main path's widths), so a split over pages with a
// combine pass would fill the card; loads go through registers with no
// cp.async / TMA pipeline; the G x hd by hd x tokens products run on CUDA
// cores, not wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;  // tokens a warp loads before it computes

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

// G query rows per KV head; EPT head elements per thread (hd = 32 * EPT).
template <typename T, int G, int EPT>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ valid_len, T* __restrict__ out,
                    int KV, int num_pages, int page_size, float scale) {
  constexpr int HD = 32 * EPT;
  __shared__ float s_q[G][HD];
  __shared__ float s_m[kWarps][G];
  __shared__ float s_l[kWarps][G];
  __shared__ float s_acc[kWarps][G][HD];

  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const size_t head = (size_t)b * KV + h;
  const T* qb = q + head * G * HD;
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) s_q[i / HD][i % HD] = to_f32(qb[i]);
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

  const int vlen = min(valid_len[b], num_pages * page_size);
  const int32_t* pt = page_table + (size_t)b * num_pages;
  const size_t tok_stride = (size_t)KV * HD;  // elements between a block's rows

  for (int base = warp * kUnroll; base < vlen; base += kWarps * kUnroll) {
    float kr[kUnroll][EPT], vr[kUnroll][EPT];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u;
      if (j < vlen) {
        const size_t blk = (size_t)pt[j / page_size];
        const size_t row = (blk * page_size + j % page_size) * tok_stride + (size_t)h * HD;
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          kr[u][e] = to_f32(k_pool[row + lane + 32 * e]);
          vr[u][e] = to_f32(v_pool[row + lane + 32 * e]);
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

  T* ob = out + head * G * HD;
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
    ob[i] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* page_table,
           const void* valid_len, void* out, int B, int KV, int G, int hd, int num_pages,
           int page_size, void* stream) {
  const dim3 grid((unsigned)(B * KV)), block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf((float)hd);
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k_pool);
  const auto* vp = static_cast<const T*>(v_pool);
  const auto* pt = static_cast<const int32_t*>(page_table);
  const auto* vl = static_cast<const int32_t*>(valid_len);
  auto* op = static_cast<T*>(out);
  if (B * KV == 0) return 0;
#define REPRO_PAGED_CASE(GG, EE)                                                      \
  if (G == GG && hd == 32 * EE) {                                                     \
    paged_decode_kernel<T, GG, EE>                                                    \
        <<<grid, block, 0, s>>>(qp, kp, vp, pt, vl, op, KV, num_pages, page_size, scale); \
    return (int)cudaGetLastError();                                                   \
  }
  // G * hd <= 1024 keeps the static shared memory under 48 KB.
  REPRO_PAGED_CASE(1, 2) REPRO_PAGED_CASE(1, 4) REPRO_PAGED_CASE(1, 8)
  REPRO_PAGED_CASE(2, 2) REPRO_PAGED_CASE(2, 4) REPRO_PAGED_CASE(2, 8)
  REPRO_PAGED_CASE(4, 2) REPRO_PAGED_CASE(4, 4) REPRO_PAGED_CASE(4, 8)
  REPRO_PAGED_CASE(8, 2) REPRO_PAGED_CASE(8, 4)
#undef REPRO_PAGED_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points, bound with ctypes.  They launch on `stream` and
// return cudaGetLastError() after the launch (0 on success); they never
// synchronise and allocate nothing.
extern "C" int paged_decode_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                                           const void* page_table, const void* valid_len,
                                           void* out, int B, int KV, int G, int hd,
                                           int num_pages, int page_size, void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, valid_len, out, B, KV, G, hd,
                               num_pages, page_size, stream);
}

extern "C" int paged_decode_attention_f32(const void* q, const void* k_pool, const void* v_pool,
                                          const void* page_table, const void* valid_len,
                                          void* out, int B, int KV, int G, int hd,
                                          int num_pages, int page_size, void* stream) {
  return launch<float>(q, k_pool, v_pool, page_table, valid_len, out, B, KV, G, hd, num_pages,
                       page_size, stream);
}
