// Dense decode attention for Hopper (sm_90a): one new token's GQA queries
// attend to a lane's contiguous KV cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention_pallas, body _decode_attn_kernel) and computes what it
// computes, not block by block: the Pallas kernel tiles C in block_c = 512
// with the tail padded and masks positions >= valid_len; here the tokens
// j < valid_len[b] of (b, kv head), at element offset ((b * C + j) * KV + h) *
// hd, are cut into n_split pieces of L (split_len) tokens, one block each:
// grid (B * KV, n_split).  The device body, its design and its contract are
// in decode_attention.cuh, shared with the paged kernel.
//
// Shapes (all contiguous, row-major):
//   q          (B, KV, G, hd)   bf16 or f32
//   k, v       (B, C, KV, hd)   same type as q (one period's cache)
//   valid_len  (B,) int32       tokens that count per lane
//   out        (B, KV, G, hd)
//   ws         (B * KV * n_split * G * (hd + 2),) f32   partials; unused if n_split = 1
//   counters   (>= B * KV,) int32, all 0; left at 0.  They belong to one stream.
//
// Contract: valid_len[b] >= 1; values above C are clamped to C, as the Pallas
// mask does.  Every caller on the path passes min(pos + 1, C)
// (layers.attention_decode).  Where every slot is masked the Pallas kernel
// averages over a padded tile, a different result; the contract avoids it.
// Slot order does not matter: a sliding-window ring cache holds token t at
// slot t % C, and attention is invariant under that permutation because RoPE
// is applied before the write.
//
// Bound: memory.  The work reads K and V of sum_b valid_len_b tokens
// (KV * hd * itemsize bytes each, twice) once, plus q and out.  At 8 lanes x
// ~1,024 tokens, KV 8, hd 128, bf16 that is ~33.5 MB, or >= 10 us at
// 3.35 TB/s; at the sliding-window ring shape (4 lanes x 8,192) ~134 MB, or
// >= 40 us.
//
// What this design leaves on the table: 16-byte loads go through registers
// with no cp.async / TMA ring, and the G x hd by hd x tokens products run on
// CUDA cores, not mma / wgmma (decode_attention.cuh).

#include "decode_attention.cuh"

namespace {

using namespace repro_decode;

struct DenseRows {
  size_t base;        // element offset of token 0's row for (b, h)
  size_t tok_stride;  // KV * hd
  __device__ __forceinline__ size_t operator()(int j) const {
    return base + (size_t)j * tok_stride;
  }
};

template <typename T, int G, int EPT>
__global__ void __launch_bounds__(kWarps * 32)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int32_t* __restrict__ valid_len, T* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters, int KV, int C,
                    int split_len, float scale) {
  constexpr int HD = 32 * EPT;
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const size_t head = blockIdx.x;
  const DenseRows rows{(size_t)b * C * KV * HD + (size_t)h * HD, (size_t)KV * HD};
  const int vlen = min(valid_len[b], C);
  decode_split<T, G, HD>(q + head * G * HD, k, v, out + head * G * HD, ws, counters, vlen,
                         split_len, rows, scale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid_len, void* out,
           void* ws, void* counters, int B, int KV, int G, int hd, int C, int split_len,
           int n_split, void* stream) {
  if (B * KV == 0) return 0;
  if (n_split < 1 || n_split > kMaxSplits || split_len < 1 ||
      (n_split > 1 && (!ws || !counters)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * KV), (unsigned)n_split), block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf((float)hd);
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* vl = static_cast<const int32_t*>(valid_len);
  auto* op = static_cast<T*>(out);
  auto* wp = static_cast<float*>(ws);
  auto* cp = static_cast<int*>(counters);
#define REPRO_DENSE_CASE(GG, EE)                                                      \
  if (G == GG && hd == 32 * EE) {                                                     \
    dense_decode_kernel<T, GG, EE>                                                    \
        <<<grid, block, 0, s>>>(qp, kp, vp, vl, op, wp, cp, KV, C, split_len, scale); \
    return (int)cudaGetLastError();                                                   \
  }
  REPRO_DECODE_SHAPES(REPRO_DENSE_CASE)
#undef REPRO_DENSE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points, bound with ctypes.  They launch on `stream` and
// return cudaGetLastError() after the launch (0 on success); they never
// synchronise and allocate nothing.
extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* valid_len, void* out, void* ws, void* counters,
                                     int B, int KV, int G, int hd, int C, int split_len,
                                     int n_split, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, valid_len, out, ws, counters, B, KV, G, hd, C,
                               split_len, n_split, stream);
}

extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* valid_len, void* out, void* ws, void* counters,
                                    int B, int KV, int G, int hd, int C, int split_len,
                                    int n_split, void* stream) {
  return launch<float>(q, k, v, valid_len, out, ws, counters, B, KV, G, hd, C, split_len,
                       n_split, stream);
}
