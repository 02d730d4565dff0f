// Dense decode attention for Hopper (sm_90a): one new token's GQA queries
// attend to a lane's contiguous KV cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention_pallas, body _decode_attn_kernel) and computes what it
// computes, not block by block: the Pallas kernel tiles C in block_c = 512
// with the tail padded and masks positions >= valid_len; here one block per
// (b, kv head) walks tokens j < valid_len[b] directly, at element offset
// ((b * C + j) * KV + h) * hd.  The device body, its design and its contract
// are in decode_attention.cuh, shared with the paged kernel.
//
// Shapes (all contiguous, row-major):
//   q          (B, KV, G, hd)   bf16 or f32
//   k, v       (B, C, KV, hd)   same type as q (one period's cache)
//   valid_len  (B,) int32       tokens that count per lane
//   out        (B, KV, G, hd)
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
// What this design leaves on the table: only B x KV blocks are in flight (32
// at the ring shape, on 132 SMs), so a split over C with a combine pass would
// fill the card; loads go through registers with no cp.async / TMA pipeline;
// the G x hd by hd x tokens products run on CUDA cores, not wgmma.

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
                    const int32_t* __restrict__ valid_len, T* __restrict__ out, int KV, int C,
                    float scale) {
  constexpr int HD = 32 * EPT;
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const size_t head = (size_t)b * KV + h;
  const DenseRows rows{(size_t)b * C * KV * HD + (size_t)h * HD, (size_t)KV * HD};
  const int vlen = min(valid_len[b], C);
  decode_block<T, G, EPT>(q + head * G * HD, k, v, out + head * G * HD, vlen, rows, scale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid_len, void* out, int B,
           int KV, int G, int hd, int C, void* stream) {
  const dim3 grid((unsigned)(B * KV)), block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf((float)hd);
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* vl = static_cast<const int32_t*>(valid_len);
  auto* op = static_cast<T*>(out);
  if (B * KV == 0) return 0;
#define REPRO_DENSE_CASE(GG, EE)                                                      \
  if (G == GG && hd == 32 * EE) {                                                     \
    dense_decode_kernel<T, GG, EE><<<grid, block, 0, s>>>(qp, kp, vp, vl, op, KV, C, scale); \
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
                                     const void* valid_len, void* out, int B, int KV, int G,
                                     int hd, int C, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, valid_len, out, B, KV, G, hd, C, stream);
}

extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* valid_len, void* out, int B, int KV, int G,
                                    int hd, int C, void* stream) {
  return launch<float>(q, k, v, valid_len, out, B, KV, G, hd, C, stream);
}
