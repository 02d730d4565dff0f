// Paged decode attention for Hopper (sm_90a): one new token's GQA queries
// attend to a lane's KV cache, read through a page table.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (paged_decode_attention_pallas, body _paged_decode_attn_kernel) and
// computes what it computes.  A lane's tokens are cut into n_split pieces of L
// (split_len, a multiple of page_size) tokens, one block each: grid (B * KV,
// n_split), and each block reads whole pages of its page-table row.  The
// device body, its design and its contract are in decode_attention.cuh,
// shared with the dense kernel.
//
// Shapes (all contiguous, row-major):
//   q          (B, KV, G, hd)           bf16 or f32
//   k_pool     (NB, page_size, KV, hd)  same type as q (one period's pool)
//   v_pool     (NB, page_size, KV, hd)
//   page_table (B, num_pages) int32     block 0 is scratch
//   valid_len  (B,) int32               resident tokens per lane
//   out        (B, KV, G, hd)
//   ws         (B * KV * n_split * G * (hd + 2),) f32   partials; unused if n_split = 1
//   counters   (>= B * KV,) int32, all 0; left at 0.  They belong to one stream.
//
// Contract: valid_len[b] >= 1.  The model always passes min(pos + 1, cap),
// so it holds on every call.  The Pallas kernel walks all num_pages pages and
// masks positions >= valid_len to -1e30; this kernel stops after
// ceil(valid_len / page_size) pages.  For valid_len >= 1 the two agree: a
// masked score adds exp(-1e30 - m) = 0 to l and acc.  valid_len above
// num_pages * page_size is clamped to it, as the Pallas mask does.  The block
// reads the page table itself (there is no scalar prefetch on this card).
//
// Bound: memory.  The work reads K and V of sum_b valid_len_b tokens
// (KV * hd * itemsize bytes each) once, plus q and out.  At the main path's
// widths (8 lanes x 1,024 tokens, KV 8, hd 128, bf16) that is ~33.5 MB, so
// >= 10 us at 3.35 TB/s.
//
// What this design leaves on the table: 16-byte loads go through registers
// with no cp.async / TMA ring, and the G x hd by hd x tokens products run on
// CUDA cores, not mma / wgmma (decode_attention.cuh).  Each lane of a row
// looks its token's page up itself.

#include "decode_attention.cuh"

namespace {

using namespace repro_decode;

struct PagedRows {
  const int32_t* pt;  // this lane's page-table row
  int page_size;
  size_t tok_stride;  // elements between a block's token rows (KV * hd)
  size_t head_off;    // h * hd
  __device__ __forceinline__ size_t operator()(int j) const {
    const size_t blk = (size_t)pt[j / page_size];
    return (blk * page_size + j % page_size) * tok_stride + head_off;
  }
};

template <typename T, int G, int EPT>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ valid_len, T* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters, int KV, int num_pages,
                    int page_size, int split_len, float scale) {
  constexpr int HD = 32 * EPT;
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const size_t head = blockIdx.x;
  const PagedRows rows{page_table + (size_t)b * num_pages, page_size, (size_t)KV * HD,
                       (size_t)h * HD};
  const int vlen = min(valid_len[b], num_pages * page_size);
  decode_split<T, G, HD>(q + head * G * HD, k_pool, v_pool, out + head * G * HD, ws, counters,
                         vlen, split_len, rows, scale);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* page_table,
           const void* valid_len, void* out, void* ws, void* counters, int B, int KV, int G,
           int hd, int num_pages, int page_size, int split_len, int n_split, void* stream) {
  if (B * KV == 0) return 0;
  if (n_split < 1 || n_split > kMaxSplits || split_len < 1 || page_size < 1 ||
      split_len % page_size || (n_split > 1 && (!ws || !counters)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * KV), (unsigned)n_split), block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf((float)hd);
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k_pool);
  const auto* vp = static_cast<const T*>(v_pool);
  const auto* pt = static_cast<const int32_t*>(page_table);
  const auto* vl = static_cast<const int32_t*>(valid_len);
  auto* op = static_cast<T*>(out);
  auto* wp = static_cast<float*>(ws);
  auto* cp = static_cast<int*>(counters);
#define REPRO_PAGED_CASE(GG, EE)                                                      \
  if (G == GG && hd == 32 * EE) {                                                     \
    paged_decode_kernel<T, GG, EE><<<grid, block, 0, s>>>(                            \
        qp, kp, vp, pt, vl, op, wp, cp, KV, num_pages, page_size, split_len, scale);  \
    return (int)cudaGetLastError();                                                   \
  }
  REPRO_DECODE_SHAPES(REPRO_PAGED_CASE)
#undef REPRO_PAGED_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points, bound with ctypes.  They launch on `stream` and
// return cudaGetLastError() after the launch (0 on success); they never
// synchronise and allocate nothing.
extern "C" int paged_decode_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                                           const void* page_table, const void* valid_len,
                                           void* out, void* ws, void* counters, int B, int KV,
                                           int G, int hd, int num_pages, int page_size,
                                           int split_len, int n_split, void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, valid_len, out, ws, counters, B,
                               KV, G, hd, num_pages, page_size, split_len, n_split, stream);
}

extern "C" int paged_decode_attention_f32(const void* q, const void* k_pool, const void* v_pool,
                                          const void* page_table, const void* valid_len,
                                          void* out, void* ws, void* counters, int B, int KV,
                                          int G, int hd, int num_pages, int page_size,
                                          int split_len, int n_split, void* stream) {
  return launch<float>(q, k_pool, v_pool, page_table, valid_len, out, ws, counters, B, KV, G,
                       hd, num_pages, page_size, split_len, n_split, stream);
}
