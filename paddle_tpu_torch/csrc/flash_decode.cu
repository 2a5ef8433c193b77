// Flash decode over a dense KV cache, for NVIDIA Hopper (sm_90a): kernels 4
// and 5 of the port.
//
// Replaces the Pallas TPU kernels _decode_kernel and _decode_kernel_int8
// (paddle_tpu/ops/flash_attention.py, launched by flash_decode and
// flash_decode_int8). q rows at absolute positions pos .. pos+T-1 attend the
// cache positions up to their own. pos is read from device memory (an int32
// [1] tensor), the counterpart of the TPU's scalar prefetch, so a decode
// step needs no host sync and can be captured in a CUDA graph. bf16/f32 rows
// are in q's dtype; int8 rows carry f32 row scales, where the k scale
// multiplies the score after the dot and the v scale multiplies p before p
// is rounded to q's dtype for p.V, as on the TPU.
//
// The cache is one layer's [B, S_max, H_kv, D] view of the [L, B, S_max,
// H_kv, D] cache, read in place through its element strides: one head's K/V
// row is a contiguous D-vector (the TPU wrapper transposes the cache to
// [B*H_kv, S_max, D] on every call), and q may be a strided view of the
// packed qkv projection. The TPU kernel takes T <= 128 (its q tile); here
// every T is one launch.
//
// Both kernels take kernel 6 and 7's instances from kv_attention.cuh, chosen
// in one shared entry (dense_instances) by T, dtype, head dim and S_max
// (never after a failed launch); the rows are q's dtype (kernel 4) or int8
// with their scales (kernel 5):
// - T <= 16: the split-K decode over the cache read as pages of 128 rows
//   through an implicit table (page p of batch row b is its rows p * 128 ..
//   p * 128 + 127), n_split runs of pps pages sized from S_max and the SM
//   count (never from pos), the partials merged by the last split of each
//   (batch row, kv head) to finish;
// - T > 16, bf16 q, D 64/128, S_max a multiple of 64: the tensor-core
//   prefill over 64-row chunks of each batch row, TMA-loaded straight into
//   the 128-byte swizzle (bf16 rows) or widened to bf16 by the producer
//   warpgroup (int8 rows);
// - otherwise (f32 at T > 16, D 256, S_max not a multiple of 64) the
//   CUDA-core attention tile of attention.cuh (attn_tile_kernel): a block
//   owns 64 q rows of one (batch, head) and streams its keys alone.
//
// Bound. A decode step (T = 1) reads each K/V row up to pos once and does
// ~4*D flops per key per head, far below the card's ~295 flops per byte: it
// is bound by bytes (int8 rows halve them; their scales add 8 bytes a row).
// A block of the CUDA-core tile streams its keys alone, so with B*H blocks
// the card has few bytes in flight: the split-K instance splits the key
// range across blocks.
#include "attention.cuh"
#include "kv_attention.cuh"

namespace {

constexpr int DENSE_PS = 128;   // rows of a page of the implicit table

attn::TileArgs decode_args(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs, const void* pos,
                           void* out, void* lse, long long q_sb,
                           long long q_ss, long long q_sh, long long k_sb,
                           long long k_ss, long long k_sh, int T, int H,
                           int H_kv, int D, int S_max) {
  attn::TileArgs a{};
  a.q = q; a.k = k; a.v = v;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.kmask = nullptr;
  a.pos = static_cast<const int*>(pos);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.m_sb = 0;
  a.s_q = T; a.H = H; a.H_kv = H_kv;
  a.n_keys = S_max;
  a.causal = 1;             // row j sees keys <= pos + j
  a.q_off = 0;
  a.scale = (float)(1.0 / sqrt((double)D));
  return a;
}

// The three instances over the dense cache, rows of KV, for q (and out)
// of T; *instance as the entry points report it.
template <typename T, typename KV>
int dense_instances(const kv::SplitArgs& sa, const attn::TileArgs& ta,
                    int dtype, int D, int S_max, int* instance,
                    cudaStream_t s) {
  if (sa.t_len <= kv::SPLIT_MAX_T) {
    const int e = kv::launch_split<T, KV, false>(D, sa, s);
    if (e == 0) *instance = 1;
    return e;
  }
  if constexpr (sizeof(T) == 2) {
    if (kv::prefill_tc_takes(dtype, D, S_max)) {
      kv::PrefillArgs pa{sa.src, sa.pos, nullptr,
                         static_cast<__nv_bfloat16*>(sa.out), sa.t_len,
                         sa.H, sa.H_kv, sa.scale};
      const int e = kv::launch_prefill_tc<KV, false>(
          D, sa.q, sa.q_sb, sa.q_ss, sa.q_sh, pa, sa.B, sa.B, s);
      if (e == 0) *instance = 2;
      return e;
    }
  }
  return attn::launch_tile_d<T, KV>(D, ta, sa.B, s);
}

// The body of both entry points; int8: k/v int8 with row scales ks/vs.
int dense_entry(const void* q, const void* k, const void* v, const void* ks,
                const void* vs, const void* pos, void* out, void* lse,
                long long q_sb, long long q_ss, long long q_sh,
                long long k_sb, long long k_ss, long long k_sh, int B, int T,
                int H, int H_kv, int D, int S_max, int dtype, void* stream,
                void* m_part, void* l_part, void* acc_part, void* tickets,
                int n_split, int pps, bool int8, int* instance) {
  *instance = 0;
  if (dtype != 0 && dtype != 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kv::SplitArgs sa{};
  sa.q = q;
  sa.q_sb = q_sb;
  sa.q_ss = q_ss;
  sa.q_sh = q_sh;
  kv::KvSrc& src = sa.src;
  src.k = k;
  src.v = v;
  src.ks = static_cast<const float*>(ks);
  src.vs = static_cast<const float*>(vs);
  src.table = nullptr;                   // the implicit table
  src.s_page = k_sb;
  src.s_row = k_ss;
  src.s_head = k_sh;
  src.ps = DENSE_PS;
  src.p_max = (S_max + DENSE_PS - 1) / DENSE_PS;
  src.n_keys = S_max;
  src.pos_sb = 0;                        // one pos for every batch row
  sa.pos = static_cast<const int*>(pos);
  sa.valid = nullptr;
  sa.m_part = static_cast<float*>(m_part);
  sa.l_part = static_cast<float*>(l_part);
  sa.acc_part = static_cast<float*>(acc_part);
  sa.tickets = static_cast<int*>(tickets);
  sa.out = out;
  sa.B = B;
  sa.t_len = T;
  sa.H = H;
  sa.H_kv = H_kv;
  sa.n_split = n_split;
  sa.pps = pps;
  sa.scale = (float)(1.0 / sqrt((double)D));
  const attn::TileArgs ta = decode_args(q, k, v, ks, vs, pos, out, lse, q_sb,
                                        q_ss, q_sh, k_sb, k_ss, k_sh, T, H,
                                        H_kv, D, S_max);
  if (int8)
    return dtype == 0 ? dense_instances<float, int8_t>(sa, ta, dtype, D,
                                                       S_max, instance, s)
                      : dense_instances<__nv_bfloat16, int8_t>(
                            sa, ta, dtype, D, S_max, instance, s);
  return dtype == 0 ? dense_instances<float, float>(sa, ta, dtype, D, S_max,
                                                    instance, s)
                    : dense_instances<__nv_bfloat16, __nv_bfloat16>(
                          sa, ta, dtype, D, S_max, instance, s);
}

}  // namespace

extern "C" {

// Shared argument order of both entry points. q [B, T, H, D] with element
// strides (q_sb, q_ss, q_sh) and a contiguous head dim; k/v one layer's
// cache [B, S_max, H_kv, D] with strides (k_sb, k_ss, k_sh); ks/vs the int8
// row scales, contiguous [B, S_max, H_kv] (null for flash_decode); pos int32
// [1] on the device; out [B, T, H, D] contiguous; lse [B, H, T] f32 or null
// (the CUDA-core tile only). dtype (q's): 0 = float32, 1 = bfloat16. Then
// the split-K instance's partial buffers m_part, l_part [B * T * H, n_split]
// and acc_part [B * T * H, n_split, D] f32 over n_split runs of pps pages
// of DENSE_PS rows (n_split = ceil(ceil(S_max / DENSE_PS) / pps)), and its
// tickets ([B * H_kv] int32, zero and left zero). *instance: 1 split-K, 2
// tensor-core, 0 the CUDA-core tile. Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success), -1 for a
// dtype/head_dim this library has no instance of, ERR_SCRATCH when the
// split-K instance is chosen and a partial buffer or the tickets are null.
#define FLASH_DECODE_ARGS                                                    \
  const void *q, const void *k, const void *v, const void *ks,               \
      const void *vs, const void *pos, void *out, void *lse, long long q_sb, \
      long long q_ss, long long q_sh, long long k_sb, long long k_ss,        \
      long long k_sh, int B, int T, int H, int H_kv, int D, int S_max,       \
      int dtype, void *stream, void *m_part, void *l_part, void *acc_part,   \
      void *tickets, int n_split, int pps, int *instance

#define FLASH_DECODE_PASS                                                    \
  q, k, v, ks, vs, pos, out, lse, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, B, T,  \
      H, H_kv, D, S_max, dtype, stream, m_part, l_part, acc_part, tickets,   \
      n_split, pps

// Kernel 4: k/v in q's dtype (ks/vs ignored).
int flash_decode(FLASH_DECODE_ARGS) {
  return dense_entry(FLASH_DECODE_PASS, false, instance);
}

// Kernel 5: k/v int8 with their row scales ks/vs.
int flash_decode_int8(FLASH_DECODE_ARGS) {
  return dense_entry(FLASH_DECODE_PASS, true, instance);
}

const char* attn_error_string(int code) { return attn::error_string(code); }

}  // extern "C"
