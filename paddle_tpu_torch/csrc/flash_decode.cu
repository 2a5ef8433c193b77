// Flash decode over a dense KV cache, for NVIDIA Hopper (sm_90a): kernels 4
// and 5 of the port.
//
// Replaces the Pallas TPU kernels _decode_kernel and _decode_kernel_int8
// (paddle_tpu/ops/flash_attention.py, launched by flash_decode and
// flash_decode_int8). q rows at absolute positions pos .. pos+T-1 attend the
// cache positions up to their own. pos is read from device memory (an int32
// [1] tensor), the counterpart of the TPU's scalar prefetch, so a decode
// step needs no host sync and can be captured in a CUDA graph. One template
// (attn_tile_kernel in attention.cuh) over the cache's element type serves
// both: bf16/f32 rows in q's dtype, or int8 rows with f32 row scales, where
// the k scale multiplies the score after the dot and the v scale multiplies
// p before p is rounded to q's dtype for p.V, as on the TPU.
//
// The cache is one layer's [B, S_max, H_kv, D] view of the [L, B, S_max,
// H_kv, D] cache, read in place: one head's K/V row is a contiguous D-vector
// (the TPU wrapper transposes the cache to [B*H_kv, S_max, D] on every call).
// The TPU kernel takes T <= 128 (its q tile); here a block owns 64 q rows of
// one (batch, head) and the grid tiles T, so every T is one launch.
//
// Bound. A decode step (T = 1) reads each K/V row up to pos once and does
// ~4*D flops per key per head, far below the card's ~295 flops per byte: it
// is bound by bytes (int8 rows halve them; their scales add 8 bytes a row).
// Each block stops at the last key its rows can see. A block streams its
// keys alone, so with B*H blocks the card has few bytes in flight; splitting
// the key range across blocks is for later work.
#include "attention.cuh"

namespace {

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

}  // namespace

extern "C" {

// Shared argument order of both entry points. q [B, T, H, D] with element
// strides (q_sb, q_ss, q_sh) and a contiguous head dim; k/v one layer's
// cache [B, S_max, H_kv, D] with strides (k_sb, k_ss, k_sh); ks/vs the int8
// row scales, contiguous [B, S_max, H_kv] (null for flash_decode); pos int32
// [1] on the device; out [B, T, H, D] contiguous; lse [B, H, T] f32 or null.
// dtype (q's): 0 = float32, 1 = bfloat16. Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success), or -1 for a
// dtype/head_dim this library has no instance of.
#define FLASH_DECODE_ARGS                                                    \
  const void *q, const void *k, const void *v, const void *ks,               \
      const void *vs, const void *pos, void *out, void *lse, long long q_sb, \
      long long q_ss, long long q_sh, long long k_sb, long long k_ss,        \
      long long k_sh, int B, int T, int H, int H_kv, int D, int S_max,       \
      int dtype, void *stream

int flash_decode(FLASH_DECODE_ARGS) {
  const attn::TileArgs a = decode_args(q, k, v, ks, vs, pos, out, lse, q_sb,
                                       q_ss, q_sh, k_sb, k_ss, k_sh, T, H,
                                       H_kv, D, S_max);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return attn::launch_tile_d<float, float>(D, a, B, s);
  if (dtype == 1)
    return attn::launch_tile_d<__nv_bfloat16, __nv_bfloat16>(D, a, B, s);
  return -1;
}

int flash_decode_int8(FLASH_DECODE_ARGS) {
  const attn::TileArgs a = decode_args(q, k, v, ks, vs, pos, out, lse, q_sb,
                                       q_ss, q_sh, k_sb, k_ss, k_sh, T, H,
                                       H_kv, D, S_max);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return attn::launch_tile_d<float, int8_t>(D, a, B, s);
  if (dtype == 1) return attn::launch_tile_d<__nv_bfloat16, int8_t>(D, a, B, s);
  return -1;
}

const char* attn_error_string(int code) { return attn::error_string(code); }

}  // extern "C"
