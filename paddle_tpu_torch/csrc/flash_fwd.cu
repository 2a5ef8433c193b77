// Flash-attention forward, for NVIDIA Hopper (sm_90a): kernel 1 of the port.
//
// Replaces the Pallas TPU kernel _fwd_kernel (paddle_tpu/ops/
// flash_attention.py, launched by _flash_fwd). It computes the same
// function: online-softmax attention of q [B, S_q, H, D] over k/v
// [B, S_k, H_kv, D]; causal with aligned ends (row i sees keys <= i +
// q_off); keys at or past n_keys (the reference's kv_valid) never visited;
// an additive f32 key mask [B, S_k]; GQA by index (head h reads kv head
// h / (H / H_kv), never a repeated copy); attention dropout on p from the
// counter hash (dropout_keep in attention.cuh: row b * H + h, the local q
// row, the key), so the backward kernels (flash_bwd.cu) regenerate the
// mask instead of reading it. It writes out in q's dtype and
// lse = m + log(max(l, 1e-30)) in f32, which the backward kernels read.
// The tile kernel is attn_tile_kernel in attention.cuh.
//
// q, k and v are read in the reference's [B, S, H, D] layout through
// element strides, so the strided views of the packed qkv projection are
// read in place, without a transpose or a copy.
//
// Bound. At the forward's shape on the main path (B = 8, S = 1024, H = 16,
// D = 64, causal, bf16) the work is ~17.2 GFLOP (17 us on the tensor cores)
// over ~67 MB of q/k/v/out (20 us at 3.35 TB/s): bound by bytes at the
// tensor cores' rate. This kernel does its dots on CUDA cores in f32 from
// shared memory, so it is bound by operations (shared-memory traffic in
// practice) far above that; wgmma with TMA-fed tiles is the later step. The
// causal tile stops at its last row's key, halving the work of a full
// sweep.
#include "attention.cuh"

extern "C" {

// q [B, S_q, H, D] with element strides (q_sb, q_ss, q_sh); k/v [B, S_k,
// H_kv, D] with strides (k_sb, k_ss, k_sh); every head dim contiguous.
// kmask additive f32 [B, S_k] with batch stride m_sb (0 broadcasts one
// row), or null. out [B, S_q, H, D] contiguous; lse [B, H, S_q] f32.
// n_keys: keys 0 .. n_keys-1 are attended (S_k, or the valid bound).
// dropout: 0 = none, else keep p where dropout_keep(seed, ..., drop_thr)
// and scale it by drop_mult (the f32s of rate * 2^24 and 1 / (1 - rate)).
// dtype: 0 = float32, 1 = bfloat16. Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success), or -1 for a
// dtype/head_dim this library has no instance of.
int flash_fwd(const void* q, const void* k, const void* v, const void* kmask,
              void* out, void* lse, long long q_sb, long long q_ss,
              long long q_sh, long long k_sb, long long k_ss, long long k_sh,
              long long m_sb, int B, int S_q, int H, int H_kv, int D,
              int n_keys, int causal, int q_off, int dtype, int dropout,
              unsigned int seed, float drop_thr, float drop_mult,
              void* stream) {
  attn::TileArgs a{};
  a.q = q; a.k = k; a.v = v;
  a.ks = nullptr; a.vs = nullptr;
  a.kmask = static_cast<const float*>(kmask);
  a.pos = nullptr;
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.m_sb = m_sb;
  a.s_q = S_q; a.H = H; a.H_kv = H_kv;
  a.n_keys = n_keys;
  a.causal = causal;
  a.q_off = q_off;
  a.scale = (float)(1.0 / sqrt((double)D));
  a.drop = attn::Dropout{dropout, seed, drop_thr, drop_mult};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return attn::launch_tile_d<float, float>(D, a, B, s);
  if (dtype == 1)
    return attn::launch_tile_d<__nv_bfloat16, __nv_bfloat16>(D, a, B, s);
  return -1;
}

const char* attn_error_string(int code) { return attn::error_string(code); }

}  // extern "C"
