// Device code shared by the port's attention kernels, for NVIDIA Hopper
// (sm_90a): element loaders, warp reductions, the row loader, the dropout
// hash, and the attention-tile kernel that flash_decode.cu instantiates
// (kernels 4 and 5) and flash_fwd.cu instantiates for float32 (kernel 1's
// bf16 instance is the tensor-core kernel of flash_fwd.cu).
//
// The attention-tile kernel computes, for one (batch b, query head h, tile
// of up to 64 q rows), the function of the reference's Pallas kernels
// _fwd_kernel (paddle_tpu/ops/flash_attention.py) and _decode_kernel /
// _decode_kernel_int8 (same file): scores are f32 dots times 1/sqrt(D);
// int8 keys multiply their row scale into the score after the dot; an
// additive key mask is added; keys a row may not see (causal: key > off +
// row, with off the q offset or the device-side decode position) are set
// to -1e30; an online softmax (m, l, acc) carries across key chunks in f32;
// l sums the unrounded p, while p.V takes p rounded to q's dtype (int8
// values first multiply their row scale into p); the output is
// acc / max(l, 1e-30) in q's dtype, and lse = m + log(max(l, 1e-30)).
// With attention dropout (training, kernel 1 only) l still sums the
// undropped p, and p.V takes p x keep / (1 - rate) rounded to q's dtype,
// keep from the counter hash dropout_keep below.
//
// Design. Head h reads kv head h / (H / H_kv): GQA never materialises
// repeated KV. Operands are read in the reference's [B, S, H, D] layout
// through element strides (the head dim contiguous), so q, k and v may be
// strided views of the packed qkv projection and a cache layer is read in
// place. Rows come in as 16-byte vectors into shared memory, widened to
// f32; the dots run on CUDA cores in f32 from shared memory, a thread per
// key for the scores and a thread per output column for p.V. The tile
// stops at the last key its own rows can see, which skips only keys masked
// for every row (no number changes) and halves a causal forward's work.
// wgmma, TMA and splitting the key range across blocks are for later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace attn {

constexpr int NT = 256;          // threads per block
constexpr int TQ = 64;           // q rows per block
constexpr float NEG_INF = -1e30f;
constexpr float EPS = 1e-30f;

template <typename T> struct Elem;

template <> struct Elem<float> {
  static __device__ __forceinline__ float from_f(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  // 16 bytes = 4 floats
  static __device__ __forceinline__ void load16(const float* src, float* dst) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  }
};

template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  // 16 bytes = 8 bf16, widened to f32
  static __device__ __forceinline__ void load16(const __nv_bfloat16* src,
                                                float* dst) {
    uint4 u = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    float2 a = __bfloat1622float2(h[0]);
    float2 b = __bfloat1622float2(h[1]);
    float2 c = __bfloat1622float2(h[2]);
    float2 d = __bfloat1622float2(h[3]);
    reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
    reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
  }
};

template <> struct Elem<int8_t> {
  // 16 bytes = 16 int8, widened to f32 (exact)
  static __device__ __forceinline__ void load16(const int8_t* src,
                                                float* dst) {
    int4 u = *reinterpret_cast<const int4*>(src);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4((float)c[i], (float)c[i + 1], (float)c[i + 2],
                      (float)c[i + 3]);
  }
};

// The reference's counter-hash dropout mask (_dropout_keep,
// paddle_tpu/ops/flash_attention.py): a murmur3-style finalizer over (seed,
// attention row b * H + h, local q row, global key) in u32 arithmetic; the
// top 24 bits against thr, the f32 of rate * 2^24. The forward and both
// backward kernels call it, so they regenerate the same mask bit for bit
// and never store it.
__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t row,
                                             uint32_t q, uint32_t k,
                                             float thr) {
  uint32_t x = q * 0x9E3779B1u + k * 0x85EBCA77u + row * 0xC2B2AE3Du + seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return (float)(x >> 8) >= thr;
}

// Dropout arguments of one attention call (dropout == 0: none).
struct Dropout {
  int dropout;
  uint32_t seed;
  float thr;                // f32 of rate * 2^24
  float mult;               // f32 of 1 / (1 - rate)
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy n rows of D elements (row i at src + i * stride) into smem rows of
// DP floats, as 16-byte vectors.
template <typename T, int D, int DP>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          size_t stride, int n, float* dst) {
  constexpr int EPV = 16 / sizeof(T);   // elements per 16-byte vector
  constexpr int VPR = D / EPV;          // vectors per row
  for (int i = threadIdx.x; i < n * VPR; i += NT) {
    const int r = i / VPR, c = i % VPR;
    Elem<T>::load16(src + (size_t)r * stride + c * EPV, dst + r * DP + c * EPV);
  }
}

// Arguments of one attention call. Strides are in elements.
struct TileArgs {
  const void* q;            // [B, S_q, H, D]
  const void* k;            // [B, n_keys.., H_kv, D]
  const void* v;            // as k (same strides)
  const float* ks;          // int8 only: k row scales, contiguous [B, n_keys, H_kv]
  const float* vs;          // int8 only: v row scales, as ks
  const float* kmask;       // additive [B, n_keys] (batch stride m_sb), or null
  const int* pos;           // decode: device position of q row 0, or null
  void* out;                // [B, S_q, H, D] contiguous, q's dtype
  float* lse;               // [B, H, S_q] f32, or null
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long m_sb;
  int s_q, H, H_kv;
  int n_keys;               // keys 0 .. n_keys-1 may be visited
  int causal;               // row i sees keys <= off + i
  int q_off;                // off when pos is null
  float scale;              // 1/sqrt(D)
  Dropout drop;             // forward only; the decode kernels pass none
};

template <typename T, typename KV, int D, int BK>
// D = 64: two blocks per SM (128 registers a thread); wider heads are held
// to one block by shared memory, so they keep the registers instead
__global__ void __launch_bounds__(NT, D <= 64 ? 2 : 1)
attn_tile_kernel(const TileArgs a) {
  constexpr bool INT8 = sizeof(KV) == 1;
  constexpr int DP = D + 4;             // padded smem row: float4 reads
                                        // by neighbouring keys hit
                                        // distinct banks
  constexpr int S_RSTEP = NT / BK;      // score tile: thread -> one key,
  constexpr int S_NJ = TQ / S_RSTEP;    //   rows rg + j * S_RSTEP
  constexpr int O_RSTEP = NT / D;       // output tile: thread -> one
  constexpr int O_NJ = TQ / O_RSTEP;    //   column, rows orow0 + j * O_RSTEP

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // [TQ][DP]  q tile (f32)
  float* kv_s = q_s + TQ * DP;          // [BK][DP]  K or V chunk (f32)
  float* s_s = kv_s + BK * DP;          // [TQ][BK]  scores, then p
  float* m_s = s_s + TQ * BK;           // [TQ]      running max
  float* l_s = m_s + TQ;                // [TQ]      running normalizer
  float* a_s = l_s + TQ;                // [TQ]      this chunk's rescale

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = min(TQ, a.s_q - q0);
  const int hk = h / (a.H / a.H_kv);
  const int off = a.pos ? a.pos[0] : a.q_off;
  // keys any row of this tile can see: all of them, or (causal) up to the
  // last row's own position
  int n_end = a.n_keys;
  if (a.causal) n_end = max(0, min(n_end, off + q0 + rows));

  load_rows<T, D, DP>(static_cast<const T*>(a.q) + b * a.q_sb + q0 * a.q_ss +
                          h * a.q_sh,
                      (size_t)a.q_ss, rows, q_s);
  for (int r = tid; r < TQ; r += NT) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  float acc[O_NJ];
#pragma unroll
  for (int j = 0; j < O_NJ; ++j) acc[j] = 0.f;
  const int od = tid % D, orow0 = tid / D;
  const int key = tid % BK, rg = tid / BK;
  const int warp = tid / 32, lane = tid % 32;
  const KV* kb = static_cast<const KV*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const KV* vb = static_cast<const KV*>(a.v) + b * a.k_sb + hk * a.k_sh;
  // int8 row scales: contiguous [B, n_keys, H_kv]
  const size_t sc0 = (size_t)b * a.n_keys * a.H_kv + hk;
  __syncthreads();

  for (int c0 = 0; c0 < n_end; c0 += BK) {
    const int n = min(BK, n_end - c0);

    // scores: s = (q . k) * scale [* k scale] [+ mask], masked to visible
    load_rows<KV, D, DP>(kb + (size_t)c0 * a.k_ss, (size_t)a.k_ss, n, kv_s);
    __syncthreads();
    if (key < n) {
      float s[S_NJ];
#pragma unroll
      for (int j = 0; j < S_NJ; ++j) s[j] = 0.f;
      const float* kr = kv_s + key * DP;
#pragma unroll 4
      for (int dd = 0; dd < D; dd += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + dd);
#pragma unroll
        for (int j = 0; j < S_NJ; ++j) {
          const int r = rg + j * S_RSTEP;
          if (r >= rows) break;         // rows grow with j: the rest too
          const float4 q4 =
              *reinterpret_cast<const float4*>(q_s + r * DP + dd);
          s[j] = fmaf(q4.x, k4.x, s[j]);
          s[j] = fmaf(q4.y, k4.y, s[j]);
          s[j] = fmaf(q4.z, k4.z, s[j]);
          s[j] = fmaf(q4.w, k4.w, s[j]);
        }
      }
      const int kpos = c0 + key;
      const float ksc = INT8 ? a.ks[sc0 + (size_t)kpos * a.H_kv] : 1.f;
      const float madd = a.kmask ? a.kmask[b * a.m_sb + kpos] : 0.f;
#pragma unroll
      for (int j = 0; j < S_NJ; ++j) {
        const int r = rg + j * S_RSTEP;
        if (r >= rows) break;
        float sc = s[j] * a.scale;
        if (INT8) sc *= ksc;
        if (a.kmask) sc += madd;
        const bool seen = !a.causal || kpos <= off + q0 + r;
        s_s[r * BK + key] = seen ? sc : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax over this chunk, one warp per row; l takes the
    // unrounded p, the p.V product takes p [times the v scale] [times the
    // dropout multiplier] rounded to q's dtype
    const uint32_t drow = (uint32_t)(b * a.H + h);
    for (int r = warp; r < rows; r += NT / 32) {
      float* sr = s_s + r * BK;
      float mx = NEG_INF;
      for (int k = lane; k < n; k += 32) mx = fmaxf(mx, sr[k]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int k = lane; k < n; k += 32) {
        const float e = expf(sr[k] - m_new);
        sum += e;
        float pv = INT8 ? e * a.vs[sc0 + (size_t)(c0 + k) * a.H_kv] : e;
        if (a.drop.dropout)
          pv = dropout_keep(a.drop.seed, drow, q0 + r, c0 + k, a.drop.thr)
                   ? pv * a.drop.mult : 0.f;
        sr[k] = Elem<T>::round(pv);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    load_rows<KV, D, DP>(vb + (size_t)c0 * a.k_ss, (size_t)a.k_ss, n, kv_s);
    __syncthreads();

    // acc = acc * alpha + p . V, four keys at a time (one 16-byte read of p)
#pragma unroll
    for (int j = 0; j < O_NJ; ++j) {
      const int r = orow0 + j * O_RSTEP;
      if (r >= rows) break;
      acc[j] *= a_s[r];
    }
    const int n4 = n & ~3;
    for (int k = 0; k < n4; k += 4) {
      const float v0 = kv_s[k * DP + od], v1 = kv_s[(k + 1) * DP + od];
      const float v2 = kv_s[(k + 2) * DP + od], v3 = kv_s[(k + 3) * DP + od];
#pragma unroll
      for (int j = 0; j < O_NJ; ++j) {
        const int r = orow0 + j * O_RSTEP;
        if (r >= rows) break;
        const float4 p4 = *reinterpret_cast<const float4*>(s_s + r * BK + k);
        acc[j] = fmaf(p4.x, v0, acc[j]);
        acc[j] = fmaf(p4.y, v1, acc[j]);
        acc[j] = fmaf(p4.z, v2, acc[j]);
        acc[j] = fmaf(p4.w, v3, acc[j]);
      }
    }
    for (int k = n4; k < n; ++k) {
      const float v = kv_s[k * DP + od];
#pragma unroll
      for (int j = 0; j < O_NJ; ++j) {
        const int r = orow0 + j * O_RSTEP;
        if (r >= rows) break;
        acc[j] = fmaf(s_s[r * BK + k], v, acc[j]);
      }
    }
    __syncthreads();
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int j = 0; j < O_NJ; ++j) {
    const int r = orow0 + j * O_RSTEP;
    if (r >= rows) break;
    out[(((size_t)b * a.s_q + q0 + r) * a.H + h) * D + od] =
        Elem<T>::from_f(acc[j] / fmaxf(l_s[r], EPS));
  }
  if (a.lse && tid < rows)
    a.lse[((size_t)b * a.H + h) * a.s_q + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], EPS));
}

// Keys per chunk: 128 for D <= 128; D = 256 halves it to fit shared memory.
template <int D> constexpr int chunk_keys() { return D <= 128 ? 128 : 64; }

template <typename T, typename KV, int D>
int launch_tile(const TileArgs& a, int B, cudaStream_t stream) {
  constexpr int BK = chunk_keys<D>();
  const size_t smem = sizeof(float) * ((size_t)TQ * (D + 4) +
                                       (size_t)BK * (D + 4) +
                                       (size_t)TQ * BK + 3 * TQ);
  auto kern = attn_tile_kernel<T, KV, D, BK>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.s_q + TQ - 1) / TQ, a.H, B);
  if (grid.x == 0 || B == 0) return 0;
  kern<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// One instance per head dim; -1 for a head dim with none.
template <typename T, typename KV>
int launch_tile_d(int D, const TileArgs& a, int B, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_tile<T, KV, 64>(a, B, stream);
    case 128: return launch_tile<T, KV, 128>(a, B, stream);
    case 256: return launch_tile<T, KV, 256>(a, B, stream);
  }
  return -1;
}

// Codes the C entry points return beside cudaError_t (which is >= 0).
constexpr int ERR_NO_INSTANCE = -1;
constexpr int ERR_TENSOR_MAP = -2;
constexpr int ERR_SCRATCH = -3;

inline const char* error_string(int code) {
  if (code == ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled refused an operand's layout";
  if (code == ERR_SCRATCH)
    return "the split-K instance was given no partial buffers or tickets";
  if (code < 0) return "no kernel instance for this dtype / head_dim";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace attn
