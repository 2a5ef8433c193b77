// Paged attention over the continuous-batching engine's KV pool, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels _paged_decode_kernel (entry point
// paged_decode) and _paged_decode_kernel_int8 (entry point
// paged_decode_int8), both in paddle_tpu/ops/paged_attention.py, launched
// by paged_flash_decode / paged_flash_decode_int8. It computes the same
// function: q rows of slot b attend that slot's pages
// through the page table; row j sees virtual positions <= pos[b] + j;
// scores are f32 dots times 1/sqrt(D), masked with -1e30; an online softmax
// (m, l, acc) carries across pages in f32; p is rounded to V's dtype
// before p.V, accumulated in f32; the output is acc / max(l, 1e-30) in q's
// dtype. Over int8 pages (kernel 7) each K/V row carries an f32 scale
// ([N, ps, H_kv]): int8 values widen exactly, the k scale multiplies the
// score after the dot, and the v scale multiplies p before p is rounded to
// q's dtype, while l sums p without it, as the TPU kernel does. The
// online-softmax state is updated once per page, as on the TPU, so the
// plain PyTorch twin (paged_decode_reference) repeats the same
// arithmetic.
//
// Design. One thread block for each (slot b, query head h, tile of up to
// 64 q rows). Head h reads KV head h / (H / H_kv): GQA never materialises
// repeated KV. The block loops over its slot's pages, reading each page id
// from page_table[b, p] itself, and stops at the last page its own rows can
// see (min(ceil((pos[b] + last row + 1) / ps), P_max)): a page past that is
// fully masked for the tile, so skipping it changes no number, and a
// causal prefill tile does about half the work of the whole-T bound. The
// pool is read in its native [N, ps, H_kv, D] layout (one layer's view),
// K and V rows as 16-byte vectors into shared memory, converted to f32
// (an int8 row is D bytes, a quarter of f32's and half of bf16's).
//
// Bound. A decode call (T = 1) moves each needed K/V page once and does
// ~4*D flops per key per head: far below the card's ~295 flops per byte,
// so it is bound by bytes (int8 pages halve them against bf16, plus 4
// bytes of scale per row and head). A prefill tile re-reads its pages for
// 64 rows
// and does its dots on CUDA cores, not tensor cores, so at T = 1024 it is
// bound by operations (shared-memory traffic in practice). This first
// version keeps the arithmetic simple and exact; wgmma, TMA and splitting
// the key range across blocks are for later work.
#include "attention.cuh"

namespace {

// element loaders, warp reductions, load_rows and the tile constants
using namespace attn;

template <typename T, typename KV, int D, int BK>
// D = 64: two blocks per SM (128 registers a thread); wider heads are held
// to one block by shared memory, so they keep the registers instead
__global__ void __launch_bounds__(NT, D <= 64 ? 2 : 1)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                    const KV* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ table,
                    const int* __restrict__ pos, T* __restrict__ out,
                    int t_len, int H, int H_kv, int ps, int p_max,
                    float scale) {
  constexpr bool INT8 = sizeof(KV) == 1;  // ks / vs: [N, ps, H_kv] f32
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
  float* s_s = kv_s + BK * DP;          // [TQ][ps]  scores, then p
  float* m_s = s_s + TQ * ps;           // [TQ]      running max
  float* l_s = m_s + TQ;                // [TQ]      running normalizer
  float* a_s = l_s + TQ;                // [TQ]      this page's rescale

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = min(TQ, t_len - q0);
  const int hk = h / (H / H_kv);
  const int p0 = pos[b];
  // last page any row of this tile can see (rows p0+q0 .. p0+q0+rows-1)
  const int needed = min((p0 + q0 + rows + ps - 1) / ps, p_max);
  const size_t row_stride = (size_t)H_kv * D;   // between rows of a page

  load_rows<T, D, DP>(q + (((size_t)b * t_len + q0) * H + h) * D,
                      (size_t)H * D, rows, q_s);
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
  __syncthreads();

  for (int p = 0; p < needed; ++p) {
    const int page = table[b * p_max + p];
    const size_t base = (size_t)page * ps * row_stride + (size_t)hk * D;
    // row scales of this page and kv head: sc0 + key * H_kv
    const size_t sc0 = (size_t)page * ps * H_kv + hk;

    // scores: s = (q . k) * scale, masked to k_pos <= pos + row
    for (int c0 = 0; c0 < ps; c0 += BK) {
      const int n = min(BK, ps - c0);
      load_rows<KV, D, DP>(kp + base + (size_t)c0 * row_stride, row_stride,
                           n, kv_s);
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
            if (r >= rows) break;       // rows grow with j: the rest too
            const float4 q4 =
                *reinterpret_cast<const float4*>(q_s + r * DP + dd);
            s[j] = fmaf(q4.x, k4.x, s[j]);
            s[j] = fmaf(q4.y, k4.y, s[j]);
            s[j] = fmaf(q4.z, k4.z, s[j]);
            s[j] = fmaf(q4.w, k4.w, s[j]);
          }
        }
        const int kpos = p * ps + c0 + key;
        const float ksc = INT8 ? ks[sc0 + (size_t)(c0 + key) * H_kv] : 1.f;
#pragma unroll
        for (int j = 0; j < S_NJ; ++j) {
          const int r = rg + j * S_RSTEP;
          if (r >= rows) break;
          float sc = s[j] * scale;
          if (INT8) sc *= ksc;
          s_s[r * ps + c0 + key] = kpos <= p0 + q0 + r ? sc : NEG_INF;
        }
      }
      __syncthreads();
    }

    // online softmax over this page, one warp per row; l takes the
    // unrounded p, the p.V product takes p [times the v scale] rounded to
    // q's dtype
    for (int r = warp; r < rows; r += NT / 32) {
      float* sr = s_s + r * ps;
      float mx = NEG_INF;
      for (int k = lane; k < ps; k += 32) mx = fmaxf(mx, sr[k]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int k = lane; k < ps; k += 32) {
        const float e = expf(sr[k] - m_new);
        sum += e;
        sr[k] = Elem<T>::round(INT8 ? e * vs[sc0 + (size_t)k * H_kv] : e);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V
#pragma unroll
    for (int j = 0; j < O_NJ; ++j) {
      const int r = orow0 + j * O_RSTEP;
      if (r >= rows) break;
      acc[j] *= a_s[r];
    }
    for (int c0 = 0; c0 < ps; c0 += BK) {
      const int n = min(BK, ps - c0);
      load_rows<KV, D, DP>(vp + base + (size_t)c0 * row_stride, row_stride,
                           n, kv_s);
      __syncthreads();
      // four keys at a time: one 16-byte read of p per row
      const int n4 = (ps & 3) ? 0 : (n & ~3);
      for (int k = 0; k < n4; k += 4) {
        const float v0 = kv_s[k * DP + od], v1 = kv_s[(k + 1) * DP + od];
        const float v2 = kv_s[(k + 2) * DP + od], v3 = kv_s[(k + 3) * DP + od];
#pragma unroll
        for (int j = 0; j < O_NJ; ++j) {
          const int r = orow0 + j * O_RSTEP;
          if (r >= rows) break;
          const float4 p4 =
              *reinterpret_cast<const float4*>(s_s + r * ps + c0 + k);
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
          acc[j] = fmaf(s_s[r * ps + c0 + k], v, acc[j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < O_NJ; ++j) {
    const int r = orow0 + j * O_RSTEP;
    if (r >= rows) break;
    out[(((size_t)b * t_len + q0 + r) * H + h) * D + od] =
        Elem<T>::from_f(acc[j] / fmaxf(l_s[r], EPS));
  }
}

template <typename T, typename KV, int D>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* table, const int* pos, void* out,
           int B, int t_len, int H, int H_kv, int ps, int p_max,
           cudaStream_t stream) {
  constexpr int BK = D <= 128 ? 128 : 64;   // keys per K/V chunk
  const size_t smem = sizeof(float) * ((size_t)TQ * (D + 4) +
                                       (size_t)BK * (D + 4) +
                                       (size_t)TQ * ps + 3 * TQ);
  auto kern = paged_decode_kernel<T, KV, D, BK>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((t_len + TQ - 1) / TQ, H, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, table, pos, static_cast<T*>(out),
      t_len, H, H_kv, ps, p_max, scale);
  return (int)cudaGetLastError();
}

// One instance per head dim; -1 for a head dim with none.
template <typename T, typename KV>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const float* ks, const float* vs, const int* table,
               const int* pos, void* out, int B, int t_len, int H, int H_kv,
               int ps, int p_max, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, KV, 64>(q, k, v, ks, vs, table, pos, out, B, t_len, H,
                               H_kv, ps, p_max, stream);
    case 128:
      return launch<T, KV, 128>(q, k, v, ks, vs, table, pos, out, B, t_len,
                                H, H_kv, ps, p_max, stream);
    case 256:
      return launch<T, KV, 256>(q, k, v, ks, vs, table, pos, out, B, t_len,
                                H, H_kv, ps, p_max, stream);
  }
  return -1;
}

}  // namespace

extern "C" {

// q [B, T, H, D]; k/v one layer's pool [N, ps, H_kv, D]; table [B, P_max]
// int32; pos [B] int32; out [B, T, H, D]. All contiguous, on one device.
// dtype: 0 = float32, 1 = bfloat16 (q, the pool and out alike). Launches on
// `stream` and returns cudaGetLastError() after the launch (0 on success),
// or -1 for a dtype/head_dim this library has no instance of.
int paged_decode(const void* q, const void* k, const void* v,
                 const void* table, const void* pos, void* out, int B,
                 int t_len, int H, int H_kv, int D, int ps, int p_max,
                 int dtype, void* stream) {
  const int* tb = static_cast<const int*>(table);
  const int* ps_ = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float, float>(D, q, k, v, nullptr, nullptr, tb, ps_,
                                    out, B, t_len, H, H_kv, ps, p_max, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(
        D, q, k, v, nullptr, nullptr, tb, ps_, out, B, t_len, H, H_kv, ps,
        p_max, s);
  return -1;
}

// paged_decode over int8 pools: k/v [N, ps, H_kv, D] int8 with row scales
// ks/vs [N, ps, H_kv] f32 (contiguous); q and out in `dtype`.
int paged_decode_int8(const void* q, const void* k, const void* v,
                      const void* ks, const void* vs, const void* table,
                      const void* pos, void* out, int B, int t_len, int H,
                      int H_kv, int D, int ps, int p_max, int dtype,
                      void* stream) {
  const int* tb = static_cast<const int*>(table);
  const int* ps_ = static_cast<const int*>(pos);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float, int8_t>(D, q, k, v, ksf, vsf, tb, ps_, out, B,
                                     t_len, H, H_kv, ps, p_max, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, int8_t>(D, q, k, v, ksf, vsf, tb, ps_,
                                             out, B, t_len, H, H_kv, ps,
                                             p_max, s);
  return -1;
}

const char* paged_decode_error_string(int code) {
  return attn::error_string(code);
}

}  // extern "C"
