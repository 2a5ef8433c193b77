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
// Instances. Kernel 6 (bf16 / f32 pages) and kernel 7 over f32 q at T > 16
// or at D = 256 run paged_decode_kernel, the CUDA-core design below. Kernel
// 7 (int8 pages) has two more, chosen by T, q's dtype and the head dim in
// the C entry point paged_decode_int8 (never after a failed launch):
// - T <= 16, either q dtype, every head dim: the split-K decode
//   (paged_split_kernel, then paged_combine_kernel);
// - T > 16, bf16 q, D = 64 or 128, pages a multiple of 64 rows: the
//   tensor-core prefill (paged_prefill_tc_kernel).
// float32 q at large T keeps the CUDA-core kernel: a TF32 product would not
// hold f32's 2e-5 against the twin, nor the card-vs-CPU f32 engine. At
// D = 256 the prefill's q tile of 128 rows (64 KB), a ring of bf16 K/V
// chunks (64 KB a slot) and their int8 staging (32 KB a slot) pass 227 KB
// of shared memory at two slots each, and its f32 O accumulator beside S
// would take every register.
//
// CUDA-core design (paged_decode_kernel). One thread block for each (slot
// b, query head h, tile of up to 64 q rows). Head h reads KV head
// h / (H / H_kv): GQA never materialises repeated KV. The block loops over
// its slot's pages, reading each page id from page_table[b, p] itself, and
// stops at the last page its own rows can see (min(ceil((pos[b] + last row
// + 1) / ps), P_max)): a page past that is fully masked for the tile, so
// skipping it changes no number, and a causal prefill tile does about half
// the work of the whole-T bound. The pool is read in its native
// [N, ps, H_kv, D] layout (one layer's view), K and V rows as 16-byte
// vectors into shared memory, converted to f32.
//
// Split-K decode (kernel 7, T <= 16). A decode call has too few (slot,
// head) pairs to fill 132 SMs and reads each page once, so the pages are
// split. The grid is (split, kv head, slot): a block takes pages_per_split
// consecutive pages of its slot for the whole GQA group of its kv head
// (g x T rows, up to four at a time), so each int8 page row is read once
// per group and pass of four rows. The split count comes from P_max and
// the SM count on the host, never from pos, which stays on the device (the
// launch stays capturable in a CUDA graph); a block past its slot's last
// needed page exits at once. Lanes take 16-byte vectors of int8 rows
// straight into registers (D / 16 lanes a row), widen and dot them in f32
// against their 16 columns of q, and sum the row over the lanes by
// shuffles: no f32 staging of K or V in shared memory. The k scale
// multiplies the score, the v scale multiplies p before p is rounded to
// q's dtype, and l sums p without it, exactly as the reference; the online
// softmax is updated once per page. Each split writes its (m, l, acc) to
// partial buffers the wrapper allocates; paged_combine_kernel (a second
// launch from the same entry point) merges a row's live splits by
// log-sum-exp and writes the output.
//
// Tensor-core prefill (kernel 7, T > 16, bf16). A block of 384 threads
// owns 128 q rows of one (slot, head): two consumer warpgroups of 64 rows
// and a producer warpgroup. One producer thread TMA-loads the q tile once,
// then the int8 K and V rows of 64-key chunks through a 4-D tensor map
// over the pool's [N, ps, H_kv, D] int8 layout, the page id (from
// page_table[b], copied to shared memory once) as the outer coordinate,
// into a staging ring of three slots. The whole producer warpgroup widens
// each staged chunk exactly into bf16 tiles in the 128-byte swizzle wgmma
// reads (a ring of three), writes the chunk's k and v scales beside them
// (loaded a chunk ahead, so their latency hides), and arrives on the
// slot's barrier. Per chunk each consumer
// warpgroup computes S = Q K8^T with wgmma (SS), scales it to
// s = S x scale x ks[key] in log2 units, carries the online softmax in
// registers across chunks, and runs O += P' V8 with P' = p x vs[key]
// rounded to bf16 as the A operand in registers (RS, V MN-major). A block
// visits chunks only up to the last key its rows can see.
//
// Bound. A decode call (T = 1) moves each needed K/V page once and does
// ~4*D flops per key per head: far below the card's ~295 flops per byte,
// so it is bound by bytes (int8 pages halve them against bf16, plus 4
// bytes of scale per row and head). The prefill at T = 1024 does ~4*D
// flops per (row, visible key, head) over a few MB: bound by operations
// on the tensor cores.
#include "attention.cuh"
#include "tc_attention.cuh"

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

// ---------------------------------------------------------------------------
// kernel 7, T <= 16: the split-K decode
// ---------------------------------------------------------------------------

constexpr int SPLIT_THREADS = 128;
constexpr int SPLIT_MAX_T = 16;    // T at or below: the split-K instance
constexpr int SPLIT_U = 4;         // 16-byte loads in flight per thread

// 16 values of a q row from 16 elements at src, as f32.
__device__ __forceinline__ void load_q16(const float* src, float (&x)[16]) {
#pragma unroll
  for (int i = 0; i < 16; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + i);
    x[i] = v.x; x[i + 1] = v.y; x[i + 2] = v.z; x[i + 3] = v.w;
  }
}
__device__ __forceinline__ void load_q16(const __nv_bfloat16* src,
                                         float (&x)[16]) {
#pragma unroll
  // a bf16 is the top half of its f32: widen by shifting the bits
  for (int i = 0; i < 16; i += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(src + i);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[i + 2 * j] = __uint_as_float(w[j] << 16);
      x[i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

// The 16 int8 of a 16-byte vector, widened exactly to f32.
__device__ __forceinline__ void widen16(const int4 u, float (&x)[16]) {
  const uint32_t w[4] = {(uint32_t)u.x, (uint32_t)u.y, (uint32_t)u.z,
                         (uint32_t)u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[4 * j + i] = (float)((int)(w[j] << (24 - 8 * i)) >> 24);
}

// One block per (split, kv head h_kv, slot b): the pages [split * pps,
// min((split + 1) * pps, needed)) of slot b for the g x T rows (head
// h_kv * g + i / T, q row i % T) of its GQA group, RC rows at a time.
// Partials, row (b * T + t) * H + head: m_part / l_part [rows][n_split],
// acc_part [rows][n_split][D], f32.
template <typename T, int D, int RC>
__global__ void __launch_bounds__(SPLIT_THREADS)
paged_split_kernel(const T* __restrict__ q, const int8_t* __restrict__ kp,
                   const int8_t* __restrict__ vp,
                   const float* __restrict__ ks, const float* __restrict__ vs,
                   const int* __restrict__ table, const int* __restrict__ pos,
                   float* __restrict__ m_part, float* __restrict__ l_part,
                   float* __restrict__ acc_part, int t_len, int H, int H_kv,
                   int ps, int p_max, int n_split, int pps, float scale) {
  constexpr int LPK = D / 16;                 // lanes per key row
  constexpr int KP = SPLIT_THREADS / LPK;     // keys per pass
  constexpr int NW = SPLIT_THREADS / 32;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int p0 = pos[b];
  const int needed = min((p0 + t_len + ps - 1) / ps, p_max);
  const int pg0 = split * pps;
  if (pg0 >= needed) return;                  // past the slot's last page
  const int pg1 = min(pg0 + pps, needed);
  const int g = H / H_kv;
  const int R = g * t_len;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kq = tid / LPK;                   // key of the pass
  const int c16 = (tid % LPK) * 16;           // this lane's 16 columns
  const size_t row_stride = (size_t)H_kv * D;

  extern __shared__ __align__(16) float smem[];
  float* s_s = smem;                          // [RC][ps] scores, then p'
  float* m_s = s_s + RC * ps;                 // [RC]
  float* l_s = m_s + RC;                      // [RC]
  float* a_s = l_s + RC;                      // [RC] this page's rescale
  float* red = a_s + RC;                      // [NW][RC][D] acc of a warp

  for (int r0 = 0; r0 < R; r0 += RC) {
    const int nr = min(RC, R - r0);
    // this lane's 16 columns of the chunk's q rows, and each row's t
    float qr[RC][16];
    int tq[RC];
#pragma unroll
    for (int rr = 0; rr < RC; ++rr) {
      const int i = r0 + min(rr, nr - 1);
      tq[rr] = i % t_len;
      const int head = hk * g + i / t_len;
      load_q16(q + (((size_t)b * t_len + tq[rr]) * H + head) * D + c16,
               qr[rr]);
    }
    if (tid < RC) {
      m_s[tid] = NEG_INF;
      l_s[tid] = 0.f;
    }
    float acc[RC][16];
#pragma unroll
    for (int rr = 0; rr < RC; ++rr)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[rr][e] = 0.f;

    for (int pg = pg0; pg < pg1; ++pg) {
      const int page = table[b * p_max + pg];
      const size_t base = (size_t)page * ps * row_stride + (size_t)hk * D;
      const int8_t* kb = kp + base + c16;
      const int8_t* vb = vp + base + c16;
      const float* ksb = ks + (size_t)page * ps * H_kv + hk;   // key k: k H_kv
      const float* vsb = vs + (size_t)page * ps * H_kv + hk;

      // scores s = (q . k) x scale x ks[key], masked to key <= pos + t
      for (int c = 0; c < ps; c += KP * SPLIT_U) {
        int4 kv[SPLIT_U];
#pragma unroll
        for (int u = 0; u < SPLIT_U; ++u) {
          const int key = c + u * KP + kq;
          kv[u] = key < ps ? *reinterpret_cast<const int4*>(
                                 kb + (size_t)key * row_stride)
                           : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < SPLIT_U; ++u) {
          const int key = c + u * KP + kq;
          float kf[16];
          widen16(kv[u], kf);
          float sd[RC];
#pragma unroll
          for (int rr = 0; rr < RC; ++rr) {
            sd[rr] = 0.f;
#pragma unroll
            for (int e = 0; e < 16; ++e)
              sd[rr] = fmaf(qr[rr][e], kf[e], sd[rr]);
#pragma unroll
            for (int o = 1; o < LPK; o <<= 1)
              sd[rr] += __shfl_xor_sync(0xffffffffu, sd[rr], o);
          }
          if (tid % LPK == 0 && key < ps) {
            const float ksc = ksb[(size_t)key * H_kv];
            const int kpos = pg * ps + key;
#pragma unroll
            for (int rr = 0; rr < RC; ++rr)
              s_s[rr * ps + key] = (rr < nr && kpos <= p0 + tq[rr])
                                       ? sd[rr] * scale * ksc : NEG_INF;
          }
        }
      }
      __syncthreads();

      // online softmax over this page, a warp per row; l takes the
      // unrounded p, the p.V product takes p x vs rounded to q's dtype
      for (int rr = warp; rr < nr; rr += NW) {
        float* sr = s_s + rr * ps;
        float mx = NEG_INF;
        for (int k = lane; k < ps; k += 32) mx = fmaxf(mx, sr[k]);
        mx = warp_max(mx);
        const float m_prev = m_s[rr];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int k = lane; k < ps; k += 32) {
          const float e = expf(sr[k] - m_new);
          sum += e;
          sr[k] = Elem<T>::round(e * vsb[(size_t)k * H_kv]);
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          a_s[rr] = alpha;
          m_s[rr] = m_new;
          l_s[rr] = l_s[rr] * alpha + sum;
        }
      }
      __syncthreads();

      // acc = acc x alpha + p' . V, this lane's 16 columns of its keys
#pragma unroll
      for (int rr = 0; rr < RC; ++rr) {
        const float alpha = rr < nr ? a_s[rr] : 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[rr][e] *= alpha;
      }
      for (int c = 0; c < ps; c += KP * SPLIT_U) {
        int4 vv[SPLIT_U];
#pragma unroll
        for (int u = 0; u < SPLIT_U; ++u) {
          const int key = c + u * KP + kq;
          vv[u] = key < ps ? *reinterpret_cast<const int4*>(
                                 vb + (size_t)key * row_stride)
                           : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < SPLIT_U; ++u) {
          const int key = c + u * KP + kq;
          if (key >= ps) continue;
          float vf[16];
          widen16(vv[u], vf);
#pragma unroll
          for (int rr = 0; rr < RC; ++rr) {
            const float pv = rr < nr ? s_s[rr * ps + key] : 0.f;
#pragma unroll
            for (int e = 0; e < 16; ++e)
              acc[rr][e] = fmaf(pv, vf[e], acc[rr][e]);
          }
        }
      }
      __syncthreads();          // before the next page overwrites s_s
    }

    // sum acc over the lanes holding the same columns: first in the warp,
    // then across the warps through shared memory
#pragma unroll
    for (int rr = 0; rr < RC; ++rr)
#pragma unroll
      for (int e = 0; e < 16; ++e)
#pragma unroll
        for (int o = LPK; o < 32; o <<= 1)
          acc[rr][e] += __shfl_xor_sync(0xffffffffu, acc[rr][e], o);
    if (lane < LPK) {
#pragma unroll
      for (int rr = 0; rr < RC; ++rr)
#pragma unroll
        for (int e = 0; e < 16; ++e)
          red[(warp * RC + rr) * D + c16 + e] = acc[rr][e];
    }
    __syncthreads();
    for (int idx = tid; idx < nr * D; idx += SPLIT_THREADS) {
      const int rr = idx / D, d = idx % D;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) v += red[(w * RC + rr) * D + d];
      const int i = r0 + rr;
      const size_t row = ((size_t)b * t_len + i % t_len) * H + hk * g +
                         i / t_len;
      acc_part[(row * n_split + split) * D + d] = v;
    }
    if (tid < nr) {
      const int i = r0 + tid;
      const size_t row = ((size_t)b * t_len + i % t_len) * H + hk * g +
                         i / t_len;
      m_part[row * n_split + split] = m_s[tid];
      l_part[row * n_split + split] = l_s[tid];
    }
    __syncthreads();            // before the next rows reuse m_s, red
  }
}

// One warp per output row (b, t, head): merge the live splits of its slot
// by log-sum-exp, out = sum_i w_i acc_i / max(sum_i w_i l_i, 1e-30) with
// w_i = exp(m_i - max_j m_j), in q's dtype.
template <typename T, int D>
__global__ void __launch_bounds__(SPLIT_THREADS)
paged_combine_kernel(const float* __restrict__ m_part,
                     const float* __restrict__ l_part,
                     const float* __restrict__ acc_part,
                     const int* __restrict__ pos, T* __restrict__ out,
                     int rows, int t_len, int H, int ps, int p_max,
                     int n_split, int pps) {
  const int row = blockIdx.x * (SPLIT_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int b = row / (t_len * H);
  const int needed = min((pos[b] + t_len + ps - 1) / ps, p_max);
  const int live = (needed + pps - 1) / pps;
  const float* mr = m_part + (size_t)row * n_split;
  const float* lr = l_part + (size_t)row * n_split;
  float mx = NEG_INF;
  for (int i = 0; i < live; ++i) mx = fmaxf(mx, mr[i]);
  float l = 0.f;
  for (int i = 0; i < live; ++i) l += expf(mr[i] - mx) * lr[i];
  const float inv_den = 1.f / fmaxf(l, EPS);
  for (int d = lane; d < D; d += 32) {
    float o = 0.f;
    for (int i = 0; i < live; ++i)
      o += expf(mr[i] - mx) * acc_part[((size_t)row * n_split + i) * D + d];
    out[(size_t)row * D + d] = Elem<T>::from_f(o * inv_den);
  }
}

template <typename T, int D, int RC>
int launch_split(const void* q, const void* k, const void* v,
                 const float* ks, const float* vs, const int* table,
                 const int* pos, void* out, float* m_part, float* l_part,
                 float* acc_part, int B, int t_len, int H, int H_kv, int ps,
                 int p_max, int n_split, int pps, cudaStream_t stream) {
  auto kern = paged_split_kernel<T, D, RC>;
  const size_t smem =
      sizeof(float) * ((size_t)RC * ps + 3 * RC +
                       (SPLIT_THREADS / 32) * (size_t)RC * D);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const float scale = (float)(1.0 / sqrt((double)D));
  kern<<<dim3(n_split, H_kv, B), SPLIT_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), ks, vs, table, pos, m_part, l_part,
      acc_part, t_len, H, H_kv, ps, p_max, n_split, pps, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rows = B * t_len * H;
  constexpr int RPB = SPLIT_THREADS / 32;     // rows a combine block
  paged_combine_kernel<T, D>
      <<<(rows + RPB - 1) / RPB, SPLIT_THREADS, 0, stream>>>(
          m_part, l_part, acc_part, pos, static_cast<T*>(out), rows, t_len,
          H, ps, p_max, n_split, pps);
  return (int)cudaGetLastError();
}

// Rows handled together: the GQA group's g x T rows, at most four (each
// lane keeps 16 columns of q and of acc per row in registers).
template <typename T, int D>
int split_rc(int R, const void* q, const void* k, const void* v,
             const float* ks, const float* vs, const int* table,
             const int* pos, void* out, float* m_part, float* l_part,
             float* acc_part, int B, int t_len, int H, int H_kv, int ps,
             int p_max, int n_split, int pps, cudaStream_t stream) {
  if (R == 1)
    return launch_split<T, D, 1>(q, k, v, ks, vs, table, pos, out, m_part,
                                 l_part, acc_part, B, t_len, H, H_kv, ps,
                                 p_max, n_split, pps, stream);
  if (R == 2)
    return launch_split<T, D, 2>(q, k, v, ks, vs, table, pos, out, m_part,
                                 l_part, acc_part, B, t_len, H, H_kv, ps,
                                 p_max, n_split, pps, stream);
  return launch_split<T, D, 4>(q, k, v, ks, vs, table, pos, out, m_part,
                               l_part, acc_part, B, t_len, H, H_kv, ps,
                               p_max, n_split, pps, stream);
}

template <typename T>
int split_d(int D, int R, const void* q, const void* k, const void* v,
            const float* ks, const float* vs, const int* table,
            const int* pos, void* out, float* m_part, float* l_part,
            float* acc_part, int B, int t_len, int H, int H_kv, int ps,
            int p_max, int n_split, int pps, cudaStream_t stream) {
  switch (D) {
    case 64:
      return split_rc<T, 64>(R, q, k, v, ks, vs, table, pos, out, m_part,
                             l_part, acc_part, B, t_len, H, H_kv, ps, p_max,
                             n_split, pps, stream);
    case 128:
      return split_rc<T, 128>(R, q, k, v, ks, vs, table, pos, out, m_part,
                              l_part, acc_part, B, t_len, H, H_kv, ps, p_max,
                              n_split, pps, stream);
    case 256:
      return split_rc<T, 256>(R, q, k, v, ks, vs, table, pos, out, m_part,
                              l_part, acc_part, B, t_len, H, H_kv, ps, p_max,
                              n_split, pps, stream);
  }
  return ERR_NO_INSTANCE;
}

// ---------------------------------------------------------------------------
// kernel 7, T > 16, bf16 q: the tensor-core prefill
// ---------------------------------------------------------------------------

constexpr int PF_BM = 128;              // q rows per block
constexpr int PF_BK = 64;               // keys per chunk (a page holds ps/64)
constexpr int PF_THREADS = 3 * tc::WG;  // two consumer warpgroups, producer's
constexpr int PF_PRODUCER_REGS = 40;    // it widens, so more than 24
constexpr int PF_CONSUMER_REGS = 232;   // 2 x 232 + 40 <= 504

template <int D> struct PfTile {
  static constexpr int ST = 3;                     // bf16 ring slots
  static constexpr int SST = 3;                    // int8 staging slots
  static constexpr int PN = D / 64;                // 64-wide head-dim panels
  static constexpr int Q_BYTES = PF_BM * D * 2;
  static constexpr int KV_BYTES = PF_BK * D * 2;   // one bf16 K or V chunk
  static constexpr int SLOT = 2 * KV_BYTES;        // K and V (1 KB multiple)
  static constexpr int I8_BYTES = PF_BK * D;       // one int8 K or V chunk
  static constexpr int STAGE = 2 * I8_BYTES;
  // + the slot's page ids (p_max ints), added at launch
  static constexpr int SMEM = Q_BYTES + ST * SLOT + SST * STAGE +
                              ST * 2 * PF_BK * 4 + 64 * 8 + 1024;
};

// 16 int8 of row r, columns c .. c + 15, widened exactly to bf16 into a
// [PN][PF_BK][64] tile in the 128-byte swizzle (two 16-byte chunks).
__device__ __forceinline__ void widen_to_tile(const int8_t* src,
                                              uint8_t* tile, int r, int c) {
  const int4 u = *reinterpret_cast<const int4*>(src);
  const uint32_t w[4] = {(uint32_t)u.x, (uint32_t)u.y, (uint32_t)u.z,
                         (uint32_t)u.w};
  uint32_t o[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int x0 = (int)(w[j] << 24) >> 24, x1 = (int)(w[j] << 16) >> 24;
    const int x2 = (int)(w[j] << 8) >> 24, x3 = (int)w[j] >> 24;
    o[2 * j] = tc::pack_bf16((float)x0, (float)x1);
    o[2 * j + 1] = tc::pack_bf16((float)x2, (float)x3);
  }
  uint8_t* pb = tile + (c / 64) * PF_BK * tc::ROW_BYTES;
  const int col = c % 64;
  *reinterpret_cast<uint4*>(pb + tc::swz128(r, col)) =
      make_uint4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<uint4*>(pb + tc::swz128(r, col + 8)) =
      make_uint4(o[4], o[5], o[6], o[7]);
}

// Grid (q tiles, H, B), the tiles with the most keys first.
template <int D>
__global__ void __launch_bounds__(PF_THREADS, 1)
paged_prefill_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ table,
                        const int* __restrict__ pos,
                        __nv_bfloat16* __restrict__ out, int t_len, int H,
                        int H_kv, int ps, int p_max, float scale) {
  using Tile = PfTile<D>;
  constexpr int ST = Tile::ST, SST = Tile::SST, PN = Tile::PN, BK = PF_BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = tc::align1024(smem_raw);            // [PN][PF_BM][64]
  uint8_t* ring = q_s + Tile::Q_BYTES;               // [ST] x {K, V} bf16
  int8_t* stage = reinterpret_cast<int8_t*>(ring + ST * Tile::SLOT);
                                                     // [SST] x {K, V}[BK][D]
  float* scl = reinterpret_cast<float*>(stage + SST * Tile::STAGE);
                                                     // [ST] x {ks, vs}[BK]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(scl + ST * 2 * BK);
  uint64_t* full = q_full + 1;                       // [ST] widened
  uint64_t* empty = full + ST;                       // [ST] multiplied
  uint64_t* st_full = empty + ST;                    // [SST] staged
  int* pages = reinterpret_cast<int*>(st_full + SST);  // the slot's page ids

  const int n_qt = (t_len + PF_BM - 1) / PF_BM;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * PF_BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / H_kv);
  const int p0 = pos[b];
  const int rows = min(PF_BM, t_len - q0);
  // keys any row of this block can see, within the slot's P_max pages
  const int n_keys = min(p0 + q0 + rows, p_max * ps);
  const int n_chunks = (n_keys + BK - 1) / BK;

  if (threadIdx.x == 0) {
    tc::bar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      tc::bar_init(&full[s], tc::WG);   // every producer thread
      tc::bar_init(&empty[s], 2);       // one arrival per consumer warpgroup
    }
    for (int s = 0; s < SST; ++s) tc::bar_init(&st_full[s], 1);
    tc::bar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= 8) {
    tc::regs_dec<PF_PRODUCER_REGS>();
    const int pt = threadIdx.x - 2 * tc::WG;
    // the page ids this block reads, once, into shared memory
    const int n_pg = (n_keys + ps - 1) / ps;
    for (int i = pt; i < n_pg; i += tc::WG) pages[i] = table[b * p_max + i];
    tc::named_sync(1, tc::WG);
    // chunk j: 64 rows of page pages[j * 64 / ps], from row j * 64 % ps
    auto issue = [&](int j) {
      const int key0 = j * BK;
      int8_t* k8 = stage + (j % SST) * Tile::STAGE;
      uint64_t* bar = &st_full[j % SST];
      tc::fence_async_smem();
      tc::bar_expect_tx(bar, Tile::STAGE);
      tc::tma_load(k8, &tm_k, bar, 0, hk, key0 % ps, pages[key0 / ps]);
      tc::tma_load(k8 + Tile::I8_BYTES, &tm_v, bar, 0, hk, key0 % ps,
                   pages[key0 / ps]);
    };
    if (pt == 0) {
      tc::bar_expect_tx(q_full, Tile::Q_BYTES);
      for (int p = 0; p < PN; ++p)
        tc::tma_load(q_s + p * PF_BM * tc::ROW_BYTES, &tm_q, q_full, 64 * p,
                     h, q0, b);
      for (int j = 0; j < min(SST, n_chunks); ++j) issue(j);
    }
    // each chunk's k and v scales, loaded one chunk ahead (their latency
    // hides behind the widening of the chunk before)
    auto scale_at = [&](int j) {
      const int key0 = j * BK;
      return ((size_t)pages[key0 / ps] * ps + key0 % ps + pt) * H_kv + hk;
    };
    float k_next = 0.f, v_next = 0.f;
    if (pt < BK && n_chunks > 0) {
      k_next = ks[scale_at(0)];
      v_next = vs[scale_at(0)];
    }
    for (int j = 0; j < n_chunks; ++j) {
      const int s = j % ST;
      const float k_sc = k_next, v_sc = v_next;
      if (pt < BK && j + 1 < n_chunks) {
        k_next = ks[scale_at(j + 1)];
        v_next = vs[scale_at(j + 1)];
      }
      const int8_t* k8 = stage + (j % SST) * Tile::STAGE;
      const int8_t* v8 = k8 + Tile::I8_BYTES;
      uint8_t* kt = ring + s * Tile::SLOT;
      uint8_t* vt = kt + Tile::KV_BYTES;
      tc::bar_wait(&st_full[j % SST], (j / SST) & 1);
      if (j >= ST) tc::bar_wait(&empty[s], ((j / ST) - 1) & 1);
      for (int v = pt; v < BK * D / 16; v += tc::WG) {
        const int r = v / (D / 16), c = (v % (D / 16)) * 16;
        widen_to_tile(k8 + r * D + c, kt, r, c);
        widen_to_tile(v8 + r * D + c, vt, r, c);
      }
      if (pt < BK) {
        float* sc = scl + s * 2 * BK;
        sc[pt] = k_sc;
        sc[BK + pt] = v_sc;
      }
      tc::fence_async_smem();           // the tiles, before wgmma reads them
      tc::bar_arrive(&full[s]);
      tc::named_sync(1, tc::WG);        // every thread is done with stage j
      if (pt == 0 && j + SST < n_chunks) issue(j + SST);
    }
    return;
  }

  tc::regs_inc<PF_CONSUMER_REGS>();
  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63; scores and the
  // running max in log2 units (x log2(e)), the reference's -1e30 with them
  const int wg = warp / 4;
  const int t = threadIdx.x % tc::WG;
  const int lane = t % 32;
  const int cq = 2 * (lane % 4);               // columns 8 n + cq + {0, 1}
  const int row0 = q0 + 64 * wg;
  const int r = row0 + 16 * (t / 32) + lane / 4;   // fragment rows r, r + 8
  const uint32_t q_addr = tc::smem_u32(q_s) + 64 * wg * tc::ROW_BYTES;
  const float neg2 = NEG_INF * tc::LOG2E;

  float o[D / 2];
#pragma unroll
  for (int k = 0; k < D / 2; ++k) o[k] = 0.f;
  float m[2] = {neg2, neg2}, l[2] = {0.f, 0.f};

  tc::bar_wait(q_full, 0);
  for (int j = 0; j < n_chunks; ++j) {
    const int s = j % ST;
    const uint32_t ph = (j / ST) & 1;
    const int c0 = j * BK;
    const uint32_t k_addr = tc::smem_u32(ring + s * Tile::SLOT);
    const uint32_t v_addr = k_addr + Tile::KV_BYTES;
    const float* ksc = scl + s * 2 * BK;
    const float* vsc = ksc + BK;

    // S = Q K8^T over D in k16 steps
    float sc[BK / 2];
    tc::bar_wait(&full[s], ph);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;          // 16 values into the row
      tc::WgmmaSS<BK>::mma(
          sc,
          tc::desc(q_addr + (kk / 4) * PF_BM * tc::ROW_BYTES + off, 16, 1024),
          tc::desc(k_addr + (kk / 4) * BK * tc::ROW_BYTES + off, 16, 1024),
          kk > 0);
    }
    tc::wg_commit();
    tc::wg_wait();
    tc::reg_fence(sc);

    // s = S x scale x ks[key] (log2 units); keys past pos + row masked
    // only where the chunk reaches past the warpgroup's first row
    const bool masked = c0 + BK - 1 > p0 + row0;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float2 kv = *reinterpret_cast<const float2*>(ksc + 8 * n + cq);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int key = c0 + 8 * n + cq + jj;
        const float ks2 = (jj ? kv.y : kv.x) * tc::LOG2E;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int idx = 4 * n + 2 * k + jj;
          float v = sc[idx] * scale * ks2;
          if (masked && key > p0 + r + 8 * k) v = neg2;
          sc[idx] = v;
          mx[k] = fmaxf(mx[k], v);
        }
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], 1));
      mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], 2));
      mx[k] = fmaxf(mx[k], m[k]);
      alpha[k] = tc::ex2(m[k] - mx[k]);
      m[k] = mx[k];
    }
    // p = 2^(s - m): l sums it, P.V takes p x vs[key]
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float2 vv = *reinterpret_cast<const float2*>(vsc + 8 * n + cq);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int idx = 4 * n + 2 * k + jj;
          const float p = tc::ex2(sc[idx] - m[k]);
          rs[k] += p;
          sc[idx] = p * (jj ? vv.y : vv.x);
        }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) l[k] = l[k] * alpha[k] + rs[k];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) tc::to_a(sc, kk, pa[kk]);
#pragma unroll
    for (int k = 0; k < D / 2; ++k) o[k] *= alpha[(k / 2) % 2];

    // O += P' V8 over the chunk's keys in k16 steps, V read MN-major
    tc::reg_fence(o);
    tc::reg_fence(pa);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      tc::WgmmaRS<D>::mma(
          o, pa[kk],
          tc::desc(v_addr + kk * 16 * tc::ROW_BYTES, BK * tc::ROW_BYTES,
                   1024));
    tc::wg_commit();
    tc::wg_wait();
    tc::reg_fence(o);
    if (t == 0) tc::bar_arrive(&empty[s]);
  }

  // out = O / max(l, 1e-30) in bf16, [B, T, H, D]
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    l[k] += __shfl_xor_sync(0xffffffffu, l[k], 1);
    l[k] += __shfl_xor_sync(0xffffffffu, l[k], 2);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int row = r + 8 * k;
    if (row >= t_len) continue;
    const float inv = __frcp_rn(fmaxf(l[k], EPS));
    __nv_bfloat16* orow = out + (((size_t)b * t_len + row) * H + h) * D + cq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          tc::pack_bf16(o[4 * n + 2 * k] * inv, o[4 * n + 2 * k + 1] * inv);
  }
}

template <int D>
int launch_prefill_tc(const void* q, const void* k, const void* v,
                      const float* ks, const float* vs, const int* table,
                      const int* pos, void* out, int B, int t_len, int H,
                      int H_kv, int ps, int p_max, int n_pages,
                      cudaStream_t stream) {
  using Tile = PfTile<D>;
  if (B == 0 || t_len == 0 || H == 0) return 0;
  CUtensorMap mq, mk, mv;
  int e = tc::make_map(&mq, q, B, t_len, H, D, (long long)t_len * H * D,
                       (long long)H * D, D, PF_BM);
  // the pool [N, ps, H_kv, D] int8: boxes of 64 rows of one page and kv
  // head, unswizzled (the producer widens them into the swizzled tiles)
  for (int i = 0; i < 2 && e == 0; ++i)
    e = tc::make_map_4d(i ? &mv : &mk, i ? v : k,
                        CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, H_kv, ps,
                        n_pages, D, (long long)H_kv * D,
                        (long long)ps * H_kv * D, D, PF_BK,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != 0) return e;
  auto kern = paged_prefill_tc_kernel<D>;
  const int smem = Tile::SMEM + 4 * p_max;
  cudaError_t ce = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (ce != cudaSuccess) return (int)ce;
  const float scale = (float)(1.0 / sqrt((double)D));
  kern<<<dim3((t_len + PF_BM - 1) / PF_BM, H, B), PF_THREADS, smem,
         stream>>>(mq, mk, mv, ks, vs, table, pos,
                   static_cast<__nv_bfloat16*>(out), t_len, H, H_kv, ps,
                   p_max, scale);
  return (int)cudaGetLastError();
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

// paged_decode over int8 pools: k/v [N, ps, H_kv, D] int8 (n_pages = N)
// with row scales ks/vs [N, ps, H_kv] f32 (contiguous); q and out in
// `dtype`. The instance is chosen here, by T, dtype and head dim:
//  - T <= 16: the split-K decode over n_split splits of pps pages each
//    (n_split = ceil(P_max / pps)), its partials in m_part, l_part
//    [B * T * H, n_split] and acc_part [B * T * H, n_split, D] f32, which
//    the caller allocates; *instance = 1;
//  - T > 16, bfloat16, D = 64 or 128, ps a multiple of 64: the tensor-core
//    prefill; *instance = 2;
//  - otherwise the CUDA-core kernel; *instance = 0.
// Returns as paged_decode; ERR_SCRATCH when the split-K instance is chosen
// and a partial buffer is null.
int paged_decode_int8(const void* q, const void* k, const void* v,
                      const void* ks, const void* vs, const void* table,
                      const void* pos, void* out, void* m_part, void* l_part,
                      void* acc_part, int B, int t_len, int H, int H_kv,
                      int D, int ps, int p_max, int n_pages, int n_split,
                      int pps, int dtype, int* instance, void* stream) {
  *instance = 0;
  const int* tb = static_cast<const int*>(table);
  const int* ps_ = static_cast<const int*>(pos);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return -1;
  if (t_len <= SPLIT_MAX_T) {
    if (!m_part || !l_part || !acc_part || n_split < 1 || pps < 1)
      return attn::ERR_SCRATCH;
    if (B == 0 || t_len == 0 || H == 0) return 0;
    float* mp = static_cast<float*>(m_part);
    float* lp = static_cast<float*>(l_part);
    float* ap = static_cast<float*>(acc_part);
    const int R = (H / H_kv) * t_len;
    const int e =
        dtype == 0
            ? split_d<float>(D, R, q, k, v, ksf, vsf, tb, ps_, out, mp, lp,
                             ap, B, t_len, H, H_kv, ps, p_max, n_split, pps,
                             s)
            : split_d<__nv_bfloat16>(D, R, q, k, v, ksf, vsf, tb, ps_, out,
                                     mp, lp, ap, B, t_len, H, H_kv, ps,
                                     p_max, n_split, pps, s);
    if (e == 0) *instance = 1;
    return e;
  }
  if (dtype == 1 && (D == 64 || D == 128) && ps % PF_BK == 0) {
    const int e =
        D == 64 ? launch_prefill_tc<64>(q, k, v, ksf, vsf, tb, ps_, out, B,
                                        t_len, H, H_kv, ps, p_max, n_pages, s)
                : launch_prefill_tc<128>(q, k, v, ksf, vsf, tb, ps_, out, B,
                                         t_len, H, H_kv, ps, p_max, n_pages,
                                         s);
    if (e == 0) *instance = 2;
    return e;
  }
  if (dtype == 0)
    return dispatch_d<float, int8_t>(D, q, k, v, ksf, vsf, tb, ps_, out, B,
                                     t_len, H, H_kv, ps, p_max, s);
  return dispatch_d<__nv_bfloat16, int8_t>(D, q, k, v, ksf, vsf, tb, ps_,
                                           out, B, t_len, H, H_kv, ps, p_max,
                                           s);
}

const char* paged_decode_error_string(int code) {
  return attn::error_string(code);
}

}  // extern "C"
