// Paged attention over the continuous-batching engine's KV pool, for NVIDIA
// Hopper (sm_90a): kernels 6 and 7 of the port.
//
// Replaces the Pallas TPU kernels _paged_decode_kernel (kernel 6, bf16/f32
// pages) and _paged_decode_kernel_int8 (kernel 7, int8 pages), both in
// paddle_tpu/ops/paged_attention.py, launched by paged_flash_decode /
// paged_flash_decode_int8. It computes the same function: q rows of slot b
// attend that slot's pages through the page table; row j sees virtual
// positions <= pos[b] + j; scores are f32 dots times 1/sqrt(D), masked with
// -1e30; an online softmax (m, l, acc) carries across pages in f32; p is
// rounded to V's dtype before p.V, accumulated in f32; the output is
// acc / max(l, 1e-30) in q's dtype. Over int8 pages each K/V row carries an
// f32 scale ([N, ps, H_kv]): int8 values widen exactly, the k scale
// multiplies the score after the dot, and the v scale multiplies p before p
// is rounded to q's dtype, while l sums p without it, as the TPU kernel
// does. The plain PyTorch twins (paged_decode_reference and its split-K and
// chunked forms) repeat the same arithmetic.
//
// Instances, chosen in the entry points paged_decode and paged_decode_int8
// (paged_entry) by T, q's dtype, the page dtype and the head dim (never
// after a failed launch), the same rule for both kernels:
// - T <= 16, every dtype and head dim: the split-K decode of
//   kv_attention.cuh (split_kernel, its partials merged by the last split
//   of each slot and kv head to finish);
// - T > 16, bf16 q, D = 64 or 128, pages a multiple of 64 rows: the
//   tensor-core prefill of kv_attention.cuh (prefill_tc_kernel), bf16 pages
//   TMA-loaded straight into wgmma's swizzle, int8 pages widened on the way;
// - otherwise (float32 q at T > 16, where a TF32 product would not hold
//   f32's 2e-5 against the twin, nor the card-vs-CPU f32 engine; D = 256,
//   whose q tile, ring and f32 O accumulator pass the shared memory and
//   registers a block has; pages not a multiple of 64 rows) the CUDA-core
//   kernel below.
//
// CUDA-core design (paged_decode_kernel). One thread block for each (slot
// b, query head h, tile of up to 64 q rows). Head h reads KV head
// h / (H / H_kv): GQA never materialises repeated KV. The block loops over
// its slot's pages, reading each page id from page_table[b, p] itself, and
// over each page in chunks of 64 keys, stopping at the last key its own
// rows can see: the score tile is 64 x 64 f32 whatever the page size, so
// the launch's shared memory does not grow with ps. The online softmax is
// updated once per chunk (twin: paged_decode_reference with chunk=64; a
// chunk past every row's last key would change no number, since key 0 is
// visible to every row). The pool is read in its native [N, ps, H_kv, D]
// layout (one layer's view), K and V rows as 16-byte vectors into shared
// memory, converted to f32; the dots run on CUDA cores in f32.
//
// Prefill padding: with valid [B] (the engine's real prompt lengths) every
// instance writes zeros to the rows t >= valid[b] and skips q tiles that
// hold only such rows (kv_attention.cuh).
//
// Bound. A decode call (T = 1) moves each needed K/V page once and does
// ~4*D flops per key per head: far below the card's ~295 flops per byte, so
// it is bound by bytes (int8 pages halve them, plus 4 bytes of scale per row
// and head). The prefill at T = 1024 does ~4*D flops per (row, visible key,
// head) over a few MB: bound by operations on the tensor cores.
#include "kv_attention.cuh"

namespace {

// element loaders, warp reductions, load_rows and the tile constants
using namespace attn;

constexpr int CK = 64;          // keys a chunk of the CUDA-core kernel

template <typename T, typename KV, int D>
// D = 64: two blocks per SM (128 registers a thread); wider heads are held
// to one block by shared memory, so they keep the registers instead
__global__ void __launch_bounds__(NT, D <= 64 ? 2 : 1)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                    const KV* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ table,
                    const int* __restrict__ pos,
                    const int* __restrict__ valid, T* __restrict__ out,
                    int t_len, int H, int H_kv, int ps, int p_max,
                    float scale) {
  constexpr bool INT8 = sizeof(KV) == 1;  // ks / vs: [N, ps, H_kv] f32
  constexpr int DP = D + 4;             // padded smem row: float4 reads
                                        // by neighbouring keys hit
                                        // distinct banks
  constexpr int S_RSTEP = NT / CK;      // score tile: thread -> one key,
  constexpr int S_NJ = TQ / S_RSTEP;    //   rows rg + j * S_RSTEP
  constexpr int O_RSTEP = NT / D;       // output tile: thread -> one
  constexpr int O_NJ = TQ / O_RSTEP;    //   column, rows orow0 + j * O_RSTEP

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // [TQ][DP]  q tile (f32)
  float* kv_s = q_s + TQ * DP;          // [CK][DP]  K or V chunk (f32)
  float* s_s = kv_s + CK * DP;          // [TQ][CK]  scores, then p
  float* m_s = s_s + TQ * CK;           // [TQ]      running max
  float* l_s = m_s + TQ;                // [TQ]      running normalizer
  float* a_s = l_s + TQ;                // [TQ]      this chunk's rescale

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = min(TQ, t_len - q0);
  const int n_valid = kv::rows_valid(valid, b, t_len);
  if (q0 >= n_valid) {                  // padding only: zeros, nothing read
    kv::zero_rows<T, D>(out, b, q0, rows, t_len, H, h, tid, NT);
    return;
  }
  const int hk = h / (H / H_kv);
  const int p0 = pos[b];
  // keys the tile's real rows can see (rows p0+q0 .. up to valid), within
  // the slot's P_max pages
  const int n_end = min(p0 + min(q0 + rows, n_valid), p_max * ps);
  const int needed = (n_end + ps - 1) / ps;
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
  const int key = tid % CK, rg = tid / CK;
  const int warp = tid / 32, lane = tid % 32;
  __syncthreads();

  for (int p = 0; p < needed; ++p) {
    const int page = table[b * p_max + p];
    const size_t base = (size_t)page * ps * row_stride + (size_t)hk * D;
    // row scales of this page and kv head: sc0 + key * H_kv
    const size_t sc0 = (size_t)page * ps * H_kv + hk;
    for (int c0 = 0; c0 < ps && p * ps + c0 < n_end; c0 += CK) {
      const int n = min(CK, ps - c0);

      // scores: s = (q . k) * scale [* k scale], masked to k_pos <= pos+row
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
          s_s[r * CK + key] = kpos <= p0 + q0 + r ? sc : NEG_INF;
        }
      }
      __syncthreads();

      // online softmax over this chunk, one warp per row; l takes the
      // unrounded p, the p.V product takes p [times the v scale] rounded
      // to q's dtype
      for (int r = warp; r < rows; r += NT / 32) {
        float* sr = s_s + r * CK;
        float mx = NEG_INF;
        for (int k = lane; k < n; k += 32) mx = fmaxf(mx, sr[k]);
        mx = warp_max(mx);
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int k = lane; k < n; k += 32) {
          const float e = expf(sr[k] - m_new);
          sum += e;
          sr[k] = Elem<T>::round(
              INT8 ? e * vs[sc0 + (size_t)(c0 + k) * H_kv] : e);
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          a_s[r] = alpha;
          m_s[r] = m_new;
          l_s[r] = l_s[r] * alpha + sum;
        }
      }
      // the K chunk is read: its V rows take its place
      load_rows<KV, D, DP>(vp + base + (size_t)c0 * row_stride, row_stride,
                           n, kv_s);
      __syncthreads();

      // acc = acc * alpha + p . V, four keys at a time (one 16-byte read
      // of p per row)
#pragma unroll
      for (int j = 0; j < O_NJ; ++j) {
        const int r = orow0 + j * O_RSTEP;
        if (r >= rows) break;
        acc[j] *= a_s[r];
      }
      const int n4 = n & ~3;
      for (int k = 0; k < n4; k += 4) {
        const float v0 = kv_s[k * DP + od], v1 = kv_s[(k + 1) * DP + od];
        const float v2 = kv_s[(k + 2) * DP + od];
        const float v3 = kv_s[(k + 3) * DP + od];
#pragma unroll
        for (int j = 0; j < O_NJ; ++j) {
          const int r = orow0 + j * O_RSTEP;
          if (r >= rows) break;
          const float4 p4 = *reinterpret_cast<const float4*>(s_s + r * CK + k);
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
          acc[j] = fmaf(s_s[r * CK + k], v, acc[j]);
        }
      }
      __syncthreads();
    }
  }

  // rows past valid: zeros
#pragma unroll
  for (int j = 0; j < O_NJ; ++j) {
    const int r = orow0 + j * O_RSTEP;
    if (r >= rows) break;
    out[(((size_t)b * t_len + q0 + r) * H + h) * D + od] = Elem<T>::from_f(
        q0 + r < n_valid ? acc[j] / fmaxf(l_s[r], EPS) : 0.f);
  }
}

template <typename T, typename KV, int D>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* table, const int* pos,
           const int* valid, void* out, int B, int t_len, int H, int H_kv,
           int ps, int p_max, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)TQ * (D + 4) +
                                       (size_t)CK * (D + 4) +
                                       (size_t)TQ * CK + 3 * TQ);
  auto kern = paged_decode_kernel<T, KV, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || t_len == 0 || H == 0) return 0;
  const dim3 grid((t_len + TQ - 1) / TQ, H, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, table, pos, valid,
      static_cast<T*>(out), t_len, H, H_kv, ps, p_max, scale);
  return (int)cudaGetLastError();
}

// One instance per head dim; -1 for a head dim with none.
template <typename T, typename KV>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const float* ks, const float* vs, const int* table,
               const int* pos, const int* valid, void* out, int B, int t_len,
               int H, int H_kv, int ps, int p_max, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, KV, 64>(q, k, v, ks, vs, table, pos, valid, out, B,
                               t_len, H, H_kv, ps, p_max, stream);
    case 128:
      return launch<T, KV, 128>(q, k, v, ks, vs, table, pos, valid, out, B,
                                t_len, H, H_kv, ps, p_max, stream);
    case 256:
      return launch<T, KV, 256>(q, k, v, ks, vs, table, pos, valid, out, B,
                                t_len, H, H_kv, ps, p_max, stream);
  }
  return ERR_NO_INSTANCE;
}

// The three instances over pages of KV for q (and out) of T.
template <typename T, typename KV>
int paged_instances(const kv::SplitArgs& sa, int D, int dtype, int n_pages,
                    int* instance, cudaStream_t s) {
  const kv::KvSrc& src = sa.src;
  if (sa.t_len <= kv::SPLIT_MAX_T) {
    const int e = kv::launch_split<T, KV, true>(D, sa, s);
    if (e == 0) *instance = 1;
    return e;
  }
  if constexpr (sizeof(T) == 2) {
    if (kv::prefill_tc_takes(dtype, D, src.ps)) {
      kv::PrefillArgs pa{src, sa.pos, sa.valid,
                         static_cast<__nv_bfloat16*>(sa.out), sa.t_len,
                         sa.H, sa.H_kv, sa.scale};
      const int e = kv::launch_prefill_tc<KV, true>(
          D, sa.q, sa.q_sb, sa.q_ss, sa.q_sh, pa, sa.B, n_pages, s);
      if (e == 0) *instance = 2;
      return e;
    }
  }
  return dispatch_d<T, KV>(D, sa.q, src.k, src.v, src.ks, src.vs, src.table,
                           sa.pos, sa.valid, sa.out, sa.B, sa.t_len, sa.H,
                           sa.H_kv, src.ps, src.p_max, s);
}

// The arguments both entry points fill in; kv_dtype 0 = float32,
// 1 = bfloat16 (q's dtype), 2 = int8 with row scales ks/vs.
int paged_entry(const void* q, const void* k, const void* v, const void* ks,
                const void* vs, const void* table, const void* pos,
                const void* valid, void* out, void* m_part, void* l_part,
                void* acc_part, void* tickets, int B, int t_len, int H,
                int H_kv, int D, int ps, int p_max, int n_pages, int n_split,
                int pps, int dtype, int kv_dtype, int* instance,
                void* stream) {
  *instance = 0;
  if (dtype != 0 && dtype != 1) return ERR_NO_INSTANCE;
  kv::SplitArgs sa{};
  sa.q = q;
  sa.q_sh = D;
  sa.q_ss = (long long)H * D;
  sa.q_sb = (long long)t_len * H * D;
  kv::KvSrc& src = sa.src;
  src.k = k;
  src.v = v;
  src.ks = static_cast<const float*>(ks);
  src.vs = static_cast<const float*>(vs);
  src.table = static_cast<const int*>(table);
  src.s_head = D;
  src.s_row = (long long)H_kv * D;
  src.s_page = (long long)ps * H_kv * D;
  src.ps = ps;
  src.p_max = p_max;
  src.n_keys = p_max * ps;
  src.pos_sb = 1;
  sa.pos = static_cast<const int*>(pos);
  sa.valid = static_cast<const int*>(valid);
  sa.m_part = static_cast<float*>(m_part);
  sa.l_part = static_cast<float*>(l_part);
  sa.acc_part = static_cast<float*>(acc_part);
  sa.tickets = static_cast<int*>(tickets);
  sa.out = out;
  sa.B = B;
  sa.t_len = t_len;
  sa.H = H;
  sa.H_kv = H_kv;
  sa.n_split = n_split;
  sa.pps = pps;
  sa.scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 2)
    return dtype == 0
               ? paged_instances<float, int8_t>(sa, D, dtype, n_pages,
                                                instance, s)
               : paged_instances<__nv_bfloat16, int8_t>(sa, D, dtype,
                                                        n_pages, instance, s);
  return dtype == 0
             ? paged_instances<float, float>(sa, D, dtype, n_pages, instance,
                                             s)
             : paged_instances<__nv_bfloat16, __nv_bfloat16>(
                   sa, D, dtype, n_pages, instance, s);
}

}  // namespace

extern "C" {

// Kernel 6. q [B, T, H, D] and out [B, T, H, D] contiguous in `dtype`
// (0 = float32, 1 = bfloat16); k/v one layer's pool [N, ps, H_kv, D] in
// q's dtype (n_pages = N); table [B, P_max] int32; pos [B] int32; valid [B]
// int32 real rows per slot (rows past it are written as zeros) or null. All
// contiguous, on one device. The instance is chosen here, by T, dtype and
// head dim:
//  - T <= 16: the split-K decode over n_split splits of pps pages each
//    (n_split = ceil(P_max / pps)), its partials in m_part, l_part
//    [B * T * H, n_split] and acc_part [B * T * H, n_split, D] f32 and its
//    tickets [B * H_kv] int32 (zero, and left zero), which the caller
//    allocates, merged by the last split of each (slot, kv head) to
//    finish; *instance = 1;
//  - T > 16, bfloat16, D = 64 or 128, ps a multiple of 64: the tensor-core
//    prefill; *instance = 2;
//  - otherwise the CUDA-core kernel; *instance = 0.
// Launches on `stream` and returns cudaGetLastError() after the launch (0
// on success), ERR_NO_INSTANCE (-1) for a dtype/head_dim without an
// instance, ERR_SCRATCH when the split-K instance is chosen and a partial
// buffer or the tickets are null, ERR_TENSOR_MAP when a tensor map is
// refused.
int paged_decode(const void* q, const void* k, const void* v,
                 const void* table, const void* pos, const void* valid,
                 void* out, void* m_part, void* l_part, void* acc_part,
                 void* tickets, int B, int t_len, int H, int H_kv, int D,
                 int ps, int p_max, int n_pages, int n_split, int pps,
                 int dtype, int* instance, void* stream) {
  return paged_entry(q, k, v, nullptr, nullptr, table, pos, valid, out,
                     m_part, l_part, acc_part, tickets, B, t_len, H, H_kv, D,
                     ps, p_max, n_pages, n_split, pps, dtype, dtype, instance,
                     stream);
}

// Kernel 7: paged_decode over int8 pools, k/v [N, ps, H_kv, D] int8 with
// row scales ks/vs [N, ps, H_kv] f32 (contiguous); q and out in `dtype`.
// Same instances and returns.
int paged_decode_int8(const void* q, const void* k, const void* v,
                      const void* ks, const void* vs, const void* table,
                      const void* pos, const void* valid, void* out,
                      void* m_part, void* l_part, void* acc_part,
                      void* tickets, int B, int t_len, int H, int H_kv,
                      int D, int ps, int p_max, int n_pages, int n_split,
                      int pps, int dtype, int* instance, void* stream) {
  return paged_entry(q, k, v, ks, vs, table, pos, valid, out, m_part, l_part,
                     acc_part, tickets, B, t_len, H, H_kv, D, ps, p_max,
                     n_pages, n_split, pps, dtype, 2, instance, stream);
}

const char* paged_decode_error_string(int code) {
  return attn::error_string(code);
}

}  // extern "C"
