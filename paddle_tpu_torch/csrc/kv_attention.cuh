// Attention of q rows over a KV cache, paged or dense, for NVIDIA Hopper
// (sm_90a): the split-K decode and the tensor-core prefill that kernels 5, 6
// and 7 of the port instantiate (flash_decode.cu: kernel 5 over a dense int8
// cache; paged_decode.cu: kernels 6 and 7 over bf16/f32 and int8 pages).
//
// The function is the one the Pallas kernels compute (_decode_kernel_int8 in
// paddle_tpu/ops/flash_attention.py; _paged_decode_kernel and
// _paged_decode_kernel_int8 in paddle_tpu/ops/paged_attention.py): q row j of
// slot b attends the slot's keys at positions <= pos + j; scores are f32
// dots times 1/sqrt(D), int8 keys times their row scale after the dot,
// masked with -1e30; an online softmax (m, l, acc) in f32; l sums the
// unrounded p, while p.V takes p (int8: times the v row scale) rounded to q's
// dtype; the output is acc / max(l, 1e-30) in q's dtype.
//
// Where the rows live (KvSrc). Kernels 6 and 7 read a page pool
// [N, ps, H_kv, D] through a page table [B, P_max]; kernel 5 reads one layer
// of the dense cache [B, S_max, H_kv, D] through an implicit table: page p
// of batch row b is its rows p * ps .. p * ps + ps - 1 (the last page may be
// short of S_max's end). Both are read in place through element strides.
// pos is [B] for the pool and one int for every batch row of the dense
// cache; either way it stays on the device, and nothing a launch is sized by
// depends on it, so a launch can be captured in a CUDA graph.
//
// Split-K decode (T <= 16). A decode call has too few (slot, kv head) pairs
// to fill 132 SMs and reads each page once, so a slot's pages are split into
// runs of pps pages (n_split runs, from P_max and the SM count on the host).
// Grid (split, kv head, slot): a block takes its run for the whole GQA group
// of its kv head (g x T rows, up to four at a time), so each K/V row is read
// once per group and pass. Lanes load 16-byte vectors of a row straight into
// registers: CL columns a lane (16 int8, 8 bf16, 4 or 8 f32), D / CL lanes a
// row; each lane dots its columns against q's in f32 and the row's dot is
// summed over the lanes by shuffles. There is no f32 staging of K or V in
// shared memory; only scores and p pass through it. The online softmax is
// updated once per page. Each split writes (m, l, acc) to partial buffers
// the wrapper allocates, and the last split of each (slot, kv head) to
// finish (an atomic ticket) merges the live splits of its rows by
// log-sum-exp in the same launch: on an H100 that is ~1.5 us faster than a
// second, combining launch, and it saves the host one launch a layer.
//
// Tensor-core prefill (T > 16, bf16 q, D 64/128, pages a multiple of 64
// rows). 384 threads own 128 q rows of one (slot, head): two consumer
// warpgroups of 64 rows and a producer warpgroup. One producer thread
// TMA-loads the q tile once and then 64-key chunks of K and V through 4-D
// tensor maps whose outer coordinate is the page id (or the batch row). bf16
// pages land straight in the 128-byte swizzle wgmma reads, in a ring of four
// slots, and the producer warpgroup keeps 24 registers a thread; int8 pages
// land unswizzled in a staging ring and the whole producer warpgroup widens
// them exactly into the swizzled bf16 ring beside their row scales (40
// registers). Per chunk each consumer warpgroup computes S = Q K^T (wgmma
// SS), carries the online softmax in registers in log2 units, and runs
// O += P V with P rounded to bf16 as the register A operand (RS, V MN-major).
// A block visits chunks only up to the last key its rows can see.
//
// Prefill padding. Given valid [B] (the engine's real prompt lengths), rows
// t >= valid[b] are written as zeros: a block whose first row is at or past
// valid[b] writes its zeros and exits, and no block reads keys past what its
// rows below valid[b] can see. Rows below valid[b] are computed as without
// it.
//
// Bound. A decode call moves each visible K/V row once and does ~4 D flops
// per key and head, far below the card's ~295 flops a byte: bytes bound it
// (int8 halves them against bf16, plus 4 bytes of scale a row and head). A
// prefill of T = 1024 rows does ~4 D flops per (row, visible key, head) over
// a few MB: the tensor cores bound it.
#pragma once

#include "attention.cuh"
#include "tc_attention.cuh"

namespace kv {

using namespace attn;

// Where a slot's K/V rows live (see the header).
struct KvSrc {
  const void* k;
  const void* v;           // as k, the same strides
  const float* ks;         // int8 rows: k row scales, contiguous
                           // [N, ps, H_kv] (pool) or [B, S_max, H_kv]
  const float* vs;         // as ks
  const int* table;        // [B, p_max] page ids, or null: dense
  long long s_page;        // elements between pages (pool) or batch rows
  long long s_row;         // between rows
  long long s_head;        // between kv heads (the head dim contiguous)
  int ps, p_max;
  int n_keys;              // keys a slot holds: p_max * ps, or S_max
  int pos_sb;              // 1: pos [B]; 0: one pos for every batch row
};

// Page p of slot b: the element offset of its row 0 (kv head 0) and the
// scale row of that row (scales: (srow + key) * H_kv + kv head). PAGED
// (compile time): through the table, else through the implicit table.
struct PageRef {
  size_t base;
  size_t srow;
};

template <bool PAGED>
__device__ __forceinline__ PageRef page_ref(const KvSrc s, int b, int p) {
  if constexpr (PAGED) {
    const size_t id = (size_t)__ldg(s.table + (size_t)b * s.p_max + p);
    return {id * (size_t)s.s_page, id * (size_t)s.ps};
  }
  return {(size_t)b * s.s_page + (size_t)p * s.ps * s.s_row,
          (size_t)b * s.n_keys + (size_t)p * s.ps};
}

// 16 bytes of elements E widened exactly to f32.
template <typename E> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void widen(uint4 u, float* x) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // a bf16 is the top half of its f32: widen by shifting the bits
  static __device__ __forceinline__ void widen(uint4 u, float* x) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[2 * j] = __uint_as_float(w[j] << 16);
      x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
};
template <> struct Vec<int8_t> {
  static constexpr int N = 16;
  static __device__ __forceinline__ void widen(uint4 u, float* x) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[4 * j + i] = (float)((int)(w[j] << (24 - 8 * i)) >> 24);
  }
};

// CL consecutive values of a row, held as 16-byte vectors (loaded through
// the read-only path: nothing a kernel reads this way is written in it).
template <typename E, int CL> struct Cols {
  static constexpr int NV = CL / Vec<E>::N;
  static_assert(NV >= 1 && NV * Vec<E>::N == CL, "whole 16-byte vectors");
  uint4 u[NV];
  __device__ __forceinline__ void load(const E* src) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      u[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < NV; ++i) u[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ void widen(float (&x)[CL]) const {
#pragma unroll
    for (int i = 0; i < NV; ++i) Vec<E>::widen(u[i], x + i * Vec<E>::N);
  }
};

// Rows q0 .. q0 + rows - 1 of head h, batch row b of out [B, T, H, D]
// (contiguous) set to zero by threads tid of nt.
template <typename T, int D>
__device__ __forceinline__ void zero_rows(T* out, int b, int q0, int rows,
                                          int t_len, int H, int h, int tid,
                                          int nt) {
  constexpr int VPR = D * (int)sizeof(T) / 16;
  for (int i = tid; i < rows * VPR; i += nt) {
    const int r = i / VPR, c = i % VPR;
    reinterpret_cast<uint4*>(out + (((size_t)b * t_len + q0 + r) * H + h) *
                                       D)[c] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Rows of slot b the caller counts as real: valid[b] (at most T), or T.
__device__ __forceinline__ int rows_valid(const int* valid, int b,
                                          int t_len) {
  return valid ? min(valid[b], t_len) : t_len;
}

// ---------------------------------------------------------------------------
// split-K decode
// ---------------------------------------------------------------------------

constexpr int SPLIT_THREADS = 128;
constexpr int SPLIT_MAX_T = 16;    // T at or below: the split-K instance
constexpr int SPLIT_U = 4;         // 16-byte loads in flight per thread

// Columns a lane holds (one or two 16-byte vectors of the row, at least
// D / 32 so that a row takes at most a warp) and lanes a row.
template <typename KV, int D> struct SplitShape {
  static constexpr int CL = Vec<KV>::N > D / 32 ? Vec<KV>::N : D / 32;
  static constexpr int LPK = D / CL;
  static constexpr int KP = SPLIT_THREADS / LPK;    // keys a pass
};

struct SplitArgs {
  const void* q;           // [B, T, H, D], head dim contiguous
  long long q_sb, q_ss, q_sh;
  KvSrc src;
  const int* pos;          // [B] or [1] (src.pos_sb)
  const int* valid;        // [B] real rows, or null
  float* m_part;           // [B * T * H, n_split]
  float* l_part;           // [B * T * H, n_split]
  float* acc_part;         // [B * T * H, n_split, D]
  int* tickets;            // [B * H_kv] zeros; the launch leaves them zero
  void* out;               // [B, T, H, D] contiguous
  int B, t_len, H, H_kv, n_split, pps;
  float scale;
};

// The pages of slot b its rows can see.
__device__ __forceinline__ int needed_pages(const SplitArgs a, int b) {
  const int p0 = a.pos[b * a.src.pos_sb];
  return min((p0 + a.t_len + a.src.ps - 1) / a.src.ps, a.src.p_max);
}

// One warp merges output row `row` (= (b * T + t) * H + head) from its live
// splits by log-sum-exp: out = sum_i w_i acc_i / max(sum_i w_i l_i, 1e-30),
// w_i = exp(m_i - max_j m_j); zeros for a row past valid. Lane i holds the
// weight of split i (of each run of 32), so each m and l is read and each
// weight computed once; the lanes then sum their columns of acc. The
// partials are read through L2: other SMs wrote them in this launch.
template <typename T, int D>
__device__ __forceinline__ void merge_row(const SplitArgs a, size_t row,
                                          int live, bool zero, int lane) {
  constexpr int NC = D / 32;                  // columns a lane
  const float* mr = a.m_part + row * a.n_split;
  const float* lr = a.l_part + row * a.n_split;
  const float* ar = a.acc_part + row * a.n_split * D + lane;
  T* out = static_cast<T*>(a.out) + row * D + lane;
  float o[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) o[c] = 0.f;
  float l = 0.f;
  if (!zero) {
    float mx = NEG_INF;
    for (int i = lane; i < live; i += 32) mx = fmaxf(mx, __ldcg(mr + i));
    mx = warp_max(mx);
    for (int i0 = 0; i0 < live; i0 += 32) {
      const int i = i0 + lane;
      const float w = i < live ? expf(__ldcg(mr + i) - mx) : 0.f;
      if (i < live) l = fmaf(w, __ldcg(lr + i), l);
      const int n = min(32, live - i0);
      for (int j = 0; j < n; ++j) {
        const float wj = __shfl_sync(0xffffffffu, w, j);
        const float* aj = ar + (size_t)(i0 + j) * D;
#pragma unroll
        for (int c = 0; c < NC; ++c) o[c] = fmaf(wj, __ldcg(aj + 32 * c), o[c]);
      }
    }
    l = warp_sum(l);
  }
  const float inv_den = zero ? 0.f : 1.f / fmaxf(l, EPS);
#pragma unroll
  for (int c = 0; c < NC; ++c) out[32 * c] = Elem<T>::from_f(o[c] * inv_den);
}

// One block per (split, kv head h_kv, slot b): pages [split * pps,
// min((split + 1) * pps, needed)) of slot b for the g x T rows (head
// h_kv * g + i / T, q row i % T) of its GQA group, RC rows at a time.
// Partials, row (b * T + t) * H + head. PAGED: a pool through its table
// (whole pages), else the dense cache (the last page may be short).
template <typename T, typename KV, int D, int RC, bool PAGED>
// one row at a time (the decode of MHA): six blocks an SM, which caps the
// registers at 85 a thread (left free, ptxas takes 96 and the engine's
// decode runs ~25% slower: the blocks are latency-bound, so residency
// counts); more rows hold q and acc for each in registers
__global__ void __launch_bounds__(SPLIT_THREADS, RC == 1 ? 6 : 1)
split_kernel(const SplitArgs a) {
  using Sh = SplitShape<KV, D>;
  constexpr int CL = Sh::CL, LPK = Sh::LPK, KP = Sh::KP;
  constexpr int NW = SPLIT_THREADS / 32;
  constexpr bool INT8 = sizeof(KV) == 1;
  // the arguments as locals (reading a kernel parameter through a
  // reference would go through generic memory)
  const KvSrc src = a.src;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int ps = src.ps;
  const int p0 = a.pos[b * src.pos_sb];
  const int needed = needed_pages(a, b);
  const int pg0 = split * a.pps;
  if (pg0 >= needed) return;                  // past the slot's last page
  const int pg1 = min(pg0 + a.pps, needed);
  const int t_len = a.t_len, H = a.H, H_kv = a.H_kv;
  const int g = H / H_kv;
  const int R = g * t_len;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kq = tid / LPK;                   // key of the pass
  const int c0 = (tid % LPK) * CL;            // this lane's CL columns
  const T* q = static_cast<const T*>(a.q);
  const KV* kp = static_cast<const KV*>(src.k);
  const KV* vp = static_cast<const KV*>(src.v);

  extern __shared__ __align__(16) float smem[];
  float* s_s = smem;                          // [RC][ps] scores, then p'
  float* m_s = s_s + RC * ps;                 // [RC]
  float* l_s = m_s + RC;                      // [RC]
  float* a_s = l_s + RC;                      // [RC] this page's rescale
  float* red = a_s + RC;                      // [NW][RC][D] acc of a warp
  __shared__ int merge_here;

  for (int r0 = 0; r0 < R; r0 += RC) {
    const int nr = min(RC, R - r0);
    // this lane's columns of the chunk's q rows, and each row's t
    float qr[RC][CL];
    int tq[RC];
#pragma unroll
    for (int rr = 0; rr < RC; ++rr) {
      const int i = r0 + min(rr, nr - 1);
      tq[rr] = i % t_len;
      const int head = hk * g + i / t_len;
      Cols<T, CL> qc;
      qc.load(q + b * a.q_sb + tq[rr] * a.q_ss + head * a.q_sh + c0);
      qc.widen(qr[rr]);
    }
    if (tid < RC) {
      m_s[tid] = NEG_INF;
      l_s[tid] = 0.f;
    }
    float acc[RC][CL];
#pragma unroll
    for (int rr = 0; rr < RC; ++rr)
#pragma unroll
      for (int e = 0; e < CL; ++e) acc[rr][e] = 0.f;

    for (int pg = pg0; pg < pg1; ++pg) {
      const PageRef pr = page_ref<PAGED>(src, b, pg);
      // rows the slot holds
      const int nk = PAGED ? ps : min(ps, src.n_keys - pg * ps);
      // this thread's first key of the page, and the step to its next
      const size_t off = pr.base + (size_t)hk * src.s_head + c0 +
                         (size_t)kq * src.s_row;
      const KV* kb = kp + off;
      const KV* vb = vp + off;
      const size_t step = (size_t)KP * src.s_row;
      const float* ksb = INT8 ? src.ks + pr.srow * H_kv + hk : nullptr;
      const float* vsb = INT8 ? src.vs + pr.srow * H_kv + hk : nullptr;

      // scores s = (q . k) x scale [x ks[key]], masked to key <= pos + t
      for (int c = 0; c < ps; c += KP * SPLIT_U) {
        Cols<KV, CL> kv[SPLIT_U];
        const KV* kc = kb + (size_t)c * src.s_row;
#pragma unroll
        for (int u = 0; u < SPLIT_U; ++u) {
          if (c + u * KP + kq < nk)
            kv[u].load(kc + u * step);
          else
            kv[u].zero();
        }
#pragma unroll
        for (int u = 0; u < SPLIT_U; ++u) {
          const int key = c + u * KP + kq;
          float kf[CL];
          kv[u].widen(kf);
          float sd[RC];
#pragma unroll
          for (int rr = 0; rr < RC; ++rr) {
            sd[rr] = 0.f;
#pragma unroll
            for (int e = 0; e < CL; ++e)
              sd[rr] = fmaf(qr[rr][e], kf[e], sd[rr]);
#pragma unroll
            for (int o = 1; o < LPK; o <<= 1)
              sd[rr] += __shfl_xor_sync(0xffffffffu, sd[rr], o);
          }
          if (tid % LPK == 0 && key < ps) {
            const float ksc =
                INT8 && key < nk ? __ldg(ksb + (size_t)key * H_kv) : 1.f;
            const int kpos = pg * ps + key;
#pragma unroll
            for (int rr = 0; rr < RC; ++rr) {
              float s = sd[rr] * a.scale;
              if (INT8) s *= ksc;
              s_s[rr * ps + key] =
                  (rr < nr && key < nk && kpos <= p0 + tq[rr]) ? s : NEG_INF;
            }
          }
        }
      }
      __syncthreads();

      // online softmax over this page, a warp per row; l takes the
      // unrounded p, the p.V product takes p [x vs] rounded to q's dtype
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
          const float pv =
              INT8 && k < nk ? e * __ldg(vsb + (size_t)k * H_kv) : e;
          sr[k] = k < nk ? Elem<T>::round(pv) : 0.f;
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

      // acc = acc x alpha + p' . V, this lane's columns of its keys
#pragma unroll
      for (int rr = 0; rr < RC; ++rr) {
        const float alpha = rr < nr ? a_s[rr] : 0.f;
#pragma unroll
        for (int e = 0; e < CL; ++e) acc[rr][e] *= alpha;
      }
      for (int c = 0; c < ps; c += KP * SPLIT_U) {
        Cols<KV, CL> vv[SPLIT_U];
        const KV* vc = vb + (size_t)c * src.s_row;
#pragma unroll
        for (int u = 0; u < SPLIT_U; ++u) {
          if (c + u * KP + kq < nk)
            vv[u].load(vc + u * step);
          else
            vv[u].zero();
        }
#pragma unroll
        for (int u = 0; u < SPLIT_U; ++u) {
          const int key = c + u * KP + kq;
          if (key >= nk) continue;
          float vf[CL];
          vv[u].widen(vf);
#pragma unroll
          for (int rr = 0; rr < RC; ++rr) {
            const float pv = rr < nr ? s_s[rr * ps + key] : 0.f;
#pragma unroll
            for (int e = 0; e < CL; ++e)
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
      for (int e = 0; e < CL; ++e)
#pragma unroll
        for (int o = LPK; o < 32; o <<= 1)
          acc[rr][e] += __shfl_xor_sync(0xffffffffu, acc[rr][e], o);
    if (lane < LPK) {
#pragma unroll
      for (int rr = 0; rr < RC; ++rr)
#pragma unroll
        for (int e = 0; e < CL; ++e)
          red[(warp * RC + rr) * D + c0 + e] = acc[rr][e];
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
      a.acc_part[(row * a.n_split + split) * D + d] = v;
    }
    if (tid < nr) {
      const int i = r0 + tid;
      const size_t row = ((size_t)b * t_len + i % t_len) * H + hk * g +
                         i / t_len;
      a.m_part[row * a.n_split + split] = m_s[tid];
      a.l_part[row * a.n_split + split] = l_s[tid];
    }
    __syncthreads();            // before the next rows reuse m_s, red
  }

  // the last live split of (b, h_kv) to finish merges its rows
  __threadfence();              // this block's partials, before its ticket
  __syncthreads();
  const int live = (needed + a.pps - 1) / a.pps;
  if (tid == 0)
    merge_here = atomicAdd(&a.tickets[b * H_kv + hk], 1) == live - 1;
  __syncthreads();
  if (!merge_here) return;
  __threadfence();
  const int n_valid = rows_valid(a.valid, b, t_len);
  for (int i = warp; i < R; i += NW) {
    const int t = i % t_len;
    merge_row<T, D>(a, ((size_t)b * t_len + t) * H + hk * g + i / t_len,
                    live, t >= n_valid, lane);
  }
  if (tid == 0) a.tickets[b * H_kv + hk] = 0;   // ready for the next launch
}

template <typename T, typename KV, int D, int RC, bool PAGED>
int launch_split_rc(const SplitArgs& a, cudaStream_t stream) {
  auto kern = split_kernel<T, KV, D, RC, PAGED>;
  const size_t smem =
      sizeof(float) * ((size_t)RC * a.src.ps + 3 * RC +
                       (SPLIT_THREADS / 32) * (size_t)RC * D);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(a.n_split, a.H_kv, a.B), SPLIT_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Rows handled together: the GQA group's g x T rows, at most four (each
// lane keeps its columns of q and of acc per row in registers).
template <typename T, typename KV, int D, bool PAGED>
int launch_split_d(const SplitArgs& a, cudaStream_t stream) {
  const int R = (a.H / a.H_kv) * a.t_len;
  if (R == 1) return launch_split_rc<T, KV, D, 1, PAGED>(a, stream);
  if (R == 2) return launch_split_rc<T, KV, D, 2, PAGED>(a, stream);
  return launch_split_rc<T, KV, D, 4, PAGED>(a, stream);
}

// The split-K instance for head dim D over a pool (PAGED, a.src.table set)
// or the dense cache; ERR_NO_INSTANCE for a head dim with none, ERR_SCRATCH
// without partial buffers or tickets.
template <typename T, typename KV, bool PAGED>
int launch_split(int D, const SplitArgs& a, cudaStream_t stream) {
  if (!a.m_part || !a.l_part || !a.acc_part || !a.tickets || a.n_split < 1 ||
      a.pps < 1)
    return ERR_SCRATCH;
  if (a.B == 0 || a.t_len == 0 || a.H == 0) return 0;
  switch (D) {
    case 64: return launch_split_d<T, KV, 64, PAGED>(a, stream);
    case 128: return launch_split_d<T, KV, 128, PAGED>(a, stream);
    case 256: return launch_split_d<T, KV, 256, PAGED>(a, stream);
  }
  return ERR_NO_INSTANCE;
}

// ---------------------------------------------------------------------------
// tensor-core prefill
// ---------------------------------------------------------------------------

constexpr int PF_BM = 128;              // q rows per block
constexpr int PF_BK = 64;               // keys per chunk (pages hold ps/64)
constexpr int PF_THREADS = 3 * tc::WG;  // two consumer warpgroups, producer's

template <typename KV, int D> struct PfTile {
  static constexpr bool INT8 = sizeof(KV) == 1;
  static constexpr int ST = INT8 ? 3 : 4;          // bf16 ring slots
  static constexpr int SST = INT8 ? 3 : 0;         // int8 staging slots
  static constexpr int PN = D / 64;                // 64-wide head-dim panels
  static constexpr int Q_BYTES = PF_BM * D * 2;
  static constexpr int KV_BYTES = PF_BK * D * 2;   // one bf16 K or V chunk
  static constexpr int SLOT = 2 * KV_BYTES;        // K and V (1 KB multiple)
  static constexpr int I8_BYTES = PF_BK * D;       // one int8 K or V chunk
  static constexpr int STAGE = 2 * I8_BYTES;
  static constexpr int SCL = INT8 ? ST * 2 * PF_BK * 4 : 0;  // {ks, vs}[BK]
  // the producer only issues copies over bf16 pages; it widens int8 ones
  static constexpr int PRODUCER_REGS = INT8 ? 40 : 24;
  static constexpr int CONSUMER_REGS = INT8 ? 232 : 240;   // 2 M + N <= 504
  // + the slot's page ids (p_max ints), added at launch
  static constexpr int SMEM =
      Q_BYTES + ST * SLOT + SST * STAGE + SCL + 64 * 8 + 1024;
};

struct PrefillArgs {
  KvSrc src;
  const int* pos;          // [B] or [1] (src.pos_sb)
  const int* valid;        // [B] real rows, or null
  __nv_bfloat16* out;      // [B, T, H, D] contiguous
  int t_len, H, H_kv;
  float scale;
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

// Grid (q tiles, H, B), the tiles with the most keys first. PAGED: a pool
// through its table, else the dense cache.
template <typename KV, int D, bool PAGED>
__global__ void __launch_bounds__(PF_THREADS, 1)
prefill_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const PrefillArgs a) {
  using Tile = PfTile<KV, D>;
  constexpr bool INT8 = Tile::INT8;
  constexpr int ST = Tile::ST, SST = Tile::SST, PN = Tile::PN, BK = PF_BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = tc::align1024(smem_raw);            // [PN][PF_BM][64]
  uint8_t* ring = q_s + Tile::Q_BYTES;               // [ST] x {K, V} bf16
  int8_t* stage = reinterpret_cast<int8_t*>(ring + ST * Tile::SLOT);
                                                     // [SST] x {K, V}[BK][D]
  float* scl = reinterpret_cast<float*>(stage + SST * Tile::STAGE);
                                                     // [ST] x {ks, vs}[BK]
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(scl) +
                                  Tile::SCL);
  uint64_t* full = q_full + 1;                       // [ST] tiles ready
  uint64_t* empty = full + ST;                       // [ST] multiplied
  uint64_t* st_full = empty + ST;                    // [SST] staged
  int* pages = reinterpret_cast<int*>(q_full + 64);  // the slot's page ids

  // the arguments as locals (reading a kernel parameter through a
  // reference would go through generic memory)
  const KvSrc src = a.src;
  const int t_len = a.t_len, H = a.H, H_kv = a.H_kv;
  const int n_qt = (t_len + PF_BM - 1) / PF_BM;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * PF_BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / a.H_kv);
  const int rows = min(PF_BM, t_len - q0);
  const int n_valid = rows_valid(a.valid, b, t_len);
  if (q0 >= n_valid) {          // padding only: zeros, nothing read
    zero_rows<__nv_bfloat16, D>(a.out, b, q0, rows, t_len, H, h,
                                threadIdx.x, PF_THREADS);
    return;
  }
  const int p0 = a.pos[b * src.pos_sb];
  // keys the block's real rows can see, within what the slot holds
  const int n_keys = min(p0 + min(q0 + rows, n_valid), src.n_keys);
  const int n_chunks = (n_keys + BK - 1) / BK;

  if (threadIdx.x == 0) {
    tc::bar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      // int8: every producer thread arrives after widening; bf16: the
      // copying thread's expect_tx
      tc::bar_init(&full[s], INT8 ? tc::WG : 1);
      tc::bar_init(&empty[s], 2);       // one arrival per consumer warpgroup
    }
    for (int s = 0; s < SST; ++s) tc::bar_init(&st_full[s], 1);
    tc::bar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= 8) {
    tc::regs_dec<Tile::PRODUCER_REGS>();
    const int pt = threadIdx.x - 2 * tc::WG;
    const int ps = src.ps;
    if constexpr (PAGED) {
      // the page ids this block reads, once, into shared memory
      const int n_pg = (n_keys + ps - 1) / ps;
      for (int i = pt; i < n_pg; i += tc::WG)
        pages[i] = __ldg(src.table + (size_t)b * src.p_max + i);
    }
    tc::named_sync(1, tc::WG);
    // chunk j: 64 rows at (row, outer) of the tensor maps: rows j 64 % ps of
    // page pages[j 64 / ps], or rows j 64 of batch row b
    auto row_of = [&](int j) { return PAGED ? j * BK % ps : j * BK; };
    auto outer_of = [&](int j) { return PAGED ? pages[j * BK / ps] : b; };
    if (pt == 0) {
      tc::bar_expect_tx(q_full, Tile::Q_BYTES);
      for (int p = 0; p < PN; ++p)
        tc::tma_load(q_s + p * PF_BM * tc::ROW_BYTES, &tm_q, q_full, 64 * p,
                     h, q0, b);
    }
    if constexpr (!INT8) {
      // bf16 pages: straight into the swizzled ring, one thread
      if (pt == 0) {
        for (int j = 0; j < n_chunks; ++j) {
          const int s = j % ST;
          if (j >= ST) tc::bar_wait(&empty[s], ((j / ST) - 1) & 1);
          uint8_t* kt = ring + s * Tile::SLOT;
          uint8_t* vt = kt + Tile::KV_BYTES;
          tc::bar_expect_tx(&full[s], Tile::SLOT);
          const int r = row_of(j), o = outer_of(j);
          for (int p = 0; p < PN; ++p) {
            tc::tma_load(kt + p * BK * tc::ROW_BYTES, &tm_k, &full[s],
                         64 * p, hk, r, o);
            tc::tma_load(vt + p * BK * tc::ROW_BYTES, &tm_v, &full[s],
                         64 * p, hk, r, o);
          }
        }
      }
    } else {
      auto issue = [&](int j) {
        int8_t* k8 = stage + (j % SST) * Tile::STAGE;
        uint64_t* bar = &st_full[j % SST];
        tc::fence_async_smem();
        tc::bar_expect_tx(bar, Tile::STAGE);
        tc::tma_load(k8, &tm_k, bar, 0, hk, row_of(j), outer_of(j));
        tc::tma_load(k8 + Tile::I8_BYTES, &tm_v, bar, 0, hk, row_of(j),
                     outer_of(j));
      };
      if (pt == 0)
        for (int j = 0; j < min(SST, n_chunks); ++j) issue(j);
      // each chunk's k and v scales, loaded one chunk ahead (their latency
      // hides behind the widening of the chunk before)
      auto scale_at = [&](int j) {
        const size_t srow =
            PAGED ? (size_t)outer_of(j) * ps + row_of(j)
                      : (size_t)b * src.n_keys + row_of(j);
        return (srow + pt) * H_kv + hk;
      };
      float k_next = 0.f, v_next = 0.f;
      if (pt < BK && n_chunks > 0) {
        k_next = __ldg(src.ks + scale_at(0));
        v_next = __ldg(src.vs + scale_at(0));
      }
      for (int j = 0; j < n_chunks; ++j) {
        const int s = j % ST;
        const float k_sc = k_next, v_sc = v_next;
        if (pt < BK && j + 1 < n_chunks) {
          k_next = __ldg(src.ks + scale_at(j + 1));
          v_next = __ldg(src.vs + scale_at(j + 1));
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
        tc::fence_async_smem();         // the tiles, before wgmma reads them
        tc::bar_arrive(&full[s]);
        tc::named_sync(1, tc::WG);      // every thread is done with stage j
        if (pt == 0 && j + SST < n_chunks) issue(j + SST);
      }
    }
    return;
  }

  tc::regs_inc<Tile::CONSUMER_REGS>();
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
  const float scale = a.scale;

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

    // S = Q K^T over D in k16 steps
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

    // s = S x scale [x ks[key]] (log2 units); keys past pos + row masked
    // only where the chunk reaches past the warpgroup's first row
    const bool masked = c0 + BK - 1 > p0 + row0;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      float2 kv = make_float2(1.f, 1.f);
      if constexpr (INT8)
        kv = *reinterpret_cast<const float2*>(ksc + 8 * n + cq);
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
    // p = 2^(s - m): l sums it, P.V takes p [x vs[key]]
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      float2 vv = make_float2(1.f, 1.f);
      if constexpr (INT8)
        vv = *reinterpret_cast<const float2*>(vsc + 8 * n + cq);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int idx = 4 * n + 2 * k + jj;
          const float p = tc::ex2(sc[idx] - m[k]);
          rs[k] += p;
          sc[idx] = INT8 ? p * (jj ? vv.y : vv.x) : p;
        }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) l[k] = l[k] * alpha[k] + rs[k];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) tc::to_a(sc, kk, pa[kk]);
#pragma unroll
    for (int k = 0; k < D / 2; ++k) o[k] *= alpha[(k / 2) % 2];

    // O += P V over the chunk's keys in k16 steps, V read MN-major
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

  // out = O / max(l, 1e-30) in bf16, [B, T, H, D]; rows past valid zero
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    l[k] += __shfl_xor_sync(0xffffffffu, l[k], 1);
    l[k] += __shfl_xor_sync(0xffffffffu, l[k], 2);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int row = r + 8 * k;
    if (row >= t_len) continue;
    const float inv = row < n_valid ? __frcp_rn(fmaxf(l[k], EPS)) : 0.f;
    __nv_bfloat16* orow =
        a.out + (((size_t)b * t_len + row) * H + h) * D + cq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          tc::pack_bf16(o[4 * n + 2 * k] * inv, o[4 * n + 2 * k + 1] * inv);
  }
}

// The tensor-core prefill for head dim D: q [B, T, H, D] bf16 read through
// its element strides; the K/V rows of a.src (n_outer pages of the pool, or
// B batch rows of the dense cache).
template <typename KV, int D, bool PAGED>
int launch_prefill_tc_d(const void* q, long long q_sb, long long q_ss,
                        long long q_sh, const PrefillArgs& a, int B,
                        int n_outer, cudaStream_t stream) {
  using Tile = PfTile<KV, D>;
  constexpr bool INT8 = Tile::INT8;
  if (B == 0 || a.t_len == 0 || a.H == 0) return 0;
  const KvSrc& s = a.src;
  CUtensorMap mq, mk, mv;
  int e = tc::make_map(&mq, q, B, a.t_len, a.H, D, q_sb, q_ss, q_sh, PF_BM);
  // K/V boxes of 64 rows of one page (or batch row) and kv head: bf16 in
  // the 128-byte swizzle wgmma reads, int8 unswizzled (the producer widens
  // them into the swizzled tiles)
  const long long rows = PAGED ? s.ps : s.n_keys;
  for (int i = 0; i < 2 && e == 0; ++i)
    e = tc::make_map_4d(
        i ? &mv : &mk, i ? s.v : s.k,
        INT8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        INT8 ? 1 : 2, D, a.H_kv, rows, n_outer, s.s_head, s.s_row, s.s_page,
        INT8 ? D : 64, PF_BK,
        INT8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != 0) return e;
  auto kern = prefill_tc_kernel<KV, D, PAGED>;
  const int smem = Tile::SMEM + (PAGED ? 4 * s.p_max : 0);
  cudaError_t ce = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (ce != cudaSuccess) return (int)ce;
  kern<<<dim3((a.t_len + PF_BM - 1) / PF_BM, a.H, B), PF_THREADS, smem,
         stream>>>(mq, mk, mv, a);
  return (int)cudaGetLastError();
}

// True when the tensor-core prefill takes q of this dtype (1 = bf16) and
// head dim over pages (or a dense cache) of ps rows: the rule the wrappers'
// paged_instance mirrors.
inline bool prefill_tc_takes(int dtype, int D, int ps) {
  return dtype == 1 && (D == 64 || D == 128) && ps % PF_BK == 0;
}

template <typename KV, bool PAGED>
int launch_prefill_tc(int D, const void* q, long long q_sb, long long q_ss,
                      long long q_sh, const PrefillArgs& a, int B,
                      int n_outer, cudaStream_t stream) {
  if (D == 64)
    return launch_prefill_tc_d<KV, 64, PAGED>(q, q_sb, q_ss, q_sh, a, B, n_outer,
                                       stream);
  if (D == 128)
    return launch_prefill_tc_d<KV, 128, PAGED>(q, q_sb, q_ss, q_sh, a, B, n_outer,
                                        stream);
  return ERR_NO_INSTANCE;
}

}  // namespace kv
