// Flash-attention backward, for NVIDIA Hopper (sm_90a): kernels 2 and 3 of
// the port.
//
// Replaces the Pallas TPU kernels _bwd_dq_kernel and _bwd_dkv_kernel
// (paddle_tpu/ops/flash_attention.py, launched by _bwd_pallas_pre). They
// compute the same function from the forward's saved lse and
// delta = rowsum(out * dO): p = exp(s - lse) with s the masked f32 scores
// of the forward (q.k times 1/sqrt(D), plus the additive key mask, -1e30
// where causal or the valid-key bound hides a key); dp = dO.v, times the
// dropout multiplier where the forward dropped (the same counter hash,
// dropout_keep in attention.cuh, row b * H + h of the QUERY head);
// ds = p * (dp - delta). Then
//   flash_bwd_dq:  dq = scale * sum_k ds(rounded to k's dtype) * K;
//   flash_bwd_dkv: dk = scale * sum_q ds(rounded to q's dtype) * Q,
//                  dv = sum_q pd(rounded to dO's dtype) * dO,
//                  pd = p times the dropout multiplier.
// Operands are read in the reference's [B, S, H, D] layout through element
// strides (the head dim contiguous): q/k/v may be strided views of the
// packed qkv projection. lse and delta are [B, H, S_q] f32.
//
// Bound. At the train step's shape (B = 8, S = 1024, H = 16, D = 64,
// causal, bf16) kernel 2 does three causal dots (s, dp, ds.K), ~25.8 GFLOP
// (26 us on the tensor cores), and kernel 3 four (s, dp, pd.dO, ds.Q),
// ~34.4 GFLOP (35 us), over ~85 MB and ~118 MB of operands (25 us and
// 35 us at 3.35 TB/s): bound by operations on the tensor cores. Both skip
// the tiles the causal mask hides entirely, halving the work of a full
// sweep.
//
// float32 (both kernels) and bf16 at D = 256 (both kernels): CUDA-core
// kernels. flash_bwd_dq_kernel: a block per (b, query head h, BT q rows)
// holds its q, dO, lse and delta rows in shared memory and walks key chunks
// of BT up to its last row's causal limit; dq stays in registers. The dkv
// kernel: a block per (b, kv head, BT key rows) holds its K and V rows and
// walks q chunks of BT from the first one that can see its keys (the
// reference's start block), for each query head of the GQA group in turn.
// The dots run on CUDA cores in f32 from shared memory, a thread per key
// for the score tile (s and dp together) and a thread per output column
// for the products. float32 stays here because a TF32 product would not
// hold its tolerance of 2e-5 against the twin (nor the card-vs-CPU f32
// gradient checks); D = 256 in bf16 because neither tensor-core kernel
// fits it: kernel 3's f32 dK and dV of 64 keys x 256 would take every
// register a thread has, and kernel 2's q and dO tile of 128 rows x 256
// takes 128 KB of shared memory, which leaves no room for a ring of two
// K/V chunks (64 KB each).
//
// flash_bwd_dq in bf16 at D = 64 and 128 (flash_bwd_dq_tc_kernel): the
// blocks are persistent, one an SM, each walking 128-row q tiles of one
// (b, query head) longest first (causal tiles differ in length by up to 8x,
// so the short ones even out the end). A block is 384 threads: two consumer
// warpgroups of 64 q rows and a producer warpgroup whose one working thread
// issues TMA copies: the tile's q and dO rows once (released after the
// tile's last S and dP products), then K and V chunks of BK = 64 keys of
// the kv head h / (H / H_kv) through a ring that runs on across tiles.
// Each row's lse and delta sit in registers. Per chunk each warpgroup
// computes S = Q K^T and dP = dO V^T with wgmma (both operands K-major in
// shared memory), then p = 2^(s log2e - lse log2e) and
// dS = p (dP x mult - delta) in the accumulator fragments (the masks only
// on diagonal and edge chunks, the dropout hash per element), and
// dQ += dS K with dS rounded to bf16 as the A operand in registers and K
// read MN-major through the transpose flag. dQ stays in f32 registers and
// is written once, times the scale.
//
// flash_bwd_dkv in bf16 at D = 64 and 128 (flash_bwd_dkv_tc_kernel): a
// block of 384 threads owns 128 keys of one (b, kv head): two consumer
// warpgroups of 64 keys and a producer warp (in a warpgroup of its own,
// which hands its registers to the consumers). The block's K and V rows stay
// in shared memory; the producer streams q and dO chunks of BQ rows by TMA
// (their lse and delta copied beside them by its lanes) through a ring of
// slots, from the first chunk that can see the block's keys, for each
// query head of the GQA group. Per chunk each warpgroup computes, with
// wgmma, S^T = K Q^T and dP^T = V dO^T (operands in shared memory, both
// K-major), then P^T = exp(S^T - lse) and dS^T = P^T (dP^T x mult - delta)
// in the accumulator fragments (lse and delta per column, the masks and
// the dropout hash from each element's (key, q row)), and
// dV += (P^T x mult, bf16) dO and dK += (dS^T, bf16) Q with the rounded
// fragments as the A operands in registers and dO, Q read MN-major. dK and
// dV stay in f32 registers over the whole group (no atomics, no partial
// buffers) and are written once.
//
// Both dkv kernels sum the GQA group's dk/dv in f32 inside the block. (The
// reference rounds each head's partial to k's dtype before its f32 sum; in
// bf16 the two differ by that rounding.)
#include "attention.cuh"
#include "tc_attention.cuh"

namespace {

using namespace attn;

struct BwdArgs {
  const void* q;            // [B, S_q, H, D], strides q_s*
  const void* k;            // [B, S_k, H_kv, D], strides k_s*
  const void* v;            // as k (same strides)
  const void* g;            // dO: [B, S_q, H, D], strides g_s*
  const float* lse;         // [B, H, S_q] f32
  const float* delta;       // [B, H, S_q] f32
  const float* kmask;       // additive [B, S_k] (batch stride m_sb), or null
  void* dq;                 // [B, S_q, H, D] contiguous, q's dtype
  void* dk;                 // [B, S_k, H_kv, D] contiguous, k's dtype
  void* dv;                 // as dk
  long long q_sb, q_ss, q_sh;
  long long g_sb, g_ss, g_sh;
  long long k_sb, k_ss, k_sh;
  long long m_sb;
  int s_q, s_k, H, H_kv;
  int n_keys;               // keys at or past n_keys are masked
  int causal;               // q row i sees keys <= q_off + i
  int q_off;
  float scale;              // 1/sqrt(D)
  Dropout drop;
};

// Rows (q rows or keys) per tile: 64, or 32 at D = 256 to fit shared memory.
template <int D> __host__ __device__ constexpr int tile_rows() {
  return D <= 128 ? 64 : 32;
}

// One [R q rows x C keys] tile of the backward: from the q and dO rows
// (qa, ga: [R][DP] f32), the K and V rows (ka, va: [C][DP] f32) and each
// row's lse and delta, write ds = p * (dp * mult - delta) rounded to T into
// ds_s [R][C] and, when pd_s is given, pd = p * mult rounded to T into
// pd_s. Rows r0 .. r0 + nr - 1 and keys c0 .. c0 + nc - 1 are global
// indices; entries past nr / nc are left unwritten. A thread per key,
// rows rg + j * RSTEP.
template <typename T, int D, int R, int C>
__device__ __forceinline__ void bwd_tile(const BwdArgs& a, const float* qa,
                                         const float* ga, const float* ka,
                                         const float* va, const float* lse_s,
                                         const float* dta_s, int b, int hq,
                                         int r0, int nr, int c0, int nc,
                                         float* ds_s, float* pd_s) {
  constexpr int DP = D + 4;
  constexpr int RSTEP = NT / C;
  constexpr int NJ = R / RSTEP;
  const int key = threadIdx.x % C, rg = threadIdx.x / C;
  if (key >= nc) return;
  float s[NJ], dp[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) s[j] = dp[j] = 0.f;
  const float* kr = ka + key * DP;
  const float* vr = va + key * DP;
#pragma unroll 2
  for (int dd = 0; dd < D; dd += 4) {
    const float4 k4 = *reinterpret_cast<const float4*>(kr + dd);
    const float4 v4 = *reinterpret_cast<const float4*>(vr + dd);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int r = rg + j * RSTEP;
      if (r >= nr) break;               // rows grow with j: the rest too
      const float4 q4 = *reinterpret_cast<const float4*>(qa + r * DP + dd);
      const float4 g4 = *reinterpret_cast<const float4*>(ga + r * DP + dd);
      s[j] = fmaf(q4.x, k4.x, s[j]);
      s[j] = fmaf(q4.y, k4.y, s[j]);
      s[j] = fmaf(q4.z, k4.z, s[j]);
      s[j] = fmaf(q4.w, k4.w, s[j]);
      dp[j] = fmaf(g4.x, v4.x, dp[j]);
      dp[j] = fmaf(g4.y, v4.y, dp[j]);
      dp[j] = fmaf(g4.z, v4.z, dp[j]);
      dp[j] = fmaf(g4.w, v4.w, dp[j]);
    }
  }
  const int kpos = c0 + key;
  const float madd = a.kmask ? a.kmask[b * a.m_sb + kpos] : 0.f;
  const bool kvalid = kpos < a.n_keys;
  const uint32_t drow = (uint32_t)(b * a.H + hq);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int r = rg + j * RSTEP;
    if (r >= nr) break;
    const int qpos = r0 + r;
    float sc = s[j] * a.scale;
    if (a.kmask) sc += madd;
    if (!kvalid || (a.causal && kpos > a.q_off + qpos)) sc = NEG_INF;
    const float p = expf(sc - lse_s[r]);
    float d = dp[j], pd = p;
    if (a.drop.dropout) {
      const float mult =
          dropout_keep(a.drop.seed, drow, qpos, kpos, a.drop.thr)
              ? a.drop.mult : 0.f;
      d *= mult;
      pd = p * mult;
    }
    ds_s[r * C + key] = Elem<T>::round(p * (d - dta_s[r]));
    if (pd_s) pd_s[r * C + key] = Elem<T>::round(pd);
  }
}

// Load n rows of lse and delta of (b, head h) from row r0 into smem.
__device__ __forceinline__ void load_stats(const BwdArgs& a, int b, int h,
                                           int r0, int n, float* lse_s,
                                           float* dta_s) {
  const size_t base = ((size_t)b * a.H + h) * a.s_q + r0;
  for (int r = threadIdx.x; r < n; r += NT) {
    lse_s[r] = a.lse[base + r];
    dta_s[r] = a.delta[base + r];
  }
}

template <typename T, int D>
// D = 64: two blocks per SM (128 registers a thread)
__global__ void __launch_bounds__(NT, D <= 64 ? 2 : 1)
flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int BT = tile_rows<D>();
  constexpr int DP = D + 4;
  constexpr int O_RSTEP = NT / D;       // output tile: thread -> one
  constexpr int O_NJ = BT / O_RSTEP;    //   column, rows orow0 + j * O_RSTEP

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // [BT][DP]  q rows (f32)
  float* g_s = q_s + BT * DP;           // [BT][DP]  dO rows
  float* k_s = g_s + BT * DP;           // [BT][DP]  K chunk
  float* v_s = k_s + BT * DP;           // [BT][DP]  V chunk
  float* ds_s = v_s + BT * DP;          // [BT][BT]  ds (rows x keys)
  float* lse_s = ds_s + BT * BT;        // [BT]
  float* dta_s = lse_s + BT;            // [BT]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = min(BT, a.s_q - q0);
  const int hk = h / (a.H / a.H_kv);
  // keys any row of this tile can see
  int n_end = min(a.n_keys, a.s_k);
  if (a.causal) n_end = max(0, min(n_end, a.q_off + q0 + rows));

  load_rows<T, D, DP>(static_cast<const T*>(a.q) + b * a.q_sb + q0 * a.q_ss +
                          h * a.q_sh,
                      (size_t)a.q_ss, rows, q_s);
  load_rows<T, D, DP>(static_cast<const T*>(a.g) + b * a.g_sb + q0 * a.g_ss +
                          h * a.g_sh,
                      (size_t)a.g_ss, rows, g_s);
  load_stats(a, b, h, q0, rows, lse_s, dta_s);
  float acc[O_NJ];
#pragma unroll
  for (int j = 0; j < O_NJ; ++j) acc[j] = 0.f;
  const int od = tid % D, orow0 = tid / D;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.k_sb + hk * a.k_sh;
  __syncthreads();

  for (int c0 = 0; c0 < n_end; c0 += BT) {
    const int n = min(BT, n_end - c0);
    load_rows<T, D, DP>(kb + (size_t)c0 * a.k_ss, (size_t)a.k_ss, n, k_s);
    load_rows<T, D, DP>(vb + (size_t)c0 * a.k_ss, (size_t)a.k_ss, n, v_s);
    __syncthreads();
    bwd_tile<T, D, BT, BT>(a, q_s, g_s, k_s, v_s, lse_s, dta_s, b, h, q0,
                           rows, c0, n, ds_s, nullptr);
    __syncthreads();
    // dq += ds . K, four keys at a time (one 16-byte read of ds per row)
    const int n4 = n & ~3;
    for (int k = 0; k < n4; k += 4) {
      const float k0 = k_s[k * DP + od], k1 = k_s[(k + 1) * DP + od];
      const float k2 = k_s[(k + 2) * DP + od], k3 = k_s[(k + 3) * DP + od];
#pragma unroll
      for (int j = 0; j < O_NJ; ++j) {
        const int r = orow0 + j * O_RSTEP;
        if (r >= rows) break;
        const float4 d4 = *reinterpret_cast<const float4*>(ds_s + r * BT + k);
        acc[j] = fmaf(d4.x, k0, acc[j]);
        acc[j] = fmaf(d4.y, k1, acc[j]);
        acc[j] = fmaf(d4.z, k2, acc[j]);
        acc[j] = fmaf(d4.w, k3, acc[j]);
      }
    }
    for (int k = n4; k < n; ++k) {
      const float kv = k_s[k * DP + od];
#pragma unroll
      for (int j = 0; j < O_NJ; ++j) {
        const int r = orow0 + j * O_RSTEP;
        if (r >= rows) break;
        acc[j] = fmaf(ds_s[r * BT + k], kv, acc[j]);
      }
    }
    __syncthreads();
  }

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int j = 0; j < O_NJ; ++j) {
    const int r = orow0 + j * O_RSTEP;
    if (r >= rows) break;
    dq[(((size_t)b * a.s_q + q0 + r) * a.H + h) * D + od] =
        Elem<T>::from_f(acc[j] * a.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, D <= 64 ? 2 : 1)
flash_bwd_dkv_kernel(const BwdArgs a) {
  constexpr int BT = tile_rows<D>();
  constexpr int DP = D + 4;
  constexpr int O_RSTEP = NT / D;       // output tile: thread -> one
  constexpr int O_NJ = BT / O_RSTEP;    //   column, keys orow0 + j * O_RSTEP

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                    // [BT][DP]  this block's K rows
  float* v_s = k_s + BT * DP;           // [BT][DP]  its V rows
  float* q_s = v_s + BT * DP;           // [BT][DP]  q chunk
  float* g_s = q_s + BT * DP;           // [BT][DP]  dO chunk
  float* ds_s = g_s + BT * DP;          // [BT][BT]  ds (q rows x keys)
  float* pd_s = ds_s + BT * BT;         // [BT][BT]  pd
  float* lse_s = pd_s + BT * BT;        // [BT]
  float* dta_s = lse_s + BT;            // [BT]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BT;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int nk = min(BT, a.s_k - k0);
  const int grp = a.H / a.H_kv;
  // causal: the first q row that can see key k0
  const int q_first = a.causal ? max(0, k0 - a.q_off) : 0;

  load_rows<T, D, DP>(static_cast<const T*>(a.k) + b * a.k_sb + k0 * a.k_ss +
                          hk * a.k_sh,
                      (size_t)a.k_ss, nk, k_s);
  load_rows<T, D, DP>(static_cast<const T*>(a.v) + b * a.k_sb + k0 * a.k_ss +
                          hk * a.k_sh,
                      (size_t)a.k_ss, nk, v_s);
  float dk[O_NJ], dv[O_NJ];
#pragma unroll
  for (int j = 0; j < O_NJ; ++j) dk[j] = dv[j] = 0.f;
  const int od = tid % D, orow0 = tid / D;

  // keys at or past n_keys see nothing: their gradients stay 0
  const int q_end = k0 < a.n_keys ? a.s_q : q_first;
  for (int i = 0; i < grp; ++i) {
    const int hq = hk * grp + i;
    const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + hq * a.q_sh;
    const T* gb = static_cast<const T*>(a.g) + b * a.g_sb + hq * a.g_sh;
    for (int q0 = q_first; q0 < q_end; q0 += BT) {
      const int rows = min(BT, a.s_q - q0);
      __syncthreads();                  // the last chunk's readers are done
      load_rows<T, D, DP>(qb + (size_t)q0 * a.q_ss, (size_t)a.q_ss, rows,
                          q_s);
      load_rows<T, D, DP>(gb + (size_t)q0 * a.g_ss, (size_t)a.g_ss, rows,
                          g_s);
      load_stats(a, b, hq, q0, rows, lse_s, dta_s);
      __syncthreads();
      bwd_tile<T, D, BT, BT>(a, q_s, g_s, k_s, v_s, lse_s, dta_s, b, hq, q0,
                             rows, k0, nk, ds_s, pd_s);
      __syncthreads();
      // dv += pd^T . dO, dk += ds^T . Q over this chunk's q rows
      for (int qq = 0; qq < rows; ++qq) {
        const float gv = g_s[qq * DP + od], qv = q_s[qq * DP + od];
#pragma unroll
        for (int j = 0; j < O_NJ; ++j) {
          const int kr = orow0 + j * O_RSTEP;
          if (kr >= nk) break;
          dv[j] = fmaf(pd_s[qq * BT + kr], gv, dv[j]);
          dk[j] = fmaf(ds_s[qq * BT + kr], qv, dk[j]);
        }
      }
    }
  }

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int j = 0; j < O_NJ; ++j) {
    const int kr = orow0 + j * O_RSTEP;
    if (kr >= nk) break;
    const size_t o = (((size_t)b * a.s_k + k0 + kr) * a.H_kv + hk) * D + od;
    dkp[o] = Elem<T>::from_f(dk[j] * a.scale);
    dvp[o] = Elem<T>::from_f(dv[j]);
  }
}

// ---------------------------------------------------------------------------
// kernel 3 in bf16: the tensor-core dK/dV kernel
// ---------------------------------------------------------------------------

constexpr int TC_BN = 128;               // keys per block
// two consumer warpgroups, then the producer's: its first warp copies; the
// group exists so that it can hand its registers over
constexpr int TC_THREADS = 3 * tc::WG;

template <int D> struct DkvTile {
  static constexpr int BQ = D == 64 ? 64 : 32;     // q rows per chunk
  static constexpr int STAGES = 3;                 // ring slots
  static constexpr int PANELS = D / 64;            // 64-wide head-dim panels
  static constexpr int KV_BYTES = TC_BN * D * 2;   // the block's K, or V
  static constexpr int QG_BYTES = BQ * D * 2;      // one q or dO chunk
  static constexpr int SLOT = 2 * QG_BYTES;        // q and dO (1 KB multiple)
  static constexpr int STATS = 2 * BQ * 4;         // a slot's lse and delta
  static constexpr int SMEM =
      2 * KV_BYTES + STAGES * (SLOT + STATS) + 64 * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_g,
                        const BwdArgs a) {
  using Tile = DkvTile<D>;
  constexpr int BQ = Tile::BQ, ST = Tile::STAGES, PN = Tile::PANELS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = tc::align1024(smem_raw);        // [PN][TC_BN][64]
  uint8_t* v_s = k_s + Tile::KV_BYTES;           // [PN][TC_BN][64]
  uint8_t* slots = v_s + Tile::KV_BYTES;         // [ST] x {q, dO}
  float* stats = reinterpret_cast<float*>(slots + ST * Tile::SLOT);
                                                 // [ST] x {lse, delta}[BQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(stats) + ST * Tile::STATS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;

  const int b = blockIdx.x / a.H_kv, hk = blockIdx.x % a.H_kv;
  const int k0 = blockIdx.y * TC_BN;     // causal: the longest blocks first
  const int grp = a.H / a.H_kv;
  // causal: the first q row that can see key k0; keys at or past n_keys see
  // nothing, so a block past it walks no chunk and writes zeros
  const int q_first = a.causal ? max(0, k0 - a.q_off) : 0;
  const int q_end = k0 < a.n_keys ? a.s_q : q_first;
  const int n_q = (q_end - q_first + BQ - 1) / BQ;     // chunks per head

  if (threadIdx.x == 0) {
    tc::bar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      tc::bar_init(&full[s], 32);       // every producer lane
      tc::bar_init(&empty[s], 2);       // one arrival per consumer warpgroup
    }
    tc::bar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= 8) {
    tc::regs_dec<24>();
    if (warp > 8) return;
    // producer: lane 0 issues the copies, every lane copies lse and delta
    if (lane == 0) {
      tc::bar_expect_tx(kv_full, 2 * Tile::KV_BYTES);
      for (int p = 0; p < PN; ++p) {
        tc::tma_load(k_s + p * TC_BN * tc::ROW_BYTES, &tm_k, kv_full, 64 * p,
                     hk, k0, b);
        tc::tma_load(v_s + p * TC_BN * tc::ROW_BYTES, &tm_v, kv_full, 64 * p,
                     hk, k0, b);
      }
    }
    for (int j = 0; j < grp * n_q; ++j) {
      const int s = j % ST;
      const int hq = hk * grp + j / n_q;
      const int q0 = q_first + (j % n_q) * BQ;
      if (j >= ST) tc::bar_wait(&empty[s], ((j / ST) - 1) & 1);
      uint8_t* slot = slots + s * Tile::SLOT;
      float* lse_s = stats + s * 2 * BQ;
      float* dta_s = lse_s + BQ;
      // rows past S_q: lse = +inf makes their p 0
      const size_t base = ((size_t)b * a.H + hq) * a.s_q;
      for (int r = lane; r < BQ; r += 32) {
        const bool in = q0 + r < a.s_q;
        lse_s[r] = in ? a.lse[base + q0 + r] : INFINITY;
        dta_s[r] = in ? a.delta[base + q0 + r] : 0.f;
      }
      if (lane == 0) {
        tc::bar_expect_tx(&full[s], 2 * Tile::QG_BYTES);
        for (int p = 0; p < PN; ++p) {
          tc::tma_load(slot + p * BQ * tc::ROW_BYTES, &tm_q, &full[s], 64 * p,
                       hq, q0, b);
          tc::tma_load(slot + Tile::QG_BYTES + p * BQ * tc::ROW_BYTES, &tm_g,
                       &full[s], 64 * p, hq, q0, b);
        }
      } else {
        tc::bar_arrive(&full[s]);
      }
    }
    return;
  }

  tc::regs_inc<240>();
  // consumers: warpgroup wg owns keys k0 + 64 wg .. + 63
  const int wg = warp / 4;
  const int t = threadIdx.x % tc::WG;
  const int key0 = k0 + 64 * wg;                        // first key of the wg
  const int kr = key0 + 16 * (t / 32) + lane / 4;  // fragment rows kr, kr + 8
  const int cq = 2 * (lane % 4);               // columns 8 n + cq + {0, 1}
  const uint32_t k_addr = tc::smem_u32(k_s) + 64 * wg * tc::ROW_BYTES;
  const uint32_t v_addr = tc::smem_u32(v_s) + 64 * wg * tc::ROW_BYTES;
  // per fragment row: the key mask, and whether the key is past n_keys
  float madd[2];
  bool dead[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr + 8 * i;
    dead[i] = key >= a.n_keys;
    madd[i] = (a.kmask && !dead[i]) ? a.kmask[b * a.m_sb + key] : 0.f;
  }

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  tc::bar_wait(kv_full, 0);
  for (int j = 0; j < grp * n_q; ++j) {
    const int s = j % ST;
    const uint32_t ph = (j / ST) & 1;
    const int hq = hk * grp + j / n_q;
    const int q0 = q_first + (j % n_q) * BQ;
    const uint32_t drow = (uint32_t)(b * a.H + hq);
    uint8_t* slot = slots + s * Tile::SLOT;
    const uint32_t q_addr = tc::smem_u32(slot);
    const uint32_t g_addr = q_addr + Tile::QG_BYTES;
    const float* lse_s = stats + s * 2 * BQ;
    const float* dta_s = lse_s + BQ;

    // S^T = K Q^T and dP^T = V dO^T over D in k16 steps
    float st[BQ / 2], dpt[BQ / 2];
    tc::bar_wait(&full[s], ph);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;          // 16 values into the row
      const uint32_t kp = (kk / 4) * TC_BN * tc::ROW_BYTES + off;
      const uint32_t qp = (kk / 4) * BQ * tc::ROW_BYTES + off;
      tc::WgmmaSS<BQ>::mma(st, tc::desc(k_addr + kp, 16, 1024),
                           tc::desc(q_addr + qp, 16, 1024), kk > 0);
      tc::WgmmaSS<BQ>::mma(dpt, tc::desc(v_addr + kp, 16, 1024),
                           tc::desc(g_addr + qp, 16, 1024), kk > 0);
    }
    tc::wg_commit();
    tc::wg_wait();
    tc::reg_fence(st);
    tc::reg_fence(dpt);

    // P^T, then pd = P^T x mult and dS^T = P^T (dP^T x mult - delta); the
    // causal mask only where the chunk reaches below a key's first row
    const bool diag = a.causal && q0 + a.q_off < key0 + 63;
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      const float2 ls = *reinterpret_cast<const float2*>(lse_s + 8 * n + cq);
      const float2 dl = *reinterpret_cast<const float2*>(dta_s + 8 * n + cq);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int q = q0 + 8 * n + cq + jj;
        const float lq = jj ? ls.y : ls.x, dlq = jj ? dl.y : dl.x;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int idx = 4 * n + 2 * i + jj;
          const int key = kr + 8 * i;
          float sv = st[idx] * a.scale + madd[i];
          if (dead[i] || (diag && key > a.q_off + q)) sv = NEG_INF;
          const float p = exp2f((sv - lq) * tc::LOG2E);
          float dp = dpt[idx], pd = p;
          if (a.drop.dropout) {
            const float mult =
                dropout_keep(a.drop.seed, drow, q, key, a.drop.thr)
                    ? a.drop.mult : 0.f;
            dp *= mult;
            pd = p * mult;
          }
          st[idx] = pd;
          dpt[idx] = p * (dp - dlq);
        }
      }
    }
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      tc::to_a(st, kk, pa[kk]);
      tc::to_a(dpt, kk, sa[kk]);
    }

    // dV += pd dO and dK += dS Q over the chunk's q rows in k16 steps
    tc::reg_fence(dv);
    tc::reg_fence(dk);
    tc::reg_fence(pa);
    tc::reg_fence(sa);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t rows = kk * 16 * tc::ROW_BYTES;
      tc::WgmmaRS<D>::mma(dv, pa[kk],
                          tc::desc(g_addr + rows, BQ * tc::ROW_BYTES, 1024));
      tc::WgmmaRS<D>::mma(dk, sa[kk],
                          tc::desc(q_addr + rows, BQ * tc::ROW_BYTES, 1024));
    }
    tc::wg_commit();
    tc::wg_wait();
    tc::reg_fence(dv);
    tc::reg_fence(dk);
    if (t == 0) tc::bar_arrive(&empty[s]);
  }

  // dk = scale x dK, dv = dV, in bf16, [B, S_k, H_kv, D] contiguous
  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(a.dk);
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(a.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr + 8 * i;
    if (key >= a.s_k) continue;
    const size_t o = (((size_t)b * a.s_k + key) * a.H_kv + hk) * D + cq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dkp + o + 8 * n) = tc::pack_bf16(
          dk[4 * n + 2 * i] * a.scale, dk[4 * n + 2 * i + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvp + o + 8 * n) =
          tc::pack_bf16(dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
    }
  }
}

template <int D>
int launch_dkv_tc(const BwdArgs& a, int B, cudaStream_t stream) {
  using Tile = DkvTile<D>;
  if (B == 0 || a.s_k == 0 || a.H_kv == 0) return 0;
  CUtensorMap mq, mk, mv, mg;
  int e = tc::make_map(&mq, a.q, B, a.s_q, a.H, D, a.q_sb, a.q_ss, a.q_sh,
                       Tile::BQ);
  if (e == 0)
    e = tc::make_map(&mg, a.g, B, a.s_q, a.H, D, a.g_sb, a.g_ss, a.g_sh,
                     Tile::BQ);
  if (e == 0)
    e = tc::make_map(&mk, a.k, B, a.s_k, a.H_kv, D, a.k_sb, a.k_ss, a.k_sh,
                     TC_BN);
  if (e == 0)
    e = tc::make_map(&mv, a.v, B, a.s_k, a.H_kv, D, a.k_sb, a.k_ss, a.k_sh,
                     TC_BN);
  if (e != 0) return e;
  auto kern = flash_bwd_dkv_tc_kernel<D>;
  cudaError_t ce = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid(B * a.H_kv, (a.s_k + TC_BN - 1) / TC_BN);
  kern<<<grid, TC_THREADS, Tile::SMEM, stream>>>(mq, mk, mv, mg, a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// kernel 2 in bf16: the tensor-core dQ kernel
// ---------------------------------------------------------------------------

constexpr int DQ_BM = 128;               // q rows per tile

template <int D> struct DqTile {
  static constexpr int BK = 64;                    // keys per chunk
  static constexpr int STAGES = D == 64 ? 4 : 3;   // ring slots
  static constexpr int PANELS = D / 64;            // 64-wide head-dim panels
  static constexpr int QG_BYTES = DQ_BM * D * 2;   // the tile's q, or its dO
  static constexpr int KV_BYTES = BK * D * 2;      // one K or V chunk
  static constexpr int SLOT = 2 * KV_BYTES;        // K and V (1 KB multiple)
  static constexpr int SMEM =
      2 * QG_BYTES + STAGES * SLOT + 64 * 8 + 1024;   // + barriers, align
};

// Tile i of the longest-first order: all (batch, head)s of the last q tile
// first, then those of the one before it.
struct DqTileAt {
  int b, h, hk, q0, n_end, n_chunks;
  __device__ DqTileAt(const BwdArgs& a, int B, int i, int bk) {
    const int bh = i % (B * a.H);
    const int n_qt = (a.s_q + DQ_BM - 1) / DQ_BM;
    b = bh / a.H;
    h = bh % a.H;
    hk = h / (a.H / a.H_kv);
    q0 = (n_qt - 1 - i / (B * a.H)) * DQ_BM;
    // keys any row of this tile can see
    n_end = min(a.n_keys, a.s_k);
    if (a.causal)
      n_end = max(0, min(n_end, a.q_off + q0 + min(DQ_BM, a.s_q - q0)));
    n_chunks = (n_end + bk - 1) / bk;
  }
};

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_g,
                       const BwdArgs a, const int B, const int n_tiles) {
  using Tile = DqTile<D>;
  constexpr int BK = Tile::BK, ST = Tile::STAGES, PN = Tile::PANELS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = tc::align1024(smem_raw);          // [PN][DQ_BM][64]
  uint8_t* g_s = q_s + Tile::QG_BYTES;             // [PN][DQ_BM][64]
  uint8_t* ring = g_s + Tile::QG_BYTES;            // [ST] x {K, V}[PN][BK][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + ST * Tile::SLOT);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_empty + 1;
  uint64_t* empty = full + ST;

  if (threadIdx.x == 0) {
    tc::bar_init(q_full, 1);
    tc::bar_init(q_empty, 2);           // one arrival per consumer warpgroup
    for (int s = 0; s < ST; ++s) {
      tc::bar_init(&full[s], 1);
      tc::bar_init(&empty[s], 2);
    }
    tc::bar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp >= 8) {
    tc::regs_dec<24>();
    // producer: one thread issues every copy, tile after tile; the K/V ring
    // runs on across tiles, so the next tile's first chunks arrive while
    // this one's last are multiplied
    if (threadIdx.x == 2 * tc::WG) {
      int g = 0;                                      // chunks issued
      for (int i = blockIdx.x, it = 0; i < n_tiles; i += gridDim.x, ++it) {
        const DqTileAt tl(a, B, i, BK);
        if (it > 0) tc::bar_wait(q_empty, (it - 1) & 1);
        tc::bar_expect_tx(q_full, 2 * Tile::QG_BYTES);
        for (int p = 0; p < PN; ++p) {
          tc::tma_load(q_s + p * DQ_BM * tc::ROW_BYTES, &tm_q, q_full,
                       64 * p, tl.h, tl.q0, tl.b);
          tc::tma_load(g_s + p * DQ_BM * tc::ROW_BYTES, &tm_g, q_full,
                       64 * p, tl.h, tl.q0, tl.b);
        }
        for (int j = 0; j < tl.n_chunks; ++j, ++g) {
          const int s = g % ST;
          if (g >= ST) tc::bar_wait(&empty[s], ((g / ST) - 1) & 1);
          uint8_t* ks = ring + s * Tile::SLOT;
          uint8_t* vs = ks + Tile::KV_BYTES;
          tc::bar_expect_tx(&full[s], Tile::SLOT);
          for (int p = 0; p < PN; ++p) {
            tc::tma_load(ks + p * BK * tc::ROW_BYTES, &tm_k, &full[s],
                         64 * p, tl.hk, j * BK, tl.b);
            tc::tma_load(vs + p * BK * tc::ROW_BYTES, &tm_v, &full[s],
                         64 * p, tl.hk, j * BK, tl.b);
          }
        }
      }
    }
    return;
  }

  tc::regs_inc<240>();
  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63 of each tile
  const int wg = warp / 4;
  const int t = threadIdx.x % tc::WG;
  const int lane = t % 32;
  const int cq = 2 * (lane % 4);               // columns 8 n + cq + {0, 1}
  const uint32_t q_addr = tc::smem_u32(q_s) + 64 * wg * tc::ROW_BYTES;
  const uint32_t g_addr = tc::smem_u32(g_s) + 64 * wg * tc::ROW_BYTES;
  const float c2 = a.scale * tc::LOG2E;
  __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(a.dq);

  int g = 0;                                           // chunks consumed
  for (int i = blockIdx.x, it = 0; i < n_tiles; i += gridDim.x, ++it) {
    const DqTileAt tl(a, B, i, BK);
    const int row0 = tl.q0 + 64 * wg;                  // first row of the wg
    const int r = row0 + 16 * (t / 32) + lane / 4;   // fragment rows r, r + 8
    const uint32_t drow = (uint32_t)(tl.b * a.H + tl.h);
    const float* km = a.kmask ? a.kmask + (size_t)tl.b * a.m_sb : nullptr;
    // each fragment row's lse and delta; rows past S_q: lse = +inf makes
    // their p 0
    float lq[2], lq2[2], dl[2];
    const size_t sbase = ((size_t)tl.b * a.H + tl.h) * a.s_q;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const bool in = r + 8 * k < a.s_q;
      lq[k] = in ? a.lse[sbase + r + 8 * k] : INFINITY;
      dl[k] = in ? a.delta[sbase + r + 8 * k] : 0.f;
      lq2[k] = lq[k] * tc::LOG2E;
    }
    float dq[D / 2];
#pragma unroll
    for (int k = 0; k < D / 2; ++k) dq[k] = 0.f;

    tc::bar_wait(q_full, it & 1);
    if (tl.n_chunks == 0 && t == 0) tc::bar_arrive(q_empty);
    for (int j = 0; j < tl.n_chunks; ++j, ++g) {
      const int s = g % ST;
      const uint32_t ph = (g / ST) & 1;
      const int c0 = j * BK;
      const uint32_t k_addr = tc::smem_u32(ring + s * Tile::SLOT);
      const uint32_t v_addr = k_addr + Tile::KV_BYTES;

      // S = Q K^T and dP = dO V^T over D in k16 steps
      float sc[BK / 2], dp[BK / 2];
      tc::bar_wait(&full[s], ph);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;        // 16 values into the row
        const uint32_t qp = (kk / 4) * DQ_BM * tc::ROW_BYTES + off;
        const uint32_t kp = (kk / 4) * BK * tc::ROW_BYTES + off;
        tc::WgmmaSS<BK>::mma(sc, tc::desc(q_addr + qp, 16, 1024),
                             tc::desc(k_addr + kp, 16, 1024), kk > 0);
        tc::WgmmaSS<BK>::mma(dp, tc::desc(g_addr + qp, 16, 1024),
                             tc::desc(v_addr + kp, 16, 1024), kk > 0);
      }
      tc::wg_commit();
      tc::wg_wait();
      tc::reg_fence(sc);
      tc::reg_fence(dp);
      // the tile's last products with q and dO: the producer may load the
      // next tile's
      if (j == tl.n_chunks - 1 && t == 0) tc::bar_arrive(q_empty);

      // p = exp(s - lse) in log2 units. Chunks off the diagonal and the
      // valid-key edge, without a key mask, need no mask; the others add
      // the key mask and mask per element (-1e30, as the reference).
      const bool masked = (a.causal && c0 + BK - 1 > a.q_off + row0) ||
                          c0 + BK > tl.n_end || km != nullptr;
      if (!masked) {
#pragma unroll
        for (int idx = 0; idx < BK / 2; ++idx)
          sc[idx] = tc::ex2(fmaf(sc[idx], c2, -lq2[(idx / 2) % 2]));
      } else {
#pragma unroll
        for (int idx = 0; idx < BK / 2; ++idx) {
          const int k = (idx / 2) % 2;
          const int key = c0 + 8 * (idx / 4) + cq + idx % 2;
          float v = sc[idx] * a.scale;
          if (km && key < tl.n_end) v += km[key];
          if (key >= tl.n_end || (a.causal && key > a.q_off + r + 8 * k))
            v = NEG_INF;
          sc[idx] = tc::ex2((v - lq[k]) * tc::LOG2E);
        }
      }
      // dS = p (dP x mult - delta), rounded to bf16 as the A operand
#pragma unroll
      for (int idx = 0; idx < BK / 2; ++idx) {
        const int k = (idx / 2) % 2;
        float d = dp[idx];
        if (a.drop.dropout) {
          const int key = c0 + 8 * (idx / 4) + cq + idx % 2;
          d = dropout_keep(a.drop.seed, drow, r + 8 * k, key, a.drop.thr)
                  ? d * a.drop.mult : 0.f;
        }
        sc[idx] = sc[idx] * (d - dl[k]);
      }
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) tc::to_a(sc, kk, pa[kk]);

      // dQ += dS K over the chunk's keys in k16 steps, K read MN-major
      tc::reg_fence(dq);
      tc::reg_fence(pa);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        tc::WgmmaRS<D>::mma(
            dq, pa[kk],
            tc::desc(k_addr + kk * 16 * tc::ROW_BYTES, BK * tc::ROW_BYTES,
                     1024));
      tc::wg_commit();
      tc::wg_wait();
      tc::reg_fence(dq);
      if (t == 0) tc::bar_arrive(&empty[s]);
    }

    // dq = scale x dQ in bf16, [B, S_q, H, D] contiguous
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int row = r + 8 * k;
      if (row >= a.s_q) continue;
      __nv_bfloat16* o =
          dqp + (((size_t)tl.b * a.s_q + row) * a.H + tl.h) * D + cq;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(o + 8 * n) = tc::pack_bf16(
            dq[4 * n + 2 * k] * a.scale, dq[4 * n + 2 * k + 1] * a.scale);
    }
  }
}

template <int D>
int launch_dq_tc(const BwdArgs& a, int B, cudaStream_t stream) {
  using Tile = DqTile<D>;
  if (B == 0 || a.s_q == 0 || a.H == 0) return 0;
  CUtensorMap mq, mk, mv, mg;
  const int s_k = max(a.s_k, 1);
  int e = tc::make_map(&mq, a.q, B, a.s_q, a.H, D, a.q_sb, a.q_ss, a.q_sh,
                       DQ_BM);
  if (e == 0)
    e = tc::make_map(&mg, a.g, B, a.s_q, a.H, D, a.g_sb, a.g_ss, a.g_sh,
                     DQ_BM);
  if (e == 0)
    e = tc::make_map(&mk, a.k, B, s_k, a.H_kv, D, a.k_sb, a.k_ss, a.k_sh,
                     Tile::BK);
  if (e == 0)
    e = tc::make_map(&mv, a.v, B, s_k, a.H_kv, D, a.k_sb, a.k_ss, a.k_sh,
                     Tile::BK);
  if (e != 0) return e;
  auto kern = flash_bwd_dq_tc_kernel<D>;
  int dev = 0, sms = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce == cudaSuccess)
    ce = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  if (ce != cudaSuccess) return (int)ce;
  // persistent blocks, one an SM, walking the tiles longest first
  const int n_tiles = ((a.s_q + DQ_BM - 1) / DQ_BM) * B * a.H;
  kern<<<min(n_tiles, sms), TC_THREADS, Tile::SMEM, stream>>>(
      mq, mk, mv, mg, a, B, n_tiles);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const BwdArgs& a, int B, bool dkv, cudaStream_t stream) {
  constexpr int BT = tile_rows<D>();
  const size_t smem = sizeof(float) * (4 * (size_t)BT * (D + 4) +
                                       (dkv ? 2 : 1) * (size_t)BT * BT +
                                       2 * BT);
  void (*kern)(const BwdArgs) =
      dkv ? &flash_bwd_dkv_kernel<T, D> : &flash_bwd_dq_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int rows = dkv ? a.s_k : a.s_q;
  const dim3 grid((rows + BT - 1) / BT, dkv ? a.H_kv : a.H, B);
  if (grid.x == 0 || B == 0) return 0;
  kern<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const BwdArgs& a, int B, bool dkv, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(a, B, dkv, stream);
    case 128: return launch<T, 128>(a, B, dkv, stream);
    case 256: return launch<T, 256>(a, B, dkv, stream);
  }
  return ERR_NO_INSTANCE;
}

int run(const void* q, const void* k, const void* v, const void* g,
        const void* lse, const void* delta, const void* kmask, void* dq,
        void* dk, void* dv, long long q_sb, long long q_ss, long long q_sh,
        long long g_sb, long long g_ss, long long g_sh, long long k_sb,
        long long k_ss, long long k_sh, long long m_sb, int B, int S_q,
        int S_k, int H, int H_kv, int D, int n_keys, int causal, int q_off,
        int dropout, unsigned int seed, float drop_thr, float drop_mult,
        int dtype, int* tc, void* stream, bool dkv) {
  *tc = 0;
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.g = g;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.kmask = static_cast<const float*>(kmask);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.g_sb = g_sb; a.g_ss = g_ss; a.g_sh = g_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.m_sb = m_sb;
  a.s_q = S_q; a.s_k = S_k; a.H = H; a.H_kv = H_kv;
  a.n_keys = n_keys;
  a.causal = causal;
  a.q_off = q_off;
  a.scale = (float)(1.0 / sqrt((double)D));
  a.drop = Dropout{dropout, seed, drop_thr, drop_mult};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(D, a, B, dkv, s);
  if (dtype != 1) return ERR_NO_INSTANCE;
  // bf16 at D = 64 and 128: the tensor-core kernels, chosen by dtype and
  // head dim (never after a failed launch)
  if (D == 64 || D == 128) {
    int e;
    if (dkv)
      e = D == 64 ? launch_dkv_tc<64>(a, B, s) : launch_dkv_tc<128>(a, B, s);
    else
      e = D == 64 ? launch_dq_tc<64>(a, B, s) : launch_dq_tc<128>(a, B, s);
    if (e == 0) *tc = 1;
    return e;
  }
  if (D == 256) return launch<__nv_bfloat16, 256>(a, B, dkv, s);
  return ERR_NO_INSTANCE;
}

}  // namespace

extern "C" {

// q [B, S_q, H, D] and dO (g) [B, S_q, H, D] with element strides (q_s*,
// g_s*); k/v [B, S_k, H_kv, D] with strides (k_s*); every head dim
// contiguous. lse, delta [B, H, S_q] f32 contiguous. kmask additive f32
// [B, S_k] with batch stride m_sb, or null. n_keys: keys at or past it are
// masked. causal: q row i sees keys <= q_off + i. dropout as in flash_fwd.
// flash_bwd_dq writes dq [B, S_q, H, D] contiguous (dk, dv unused, may be
// null); flash_bwd_dkv writes dk, dv [B, S_k, H_kv, D] contiguous (dq
// unused). dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs
// alike). *tc is set to 1 when a tensor-core kernel was launched (bf16 at
// D = 64 or 128), else 0. Launch on `stream`; return
// cudaGetLastError() after the launch (0 on success), ERR_TENSOR_MAP when a
// tensor map cannot describe an operand, or -1 for a dtype/head_dim with
// no instance.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                 const void* lse, const void* delta, const void* kmask,
                 void* dq, void* dk, void* dv, long long q_sb, long long q_ss,
                 long long q_sh, long long g_sb, long long g_ss,
                 long long g_sh, long long k_sb, long long k_ss,
                 long long k_sh, long long m_sb, int B, int S_q, int S_k,
                 int H, int H_kv, int D, int n_keys, int causal, int q_off,
                 int dropout, unsigned int seed, float drop_thr,
                 float drop_mult, int dtype, int* tc, void* stream) {
  return run(q, k, v, g, lse, delta, kmask, dq, dk, dv, q_sb, q_ss, q_sh,
             g_sb, g_ss, g_sh, k_sb, k_ss, k_sh, m_sb, B, S_q, S_k, H, H_kv,
             D, n_keys, causal, q_off, dropout, seed, drop_thr, drop_mult,
             dtype, tc, stream, false);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                  const void* lse, const void* delta, const void* kmask,
                  void* dq, void* dk, void* dv, long long q_sb,
                  long long q_ss, long long q_sh, long long g_sb,
                  long long g_ss, long long g_sh, long long k_sb,
                  long long k_ss, long long k_sh, long long m_sb, int B,
                  int S_q, int S_k, int H, int H_kv, int D, int n_keys,
                  int causal, int q_off, int dropout, unsigned int seed,
                  float drop_thr, float drop_mult, int dtype, int* tc,
                  void* stream) {
  return run(q, k, v, g, lse, delta, kmask, dq, dk, dv, q_sb, q_ss, q_sh,
             g_sb, g_ss, g_sh, k_sb, k_ss, k_sh, m_sb, B, S_q, S_k, H, H_kv,
             D, n_keys, causal, q_off, dropout, seed, drop_thr, drop_mult,
             dtype, tc, stream, true);
}

const char* attn_error_string(int code) { return attn::error_string(code); }

}  // extern "C"
