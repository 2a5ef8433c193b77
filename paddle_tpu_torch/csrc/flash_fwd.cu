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
// mask instead of reading it. l sums the undropped p, and p.V takes
// p x keep x mult rounded to q's dtype. It writes out in q's dtype and
// lse = m + log(max(l, 1e-30)) in f32, which the backward kernels read.
//
// q, k and v are read in the reference's [B, S, H, D] layout through
// element strides, so the strided views of the packed qkv projection are
// read in place, without a transpose or a copy.
//
// Bound. At the forward's shape on the main path (B = 8, S = 1024, H = 16,
// D = 64, causal, bf16) the work is ~17.2 GFLOP (17 us at the tensor
// cores' 989 TFLOP/s) over ~67 MB of q/k/v/out (20 us at 3.35 TB/s): bound
// by bytes, with operations close behind. A kernel near the bound needs
// both products on the tensor cores and its tiles arriving while the
// previous ones are multiplied.
//
// Design of the bf16 instance (flash_fwd_tc_kernel). The blocks are
// persistent, one an SM, each walking q tiles of 128 rows of one (batch,
// head) in a longest-first order (the causal tiles with the most keys
// first, so the short ones even out the end). A block is 384 threads: two
// consumer warpgroups of 64 rows each and a producer warpgroup, of which
// one thread works; the group hands its registers to the consumers
// (setmaxnreg), whose accumulators need them.
// - The producer issues TMA loads: a tile's q rows once (released by the
//   consumers after the tile's last S product), then its K and V chunks of
//   BK keys through a ring of STAGES slots in shared memory, in the
//   128-byte swizzle the tensor cores read (mbarriers: full per K and per V
//   slot, empty per slot, full and empty for q). The ring runs on across
//   tiles, so the next tile's q and first chunks arrive while this one's
//   last are multiplied and written: a block never waits on a cold start
//   after its first tile. The tensor maps describe the strided
//   [B, S, H, D] views.
// - Each consumer warpgroup computes S = Q K^T with wgmma (both operands
//   in shared memory, K-major) into f32 registers. Chunks off the
//   diagonal and the valid-key edge, without a key mask, take their row
//   maxima from the raw scores; the others are scaled, take the key mask,
//   and are masked per element from its (row, key) coordinates. The
//   online softmax (m, l, the rescale) stays in registers in log2 units, a
//   row spread over the four threads of a quad, p = 2^(s - m) one FFMA and
//   one MUFU.EX2. P, rounded to bf16 after the dropout, becomes the A
//   operand of O += P V in registers; V is read MN-major from shared
//   memory through the transpose flag.
// - A tile visits chunks only up to its last row's visible key.
// Chunks: BK = 128 keys at D = 64 and 128, 64 at D = 256, which keeps the q
// tile and a ring of 3 slots (D = 64) or 2 (D >= 128) within 227 KB.
//
// float32 keeps the CUDA-core tile (attn_tile_kernel in attention.cuh),
// chosen by dtype in flash_fwd below: a TF32 product would not hold f32's
// tolerance of 2e-5 against the twin.
#include "attention.cuh"
#include "tc_attention.cuh"

namespace {

using namespace attn;

constexpr int TC_BM = 128;               // q rows per tile
// two consumer warpgroups, then the producer's: one of its threads issues
// the copies; the group exists so that it can hand its registers over
constexpr int TC_THREADS = 3 * tc::WG;

template <int D> struct FwdTile {
  static constexpr int BK = D <= 128 ? 128 : 64;   // keys per chunk
  static constexpr int STAGES = D == 64 ? 3 : 2;   // ring slots
  static constexpr int PANELS = D / 64;            // 64-wide head-dim panels
  static constexpr int Q_BYTES = TC_BM * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;      // one K or V chunk
  static constexpr int SMEM =
      Q_BYTES + 2 * STAGES * KV_BYTES + 64 * 8 + 1024;   // + barriers, align
};

struct FwdArgs {
  const float* kmask;       // additive [B, S_k] (batch stride m_sb), or null
  void* out;                // [B, S_q, H, D] contiguous bf16
  float* lse;               // [B, H, S_q] f32
  long long m_sb;
  int B, s_q, H, H_kv;
  int n_keys;
  int causal;
  int q_off;
  float scale;
  Dropout drop;
};

// Tile i of the longest-first order: all (batch, head)s of the last q tile
// first, then those of the one before it.
struct FwdTileAt {
  int b, h, hk, q0, n_end, n_chunks;
  __device__ FwdTileAt(const FwdArgs& a, int i, int bk) {
    const int bh = i % (a.B * a.H);
    const int n_qt = (a.s_q + TC_BM - 1) / TC_BM;
    b = bh / a.H;
    h = bh % a.H;
    hk = h / (a.H / a.H_kv);
    q0 = (n_qt - 1 - i / (a.B * a.H)) * TC_BM;
    // keys any row of this tile can see
    n_end = a.n_keys;
    if (a.causal)
      n_end = max(0, min(n_end, a.q_off + q0 + min(TC_BM, a.s_q - q0)));
    n_chunks = (n_end + bk - 1) / bk;
  }
};

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const FwdArgs a, const int n_tiles) {
  using Tile = FwdTile<D>;
  constexpr int BK = Tile::BK, ST = Tile::STAGES, PN = Tile::PANELS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = tc::align1024(smem_raw);             // [PN][TC_BM][64]
  uint8_t* k_s = q_s + Tile::Q_BYTES;                 // [ST][PN][BK][64]
  uint8_t* v_s = k_s + ST * Tile::KV_BYTES;           // [ST][PN][BK][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + ST * Tile::KV_BYTES);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* empty = v_full + ST;

  if (threadIdx.x == 0) {
    tc::bar_init(q_full, 1);
    tc::bar_init(q_empty, 2);           // one arrival per consumer warpgroup
    for (int s = 0; s < ST; ++s) {
      tc::bar_init(&k_full[s], 1);
      tc::bar_init(&v_full[s], 1);
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
        const FwdTileAt tl(a, i, BK);
        if (it > 0) tc::bar_wait(q_empty, (it - 1) & 1);
        tc::bar_expect_tx(q_full, Tile::Q_BYTES);
        for (int p = 0; p < PN; ++p)
          tc::tma_load(q_s + p * TC_BM * tc::ROW_BYTES, &tm_q, q_full,
                       64 * p, tl.h, tl.q0, tl.b);
        for (int j = 0; j < tl.n_chunks; ++j, ++g) {
          const int s = g % ST;
          if (g >= ST) tc::bar_wait(&empty[s], ((g / ST) - 1) & 1);
          uint8_t* ks = k_s + s * Tile::KV_BYTES;
          uint8_t* vs = v_s + s * Tile::KV_BYTES;
          tc::bar_expect_tx(&k_full[s], Tile::KV_BYTES);
          for (int p = 0; p < PN; ++p)
            tc::tma_load(ks + p * BK * tc::ROW_BYTES, &tm_k, &k_full[s],
                         64 * p, tl.hk, j * BK, tl.b);
          tc::bar_expect_tx(&v_full[s], Tile::KV_BYTES);
          for (int p = 0; p < PN; ++p)
            tc::tma_load(vs + p * BK * tc::ROW_BYTES, &tm_v, &v_full[s],
                         64 * p, tl.hk, j * BK, tl.b);
        }
      }
    }
    return;
  }

  tc::regs_inc<240>();
  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63 of each tile.
  // Scores and the running max are kept in log2 units (x log2(e)), so
  // p = 2^(s - m) is one FFMA and one MUFU.EX2; the reference's -1e30
  // sentinel scales with them.
  const int wg = warp / 4;
  const int t = threadIdx.x % tc::WG;
  const int lane = t % 32;
  const int cq = 2 * (lane % 4);               // columns 8 n + cq + {0, 1}
  const uint32_t q_addr = tc::smem_u32(q_s) + 64 * wg * tc::ROW_BYTES;
  const float neg2 = NEG_INF * tc::LOG2E;
  const float c2 = a.scale * tc::LOG2E;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);

  int g = 0;                                           // chunks consumed
  for (int i = blockIdx.x, it = 0; i < n_tiles; i += gridDim.x, ++it) {
    const FwdTileAt tl(a, i, BK);
    const int row0 = tl.q0 + 64 * wg;                  // first row of the wg
    const int r = row0 + 16 * (t / 32) + lane / 4;   // fragment rows r, r + 8
    const uint32_t drow = (uint32_t)(tl.b * a.H + tl.h);
    const float* km = a.kmask ? a.kmask + tl.b * a.m_sb : nullptr;

    float o[D / 2];
#pragma unroll
    for (int k = 0; k < D / 2; ++k) o[k] = 0.f;
    float m[2] = {neg2, neg2}, l[2] = {0.f, 0.f};

    tc::bar_wait(q_full, it & 1);
    if (tl.n_chunks == 0 && t == 0) tc::bar_arrive(q_empty);
    for (int j = 0; j < tl.n_chunks; ++j, ++g) {
      const int s = g % ST;
      const uint32_t ph = (g / ST) & 1;
      const int c0 = j * BK;
      const uint32_t k_addr = tc::smem_u32(k_s + s * Tile::KV_BYTES);
      const uint32_t v_addr = tc::smem_u32(v_s + s * Tile::KV_BYTES);

      // S = Q K^T over D in k16 steps
      float sc[BK / 2];
      tc::bar_wait(&k_full[s], ph);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;        // 16 values into the row
        tc::WgmmaSS<BK>::mma(
            sc,
            tc::desc(q_addr + (kk / 4) * TC_BM * tc::ROW_BYTES + off, 16,
                     1024),
            tc::desc(k_addr + (kk / 4) * BK * tc::ROW_BYTES + off, 16, 1024),
            kk > 0);
      }
      tc::wg_commit();
      tc::wg_wait();
      tc::reg_fence(sc);
      // the tile's last product with Q: the producer may load the next
      if (j == tl.n_chunks - 1 && t == 0) tc::bar_arrive(q_empty);

      // Chunks off the diagonal and the valid-key edge, without a key
      // mask, need no mask: their row maxima come from the raw scores. The
      // others scale first, add the key mask, and mask per element: causal
      // with the reference's -1e30, keys past the bound (never visited)
      // with -inf, so their p is 0.
      const bool masked = (a.causal && c0 + BK - 1 > a.q_off + row0) ||
                          c0 + BK > tl.n_end || km != nullptr;
      float mx[2] = {-INFINITY, -INFINITY};
      float ce = c2;                             // score scale left to apply
      if (!masked) {
#pragma unroll
        for (int idx = 0; idx < BK / 2; ++idx)
          mx[(idx / 2) % 2] = fmaxf(mx[(idx / 2) % 2], sc[idx]);
#pragma unroll
        for (int k = 0; k < 2; ++k) mx[k] *= c2;
      } else {
        ce = 1.f;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int key = c0 + 8 * n + cq + jj;
            const float madd = (km && key < tl.n_end) ? km[key] : 0.f;
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              float v =
                  fmaf(sc[4 * n + 2 * k + jj], a.scale, madd) * tc::LOG2E;
              if (a.causal && key > a.q_off + r + 8 * k) v = neg2;
              if (key >= tl.n_end) v = -INFINITY;
              sc[4 * n + 2 * k + jj] = v;
              mx[k] = fmaxf(mx[k], v);
            }
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
      // p = 2^(s - m): l takes it undropped, P.V takes it dropped
#pragma unroll
      for (int idx = 0; idx < BK / 2; ++idx) {
        const int k = (idx / 2) % 2;
        float p = tc::ex2(fmaf(sc[idx], ce, -m[k]));
        rs[k] += p;
        if (a.drop.dropout) {
          const int key = c0 + 8 * (idx / 4) + cq + idx % 2;
          p = dropout_keep(a.drop.seed, drow, r + 8 * k, key, a.drop.thr)
                  ? p * a.drop.mult : 0.f;
        }
        sc[idx] = p;
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) l[k] = l[k] * alpha[k] + rs[k];
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) tc::to_a(sc, kk, pa[kk]);
#pragma unroll
      for (int k = 0; k < D / 2; ++k) o[k] *= alpha[(k / 2) % 2];

      // O += P V over the chunk's keys in k16 steps
      tc::bar_wait(&v_full[s], ph);
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

    // out = O / max(l, 1e-30) in bf16, lse = m + log(max(l, 1e-30))
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      l[k] += __shfl_xor_sync(0xffffffffu, l[k], 1);
      l[k] += __shfl_xor_sync(0xffffffffu, l[k], 2);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int row = r + 8 * k;
      if (row >= a.s_q) continue;
      const float den = fmaxf(l[k], EPS);
      const float inv = __frcp_rn(den);
      __nv_bfloat16* orow =
          out + (((size_t)tl.b * a.s_q + row) * a.H + tl.h) * D + cq;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) = tc::pack_bf16(
            o[4 * n + 2 * k] * inv, o[4 * n + 2 * k + 1] * inv);
      if (lane % 4 == 0)
        a.lse[((size_t)tl.b * a.H + tl.h) * a.s_q + row] =
            m[k] * tc::LN2 + logf(den);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, long long q_sb,
              long long q_ss, long long q_sh, long long k_sb, long long k_ss,
              long long k_sh, const FwdArgs& a, cudaStream_t stream) {
  using Tile = FwdTile<D>;
  if (a.B == 0 || a.s_q == 0 || a.H == 0) return 0;
  CUtensorMap mq, mk, mv;
  // the key maps end at n_keys: keys past it are never read
  const int s_k = max(a.n_keys, 1);
  int e = tc::make_map(&mq, q, a.B, a.s_q, a.H, D, q_sb, q_ss, q_sh, TC_BM);
  if (e == 0)
    e = tc::make_map(&mk, k, a.B, s_k, a.H_kv, D, k_sb, k_ss, k_sh,
                     Tile::BK);
  if (e == 0)
    e = tc::make_map(&mv, v, a.B, s_k, a.H_kv, D, k_sb, k_ss, k_sh,
                     Tile::BK);
  if (e != 0) return e;
  auto kern = flash_fwd_tc_kernel<D>;
  int dev = 0, sms = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce == cudaSuccess)
    ce = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  if (ce != cudaSuccess) return (int)ce;
  // persistent blocks, one an SM, walking the tiles longest first
  const int n_tiles = ((a.s_q + TC_BM - 1) / TC_BM) * a.B * a.H;
  kern<<<min(n_tiles, sms), TC_THREADS, Tile::SMEM, stream>>>(mq, mk, mv, a,
                                                              n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, S_q, H, D] with element strides (q_sb, q_ss, q_sh); k/v [B, S_k,
// H_kv, D] with strides (k_sb, k_ss, k_sh); every head dim contiguous.
// kmask additive f32 [B, S_k] with batch stride m_sb (0 broadcasts one
// row), or null. out [B, S_q, H, D] contiguous; lse [B, H, S_q] f32.
// n_keys: keys 0 .. n_keys-1 are attended (S_k, or the valid bound).
// dropout: 0 = none, else keep p where dropout_keep(seed, ..., drop_thr)
// and scale it by drop_mult (the f32s of rate * 2^24 and 1 / (1 - rate)).
// dtype: 0 = float32 (the CUDA-core tile), 1 = bfloat16 (the tensor-core
// kernel); *tc is set to 1 when the tensor-core kernel was launched, else
// 0. Launches on `stream` and returns cudaGetLastError() after the launch
// (0 on success), ERR_TENSOR_MAP when a tensor map cannot describe an
// operand, or -1 for a dtype/head_dim this library has no instance of.
int flash_fwd(const void* q, const void* k, const void* v, const void* kmask,
              void* out, void* lse, long long q_sb, long long q_ss,
              long long q_sh, long long k_sb, long long k_ss, long long k_sh,
              long long m_sb, int B, int S_q, int H, int H_kv, int D,
              int n_keys, int causal, int q_off, int dtype, int dropout,
              unsigned int seed, float drop_thr, float drop_mult, int* tc,
              void* stream) {
  *tc = 0;
  const float scale = (float)(1.0 / sqrt((double)D));
  const Dropout drop{dropout, seed, drop_thr, drop_mult};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    FwdArgs a{};
    a.kmask = static_cast<const float*>(kmask);
    a.out = out;
    a.lse = static_cast<float*>(lse);
    a.m_sb = m_sb;
    a.B = B; a.s_q = S_q; a.H = H; a.H_kv = H_kv;
    a.n_keys = n_keys;
    a.causal = causal;
    a.q_off = q_off;
    a.scale = scale;
    a.drop = drop;
    int e = ERR_NO_INSTANCE;
    switch (D) {
      case 64: e = launch_tc<64>(q, k, v, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                                 a, s); break;
      case 128: e = launch_tc<128>(q, k, v, q_sb, q_ss, q_sh, k_sb, k_ss,
                                   k_sh, a, s); break;
      case 256: e = launch_tc<256>(q, k, v, q_sb, q_ss, q_sh, k_sb, k_ss,
                                   k_sh, a, s); break;
    }
    if (e == 0) *tc = 1;
    return e;
  }
  if (dtype != 0) return ERR_NO_INSTANCE;
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
  a.scale = scale;
  a.drop = drop;
  return attn::launch_tile_d<float, float>(D, a, B, s);
}

const char* attn_error_string(int code) { return attn::error_string(code); }

}  // extern "C"
