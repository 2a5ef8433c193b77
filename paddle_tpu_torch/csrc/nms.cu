// Greedy non-maximum suppression with a fixed-size output, for Hopper
// (sm_90a): the card's side of the operator torch.ops.paddle_tpu_torch.
// nms_static (paddle_tpu_torch/vision/ops.py).
//
// Replaces: paddle_tpu/vision/ops.py:22 nms_static, which is not a Pallas
// kernel: the reference builds the [n, n] IoU matrix and sweeps it with an
// XLA fori_loop. Done with PyTorch ops the sweep would cost about n
// launches (8,400 an image for a 640 x 640 detector), so the port sweeps
// inside one block instead.
//
// The wrapper offsets the boxes by category and sorts them by score
// (descending, stable: the reference's argsort). Then two launches:
//   1. nms_mask_kernel: row i of the suppression bitmask holds, in words
//      of 64 columns, whether iou(box i, box j) > threshold for j > i
//      (sorted order). One block of 64 threads for each (row tile, column
//      tile) pair on or above the diagonal, the 64 column boxes staged in
//      shared memory; tiles below the diagonal are never read.
//   2. nms_sweep_kernel: one block walks the rows in order. The set of
//      suppressed rows lives in shared memory; the next live row of the
//      current word is found with __ffsll, kept, and its words are ORed
//      into the set by all threads. The walk stops once max_out rows are
//      kept. keep[] (the original indices, -1 past the count) and the
//      count are written by the block.
// The IoU is the reference's expression, evaluated in the same order with
// round-to-nearest intrinsics (no contraction into FMAs), so the bits
// equal PyTorch's elementwise evaluation of vision/detection.pairwise_iou
// and the kept set is exactly the twin's.
//
// Bound: operations, ~14 f32 operations for each of the n(n-1)/2 pairs;
// the bytes are the boxes (16 n) and the bitmask (8 n ceil(n/64)), written
// once and read at most once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // boxes of a tile: one bitmask word
constexpr int kSweepThreads = 256;

__device__ __forceinline__ float iou_rn(const float4 a, const float4 b,
                                        float area_a, float area_b,
                                        float eps) {
  // the reference's order: lt = max, rb = min, wh = max(rb - lt, 0),
  // inter = wh0 * wh1, inter / (((area_a + area_b) - inter) + eps)
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float den = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter),
                              eps);
  return __fdiv_rn(inter, den);
}

__device__ __forceinline__ float area_rn(const float4 a) {
  return fmaxf(__fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y)), 0.f);
}

// grid (tiles, tiles), block kTile: block (cx, ry) fills word cx of the 64
// rows of tile ry; only cx >= ry is computed.
__global__ void nms_mask_kernel(const float4* __restrict__ boxes, int n,
                                int words, float threshold, float eps,
                                unsigned long long* __restrict__ mask) {
  const int ry = blockIdx.y, cx = blockIdx.x;
  if (cx < ry) return;
  __shared__ float4 col[kTile];
  __shared__ float col_area[kTile];
  const int cols = min(kTile, n - cx * kTile);
  if (threadIdx.x < cols) {
    const float4 b = boxes[cx * kTile + threadIdx.x];
    col[threadIdx.x] = b;
    col_area[threadIdx.x] = area_rn(b);
  }
  __syncthreads();
  const int i = ry * kTile + threadIdx.x;
  if (i >= n) return;
  const float4 a = boxes[i];
  const float area_a = area_rn(a);
  const int first = (cx == ry) ? threadIdx.x + 1 : 0;   // j > i only
  unsigned long long word = 0;
  for (int c = first; c < cols; ++c) {
    if (iou_rn(a, col[c], area_a, col_area[c], eps) > threshold)
      word |= 1ull << c;
  }
  mask[(long long)i * words + cx] = word;
}

// one block: the greedy walk over the rows in sorted order. removed[] is
// the suppressed set, a bit a row.
__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                                 const int32_t* __restrict__ order, int n,
                                 int words, int max_out,
                                 int32_t* __restrict__ keep,
                                 int32_t* __restrict__ valid) {
  extern __shared__ unsigned long long removed[];
  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0ull;
  for (int k = threadIdx.x; k < max_out; k += blockDim.x) keep[k] = -1;
  __syncthreads();
  int count = 0;
  for (int w = 0; w < words && count < max_out; ++w) {
    const int rows = min(kTile, n - w * kTile);
    const unsigned long long in_range =
        rows == kTile ? ~0ull : ((1ull << rows) - 1ull);
    unsigned long long done = 0ull;   // bits of this word already walked
    while (count < max_out) {
      const unsigned long long live = ~removed[w] & in_range & ~done;
      if (live == 0ull) break;
      const int bit = __ffsll((long long)live) - 1;
      const int i = w * kTile + bit;
      if (threadIdx.x == 0) keep[count] = order[i];
      ++count;
      done |= (bit == 63) ? ~0ull : ((2ull << bit) - 1ull);
      __syncthreads();   // every thread has read removed[w]
      const unsigned long long* row = mask + (long long)i * words;
      for (int k = w + threadIdx.x; k < words; k += blockDim.x)
        removed[k] |= row[k];
      __syncthreads();
    }
  }
  if (threadIdx.x == 0) *valid = count;
}

}  // namespace

extern "C" {

// boxes: [n, 4] f32 xyxy in score order, contiguous and 16-byte aligned;
// order: [n] int32, the original index of each sorted box; mask: scratch
// of n * ceil(n/64) u64 words (never zeroed: every word read is written);
// keep: [max_out] int32; valid: one int32. Launches both kernels on
// `stream`; returns cudaGetLastError() after the launches (0 on success)
// or -1 for arguments the kernels do not take.
int nms_static(const void* boxes, const void* order, void* mask, void* keep,
               void* valid, int n, int max_out, float threshold, float eps,
               void* stream) {
  if (n < 1 || max_out < 1) return -1;
  const int words = (n + kTile - 1) / kTile;
  const size_t smem = (size_t)words * sizeof(unsigned long long);
  if (smem > 227 * 1024) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(words, words), kTile, 0, s>>>(
      static_cast<const float4*>(boxes), n, words, threshold, eps,
      static_cast<unsigned long long*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_sweep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_sweep_kernel<<<1, kSweepThreads, smem, s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const int32_t*>(order), n, words, max_out,
      static_cast<int32_t*>(keep), static_cast<int32_t*>(valid));
  return (int)cudaGetLastError();
}

const char* nms_error_string(int code) {
  if (code == -1) return "arguments the NMS kernels do not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
