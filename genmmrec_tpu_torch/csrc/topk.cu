// K3: exact masked top-k over the rows of a float32 score matrix.
//
// Replaces the TPU kernel genmmrec_tpu/ops/topk.py::_gather_kernel (reached
// through _candidate_gather_pallas from grouped_topk). On the TPU, grouped_topk
// folded each row into per-128-lane group maxima, picked the k best groups,
// gathered their k*128 candidates in this kernel by a one-hot MXU contraction,
// and sorted the candidates. That split, and the 16-wide recursion on top of
// it, were cost trade-offs of the TPU's lanes and sort network. Here one
// kernel serves every width and every k <= 64: the regeneration top-1 and the
// evaluation top-50.
//
// What it computes: the values in descending order, ties broken by the lower
// index first (lax.top_k's rule). Bit (j & 7) of byte (j >> 3) of a row's
// packed mask (little-endian, numpy packbits(bitorder="little")) marks column
// j as excluded; an excluded column takes part with the value -inf.
//
// What bounds it on the H100: one read of the score row (4 B a column) and of
// its mask byte. At the DiffMM-baby eval shape (4096 x 7050, k = 50) that is
// 115 MB of scores. The k merge rounds below are a latency chain of
// block-wide reductions, which bounds the small-row case.
//
// Design: one 256-thread block per row. Each thread scans a strided slice of
// the row (neighbouring threads on neighbouring columns, so the loads
// coalesce), applies the mask bit inline, and keeps a sorted list of its best
// (value, index) pairs, at most k long, in registers or local memory. Since a
// thread visits its columns in increasing order, a new pair displaces only
// strictly smaller values, which keeps the lower-index-first rule. The block
// then merges the lists in k rounds of a block-wide argmax over their heads:
// warp shuffles, then one warp over the per-warp winners. Column j is owned by
// thread j % 256, so the owner of the winning index advances its head.
// Writing all 256 x k candidates to shared memory instead would need about
// 100 KB of dynamic shared memory at k = 50.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Pair {
  float v;
  int i;
};

// a ranks before b: larger value, or equal value and lower index.
__device__ __forceinline__ bool before(const Pair& a, const Pair& b) {
  return a.v > b.v || (a.v == b.v && a.i < b.i);
}

__device__ __forceinline__ Pair warp_best(Pair p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Pair q;
    q.v = __shfl_xor_sync(0xffffffffu, p.v, off);
    q.i = __shfl_xor_sync(0xffffffffu, p.i, off);
    if (before(q, p)) p = q;
  }
  return p;
}

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
masked_topk_kernel(const float* __restrict__ scores, const unsigned char* __restrict__ mask,
                   int mask_stride, float* __restrict__ out_v, long long* __restrict__ out_i,
                   int n, int k) {
  __shared__ Pair warp_win[kWarps];
  __shared__ Pair win;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* s = scores + static_cast<long long>(row) * n;
  const unsigned char* m = mask ? mask + static_cast<long long>(row) * mask_stride : nullptr;

  float lv[KMAX];
  int li[KMAX];
  int cnt = 0;
  for (int j = tid; j < n; j += kThreads) {
    float x = __ldg(s + j);
    if (m && ((__ldg(m + (j >> 3)) >> (j & 7)) & 1)) x = -CUDART_INF_F;
    if (cnt < k || x > lv[k - 1]) {
      int p = cnt < k ? cnt : k - 1;
      while (p > 0 && lv[p - 1] < x) {
        lv[p] = lv[p - 1];
        li[p] = li[p - 1];
        --p;
      }
      lv[p] = x;
      li[p] = j;
      if (cnt < k) ++cnt;
    }
  }

  int head = 0;
  for (int r = 0; r < k; ++r) {
    // an exhausted list offers (-inf, INT_MAX), which any real pair beats
    Pair p = head < cnt ? Pair{lv[head], li[head]} : Pair{-CUDART_INF_F, 0x7fffffff};
    p = warp_best(p);
    if ((tid & 31) == 0) warp_win[tid >> 5] = p;
    __syncthreads();
    if (tid < 32) {
      Pair q = tid < kWarps ? warp_win[tid] : Pair{-CUDART_INF_F, 0x7fffffff};
      q = warp_best(q);
      if (tid == 0) {
        win = q;
        out_v[static_cast<long long>(row) * k + r] = q.v;
        out_i[static_cast<long long>(row) * k + r] = q.i;
      }
    }
    __syncthreads();
    if (head < cnt && li[head] == win.i) ++head;
  }
}

template <int KMAX>
cudaError_t launch(const float* scores, const unsigned char* mask, int mask_stride, float* out_v,
                   long long* out_i, int b, int n, int k, cudaStream_t stream) {
  masked_topk_kernel<KMAX><<<b, kThreads, 0, stream>>>(scores, mask, mask_stride, out_v, out_i,
                                                       n, k);
  return cudaGetLastError();
}

}  // namespace

// scores: (b, n) float32; mask: null or (b, mask_stride) uint8 with
// mask_stride >= ceil(n / 8); out_v: (b, k) float32; out_i: (b, k) int64.
// Requires 1 <= k <= min(n, 64). Returns a cudaError_t (0 on success).
extern "C" int masked_topk_f32(const void* scores, const void* mask, int mask_stride,
                               void* out_v, void* out_i, int b, int n, int k, void* stream) {
  if (b <= 0) return 0;
  if (k < 1 || k > 64 || k > n) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<const float*>(scores);
  auto m = static_cast<const unsigned char*>(mask);
  auto v = static_cast<float*>(out_v);
  auto i = static_cast<long long*>(out_i);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k == 1) err = launch<1>(s, m, mask_stride, v, i, b, n, k, st);
  else if (k <= 16) err = launch<16>(s, m, mask_stride, v, i, b, n, k, st);
  else err = launch<64>(s, m, mask_stride, v, i, b, n, k, st);
  return static_cast<int>(err);
}
