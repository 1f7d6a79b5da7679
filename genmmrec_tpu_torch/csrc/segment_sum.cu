// K1, forward: CSR sparse @ dense, out[r] = sum_{e in [row_ptr[r], row_ptr[r+1])} vals[e] * x[cols[e], :].
//
// Replaces the TPU kernel genmmrec_tpu/ops/segment_pallas.py::_segsum_kernel
// (reached through sorted_segment_sum and spmm_symmetric). On the TPU the
// (nnz, d) plane vals[:, None] * x[cols] was built by XLA outside the kernel
// and reduced by per-chunk one-hot matmuls into an output block resident in
// VMEM, with a static row-span bound planned on the host. None of that fits
// this card: blocks run in parallel and in no order, and there is no
// megabytes-large scratch that outlives a block.
//
// What bounds it on the H100: the gathers of x rows (each edge reads one
// d-wide row of x at a random position). The arithmetic is one FMA per
// gathered float. At the DiffMM-baby shapes x is 26,495 x 128 x 4 B = 13.6 MB,
// which stays in the 50 MB L2, so the gathers mostly hit L2.
//
// Design: a CSR row pointer replaces the chunk/span planning. One warp owns
// one output row. The warp is split into 32/G groups of G lanes; each group
// takes every (32/G)-th edge of the row, and each lane of a group owns VPL
// float4 vectors of the row (16-byte loads, neighbouring lanes on
// neighbouring addresses). The gather-multiply happens in registers, so the
// (nnz, d) product never goes to device memory. The groups' partial sums are
// combined by warp shuffles and the row is written once: no atomics, no zero
// fill, and a summation order fixed by the row's edge order, so the result
// repeats exactly from run to run. An empty row writes zeros.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ void fma4(float4& acc, float v, const float4& x) {
  acc.x = fmaf(v, x.x, acc.x);
  acc.y = fmaf(v, x.y, acc.y);
  acc.z = fmaf(v, x.z, acc.z);
  acc.w = fmaf(v, x.w, acc.w);
}

// G: lanes per edge group (8, 16 or 32); VPL: float4 vectors per lane.
template <int G, int VPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_spmm_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cols,
                    const float* __restrict__ vals, const float4* __restrict__ x,
                    float4* __restrict__ out, int n_rows, int nv) {
  constexpr int kGroups = 32 / G;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // uniform across the warp
  const int grp = lane / G;
  const int sub = lane % G;

  float4 acc[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int begin = __ldg(row_ptr + row);
  const int end = __ldg(row_ptr + row + 1);
  for (int e = begin + grp; e < end; e += kGroups) {
    const float v = __ldg(vals + e);
    const float4* xr = x + static_cast<long long>(__ldg(cols + e)) * nv;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = sub + j * G;
      if (c < nv) fma4(acc[j], v, __ldg(xr + c));
    }
  }

#pragma unroll
  for (int off = G; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      acc[j].x += __shfl_down_sync(0xffffffffu, acc[j].x, off);
      acc[j].y += __shfl_down_sync(0xffffffffu, acc[j].y, off);
      acc[j].z += __shfl_down_sync(0xffffffffu, acc[j].z, off);
      acc[j].w += __shfl_down_sync(0xffffffffu, acc[j].w, off);
    }
  }
  if (grp == 0) {
    float4* o = out + static_cast<long long>(row) * nv;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = sub + j * G;
      if (c < nv) o[c] = acc[j];
    }
  }
}

template <int G, int VPL>
cudaError_t launch(const int* row_ptr, const int* cols, const float* vals, const float* x,
                   float* out, int n_rows, int nv, cudaStream_t stream) {
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_spmm_kernel<G, VPL><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      row_ptr, cols, vals, reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out),
      n_rows, nv);
  return cudaGetLastError();
}

}  // namespace

// d must be a multiple of 4 and at most 512; x and out 16-byte aligned.
// Returns a cudaError_t (0 on success); the Python wrapper checks the rest.
extern "C" int segment_spmm_f32(const void* row_ptr, const void* cols, const void* vals,
                                const void* x, void* out, int n_rows, int d, void* stream) {
  if (n_rows <= 0) return 0;
  if (d <= 0 || d % 4 != 0 || d > 512) return static_cast<int>(cudaErrorInvalidValue);
  const int nv = d / 4;
  auto s = static_cast<cudaStream_t>(stream);
  auto rp = static_cast<const int*>(row_ptr);
  auto c = static_cast<const int*>(cols);
  auto v = static_cast<const float*>(vals);
  auto xx = static_cast<const float*>(x);
  auto o = static_cast<float*>(out);
  cudaError_t err;
  if (nv <= 8) err = launch<8, 1>(rp, c, v, xx, o, n_rows, nv, s);
  else if (nv <= 16) err = launch<16, 1>(rp, c, v, xx, o, n_rows, nv, s);
  else if (nv <= 32) err = launch<32, 1>(rp, c, v, xx, o, n_rows, nv, s);
  else if (nv <= 64) err = launch<32, 2>(rp, c, v, xx, o, n_rows, nv, s);
  else err = launch<32, 4>(rp, c, v, xx, o, n_rows, nv, s);
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
