// K2: edge-balanced segmented sum, out[r] = sum_{e : rows[e] == r} vals[e] * x[cols[e], :]
// over row-sorted edges, for graphs whose operand and output outgrow the L2.
//
// Replaces the TPU kernel genmmrec_tpu/ops/segment_pallas.py::_segsum_kernel_blocked
// (reached through _segsum_blocked_impl from sorted_segment_sum_blocked and
// spmm_symmetric_blocked). On the TPU the output of a 255,404-row adjacency
// did not fit one VMEM window, so a host planner cut the edges into blocks
// that each own a contiguous row window, reduced every block by one-hot
// matmuls, and added the overlapping windows afterwards. The windows, the
// planner and the one-hot products are TPU shapes and are not carried over.
// What is kept is the idea: work is cut by EDGES, not by rows, and a row cut
// by a boundary is put together afterwards.
//
// Why K1 (which owns rows) does not serve this geometry as well: it gives an
// item-popularity row of tens of thousands of edges to one cluster of eight
// thread blocks, where cutting by edges spreads its gathers over the card.
//
// What bounds it on the H100. Counted as each input read once, bytes: 152 MB
// at the Amazon-elec adjacency (255,404 rows, 2.57 M edges) and d = 64,
// 0.0455 ms. What the card really has to move is more: every edge gathers its
// own d-wide row of x at a random place, 2.57 M x 256 B = 657 MB at d = 64,
// and every design tried ran those gathers at 4.5-5.2 TB/s on this card,
// which puts the kernel near 0.13 ms; the time tracked the gathers in
// flight, warps an SM times gathers a warp. Three suspected limits were each
// answered and timed on the elec adjacency (PERF.md §6), and none paid at
// d = 64, so the design below stands:
// - Ids loaded just before their gathers, four edges in flight a team. Ids
//   staged in shared memory by cp.async a work item ahead, or handed round a
//   team by shuffles a batch ahead, with 8 or 16 gathers in flight a lane:
//   no faster (0.13-0.17 ms at d = 64). Their registers and shared memory
//   cost as many warps as the depth bought. Kept: four edges a batch, at
//   most 48 registers a thread at one vector a lane, so five blocks fit an SM.
// - The 65 MB operand over the 50 MB L2. Cutting the features into slices
//   that the L2 holds, the work ordered slice by slice: slower at d = 64
//   (each slice reads the ids again), 3-4% faster at d = 128 only, which no
//   configuration runs on a graph this large. Not kept.
// - The grid's 1.19 waves at d = 64. A persistent grid walking work items,
//   and chunks of 64 to 512 edges: no steady gain. The wave's tail is short
//   against the gathers' time.
//
// Design. The edges are cut into chunks of kChunk consecutive edges. A team
// of G lanes (G * VPL float4 vectors cover a row of x) owns one chunk and
// walks it in edge order, kBatch edges at a time: the batch's row ids,
// columns, values and x rows are all loaded before the first of them is
// added, so kBatch gathers are in flight a team. The product vals * x[cols]
// lives in registers only. When the row id changes, the finished row is
// written:
//   - a row that lies wholly inside the chunk goes straight to out;
//   - the chunk's first row, if it began in an earlier chunk, goes to the
//     chunk's HEAD partial; its last row, if it began here and runs on into
//     the next chunk, to its TAIL partial (part: (n_chunks, 2, d) float32).
// A second kernel, one team a chunk again, acts for every chunk that has a
// tail: it adds tail[c] + head[c + 1] + ... + head[c1] in chunk order, c1 the
// chunk that holds the row's last edge, and writes the row. A 40,000-edge
// row is thus summed by 300 teams, then by one short loop over 300 partials.
// Rows without edges are zeroed by the team that walks past them (the rows
// between two consecutive edges' ids, before the first edge and after the
// last), so every row of out is written exactly once and the wrapper can
// hand in uninitialised memory. No atomics: the order of every sum is fixed
// by the edge order and kChunk, and two launches give bit-equal results.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;  // edges a team
constexpr int kBatch = 4;    // edges in flight a team

__device__ __forceinline__ void fma4(float4& acc, float v, const float4& x) {
  acc.x = fmaf(v, x.x, acc.x);
  acc.y = fmaf(v, x.y, acc.y);
  acc.z = fmaf(v, x.z, acc.z);
  acc.w = fmaf(v, x.w, acc.w);
}

template <int G, int VPL>
struct Row {
  float4 v[VPL];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < VPL; ++j) v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // this lane's vectors of the row that starts at dst
  __device__ __forceinline__ void store(float4* dst, int sub, int nv) const {
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = sub + j * G;
      if (c < nv) dst[c] = v[j];
    }
  }
};

// rows [lo, hi) of out get zeros
template <int G, int VPL>
__device__ __forceinline__ void zero_rows(float4* out, int lo, int hi, int sub, int nv) {
  Row<G, VPL> z;
  z.clear();
  for (int r = lo; r < hi; ++r) z.store(out + static_cast<long long>(r) * nv, sub, nv);
}

// G: lanes a team (8, 16 or 32); VPL: float4 vectors a lane. At one vector
// a lane the registers are held for five blocks an SM.
template <int G, int VPL>
__global__ void __launch_bounds__(kThreads, VPL == 1 ? 5 : 1)
segment_blocked_kernel(const int* __restrict__ row_ptr, const int* __restrict__ rows,
                       const int* __restrict__ cols, const float* __restrict__ vals,
                       const float4* __restrict__ x, float4* __restrict__ out,
                       float4* __restrict__ part, int nnz, int n_rows, int nv) {
  const long long team = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  const int sub = threadIdx.x % G;
  const long long begin_ll = team * kChunk;
  if (begin_ll >= nnz) return;
  const int begin = static_cast<int>(begin_ll);
  const int end = min(begin + kChunk, nnz);
  float4* head = part + (team * 2) * nv;
  float4* tail = head + nv;

  int cur = __ldg(rows + begin);
  // the first row began in an earlier chunk: its sum here is a partial
  bool is_head = __ldg(row_ptr + cur) < begin;
  if (!is_head) {
    const int prev = begin > 0 ? __ldg(rows + begin - 1) : -1;
    zero_rows<G, VPL>(out, prev + 1, cur, sub, nv);
  }
  Row<G, VPL> acc;
  acc.clear();

  for (int e = begin; e < end; e += kBatch) {
    int r[kBatch];
    float v[kBatch];
    float4 xv[kBatch][VPL];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool live = e + u < end;
      r[u] = live ? __ldg(rows + e + u) : -1;
      v[u] = live ? __ldg(vals + e + u) : 0.f;
      const int c = live ? __ldg(cols + e + u) : 0;
      const float4* xr = x + static_cast<long long>(c) * nv;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int cc = sub + j * G;
        xv[u][j] = (live && cc < nv) ? __ldg(xr + cc) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (r[u] < 0) break;
      if (r[u] != cur) {
        acc.store(is_head ? head : out + static_cast<long long>(cur) * nv, sub, nv);
        zero_rows<G, VPL>(out, cur + 1, r[u], sub, nv);
        acc.clear();
        cur = r[u];
        is_head = false;
      }
#pragma unroll
      for (int j = 0; j < VPL; ++j) fma4(acc.v[j], v[u], xv[u][j]);
    }
  }

  // the chunk's last row: a head partial if the whole chunk lies inside a
  // row that began earlier, a tail partial if it runs on, else complete
  float4* dst = out + static_cast<long long>(cur) * nv;
  if (is_head) dst = head;
  else if (__ldg(row_ptr + cur + 1) > end) dst = tail;
  acc.store(dst, sub, nv);
  if (end == nnz) zero_rows<G, VPL>(out, cur + 1, n_rows, sub, nv);
}

// One team a chunk; acts where the chunk's last row began in it and runs on.
template <int G, int VPL>
__global__ void __launch_bounds__(kThreads)
segment_combine_kernel(const int* __restrict__ row_ptr, const int* __restrict__ rows,
                       const float4* __restrict__ part, float4* __restrict__ out, int nnz, int nv) {
  const long long team = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  const int sub = threadIdx.x % G;
  const long long begin_ll = team * kChunk;
  if (begin_ll + kChunk >= nnz) return;  // the last chunk has no tail
  const int begin = static_cast<int>(begin_ll);
  const int end = begin + kChunk;
  const int row = __ldg(rows + end - 1);
  const int row_end = __ldg(row_ptr + row + 1);
  if (row_end <= end || __ldg(row_ptr + row) < begin) return;
  const long long last = (row_end - 1) / kChunk;  // the chunk of the row's last edge

  Row<G, VPL> acc;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = sub + j * G;
    acc.v[j] = c < nv ? part[(team * 2 + 1) * nv + c] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (long long t = team + 1; t <= last; ++t) {
    const float4* h = part + (t * 2) * nv;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = sub + j * G;
      if (c < nv) {
        const float4 p = h[c];
        acc.v[j].x += p.x;
        acc.v[j].y += p.y;
        acc.v[j].z += p.z;
        acc.v[j].w += p.w;
      }
    }
  }
  acc.store(out + static_cast<long long>(row) * nv, sub, nv);
}

template <int G, int VPL>
cudaError_t launch(const int* row_ptr, const int* rows, const int* cols, const float* vals,
                   const float* x, float* out, float* part, int nnz, int n_rows, int nv,
                   cudaStream_t stream) {
  const long long chunks = (static_cast<long long>(nnz) + kChunk - 1) / kChunk;
  const int teams_per_block = kThreads / G;
  const int blocks = static_cast<int>((chunks + teams_per_block - 1) / teams_per_block);
  auto x4 = reinterpret_cast<const float4*>(x);
  auto out4 = reinterpret_cast<float4*>(out);
  auto part4 = reinterpret_cast<float4*>(part);
  segment_blocked_kernel<G, VPL><<<blocks, kThreads, 0, stream>>>(
      row_ptr, rows, cols, vals, x4, out4, part4, nnz, n_rows, nv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  segment_combine_kernel<G, VPL><<<blocks, kThreads, 0, stream>>>(row_ptr, rows, part4, out4, nnz,
                                                                  nv);
  return cudaGetLastError();
}

}  // namespace

// Edges of a chunk, for the wrapper to size `part`: (ceil(nnz / chunk), 2, d) float32.
extern "C" int segment_spmm_blocked_chunk() { return kChunk; }

// rows, cols, vals: (nnz,) row-sorted edges, nnz >= 1; row_ptr: (n_rows + 1,);
// x: (n_cols, d); out: (n_rows, d), every row written; part: scratch as above.
// d must be a multiple of 4 and at most 512; x, out and part 16-byte aligned.
// Returns a cudaError_t (0 on success); the Python wrapper checks the rest.
extern "C" int segment_spmm_blocked_f32(const void* row_ptr, const void* rows, const void* cols,
                                        const void* vals, const void* x, void* out, void* part,
                                        int nnz, int n_rows, int d, void* stream) {
  if (n_rows <= 0) return 0;
  if (nnz <= 0 || d <= 0 || d % 4 != 0 || d > 512) return static_cast<int>(cudaErrorInvalidValue);
  const int nv = d / 4;
  auto s = static_cast<cudaStream_t>(stream);
  auto rp = static_cast<const int*>(row_ptr);
  auto r = static_cast<const int*>(rows);
  auto c = static_cast<const int*>(cols);
  auto v = static_cast<const float*>(vals);
  auto xx = static_cast<const float*>(x);
  auto o = static_cast<float*>(out);
  auto p = static_cast<float*>(part);
  cudaError_t err;
  if (nv <= 8) err = launch<8, 1>(rp, r, c, v, xx, o, p, nnz, n_rows, nv, s);
  else if (nv <= 16) err = launch<16, 1>(rp, r, c, v, xx, o, p, nnz, n_rows, nv, s);
  else if (nv <= 32) err = launch<32, 1>(rp, r, c, v, xx, o, p, nnz, n_rows, nv, s);
  else if (nv <= 64) err = launch<32, 2>(rp, r, c, v, xx, o, p, nnz, n_rows, nv, s);
  else err = launch<32, 4>(rp, r, c, v, xx, o, p, nnz, n_rows, nv, s);
  return static_cast<int>(err);
}
