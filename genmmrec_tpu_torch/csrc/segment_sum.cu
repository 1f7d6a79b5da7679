// K1, forward and backward: CSR sparse @ dense,
// out[r] = sum_{e in [row_ptr[r], row_ptr[r+1])} vals[e] * x[cols[e], :].
// The backward is the same product on the output cotangent, over the edges
// of the transposed graph.
//
// Replaces the TPU kernel genmmrec_tpu/ops/segment_pallas.py::_segsum_kernel
// (reached through sorted_segment_sum and spmm_symmetric). On the TPU the
// (nnz, d) plane vals[:, None] * x[cols] was built by XLA outside the kernel
// and reduced by per-chunk one-hot matmuls into an output block resident in
// VMEM, with a static row-span bound planned on the host. None of that fits
// this card: blocks run in parallel and in no order, and there is no
// megabytes-large scratch that outlives a block.
//
// What bounds it on the H100: bytes, but not those of device memory. Each
// edge gathers one d-wide row of x at a random position; the arithmetic is
// one FMA per gathered float. At the DiffMM-baby shapes x (26,495 x 128 x 4 B
// = 13.6 MB) stays in the 50 MB L2, so the 125 MB of gathers are L2 round
// trips: what sets the time is the L2's rate, how many gathers are in flight,
// and the longest chain of dependent ones. The rows are skewed: nine edges
// on average, hundreds of rows of 33 to a few thousand, and one row of a
// regenerated graph holds 14,106.
//
// Design: the kernel owns rows, by their length.
// - A row of at most long_len edges (64) belongs to one team of G lanes (8,
//   16 or 32; the row of x as float4 vectors, VPL vectors a lane), so a warp
//   sums 32/G rows at once. The team stages its edges' ids and values with
//   one coalesced load each, G edges at a time and one stage ahead, hands
//   them round by shuffle, and starts the gathers of a batch (8 vectors a
//   lane at d <= 128) before the first FMA.
// - A longer row is in the graph's list of long rows (built once with the row
//   pointer; -1 ends it). The first blocks of the launch, a fixed number of
//   thread-block clusters of 8, walk the list, eight slots a cluster a turn.
//   A row of at most kClusterRow edges (1024) is one block's: each of its
//   teams takes a contiguous slice of the row's edges and sums it as above,
//   the partial sums meet in shared memory and are added in team order. A
//   row longer than that is the whole cluster's, and comes first: the eight
//   blocks' sums are read by the cluster's first block through distributed
//   shared memory and added in rank order; 14,106 edges over 64 warps are
//   220 edges a warp. Such a row's gathers all pass through eight SMs, whose
//   share of the L2's rate is what bounds it.
//   Nothing is read back and the grid does not depend on the list's length.
//   The thresholds (64, 1024, 64 clusters) sit on the flat part of a sweep on
//   the DiffMM-baby graphs at d = 64, 128 and 192: the time hardly moves over
//   long_len 32 to 64 and kClusterRow 256 to 4096, and rises past long_len 96.
// The gather-multiply happens in registers, the (nnz, d) product never goes
// to device memory, every row is written once (an empty row as zeros): no
// atomics, no zero fill, no scratch in device memory, and a summation order
// fixed by the graph and d alone, so two launches give the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kClusterBlocks = 8;
// clusters that walk the list of long rows: four blocks an SM's worth
constexpr int kMaxLongClusters = 64;
// a listed row of more edges than this is summed by a whole cluster
constexpr int kClusterRow = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void fma4(float4& acc, float v, const float4& x) {
  acc.x = fmaf(v, x.x, acc.x);
  acc.y = fmaf(v, x.y, acc.y);
  acc.z = fmaf(v, x.z, acc.z);
  acc.w = fmaf(v, x.w, acc.w);
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// One team's sum over edges [begin, begin + cnt), added into acc in edge
// order. Every lane of the warp calls it with the same wcnt >= cnt, the
// warp's largest count, so that the shuffles are uniform; a lane past its
// team's count loads nothing and adds 0 * 0.
template <int G, int VPL>
__device__ __forceinline__ void team_sum(float4 (&acc)[VPL], const int* __restrict__ cols,
                                         const float* __restrict__ vals,
                                         const float4* __restrict__ x, int nv, int begin, int cnt,
                                         int wcnt, int sub) {
  // edges a batch: 8 float4 gathers in flight a lane, 12 at three vectors a lane
  constexpr int U = VPL == 1 ? 8 : VPL <= 3 ? 4 : 2;
  // lane sub stages edge base + sub of its team, one coalesced load each,
  // a stage ahead of the gathers
  int c_next = 0;
  float v_next = 0.f;
  if (sub < cnt) {
    c_next = __ldg(cols + begin + sub);
    v_next = __ldg(vals + begin + sub);
  }
  for (int base = 0; base < wcnt; base += G) {
    const int c = c_next;
    const float v = v_next;  // 0 past the team's count
    c_next = 0;
    v_next = 0.f;
    if (base + G + sub < cnt) {
      c_next = __ldg(cols + begin + base + G + sub);
      v_next = __ldg(vals + begin + base + G + sub);
    }
    const int lim = min(G, wcnt - base);
    for (int u0 = 0; u0 < lim; u0 += U) {
      float4 xr[U][VPL];
      float vv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int cu = __shfl_sync(kFull, c, u0 + u, G);
        vv[u] = __shfl_sync(kFull, v, u0 + u, G);
        const bool live = base + u0 + u < cnt;
        const float4* xrow = x + static_cast<long long>(cu) * nv;
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const int col = sub + j * G;
          xr[u][j] = (live && col < nv) ? __ldg(xrow + col) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int j = 0; j < VPL; ++j) fma4(acc[j], vv[u], xr[u][j]);
      }
    }
  }
}

// A listed row of len edges from begin on, summed by n_teams teams of which
// this is team_id: the team's contiguous slice, whole batches, into part;
// then the block's sum of column col (col = threadIdx.x + i * kThreads < nv),
// its teams in order, handed to emit(col, sum). part holds the teams' sums,
// kBlockTeams * nv vectors; its earlier readers are done on return from the
// first barrier.
template <int G, int VPL, typename Emit>
__device__ __forceinline__ void slice_sum(float4* part, const int* __restrict__ cols,
                                          const float* __restrict__ vals,
                                          const float4* __restrict__ x, int nv, int begin, int len,
                                          int n_teams, int team_id, int team, int sub,
                                          Emit&& emit) {
  constexpr int kBlockTeams = kWarpsPerBlock * (32 / G);
  int per = (len + n_teams - 1) / n_teams;
  per = (per + 7) / 8 * 8;
  const int first = min(len, team_id * per);
  const int cnt = min(len - first, per);
  float4 acc[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  team_sum<G, VPL>(acc, cols, vals, x, nv, begin + first, cnt, per, sub);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int col = sub + j * G;
    if (col < nv) part[team * nv + col] = acc[j];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < nv; col += kThreads) {
    float4 s = part[col];
    for (int t = 1; t < kBlockTeams; ++t) add4(s, part[t * nv + col]);
    emit(col, s);
  }
}

// G: lanes a team (8, 16 or 32); VPL: float4 vectors a lane.
template <int G, int VPL>
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kThreads)
segment_spmm_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cols,
                    const float* __restrict__ vals, const float4* __restrict__ x,
                    float4* __restrict__ out, const int* __restrict__ long_rows, int n_slots,
                    int n_long_blocks, int long_len, int n_rows, int nv) {
  constexpr int kTeams = 32 / G;                        // teams a warp
  constexpr int kBlockTeams = kWarpsPerBlock * kTeams;  // teams a block
  // the teams' partial sums of a listed row: kBlockTeams * nv <= 1024 vectors
  __shared__ float4 part[kWarpsPerBlock * 128];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int sub = lane % G;
  const int team = (tid >> 5) * kTeams + lane / G;  // within the block

  if (blockIdx.x < n_long_blocks) {
    // ---- the clusters walk the list of long rows, eight slots a cluster a turn ----
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int stride = n_long_blocks;  // slots all the clusters take in one turn
    const int first_base = blockIdx.x / kClusterBlocks * kClusterBlocks;
    // first the rows that need the whole cluster, the longest chains of the
    // launch; every block reads the same list, so the cluster's barriers are
    // reached by all of its blocks or by none
    bool more = true;
    for (int base = first_base; more && base < n_slots; base += stride) {
      for (int slot = base; slot < base + kClusterBlocks; ++slot) {
        const int row = slot < n_slots ? __ldg(long_rows + slot) : -1;
        if (row < 0) {
          more = false;  // the list's end
          break;
        }
        const int begin = __ldg(row_ptr + row);
        const int len = __ldg(row_ptr + row + 1) - begin;
        if (len <= kClusterRow) continue;
        slice_sum<G, VPL>(part, cols, vals, x, nv, begin, len, kClusterBlocks * kBlockTeams,
                          rank * kBlockTeams + team, team, sub,
                          [&](int col, const float4& s) { part[col] = s; });
        cluster.sync();
        if (rank == 0) {
          for (int col = tid; col < nv; col += kThreads) {
            float4 s = part[col];
            for (int r = 1; r < kClusterBlocks; ++r) add4(s, cluster.map_shared_rank(part, r)[col]);
            out[static_cast<long long>(row) * nv + col] = s;
          }
        }
        // no block leaves or overwrites its sums before the first has read them
        cluster.sync();
      }
    }
    // then this block's row of each eight, if one block is enough for it
    for (int slot = first_base + rank; slot < n_slots; slot += stride) {
      const int row = __ldg(long_rows + slot);
      if (row < 0) break;
      const int begin = __ldg(row_ptr + row);
      const int len = __ldg(row_ptr + row + 1) - begin;
      if (len > kClusterRow) continue;
      float4* o = out + static_cast<long long>(row) * nv;
      slice_sum<G, VPL>(part, cols, vals, x, nv, begin, len, kBlockTeams, team, team, sub,
                        [&](int col, const float4& s) { o[col] = s; });
    }
    return;
  }

  // ---- a team a row ----
  const int row = (blockIdx.x - n_long_blocks) * kBlockTeams + team;
  int begin = 0, cnt = 0;
  bool mine = false;
  if (row < n_rows) {
    begin = __ldg(row_ptr + row);
    const int len = __ldg(row_ptr + row + 1) - begin;
    mine = len <= long_len;  // a longer row is in the list
    cnt = mine ? len : 0;
  }
  int wcnt = cnt;
#pragma unroll
  for (int off = G; off < 32; off <<= 1) wcnt = max(wcnt, __shfl_xor_sync(kFull, wcnt, off));
  float4 acc[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  team_sum<G, VPL>(acc, cols, vals, x, nv, begin, cnt, wcnt, sub);
  if (mine) {
    float4* o = out + static_cast<long long>(row) * nv;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int col = sub + j * G;
      if (col < nv) o[col] = acc[j];
    }
  }
}

template <int G, int VPL>
cudaError_t launch(const int* row_ptr, const int* cols, const float* vals, const float* x,
                   float* out, const int* long_rows, int n_slots, int long_len, int n_rows,
                   int nv, cudaStream_t stream) {
  constexpr int kBlockTeams = kWarpsPerBlock * (32 / G);
  const int n_long_blocks = (n_slots < kMaxLongClusters ? n_slots : kMaxLongClusters) * kClusterBlocks;
  const int row_blocks = (n_rows + kBlockTeams - 1) / kBlockTeams;
  // whole clusters
  const int blocks = (n_long_blocks + row_blocks + kClusterBlocks - 1) / kClusterBlocks * kClusterBlocks;
  segment_spmm_kernel<G, VPL><<<blocks, kThreads, 0, stream>>>(
      row_ptr, cols, vals, reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out),
      long_rows, n_slots, n_long_blocks, long_len, n_rows, nv);
  return cudaGetLastError();
}

}  // namespace

// d must be a multiple of 4 and at most 512; x and out 16-byte aligned.
// long_rows: (n_slots,) int32, the ids of the rows of more than long_len
// edges, then -1 (at least one). Returns a cudaError_t (0 on success); the
// Python wrapper checks the rest.
extern "C" int segment_spmm_f32(const void* row_ptr, const void* cols, const void* vals,
                                const void* x, void* out, const void* long_rows, int n_slots,
                                int long_len, int n_rows, int d, void* stream) {
  if (n_rows <= 0) return 0;
  if (d <= 0 || d % 4 != 0 || d > 512 || n_slots < 1 || long_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nv = d / 4;
  auto s = static_cast<cudaStream_t>(stream);
  auto rp = static_cast<const int*>(row_ptr);
  auto c = static_cast<const int*>(cols);
  auto v = static_cast<const float*>(vals);
  auto xx = static_cast<const float*>(x);
  auto o = static_cast<float*>(out);
  auto lr = static_cast<const int*>(long_rows);
  cudaError_t err;
  // the team shape that leaves the fewest lanes idle
  if (nv <= 8) err = launch<8, 1>(rp, c, v, xx, o, lr, n_slots, long_len, n_rows, nv, s);
  else if (nv <= 16) err = launch<16, 1>(rp, c, v, xx, o, lr, n_slots, long_len, n_rows, nv, s);
  else if (nv <= 32) err = launch<32, 1>(rp, c, v, xx, o, lr, n_slots, long_len, n_rows, nv, s);
  else if (nv <= 48) err = launch<16, 3>(rp, c, v, xx, o, lr, n_slots, long_len, n_rows, nv, s);
  else if (nv <= 64) err = launch<32, 2>(rp, c, v, xx, o, lr, n_slots, long_len, n_rows, nv, s);
  else if (nv <= 96) err = launch<32, 3>(rp, c, v, xx, o, lr, n_slots, long_len, n_rows, nv, s);
  else err = launch<32, 4>(rp, c, v, xx, o, lr, n_slots, long_len, n_rows, nv, s);
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
