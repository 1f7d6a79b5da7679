// K5a, K5b, K5c: the kernel stages of the fused score + mask + top-k of
// the bf16 full-catalog evaluation. The (B, n_items) score plane of a user
// chunk is never written to device memory.
//
// They replace the three Pallas kernels of genmmrec_tpu/ops/fused_topk.py:
//   K5a  group_max_kernel             _fold_kernel      (pallas_call at :293)
//   K5b  candidates_kernel<.., true>  _cand_kernel      (pallas_call at :329)
//   K5c  candidates_kernel<.., false> _cand_kernel_slim (pallas_call at :312)
//
// What they compute. A score is s[r, j] = bf16(sum_k u[r, k] * t[j, k]):
// bfloat16 operands, float32 accumulation, one rounding to bfloat16 (the
// bf16 matrix product of the unfused route). The catalog is cut into groups
// of 128 consecutive items. Bit (j & 7) of byte (j >> 3) of a row's packed
// mask marks item j as excluded (little-endian packbits; the row is
// n_groups * 16 bytes and the columns past the catalog are set), so group
// g's 128 bits are the 16 bytes at 16 * g: one 16-byte load.
//   K5a writes, for each (row, group), the maximum of the group's scores with
//       excluded items at -inf: (B, n_groups) bfloat16.
//   K5b writes, for each row, the 128 scores of each of the kp groups listed
//       in gidx[r, :], excluded items at -inf: (B, kp * 128) bfloat16, slot
//       (r, j) at (r * kp + j) * 128.
//   K5c writes the same scores without looking at the mask.
// A group id outside [0, n_groups) is a pad slot and yields 128 times -inf.
// Between K5a and K5b the caller picks each row's groups from the maxima.
//
// What was dropped from the TPU design: its 8,192-lane item tiles with the
// whole table resident in VMEM, the planar mask layout its unpack needed, the
// arithmetic variant of the mask, and, in the candidate kernels, the
// recomputation of every score tile with one-hot contractions picking the
// chosen groups (a TPU cannot gather by lane). Here the candidate kernels
// compute only the chosen groups.
//
// What bounds them on the H100 at d = 64. K5a does 2 * B * n * d operations:
// 3.7 GFLOP at the baby shape (B 4096, n 7,050) and 33 GFLOP at the elec shape
// (n 63,001), 0.004 and 0.033 ms at the tensor cores' bf16 peak. It must move
// the mask (n / 8 bytes a row: 3.7 MB and 32.3 MB a chunk), u (0.5 MB), the
// table (0.9 MB, 8.1 MB) and the maxima (0.5 MB, 4.0 MB): 0.002 and 0.013 ms
// at 3.35 TB/s. So the operations bound it, narrowly (660 operations a byte
// against the card's 295). What this design pays beyond either is a re-read of
// the table by every user tile, from the L2 cache (32 user tiles: 29 MB and
// 258 MB), one pass of each table tile through shared memory per warp, and
// two barriers a tile with no load in flight meanwhile.
// K5b and K5c compute kp * 128 * d multiply-adds a row (all of the plane at
// baby, where kp = 50 of 56 groups; an eighth of it at elec) and must write
// the candidates, B * kp * 256 bytes: 52 MB at B 4096, k = 50, 0.016 ms at
// 3.35 TB/s. That write is their bound (bytes); the operations take 0.004 ms.
//
// Design of K5a. The product comes from the tensor cores with
// mma.sync.m16n8k16 (bfloat16 in, float32 out): A is a 16-row tile of u, held
// in registers for the block's life, B a 128-item table tile in shared
// memory, its rows padded by 8 elements so that the fragment loads of a warp
// fall on 32 different banks. A block of 8 warps owns 128 rows and walks
// groups blockIdx.y, blockIdx.y + gridDim.y, ...; a warp owns 16 rows and all
// 128 columns of the tile (64 accumulators a thread). Each thread rounds its
// 32 scores of a row, applies the row's 16 mask bytes, takes the maximum, and
// the four threads of a quad combine theirs with two shuffles. Rows past B
// are zero in A and are not written; the mask is not read for them.
//
// Design of K5b and K5c: one pass per group, not per row. The first design gave
// a block one row: its A tile held that row and 15 rows of zeros (1/16 of
// each tensor-core instruction useful), and for each of the row's kp groups
// the block pulled the group's whole table tile (16 KB at d = 64) through the
// L2, B * kp tiles, 3.4 GB a 4,096-row chunk, because rows that chose the
// same group never shared its tile. Now:
// - The plan. A counting sort inverts the (row, slot) -> group choices into
//   one list a group of the flat slots r * kp + j that chose it, on the
//   device and read back by no one: plan_count_kernel takes the histogram
//   (a block's slots in shared memory first, one atomic a block and group in
//   device memory) and writes the pad slots' -inf; its last block to finish
//   scans the counts into each group's first work item and names each work
//   item's group; plan_scatter_kernel writes the slots into their group's
//   list, padded to whole work items of 128 (the order within a list
//   changes from run to run, the output does not, since each slot is
//   written once).
// - The candidates kernel. Its grid is fixed, ceil(B * kp / 128) + n_groups
//   work items (at least the sum over groups of ceil(count / 128)); a work
//   item is a group and a slice of up to 128 slots of its list, which the
//   block reads with two independent loads; a block past the plan's last
//   work item exits. So a long list (at baby nearly every row chooses 50 of
//   the 56 groups) is cut into slices and no block owns more than 128 rows. The
//   block (4 warps) loads the group's table tile into shared memory once, by
//   cp.async, at the padded layout of K5a, and gathers the slice's u rows
//   into full 16-row A tiles and their 16 mask bytes beside them, in two
//   halves of 64 rows: the second half's gather is in flight while the
//   first half is multiplied and stored. A warp multiplies 16 rows by the
//   128 items with the same mma.sync.m16n8k16, the same fragments and the
//   same ascending k-steps as K5a, so that every candidate is bit-equal to
//   the score K5a folded; each thread rounds once and applies the row's
//   mask bits. The output leaves as whole 128-byte lines: a warp's 16 rows
//   pass through shared memory, 64 items at a time, and go out as 16-byte
//   vectors, each 8 lanes one row's 128 bytes. (Written as they come out of
//   the accumulators, 4 bytes a thread and 16 bytes of a row a warp store,
//   half-sector pieces of eight rows, K5b took 0.101 ms at the baby shape
//   instead of 0.060: chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W.)
// - Traffic. Table tiles through the L2 drop from B * kp * 16 KB to
//   n_groups * 16 KB (0.9 MB at baby, 8 MB at elec); in their place come
//   B * kp u rows of 128 B (26 MB, from a 0.5 MB chunk that stays in the L2)
//   and 16-byte mask pieces (3.3 MB). The 52 MB of candidates are the
//   dominant traffic, as the bound says, and the tensor cores' A tiles are
//   full rows but for the last tile of a list.
// Table rows past the catalog are loaded as zeros, never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;  // items in a group, and in a table tile
constexpr int kPad = 8;      // elements of padding after each tile row
constexpr uint16_t kNegInfBits = 0xFF80;  // -inf as bfloat16
constexpr int kRows = 128;         // slots of a candidates work item
constexpr int kHalfRows = 64;      // slots a warp set multiplies at once: 4 warps x 16
constexpr int kCandThreads = 128;  // 4 warps
constexpr int kPlanThreads = 256;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The score as the float value of its bfloat16 rounding (to nearest even).
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Bits of a float that holds a bfloat16 value: exact.
__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return static_cast<uint16_t>(__float_as_uint(x) >> 16);
}

// Items item0 .. item0 + 127 of the (n, D) table into the tile, 16 bytes a
// thread and step, neighbouring threads on neighbouring addresses.
template <int D, int THREADS>
__device__ __forceinline__ void load_tile(uint16_t* tile, const uint16_t* __restrict__ table,
                                          int item0, int n, int tid) {
  constexpr int kVec = D / 8;  // 16-byte pieces in a table row
  for (int i = tid; i < kGroup * kVec; i += THREADS) {
    const int item = i / kVec, c = i % kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (item0 + item < n)
      v = __ldg(reinterpret_cast<const uint4*>(table + static_cast<long long>(item0 + item) * D) + c);
    *reinterpret_cast<uint4*>(tile + item * (D + kPad) + c * 8) = v;
  }
}

// The two B fragments of n-tile nt (items nt*8 .. nt*8+7) and k-step ks.
template <int D>
__device__ __forceinline__ void b_fragments(const uint16_t* tile, int nt, int ks, int g, int t,
                                            uint32_t& b0, uint32_t& b1) {
  const uint32_t* p =
      reinterpret_cast<const uint32_t*>(tile + (nt * 8 + g) * (D + kPad) + ks * 16 + t * 2);
  b0 = p[0];
  b1 = p[4];
}

template <int D>
__global__ void __launch_bounds__(256)
group_max_kernel(const uint16_t* __restrict__ u, const uint16_t* __restrict__ table,
                 const unsigned char* __restrict__ mask, uint16_t* __restrict__ gmax, int b, int n,
                 int n_groups) {
  constexpr int kSteps = D / 16;
  __shared__ __align__(16) uint16_t tile[kGroup * (D + kPad)];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * 128 + warp * 16 + g, row1 = row0 + 8;
  const bool in0 = row0 < b, in1 = row1 < b;

  uint32_t a[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const int k0 = ks * 16 + t * 2;
    const uint16_t* p0 = u + static_cast<long long>(row0) * D + k0;
    const uint16_t* p1 = u + static_cast<long long>(row1) * D + k0;
    a[ks][0] = in0 ? __ldg(reinterpret_cast<const uint32_t*>(p0)) : 0u;
    a[ks][1] = in1 ? __ldg(reinterpret_cast<const uint32_t*>(p1)) : 0u;
    a[ks][2] = in0 ? __ldg(reinterpret_cast<const uint32_t*>(p0 + 8)) : 0u;
    a[ks][3] = in1 ? __ldg(reinterpret_cast<const uint32_t*>(p1 + 8)) : 0u;
  }

  const long long mask_stride = static_cast<long long>(n_groups) * 16;
  for (int grp = blockIdx.y; grp < n_groups; grp += gridDim.y) {
    __syncthreads();  // the previous tile has been consumed
    load_tile<D, 256>(tile, table, grp * kGroup, n, tid);
    __syncthreads();

    float c[16][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t b0, b1;
        b_fragments<D>(tile, nt, ks, g, t, b0, b1);
        mma_bf16(c[nt], a[ks], b0, b1);
      }
    }

    // the group's 16 mask bytes of each of the thread's two rows; byte nt
    // holds the bits of the items of n-tile nt, bits 2t and 2t+1 are this
    // thread's two columns
    uint4 m0 = make_uint4(~0u, ~0u, ~0u, ~0u), m1 = m0;
    if (in0) m0 = __ldg(reinterpret_cast<const uint4*>(mask + row0 * mask_stride + grp * 16));
    if (in1) m1 = __ldg(reinterpret_cast<const uint4*>(mask + row1 * mask_stride + grp * 16));
    const uint32_t w0[4] = {m0.x, m0.y, m0.z, m0.w}, w1[4] = {m1.x, m1.y, m1.z, m1.w};
    float best0 = -CUDART_INF_F, best1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const uint32_t bits0 = (w0[nt >> 2] >> ((nt & 3) * 8 + t * 2)) & 3u;
      const uint32_t bits1 = (w1[nt >> 2] >> ((nt & 3) * 8 + t * 2)) & 3u;
      if (!(bits0 & 1u)) best0 = fmaxf(best0, round_bf16(c[nt][0]));
      if (!(bits0 & 2u)) best0 = fmaxf(best0, round_bf16(c[nt][1]));
      if (!(bits1 & 1u)) best1 = fmaxf(best1, round_bf16(c[nt][2]));
      if (!(bits1 & 2u)) best1 = fmaxf(best1, round_bf16(c[nt][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      best0 = fmaxf(best0, __shfl_xor_sync(0xffffffffu, best0, off));
      best1 = fmaxf(best1, __shfl_xor_sync(0xffffffffu, best1, off));
    }
    if (t == 0) {
      if (in0) gmax[static_cast<long long>(row0) * n_groups + grp] = bf16_bits(best0);
      if (in1) gmax[static_cast<long long>(row1) * n_groups + grp] = bf16_bits(best1);
    }
  }
}

// ---- the plan of K5b and K5c ----
//
// A work item is a group and up to kRows of the slots that chose it. The
// plan lays each group's list out padded to whole work items, so that work
// item w's slots are list[w * kRows ...] and its group item_group[w]: a
// block finds both with two independent loads. Scratch, int32, for
// n_groups g, n_slots = B * kp slots and n_items = ceil(n_slots / kRows) + g
// work items at most (the sum over groups of ceil(count / kRows) is less):
//   counts[g] | cursor[g] | ticket | first_item[g + 1] | item_group[n_items] |
//   list[n_items * kRows]
// counts, cursor and ticket start at 0, item_group and list at -1;
// first_item is the exclusive scan of ceil(counts / kRows), the number of
// work items at [g]. Group grp's slots fill list[first_item[grp] * kRows
// ...] from the start, so a work item's slots are a prefix of its kRows.
struct Plan {
  int* counts;
  int* cursor;
  int* ticket;
  int* first_item;
  int* item_group;
  int* list;
  __host__ __device__ Plan(int* scratch, int n_groups, int n_slots)
      : counts(scratch),
        cursor(scratch + n_groups),
        ticket(scratch + 2 * n_groups),
        first_item(scratch + 2 * n_groups + 1),
        item_group(scratch + 3 * n_groups + 2),
        list(scratch + 3 * n_groups + 2 + max_items(n_groups, n_slots)) {}
  __host__ __device__ static int max_items(int n_groups, int n_slots) {
    return (n_slots + kRows - 1) / kRows + n_groups;
  }
  // the words that start at 0, then the words that start at -1
  static int zeroed(int n_groups) { return 2 * n_groups + 1; }
  static long long unset(int n_groups, int n_slots) {
    return static_cast<long long>(max_items(n_groups, n_slots)) * (1 + kRows);
  }
  static long long ints(int n_groups, int n_slots) {
    return 3LL * n_groups + 2 + unset(n_groups, n_slots);
  }
};

// A thread of the plan's kernels takes kPlanSlots slots, 256 apart, so a
// block's kPlanThreads * kPlanSlots slots (41 rows at kp = 50) meet in one
// histogram in shared memory, and a block adds its count of each group to
// the device's counter once: a popular group's counter sees one atomic a
// block, not one a row (4,096 in a row at baby, serialized at the L2). A
// catalog of more than kSharedGroups groups counts in device memory
// directly.
constexpr int kPlanSlots = 8;
constexpr int kSharedGroups = 4096;

// The histogram of the slots' groups and the pad slots' -inf (cand may be
// null: the plan alone); the last block to finish scans the counts into
// each group's first work item and names each work item's group.
__global__ void __launch_bounds__(kPlanThreads)
plan_count_kernel(const int* __restrict__ gidx, uint16_t* __restrict__ cand, int* scratch,
                  int n_slots, int n_groups) {
  __shared__ int hist[kSharedGroups];
  __shared__ bool last;
  __shared__ int warp_sum[kPlanThreads / 32];
  const Plan plan(scratch, n_groups, n_slots);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool shared = n_groups <= kSharedGroups;
  if (shared)
    for (int g = tid; g < n_groups; g += kPlanThreads) hist[g] = 0;
  __syncthreads();
  const int first_slot = blockIdx.x * kPlanThreads * kPlanSlots + tid;
#pragma unroll
  for (int i = 0; i < kPlanSlots; ++i) {
    const int slot = first_slot + i * kPlanThreads;
    if (slot >= n_slots) break;
    const int grp = __ldg(gidx + slot);
    if (grp >= 0 && grp < n_groups) {
      atomicAdd((shared ? hist : plan.counts) + grp, 1);
    } else if (cand) {
      const uint32_t two = kNegInfBits | (static_cast<uint32_t>(kNegInfBits) << 16);
      uint4* out = reinterpret_cast<uint4*>(cand + static_cast<long long>(slot) * kGroup);
#pragma unroll
      for (int j = 0; j < kGroup / 8; ++j) out[j] = make_uint4(two, two, two, two);
    }
  }
  if (shared) {
    __syncthreads();
    for (int g = tid; g < n_groups; g += kPlanThreads)
      if (hist[g]) atomicAdd(plan.counts + g, hist[g]);
  }
  // this block's counts reach the L2 before its ticket does
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(plan.ticket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the exclusive scan of the work items, 256 groups a round
  int carry = 0;
  for (int base = 0; base < n_groups; base += kPlanThreads) {
    const int grp = base + tid;
    const int items = grp < n_groups ? (__ldcg(plan.counts + grp) + kRows - 1) / kRows : 0;
    int y = items;  // inclusive within the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int yo = __shfl_up_sync(0xffffffffu, y, off);
      if (lane >= off) y += yo;
    }
    if (lane == 31) warp_sum[warp] = y;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kPlanThreads / 32; ++w) {
      before += w < warp ? warp_sum[w] : 0;
      total += warp_sum[w];
    }
    if (grp < n_groups) plan.first_item[grp] = carry + before + y - items;
    carry += total;
    __syncthreads();  // warp_sum is read before the next round writes it
  }
  if (tid == 0) plan.first_item[n_groups] = carry;
  __syncthreads();
  for (int g = tid; g < n_groups; g += kPlanThreads)
    for (int it = plan.first_item[g], end = plan.first_item[g + 1]; it < end; ++it) plan.item_group[it] = g;
}

// Each real slot into its group's list: a block ranks its slots within each
// group in shared memory, takes one range of each list with one atomic, and
// writes.
__global__ void __launch_bounds__(kPlanThreads)
plan_scatter_kernel(const int* __restrict__ gidx, int* scratch, int n_slots, int n_groups) {
  __shared__ int hist[kSharedGroups];  // the block's count of each group, then its place in the list
  const Plan plan(scratch, n_groups, n_slots);
  const int tid = threadIdx.x;
  const bool shared = n_groups <= kSharedGroups;
  if (shared)
    for (int g = tid; g < n_groups; g += kPlanThreads) hist[g] = 0;
  __syncthreads();
  const int first_slot = blockIdx.x * kPlanThreads * kPlanSlots + tid;
  int grp[kPlanSlots], rank[kPlanSlots];
#pragma unroll
  for (int i = 0; i < kPlanSlots; ++i) {
    const int slot = first_slot + i * kPlanThreads;
    grp[i] = slot < n_slots ? __ldg(gidx + slot) : -1;
    rank[i] = 0;
    if (grp[i] < 0 || grp[i] >= n_groups) {
      grp[i] = -1;
    } else if (shared) {
      rank[i] = atomicAdd(hist + grp[i], 1);
    } else {
      plan.list[plan.first_item[grp[i]] * kRows + atomicAdd(plan.cursor + grp[i], 1)] = slot;
      grp[i] = -1;
    }
  }
  if (!shared) return;
  __syncthreads();
  for (int g = tid; g < n_groups; g += kPlanThreads)
    if (hist[g]) hist[g] = plan.first_item[g] * kRows + atomicAdd(plan.cursor + g, hist[g]);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPlanSlots; ++i)
    if (grp[i] >= 0) plan.list[hist[grp[i]] + rank[i]] = first_slot + i * kPlanThreads;
}

// ---- the candidates kernel (K5b with MASKED, K5c without) ----

// The mask bits of n-tile nt for this thread's two columns (2t, 2t + 1) out
// of a group's 16 mask bytes, as K5a reads them: byte nt holds the bits of
// the n-tile's items.
__device__ __forceinline__ uint32_t tile_bits(const uint32_t (&w)[4], int nt, int t) {
  return (w[nt >> 2] >> ((nt & 3) * 8 + t * 2)) & 3u;
}

// A warp's 16 rows of scores pass through shared memory, 64 items at a
// time, on their way out: kOutStride elements a row.
constexpr int kOutCols = 64;
constexpr int kOutStride = kOutCols + kPad;

template <int D>
constexpr size_t candidates_smem() {
  // the table tile, the slice's A rows, their mask pieces, their slots, and
  // each warp's rows of scores
  return static_cast<size_t>(kGroup + kRows) * (D + kPad) * 2 + kRows * 16 + kRows * 4 +
         (kCandThreads / 32) * 16 * kOutStride * 2;
}

template <int D, bool MASKED>
__global__ void __launch_bounds__(kCandThreads)
candidates_kernel(const uint16_t* __restrict__ u, const uint16_t* __restrict__ table,
                  const unsigned char* __restrict__ mask, int* scratch,
                  uint16_t* __restrict__ cand, int n, int n_groups, int kp, int n_slots) {
  constexpr int kSteps = D / 16, kVec = D / 8, kStride = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* tile = reinterpret_cast<uint16_t*>(smem);
  uint16_t* a_rows = tile + kGroup * kStride;
  uint4* mask_s = reinterpret_cast<uint4*>(a_rows + kRows * kStride);
  int* slot_s = reinterpret_cast<int*>(mask_s + kRows);
  uint16_t* out_s = reinterpret_cast<uint16_t*>(slot_s + kRows);

  const Plan plan(scratch, n_groups, n_slots);
  const int item = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  static_assert(kCandThreads == kRows, "a thread a slot of the work item");
  const int grp = __ldg(plan.item_group + item);  // -1: past the plan's last work item
  const int my_slot = __ldg(plan.list + static_cast<long long>(item) * kRows + tid);
  if (grp < 0) return;
  slot_s[tid] = my_slot;
  const int rows = __syncthreads_count(my_slot >= 0);  // the item's slots are a prefix

  // two groups of copies: the table tile and the first half's rows, then
  // the second half's rows
  const int item0 = grp * kGroup;
  for (int i = tid; i < kGroup * kVec; i += kCandThreads) {
    const int it = i / kVec, c = i % kVec;
    const bool in = item0 + it < n;
    cp_async16(tile + it * kStride + c * 8, table + static_cast<long long>(in ? item0 + it : 0) * D + c * 8, in);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (half * kHalfRows < rows) {
      for (int i = tid; i < kHalfRows * kVec; i += kCandThreads) {
        const int r = half * kHalfRows + i / kVec, c = i % kVec;
        const int slot = slot_s[r];
        const long long row = slot >= 0 ? slot / kp : 0;
        cp_async16(a_rows + r * kStride + c * 8, u + row * D + c * 8, slot >= 0);
      }
      if (MASKED && tid < kHalfRows) {
        const int r = half * kHalfRows + tid;
        const int slot = slot_s[r];
        const long long row = slot >= 0 ? slot / kp : 0;
        cp_async16(mask_s + r, mask + (row * n_groups + grp) * 16, slot >= 0);
      }
    }
    cp_async_commit();
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (half == 0) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    const int r0 = half * kHalfRows + warp * 16;  // the warp's first row of the slice
    if (r0 >= rows) continue;
    uint32_t a[kSteps][4];
    const uint16_t* p0 = a_rows + (r0 + g) * kStride + t * 2;
    const uint16_t* p1 = p0 + 8 * kStride;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      a[ks][0] = *reinterpret_cast<const uint32_t*>(p0 + ks * 16);
      a[ks][1] = *reinterpret_cast<const uint32_t*>(p1 + ks * 16);
      a[ks][2] = *reinterpret_cast<const uint32_t*>(p0 + ks * 16 + 8);
      a[ks][3] = *reinterpret_cast<const uint32_t*>(p1 + ks * 16 + 8);
    }
    float c[16][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t b0, b1;
        b_fragments<D>(tile, nt, ks, g, t, b0, b1);
        mma_bf16(c[nt], a[ks], b0, b1);
      }
    }
    uint4 m0 = make_uint4(0u, 0u, 0u, 0u), m1 = m0;
    if (MASKED) m0 = mask_s[r0 + g], m1 = mask_s[r0 + g + 8];
    const uint32_t w0[4] = {m0.x, m0.y, m0.z, m0.w}, w1[4] = {m1.x, m1.y, m1.z, m1.w};
    // a thread holds two columns of each n-tile of its two rows: rounded and
    // masked into the warp's rows in shared memory, 8 n-tiles at a time, then
    // out as 16-byte vectors, 128 contiguous bytes of a row by 8 lanes
    uint16_t* out = out_s + warp * 16 * kOutStride;
#pragma unroll
    for (int part = 0; part < kGroup / kOutCols; ++part) {
#pragma unroll
      for (int q = 0; q < kOutCols / 8; ++q) {
        const int nt = part * (kOutCols / 8) + q;
        uint32_t lo0 = bf16_bits(round_bf16(c[nt][0])), hi0 = bf16_bits(round_bf16(c[nt][1]));
        uint32_t lo1 = bf16_bits(round_bf16(c[nt][2])), hi1 = bf16_bits(round_bf16(c[nt][3]));
        if (MASKED) {
          const uint32_t bits0 = tile_bits(w0, nt, t), bits1 = tile_bits(w1, nt, t);
          if (bits0 & 1u) lo0 = kNegInfBits;
          if (bits0 & 2u) hi0 = kNegInfBits;
          if (bits1 & 1u) lo1 = kNegInfBits;
          if (bits1 & 2u) hi1 = kNegInfBits;
        }
        *reinterpret_cast<uint32_t*>(out + g * kOutStride + q * 8 + t * 2) = lo0 | (hi0 << 16);
        *reinterpret_cast<uint32_t*>(out + (g + 8) * kOutStride + q * 8 + t * 2) = lo1 | (hi1 << 16);
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 16 * kOutCols / 8 / 32; ++j) {
        const int i = lane + 32 * j, r = i / (kOutCols / 8), v = i % (kOutCols / 8);
        const int slot = slot_s[r0 + r];
        const uint4 x = *reinterpret_cast<const uint4*>(out + r * kOutStride + v * 8);
        if (slot >= 0)
          *reinterpret_cast<uint4*>(cand + static_cast<long long>(slot) * kGroup + part * kOutCols + v * 8) = x;
      }
      __syncwarp();  // the rows are read before the next part overwrites them
    }
  }
}

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

template <int D>
cudaError_t launch_group_max(const void* u, const void* table, const void* mask, void* gmax, int b,
                             int n, cudaStream_t stream) {
  const int n_groups = (n + kGroup - 1) / kGroup;
  const int gx = (b + 127) / 128;
  // enough blocks for a few waves over the card's SMs; a block walks the
  // groups its blockIdx.y leaves it
  int gy = 1024 / gx;
  gy = gy < 1 ? 1 : (gy > n_groups ? n_groups : gy);
  group_max_kernel<D><<<dim3(gx, gy), 256, 0, stream>>>(
      static_cast<const uint16_t*>(u), static_cast<const uint16_t*>(table),
      static_cast<const unsigned char*>(mask), static_cast<uint16_t*>(gmax), b, n, n_groups);
  return cudaGetLastError();
}

// The plan of n_slots slots over n_groups groups into scratch; the pad
// slots' -inf into cand unless it is null.
cudaError_t build_plan(const void* gidx, void* cand, void* scratch, int n_slots, int n_groups,
                       cudaStream_t stream) {
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, static_cast<size_t>(Plan::zeroed(n_groups)) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const Plan plan(static_cast<int*>(scratch), n_groups, n_slots);
  err = cudaMemsetAsync(plan.item_group, 0xff, static_cast<size_t>(Plan::unset(n_groups, n_slots)) * sizeof(int),
                        stream);
  if (err != cudaSuccess) return err;
  const int blocks = (n_slots + kPlanThreads * kPlanSlots - 1) / (kPlanThreads * kPlanSlots);
  plan_count_kernel<<<blocks, kPlanThreads, 0, stream>>>(
      static_cast<const int*>(gidx), static_cast<uint16_t*>(cand), static_cast<int*>(scratch),
      n_slots, n_groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  plan_scatter_kernel<<<blocks, kPlanThreads, 0, stream>>>(static_cast<const int*>(gidx),
                                                           static_cast<int*>(scratch), n_slots,
                                                           n_groups);
  return cudaGetLastError();
}

template <int D, bool MASKED>
cudaError_t launch_candidates(const void* u, const void* table, const void* gidx, const void* mask,
                              void* cand, void* scratch, int b, int n, int kp, cudaStream_t stream) {
  const int n_groups = (n + kGroup - 1) / kGroup;
  const int n_slots = b * kp;
  cudaError_t err = build_plan(gidx, cand, scratch, n_slots, n_groups, stream);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = candidates_smem<D>();
  err = cudaFuncSetAttribute(candidates_kernel<D, MASKED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // a fixed grid: as many work items as the plan can make
  candidates_kernel<D, MASKED><<<Plan::max_items(n_groups, n_slots), kCandThreads, smem, stream>>>(
      static_cast<const uint16_t*>(u), static_cast<const uint16_t*>(table),
      static_cast<const unsigned char*>(mask), static_cast<int*>(scratch),
      static_cast<uint16_t*>(cand), n, n_groups, kp, n_slots);
  return cudaGetLastError();
}

bool scratch_fits(int scratch_ints, int n_groups, int n_slots) {
  return scratch_ints >= Plan::ints(n_groups, n_slots);
}

template <bool MASKED>
int candidates(const void* u, const void* table, const void* gidx, const void* mask, void* cand,
               void* scratch, int scratch_ints, int b, int n, int d, int kp, void* stream) {
  if (b <= 0 || kp <= 0) return 0;
  if (n <= 0 || !scratch_fits(scratch_ints, (n + kGroup - 1) / kGroup, b * kp))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = as_stream(stream);
  cudaError_t err;
  if (d == 32) err = launch_candidates<32, MASKED>(u, table, gidx, mask, cand, scratch, b, n, kp, st);
  else if (d == 64) err = launch_candidates<64, MASKED>(u, table, gidx, mask, cand, scratch, b, n, kp, st);
  else if (d == 128) err = launch_candidates<128, MASKED>(u, table, gidx, mask, cand, scratch, b, n, kp, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// All tensors contiguous and 16-byte aligned; d is 32, 64 or 128 (the Python
// wrapper pads a narrower d with zeros, which is exact). n_groups is
// ceil(n / 128). Each returns a cudaError_t (0 on success).

// K5a. u: (b, d) bfloat16; table: (n, d) bfloat16; mask: (b, n_groups * 16)
// uint8; gmax: (b, n_groups) bfloat16.
extern "C" int fused_group_max_bf16(const void* u, const void* table, const void* mask, void* gmax,
                                    int b, int n, int d, void* stream) {
  if (b <= 0) return 0;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = as_stream(stream);
  cudaError_t err;
  if (d == 32) err = launch_group_max<32>(u, table, mask, gmax, b, n, st);
  else if (d == 64) err = launch_group_max<64>(u, table, mask, gmax, b, n, st);
  else if (d == 128) err = launch_group_max<128>(u, table, mask, gmax, b, n, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The plan alone, for its checks and its time: gidx (b, kp) int32; scratch
// int32 of at least 3 * n_groups + 2 + (ceil(b * kp / 128) + n_groups) * 129
// (layout: struct Plan).
extern "C" int fused_candidate_plan(const void* gidx, void* scratch, int scratch_ints, int b,
                                    int n_groups, int kp, void* stream) {
  if (b <= 0 || kp <= 0) return 0;
  if (n_groups <= 0 || !scratch_fits(scratch_ints, n_groups, b * kp))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(build_plan(gidx, nullptr, scratch, b * kp, n_groups, as_stream(stream)));
}

// K5b. gidx: (b, kp) int32 group ids; cand: (b, kp * 128) bfloat16, with the
// mask's bits applied; scratch as for fused_candidate_plan.
extern "C" int fused_candidates_bf16(const void* u, const void* table, const void* gidx,
                                     const void* mask, void* cand, void* scratch, int scratch_ints,
                                     int b, int n, int d, int kp, void* stream) {
  return candidates<true>(u, table, gidx, mask, cand, scratch, scratch_ints, b, n, d, kp, stream);
}

// K5c. The same without the mask, which is not read and may be null.
extern "C" int fused_candidates_unmasked_bf16(const void* u, const void* table, const void* gidx,
                                              const void* mask, void* cand, void* scratch,
                                              int scratch_ints, int b, int n, int d, int kp,
                                              void* stream) {
  return candidates<false>(u, table, gidx, mask, cand, scratch, scratch_ints, b, n, d, kp, stream);
}
