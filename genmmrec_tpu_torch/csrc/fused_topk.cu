// K5a, K5b, K5c: the kernel stages of the fused score + mask + top-k of
// the bf16 full-catalog evaluation. The (B, n_items) score plane of a user
// chunk is never written to device memory.
//
// They replace the three Pallas kernels of genmmrec_tpu/ops/fused_topk.py:
//   K5a  fold_kernel                  _fold_kernel      (pallas_call at :293)
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
// against the card's 295).
// K5b and K5c compute kp * 128 * d multiply-adds a row (all of the plane at
// baby, where kp = 50 of 56 groups; an eighth of it at elec) and must write
// the candidates, B * kp * 256 bytes: 52 MB at B 4096, k = 50, 0.016 ms at
// 3.35 TB/s. That write is their bound (bytes); the operations take 0.004 ms.
//
// Design of K5a: a persistent, warp-specialised wgmma pass fed by TMA.
// - Work. A unit is 512 rows of u and a chunk of the groups (fold_work): the
//   groups are cut into as many chunks as the SMs allow beside the rows'
//   chunks, so that at B 4,096 the 132 SMs take one unit each (8 row chunks x
//   16 chunks of 31 groups at elec). Every block re-reads the table from the
//   L2 once a row chunk (8 x 8.1 MB at elec, against 32 x in the first
//   design); the mask and u are read once.
// - The block: one producer warpgroup (40 registers a thread after
//   setmaxnreg) and four consumer warpgroups (104). One producer thread
//   issues TMA copies: the unit's 512 rows of u once, into shared memory,
//   then for each group a ring stage (four deep at d = 64) of its table tile
//   and the rows' 16 mask bytes, each stage completing on an mbarrier and
//   freed by the consumers' arrivals. Tiles keep TMA's swizzle (128 bytes,
//   64 for d = 32; d = 128 is two K-blocks); wgmma reads them through
//   descriptors of the same swizzle.
// - A consumer warpgroup owns 128 of the unit's rows: for each group, two
//   64 x 128 tiles, each wgmma.m64n128k16 in 16-wide k-steps from shared A
//   (u) and B (the table tile), then folded. The four warpgroups run out of
//   step, so one's MMAs run while another folds. (Two accumulators a
//   warpgroup, the next tile's wgmma in flight during the fold, made ptxas
//   serialize the wgmmas: C7514, C7518; that build was no faster.)
// - The fold: each thread holds rows lane / 4 and + 8, columns 8j + 2t and
//   + 1 of each n-tile j. Its 16 mask bytes of a row become one 32-bit word
//   (mask_word: bit 8q + 2i + c is column c of n-tile 4i + q), the float32
//   maximum of its included sums is taken (a warp none of whose rows
//   excludes an item in the group takes them all, without tests), the quad
//   combines with two shuffles, and the maximum is rounded to bfloat16 once
//   (rounding is monotone, so this is the maximum of the rounded scores).
//   wgmma's sums are mma.sync's bit for bit (chip_smoke.py holds K5b's
//   candidates' maxima equal to K5a's), so the two stages agree.
// - Edges: rows past B and table rows past n are read as zeros by TMA; rows
//   past B are never written; the catalog's pad columns are excluded by the
//   mask's set bits, never by their zero scores.
// What remains (PERF.md): the tensor cores read both operands from shared
// memory at about 96 bytes a cycle, close to its limit, and the fold's
// latency is hidden only in part by four warpgroups.
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
//   cp.async, its rows padded by 8 elements (a warp's fragment loads fall
//   on 32 banks), and gathers the slice's u rows
//   into full 16-row A tiles and their 16 mask bytes beside them, in two
//   halves of 64 rows: the second half's gather is in flight while the
//   first half is multiplied and stored. A warp multiplies 16 rows by the
//   128 items with mma.sync.m16n8k16 in the same ascending k-steps as K5a's
//   wgmma, whose sums are the same bits, so that every candidate is
//   bit-equal to the score K5a folded; each thread rounds once and applies the row's
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

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

// The two B fragments of n-tile nt (items nt*8 .. nt*8+7) and k-step ks.
template <int D>
__device__ __forceinline__ void b_fragments(const uint16_t* tile, int nt, int ks, int g, int t,
                                            uint32_t& b0, uint32_t& b1) {
  const uint32_t* p =
      reinterpret_cast<const uint32_t*>(tile + (nt * 8 + g) * (D + kPad) + ks * 16 + t * 2);
  b0 = p[0];
  b1 = p[4];
}

// ---- K5a: the group maxima ----
//
// Shared memory holds every operand tile as TMA writes it with the tensor
// map's swizzle: a K-block is up to 64 elements of d (128 bytes a row; d = 32
// is one K-block of 64 bytes a row), 8 rows an atom of 8 * kRowBytes bytes,
// the 16-byte chunk c of row r stored at chunk c ^ (r % 8) (128-byte swizzle)
// or c ^ ((r / 2) % 4) (64-byte swizzle). wgmma reads it through descriptors
// of the same swizzle.
template <int D>
struct FoldShape {
  static constexpr int kKbElems = D < 64 ? D : 64;   // elements of a K-block row
  static constexpr int kRowBytes = kKbElems * 2;     // 64 or 128: the swizzle span
  static constexpr int kKBlocks = D / kKbElems;      // 1 or 2
  static constexpr int kKbSteps = kKbElems / 16;     // k-steps of 16 in a K-block
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // descriptor: 128B or 64B swizzle
  __host__ __device__ static constexpr int tile_bytes(int rows) { return rows * D * 2; }  // all K-blocks of `rows` rows
};

constexpr int kSubRows = 64;       // rows of one wgmma tile (m64)
constexpr int kFoldConsumers = 4;  // K5a's consumer warpgroups
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}
// Until the phase of parity `parity` has completed. A wait of two seconds,
// far past any copy or product, is a fault in the protocol: it traps, so
// that the launch fails instead of holding the card (try_wait may suspend
// the thread a while each time, so a count of tries is no measure of time).
// WARP: all 32 lanes wait together and leave together, the result taken
// from lane 0.
template <bool WARP>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done = mbar_try_wait(bar, parity);
    if (WARP) done = __shfl_sync(0xffffffffu, done, 0);
    if (done) return;
    if (tries % 64 == 0) {
      const uint64_t now = global_ns();
      if (tries == 0) start = now;
      else if (now - start > 2000000000ull) __trap();
    }
  }
}
// box (c0, c1) of a 2-D tensor map into shared memory; completes on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile at addr: the swizzle,
// 8 rows an atom of 8 * kRowBytes bytes (the stride byte offset); the
// leading byte offset is not read for swizzled K-major tiles.
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  using S = FoldShape<D>;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * S::kRowBytes) >> 4) << 32) | (S::kLayout << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A (64 x 16, K-major) * B (128 x 16, K-major)ᵀ + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The warpgroup's 64 x 128 tile of float32 sums: 16-wide k-steps
// ascending, as K5b forms each candidate with mma.sync (the two give the
// same bits: chip_smoke.py holds K5b's candidates' maxima equal to these).
// The first step has scale-d = 0 (D = A·B) in place of a zeroed
// accumulator; a sum can then differ from K5b's only in the sign of an exact
// zero, which fold_tile's + 0.0 removes. desc_a, desc_b: descriptors of the
// tiles' first K-blocks, a K-block a_kb (b_kb) bytes after the one before.
// Thread `lane` of warp w holds rows 16w + lane / 4 (d[4j], d[4j + 1]) and
// + 8 (d[4j + 2], d[4j + 3]), columns 8j + 2 (lane % 4) and + 1: mma.sync's
// layout of each 8-column n-tile.
template <int D>
__device__ __forceinline__ void tile_sums(float (&d)[64], uint64_t desc_a, uint32_t a_kb, uint64_t desc_b,
                                          uint32_t b_kb) {
  using S = FoldShape<D>;
  fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kb = 0; kb < S::kKBlocks; ++kb)
#pragma unroll
    for (int ks = 0; ks < S::kKbSteps; ++ks)  // a descriptor's address field counts 16 bytes
      wgmma_m64n128k16(d, desc_a + ((kb * a_kb + ks * 32) >> 4), desc_b + ((kb * b_kb + ks * 32) >> 4),
                       kb + ks > 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);
}

// The thread's 32 mask bits of one row and group, from the group's 16 mask
// bytes: byte j holds the items of n-tile j, its bits 2t and 2t + 1 this
// thread's columns. Shifted by 2t once, word i keeps n-tiles 4i .. 4i + 3 in
// bits 0-1 of its bytes; interleaved, bit 8q + 2i + c is column c of n-tile
// 4i + q.
__device__ __forceinline__ uint32_t mask_word(uint4 m, int t) {
  const int s = 2 * t;
  const uint32_t lo = 0x03030303u;
  return ((m.x >> s) & lo) | (((m.y >> s) & lo) << 2) | (((m.z >> s) & lo) << 4) | (((m.w >> s) & lo) << 6);
}

__device__ __forceinline__ constexpr uint32_t mask_bit(int j, int c) {
  return 1u << (8 * (j & 3) + 2 * (j >> 2) + c);
}

// The maxima of one 64 x 128 tile: the float32 maximum of each row's
// included sums (-inf if none), one rounding, one bfloat16 a (row, group).
// mask: this thread's row's 16 mask bytes of the group, the row 8 below
// 128 bytes on; row: that row of u.
__device__ __forceinline__ void fold_tile(const float (&d)[64], const unsigned char* mask, int row, int grp, int b,
                                          int n_groups, uint16_t* __restrict__ gmax) {
  const int t = threadIdx.x & 3;
  const uint32_t m0 = mask_word(*reinterpret_cast<const uint4*>(mask), t);
  const uint32_t m1 = mask_word(*reinterpret_cast<const uint4*>(mask + 8 * 16), t);
  float p0[4], p1[4];  // partial maxima: four chains
#pragma unroll
  for (int i = 0; i < 4; ++i) p0[i] = p1[i] = -CUDART_INF_F;
  // the warp skips the tests where none of its rows excludes an item here
  if (__any_sync(0xffffffffu, (m0 | m1) != 0u)) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (!(m0 & mask_bit(j, c))) p0[j & 3] = fmaxf(p0[j & 3], d[4 * j + c]);
        if (!(m1 & mask_bit(j, c))) p1[j & 3] = fmaxf(p1[j & 3], d[4 * j + 2 + c]);
      }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      p0[j & 3] = fmaxf(p0[j & 3], fmaxf(d[4 * j], d[4 * j + 1]));
      p1[j & 3] = fmaxf(p1[j & 3], fmaxf(d[4 * j + 2], d[4 * j + 3]));
    }
  }
  float best0 = fmaxf(fmaxf(p0[0], p0[1]), fmaxf(p0[2], p0[3]));
  float best1 = fmaxf(fmaxf(p1[0], p1[1]), fmaxf(p1[2], p1[3]));
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    best0 = fmaxf(best0, __shfl_xor_sync(0xffffffffu, best0, off));
    best1 = fmaxf(best1, __shfl_xor_sync(0xffffffffu, best1, off));
  }
  // one rounding of the maximum: rounding is monotone, so this is the
  // maximum of the rounded scores; + 0.0 makes a zero maximum +0. Thread
  // t = 0 writes row `row`, t = 1 row `row` + 8.
  row += t == 1 ? 8 : 0;
  if (t < 2 && row < b)
    gmax[static_cast<long long>(row) * n_groups + grp] = bf16_bits(round_bf16((t == 0 ? best0 : best1) + 0.0f));
}

// The persistent grid's work: units (row chunk, group chunk), group chunk
// fastest, unit_groups groups and unit_rows rows each (the last ones
// cut at n_groups and b); block x takes units x, x + gridDim.x, ...
struct FoldWork {
  int b, n_groups, unit_groups, unit_rows, group_chunks, units, stages;
  __device__ void unit(int u, int& g0, int& g1, int& r0, int& r1) const {
    g0 = (u % group_chunks) * unit_groups;
    g1 = min(n_groups, g0 + unit_groups);
    r0 = (u / group_chunks) * unit_rows;
    r1 = min(b, r0 + unit_rows);
  }
};

// K5a's block: WGS consumer warpgroups and one producer warpgroup. A unit's
// rows of u, 128 a consumer, stay in shared memory (stationary) while its
// groups stream past, a ring stage each: the group's table tile and the
// unit's rows' 16 mask bytes of it.
template <int D_>
struct FoldCfg {
  static constexpr int D = D_, WGS = kFoldConsumers;
  static constexpr int kThreads = 128 * (WGS + 1);
  static constexpr int kConsumerWarps = 4 * WGS;
  static constexpr int kUnitRows = 2 * kSubRows * WGS;  // u rows a unit holds
  static constexpr int kBoxRows = 128;                  // rows of a TMA box of u or the mask (<= 256)
  // registers a thread: ptxas gives the 640 threads 96 each at launch; the
  // producer's drop to 40 pays for the consumers' rise to 104 (launch_fold
  // checks the sum)
  static constexpr int kProducerRegs = 40, kConsumerRegs = 104;
  using S = FoldShape<D>;
  // shared memory: [u rows][stage: table tile | mask box]...[barriers]
  __host__ __device__ static constexpr int stationary() { return S::tile_bytes(kUnitRows); }
  __host__ __device__ static constexpr int stage_tile() { return S::tile_bytes(kGroup); }
  __host__ __device__ static constexpr int stage() { return stage_tile() + kUnitRows * 16; }
  // the alignment slack, the u rows, the stages, 2 * kMaxStages + 2 barriers
  __host__ __device__ static constexpr int bytes(int stages) {
    return 1024 + stationary() + stages * stage() + (2 * kMaxStages + 2) * 8;
  }
};

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
fold_kernel(const __grid_constant__ CUtensorMap map_u, const __grid_constant__ CUtensorMap map_t,
            const __grid_constant__ CUtensorMap map_m, uint16_t* __restrict__ gmax, const FoldWork work) {
  using S = FoldShape<C::D>;
  extern __shared__ unsigned char fold_smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: every tile starts on such a boundary
  unsigned char* smem = fold_smem_raw + ((1024 - (smem_u32(fold_smem_raw) & 1023)) & 1023);
  unsigned char* stat = smem;
  unsigned char* stages = stat + C::stationary();
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + work.stages * C::stage());
  // full[s], empty[s], then the u rows' full and empty
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kMaxStages;
  const uint32_t stat_full = full0 + 16 * kMaxStages, stat_empty = stat_full + 8;
  // the warp's index broadcast from lane 0: the roles below split by warp,
  // which the compiler then knows
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0), lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < work.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, C::kConsumerWarps);
    }
    mbar_init(stat_full, 1);
    mbar_init(stat_empty, C::kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= C::kConsumerWarps) {
    // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs) : "memory");
    if (threadIdx.x != C::kConsumerWarps * 32) return;
    int stage = 0;
    uint32_t phase = 0, stat_phase = 0;
    for (int u = blockIdx.x; u < work.units; u += gridDim.x) {
      int g0, g1, r0, r1;
      work.unit(u, g0, g1, r0, r1);
      mbar_wait<false>(stat_empty, stat_phase ^ 1);
      stat_phase ^= 1;
      mbar_expect_tx(stat_full, C::stationary());
      for (int kb = 0; kb < S::kKBlocks; ++kb)
        for (int j = 0; j < C::kUnitRows / C::kBoxRows; ++j)
          tma_load_2d(smem_u32(stat + (kb * C::kUnitRows + j * C::kBoxRows) * S::kRowBytes), &map_u,
                      kb * S::kKbElems, r0 + j * C::kBoxRows, stat_full);
      for (int g = g0; g < g1; ++g) {
        mbar_wait<false>(empty0 + 8 * stage, phase ^ 1);
        const uint32_t bar = full0 + 8 * stage;
        unsigned char* st = stages + stage * C::stage();
        mbar_expect_tx(bar, C::stage());
        for (int kb = 0; kb < S::kKBlocks; ++kb)
          tma_load_2d(smem_u32(st + kb * kGroup * S::kRowBytes), &map_t, kb * S::kKbElems, g * kGroup, bar);
        for (int j = 0; j < C::kUnitRows / C::kBoxRows; ++j)
          tma_load_2d(smem_u32(st + C::stage_tile() + j * C::kBoxRows * 16), &map_m, g * 16, r0 + j * C::kBoxRows,
                      bar);
        if (++stage == work.stages) stage = 0, phase ^= 1;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs) : "memory");
    // this warpgroup's two 64-row tiles of the unit's rows: their descriptors
    // and this thread's first row in each (16 rows a warp, rows r and r + 8)
    const int wg = warp >> 2;
    const int r = 16 * (warp & 3) + (lane >> 2);
    const uint64_t desc_a0 = smem_desc<C::D>(smem_u32(stat) + 2 * wg * kSubRows * S::kRowBytes);
    const uint64_t desc_a1 = desc_a0 + ((kSubRows * S::kRowBytes) >> 4);
    int stage = 0;
    uint32_t phase = 0, stat_phase = 0;
    float acc[64];
    for (int u = blockIdx.x; u < work.units; u += gridDim.x) {
      int g0, g1, r0, r1;
      work.unit(u, g0, g1, r0, r1);
      const int row0 = r0 + 2 * wg * kSubRows;  // the warpgroup's first row
      mbar_wait<true>(stat_full, stat_phase);
      stat_phase ^= 1;
      for (int g = g0; g < g1; ++g) {
        mbar_wait<true>(full0 + 8 * stage, phase);
        const unsigned char* st = stages + stage * C::stage();
        const uint64_t desc_b = smem_desc<C::D>(smem_u32(st));
        const unsigned char* mask = st + C::stage_tile() + (2 * wg * kSubRows + r) * 16;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (row0 + half * kSubRows < r1) {  // a tile with rows of u in it
            tile_sums<C::D>(acc, half ? desc_a1 : desc_a0, C::kUnitRows * S::kRowBytes, desc_b,
                            kGroup * S::kRowBytes);
            fold_tile(acc, mask + half * kSubRows * 16, row0 + half * kSubRows + r, g, work.b, work.n_groups, gmax);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * stage);
        if (++stage == work.stages) stage = 0, phase ^= 1;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(stat_empty);
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
// of a group's 16 mask bytes: byte nt holds the bits of the n-tile's items.
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

// ---- K5a's host side: tensor maps, the work plan, the launch ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so that
// the library links no libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, cols) tensor of `elem` bytes an element, read in boxes
// of (box_rows, box_cols); rows past the end are read as zeros.
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr, int rows, int cols,
               int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The last few tensor maps of one role in one build, by address and shape:
// a map describes memory, not its contents, so one encoded for the same
// (pointer, rows, cols) serves again (the item table of every chunk of an
// evaluation; repeated calls), and the launch's host time stays short.
struct MapCache {
  static constexpr int kSlots = 4;
  const void* ptr[kSlots] = {};
  int rows[kSlots] = {}, cols[kSlots] = {}, next = 0;
  CUtensorMap map[kSlots];
  bool get(CUtensorMap* out, CUtensorMapDataType type, int elem, const void* p, int r, int c, int box_rows,
           int box_cols, CUtensorMapSwizzle swizzle) {
    for (int i = 0; i < kSlots; ++i)
      if (ptr[i] == p && rows[i] == r && cols[i] == c) {
        *out = map[i];
        return true;
      }
    if (!encode_2d(out, type, elem, p, r, c, box_rows, box_cols, swizzle)) return false;
    ptr[next] = p, rows[next] = r, cols[next] = c, map[next] = *out;
    next = (next + 1) % kSlots;
    return true;
  }
};

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 && cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    count[dev] = 132;
  return count[dev];
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The work plan (mirrored by ops/fused_topk.py fold_work_plan): units of
// C::kUnitRows rows and a chunk of the groups, the groups cut into as many
// chunks as the SMs allow beside the rows' chunks, so that the units fill
// the card's SMs once where the shape allows; each block takes the units
// blockIdx.x + i * gridDim.x.
template <class C>
FoldWork fold_work(int b, int n_groups, int sms) {
  FoldWork w{};
  w.b = b;
  w.n_groups = n_groups;
  w.unit_rows = C::kUnitRows;
  const int row_chunks = cdiv(b, w.unit_rows);
  w.unit_groups = cdiv(n_groups, std::max(1, std::min(n_groups, sms / row_chunks)));
  w.group_chunks = cdiv(n_groups, w.unit_groups);
  w.units = w.group_chunks * row_chunks;
  return w;
}

// Once a build and device: the shared memory past 48 KB, and the registers
// setmaxnreg moves within a block, where the consumers' rise must be paid by
// the producer's drop from what the block was launched with, or the rise
// waits forever.
template <class C>
cudaError_t fold_setup() {
  static cudaError_t state[64];
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev < 0 || dev >= 64) return e != cudaSuccess ? e : cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(fold_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             std::min(C::bytes(kMaxStages), kSmemLimit));
    cudaFuncAttributes attr;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fold_kernel<C>);
    if (e == cudaSuccess &&
        (attr.numRegs - C::kProducerRegs) * 128 < (C::kConsumerRegs - attr.numRegs) * 128 * C::WGS)
      e = cudaErrorInvalidConfiguration;
    state[dev] = e;
    done[dev] = true;
  }
  return state[dev];
}

template <class C>
cudaError_t launch_fold(const void* u, const void* table, const void* mask, void* gmax, int b, int n,
                        cudaStream_t stream) {
  using S = FoldShape<C::D>;
  const int n_groups = cdiv(n, kGroup);
  const int sms = sm_count();
  FoldWork work = fold_work<C>(b, n_groups, sms);
  work.stages = std::min(kMaxStages, (kSmemLimit - C::bytes(0)) / C::stage());
  if (work.stages < 2) return cudaErrorInvalidValue;
  const CUtensorMapSwizzle swizzle = S::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  // the box shapes are the build's: a cache a build, role and host thread
  static thread_local MapCache cache_u, cache_t, cache_m;
  CUtensorMap map_u, map_t, map_m;
  if (!cache_u.get(&map_u, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, u, b, C::D, C::kBoxRows, S::kKbElems, swizzle) ||
      !cache_t.get(&map_t, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, table, n, C::D, kGroup, S::kKbElems, swizzle) ||
      !cache_m.get(&map_m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, mask, b, n_groups * 16, C::kBoxRows, 16,
                   CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const int smem = C::bytes(work.stages);
  const cudaError_t err = fold_setup<C>();
  if (err != cudaSuccess) return err;
  fold_kernel<C><<<std::min(work.units, sms), C::kThreads, smem, stream>>>(map_u, map_t, map_m,
                                                                          static_cast<uint16_t*>(gmax), work);
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
  cudaError_t err = cudaErrorInvalidValue;
  if (d == 32) err = launch_fold<FoldCfg<32>>(u, table, mask, gmax, b, n, st);
  else if (d == 64) err = launch_fold<FoldCfg<64>>(u, table, mask, gmax, b, n, st);
  else if (d == 128) err = launch_fold<FoldCfg<128>>(u, table, mask, gmax, b, n, st);
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
