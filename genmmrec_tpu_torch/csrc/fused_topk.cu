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
//       in gidx[r, :], excluded items at -inf: (B, kp * 128) bfloat16.
//   K5c writes the same scores without looking at the mask.
// A group id outside [0, n_groups) is a pad slot and yields 128 times -inf.
// Between K5a and K5b the caller picks each row's groups from the maxima.
//
// What was dropped from the TPU design: its 8,192-lane item tiles with the
// whole table resident in VMEM, the planar mask layout its unpack needed, the
// arithmetic variant of the mask, and, in the candidate kernels, the
// recomputation of every score tile with one-hot contractions picking the
// chosen groups (a TPU cannot gather by lane). Here a block reads its row's
// group ids and computes only those groups.
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
// B * kp * 256 bytes (52 MB at k = 50: 0.016 ms, the bound: bytes); their cost
// here is the B * kp table tiles of 16 KB that the blocks pull through L2,
// 3.4 GB a chunk, because rows that chose the same group do not share its
// tile.
//
// Design. Both kernels take the product from the tensor cores with
// mma.sync.m16n8k16 (bfloat16 in, float32 out): A is a 16-row tile of u, held
// in registers for the block's life, B a 128-item table tile in shared
// memory, its rows padded by 8 elements so that the fragment loads of a warp
// fall on 32 different banks.
//   K5a: a block of 8 warps owns 128 rows and walks groups blockIdx.y,
//   blockIdx.y + gridDim.y, ...; a warp owns 16 rows and all 128 columns of
//   the tile (64 accumulators a thread). Each thread rounds its 32 scores of
//   a row, applies the row's 16 mask bytes, takes the maximum, and the four
//   threads of a quad combine theirs with two shuffles. Rows past B are zero
//   in A and are not written; the mask is not read for them.
//   K5b/K5c: a block of 4 warps owns one row; its A tile holds that row and
//   15 rows of zeros, so that a candidate comes out of the same instruction,
//   in the same order of accumulation, as the score K5a folded. For each of
//   the row's groups the block loads the tile, each warp multiplies 32 of its
//   columns, and the four threads that hold row 0 round, mask and store.
// Table rows past the catalog are loaded as zeros, never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;  // items in a group, and in a table tile
constexpr int kPad = 8;      // elements of padding after each tile row
constexpr uint16_t kNegInfBits = 0xFF80;  // -inf as bfloat16

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

template <int D, bool MASKED>
__global__ void __launch_bounds__(128)
candidates_kernel(const uint16_t* __restrict__ u, const uint16_t* __restrict__ table,
                  const int* __restrict__ gidx, const unsigned char* __restrict__ mask,
                  uint16_t* __restrict__ cand, int n, int n_groups, int kp) {
  constexpr int kSteps = D / 16;
  __shared__ __align__(16) uint16_t tile[kGroup * (D + kPad)];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long row = blockIdx.x;

  // row 0 of the A tile is the block's row of u; rows 1..15 are zero
  uint32_t a[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const uint16_t* p = u + row * D + ks * 16 + t * 2;
    a[ks][0] = g == 0 ? __ldg(reinterpret_cast<const uint32_t*>(p)) : 0u;
    a[ks][2] = g == 0 ? __ldg(reinterpret_cast<const uint32_t*>(p + 8)) : 0u;
    a[ks][1] = a[ks][3] = 0u;
  }

  const unsigned char* mrow = MASKED ? mask + row * n_groups * 16 : nullptr;
  for (int j = 0; j < kp; ++j) {
    const int gid = __ldg(gidx + row * kp + j);  // the same for the whole block
    uint16_t* out = cand + (row * kp + j) * kGroup;
    if (gid < 0 || gid >= n_groups) {  // a pad slot
      out[tid] = kNegInfBits;
      continue;
    }
    __syncthreads();  // the previous tile has been consumed
    load_tile<D, 128>(tile, table, gid * kGroup, n, tid);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int nt = warp * 4 + q;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t b0, b1;
        b_fragments<D>(tile, nt, ks, g, t, b0, b1);
        mma_bf16(c, a[ks], b0, b1);
      }
      if (g == 0) {
        uint32_t lo = bf16_bits(round_bf16(c[0])), hi = bf16_bits(round_bf16(c[1]));
        if (MASKED) {
          const uint32_t bits = (static_cast<uint32_t>(__ldg(mrow + gid * 16 + nt)) >> (t * 2)) & 3u;
          if (bits & 1u) lo = kNegInfBits;
          if (bits & 2u) hi = kNegInfBits;
        }
        *reinterpret_cast<uint32_t*>(out + nt * 8 + t * 2) = lo | (hi << 16);
      }
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

template <int D, bool MASKED>
cudaError_t launch_candidates(const void* u, const void* table, const void* gidx, const void* mask,
                              void* cand, int b, int n, int kp, cudaStream_t stream) {
  const int n_groups = (n + kGroup - 1) / kGroup;
  candidates_kernel<D, MASKED><<<b, 128, 0, stream>>>(
      static_cast<const uint16_t*>(u), static_cast<const uint16_t*>(table),
      static_cast<const int*>(gidx), static_cast<const unsigned char*>(mask),
      static_cast<uint16_t*>(cand), n, n_groups, kp);
  return cudaGetLastError();
}

template <bool MASKED>
int candidates(const void* u, const void* table, const void* gidx, const void* mask, void* cand,
               int b, int n, int d, int kp, void* stream) {
  if (b <= 0 || kp <= 0) return 0;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = as_stream(stream);
  cudaError_t err;
  if (d == 32) err = launch_candidates<32, MASKED>(u, table, gidx, mask, cand, b, n, kp, st);
  else if (d == 64) err = launch_candidates<64, MASKED>(u, table, gidx, mask, cand, b, n, kp, st);
  else if (d == 128) err = launch_candidates<128, MASKED>(u, table, gidx, mask, cand, b, n, kp, st);
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

// K5b. gidx: (b, kp) int32 group ids; cand: (b, kp * 128) bfloat16, with the
// mask's bits applied.
extern "C" int fused_candidates_bf16(const void* u, const void* table, const void* gidx,
                                     const void* mask, void* cand, int b, int n, int d, int kp,
                                     void* stream) {
  return candidates<true>(u, table, gidx, mask, cand, b, n, d, kp, stream);
}

// K5c. The same without the mask, which is not read and may be null.
extern "C" int fused_candidates_unmasked_bf16(const void* u, const void* table, const void* gidx,
                                              const void* mask, void* cand, int b, int n, int d,
                                              int kp, void* stream) {
  return candidates<false>(u, table, gidx, mask, cand, b, n, d, kp, stream);
}
