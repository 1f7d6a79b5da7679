// K4: candidate extraction of the two-stage top-k. Per row: gather the kp
// chosen 128-wide groups of a score row, apply the exclusion mask, and take
// the exact top-k of those kp * 128 candidates by k rounds of argmax and
// knock-out.
//
// Replaces the TPU kernel genmmrec_tpu/ops/topk.py::_extract_kernel (reached
// through _candidate_extract_pallas from grouped_topk when
// GENMMREC_PALLAS_TOPK is set). On the TPU the gather was a one-hot MXU
// contraction over a masked copy of the whole (b, g, 128) plane, which forced
// a finite sentinel in place of -inf (0 * -inf is NaN), and the k rounds ran
// over (bt, kp * 128) planes in VMEM with results selected into loop-carried
// planes, as lane offsets cannot be dynamic there. Here the gather is by
// index, so the kernel reads the raw scores and the plain bit mask, keeps
// -inf for excluded items, and writes each round's winner directly.
//
// What it computes: values in descending order, equal values by the lower
// flat position first. The wrapper hands the groups on sorted by id, so flat
// position order is item-index order: lax.top_k's rule. Bit (j & 7) of byte
// (j >> 3) of a row's packed mask excludes item j: it takes part with the
// value -inf. A group id outside [0, n_groups) is a pad slot, and the items
// past the catalog in the ragged last group are pad entries: neither is ever
// listed; when a row runs out of real candidates the rest of its list is
// (-inf, -1). bfloat16 rows are widened to float on load, which is exact,
// and the values go back out as bfloat16.
//
// What bounds it on the H100: one read of the chosen groups (kp * 128 scores
// and kp * 16 mask bytes a row) and the k rounds, a latency chain of
// block-wide reductions, which is what sets the time.
//
// Design: one 256-thread block a row. A candidate becomes a 32-bit key that
// orders as its float does (sign bit flipped for positives, all bits for
// negatives; -inf maps above 0), pad entries get key 0. Thread t stages and
// owns positions t, t + 256, ... of the candidate plane in dynamic shared
// memory (kp * 128 keys and the kp group ids: 25,800 bytes at kp = 50; kp up
// to kMaxGroups = 448, 231,168 of the 232,448 bytes a block may opt in to), so
// neighbouring threads load neighbouring scores and no barrier guards the
// plane. A wider kp is the wrapper's to refuse: ops/topk.py sends such rows
// to K3. Each thread keeps the best of its positions as one 64-bit word, key
// above the complemented position, so a plain maximum is the argmax with the
// lower position winning ties. A round
// is a warp-shuffle maximum, one barrier over the eight warp winners (the
// buffer alternates, so one barrier a round is enough), then the owner of the
// winning position zeroes its key and rescans its own positions.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 128;
constexpr int kMaxGroups = 448;  // kp * (128 + 1) * 4 B, with 128 B of static shared memory, fits

using bf16_bits = unsigned short;
using u64 = unsigned long long;

__device__ __forceinline__ unsigned load_bits(const float* p) { return __float_as_uint(__ldg(p)); }
__device__ __forceinline__ unsigned load_bits(const bf16_bits* p) {
  return static_cast<unsigned>(__ldg(p)) << 16;
}
__device__ __forceinline__ void store_bits(float* p, unsigned bits) { *p = __uint_as_float(bits); }
__device__ __forceinline__ void store_bits(bf16_bits* p, unsigned bits) {
  *p = static_cast<bf16_bits>(bits >> 16);
}

// float bits <-> a key that compares as the float does (-0 as +0, which
// are equal); every float's key is above 0
__device__ __forceinline__ unsigned to_key(unsigned bits) {
  if (bits == 0x80000000u) bits = 0u;
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}
__device__ __forceinline__ unsigned from_key(unsigned key) {
  return (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
}

constexpr unsigned kNegInfBits = 0xff800000u;

__device__ __forceinline__ u64 pack(unsigned key, int pos) {
  return (static_cast<u64>(key) << 32) | static_cast<unsigned>(~pos);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
candidate_extract_kernel(const T* __restrict__ scores, const int* __restrict__ gidx,
                         const unsigned char* __restrict__ mask, int mask_stride,
                         T* __restrict__ out_v, long long* __restrict__ out_i, int n, int kp,
                         int k) {
  extern __shared__ unsigned keys[];  // kp * kGroup keys, then the kp group ids
  int* groups = reinterpret_cast<int*>(keys + kp * kGroup);
  __shared__ u64 warp_win[2][kWarps];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_groups = (n + kGroup - 1) / kGroup;
  const T* s = scores + static_cast<long long>(row) * n;
  const unsigned char* m = mask ? mask + static_cast<long long>(row) * mask_stride : nullptr;

  for (int i = tid; i < kp; i += kThreads) groups[i] = __ldg(gidx + static_cast<long long>(row) * kp + i);
  __syncthreads();

  const int kc = kp * kGroup;
  u64 best = 0;
  for (int pos = tid; pos < kc; pos += kThreads) {
    const int g = groups[pos / kGroup];
    const int j = g * kGroup + pos % kGroup;
    unsigned key = 0;
    if (g >= 0 && g < n_groups && j < n) {
      const bool excluded = m && ((__ldg(m + (j >> 3)) >> (j & 7)) & 1);
      key = to_key(excluded ? kNegInfBits : load_bits(s + j));
    }
    keys[pos] = key;
    best = max(best, pack(key, pos));
  }

  for (int r = 0; r < k; ++r) {
    u64 w = best;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) w = max(w, __shfl_xor_sync(0xffffffffu, w, off));
    if ((tid & 31) == 0) warp_win[r & 1][tid >> 5] = w;
    __syncthreads();
    w = warp_win[r & 1][0];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) w = max(w, warp_win[r & 1][i]);
    const unsigned key = static_cast<unsigned>(w >> 32);
    const int pos = static_cast<int>(~static_cast<unsigned>(w));
    if (tid == 0) {
      const long long o = static_cast<long long>(row) * k + r;
      // key 0: no real candidate is left
      store_bits(out_v + o, key ? from_key(key) : kNegInfBits);
      out_i[o] = key ? static_cast<long long>(groups[pos / kGroup]) * kGroup + pos % kGroup : -1;
    }
    if (key && pos % kThreads == tid) {
      keys[pos] = 0;
      best = 0;
      for (int p = tid; p < kc; p += kThreads) best = max(best, pack(keys[p], p));
    }
  }
}

template <typename T>
int candidate_extract(const void* scores, const void* gidx, const void* mask, int mask_stride,
                      void* out_v, void* out_i, int b, int n, int kp, int k, void* stream) {
  if (b <= 0) return 0;
  if (n < 1 || kp < 1 || kp > kMaxGroups || k < 1 || k > kp * kGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kp * (kGroup + 1) * static_cast<int>(sizeof(unsigned));
  const cudaError_t err =
      cudaFuncSetAttribute(candidate_extract_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  candidate_extract_kernel<T><<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(scores), static_cast<const int*>(gidx),
      static_cast<const unsigned char*>(mask), mask_stride, static_cast<T*>(out_v),
      static_cast<long long*>(out_i), n, kp, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scores: (b, n) float32; gidx: (b, kp) int32 group ids, kp <= 448; mask: null
// or (b, mask_stride) uint8 with mask_stride >= ceil(n / 8); out_v: (b, k)
// float32; out_i: (b, k) int64 item indices. Returns a cudaError_t (0 on success).
extern "C" int candidate_extract_f32(const void* scores, const void* gidx, const void* mask,
                                     int mask_stride, void* out_v, void* out_i, int b, int n,
                                     int kp, int k, void* stream) {
  return candidate_extract<float>(scores, gidx, mask, mask_stride, out_v, out_i, b, n, kp, k,
                                  stream);
}

// The same over (b, n) bfloat16 scores, with (b, k) bfloat16 values out.
extern "C" int candidate_extract_bf16(const void* scores, const void* gidx, const void* mask,
                                      int mask_stride, void* out_v, void* out_i, int b, int n,
                                      int kp, int k, void* stream) {
  return candidate_extract<bf16_bits>(scores, gidx, mask, mask_stride, out_v, out_i, b, n, kp, k,
                                      stream);
}
