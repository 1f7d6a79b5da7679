// K3: exact masked top-k over the rows of a float32 or bfloat16 score matrix.
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
// j as excluded; an excluded column takes part with the value -inf. -0 ranks
// as +0. A NaN, whatever its sign, ranks above +inf (where torch.sort and
// lax.top_k put it), NaNs among themselves by index, and comes out as a NaN.
// bfloat16 rows are compared by their own bits (exact), and the values go
// back out as bfloat16.
//
// What bounds it on the H100: bytes, one read of the score row (4 B a column,
// 2 B in bfloat16) and of its mask bits: 1.03 GB at (4096 x 63001) float32,
// 115 MB at the DiffMM-baby shape (4096 x 7050). The selection itself has to
// stay small beside that read.
//
// Design: one 256-thread block a row, one threshold for the whole block, the
// candidates in shared memory, one small ranking.
// - A score becomes a 32-bit key that orders as the float does (K4's trick),
//   and a candidate one 64-bit word, the key above the complemented column,
//   so that "larger value, then lower index" is one integer compare and no
//   two words of a row are equal.
// - Pass 1: the block reads the row once in 16-byte vectors (the row's
//   unaligned first and last columns apart: a row of 63,001 floats starts on
//   any 4-byte address), four vectors in flight a thread, the mask bits
//   applied from the two bytes a vector spans. A thread keeps only the
//   largest key of the columns it visits. A row of at most kStageBytes of
//   keys is kept in shared memory meanwhile, each thread its own vectors,
//   and pass 2 then reads no device memory; a wider row is read again, from
//   the L2.
// - Threshold: t = the k-th largest of the 256 thread maxima. Each warp
//   sorts its 32 maxima by shuffles; a value's rank is its place in its own
//   warp's list plus, by binary search, the entries before it in the other
//   seven. At least k columns are >= t, so every member of the top-k is.
//   The threads' columns interleave across the row, so for any scores whose
//   order is independent of their position about -256 ln(1 - k/256) columns
//   pass: 56 at k = 50. (The TPU's 128-wide groups would pass 125 of baby's
//   7,050.)
// - Pass 2: only a thread whose maximum reached t looks at its columns
//   again (about k of the 256, so a wide row is not read twice); every
//   column with key >= t is appended to a buffer of kCap words in shared
//   memory through a counter, one atomic add for a thread's vector.
// - Finish: each candidate counts the candidates above it; that rank is its
//   place in the output. No sort network, no k rounds of barriers.
// - Overflow (a constant row, a row with fewer than k finite scores, many
//   ties at t: more than kCap columns pass) is handled here, exactly: a radix
//   select over the key's bits, eight at a time with a 256-bin histogram in
//   shared memory, finds the k-th largest key; the columns above it are
//   collected, then the columns equal to it in index order, by block-wide
//   prefix counts over 256 columns at a time, until k are in the buffer.
// - k = 1 (the regeneration) has a kernel of its own: one maximum a thread,
//   one block-wide maximum, no second pass.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCap = 512;             // candidate buffer, 64-bit words
constexpr int kInFlight = 4;          // 16-byte loads a thread starts together
constexpr int kStageBytes = 40 * 1024;  // widest row kept in shared memory
constexpr unsigned kFull = 0xffffffffu;

using bf16_bits = unsigned short;
using u64 = unsigned long long;

// float bits -> a key that compares as the float does: -0 as +0, every NaN
// above +inf, every key above 0
__device__ __forceinline__ unsigned to_key(unsigned bits) {
  if ((bits & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;
  if (bits == 0x80000000u) bits = 0u;
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}
__device__ __forceinline__ unsigned from_key(unsigned key) {
  return (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
}
constexpr unsigned kNegInfBits = 0xff800000u;

__device__ __forceinline__ u64 pack(unsigned key, int col) {
  return (static_cast<u64>(key) << 32) | static_cast<unsigned>(~col);
}

// What differs between the score types: V scores to a 16-byte vector, the
// key of a score's bits (a bfloat16 is the upper half of a float32; its key
// keeps the upper 16 bits only, so that it survives being staged as 16 bits),
// and how a vector of keys is kept in 16 bytes of shared memory.
template <typename T>
struct Score;

template <>
struct Score<float> {
  static constexpr int V = 4;
  static constexpr int kKeyBits = 32;
  using staged = unsigned;
  static __device__ __forceinline__ unsigned key(unsigned bits) { return to_key(bits); }
  static __device__ __forceinline__ unsigned bits_at(const float* p) {
    return __float_as_uint(__ldg(p));
  }
  static __device__ __forceinline__ void keys(const uint4& raw, unsigned (&k)[V]) {
    k[0] = key(raw.x), k[1] = key(raw.y), k[2] = key(raw.z), k[3] = key(raw.w);
  }
  static __device__ __forceinline__ uint4 stage(const unsigned (&k)[V]) {
    return make_uint4(k[0], k[1], k[2], k[3]);
  }
  static __device__ __forceinline__ void unstage(const uint4& s, unsigned (&k)[V]) {
    k[0] = s.x, k[1] = s.y, k[2] = s.z, k[3] = s.w;
  }
  static __device__ __forceinline__ staged stage1(unsigned k) { return k; }
  static __device__ __forceinline__ unsigned unstage1(staged s) { return s; }
  static __device__ __forceinline__ void store(float* p, unsigned k) {
    *p = __uint_as_float(from_key(k));
  }
};

template <>
struct Score<bf16_bits> {
  static constexpr int V = 8;
  static constexpr int kKeyBits = 16;
  using staged = unsigned short;
  static __device__ __forceinline__ unsigned key(unsigned bits) {
    return to_key(bits) & 0xffff0000u;
  }
  static __device__ __forceinline__ unsigned bits_at(const bf16_bits* p) {
    return static_cast<unsigned>(__ldg(p)) << 16;
  }
  static __device__ __forceinline__ void keys(const uint4& raw, unsigned (&k)[V]) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      k[2 * i] = key(w[i] << 16);  // little-endian: the lower half comes first
      k[2 * i + 1] = key(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 stage(const unsigned (&k)[V]) {
    return make_uint4((k[0] >> 16) | k[1], (k[2] >> 16) | k[3], (k[4] >> 16) | k[5],
                      (k[6] >> 16) | k[7]);
  }
  static __device__ __forceinline__ void unstage(const uint4& s, unsigned (&k)[V]) {
    const unsigned w[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      k[2 * i] = w[i] << 16;
      k[2 * i + 1] = w[i] & 0xffff0000u;
    }
  }
  static __device__ __forceinline__ staged stage1(unsigned k) {
    return static_cast<staged>(k >> 16);
  }
  static __device__ __forceinline__ unsigned unstage1(staged s) {
    return static_cast<unsigned>(s) << 16;
  }
  static __device__ __forceinline__ void store(bf16_bits* p, unsigned k) {
    *p = static_cast<bf16_bits>(from_key(k) >> 16);
  }
};

// One row: the scores, the mask bits, and where its 16-byte vectors lie.
// Columns [0, head) and [tail, n) are the unaligned ends, fewer than V each;
// vector c holds columns head + c * V ... + V - 1.
template <typename T>
struct Row {
  using S = Score<T>;
  const T* s;
  const unsigned char* m;  // null: no mask
  int n, head, n_vec, tail;

  __device__ __forceinline__ Row(const T* scores, const unsigned char* mask, int mask_stride,
                                 int row, int n_)
      : s(scores + static_cast<long long>(row) * n_),
        m(mask ? mask + static_cast<long long>(row) * mask_stride : nullptr),
        n(n_) {
    const unsigned addr = static_cast<unsigned>(reinterpret_cast<unsigned long long>(s));
    head = min(n, static_cast<int>(((16u - (addr & 15u)) & 15u) / sizeof(T)));
    n_vec = (n - head) / S::V;
    tail = head + n_vec * S::V;
  }

  // the ends: column of the i-th of them, i < n_ends()
  __device__ __forceinline__ int n_ends() const { return head + n - tail; }
  __device__ __forceinline__ int end_col(int i) const { return i < head ? i : tail + i - head; }

  __device__ __forceinline__ unsigned key_at(int j) const {
    if (m && ((__ldg(m + (j >> 3)) >> (j & 7)) & 1)) return S::key(kNegInfBits);
    return S::key(S::bits_at(s + j));
  }
  __device__ __forceinline__ uint4 raw_vec(int c) const {
    return __ldg(reinterpret_cast<const uint4*>(s + head) + c);
  }
  // the V mask bits of vector c, from the one or two bytes it spans
  __device__ __forceinline__ unsigned mask_bits(int c) const {
    if (!m) return 0u;
    const int col = head + c * S::V;
    unsigned bits = __ldg(m + (col >> 3));
    if ((col & 7) + S::V > 8) bits |= static_cast<unsigned>(__ldg(m + (col >> 3) + 1)) << 8;
    return bits >> (col & 7);
  }
  __device__ __forceinline__ void vec_keys(const uint4& raw, unsigned mbits,
                                           unsigned (&k)[S::V]) const {
    S::keys(raw, k);
#pragma unroll
    for (int i = 0; i < S::V; ++i)
      if ((mbits >> i) & 1) k[i] = S::key(kNegInfBits);
  }
};

enum Source { kGlobal, kGlobalAndStage, kStaged };

// Calls f(keys, first column, count) for each of this thread's 16-byte
// vectors (count = V) and for its one column of the row's ends, if it has
// one (count = 1); f loops over all V keys under `i < count`, so that the
// keys stay in registers. Threads' vectors interleave: vector c is thread c % 256's.
// With kGlobalAndStage the keys are also left in `stage`, where kStaged
// finds them: each thread reads back only what it wrote.
template <typename T, Source SRC, typename F>
__device__ __forceinline__ void visit(const Row<T>& r, uint4* stage, int tid, F&& f) {
  using S = Score<T>;
  constexpr int V = S::V;
  typename S::staged* stage_ends = reinterpret_cast<typename S::staged*>(stage + r.n_vec);
  for (int c0 = tid; c0 < r.n_vec; c0 += kInFlight * kThreads) {
    uint4 raw[kInFlight];
    unsigned mbits[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int c = c0 + u * kThreads;
      if (c < r.n_vec) {
        if (SRC == kStaged) {
          raw[u] = stage[c];
        } else {
          raw[u] = r.raw_vec(c);
          mbits[u] = r.mask_bits(c);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int c = c0 + u * kThreads;
      if (c < r.n_vec) {
        unsigned k[V];
        if (SRC == kStaged) {
          S::unstage(raw[u], k);
        } else {
          r.vec_keys(raw[u], mbits[u], k);
          if (SRC == kGlobalAndStage) stage[c] = S::stage(k);
        }
        f(k, r.head + c * V, V);
      }
    }
  }
  if (tid < r.n_ends()) {
    unsigned k[V];
    if (SRC == kStaged) {
      k[0] = S::unstage1(stage_ends[tid]);
    } else {
      k[0] = r.key_at(r.end_col(tid));
      if (SRC == kGlobalAndStage) stage_ends[tid] = S::stage1(k[0]);
    }
    f(k, r.end_col(tid), 1);
  }
}

// The warp's 32 values in descending order, lane l's the l-th largest
// (bitonic, by shuffles).
__device__ __forceinline__ unsigned warp_sort_desc(unsigned v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned other = __shfl_xor_sync(kFull, v, j);
      const bool keep_max = ((lane & j) == 0) == ((lane & k) == 0);
      v = keep_max ? max(v, other) : min(v, other);
    }
  }
  return v;
}

__device__ __forceinline__ u64 warp_max(u64 w) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) w = max(w, __shfl_xor_sync(kFull, w, off));
  return w;
}

// k = 1: the largest word of the row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_top1_kernel(const T* __restrict__ scores, const unsigned char* __restrict__ mask,
                   int mask_stride, T* __restrict__ out_v, long long* __restrict__ out_i, int n) {
  __shared__ u64 warp_win[kWarps];
  const int tid = threadIdx.x;
  const Row<T> r(scores, mask, mask_stride, blockIdx.x, n);
  u64 best = 0;
  visit<T, kGlobal>(r, nullptr, tid, [&](const unsigned(&key)[Score<T>::V], int col, int cnt) {
#pragma unroll
    for (int i = 0; i < Score<T>::V; ++i)
      if (i < cnt) best = max(best, pack(key[i], col + i));
  });
  best = warp_max(best);
  if ((tid & 31) == 0) warp_win[tid >> 5] = best;
  __syncthreads();
  if (tid < 32) {
    best = warp_max(tid < kWarps ? warp_win[tid] : 0);
    if (tid == 0) {
      Score<T>::store(out_v + blockIdx.x, static_cast<unsigned>(best >> 32));
      out_i[blockIdx.x] = static_cast<long long>(~static_cast<unsigned>(best));
    }
  }
}

// 1 < k <= 64. STAGE: the row's keys fit the dynamic shared memory.
template <typename T, bool STAGE>
__global__ void __launch_bounds__(kThreads)
masked_topk_kernel(const T* __restrict__ scores, const unsigned char* __restrict__ mask,
                   int mask_stride, T* __restrict__ out_v, long long* __restrict__ out_i, int n,
                   int k) {
  using S = Score<T>;
  extern __shared__ uint4 stage[];
  __shared__ u64 cand[kCap];
  __shared__ unsigned sorted[kWarps][32];
  __shared__ unsigned hist[256];
  __shared__ int warp_count[2][kWarps];
  __shared__ int count;        // columns that passed the threshold
  __shared__ int count_above;  // overflow path: columns above the k-th key
  __shared__ unsigned chosen;
  __shared__ int chosen_want;
  constexpr Source kAgain = STAGE ? kStaged : kGlobal;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Row<T> r(scores, mask, mask_stride, blockIdx.x, n);

  // ---- pass 1: a maximum a thread ----
  unsigned best = 0;
  visit<T, STAGE ? kGlobalAndStage : kGlobal>(r, stage, tid, [&](const unsigned(&key)[S::V], int, int cnt) {
#pragma unroll
    for (int i = 0; i < S::V; ++i)
      if (i < cnt) best = max(best, key[i]);
  });
  // ---- the threshold: the k-th largest of the thread maxima ----
  {
    // ordered by (value, warp, place in the warp's sorted list): no two alike
    const unsigned mine = warp_sort_desc(best, lane);
    sorted[warp][lane] = mine;
    if (tid == 0) count = count_above = 0;
    __syncthreads();
    int rank = lane;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) continue;
      const unsigned* a = sorted[w];
      // the entries of warp w's list before `mine`: a prefix, by binary search
      int before = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        const unsigned p = a[before + step - 1];
        if (w < warp ? p >= mine : p > mine) before += step;
      }
      const unsigned p = a[before];  // before <= 31: the whole list?
      if (w < warp ? p >= mine : p > mine) ++before;
      rank += before;
    }
    if (rank == k - 1) chosen = mine;
  }
  __syncthreads();
  const unsigned t = chosen;

  // ---- pass 2: the columns at or above the threshold ----
  {
    bool full = best < t;  // nothing to add, or this thread saw the buffer overflow
    if (!full) visit<T, kAgain>(r, stage, tid, [&](const unsigned(&key)[S::V], int col, int cnt) {
      int hits = 0;
#pragma unroll
      for (int i = 0; i < S::V; ++i) hits += (i < cnt && key[i] >= t);
      if (hits == 0 || full) return;
      int at = atomicAdd(&count, hits);
      if (at + hits > kCap) {
        full = true;
        return;
      }
#pragma unroll
      for (int i = 0; i < S::V; ++i)
        if (i < cnt && key[i] >= t) cand[at++] = pack(key[i], col + i);
    });
  }
  __syncthreads();
  int c = count;

  if (c > kCap) {
    // ---- overflow: the exact k-th largest key by radix select ----
    unsigned prefix = 0, known = 0;
    int want = k;  // the want-th largest of the keys that match the prefix
    for (int shift = 24; shift >= 32 - S::kKeyBits; shift -= 8) {
      hist[tid] = 0;
      __syncthreads();
      visit<T, kAgain>(r, stage, tid, [&](const unsigned(&key)[S::V], int, int cnt) {
#pragma unroll
        for (int i = 0; i < S::V; ++i) {
          if (i >= cnt) break;
          const bool in = (key[i] & known) == prefix;
          const unsigned bin = (key[i] >> shift) & 255u;
          // lanes with the same bin add once
          const unsigned act = __activemask();
          const unsigned peers = __match_any_sync(act, in ? bin : 256u);
          if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
        }
      });
      __syncthreads();
      int above = 0;  // keys in the bins above this thread's
      for (int b = tid + 1; b < 256; ++b) above += hist[b];
      if (above < want && want <= above + static_cast<int>(hist[tid])) {
        chosen = static_cast<unsigned>(tid);
        chosen_want = want - above;
      }
      __syncthreads();
      prefix |= chosen << shift;
      known |= 255u << shift;
      want = chosen_want;
    }
    // prefix is the k-th largest key; `want` of the columns equal to it belong
    // to the top-k, the lowest indices first
    const int n_above = k - want;
    visit<T, kAgain>(r, stage, tid, [&](const unsigned(&key)[S::V], int col, int cnt) {
#pragma unroll
      for (int i = 0; i < S::V; ++i)
        if (i < cnt && key[i] > prefix) cand[atomicAdd(&count_above, 1)] = pack(key[i], col + i);
    });
    int taken = 0;
    for (int base = 0, it = 0; base < n && taken < want; base += kThreads, ++it) {
      const int j = base + tid;
      const bool tie = j < n && r.key_at(j) == prefix;
      const unsigned votes = __ballot_sync(kFull, tie);
      if (lane == 0) warp_count[it & 1][warp] = __popc(votes);
      __syncthreads();
      int before = 0, total = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int cw = warp_count[it & 1][w];
        before += w < warp ? cw : 0;
        total += cw;
      }
      const int rank = taken + before + __popc(votes & ((1u << lane) - 1u));
      if (tie && rank < want) cand[n_above + rank] = pack(prefix, j);
      taken += total;
    }
    __syncthreads();
    c = k;
  }

  // ---- finish: a candidate's rank among the candidates is its place ----
  for (int i = tid; i < c; i += kThreads) {
    const u64 w = cand[i];
    int rank = 0;
    for (int j = 0; j < c; ++j) rank += cand[j] > w;
    if (rank < k) {
      const long long o = static_cast<long long>(blockIdx.x) * k + rank;
      S::store(out_v + o, static_cast<unsigned>(w >> 32));
      out_i[o] = static_cast<long long>(~static_cast<unsigned>(w));
    }
  }
}

template <typename T>
int masked_topk(const void* scores, const void* mask, int mask_stride, void* out_v, void* out_i,
                int b, int n, int k, void* stream) {
  if (b <= 0) return 0;
  if (k < 1 || k > 64 || k > n) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<const T*>(scores);
  auto m = static_cast<const unsigned char*>(mask);
  auto v = static_cast<T*>(out_v);
  auto i = static_cast<long long*>(out_i);
  auto st = static_cast<cudaStream_t>(stream);
  if (k == 1) {
    masked_top1_kernel<T><<<b, kThreads, 0, st>>>(s, m, mask_stride, v, i, n);
    return static_cast<int>(cudaGetLastError());
  }
  // the vectors' keys and the ends', 16 bytes a vector of V columns
  const size_t stage_bytes = (static_cast<size_t>(n) / Score<T>::V + 2) * 16;
  if (stage_bytes <= kStageBytes) {
    // as many blocks an SM as the staged rows leave room for
    const cudaError_t err = cudaFuncSetAttribute(masked_topk_kernel<T, true>,
                                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    masked_topk_kernel<T, true><<<b, kThreads, stage_bytes, st>>>(s, m, mask_stride, v, i, n, k);
  } else
    masked_topk_kernel<T, false><<<b, kThreads, 0, st>>>(s, m, mask_stride, v, i, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scores: (b, n) float32; mask: null or (b, mask_stride) uint8 with
// mask_stride >= ceil(n / 8); out_v: (b, k) float32; out_i: (b, k) int64.
// Requires 1 <= k <= min(n, 64). Returns a cudaError_t (0 on success).
extern "C" int masked_topk_f32(const void* scores, const void* mask, int mask_stride,
                               void* out_v, void* out_i, int b, int n, int k, void* stream) {
  return masked_topk<float>(scores, mask, mask_stride, out_v, out_i, b, n, k, stream);
}

// The same over (b, n) bfloat16 scores, with (b, k) bfloat16 values out.
extern "C" int masked_topk_bf16(const void* scores, const void* mask, int mask_stride,
                                void* out_v, void* out_i, int b, int n, int k, void* stream) {
  return masked_topk<bf16_bits>(scores, mask, mask_stride, out_v, out_i, b, n, k, stream);
}
