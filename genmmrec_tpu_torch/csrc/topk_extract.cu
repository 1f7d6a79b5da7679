// K4: candidate extraction of the two-stage top-k, and the masked group
// maxima that choose its groups.
//
// candidate_extract_kernel replaces the TPU kernel
// genmmrec_tpu/ops/topk.py::_extract_kernel (reached through
// _candidate_extract_pallas from grouped_topk when GENMMREC_PALLAS_TOPK is
// set). On the TPU the gather was a one-hot MXU contraction over a masked
// copy of the whole (b, g, 128) plane, which forced a finite sentinel in place
// of -inf (0 * -inf is NaN), and the top-k was k rounds of max and knock-out
// over (bt, kp * 128) planes in VMEM. Here the gather is by index from the raw
// scores and the plain bit mask, and there are no rounds.
//
// masked_group_max_kernel is the fold in front of it: the (b, n_groups)
// float32 maxima of each row's 128-column groups, the mask applied. The
// reference computes it with XLA outside any Pallas kernel
// (genmmrec_tpu/ops/topk.py, grouped_topk's fold pass); in PyTorch it took a
// masked copy, a padded copy and an unpacked mask of the whole score plane.
//
// What they compute. K4: the exact top-k among the kp chosen groups of a
// row, values in descending order, equal values by the lower flat position
// (slot * 128 + column in the group) first. The wrapper hands the groups on
// sorted by id, so flat position order is item-index order: lax.top_k's rule.
// Bit (j & 7) of byte (j >> 3) of a row's packed mask excludes item j: it
// takes part with the value -inf. A group id outside [0, n_groups) is a pad
// slot, and the items past the catalog in the ragged last group are pad
// entries: neither is ever listed; when a row runs out of real candidates the
// rest of its list is (-inf, -1). -0 ranks as +0; a NaN, whatever its sign,
// ranks above +inf (as in torch.sort and lax.top_k). The fold: the largest
// score of each group by the same order (a NaN wins, a zero comes out as +0),
// excluded items and the columns past n at -inf. bfloat16 rows are widened to
// float on load, which is exact.
//
// What bounds them on the H100: bytes. K4 reads the chosen groups' scores
// and mask bytes once (kp * 128 * 4 B + kp * 16 B a row, 0.033 ms at
// (4096, 63001), kp = 50, float32); the fold reads the whole score plane and
// mask once (1.03 GB + 32 MB at that shape, 0.32 ms).
//
// Design of K4: one 256-thread block a row, no rounds.
// - A score becomes a 32-bit key that orders as the float does (K3's key)
//   and a candidate one 64-bit word, the key above the complemented flat
//   position, so that "larger value, then lower position" is one integer
//   compare. Pad entries get key 0, below every real key.
// - Pass 1: the group ids to shared memory, then every thread loads 16-byte
//   vectors of the chosen groups, four in flight, with the mask bytes they
//   need. A row of 63,001 floats starts on any 4-byte address, but a group
//   is 512 (or 256) bytes, so every group of a row sits the same h columns
//   past a 16-byte boundary: a group is 32 (16) vectors from the boundary at
//   or below its start, one more where h > 0, and nothing of it needs a
//   narrower load. Where kp <= kStageGroups the keys are kept in shared
//   memory as loaded, kSlot words a slot, a column outside the group keyed
//   0 (26 KB at kp = 50); a warp then reduces each group's maximum. A wider
//   kp keeps only the maxima (shared-memory atomics) and reads the groups
//   again, from the L2, in pass 2 and the select.
// - Threshold: t = the k-th largest of the kp group maxima; for kp == k, the
//   route's case, their minimum. Each of at least k groups holds a key >= t,
//   so at least k candidates pass. With kp < k every candidate passes (t = 0)
//   and the row goes to the exact select below.
// - Pass 2: the keys >= t are appended to a buffer in shared memory of
//   twice k words (at least 128, at most kCap); with a staged plane a thread
//   scans 16-byte vectors of it.
// - Finish: each candidate counts the candidates above it; that rank is its
//   place in the output.
// - Overflow (more pass than the buffer holds: constant rows, rows tied at
//   t, rows of masked -inf) is finished exactly in the same kernel, as K3
//   does: a radix select over the key's four bytes with a 256-bin histogram
//   finds the k-th largest key, the keys above it are collected, then those
//   equal to it by lowest position, by block-wide prefix counts over 256
//   positions at a time. For k <= the buffer they are ranked in it; a wider
//   k (past kCap) is written to the output in no order, with the flat
//   position in place of the item (kc + position for a pad entry), and the
//   wrapper orders the (b, k) result and maps positions to items.
//
// Design of the fold: a block a row and 512 of its groups, 16-byte vectors
// from the segment's first 16-byte boundary, four in flight a thread; a warp's
// 32 vectors then hold whole groups but for a vector's last columns (see
// masked_group_max_kernel), reduced by shuffles and one shared-memory atomic
// max a group. No masked, padded or unpacked plane is written.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 128;
constexpr int kMaxGroups = 448;    // the widest kp the wrapper hands on
constexpr int kStageGroups = 128;  // the widest kp whose keys stay in shared memory (64 KB)
constexpr int kCap = 512;          // candidate buffer, 64-bit words
constexpr int kFoldGroups = 512;   // groups a block of the fold takes (2 KB of maxima)
constexpr int kFoldAhead = 4;      // 16-byte vectors a thread of the fold loads together
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNegInfBits = 0xff800000u;

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

__device__ __forceinline__ u64 pack(unsigned key, int pos) {
  return (static_cast<u64>(key) << 32) | static_cast<unsigned>(~pos);
}

__device__ __forceinline__ unsigned warp_max(unsigned v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The key of item j of a row: 0 where `live` is false (a pad entry), the
// key of -inf where the mask excludes it. Both loads are issued before
// either is looked at.
template <typename T>
__device__ __forceinline__ unsigned item_key(const T* s, const unsigned char* m, int j, bool live) {
  const unsigned bits = live ? load_bits(s + j) : 0u;
  const bool excluded = live && m && ((__ldg(m + (j >> 3)) >> (j & 7)) & 1);
  return live ? to_key(excluded ? kNegInfBits : bits) : 0u;
}

// One row's chosen groups: the key at flat position pos = slot * 128 + c.
template <typename T>
struct Chosen {
  const T* s;
  const unsigned char* m;  // null: no mask
  const int* groups;       // the row's kp group ids, in shared memory
  int n, n_groups;

  __device__ __forceinline__ unsigned key(int gid, int c) const {
    const bool live = gid >= 0 && gid < n_groups && gid * kGroup + c < n;
    return item_key(s, m, live ? gid * kGroup + c : 0, live);
  }
  __device__ __forceinline__ unsigned key_at(int pos) const { return key(groups[pos / kGroup], pos % kGroup); }

  // Calls f(slot, v, keys) once for each unit of the kp chosen groups: unit
  // v of a slot is the 16-byte vector v vectors past the 16-byte boundary at
  // or below the group's start, its V keys a column outside the group (or
  // past n, or of a pad slot) keyed 0. A row of 63,001 floats starts on any
  // 4-byte address, but a group is 512 (or 256) bytes, so every group of a
  // row sits the same h columns past a boundary: column c of the group is
  // key (h + c) % V of unit (h + c) / V, and a group spans 128 / V units, one
  // more where h > 0 (U a slot). Thread t takes units t, t + 256, ...;
  // kAhead units' scores and mask bytes are loaded before the first is
  // looked at.
  template <typename F>
  __device__ __forceinline__ void visit(int kp, int tid, int h, F&& f) const {
    constexpr int V = 16 / sizeof(T);
    constexpr int U = kGroup / V + 1;
    constexpr int kAhead = 4;
    const int n_units = kp * U;
    const uint4* aligned = reinterpret_cast<const uint4*>(reinterpret_cast<unsigned long long>(s) & ~15ull);
    for (int u0 = tid; u0 < n_units; u0 += kAhead * kThreads) {
      uint4 raw[kAhead];
      unsigned mb[kAhead];
      int first[kAhead], lo[kAhead], hi[kAhead];  // the unit's first column; the group's columns
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        const int u = u0 + a * kThreads;
        const int gid = u < n_units ? groups[u / U] : -1;
        const bool real = gid >= 0 && gid < n_groups;
        lo[a] = real ? gid * kGroup : 0;
        hi[a] = real ? min(lo[a] + kGroup, n) : 0;  // empty for a pad slot
        first[a] = lo[a] - h + V * (u % U);
        const bool live = hi[a] > lo[a] && first[a] < hi[a];
        raw[a] = live ? __ldg(aligned + (first[a] + h) / V) : make_uint4(0u, 0u, 0u, 0u);
        mb[a] = 0u;
        if (live && m) {
          // the bit of column first + i at bit i + 8
          const int b0 = max(first[a], lo[a]) >> 3, b1 = min(first[a] + V, hi[a]) - 1 >> 3;
          mb[a] = (__ldg(m + b0) | (static_cast<unsigned>(__ldg(m + b1)) << 8)) << (b0 * 8 - first[a] + 8);
        }
      }
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        const int u = u0 + a * kThreads;
        if (u >= n_units) break;
        const unsigned w[4] = {raw[a].x, raw[a].y, raw[a].z, raw[a].w};
        unsigned key[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const unsigned bits = V == 4 ? w[i] : (i & 1 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
          const bool excluded = (mb[a] >> (i + 8)) & 1u;
          const int col = first[a] + i;
          key[i] = col >= lo[a] && col < hi[a] ? to_key(excluded ? kNegInfBits : bits) : 0u;
        }
        f(u / U, u % U, key);
      }
    }
  }
};

// K4's output for one candidate word: the value and the item, (-inf, -1)
// for a pad entry.
template <typename T>
__device__ __forceinline__ void store_word(T* out_v, long long* out_i, long long o, u64 w,
                                           const int* groups) {
  const unsigned key = static_cast<unsigned>(w >> 32);
  const int pos = static_cast<int>(~static_cast<unsigned>(w));
  store_bits(out_v + o, key ? from_key(key) : kNegInfBits);
  out_i[o] = key ? static_cast<long long>(groups[pos / kGroup]) * kGroup + pos % kGroup : -1;
}

template <typename T, bool STAGE>
__global__ void __launch_bounds__(kThreads)
candidate_extract_kernel(const T* __restrict__ scores, const int* __restrict__ gidx,
                         const unsigned char* __restrict__ mask, int mask_stride,
                         T* __restrict__ out_v, long long* __restrict__ out_i, int n, int kp,
                         int k, int cap) {
  // dynamic: (STAGE) the staged keys, kSlot a slot; the kp group ids; the kp
  // group maxima; the candidate buffer of `cap` words. kSlot is even, so the
  // buffer starts an even number of words in: 8-byte aligned for any kp.
  constexpr int kSlot = (kGroup * static_cast<int>(sizeof(T)) / 16 + 1) * (16 / static_cast<int>(sizeof(T)));
  static_assert(kSlot % 2 == 0, "the candidate buffer must stay 8-byte aligned");
  extern __shared__ uint4 dyn_vec[];
  unsigned* plane = reinterpret_cast<unsigned*>(dyn_vec);
  int* groups = reinterpret_cast<int*>(plane + (STAGE ? kp * kSlot : 0));
  unsigned* gmax = reinterpret_cast<unsigned*>(groups + kp);
  u64* cand = reinterpret_cast<u64*>(gmax + kp);
  __shared__ unsigned hist[256];
  __shared__ int warp_count[2][kWarps];
  __shared__ int count;        // keys that passed the threshold
  __shared__ int count_above;  // overflow: keys above the k-th
  __shared__ unsigned threshold, chosen;
  __shared__ int chosen_want;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row = blockIdx.x;
  const int kc = kp * kGroup;
  // column c of a staged slot's group lies at slot * kSlot + h + c
  const int h = static_cast<int>((reinterpret_cast<unsigned long long>(scores + row * n) & 15u) / sizeof(T));
  const Chosen<T> c{scores + row * n, mask ? mask + row * mask_stride : nullptr, groups, n,
                    (n + kGroup - 1) / kGroup};

  for (int i = tid; i < kp; i += kThreads) groups[i] = __ldg(gidx + row * kp + i);
  if (tid == 0) count = count_above = 0, threshold = 0u;
  __syncthreads();

  // ---- pass 1: the keys (kept where STAGE) and each group's maximum ----
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if (STAGE) {
    // kept as loaded: unit v of a slot at slot * kSlot + V * v
    c.visit(kp, tid, h, [&](int slot, int v, const unsigned(&key)[V]) {
      uint4* dst = reinterpret_cast<uint4*>(plane + slot * kSlot + V * v);
#pragma unroll
      for (int q = 0; q < V / 4; ++q) dst[q] = make_uint4(key[4 * q], key[4 * q + 1], key[4 * q + 2], key[4 * q + 3]);
    });
    __syncthreads();
    for (int slot = warp; slot < kp; slot += kWarps) {
      const unsigned* g = plane + slot * kSlot + h + lane;
      const unsigned mx = warp_max(max(max(g[0], g[32]), max(g[64], g[96])));
      if (lane == 0) gmax[slot] = mx;
    }
  } else {
    for (int i = tid; i < kp; i += kThreads) gmax[i] = 0u;
    __syncthreads();
    c.visit(kp, tid, h, [&](int slot, int, const unsigned(&key)[V]) {
      unsigned mx = 0u;
#pragma unroll
      for (int i = 0; i < V; ++i) mx = max(mx, key[i]);
      atomicMax(gmax + slot, mx);
    });
  }
  __syncthreads();

  // ---- the threshold: the k-th largest group maximum (0 if kp < k) ----
  if (kp == k) {
    // the route's case: the smallest maximum
    if (warp == 0) {
      unsigned lo = 0xffffffffu;
      for (int s = lane; s < kp; s += 32) lo = min(lo, gmax[s]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) lo = min(lo, __shfl_xor_sync(kFull, lo, off));
      if (lane == 0) threshold = lo;
    }
  } else if (kp > k) {
    for (int s = tid; s < kp; s += kThreads) {
      const unsigned v = gmax[s];
      int rank = 0;  // by (maximum, then slot): no two alike
      for (int j = 0; j < kp; ++j) {
        const unsigned w = gmax[j];
        rank += w > v || (w == v && j < s);
      }
      if (rank == k - 1) threshold = v;
    }
  }
  __syncthreads();
  const unsigned t = threshold;

  // ---- pass 2: the keys >= t, to the buffer ----
  const unsigned below = (1u << lane) - 1u;
  if (STAGE) {
    // a thread a 16-byte vector of the staged keys at a time; a key outside
    // its slot's group is 0 and passes only where t = 0
    const uint4* pv = reinterpret_cast<const uint4*>(plane);
    for (int q = tid; q < kp * kSlot / 4; q += kThreads) {
      const uint4 v = pv[q];
      const unsigned kq[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kq[i] < t) continue;
        const int slot = (4 * q + i) / kSlot, col = (4 * q + i) % kSlot - h;
        if (col < 0 || col >= kGroup) continue;
        const int at = atomicAdd(&count, 1);
        if (at < cap) cand[at] = pack(kq[i], slot * kGroup + col);
      }
    }
  } else {
    c.visit(kp, tid, h, [&](int slot, int v, const unsigned(&key)[V]) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int col = V * v + i - h;
        if (key[i] < t || col < 0 || col >= kGroup) continue;
        const int at = atomicAdd(&count, 1);
        if (at < cap) cand[at] = pack(key[i], slot * kGroup + col);
      }
    });
  }
  __syncthreads();
  int n_cand = count;

  if (n_cand > cap) {
    // ---- overflow: the exact k-th largest key by radix select ----
    auto key_at = [&](int pos) { return STAGE ? plane[pos / kGroup * kSlot + h + pos % kGroup] : c.key_at(pos); };
    unsigned prefix = 0u, known = 0u;
    int want = k;  // the want-th largest of the keys that match the prefix
    for (int shift = 24; shift >= 0; shift -= 8) {
      hist[tid] = 0u;
      __syncthreads();
      for (int pos = tid; pos < kc; pos += kThreads) {
        const unsigned key = key_at(pos);
        const bool in = (key & known) == prefix;
        const unsigned bin = (key >> shift) & 255u;
        // lanes with the same bin add once
        const unsigned peers = __match_any_sync(__activemask(), in ? bin : 256u);
        if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
      }
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
    // prefix is the k-th largest key; `want` of the keys equal to it belong
    // to the top-k, the lowest positions first. k <= cap: into the buffer;
    // past it straight to the output in no order, the flat position (kc +
    // position for a pad entry) in place of the item.
    const long long o = row * k;
    auto emit = [&](int slot, unsigned key, int pos) {
      if (k <= cap) {
        cand[slot] = pack(key, pos);
      } else {
        store_bits(out_v + o + slot, key ? from_key(key) : kNegInfBits);
        out_i[o + slot] = key ? pos : kc + pos;
      }
    };
    for (int pos = tid; pos < kc; pos += kThreads) {
      const unsigned key = key_at(pos);
      if (key > prefix) emit(atomicAdd(&count_above, 1), key, pos);
    }
    const int n_above = k - want;
    int taken = 0;
    for (int base = 0, it = 0; base < kc && taken < want; base += kThreads, ++it) {
      const int pos = base + tid;
      const bool tie = pos < kc && key_at(pos) == prefix;
      const unsigned votes = __ballot_sync(kFull, tie);
      if (lane == 0) warp_count[it & 1][warp] = __popc(votes);
      __syncthreads();
      int before = 0, total = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int cw = warp_count[it & 1][w];
        before += w < warp ? cw : 0;
        total += cw;
      }
      const int rank = taken + before + __popc(votes & below);
      if (tie && rank < want) emit(n_above + rank, prefix, pos);
      taken += total;
    }
    __syncthreads();
    if (k > cap) return;
    n_cand = k;
  }

  // ---- finish: a candidate's rank among the candidates is its place ----
  for (int i = tid; i < n_cand; i += kThreads) {
    const u64 w = cand[i];
    int rank = 0;
    for (int j = 0; j < n_cand; ++j) rank += cand[j] > w;
    if (rank < k) store_word(out_v, out_i, row * k + rank, w, groups);
  }
}

// The fold: block (row, segment) takes kFoldGroups groups of a row, read in
// 16-byte vectors from the first 16-byte boundary of the segment on (the
// unaligned first and last columns one a thread). With the row so cut, a
// warp's 32 consecutive vectors are 128 / V lanes a group, each lane's vector
// in its lane group's group but for its last V - 1 columns at most, which may
// lie in the next group; the lanes of a group reduce by shuffles, and the
// group's maximum goes to shared memory by one atomic max (two where a vector
// straddles). The maxima are written out coalesced at the end.
template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_group_max_kernel(const T* __restrict__ scores, const unsigned char* __restrict__ mask,
                        int mask_stride, float* __restrict__ out, int n, int n_groups) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kLanes = kGroup / V;  // lanes a group
  __shared__ unsigned gs[kFoldGroups];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long row = blockIdx.x;
  const int g0 = blockIdx.y * kFoldGroups;
  const int c0 = g0 * kGroup;
  const int len = min(n - c0, kFoldGroups * kGroup);
  const int ng = (len + kGroup - 1) / kGroup;
  const T* s = scores + row * n + c0;
  const unsigned char* m = mask ? mask + row * mask_stride : nullptr;
  for (int i = tid; i < ng; i += kThreads) gs[i] = to_key(kNegInfBits);
  __syncthreads();
  const unsigned addr = static_cast<unsigned>(reinterpret_cast<unsigned long long>(s));
  const int head = min(len, static_cast<int>(((16u - (addr & 15u)) & 15u) / sizeof(T)));
  const int n_vec = (len - head) / V;
  const int tail = head + n_vec * V;
  const uint4* vec = reinterpret_cast<const uint4*>(s + head);
  for (int base = 0; base < n_vec; base += kFoldAhead * kThreads) {
    uint4 raw[kFoldAhead];
    unsigned mb[kFoldAhead];
#pragma unroll
    for (int a = 0; a < kFoldAhead; ++a) {
      const int v = base + a * kThreads + tid;
      const int col = c0 + head + v * V;  // in the row
      raw[a] = v < n_vec ? __ldg(vec + v) : make_uint4(0u, 0u, 0u, 0u);
      mb[a] = 0u;
      if (v < n_vec && m) {
        mb[a] = __ldg(m + (col >> 3));
        if ((col & 7) + V > 8) mb[a] |= static_cast<unsigned>(__ldg(m + (col >> 3) + 1)) << 8;
        mb[a] >>= col & 7;
      }
    }
#pragma unroll
    for (int a = 0; a < kFoldAhead; ++a) {
      const int v = base + a * kThreads + tid;
      const int lc = head + v * V;  // in the segment
      const int ga = lc / kGroup;
      const int split = (ga + 1) * kGroup - lc;  // the vector's columns in group ga
      const unsigned w[4] = {raw[a].x, raw[a].y, raw[a].z, raw[a].w};
      unsigned ka = 0u, kb = 0u;  // this group's keys, the next group's
      if (v < n_vec) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const unsigned bits = V == 4 ? w[i] : (i & 1 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
          const unsigned key = to_key((mb[a] >> i) & 1u ? kNegInfBits : bits);
          if (i < split) ka = max(ka, key);
          else kb = max(kb, key);
        }
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) ka = max(ka, __shfl_xor_sync(kFull, ka, off));
      if (lane % kLanes == 0 && ka) atomicMax(gs + ga, ka);
      if (kb) atomicMax(gs + ga + 1, kb);
    }
  }
  // the unaligned ends
  for (int i = tid; i < head + len - tail; i += kThreads) {
    const int lc = i < head ? i : tail + i - head;
    const int col = c0 + lc;
    const bool excluded = m && ((__ldg(m + (col >> 3)) >> (col & 7)) & 1);
    atomicMax(gs + lc / kGroup, to_key(excluded ? kNegInfBits : load_bits(s + lc)));
  }
  __syncthreads();
  for (int i = tid; i < ng; i += kThreads) out[row * n_groups + g0 + i] = __uint_as_float(from_key(gs[i]));
}

template <typename T>
int candidate_extract(const void* scores, const void* gidx, const void* mask, int mask_stride,
                      void* out_v, void* out_i, int b, int n, int kp, int k, void* stream) {
  if (b <= 0) return 0;
  if (n < 1 || kp < 1 || kp > kMaxGroups || k < 1 || k > kp * kGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool stage = kp <= kStageGroups;
  constexpr int kSlot = (kGroup * static_cast<int>(sizeof(T)) / 16 + 1) * (16 / static_cast<int>(sizeof(T)));
  // a buffer twice k (at least 128 words, at most kCap): a row of scores
  // whose order is independent of their place passes a few more than k
  const int cap = min(kCap, max(128, 2 * k));
  const int smem = (2 + (stage ? kSlot : 0)) * kp * static_cast<int>(sizeof(unsigned)) +
                   cap * static_cast<int>(sizeof(u64));
  auto kernel = stage ? candidate_extract_kernel<T, true> : candidate_extract_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(scores), static_cast<const int*>(gidx),
      static_cast<const unsigned char*>(mask), mask_stride, static_cast<T*>(out_v),
      static_cast<long long*>(out_i), n, kp, k, cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int masked_group_max(const void* scores, const void* mask, int mask_stride, void* out, int b,
                     int n, void* stream) {
  if (b <= 0) return 0;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_groups = (n + kGroup - 1) / kGroup;
  const dim3 grid(b, (n_groups + kFoldGroups - 1) / kFoldGroups);
  masked_group_max_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(scores), static_cast<const unsigned char*>(mask), mask_stride,
      static_cast<float*>(out), n, n_groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scores: (b, n) float32; gidx: (b, kp) int32 group ids, kp <= 448; mask: null
// or (b, mask_stride) uint8 with mask_stride >= ceil(n / 8); out_v: (b, k)
// float32; out_i: (b, k) int64 item indices. For k > 512 a row's k entries
// come out in no order, with flat positions (kp * 128 + position for a pad
// entry) in out_i. Returns a cudaError_t (0 on success).
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

// scores: (b, n) float32; mask as above; out: (b, ceil(n / 128)) float32
// group maxima. Returns a cudaError_t (0 on success).
extern "C" int masked_group_max_f32(const void* scores, const void* mask, int mask_stride,
                                    void* out, int b, int n, void* stream) {
  return masked_group_max<float>(scores, mask, mask_stride, out, b, n, stream);
}

// The same over (b, n) bfloat16 scores; the maxima are float32.
extern "C" int masked_group_max_bf16(const void* scores, const void* mask, int mask_stride,
                                     void* out, int b, int n, void* stream) {
  return masked_group_max<bf16_bits>(scores, mask, mask_stride, out, b, n, stream);
}
