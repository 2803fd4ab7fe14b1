// K3, sorted-set membership for Hopper (sm_90a), plain C interface.
//
// mkssd_member replaces metakssd_tpu/ops/merge_device.py _member_kernel
// (launched by _member_pallas).  For every needle x it returns
//     member[i] = 1 if x occurs in the sorted haystack, else 0;
//     value[i]  = the hit's position (identity mode, values == NULL) or
//                 values[position], and 0 for a miss,
// where position is the lower bound of x (the first equal entry), exactly
// the host fallback of metakssd_tpu/ops/merge.py (np.searchsorted, then
// a compare).  Keys compare as uint32_t, so keys >= 2^31 order as they do
// on the host, and 0xFFFFFFFF is a member when the haystack holds it (the
// Pallas kernel reserves it as padding; the fallback does not).  Needles
// may come in any order.
//
// The search index, built once per haystack by mkssd_member_index: a
// table of nb + 1 lower bounds, table[b] = the lower bound of b << shift
// and table[nb] = nh, where nb is a power of two and shift is taken from
// the haystack's largest key, so that bucket b = x >> shift covers the
// keys whose top bits are b and the lower bound of x lies in
// [table[b], table[b + 1]].  K3's own rule (merge.index_shape) takes the
// most buckets with nb + 1 <= nh / 8, so the table takes at most 1/8 of
// the haystack's bytes (nb == 0, below 16 keys: no table, one bucket).  A
// caller may name any power of two with nb + 1 <= nh (valid_index): the
// probe's exact search (probe.cu) takes the densest, 2049 entries for 4096
// keys, half the haystack's bytes.  A skewed haystack leaves some buckets
// large; the search inside a bucket is a binary search, so such a bucket
// costs log2 of its size.
//
// Design for this card.  The TPU layout is not carried over: no [R,128]
// lane tiles, no 2W window, no host anchor pass and no serial range
// search.  A block takes kNeedles consecutive needles and every thread
// starts on its own four.  A warp reduction gives the block's min and max,
// and two table loads (one address for the whole block) give the haystack
// range that can hold any of them.
//   * A range of at most kWindow entries (a sorted, dense block) is copied
//     to shared memory with cp.async, all copies in flight at once, with
//     the table entries of its buckets where they are at most kSlice; a
//     needle then searches its own bucket there (about 6 shared loads),
//     or the whole range where the slice did not fit.
//   * Otherwise each needle reads its bucket's bounds from the table (1/8
//     of the haystack, so it stays in the 50 MB L2 for haystacks up to
//     100M keys); a bucket of more than kGroup entries is narrowed by
//     halving steps (a skewed haystack); then each half-warp takes its 16
//     lanes' needles one after another: the 16 lanes load the bucket
//     (uniform keys give 8-16 entries, one or two 32-byte sectors) in one
//     contiguous load, and two ballots count the keys below the needle
//     and find one equal to it.  Four needles a lane are in flight, and a
//     needle costs one or two L1 wavefronts where a search by one thread
//     costs one a step.
// What bounds the kernel: the sector rate and the L1 wavefronts of the
// random bucket loads for sparse needles (dist search, set -s/-i), and
// shared-memory steps for a staged block.

#include <algorithm>
#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kNeedles = kThreads * kPerThread;   // needles per block
constexpr int kWindow = 6144;                     // staged haystack entries
constexpr int kSlice = 1024;                      // staged table entries
constexpr unsigned kGroup = 16;                   // lanes that scan a bucket
constexpr int kWarps = kThreads / 32;

struct Index {
  const uint32_t* table;   // nb + 1 lower bounds; unused when nb == 0
  unsigned long long nb;   // buckets: 0 or a power of two
  int shift;               // bucket of x: x >> shift, 0 <= shift <= 32
  uint32_t nh;
};

// [lo, hi): the entries of x's bucket; x's lower bound lies in [lo, hi].
__device__ inline void bucket_of(const Index& ix, uint32_t x, uint32_t& lo,
                                 uint32_t& hi) {
  if (ix.nb == 0) {
    lo = 0;
    hi = ix.nh;
    return;
  }
  const unsigned long long b = static_cast<unsigned long long>(x) >> ix.shift;
  if (b >= ix.nb) {            // x is above every key
    lo = hi = ix.nh;
    return;
  }
  lo = __ldg(ix.table + b);
  hi = __ldg(ix.table + b + 1);
}

// One step of the lower-bound search of x in a[b, b + len): the answer
// lies in [b, b + len], and ku holds a[b + len] wherever that entry was
// read (a key >= x).  Ends at len == 0 with the answer in b.
__device__ inline void step(const uint32_t* a, uint32_t x, uint32_t& b,
                            uint32_t& len, uint32_t& ku) {
  const uint32_t half = len >> 1;
  const uint32_t m = b + half;
  const uint32_t key = a[m];
  const bool lt = key < x;
  b = lt ? m + 1 : b;
  len = lt ? len - half - 1 : half;
  ku = lt ? ku : key;
}

// The searches of a thread's needles in lockstep over a (device or shared
// memory); b and len start at each needle's range, and the steps go on
// while a range holds more than limit entries.  With limit 0, on return b
// holds the lower bound (relative to a) and ku == x marks a hit: the
// entry there was read, or the range ended at an entry > x, which
// ku = ~x stands for.
__device__ inline void search(const uint32_t* a, const uint32_t (&x)[kPerThread],
                              uint32_t (&b)[kPerThread],
                              uint32_t (&len)[kPerThread],
                              uint32_t (&ku)[kPerThread], uint32_t limit) {
  bool more = true;
  while (more) {
    more = false;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (len[k] > limit) {
        step(a, x[k], b[k], len[k], ku[k]);
        more = true;
      }
    }
  }
}

__device__ inline void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__global__ void __launch_bounds__(kThreads)
index_kernel(const uint32_t* __restrict__ hay, uint32_t nh, int shift,
             unsigned long long nb, uint32_t* __restrict__ table) {
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long b =
           static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
           threadIdx.x;
       b <= nb; b += stride) {
    if (b == nb) {
      table[b] = nh;
      continue;
    }
    // b < nb: b << shift < 2^32 (shift leaves the largest key's top bits)
    const uint32_t x = static_cast<uint32_t>(b << shift);
    uint32_t lo = 0, len = nh, ku = ~x;
    while (len > 0) step(hay, x, lo, len, ku);
    table[b] = lo;
  }
}

__global__ void __launch_bounds__(kThreads)
member_kernel(const uint32_t* __restrict__ hay, Index ix,
              const uint32_t* __restrict__ values,
              const uint32_t* __restrict__ needles, long long nn,
              int32_t* __restrict__ out_member,
              uint32_t* __restrict__ out_value) {
  extern __shared__ __align__(16) uint32_t smem[];  // table | hay | values
  __shared__ uint32_t s_min[kWarps], s_max[kWarps];
  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * kNeedles;

  uint32_t x[kPerThread], b[kPerThread], len[kPerThread], ku[kPerThread];
  bool ok[kPerThread];
  uint32_t mn = 0xFFFFFFFFu, mx = 0u;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = first + k * kThreads + tid;
    ok[k] = i < nn;
    x[k] = ok[k] ? needles[i] : 0u;
    if (ok[k]) {
      mn = min(mn, x[k]);
      mx = max(mx, x[k]);
    }
  }
  mn = __reduce_min_sync(0xffffffffu, mn);
  mx = __reduce_max_sync(0xffffffffu, mx);
  if ((tid & 31) == 0) {
    s_min[tid >> 5] = mn;
    s_max[tid >> 5] = mx;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    mn = min(mn, s_min[w]);
    mx = max(mx, s_max[w]);
  }
  // every block holds at least one needle, so mn <= mx and lo <= hi; no
  // entry before lo is >= mn, and none from hi on is <= mx
  uint32_t lo, hi, unused;
  bucket_of(ix, mn, lo, unused);
  bucket_of(ix, mx, unused, hi);
  const uint32_t span = hi - lo;

  if (span <= static_cast<uint32_t>(kWindow)) {     // the same in the block
    // the table entries of the block's buckets b0..b1 + 1, where they are
    // few: a needle then searches its bucket, not the whole range
    const unsigned long long b0 = static_cast<unsigned long long>(mn) >>
                                  ix.shift;
    const unsigned long long b1 = min(
        static_cast<unsigned long long>(mx) >> ix.shift, ix.nb - 1);
    const bool sliced = ix.nb != 0 && b0 < ix.nb && b1 - b0 + 2 <= kSlice;
    uint32_t* s_tab = smem;
    uint32_t* s_hay = smem + kSlice;
    uint32_t* s_val = s_hay + kWindow;
    if (sliced) {
      for (uint32_t i = tid; i < b1 - b0 + 2; i += kThreads)
        cp_async4(s_tab + i, ix.table + b0 + i);
    }
    for (uint32_t i = tid; i < span; i += kThreads) {
      cp_async4(s_hay + i, hay + lo + i);
      if (values != nullptr) cp_async4(s_val + i, values + lo + i);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      b[k] = 0;
      len[k] = ok[k] ? span : 0u;
      ku[k] = ~x[k];
      if (ok[k] && sliced) {
        const unsigned long long bk =
            static_cast<unsigned long long>(x[k]) >> ix.shift;
        if (bk >= ix.nb) {               // above every key: the range end
          b[k] = span;
          len[k] = 0;
        } else {
          b[k] = s_tab[bk - b0] - lo;
          len[k] = s_tab[bk - b0 + 1] - lo - b[k];
        }
      }
    }
    search(s_hay, x, b, len, ku, 0);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (!ok[k]) continue;
      const long long i = first + k * kThreads + tid;
      const bool hit = ku[k] == x[k];
      out_member[i] = hit ? 1 : 0;
      out_value[i] = !hit ? 0u
                     : values != nullptr ? s_val[b[k]] : lo + b[k];
    }
    return;
  }

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    uint32_t bhi = 0;
    b[k] = 0;
    if (ok[k]) bucket_of(ix, x[k], b[k], bhi);
    len[k] = bhi - b[k];
    ku[k] = ~x[k];
  }
  // a bucket of more than kGroup entries (a skewed haystack) is first
  // narrowed by halving steps; then each half-warp takes the needles of
  // its 16 lanes one after another: one contiguous load of the range,
  // a ballot of the keys below the needle and one of those equal to it
  search(hay, x, b, len, ku, kGroup);
  const unsigned sub = tid & (kGroup - 1);
  const unsigned half = tid & kGroup;
  bool hit[kPerThread] = {};
#pragma unroll 2
  for (unsigned s = 0; s < kGroup; ++s) {
    const unsigned src = half | s;
    uint32_t key[kPerThread], xs[kPerThread], ls[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      xs[k] = __shfl_sync(0xffffffffu, x[k], src);
      ls[k] = __shfl_sync(0xffffffffu, len[k], src);
      const uint32_t bs = __shfl_sync(0xffffffffu, b[k], src);
      key[k] = sub < ls[k] ? hay[bs + sub] : 0u;
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const unsigned lt = __ballot_sync(0xffffffffu,
                                        sub < ls[k] && key[k] < xs[k]) >> half;
      const unsigned eq = __ballot_sync(0xffffffffu,
                                        sub < ls[k] && key[k] == xs[k]) >> half;
      if (sub == s) {
        const uint32_t n = __popc(lt & 0xFFFFu);
        hit[k] = (eq & 0xFFFFu) != 0 || (n == len[k] && ku[k] == x[k]);
        b[k] += n;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (!ok[k]) continue;
    const long long i = first + k * kThreads + tid;
    out_member[i] = hit[k] ? 1 : 0;
    out_value[i] = !hit[k] ? 0u : values != nullptr ? values[b[k]] : b[k];
  }
}

bool valid_index(long long nh, const void* table, long long nb, int shift) {
  if (nh < 0 || nh > 0xFFFFFFFFll || shift < 0 || shift > 32) return false;
  if (nb == 0) return true;
  return table != nullptr && nb > 0 && (nb & (nb - 1)) == 0 && nb + 1 <= nh;
}

}  // namespace

extern "C" {

// The search index of a sorted haystack: table (u32, nb + 1 entries) as
// described above.  Returns 0 or the cudaError_t of the launch.
int mkssd_member_index(const void* hay, long long nh, long long nb,
                       int shift, void* table, void* stream) {
  if (nb <= 0 || !valid_index(nh, table, nb, shift))
    return cudaErrorInvalidValue;
  const long long blocks =
      std::min<long long>((nb + kThreads) / kThreads, 132LL * 16);
  index_kernel<<<static_cast<int>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hay), static_cast<uint32_t>(nh), shift,
      static_cast<unsigned long long>(nb), static_cast<uint32_t*>(table));
  return cudaGetLastError();
}

// Returns 0 or the cudaError_t of the launch.  hay holds nh sorted u32
// keys (NULL when nh == 0); table, nb and shift are its index from
// mkssd_member_index (nb == 0: no table); values is NULL (identity) or nh
// u32; the caller sizes out_member (int32) and out_value (u32) to nn >= 1.
int mkssd_member(const void* hay, long long nh, const void* table,
                 long long nb, int shift, const void* values,
                 const void* needles, long long nn, void* out_member,
                 void* out_value, void* stream) {
  if (nn <= 0 || !valid_index(nh, table, nb, shift))
    return cudaErrorInvalidValue;
  const long long nblocks = (nn + kNeedles - 1) / kNeedles;
  if (nblocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) *
      (kSlice + static_cast<size_t>(kWindow) * (values != nullptr ? 2 : 1));
  cudaError_t err = cudaFuncSetAttribute(
      member_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const Index ix{static_cast<const uint32_t*>(table),
                 static_cast<unsigned long long>(nb), shift,
                 static_cast<uint32_t>(nh)};
  member_kernel<<<static_cast<int>(nblocks), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hay), ix,
      static_cast<const uint32_t*>(values),
      static_cast<const uint32_t*>(needles), nn,
      static_cast<int32_t*>(out_member), static_cast<uint32_t*>(out_value));
  return cudaGetLastError();
}

}  // extern "C"
