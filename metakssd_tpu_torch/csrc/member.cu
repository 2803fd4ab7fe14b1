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
// Pallas kernel reserves it as padding; the fallback does not).
//
// The TPU layout is not carried over: no [R,128] lane tiles, no row-select
// gathers, no host anchor pass and no host rerun of spilled blocks.  Each
// block takes kNeedles consecutive needles (a sorted query gives it a
// narrow key range), reduces their min and max, and finds the haystack
// range [lo, hi) that can hold any of them with two binary searches in
// device memory.  A range of at most kWindow entries is staged in shared
// memory with coalesced loads (and its values, in values mode), and each
// thread runs a branchless lower bound there; a wider range (a query
// sparse against a large haystack, as in dist search, or a dense cluster)
// is searched in device memory inside the same kernel.  The kernel is
// bound by the latency of those dependent loads, not by bytes: a staged
// block reads (1 or 2) x 4 x span bytes once, then ceil(log2 span) shared
// loads per needle; a wide block pays ceil(log2 span) dependent loads from
// L2 or HBM per needle.  Needles need not be sorted for a right answer
// (min/max bound the range whatever the order), only for a narrow one.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kNeedles = kThreads * kPerThread;   // needles per block
constexpr int kWindow = 8192;                     // staged haystack entries
constexpr int kWarps = kThreads / 32;

// First index i in [0, n) with a[i] >= x (kUpper: a[i] > x), or n.  The
// loop count depends on n only, so the lanes of a warp step together.
template <bool kUpper, class I>
__device__ inline I bound(const uint32_t* a, I n, uint32_t x) {
  if (n == 0) return 0;
  const uint32_t* base = a;
  I len = n;
  while (len > 1) {
    const I half = len >> 1;
    const bool right = kUpper ? base[half] <= x : base[half] < x;
    base = right ? base + half : base;
    len -= half;
  }
  const bool past = kUpper ? *base <= x : *base < x;
  return static_cast<I>(base - a) + (past ? 1 : 0);
}

__global__ void __launch_bounds__(kThreads)
member_kernel(const uint32_t* __restrict__ hay, long long nh,
              const uint32_t* __restrict__ values,
              const uint32_t* __restrict__ needles, long long nn,
              int32_t* __restrict__ out_member,
              uint32_t* __restrict__ out_value) {
  extern __shared__ __align__(16) uint32_t smem[];  // hay | values
  __shared__ uint32_t s_min[kWarps], s_max[kWarps];
  __shared__ long long s_lo, s_hi;
  const int tid = threadIdx.x;
  const unsigned lane = tid & 31u;
  const long long first = static_cast<long long>(blockIdx.x) * kNeedles;

  uint32_t x[kPerThread];
  uint32_t mn = 0xFFFFFFFFu, mx = 0u;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = first + k * kThreads + tid;
    x[k] = i < nn ? needles[i] : 0u;
    if (i < nn) {
      mn = min(mn, x[k]);
      mx = max(mx, x[k]);
    }
  }
  mn = __reduce_min_sync(0xffffffffu, mn);
  mx = __reduce_max_sync(0xffffffffu, mx);
  if (lane == 0) {
    s_min[tid >> 5] = mn;
    s_max[tid >> 5] = mx;
  }
  __syncthreads();
  // every block holds at least one needle, so mn <= mx and lo <= hi
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) mn = min(mn, s_min[w]);
    s_lo = bound<false>(hay, nh, mn);
  } else if (tid == 32) {
    for (int w = 0; w < kWarps; ++w) mx = max(mx, s_max[w]);
    s_hi = bound<true>(hay, nh, mx);
  }
  __syncthreads();
  const long long lo = s_lo;
  const long long span = s_hi - lo;
  const bool staged = span <= kWindow;
  uint32_t* s_hay = smem;
  uint32_t* s_val = smem + kWindow;
  if (staged) {
    for (int i = tid; i < span; i += kThreads) {
      s_hay[i] = hay[lo + i];
      if (values != nullptr) s_val[i] = values[lo + i];
    }
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = first + k * kThreads + tid;
    if (i >= nn) continue;
    bool hit;
    long long pos;
    uint32_t v = 0u;
    if (staged) {
      const int q = bound<false>(s_hay, static_cast<int>(span), x[k]);
      hit = q < span && s_hay[q] == x[k];
      pos = lo + q;
      if (hit) v = values != nullptr ? s_val[q] : static_cast<uint32_t>(pos);
    } else {
      pos = lo + bound<false>(hay + lo, span, x[k]);
      hit = pos < lo + span && hay[pos] == x[k];
      if (hit)
        v = values != nullptr ? values[pos] : static_cast<uint32_t>(pos);
    }
    out_member[i] = hit ? 1 : 0;
    out_value[i] = v;
  }
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch.  hay holds nh sorted u32
// keys (NULL when nh == 0); values is NULL (identity) or nh u32; the
// caller sizes out_member (int32) and out_value (u32) to nn >= 1.
int mkssd_member(const void* hay, long long nh, const void* values,
                 const void* needles, long long nn, void* out_member,
                 void* out_value, void* stream) {
  if (nn <= 0 || nh < 0 || nh > 0xFFFFFFFFll) return cudaErrorInvalidValue;
  const long long nblocks = (nn + kNeedles - 1) / kNeedles;
  if (nblocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kWindow) * sizeof(uint32_t) *
                      (values != nullptr ? 2 : 1);
  cudaError_t err = cudaFuncSetAttribute(
      member_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  member_kernel<<<static_cast<int>(nblocks), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hay), nh,
      static_cast<const uint32_t*>(values),
      static_cast<const uint32_t*>(needles), nn,
      static_cast<int32_t*>(out_member), static_cast<uint32_t*>(out_value));
  return cudaGetLastError();
}

}  // extern "C"
