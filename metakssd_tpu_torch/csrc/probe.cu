// Probe kernels P1-P4 for Hopper (sm_90a), plain C interface.
//
// The TPU probes split the cost of the compact sketch kernel K1 into its
// read floor, its window math, its table search and its launch overhead
// (benchmarks/probe_kernel_cost.py, probe_r4.py, probe_floor_chunk.py,
// probe_floor_noread.py).  Each TPU probe kernel reduces one block of a
// [nb, rows, 128] tile tensor to one [128] row of int32 sums that wrap
// mod 2^32; four kernels here cover every variant:
//
//   mkssd_probe_floor    the floors: _floor_kernel (probe_kernel_cost.py:71),
//                        make_floor (probe_r4.py:73, probe_floor_chunk.py:32),
//                        k_noread / k_touch8 / k_sumall / k_xorfold
//                        (probe_floor_noread.py:55-67).  A row range, an op
//                        (sum, XOR, none = write the block index) and a
//                        tile type (i32, i8, u16).
//   mkssd_probe_winmath  the window math: _winmath_kernel
//                        (probe_kernel_cost.py:90), make_winmath
//                        (probe_r4.py:149, probe_floor_chunk.py:57).
//   mkssd_probe_gather   ng chained, dependent table lookups: make_gather and
//                        make_gather_1row (probe_r4.py:90,123).
//   mkssd_probe_search   window math + table search, no compaction:
//                        _search_kernel (probe_kernel_cost.py:136), exact
//                        (K1's lower bound) or signature form (7-level bucket
//                        descent + 16-bit signature test).
//
// Layout: element [b, r, l] of a tile tensor lies at (b*tile_rows + r)*128 +
// l; the window (b, r, l) reads rows r .. r+TL-1 of lane l.  The output is
// [nb, 128] int32 (the TPU's [nb, 1, 128]), zeroed by the caller.
//
// The TPU's grid walked the blocks in order on one core; here a block of
// 128 lanes x 4 row groups takes kPartRows rows of one tile block, and the
// parts of a tile block meet in its output row through one atomicAdd (or
// atomicXor) per lane.  Wrapping 32-bit addition and XOR are associative
// and commutative, so the result is exact whatever the order.  What bounds
// each kernel on this card: the floors and the window math move each tile
// byte once (bytes, 3.35 TB/s); the gather and the search are chains of
// dependent shared-memory loads, one per step and window (latency, which
// neither roofline bound sees).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kGroups = 4;                  // row groups per block
constexpr int kPartRows = 128;              // rows per block
constexpr int kRun = kPartRows / kGroups;   // contiguous windows per thread
constexpr int kMaxTL = 32;

enum Op { kSum = 0, kXor = 1, kNone = 2 };
enum Type { kI32 = 0, kI8 = 1, kU16 = 2 };

// A tile element as the TPU kernels read it: astype(int32) sign-extends
// int8 and zero-extends uint16.
template <typename T>
__device__ inline int32_t load(const T* p) {
  return static_cast<int32_t>(*p);
}

// Combines the kGroups partial results of each lane and adds (or XORs)
// them into the lane's output word.
template <int OP>
__device__ inline void block_reduce(uint32_t acc, uint32_t* out_row) {
  __shared__ uint32_t s[kGroups][kLanes];
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0) {
    uint32_t v = s[0][threadIdx.x];
    for (int g = 1; g < kGroups; ++g)
      v = OP == kXor ? (v ^ s[g][threadIdx.x]) : (v + s[g][threadIdx.x]);
    if (OP == kXor)
      atomicXor(out_row + threadIdx.x, v);
    else
      atomicAdd(out_row + threadIdx.x, v);
  }
}

// ---------------------------------------------------------------------------
// floor
// ---------------------------------------------------------------------------

template <typename T, int OP>
__global__ void __launch_bounds__(kLanes * kGroups)
floor_kernel(const T* __restrict__ tiles, int tile_rows, int row0, int row1,
             uint32_t* __restrict__ out) {
  const int b = blockIdx.x;
  const int lo = row0 + blockIdx.y * kPartRows;
  const int hi = min(lo + kPartRows, row1);
  const T* col = tiles + static_cast<size_t>(b) * tile_rows * kLanes +
                 threadIdx.x;
  uint32_t acc = 0;
  for (int r = lo + threadIdx.y; r < hi; r += kGroups) {
    const uint32_t v = static_cast<uint32_t>(
        load(col + static_cast<size_t>(r) * kLanes));
    acc = OP == kXor ? (acc ^ v) : (acc + v);
  }
  block_reduce<OP>(acc, out + static_cast<size_t>(b) * kLanes);
}

__global__ void block_index_kernel(uint32_t* __restrict__ out) {
  out[static_cast<size_t>(blockIdx.x) * kLanes + threadIdx.x] = blockIdx.x;
}

// ---------------------------------------------------------------------------
// window math
// ---------------------------------------------------------------------------

// 64-bit rolling tuples over one lane's rows, as csrc/sketch.cu rolls them:
// after TL pushes, fwd holds the TL codes first-row-highest and rc their
// reverse complement; equal to the TPU's (hi, lo) u32 pairs.
struct Roll {
  uint64_t fwd = 0, rc = 0, mask;
  int rc_shift;
  int last_bad = -1;            // last row whose code is >= 4
  __device__ explicit Roll(int TL)
      : mask(2 * TL >= 64 ? ~0ull : (1ull << (2 * TL)) - 1),
        rc_shift(2 * (TL - 1)) {}
  __device__ inline void push(int32_t c, int row) {
    const uint32_t code = static_cast<uint32_t>(c) & 3u;
    if (c >= 4) last_bad = row;
    fwd = ((fwd << 2) | code) & mask;
    rc = (rc >> 2) | (static_cast<uint64_t>(code ^ 3u) << rc_shift);
  }
  __device__ inline uint64_t uni() const { return fwd <= rc ? fwd : rc; }
};

// Calls f(window row, roll) for this thread's kRun consecutive windows of
// its part, in [0, nrows).
template <typename T, class F>
__device__ inline void for_each_window(const T* tiles, int tile_rows,
                                       int nrows, int TL, F f) {
  const int r0 = blockIdx.y * kPartRows + threadIdx.y * kRun;
  const int r1 = min(r0 + kRun, nrows);
  if (r0 >= r1) return;
  const T* col = tiles + static_cast<size_t>(blockIdx.x) * tile_rows * kLanes +
                 threadIdx.x;
  Roll roll(TL);
  for (int j = 0; j < TL - 1; ++j)
    roll.push(load(col + static_cast<size_t>(r0 + j) * kLanes), r0 + j);
  for (int r = r0; r < r1; ++r) {
    const int last = r + TL - 1;
    roll.push(load(col + static_cast<size_t>(last) * kLanes), last);
    f(r, roll);
  }
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kGroups)
winmath_kernel(const T* __restrict__ tiles, int tile_rows, int nrows, int TL,
               uint32_t* __restrict__ out) {
  uint32_t acc = 0;
  for_each_window(tiles, tile_rows, nrows, TL, [&](int r, const Roll& roll) {
    const uint64_t u = roll.uni();
    const uint32_t v = (static_cast<uint32_t>(u >> 32) ^
                        static_cast<uint32_t>(u)) |
                       (roll.last_bad >= r ? 1u : 0u);
    acc += v;
  });
  block_reduce<kSum>(acc, out + static_cast<size_t>(blockIdx.x) * kLanes);
}

// ---------------------------------------------------------------------------
// gather
// ---------------------------------------------------------------------------

// table_size is 4096 (the [32,128] table) or 128 (its first row); u16
// entries are zero-extended into the shared copy.
template <typename TT>
__global__ void __launch_bounds__(kLanes * kGroups)
gather_kernel(const int32_t* __restrict__ tiles, int tile_rows, int nrows,
              const TT* __restrict__ table, int table_size, int mult, int ng,
              uint32_t* __restrict__ out) {
  extern __shared__ uint32_t s_tab[];
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int i = tid; i < table_size; i += kLanes * kGroups)
    s_tab[i] = static_cast<uint32_t>(table[i]);
  __syncthreads();
  const uint32_t mask = static_cast<uint32_t>(table_size - 1);
  const int lo = blockIdx.y * kPartRows;
  const int hi = min(lo + kPartRows, nrows);
  const int32_t* col = tiles +
                       static_cast<size_t>(blockIdx.x) * tile_rows * kLanes +
                       threadIdx.x;
  uint32_t acc = 0;
  for (int r = lo + threadIdx.y; r < hi; r += kGroups) {
    uint32_t pos = ((static_cast<uint32_t>(col[static_cast<size_t>(r) * kLanes])
                     & 3u) * static_cast<uint32_t>(mult)) & mask;
    for (int g = 0; g < ng; ++g) {
      const uint32_t res = s_tab[pos];
      acc += res;
      pos = (pos + res) & mask;
    }
  }
  block_reduce<kSum>(acc, out + static_cast<size_t>(blockIdx.x) * kLanes);
}

// ---------------------------------------------------------------------------
// search
// ---------------------------------------------------------------------------

struct SearchParams {
  int TL;
  int dim_shift;                // 2 * outctx
  uint64_t dim_mask;            // low 4*subk bits
  int top_shift;                // 4k - 2*outctx
  uint64_t outer_mask;          // low 2*outctx bits
  int outer_bits;               // 2 * outctx
  int pf_bits;                  // 4 * (subk - drlevel)
};

// Index of the first entry >= x, in [0, n]: K1's search (csrc/sketch.cu).
__device__ inline int lower_bound(const uint32_t* a, int n, uint32_t x) {
  const uint32_t* base = a;
  int len = n;
  while (len > 1) {
    const int half = len >> 1;
    base = (base[half] < x) ? base + half : base;
    len -= half;
  }
  return static_cast<int>(base - a) + (*base < x ? 1 : 0);
}

// Shared memory: exact form, accept[n_accept]; signature form, the first 7
// BFS level rows [7][128] then the signature words [sig_words][128].
__global__ void __launch_bounds__(kLanes * kGroups)
search_kernel(const int32_t* __restrict__ tiles, int tile_rows, int nrows,
              SearchParams sp, const uint32_t* __restrict__ accept,
              int n_accept, const uint32_t* __restrict__ lev,
              const uint32_t* __restrict__ sig, int sig_words,
              uint32_t* __restrict__ out) {
  extern __shared__ uint32_t s_tab[];
  const bool use_sig = sig != nullptr;
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  if (use_sig) {
    for (int i = tid; i < 7 * kLanes; i += kLanes * kGroups) s_tab[i] = lev[i];
    for (int i = tid; i < sig_words * kLanes; i += kLanes * kGroups)
      s_tab[7 * kLanes + i] = sig[i];
  } else {
    for (int i = tid; i < n_accept; i += kLanes * kGroups)
      s_tab[i] = accept[i];
  }
  __syncthreads();
  const uint32_t* s_lev = s_tab;
  const uint32_t* s_sig = s_tab + 7 * kLanes;
  uint32_t acc = 0;
  for_each_window(tiles, tile_rows, nrows, sp.TL,
                  [&](int r, const Roll& roll) {
    const uint64_t u = roll.uni();
    const uint32_t dim = static_cast<uint32_t>((u >> sp.dim_shift) &
                                               sp.dim_mask);
    uint32_t pos = 0;
    bool hit = false;
    if (use_sig) {
      for (int d = 0; d < 7; ++d)
        pos = 2 * pos + (s_lev[d * kLanes + pos] < dim ? 1u : 0u);
      const uint32_t dsig = dim & 0xFFFFu;
      for (int w = 0; w < sig_words; ++w) {
        const uint32_t word = s_sig[w * kLanes + pos];
        hit = hit || (word & 0xFFFFu) == dsig || (word >> 16) == dsig;
      }
    } else {
      const int p = lower_bound(s_tab, n_accept, dim);
      hit = p < n_accept && s_tab[p] == dim;
      pos = static_cast<uint32_t>(p);
    }
    const uint64_t top = (u >> sp.top_shift) & sp.outer_mask;
    const uint64_t right = u & sp.outer_mask;
    const uint32_t base = static_cast<uint32_t>(
        ((top << sp.outer_bits) | right) << sp.pf_bits);
    if (hit && roll.last_bad < r) acc += base | pos;
  });
  block_reduce<kSum>(acc, out + static_cast<size_t>(blockIdx.x) * kLanes);
}

inline dim3 parts_grid(int nb, int nrows) {
  return dim3(static_cast<unsigned>(nb),
              static_cast<unsigned>((nrows + kPartRows - 1) / kPartRows));
}

const dim3 kBlock(kLanes, kGroups);

template <typename T>
cudaError_t launch_floor(const void* tiles, int nb, int tile_rows, int row0,
                         int row1, int op, uint32_t* out, cudaStream_t s) {
  const dim3 grid = parts_grid(nb, row1 - row0);
  const T* t = static_cast<const T*>(tiles);
  if (op == kXor)
    floor_kernel<T, kXor><<<grid, kBlock, 0, s>>>(t, tile_rows, row0, row1,
                                                  out);
  else
    floor_kernel<T, kSum><<<grid, kBlock, 0, s>>>(t, tile_rows, row0, row1,
                                                  out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_winmath(const void* tiles, int nb, int tile_rows,
                           int nrows, int TL, uint32_t* out, cudaStream_t s) {
  winmath_kernel<T><<<parts_grid(nb, nrows), kBlock, 0, s>>>(
      static_cast<const T*>(tiles), tile_rows, nrows, TL, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every function returns 0 or the cudaError_t of the launch.  `out` is a
// zeroed [nb, 128] int32 buffer.

// Rows [row0, row1) of every tile block, summed (op 0) or XORed (op 1);
// op 2 writes each block's index without reading the tiles.  dtype: 0
// int32, 1 int8, 2 uint16.
int mkssd_probe_floor(const void* tiles, int dtype, int nb, int tile_rows,
                      int row0, int row1, int op, void* out, void* stream) {
  if (nb < 1 || row0 < 0 || row1 <= row0 || row1 > tile_rows || op < 0 ||
      op > kNone || dtype < kI32 || dtype > kU16)
    return cudaErrorInvalidValue;
  uint32_t* o = static_cast<uint32_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == kNone) {
    block_index_kernel<<<nb, kLanes, 0, s>>>(o);
    return cudaGetLastError();
  }
  if (dtype == kI8)
    return launch_floor<int8_t>(tiles, nb, tile_rows, row0, row1, op, o, s);
  if (dtype == kU16)
    return launch_floor<uint16_t>(tiles, nb, tile_rows, row0, row1, op, o, s);
  return launch_floor<int32_t>(tiles, nb, tile_rows, row0, row1, op, o, s);
}

// The sum over the first nrows window rows of (uni_hi ^ uni_lo) | invalid,
// for TL-base windows; needs nrows + TL - 1 <= tile_rows.  dtype: 0 int32,
// 1 int8.
int mkssd_probe_winmath(const void* tiles, int dtype, int nb, int tile_rows,
                        int nrows, int TL, void* out, void* stream) {
  if (nb < 1 || nrows < 1 || TL < 1 || TL > kMaxTL ||
      nrows + TL - 1 > tile_rows || (dtype != kI32 && dtype != kI8))
    return cudaErrorInvalidValue;
  uint32_t* o = static_cast<uint32_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kI8)
    return launch_winmath<int8_t>(tiles, nb, tile_rows, nrows, TL, o, s);
  return launch_winmath<int32_t>(tiles, nb, tile_rows, nrows, TL, o, s);
}

// ng chained lookups pos = (pos + table[pos]) & (table_size - 1) from
// pos = ((tile & 3) * mult) & (table_size - 1), summed over every step and
// the first nrows rows of int32 tiles.  table_dtype: 0 uint32, 2 uint16.
int mkssd_probe_gather(const void* tiles, int nb, int tile_rows, int nrows,
                       const void* table, int table_dtype, int table_size,
                       int mult, int ng, void* out, void* stream) {
  if (nb < 1 || nrows < 1 || nrows > tile_rows || ng < 0 || table_size < 1 ||
      (table_size & (table_size - 1)) != 0 || table_size > 4096 ||
      (table_dtype != kI32 && table_dtype != kU16))
    return cudaErrorInvalidValue;
  const dim3 grid = parts_grid(nb, nrows);
  const size_t smem = static_cast<size_t>(table_size) * sizeof(uint32_t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* t = static_cast<const int32_t*>(tiles);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (table_dtype == kU16)
    gather_kernel<uint16_t><<<grid, kBlock, smem, s>>>(
        t, tile_rows, nrows, static_cast<const uint16_t*>(table), table_size,
        mult, ng, o);
  else
    gather_kernel<uint32_t><<<grid, kBlock, smem, s>>>(
        t, tile_rows, nrows, static_cast<const uint32_t*>(table), table_size,
        mult, ng, o);
  return cudaGetLastError();
}

// The sum over the first nrows window rows of base | pos where the window
// is kept.  sig == NULL: the exact form, pos = the lower bound of dim in
// accept[n_accept] and a hit where it is equal.  Otherwise the signature
// form: pos = the 7-level bucket index through lev's first 7 rows [7][128]
// and a hit where a 16-bit half of one of sig[sig_words][128]'s words at
// lane pos equals dim's low 16 bits.  Tables hold u32 bits.
int mkssd_probe_search(const void* tiles, int nb, int tile_rows, int nrows,
                       int k, int subk, int drlevel, const void* accept,
                       int n_accept, const void* lev, const void* sig,
                       int sig_words, void* out, void* stream) {
  const int TL = 2 * k;
  const int outctx = k - subk;
  if (nb < 1 || nrows < 1 || TL > kMaxTL || outctx < 0 || drlevel > subk ||
      4 * subk > 32 || nrows + TL - 1 > tile_rows)
    return cudaErrorInvalidValue;
  if (sig == nullptr ? (n_accept < 1 || accept == nullptr)
                     : (lev == nullptr || sig_words < 0))
    return cudaErrorInvalidValue;
  SearchParams sp;
  sp.TL = TL;
  sp.dim_shift = 2 * outctx;
  sp.dim_mask = (1ull << (4 * subk)) - 1;
  sp.top_shift = 4 * k - 2 * outctx;
  sp.outer_bits = 2 * outctx;
  sp.outer_mask = (1ull << (2 * outctx)) - 1;
  sp.pf_bits = 4 * (subk - drlevel);
  const size_t words = sig == nullptr
                           ? static_cast<size_t>(n_accept)
                           : static_cast<size_t>(7 + sig_words) * kLanes;
  const size_t smem = words * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  search_kernel<<<parts_grid(nb, nrows), kBlock, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tiles), tile_rows, nrows, sp,
      static_cast<const uint32_t*>(accept), n_accept,
      static_cast<const uint32_t*>(lev), static_cast<const uint32_t*>(sig),
      sig_words, static_cast<uint32_t*>(out));
  return cudaGetLastError();
}

}  // extern "C"
