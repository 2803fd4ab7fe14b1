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
//                        form (the lower bound of dim in the accept table,
//                        through a bucket index: below) or signature form
//                        (7-level bucket descent + 16-bit signature test).
//
// Layout: element [b, r, l] of a tile tensor lies at (b*tile_rows + r)*128 +
// l; the window (b, r, l) reads rows r .. r+TL-1 of lane l.  The output is
// [nb, 128] int32 (the TPU's [nb, 1, 128]).
//
// The TPU's grid walked the blocks in order on one core; here a block of
// 128 lanes x 4 row groups takes an equal share of the rows of one tile
// block (tile block blockIdx.x, share blockIdx.y of gridDim.y).  The
// blocks of a tile block meet in its output row in one of two ways, the
// caller's choice:
//
//   atomic  (tickets == NULL) one share per kPartRows rows; each block adds
//           (or XORs) its row into the output row with one atomic per lane,
//           so the caller zeroes the output first: two launches.
//   ticket  (tickets != NULL) as many shares as end the launch soonest on
//           the card's block slots (the kernel's occupancy times the SMs),
//           at most one per kPartRows rows: few blocks, long ones.  Each
//           writes its row of the scratch buffer `partial` [nb, shares,
//           128], and the last block of the tile block to finish (a ticket
//           counter per tile block, reset by that block) combines the rows
//           into the output row, which nothing zeroes: one launch.  Taking
//           the ticket (a fence, then an atomic whose result the block
//           waits for) costs a block about a microsecond at its end.
//
// A tile block with one share writes its output row in either way.  The
// ticket counters are the caller's [>= nb] uint32, zero before the first
// launch and left zero by every launch; two launches that run at the same
// time must not share them (the wrapper keeps a buffer per stream).
// Wrapping 32-bit addition and XOR are associative and commutative, so the
// result is exact whatever the order.  What bounds each kernel on this
// card: the floors and the window math move each tile byte once (bytes,
// 3.35 TB/s); the gather and the signature search are chains of dependent
// shared-memory loads, one per step and window (latency, which neither
// roofline bound sees).
//
// The exact search.  The TPU kernel and K1 before its filter ran a
// branchless binary search of the whole sorted accept table for every
// window: 12 dependent shared-memory loads for 4096 entries, a chain that
// held the kernel at 12% of its operations bound.  Here the block stages
// the accept table and K3's search index of it (ops/merge.MemberIndex,
// built once per table by mkssd_member_index in member.cu: idx[b] = the
// lower bound of b << shift, idx[nb] = n) in shared memory.  A window's
// dim picks its bucket b = dim >> shift; two independent loads give the
// bucket's range [idx[b], idx[b + 1]), in which the lower bound of dim
// lies, and K3's search step halves that range only, its last key read
// at or above dim deciding the hit (no load after the search): at nb =
// 2048 buckets over 4096 keys (the densest index K3's kernel takes, nb +
// 1 <= n) a bucket holds about 2 keys, so one or two steps.  An empty
// bucket gives its start without a read; b >= nb gives n (dim lies above
// every key); nb = 0 searches the whole table.  The function's least
// work is the window math plus one table step a window
// (probes/_common.search_ops(1)), which bounds it by operations; what
// the kernel spends above it is the index's two loads, the steps past
// the first, and the bank conflicts of random shared-memory reads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kGroups = 4;                  // row groups per block
constexpr int kPartRows = 128;              // rows per block, at least
constexpr int kMaxTL = 32;
constexpr int kMaxShares = 65535;           // shares of a tile block: y

enum Op { kSum = 0, kXor = 1, kNone = 2 };
enum Type { kI32 = 0, kI8 = 1, kU16 = 2 };

// A tile element as the TPU kernels read it: astype(int32) sign-extends
// int8 and zero-extends uint16.
template <typename T>
__device__ inline int32_t load(const T* p) {
  return static_cast<int32_t>(*p);
}

template <int OP>
__device__ inline uint32_t combine(uint32_t a, uint32_t b) {
  return OP == kXor ? (a ^ b) : (a + b);
}

// Rows [lo, hi) of [0, n) that this block takes: share blockIdx.y of
// gridDim.y, the shares' sizes at most one row apart.  32-bit arithmetic:
// a 64-bit division is a long software routine, paid by every thread.
__device__ inline void block_rows(int n, int& lo, int& hi) {
  const int g = static_cast<int>(gridDim.y);
  const int y = static_cast<int>(blockIdx.y);
  const int q = n / g, r = n % g;
  lo = y * q + min(y, r);
  hi = lo + q + (y < r ? 1 : 0);
}

// Combines the kGroups partial results of each lane, then the blocks of
// the tile block (blockIdx.x): with one block (gridDim.y == 1) it writes
// the lane's output word; otherwise, without tickets, it adds (or XORs)
// it into the zeroed output word; with tickets it writes its row of
// `partial` [nb, gridDim.y, 128], and the last block to take a ticket
// combines the rows into the output row.
template <int OP>
__device__ inline void block_reduce(uint32_t acc, uint32_t* __restrict__ out,
                                    uint32_t* partial, unsigned* tickets) {
  __shared__ uint32_t s[kGroups][kLanes];
  __shared__ bool last;
  const int b = blockIdx.x;
  const int blocks = gridDim.y;
  uint32_t* o = out + static_cast<size_t>(b) * kLanes + threadIdx.x;
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0) {
    uint32_t v = s[0][threadIdx.x];
    for (int g = 1; g < kGroups; ++g) v = combine<OP>(v, s[g][threadIdx.x]);
    if (blocks == 1) {
      *o = v;
    } else if (tickets == nullptr) {
      if (OP == kXor)
        atomicXor(o, v);
      else
        atomicAdd(o, v);
    } else {
      partial[(static_cast<size_t>(b) * blocks + blockIdx.y) * kLanes +
              threadIdx.x] = v;
      __threadfence();          // the row is visible before the ticket
    }
  }
  if (blocks == 1 || tickets == nullptr) return;   // uniform over the grid
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0)
    last = atomicAdd(&tickets[b], 1u) == static_cast<unsigned>(blocks - 1);
  __syncthreads();
  if (!last) return;             // uniform over the block
  __threadfence();
  // __ldcg: the other blocks' rows come from L2, never a stale L1 line; 0
  // is the identity of both + and ^
  const uint32_t* rows =
      partial + static_cast<size_t>(b) * blocks * kLanes + threadIdx.x;
  uint32_t v = 0;
  for (int q = threadIdx.y; q < blocks; q += kGroups)
    v = combine<OP>(v, __ldcg(rows + static_cast<size_t>(q) * kLanes));
  s[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y != 0) return;
  v = s[0][threadIdx.x];
  for (int g = 1; g < kGroups; ++g) v = combine<OP>(v, s[g][threadIdx.x]);
  *o = v;
  if (threadIdx.x == 0) tickets[b] = 0;
}

// ---------------------------------------------------------------------------
// floor
// ---------------------------------------------------------------------------

template <typename T, int OP>
__global__ void __launch_bounds__(kLanes * kGroups)
floor_kernel(const T* __restrict__ tiles, int tile_rows, int row0, int row1,
             uint32_t* __restrict__ out, uint32_t* partial,
             unsigned* tickets) {
  const int b = blockIdx.x;
  int lo, hi;
  block_rows(row1 - row0, lo, hi);
  lo += row0;
  hi += row0;
  const T* col = tiles + static_cast<size_t>(b) * tile_rows * kLanes +
                 threadIdx.x;
  uint32_t acc = 0;
  for (int r = lo + threadIdx.y; r < hi; r += kGroups) {
    const uint32_t v = static_cast<uint32_t>(
        load(col + static_cast<size_t>(r) * kLanes));
    acc = combine<OP>(acc, v);
  }
  block_reduce<OP>(acc, out, partial, tickets);
}

// The floor over int8 and uint16 tiles, 16 bytes a load.  A row of 128
// lanes is 128 (int8) or 256 (uint16) bytes, kTPR = 8 or 16 uint4s; a
// warp's load instruction moves 512 bytes (4 or 2 rows), as floor_kernel's
// does at int32, where one element a thread would move 32 or 64.  The
// block stages its share's rows in shared memory kBatch uint4s a thread
// at a time (every load of a batch in flight at once, 32 KB), and each
// (lane, row group) thread then reads its lane of the batch's rows there,
// sign-extended (int8) or zero-extended (uint16) by load(), in the order
// floor_kernel reads them from device memory: the output row is the one
// floor_kernel would write, bit for bit.  __launch_bounds__(..., 4) holds
// the kernel to 32 registers, so that 4 blocks share an SM and P2's 512
// tile blocks take one share each in one round (grid_for).  The rows
// [lo, hi) of a share are one contiguous run of bytes; its start is
// 16-byte aligned where the tiles are (mkssd_probe_floor checks that).
// Other forms timed on the H100 (PERF.md section 6): 16 or 8 lane sums a
// thread in registers, folded by shuffles, slower (40 registers, so 3
// blocks an SM and 3 shares a tile block; or, held to 32 registers, two
// loads a thread in flight and spills); a double-buffered cp.async ring
// of 20 KB stages, 2% faster at int8 and 4% slower at uint16.
template <typename T, int OP>
__global__ void __launch_bounds__(kLanes * kGroups, 4)
floor_vec_kernel(const T* __restrict__ tiles, int tile_rows, int row0,
                 int row1, uint32_t* __restrict__ out, uint32_t* partial,
                 unsigned* tickets) {
  constexpr int kTPR = kLanes * static_cast<int>(sizeof(T)) / 16;
  constexpr int kThreads = kLanes * kGroups;
  constexpr int kBatch = 4;                        // uint4s a thread
  constexpr int kRowsB = kBatch * kThreads / kTPR;  // rows a batch
  __shared__ uint4 s_run[kBatch * kThreads];
  const T* s_el = reinterpret_cast<const T*>(s_run);
  int lo, hi;
  block_rows(row1 - row0, lo, hi);
  lo += row0;
  hi += row0;
  const int t = threadIdx.y * kLanes + threadIdx.x;
  const uint4* run = reinterpret_cast<const uint4*>(
      tiles + (static_cast<size_t>(blockIdx.x) * tile_rows + lo) * kLanes);
  const int nvec = (hi - lo) * kTPR;
  uint32_t acc = 0;
  for (int base = 0; base < nvec; base += kBatch * kThreads) {
    uint4 w[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int v = base + i * kThreads + t;
      if (v < nvec) w[i] = __ldg(run + v);
    }
    __syncthreads();                 // the previous batch has been read
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (base + i * kThreads + t < nvec) s_run[i * kThreads + t] = w[i];
    }
    __syncthreads();
    const int rows = min(kRowsB, (nvec - base) / kTPR);
    for (int r = threadIdx.y; r < rows; r += kGroups)
      acc = combine<OP>(acc, static_cast<uint32_t>(
                                 load(s_el + r * kLanes + threadIdx.x)));
  }
  block_reduce<OP>(acc, out, partial, tickets);
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

// Calls f(window row, roll) for this thread's consecutive windows: a
// quarter (its row group's) of its block's rows of [0, nrows).
template <typename T, class F>
__device__ inline void for_each_window(const T* tiles, int tile_rows,
                                       int nrows, int TL, F f) {
  int lo, hi;
  block_rows(nrows, lo, hi);
  const int r0 = lo + (hi - lo) * static_cast<int>(threadIdx.y) / kGroups;
  const int r1 = lo + (hi - lo) * static_cast<int>(threadIdx.y + 1) / kGroups;
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
               uint32_t* __restrict__ out, uint32_t* partial,
               unsigned* tickets) {
  uint32_t acc = 0;
  for_each_window(tiles, tile_rows, nrows, TL, [&](int r, const Roll& roll) {
    const uint64_t u = roll.uni();
    const uint32_t v = (static_cast<uint32_t>(u >> 32) ^
                        static_cast<uint32_t>(u)) |
                       (roll.last_bad >= r ? 1u : 0u);
    acc += v;
  });
  block_reduce<kSum>(acc, out, partial, tickets);
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
              uint32_t* __restrict__ out, uint32_t* partial,
              unsigned* tickets) {
  extern __shared__ uint32_t s_tab[];
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int i = tid; i < table_size; i += kLanes * kGroups)
    s_tab[i] = static_cast<uint32_t>(table[i]);
  __syncthreads();
  const uint32_t mask = static_cast<uint32_t>(table_size - 1);
  int lo, hi;
  block_rows(nrows, lo, hi);
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
  block_reduce<kSum>(acc, out, partial, tickets);
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

// The lower bound of x in a[lo, hi) (hi if every entry is below x), by
// K3's search step (csrc/member.cu step): halve [base, base + len), where
// the answer lies in [base, base + len] and ku holds a[base + len]
// wherever that entry was read, until len is 0.  So ku == x marks a hit
// without another load: the answer's entry is the last key read that is
// >= x, and an answer of hi read none.  An empty range reads nothing.
__device__ inline int lower_bound(const uint32_t* a, int lo, int hi,
                                  uint32_t x, bool& hit) {
  int base = lo, len = hi - lo;
  uint32_t ku = ~x;                 // no key >= x read yet
  while (len > 0) {
    const int half = len >> 1;
    const uint32_t key = a[base + half];
    const bool lt = key < x;
    base = lt ? base + half + 1 : base;
    len = lt ? len - half - 1 : half;
    ku = lt ? ku : key;
  }
  hit = ku == x;
  return base;
}

__device__ inline uint32_t window_dim(uint64_t u, const SearchParams& sp) {
  return static_cast<uint32_t>((u >> sp.dim_shift) & sp.dim_mask);
}

// What a hit adds: the window's base (its outer context bits, shifted
// above the prefix) or'ed with the table position.
__device__ inline uint32_t window_base(uint64_t u, const SearchParams& sp) {
  const uint64_t top = (u >> sp.top_shift) & sp.outer_mask;
  const uint64_t right = u & sp.outer_mask;
  return static_cast<uint32_t>(((top << sp.outer_bits) | right)
                               << sp.pf_bits);
}

// The exact form.  Shared memory: accept[n], then the index's nb + 1
// entries (none where nb == 0).
__global__ void __launch_bounds__(kLanes * kGroups)
exact_search_kernel(const int32_t* __restrict__ tiles, int tile_rows,
                    int nrows, SearchParams sp,
                    const uint32_t* __restrict__ accept, int n,
                    const uint32_t* __restrict__ index, int nb, int shift,
                    uint32_t* __restrict__ out, uint32_t* partial,
                    unsigned* tickets) {
  extern __shared__ uint32_t s_tab[];
  uint32_t* s_idx = s_tab + n;
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int i = tid; i < n; i += kLanes * kGroups) s_tab[i] = accept[i];
  if (nb > 0)
    for (int i = tid; i <= nb; i += kLanes * kGroups) s_idx[i] = index[i];
  __syncthreads();
  uint32_t acc = 0;
  for_each_window(tiles, tile_rows, nrows, sp.TL,
                  [&](int r, const Roll& roll) {
    const uint64_t u = roll.uni();
    const uint32_t dim = window_dim(u, sp);
    int lo = 0, hi = n;
    if (nb > 0) {
      // a 64-bit shift: shift may be 32 (one bucket over 32-bit keys)
      const uint64_t b = static_cast<uint64_t>(dim) >> shift;
      const bool in = b < static_cast<uint64_t>(nb);
      lo = in ? static_cast<int>(s_idx[b]) : n;
      hi = in ? static_cast<int>(s_idx[b + 1]) : n;
    }
    bool hit;
    const int pos = lower_bound(s_tab, lo, hi, dim, hit);
    if (hit && roll.last_bad < r)
      acc += window_base(u, sp) | static_cast<uint32_t>(pos);
  });
  block_reduce<kSum>(acc, out, partial, tickets);
}

// The signature form.  Shared memory: the first 7 BFS level rows [7][128]
// then the signature words [sig_words][128].
__global__ void __launch_bounds__(kLanes * kGroups)
sig_search_kernel(const int32_t* __restrict__ tiles, int tile_rows,
                  int nrows, SearchParams sp,
                  const uint32_t* __restrict__ lev,
                  const uint32_t* __restrict__ sig, int sig_words,
                  uint32_t* __restrict__ out, uint32_t* partial,
                  unsigned* tickets) {
  extern __shared__ uint32_t s_tab[];
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int i = tid; i < 7 * kLanes; i += kLanes * kGroups) s_tab[i] = lev[i];
  for (int i = tid; i < sig_words * kLanes; i += kLanes * kGroups)
    s_tab[7 * kLanes + i] = sig[i];
  __syncthreads();
  const uint32_t* s_lev = s_tab;
  const uint32_t* s_sig = s_tab + 7 * kLanes;
  uint32_t acc = 0;
  for_each_window(tiles, tile_rows, nrows, sp.TL,
                  [&](int r, const Roll& roll) {
    const uint64_t u = roll.uni();
    const uint32_t dim = window_dim(u, sp);
    uint32_t pos = 0;
    bool hit = false;
    for (int d = 0; d < 7; ++d)
      pos = 2 * pos + (s_lev[d * kLanes + pos] < dim ? 1u : 0u);
    const uint32_t dsig = dim & 0xFFFFu;
    for (int w = 0; w < sig_words; ++w) {
      const uint32_t word = s_sig[w * kLanes + pos];
      hit = hit || (word & 0xFFFFu) == dsig || (word >> 16) == dsig;
    }
    if (hit && roll.last_bad < r) acc += window_base(u, sp) | pos;
  });
  block_reduce<kSum>(acc, out, partial, tickets);
}

inline int n_parts(int nrows) { return (nrows + kPartRows - 1) / kPartRows; }

// The grid of a launch of `kernel` (with `smem` bytes of dynamic shared
// memory) over nb tile blocks of nrows rows: nb blocks on x, and on y the
// shares of a tile block.  Without tickets, one share per kPartRows rows.
// With them, the number of shares, at most that many, that finishes
// soonest if every block takes time in proportion to its rows and the card
// runs `slots` blocks at a time (the fewest, where two counts tie: each
// block of a tile block that has several pays a ticket).
template <typename K>
dim3 grid_for(K kernel, size_t smem, int nb, int nrows, bool tickets) {
  if (!tickets)
    return dim3(static_cast<unsigned>(nb),
                static_cast<unsigned>(n_parts(nrows)));
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms < 1)
      sms = 132;
  }
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kLanes * kGroups, smem) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  const long long slots = static_cast<long long>(sms) * per_sm;
  int shares = 1;
  long long best = -1;
  for (int g = 1; g <= n_parts(nrows); ++g) {
    const long long rounds = (static_cast<long long>(nb) * g + slots - 1) /
                             slots;
    const long long span = rounds * ((nrows + g - 1) / g);
    if (best < 0 || span < best) {
      best = span;
      shares = g;
    }
  }
  return dim3(static_cast<unsigned>(nb), static_cast<unsigned>(shares));
}

// At most kMaxShares shares; scratch and tickets come together, and are
// needed for the ticket reduce only.
inline bool parts_ok(int nrows, const void* partial, const void* tickets) {
  return n_parts(nrows) <= kMaxShares &&
         (partial == nullptr) == (tickets == nullptr);
}

const dim3 kBlock(kLanes, kGroups);

// Launches `kernel` with `smem` bytes of dynamic shared memory over nb
// tile blocks of nrows rows (grid_for's grid).
template <typename K, typename... Args>
cudaError_t launch_smem(K kernel, size_t smem, int nb, int nrows,
                        unsigned* tickets, cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid = grid_for(kernel, smem, nb, nrows, tickets != nullptr);
  kernel<<<grid, kBlock, smem, s>>>(args...);
  return cudaGetLastError();
}

// int32 tiles: floor_kernel, an element a thread; int8 and uint16:
// floor_vec_kernel, 16 bytes a thread, on 16-byte aligned tiles.
template <typename T>
cudaError_t launch_floor(const void* tiles, int nb, int tile_rows, int row0,
                         int row1, int op, uint32_t* out, uint32_t* partial,
                         unsigned* tickets, cudaStream_t s) {
  const T* t = static_cast<const T*>(tiles);
  void (*kernel)(const T*, int, int, int, uint32_t*, uint32_t*, unsigned*);
  if constexpr (sizeof(T) == 4) {
    kernel = op == kXor ? floor_kernel<T, kXor> : floor_kernel<T, kSum>;
  } else {
    if (reinterpret_cast<uintptr_t>(t) % 16 != 0)
      return cudaErrorMisalignedAddress;
    kernel = op == kXor ? floor_vec_kernel<T, kXor>
                        : floor_vec_kernel<T, kSum>;
  }
  const dim3 grid = grid_for(kernel, 0, nb, row1 - row0, tickets != nullptr);
  kernel<<<grid, kBlock, 0, s>>>(t, tile_rows, row0, row1, out, partial,
                                 tickets);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_winmath(const void* tiles, int nb, int tile_rows,
                           int nrows, int TL, uint32_t* out, uint32_t* partial,
                           unsigned* tickets, cudaStream_t s) {
  const dim3 grid =
      grid_for(winmath_kernel<T>, 0, nb, nrows, tickets != nullptr);
  winmath_kernel<T><<<grid, kBlock, 0, s>>>(static_cast<const T*>(tiles),
                                            tile_rows, nrows, TL, out,
                                            partial, tickets);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every function returns 0 or the cudaError_t of the launch.  `out` is an
// [nb, 128] int32 buffer.  With `partial` and `tickets` NULL (the atomic
// reduce) the kernel adds into it, so it must be zeroed where parts > 1;
// parts = ceil(rows / 128) of the rows reduced (row1 - row0 or nrows), at
// most 65535.  Otherwise (the ticket reduce) it is written whole;
// `partial` is scratch of [nb, parts, 128] int32 and `tickets` [>= nb]
// uint32, zero and not in use by a launch that may run at the same time.

// Rows [row0, row1) of every tile block, summed (op 0) or XORed (op 1);
// op 2 writes each block's index without reading the tiles.  dtype: 0
// int32, 1 int8, 2 uint16; int8 and uint16 tiles must be 16-byte aligned
// (cudaErrorMisalignedAddress otherwise).
int mkssd_probe_floor(const void* tiles, int dtype, int nb, int tile_rows,
                      int row0, int row1, int op, void* out, void* partial,
                      void* tickets, void* stream) {
  if (nb < 1 || row0 < 0 || row1 <= row0 || row1 > tile_rows || op < 0 ||
      op > kNone || dtype < kI32 || dtype > kU16 ||
      (op != kNone && !parts_ok(row1 - row0, partial, tickets)))
    return cudaErrorInvalidValue;
  uint32_t* o = static_cast<uint32_t*>(out);
  uint32_t* pt = static_cast<uint32_t*>(partial);
  unsigned* tk = static_cast<unsigned*>(tickets);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == kNone) {
    block_index_kernel<<<nb, kLanes, 0, s>>>(o);
    return cudaGetLastError();
  }
  if (dtype == kI8)
    return launch_floor<int8_t>(tiles, nb, tile_rows, row0, row1, op, o, pt,
                                tk, s);
  if (dtype == kU16)
    return launch_floor<uint16_t>(tiles, nb, tile_rows, row0, row1, op, o,
                                  pt, tk, s);
  return launch_floor<int32_t>(tiles, nb, tile_rows, row0, row1, op, o, pt,
                               tk, s);
}

// The sum over the first nrows window rows of (uni_hi ^ uni_lo) | invalid,
// for TL-base windows; needs nrows + TL - 1 <= tile_rows.  dtype: 0 int32,
// 1 int8.
int mkssd_probe_winmath(const void* tiles, int dtype, int nb, int tile_rows,
                        int nrows, int TL, void* out, void* partial,
                        void* tickets, void* stream) {
  if (nb < 1 || nrows < 1 || TL < 1 || TL > kMaxTL ||
      nrows + TL - 1 > tile_rows || (dtype != kI32 && dtype != kI8) ||
      !parts_ok(nrows, partial, tickets))
    return cudaErrorInvalidValue;
  uint32_t* o = static_cast<uint32_t*>(out);
  uint32_t* pt = static_cast<uint32_t*>(partial);
  unsigned* tk = static_cast<unsigned*>(tickets);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kI8)
    return launch_winmath<int8_t>(tiles, nb, tile_rows, nrows, TL, o, pt, tk,
                                  s);
  return launch_winmath<int32_t>(tiles, nb, tile_rows, nrows, TL, o, pt, tk,
                                 s);
}

// ng chained lookups pos = (pos + table[pos]) & (table_size - 1) from
// pos = ((tile & 3) * mult) & (table_size - 1), summed over every step and
// the first nrows rows of int32 tiles.  table_dtype: 0 uint32, 2 uint16.
int mkssd_probe_gather(const void* tiles, int nb, int tile_rows, int nrows,
                       const void* table, int table_dtype, int table_size,
                       int mult, int ng, void* out, void* partial,
                       void* tickets, void* stream) {
  if (nb < 1 || nrows < 1 || nrows > tile_rows || ng < 0 || table_size < 1 ||
      (table_size & (table_size - 1)) != 0 || table_size > 4096 ||
      (table_dtype != kI32 && table_dtype != kU16) ||
      !parts_ok(nrows, partial, tickets))
    return cudaErrorInvalidValue;
  uint32_t* pt = static_cast<uint32_t*>(partial);
  unsigned* tk = static_cast<unsigned*>(tickets);
  const size_t smem = static_cast<size_t>(table_size) * sizeof(uint32_t);
  const dim3 grid = table_dtype == kU16
      ? grid_for(gather_kernel<uint16_t>, smem, nb, nrows, tk != nullptr)
      : grid_for(gather_kernel<uint32_t>, smem, nb, nrows, tk != nullptr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* t = static_cast<const int32_t*>(tiles);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (table_dtype == kU16)
    gather_kernel<uint16_t><<<grid, kBlock, smem, s>>>(
        t, tile_rows, nrows, static_cast<const uint16_t*>(table), table_size,
        mult, ng, o, pt, tk);
  else
    gather_kernel<uint32_t><<<grid, kBlock, smem, s>>>(
        t, tile_rows, nrows, static_cast<const uint32_t*>(table), table_size,
        mult, ng, o, pt, tk);
  return cudaGetLastError();
}

// The sum over the first nrows window rows of base | pos where the window
// is kept.  sig == NULL: the exact form, pos = the lower bound of dim in
// accept[n_accept] and a hit where it is equal, searched through the
// index (u32 [n_buckets + 1], mkssd_member_index's table of accept, with
// its shift; n_buckets == 0: no index, the whole table is searched).
// Otherwise the signature form: pos = the 7-level bucket index through
// lev's first 7 rows [7][128] and a hit where a 16-bit half of one of
// sig[sig_words][128]'s words at lane pos equals dim's low 16 bits.
// Tables hold u32 bits.
int mkssd_probe_search(const void* tiles, int nb, int tile_rows, int nrows,
                       int k, int subk, int drlevel, const void* accept,
                       int n_accept, const void* index, int n_buckets,
                       int shift, const void* lev, const void* sig,
                       int sig_words, void* out, void* partial,
                       void* tickets, void* stream) {
  const int TL = 2 * k;
  const int outctx = k - subk;
  if (nb < 1 || nrows < 1 || TL > kMaxTL || outctx < 0 || drlevel > subk ||
      4 * subk > 32 || nrows + TL - 1 > tile_rows ||
      !parts_ok(nrows, partial, tickets))
    return cudaErrorInvalidValue;
  const bool exact = sig == nullptr;
  if (exact ? (n_accept < 1 || accept == nullptr || n_buckets < 0 ||
               (n_buckets > 0 &&
                (index == nullptr || (n_buckets & (n_buckets - 1)) != 0 ||
                 n_buckets >= n_accept || shift < 0 || shift > 32)))
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
  const int32_t* t = static_cast<const int32_t*>(tiles);
  uint32_t* o = static_cast<uint32_t*>(out);
  uint32_t* pt = static_cast<uint32_t*>(partial);
  unsigned* tk = static_cast<unsigned*>(tickets);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (exact) {
    const size_t words = static_cast<size_t>(n_accept) +
                         (n_buckets > 0 ? n_buckets + 1 : 0);
    return launch_smem(exact_search_kernel, words * sizeof(uint32_t), nb,
                       nrows, tk, s, t, tile_rows, nrows, sp,
                       static_cast<const uint32_t*>(accept), n_accept,
                       static_cast<const uint32_t*>(index), n_buckets, shift,
                       o, pt, tk);
  }
  const size_t words = static_cast<size_t>(7 + sig_words) * kLanes;
  return launch_smem(sig_search_kernel, words * sizeof(uint32_t), nb, nrows,
                     tk, s, t, tile_rows, nrows, sp,
                     static_cast<const uint32_t*>(lev),
                     static_cast<const uint32_t*>(sig), sig_words, o, pt,
                     tk);
}

}  // extern "C"
