// Dense abundance-vector search for Hopper (sm_90a), plain C interface.
//
// mkssd_abv_gather replaces no Pallas kernel: the JAX package computes
// the dense search through XLA matmuls outside any Pallas kernel
// (metakssd_tpu/ops/dense_abv.py:45-96), and the port first ran them as
// torch ops.  A profile of composite -s <mode> --dense on an H100
// (47,752 x 85,205 float32 DB, one query a call) showed every one of those
// ops walking the whole 16.3 GB matrix: a float32 mask of the DB (twice a
// call in L2), db * db and four GEMVs in L2, 167 broadcast steps in L1,
// 59-71 ms of device time a call.  The answer reads far less.  For a query
// x (sparse: the species it holds) and a DB sample y, over the species
// both hold (the reference tool's abv_search, command_composite.c:299-319,
// ported as metakssd_tpu/composite.py:515-530):
//     overlap = any query species j with y_j != 0
//     L2      = sqrt(sum (x_j - y_j)^2)
//     L1      = 200 + sum (|x_j - y_j| - x_j - y_j)
//     cosine  = sum x_j * y_j / (sqrt(sum over all query species of
//               x_j^2) * y_l2n)
// Every term over a species the query lacks is zero or absent from the
// formula, so reading only the query's columns of each DB row is the same
// arithmetic.  The DB stays row-major in place.
//
// What bounds it: the bytes of the sectors it gathers.  Row r, column j
// costs one 32-byte sector (a query's columns are sparse, so two of them
// rarely share one): rows x nnz x 32 B, 0.59 GB at the benchmark's mean
// query of 383 species, about 0.17 ms at 3.35 TB/s.  At every species the
// gather is one coalesced read of the whole matrix (16.3 GB).
//
// Design.  One warp a (query, DB row); a block of kWarps warps takes
// kWarps consecutive rows of one query.  The block stages the query's
// sorted column ids and values in shared memory, kTile at a time (a query
// of more columns takes several tiles), and the lanes stride the staged
// list: lane l reads columns l, l + 32, ... of its warp's row.  Each lane
// issues the loads of kUnroll columns before it uses any, so kUnroll
// independent read-only loads (ld.global.nc) are in flight a lane, which
// at the mean query is every column of the row at once.  The cost follows
// the query: the column list is sorted, so as a query grows dense the 32
// lanes read neighbouring addresses and the gather becomes a coalesced row
// read, with no threshold and no second kernel.  Blocks are ordered row
// block first, query second, so that the queries of a batch read the same
// rows together and share the sectors of common species in L2.  Lanes
// accumulate the overlap flag and the mode's sum; a warp shuffle reduces
// them and lane 0 writes the row's two outputs.  The mode is a template
// parameter: the three share the loads and differ in 2-3 operations.
// On an H100 the sparse gather runs at about 36G scattered sectors a
// second (0.51 ms at 383 columns, 2.46 ms at 3,000), about a third of the
// sector bound, whatever the shape of the launch: 1-8 rows a warp, 4-16
// loads in flight a lane, 8-32 warps a block, tiles of 2048-4096 columns
// and forced occupancy all gave 0.508-0.538 ms at 383 columns, so the
// card's rate of random DRAM accesses, not the launch, sets it.  Every
// species reads the matrix once in about 6.5 ms (2.5 TB/s).

// Precision: each term and every sum is taken in float64 from the float32
// inputs, and the result is rounded once to float32, so the L2 of a query
// equal to its own DB row is exactly 0 (no q2y + y2x - 2<x,y>
// cancellation) and L1 does not lose digits in 200 - 2 sum min(x, y).
// A row that shares no species with the query is written as measure 0,
// overlap 0 (nothing reads its measure).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;        // rows a block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 2048;      // staged columns: 16 KB of shared memory
constexpr int kUnroll = 16;      // columns a lane loads before it sums

enum Mode { kCosine = 0, kL1 = 1, kL2 = 2 };

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    abv_gather_kernel(const float* __restrict__ db, long long n_rows,
                      long long n_cols, int n_queries,
                      const int32_t* __restrict__ offsets,
                      const int32_t* __restrict__ cols,
                      const float* __restrict__ vals,
                      const float* __restrict__ y_l2n,
                      float* __restrict__ measure,
                      uint8_t* __restrict__ overlap) {
  __shared__ int32_t s_col[kTile];
  __shared__ float s_val[kTile];
  const int q = static_cast<int>(blockIdx.x % n_queries);
  const long long row =
      static_cast<long long>(blockIdx.x / n_queries) * kWarps +
      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  // a warp past the last row reads that row and writes nothing
  const float* rowp = db + min(row, n_rows - 1) * n_cols;
  double acc = 0.0;
  double x2 = 0.0;
  bool hit = false;
  const int lo = offsets[q];
  const int hi = offsets[q + 1];
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n = min(kTile, hi - t0);
    __syncthreads();  // every warp is done with the previous tile
    for (int j = threadIdx.x; j < n; j += kThreads) {
      s_col[j] = __ldg(cols + t0 + j);
      s_val[j] = __ldg(vals + t0 + j);
    }
    __syncthreads();
    for (int j = lane; j < n; j += 32 * kUnroll) {
      bool in[kUnroll];
      float x[kUnroll];
      float y[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        in[u] = j + 32 * u < n;
        x[u] = in[u] ? s_val[j + 32 * u] : 0.0f;
        y[u] = in[u] ? __ldg(rowp + s_col[j + 32 * u]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const double xd = x[u];
        const double yd = y[u];
        const bool both = in[u] && y[u] != 0.0f;
        double t;
        if (kMode == kL2) {
          const double d = xd - yd;
          t = d * d;
        } else if (kMode == kL1) {
          t = fabs(xd - yd) - xd - yd;
        } else {
          t = xd * yd;
          x2 += xd * xd;   // 0 for a lane past n
        }
        acc += both ? t : 0.0;
        hit = hit || both;
      }
    }
  }
  acc = warp_sum(acc);
  if (kMode == kCosine) x2 = warp_sum(x2);
  const bool any = __any_sync(0xffffffffu, hit);
  if (lane != 0 || row >= n_rows) return;
  double v;
  if (kMode == kL2) {
    v = sqrt(acc);
  } else if (kMode == kL1) {
    v = 200.0 + acc;
  } else {
    v = acc / (sqrt(x2) * static_cast<double>(y_l2n[row]));
  }
  const long long o = static_cast<long long>(q) * n_rows + row;
  measure[o] = any ? static_cast<float>(v) : 0.0f;
  overlap[o] = any ? 1 : 0;
}

template <int kMode>
cudaError_t launch(const float* db, long long n_rows, long long n_cols,
                   int n_queries, long long blocks, const int32_t* offsets,
                   const int32_t* cols, const float* vals,
                   const float* y_l2n, float* measure, uint8_t* overlap,
                   cudaStream_t s) {
  abv_gather_kernel<kMode><<<static_cast<unsigned>(blocks), kThreads, 0,
                             s>>>(db, n_rows, n_cols, n_queries, offsets,
                                  cols, vals, y_l2n, measure, overlap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch.  db: n_rows x n_cols float32,
// row-major; the queries as CSR: offsets (int32, n_queries + 1, from 0),
// cols (int32, each query's column ids sorted, in [0, n_cols)) and vals
// (float32, nonzero); y_l2n (float32, n_rows; read by cosine only, may be
// NULL otherwise); mode 0 cosine, 1 L1, 2 L2.  The caller sizes measure
// (float32) and overlap (uint8) to n_queries x n_rows.
int mkssd_abv_gather(const void* db, long long n_rows, long long n_cols,
                     const void* offsets, const void* cols, const void* vals,
                     int n_queries, const void* y_l2n, int mode,
                     void* measure, void* overlap, void* stream) {
  if (n_rows <= 0 || n_cols <= 0 || n_queries <= 0 || mode < kCosine ||
      mode > kL2 || (mode == kCosine && y_l2n == nullptr))
    return cudaErrorInvalidValue;
  const long long blocks = (n_rows + kWarps - 1) / kWarps * n_queries;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const float* d = static_cast<const float*>(db);
  const int32_t* off = static_cast<const int32_t*>(offsets);
  const int32_t* c = static_cast<const int32_t*>(cols);
  const float* v = static_cast<const float*>(vals);
  const float* yn = static_cast<const float*>(y_l2n);
  float* m = static_cast<float*>(measure);
  uint8_t* o = static_cast<uint8_t*>(overlap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kCosine)
    return launch<kCosine>(d, n_rows, n_cols, n_queries, blocks, off, c, v,
                           yn, m, o, s);
  if (mode == kL1)
    return launch<kL1>(d, n_rows, n_cols, n_queries, blocks, off, c, v, yn,
                       m, o, s);
  return launch<kL2>(d, n_rows, n_cols, n_queries, blocks, off, c, v, yn, m,
                     o, s);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// mkssd_abv_post_walk: composite -s <mode> over the abv index's own
// postings (ops/abv_postings.py), for a DB too large to hold dense.
//
// It replaces no Pallas kernel: the JAX package walks the postings on the
// host (metakssd_tpu/composite.py abv_search, np.add.at over every
// posting of the query's species).  The index is species-major: species
// j holds postings [starts[j], starts[j + 1]) of (sample id, percentage),
// sample ids ascending (composite -i appends the sample files in order).
// The reference tool walks the query's species in the .abv file's order
// and, for every posting, adds the mode's term to the sample's float32
// accumulator (command_composite.c:299-319); ties in its ranking fall to
// the order in which samples were first touched.  The text is promised
// byte-identical, so this kernel adds in that order, one float32 rounding
// an addition, and no atomics: per sample,
//     L2      acc += (y - x) * (y - x)                 (float32 ops)
//     L1      acc += (float)|(double)y - (double)x|;  xs += x;  ys += y
//             and at the end acc + ((200 - xs) - ys)  (float32 ops)
//     cosine  acc += y * x                            (float32 ops)
// each written as an explicit _rn intrinsic so that nvcc contracts
// nothing into an FMA, and touch = the walk position (the query species'
// postings laid end to end, in query order) of its first posting; -1 and
// measure 0 for a sample that shares no species with the query.
//
// What bounds it: the bytes of the query's postings, each read once
// (4-byte id + 4-byte percentage): about 21M postings, 169 MB, 0.05 ms at
// 3.35 TB/s at the whole public DB's mean query.  Design: one block a
// tile of kPostTile samples of one query (grid x: tiles, y: queries),
// with the tile's accumulators and first touches in shared memory.  The
// query's species are taken kPostThreads at a time: one thread a species
// finds the tile's range of its postings by two binary searches (ids are
// sorted within a species) and a block scan lays the ranges end to end.
// That run is walked in windows of kPostBuf postings: every thread first
// issues the loads of its eight entries of the window (so eight
// independent loads are in flight a thread) into shared memory, then the
// block applies the window species by species, in query order, one
// __syncthreads apart.  Within one species each sample occurs once, so no
// two threads touch one slot and the order of additions per sample is the
// query's.
// ---------------------------------------------------------------------------

namespace {

constexpr int kPostThreads = 256;
constexpr int kPostTile = 1024;                  // samples a block
constexpr int kPostLoads = 8;                    // loads a thread a window
constexpr int kPostBuf = kPostThreads * kPostLoads;

__device__ __forceinline__ long long first_at_least(
    const int32_t* __restrict__ a, long long lo, long long hi,
    long long key) {
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The last k in [0, n) with cut[k] <= v (cut[0] = 0 <= v < cut[n]): the
// species of the run that holds entry v.
__device__ __forceinline__ int species_of(const int* cut, int n, int v) {
  int lo = 0;
  int hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (cut[mid] <= v)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Exclusive prefix sum of one int a thread over the block; every thread
// gets its own, and cut[kPostThreads] the total.
__device__ __forceinline__ void block_cuts(int v, int* cut, int* warp_sum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += t;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kPostThreads / 32 ? warp_sum[lane] : 0;
    int winc = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, winc, d);
      if (lane >= d) winc += t;
    }
    if (lane < kPostThreads / 32) warp_sum[lane] = winc - w;
  }
  __syncthreads();
  const int excl = inc - v + warp_sum[warp];
  cut[threadIdx.x] = excl;
  if (threadIdx.x == kPostThreads - 1) cut[kPostThreads] = excl + v;
}

template <int kMode>
__global__ void __launch_bounds__(kPostThreads)
    abv_post_walk_kernel(const long long* __restrict__ starts,
                         const int32_t* __restrict__ ids,
                         const float* __restrict__ pct, long long n_samples,
                         const int32_t* __restrict__ q_off,
                         const int32_t* __restrict__ q_sp,
                         const float* __restrict__ q_val,
                         const long long* __restrict__ q_pos,
                         float* __restrict__ measure,
                         long long* __restrict__ touch) {
  constexpr int kSums = kMode == kL1 ? 3 : 1;   // L1: acc, xs, ys
  __shared__ float s_sum[kSums][kPostTile];
  __shared__ long long s_touch[kPostTile];
  __shared__ long long s_first[kPostThreads];   // tile's first posting
  __shared__ long long s_pos[kPostThreads];     // ... and its walk position
  __shared__ float s_x[kPostThreads];
  __shared__ int s_cut[kPostThreads + 1];
  __shared__ int s_warp[kPostThreads / 32];
  __shared__ uint16_t s_sample[kPostBuf];       // sample - tile start
  __shared__ float s_y[kPostBuf];

  const long long q = blockIdx.y;
  const long long s0 = static_cast<long long>(blockIdx.x) * kPostTile;
  const int tile = static_cast<int>(min(static_cast<long long>(kPostTile),
                                        n_samples - s0));
  for (int i = threadIdx.x; i < kPostTile; i += kPostThreads) {
#pragma unroll
    for (int a = 0; a < kSums; ++a) s_sum[a][i] = 0.0f;
    s_touch[i] = -1;
  }
  const int k_lo = q_off[q];
  const int k_hi = q_off[q + 1];
  for (int kb = k_lo; kb < k_hi; kb += kPostThreads) {
    __syncthreads();  // the previous run's walk is done with the arrays
    const int n = min(kPostThreads, k_hi - kb);
    int cnt = 0;
    if (threadIdx.x < n) {
      const int k = kb + threadIdx.x;
      const int sp = q_sp[k];
      const long long lo = starts[sp];
      const long long hi = starts[sp + 1];
      const long long a = first_at_least(ids, lo, hi, s0);
      cnt = static_cast<int>(first_at_least(ids, a, hi, s0 + tile) - a);
      s_first[threadIdx.x] = a;
      s_pos[threadIdx.x] = q_pos[k] + (a - lo);
      s_x[threadIdx.x] = q_val[k];
    }
    block_cuts(cnt, s_cut, s_warp);
    __syncthreads();
    const int total = s_cut[kPostThreads];
    for (int w0 = 0; w0 < total; w0 += kPostBuf) {
      const int wn = min(kPostBuf, total - w0);
      int32_t got_s[kPostLoads];
      float got_y[kPostLoads];
#pragma unroll
      for (int u = 0; u < kPostLoads; ++u) {
        const int i = threadIdx.x + u * kPostThreads;
        if (i < wn) {
          const int k = species_of(s_cut, n, w0 + i);
          const long long p = s_first[k] + (w0 + i - s_cut[k]);
          got_s[u] = __ldg(ids + p);
          got_y[u] = __ldg(pct + p);
        }
      }
#pragma unroll
      for (int u = 0; u < kPostLoads; ++u) {
        const int i = threadIdx.x + u * kPostThreads;
        if (i < wn) {
          s_sample[i] = static_cast<uint16_t>(got_s[u] - s0);
          s_y[i] = got_y[u];
        }
      }
      __syncthreads();
      // the window's species in query order, one barrier apart
      for (int k = species_of(s_cut, n, w0); k < n && s_cut[k] < w0 + wn;
           ++k) {
        const int e0 = max(s_cut[k], w0) - w0;
        const int e1 = min(s_cut[k + 1], w0 + wn) - w0;
        if (e0 >= e1) continue;  // the same for every thread
        const float x = s_x[k];
        const long long pos0 = s_pos[k] + (w0 - s_cut[k]);
        for (int i = e0 + threadIdx.x; i < e1; i += kPostThreads) {
          const int s = s_sample[i];
          const float y = s_y[i];
          if constexpr (kMode == kL2) {
            const float d = __fsub_rn(y, x);
            s_sum[0][s] = __fadd_rn(s_sum[0][s], __fmul_rn(d, d));
          } else if constexpr (kMode == kL1) {
            const float t = __double2float_rn(
                fabs(__dsub_rn(static_cast<double>(y),
                               static_cast<double>(x))));
            s_sum[0][s] = __fadd_rn(s_sum[0][s], t);
            s_sum[1][s] = __fadd_rn(s_sum[1][s], x);
            s_sum[2][s] = __fadd_rn(s_sum[2][s], y);
          } else {
            s_sum[0][s] = __fadd_rn(s_sum[0][s], __fmul_rn(y, x));
          }
          if (s_touch[s] < 0) s_touch[s] = pos0 + i;
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tile; i += kPostThreads) {
    const long long o = q * n_samples + s0 + i;
    const long long t = s_touch[i];
    float m = s_sum[0][i];
    if constexpr (kMode == kL1)
      m = __fadd_rn(m, __fsub_rn(__fsub_rn(200.0f, s_sum[1][i]),
                                 s_sum[2][i]));
    measure[o] = t >= 0 ? m : 0.0f;
    touch[o] = t;
  }
}

template <int kMode>
cudaError_t launch_post(dim3 grid, const long long* starts,
                        const int32_t* ids, const float* pct,
                        long long n_samples, const int32_t* q_off,
                        const int32_t* q_sp, const float* q_val,
                        const long long* q_pos, float* measure,
                        long long* touch, cudaStream_t s) {
  abv_post_walk_kernel<kMode><<<grid, kPostThreads, 0, s>>>(
      starts, ids, pct, n_samples, q_off, q_sp, q_val, q_pos, measure,
      touch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch.  The index: starts (int64,
// n_species + 1), ids (int32, ascending within each species, in
// [0, n_samples)), pct (float32).  The queries as CSR over their species
// in file order: q_off (int32, n_queries + 1, from 0), q_sp (int32, each
// in [0, n_species)), q_val (float32) and q_pos (int64, the walk position
// of each query species' first posting: its query's earlier species'
// posting counts summed); mode 0 cosine, 1 L1, 2 L2.  The caller sizes
// measure (float32) and touch (int64) to n_queries x n_samples.
int mkssd_abv_post_walk(const void* starts, const void* ids, const void* pct,
                        long long n_samples, const void* q_off,
                        const void* q_sp, const void* q_val,
                        const void* q_pos, int n_queries, int mode,
                        void* measure, void* touch, void* stream) {
  if (n_samples <= 0 || n_queries <= 0 || n_queries > 65535 ||
      mode < kCosine || mode > kL2)
    return cudaErrorInvalidValue;
  const long long tiles = (n_samples + kPostTile - 1) / kPostTile;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(n_queries));
  const long long* st = static_cast<const long long*>(starts);
  const int32_t* id = static_cast<const int32_t*>(ids);
  const float* pc = static_cast<const float*>(pct);
  const int32_t* off = static_cast<const int32_t*>(q_off);
  const int32_t* sp = static_cast<const int32_t*>(q_sp);
  const float* val = static_cast<const float*>(q_val);
  const long long* pos = static_cast<const long long*>(q_pos);
  float* m = static_cast<float*>(measure);
  long long* t = static_cast<long long*>(touch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kCosine)
    return launch_post<kCosine>(grid, st, id, pc, n_samples, off, sp, val,
                                pos, m, t, s);
  if (mode == kL1)
    return launch_post<kL1>(grid, st, id, pc, n_samples, off, sp, val, pos,
                            m, t, s);
  return launch_post<kL2>(grid, st, id, pc, n_samples, off, sp, val, pos, m,
                          t, s);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// mkssd_abv_format_lines: the ranked text of composite -s <mode>, one line
// "name\t%f\n" a (sample, value), formatted on the card from the names
// staged there (ops/abv_text.py).
//
// It replaces no Pallas kernel: the JAX package and the port format the
// text on the host (native/fastseq.cpp:1286 format_name_float_lines, one
// thread, about 130 ns a line).  Over the whole public abv DB a query
// ranks about 378k samples, so that loop and its Python wrapping took 73
// ms of a 98 ms call while the card sat idle.  The value is printed as
// glibc's "%f" prints it, by fastseq.cpp's fast_f6: for v = m * 2^e,
// d = round_half_even(m * 5^6 * 2^(e + 6)) exactly in unsigned __int128,
// a '-' whenever the sign bit is set (-0.0 and negatives that round to
// -0.000000 too), d / 10^6, '.', and six digits of d % 10^6.  A line
// that this cannot print exactly (a value not finite, or d above 9e18,
// |v| above 9e12) or that names a sample outside the names is counted in
// head[1], not printed: the caller then formats the whole text on the
// host.
//
// What bounds it: the bytes it moves, about 23 MB a query at the cell's
// shape (12 B of input a line, the names' offsets, the names' bytes and
// about 26 B of text a line), 0.007 ms at 3.35 TB/s.  Design: one thread
// a line, two launches on one stream.  The first gives each block of
// kFmtThreads lines its text's length and counts the flagged lines.  The
// second adds up the lengths of the blocks before its own (read from L2
// by every block, so no third pass), scans its threads' lengths and
// writes each line at its offset.  A block's text, about 7 KB at the
// cell's names, is laid out in shared memory and written out by
// consecutive threads to consecutive bytes; a block whose text exceeds
// kFmtStage (long names) writes its lines to device memory directly.  The
// last block writes the total length to head[0].
// ---------------------------------------------------------------------------

namespace {

constexpr int kFmtThreads = 256;                   // lines a block
constexpr int kFmtStage = 12 * 1024;               // bytes of shared text

// Line i of the text: where its name lies in the blob, and its value as
// d = round_half_even(|v| * 10^6) with its sign; value_len is the length
// of the value's text (sign, integer digits, '.', six digits), 0 where
// the line is flagged (fastseq.cpp fast_f6's fallbacks, or a sample
// outside the names).
struct Line {
  long long name;
  int name_len;
  int value_len;
  unsigned long long d;
  bool neg;
};

__device__ __forceinline__ Line line_of(const long long* __restrict__ off,
                                        long long n_names,
                                        const int32_t* __restrict__ ids,
                                        const double* __restrict__ vals,
                                        long long i) {
  Line ln{0, 0, 0, 0, false};
  const long long s = ids[i];
  if (s < 0 || s >= n_names) return ln;
  ln.name = off[s];
  ln.name_len = static_cast<int>(off[s + 1] - ln.name);
  const unsigned long long bits =
      static_cast<unsigned long long>(__double_as_longlong(vals[i]));
  const int biased = static_cast<int>((bits >> 52) & 0x7FF);
  const unsigned long long mant = bits & ((1ULL << 52) - 1);
  if (biased == 0x7FF) return ln;                  // inf, nan
  const unsigned long long m = biased == 0 ? mant : mant | (1ULL << 52);
  const int sh = (biased == 0 ? -1074 : biased - 1075) + 6;
  const unsigned __int128 p = static_cast<unsigned __int128>(m) * 15625u;
  unsigned __int128 dd;
  if (sh >= 0) {
    if (sh > 50) return ln;                        // huge magnitude
    dd = p << sh;
  } else if (-sh > 120) {
    dd = 0;                                        // rounds to 0.000000
  } else {
    const int r = -sh;
    const unsigned __int128 q = p >> r;
    const unsigned __int128 frac = p - (q << r);
    const unsigned __int128 half = static_cast<unsigned __int128>(1)
                                   << (r - 1);
    dd = q + ((frac > half || (frac == half && (q & 1))) ? 1 : 0);
  }
  if (dd > static_cast<unsigned __int128>(9000000000000000000ULL)) return ln;
  ln.d = static_cast<unsigned long long>(dd);
  ln.neg = (bits >> 63) != 0;
  int digits = 1;
  for (unsigned long long t = 10000000ULL; t <= ln.d && digits < 13;
       t *= 10)
    ++digits;
  ln.value_len = (ln.neg ? 1 : 0) + digits + 7;
  return ln;
}

__device__ __forceinline__ int length_of(const Line& ln) {
  return ln.value_len ? ln.name_len + ln.value_len + 2 : 0;
}

__device__ __forceinline__ void write_line(char* p, const Line& ln,
                                           const char* __restrict__ blob) {
  for (int k = 0; k < ln.name_len; ++k) p[k] = blob[ln.name + k];
  p += ln.name_len;
  *p++ = '\t';
  char* q = p + ln.value_len;
  *q = '\n';
  const unsigned long long ip = ln.d / 1000000ULL;
  unsigned fp = static_cast<unsigned>(ln.d - ip * 1000000ULL);
  for (int k = 0; k < 6; ++k) {
    *--q = static_cast<char>('0' + fp % 10);
    fp /= 10;
  }
  *--q = '.';
  if (ip <= 0xFFFFFFFFULL) {
    unsigned x = static_cast<unsigned>(ip);
    do {
      *--q = static_cast<char>('0' + x % 10);
      x /= 10;
    } while (x);
  } else {
    unsigned long long x = ip;
    do {
      *--q = static_cast<char>('0' + x % 10);
      x /= 10;
    } while (x);
  }
  if (ln.neg) *--q = '-';
}

// Exclusive prefix sum of one value a thread over the block; *total gets
// the block's sum.
__device__ __forceinline__ long long block_scan(long long v,
                                                long long* total) {
  __shared__ long long s_warp[kFmtThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long t = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += t;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  long long before = 0;
  long long all = 0;
#pragma unroll
  for (int w = 0; w < kFmtThreads / 32; ++w) {
    before += w < warp ? s_warp[w] : 0;
    all += s_warp[w];
  }
  __syncthreads();  // s_warp is free for the next scan
  *total = all;
  return before + inc - v;
}

__global__ void __launch_bounds__(kFmtThreads)
    abv_format_sizes_kernel(const long long* __restrict__ off,
                            long long n_names,
                            const int32_t* __restrict__ ids,
                            const double* __restrict__ vals, long long n,
                            long long* __restrict__ head,
                            long long* __restrict__ block_len) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kFmtThreads + threadIdx.x;
  const int len =
      i < n ? length_of(line_of(off, n_names, ids, vals, i)) : -1;
  long long block_total;
  block_scan(len > 0 ? len : 0, &block_total);
  long long flagged;
  block_scan(len == 0, &flagged);
  if (threadIdx.x == 0) {
    block_len[blockIdx.x] = block_total;
    if (flagged)
      atomicAdd(reinterpret_cast<unsigned long long*>(head + 1),
                static_cast<unsigned long long>(flagged));
  }
}

__global__ void __launch_bounds__(kFmtThreads)
    abv_format_write_kernel(const char* __restrict__ blob,
                            const long long* __restrict__ off,
                            long long n_names,
                            const int32_t* __restrict__ ids,
                            const double* __restrict__ vals, long long n,
                            long long* __restrict__ head,
                            const long long* __restrict__ block_len,
                            char* __restrict__ out, long long out_cap) {
  __shared__ char s_text[kFmtStage];
  long long part = 0;
  for (unsigned j = threadIdx.x; j < blockIdx.x; j += kFmtThreads)
    part += block_len[j];
  long long base;
  block_scan(part, &base);
  const long long total = block_len[blockIdx.x];
  if (threadIdx.x == 0 && blockIdx.x == gridDim.x - 1)
    head[0] = base + total;
  if (base + total > out_cap) return;   // the caller sees head[0] > cap

  const long long i =
      static_cast<long long>(blockIdx.x) * kFmtThreads + threadIdx.x;
  const Line ln = i < n ? line_of(off, n_names, ids, vals, i)
                        : Line{0, 0, 0, 0, false};
  long long ignored;
  const long long at = block_scan(length_of(ln), &ignored);
  const bool staged = total <= kFmtStage;
  if (ln.value_len) write_line((staged ? s_text : out + base) + at, ln, blob);
  if (!staged) return;
  __syncthreads();
  for (int j = threadIdx.x; j < total; j += kFmtThreads)
    out[base + j] = s_text[j];
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of a launch.  blob (uint8) holds the
// names end to end, name s at [off[s], off[s + 1]) (off int64,
// n_names + 1); the lines: ids (int32, n) and vals (float64, n).  scratch
// (int64, 2 + ceil(n / 256)): head[0] gets the text's length, head[1]
// the lines not printed (value not finite or |v| above 9e12, or a sample
// outside the names), the rest the blocks' lengths.  out (uint8,
// out_cap) gets the text of the printed lines; where head[1] is not 0 or
// head[0] exceeds out_cap its content is undefined.
int mkssd_abv_format_lines(const void* blob, const void* off,
                           long long n_names, const void* ids,
                           const void* vals, long long n, void* scratch,
                           void* out, long long out_cap, void* stream) {
  if (n < 0 || n_names < 0 || out_cap < 0) return cudaErrorInvalidValue;
  const long long blocks = (n + kFmtThreads - 1) / kFmtThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  long long* head = static_cast<long long*>(scratch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(head, 0, 2 * sizeof(long long), s);
  if (err != cudaSuccess || blocks == 0) return err;
  const long long* o = static_cast<const long long*>(off);
  const int32_t* id = static_cast<const int32_t*>(ids);
  const double* v = static_cast<const double*>(vals);
  abv_format_sizes_kernel<<<static_cast<unsigned>(blocks), kFmtThreads, 0,
                            s>>>(o, n_names, id, v, n, head, head + 2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  abv_format_write_kernel<<<static_cast<unsigned>(blocks), kFmtThreads, 0,
                            s>>>(static_cast<const char*>(blob), o, n_names,
                                 id, v, n, head, head + 2,
                                 static_cast<char*>(out), out_cap);
  return cudaGetLastError();
}

}  // extern "C"
