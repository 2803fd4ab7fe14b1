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
