// KSSD window sketch kernels for Hopper (sm_90a), plain C interface.
//
// K1  mkssd_sketch_compact  replaces metakssd_tpu/ops/sketch_pallas.py
//     _compact_kernel (launched by sketch_tiles_compact_pallas).
// K2  mkssd_sketch_full     replaces metakssd_tpu/ops/sketch_pallas.py
//     _kernel (launched by sketch_tiles_pallas).
//
// Both compute, for every window of TL = 2k consecutive bases of a uint8
// code stream (0..3 = ACGT, >= 4 = invalid), the canonical tuple
// min(forward, reverse complement) (forward on a tie), its inner
// substring dim (4*subk bits at offset 2*(k - subk)), whether dim is in
// the sorted accept table, and the drtuple
//     ((left outer << 2*outctx) | right outer) << 4*(subk - drlevel)
//       + pfilter[pos].
// A window is kept when all TL bases are valid and dim is in the table.
// K1 writes only the kept windows (drtuple, and optionally the window
// index); its global cursor keeps counting past `capacity`, so the caller
// sees count > capacity and reruns the chunk through K2.  K2 writes, for
// every window, the drtuple (0xFFFFFFFF where dropped) and an int32 keep
// flag.
//
// Design.  Only n_accept / 16^subk of random windows are kept (1 in 4096
// at k=11, subk=6, drlevel=3), so an exact search per window, a chain of
// ceil(log2 n_accept) dependent loads, is spent almost always on a miss.
// Each tile of 256*16 windows therefore runs in two phases.
//
// Scan (every window): a thread reads its 16 + TL - 1 code bytes from
// shared memory as three 16-byte loads (conflict-free at a 16-byte lane
// stride), packs them to 2 bits a base in registers (a multiply packs
// four), and takes each window's forward and reverse-complement tuple
// out of the packed bits with two funnel shifts each: no loop over the
// TL bases of a window.  It then tests ONE bit of a filter bitmap in
// shared memory per window: bit dim where 16^subk bits are given (no
// false positive), a multiplicative fold of dim otherwise (every
// accepted dim has its bit set, so no false negative; about
// n_accept / bits of the other windows pass).  The 16 tests of a thread
// are independent loads.  A window that passes goes into a per-block
// queue of window indices in shared memory.
//
// Verify (the queue, about 1.6% of windows at 64 bits per entry): one
// candidate per thread, lanes dense from warp 0 up; the thread rebuilds
// the tuple from the staged codes, drops a window that holds an invalid
// code, and runs the exact lower bound on the accept table in device
// memory (16 KiB, read through L1), which also gives pos for pfilter.
// K1 then compacts a round's survivors with a warp ballot and a counting
// barrier, takes ONE atomicAdd on the global cursor for the block (none
// when the round kept nothing), and consecutive survivors take
// consecutive slots.  K2 scatters the survivors into a staged output tile
// that was filled with the drop mark, and the block writes the tile out
// as 16-byte stores along consecutive addresses.
//
// The next tile's codes arrive by 16-byte cp.async into the second half
// of a double buffer while this tile is scanned.  Blocks are persistent
// (one resident wave) and walk tiles with a grid stride, so the bitmap
// is staged once per block.
//
// All masks and shifts are built in 64 bits: the device path has
// k - drlevel <= 8 and subk < 8, so k <= 15, 4k <= 60 bits, and no shift
// reaches the operand width (outctx = 0 gives empty masks, not UB).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // threads of a block
constexpr int kWinPerThread = 16;
constexpr int kTile = kThreads * kWinPerThread;   // windows of a tile
constexpr int kMaxTL = 32;
constexpr int kHalo = 32;                 // tile buffer = tile + 32 bytes
constexpr uint32_t kFoldMult = 0x9E3779B1u;
constexpr uint32_t kDropped = 0xFFFFFFFFu;

struct WindowParams {
  int TL;
  int rc_shift;                 // 2 * (TL - 1)
  int top_drop;                 // 64 - 2*TL
  uint64_t tupmask;             // low 2*TL bits
  int dim_shift;                // 2 * outctx
  uint32_t dim_mask;            // low 4*subk bits
  int top_shift;                // 4k - 2*outctx
  uint64_t outer_mask;          // low 2*outctx bits
  int outer_bits;               // 2 * outctx
  int pf_bits;                  // 4 * (subk - drlevel)
  uint32_t fold_mult;           // filter bit = (dim * fold_mult) >> fold_shift
  int fold_shift;
};

WindowParams make_params(int k, int subk, int drlevel, int filter_log2) {
  WindowParams w;
  const int outctx = k - subk;
  w.TL = 2 * k;
  w.rc_shift = 2 * (w.TL - 1);
  w.top_drop = 64 - 2 * w.TL;
  w.tupmask = (2 * w.TL >= 64) ? ~0ull : ((1ull << (2 * w.TL)) - 1);
  w.dim_shift = 2 * outctx;
  w.dim_mask = static_cast<uint32_t>((1ull << (4 * subk)) - 1);
  w.top_shift = 4 * k - 2 * outctx;
  w.outer_bits = 2 * outctx;
  w.outer_mask = (1ull << (2 * outctx)) - 1;
  w.pf_bits = 4 * (subk - drlevel);
  const bool direct = filter_log2 == 4 * subk;
  w.fold_mult = direct ? 1u : kFoldMult;
  w.fold_shift = direct ? 0 : 32 - filter_log2;
  return w;
}

__device__ inline void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of a tile's kTile + TL - 1 codes (rounded up to
// whole 16-byte pieces, at most tile + 32 bytes) into s_buf.  A piece
// that crosses the end of the stream, or a stream that is not 16-byte
// aligned, is copied byte by byte; bytes past the end read as invalid.
__device__ inline void stage_tile(const uint8_t* __restrict__ codes,
                                  long long n_codes, long long tile_start,
                                  bool aligned, uint8_t* s_buf) {
  constexpr int kPieces = kThreads + kHalo / 16;
  for (int c = threadIdx.x; c < kPieces; c += kThreads) {
    const long long g = tile_start + 16LL * c;
    uint8_t* dst = s_buf + 16 * c;
    if (aligned && g + 16 <= n_codes) {
      cp_async16(dst, codes + g);
    } else {
      for (int b = 0; b < 16; ++b)
        dst[b] = (g + b < n_codes) ? codes[g + b] : uint8_t(4);
    }
  }
  cp_async_commit();
}

// Four codes (one per byte of r, the first in the low byte) as 2 bits
// each in the top byte of the result, the first code highest: the four
// products of the multiplier fall on disjoint bits, so nothing carries.
// A code >= 4 contributes its low two bits.
__device__ inline uint32_t pack4(uint32_t r) {
  return (r & 0x03030303u) * 0x40100401u;
}

// Sixteen codes (four words in address order) as 32 bits, the first
// code in bits 31-30.
__device__ inline uint32_t pack16(uint32_t a, uint32_t b, uint32_t c,
                                  uint32_t d) {
  const uint32_t hi = __byte_perm(pack4(b), pack4(a), 0x0073);
  const uint32_t lo = __byte_perm(pack4(d), pack4(c), 0x0073);
  return __byte_perm(lo, hi, 0x5410);
}

// The reverse complement of sixteen packed codes: complement, then
// reverse the 2-bit groups (a bit reversal and a swap within each pair).
__device__ inline uint32_t revcomp16(uint32_t x) {
  const uint32_t v = __brev(~x);
  return ((v >> 1) & 0x55555555u) | ((v & 0x55555555u) << 1);
}

// The scan phase for this thread's 16 consecutive windows of the tile in
// s_buf.  Its 48 code bytes become 96 bits (2 bits a base) and the
// reverse complement's 96 bits, once; window i's forward tuple is then
// the 96 bits shifted left by 2i (a constant) and cut to its top 2*TL
// bits, and its reverse-complement tuple the other 96 bits shifted right
// by 2i and cut to their low 2*TL bits: no loop over bases.  One filter
// bit is tested per window, and the windows inside the stream that pass
// are queued.  Validity is left to the verify phase: an invalid code
// counts as its low two bits here, so a window that holds one may be
// queued (at the filter's false-positive rate) and is dropped there.
__device__ inline void scan_tile(const WindowParams& w, const uint8_t* s_buf,
                                 const uint32_t* s_bits, long long tile_start,
                                 long long nwin, uint16_t* s_queue,
                                 int* s_qn) {
  const int w0 = threadIdx.x * kWinPerThread;
  const uint4* src = reinterpret_cast<const uint4*>(s_buf + w0);
  const uint4 q0 = src[0], q1 = src[1], q2 = src[2];
  const uint32_t p0 = pack16(q0.x, q0.y, q0.z, q0.w);
  const uint32_t p1 = pack16(q1.x, q1.y, q1.z, q1.w);
  const uint32_t p2 = pack16(q2.x, q2.y, q2.z, q2.w);
  const uint32_t r0 = revcomp16(p2), r1 = revcomp16(p1), r2 = revcomp16(p0);
  uint32_t cand = 0;
#pragma unroll
  for (int i = 0; i < kWinPerThread; ++i) {
    const uint64_t fwd =
        ((static_cast<uint64_t>(__funnelshift_l(p1, p0, 2 * i)) << 32) |
         __funnelshift_l(p2, p1, 2 * i)) >> w.top_drop;
    const uint64_t rc =
        ((static_cast<uint64_t>(__funnelshift_r(r1, r0, 2 * i)) << 32) |
         __funnelshift_r(r2, r1, 2 * i)) & w.tupmask;
    const uint64_t uni = fwd <= rc ? fwd : rc;
    const uint32_t dim =
        static_cast<uint32_t>(uni >> w.dim_shift) & w.dim_mask;
    const uint32_t bit = (dim * w.fold_mult) >> w.fold_shift;
    cand |= ((s_bits[bit >> 5] >> (bit & 31u)) & 1u) << i;
  }
  const long long left = nwin - tile_start - w0;
  if (left < kWinPerThread)
    cand &= left > 0 ? (1u << static_cast<int>(left)) - 1u : 0u;
  while (cand != 0u) {
    const int i = __ffs(cand) - 1;
    cand &= cand - 1u;
    const int slot = atomicAdd(s_qn, 1);
    s_queue[slot] = static_cast<uint16_t>(w0 + i);
  }
}

// Index of the first accept entry >= x, in [0, n].  The loop count
// depends on n only, so every lane of a warp runs the same steps.
__device__ inline int lower_bound(const uint32_t* __restrict__ a, int n,
                                  uint32_t x) {
  const uint32_t* base = a;
  int len = n;
  while (len > 1) {
    const int half = len >> 1;
    base = (__ldg(base + half) < x) ? base + half : base;
    len -= half;
  }
  return static_cast<int>(base - a) + (__ldg(base) < x ? 1 : 0);
}

// The verify phase for one queued window: rebuilds the tuple from the
// staged codes, drops the window if a code is invalid, searches dim
// exactly and, on a hit, gives the drtuple.
__device__ inline bool verify_window(const WindowParams& w,
                                     const uint8_t* s_buf, int wl,
                                     const uint32_t* __restrict__ accept,
                                     const uint32_t* __restrict__ pfil,
                                     int n_accept, uint32_t* dr) {
  uint64_t fwd = 0, rc = 0;
  uint32_t any = 0;
  for (int j = 0; j < w.TL; ++j) {
    const uint32_t b = s_buf[wl + j];
    any |= b;
    fwd = (fwd << 2) | b;
    rc = (rc >> 2) | (static_cast<uint64_t>(b ^ 3u) << w.rc_shift);
  }
  if (any > 3u) return false;
  const uint64_t uni = fwd <= rc ? fwd : rc;
  const uint32_t dim = static_cast<uint32_t>(uni >> w.dim_shift) & w.dim_mask;
  const int pos = lower_bound(accept, n_accept, dim);
  if (pos >= n_accept || __ldg(accept + pos) != dim) return false;
  const uint64_t top = (uni >> w.top_shift) & w.outer_mask;
  const uint64_t right = uni & w.outer_mask;
  *dr = static_cast<uint32_t>(((top << w.outer_bits) | right) << w.pf_bits) +
        __ldg(pfil + pos);
  return true;
}

inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// Shared memory of K1: codes[2][tile+32] | bitmap | queue u16[tile].
size_t compact_smem(int filter_words) {
  constexpr size_t tile = kTile;
  return 2 * (tile + kHalo) + align16(4 * static_cast<size_t>(filter_words)) +
         2 * tile;
}

// Shared memory of K2: K1's, then dr u32[tile] | keep u8[tile].
size_t full_smem(int filter_words) {
  constexpr size_t tile = kTile;
  return compact_smem(filter_words) + 4 * tile + tile;
}

__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
sketch_compact_kernel(const uint8_t* __restrict__ codes, long long n_codes,
                      long long nwin, const uint32_t* __restrict__ accept,
                      const uint32_t* __restrict__ pfil, int n_accept,
                      const uint32_t* __restrict__ filter, int filter_words,
                      const WindowParams w, uint32_t* __restrict__ out_dr,
                      int32_t* __restrict__ out_pos,
                      unsigned long long* __restrict__ counter,
                      long long capacity) {
  constexpr int kBuf = kTile + kHalo;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* s_codes = smem;
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(smem + 2 * kBuf);
  uint16_t* s_queue = reinterpret_cast<uint16_t*>(
      smem + 2 * kBuf + ((4 * filter_words + 15) & ~15));
  __shared__ int s_qn;
  __shared__ unsigned s_wcnt[2][kWarps];   // by the round's parity
  __shared__ unsigned long long s_base;

  const int tid = threadIdx.x;
  const unsigned lane = tid & 31u;
  const unsigned warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const bool aligned = (reinterpret_cast<uintptr_t>(codes) & 15u) == 0;
  const long long ntiles = (nwin + kTile - 1) / kTile;

  for (int i = tid; i < filter_words; i += kThreads) s_bits[i] = filter[i];
  long long tile = blockIdx.x;
  int cur = 0;
  stage_tile(codes, n_codes, tile * kTile, aligned, s_codes);
  for (; tile < ntiles; tile += gridDim.x, cur ^= 1) {
    cp_async_wait_all();
    if (tid == 0) s_qn = 0;
    __syncthreads();
    const long long next = tile + gridDim.x;
    if (next < ntiles)
      stage_tile(codes, n_codes, next * kTile, aligned,
                          s_codes + (cur ^ 1) * kBuf);
    const uint8_t* buf = s_codes + cur * kBuf;
    const long long tile_start = tile * kTile;
    scan_tile(w, buf, s_bits, tile_start, nwin, s_queue, &s_qn);
    __syncthreads();
    const int qn = s_qn;
    // rounds of one candidate per thread; the barriers are reached by
    // every thread of the block in every round
    for (int c0 = 0, par = 0; c0 < qn; c0 += kThreads, par ^= 1) {
      const int c = c0 + tid;
      bool keep = false;
      uint32_t dr = 0;
      int wl = 0;
      if (c < qn) {
        wl = s_queue[c];
        keep = verify_window(w, buf, wl, accept, pfil, n_accept, &dr);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) s_wcnt[par][warp] = __popc(ballot);
      const int total = __syncthreads_count(keep);
      if (total == 0) continue;       // the same on every thread
      if (tid == 0)
        s_base = atomicAdd(counter, static_cast<unsigned long long>(total));
      __syncthreads();
      if (keep) {
        unsigned before = __popc(ballot & lanes_below);
        for (unsigned v = 0; v < warp; ++v) before += s_wcnt[par][v];
        const unsigned long long slot = s_base + before;
        if (slot < static_cast<unsigned long long>(capacity)) {
          out_dr[slot] = dr;
          if (out_pos != nullptr)
            out_pos[slot] = static_cast<int32_t>(tile_start + wl);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
sketch_full_kernel(const uint8_t* __restrict__ codes, long long n_codes,
                   long long nwin, const uint32_t* __restrict__ accept,
                   const uint32_t* __restrict__ pfil, int n_accept,
                   const uint32_t* __restrict__ filter, int filter_words,
                   const WindowParams w, uint32_t* __restrict__ out_dr,
                   int32_t* __restrict__ out_keep) {
  constexpr int kBuf = kTile + kHalo;
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* s_codes = smem;
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(smem + 2 * kBuf);
  unsigned char* after_bits = smem + 2 * kBuf + ((4 * filter_words + 15) & ~15);
  uint16_t* s_queue = reinterpret_cast<uint16_t*>(after_bits);
  uint32_t* s_dr = reinterpret_cast<uint32_t*>(after_bits + 2 * kTile);
  uint8_t* s_keep = after_bits + 2 * kTile + 4 * kTile;
  __shared__ int s_qn;

  const int tid = threadIdx.x;
  const bool aligned = (reinterpret_cast<uintptr_t>(codes) & 15u) == 0;
  const bool out_aligned =
      ((reinterpret_cast<uintptr_t>(out_dr) |
        reinterpret_cast<uintptr_t>(out_keep)) & 15u) == 0;
  const long long ntiles = (nwin + kTile - 1) / kTile;

  for (int i = tid; i < filter_words; i += kThreads) s_bits[i] = filter[i];
  long long tile = blockIdx.x;
  int cur = 0;
  stage_tile(codes, n_codes, tile * kTile, aligned, s_codes);
  for (; tile < ntiles; tile += gridDim.x, cur ^= 1) {
    cp_async_wait_all();
    if (tid == 0) s_qn = 0;
    __syncthreads();
    const long long next = tile + gridDim.x;
    if (next < ntiles)
      stage_tile(codes, n_codes, next * kTile, aligned,
                          s_codes + (cur ^ 1) * kBuf);
    const uint8_t* buf = s_codes + cur * kBuf;
    const long long tile_start = tile * kTile;
    // the staged output tile: every window dropped until verified
    for (int i = tid * 4; i < kTile; i += kThreads * 4)
      *reinterpret_cast<uint4*>(s_dr + i) =
          make_uint4(kDropped, kDropped, kDropped, kDropped);
    *reinterpret_cast<uint4*>(s_keep + tid * 16) = make_uint4(0, 0, 0, 0);
    scan_tile(w, buf, s_bits, tile_start, nwin, s_queue, &s_qn);
    __syncthreads();
    const int qn = s_qn;
    for (int c = tid; c < qn; c += kThreads) {
      const int wl = s_queue[c];
      uint32_t dr;
      if (verify_window(w, buf, wl, accept, pfil, n_accept, &dr)) {
        s_dr[wl] = dr;
        s_keep[wl] = 1;
      }
    }
    __syncthreads();
    for (int i = tid * 4; i < kTile; i += kThreads * 4) {
      const long long g = tile_start + i;
      if (g >= nwin) break;
      const uint4 v = *reinterpret_cast<const uint4*>(s_dr + i);
      const uint32_t kb = *reinterpret_cast<const uint32_t*>(s_keep + i);
      const int4 kv = make_int4(kb & 0xFFu, (kb >> 8) & 0xFFu,
                                (kb >> 16) & 0xFFu, kb >> 24);
      if (out_aligned && g + 4 <= nwin) {
        *reinterpret_cast<uint4*>(out_dr + g) = v;
        *reinterpret_cast<int4*>(out_keep + g) = kv;
      } else {
        const uint32_t dv[4] = {v.x, v.y, v.z, v.w};
        const int kk[4] = {kv.x, kv.y, kv.z, kv.w};
        for (int e = 0; e < 4 && g + e < nwin; ++e) {
          out_dr[g + e] = dv[e];
          out_keep[g + e] = kk[e];
        }
      }
    }
  }
}

// Grid: at most one resident wave of blocks; each block walks tiles so
// the bitmap is staged once per block, not once per tile.
template <class Kernel>
cudaError_t launch_shape(Kernel kernel, long long nwin, size_t smem,
                         int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long ntiles = (nwin + kTile - 1) / kTile;
  const long long wave = static_cast<long long>(per_sm) * sms;
  *grid = static_cast<int>(ntiles < wave ? ntiles : wave);
  return cudaSuccess;
}

// The largest bitmap, 2^19 bits (64 KiB), leaves room for two blocks to
// an SM; the default of a 4096-entry table, 2^18 bits, for three or four.
constexpr int kMaxFilterLog2 = 19;

bool bad_args(long long nwin, int n_accept, int filter_log2, int k,
              int subk) {
  return nwin <= 0 || n_accept < 1 || 2 * k > kMaxTL || k < 1 ||
         subk < 1 || filter_log2 < 4 || filter_log2 > kMaxFilterLog2 ||
         filter_log2 > 4 * subk;
}

inline int filter_words_of(int filter_log2) {
  return filter_log2 <= 5 ? 1 : 1 << (filter_log2 - 5);
}

cudaError_t launch_compact(const void* codes, long long n_codes,
                           long long nwin, const void* accept,
                           const void* pfil, int n_accept, const void* filter,
                           int words, const WindowParams& w, void* out_dr,
                           void* out_pos, void* counter, long long capacity,
                           cudaStream_t stream) {
  int grid = 0;
  const size_t smem = compact_smem(words);
  cudaError_t err = launch_shape(sketch_compact_kernel, nwin, smem, &grid);
  if (err != cudaSuccess) return err;
  sketch_compact_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(codes), n_codes, nwin,
      static_cast<const uint32_t*>(accept),
      static_cast<const uint32_t*>(pfil), n_accept,
      static_cast<const uint32_t*>(filter), words, w,
      static_cast<uint32_t*>(out_dr), static_cast<int32_t*>(out_pos),
      static_cast<unsigned long long*>(counter), capacity);
  return cudaGetLastError();
}

cudaError_t launch_full(const void* codes, long long n_codes, long long nwin,
                        const void* accept, const void* pfil, int n_accept,
                        const void* filter, int words, const WindowParams& w,
                        void* out_dr, void* out_keep, cudaStream_t stream) {
  int grid = 0;
  const size_t smem = full_smem(words);
  cudaError_t err = launch_shape(sketch_full_kernel, nwin, smem, &grid);
  if (err != cudaSuccess) return err;
  sketch_full_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(codes), n_codes, nwin,
      static_cast<const uint32_t*>(accept),
      static_cast<const uint32_t*>(pfil), n_accept,
      static_cast<const uint32_t*>(filter), words, w,
      static_cast<uint32_t*>(out_dr), static_cast<int32_t*>(out_keep));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch.  `filter` is the bitmap of
// 2^filter_log2 bits (32-bit words, at least one; at most 2^19 bits): bit
// dim of every accepted dim when filter_log2 == 4*subk, bit
// (dim * 0x9E3779B1 mod 2^32) >> (32 - filter_log2) otherwise.  The caller
// zeroes *counter, sizes out_dr/out_pos to `capacity`, and passes
// out_pos = NULL when positions are not wanted.
int mkssd_sketch_compact(const void* codes, long long n_codes,
                         long long nwin, const void* accept,
                         const void* pfil, int n_accept, const void* filter,
                         int filter_log2, int k, int subk, int drlevel,
                         void* out_dr, void* out_pos, void* counter,
                         long long capacity, void* stream) {
  if (bad_args(nwin, n_accept, filter_log2, k, subk))
    return cudaErrorInvalidValue;
  const WindowParams w = make_params(k, subk, drlevel, filter_log2);
  const int words = filter_words_of(filter_log2);
  return launch_compact(codes, n_codes, nwin, accept, pfil, n_accept, filter,
                        words, w, out_dr, out_pos, counter, capacity,
                        static_cast<cudaStream_t>(stream));
}

// out_dr and out_keep hold nwin entries each.
int mkssd_sketch_full(const void* codes, long long n_codes, long long nwin,
                      const void* accept, const void* pfil, int n_accept,
                      const void* filter, int filter_log2, int k, int subk,
                      int drlevel, void* out_dr, void* out_keep,
                      void* stream) {
  if (bad_args(nwin, n_accept, filter_log2, k, subk))
    return cudaErrorInvalidValue;
  const WindowParams w = make_params(k, subk, drlevel, filter_log2);
  const int words = filter_words_of(filter_log2);
  return launch_full(codes, n_codes, nwin, accept, pfil, n_accept, filter,
                     words, w, out_dr, out_keep,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
