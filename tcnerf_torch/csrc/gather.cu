// Four gather kernels: the ports of the TPU gather probes K4-K13 in
// tools/bench_gather{2,3,4}.py. Each computes its probe's function through
// the Hopper analogue of the probe's mechanism, since the mechanism is what
// the probe measures:
//
//   G1 gather_rows         out[q] = table[idx[q]], straight from global
//                          memory (K4 pallas_dma_gather, bench_gather2.py:66).
//   G2 gather_rows_window  out[q] = win[idx[q]], the window staged in shared
//                          memory (K5 pallas_vmem_loop bench_gather2.py:99,
//                          K6 pallas_vmem_take :122, K7 pallas_row_loop
//                          bench_gather3.py:80, K10 pallas_row_loop
//                          bench_gather4.py:87).
//   G3 gather_lanes        out[q, l] = src[q, idx[q, l]] within a 128-wide row,
//                          by lane shuffles (K8 pallas_lane_gather
//                          bench_gather3.py:113, K11 pallas_lane
//                          bench_gather4.py:112, K12 pallas_lane_f32 :138).
//   G4 gather_onehot       out = onehot(idx) @ win on the tensor cores, f32
//                          accumulation, bf16 out (K9 pallas_onehot
//                          bench_gather3.py:161, K13 pallas_onehot
//                          bench_gather4.py:168).
//
// What bounds them on the H100: each moves bytes (each output row written
// once, each input read once), so device memory bounds all four. G4's
// product does arithmetic on purpose, but only the k16 blocks of the window
// that a 16-row tile indexes carry a non-zero one-hot A, so the product it
// executes depends on the indices (about 12% of the dense product at K13's
// 2048-row window, 39% at K9's 512); G1's table is six times the L2, so its
// bound is met only if each touched row comes from device memory once.
//
// G1 and G2 copy opaque 16-byte vectors, so they take f32 and bf16 rows
// alike. Row indices outside the table or window are outside the function;
// G1 and G2 clamp them to the last row and G3 wraps them mod 128, so a stray
// index cannot read outside the inputs. G4 gives a zero row for them.
#include "chain.cuh"

using namespace tcn;

namespace {

constexpr int MAX_SMEM = 232448;           // a block's opt-in shared memory
constexpr unsigned FULL = 0xffffffffu;     // every lane of a warp

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// ---------------------------------------------------------------- G1
// The table (315 MB at K4) is six times the L2 and the indices are random,
// so a direct gather misses L2 on every read: a row that several queries
// touch comes from device memory each time (K4: 524,288 reads of ~251,600
// rows), and the output's stores evict the table's lines. Here the table is
// cut into bands of about a quarter of the L2 (ROWS_BAND_BYTES). Persistent
// CTAs each take a contiguous slice of the queries, in chunks of ROWS_CHUNK:
// the CTA counting-sorts the chunk's (query, row) pairs by band in shared
// memory, then its warps copy the rows in band order, ROWS_UNROLL rows a
// warp at a time, 16-byte vectors per lane. All CTAs start together and
// hold about equal shares of each band, so at any time they read from about
// one band, and a row's re-reads hit L2. The kernel writes the output with
// streaming stores (st.global.cs, evict first), so that it does not push
// the band out of L2, and reads the table with an L2 evict-last policy.
// Device memory bounds it: each touched row read once, each output row
// written once (K4: 258 + 537 MB).
constexpr int ROWS_THREADS = 512, ROWS_WARPS = ROWS_THREADS / 32;
constexpr int ROWS_PER_THREAD = 8;         // chunk entries a thread sorts
constexpr int ROWS_CHUNK = ROWS_THREADS * ROWS_PER_THREAD;
constexpr int ROWS_UNROLL = 4;             // rows a warp copies at a time
constexpr int ROWS_MAX_BANDS = 1024;
constexpr long ROWS_BAND_BYTES = 12L << 20;

__device__ __forceinline__ void st_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.b32 [%0], {%1,%2,%3,%4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint4 ld_keep(const uint4* p, uint64_t policy) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L2::cache_hint.v4.u32 {%0,%1,%2,%3}, [%4], %5;\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

__global__ void __launch_bounds__(ROWS_THREADS, 2)
gather_rows_kernel(const uint4* __restrict__ table, const int* __restrict__ idx,
                   uint4* __restrict__ out, int n, int vecs, unsigned n_rows,
                   unsigned band_rows, int n_bands, int slice) {
  __shared__ int start[ROWS_MAX_BANDS];    // counts, then write cursors
  __shared__ int2 entry[ROWS_CHUNK];       // (query, row), in band order
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint64_t keep;                           // L2 evict-last for the table
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(keep));
  const int q_end = min(n, ((int)blockIdx.x + 1) * slice);
  for (int c0 = (int)blockIdx.x * slice; c0 < q_end; c0 += ROWS_CHUNK) {
    const int len = min(ROWS_CHUNK, q_end - c0);
    for (int b = threadIdx.x; b < n_bands; b += ROWS_THREADS) start[b] = 0;
    __syncthreads();
    unsigned row[ROWS_PER_THREAD];
#pragma unroll
    for (int k = 0; k < ROWS_PER_THREAD; ++k) {
      const int e = threadIdx.x + k * ROWS_THREADS;
      row[k] = e < len ? min((unsigned)__ldg(idx + c0 + e), n_rows - 1) : 0u;
      if (e < len) atomicAdd(start + row[k] / band_rows, 1);
    }
    __syncthreads();
    if (warp == 0) {                       // exclusive scan of the counts
      int carry = 0;
      for (int b0 = 0; b0 < n_bands; b0 += 32) {
        const int v = b0 + lane < n_bands ? start[b0 + lane] : 0;
        int incl = v;
#pragma unroll
        for (int d = 1; d < 32; d *= 2) {
          const int u = __shfl_up_sync(FULL, incl, d);
          if (lane >= d) incl += u;
        }
        if (b0 + lane < n_bands) start[b0 + lane] = carry + incl - v;
        carry += __shfl_sync(FULL, incl, 31);
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ROWS_PER_THREAD; ++k) {
      const int e = threadIdx.x + k * ROWS_THREADS;
      if (e < len)
        entry[atomicAdd(start + row[k] / band_rows, 1)] =
            make_int2(c0 + e, (int)row[k]);
    }
    __syncthreads();
    for (int e0 = warp * ROWS_UNROLL; e0 < len;
         e0 += ROWS_WARPS * ROWS_UNROLL) {
      int2 en[ROWS_UNROLL];
#pragma unroll
      for (int u = 0; u < ROWS_UNROLL; ++u)
        en[u] = e0 + u < len ? entry[e0 + u] : make_int2(-1, 0);
      for (int c = lane; c < vecs; c += 32) {
        uint4 v[ROWS_UNROLL];
#pragma unroll
        for (int u = 0; u < ROWS_UNROLL; ++u)
          if (en[u].x >= 0)
            v[u] = ld_keep(table + (size_t)en[u].y * vecs + c, keep);
#pragma unroll
        for (int u = 0; u < ROWS_UNROLL; ++u)
          if (en[u].x >= 0) st_stream(out + (size_t)en[u].x * vecs + c, v[u]);
      }
    }
    __syncthreads();                       // entry and start are reused
  }
}

// ---------------------------------------------------------------- G2
// A window of win_rows rows does not fit in shared memory whole ([2048, 512]
// bf16 is 2 MB), so it is cut into column slabs of `slab` bytes per row
// (64 bytes: [2048 x 64 B] = 128 KB). The CTAs are persistent: the grid is
// about one CTA per SM, divided among the slabs, and each CTA stages its
// slab once and then walks over its share of the queries, writing the slab's
// part of each output row. `vecs` = slab / 16 threads serve one query.
constexpr int WIN_THREADS = 512;
constexpr int WIN_UNROLL = 4;              // queries in flight per thread
constexpr int MAX_SLAB = 1024;             // bytes; keeps vecs <= 64

__global__ void __launch_bounds__(WIN_THREADS)
gather_window_kernel(const unsigned char* __restrict__ win,
                     const int* __restrict__ idx, unsigned char* __restrict__ out,
                     int n, int win_rows, int row_bytes, int slab,
                     int ctas_per_slab) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x / ctas_per_slab, part = blockIdx.x % ctas_per_slab;
  const int vecs = slab / 16;
  const unsigned char* src = win + (size_t)s * slab;
  for (int i = threadIdx.x; i < win_rows * vecs; i += WIN_THREADS) {
    const int r = i / vecs, c = i % vecs;
    cp_async16(smem + (size_t)i * 16, src + (size_t)r * row_bytes + c * 16);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const uint4* tile = reinterpret_cast<const uint4*>(smem);
  const int per_step = WIN_THREADS / vecs;          // queries per CTA step
  const int c = threadIdx.x % vecs;
  const int step = ctas_per_slab * per_step;
  const size_t row_vecs = row_bytes / 16;
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)s * slab) + c;
  const unsigned last = win_rows - 1;
  for (int q = part * per_step + threadIdx.x / vecs; q < n;
       q += WIN_UNROLL * step) {
    unsigned r[WIN_UNROLL];
#pragma unroll
    for (int u = 0; u < WIN_UNROLL; ++u) {
      const int qq = q + u * step;
      r[u] = qq < n ? min((unsigned)__ldg(idx + qq), last) : 0u;
    }
#pragma unroll
    for (int u = 0; u < WIN_UNROLL; ++u) {
      const int qq = q + u * step;
      if (qq < n) dst[(size_t)qq * row_vecs] = tile[r[u] * vecs + c];
    }
  }
}

// ---------------------------------------------------------------- G3
// One warp per 128-wide row: lane L holds elements 4L..4L+3 and its four
// indices. Output column l takes element idx[l] from lane idx[l] / 4 with
// __shfl_sync; each shuffle sends one of the sender's registers, so the
// receiver fetches every register that can hold slot idx[l] % 4 and selects.
constexpr int LANES_THREADS = 256;

__global__ void __launch_bounds__(LANES_THREADS)
gather_lanes_f32_kernel(const float4* __restrict__ src,
                        const int4* __restrict__ idx, float4* __restrict__ out,
                        int n) {
  const int q = blockIdx.x * (LANES_THREADS / 32) + (threadIdx.x >> 5);
  if (q >= n) return;                               // whole warps leave
  const int lane = threadIdx.x & 31;
  const float4 v = __ldg(src + (size_t)q * 32 + lane);
  const int4 id = __ldg(idx + (size_t)q * 32 + lane);
  const int ids[4] = {id.x, id.y, id.z, id.w};
  float r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = ids[k] & 127, from = j >> 2, slot = j & 3;
    const float a = __shfl_sync(FULL, v.x, from);
    const float b = __shfl_sync(FULL, v.y, from);
    const float c = __shfl_sync(FULL, v.z, from);
    const float d = __shfl_sync(FULL, v.w, from);
    r[k] = slot == 0 ? a : slot == 1 ? b : slot == 2 ? c : d;
  }
  out[(size_t)q * 32 + lane] = make_float4(r[0], r[1], r[2], r[3]);
}

__global__ void __launch_bounds__(LANES_THREADS)
gather_lanes_bf16_kernel(const uint2* __restrict__ src,
                         const int4* __restrict__ idx, uint2* __restrict__ out,
                         int n) {
  const int q = blockIdx.x * (LANES_THREADS / 32) + (threadIdx.x >> 5);
  if (q >= n) return;
  const int lane = threadIdx.x & 31;
  const uint2 v = __ldg(src + (size_t)q * 32 + lane);   // 4 bf16, 2 per word
  const int4 id = __ldg(idx + (size_t)q * 32 + lane);
  const int ids[4] = {id.x, id.y, id.z, id.w};
  uint32_t h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = ids[k] & 127, from = j >> 2, slot = j & 3;
    const uint32_t a = __shfl_sync(FULL, v.x, from);
    const uint32_t b = __shfl_sync(FULL, v.y, from);
    const uint32_t w = (slot & 2) ? b : a;
    h[k] = (slot & 1) ? (w >> 16) : (w & 0xffffu);
  }
  out[(size_t)q * 32 + lane] = make_uint2(h[0] | (h[1] << 16),
                                          h[2] | (h[3] << 16));
}

// ---------------------------------------------------------------- G4
// out[N, 128] = onehot(idx)[N, W] @ win[W, 128] with mma.sync m16n8k16,
// bf16 operands, f32 accumulation. Every output element is 1.0 * x plus
// zeros in f32: exact. The dense product is 2 * N * W * 128 operations (at
// K13 0.42 ms at the bf16 peak, about the library gather's whole time), but
// a k16 block of the window that none of a tile's 16 rows index has an
// all-zero A and adds nothing. So each warp takes 16 rows at a time, finds
// the distinct blocks idx >> 4 of its rows (a __reduce_min_sync loop), and
// multiplies only those: about 15 of K13's 128 blocks, 12 of K9's 32.
//
// The window stays resident in shared memory: cut into column slabs of SW
// columns (the widest that fits: [512 x 128] whole, [2048 x 32] at K13),
// rows padded by 8 elements so that ldmatrix.trans (B is row-major [k][n];
// the mma wants it "col") reads 8 rows on distinct banks. The CTAs are
// persistent, about one per SM, divided among the slabs; each stages its
// slab once, then its warps walk the 16-row tiles and write the slab's
// columns of each output row, through a per-warp staging tile in shared
// memory so that each store is 16 bytes (4-byte stores from the mma
// fragments touch each 32-byte sector twice). The one-hot A fragment is
// built in registers from the rows' indices, which lanes l and l + 16 load
// for row l & 15, one tile ahead; per block only a select remains.
constexpr int OH_PAD = 8;                           // elements per slab row

__host__ __device__ constexpr int oh_warps(int sw) {
  return sw >= 64 ? 16 : 32;
}
// shared memory: the slab, then a 16-row staging tile per warp
__host__ __device__ constexpr long oh_smem(int sw, int win_rows) {
  return (long)(win_rows + oh_warps(sw) * 16) * (sw + OH_PAD) * 2;
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// bf16 pair (1.0 where the row's index hits column k, k + 1), d = index - k
__device__ __forceinline__ uint32_t onehot_pair(int d) {
  return (d == 0 ? 0x3F80u : 0u) | (d == 1 ? 0x3F800000u : 0u);
}

__device__ __forceinline__ int tile_index(const int* idx, int tile, int n,
                                          int lane) {
  const int r = tile * 16 + (lane & 15);
  return r < n ? __ldg(idx + r) : -1;               // -1 matches no column
}

template <int SW>
__global__ void __launch_bounds__(oh_warps(SW) * 32, 1)
gather_onehot_kernel(const bf16* __restrict__ win, const int* __restrict__ idx,
                     bf16* __restrict__ out, int n, int win_rows,
                     int ctas_per_slab) {
  constexpr int WARPS = oh_warps(SW), LDS = SW + OH_PAD, NP = SW / 16;
  constexpr int VR = SW / 8;                        // 16-byte vectors a row
  constexpr int NO_BLOCK = 0x7fffffff;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* slab = reinterpret_cast<bf16*>(smem);
  const int col0 = blockIdx.x / ctas_per_slab * SW;
  const int part = blockIdx.x % ctas_per_slab;
  for (int i = threadIdx.x; i < win_rows * VR; i += WARPS * 32) {
    const int r = i / VR, c = i % VR * 8;
    cp_async16(slab + r * LDS + c, win + (size_t)r * HID + col0 + c);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  bf16* stage = slab + (win_rows + warp * 16) * LDS;
  // ldmatrix x4: lanes 8m..8m+7 address the rows of matrix m = (k half,
  // n half) of a 16 x 16 block: regs 0, 1 = b0, b1 of n-tile 2p; 2, 3 of 2p+1
  const int m = lane >> 3;
  const bf16* bl = slab + ((m & 1) * 8 + (lane & 7)) * LDS + (m >> 1) * 8;
  const int n_tiles = (n + 15) / 16, step = ctas_per_slab * WARPS;
  int tile = part * WARPS + warp;
  int next = tile < n_tiles ? tile_index(idx, tile, n, lane) : -1;
  for (; tile < n_tiles; tile += step) {
    const int mine = next;
    if (tile + step < n_tiles) next = tile_index(idx, tile + step, n, lane);
    const int id0 = __shfl_sync(FULL, mine, g);     // rows g and g + 8
    const int id1 = __shfl_sync(FULL, mine, g + 8);
    float acc[2 * NP][4];
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    // A fragment of each of the lane's two rows if the block is the row's
    // (-1 and W >> 4 match no block of the window): built once per tile
    const int b0 = id0 >> 4, b1 = id1 >> 4;
    const int o0 = (id0 & 15) - 2 * t, o1 = (id1 & 15) - 2 * t;
    const uint32_t f0 = onehot_pair(o0), f1 = onehot_pair(o1),
                   f2 = onehot_pair(o0 - 8), f3 = onehot_pair(o1 - 8);
    int blk = (unsigned)mine < (unsigned)win_rows ? mine >> 4 : NO_BLOCK;
    int kb = __reduce_min_sync(FULL, blk);          // each hit block once
    while (kb != NO_BLOCK) {
      if (blk == kb) blk = NO_BLOCK;
      const int next_kb = __reduce_min_sync(FULL, blk);   // ahead of the mma
      const bool h0 = b0 == kb, h1 = b1 == kb;
      const uint32_t a[4] = {h0 ? f0 : 0u, h1 ? f1 : 0u, h0 ? f2 : 0u,
                             h1 ? f3 : 0u};
      const bf16* bk = bl + kb * 16 * LDS;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        uint32_t f[4];
        ldsm_x4_trans(f, bk + p * 16);
        mma_bf16(acc[2 * p], a, f[0], f[1]);
        mma_bf16(acc[2 * p + 1], a, f[2], f[3]);
      }
      kb = next_kb;
    }
    // out through the warp's staging tile: 16-byte stores of whole sectors
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j) {
      *reinterpret_cast<uint32_t*>(stage + g * LDS + j * 8 + 2 * t) =
          pack_bf16(acc[j][0], acc[j][1]);
      *reinterpret_cast<uint32_t*>(stage + (g + 8) * LDS + j * 8 + 2 * t) =
          pack_bf16(acc[j][2], acc[j][3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = lane; i < 16 * VR; i += 32) {
      const int r = i / VR, c = i % VR * 8, q = tile * 16 + r;
      if (q < n)
        *reinterpret_cast<uint4*>(out + (size_t)q * HID + col0 + c) =
            *reinterpret_cast<const uint4*>(stage + r * LDS + c);
    }
    __syncwarp();                                   // stage is reused
  }
}

template <int SW>
int launch_onehot(const void* win, const int* idx, void* out, int n,
                  int win_rows, cudaStream_t stream) {
  constexpr int WARPS = oh_warps(SW);
  const int smem = (int)oh_smem(SW, win_rows);
  const int err = enable_smem((const void*)gather_onehot_kernel<SW>, smem);
  if (err) return err;
  const int n_slabs = HID / SW, tiles = (n + 15) / 16;
  const int ctas_per_slab = max(1, min(sm_count() / n_slabs,
                                       (tiles + WARPS - 1) / WARPS));
  gather_onehot_kernel<SW><<<n_slabs * ctas_per_slab, WARPS * 32, smem,
                             stream>>>((const bf16*)win, idx, (bf16*)out, n,
                                       win_rows, ctas_per_slab);
  return (int)cudaGetLastError();
}

}  // namespace

// All pointers are device pointers, 16-byte aligned; idx is int32; n > 0.
// Each returns cudaGetLastError() after its launch (or a cudaError for a
// shape it does not take).

// table [n_rows][row_bytes], out [n][row_bytes]; row_bytes a multiple of 16.
// The bands follow from the table's bytes: ROWS_BAND_BYTES each, or more
// where the table would need more than ROWS_MAX_BANDS of them.
extern "C" int gather_rows_launch(const void* table, const int* idx, void* out,
                                  int n, int n_rows, int row_bytes,
                                  void* stream) {
  if (row_bytes % 16 || n_rows < 1) return (int)cudaErrorInvalidValue;
  const long fit = ROWS_BAND_BYTES / row_bytes;
  const long spread = ((long)n_rows + ROWS_MAX_BANDS - 1) / ROWS_MAX_BANDS;
  const long band_rows = fit > spread ? (fit > 1 ? fit : 1) : spread;
  const int n_bands = (int)((n_rows + band_rows - 1) / band_rows);
  const int grid = max(1, min(2 * sm_count(), (n + 255) / 256));
  const int slice = (n + grid - 1) / grid;
  gather_rows_kernel<<<grid, ROWS_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)table, idx, (uint4*)out, n, row_bytes / 16,
      (unsigned)n_rows, (unsigned)band_rows, n_bands, slice);
  return (int)cudaGetLastError();
}

// win [win_rows][row_bytes], out [n][row_bytes]; row_bytes a multiple of 16
// and win_rows * 16 <= 232,448 (one 16-byte slab of every row fits).
extern "C" int gather_window_launch(const void* win, const int* idx,
                                    void* out, int n, int win_rows,
                                    int row_bytes, void* stream) {
  if (row_bytes % 16 || win_rows < 1 || (long)win_rows * 16 > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  int slab = 16;                   // widest power-of-two slab under 128 KB
  while (slab * 2 <= MAX_SLAB && row_bytes % (slab * 2) == 0 &&
         (long)win_rows * slab * 2 <= 131072)
    slab *= 2;
  const int smem = win_rows * slab;
  int err = enable_smem((const void*)gather_window_kernel, smem);
  if (err) return err;
  const int n_slabs = row_bytes / slab;
  const int per_step = WIN_THREADS / (slab / 16);
  const int ctas_per_slab = max(1, min(sm_count() / n_slabs,
                                       (n + per_step - 1) / per_step));
  gather_window_kernel<<<n_slabs * ctas_per_slab, WIN_THREADS, smem,
                         (cudaStream_t)stream>>>(
      (const unsigned char*)win, idx, (unsigned char*)out, n, win_rows,
      row_bytes, slab, ctas_per_slab);
  return (int)cudaGetLastError();
}

// src, out [n][128] of f32 (is_f32 = 1) or bf16; idx [n][128] in [0, 128).
extern "C" int gather_lanes_launch(const void* src, const int* idx, void* out,
                                   int n, int is_f32, void* stream) {
  const int grid = (n + LANES_THREADS / 32 - 1) / (LANES_THREADS / 32);
  if (is_f32)
    gather_lanes_f32_kernel<<<grid, LANES_THREADS, 0, (cudaStream_t)stream>>>(
        (const float4*)src, (const int4*)idx, (float4*)out, n);
  else
    gather_lanes_bf16_kernel<<<grid, LANES_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint2*)src, (const int4*)idx, (uint2*)out, n);
  return (int)cudaGetLastError();
}

// win [win_rows][128] bf16 with win_rows a multiple of 16 whose narrowest
// slab fits in shared memory with its staging tiles (oh_smem(16, win_rows)
// <= 232,448: at most 4,320 rows); idx [n]; out [n][128] bf16.
extern "C" int gather_onehot_launch(const void* win, const int* idx, void* out,
                                    int n, int win_rows, void* stream) {
  auto fits = [&](int sw) { return oh_smem(sw, win_rows) <= MAX_SMEM; };
  if (win_rows < 16 || win_rows % 16 || !fits(16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (fits(128)) return launch_onehot<128>(win, idx, out, n, win_rows, st);
  if (fits(64)) return launch_onehot<64>(win, idx, out, n, win_rows, st);
  if (fits(32)) return launch_onehot<32>(win, idx, out, n, win_rows, st);
  return launch_onehot<16>(win, idx, out, n, win_rows, st);
}
