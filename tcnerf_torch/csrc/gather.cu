// Four gather kernels: the ports of the TPU gather probes K4-K13 in
// tools/bench_gather{2,3,4}.py. Each computes its probe's function through
// the Hopper analogue of the probe's mechanism, since the mechanism is what
// the probe measures:
//
//   G1 gather_rows         out[q] = table[idx[q]], straight from global memory
//                          (K4 pallas_dma_gather, bench_gather2.py:66).
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
// What bounds them on the H100: G1-G3 move bytes and do no arithmetic, so
// device memory bounds them (each output row written once, each input read
// once). G4 does 2 * N * WIN * 128 operations on purpose to move the same
// bytes as G2; at WIN 512 and 2048 the bf16 tensor-core rate bounds it.
//
// G1 and G2 copy opaque 16-byte vectors, so they take f32 and bf16 rows
// alike. Row indices outside the table or window are outside the function;
// G1 and G2 clamp them to the last row and G3 wraps them mod 128, so a stray
// index cannot read outside the inputs. G4 gives a zero row for them.
#include "chain.cuh"

using namespace tcn;

namespace {

constexpr int MAX_SMEM = 232448;           // a block's opt-in shared memory

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// ---------------------------------------------------------------- G1
// Each warp copies whole rows with 16-byte vector loads and stores, lane i
// taking vectors i, i + 32, ...; the warps stride over the queries.
constexpr int ROWS_THREADS = 256;

__global__ void __launch_bounds__(ROWS_THREADS)
gather_rows_kernel(const uint4* __restrict__ table, const int* __restrict__ idx,
                   uint4* __restrict__ out, int n, int vecs, unsigned n_rows) {
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * (ROWS_THREADS / 32);
  for (int q = (blockIdx.x * ROWS_THREADS + threadIdx.x) >> 5; q < n;
       q += n_warps) {
    const unsigned r = min((unsigned)__ldg(idx + q), n_rows - 1);
    const uint4* src = table + (size_t)r * vecs;
    uint4* dst = out + (size_t)q * vecs;
    for (int c = lane; c < vecs; c += 32) dst[c] = __ldg(src + c);
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
constexpr unsigned FULL = 0xffffffffu;

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
// out[N, 128] = onehot(idx)[N, WIN] @ win[WIN, 128] with mma.sync m16n8k16,
// bf16 operands, f32 accumulation. The one-hot A fragment is built in
// registers from the row's index (no memory read). B, the window, streams
// through shared memory in k-slices of 64 rows over a 4-deep cp.async ring
// (a [2048, 128] window is 512 KB and does not fit), rows padded to 136
// elements so that ldmatrix.trans (B is row-major [k][n]; the mma wants it
// "col") reads 8 rows on distinct banks. Each warp owns 32 rows (two
// m-tiles) and all 128 columns, so each B fragment feeds two mma.sync.
// Every output element is 1.0 * x plus zeros in f32: exact.
constexpr int OH_WARPS = 8, OH_THREADS = OH_WARPS * 32, OH_MT = 2;
constexpr int OH_ROWS = OH_WARPS * OH_MT * 16;      // 256 rows per CTA
constexpr int KS = 64;                              // window rows per slice
constexpr int STAGES = 4;
constexpr int LDB = HID + 8;
constexpr int SLICE = KS * LDB;                     // elements
constexpr int OH_SMEM = STAGES * SLICE * 2;         // 69,632 bytes

__device__ __forceinline__ void fetch_slice(bf16* dst, const bf16* win, int s,
                                            int n_slices, int win_rows) {
  if (s < n_slices) {
    const int r0 = s * KS, rows = min(KS, win_rows - r0);
    for (int i = threadIdx.x; i < rows * (HID / 8); i += OH_THREADS) {
      const int r = i / (HID / 8), c = (i % (HID / 8)) * 8;
      cp_async16(dst + r * LDB + c, win + (size_t)(r0 + r) * HID + c);
    }
  }
  cp_async_commit();             // an empty group past the end keeps counts
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

__global__ void __launch_bounds__(OH_THREADS)
gather_onehot_kernel(const bf16* __restrict__ win, const int* __restrict__ idx,
                     bf16* __restrict__ out, int n, int win_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * OH_ROWS + warp * OH_MT * 16;
  int id[OH_MT][2];                                 // rows g and g + 8
#pragma unroll
  for (int mt = 0; mt < OH_MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + mt * 16 + 8 * h + g;
      id[mt][h] = r < n ? __ldg(idx + r) : -1;     // -1 matches no column
    }
  float acc[OH_MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < OH_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  // ldmatrix x4: lanes 8m..8m+7 address the rows of matrix m = (k half,
  // n half) of a 16 x 16 block: regs 0, 1 = b0, b1 of n-tile 2p; 2, 3 of 2p+1
  const int m = lane >> 3;
  const int lrow = (m & 1) * 8 + (lane & 7), lcol = (m >> 1) * 8;
  const int n_slices = (win_rows + KS - 1) / KS;
  for (int s = 0; s < STAGES - 1; ++s)
    fetch_slice(ring + s * SLICE, win, s, n_slices, win_rows);
  for (int s = 0; s < n_slices; ++s) {
    cp_async_wait<STAGES - 2>();   // slice s landed (this thread's copies)
    __syncthreads();               // ... everyone's, and slice s-1 is done
    fetch_slice(ring + ((s + STAGES - 1) % STAGES) * SLICE, win,
                s + STAGES - 1, n_slices, win_rows);
    const bf16* b = ring + (s % STAGES) * SLICE;
    const int kts = min(KS, win_rows - s * KS) / 16;
    for (int kt = 0; kt < kts; ++kt) {
      const int k0 = s * KS + kt * 16 + 2 * t;
      uint32_t a[OH_MT][4];
#pragma unroll
      for (int mt = 0; mt < OH_MT; ++mt) {
        a[mt][0] = onehot_pair(id[mt][0] - k0);
        a[mt][1] = onehot_pair(id[mt][1] - k0);
        a[mt][2] = onehot_pair(id[mt][0] - k0 - 8);
        a[mt][3] = onehot_pair(id[mt][1] - k0 - 8);
      }
      const bf16* bk = b + (kt * 16 + lrow) * LDB + lcol;
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t f[4];
        ldsm_x4_trans(f, bk + p * 16);
#pragma unroll
        for (int mt = 0; mt < OH_MT; ++mt) {
          mma_bf16(acc[mt][2 * p], a[mt], f[0], f[1]);
          mma_bf16(acc[mt][2 * p + 1], a[mt], f[2], f[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < OH_MT; ++mt) {
    const int r0 = row0 + mt * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (r0 < n)
        *reinterpret_cast<uint32_t*>(out + (size_t)r0 * HID + c) =
            pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
      if (r1 < n)
        *reinterpret_cast<uint32_t*>(out + (size_t)r1 * HID + c) =
            pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

}  // namespace

// All pointers are device pointers, 16-byte aligned; idx is int32; n > 0.
// Each returns cudaGetLastError() after its launch (or a cudaError for a
// shape it does not take).

// table [n_rows][row_bytes], out [n][row_bytes]; row_bytes a multiple of 16.
extern "C" int gather_rows_launch(const void* table, const int* idx, void* out,
                                  int n, int n_rows, int row_bytes,
                                  void* stream) {
  if (row_bytes % 16 || n_rows < 1) return (int)cudaErrorInvalidValue;
  const int blocks_needed = (n + ROWS_THREADS / 32 - 1) / (ROWS_THREADS / 32);
  const int grid = min(blocks_needed, sm_count() * (2048 / ROWS_THREADS));
  gather_rows_kernel<<<grid, ROWS_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)table, idx, (uint4*)out, n, row_bytes / 16,
      (unsigned)n_rows);
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

// win [win_rows][128] bf16 with win_rows a multiple of 16; idx [n];
// out [n][128] bf16.
extern "C" int gather_onehot_launch(const void* win, const int* idx, void* out,
                                    int n, int win_rows, void* stream) {
  if (win_rows < 16 || win_rows % 16) return (int)cudaErrorInvalidValue;
  int err = enable_smem((const void*)gather_onehot_kernel, OH_SMEM);
  if (err) return err;
  const int grid = (n + OH_ROWS - 1) / OH_ROWS;
  gather_onehot_kernel<<<grid, OH_THREADS, OH_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)win, idx, (bf16*)out, n, win_rows);
  return (int)cudaGetLastError();
}
