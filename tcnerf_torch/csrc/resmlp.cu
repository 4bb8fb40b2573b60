// Fused residual-MLP chain over rows: the port of the TPU kernel
// tcnerf/ops/pallas/resmlp.py:137 `resmlp_rows` (body `_chain_kernel` :78,
// math `chain_math` :41).
//
// Computes, per row: an optional input Dense (d_in -> 128), n_blocks
// pre-activation residual blocks h += Wb act(Wa act(h) + ba) + bb, and an
// optional relu -> readout Dense (128 -> out_dim <= 8).
//
// What bounds it on the H100: at the main path's 1,048,576 x 128 rows with
// 3 blocks (the `_pallas_chain` half) it does 2 * 6 * 128^2 = 197 kFLOP per
// row against 512 bytes of row traffic (bf16 in + out): ~384 FLOP/byte,
// above the card's ~295 FLOP/byte ridge, so the tensor cores bound it
// (narrowly). Design: every row is read once and written once, in 16-byte
// coalesced accesses through a per-warp shared tile (scattered 2-byte
// accesses in the accumulator layout cost ~40% of the kernel); the hidden
// stream never leaves registers (mma.sync accumulators feed the next layer
// directly, chain.cuh), and only the weights go through shared memory, a
// two-deep cp.async ring that fetches the next residual block from L2 while
// the current one computes. bf16 operands, f32 accumulation. Measured
// limit now: each layer waits for the previous one's epilogue with only two
// warpgroups per SM (wgmma in place of mma.sync was no faster).
#include "chain.cuh"

using namespace tcn;

// Rows in and out of the register stream go through a per-warp shared tile
// of [ROWS_PER_WARP][LDT] elements, so that global memory sees 16-byte
// coalesced accesses instead of the accumulator layout's scattered pairs.
constexpr int LDT = HID + 8;
constexpr int IO_TILE_SMEM = ROWS_PER_WARP * LDT * 4;   // bytes, f32 or bf16

// h <- rows [row0, row0 + 16) of a row-major [n][HID] matrix of T (zero past
// n). src must be 16-byte aligned. Warp-level: all lanes call it.
template <class T>
__device__ __forceinline__ void load_rows(float (&h)[NT][4], const T* src,
                                          int row0, int n, T* tile,
                                          int lane) {
  constexpr int VEC = 16 / sizeof(T), CHUNKS = HID / VEC;
  for (int i = lane; i < ROWS_PER_WARP * CHUNKS; i += 32) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * VEC;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < n)
      v = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HID + c));
    *reinterpret_cast<uint4*>(tile + r * LDT + c) = v;
  }
  __syncwarp();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const T* p = tile + g * LDT + nt * 8 + 2 * t;
    h[nt][0] = to_f32<T>(p[0]);
    h[nt][1] = to_f32<T>(p[1]);
    h[nt][2] = to_f32<T>(p[8 * LDT]);
    h[nt][3] = to_f32<T>(p[8 * LDT + 1]);
  }
  __syncwarp();
}

// Rows [row0, row0 + 16) of a row-major [n][HID] matrix of T <- h (rows
// past n are not written). dst must be 16-byte aligned. Warp-level.
template <class T>
__device__ __forceinline__ void store_rows(const float (&h)[NT][4], T* dst,
                                           int row0, int n, T* tile,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    T* p = tile + g * LDT + nt * 8 + 2 * t;
    p[0] = from_f32<T>(h[nt][0]);
    p[1] = from_f32<T>(h[nt][1]);
    p[8 * LDT] = from_f32<T>(h[nt][2]);
    p[8 * LDT + 1] = from_f32<T>(h[nt][3]);
  }
  __syncwarp();
  constexpr int VEC = 16 / sizeof(T), CHUNKS = HID / VEC;
  for (int i = lane; i < ROWS_PER_WARP * CHUNKS; i += 32) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * VEC;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * HID + c) =
          *reinterpret_cast<const uint4*>(tile + r * LDT + c);
  }
}

// chain weights | per-warp row I/O tiles
constexpr int RESMLP_SMEM = CHAIN_SMEM + WARPS * IO_TILE_SMEM;

template <class T>
__device__ __forceinline__ float load_x(const T* x, int row, int col, int n,
                                        int d) {
  return (row < n && col < d) ? to_f32<T>(x[(size_t)row * d + col]) : 0.f;
}

template <class T, bool ELU>
__global__ void __launch_bounds__(THREADS)
resmlp_kernel(const T* __restrict__ x, T* __restrict__ out,
              const bf16* __restrict__ w0, const float* __restrict__ b0,
              int d_in, const bf16* __restrict__ wpack,
              const float* __restrict__ bpack, int n_blocks,
              const bf16* __restrict__ wro, const float* __restrict__ bro,
              int out_dim, int n, bool round_mm, bool round_stream) {
  extern __shared__ __align__(16) unsigned char smem[];
  ChainSmem s(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * ROWS_PER_BLOCK + warp * ROWS_PER_WARP;
  const int r0 = row0 + g, r1 = r0 + 8;
  T* tile = reinterpret_cast<T*>(smem + CHAIN_SMEM + warp * IO_TILE_SMEM);

  // block 0's weights stream into ring buffer 0 while the input loads
  if (n_blocks > 0) fetch_block(s, 0, wpack, bpack, 0);
  if (out_dim > 0) stage_readout(s, wro, bro, out_dim);

  float h[NT][4];
  if (d_in == 0) {
    // skip_input: x already is the 128-wide hidden stream
    load_rows<T>(h, x, row0, n, tile, lane);
  } else {
    // input Dense, K in chunks of 128: W0 [128][d_pad] (zero past d_in)
    // staged chunk-wise in ring buffer 1, free until run_chain's first
    // barrier
    const int d_pad = (d_in + HID - 1) / HID * HID;
    bf16* w0s = s.layer(1, 0);
    uint32_t a[KT][4];
    for (int kc = 0; kc < d_in; kc += HID) {
      __syncthreads();
      stage_rows(w0s, w0 + kc, HID, HID, d_pad);
      __syncthreads();
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const int c = kc + kt * 16 + 2 * t;
        a[kt][0] = pack_bf16(load_x(x, r0, c, n, d_in), load_x(x, r0, c + 1, n, d_in));
        a[kt][1] = pack_bf16(load_x(x, r1, c, n, d_in), load_x(x, r1, c + 1, n, d_in));
        a[kt][2] = pack_bf16(load_x(x, r0, c + 8, n, d_in), load_x(x, r0, c + 9, n, d_in));
        a[kt][3] = pack_bf16(load_x(x, r1, c + 8, n, d_in), load_x(x, r1, c + 9, n, d_in));
      }
      mm_layer(h, a, w0s, lane, kc == 0);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = h[nt][i] + __ldg(b0 + nt * 8 + 2 * t + (i & 1));
        h[nt][i] = round_mm ? round_bf16(v) : v;
      }
    }
  }

  run_chain<ELU>(h, s, wpack, bpack, n_blocks, round_mm, round_stream, lane);

  if (out_dim > 0) {
    __syncthreads();   // readout staged before the chain; make sure it landed
    float o[4];
    run_readout(h, s, round_mm, lane, o);
    const int c = 2 * t;
    if (c < out_dim) {
      if (r0 < n) out[(size_t)r0 * out_dim + c] = from_f32<T>(o[0]);
      if (r1 < n) out[(size_t)r1 * out_dim + c] = from_f32<T>(o[2]);
    }
    if (c + 1 < out_dim) {
      if (r0 < n) out[(size_t)r0 * out_dim + c + 1] = from_f32<T>(o[1]);
      if (r1 < n) out[(size_t)r1 * out_dim + c + 1] = from_f32<T>(o[3]);
    }
  } else {
    store_rows<T>(h, out, row0, n, tile, lane);
  }
}

template <class T, bool ELU>
static int launch(const void* x, void* out, const void* w0, const float* b0,
                  int d_in, const void* wpack, const float* bpack, int n_blocks,
                  const void* wro, const float* bro, int out_dim, int n,
                  int round_mm, int round_stream, cudaStream_t stream) {
  int err = enable_smem((const void*)resmlp_kernel<T, ELU>, RESMLP_SMEM);
  if (err) return err;
  const int grid = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  resmlp_kernel<T, ELU><<<grid, THREADS, RESMLP_SMEM, stream>>>(
      (const T*)x, (T*)out, (const bf16*)w0, b0, d_in, (const bf16*)wpack,
      bpack, n_blocks, (const bf16*)wro, bro, out_dim, n, round_mm != 0,
      round_stream != 0);
  return (int)cudaGetLastError();
}

// x/out: [n][d_in or 128] and [n][out_dim or 128], both float32 (x_bf16 = 0)
// or both bfloat16 (x_bf16 = 1), 16-byte aligned. d_in = 0: no input Dense (skip_input).
// out_dim = 0: no readout. Weights bf16 in [out][in] (w0: [128][d_pad],
// d_pad = d_in rounded up to a multiple of 128, zero past d_in); biases f32.
// Returns cudaGetLastError() after the launch.
extern "C" int resmlp_launch(const void* x, void* out, int x_bf16,
                             const void* w0, const float* b0, int d_in,
                             const void* wpack, const float* bpack,
                             int n_blocks, const void* wro, const float* bro,
                             int out_dim, int n, int round_mm,
                             int round_stream, int elu, void* stream) {
  auto* fn = x_bf16 ? (elu ? launch<bf16, true> : launch<bf16, false>)
                     : (elu ? launch<float, true> : launch<float, false>);
  return fn(x, out, w0, b0, d_in, wpack, bpack, n_blocks, wro, bro, out_dim, n,
            round_mm, round_stream, (cudaStream_t)stream);
}
