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
// (narrowly). Design (chain.cuh): persistent CTAs, the layers streamed
// through a bulk-copy ring by a producer warp, wgmma with the stream in
// registers, and two warpgroups that take turns so one's epilogue runs
// under the other's products. Warp 9 bulk-copies the next pair's 128 input
// rows (skip_input) into a padded tile while the current pair computes, so
// row loads leave the critical path; outputs go straight from registers as
// 4- or 8-byte pairs. The 379-wide input rows of the `fused_field` form
// (758-byte stride, not 16-byte aligned) are read by the consumers
// themselves, element by element, into the input Dense's A fragments: that
// form is on no served path.
#include "chain.cuh"

using namespace tcn;

template <class T>
constexpr int resmlp_region() {
  return PAIR_ROWS * LDW * (int)sizeof(T);   // skip_input row tile
}

template <class T>
__device__ __forceinline__ float load_x(const T* x, int row, int col, int n,
                                        int d) {
  return (row < n && col < d) ? to_f32<T>(x[(size_t)row * d + col]) : 0.f;
}

template <class T> struct Pair2;
template <> struct Pair2<float> {
  __device__ static float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};
template <> struct Pair2<bf16> {
  __device__ static float2 load(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static void store(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// Warp 9 (skip_input): per pair, bulk-copy its rows of x into the padded
// tile [PAIR_ROWS][LDW] once the consumers have read the previous pair.
// (A second tile, to load the next pair's rows while the current ones are
// read, measured no gain.)
template <class T>
__device__ __forceinline__ void row_producer(const Smem& s, T* tile,
                                             const T* x, int n, int n_pairs,
                                             int lane) {
  uint32_t j = 0;
  for (int p = blockIdx.x; p < n_pairs; p += gridDim.x, ++j) {
    mbar_wait(&s.pipe->in_empty, (j & 1) ^ 1);
    const int base = p * PAIR_ROWS;
    const int rows = min(PAIR_ROWS, n - base);
    if (lane == 0) mbar_expect_tx(&s.pipe->in_full, rows * HID * sizeof(T));
    __syncwarp();
    for (int r = lane; r < rows; r += 32)
      bulk_g2s(tile + r * LDW, x + (size_t)(base + r) * HID, HID * sizeof(T),
               &s.pipe->in_full);
    if (lane != 0) mbar_arrive(&s.pipe->in_full);
  }
}

template <class T, bool ELU>
__global__ void __launch_bounds__(THREADS, 1)
resmlp_kernel(const T* __restrict__ x, T* __restrict__ out,
              const unsigned char* __restrict__ wring, int d_in,
              int n_blocks, const bf16* __restrict__ wro,
              const float* __restrict__ bro, int out_dim, int n,
              bool round_mm, bool round_stream) {
  extern __shared__ unsigned char smem_raw[];
  Smem s(smem_raw);
  T* tile = reinterpret_cast<T*>(s.region);
  const int n_pairs = (n + PAIR_ROWS - 1) / PAIR_ROWS;
  const int n_pre = (d_in + HID - 1) / HID;       // input Dense k-chunks
  setup(s, wro, bro, out_dim, 32);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= RING_WARP) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == RING_WARP && lane == 0)
      ring_producer(s, wring, n_pre + 2 * n_blocks, n_pairs);
    else if (warp == INPUT_WARP && d_in == 0)
      row_producer<T>(s, tile, x, n, n_pairs, lane);
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int lrow = wg * 64 + (warp & 3) * 16 + g;   // rows lrow, lrow + 8
  Ring ring(s);
  turn_begin(wg);
  uint32_t j = 0;
  for (int p = blockIdx.x; p < n_pairs; p += gridDim.x, ++j) {
    const int r0 = p * PAIR_ROWS + lrow, r1 = r0 + 8;
    float h[NT][4];
    if (d_in == 0) {
      // skip_input: x already is the 128-wide hidden stream
      mbar_wait(&s.pipe->in_full, j & 1);
      const T* p0 = tile + lrow * LDW + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 u = Pair2<T>::load(p0 + nt * 8);
        const float2 v = Pair2<T>::load(p0 + 8 * LDW + nt * 8);
        h[nt][0] = u.x; h[nt][1] = u.y; h[nt][2] = v.x; h[nt][3] = v.y;
      }
      release_input(s);
    } else {
      // input Dense, one ring entry per 128-wide k-chunk of W0 (zero past
      // d_in); its bias rides in the last chunk's entry
      uint32_t a[KT][4];
      const unsigned char* w = nullptr;
      for (int c = 0; c < n_pre; ++c) {
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          const int col = c * HID + kt * 16 + 2 * t;
          a[kt][0] = pack_bf16(load_x(x, r0, col, n, d_in), load_x(x, r0, col + 1, n, d_in));
          a[kt][1] = pack_bf16(load_x(x, r1, col, n, d_in), load_x(x, r1, col + 1, n, d_in));
          a[kt][2] = pack_bf16(load_x(x, r0, col + 8, n, d_in), load_x(x, r0, col + 9, n, d_in));
          a[kt][3] = pack_bf16(load_x(x, r1, col + 8, n, d_in), load_x(x, r1, col + 9, n, d_in));
        }
        w = ring.acquire();
        layer_rs(h, a, smem_u32(w), c > 0, wg);
        if (c + 1 < n_pre) ring.release();
      }
      const float* b0 = slot_bias(w);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 b = *reinterpret_cast<const float2*>(b0 + nt * 8 + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = h[nt][i] + ((i & 1) ? b.y : b.x);
          h[nt][i] = round_mm ? round_bf16(v) : v;
        }
      }
      ring.release();
    }

    run_chain<ELU>(h, ring, n_blocks, round_mm, round_stream, wg, t);

    if (out_dim > 0) {
      float o[4];
      run_readout(h, s, round_mm, lane, o);
      store_readout<T>(out, o, r0, r1, n, out_dim, t);
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = nt * 8 + 2 * t;
        if (r0 < n) Pair2<T>::store(out + (size_t)r0 * HID + c, h[nt][0], h[nt][1]);
        if (r1 < n) Pair2<T>::store(out + (size_t)r1 * HID + c, h[nt][2], h[nt][3]);
      }
    }
  }
  turn_end(wg);
}

template <class T, bool ELU>
static int launch(const void* x, void* out, const void* wring, int d_in,
                  int n_blocks, const void* wro, const float* bro,
                  int out_dim, int n, int round_mm, int round_stream,
                  cudaStream_t stream) {
  constexpr int smem = smem_bytes(resmlp_region<T>());
  int err = enable_smem((const void*)resmlp_kernel<T, ELU>, smem);
  if (err) return err;
  const int n_pairs = (n + PAIR_ROWS - 1) / PAIR_ROWS;
  resmlp_kernel<T, ELU><<<launch_grid(n_pairs), THREADS, smem, stream>>>(
      (const T*)x, (T*)out, (const unsigned char*)wring, d_in, n_blocks,
      (const bf16*)wro, bro, out_dim, n, round_mm != 0, round_stream != 0);
  return (int)cudaGetLastError();
}

// x/out: [n][d_in or 128] and [n][out_dim or 128], both float32 (x_bf16 = 0)
// or both bfloat16 (x_bf16 = 1), 16-byte aligned. d_in = 0: no input Dense
// (skip_input). out_dim = 0: no readout. wring: the packed ring entries
// (ops/resmlp.py `pack_chain`): ceil(d_in / 128) input-Dense chunks, then
// 2 * n_blocks chain layers, each STAGE_BYTES (swizzled bf16 [out][in]
// weights, then the f32 bias). wro [out_dim][128] bf16, bro [out_dim] f32.
// Returns cudaGetLastError() after the launch.
extern "C" int resmlp_launch(const void* x, void* out, int x_bf16,
                             const void* wring, int d_in, int n_blocks,
                             const void* wro, const float* bro, int out_dim,
                             int n, int round_mm, int round_stream, int elu,
                             void* stream) {
  auto* fn = x_bf16 ? (elu ? launch<bf16, true> : launch<bf16, false>)
                     : (elu ? launch<float, true> : launch<float, false>);
  return fn(x, out, wring, d_in, n_blocks, wro, bro, out_dim, n, round_mm,
            round_stream, (cudaStream_t)stream);
}
