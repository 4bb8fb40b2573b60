// Fused field stage of the serving path: bilinear gather of the
// pre-projected feature image + Fourier pos/dir head + 128-wide residual
// chain + readout, per query. The port of the TPU kernels
//   tcnerf/ops/pallas/swg.py:246 `swg_gather_mlp_t` (mode "head inside", K2)
//   tcnerf/ops/pallas/swg.py:362 `swg_gather_mlp`   (mode "head given", K3).
//
// The TPU kernels sort queries by pixel key so that each block can DMA a
// contiguous window of image rows and gather by one-hot matmuls; on Hopper
// the taps are read straight from global memory (the 480x640x128 bf16
// image, 79 MB, mostly lives in the 50 MB L2 for a raster-ordered chunk), so
// there is no sort, no window, no overflow and no unsort, and the output is
// written in query order.
//
// What bounds it on the H100: per query the head (128x128) plus 12 chain
// layers (128x128) plus the readout is ~4.3e5 FLOP against ~1 KB of
// gathered taps and ~40 bytes of query I/O, so the tensor cores bound it.
// Design (chain.cuh): persistent CTAs, two consumer warpgroups that take
// turns at wgmma, the head and chain layers streamed through a bulk-copy
// ring. The three phases that used to run one after another now overlap:
// warps 9-11 gather the next pair's 4 taps per (query, 8 channels) as
// 16-byte vectors and park the f32 lerp in shared memory while the
// consumers run the current pair's chain; each consumer warp writes its
// rows' encodings (inputs loaded a pair ahead; 10 octaves by the
// double-angle recurrence, f32, then bf16) into its warpgroup's swizzled A
// tile, and the head is one shared-memory wgmma layer whose epilogue adds
// the parked lerp and the head bias. The bf16 stream stays packed in
// registers through the chain. (Encodings written by warps 9-11 instead
// overload them: PERF.md has the run.)
#include "chain.cuh"

using namespace tcn;

constexpr int ENC_TILE = 64 * HID * 2;                 // per warpgroup, swizzled
constexpr int FEAT_OFFSET = 2 * ENC_TILE;              // f32 [PAIR_ROWS][LDW]
constexpr int TAP_OFFSET = FEAT_OFFSET + PAIR_ROWS * LDW * 4;
constexpr int TAP_BYTES = PAIR_ROWS * 12;              // pixel, ax, ay per query
constexpr int SWG_REGION = TAP_OFFSET + 2 * TAP_BYTES;   // two pairs' worth

// Warps 9-11, for pair p: each query's top-left tap pixel and fractions
// (the clamps of ops/interpolate.py) into one of the two tap buffers.
__device__ __forceinline__ void tap_params(unsigned char* buf, int p,
                                           const float* __restrict__ coords,
                                           int img_h, int img_w, int n,
                                           int pt) {
  int* pix = reinterpret_cast<int*>(buf);
  float* fx = reinterpret_cast<float*>(pix + PAIR_ROWS);
  float* fy = fx + PAIR_ROWS;
  const int base = p * PAIR_ROWS;
  for (int q = pt; q < PAIR_ROWS; q += INPUT_WARPS * 32) {
    float cx = 0.f, cy = 0.f;
    if (base + q < n) {
      cx = __ldg(coords + (size_t)(base + q) * 2);
      cy = __ldg(coords + (size_t)(base + q) * 2 + 1);
    }
    const float x = fminf(fmaxf(cx, 0.f), img_w - 1.f);
    const float y = fminf(fmaxf(cy, 0.f), img_h - 1.f);
    const float x0 = fminf(fmaxf(floorf(x), 0.f), img_w - 2.f);
    const float y0 = fminf(fmaxf(floorf(y), 0.f), img_h - 2.f);
    pix[q] = (int)y0 * img_w + (int)x0;
    fx[q] = x - x0;
    fy[q] = y - y0;
  }
}

// Warps 9-11: per pair, once the consumers have read the previous one,
// the bilinear lerp of the 4 taps in f32, plus h0_geo in the head-given
// mode, into feat [PAIR_ROWS][LDW]. The next pair's taps are located while
// the consumers still read this one's. (An L2 prefetch of the next pair's
// taps, and 4 items in flight a thread in place of 2, were measured and
// gave nothing or lost; PERF.md has the runs.)
template <bool HEAD_INSIDE>
__device__ __forceinline__ void gather_producer(
    const Smem& s, const float* __restrict__ coords,
    const bf16* __restrict__ h0geo, const bf16* __restrict__ img, int img_h,
    int img_w, int n, int n_pairs, int pt) {
  constexpr int NP = INPUT_WARPS * 32;                // gathering threads
  constexpr int ITEMS = PAIR_ROWS * (HID / 8);        // (query, 8 channels)
  constexpr int U = 2;                                // items in flight a thread
  float* feat = reinterpret_cast<float*>(s.region + FEAT_OFFSET);
  const size_t down = (size_t)img_w * HID;
  if (blockIdx.x < n_pairs)
    tap_params(s.region + TAP_OFFSET, blockIdx.x, coords, img_h, img_w, n, pt);
  uint32_t j = 0;
  for (int p = blockIdx.x; p < n_pairs; p += gridDim.x, ++j) {
    // this pair's tap buffer is written; the other one is free again
    named_sync(BAR_INPUT, NP);
    if (p + (int)gridDim.x < n_pairs)
      tap_params(s.region + TAP_OFFSET + ((j + 1) & 1) * TAP_BYTES,
                 p + gridDim.x, coords, img_h, img_w, n, pt);
    const int* pix =
        reinterpret_cast<const int*>(s.region + TAP_OFFSET + (j & 1) * TAP_BYTES);
    const float* fx = reinterpret_cast<const float*>(pix + PAIR_ROWS);
    const float* fy = fx + PAIR_ROWS;
    const int base = p * PAIR_ROWS;
    mbar_wait(&s.pipe->in_empty, (j & 1) ^ 1);
    for (int i0 = pt; i0 < ITEMS; i0 += NP * U) {
      uint4 tap[U][4];
      uint4 geo[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int item = min(i0 + u * NP, ITEMS - 1);
        const int q = item >> 4, c8 = (item & 15) * 8;
        const bf16* pp = img + (size_t)pix[q] * HID + c8;
        tap[u][0] = __ldg(reinterpret_cast<const uint4*>(pp));
        tap[u][1] = __ldg(reinterpret_cast<const uint4*>(pp + HID));
        tap[u][2] = __ldg(reinterpret_cast<const uint4*>(pp + down));
        tap[u][3] = __ldg(reinterpret_cast<const uint4*>(pp + down + HID));
        if (!HEAD_INSIDE) {
          geo[u] = make_uint4(0, 0, 0, 0);
          if (base + q < n)
            geo[u] = __ldg(reinterpret_cast<const uint4*>(
                h0geo + (size_t)(base + q) * HID + c8));
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int item = i0 + u * NP;
        if (item >= ITEMS) break;
        const int q = item >> 4, c8 = (item & 15) * 8;
        const float ax = fx[q], ay = fy[q];
        const bf16* v00 = reinterpret_cast<const bf16*>(&tap[u][0]);
        const bf16* v01 = reinterpret_cast<const bf16*>(&tap[u][1]);
        const bf16* v10 = reinterpret_cast<const bf16*>(&tap[u][2]);
        const bf16* v11 = reinterpret_cast<const bf16*>(&tap[u][3]);
        const bf16* vg = reinterpret_cast<const bf16*>(&geo[u]);
        float v[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float f00 = __bfloat162float(v00[c]), f01 = __bfloat162float(v01[c]);
          const float f10 = __bfloat162float(v10[c]), f11 = __bfloat162float(v11[c]);
          const float top = f00 + ax * (f01 - f00);
          const float bot = f10 + ax * (f11 - f10);
          v[c] = top + ay * (bot - top);
          if (!HEAD_INSIDE) v[c] += __bfloat162float(vg[c]);
        }
        float4* dst = reinterpret_cast<float4*>(feat + q * LDW + c8);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
    mbar_arrive(&s.pipe->in_full);
  }
}

// A consumer warp's 16 rows x 6 channels of encoding inputs (pos xyz, dir
// xyz) for pair p, 3 per lane (item lane + 32 u: row item / 6, channel
// item % 6); zero past n. Loaded a pair ahead, so the loads' latency hides
// under the chain.
__device__ __forceinline__ void load_enc_inputs(float (&v)[3],
                                                const float* __restrict__ pos,
                                                const float* __restrict__ dirs,
                                                int row_base, int n,
                                                int lane) {
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    const int i = lane + 32 * u, ch = i % 6, row = row_base + i / 6;
    v[u] = 0.f;
    if (row < n)
      v[u] = ch < 3 ? pos[(size_t)row * 3 + ch] : dirs[(size_t)row * 3 + ch - 3];
  }
}

// The warp's rows of the encoding tile: column f*6*n_freq + k*6 + ch (sin
// octaves then cos octaves; pos xyz then dir xyz), bf16, in the
// warpgroup's swizzled [64][HID] tile; columns past 12 * n_freq stay zero
// from the set-up.
__device__ __forceinline__ void encode_rows(unsigned char* tile,
                                            const float (&v)[3], int m_base,
                                            int n_freq, float base_freq,
                                            int lane) {
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    const int i = lane + 32 * u, ch = i % 6, m = m_base + i / 6;
    const float xb = v[u] * base_freq;
    float sn = sinf(xb), cs = cosf(xb);
    for (int k = 0; k < n_freq; ++k) {
      *reinterpret_cast<bf16*>(tile + sw128_offset(m, k * 6 + ch, 64)) =
          __float2bfloat16_rn(sn);
      *reinterpret_cast<bf16*>(tile + sw128_offset(m, (n_freq + k) * 6 + ch, 64)) =
          __float2bfloat16_rn(cs);
      const float s2 = 2.f * sn * cs;
      cs = 1.f - 2.f * sn * sn;
      sn = s2;
    }
  }
}

template <bool HEAD_INSIDE, bool ELU>
__global__ void __launch_bounds__(THREADS, 1)
swg_kernel(const float* __restrict__ coords, const float* __restrict__ pos,
           const float* __restrict__ dirs, const bf16* __restrict__ h0geo,
           const bf16* __restrict__ img, int img_h, int img_w,
           const unsigned char* __restrict__ wring, int n_freq,
           float base_freq, int n_blocks, const bf16* __restrict__ wro,
           const float* __restrict__ bro, int out_dim, int n, bool fast,
           float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  Smem s(smem_raw);
  const int n_pairs = (n + PAIR_ROWS - 1) / PAIR_ROWS;
  setup(s, wro, bro, out_dim, INPUT_WARPS * 32);
  if (HEAD_INSIDE) {
    for (int i = threadIdx.x; i < 2 * ENC_TILE / 16; i += THREADS)
      reinterpret_cast<uint4*>(s.region)[i] = make_uint4(0, 0, 0, 0);
    fence_proxy_async();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= RING_WARP) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == RING_WARP) {
      if (lane == 0)
        ring_producer(s, wring, (HEAD_INSIDE ? 1 : 0) + 2 * n_blocks, n_pairs);
    } else {
      gather_producer<HEAD_INSIDE>(s, coords, h0geo, img, img_h, img_w, n,
                                   n_pairs, threadIdx.x - INPUT_WARP * 32);
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int warp_row = wg * 64 + (warp & 3) * 16;    // the warp's 16 rows
  const int lrow = warp_row + g;                     // rows lrow, lrow + 8
  const float* feat = reinterpret_cast<const float*>(s.region + FEAT_OFFSET);
  unsigned char* enc = s.region + wg * ENC_TILE;
  float ev[3];
  if (HEAD_INSIDE)
    load_enc_inputs(ev, pos, dirs, blockIdx.x * PAIR_ROWS + warp_row, n, lane);
  Ring ring(s);
  turn_begin(wg);
  uint32_t j = 0;
  for (int p = blockIdx.x; p < n_pairs; p += gridDim.x, ++j) {
    const int r0 = p * PAIR_ROWS + lrow, r1 = r0 + 8;
    float h[NT][4];
    const float* f0 = feat + lrow * LDW + 2 * t;
    if (HEAD_INSIDE) {
      encode_rows(enc, ev, warp_row - wg * 64, n_freq, base_freq, lane);
      load_enc_inputs(ev, pos, dirs, (p + gridDim.x) * PAIR_ROWS + warp_row, n,
                      lane);
      fence_proxy_async();
      named_sync(BAR_WG + wg, 128);
      const unsigned char* w = ring.acquire();
      layer_ss(h, smem_u32(enc), smem_u32(w), wg);
      mbar_wait(&s.pipe->in_full, j & 1);
      const float* hb = slot_bias(w) + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 u = *reinterpret_cast<const float2*>(f0 + nt * 8);
        const float2 v = *reinterpret_cast<const float2*>(f0 + 8 * LDW + nt * 8);
        const float2 b = *reinterpret_cast<const float2*>(hb + nt * 8);
        const float x[4] = {u.x + h[nt][0] + b.x, u.y + h[nt][1] + b.y,
                            v.x + h[nt][2] + b.x, v.y + h[nt][3] + b.y};
#pragma unroll
        for (int i = 0; i < 4; ++i) h[nt][i] = fast ? round_bf16(x[i]) : x[i];
      }
      ring.release();
    } else {
      // head given: feat already holds lerp + h0_geo
      mbar_wait(&s.pipe->in_full, j & 1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 u = *reinterpret_cast<const float2*>(f0 + nt * 8);
        const float2 v = *reinterpret_cast<const float2*>(f0 + 8 * LDW + nt * 8);
        const float x[4] = {u.x, u.y, v.x, v.y};
#pragma unroll
        for (int i = 0; i < 4; ++i) h[nt][i] = fast ? round_bf16(x[i]) : x[i];
      }
    }
    release_input(s);

    run_chain<ELU>(h, ring, n_blocks, fast, fast, wg, t);

    float o[4];
    run_readout(h, s, fast, lane, o);
    store_readout<float>(out, o, r0, r1, n, out_dim, t);
  }
  turn_end(wg);
}

template <bool HEAD_INSIDE, bool ELU>
static int launch(const float* coords, const float* pos, const float* dirs,
                  const void* h0geo, const void* img, int img_h, int img_w,
                  const void* wring, int n_freq, float base_freq,
                  int n_blocks, const void* wro, const float* bro,
                  int out_dim, int n, int fast, float* out,
                  cudaStream_t stream) {
  constexpr int smem = smem_bytes(SWG_REGION);
  int err = enable_smem((const void*)swg_kernel<HEAD_INSIDE, ELU>, smem);
  if (err) return err;
  const int n_pairs = (n + PAIR_ROWS - 1) / PAIR_ROWS;
  swg_kernel<HEAD_INSIDE, ELU><<<launch_grid(n_pairs), THREADS, smem, stream>>>(
      coords, pos, dirs, (const bf16*)h0geo, (const bf16*)img, img_h, img_w,
      (const unsigned char*)wring, n_freq, base_freq, n_blocks,
      (const bf16*)wro, bro, out_dim, n, fast != 0, out);
  return (int)cudaGetLastError();
}

// head_inside = 1 (K2): pos/dirs [n][3] f32 are encoded in the kernel; the
//   ring's first entry is the head (its [128][128] weights in the column
//   order of the kernel's encoding tile, zero past 12 * n_freq, and its
//   bias), then 2 * n_blocks chain layers (ops/swg.py `pack_swg`).
// head_inside = 0 (K3): h0geo [n][128] bf16 is the head output; the ring
//   holds the chain layers only.
// coords [n][2] f32 (x, y) into img [img_h][img_w][128] bf16; wro/bro the
// readout as in resmlp_launch; out [n][out_dim] f32 in query order.
extern "C" int swg_launch(int head_inside, const float* coords,
                          const float* pos, const float* dirs,
                          const void* h0geo, const void* img, int img_h,
                          int img_w, const void* wring, int n_freq,
                          float base_freq, int n_blocks, const void* wro,
                          const float* bro, int out_dim, int n, int fast,
                          int elu, float* out, void* stream) {
  auto* fn = head_inside ? (elu ? launch<true, true> : launch<true, false>)
                         : (elu ? launch<false, true> : launch<false, false>);
  return fn(coords, pos, dirs, h0geo, img, img_h, img_w, wring, n_freq,
            base_freq, n_blocks, wro, bro, out_dim, n, fast, out,
            (cudaStream_t)stream);
}
