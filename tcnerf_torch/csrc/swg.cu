// Fused field stage of the serving path: bilinear gather of the
// pre-projected feature image + Fourier pos/dir head + 128-wide residual
// chain + readout, per query. The port of the TPU kernels
//   tcnerf/ops/pallas/swg.py:246 `swg_gather_mlp_t` (mode "head inside", K2)
//   tcnerf/ops/pallas/swg.py:362 `swg_gather_mlp`   (mode "head given", K3).
//
// The TPU kernels sort queries by pixel key so that each block can DMA a
// contiguous window of image rows and gather by one-hot matmuls; on Hopper
// a block simply gathers its queries' four taps straight from global memory
// (the 480x640x128 bf16 image, 79 MB, mostly lives in the 50 MB L2 for a
// raster-ordered chunk), so there is no sort, no window, no overflow and no
// unsort, and the output is written in query order.
//
// What bounds it on the H100: per query the head (128x128) plus 12 chain
// layers (128x128) plus the readout is ~4.3e5 FLOP against ~1 KB of
// gathered taps and ~40 bytes of query I/O, so the tensor cores bound it.
// Design: per warp 16 queries; the encodings (10 octaves by the
// double-angle recurrence, in f32) go through a small per-warp shared tile
// into bf16 A fragments for the head product; the taps are read as 16-byte
// vectors, lerped in f32 and parked in the same per-warp tile to be added
// to the head output in its accumulator layout; the chain then runs on
// registers as in resmlp.cu (chain.cuh).
#include "chain.cuh"

using namespace tcn;

constexpr int LDG = HID + 8;                             // f32 scratch row
constexpr int WARP_SCRATCH = ROWS_PER_WARP * LDG * 4;    // bytes per warp
constexpr int SWG_SMEM = CHAIN_SMEM + HID * 4 + WARPS * WARP_SCRATCH;

template <bool HEAD_INSIDE, bool ELU>
__global__ void __launch_bounds__(THREADS)
swg_kernel(const float* __restrict__ coords, const float* __restrict__ pos,
           const float* __restrict__ dirs, const bf16* __restrict__ h0geo,
           const bf16* __restrict__ img, int img_h, int img_w,
           const bf16* __restrict__ head_t, const float* __restrict__ head_b,
           int n_freq, float base_freq, const bf16* __restrict__ wpack,
           const float* __restrict__ bpack, int n_blocks,
           const bf16* __restrict__ wro, const float* __restrict__ bro,
           int out_dim, int n, bool fast, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  ChainSmem s(smem);
  float* hb = reinterpret_cast<float*>(smem + CHAIN_SMEM);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* scratch = reinterpret_cast<float*>(smem + CHAIN_SMEM + HID * 4 +
                                            warp * WARP_SCRATCH);
  const int row_base = blockIdx.x * ROWS_PER_BLOCK + warp * ROWS_PER_WARP;
  const int r0 = row_base + g, r1 = r0 + 8;

  // block 0's weights stream into ring buffer 0 during the head and gather
  if (n_blocks > 0) fetch_block(s, 0, wpack, bpack, 0);
  stage_readout(s, wro, bro, out_dim);
  float h[NT][4];
  if (HEAD_INSIDE) {
    // the head sits in ring buffer 1, free until run_chain's first barrier
    stage_rows(s.layer(1, 0), head_t, HID, HID);
    stage_f32(hb, head_b, HID, HID);
    __syncthreads();
    // ---- encodings: [16 queries][128] bf16, column f*6*n_freq + k*6 + ch
    // (sin octaves then cos octaves; pos xyz then dir xyz), zero past 12*n_freq
    bf16* enc = reinterpret_cast<bf16*>(scratch);
    for (int i = lane; i < ROWS_PER_WARP * 6; i += 32) {
      const int q = i / 6, ch = i % 6, row = row_base + q;
      float v = 0.f;
      if (row < n) v = ch < 3 ? pos[(size_t)row * 3 + ch] : dirs[(size_t)row * 3 + ch - 3];
      const float xb = v * base_freq;
      float sn = sinf(xb), cs = cosf(xb);
      for (int k = 0; k < n_freq; ++k) {
        enc[q * LDW + k * 6 + ch] = __float2bfloat16_rn(sn);
        enc[q * LDW + (n_freq + k) * 6 + ch] = __float2bfloat16_rn(cs);
        const float s2 = 2.f * sn * cs;
        cs = 1.f - 2.f * sn * sn;
        sn = s2;
      }
    }
    const int used = 12 * n_freq;
    for (int i = lane; i < ROWS_PER_WARP * (HID - used); i += 32) {
      const int q = i / (HID - used), c = used + i % (HID - used);
      enc[q * LDW + c] = __float2bfloat16_rn(0.f);
    }
    __syncwarp();
    uint32_t a[KT][4];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const bf16* e = enc + kt * 16 + 2 * t;
      a[kt][0] = *reinterpret_cast<const uint32_t*>(e + g * LDW);
      a[kt][1] = *reinterpret_cast<const uint32_t*>(e + (g + 8) * LDW);
      a[kt][2] = *reinterpret_cast<const uint32_t*>(e + g * LDW + 8);
      a[kt][3] = *reinterpret_cast<const uint32_t*>(e + (g + 8) * LDW + 8);
    }
    __syncwarp();
    mm_layer(h, a, s.layer(1, 0), lane, true);
  } else {
    // head given: h0_geo [n][128] bf16 (bias already folded in)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * t;
      h[nt][0] = r0 < n ? __bfloat162float(h0geo[(size_t)r0 * HID + c]) : 0.f;
      h[nt][1] = r0 < n ? __bfloat162float(h0geo[(size_t)r0 * HID + c + 1]) : 0.f;
      h[nt][2] = r1 < n ? __bfloat162float(h0geo[(size_t)r1 * HID + c]) : 0.f;
      h[nt][3] = r1 < n ? __bfloat162float(h0geo[(size_t)r1 * HID + c + 1]) : 0.f;
    }
  }

  // ---- bilinear gather, clamps of ops/interpolate.py: one (query, 8-channel
  // chunk) per item, four 16-byte taps, f32 lerp into the scratch tile
  for (int i = lane; i < ROWS_PER_WARP * (HID / 8); i += 32) {
    const int q = i / (HID / 8), c8 = (i % (HID / 8)) * 8, row = row_base + q;
    float cx = 0.f, cy = 0.f;
    if (row < n) {
      cx = __ldg(coords + (size_t)row * 2);
      cy = __ldg(coords + (size_t)row * 2 + 1);
    }
    const float x = fminf(fmaxf(cx, 0.f), img_w - 1.f);
    const float y = fminf(fmaxf(cy, 0.f), img_h - 1.f);
    const float x0 = fminf(fmaxf(floorf(x), 0.f), img_w - 2.f);
    const float y0 = fminf(fmaxf(floorf(y), 0.f), img_h - 2.f);
    const float ax = x - x0, ay = y - y0;
    const bf16* p = img + ((size_t)y0 * img_w + (size_t)x0) * HID + c8;
    const size_t down = (size_t)img_w * HID;
    uint4 u00 = __ldg(reinterpret_cast<const uint4*>(p));
    uint4 u01 = __ldg(reinterpret_cast<const uint4*>(p + HID));
    uint4 u10 = __ldg(reinterpret_cast<const uint4*>(p + down));
    uint4 u11 = __ldg(reinterpret_cast<const uint4*>(p + down + HID));
    const bf16* v00 = reinterpret_cast<const bf16*>(&u00);
    const bf16* v01 = reinterpret_cast<const bf16*>(&u01);
    const bf16* v10 = reinterpret_cast<const bf16*>(&u10);
    const bf16* v11 = reinterpret_cast<const bf16*>(&u11);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f00 = __bfloat162float(v00[j]), f01 = __bfloat162float(v01[j]);
      const float f10 = __bfloat162float(v10[j]), f11 = __bfloat162float(v11[j]);
      const float top = f00 + ax * (f01 - f00);
      const float bot = f10 + ax * (f11 - f10);
      scratch[q * LDG + c8 + j] = top + ay * (bot - top);
    }
  }
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = nt * 8 + 2 * t + (i & 1);
      const int q = g + (i >> 1) * 8;
      float v = scratch[q * LDG + c] + h[nt][i];
      if (HEAD_INSIDE) v += hb[c];
      h[nt][i] = fast ? round_bf16(v) : v;
    }
  }

  run_chain<ELU>(h, s, wpack, bpack, n_blocks, fast, fast, lane);

  __syncthreads();   // readout staged at entry; chain may have no blocks
  float o[4];
  run_readout(h, s, fast, lane, o);
  const int c = 2 * t;
  if (c < out_dim) {
    if (r0 < n) out[(size_t)r0 * out_dim + c] = o[0];
    if (r1 < n) out[(size_t)r1 * out_dim + c] = o[2];
  }
  if (c + 1 < out_dim) {
    if (r0 < n) out[(size_t)r0 * out_dim + c + 1] = o[1];
    if (r1 < n) out[(size_t)r1 * out_dim + c + 1] = o[3];
  }
}

template <bool HEAD_INSIDE, bool ELU>
static int launch(const float* coords, const float* pos, const float* dirs,
                  const void* h0geo, const void* img, int img_h, int img_w,
                  const void* head_t, const float* head_b, int n_freq,
                  float base_freq, const void* wpack, const float* bpack,
                  int n_blocks, const void* wro, const float* bro, int out_dim,
                  int n, int fast, float* out, cudaStream_t stream) {
  int err = enable_smem((const void*)swg_kernel<HEAD_INSIDE, ELU>, SWG_SMEM);
  if (err) return err;
  const int grid = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  swg_kernel<HEAD_INSIDE, ELU><<<grid, THREADS, SWG_SMEM, stream>>>(
      coords, pos, dirs, (const bf16*)h0geo, (const bf16*)img, img_h, img_w,
      (const bf16*)head_t, head_b, n_freq, base_freq, (const bf16*)wpack,
      bpack, n_blocks, (const bf16*)wro, bro, out_dim, n, fast != 0, out);
  return (int)cudaGetLastError();
}

// head_inside = 1 (K2): pos/dirs [n][3] f32 are encoded in the kernel and
//   multiplied by head_t [128][128] bf16 (column order of the kernel's
//   encoding tile, zero past 12 * n_freq) plus head_b [128] f32.
// head_inside = 0 (K3): h0geo [n][128] bf16 is the head output.
// coords [n][2] f32 (x, y) into img [img_h][img_w][128] bf16; chain weights
// as in resmlp_launch; out [n][out_dim] f32 in query order.
extern "C" int swg_launch(int head_inside, const float* coords,
                          const float* pos, const float* dirs,
                          const void* h0geo, const void* img, int img_h,
                          int img_w, const void* head_t, const float* head_b,
                          int n_freq, float base_freq, const void* wpack,
                          const float* bpack, int n_blocks, const void* wro,
                          const float* bro, int out_dim, int n, int fast,
                          int elu, float* out, void* stream) {
  auto* fn = head_inside ? (elu ? launch<true, true> : launch<true, false>)
                         : (elu ? launch<false, true> : launch<false, false>);
  return fn(coords, pos, dirs, h0geo, img, img_h, img_w, head_t, head_b,
            n_freq, base_freq, wpack, bpack, n_blocks, wro, bro, out_dim, n,
            fast, out, (cudaStream_t)stream);
}
