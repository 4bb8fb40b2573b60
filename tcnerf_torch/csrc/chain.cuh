// Shared device code of the port's two kernels (resmlp.cu, swg.cu): the
// 128-wide residual-MLP chain on bf16 tensor cores.
//
// Layout. A block has 8 warps; each warp owns 16 rows and the whole hidden
// width, kept in registers as the f32 accumulator fragments of
// mma.sync.m16n8k16 (16 n-tiles x 4 floats per thread). The accumulator
// layout of two neighbouring n-tiles is exactly the A-operand layout of one
// k-tile, so a layer's output feeds the next layer's product without a trip
// through shared memory. Weights ([out][in], nn.Linear layout = the "col"
// B operand) go through a two-deep ring in shared memory, one residual
// block (two 128x128 bf16 layers, 2 x 34 KB with padded rows) per stage:
// cp.async fetches block i+1 while block i computes. Rows are padded to
// 136 elements so the B-fragment loads of a warp hit 32 distinct banks.
//
// Numerics mirror tcnerf/ops/pallas/resmlp.py chain_math: bf16 operands,
// f32 accumulation, bias added in f32; `round_mm` rounds every layer output
// to bf16 (the `fast` serving stream), `round_stream` rounds the residual
// stream too (when the stream's own dtype is bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tcn {

typedef __nv_bfloat16 bf16;

constexpr int HID = 128;                 // hidden width (fixed)
constexpr int LDW = HID + 8;             // padded smem row of a staged layer
constexpr int NT = HID / 8;              // n-tiles of 8 columns
constexpr int KT = HID / 16;             // k-tiles of 16
constexpr int WARPS = 8;
constexpr int ROWS_PER_WARP = 16;
constexpr int ROWS_PER_BLOCK = WARPS * ROWS_PER_WARP;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_OUT = 8;               // readout width limit (one n-tile)

constexpr int LAYER_SMEM = HID * LDW * 2;                  // bytes
constexpr int READOUT_SMEM = MAX_OUT * LDW * 2;
constexpr int BIAS_SMEM = (4 * HID + MAX_OUT) * 4;
// ring buffer 0 (layer a, layer b) | ring buffer 1 | readout weights |
// biases (ring 0, ring 1, readout)
constexpr int CHAIN_SMEM = 4 * LAYER_SMEM + READOUT_SMEM + BIAS_SMEM;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The activation is a compile-time choice: with a run-time flag the elu
// branch (an inlined expm1f) sits at every activation site of the
// unrolled chain, and the relu loop turns into a chain of taken branches
// through code larger than the instruction caches.
template <bool ELU>
__device__ __forceinline__ float activate(float x) {
  if constexpr (ELU) return x > 0.f ? x : expm1f(x);
  return fmaxf(x, 0.f);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Accumulator fragments [NT][4] -> A fragments [KT][4] of f(value), in bf16.
// Thread (g = lane/4, t = lane%4) holds rows g and g+8, columns
// nt*8 + 2t + {0, 1}.
template <class F>
__device__ __forceinline__ void to_afrag(uint32_t (&a)[KT][4],
                                         const float (&h)[NT][4], F f) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    a[kt][0] = pack_bf16(f(h[2 * kt][0]), f(h[2 * kt][1]));
    a[kt][1] = pack_bf16(f(h[2 * kt][2]), f(h[2 * kt][3]));
    a[kt][2] = pack_bf16(f(h[2 * kt + 1][0]), f(h[2 * kt + 1][1]));
    a[kt][3] = pack_bf16(f(h[2 * kt + 1][2]), f(h[2 * kt + 1][3]));
  }
}

// acc (+)= A @ W^T for a staged [HID][LDW] layer.
__device__ __forceinline__ void mm_layer(float (&acc)[NT][4],
                                         const uint32_t (&a)[KT][4],
                                         const bf16* w, int lane, bool zero) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (zero) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const bf16* wr = w + (nt * 8 + g) * LDW + 2 * t;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t b0 = *reinterpret_cast<const uint32_t*>(wr + kt * 16);
      uint32_t b1 = *reinterpret_cast<const uint32_t*>(wr + kt * 16 + 8);
      mma_bf16(acc[nt], a[kt], b0, b1);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy `rows` rows of a row-major bf16 global matrix (row stride `ld`
// elements, a multiple of 8) into a padded [rows][LDW] shared buffer,
// HID columns, 16-byte vectors; rows < dst_rows are zero-filled up to
// dst_rows.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int rows, int dst_rows,
                                           int ld = HID) {
  for (int i = threadIdx.x; i < dst_rows * (HID / 8); i += THREADS) {
    const int r = i / (HID / 8), c = (i % (HID / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows) v = __ldg(reinterpret_cast<const uint4*>(src + r * ld + c));
    *reinterpret_cast<uint4*>(dst + r * LDW + c) = v;
  }
}

__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int n, int dst_n) {
  for (int i = threadIdx.x; i < dst_n; i += THREADS)
    dst[i] = i < n ? src[i] : 0.f;
}

struct ChainSmem {
  bf16* w;      // ring: [buffer][layer a, b][HID][LDW]
  bf16* wro;    // [MAX_OUT][LDW]
  float* b;     // ring biases: [buffer][2 * HID]
  float* bro;   // [MAX_OUT]
  __device__ explicit ChainSmem(unsigned char* base) {
    w = reinterpret_cast<bf16*>(base);
    wro = w + 4 * HID * LDW;
    b = reinterpret_cast<float*>(wro + MAX_OUT * LDW);
    bro = b + 4 * HID;
  }
  __device__ bf16* layer(int buf, int l) const {
    return w + (2 * buf + l) * HID * LDW;
  }
  __device__ float* bias(int buf) const { return b + buf * 2 * HID; }
};

// Stage the readout (relu -> Dense(out_dim)) once; caller syncs.
__device__ __forceinline__ void stage_readout(const ChainSmem& s,
                                              const bf16* wro,
                                              const float* bro, int out_dim) {
  stage_rows(s.wro, wro, out_dim, MAX_OUT);
  stage_f32(s.bro, bro, out_dim, MAX_OUT);
}

// Issue (and commit) the cp.async copies of residual block `blk` into ring
// buffer `buf`: two [HID][HID] layers and their 2 * HID biases.
__device__ __forceinline__ void fetch_block(const ChainSmem& s, int buf,
                                            const bf16* wpack,
                                            const float* bpack, int blk) {
  const bf16* src = wpack + (size_t)(2 * blk) * HID * HID;
  bf16* dst = s.layer(buf, 0);
  for (int i = threadIdx.x; i < 2 * HID * (HID / 8); i += THREADS) {
    const int r = i / (HID / 8), c = (i % (HID / 8)) * 8;   // r < 2 * HID
    cp_async16(dst + r * LDW + c, src + r * HID + c);
  }
  for (int i = threadIdx.x; i < 2 * HID / 4; i += THREADS)
    cp_async16(s.bias(buf) + 4 * i, bpack + (size_t)(2 * blk) * HID + 4 * i);
  cp_async_commit();
}

// One residual block on the register stream with staged weights.
template <bool ELU>
__device__ __forceinline__ void residual_block(float (&h)[NT][4],
                                               const bf16* wa, const bf16* wb,
                                               const float* bias,
                                               bool round_mm,
                                               bool round_stream, int lane) {
  const int t = lane & 3;
  uint32_t a[KT][4];
  float acc[NT][4];
  to_afrag(a, h, [](float v) { return activate<ELU>(v); });
  mm_layer(acc, a, wa, lane, true);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = acc[nt][i] + bias[nt * 8 + 2 * t + (i & 1)];
      acc[nt][i] = round_mm ? round_bf16(v) : v;
    }
  }
  to_afrag(a, acc, [](float v) { return activate<ELU>(v); });
  mm_layer(acc, a, wb, lane, true);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float r = acc[nt][i] + bias[HID + nt * 8 + 2 * t + (i & 1)];
      if (round_mm) r = round_bf16(r);
      float v = h[nt][i] + r;
      h[nt][i] = round_stream ? round_bf16(v) : v;
    }
  }
}

// n_blocks pre-activation residual blocks, h += Wb act(Wa act(h) + ba) + bb.
// wpack: [2 * n_blocks][HID][HID] bf16 ([out][in]); bpack: [2 * n_blocks][HID]
// f32. The caller has already issued fetch_block(s, 0, wpack, bpack, 0)
// (when n_blocks > 0), so block 0 streams in while it prepares the input;
// ring buffer 1 may hold other data (a head or input Dense) until the first
// iteration's barrier. Every thread of the block must call this (it
// synchronises).
template <bool ELU>
__device__ __forceinline__ void run_chain(float (&h)[NT][4], const ChainSmem& s,
                                          const bf16* wpack, const float* bpack,
                                          int n_blocks, bool round_mm,
                                          bool round_stream, int lane) {
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int cur = blk & 1;
    __syncthreads();          // everyone is done with the other buffer
    if (blk + 1 < n_blocks) {
      fetch_block(s, cur ^ 1, wpack, bpack, blk + 1);
      cp_async_wait<1>();     // block `blk` landed (this thread's copies)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();          // ... and everyone else's
    residual_block<ELU>(h, s.layer(cur, 0), s.layer(cur, 1), s.bias(cur),
                        round_mm, round_stream, lane);
  }
}

// relu -> staged readout; o[0..1] = row g, cols 2t..2t+1; o[2..3] = row g+8.
__device__ __forceinline__ void run_readout(const float (&h)[NT][4],
                                            const ChainSmem& s, bool round_mm,
                                            int lane, float (&o)[4]) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[KT][4];
  to_afrag(a, h, [](float v) { return fmaxf(v, 0.f); });
  o[0] = o[1] = o[2] = o[3] = 0.f;
  const bf16* wr = s.wro + g * LDW + 2 * t;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t b0 = *reinterpret_cast<const uint32_t*>(wr + kt * 16);
    uint32_t b1 = *reinterpret_cast<const uint32_t*>(wr + kt * 16 + 8);
    mma_bf16(o, a[kt], b0, b1);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = o[i] + s.bro[2 * t + (i & 1)];
    o[i] = round_mm ? round_bf16(v) : v;
  }
}

template <class T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}
template <class T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

inline int enable_smem(const void* fn, int bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace tcn
