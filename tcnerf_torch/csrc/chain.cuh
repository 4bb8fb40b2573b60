// Shared device code of the port's two residual-chain kernels (resmlp.cu,
// swg.cu): a persistent, warp-specialised 128-wide residual-MLP engine on
// Hopper's wgmma.
//
// Roles. A CTA has three warpgroups and stays resident (one per SM), walking
// "pairs" of 128 rows with a static stride over the grid. Warpgroups 0 and
// 1 are consumers, each owning 64 rows of the pair. In the producer
// warpgroup, one lane of warp 8 streams the chain's layers through a ring
// of RING_STAGES shared-memory slots (1-D cp.async.bulk, mbarrier full/empty
// pairs), and warps 9-11 load the next pair's inputs (rows, or bilinear
// taps) while the consumers compute the current pair. setmaxnreg moves
// registers from the producers (64 each) to the consumers (216 each), which
// hold the stream, the accumulator and the A fragments (160 registers).
//
// Product. A 128x128 layer is 8 wgmma.m64n128k16 per warpgroup: A, the
// activated stream in bf16, from registers; B, the weights, from shared
// memory in the canonical K-major 128-byte-swizzled layout that the host
// builds once (ops/resmlp.py `swizzle_index`). The accumulator layout of
// columns 16k..16k+15 is the A-fragment layout of k-step k, so the stream
// never leaves registers.
//
// Overlap. The two warpgroups take turns at the tensor cores (named
// barriers, the ping-pong of FlashAttention-3): one issues its layer's
// products while the other runs its epilogue (bias, bf16 rounding,
// activation, pack).
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
constexpr int NT = HID / 8;              // n-tiles of 8 columns
constexpr int KT = HID / 16;             // k-steps of 16
constexpr int MAX_OUT = 8;               // readout width limit (one n-tile)
constexpr int LDW = HID + 8;             // padded smem row (readout, row tiles)

constexpr int THREADS = 384;             // 2 consumer + 1 producer warpgroups
constexpr int CONSUMERS = 256;
constexpr int RING_WARP = 8, INPUT_WARP = 9, INPUT_WARPS = 3;
// A CTA of 384 threads starts with 168 registers each (65,536 / 384, in
// steps of 8); setmaxnreg.inc blocks until the producers' decrease has
// freed what the consumers ask for.
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 64, CONSUMER_REGS = 216;
static_assert(CONSUMERS * (CONSUMER_REGS - LAUNCH_REGS) <=
                  (THREADS - CONSUMERS) * (LAUNCH_REGS - PRODUCER_REGS),
              "setmaxnreg: the consumers ask for more than the producers free");
constexpr int PAIR_ROWS = 128;           // rows per CTA step, 64 per warpgroup

constexpr int RING_STAGES = 3;
constexpr int LAYER_BYTES = HID * HID * 2;           // swizzled bf16 weights
constexpr int STAGE_BYTES = LAYER_BYTES + HID * 4;   // + f32 bias
constexpr int SLOT_BYTES = 33 * 1024;    // slots stay 1024-aligned (swizzle atom)

// named barriers (0 is __syncthreads): the two ping-pong turns, one per
// consumer warpgroup, and the input warps'
constexpr int BAR_TURN = 1, BAR_WG = 3, BAR_INPUT = 5;

struct Pipe {
  uint64_t full[RING_STAGES], empty[RING_STAGES];  // weight ring
  uint64_t in_full, in_empty;            // the pair's inputs (warps 9-11)
};

// [1024-aligned] ring slots | readout [MAX_OUT][LDW] bf16 | its bias
// [MAX_OUT] f32 | Pipe | kernel region (1024-aligned)
constexpr int RING_SMEM = RING_STAGES * SLOT_BYTES;
constexpr int REGION_OFFSET =
    (RING_SMEM + MAX_OUT * LDW * 2 + MAX_OUT * 4 + (int)sizeof(Pipe) + 1023) /
    1024 * 1024;
// dynamic shared memory to request for a kernel region of `bytes`
constexpr int smem_bytes(int region) { return 1024 + REGION_OFFSET + region; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

struct Smem {
  unsigned char* ring;
  bf16* wro;
  float* bro;
  Pipe* pipe;
  unsigned char* region;
  __device__ explicit Smem(unsigned char* raw) {
    unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    ring = base;
    wro = reinterpret_cast<bf16*>(base + RING_SMEM);
    bro = reinterpret_cast<float*>(wro + MAX_OUT * LDW);
    pipe = reinterpret_cast<Pipe*>(bro + MAX_OUT);
    region = base + REGION_OFFSET;
  }
};

// ---------------------------------------------------------------- barriers

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(b)),
               "r"(bytes)
               : "memory");
}
// Wait for the phase of parity `parity` to complete. A wait of more than
// ~2^34 cycles (seconds) can only be a protocol fault: trap, so that the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// generic-proxy shared-memory writes -> visible to wgmma / bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 1-D bulk copy global -> shared, completion counted on `bar` in bytes.
// src, dst and bytes are multiples of 16.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16-byte cp.async (global -> shared), for the gather kernels (gather.cu)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// -------------------------------------------------------------- conversions

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
__device__ __forceinline__ uint32_t pack_relu_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The activation is a compile-time choice: with a run-time flag the elu
// branch (an inlined expm1f) sits at every activation site of the unrolled
// chain.
template <bool ELU>
__device__ __forceinline__ float activate(float x) {
  if constexpr (ELU) return x > 0.f ? x : expm1f(x);
  return fmaxf(x, 0.f);
}
template <bool ELU>
__device__ __forceinline__ uint32_t pack_act(float lo, float hi) {
  if constexpr (ELU) return pack_bf16(activate<true>(lo), activate<true>(hi));
  return pack_relu_bf16(lo, hi);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {   // (lo, hi)
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}
// Round-to-nearest sum of two bf16 pairs. For bf16 inputs this equals
// rounding their f32 sum: the f32 sum is exact unless the exponents differ
// by more than 16, and then the smaller term is far below half an ulp.
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
template <bool ELU>
__device__ __forceinline__ uint32_t act_bf16x2(uint32_t v) {
  if constexpr (ELU) {
    const float2 f = unpack_bf16(v);
    return pack_bf16(activate<true>(f.x), activate<true>(f.y));
  }
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(v), "r"(0u));
  return d;
}

// Accumulator fragments [NT][4] -> A fragments [KT][4] of act(value), bf16.
// Thread (g = lane/4, t = lane%4) of warp w holds rows 16w+g and 16w+g+8,
// columns nt*8 + 2t + {0, 1}.
template <bool ELU>
__device__ __forceinline__ void act_frag(uint32_t (&a)[KT][4],
                                         const float (&h)[NT][4]) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    a[kt][0] = pack_act<ELU>(h[2 * kt][0], h[2 * kt][1]);
    a[kt][1] = pack_act<ELU>(h[2 * kt][2], h[2 * kt][3]);
    a[kt][2] = pack_act<ELU>(h[2 * kt + 1][0], h[2 * kt + 1][1]);
    a[kt][3] = pack_act<ELU>(h[2 * kt + 1][2], h[2 * kt + 1][3]);
  }
}

// -------------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor, K-major, 128-byte swizzle: 8-row groups
// 1024 bytes apart (SBO); the leading offset is unused for this layout.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define TCN_ACC_REGS                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define TCN_ACC_ROW(d, j) \
  "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define TCN_ACC_OUT(d)                                                     \
  TCN_ACC_ROW(d, 0), TCN_ACC_ROW(d, 1), TCN_ACC_ROW(d, 2),                 \
      TCN_ACC_ROW(d, 3), TCN_ACC_ROW(d, 4), TCN_ACC_ROW(d, 5),             \
      TCN_ACC_ROW(d, 6), TCN_ACC_ROW(d, 7), TCN_ACC_ROW(d, 8),             \
      TCN_ACC_ROW(d, 9), TCN_ACC_ROW(d, 10), TCN_ACC_ROW(d, 11),           \
      TCN_ACC_ROW(d, 12), TCN_ACC_ROW(d, 13), TCN_ACC_ROW(d, 14),          \
      TCN_ACC_ROW(d, 15)

// d (+)= A (registers) @ B (descriptor), m64n128k16
__device__ __forceinline__ void wgmma_rs(float (&d)[NT][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TCN_ACC_REGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : TCN_ACC_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d (+)= A (descriptor) @ B (descriptor), m64n128k16
__device__ __forceinline__ void wgmma_ss(float (&d)[NT][4], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TCN_ACC_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : TCN_ACC_OUT(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Keep the compiler from moving accumulator / operand registers across the
// asynchronous wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}
__device__ __forceinline__ void fence_a(uint32_t (&a)[KT][4]) {
#pragma unroll
  for (int k = 0; k < KT; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// The ping-pong: warpgroup wg issues its products only in its turn and
// hands the turn over as soon as they are issued. Warpgroup 1 starts by
// passing the turn to 0; warpgroup 0 ends by taking the last hand-over, so
// every barrier generation is complete when the kernel ends.
__device__ __forceinline__ void turn_begin(int wg) {
  if (wg == 1) named_arrive(BAR_TURN, CONSUMERS);
}
__device__ __forceinline__ void turn_end(int wg) {
  if (wg == 0) named_sync(BAR_TURN, CONSUMERS);
}

// One layer on the tensor cores: acc (+)= A @ W^T, W a swizzled
// [HID][HID] layer at shared address w, A in registers. Waits for the
// products (the epilogue follows).
__device__ __forceinline__ void layer_rs(float (&acc)[NT][4],
                                         uint32_t (&a)[KT][4], uint32_t w,
                                         bool accumulate, int wg) {
  fence_acc(acc);
  fence_a(a);
  named_sync(BAR_TURN + wg, CONSUMERS);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < KT; ++ks)
    wgmma_rs(acc, a[ks],
             sw128_desc(w + (ks >> 2) * (LAYER_BYTES / 2) + (ks & 3) * 32),
             (accumulate || ks > 0) ? 1 : 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  named_arrive(BAR_TURN + (wg ^ 1), CONSUMERS);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  fence_a(a);
}

// The same with A from a swizzled [64][HID] tile at shared address a_tile.
__device__ __forceinline__ void layer_ss(float (&acc)[NT][4], uint32_t a_tile,
                                         uint32_t w, int wg) {
  fence_acc(acc);
  named_sync(BAR_TURN + wg, CONSUMERS);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < KT; ++ks)
    wgmma_ss(acc,
             sw128_desc(a_tile + (ks >> 2) * (LAYER_BYTES / 4) + (ks & 3) * 32),
             sw128_desc(w + (ks >> 2) * (LAYER_BYTES / 2) + (ks & 3) * 32),
             ks > 0 ? 1 : 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  named_arrive(BAR_TURN + (wg ^ 1), CONSUMERS);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
}

// Byte offset of element (m, k) in a swizzled [rows][HID] bf16 tile: two
// 64-column halves, rows of 128 bytes, 16-byte chunk c of row m stored at
// chunk c ^ (m % 8). The host's `swizzle_index` is the same map.
__device__ __forceinline__ int sw128_offset(int m, int k, int rows) {
  return (k >> 6) * rows * 128 + m * 128 +
         ((((k >> 3) & 7) ^ (m & 7)) << 4) + (k & 7) * 2;
}

// ---------------------------------------------------------------- the ring

// Lane 0 of RING_WARP: stream `layers` ring entries (each STAGE_BYTES:
// swizzled weights, then f32 bias) per pair this CTA walks, in order.
__device__ __forceinline__ void ring_producer(const Smem& s,
                                              const unsigned char* wring,
                                              int layers, int n_pairs) {
  uint32_t it = 0;
  for (int p = blockIdx.x; p < n_pairs; p += gridDim.x) {
    for (int l = 0; l < layers; ++l, ++it) {
      const int st = it % RING_STAGES;
      mbar_wait(&s.pipe->empty[st], ((it / RING_STAGES) & 1) ^ 1);
      mbar_expect_tx(&s.pipe->full[st], STAGE_BYTES);
      bulk_g2s(s.ring + st * SLOT_BYTES, wring + (size_t)l * STAGE_BYTES,
               STAGE_BYTES, &s.pipe->full[st]);
    }
  }
}

// A consumer is done reading the pair's inputs from shared memory. The
// proxy fence orders those generic reads before the writes that refill the
// buffer once every consumer has arrived (bulk copies, in the async
// proxy); without it, rows read last could take the next pair's bytes.
__device__ __forceinline__ void release_input(const Smem& s) {
  fence_proxy_async();
  mbar_arrive(&s.pipe->in_empty);
}

// Consumer side of the ring: every consumer thread acquires and releases
// every entry, in the producer's order.
struct Ring {
  const Smem& s;
  uint32_t it = 0;
  __device__ explicit Ring(const Smem& sm) : s(sm) {}
  __device__ const unsigned char* acquire() {
    mbar_wait(&s.pipe->full[it % RING_STAGES], (it / RING_STAGES) & 1);
    return s.ring + (it % RING_STAGES) * SLOT_BYTES;
  }
  __device__ void release() { mbar_arrive(&s.pipe->empty[it++ % RING_STAGES]); }
};

__device__ __forceinline__ const float* slot_bias(const unsigned char* w) {
  return reinterpret_cast<const float*>(w + LAYER_BYTES);
}

// Every thread: barriers (in_full counts `in_arrivals` producer threads),
// the readout weights; then the caller's own set-up and a __syncthreads.
__device__ __forceinline__ void setup(const Smem& s, const bf16* wro,
                                      const float* bro, int out_dim,
                                      int in_arrivals) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < RING_STAGES; ++i) {
      mbar_init(&s.pipe->full[i], 1);
      mbar_init(&s.pipe->empty[i], CONSUMERS);
    }
    mbar_init(&s.pipe->in_full, in_arrivals);
    mbar_init(&s.pipe->in_empty, CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < MAX_OUT * (HID / 8); i += THREADS) {
    const int r = i / (HID / 8), c = (i % (HID / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < out_dim) v = __ldg(reinterpret_cast<const uint4*>(wro + r * HID + c));
    *reinterpret_cast<uint4*>(s.wro + r * LDW + c) = v;
  }
  if (threadIdx.x < MAX_OUT)
    s.bro[threadIdx.x] = (int)threadIdx.x < out_dim ? bro[threadIdx.x] : 0.f;
}

// ---------------------------------------------------------------- epilogues

// Hidden layer: a <- act(acc + bias) in bf16 (rounded first under round_mm,
// which relu's pack makes redundant).
template <bool ELU, bool RM>
__device__ __forceinline__ void epi_hidden(uint32_t (&a)[KT][4],
                                           const float (&acc)[NT][4],
                                           const float* bias, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 b = *reinterpret_cast<const float2*>(bias + nt * 8 + 2 * t);
    float v0 = acc[nt][0] + b.x, v1 = acc[nt][1] + b.y;
    float v2 = acc[nt][2] + b.x, v3 = acc[nt][3] + b.y;
    if (ELU && RM) {
      v0 = round_bf16(v0); v1 = round_bf16(v1);
      v2 = round_bf16(v2); v3 = round_bf16(v3);
    }
    a[nt >> 1][(nt & 1) * 2] = pack_act<ELU>(v0, v1);
    a[nt >> 1][(nt & 1) * 2 + 1] = pack_act<ELU>(v2, v3);
  }
}

// Residual layer: h <- h + (acc + bias), with the roundings of chain_math
// for an f32 stream (the layer output rounded under round_mm).
template <bool RM>
__device__ __forceinline__ void epi_residual(float (&h)[NT][4],
                                             const float (&acc)[NT][4],
                                             const float* bias, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 b = *reinterpret_cast<const float2*>(bias + nt * 8 + 2 * t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float r = acc[nt][i] + ((i & 1) ? b.y : b.x);
      if (RM) r = round_bf16(r);
      h[nt][i] += r;
    }
  }
}

// n_blocks pre-activation residual blocks, h += Wb act(Wa act(h) + ba) + bb,
// each layer one ring entry; f32 stream.
template <bool ELU, bool RM>
__device__ __forceinline__ void chain_blocks(float (&h)[NT][4], Ring& ring,
                                             int n_blocks, int wg, int t) {
  for (int blk = 0; blk < n_blocks; ++blk) {
    uint32_t a[KT][4];
    float acc[NT][4];
    act_frag<ELU>(a, h);
    const unsigned char* w = ring.acquire();
    layer_rs(acc, a, smem_u32(w), false, wg);
    epi_hidden<ELU, RM>(a, acc, slot_bias(w), t);
    ring.release();
    w = ring.acquire();
    layer_rs(acc, a, smem_u32(w), false, wg);
    epi_residual<RM>(h, acc, slot_bias(w), t);
    ring.release();
  }
}

// The same on a bf16 stream (round_mm and round_stream), kept packed as
// bf16 pairs in the A-fragment order (hp[nt][0]: row g, hp[nt][1]: row g+8):
// the residual add is one bf16x2 add on the packed layer output, and the
// next activation one bf16x2 max, a third of the f32 epilogue's work.
template <bool ELU>
__device__ __forceinline__ void chain_blocks_bf16(uint32_t (&hp)[NT][2],
                                                  Ring& ring, int n_blocks,
                                                  int wg, int t) {
  for (int blk = 0; blk < n_blocks; ++blk) {
    uint32_t a[KT][4];
    float acc[NT][4];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      a[kt][0] = act_bf16x2<ELU>(hp[2 * kt][0]);
      a[kt][1] = act_bf16x2<ELU>(hp[2 * kt][1]);
      a[kt][2] = act_bf16x2<ELU>(hp[2 * kt + 1][0]);
      a[kt][3] = act_bf16x2<ELU>(hp[2 * kt + 1][1]);
    }
    const unsigned char* w = ring.acquire();
    layer_rs(acc, a, smem_u32(w), false, wg);
    epi_hidden<ELU, true>(a, acc, slot_bias(w), t);
    ring.release();
    w = ring.acquire();
    layer_rs(acc, a, smem_u32(w), false, wg);
    const float* bias = slot_bias(w);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 b = *reinterpret_cast<const float2*>(bias + nt * 8 + 2 * t);
      hp[nt][0] = add_bf16x2(hp[nt][0],
                             pack_bf16(acc[nt][0] + b.x, acc[nt][1] + b.y));
      hp[nt][1] = add_bf16x2(hp[nt][1],
                             pack_bf16(acc[nt][2] + b.x, acc[nt][3] + b.y));
    }
    ring.release();
  }
}

// The chain on the stream h. Under round_stream h holds bf16 values on
// entry (every caller rounds it), so packing it is exact.
template <bool ELU>
__device__ __forceinline__ void run_chain(float (&h)[NT][4], Ring& ring,
                                          int n_blocks, bool round_mm,
                                          bool round_stream, int wg, int t) {
  if (round_stream) {
    uint32_t hp[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      hp[nt][0] = pack_bf16(h[nt][0], h[nt][1]);
      hp[nt][1] = pack_bf16(h[nt][2], h[nt][3]);
    }
    chain_blocks_bf16<ELU>(hp, ring, n_blocks, wg, t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 u = unpack_bf16(hp[nt][0]), v = unpack_bf16(hp[nt][1]);
      h[nt][0] = u.x; h[nt][1] = u.y; h[nt][2] = v.x; h[nt][3] = v.y;
    }
  } else if (round_mm) {
    chain_blocks<ELU, true>(h, ring, n_blocks, wg, t);
  } else {
    chain_blocks<ELU, false>(h, ring, n_blocks, wg, t);
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// relu -> readout (<= 8 columns, one mma.sync n-tile per k-step, per warp);
// o[0..1] = row g, cols 2t..2t+1; o[2..3] = row g+8.
__device__ __forceinline__ void run_readout(const float (&h)[NT][4],
                                            const Smem& s, bool round_mm,
                                            int lane, float (&o)[4]) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[KT][4];
  act_frag<false>(a, h);
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

// out [n][out_dim] <- the readout of rows r0 (o[0..1]) and r1 (o[2..3])
template <class T>
__device__ __forceinline__ void store_readout(T* out, const float (&o)[4],
                                              int r0, int r1, int n,
                                              int out_dim, int t) {
  const int c = 2 * t;
  if (c < out_dim) {
    if (r0 < n) out[(size_t)r0 * out_dim + c] = from_f32<T>(o[0]);
    if (r1 < n) out[(size_t)r1 * out_dim + c] = from_f32<T>(o[2]);
  }
  if (c + 1 < out_dim) {
    if (r0 < n) out[(size_t)r0 * out_dim + c + 1] = from_f32<T>(o[1]);
    if (r1 < n) out[(size_t)r1 * out_dim + c + 1] = from_f32<T>(o[3]);
  }
}

inline int launch_grid(int n_pairs) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return n_pairs < sms ? n_pairs : sms;
}

inline int enable_smem(const void* fn, int bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace tcn
