// The grasp energy's probe chain (models/grasp.py `GraspEBM.energy_prepared`
// on the corner-gather path, one view), forward and pose-gradient backward.
// It replaces no TPU kernel: the JAX package leaves this part of the energy
// to XLA. Added because the pose ascent spends half its step in f32 GEMMs
// and the other half moving [rows, 128] f32 activations through device
// memory between element-wise kernels (PERF.md §5).
//
// Per probe row (pixel xy, camera-frame position and direction):
//   forward  the corner image's bilinear tap (`bilinear_gather_corners`,
//            same clamps, same roundings), the Fourier encoding (sinf /
//            cosf per octave, `core/encoding.positional_encoding`),
//            layer_0's geometry head plus the tap, the n_blocks residual
//            blocks (pre-activation relu), and the grasp readout's per-probe
//            part: each tapped activation's Dense(64) and activation, then
//            the combined Dense(64) and activation -> out [rows, 64];
//   backward d(out) [rows, 64] -> d(pixel xy, position, direction)
//            [rows, 8] through the transposed products, the relu masks and
//            the readout activation's derivative that the forward saved,
//            the encoding's derivative and the tap's derivative in x and y
//            with the clamps' factors. No weight gradients: the weights
//            are frozen where this runs.
//
// Bound: f32 FFMA (the configuration is float32 and its check admits no
// TF32), ~0.52 MFLOP a row each way; the tap reads 2 KB a row. Design: two
// persistent CTAs of 128 threads on each SM walk tiles of 64 rows, so that
// one CTA's serial phases (the tap's loads, barriers, element-wise passes)
// overlap the other's products. The tile's activations stay in shared
// memory for the whole chain, feature-major ([feature][row], rotated rows:
// `sw`), so a layer's output is the next layer's A operand in place; each
// thread holds an 8 x 8 (or 8 x 4) register block of the product. The
// weights stream from L2 in 8 KB chunks, packed on the host in the order of
// use (ops/probe.py `pack_probe`), double-buffered with cp.async so that a
// chunk lands while the one before is multiplied.
// The readout's combined product accumulates in registers across the
// taps. What the backward needs of the forward is kept small: each relu's
// mask as bits, each thread's 8 x 8 block in a word, and the readout
// activation's derivative, ~1.7 KB a row.
// The next tile's corner rows are prefetched into L2 while a tile computes.
//
// Numerics: float32 storage and FMA throughout; sinf, cosf, expf and
// expm1f of the CUDA math library, as PyTorch's kernels call them; built
// without fast math. The tap's lerp keeps PyTorch's separate roundings.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HID = 128;           // the chain's width
constexpr int DS = 64;             // the readout's downscale width
constexpr int TILE = 64;           // rows per CTA step
constexpr int HALF = TILE / 2;
constexpr int THREADS = 128;       // 16 x 8 threads
constexpr int CTAS = 2;            // resident on each SM
constexpr int WARPS = THREADS / 32;
constexpr int LDA = TILE;          // stride of a [feature][row] buffer
constexpr int CHUNK = 2048;        // floats per weight chunk (8 KB)
constexpr int MAX_TAPS = 4;
constexpr int IN = 8;              // per-row inputs: x, y, position, direction
constexpr unsigned FULL = 0xffffffffu;
typedef unsigned long long u64;

struct Args {
  int n_rows, rows_per_image, height, width;
  int n_blocks, tap0, n_taps, n_freq, elu;
  float base_freq;
  const float* coords;   // [n_rows][2] pixel (x, y)
  const float* pos;      // [n_rows][3]
  const float* dirs;     // [n_rows][3]
  const float* corner;   // [images][H][W][4 * HID]
  const float* stream;   // weight chunks in order of use
  int n_chunks;
  const float* bias;     // forward only
  u64* masks;            // [tiles][2 * n_blocks][THREADS] relu bits (`relu`)
  float* actd;           // [tiles * TILE][DS * (n_taps + 1)] activation'
  float* out;            // forward [n_rows][DS]
  const float* gout;     // backward [n_rows][DS]
  float* gin;            // backward [n_rows][IN]
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// The CTA's walk through the weight stream: chunk number `c` (counted over
// the CTA's whole life) is chunk c % n_chunks, in buffer c & 1.
struct Weights {
  const float* src;
  int n_chunks;
  float* buf;
  int c;
  __device__ void load(int seq) {
    const float4* s =
        reinterpret_cast<const float4*>(src + (size_t)(seq % n_chunks) * CHUNK);
    float* d = buf + (seq & 1) * CHUNK;
    for (int i = threadIdx.x; i < CHUNK / 4; i += THREADS)
      cp_async16(d + 4 * i, s + i);
    cp_async_commit();
  }
};

// A [feature][row] buffer keeps feature f's row r at sw(f, r): each
// feature's rows are rotated by 4 * ((f / 4) % 8), so that the 8 threads of
// an epilogue's 16-byte store phase (8 features 4 apart, one row quad) hit
// 8 different bank quads, while a row quad stays one aligned float4.
__device__ __forceinline__ int sw(int f, int r) {
  return f * LDA + ((r + (((f >> 2) & 7) << 2)) & (TILE - 1));
}

// A thread's register block: rows ty*4 + (0..3) and 32 + ty*4 + (0..3);
// columns tx*4 + (0..3) and, at N = 128, 64 + tx*4 + (0..3).
__device__ __forceinline__ int row_of(int i, int ty) {
  return (i >> 2) * HALF + ty * 4 + (i & 3);
}
template <int N>
__device__ __forceinline__ int col_of(int j, int tx) {
  return N == 128 ? (j & 4) * 16 + tx * 4 + (j & 3) : tx * 4 + j;
}

// acc[i][j] += sum_k A[k][row_of(i)] * B[k][col_of(j)]: A is K features of
// a [feature][row] shared buffer, B the next K * N / CHUNK chunks of the
// weight stream ([k][n] row-major). Starts with a barrier, so what the CTA
// wrote before the call is visible to it. U: groups of 4 features to a
// loop iteration (on an H100 at 516,096 rows the forward, with more code
// around its products, ran faster at 1, the backward at 2).
template <int K, int N, int U>
__device__ __forceinline__ void gemm(const float* A, Weights& w,
                                     float (&acc)[8][N / 16]) {
  constexpr int KC = CHUNK / N;
  static_assert(K % KC == 0 && KC % 4 == 0, "K must be whole chunks");
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k0 = 0; k0 < K; k0 += KC) {
    cp_async_wait_all();
    __syncthreads();
    w.load(w.c + 1);
    const float* B = w.buf + (w.c & 1) * CHUNK + tx * 4;
#pragma unroll (U)
    for (int g = 0; g < KC / 4; ++g) {   // 4 features share a rotation
      const float* a0p = A + sw(k0 + 4 * g, ty * 4);
      const float* a1p = A + sw(k0 + 4 * g, HALF + ty * 4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 a0 = *reinterpret_cast<const float4*>(a0p + u * LDA);
        const float4 a1 = *reinterpret_cast<const float4*>(a1p + u * LDA);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float* b = B + (4 * g + u) * N;
        float bv[N / 16];
        const float4 b0 = *reinterpret_cast<const float4*>(b);
        bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
        if constexpr (N == 128) {
          const float4 b1 = *reinterpret_cast<const float4*>(b + 64);
          bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < N / 16; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    ++w.c;
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[8][NC]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
}

// The thread's block of [feature][row] buffers, a row quad at a time:
// dst(i, j) = f(i, j, src(i, j)) for each (row_of(i), col_of(j)).
template <int N, class F>
__device__ __forceinline__ void update(const float* src, float* dst, F f) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = sw(col_of<N>(j, tx), h * HALF + ty * 4);
      float4 x = *reinterpret_cast<const float4*>(src + o);
      x.x = f(4 * h, j, x.x);
      x.y = f(4 * h + 1, j, x.y);
      x.z = f(4 * h + 2, j, x.z);
      x.w = f(4 * h + 3, j, x.w);
      *reinterpret_cast<float4*>(dst + o) = x;
    }
}
// buf(i, j) = f(i, j), the old values unread
template <int N, class F>
__device__ __forceinline__ void store(float* buf, F f) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(buf + sw(col_of<N>(j, tx), h * HALF + ty * 4)) =
          make_float4(f(4 * h, j), f(4 * h + 1, j), f(4 * h + 2, j),
                      f(4 * h + 3, j));
}

__device__ __forceinline__ float act(float x, int elu) {
  return elu ? (x > 0.f ? x : expm1f(x)) : (x > 0.f ? x : 0.f);
}
// d act / dx as PyTorch's backward computes it (elu: exp(x) where x <= 0)
__device__ __forceinline__ float act_grad(float x, int elu) {
  return elu ? (x <= 0.f ? expf(x) : 1.f) : (x > 0.f ? 1.f : 0.f);
}

// `bilinear_gather`'s stencil: the query clipped into the grid, the floor
// clamped to [0, size - 2], the fractions from the clipped values
__device__ __forceinline__ void stencil(float cx, float cy, int H, int W,
                                        int& idx, float& ax, float& ay) {
  const float x = fminf(fmaxf(cx, 0.f), (float)W - 1.f);
  const float y = fminf(fmaxf(cy, 0.f), (float)H - 1.f);
  const float x0 = fminf(fmaxf(floorf(x), 0.f), (float)W - 2.f);
  const float y0 = fminf(fmaxf(floorf(y), 0.f), (float)H - 2.f);
  ax = x - x0;
  ay = y - y0;
  idx = (int)y0 * W + (int)x0;
}

// the gradient factor of jnp.clip(c, 0, hi): 1 inside, 0 outside, a half
// at each bound it ties (core/bounds.py)
__device__ __forceinline__ float clip_factor(float c, float hi) {
  const float m = fmaxf(c, 0.f);
  const float f0 = c > 0.f ? 1.f : (c == 0.f ? 0.5f : 0.f);
  const float f1 = m < hi ? 1.f : (m == hi ? 0.5f : 0.f);
  return f0 * f1;
}

__device__ __forceinline__ const float* corner_row(const Args& a, int row,
                                                   int idx) {
  const int img = min(row, a.n_rows - 1) / a.rows_per_image;
  return a.corner + ((size_t)img * a.height * a.width + idx) * (4 * HID);
}

// rin[k][r]: x, y, position xyz, direction xyz of the tile's rows (zeros
// past n_rows)
__device__ void load_rows(const Args& a, int row0, float* rin) {
  for (int t = threadIdx.x; t < IN * TILE; t += THREADS) {
    const int r = t & (TILE - 1), k = t / TILE, row = row0 + r;
    float v = 0.f;
    if (row < a.n_rows)
      v = k < 2 ? a.coords[(size_t)row * 2 + k]
                : (k < 5 ? a.pos[(size_t)row * 3 + k - 2]
                         : a.dirs[(size_t)row * 3 + k - 5]);
    rin[t] = v;
  }
}

// the corner rows of tile `tile` into L2 (one thread a row, 16 lines)
__device__ void prefetch_tile(const Args& a, int tile) {
  const int row = tile * TILE + threadIdx.x;
  if (threadIdx.x >= TILE || row >= a.n_rows) return;
  int idx;
  float ax, ay;
  stencil(a.coords[(size_t)row * 2], a.coords[(size_t)row * 2 + 1], a.height,
          a.width, idx, ax, ay);
  const float* src = corner_row(a, row, idx);
#pragma unroll
  for (int l = 0; l < 16; ++l) prefetch_l2(src + l * 32);
}

// X[c][r] = the lerped corner row of each row r (a warp a row pair)
__device__ void gather(const Args& a, int row0, const float* rin, float* X) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r0 = warp * (TILE / WARPS); r0 < (warp + 1) * (TILE / WARPS);
       r0 += 2) {
    float v[2][16], ax[2], ay[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      int idx;
      stencil(rin[r0 + u], rin[TILE + r0 + u], a.height, a.width, idx, ax[u],
              ay[u]);
      const float* src = corner_row(a, row0 + r0 + u, idx) + lane;
#pragma unroll
      for (int k = 0; k < 16; ++k)
        v[u][k] = __ldg(src + (k >> 2) * HID + (k & 3) * 32);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v00 = v[u][q], v01 = v[u][4 + q], v10 = v[u][8 + q],
                    v11 = v[u][12 + q];
        const float top = __fadd_rn(v00, __fmul_rn(ax[u], __fsub_rn(v01, v00)));
        const float bot = __fadd_rn(v10, __fmul_rn(ax[u], __fsub_rn(v11, v10)));
        X[sw(q * 32 + lane, r0 + u)] =
            __fadd_rn(top, __fmul_rn(ay[u], __fsub_rn(bot, top)));
      }
  }
}

// T[d * 2F + 2k + (0: sin, 1: cos)][r] of position (d < 3) and direction
// (d >= 3) channels, octave k (frequency base * 2^k); zero rows past 12 F
__device__ void encode(const Args& a, const float* rin, float* T) {
  const int pd = 12 * a.n_freq;
  for (int t = threadIdx.x; t < 6 * TILE; t += THREADS) {
    const int r = t & (TILE - 1), d = t / TILE;
    const float v = rin[(2 + d) * TILE + r];
    const int f0 = d * 2 * a.n_freq;
    for (int k = 0; k < a.n_freq; ++k) {
      const float s = v * (a.base_freq * (float)(1 << k));
      T[sw(f0 + 2 * k, r)] = sinf(s);
      T[sw(f0 + 2 * k + 1, r)] = cosf(s);
    }
  }
  for (int t = threadIdx.x; t < (HID - pd) * TILE; t += THREADS)
    T[sw(pd + t / TILE, t & (TILE - 1))] = 0.f;
}

// relu(v) of the thread's block element (i, j), and its bit (8 i + j) in
// `bits` where v > 0: the backward's mask of that element
__device__ __forceinline__ float relu(float v, int i, int j, u64& bits) {
  if (v > 0.f) bits |= 1ull << (8 * i + j);
  return v > 0.f ? v : 0.f;
}

__global__ void __launch_bounds__(THREADS, CTAS) probe_fwd_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* X = smem;                  // the residual stream [HID][LDA]
  float* T = X + HID * LDA;         // the A operand [HID][LDA]
  float* rin = T + HID * LDA;       // [IN][TILE]
  Weights w{a.stream, a.n_chunks, rin + IN * TILE, 0};
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_tiles = (a.n_rows + TILE - 1) / TILE;
  const int dw = DS * (a.n_taps + 1);
  w.load(0);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE;
    u64* masks = a.masks ? a.masks + (size_t)tile * 2 * a.n_blocks *
                                              THREADS + threadIdx.x
                              : nullptr;
    __syncthreads();
    load_rows(a, row0, rin);
    __syncthreads();
    gather(a, row0, rin, X);
    encode(a, rin, T);
    if (tile + (int)gridDim.x < n_tiles) prefetch_tile(a, tile + gridDim.x);

    float acc[8][8], cacc[8][4], bj[8];
    zero(cacc);
    zero(acc);
    gemm<HID, HID, 1>(T, w, acc);
    // layer_0: (encoding @ head + bias) + tap, in place of the tap
#pragma unroll
    for (int j = 0; j < 8; ++j) bj[j] = __ldg(a.bias + col_of<HID>(j, tx));
    update<HID>(X, X, [&](int i, int j, float x) {
      return (acc[i][j] + bj[j]) + x;
    });
    for (int b = 0; b < a.n_blocks; ++b) {
      const float* b0 = a.bias + HID + 2 * HID * b;
      u64 bits = 0;
      __syncthreads();
      update<HID>(X, T, [&](int i, int j, float x) {
        return relu(x, i, j, bits);
      });
      if (masks) masks[2 * b * THREADS] = bits;
      zero(acc);
      gemm<HID, HID, 1>(T, w, acc);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 8; ++j) bj[j] = __ldg(b0 + col_of<HID>(j, tx));
      bits = 0;
      store<HID>(T, [&](int i, int j) {
        return relu(acc[i][j] + bj[j], i, j, bits);
      });
      if (masks) masks[(2 * b + 1) * THREADS] = bits;
      zero(acc);
      gemm<HID, HID, 1>(T, w, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) bj[j] = __ldg(b0 + HID + col_of<HID>(j, tx));
      update<HID>(X, X, [&](int i, int j, float x) {
        return x + (acc[i][j] + bj[j]);
      });
      const int tap = b - a.tap0;
      if (tap < 0 || tap >= a.n_taps) continue;
      // the readout's Dense(64) of this activation, its activation, and
      // its share of the combined Dense(64)
      const float* bd = a.bias + HID + 2 * HID * a.n_blocks + DS * tap;
      float s[8][4];
      zero(s);
      gemm<HID, DS, 1>(X, w, s);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += __ldg(bd + col_of<DS>(j, tx));
      store<DS>(T, [&](int i, int j) { return act(s[i][j], a.elu); });
      if (a.actd) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<float4*>(
              a.actd + (size_t)(row0 + row_of(i, ty)) * dw + DS * tap + tx * 4) =
              make_float4(act_grad(s[i][0], a.elu), act_grad(s[i][1], a.elu),
                          act_grad(s[i][2], a.elu), act_grad(s[i][3], a.elu));
      }
      gemm<DS, DS, 1>(T, w, cacc);
    }
    const float* bc = a.bias + HID + 2 * HID * a.n_blocks + DS * a.n_taps;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + row_of(i, ty);
      float c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = cacc[i][j] + __ldg(bc + tx * 4 + j);
      if (row < a.n_rows)
        *reinterpret_cast<float4*>(a.out + (size_t)row * DS + tx * 4) =
            make_float4(act(c[0], a.elu), act(c[1], a.elu), act(c[2], a.elu),
                        act(c[3], a.elu));
      if (a.actd)
        *reinterpret_cast<float4*>(a.actd + (size_t)row * dw + DS * a.n_taps +
                                   tx * 4) =
            make_float4(act_grad(c[0], a.elu), act_grad(c[1], a.elu),
                        act_grad(c[2], a.elu), act_grad(c[3], a.elu));
    }
  }
  cp_async_wait_all();
}

__global__ void __launch_bounds__(THREADS, CTAS) probe_bwd_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* G = smem;                  // d(stream) [HID][LDA]
  float* T = G + HID * LDA;         // the A operand [HID][LDA]
  float* GC = T + HID * LDA;        // d(combined pre-activation) [DS][LDA]
  float* rin = GC + DS * LDA;       // [IN][TILE]
  float* ob = rin + IN * TILE;      // the rows' d(inputs) [IN][TILE]
  Weights w{a.stream, a.n_chunks, ob + IN * TILE, 0};
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (a.n_rows + TILE - 1) / TILE;
  const int dw = DS * (a.n_taps + 1);
  w.load(0);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * TILE;
    const u64* masks =
        a.masks + (size_t)tile * 2 * a.n_blocks * THREADS + tid;
    prefetch_tile(a, tile);         // read again at the tile's end
    __syncthreads();
    load_rows(a, row0, rin);
    for (int t = tid; t < DS * TILE; t += THREADS) {
      const int c = t & (DS - 1), r = t / DS, row = row0 + r;
      GC[sw(c, r)] =
          row < a.n_rows ? a.gout[(size_t)row * DS + c] *
                               a.actd[(size_t)row * dw + DS * a.n_taps + c]
                         : 0.f;
    }
    for (int t = tid; t < HID * TILE; t += THREADS) G[t] = 0.f;

    float acc[8][8];
    for (int b = a.n_blocks - 1; b >= 0; --b) {
      const int tap = b - a.tap0;
      if (tap >= 0 && tap < a.n_taps) {
        // d(tapped activation) += Wd^T (act' * (Wc_tap^T d(combined)))
        float s[8][4];
        zero(s);
        gemm<DS, DS, 2>(GC, w, s);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 d = __ldg(reinterpret_cast<const float4*>(
              a.actd + (size_t)(row0 + row_of(i, ty)) * dw + DS * tap + tx * 4));
          s[i][0] *= d.x;
          s[i][1] *= d.y;
          s[i][2] *= d.z;
          s[i][3] *= d.w;
        }
        store<DS>(T, [&](int i, int j) { return s[i][j]; });
        zero(acc);
        gemm<DS, HID, 2>(T, w, acc);
        update<HID>(G, G, [&](int i, int j, float g) { return g + acc[i][j]; });
      }
      // block b: d(z) = relu'(z) * W1^T d(out); d(in) = d(out) +
      // relu'(in) * W0^T d(z)
      u64 bits = __ldg(masks + (2 * b + 1) * THREADS);
      zero(acc);
      gemm<HID, HID, 2>(G, w, acc);
      store<HID>(T, [&](int i, int j) {
        return (bits >> (8 * i + j) & 1) ? acc[i][j] : 0.f;
      });
      bits = __ldg(masks + 2 * b * THREADS);
      zero(acc);
      gemm<HID, HID, 2>(T, w, acc);
      update<HID>(G, G, [&](int i, int j, float g) {
        return g + ((bits >> (8 * i + j) & 1) ? acc[i][j] : 0.f);
      });
    }
    // d(encoding) = head^T d(layer_0 output), into T
    zero(acc);
    gemm<HID, HID, 2>(G, w, acc);
    store<HID>(T, [&](int i, int j) { return acc[i][j]; });
    __syncthreads();

    // d(pixel x, y): the lerp's derivative against d(layer_0 output), a warp
    // a row pair, times the clamps' factors
    for (int r0 = warp * (TILE / WARPS); r0 < (warp + 1) * (TILE / WARPS);
         r0 += 2) {
      float v[2][16], ax[2], ay[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        int idx;
        stencil(rin[r0 + u], rin[TILE + r0 + u], a.height, a.width, idx,
                ax[u], ay[u]);
        const float* src = corner_row(a, row0 + r0 + u, idx) + lane;
#pragma unroll
        for (int k = 0; k < 16; ++k)
          v[u][k] = __ldg(src + (k >> 2) * HID + (k & 3) * 32);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float gx = 0.f, gy = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float g = G[sw(q * 32 + lane, r0 + u)];
          const float v00 = v[u][q], v01 = v[u][4 + q], v10 = v[u][8 + q],
                      v11 = v[u][12 + q];
          const float dx0 = v01 - v00, dx1 = v11 - v10;
          const float top = v00 + ax[u] * dx0, bot = v10 + ax[u] * dx1;
          gx += g * ((1.f - ay[u]) * dx0 + ay[u] * dx1);
          gy += g * (bot - top);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          gx += __shfl_xor_sync(FULL, gx, o);
          gy += __shfl_xor_sync(FULL, gy, o);
        }
        if (lane == 0) {
          const int r = r0 + u;
          ob[r] = gx * clip_factor(rin[r], (float)a.width - 1.f);
          ob[TILE + r] = gy * clip_factor(rin[TILE + r], (float)a.height - 1.f);
        }
      }
    }
    // d(position, direction) through the encoding: sum over octaves of
    // f_k (d sin * cos - d cos * sin)
    for (int t = tid; t < 6 * TILE; t += THREADS) {
      const int r = t & (TILE - 1), d = t / TILE;
      const float v = rin[(2 + d) * TILE + r];
      const int f0 = d * 2 * a.n_freq;
      float sum = 0.f;
      for (int k = 0; k < a.n_freq; ++k) {
        const float f = a.base_freq * (float)(1 << k);
        const float s = v * f;
        sum += (T[sw(f0 + 2 * k, r)] * cosf(s) -
                T[sw(f0 + 2 * k + 1, r)] * sinf(s)) * f;
      }
      ob[(2 + d) * TILE + r] = sum;
    }
    __syncthreads();
    for (int t = tid; t < IN * TILE; t += THREADS) {
      const int r = t / IN, k = t % IN, row = row0 + r;
      if (row < a.n_rows) a.gin[(size_t)row * IN + k] = ob[k * TILE + r];
    }
  }
  cp_async_wait_all();
}

constexpr int FWD_SMEM = (2 * HID * LDA + IN * TILE + 2 * CHUNK) * 4;
constexpr int BWD_SMEM =
    (2 * HID * LDA + DS * LDA + 2 * IN * TILE + 2 * CHUNK) * 4;
static_assert(CTAS * (BWD_SMEM + 1024) <= 233472, "shared memory");


// the chunks of either stream: the head, two layers a block, and a tap's
// Dense(64) and combined share
int stream_chunks(int n_blocks, int n_taps) {
  return (HID * HID * (1 + 2 * n_blocks) + n_taps * (HID * DS + DS * DS)) /
         CHUNK;
}

int check(int n_rows, int rows_per_image, int height, int width, int n_blocks,
          int n_taps, int n_freq, int n_chunks) {
  const int nf = n_blocks / 2;
  const bool ok = n_rows >= 0 && rows_per_image > 0 && height >= 2 &&
                  width >= 2 && n_blocks >= 2 && n_blocks <= 64 &&
                  n_taps == min(n_blocks - nf + 1, MAX_TAPS) && n_freq >= 1 &&
                  12 * n_freq <= HID &&
                  n_chunks == stream_chunks(n_blocks, n_taps);
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

Args make_args(const float* coords, const float* pos, const float* dirs,
               const float* corner, int n_rows, int rows_per_image,
               int height, int width, const float* stream, int n_chunks,
               int n_blocks, int n_taps, int n_freq, float base_freq,
               int elu) {
  Args a{};
  a.n_rows = n_rows;
  a.rows_per_image = rows_per_image;
  a.height = height;
  a.width = width;
  a.n_blocks = n_blocks;
  a.tap0 = n_blocks / 2 - 1;
  a.n_taps = n_taps;
  a.n_freq = n_freq;
  a.elu = elu;
  a.base_freq = base_freq;
  a.coords = coords;
  a.pos = pos;
  a.dirs = dirs;
  a.corner = corner;
  a.stream = stream;
  a.n_chunks = n_chunks;
  return a;
}

// Per device (ids below 64): the SM count, and whether each kernel's
// attributes are set. Set once: the launch is on the host's path between
// the card's kernels.
int sms[64];
bool ready[2][64];

int launch(int which, void (*kernel)(Args), int smem, const Args& a,
           void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[which][dev]) {
    err = cudaFuncSetAttribute((const void*)kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)   // all of the SM's L1 as shared memory: 2 CTAs
      err = cudaFuncSetAttribute(
          (const void*)kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && sms[dev] == 0)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return (int)err;
    ready[which][dev] = true;
  }
  const int tiles = (a.n_rows + TILE - 1) / TILE;
  if (tiles == 0) return 0;
  kernel<<<min(tiles, CTAS * max(sms[dev], 1)), THREADS, smem,
           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns cudaGetLastError() after its launch (or a cudaError for
// arguments the kernels do not take). coords [n][2], pos and dirs [n][3],
// corner [n / rows_per_image][H][W][512], all f32 and contiguous; stream
// `pack_probe`'s forward or backward chunks. masks and actd: the buffers
// of `probe_buffers` (NULL in a forward that keeps nothing for a backward).
extern "C" int probe_fwd_launch(const float* coords, const float* pos,
                                const float* dirs, const float* corner,
                                int n_rows, int rows_per_image, int height,
                                int width, const float* stream, int n_chunks,
                                const float* bias, int n_blocks, int n_taps,
                                int n_freq, float base_freq, int elu,
                                u64* masks, float* actd, float* out,
                                void* cuda_stream) {
  int err = check(n_rows, rows_per_image, height, width, n_blocks, n_taps,
                  n_freq, n_chunks);
  if (err || (masks == nullptr) != (actd == nullptr))
    return err ? err : (int)cudaErrorInvalidValue;
  Args a = make_args(coords, pos, dirs, corner, n_rows, rows_per_image, height,
                     width, stream, n_chunks, n_blocks, n_taps, n_freq,
                     base_freq, elu);
  a.bias = bias;
  a.masks = masks;
  a.actd = actd;
  a.out = out;
  return launch(0, probe_fwd_kernel, FWD_SMEM, a, cuda_stream);
}

extern "C" int probe_bwd_launch(const float* coords, const float* pos,
                                const float* dirs, const float* corner,
                                int n_rows, int rows_per_image, int height,
                                int width, const float* stream, int n_chunks,
                                int n_blocks, int n_taps, int n_freq,
                                float base_freq, int elu,
                                const u64* masks, const float* actd,
                                const float* gout, float* gin,
                                void* cuda_stream) {
  int err = check(n_rows, rows_per_image, height, width, n_blocks, n_taps,
                  n_freq, n_chunks);
  if (err || masks == nullptr || actd == nullptr)
    return err ? err : (int)cudaErrorInvalidValue;
  Args a = make_args(coords, pos, dirs, corner, n_rows, rows_per_image, height,
                     width, stream, n_chunks, n_blocks, n_taps, n_freq,
                     base_freq, elu);
  a.masks = const_cast<u64*>(masks);
  a.actd = const_cast<float*>(actd);
  a.gout = gout;
  a.gin = gin;
  return launch(1, probe_bwd_kernel, BWD_SMEM, a, cuda_stream);
}
