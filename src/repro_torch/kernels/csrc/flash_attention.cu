// Causal GQA flash attention, forward, for bf16 or f32 inputs.
//
// Replaces the Pallas kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (B6). Same function: q [B,S,Hq,D],
// k/v [B,S,Hkv,D] -> o [B,S,Hq,D] in q's type, the G = Hq/Hkv query heads of
// a kv head sharing its K/V tiles, an online softmax whose running max, sum
// and output (m, l, o) stay in f32 on chip, q scaled in f32 before the
// product, key positions above a query's row contributing nothing, and key
// tiles wholly above a block's last row never read. Unlike the Pallas
// kernel it takes any S >= 1: the last query and key tiles are masked.
//
// Bound on the H100: operations. At the serving shape (B 4, S 4096, Hq 16,
// Hkv 8, D 128) the two products are ~275 GFLOP against ~0.2 GB of q, k, v
// and o, far above the card's bytes-per-operation line. This first kernel
// does them on the CUDA cores in f32 (explicit fmaf, so the library's global
// -fmad=false does not split them), so it runs well under the tensor-core
// bound; moving the products to wgmma is later work.
//
// Design: one block per (q-tile, kv head, batch row). A block holds 128
// query rows: the G heads of the group times BQ = 128 / G positions, so
// K/V tiles are loaded once for the whole group. q * scale (f32) stays in
// shared memory; each 64-key tile of K and V is staged in shared memory
// (f32, zero past S). Thread (rg, cg) of 256 owns rows rg + 32 i (i < 4):
// it computes their scores against keys cg + 8 j (j < 8), keeps their m
// and l (the 8 threads of a row sit in one warp and reduce by shuffles),
// and accumulates their outputs at dims cg + 8 j in registers. The
// probabilities pass through shared memory to the P·V product. Padded
// row strides keep every shared-memory column read free of bank
// conflicts. Blocks run the longest (last) q-tiles first.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;      // query rows of one block (G heads × BQ)
constexpr int kBK = 64;         // keys of one tile
constexpr int kThreads = 256;   // 32 row groups × 8 column groups
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kRows * (D + 1) + (size_t)kBK * (D + 1) +
                          (size_t)kBK * D + (size_t)kRows * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int s, int hq, int hkv, int g, int bq, float scale) {
  constexpr int QS = D + 1;     // q and k row stride
  constexpr int PS = kBK + 1;   // p row stride
  constexpr int DJ = D / 8;     // output dims per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // [kRows][QS]  q * scale
  float* ks = qs + kRows * QS;      // [kBK][QS]
  float* vs = ks + kBK * QS;        // [kBK][D]
  float* ps = vs + kBK * D;         // [kRows][PS]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int q0 = qt * bq;
  const int rows = g * bq;
  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    float x = 0.f;
    if (r < rows && q0 + r % bq < s) {
      const int64_t row = (b * s + q0 + r % bq) * hq + h * g + r / bq;
      x = to_f32(q[row * D + d]) * scale;
    }
    qs[r * QS + d] = x;
  }

  // A row past the group or past S has position -1: it matches no key and
  // is never written.
  int qpos[4];
  float m[4], l[4], o[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 32 * i;
    qpos[i] = (r < rows && q0 + r % bq < s) ? q0 + r % bq : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;
  }

  const int last = min(q0 + bq, s) - 1;
  const int n_tiles = last / kBK + 1;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();            // the last tile's K/V reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i - c * D;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < s) {
        const int64_t off = ((b * s + k0 + c) * hkv + h) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[c * QS + d] = kx;
      vs[c * D + d] = vx;
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(rg + 32 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kb[j] = ks[(cg + 8 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }

    // Online softmax over this tile; p = 0 where the key is masked.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (k0 + cg + 8 * j <= qpos[i]) mx = fmaxf(mx, sc[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float alpha = expf(m[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p =
            (k0 + cg + 8 * j <= qpos[i]) ? expf(sc[i][j] - mx) : 0.f;
        ps[(rg + 32 * i) * PS + cg + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = mx;
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[i][j] *= alpha;
    }
    __syncwarp();               // a row's p is written and read by one warp

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ps[(rg + 32 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vb = vs[c * D + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(pa[i], vb, o[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qpos[i] < 0) continue;
    const int r = rg + 32 * i;
    const int64_t row = (b * s + qpos[i]) * hq + h * g + r / bq;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(out + row * D + cg + 8 * j, o[i][j] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int hq, int hkv, float scale, cudaStream_t stream) {
  const int g = hq / hkv;
  const int bq = kRows / g;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + bq - 1) / bq, hkv, b);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, s, hq, hkv, g, bq,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int b,
             int s, int hq, int hkv, int d, float scale, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, b, s, hq, hkv, scale, st);
    case 32: return launch<T, 32>(q, k, v, out, b, s, hq, hkv, scale, st);
    case 64: return launch<T, 64>(q, k, v, out, b, s, hq, hkv, scale, st);
    case 128: return launch<T, 128>(q, k, v, out, b, s, hq, hkv, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [b, s, hq, d], k/v: [b, s, hkv, d], out: [b, s, hq, d], contiguous, all
// bf16 (is_bf16 = 1) or all f32. d in {16, 32, 64, 128}; hkv divides hq and
// hq / hkv <= 128; s >= 1. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int s,
                                      int hq, int hkv, int d, int is_bf16,
                                      float scale, void* stream) {
  if (b < 1 || s < 1 || hkv < 1 || hq % hkv != 0 || hq / hkv > kRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16
             ? launch_d<__nv_bfloat16>(q, k, v, out, b, s, hq, hkv, d, scale, st)
             : launch_d<float>(q, k, v, out, b, s, hq, hkv, d, scale, st);
}
