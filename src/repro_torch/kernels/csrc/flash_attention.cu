// Causal GQA flash attention, forward, for bf16 or f32 inputs.
//
// Replaces the Pallas kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (B6). Same function: q [B,S,Hq,D],
// k/v [B,S,Hkv,D] -> o [B,S,Hq,D] in q's type, the G = Hq/Hkv query heads of
// a kv head sharing its K/V tiles, an online softmax whose running max, sum
// and output (m, l, o) stay in f32 on chip (alpha rescale, then add), key
// positions above a query's row contributing nothing, and key tiles wholly
// above a block's last row never read. Unlike the Pallas kernel it takes
// any S >= 1.
//
// Bound on the H100: operations, on the tensor cores. At the serving shape
// (B 4, S 4096, Hq 16, Hkv 8, D 128) the two products are ~275 GFLOP
// against ~0.2 GB of q, k, v and o, far above the card's bytes-per-
// operation line.
//
// Two bodies, chosen by dtype and D (tensor_core_body below); in both,
// blocks run the longest (last) q-tiles first.
//
// * Tensor cores (bf16, D 64 or 128). A block holds 128 query rows, the G
//   heads of a kv head × 128/G positions (row = position · G + head), as
//   two consumer warpgroups of 64 rows and one producer warpgroup that
//   only issues copies; setmaxnreg gives the consumers 240 registers and
//   leaves the producer 24. The producer loads Q once and then K and V
//   tiles of 64 keys into a ring of 3 stages, all by TMA through rank-4
//   tensor maps over (D, H, S, B) with the 128-byte swizzle (a 128-wide
//   row takes two 64-wide boxes). Keys and rows past S arrive as zeros,
//   and only the tiles up to the block's last row are loaded. Each
//   consumer computes S = Q·Kᵀ by wgmma (bf16 in, f32 out), Q unscaled in
//   bf16; scale·log2(e) multiplies the f32 scores; the online softmax
//   runs on the accumulator's registers with ex2, masking only tiles
//   that reach past the warpgroup's first position. O += P·V is two
//   wgmmas, P_hi·V and P_lo·V, with P_hi = bf16(p) and P_lo =
//   bf16(p - P_hi) as register operands and V, stored [key][d], as the
//   MN-major B. One bf16 rounding of p (what FA2, FA3 and SDPA do) gives
//   a relative RMS error near 2e-3, about twice the 2^-10 this kernel is
//   held to; the split keeps p to ~16 bits for 1.5x the product work. l
//   sums the f32 p. O / max(l, 1e-30) is written in bf16; rows past S
//   are not written.
//
// * CUDA cores (f32 at every D, bf16 at D 16 or 32), in f32 with explicit
//   fmaf (the library builds with -fmad=false). One block per (q-tile,
//   kv head, batch row) holds the same 128 rows (head-major: row = head ·
//   BQ + position); q * scale (f32) stays in shared memory; each 64-key
//   tile of K and V is staged in shared memory (f32, zero past S). Thread
//   (rg, cg) of 256 owns rows rg + 32 i (i < 4): it computes their scores
//   against keys cg + 8 j (j < 8), keeps their m and l (the 8 threads of a
//   row sit in one warp and reduce by shuffles), and accumulates their
//   outputs at dims cg + 8 j in registers. The probabilities pass through
//   shared memory to the P·V product. Padded row strides keep every
//   shared-memory column read free of bank conflicts.

#include <atomic>
#include <cstdint>
#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch_util.cuh"
#include "wgmma_sm90.cuh"

namespace {

// ===========================================================================
// CUDA-core body
// ===========================================================================

constexpr int kRows = 128;      // query rows of one block (G heads × BQ)
constexpr int kBK = 64;         // keys of one tile
constexpr int kThreads = 256;   // 32 row groups × 8 column groups
constexpr float kNegInf = -1.0e30f;

// Launches that ran on this device, per body ([0] CUDA cores, [1] tensor
// cores): thread 0 of each launch's first block adds one, so a reader
// sees which kernel ran, not which one the host meant to launch.
__device__ unsigned long long g_body_launches[2];

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
  if (tid == 0 && blockIdx.x == 0 && h == 0 && b == 0)
    atomicAdd(&g_body_launches[0], 1ull);

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
  static std::atomic<uint64_t> ready{0};
  const cudaError_t err = raise_smem_limit(
      (const void*)flash_attention_kernel<T, D>, (int)smem, ready);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + bq - 1) / bq, hkv, b);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, s, hq, hkv, g, bq,
      scale);
  return (int)cudaGetLastError();
}



// ===========================================================================
// Tensor-core body (bf16, D 64 or 128)
// ===========================================================================

namespace tc {

constexpr int kBK = 64;              // keys of one tile (QKᵀ is m64n64)
constexpr int kStages = 3;           // K/V ring depth
constexpr int kThreads = 384;        // two consumer warpgroups + producer
constexpr int kBox = 64;             // bf16 columns of one 128-byte box row

template <int D>
struct Smem {
  static constexpr int kHalves = D / kBox;                  // boxes per row
  static constexpr int kQTile = kRows * kBox * 2;           // 16 KB
  static constexpr int kKVTile = kBK * kBox * 2;            // 8 KB
  static constexpr int kK = kHalves * kQTile;               // Q first
  static constexpr int kStage = 2 * kHalves * kKVTile;      // K then V
  static constexpr int kBar = kK + kStages * kStage;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages);
  static constexpr int kAlloc = kBytes + 1024;              // for alignment
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 64) sm90::wgmma_rs_n64(d, a, db);
  else sm90::wgmma_rs_n128(d, a, db);
}

// Grid: one block per (q-tile, kv head, batch row), the q-tile slowest and
// last first. Threads 0-255 are the consumers, 256-383 the producer.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_tc_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
    int s, int hq, int hkv, int nb, int g, int bq, int n_qt, float c) {
  using L = Smem<D>;
  constexpr int H = L::kHalves;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bar = base + L::kBar;
  const uint32_t q_full = bar;
  auto k_full = [&](int st) { return bar + 8u * (1 + st); };
  auto v_full = [&](int st) { return bar + 8u * (1 + kStages + st); };
  auto empty = [&](int st) { return bar + 8u * (1 + 2 * kStages + st); };
  auto k_s = [&](int st) { return base + L::kK + st * L::kStage; };
  auto v_s = [&](int st) { return k_s(st) + H * L::kKVTile; };

  const int hb = blockIdx.x % (hkv * nb);
  const int qt = n_qt - 1 - (int)(blockIdx.x / (hkv * nb));
  const int h = hb % hkv;
  const int b = hb / hkv;
  const int q0 = qt * bq;
  const int rows = g * bq;
  const int n_tiles = (min(q0 + bq, s) - 1) / kBK + 1;

  if (threadIdx.x == 0 && blockIdx.x == 0)
    atomicAdd(&g_body_launches[1], 1ull);
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(k_full(st), 1);
      sm90::mbar_init(v_full(st), 1);
      sm90::mbar_init(empty(st), 2 * 128);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: one thread issues every copy.
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 256) {
      sm90::mbar_arrive_expect_tx(q_full, H * rows * kBox * 2);
      for (int hh = 0; hh < H; ++hh)
        sm90::tma_load_4d(q_s + hh * L::kQTile, &qmap, q_full, hh * kBox,
                          h * g, q0, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % kStages;
        sm90::mbar_wait(empty(st), ((kt / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(k_full(st), H * L::kKVTile);
        for (int hh = 0; hh < H; ++hh)
          sm90::tma_load_4d(k_s(st) + hh * L::kKVTile, &kmap, k_full(st),
                            hh * kBox, h, kt * kBK, b);
        sm90::mbar_arrive_expect_tx(v_full(st), H * L::kKVTile);
        for (int hh = 0; hh < H; ++hh)
          sm90::tma_load_4d(v_s(st) + hh * L::kKVTile, &vmap, v_full(st),
                            hh * kBox, h, kt * kBK, b);
      }
    }
  } else {
    // Consumer warpgroup wg: block rows 64 wg .. 64 wg + 63.
    sm90::reg_alloc<240>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int ra = 64 * wg + 16 * (t / 32) + lane / 4;   // and ra + 8
    // A row past the block's rows or past S has position -1: it matches
    // no key and is never written.
    int pos[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = ra + 8 * j;
      pos[j] = (r < rows && q0 + r / g < s) ? q0 + r / g : -1;
    }
    const int wg_last = min(64 * wg + 63, rows - 1);
    const int wg_max_pos =
        64 * wg < rows ? min(q0 + wg_last / g, s - 1) : -1;
    // Tiles reaching past this position, or any tile when a row of the
    // warpgroup has no position, need the mask.
    const bool wg_partial = 64 * wg + 63 >= rows ||
                            q0 + (64 * wg + 63) / g >= s;
    const int wg_min_pos = wg_partial ? -1 : q0 + (64 * wg) / g;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    // Descriptors: Q rows of this warpgroup (K-major A), K tiles (K-major
    // B, N = keys), V tiles (MN-major B, N = d: its two 64-wide halves lie
    // one tile apart; K steps of 16 keys are 2 KB apart).
    const uint32_t q_wg = q_s + 64 * wg * kBox * 2;
    sm90::mbar_wait(q_full, 0);

    for (int kt = 0; kt < n_tiles; ++kt) {
      const int st = kt % kStages;
      const uint32_t par = (kt / kStages) & 1;
      const int k0 = kt * kBK;
      sm90::mbar_wait(k_full(st), par);
      if (k0 > wg_max_pos) {
        // Every key of this tile is above every row of the warpgroup.
        sm90::mbar_wait(v_full(st), par);
        sm90::mbar_arrive(empty(st));
        continue;
      }
      float sc[kBK / 2];
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        sm90::wgmma_ss_n64(
            sc,
            sm90::desc_sw128(q_wg + (kk / 4) * L::kQTile + off, 16, 1024),
            sm90::desc_sw128(k_s(st) + (kk / 4) * L::kKVTile + off, 16, 1024),
            kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      // Online softmax in the log2 domain: x = score · scale · log2(e).
      const bool masked = k0 + kBK - 1 > wg_min_pos;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int j = (i >> 1) & 1;
        float x = sc[i] * c;
        if (masked) {
          const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          if (key > pos[j]) x = __int_as_float(0xff800000);  // -inf
        }
        sc[i] = x;
        mx[j] = fmaxf(mx[j], x);
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
        alpha[j] = ex2(m[j] - mx[j]);
        m[j] = mx[j];
      }
      uint32_t ph[kBK / 16][4], pl[kBK / 16][4];
#pragma unroll
      for (int i = 0; i < kBK / 2; i += 2) {
        const int j = (i >> 1) & 1;
        const float p0 = ex2(sc[i] - mx[j]);
        const float p1 = ex2(sc[i + 1] - mx[j]);
        sum[j] += p0;
        sum[j] += p1;
        const uint32_t hi = pack_bf16(p0, p1);
        ph[i / 8][(i % 8) / 2] = hi;
        pl[i / 8][(i % 8) / 2] = pack_bf16(p0 - bf16_lo(hi), p1 - bf16_hi(hi));
      }
      // l and o hold this thread's share of its rows: alpha rescale, then
      // add. The four threads of a row sum their l at the end.
#pragma unroll
      for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + sum[j];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      sm90::mbar_wait(v_full(st), par);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = sm90::desc_sw128(v_s(st) + kk * 16 * kBox * 2,
                                             L::kKVTile, 1024);
        wgmma_pv<D>(o, ph[kk], dv);
        wgmma_pv<D>(o, pl[kk], dv);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        sm90::fence_regs(ph[kk]);
        sm90::fence_regs(pl[kk]);
      }
      sm90::mbar_arrive(empty(st));
    }

    float den[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
      den[j] = fmaxf(l[j], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (pos[j] < 0) continue;
      const int r = ra + 8 * j;
      __nv_bfloat16* row =
          out + (((int64_t)b * s + pos[j]) * hq + h * g + r % g) * D;
#pragma unroll
      for (int i = 2 * j; i < D / 2; i += 4) {
        const int col = 8 * (i >> 2) + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(o[i] / den[j], o[i + 1] / den[j]);
      }
    }
  }
}

// cuTensorMapEncodeTiled (libcuda), looked up through the runtime's
// entry-point query so the library needs no -lcuda.
PFN_cuTensorMapEncodeTiled_v12000 encode_fn(cudaError_t* err) {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    *err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                            12000, cudaEnableDefault, &found);
#else
    *err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                   cudaEnableDefault, &found);
#endif
    if (*err == cudaSuccess && found != cudaDriverEntryPointSuccess)
      *err = cudaErrorSymbolNotFound;
    if (*err != cudaSuccess) return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  *err = cudaSuccess;
  return fn;
}

// A rank-4 map over the contiguous bf16 tensor [b][s][h][d], innermost
// first, read in boxes of 64 × box_h × box_s × 1 with the 128-byte swizzle.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int b, int s, int h,
                     int d, int box_h, int box_s) {
  cudaError_t err;
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn(&err);
  if (encode == nullptr) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)h * d * 2,
                                 (cuuint64_t)s * h * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, (cuuint32_t)box_h,
                             (cuuint32_t)box_s, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int hq, int hkv, float scale, cudaStream_t stream) {
  const int g = hq / hkv;
  const int bq = kRows / g;
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = make_map(&qmap, q, b, s, hq, D, g, bq);
  if (err == cudaSuccess) err = make_map(&kmap, k, b, s, hkv, D, 1, kBK);
  if (err == cudaSuccess) err = make_map(&vmap, v, b, s, hkv, D, 1, kBK);
  if (err != cudaSuccess) return (int)err;
  constexpr int smem = Smem<D>::kAlloc;
  static std::atomic<uint64_t> ready{0};
  err = raise_smem_limit((const void*)flash_attention_tc_kernel<D>, smem,
                         ready);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (s + bq - 1) / bq;
  const float c = scale * 1.4426950408889634f;   // log2(e)
  flash_attention_tc_kernel<D><<<n_qt * hkv * b, kThreads, smem, stream>>>(
      qmap, kmap, vmap, (__nv_bfloat16*)out, s, hq, hkv, b, g, bq, n_qt, c);
  return (int)cudaGetLastError();
}

}  // namespace tc

bool tensor_core_body(int d, int is_bf16) {
  return is_bf16 && (d == 64 || d == 128);
}

int launch_body(const void* q, const void* k, const void* v, void* out,
                int b, int s, int hq, int hkv, int d, int is_bf16,
                float scale, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (tensor_core_body(d, is_bf16))
    return d == 64 ? tc::launch<64>(q, k, v, out, b, s, hq, hkv, scale, st)
                   : tc::launch<128>(q, k, v, out, b, s, hq, hkv, scale, st);
  if (is_bf16) {
    switch (d) {
      case 16: return launch<bf16, 16>(q, k, v, out, b, s, hq, hkv, scale, st);
      case 32: return launch<bf16, 32>(q, k, v, out, b, s, hq, hkv, scale, st);
    }
  } else {
    switch (d) {
      case 16: return launch<float, 16>(q, k, v, out, b, s, hq, hkv, scale, st);
      case 32: return launch<float, 32>(q, k, v, out, b, s, hq, hkv, scale, st);
      case 64: return launch<float, 64>(q, k, v, out, b, s, hq, hkv, scale, st);
      case 128:
        return launch<float, 128>(q, k, v, out, b, s, hq, hkv, scale, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: [b, s, hq, d], k/v: [b, s, hkv, d], out: [b, s, hq, d], contiguous, all
// bf16 (is_bf16 = 1) or all f32; bf16 pointers 16-byte aligned. d in
// {16, 32, 64, 128}; hkv divides hq and hq / hkv <= 128; s >= 1. Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for a shape
// it does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int s,
                                      int hq, int hkv, int d, int is_bf16,
                                      float scale, void* stream) {
  if (b < 1 || s < 1 || hkv < 1 || hq % hkv != 0 || hq / hkv > kRows)
    return (int)cudaErrorInvalidValue;
  return launch_body(q, k, v, out, b, s, hq, hkv, d, is_bf16, scale,
                     (cudaStream_t)stream);
}

// Copies the current device's launch counts per body into out[2] (see
// g_body_launches): a synchronous copy, so the caller waits for the
// launches it wants counted first.
extern "C" int flash_attention_body_launches(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_body_launches,
                                   sizeof(g_body_launches));
}
