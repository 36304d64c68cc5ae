// Temporal (per-pixel, per-head) attention over frames for Hopper (sm_90a):
// for each pixel n and head h, o[n, :, h] = softmax(q k^T * scale) v over
// the F frames, with q, k, v, o laid out (N, F, heads, e) in bf16 — the
// motion module's (B, P, F, C) stream with C split as (heads, e).
//
// Replaces the TPU kernel _packed_temporal_kernel of the JAX package's
// ops/attention.py (launched by packed_temporal_attention). That kernel packs the heads
// and frames of a pixel into one m = F*heads axis and masks the cross-head
// entries of an m x m product to -inf, a TPU matrix-unit shape trick that
// does 8x the needed work. Here each (pixel, head) problem is computed as
// what it is, an F x F attention (F <= 32), with no masked work.
//
// Bound on the H100: 4*F*F*e FLOPs per problem against 4*F*e*2 bytes,
// i.e. F/2 = 8 FLOP/byte at F = 16: bound by memory bytes. The design
// reads q, k and v once with 16-byte loads and writes o once: one warp per
// problem copies its F x e tiles into shared memory (cp.async; frames
// padded to 16 or 32 and e to a multiple of 16 with zeros, in shared
// memory only), computes S = q k^T on the tensor cores (mma.sync
// m16n8k16, f32 accumulate), the softmax in registers (f32), and P v on
// the tensor cores from P's registers, as the flash kernel does.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // problems per block

template <int FP, int EP>
struct TLayout {
  static constexpr int LD = EP + 8;  // bf16 row stride, 16-byte padding
  static constexpr int TILE = FP * LD;
  static constexpr size_t per_warp = sizeof(bf16) * 3 * TILE;
  static constexpr size_t bytes = kWarps * per_warp;
};

template <int FP, int EP>
__global__ void __launch_bounds__(kWarps * 32)
temporal_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int problems, int F,
                     int heads, int e, float scale_log2) {
  using L = TLayout<FP, EP>;
  constexpr int MT = FP / 16;  // m16 frame tiles
  constexpr int NS = FP / 8;   // n8 key tiles of S
  constexpr int KE = EP / 16;  // k16 steps over e
  constexpr int NO = EP / 8;   // n8 tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int idx = blockIdx.x * kWarps + warp;
  if (idx >= problems) return;  // no block-wide barrier below
  bf16* sQ = reinterpret_cast<bf16*>(smem + warp * L::per_warp);
  bf16* sK = sQ + L::TILE;
  bf16* sV = sK + L::TILE;

  const size_t n = idx / heads, h = idx % heads;
  const size_t fstride = (size_t)heads * e;  // elements between frames
  const size_t base = n * F * fstride + h * e;
  constexpr int CH = EP / 8;  // 16-byte chunks per padded row
  for (int i = lane; i < FP * CH; i += 32) {
    const int f = i / CH, c = (i % CH) * 8;
    const int off = f * L::LD + c;
    if (f < F && c < e) {
      const size_t g = base + f * fstride + c;
      cp_async16(sQ + off, q + g);
      cp_async16(sK + off, k + g);
      cp_async16(sV + off, v + g);
    } else {
      const uint4 z = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(sQ + off) = z;
      *reinterpret_cast<uint4*>(sK + off) = z;
      *reinterpret_cast<uint4*>(sV + off) = z;
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

  const int c2 = 2 * (lane % 4), mi = lane / 8;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    // S (16 frames x FP keys) = Q_mt K^T
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[j][x] = 0.f;
#pragma unroll
    for (int ke = 0; ke < KE; ++ke) {
      uint32_t a[4];
      ldmatrix_x4(a, sQ + (mt * 16 + lane % 16) * L::LD + ke * 16 + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t b[4];  // key tiles j and j + 1
        ldmatrix_x4(b, sK + (j * 8 + lane % 8 + 8 * (mi / 2)) * L::LD + ke * 16 + 8 * (mi % 2));
        mma_bf16_16816(s[j], a, b[0], b[1]);
        mma_bf16_16816(s[j + 1], a, b[2], b[3]);
      }
    }
    // softmax over the F keys of each row (rows lane/4 and lane/4 + 8)
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        s[j][x] = (j * 8 + c2 + (x & 1)) < F ? s[j][x] * scale_log2 : -INFINITY;
        mx[x / 2] = fmaxf(mx[x / 2], s[j][x]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        s[j][x] = exp2f(s[j][x] - mx[x / 2]);
        sum[x / 2] += s[j][x];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      sum[r] = 1.f / sum[r];
    }
    // O (16 x EP) = P V, P normalised and rounded to bf16 (as the plain
    // twin rounds its probabilities to v's dtype)
    float acc[NO][4];
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;
#pragma unroll
    for (int kk = 0; kk < FP / 16; ++kk) {
      uint32_t pa[4] = {pack_bf16(s[2 * kk][0] * sum[0], s[2 * kk][1] * sum[0]),
                        pack_bf16(s[2 * kk][2] * sum[1], s[2 * kk][3] * sum[1]),
                        pack_bf16(s[2 * kk + 1][0] * sum[0], s[2 * kk + 1][1] * sum[0]),
                        pack_bf16(s[2 * kk + 1][2] * sum[1], s[2 * kk + 1][3] * sum[1])};
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t b[4];  // e tiles j and j + 1, keys kk*16 .. +16
        ldmatrix_x4_trans(b, sV + (kk * 16 + lane % 8 + 8 * (mi % 2)) * L::LD + j * 8 +
                                 8 * (mi / 2));
        mma_bf16_16816(acc[j], pa, b[0], b[1]);
        mma_bf16_16816(acc[j + 1], pa, b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = j * 8 + c2;
      if (col >= e) continue;  // e is even: a pair is all in or all out
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int f = mt * 16 + lane / 4 + 8 * r;
        if (f < F)
          *reinterpret_cast<uint32_t*>(o + base + f * fstride + col) =
              pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }
  }
}

// With ``grid`` set, no launch: grid = {blocks, threads a block, blocks
// resident an SM} of the launch these arguments would make.
template <int FP, int EP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int n, int F,
                   int heads, int e, float scale, cudaStream_t stream, int* grid) {
  using L = TLayout<FP, EP>;
  auto kern = temporal_attn_kernel<FP, EP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::bytes));
  if (err != cudaSuccess) return err;
  const int problems = n * heads;
  const int blocks = (problems + kWarps - 1) / kWarps;
  if (grid) {
    grid[0] = blocks;
    grid[1] = kWarps * 32;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&grid[2], kern, kWarps * 32, L::bytes);
  }
  kern<<<blocks, kWarps * 32, L::bytes, stream>>>(q, k, v, o, problems, F, heads, e,
                                                  scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int FP>
cudaError_t launch_e(const bf16* q, const bf16* k, const bf16* v, bf16* o, int n, int F,
                     int heads, int e, float scale, cudaStream_t stream, int* grid) {
  switch ((e + 15) / 16 * 16) {
    case 16: return launch<FP, 16>(q, k, v, o, n, F, heads, e, scale, stream, grid);
    case 48: return launch<FP, 48>(q, k, v, o, n, F, heads, e, scale, stream, grid);
    case 80: return launch<FP, 80>(q, k, v, o, n, F, heads, e, scale, stream, grid);
    case 160: return launch<FP, 160>(q, k, v, o, n, F, heads, e, scale, stream, grid);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int n, int F,
                     int heads, int e, float scale, cudaStream_t stream, int* grid) {
  if (F < 1 || F > 32 || n <= 0 || heads <= 0 || e <= 0 || e % 8) return cudaErrorInvalidValue;
  return F <= 16 ? launch_e<16>(q, k, v, o, n, F, heads, e, scale, stream, grid)
                 : launch_e<32>(q, k, v, o, n, F, heads, e, scale, stream, grid);
}

}  // namespace

// q, k, v, o: (n, F, heads, e) bf16, contiguous and 16-byte aligned;
// 1 <= F <= 32, e % 8 == 0 and ceil16(e) in {16, 48, 80, 160} (the motion
// modules' 40, 80 and 160, and small e for tests).
INSV2V_EXPORT int temporal_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    int n, int F, int heads, int e, float scale,
                                    void* stream) {
  cudaGetLastError();
  return dispatch(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<bf16*>(o), n, F, heads, e, scale,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// The grid temporal_attn_fwd launches for these sizes, into out[3]:
// blocks, threads a block, and blocks resident an SM (the occupancy API).
INSV2V_EXPORT int temporal_attn_grid(int n, int F, int heads, int e, int* out) {
  cudaGetLastError();
  return dispatch(nullptr, nullptr, nullptr, nullptr, n, F, heads, e, 1.0f, nullptr, out);
}
