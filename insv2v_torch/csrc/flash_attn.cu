// Flash attention forward for Hopper (sm_90a): bf16 q, k, v, f32 online
// softmax, bf16 out.
//
// Replaces the TPU kernel _flash_kernel of the JAX package's
// ops/attention.py (launched by flash_attention). It computes, per
// (batch*head, query block), softmax(q k^T * scale) v with a running max,
// sum and f32 accumulator over key tiles; keys past Sk are masked to -inf.
//
// Bound on the H100: at the UNet shapes (S = 1536 or 384, d = 40 or 80)
// the work is ~4*S*S*d FLOPs against 4*S*d*2 bytes, S/2 FLOP/byte, above
// the card's ~295 FLOP/byte balance point at S = 1536 (bound by tensor-core
// operations) and below it at S = 384 (bound by bytes); the VAE mid-block
// (d = 512, S = 1536) is bound by operations. Two designs:
//
//  * the UNet's head dims 40 and 80: the FlashAttention-2
//    layout. Eight warps own 16 query rows each (128 queries a block, so
//    each K/V tile in shared memory serves 128 rows); Q stays in registers as
//    mma.sync fragments, the S = QK^T tile, the online softmax and the P
//    fragments never leave registers (the m16n8 accumulator layout of two
//    adjacent key tiles is the m16k16 operand layout of P), and O
//    accumulates in registers. K and V tiles of 64 keys are double
//    buffered in shared memory by cp.async. d = 40 is zero-padded to 48 in
//    shared memory only, never in device memory.
//  * d = 512 does not fit registers: 32-row query and key tiles with wmma
//    16x16x16 fragments, the logits and the f32 output tile in dynamic
//    shared memory (above 48 KB, after cudaFuncSetAttribute).
// Known cost of this version: no TMA, no wgmma, no warp specialisation.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kPadH = 8;  // bf16 row padding: 16 bytes, rows in distinct banks
constexpr int kPadF = 4;  // f32 row padding: keeps ld a multiple of 4

// Copies rows [r0, r0 + R) of a (n, d) bf16 matrix into shared memory
// (R x ld), zero-filling rows past n and columns d..DP. d % 8 == 0, so
// each row is whole 16-byte chunks. ASYNC: valid chunks go by cp.async.
template <int DP, int R, bool ASYNC>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, int r0, int n,
                                          int d, int tid, int nthreads) {
  constexpr int CH = DP / 8;  // 16-byte chunks per padded row
  for (int i = tid; i < R * CH; i += nthreads) {
    const int r = i / CH, c = (i % CH) * 8;
    bf16* to = dst + r * ld + c;
    if (r0 + r < n && c < d) {
      const bf16* from = src + (size_t)(r0 + r) * d + c;
      if (ASYNC)
        cp_async16(to, from);
      else
        *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
    } else {
      *reinterpret_cast<uint4*>(to) = make_uint4(0, 0, 0, 0);
    }
  }
}

// --- d = 40 and 80: registers ---------------------------------------------

constexpr int kBQ = 128, kBK = 64, kWarpsR = 8;

template <int DP>
struct RegLayout {
  static constexpr int LD = DP + kPadH;
  static constexpr int TILE = kBK * LD;  // elements of one K or V tile
  static constexpr size_t bytes = sizeof(bf16) * (kBQ * LD + 4 * TILE);
};

template <int DP>
__global__ void __launch_bounds__(kWarpsR * 32)
flash_fwd_reg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int sq, int sk, int d,
                     float scale_log2) {
  using L = RegLayout<DP>;
  constexpr int NT = kWarpsR * 32;
  constexpr int KD = DP / 16;   // k16 steps over the head dim
  constexpr int NS = kBK / 8;   // n8 key tiles of S
  constexpr int NO = DP / 8;    // n8 head-dim tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBQ * L::LD;  // two buffers
  bf16* sV = sK + 2 * L::TILE;  // two buffers

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  q += bh * sq * d;
  k += bh * sk * d;
  v += bh * sk * d;
  o += bh * sq * d;
  const int ntiles = (sk + kBK - 1) / kBK;

  load_tile<DP, kBQ, true>(sQ, L::LD, q, q0, sq, d, tid, NT);
  load_tile<DP, kBK, true>(sK, L::LD, k, 0, sk, d, tid, NT);
  load_tile<DP, kBK, true>(sV, L::LD, v, 0, sk, d, tid, NT);
  cp_async_commit();

  uint32_t qf[KD][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums
  const int c2 = 2 * (lane % 4);

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {  // prefetch the next tile into the other buffer
      load_tile<DP, kBK, true>(sK + (buf ^ 1) * L::TILE, L::LD, k, (t + 1) * kBK, sk, d, tid, NT);
      load_tile<DP, kBK, true>(sV + (buf ^ 1) * L::TILE, L::LD, v, (t + 1) * kBK, sk, d, tid, NT);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and Q) have landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldmatrix_x4(qf[kd], sQ + (warp * 16 + lane % 16) * L::LD + kd * 16 + (lane / 16) * 8);
    }
    const bf16* tK = sK + buf * L::TILE;
    const bf16* tV = sV + buf * L::TILE;

    // S (16 x 64) = Q_w K^T
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t b[4];  // key tiles n and n + 1, head dims kd*16 .. +16
        const int mi = lane / 8;
        ldmatrix_x4(b, tK + (n * 8 + lane % 8 + 8 * (mi / 2)) * L::LD + kd * 16 + 8 * (mi % 2));
        mma_bf16_16816(s[n], qf[kd], b[0], b[1]);
        mma_bf16_16816(s[n + 1], qf[kd], b[2], b[3]);
      }

    // online softmax over the tile; keys past sk are -inf
    const int kbase = t * kBK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kbase + n * 8 + c2 + (e & 1);
        s[n][e] = key < sk ? s[n][e] * scale_log2 : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: tile 0 has a key
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m_run[e / 2]);
        l_run[e / 2] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O_w += P (16 x 64) V (64 x DP); P's operand fragments are S's
    // accumulators, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];  // head-dim tiles n and n + 1, keys kk*16 .. +16
        const int mi = lane / 8;
        ldmatrix_x4_trans(b, tV + (kk * 16 + lane % 8 + 8 * (mi % 2)) * L::LD + n * 8 +
                                 8 * (mi / 2));
        mma_bf16_16816(acc[n], pa, b[0], b[1]);
        mma_bf16_16816(acc[n + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer `buf` before its refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    l_run[r] = 1.f / l_run[r];
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + c2;
    if (col >= d) continue;  // d is even: a pair is all in or all out
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + lane / 4 + 8 * r;
      if (row < sq)
        *reinterpret_cast<uint32_t*>(o + (size_t)row * d + col) =
            pack_bf16(acc[n][2 * r] * l_run[r], acc[n][2 * r + 1] * l_run[r]);
    }
  }
}

template <int DP>
cudaError_t launch_reg(const bf16* q, const bf16* k, const bf16* v, bf16* o, int bh, int sq,
                       int sk, int d, float scale, cudaStream_t stream) {
  using L = RegLayout<DP>;
  auto kern = flash_fwd_reg_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::bytes));
  if (e != cudaSuccess) return e;
  dim3 grid((sq + kBQ - 1) / kBQ, bh);
  kern<<<grid, kWarpsR * 32, L::bytes, stream>>>(q, k, v, o, sq, sk, d,
                                                 scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// --- d = 512: shared memory ----------------------------------------------

template <int DP, int BQ, int BK>
struct WideLayout {
  static constexpr int NW = BQ / 16;  // warps; each owns 16 query rows
  static constexpr int LDH = DP + kPadH;
  static constexpr int LDS = BK + kPadF;
  static constexpr int LDP = BK + kPadH;
  static constexpr int LDO = DP + kPadF;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + align128(sizeof(bf16) * BQ * LDH);
  static constexpr size_t v_off = k_off + align128(sizeof(bf16) * BK * LDH);
  static constexpr size_t s_off = v_off + align128(sizeof(bf16) * BK * LDH);
  static constexpr size_t p_off = s_off + align128(sizeof(float) * BQ * LDS);
  static constexpr size_t o_off = p_off + align128(sizeof(bf16) * BQ * LDP);
  static constexpr size_t m_off = o_off + align128(sizeof(float) * BQ * LDO);
  static constexpr size_t bytes = m_off + align128(sizeof(float) * BQ * 3);
};

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(BQ / 16 * 32)
flash_fwd_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      int sq, int sk, int d, float scale_log2) {
  using L = WideLayout<DP, BQ, BK>;
  constexpr int NT = L::NW * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p_off);
  float* sO = reinterpret_cast<float*>(smem + L::o_off);
  float* sM = reinterpret_cast<float*>(smem + L::m_off);  // running max (log2 units)
  float* sL = sM + BQ;                                    // running sum
  float* sA = sL + BQ;                                    // this tile's rescale

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  q += bh * sq * d;
  k += bh * sk * d;
  v += bh * sk * d;
  o += bh * sq * d;

  load_tile<DP, BQ, false>(sQ, L::LDH, q, q0, sq, d, tid, NT);
  for (int i = tid; i < BQ * L::LDO; i += NT) sO[i] = 0.f;
  for (int i = tid; i < BQ; i += NT) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }
  const int row0 = warp * 16;  // this warp's first query row in the tile

  for (int k0 = 0; k0 < sk; k0 += BK) {
    __syncthreads();  // previous tile's readers of sK/sV are done
    load_tile<DP, BK, false>(sK, L::LDH, k, k0, sk, d, tid, NT);
    load_tile<DP, BK, false>(sV, L::LDH, v, k0, sk, d, tid, NT);
    __syncthreads();

    // S (16 x BK) = Q_w (16 x DP) K^T
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, sQ + row0 * L::LDH + kk * 16, L::LDH);
        wmma::load_matrix_sync(b, sK + n * 16 * L::LDH + kk * 16, L::LDH);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sS + row0 * L::LDS + n * 16, acc, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile, one row at a time across the warp
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r;
      const float m_old = sM[row];
      float s[BK / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        int col = lane + 32 * j;
        s[j] = (k0 + col < sk) ? sS[row * L::LDS + col] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        float p = exp2f(s[j] - m_new);
        sum += p;
        sP[row * L::LDP + lane + 32 * j] = __float2bfloat16(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        sM[row] = m_new;
        sL[row] = sL[row] * alpha + sum;
        sA[row] = alpha;
      }
    }
    __syncwarp();

    // rescale this warp's output rows, then O_w += P_w (16 x BK) V (BK x DP)
    for (int i = lane; i < 16 * DP; i += 32) {
      int r = i / DP, c = i % DP;
      sO[(row0 + r) * L::LDO + c] *= sA[row0 + r];
    }
    __syncwarp();
#pragma unroll 1
    for (int n = 0; n < DP / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + row0 * L::LDO + n * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sP + row0 * L::LDP + kk * 16, L::LDP);
        wmma::load_matrix_sync(b, sV + kk * 16 * L::LDH + n * 16, L::LDH);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sO + row0 * L::LDO + n * 16, acc, L::LDO, wmma::mem_row_major);
    }
  }
  __syncwarp();

  for (int i = lane; i < 16 * d; i += 32) {
    int r = i / d, c = i % d;
    int row = q0 + row0 + r;
    if (row < sq)
      o[(size_t)row * d + c] = __float2bfloat16(sO[(row0 + r) * L::LDO + c] / sL[row0 + r]);
  }
}

template <int DP, int BQ, int BK>
cudaError_t launch_wide(const bf16* q, const bf16* k, const bf16* v, bf16* o, int bh, int sq,
                        int sk, int d, float scale, cudaStream_t stream) {
  using L = WideLayout<DP, BQ, BK>;
  auto kern = flash_fwd_wide_kernel<DP, BQ, BK>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::bytes));
  if (e != cudaSuccess) return e;
  dim3 grid((sq + BQ - 1) / BQ, bh);
  kern<<<grid, L::NW * 32, L::bytes, stream>>>(q, k, v, o, sq, sk, d,
                                                scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// q: (bh, sq, d), k and v: (bh, sk, d), o: (bh, sq, d), all bf16,
// contiguous and 16-byte aligned; d % 8 == 0 and ceil16(d) in {48, 80, 512}
// (the UNet's 40 and 80, the VAE's 512).
INSV2V_EXPORT int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                 int bh, int sq, int sk, int d, float scale, void* stream) {
  auto Q = static_cast<const bf16*>(q);
  auto K = static_cast<const bf16*>(k);
  auto V = static_cast<const bf16*>(v);
  auto O = static_cast<bf16*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // clear an unrelated earlier error of this runtime
  if (d % 8 != 0 || sq <= 0 || sk <= 0) return cudaErrorInvalidValue;
  switch ((d + 15) / 16 * 16) {
    case 48: return launch_reg<48>(Q, K, V, O, bh, sq, sk, d, scale, st);
    case 80: return launch_reg<80>(Q, K, V, O, bh, sq, sk, d, scale, st);
    case 512: return launch_wide<512, 32, 32>(Q, K, V, O, bh, sq, sk, d, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
