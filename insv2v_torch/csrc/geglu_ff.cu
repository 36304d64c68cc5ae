// Fused LayerNorm + GEGLU feed-forward + residual for Hopper (sm_90a):
//   out = x + (h * gelu(g)) W2^T + b2,  [h | g] = LN(x) W1^T + b1
// with x (rows, C), W1 (2*inner, C) and W2 (C, inner) in the torch
// nn.Linear layout, all bf16; LN with f32 two-pass statistics, rounded to
// bf16 once; [h | g] and the output accumulated in f32; gelu is the exact
// erf form; the gated value is rounded to bf16 once.
//
// Replaces the TPU kernels _ff_kernel_resident (C <= 640, weights resident
// in VMEM; the JAX package's ops/fused_ff.py:155) and _ff_kernel (C > 640,
// weights streamed over inner blocks; fused_ff.py:125), both launched by
// fused_geglu_ff.
//
// Bound on the H100: 2*rows*12*C^2 FLOPs against ~4*rows*C bytes of
// activations, 6*C FLOP/byte (>= 1920 at C = 320): bound by tensor-core
// operations, as long as the weights (24*C^2 bytes, which every row tile
// needs whole) do not come from L2 so often that the L2 stream outlasts
// the products. A design that reads them once per M rows moves
// 24*rows*C^2/M bytes from L2 per call.
//
// Design: two kernels launched back to back by geglu_ff_fwd, each a TMA +
// wgmma pipeline on 128-row tiles with two consumer warpgroups and one
// producer warp, so each weight box read from L2 feeds 128 rows:
// 0.1875*rows*C^2 bytes of weights per call (2.83 GB -> 1.42 GB at every
// full UNet shape of the edit).
//  * B-i, LN + GEMM1 + GEGLU, writing the gated (rows, inner) bf16 to a
//    scratch buffer. Its W1 boxes hold the h rows and the g rows of the
//    same inner columns (a 3D view of W1), so one product gives a thread h
//    and g of a column and the gate stays in registers.
//    - C <= 640 (ff_gate_res_kernel): LN(x) of the block's 128 rows stays
//      in shared memory; the warpgroups take turns (named barriers) on
//      alternate column tiles of 64 gated columns over all 128 rows
//      (m64n128k16), one issuing its products while the other runs its erf
//      epilogue; one 4- or 8-stage ring of 16 KB W1 boxes feeds both.
//    - C = 1280 (ff_gate_stream_kernel): LN(x) of 128 rows (320 KB) does
//      not fit, so raw x k-blocks stream beside 32 KB W1 boxes of 128
//      gated columns; each warpgroup normalises its own 64 rows of an x
//      k-block in place (statistics from a prologue) while its previous
//      k-block's m64n256k16 products run.
//  * B-ii (ff_out_kernel), GEMM2 + b2 + residual on 128 x 160 tiles
//    (m64n160k16), 64-deep W2 boxes in the 128-byte swizzle.
// No cluster and no cluster barrier: nothing crosses blocks but the
// scratch. The cost of the split is the gated intermediate, 16*rows*C
// bytes written and read back.
//
// What the single fused kernel could not do: it keeps the f32 output of
// its columns in registers across the whole inner dimension, and ptxas
// compiles these kernels at 168 registers a thread (setmaxnreg does not
// raise it), so 64 rows x 320 columns (160) plus a [h | g] accumulator do
// not fit; and LN(x) of 128 rows at C = 1280 does not fit shared memory.
// The previous design, 64-row tiles over a cluster of C / 320 blocks,
// read the weights from L2 once per 64 rows, met at a cluster barrier
// every chunk and ran [h | g] at N = 32 or 64 with 16-deep W2 tiles.
// Measured on an H100 80GB HBM3 at 700 W on the way here (kernel B at
// (73728, 320)): a 128-row fused kernel at C = 320 (64 rows and 320
// columns a warpgroup) 0.94 ms with setmaxnreg and 1.73 ms without (ptxas
// spilled 1.5 KB and serialised the wgmmas), against 0.85 for the previous
// design; B-ii on 128 x 320 tiles 1.47 ms (spilling) against 0.16 on
// 128 x 160; B-i with two accumulator sets in one warpgroup (the next
// tile's products issued around the gelu) 0.56 ms, ptxas serialising its
// wgmmas, against 0.43 with the two warpgroups taking turns; a ring per
// warpgroup instead of one shared ring, and 256-row blocks at N = 64
// (0.60 ms, 112 bytes spilled), both slower.
#include "hopper.cuh"

namespace {

constexpr int kBM = 128;         // rows of a tile: 64 per consumer warpgroup
constexpr int kBK = 64;          // k-block depth: one 128-byte swizzle row of bf16
constexpr int kBox2 = 160;       // rows of a W2 box, and N of a B-ii product
constexpr int kThreads = 288;    // two consumer warpgroups, then a producer warp
constexpr int kATile = kBM * kBK * 2;  // 16 KB: one 128 x 64 bf16 operand tile
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

// RB rows of a tile in one warp's registers, their loads in flight together:
// u[k][i] is the 16-byte vector lane + 32 i of row `row[k]` (zeros past the
// row's end or past `rows`), with the row's two-pass f32 mean and rstd.
template <int C, int RB>
struct RowBatch {
  static constexpr int V = C / 8, VPL = (V + 31) / 32;
  uint4 u[RB][VPL];
  float mean[RB], rstd[RB];
  bool valid[RB];

  __device__ __forceinline__ void load(const bf16* __restrict__ x, const int (&row)[RB],
                                       int rows, int lane, float eps) {
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      valid[k] = row[k] < rows;
      const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)row[k] * C);
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int v = lane + 32 * i;
        u[k][i] = valid[k] && v < V ? src[v] : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) s += at(k, i, e);
      const float m = warp_sum(s) / C;
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        if (lane + 32 * i >= V) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) ss += (at(k, i, e) - m) * (at(k, i, e) - m);
      }
      mean[k] = m;
      rstd[k] = rsqrtf(warp_sum(ss) / C + eps);
    }
  }
  __device__ __forceinline__ float at(int k, int i, int e) const {
    return __bfloat162float(reinterpret_cast<const bf16*>(&u[k][i])[e]);
  }
};

// rows per batch: as many as keep the batch within ~40 registers
template <int C>
constexpr int kRowBatch = C <= 640 ? 4 : 2;

// LN(x) of the tile's 128 rows into shared memory, bf16 in the 128-byte
// swizzle (k-block v / 8 of 128 rows x 64 columns at v / 8 * 16 KB; 16-byte
// chunk v % 8 of row r at r * 128 + 16 * ((v % 8) ^ (r % 8))); rows past
// `rows` are zeros. Warp w of the two consumer warpgroups takes rows w,
// w + 8, ...
template <int C>
__device__ __forceinline__ void ln_tile_to_smem(unsigned char* xs, const bf16* __restrict__ x,
                                                const bf16* __restrict__ ln_w,
                                                const bf16* __restrict__ ln_b, int row0, int rows,
                                                float eps, int warp, int lane) {
  constexpr int RB = kRowBatch<C>;
  using B = RowBatch<C, RB>;
  for (int r0 = warp; r0 < kBM; r0 += 8 * RB) {
    int row[RB];
#pragma unroll
    for (int k = 0; k < RB; ++k) row[k] = row0 + r0 + 8 * k;
    B b;
    b.load(x, row, rows, lane, eps);
#pragma unroll
    for (int i = 0; i < B::VPL; ++i) {
      const int v = lane + 32 * i;
      if (v >= B::V) continue;
      const uint4 wv = reinterpret_cast<const uint4*>(ln_w)[v];
      const uint4 bv = reinterpret_cast<const uint4*>(ln_b)[v];
      const bf16* we = reinterpret_cast<const bf16*>(&wv);
      const bf16* be = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        const int r = r0 + 8 * k;
        uint4 o = make_uint4(0, 0, 0, 0);
        if (b.valid[k]) {
          uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            op[q] = pack_bf16(
                (b.at(k, i, 2 * q) - b.mean[k]) * b.rstd[k] * __bfloat162float(we[2 * q]) +
                    __bfloat162float(be[2 * q]),
                (b.at(k, i, 2 * q + 1) - b.mean[k]) * b.rstd[k] * __bfloat162float(we[2 * q + 1]) +
                    __bfloat162float(be[2 * q + 1]));
        }
        *reinterpret_cast<uint4*>(xs + (v / 8) * kATile + r * 128 + (((v % 8) ^ (r % 8)) * 16)) =
            o;
      }
    }
  }
}

// --- B-i, C <= 640: LN(x) resident, GEMM1 + GEGLU -------------------------------
//
// LN(x) of the block's 128 rows stays in shared memory. The two consumer
// warpgroups take alternate column tiles of 64 gated columns (warpgroup w
// the block's tiles w, w + 2, ...), each over all 128 rows: two m64n128k16
// products per k16 step, one per half of the rows, on the same W1 box (the
// 64 h rows and the 64 g rows of the tile's inner columns: a 3D view of
// W1, 16 KB a k-block). Named barriers make the warpgroups take turns on
// the tensor cores: one issues its tile's products while the other runs its
// gelu epilogue, so the erf is hidden behind the other's products. The
// turns fix the order in which the k-blocks are read, so one ring, as deep
// as shared memory allows, feeds both.

template <int C>
struct GateResLayout {
  static constexpr int KB = C / kBK, COLS = 64;
  static constexpr int X_BYTES = KB * kATile;
  static constexpr int B_BYTES = 2 * COLS * kBK * 2;  // 16 KB: h rows, then g rows
  static constexpr int FIT = static_cast<int>((kMaxSmem - 2048 - X_BYTES) / B_BYTES);
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr size_t bytes = 1024 + X_BYTES + (size_t)STAGES * B_BYTES;
  static_assert(STAGES >= 4 && bytes + 2 * 8 * 8 <= kMaxSmem, "shared memory");
};

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
ff_gate_res_kernel(const __grid_constant__ CUtensorMap map_w1, const bf16* __restrict__ x,
                   const bf16* __restrict__ ln_w, const bf16* __restrict__ ln_b,
                   const bf16* __restrict__ b1, bf16* __restrict__ gated, int rows, int inner,
                   int nt, float eps) {
  using L = GateResLayout<C>;
  constexpr int KB = L::KB, ST = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ uint64_t full[8], empty[8];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem + L::X_BYTES;
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int row0 = blockIdx.y * kBM, n0 = blockIdx.x * nt;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 8) {
    // producer: k-block g = t * KB + kb of column tile t, in turn order
    if (lane == 0) {
      for (int g = 0; g < nt * KB; ++g) {
        const int s = g % ST;
        mbar_wait(&empty[s], ((g / ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::B_BYTES);
        tma_load_3d(ring + s * L::B_BYTES, &map_w1, (g % KB) * kBK, (n0 + g / KB) * L::COLS, 0,
                    &full[s]);
      }
    }
    return;
  }

  ln_tile_to_smem<C>(smem, x, ln_w, ln_b, row0, rows, eps, warp, lane);
  fence_proxy_async();
  consumer_sync();

  const int wg = warp / 4, wl = warp % 4, c2 = 2 * (lane % 4), wtid = tid % 128;
  // turns on the tensor cores: barrier 2 + w opens warpgroup w's next turn
  auto give_turn = [&]() {
    if (wg == 0) named_arrive<3, 256>(); else named_arrive<2, 256>();
  };
  auto take_turn = [&]() {
    if (wg == 0) named_sync<2, 256>(); else named_sync<3, 256>();
  };
  float acc[2][64];  // [h | g] of rows 0-63 and 64-127: 64 gated columns
  for (int t = wg; t < nt; t += 2) {
    if (t > 0) take_turn();
    int prev = 0;
    for (int kb = 0; kb < KB; ++kb) {
      const int g = t * KB + kb, s = g % ST;
      mbar_wait(&full[s], (g / ST) & 1);
      const unsigned char* bt = ring + s * L::B_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          WgmmaSS<128>::run(acc[h], gmma_desc(smem + kb * kATile + h * 8192 + kk * 32, 1, 1024),
                            gmma_desc(bt + kk * 32, 1, 1024), (kb > 0 || kk > 0) ? 1 : 0);
      wgmma_commit();
      wgmma_wait_1();  // the k-block before: its slot goes back
      if (kb > 0 && wtid == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    if (t + 1 < nt) give_turn();  // the other warpgroup's products queue behind these
    wgmma_wait_all();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (wtid == 0) mbar_arrive(&empty[prev]);

    // epilogue: h in columns 0..63, g of the same inner column 64 later
    const int j0 = (n0 + t) * L::COLS;
#pragma unroll
    for (int nb = 0; nb < L::COLS / 8; ++nb) {
      const int col = j0 + nb * 8 + c2;
      const float2 bh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + col));
      const float2 bg =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + inner + col));
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + h * 64 + wl * 16 + lane / 4 + 8 * half, e = 4 * nb + 2 * half;
          const uint32_t val =
              pack_bf16((acc[h][e] + bh.x) * gelu_erf(acc[h][e + 32] + bg.x),
                        (acc[h][e + 1] + bh.y) * gelu_erf(acc[h][e + 33] + bg.y));
          if (row < rows) *reinterpret_cast<uint32_t*>(gated + (size_t)row * inner + col) = val;
        }
    }
  }
}

// --- B-i, C = 1280: x streamed, LN + GEMM1 + GEGLU ------------------------------
//
// LN(x) of 128 rows at C = 1280 (320 KB) does not fit shared memory: the
// producer streams raw x k-blocks beside W1 k-blocks of [h | g] for 128
// gated columns (32 KB); each warpgroup normalises its own 64 rows of an x
// k-block in place (statistics from a prologue) while its previous
// k-block's products run, then runs m64n256k16 on it.

struct GateStreamLayout {
  static constexpr int COLS = 128;
  static constexpr int B_BYTES = 2 * COLS * kBK * 2;  // 32 KB
  static constexpr int STAGE = kATile + B_BYTES;
  static constexpr int STAGES = 4;
  static constexpr size_t stats_off = (size_t)STAGES * STAGE;
  static constexpr size_t bytes = 1024 + stats_off + 2 * kBM * sizeof(float);
  static_assert(bytes + 2 * STAGES * 8 <= kMaxSmem, "shared memory");
};

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
ff_gate_stream_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w1, const bf16* __restrict__ x,
                      const bf16* __restrict__ ln_w, const bf16* __restrict__ ln_b,
                      const bf16* __restrict__ b1, bf16* __restrict__ gated, int rows,
                      int inner, int nt, float eps) {
  using L = GateStreamLayout;
  constexpr int KB = C / kBK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ uint64_t full[L::STAGES], empty[L::STAGES];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* s_mean = reinterpret_cast<float*>(smem + L::stats_off);
  float* s_rstd = s_mean + kBM;
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int row0 = blockIdx.y * kBM, n0 = blockIdx.x * nt;

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 8) {
    if (lane == 0) {
      for (int g = 0; g < nt * KB; ++g) {
        const int s = g % L::STAGES, kb = g % KB;
        unsigned char* st = smem + s * L::STAGE;
        mbar_wait(&empty[s], ((g / L::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::STAGE);
        tma_load_2d(st, &map_x, kb * kBK, row0, &full[s]);
        tma_load_3d(st + kATile, &map_w1, kb * kBK, (n0 + g / KB) * L::COLS, 0, &full[s]);
      }
    }
    return;
  }

  // row statistics: warp w takes rows w, w + 8, ...; rows past the end get
  // (0, 0), so their LN is the bias
  constexpr int RB = kRowBatch<C>;
  for (int r0 = warp; r0 < kBM; r0 += 8 * RB) {
    int row[RB];
#pragma unroll
    for (int k = 0; k < RB; ++k) row[k] = row0 + r0 + 8 * k;
    RowBatch<C, RB> b;
    b.load(x, row, rows, lane, eps);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        s_mean[r0 + 8 * k] = b.valid[k] ? b.mean[k] : 0.f;
        s_rstd[r0 + 8 * k] = b.valid[k] ? b.rstd[k] : 0.f;
      }
    }
  }
  consumer_sync();

  // this thread normalises the 16-byte chunk j (8 columns) of the rows
  // 64 wg + wtid / 8 + 16 q of each x k-block; TMA's 128-byte swizzle puts
  // chunk j of row r at r * 128 + 16 * (j ^ (r % 8))
  const int wg = warp / 4, wl = warp % 4, wtid = tid % 128, c2 = 2 * (lane % 4);
  const int j = wtid % 8;
  float nm[4], nr[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    nm[q] = s_mean[64 * wg + wtid / 8 + 16 * q];
    nr[q] = s_rstd[64 * wg + wtid / 8 + 16 * q];
  }
  auto normalise = [&](unsigned char* a, int kb) {
    const int c0 = kb * kBK + 8 * j;
    const uint4 wv = *reinterpret_cast<const uint4*>(ln_w + c0);
    const uint4 bv = *reinterpret_cast<const uint4*>(ln_b + c0);
    const bf16* we = reinterpret_cast<const bf16*>(&wv);
    const bf16* be = reinterpret_cast<const bf16*>(&bv);
    uint4 v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 64 * wg + wtid / 8 + 16 * q;
      v[q] = *reinterpret_cast<const uint4*>(a + r * 128 + ((j ^ (r & 7)) << 4));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 64 * wg + wtid / 8 + 16 * q;
      const bf16* xe = reinterpret_cast<const bf16*>(&v[q]);
      uint4 o;
      uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        op[e] = pack_bf16(
            (__bfloat162float(xe[2 * e]) - nm[q]) * nr[q] * __bfloat162float(we[2 * e]) +
                __bfloat162float(be[2 * e]),
            (__bfloat162float(xe[2 * e + 1]) - nm[q]) * nr[q] * __bfloat162float(we[2 * e + 1]) +
                __bfloat162float(be[2 * e + 1]));
      *reinterpret_cast<uint4*>(a + r * 128 + ((j ^ (r & 7)) << 4)) = o;
    }
    fence_proxy_async();  // the stores, before this warpgroup's wgmma reads
    if (wg == 0) named_sync<2, 128>(); else named_sync<3, 128>();
  };

  const int rbase = row0 + wg * 64 + wl * 16 + lane / 4;
  float acc[L::COLS];  // [h | g]: 64 rows x 256 columns of the warpgroup
  int g = 0;
  for (int i = 0; i < nt; ++i) {
    int prev = 0;
    for (int kb = 0; kb < KB; ++kb, ++g) {
      const int s = g % L::STAGES;
      mbar_wait(&full[s], (g / L::STAGES) & 1);
      unsigned char* st = smem + s * L::STAGE;
      normalise(st, kb);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaSS<256>::run(acc, gmma_desc(st + wg * 8192 + kk * 32, 1, 1024),
                          gmma_desc(st + kATile + kk * 32, 1, 1024), (kb > 0 || kk > 0) ? 1 : 0);
      wgmma_commit();
      wgmma_wait_1();  // the k-block before: its slot goes back
      if (kb > 0 && (tid & 127) == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait_all();
    fence_regs(acc);
    if ((tid & 127) == 0) mbar_arrive(&empty[prev]);

    // epilogue: h in columns 0..127, g of the same inner column 128 later
    const int j0 = (n0 + i) * L::COLS;
#pragma unroll
    for (int nb = 0; nb < L::COLS / 8; ++nb) {
      const int col = j0 + nb * 8 + c2;
      const float2 bh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + col));
      const float2 bg =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + inner + col));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = rbase + 8 * half, e = 4 * nb + 2 * half;
        const uint32_t val =
            pack_bf16((acc[e] + bh.x) * gelu_erf(acc[e + L::COLS / 2] + bg.x),
                      (acc[e + 1] + bh.y) * gelu_erf(acc[e + L::COLS / 2 + 1] + bg.y));
        if (row < rows) *reinterpret_cast<uint32_t*>(gated + (size_t)row * inner + col) = val;
      }
    }
  }
}

// --- B-ii: GEMM2 + b2 + residual ----------------------------------------------
//
// A tile is 128 rows x 160 output columns (320 would need 160 f32
// registers a thread for the output alone: measured spilling 1.4 KB and
// serialising the wgmmas); the gated k-blocks and W2 boxes (160 rows x 64
// deep) stream through a 6-stage ring, each warpgroup accumulates its 64
// rows (m64n160k16) and the epilogue adds x and b2 and rounds once.

struct OutLayout {
  static constexpr int STAGE = kATile + kBox2 * kBK * 2;  // gated k-block + W2 k-block
  static constexpr int STAGES = 6;
  static constexpr size_t bytes = 1024 + (size_t)STAGES * STAGE;
  static_assert(bytes + 2 * STAGES * 8 <= kMaxSmem, "shared memory");
};

__global__ void __launch_bounds__(kThreads, 1)
ff_out_kernel(const __grid_constant__ CUtensorMap map_g, const __grid_constant__ CUtensorMap map_w2,
              const bf16* __restrict__ x, const bf16* __restrict__ b2, bf16* __restrict__ out,
              int rows, int C, int inner) {
  using L = OutLayout;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ uint64_t full[L::STAGES], empty[L::STAGES];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBox2;
  const int KB = inner / kBK;

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 8) {
    if (lane == 0) {
      for (int kb = 0; kb < KB; ++kb) {
        const int s = kb % L::STAGES;
        unsigned char* st = smem + s * L::STAGE;
        mbar_wait(&empty[s], ((kb / L::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::STAGE);
        tma_load_2d(st, &map_g, kb * kBK, row0, &full[s]);
        tma_load_2d(st + kATile, &map_w2, kb * kBK, col0, &full[s]);
      }
    }
    return;
  }

  const int wg = warp / 4, wl = warp % 4, c2 = 2 * (lane % 4);
  float acc[kBox2 / 2];
  int prev = 0;
  for (int kb = 0; kb < KB; ++kb) {
    const int s = kb % L::STAGES;
    mbar_wait(&full[s], (kb / L::STAGES) & 1);
    const unsigned char* st = smem + s * L::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaSS<kBox2>::run(acc, gmma_desc(st + wg * 8192 + kk * 32, 1, 1024),
                          gmma_desc(st + kATile + kk * 32, 1, 1024), (kb > 0 || kk > 0) ? 1 : 0);
    wgmma_commit();
    wgmma_wait_1();
    if (kb > 0 && (tid & 127) == 0) mbar_arrive(&empty[prev]);
    prev = s;
  }
  wgmma_wait_all();
  fence_regs(acc);

  const int rbase = row0 + wg * 64 + wl * 16 + lane / 4;
#pragma unroll
  for (int n = 0; n < kBox2 / 8; ++n) {
    const int col = col0 + n * 8 + c2;
    const float2 bo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + col));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = rbase + 8 * half;
      if (row >= rows) continue;
      const size_t off = (size_t)row * C + col;
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + off));
      *reinterpret_cast<uint32_t*>(out + off) =
          pack_bf16(xv.x + bo.x + acc[4 * n + 2 * half], xv.y + bo.y + acc[4 * n + 2 * half + 1]);
    }
  }
}

// --- launchers ------------------------------------------------------------------

// gated columns of a B-i column tile: 64 where LN(x) stays resident, else 128
constexpr int gate_cols(int C) { return C <= 640 ? 64 : 128; }

// The grids at (rows, C, inner) on `sms` SMs. B-i: `nt` column tiles per
// block (a divisor of inner / gate_cols), the one that makes
// ceil(blocks / sms) * (nt + fixed) least, where `fixed` is the block's
// start in column tiles (1 where it writes LN(x) of its rows to shared
// memory, 1/2 where it only takes their statistics). B-ii: one block per
// 128 rows and 160 output columns.
struct FFGrid {
  int nt, gate_blocks, out_blocks;
};

FFGrid ff_grid(int rows, int C, int inner, int sms) {
  const int tiles = (rows + kBM - 1) / kBM, ntiles = inner / gate_cols(C);
  const int fixed2 = C <= 640 ? 2 : 1;  // twice `fixed`
  FFGrid f = {1, tiles * ntiles, tiles * (C / kBox2)};
  long best = -1;
  for (int nt = 1; nt <= ntiles; ++nt) {
    if (ntiles % nt) continue;
    const long blocks = (long)tiles * (ntiles / nt);
    const long cost = (blocks + sms - 1) / sms * (2 * nt + fixed2);
    if (best < 0 || cost <= best) {
      best = cost;
      f.nt = nt;
      f.gate_blocks = static_cast<int>(blocks);
    }
  }
  return f;
}

// W1 (2*inner, C) as two (inner, C) matrices, h then g: boxes of `cols`
// rows of each (2 * cols rows of 128 bytes in shared memory)
bool w1_map(CUtensorMap* m, const bf16* w1, int C, int inner, int cols) {
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)inner, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)inner * C * 2};
  const cuuint32_t box[3] = {kBK, (cuuint32_t)cols, 2};
  return make_map_nd(m, w1, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename K>
cudaError_t smem_attr(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int C>
cudaError_t launch_gate(const bf16* x, const bf16* lw, const bf16* lb, const bf16* w1,
                        const bf16* b1, bf16* gated, int rows, int inner, int nt, float eps,
                        cudaStream_t stream) {
  const dim3 grid(inner / gate_cols(C) / nt, (rows + kBM - 1) / kBM);
  CUtensorMap mw1;
  if (!w1_map(&mw1, w1, C, inner, gate_cols(C))) return cudaErrorInvalidValue;
  cudaError_t e;
  if constexpr (C <= 640) {
    using L = GateResLayout<C>;
    if ((e = smem_attr(ff_gate_res_kernel<C>, L::bytes)) != cudaSuccess) return e;
    ff_gate_res_kernel<C><<<grid, kThreads, L::bytes, stream>>>(mw1, x, lw, lb, b1, gated, rows,
                                                                inner, nt, eps);
  } else {
    using L = GateStreamLayout;
    CUtensorMap mx;
    if (!make_map(&mx, x, rows, C, kBM, kBK, CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
    if ((e = smem_attr(ff_gate_stream_kernel<C>, L::bytes)) != cudaSuccess) return e;
    ff_gate_stream_kernel<C><<<grid, kThreads, L::bytes, stream>>>(mx, mw1, x, lw, lb, b1, gated,
                                                                   rows, inner, nt, eps);
  }
  return cudaGetLastError();
}

cudaError_t launch_out(const bf16* gated, const bf16* w2, const bf16* x, const bf16* b2,
                       bf16* out, int rows, int C, int inner, cudaStream_t stream) {
  using L = OutLayout;
  CUtensorMap mg, mw2;
  if (!make_map(&mg, gated, rows, inner, kBM, kBK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&mw2, w2, C, inner, kBox2, kBK, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  cudaError_t e = smem_attr(ff_out_kernel, L::bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(C / kBox2, (rows + kBM - 1) / kBM);
  ff_out_kernel<<<grid, kThreads, L::bytes, stream>>>(mg, mw2, x, b2, out, rows, C, inner);
  return cudaGetLastError();
}

bool ff_shape_ok(int rows, int C, int inner) {
  return rows > 0 && inner > 0 && inner % 128 == 0 && (C == 320 || C == 640 || C == 1280);
}

}  // namespace

// x, out: (rows, C); ln_w, ln_b, b2: (C,); w1: (2*inner, C); b1: (2*inner,);
// w2: (C, inner); gated: (rows, inner) scratch for the GEGLU intermediate;
// all bf16, contiguous and 16-byte aligned. C in {320, 640, 1280} (the SD
// UNet widths), inner % 128 == 0.
INSV2V_EXPORT int geglu_ff_fwd(const void* x, const void* ln_w, const void* ln_b,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, void* gated, int rows, int C,
                               int inner, float eps, void* stream) {
  cudaGetLastError();  // clear an unrelated earlier error of this runtime
  if (!ff_shape_ok(rows, C, inner)) return cudaErrorInvalidValue;
  auto X = static_cast<const bf16*>(x);
  auto LW = static_cast<const bf16*>(ln_w);
  auto LB = static_cast<const bf16*>(ln_b);
  auto W1 = static_cast<const bf16*>(w1);
  auto B1 = static_cast<const bf16*>(b1);
  auto W2 = static_cast<const bf16*>(w2);
  auto B2 = static_cast<const bf16*>(b2);
  auto O = static_cast<bf16*>(out);
  auto G = static_cast<bf16*>(gated);
  auto st = static_cast<cudaStream_t>(stream);
  const FFGrid f = ff_grid(rows, C, inner, sm_count());
  cudaError_t e;
  switch (C) {
    case 320: e = launch_gate<320>(X, LW, LB, W1, B1, G, rows, inner, f.nt, eps, st); break;
    case 640: e = launch_gate<640>(X, LW, LB, W1, B1, G, rows, inner, f.nt, eps, st); break;
    default: e = launch_gate<1280>(X, LW, LB, W1, B1, G, rows, inner, f.nt, eps, st); break;
  }
  if (e != cudaSuccess) return e;
  return launch_out(G, W2, X, B2, O, rows, C, inner, st);
}

// The grids geglu_ff_fwd launches at (rows, C, inner) on the current
// device: out[0] gated columns of a B-i column tile, out[1] column tiles
// per B-i block, out[2] B-i blocks, out[3] B-ii blocks (of 128 rows x 160
// output columns).
INSV2V_EXPORT int geglu_ff_grid(int rows, int C, int inner, int* out) {
  if (!ff_shape_ok(rows, C, inner)) return cudaErrorInvalidValue;
  const FFGrid f = ff_grid(rows, C, inner, sm_count());
  out[0] = gate_cols(C);
  out[1] = f.nt;
  out[2] = f.gate_blocks;
  out[3] = f.out_blocks;
  return cudaSuccess;
}
