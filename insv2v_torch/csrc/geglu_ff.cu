// Fused LayerNorm + GEGLU feed-forward + residual for Hopper (sm_90a):
//   out = x + (h * gelu(g)) W2^T + b2,  [h | g] = LN(x) W1^T + b1
// with x (rows, C), W1 (2*inner, C) and W2 (C, inner) in the torch
// nn.Linear layout, all bf16; gelu is the exact erf form.
//
// Replaces the TPU kernels _ff_kernel_resident (C <= 640, weights resident
// in VMEM) and _ff_kernel (C > 640, weights streamed over inner blocks) of
// the JAX package's ops/fused_ff.py, both launched by fused_geglu_ff. One
// kernel serves every width here: the 16 MB VMEM residency has no
// counterpart in the 227 KB of shared memory a block may use.
//
// Bound on the H100: 2*rows*12*C^2 FLOPs against ~4*rows*C bytes of
// activations, i.e. 6*C FLOP/byte (>= 1920 at C = 320): bound by
// tensor-core operations, as long as the weights, which every row tile
// needs whole, are not re-read from L2 too often and reach the tensor
// cores without stalling them. What the design keeps off device memory
// is the 8C-wide GEGLU intermediate, as the TPU kernel did.
//
// Design. A cluster of R = C / 320 blocks (1, 2 or 4) owns a tile of 64
// rows, so a 64-row tile reads the weights from L2 once at every width;
// block r of the cluster keeps the f32 output columns [320 r, 320 (r+1))
// of those rows in registers for the whole kernel. Each block has two
// consumer warpgroups and one producer warp:
//  * the producer streams weight tiles into a ring of shared-memory slots
//    with TMA (one instruction per box, completion counted on a "full"
//    mbarrier; the consumers give a slot back on its "empty" mbarrier);
//  * the consumers normalise the 64 rows into shared memory (f32
//    statistics), then walk the inner dimension in chunks of NC (64, or
//    128 for the 4-block cluster): the block's NC / R columns of the
//    chunk's [h | g] on wgmma, bias and erf gelu in registers, the gated
//    bf16 values written into the shared memory of every block of the
//    cluster (distributed shared memory), a cluster barrier, then the
//    whole gated chunk times the block's 320 rows of W2's chunk on wgmma,
//    accumulated in registers (warpgroup w owns 160 output columns).
// Operands sit in shared memory in wgmma's swizzled K-major layouts: TMA
// writes the weight tiles swizzled (128 bytes for W1, 32 for W2), and the
// consumers write LN(x) and the gated chunk with the same 128-byte swizzle.
// Known cost of this version: every 64-row tile still re-reads all of W1
// and W2 from L2 (2.4 MB at C = 320, 39 MB at C = 1280); one cluster
// barrier per chunk; wgmma N is only 32 or 64 for [h | g]. Measured on the
// H100 on the way here: mma.sync with a block barrier per cp.async weight
// tile ran 1.3-1.6x slower; without the cluster (16-64 rows per block,
// the whole output row in registers) the L2 stream took 3.2 of 3.9 ms at
// C = 1280; one producer warp issuing cp.async instead of TMA was slower
// still; a bare fence.proxy.async in the tile loop doubles the time (it
// waits for the in-flight copies).
#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumerWarps = 8, kThreads = 256 + 32;
constexpr int BM = 64, KS2 = 16;
constexpr size_t kMaxSmem = 232448;

template <int C, int R>
struct FFLayout {
  // inner chunk width: 128 where the cluster is 4 wide, so that each
  // block's share of a chunk (GC) stays 32 columns
  static constexpr int NC = R >= 4 ? 128 : 64;
  static constexpr int CS = C / R, GC = NC / R;
  static constexpr int GBUF = BM * NC * 2;  // bytes of one gated-chunk buffer
  static constexpr int N1 = GC, N2 = CS / 2;
  // W1 tiles span KB 64-column blocks of C: two at C = 640 (fewer, larger
  // tiles per wait); one at C = 1280, whose LN(x) tile leaves room only for
  // small slots
  static constexpr int KB = (R == 2) ? 2 : 1, KS1 = 64 * KB;
  static constexpr int KT1 = C / KS1, KT2 = NC / KS2, TPC = KT1 + KT2;
  static constexpr int W1_BYTES = KB * 2 * GC * 128, W2_BYTES = CS * 32;
  // slots start on 1 KB boundaries: the 128-byte swizzle repeats every 1 KB
  static constexpr int SLOT = ((W1_BYTES > W2_BYTES ? W1_BYTES : W2_BYTES) + 1023) / 1024 * 1024;
  static constexpr size_t x_off = 0;                           // C / 64 blocks of 64 x 128 B
  static constexpr size_t g_off = x_off + (size_t)BM * C * 2;  // two gated-chunk buffers
  static constexpr size_t w_off = g_off + 2 * GBUF;
  // 1 KB for aligning the dynamic base to the swizzle atom, 1 KB for the
  // static barriers and slack
  static constexpr int FIT = (kMaxSmem - 2048 - w_off) / SLOT;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr size_t bytes = 1024 + w_off + (size_t)STAGES * SLOT;
  static_assert(STAGES >= 3 && STAGES <= 8 && bytes <= kMaxSmem, "shared memory");
  static_assert(C % R == 0 && GC % 16 == 0 && N2 % 8 == 0 && C % KS1 == 0, "tile shape");
};

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

template <int C, int R>
__global__ void __launch_bounds__(kThreads, 1)
geglu_ff_kernel(const __grid_constant__ CUtensorMap map_w1,
                const __grid_constant__ CUtensorMap map_w2, const bf16* __restrict__ x,
                const bf16* __restrict__ ln_w,
                const bf16* __restrict__ ln_b, const bf16* __restrict__ b1,
                const bf16* __restrict__ b2, bf16* __restrict__ out,
                int rows, int inner, float eps) {
  using T = FFLayout<C, R>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ uint64_t full[8], empty[8];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sXb = smem + T::x_off;
  unsigned char* sGb = smem + T::g_off;
  unsigned char* sWb = smem + T::w_off;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = (blockIdx.x / R) * BM;
  const int ntiles = (inner / T::NC) * T::TPC;

  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer warp: lane 0 streams the weight tiles with TMA ----
    // The producer takes part in the consumers' cluster barriers (start,
    // then one per chunk's gate) without holding them up: it arrives as
    // soon as it has issued what they need before the barrier (nothing for
    // the start, the chunk's W1 tiles for a gate) and waits for the phase
    // only before its next arrival.
    if (R > 1) cluster_arrive();
    for (int t = 0; t < ntiles; ++t) {
      const int slot = t % T::STAGES, round = t / T::STAGES;
      const int s = t % T::TPC;
      if (lane == 0) {
        const int j = t / T::TPC;
        mbar_wait(&empty[slot], (round & 1) ^ 1);
        unsigned char* dst = sWb + slot * T::SLOT;
        const int j0 = j * T::NC;
        if (s < T::KT1) {
          mbar_expect_tx(&full[slot], T::W1_BYTES);
          const int half = T::GC / 2;
#pragma unroll
          for (int kb = 0; kb < T::KB; ++kb) {
            const int k0 = s * T::KS1 + kb * 64;
            unsigned char* d = dst + kb * 2 * T::GC * 128;
#pragma unroll
            for (int w = 0; w < 2; ++w) {
              const int r0 = j0 + rank * T::GC + w * half;
              tma_load_2d(d + (w * T::GC) * 128, &map_w1, k0, r0, &full[slot]);
              tma_load_2d(d + (w * T::GC + half) * 128, &map_w1, k0, inner + r0, &full[slot]);
            }
          }
        } else {
          mbar_expect_tx(&full[slot], T::W2_BYTES);
          const int k0 = j0 + (s - T::KT1) * KS2;
#pragma unroll
          for (int w = 0; w < 2; ++w)
            tma_load_2d(dst + w * T::N2 * 32, &map_w2, k0, rank * T::CS + w * T::N2, &full[slot]);
        }
      }
      __syncwarp();
      if (R > 1 && s == T::KT1 - 1) {
        cluster_wait();    // the previous barrier (start, or the last gate)
        cluster_arrive();  // this chunk's gate
      }
    }
    if (R > 1) cluster_wait();
    return;
  }

  // ---- consumers: LayerNorm, then the two products on wgmma ----
  // LayerNorm of the row tile while the first tiles arrive: one warp per
  // row, the row in registers, two-pass f32 statistics.
  constexpr int V = C / 8;              // 16-byte vectors per row
  constexpr int VPL = (V + 31) / 32;    // vectors per lane
  for (int r = warp; r < BM; r += kConsumerWarps) {
    const int row = row0 + r;
    // 16-byte chunk v of row r: 64-column block v / 8, 128-byte swizzle
    auto dst_at = [&](int v) {
      return reinterpret_cast<uint4*>(sXb + (v / 8) * 8192 + r * 128 +
                                      (((v % 8) ^ (r % 8)) * 16));
    };
    if (row >= rows) {
      for (int v = lane; v < V; v += 32) *dst_at(v) = make_uint4(0, 0, 0, 0);
      continue;
    }
    const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)row * C);
    float vals[VPL][8];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = lane + 32 * i;
      uint4 u = v < V ? src[v] : make_uint4(0, 0, 0, 0);
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        vals[i][j] = __bfloat162float(e[j]);
        s += vals[i][j];
      }
    }
    const float mean = warp_sum(s) / C;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (lane + 32 * i >= V) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) ss += (vals[i][j] - mean) * (vals[i][j] - mean);
    }
    const float rstd = rsqrtf(warp_sum(ss) / C + eps);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = lane + 32 * i;
      if (v >= V) continue;
      uint4 wv = reinterpret_cast<const uint4*>(ln_w)[v];
      uint4 bv = reinterpret_cast<const uint4*>(ln_b)[v];
      const bf16* we = reinterpret_cast<const bf16*>(&wv);
      const bf16* be = reinterpret_cast<const bf16*>(&bv);
      uint4 o;
      uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float y0 = (vals[i][2 * j] - mean) * rstd * __bfloat162float(we[2 * j]) +
                         __bfloat162float(be[2 * j]);
        const float y1 = (vals[i][2 * j + 1] - mean) * rstd * __bfloat162float(we[2 * j + 1]) +
                         __bfloat162float(be[2 * j + 1]);
        op[j] = pack_bf16(y0, y1);
      }
      *dst_at(v) = o;
    }
  }
  fence_proxy_async();
  if constexpr (R > 1) cluster.sync(); else consumer_sync();

  const int wg = tid / 128, wl = warp % 4;
  const int c2 = 2 * (lane % 4);
  float acc1[T::N1 / 2];
  float acc2[T::N2 / 2];
#pragma unroll
  for (int i = 0; i < T::N2 / 2; ++i) acc2[i] = 0.f;
#pragma unroll
  for (int i = 0; i < T::N1 / 2; ++i) acc1[i] = 0.f;

  // In a cluster one wgmma group stays in flight: a tile's slot is given
  // back once the next tile's products are issued and the tile's are done.
  // A block alone waits for each tile's products (measured faster there).
  int pending = -1;
  auto release = [&](int slot) {
    if ((tid & 127) == 0) mbar_arrive(&empty[slot]);
  };
  for (int t = 0; t < ntiles; ++t) {
    const int slot = t % T::STAGES, round = t / T::STAGES;
    mbar_wait(&full[slot], round & 1);
    const unsigned char* w = sWb + slot * T::SLOT;
    const int s = t % T::TPC;
    unsigned char* gbuf = sGb + ((t / T::TPC) & 1) * T::GBUF;
    if (s < T::KT1) {
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < T::KB; ++kb)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // A: LN(x), 64-column block s*KB + kb; B: warpgroup wg's GC rows
          // of the tile (its h columns, then its g columns); k16 step kk
          const uint64_t da = gmma_desc(sXb + (s * T::KB + kb) * 8192 + kk * 32, 1, 1024);
          const uint64_t db = gmma_desc(w + (kb * 2 + wg) * T::GC * 128 + kk * 32, 1, 1024);
          WgmmaSS<T::N1>::run(acc1, da, db, (s > 0 || kb > 0 || kk > 0) ? 1 : 0);
        }
      wgmma_commit();
      if (R == 1 || s == T::KT1 - 1) {
        wgmma_wait_all();
        fence_regs(acc1);
        if (pending >= 0) release(pending);
        release(slot);
        pending = -1;
      } else {
        wgmma_wait_1();
        if (pending >= 0) release(pending);
        pending = slot;
      }
      if (s == T::KT1 - 1) {
        const int j0 = (t / T::TPC) * T::NC;
        constexpr int NB = T::N1 / 16;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const int col = rank * T::GC + wg * (T::GC / 2) + n * 8 + c2;
          const float2 bh =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + j0 + col));
          const float2 bg = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(b1 + inner + j0 + col));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float* hv = &acc1[4 * n + 2 * half];
            const float* gv = &acc1[4 * (n + NB) + 2 * half];
            const uint32_t val = pack_bf16((hv[0] + bh.x) * gelu_erf(gv[0] + bg.x),
                                           (hv[1] + bh.y) * gelu_erf(gv[1] + bg.y));
            const int row = wl * 16 + lane / 4 + 8 * half;  // 128-byte swizzle
            const int off = (col / 64) * 8192 + row * 128 +
                            ((((col % 64) / 8) ^ (row % 8)) * 16) + (col % 8) * 2;
            if constexpr (R == 1) {
              *reinterpret_cast<uint32_t*>(gbuf + off) = val;
            } else {
#pragma unroll
              for (int q = 0; q < R; ++q)
                *reinterpret_cast<uint32_t*>(cluster.map_shared_rank(gbuf, q) + off) = val;
            }
          }
        }
        fence_proxy_async();
        if constexpr (R > 1) cluster.sync(); else consumer_sync();
      }
    } else {
      const int kk = s - T::KT1;
      wgmma_fence();
      const uint64_t da = gmma_desc(gbuf + (kk / 4) * 8192 + (kk % 4) * 32, 1, 1024);
      const uint64_t db = gmma_desc(w + wg * T::N2 * 32, 3, 256);
      WgmmaSS<T::N2>::run(acc2, da, db, 1);
      wgmma_commit();
      if (R == 1) {
        wgmma_wait_all();
        release(slot);
      } else {
        wgmma_wait_1();
        if (pending >= 0) release(pending);
        pending = slot;
      }
    }
  }
  wgmma_wait_all();
  fence_regs(acc2);
  if (pending >= 0) release(pending);

#pragma unroll
  for (int n = 0; n < T::N2 / 8; ++n) {
    const int col = rank * T::CS + wg * T::N2 + n * 8 + c2;
    const float2 bo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + col));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + wl * 16 + lane / 4 + 8 * half;
      if (row >= rows) continue;
      const size_t off = (size_t)row * C + col;
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + off));
      *reinterpret_cast<uint32_t*>(out + off) = pack_bf16(
          xv.x + bo.x + acc2[4 * n + 2 * half], xv.y + bo.y + acc2[4 * n + 2 * half + 1]);
    }
  }
}

template <int C, int R>
cudaError_t launch(const bf16* x, const bf16* lw, const bf16* lb, const bf16* w1,
                   const bf16* b1, const bf16* w2, const bf16* b2, bf16* out, int rows,
                   int inner, float eps, cudaStream_t stream) {
  using T = FFLayout<C, R>;
  CUtensorMap m1, m2;
  if (!make_map(&m1, w1, 2 * (uint64_t)inner, C, T::GC / 2, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&m2, w2, C, inner, T::N2, KS2, CU_TENSOR_MAP_SWIZZLE_32B))
    return cudaErrorInvalidValue;
  auto kern = geglu_ff_kernel<C, R>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(T::bytes));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((rows + BM - 1) / BM) * R);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = T::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, m1, m2, x, lw, lb, b1, b2, out, rows, inner, eps);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// x, out: (rows, C); ln_w, ln_b, b2: (C,); w1: (2*inner, C); b1: (2*inner,);
// w2: (C, inner); all bf16, contiguous and 16-byte aligned.
// C in {320, 640, 1280} (the SD UNet widths), inner % 128 == 0.
INSV2V_EXPORT int geglu_ff_fwd(const void* x, const void* ln_w, const void* ln_b,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, int rows, int C, int inner,
                               float eps, void* stream) {
  cudaGetLastError();
  if (inner % 128 != 0 || inner <= 0 || rows <= 0) return cudaErrorInvalidValue;
  auto X = static_cast<const bf16*>(x);
  auto LW = static_cast<const bf16*>(ln_w);
  auto LB = static_cast<const bf16*>(ln_b);
  auto W1 = static_cast<const bf16*>(w1);
  auto B1 = static_cast<const bf16*>(b1);
  auto W2 = static_cast<const bf16*>(w2);
  auto B2 = static_cast<const bf16*>(b2);
  auto O = static_cast<bf16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 320: return launch<320, 1>(X, LW, LB, W1, B1, W2, B2, O, rows, inner, eps, st);
    case 640: return launch<640, 2>(X, LW, LB, W1, B1, W2, B2, O, rows, inner, eps, st);
    case 1280: return launch<1280, 4>(X, LW, LB, W1, B1, W2, B2, O, rows, inner, eps, st);
    default: return cudaErrorInvalidValue;
  }
}
