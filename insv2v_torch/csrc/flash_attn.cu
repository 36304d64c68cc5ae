// Flash attention forward for Hopper (sm_90a): bf16 q, k, v, f32 online
// softmax, bf16 out.
//
// Replaces the TPU kernels _flash_kernel and _flash_kernel_headfold of the
// JAX package's ops/attention.py (launched by flash_attention). It computes, per
// (batch*head, query block), softmax(q k^T * scale) v with a running max,
// sum and f32 accumulator over key tiles; keys past Sk are masked to -inf.
//
// Bound on the H100: at the UNet shapes (S = 1536 or 384, d = 40 or 80;
// ModelScope's S = 1024 or 256 at d = 64) the work is ~4*S*S*d FLOPs
// against 4*S*d*2 bytes, S/2 FLOP/byte, above the card's ~295 FLOP/byte
// balance point at S = 1536 and 1024 (bound by tensor-core operations; at
// d = 40 the S*S exponentials of the softmax weigh as much as the products)
// and below it at S = 384 and 256 (bound by bytes); the VAE mid-block
// (d = 512, S = 1536) is bound by operations.
//
// Every block has one producer warpgroup and two or three consumer
// warpgroups of 64 query rows each. A producer thread streams Q once per
// work item and K/V tiles into a ring with TMA (completion on "full"
// mbarriers; K and V slots given back apart on "empty" ones); the consumers
// run Q K^T on wgmma with both operands in shared memory, the online
// softmax on the wgmma accumulator layout in registers (one ex2 per
// element), and P V on wgmma with P rounded to bf16 in registers (the
// accumulator layout of two adjacent 8-key blocks is the A-fragment layout
// of 16 keys) and V read transposed (it is (keys, d) row-major, N
// contiguous). O accumulates in f32 in registers; the epilogue divides by
// the row sum and writes bf16 straight from registers. The producer gives
// registers to the consumers (setmaxnreg).
//
//  * d = 40 and 80 (kernels A and A'): 64-key tiles in a 3- or 4-stage
//    ring. Operands are TMA boxes of 64 columns in the 128-byte swizzle,
//    zero past column d (TMA's out-of-bound fill: nothing is padded in
//    device memory), so Q K^T contracts over 48 or 80 and P V is m64n48 or
//    m64n80 (part of a swizzle atom). Each warpgroup pipelines its tiles:
//    Q K^T of tile t + 1 and P V of tile t are in flight while the softmax
//    of tile t + 1 runs. The warpgroups of a block share one K/V ring (one
//    head, query rows 64 apart), so a K/V tile crosses from L2 once per 128
//    or 192 queries: the kernel is bound by that traffic, not by the
//    products, when every warpgroup has its own ring. Kernel A is
//    persistent (one block per SM over the (batch*head, query block)
//    pairs); kernel A' gives a block one batch and walks its heads, its
//    producer loading the next head's Q and K/V while the consumers finish
//    the current one, and where those blocks are too few to fill the card
//    it gives each of two warpgroups its own ring and heads w, w + 2, ...
//    over 64-query blocks. One item runs the same instructions in every
//    variant, so A' equals A bit for bit.
//  * d = 64 (ModelScope's UNetSD, kernels A and A'; flash_fwd64_kernel): a
//    body of its own on the same pipeline. Work items of 128 query rows (two
//    warpgroups), which divide ModelScope's S = 1024 and 256 where the d = 40
//    body's 192 left 12.5 % and 50 % of the rows on TMA's zero fill;
//    and 128-key tiles (one 16 KB box each for K and V, four stages), which
//    halve the barriers, max and rescale steps and wgmma batches per key.
//    One P fragment buffer (P of tile t + 1 is packed once P V of tile t
//    has read the registers) keeps a consumer thread in the 168 registers
//    of a block with a producer warp. A' walks a batch's heads with the same
//    item body, split over as many blocks as fill the SMs once.
//  * d = 512 (VAE): O (64 x 512 f32) does not fit one warpgroup's registers.
//    The two warpgroups share the block's 64 query rows, each owning 256
//    columns of O (128 accumulators a thread); Q K^T is split over the
//    depth, each warpgroup contracting its 256 of d on its half of the K
//    tile, and the partial 64 x 32 sums are exchanged through shared memory
//    (double-buffered, one named barrier per tile). Both add the same two
//    partials and run the same softmax, so both hold the same P. 32-key
//    tiles, 128-byte swizzle, double-buffered K and V.
#include "hopper.cuh"

namespace {

constexpr int kBM = 64;  // query rows per consumer warpgroup
constexpr int kProducerRegs = 24;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxStages = 4;

// One producer/consumer pipeline's barriers: two Q slots and a ring of K
// and V stages; K and V slots are given back apart (K after Q K^T, V after
// P V), so the next K load starts half a tile earlier.
struct Stream {
  uint64_t qfull[2], qempty[2];
  uint64_t kfull[kMaxStages], vfull[kMaxStages], kempty[kMaxStages], vempty[kMaxStages];
};

__device__ __forceinline__ void init_stream(Stream& s, int consumers) {
  for (int i = 0; i < 2; ++i) {
    mbar_init(&s.qfull[i], 1);
    mbar_init(&s.qempty[i], 1);
  }
  for (int i = 0; i < kMaxStages; ++i) {
    mbar_init(&s.kfull[i], 1);
    mbar_init(&s.vfull[i], 1);
    mbar_init(&s.kempty[i], consumers);
    mbar_init(&s.vempty[i], consumers);
  }
}

__device__ __forceinline__ float ex2(float x) {  // one MUFU op; x <= 0 here
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one key tile on the m64nBK accumulator layout: rows
// g and g + 8 of this warp's 16 (g = lane / 4), keys 8j + 2(lane % 4) + {0, 1}.
// Masks keys past sk, updates the running max (of the raw logits) and the
// running sum, leaves exp2((s - max) * scale_log2) in s and each row's
// rescale in alpha.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2], int kbase,
                                             int sk, float scale_log2, int lane) {
  const int c2 = 2 * (lane % 4);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if (kbase + BK > sk && kbase + 8 * (i / 4) + c2 + (i & 1) >= sk) s[i] = -INFINITY;
    mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
  }
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);  // finite: tile 0 has a key
    alpha[r] = ex2(__fmul_rn(m_run[r] - m_new, scale_log2));
    m_run[r] = m_new;
    ms[r] = __fmul_rn(m_new, scale_log2);
    l_run[r] = __fmul_rn(l_run[r], alpha[r]);
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] = ex2(__fmaf_rn(s[i], scale_log2, -ms[(i % 4) / 2]));
    l_run[(i % 4) / 2] += s[i];
  }
}

// P's A fragments for wgmma: 16 keys kk*16.. of rows g, g + 8 as bf16 pairs
template <int BK>
__device__ __forceinline__ void p_fragments(uint32_t (&pa)[BK / 16][4], const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i % 4) / 2];
}

// Writes rows q0 + 16 * wl + g (+ 8) < sq of this warpgroup's O columns
// [c0, c0 + 2N) (< d) divided by the row sums.
template <int N>
__device__ __forceinline__ void store_rows(bf16* __restrict__ o, const float (&acc)[N],
                                           float (&l_run)[2], int q0, int sq, int d, int c0,
                                           int wl, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    l_run[r] = 1.f / l_run[r];
  }
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int col = c0 + 8 * j + 2 * (lane % 4);
    if (col >= d) continue;  // d is even: a pair is all in or all out
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * wl + lane / 4 + 8 * r;
      if (row < sq)
        *reinterpret_cast<uint32_t*>(o + (size_t)row * d + col) =
            pack_bf16(acc[4 * j + 2 * r] * l_run[r], acc[4 * j + 2 * r + 1] * l_run[r]);
    }
  }
}

// --- d = 40 and 80 ----------------------------------------------------------

template <int DP, int NWG, bool SPLIT>
struct Narrow {
  // 64-key tiles; operands in TMA boxes of 64 columns (128-byte rows, the
  // 128-byte swizzle), zero past column d; Q K^T contracts over DP (k16
  // steps inside the boxes), P V is m64nDP over ceil(DP / 64) swizzle atoms
  static constexpr int BK = 64, NB = (DP + 63) / 64, KS = DP / 16;
  static constexpr int NR = SPLIT ? NWG : 1;  // K/V rings
  // Q slots per warpgroup and ring stages that fit shared memory
  static constexpr int QS = (NB == 1 || !SPLIT) ? 2 : 1, ST = (NB == 1 || !SPLIT) ? 4 : 3;
  static constexpr int Q_BYTES = NB * kBM * 128, KV_BYTES = NB * BK * 128;
  static constexpr int QREGION = NWG * QS * Q_BYTES, RING = 2 * ST * KV_BYTES;
  static constexpr size_t bytes = 1024 + (size_t)QREGION + (size_t)NR * RING;
  static constexpr int THREADS = (NWG + 1) * 128;
  // a consumer thread's registers once the producer warpgroup has given
  // back all but 24: 65536 / 384 rounded to 8 leaves 240, 65536 / 512 160
  static constexpr int CREGS = NWG == 2 ? 240 : 160;
  static_assert(DP % 16 == 0 && DP <= 128 && (NWG == 2 || NWG == 3), "tile shape");
  static_assert(ST <= kMaxStages && bytes + NWG * sizeof(Stream) <= 232448, "shared memory");
  __device__ static unsigned char* q_slot(unsigned char* smem, int w, int qs) {
    return smem + (w * QS + qs) * Q_BYTES;
  }
  __device__ static unsigned char* k_tile(unsigned char* smem, int r, int st) {
    return smem + QREGION + r * RING + st * KV_BYTES;
  }
  __device__ static unsigned char* v_tile(unsigned char* smem, int r, int st) {
    return smem + QREGION + r * RING + (ST + st) * KV_BYTES;
  }
};

// Work item i of consumer warpgroup w: (batch*head, first query row), or
// false past its last. A block either shares one K/V ring between its NWG
// warpgroups, which then take the same head and query rows
// 64 (NWG x + w) (some past sq in the last query block: computed on TMA's
// zero rows, not stored), or gives each warpgroup a ring of its own (SPLIT,
// kernel A' only), warpgroup w taking heads w, w + NWG, ... at query rows
// 64 x. Kernel A is persistent (one block per SM walks the (batch*head,
// query block) pairs, its producer loading the next pair's Q and K/V
// while the consumers finish the current one); kernel A' walks every head
// of batch y at query block x. (`heads` is batch*heads for kernel A.)
template <bool HEADFOLD, int NWG, bool SPLIT>
__device__ __forceinline__ bool work_item(int i, int w, int heads, int sq, int& bh, int& q0) {
  if (!HEADFOLD) {  // persistent: (batch*head, query block) pairs x, x + grid, ...
    const int blocks = (sq + NWG * kBM - 1) / (NWG * kBM);
    const int item = blockIdx.x + i * gridDim.x;
    bh = item / blocks;
    q0 = ((item % blocks) * NWG + w) * kBM;
    return item < heads * blocks;
  }
  const int h = SPLIT ? w + NWG * i : i;
  bh = blockIdx.y * heads + h;
  q0 = SPLIT ? blockIdx.x * kBM : (blockIdx.x * NWG + w) * kBM;
  return h < heads;
}

template <int DP, bool HEADFOLD, int NWG, bool SPLIT>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o, int heads,
                 int sq, int sk, int d, float scale_log2) {
  using L = Narrow<DP, NWG, SPLIT>;
  constexpr int BK = L::BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ Stream bars[NWG];  // Q barriers of warpgroup w; ring w's barriers
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // the warp index through a shuffle: ptxas then treats it (and the roles,
  // work items and loops derived from it) as warp-uniform, and keeps the
  // wgmma pipeline instead of serialising it on a divergent path
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int ntiles = (sk + BK - 1) / BK;

  if (tid == 0) {
    for (int w = 0; w < NWG; ++w) init_stream(bars[w], SPLIT ? 1 : NWG);
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // ---- producer warpgroup: warp 4 NWG + r feeds ring r (one thread) ----
    regs_dealloc<kProducerRegs>();
    const int r = warp - 4 * NWG;
    if (r < L::NR && lane == 0) {
      Stream& b = bars[r];
      int bh, q0, g = 0;
      for (int i = 0; work_item<HEADFOLD, NWG, SPLIT>(i, r, heads, sq, bh, q0); ++i) {
        const int qs = i % L::QS;
        // Q of each warpgroup this ring feeds
        for (int w = r; w < (SPLIT ? r + 1 : NWG); ++w) {
          Stream& bq = bars[w];
          work_item<HEADFOLD, NWG, SPLIT>(i, w, heads, sq, bh, q0);
          mbar_wait(&bq.qempty[qs], ((i / L::QS) & 1) ^ 1);
          mbar_expect_tx(&bq.qfull[qs], L::Q_BYTES);
#pragma unroll
          for (int c = 0; c < L::NB; ++c)
            tma_load_3d(L::q_slot(smem, w, qs) + c * kBM * 128, &map_q, 64 * c, q0, bh,
                        &bq.qfull[qs]);
        }
        for (int t = 0; t < ntiles; ++t, ++g) {
          const int st = g % L::ST;
          const uint32_t par = ((g / L::ST) & 1) ^ 1;
          mbar_wait(&b.kempty[st], par);
          mbar_expect_tx(&b.kfull[st], L::KV_BYTES);
#pragma unroll
          for (int c = 0; c < L::NB; ++c)
            tma_load_3d(L::k_tile(smem, r, st) + c * BK * 128, &map_k, 64 * c,
                        t * BK, bh, &b.kfull[st]);
          mbar_wait(&b.vempty[st], par);
          mbar_expect_tx(&b.vfull[st], L::KV_BYTES);
#pragma unroll
          for (int c = 0; c < L::NB; ++c)
            tma_load_3d(L::v_tile(smem, r, st) + c * BK * 128, &map_v, 64 * c,
                        t * BK, bh, &b.vfull[st]);
        }
      }
    }
  } else {
    // ---- consumer warpgroup w ----
    regs_alloc<L::CREGS>();
    const int w = warp / 4, wl = warp % 4, wtid = tid % 128;
    const int r = SPLIT ? w : 0;  // the ring it reads
    Stream& bq = bars[w];         // its Q slots
    Stream& b = bars[r];
    // Software pipeline over key tiles: Q K^T of tile t + 1 and P V of
    // tile t are issued together; the softmax of tile t + 1 runs while P V
    // of tile t finishes, and O is rescaled after it. Every mbarrier wait
    // and every divergent branch stays outside the window between a wgmma
    // batch's issue and its wait, or ptxas serialises the wgmmas.
    auto qk = [&](float (&s)[BK / 2], const unsigned char* sQ, int g) {
      const unsigned char* sK = L::k_tile(smem, r, g % L::ST);
#pragma unroll
      for (int kk = 0; kk < L::KS; ++kk) {
        const int off = (kk % 4) * 32;  // k16 step inside a 128-byte row
        WgmmaSS<BK>::run(s, gmma_desc(sQ + (kk / 4) * kBM * 128 + off, 1, 1024),
                         gmma_desc(sK + (kk / 4) * BK * 128 + off, 1, 1024), kk > 0);
      }
      wgmma_commit();
    };
    auto pv = [&](float (&acc)[DP / 2], const uint32_t (&pa)[BK / 16][4], int g) {
      const unsigned char* sV = L::v_tile(smem, r, g % L::ST);
      // O (64 x DP) += P (64 x BK) V (BK x DP); V's 64-column boxes are the
      // swizzle atoms along N
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        WgmmaRS<DP>::run(acc, pa[kk], gmma_desc(sV + kk * 16 * 128, 1, 1024, BK * 128), 1);
      wgmma_commit();
    };
    int bh, q0, g = 0;
    for (int i = 0; work_item<HEADFOLD, NWG, SPLIT>(i, w, heads, sq, bh, q0); ++i) {
      const int qs = i % L::QS;
      const unsigned char* sQ = L::q_slot(smem, w, qs);
      float acc[DP / 2];
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, alpha[2];
      float s[BK / 2];
      uint32_t pa[BK / 16][4], pn[BK / 16][4];
      mbar_wait(&bq.qfull[qs], (i / L::QS) & 1);
      mbar_wait(&b.kfull[g % L::ST], (g / L::ST) & 1);
      wgmma_fence();
      qk(s, sQ, g);
      wgmma_wait_all();
      fence_regs(s);
      if (wtid == 0) {
        mbar_arrive(&b.kempty[g % L::ST]);
        if (ntiles == 1) mbar_arrive(&bq.qempty[qs]);  // Q's last read is done
      }
      softmax_tile<BK>(s, m_run, l_run, alpha, 0, sk, scale_log2, lane);
      p_fragments<BK>(pa, s);
      // tile t: P V of tile t from `cur` while S of tile t + 1 becomes `nxt`
      // (two fragment buffers, unrolled by two: no copy between them that
      // could share registers with a wgmma still reading)
      auto step = [&](int t, const uint32_t (&cur)[BK / 16][4], uint32_t (&nxt)[BK / 16][4]) {
        mbar_wait(&b.kfull[(g + 1) % L::ST], ((g + 1) / L::ST) & 1);
        mbar_wait(&b.vfull[g % L::ST], (g / L::ST) & 1);
        wgmma_fence();
        qk(s, sQ, g + 1);  // the older group: S of tile t + 1
        pv(acc, cur, g);
        wgmma_wait_1();
        fence_regs(s);
        softmax_tile<BK>(s, m_run, l_run, alpha, (t + 1) * BK, sk, scale_log2, lane);
        p_fragments<BK>(nxt, s);
        wgmma_wait_all();
        fence_regs(acc);
        if (wtid == 0) {
          mbar_arrive(&b.vempty[g % L::ST]);
          mbar_arrive(&b.kempty[(g + 1) % L::ST]);
          if (t + 2 == ntiles) mbar_arrive(&bq.qempty[qs]);
        }
        rescale(acc, alpha);
        ++g;
      };
      auto last = [&](const uint32_t (&cur)[BK / 16][4]) {
        mbar_wait(&b.vfull[g % L::ST], (g / L::ST) & 1);
        wgmma_fence();
        pv(acc, cur, g);
        wgmma_wait_all();
        fence_regs(acc);
        if (wtid == 0) mbar_arrive(&b.vempty[g % L::ST]);
        ++g;
      };
      int t = 0;
      for (; t + 2 < ntiles; t += 2) {
        step(t, pa, pn);
        step(t + 1, pn, pa);
      }
      if (t + 1 < ntiles) {
        step(t, pa, pn);
        last(pn);
      } else {
        last(pa);
      }
      store_rows(o + (size_t)bh * sq * d, acc, l_run, q0, sq, d, 0, wl, lane);
    }
  }
}

// --- d = 64 (ModelScope's UNetSD) --------------------------------------------------

// Two consumer warpgroups of 64 query rows share a work item of 128 rows
// (ModelScope's S = 1024 and 256 are multiples: no query row is computed on
// TMA's zero fill there) and one ring of 128-key K/V tiles (16 KB a tile at
// d = 64, four stages). A 128-key tile halves the barriers, max and rescale
// steps and wgmma batches per key against 64-key tiles. A consumer thread
// holds 64 S, 32 O and 32 P fragment registers while its wgmmas are in
// flight, inside the 168 that ptxas gives a thread of a block with three
// warps on some SM sub-partition (setmaxnreg notwithstanding). The producer
// is one warp.
struct D64 {
  static constexpr int DP = 64, BK = 128, NWG = 2, ST = 4, QS = 2;
  static constexpr int ROWS = NWG * kBM;  // query rows of a work item
  static constexpr int Q_BYTES = kBM * 128, KV_BYTES = BK * 128;
  static constexpr int QREGION = NWG * QS * Q_BYTES;
  static constexpr size_t bytes = 1024 + (size_t)QREGION + 2 * ST * KV_BYTES;
  static constexpr int THREADS = NWG * 128 + 32;
  static_assert(ST <= kMaxStages && bytes + NWG * sizeof(Stream) <= 232448, "shared memory");
  __device__ static unsigned char* q_slot(unsigned char* smem, int w, int qs) {
    return smem + (w * QS + qs) * Q_BYTES;
  }
  __device__ static unsigned char* k_tile(unsigned char* smem, int st) {
    return smem + QREGION + st * KV_BYTES;
  }
  __device__ static unsigned char* v_tile(unsigned char* smem, int st) {
    return smem + QREGION + (ST + st) * KV_BYTES;
  }
};

// Work item i of a d = 64 block: (batch*head, first query row of the
// item), or false past its last. Kernel A is persistent over the (batch*head,
// 128-row query block) items; kernel A' walks heads z, z + gridDim.z, ... of
// batch y at query block x.
template <bool HEADFOLD>
__device__ __forceinline__ bool work_item64(int i, int heads, int sq, int& bh, int& q0) {
  if (!HEADFOLD) {
    const int blocks = (sq + D64::ROWS - 1) / D64::ROWS;
    const int item = blockIdx.x + i * gridDim.x;
    bh = item / blocks;
    q0 = (item % blocks) * D64::ROWS;
    return item < heads * blocks;
  }
  const int h = blockIdx.z + i * gridDim.z;
  bh = blockIdx.y * heads + h;
  q0 = blockIdx.x * D64::ROWS;
  return h < heads;
}

// The kernel A body of d = 40/80 (Q K^T of tile t + 1 and P V of tile t in
// flight together while the softmax of tile t + 1 runs; the same online
// softmax) on D64's tiles. An item runs the same instructions in A and A',
// which stay equal bit for bit.
template <bool HEADFOLD>
__global__ void __launch_bounds__(D64::THREADS, 1)
flash_fwd64_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o, int heads,
                   int sq, int sk, int d, float scale_log2) {
  using L = D64;
  constexpr int BK = L::BK, DP = L::DP;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ Stream bars[L::NWG];  // Q barriers of warpgroup w; bars[0] also the ring's
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int ntiles = (sk + BK - 1) / BK;

  if (tid == 0) {
    for (int w = 0; w < L::NWG; ++w) init_stream(bars[w], L::NWG);
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4 * L::NWG) {
    // ---- producer warp: one thread streams both warpgroups' Q, then K and V ----
    if (lane == 0) {
      Stream& b = bars[0];
      int bh, q0, g = 0;
      for (int i = 0; work_item64<HEADFOLD>(i, heads, sq, bh, q0); ++i) {
        const int qs = i % L::QS;
        for (int w = 0; w < L::NWG; ++w) {
          Stream& bq = bars[w];
          mbar_wait(&bq.qempty[qs], ((i / L::QS) & 1) ^ 1);
          mbar_expect_tx(&bq.qfull[qs], L::Q_BYTES);
          tma_load_3d(L::q_slot(smem, w, qs), &map_q, 0, q0 + w * kBM, bh, &bq.qfull[qs]);
        }
        for (int t = 0; t < ntiles; ++t, ++g) {
          const int st = g % L::ST;
          const uint32_t par = ((g / L::ST) & 1) ^ 1;
          mbar_wait(&b.kempty[st], par);
          mbar_expect_tx(&b.kfull[st], L::KV_BYTES);
          tma_load_3d(L::k_tile(smem, st), &map_k, 0, t * BK, bh, &b.kfull[st]);
          mbar_wait(&b.vempty[st], par);
          mbar_expect_tx(&b.vfull[st], L::KV_BYTES);
          tma_load_3d(L::v_tile(smem, st), &map_v, 0, t * BK, bh, &b.vfull[st]);
        }
      }
    }
  } else {
    // ---- consumer warpgroup w: query rows q0 + 64 w of each item ----
    const int w = warp / 4, wl = warp % 4, wtid = tid % 128;
    Stream& bq = bars[w];
    Stream& b = bars[0];
    auto qk = [&](float (&s)[BK / 2], const unsigned char* sQ, int g) {
      const unsigned char* sK = L::k_tile(smem, g % L::ST);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)  // k16 steps inside one 128-byte row
        WgmmaSS<BK>::run(s, gmma_desc(sQ + kk * 32, 1, 1024), gmma_desc(sK + kk * 32, 1, 1024),
                         kk > 0);
      wgmma_commit();
    };
    auto pv = [&](float (&acc)[DP / 2], const uint32_t (&pa)[BK / 16][4], int g) {
      const unsigned char* sV = L::v_tile(smem, g % L::ST);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        WgmmaRS<DP>::run(acc, pa[kk], gmma_desc(sV + kk * 16 * 128, 1, 1024, BK * 128), 1);
      wgmma_commit();
    };
    int bh, q0, g = 0;
    for (int i = 0; work_item64<HEADFOLD>(i, heads, sq, bh, q0); ++i) {
      const int qs = i % L::QS;
      const unsigned char* sQ = L::q_slot(smem, w, qs);
      float acc[DP / 2];
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, alpha[2];
      float s[BK / 2];
      uint32_t pa[BK / 16][4];
      mbar_wait(&bq.qfull[qs], (i / L::QS) & 1);
      mbar_wait(&b.kfull[g % L::ST], (g / L::ST) & 1);
      wgmma_fence();
      qk(s, sQ, g);
      wgmma_wait_all();
      fence_regs(s);
      if (wtid == 0) {
        mbar_arrive(&b.kempty[g % L::ST]);
        if (ntiles == 1) mbar_arrive(&bq.qempty[qs]);  // Q's last read is done
      }
      softmax_tile<BK>(s, m_run, l_run, alpha, 0, sk, scale_log2, lane);
      p_fragments<BK>(pa, s);
      // tile t: P V of tile t from pa while S of tile t + 1 is computed and
      // its softmax runs; pa takes P of tile t + 1 once P V has read it (one
      // fragment buffer: two would not fit 168 registers beside S and O)
      for (int t = 0; t + 1 < ntiles; ++t, ++g) {
        mbar_wait(&b.kfull[(g + 1) % L::ST], ((g + 1) / L::ST) & 1);
        mbar_wait(&b.vfull[g % L::ST], (g / L::ST) & 1);
        wgmma_fence();
        qk(s, sQ, g + 1);  // the older group: S of tile t + 1
        pv(acc, pa, g);
        wgmma_wait_1();
        fence_regs(s);
        softmax_tile<BK>(s, m_run, l_run, alpha, (t + 1) * BK, sk, scale_log2, lane);
        wgmma_wait_all();
        fence_regs(acc);
        if (wtid == 0) {
          mbar_arrive(&b.vempty[g % L::ST]);
          mbar_arrive(&b.kempty[(g + 1) % L::ST]);
          if (t + 2 == ntiles) mbar_arrive(&bq.qempty[qs]);
        }
        p_fragments<BK>(pa, s);
        rescale(acc, alpha);
      }
      mbar_wait(&b.vfull[g % L::ST], (g / L::ST) & 1);
      wgmma_fence();
      pv(acc, pa, g);
      wgmma_wait_all();
      fence_regs(acc);
      if (wtid == 0) mbar_arrive(&b.vempty[g % L::ST]);
      ++g;
      store_rows(o + (size_t)bh * sq * d, acc, l_run, q0 + w * kBM, sq, d, 0, wl, lane);
    }
  }
}

// --- d = 512 ------------------------------------------------------------------

struct Wide {
  static constexpr int WG = 2;                   // consumer warpgroups
  static constexpr int THREADS = (WG + 1) * 128;  // + one producer warpgroup
  static constexpr int CREGS = 240;              // 65536 / 384 rounded to 8
  static constexpr int DP = 512, BK = 32, ST = 2, HALF = DP / WG;
  static constexpr int BOX = 64;  // columns of a 128-byte-swizzle box
  static constexpr int Q_BYTES = kBM * DP * 2, KV_BYTES = BK * DP * 2;
  static constexpr int X_BYTES = kBM * BK * 4;  // one warpgroup's partial S
  static constexpr int K_OFF = Q_BYTES, V_OFF = K_OFF + ST * KV_BYTES;
  static constexpr int X_OFF = V_OFF + ST * KV_BYTES;
  static constexpr size_t bytes = 1024 + X_OFF + 2 * WG * X_BYTES;
  static_assert(ST <= kMaxStages && bytes + sizeof(Stream) <= 232448, "shared memory");
};

__global__ void __launch_bounds__(Wide::THREADS, 1)
flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o, int sq,
                      int sk, int d, float scale_log2) {
  using L = Wide;
  constexpr int BK = L::BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ Stream b;
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // the warp index through a shuffle: ptxas then treats it (and the roles,
  // work items and loops derived from it) as warp-uniform, and keeps the
  // wgmma pipeline instead of serialising it on a divergent path
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int ntiles = (sk + BK - 1) / BK;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBM;

  if (tid == 0) {
    init_stream(b, L::WG);
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= 4 * L::WG) {
    // ---- producer: one thread streams Q once, then K and V tiles ----
    regs_dealloc<kProducerRegs>();
    if (warp == 4 * L::WG && lane == 0) {
      mbar_expect_tx(&b.qfull[0], L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < L::DP / L::BOX; ++c)
        tma_load_3d(smem + c * kBM * 128, &map_q, L::BOX * c, q0, bh, &b.qfull[0]);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % L::ST;
        const uint32_t par = ((t / L::ST) & 1) ^ 1;
        mbar_wait(&b.kempty[st], par);
        mbar_expect_tx(&b.kfull[st], L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::DP / L::BOX; ++c)
          tma_load_3d(smem + L::K_OFF + st * L::KV_BYTES + c * BK * 128, &map_k, L::BOX * c,
                      t * BK, bh, &b.kfull[st]);
        mbar_wait(&b.vempty[st], par);
        mbar_expect_tx(&b.vfull[st], L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::DP / L::BOX; ++c)
          tma_load_3d(smem + L::V_OFF + st * L::KV_BYTES + c * BK * 128, &map_v, L::BOX * c,
                      t * BK, bh, &b.vfull[st]);
      }
    }
  } else {
    // ---- consumer warpgroup w: depth half w of Q K^T, columns half w of O ----
    regs_alloc<L::CREGS>();
    const int w = warp / 4, wl = warp % 4, wtid = tid % 128;
    constexpr int CB = L::HALF / L::BOX;  // boxes per half
    float acc[L::HALF / 2];
#pragma unroll
    for (int j = 0; j < L::HALF / 2; ++j) acc[j] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    mbar_wait(&b.qfull[0], 0);
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % L::ST;
      const uint32_t par = (t / L::ST) & 1;
      const unsigned char* sK = smem + L::K_OFF + st * L::KV_BYTES;
      const unsigned char* sV = smem + L::V_OFF + st * L::KV_BYTES;
      float s[BK / 2];
      mbar_wait(&b.kfull[st], par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::HALF / 16; ++kk) {
        const int box = w * CB + kk / 4, off = (kk % 4) * 32;
        WgmmaSS<BK>::run(s, gmma_desc(smem + box * kBM * 128 + off, 1, 1024),
                         gmma_desc(sK + box * BK * 128 + off, 1, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      if (wtid == 0) mbar_arrive(&b.kempty[st]);
      // exchange the partial sums: mine out, the other warpgroup's in
      float* xb = reinterpret_cast<float*>(smem + L::X_OFF + (t & 1) * L::WG * L::X_BYTES);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) xb[(w * (BK / 2) + i) * 128 + wtid] = s[i];
      consumer_sync();
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float other = xb[((1 - w) * (BK / 2) + i) * 128 + wtid];
        s[i] = w == 0 ? s[i] + other : other + s[i];
      }

      float alpha[2];
      softmax_tile<BK>(s, m_run, l_run, alpha, t * BK, sk, scale_log2, lane);
      rescale(acc, alpha);
      uint32_t pa[BK / 16][4];
      p_fragments<BK>(pa, s);

      mbar_wait(&b.vfull[st], par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        WgmmaRS<L::HALF>::run(
            acc, pa[kk], gmma_desc(sV + w * CB * BK * 128 + kk * 16 * 128, 1, 1024, BK * 128), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (wtid == 0) mbar_arrive(&b.vempty[st]);
    }
    store_rows(o + (size_t)bh * sq * d, acc, l_run, q0, sq, d, w * L::HALF, wl, lane);
  }
}

// --- launchers ------------------------------------------------------------------

// maps of q (n, sq, d) and k, v (n, sk, d), boxes of `box` columns
bool flash_maps(CUtensorMap (&m)[3], const bf16* q, const bf16* k, const bf16* v, int n, int sq,
                int sk, int d, int box, int bk, CUtensorMapSwizzle swz) {
  return make_map_3d(&m[0], q, n, sq, d, kBM, box, swz) &&
         make_map_3d(&m[1], k, n, sk, d, bk, box, swz) &&
         make_map_3d(&m[2], v, n, sk, d, bk, box, swz);
}

// The launch at (b, heads, sq, d rounded up to 16): consumer warpgroups a
// block, whether each has a K/V ring of its own (kernel A' only), query
// blocks of one head, the work items and the blocks launched, the query rows
// of a work item, and the blocks each batch's heads are split over (A' at
// d = 64).
//  * Kernel A (d = 40, 80): persistent blocks over the (batch*head, query
//    block) items, their warpgroups sharing each K/V tile: three (192 query
//    rows) at d = 40, two (128) at d = 80, whose three would spill at 160
//    registers a thread.
//  * Kernel A' (d = 40, 80): one block per (batch, query block): three
//    warpgroups on a shared ring while those 192-query blocks fill half the
//    SMs, else two warpgroups with a ring each over 64-query blocks (three
//    times the blocks, each K/V tile read twice from L2).
//  * d = 64: two warpgroups, 128-row items (D64). Kernel A is persistent
//    over them; kernel A' gives each (batch, query block) as many blocks,
//    each walking every so-many'th head, as fill the SMs once.
//  * d = 512: one block per (batch*head, 64-query block).
struct Grid {
  int nwg;
  bool split;
  int qblocks, items, blocks, rows, hsplit;
};

constexpr int a_warpgroups(int dp) { return dp > 64 ? 2 : 3; }

Grid flash_grid(int b, int heads, int sq, int dp, bool headfold, int sms) {
  auto qblocks = [sq](int rows) { return (sq + rows - 1) / rows; };
  if (dp > 128) {
    const int qb = qblocks(kBM);
    return {Wide::WG, false, qb, b * heads * qb, b * heads * qb, kBM, 1};
  }
  if (dp == D64::DP) {
    const int qb = qblocks(D64::ROWS), items = b * heads * qb;
    if (!headfold) return {D64::NWG, false, qb, items, items < sms ? items : sms, D64::ROWS, 1};
    int hs = sms / (b * qb);
    hs = hs < 1 ? 1 : (hs > heads ? heads : hs);
    return {D64::NWG, false, qb, items, b * qb * hs, D64::ROWS, hs};
  }
  if (!headfold) {
    const int nwg = a_warpgroups(dp), qb = qblocks(nwg * kBM), items = b * heads * qb;
    return {nwg, false, qb, items, items < sms ? items : sms, nwg * kBM, 1};
  }
  const bool split = 2 * b * qblocks(3 * kBM) < sms;
  const int qb = qblocks(split ? kBM : 3 * kBM);
  return {split ? 2 : 3, split, qb, b * qb, b * qb, split ? kBM : 3 * kBM, 1};
}

template <int DP, bool HEADFOLD, int NWG, bool SPLIT>
cudaError_t launch_narrow(const CUtensorMap (&m)[3], bf16* o, const Grid& g, int b, int heads,
                          int sq, int sk, int d, float scale, cudaStream_t stream) {
  using L = Narrow<DP, NWG, SPLIT>;
  if (g.nwg != NWG || g.split != SPLIT) return cudaErrorInvalidConfiguration;
  auto kern = flash_fwd_kernel<DP, HEADFOLD, NWG, SPLIT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid = HEADFOLD ? dim3(g.qblocks, b) : dim3(g.blocks);
  kern<<<grid, L::THREADS, L::bytes, stream>>>(m[0], m[1], m[2], o, heads, sq, sk, d,
                                               scale * kLog2e);
  return cudaGetLastError();
}

template <int DP, bool HEADFOLD>
cudaError_t launch_flash(const bf16* q, const bf16* k, const bf16* v, bf16* o, int b, int heads,
                         int sq, int sk, int d, float scale, cudaStream_t stream) {
  CUtensorMap m[3];
  if (!flash_maps(m, q, k, v, b * heads, sq, sk, d, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const Grid g = flash_grid(b, heads, sq, DP, HEADFOLD, sm_count());
  if (!HEADFOLD)
    return launch_narrow<DP, false, a_warpgroups(DP), false>(m, o, g, b, heads, sq, sk, d, scale,
                                                             stream);
  if (g.split) return launch_narrow<DP, true, 2, true>(m, o, g, b, heads, sq, sk, d, scale, stream);
  return launch_narrow<DP, true, 3, false>(m, o, g, b, heads, sq, sk, d, scale, stream);
}

template <bool HEADFOLD>
cudaError_t launch_flash64(const bf16* q, const bf16* k, const bf16* v, bf16* o, int b,
                           int heads, int sq, int sk, int d, float scale, cudaStream_t stream) {
  using L = D64;
  CUtensorMap m[3];
  if (!flash_maps(m, q, k, v, b * heads, sq, sk, d, 64, L::BK, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd64_kernel<HEADFOLD>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::bytes));
  if (e != cudaSuccess) return e;
  const Grid g = flash_grid(b, heads, sq, L::DP, HEADFOLD, sm_count());
  const dim3 grid = HEADFOLD ? dim3(g.qblocks, b, g.hsplit) : dim3(g.blocks);
  kern<<<grid, L::THREADS, L::bytes, stream>>>(m[0], m[1], m[2], o, heads, sq, sk, d,
                                               scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t launch_wide(const bf16* q, const bf16* k, const bf16* v, bf16* o, int bh, int sq,
                        int sk, int d, float scale, cudaStream_t stream) {
  using L = Wide;
  CUtensorMap m[3];
  if (!flash_maps(m, q, k, v, bh, sq, sk, d, L::BOX, L::BK, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_wide_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::bytes));
  if (e != cudaSuccess) return e;
  const Grid g = flash_grid(1, bh, sq, L::DP, false, sm_count());
  flash_fwd_wide_kernel<<<dim3(g.qblocks, bh), L::THREADS, L::bytes, stream>>>(
      m[0], m[1], m[2], o, sq, sk, d, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q: (bh, sq, d), k and v: (bh, sk, d), o: (bh, sq, d), all bf16,
// contiguous and 16-byte aligned; d % 8 == 0 and ceil16(d) in {48, 64, 80,
// 512} (the UNet's 40 and 80, ModelScope's 64, the VAE's 512).
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
    case 48: return launch_flash<48, false>(Q, K, V, O, 1, bh, sq, sk, d, scale, st);
    case 64: return launch_flash64<false>(Q, K, V, O, 1, bh, sq, sk, d, scale, st);
    case 80: return launch_flash<80, false>(Q, K, V, O, 1, bh, sq, sk, d, scale, st);
    case 512: return launch_wide(Q, K, V, O, bh, sq, sk, d, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// Kernel A' (headfold): q (b, heads, sq, d), k and v (b, heads, sk, d),
// o like q; the same conditions as flash_attn_fwd, for the UNet's head dims
// (ceil16(d) in {48, 64, 80}). With one head the two grids are the same, so
// the d = 512 VAE case goes to flash_attn_fwd.
INSV2V_EXPORT int flash_attn_fwd_headfold(const void* q, const void* k, const void* v, void* o,
                                          int b, int heads, int sq, int sk, int d, float scale,
                                          void* stream) {
  auto Q = static_cast<const bf16*>(q);
  auto K = static_cast<const bf16*>(k);
  auto V = static_cast<const bf16*>(v);
  auto O = static_cast<bf16*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // clear an unrelated earlier error of this runtime
  if (d % 8 != 0 || sq <= 0 || sk <= 0 || heads <= 0) return cudaErrorInvalidValue;
  switch ((d + 15) / 16 * 16) {
    case 48: return launch_flash<48, true>(Q, K, V, O, b, heads, sq, sk, d, scale, st);
    case 64: return launch_flash64<true>(Q, K, V, O, b, heads, sq, sk, d, scale, st);
    case 80: return launch_flash<80, true>(Q, K, V, O, b, heads, sq, sk, d, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// The grid that flash_attn_fwd (headfold = 0) or flash_attn_fwd_headfold
// (headfold = 1) launches at (b, heads, sq, d) on the current device:
// out[0] consumer warpgroups a block, out[1] blocks, out[2] work items (the
// query blocks of every head, shared out over the blocks), out[3] query rows
// a work item, out[4] keys a K/V tile.
INSV2V_EXPORT int flash_attn_grid(int b, int heads, int sq, int d, int headfold, int* out) {
  const int dp = (d + 15) / 16 * 16;
  if (d % 8 != 0 || sq <= 0 || b <= 0 || heads <= 0 ||
      !(dp == 48 || dp == 64 || dp == 80 || (dp == 512 && !headfold)))
    return cudaErrorInvalidValue;
  const Grid g = flash_grid(b, heads, sq, dp, headfold != 0, sm_count());
  out[0] = g.nwg;
  out[1] = g.blocks;
  out[2] = g.items;
  out[3] = g.rows;
  out[4] = dp > 128 ? Wide::BK : dp == D64::DP ? D64::BK : 64;
  return cudaSuccess;
}
