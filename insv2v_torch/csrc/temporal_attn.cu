// Temporal (per-pixel, per-head) attention over frames for Hopper (sm_90a):
// for each pixel n and head h, o[n, :, h] = softmax(q k^T * scale) v over
// the F frames, with q, k, v, o laid out (N, F, heads, e) in bf16 — the
// motion module's (B, P, F, C) stream with C split as (heads, e).
//
// Replaces the TPU kernels _packed_temporal_kernel and
// _packed_temporal_kernel_bigblock of the JAX package's ops/attention.py
// (launched by packed_temporal_attention). They pack the heads and frames of
// a pixel into one m = F*heads axis and mask the cross-head entries of an
// m x m product to -inf, a TPU matrix-unit shape trick that does `heads`
// times the needed work. Here each (pixel, head) problem is computed as what
// it is, an F x F attention (F <= 32), with no masked work.
//
// Bound on the H100: 4*F*F*e FLOPs per problem against 4*F*e*2 bytes, i.e.
// F/2 = 8 FLOP/byte at F = 16: bound by memory bytes. The only gain is to
// move q, k, v and o once each at a rate near the card's. The design:
//
//  * Work units of whole pixels: a unit is one pixel's F frames of G of its
//    heads (G divides heads, at most 8). G = heads where one ring stage (the
//    unit's q, k and v) fits kStageBytes; fewer where it does not (e = 80,
//    160, or F > 16) and where the units would be too few to fill the card
//    (the motion modules' 12-64-pixel levels). A unit's F frame rows are G*e
//    contiguous bf16 each in device memory (the whole pixel slab is
//    contiguous when G = heads).
//  * A persistent grid: the blocks the occupancy API fits on every SM walk
//    the units u = blockIdx.x + i * gridDim.x.
//  * A producer warp brings each unit's q, k and v into a ring of kStages
//    stages in shared memory with bulk copies (cp.async.bulk, lane f copying
//    frame row f of each tensor), completing on the stage's "full" mbarrier,
//    so the next units' loads run under the current unit's compute and
//    stores. Where one-stage blocks hold every unit at once (the small
//    levels), each block takes one unit in one stage: more blocks resident.
//  * G consumer warps, one head each, compute S = q k^T on the tensor cores
//    (mma.sync m16n8k16, f32 accumulate: at F = 16, wgmma's 64-row minimum
//    would buy only masked work), the softmax in f32 registers, and P v from
//    P's registers. Frames are padded to FP = 16 or 32 and e to EP, a
//    multiple of 16, in the fragments only: q's columns past e are zeroed in
//    registers, and the rows past F that P v reads are zeroed in shared
//    memory once.
//  * Each warp writes its O over its own head's q columns in shared memory
//    (a neighbour's last k16 step reads their first 8 columns only to zero
//    them) and says so on the stage's "done" mbarrier.
//    Once all G have, the producer sends the unit's F rows out with bulk
//    stores and, once they have read the stage, loads a later unit into it:
//    the consumers never wait for a store.
//  * Layout in shared memory: each frame row of the unit (G*e bf16) is
//    followed by a pad to an odd number of 16-byte chunks. A head's rows are
//    then an odd number of chunks apart, so the 8 row addresses of each
//    ldmatrix phase, and the 8 rows of O's 4-byte writes, fall on 8 different
//    16-byte bank groups: no bank conflict. Unpadded, rows would be
//    heads*e*2 = 640, 1280 or 2560 bytes apart, multiples of 128, and every
//    ldmatrix an 8-way conflict. A tensor map cannot pad rows, and a box per
//    head would conflict 2- or 4-way at e = 80 and 160; a bulk copy per row
//    pads them.
#include "hopper.cuh"

namespace {

constexpr int kMaxHeads = 8;            // consumer warps a block: a head of the unit each
constexpr int kStages = 2;              // ring stages where a block walks several units
constexpr int kStageBytes = 33 * 1024;  // the largest stage G is chosen for
constexpr int kUnitsPerSm = 4;          // fewer heads a unit below this many units an SM

// Bytes between frame rows of a unit in shared memory: G*e bf16 and a pad to
// an odd number of 16-byte chunks (at least one chunk, which also holds the
// 8 columns past the last head's e that its last k16 step reads).
__host__ __device__ __forceinline__ int row_stride(int g, int e) {
  const int chunks = g * e / 8;
  return 16 * (chunks + (chunks % 2 ? 2 : 1));
}

template <int FP, int EP>
__global__ void __launch_bounds__((kMaxHeads + 1) * 32)
temporal_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int n, int F,
                     int heads, int e, int G, int stages, float scale_log2) {
  constexpr int MT = FP / 16;  // m16 frame tiles
  constexpr int NS = FP / 8;   // n8 key tiles of S
  constexpr int KE = EP / 16;  // k16 steps over e
  constexpr int NO = EP / 8;   // n8 tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[kStages], done[kStages];
  const int tid = threadIdx.x, lane = tid % 32;
  // the warp index through a shuffle: ptxas treats the roles as warp-uniform
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int rs = row_stride(G, e), slot = FP * rs, stage = 3 * slot;  // bytes
  const int ST = stages;
  const int groups = heads / G, units = n * groups;
  const uint32_t row_bytes = 2u * G * e;
  const size_t fstride = (size_t)heads * e;  // elements between frame rows
  // first element of frame row f of unit u, in q, k, v and o alike
  auto row0 = [&](int u, int f) {
    return ((size_t)(u / groups) * F + f) * fstride + (size_t)(u % groups) * G * e;
  };

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&done[s], G);
    }
    fence_mbar_init();
  }
  // Zero what the products read but no copy writes: k's pad chunk (the last
  // head's zeroed q columns multiply it: stale bytes could be NaN) and v's
  // rows past F (P is 0 there)
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const int vchunks = (FP - F) * rs / 16;
  for (int s = 0; s < ST; ++s) {
    unsigned char* sk = smem + s * stage + slot;
    for (int r = tid; r < FP; r += blockDim.x)
      *reinterpret_cast<uint4*>(sk + r * rs + row_bytes) = zero;
    unsigned char* sv = sk + slot + F * rs;
    for (int c = tid; c < vchunks; c += blockDim.x) reinterpret_cast<uint4*>(sv)[c] = zero;
  }
  __syncthreads();

  if (warp == G) {
    // ---- producer warp: lane f copies frame row f of q, k and v in, and of
    // O out once the consumers are done with the unit ----
    auto store = [&](int i) {  // the i-th unit of this block, u = blockIdx.x + i * gridDim.x
      const int st = i % ST;
      if (lane == 0) mbar_wait(&done[st], (i / ST) & 1);
      __syncwarp();
      if (lane < F) {
        bulk_store(o + row0(blockIdx.x + i * gridDim.x, lane), smem + st * stage + lane * rs,
                   row_bytes);
        bulk_commit();
        bulk_wait_read();  // the stage is free once the store has read it
      }
      __syncwarp();
    };
    int i = 0;
    for (int u = blockIdx.x; u < units; ++i, u += gridDim.x) {
      const int st = i % ST;
      if (i >= ST) store(i - ST);
      if (lane == 0) mbar_expect_tx(&full[st], 3u * F * row_bytes);
      __syncwarp();
      if (lane < F) {
        const size_t src = row0(u, lane);
        unsigned char* dst = smem + st * stage + lane * rs;
        bulk_load(dst, q + src, row_bytes, &full[st]);
        bulk_load(dst + slot, k + src, row_bytes, &full[st]);
        bulk_load(dst + 2 * slot, v + src, row_bytes, &full[st]);
      }
    }
    for (int j = i > ST ? i - ST : 0; j < i; ++j) store(j);
    return;
  }

  // ---- consumer warp `warp`: head `warp` of every unit ----
  const int ld = rs / 2;  // bf16 elements between rows
  const int c2 = 2 * (lane % 4), mi = lane / 8;
  for (int i = 0, u = blockIdx.x; u < units; ++i, u += gridDim.x) {
    const int st = i % ST;
    bf16* sQ = reinterpret_cast<bf16*>(smem + st * stage) + warp * e;
    const bf16* sK = sQ + slot / 2;
    const bf16* sV = sK + slot / 2;
    mbar_wait(&full[st], (i / ST) & 1);
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
        ldmatrix_x4(a, sQ + (mt * 16 + lane % 16) * ld + ke * 16 + (lane / 16) * 8);
        if (ke * 16 + 8 >= e) a[2] = a[3] = 0u;  // columns past e: the next head's or the pad
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
          uint32_t b[4];  // key tiles j and j + 1
          ldmatrix_x4(b, sK + (j * 8 + lane % 8 + 8 * (mi / 2)) * ld + ke * 16 + 8 * (mi % 2));
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
          ldmatrix_x4_trans(b, sV + (kk * 16 + lane % 8 + 8 * (mi % 2)) * ld + j * 8 +
                                   8 * (mi / 2));
          mma_bf16_16816(acc[j], pa, b[0], b[1]);
          mma_bf16_16816(acc[j + 1], pa, b[2], b[3]);
        }
      }
      // O over this head's q columns (rows mt*16.. were read above)
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int col = j * 8 + c2;
        if (col >= e) continue;  // e is even: a pair is all in or all out
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int f = mt * 16 + lane / 4 + 8 * r;
          if (f < F)
            *reinterpret_cast<uint32_t*>(sQ + f * ld + col) =
                pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
        }
      }
    }
    // this warp's O visible to the producer's bulk stores
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&done[st]);
  }
}

// The launch at (n pixels, F, heads, e): heads a unit, threads and dynamic
// shared memory a block, ring stages and the units.
struct Plan {
  int heads_per_unit, threads, smem, stages, units;
};

// Blocks of `kern` resident an SM at this block shape (the occupancy API,
// asked once per kernel, shape and device); 0 on an error. Sets the
// kernel's dynamic shared-memory limit to `smem` on the way.
int resident_blocks(const void* kern, int threads, int smem) {
  struct Entry {
    const void* kern;
    int dev, threads, smem, resident;
  };
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].kern == kern && cache[i].dev == dev && cache[i].threads == threads &&
        cache[i].smem == smem)
      return cache[i].resident;
  int resident = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kern, threads, smem) !=
      cudaSuccess)
    return 0;
  if (used < 64) cache[used++] = {kern, dev, threads, smem, resident};
  return resident;
}

Plan plan(const void* kern, int n, int F, int heads, int e, int sms, int& resident) {
  const int fp = F <= 16 ? 16 : 32;
  auto stage = [&](int g) { return 3 * fp * row_stride(g, e); };
  int g = 1;
  for (int c = kMaxHeads; c > 1; --c)
    if (heads % c == 0 && stage(c) <= kStageBytes) {
      g = c;
      break;
    }
  while (g > 1 && (long long)n * (heads / g) < (long long)kUnitsPerSm * sms) {
    int c = g - 1;
    while (heads % c) --c;
    g = c;
  }
  const int units = n * (heads / g), threads = (g + 1) * 32;
  // one stage where one-stage blocks take every unit at once
  resident = resident_blocks(kern, threads, stage(g));
  if ((long long)resident * sms >= units) return {g, threads, stage(g), 1, units};
  resident = resident_blocks(kern, threads, kStages * stage(g));
  return {g, threads, kStages * stage(g), kStages, units};
}

// With ``grid`` set, no launch: grid = {blocks, threads a block, blocks
// resident an SM, heads a unit, units, ring stages} of the launch these
// arguments would make.
template <int FP, int EP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int n, int F,
                   int heads, int e, float scale, cudaStream_t stream, int* grid) {
  auto kern = temporal_attn_kernel<FP, EP>;
  const int sms = sm_count();
  int resident = 0;
  const Plan p = plan(reinterpret_cast<const void*>(kern), n, F, heads, e, sms, resident);
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const int blocks = p.units < resident * sms ? p.units : resident * sms;
  if (grid) {
    grid[0] = blocks;
    grid[1] = p.threads;
    grid[2] = resident;
    grid[3] = p.heads_per_unit;
    grid[4] = p.units;
    grid[5] = p.stages;
    return cudaSuccess;
  }
  kern<<<blocks, p.threads, p.smem, stream>>>(q, k, v, o, n, F, heads, e, p.heads_per_unit,
                                              p.stages, scale * 1.4426950408889634f);
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

// The grid temporal_attn_fwd launches for these sizes, into out[6]: blocks,
// threads a block, blocks resident an SM (the occupancy API), heads a work
// unit, work units (the persistent blocks walk the units) and ring stages.
INSV2V_EXPORT int temporal_attn_grid(int n, int F, int heads, int e, int* out) {
  cudaGetLastError();
  return dispatch(nullptr, nullptr, nullptr, nullptr, n, F, heads, e, 1.0f, nullptr, out);
}
