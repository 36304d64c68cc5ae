// GroupNorm over channels-last rows, with its SiLU when asked for, for
// Hopper (sm_90a): bf16 in and out, f32 statistics and affine, one rounding
// to bf16.
//
// Replaces no Pallas kernel: the JAX package leaves GroupNorm to XLA (its
// ops/norms.py). ops/norms.py::group_norm and
// group_norm_split_pair route here through ops/fused_norm.py::
// fused_group_norm. The input is one or two parts (N, M, C_p), row-major;
// their channel concat (C = C_0 + C_1, never built) is normalised in G
// groups of C / G channels, per (n, group) over the M rows and the group's
// channels. A group may straddle the two parts (1280 + 640 channels in 32
// groups of 60). Each part is written to its own output.
//
// Bound on the H100: bytes. The least traffic is one read and one write of
// each element (4 bytes) for ~10 FLOPs, far below the card's ~295 FLOP/byte
// balance point; ATen's path (a float32 copy, var_mean, a broadcast float32
// addcmul, then F.silu) moves 4-6 bytes an element in each of several passes.
// Design: three launches, no atomics, no allocation, no host sync (so a CUDA
// graph captures them and a replay is bit for bit the same), 6 bytes an
// element (the rows are read twice: one sample's rows outgrow what the L2
// keeps between the passes, and walking the second pass backwards over them
// measured no gain):
//  1. group_norm_stats_kernel, grid (chunks, N): a block reads R rows of one
//     sample with 16-byte loads, 8 channels a thread and `rpar` rows at once,
//     and sums each channel's x - p and (x - p)^2 in f32, p the channel's
//     value in the block's first row. The shift keeps E[x^2] - mean^2 from
//     cancelling where the mean is far above the spread; taking p from the
//     block's own rows keeps every block off one hot line of the L2. The
//     row lanes' sums meet in shared memory (j-major: no bank conflicts),
//     become each channel's (mean, M2), and a warp a group folds those
//     (Chan: the group's M2 is the channels' M2 plus their means' spread,
//     so 10-, 30- or 60-channel groups need not align with the 8-lane
//     vectors) into (mean, M2) a (n, group, chunk) in scratch. The wrapper
//     sizes the chunks so that the blocks fill whole waves of the SMs
//     (ops/fused_norm.py::group_norm_plan).
//  2. group_norm_finish_kernel, grid (G, N): 128 threads merge one group's
//     chunks, (count, mean, M2), in a fixed order (Chan's pairwise update,
//     a shuffle tree, then the four warps in turn) into its mean and rstd.
//  3. group_norm_apply_kernel, grid (chunks, N): the block's per-channel
//     f32 a = rstd * scale, b = bias - mean * a in shared memory, then
//     y = x * a + b, SiLU on that, one rounding, 16-byte stores.
#include "common.cuh"

namespace {

constexpr int kMaxWidth = 4096;   // channels of both parts together
constexpr int kMaxThreads = 512;  // a block: 8 channels a thread, rpar rows
constexpr int kUnroll = 4;        // rows a thread has in flight
constexpr int kFinishThreads = 128;

struct Params {
  const bf16* x0;
  const bf16* x1;
  bf16* y0;
  bf16* y1;
  const void* scale;  // (C,), f32 or bf16 (affine_bf16)
  const void* bias;
  float2* part;   // (N, G, chunks): the chunk's (mean, M2)
  float2* stats;  // (N, G): (mean, rstd)
  int m, c0, c1, c, groups, gs, v0, v, rpar, rows, chunks, affine_bf16;
  float eps;
};

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

// The thread's column: its part's row stride and the address of its 8
// channels in the sample's first row, in x and in y.
struct Column {
  size_t stride;
  const bf16* x;
  bf16* y;
};

__device__ __forceinline__ Column column(const Params& p, int n, int vec) {
  const bool first = vec < p.v0;
  const int cp = first ? p.c0 : p.c1;
  const size_t off = (size_t)n * p.m * cp + (size_t)(first ? vec : vec - p.v0) * 8;
  return {(size_t)cp, (first ? p.x0 : p.x1) + off, (first ? p.y0 : p.y1) + off};
}

// (count, mean, M2) of a and b together, into a; b's count may be 0.
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& m2a, float nb, float mb,
                                           float m2b) {
  if (nb == 0.f) return;
  const float nn = na + nb, w = nb / nn, d = mb - ma;
  ma = fmaf(d, w, ma);
  m2a += m2b + d * d * na * w;
  na = nn;
}

__device__ __forceinline__ void accumulate(const uint4& raw, const float (&piv)[8],
                                           float (&s1)[8], float (&s2)[8]) {
  float f[8];
  unpack8(raw, f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float d = f[j] - piv[j];
    s1[j] += d;
    s2[j] = fmaf(d, d, s2[j]);
  }
}

// Shared memory of a stats block of `threads` threads: with rpar > 1 the
// row lanes' sums, (2, 8, threads) floats, then the channels' (mean, M2).
__host__ __device__ inline size_t stats_smem(int c, int rpar, int threads) {
  return ((rpar > 1 ? 16 * (size_t)threads : 0) + 2 * (size_t)c) * sizeof(float);
}

__global__ void group_norm_stats_kernel(Params p) {
  extern __shared__ float sh[];
  const int n = blockIdx.y, chunk = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int vec = t % p.v, rl = t / p.v;
  const int m0 = chunk * p.rows, m1 = min(m0 + p.rows, p.m);
  const Column col = column(p, n, vec);
  float piv[8], s1[8], s2[8];
  unpack8(ld16(col.x + (size_t)m0 * col.stride), piv);
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
  int m = m0 + rl;
  for (; m + (kUnroll - 1) * p.rpar < m1; m += kUnroll * p.rpar) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = ld16(col.x + (size_t)(m + u * p.rpar) * col.stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) accumulate(raw[u], piv, s1, s2);
  }
  for (; m < m1; m += p.rpar) accumulate(ld16(col.x + (size_t)m * col.stride), piv, s1, s2);

  // each channel's (mean, M2) over the chunk's r rows, in ch[c]
  const float r = (float)(m1 - m0);
  float2* ch = reinterpret_cast<float2*>(sh + (p.rpar > 1 ? 16 * nt : 0));
  if (p.rpar > 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sh[j * nt + t] = s1[j];
      sh[(8 + j) * nt + t] = s2[j];
    }
    __syncthreads();
    // the row lanes of a column share its pivots: lane rl finishes the
    // column's channels j = rl, rl + rpar, ...
    for (int j = rl; j < 8; j += p.rpar) {
      float a = 0.f, b = 0.f;
      for (int l = 0; l < p.rpar; ++l) {
        a += sh[j * nt + l * p.v + vec];
        b += sh[(8 + j) * nt + l * p.v + vec];
      }
      const float mu = a / r;
      ch[vec * 8 + j] = make_float2(piv[j] + mu, fmaxf(b - a * mu, 0.f));
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float mu = s1[j] / r;
      ch[vec * 8 + j] = make_float2(piv[j] + mu, fmaxf(s2[j] - s1[j] * mu, 0.f));
    }
  }
  __syncthreads();
  // a warp a group (full warps only)
  const int lane = t % 32, warps = nt / 32;
  for (int g = t / 32; g < p.groups && t < warps * 32; g += warps) {
    const float2* gc = ch + g * p.gs;
    float mean = 0.f;
    for (int i = lane; i < p.gs; i += 32) mean += gc[i].x;
    mean = warp_sum(mean) / p.gs;
    float m2 = 0.f;
    for (int i = lane; i < p.gs; i += 32) {
      const float d = gc[i].x - mean;
      m2 += fmaf(r * d, d, gc[i].y);
    }
    m2 = warp_sum(m2);
    if (lane == 0) p.part[((size_t)n * p.groups + g) * p.chunks + chunk] = make_float2(mean, m2);
  }
}

__device__ __forceinline__ float chunk_count(const Params& p, int k) {
  return (float)(min(p.rows, p.m - k * p.rows) * p.gs);
}

__global__ void __launch_bounds__(kFinishThreads) group_norm_finish_kernel(Params p) {
  __shared__ float3 warp_part[kFinishThreads / 32];
  const int g = blockIdx.x, n = blockIdx.y, t = threadIdx.x, lane = t % 32;
  const float2* part = p.part + ((size_t)n * p.groups + g) * p.chunks;
  float cnt = 0.f, mean = 0.f, m2 = 0.f;
  int k = t;
  constexpr int kStep = kFinishThreads;
  for (; k + 3 * kStep < p.chunks; k += 4 * kStep) {  // four loads in flight
    float2 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = part[k + u * kStep];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      chan_merge(cnt, mean, m2, chunk_count(p, k + u * kStep), v[u].x, v[u].y);
  }
  for (; k < p.chunks; k += kStep) {
    const float2 v = part[k];
    chan_merge(cnt, mean, m2, chunk_count(p, k), v.x, v.y);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, cnt, o);
    const float mb = __shfl_down_sync(0xffffffffu, mean, o);
    const float m2b = __shfl_down_sync(0xffffffffu, m2, o);
    if (lane + o < 32) chan_merge(cnt, mean, m2, nb, mb, m2b);
  }
  if (lane == 0) warp_part[t / 32] = make_float3(cnt, mean, m2);
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kFinishThreads / 32; ++w)
      chan_merge(cnt, mean, m2, warp_part[w].x, warp_part[w].y, warp_part[w].z);
    p.stats[n * p.groups + g] = make_float2(mean, rsqrtf(m2 / cnt + p.eps));
  }
}

__device__ __forceinline__ float affine_at(const void* t, int ch, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(t)[ch])
                 : static_cast<const float*>(t)[ch];
}

template <bool SILU>
__device__ __forceinline__ uint4 apply8(const uint4& raw, const float2 (&ab)[8]) {
  float f[8];
  unpack8(raw, f);
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float y = fmaf(f[j], ab[j].x, ab[j].y);
    // y * sigmoid(y); the fast divide returns 0 once exp(-y) overflows
    if (SILU) y = __fdividef(y, 1.f + __expf(-y));
    f[j] = y;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = pack_bf16(f[2 * j], f[2 * j + 1]);
  return out;
}

template <bool SILU>
__global__ void group_norm_apply_kernel(Params p) {
  extern __shared__ float2 ab_all[];  // (C): each channel's (a, b)
  const int n = blockIdx.y, chunk = blockIdx.x;
  for (int c = threadIdx.x; c < p.c; c += blockDim.x) {
    const float2 st = p.stats[n * p.groups + c / p.gs];
    const float a = st.y * affine_at(p.scale, c, p.affine_bf16);
    ab_all[c] = make_float2(a, fmaf(-st.x, a, affine_at(p.bias, c, p.affine_bf16)));
  }
  __syncthreads();
  const int vec = threadIdx.x % p.v, rl = threadIdx.x / p.v;
  const int m0 = chunk * p.rows, m1 = min(m0 + p.rows, p.m);
  const Column col = column(p, n, vec);
  float2 ab[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) ab[j] = ab_all[vec * 8 + j];
  int m = m0 + rl;
  for (; m + (kUnroll - 1) * p.rpar < m1; m += kUnroll * p.rpar) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = ld16(col.x + (size_t)(m + u * p.rpar) * col.stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      *reinterpret_cast<uint4*>(col.y + (size_t)(m + u * p.rpar) * col.stride) =
          apply8<SILU>(raw[u], ab);
  }
  for (; m < m1; m += p.rpar)
    *reinterpret_cast<uint4*>(col.y + (size_t)m * col.stride) =
        apply8<SILU>(ld16(col.x + (size_t)m * col.stride), ab);
}

cudaError_t check_params(const Params& p, int n) {
  const bool ok = n > 0 && n <= 65535 && p.m > 0 && p.c0 > 0 && p.c0 % 8 == 0 && p.c1 >= 0 &&
                  p.c1 % 8 == 0 && p.c <= kMaxWidth && p.groups > 0 && p.groups <= 65535 &&
                  p.c % p.groups == 0 && p.rpar > 0 && p.v * p.rpar >= 32 &&
                  p.v * p.rpar <= kMaxThreads && p.rows >= 1 &&
                  p.chunks == (p.m + p.rows - 1) / p.rows;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

Params make_params(const void* x0, const void* x1, const void* scale, const void* bias, void* y0,
                   void* y1, void* scratch, int n, int m, int c0, int c1, int groups, int rpar,
                   int rows, int chunks, int affine_bf16, float eps) {
  Params p;
  p.x0 = static_cast<const bf16*>(x0);
  p.x1 = static_cast<const bf16*>(x1);
  p.y0 = static_cast<bf16*>(y0);
  p.y1 = static_cast<bf16*>(y1);
  p.scale = scale;
  p.bias = bias;
  p.part = static_cast<float2*>(scratch);
  p.m = m;
  p.c0 = c0;
  p.c1 = c1;
  p.c = c0 + c1;
  p.groups = groups;
  p.gs = groups > 0 ? p.c / groups : 0;
  p.v0 = c0 / 8;
  p.v = p.c / 8;
  p.rpar = rpar;
  p.rows = rows;
  p.chunks = chunks;
  p.affine_bf16 = affine_bf16;
  p.eps = eps;
  p.stats = p.part + (size_t)n * groups * chunks;
  return p;
}

}  // namespace

// x0, y0: (n, m, c0) and x1, y1: (n, m, c1) bf16, row-major, 16-byte
// aligned (c1 = 0: one part, x1 and y1 unused); scale and bias: (c0 + c1,)
// float32, or bf16 with affine_bf16; scratch: (n * groups * (chunks + 1))
// float2. Blocks of (c0 + c1) / 8 * rpar threads over `rows` rows each,
// chunks = ceil(m / rows) a sample.
INSV2V_EXPORT int group_norm_fwd(const void* x0, const void* x1, const void* scale,
                                 const void* bias, void* y0, void* y1, void* scratch, int n, int m,
                                 int c0, int c1, int groups, int rpar, int rows, int chunks,
                                 int affine_bf16, float eps, int silu, void* stream) {
  cudaGetLastError();  // clear an unrelated earlier error of this runtime
  const Params p = make_params(x0, x1, scale, bias, y0, y1, scratch, n, m, c0, c1, groups, rpar,
                               rows, chunks, affine_bf16, eps);
  cudaError_t err = check_params(p, n);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = p.v * p.rpar;
  const dim3 grid(chunks, n);
  group_norm_stats_kernel<<<grid, threads, stats_smem(p.c, rpar, threads), s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  group_norm_finish_kernel<<<dim3(groups, n), kFinishThreads, 0, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t ab = (size_t)p.c * sizeof(float2);
  if (silu)
    group_norm_apply_kernel<true><<<grid, threads, ab, s>>>(p);
  else
    group_norm_apply_kernel<false><<<grid, threads, ab, s>>>(p);
  return cudaGetLastError();
}

// The stats and apply launches' shape for c channels at rpar rows a block,
// into out[3]: threads a block, then the blocks of each kernel resident an
// SM (the occupancy API).
INSV2V_EXPORT int group_norm_grid(int c, int rpar, int* out) {
  cudaGetLastError();
  if (c <= 0 || c % 8 != 0 || c > kMaxWidth || rpar <= 0 || c / 8 * rpar > kMaxThreads ||
      c / 8 * rpar < 32)
    return cudaErrorInvalidValue;
  const int threads = c / 8 * rpar;
  out[0] = threads;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], group_norm_stats_kernel, threads, stats_smem(c, rpar, threads));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], group_norm_apply_kernel<true>,
                                                       threads, (size_t)c * sizeof(float2));
}
