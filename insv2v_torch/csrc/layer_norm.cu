// Row-wise LayerNorm for Hopper (sm_90a): bf16 in and out, f32 statistics
// and affine, one rounding to bf16.
//
// Replaces the TPU kernel _ln_kernel of the JAX package's ops/fused_norm.py
// (launched by fused_layer_norm). Per row of C values: the f32 mean, then
// the centred variance mean((x - mean)^2) as _ln_kernel computes it (not
// E[x^2] - mean^2), y = (x - mean) * rsqrt(var + eps) * scale + bias with
// f32 scale and bias.
//
// Bound on the H100: bytes. Each element is read once and written once (4
// bytes) for ~8 FLOPs, far below the card's ~295 FLOP/byte balance point,
// so the least time is (2 * rows * C * 2 + 2 * C * 4) bytes / 3.35 TB/s.
// Design: one warp per row, eight rows a block. C <= 1280 puts at most 40
// values in a lane, so the row stays in registers between the two
// reductions and the affine: one 16-byte load and one 16-byte store per 8
// values, and no shared memory.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // one warp each
constexpr int kMaxWidth = 1280;

// NCH: 16-byte chunks (8 values) a lane holds, ceil(C / 256).
template <int NCH>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
layer_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, bf16* __restrict__ y, int rows, int c,
                  float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;  // a whole warp leaves together
  const int nch = c / 8;
  const bf16* xr = x + (size_t)row * c;
  bf16* yr = y + (size_t)row * c;

  float v[NCH][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int ch = lane + 32 * i;
    if (ch < nch) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + ch * 8);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p[j]);
        v[i][2 * j] = f.x;
        v[i][2 * j + 1] = f.y;
        sum += f.x + f.y;
      }
    }
  }
  const float mean = warp_sum(sum) / c;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    if (lane + 32 * i < nch) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float dv = v[i][j] - mean;
        sq += dv * dv;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / c + eps);
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int ch = lane + 32 * i;
    if (ch < nch) {
      const float4* s4 = reinterpret_cast<const float4*>(scale + ch * 8);
      const float4* b4 = reinterpret_cast<const float4*>(bias + ch * 8);
      const float4 s0 = s4[0], s1 = s4[1], b0 = b4[0], b1 = b4[1];
      const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      uint4 out;
      uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = pack_bf16((v[i][2 * j] - mean) * rstd * s[2 * j] + b[2 * j],
                         (v[i][2 * j + 1] - mean) * rstd * s[2 * j + 1] + b[2 * j + 1]);
      *reinterpret_cast<uint4*>(yr + ch * 8) = out;
    }
  }
}

// With ``grid`` set, no launch: grid = {blocks, threads a block, blocks
// resident an SM} of the launch these arguments would make.
template <int NCH>
cudaError_t launch(const bf16* x, const float* scale, const float* bias, bf16* y, int rows,
                   int c, float eps, cudaStream_t stream, int* grid) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (grid) {
    grid[0] = blocks;
    grid[1] = kRowsPerBlock * 32;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&grid[2], layer_norm_kernel<NCH>,
                                                         kRowsPerBlock * 32, 0);
  }
  layer_norm_kernel<NCH><<<blocks, kRowsPerBlock * 32, 0, stream>>>(x, scale, bias, y, rows, c,
                                                                     eps);
  return cudaGetLastError();
}

cudaError_t dispatch(const bf16* x, const float* scale, const float* bias, bf16* y, int rows,
                     int c, float eps, cudaStream_t stream, int* grid) {
  if (rows <= 0 || c <= 0 || c % 8 != 0 || c > kMaxWidth) return cudaErrorInvalidValue;
  switch ((c + 255) / 256) {
    case 1: return launch<1>(x, scale, bias, y, rows, c, eps, stream, grid);
    case 2: return launch<2>(x, scale, bias, y, rows, c, eps, stream, grid);
    case 3: return launch<3>(x, scale, bias, y, rows, c, eps, stream, grid);
    case 4: return launch<4>(x, scale, bias, y, rows, c, eps, stream, grid);
    case 5: return launch<5>(x, scale, bias, y, rows, c, eps, stream, grid);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x and y: (rows, c) bf16; scale and bias: (c,) float32; all contiguous
// and 16-byte aligned; c % 8 == 0 and c <= 1280.
INSV2V_EXPORT int layer_norm_fwd(const void* x, const void* scale, const void* bias, void* y,
                                 int rows, int c, float eps, void* stream) {
  cudaGetLastError();  // clear an unrelated earlier error of this runtime
  return dispatch(static_cast<const bf16*>(x), static_cast<const float*>(scale),
                  static_cast<const float*>(bias), static_cast<bf16*>(y), rows, c, eps,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// The grid layer_norm_fwd launches for (rows, c), into out[3]: blocks,
// threads a block, and blocks resident an SM (the occupancy API).
INSV2V_EXPORT int layer_norm_grid(int rows, int c, int* out) {
  cudaGetLastError();
  return dispatch(nullptr, nullptr, nullptr, nullptr, rows, c, 0.0f, nullptr, out);
}
