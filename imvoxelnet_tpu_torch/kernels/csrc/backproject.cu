// Fused image-to-voxel backprojection (masked feature sums + view counts).
//
// Replaces the TPU kernel imvoxelnet_tpu/ops/backproject_pallas.py
// (_kernel / backproject_pallas): for every voxel and view, project the voxel
// center with the view's 3x4 matrix, round to the nearest pixel, mask on the
// valid extent and on positive depth, gather the feature row and accumulate
// the sum and the number of views that see the voxel.  The contract is the
// one of imvoxelnet_tpu/ops/backproject.py:backproject_batch: output rows are
// voxel-major, batch-minor, (P, B, C) sums and (P, B) counts.
//
// Design: one warp per output row (voxel, sample).  Every lane computes the
// projection (a dozen flops, shared by the warp) and walks two channels per
// 64-channel chunk, so the gather of a feature row and the store of an output
// row are 256-byte coalesced accesses.  The view loop stays inside the warp
// with the sum in registers: no atomics, each output row is written once.
//
// Bound on an H100: bytes.  The output is (P * B, C) values written once
// (164 MB per KITTI sample in float32) against a few flops per value; the
// feature table (7.9 MB per KITTI view) is re-read from L2.
//
// Numerics: the projection is the explicit expression p0*x + p1*y + p2*z + p3
// with every multiply and add rounded on its own (__fmul_rn / __fadd_rn, and
// the file is built with -fmad=false), rounded half-to-even with rintf, so the
// kernel picks the same pixel as the plain PyTorch version
// (ops/backproject.py:_view_indices), which evaluates the same expression.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
}

__device__ __forceinline__ float dot4(const float* m, float x, float y,
                                      float z) {
  float s = __fadd_rn(__fmul_rn(m[0], x), __fmul_rn(m[1], y));
  s = __fadd_rn(s, __fmul_rn(m[2], z));
  return __fadd_rn(s, m[3]);
}

template <typename T>
__global__ void backproject_kernel(const T* __restrict__ feats,
                                   const float* __restrict__ points,
                                   const float* __restrict__ proj,
                                   const int* __restrict__ valid_hw,
                                   T* __restrict__ acc, T* __restrict__ cnt,
                                   int B, int V, int Hf, int Wf, int C,
                                   long long P) {
  const int lane = threadIdx.x & 31;
  const long long warps_per_block = blockDim.x >> 5;
  const long long n_rows = P * B;
  const long long stride = (long long)gridDim.x * warps_per_block;
  const long long hw = (long long)Hf * Wf;
  for (long long row = blockIdx.x * warps_per_block + (threadIdx.x >> 5);
       row < n_rows; row += stride) {
    const long long p = row / B;
    const int b = (int)(row - p * B);
    const float* pt = points + ((long long)b * P + p) * 3;
    const float x = pt[0], y = pt[1], z = pt[2];
    const float vh = (float)valid_hw[2 * b];
    const float vw = (float)valid_hw[2 * b + 1];
    T* out = acc + row * C;
    for (int c0 = 0; c0 < C; c0 += 64) {
      const int c = c0 + 2 * lane;
      float s0 = 0.f, s1 = 0.f;
      int n_seen = 0;
      for (int v = 0; v < V; ++v) {
        const float* m = proj + ((long long)b * V + v) * 12;
        const float u = dot4(m, x, y, z);
        const float vv = dot4(m + 4, x, y, z);
        const float w = dot4(m + 8, x, y, z);
        const float w_safe = (w != 0.f) ? w : 1.f;
        const float xf = rintf(__fdiv_rn(u, w_safe));
        const float yf = rintf(__fdiv_rn(vv, w_safe));
        const bool valid = (xf >= 0.f) && (yf >= 0.f) && (xf < vw) &&
                           (yf < vh) && (w > 0.f);
        if (!valid) continue;
        ++n_seen;
        if (c < C) {
          const int xi = min((int)xf, Wf - 1);
          const int yi = min((int)yf, Hf - 1);
          const T* src =
              feats + (((long long)b * V + v) * hw + (long long)yi * Wf + xi) *
                          C + c;
          const float2 f = load2(src);
          s0 = __fadd_rn(s0, f.x);
          s1 = __fadd_rn(s1, f.y);
        }
      }
      if (c < C) store2(out + c, s0, s1);
      if (c0 == 0 && lane == 0) store1(cnt + row, (float)n_seen);
    }
  }
}

template <typename T>
int launch(const void* feats, const void* points, const void* proj,
           const void* valid_hw, void* acc, void* cnt, int B, int V, int Hf,
           int Wf, int C, long long P, cudaStream_t stream) {
  const int threads = 256;
  const long long rows = P * B;
  long long blocks = (rows + (threads / 32) - 1) / (threads / 32);
  if (blocks > 132LL * 2048) blocks = 132LL * 2048;
  if (blocks < 1) blocks = 1;
  backproject_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const float*>(points),
      static_cast<const float*>(proj), static_cast<const int*>(valid_hw),
      static_cast<T*>(acc), static_cast<T*>(cnt), B, V, Hf, Wf, C, P);
  return (int)cudaGetLastError();
}

}  // namespace

// features (B, V, Hf, Wf, C) float32 or bfloat16, C even; points (B, P, 3)
// float32; proj (B, V, 3, 4) float32; valid_hw (B, 2) int32 (h, w);
// acc (P, B, C) and cnt (P, B) in the features' type.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int imvx_backproject(const void* feats, int feats_bf16,
                                const void* points, const void* proj,
                                const void* valid_hw, void* acc, void* cnt,
                                int B, int V, int Hf, int Wf, int C,
                                long long P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feats_bf16)
    return launch<__nv_bfloat16>(feats, points, proj, valid_hw, acc, cnt, B,
                                 V, Hf, Wf, C, P, s);
  return launch<float>(feats, points, proj, valid_hw, acc, cnt, B, V, Hf, Wf,
                       C, P, s);
}
