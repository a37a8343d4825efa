// 3x3x3 SAME stride-1 convolution, 64 -> 64 channels, channels-last volumes.
//
// Replaces the TPU kernel imvoxelnet_tpu/ops/conv3z_pallas.py
// (_kernel / _conv3z_pallas / conv3z_lanepack), which runs the KITTI neck's
// block0 convolutions: (B, nx, ny, nz, 64) x (3, 3, 3, 64, 64) with float32
// accumulation.  The Pallas kernel packs the three z taps into the matmul's
// output lanes to fill the TPU's 128-lane matrix unit; nothing on Hopper
// asks for that, so this kernel is a plain implicit GEMM.
//
// Design: the GEMM has M = B*nx*ny*nz output sites, N = 64 output channels
// and K = 27 taps x 64 input channels.  A block owns a 128-site x 64-channel
// output tile; it walks K in 32-channel slices of one tap, staging the
// shifted input slice (zero outside the volume, which is the SAME padding)
// and the tap's weight slice in shared memory.  Each of its 256 threads
// keeps an 8 x 4 float32 accumulator tile in registers.  bfloat16 inputs are
// widened to float32 when they are staged, so both types accumulate in
// float32 on the CUDA cores.
//
// Bound on an H100: operations.  2 * 27 * 64 * 64 flops per site, 142 GFLOP
// per KITTI sample; the input and output move 329 MB per sample in float32.
// This first version runs on the CUDA cores (67 TFLOP/s float32 peak), not
// the tensor cores; moving the bfloat16 path to wgmma is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;     // input and output channels
constexpr int kBM = 128;   // output sites per block
constexpr int kBK = 32;    // input channels per K step
constexpr int kTM = 8;     // sites per thread
constexpr int kTN = 4;     // output channels per thread
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ out, int B, int NX, int NY, int NZ) {
  __shared__ float As[kBK][kBM];
  __shared__ float Bs[kBK][kC];

  const int tid = threadIdx.x;
  const long long M = (long long)B * NX * NY * NZ;
  const long long m0 = (long long)blockIdx.x * kBM;

  // staging role: each thread loads 16 channels of one site per K step
  const int a_row = tid >> 1;
  const int a_c = (tid & 1) * 16;
  const long long a_site = m0 + a_row;
  int sb = 0, sx = 0, sy = 0, sz = 0;
  const bool a_in = a_site < M;
  if (a_in) {
    long long r = a_site;
    sz = (int)(r % NZ); r /= NZ;
    sy = (int)(r % NY); r /= NY;
    sx = (int)(r % NX); r /= NX;
    sb = (int)r;
  }
  // weight staging: each thread loads 8 of the 32 x 64 slice
  const int b_k = tid >> 3;
  const int b_n = (tid & 7) * 8;

  // compute role
  const int ty = tid >> 4;   // site group: rows ty*8 .. ty*8+7
  const int tx = tid & 15;   // channel group: cols tx*4 .. tx*4+3
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 27; ++tap) {
    const int dx = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dz = tap % 3 - 1;
    const int ix = sx + dx, iy = sy + dy, iz = sz + dz;
    const bool inside = a_in && ix >= 0 && ix < NX && iy >= 0 && iy < NY &&
                        iz >= 0 && iz < NZ;
    const T* src =
        x + ((((long long)sb * NX + ix) * NY + iy) * NZ + iz) * kC + a_c;
    for (int c0 = 0; c0 < kC; c0 += kBK) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        As[a_c + j][a_row] = inside ? to_f(src[c0 + j]) : 0.f;
      const T* wsrc = w + ((long long)tap * kC + c0 + b_k) * kC + b_n;
#pragma unroll
      for (int j = 0; j < 8; ++j) Bs[b_k][b_n + j] = to_f(wsrc[j]);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float a[kTM], b[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = As[k][ty * kTM + i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) b[j] = Bs[k][tx * kTN + j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long site = m0 + ty * kTM + i;
    if (site >= M) continue;
    T* dst = out + site * kC + tx * kTN;
#pragma unroll
    for (int j = 0; j < kTN; ++j) put(dst + j, acc[i][j]);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int B, int NX, int NY,
           int NZ, cudaStream_t stream) {
  const long long M = (long long)B * NX * NY * NZ;
  const long long blocks = (M + kBM - 1) / kBM;
  conv3x3x3_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      B, NX, NY, NZ);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, NX, NY, NZ, 64) and out (B, NX, NY, NZ, 64) channels-last; w packed as
// (27, 64, 64) = (tap = (dx*3 + dy)*3 + dz, ci, co); all float32 or all
// bfloat16.  Returns the CUDA error code of the launch (0 on success).
extern "C" int imvx_conv3x3x3(const void* x, const void* w, void* out,
                              int is_bf16, int B, int NX, int NY, int NZ,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, w, out, B, NX, NY, NZ, s);
  return launch<float>(x, w, out, B, NX, NY, NZ, s);
}
