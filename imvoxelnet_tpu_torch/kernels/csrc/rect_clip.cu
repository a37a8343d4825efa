// Rotated-rectangle intersection area by a sort-free Sutherland-Hodgman clip.
//
// Replaces the TPU kernel imvoxelnet_tpu/ops/iou_pallas.py
// (_clip_kernel / _pallas_area_flat / rect_intersection_area_pallas): clip
// rect1 against the four edges of rect2, keeping the polygon in 8 slots and
// compacting the emitted vertices after every edge, then take the area by
// the shoelace formula.
//
// Design: one thread per pair, the 8-slot polygon in per-thread arrays, the
// compaction a per-thread loop that writes each emitted vertex to its packed
// slot (the Pallas kernel's masked-sum scatter selects the same value).
//
// Bound on an H100: launch latency.  KITTI NMS clips 100 x 100 = 10,000
// pairs per sample, 64 bytes in and 4 bytes out each: a few microseconds of
// work for the whole card.
//
// Numerics: the areas are bit-identical to the plain PyTorch version
// (ops/iou.py:rect_intersection_area_plain) and to the JAX reference
// (imvoxelnet_tpu/ops/iou.py:_rect_intersection_area_jnp).  Every operation
// is rounded on its own (explicit __f*_rn intrinsics, -fmad=false), in the
// same order: the rect2 center is ((c0 + c1) + c2) + c3) * 0.25 and the
// shoelace sum runs over the slots in order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 8;

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }

__global__ void rect_clip_kernel(const float* __restrict__ c1,
                                 const float* __restrict__ c2,
                                 float* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float vx[kSlots], vy[kSlots], s[kSlots];
  float bx[4], by[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    vx[k] = c1[i * 8 + 2 * k];
    vy[k] = c1[i * 8 + 2 * k + 1];
    bx[k] = c2[i * 8 + 2 * k];
    by[k] = c2[i * 8 + 2 * k + 1];
  }
#pragma unroll
  for (int k = 4; k < kSlots; ++k) vx[k] = vy[k] = 0.f;
  int count = 4;

  const float cx2 = fmul(fadd(fadd(fadd(bx[0], bx[1]), bx[2]), bx[3]), 0.25f);
  const float cy2 = fmul(fadd(fadd(fadd(by[0], by[1]), by[2]), by[3]), 0.25f);

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float ax = bx[e], ay = by[e];
    const float abx = fsub(bx[(e + 1) % 4], ax);
    const float aby = fsub(by[(e + 1) % 4], ay);
    const float ref =
        fsub(fmul(abx, fsub(cy2, ay)), fmul(aby, fsub(cx2, ax)));
    const float sign = ref >= 0.f ? 1.f : -1.f;
    // slots beyond the 8th are dropped, as the reference's fixed 8 rows do;
    // `count` itself is kept as emitted, like the reference's.
    const int n_act = count < kSlots ? count : kSlots;
    for (int k = 0; k < n_act; ++k)
      s[k] = fmul(fsub(fmul(abx, fsub(vy[k], ay)), fmul(aby, fsub(vx[k], ax))),
                  sign);
    float nx_[kSlots], ny_[kSlots];
    int pos = 0;
    for (int k = 0; k < n_act; ++k) {
      const int nk = (k + 1 < n_act) ? k + 1 : 0;
      const float s_cur = s[k], s_nxt = s[nk];
      const bool in_cur = s_cur >= 0.f;
      const bool in_nxt = s_nxt >= 0.f;
      if (in_cur) {
        if (pos < kSlots) { nx_[pos] = vx[k]; ny_[pos] = vy[k]; }
        ++pos;
      }
      if (in_cur != in_nxt) {
        const float denom = fsub(s_cur, s_nxt);
        const float t = __fdiv_rn(s_cur, fabsf(denom) > 1e-12f ? denom : 1.f);
        if (pos < kSlots) {
          nx_[pos] = fadd(vx[k], fmul(t, fsub(vx[nk], vx[k])));
          ny_[pos] = fadd(vy[k], fmul(t, fsub(vy[nk], vy[k])));
        }
        ++pos;
      }
    }
    const int n_new = pos < kSlots ? pos : kSlots;
    for (int k = 0; k < n_new; ++k) { vx[k] = nx_[k]; vy[k] = ny_[k]; }
    count = pos;
  }

  // shoelace over all 8 slots; inactive slots repeat the first vertex
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int nk = (k + 1) % kSlots;
    const float cx = k < count ? vx[k] : vx[0];
    const float cy = k < count ? vy[k] : vy[0];
    const float nx = nk < count ? vx[nk] : vx[0];
    const float ny = nk < count ? vy[nk] : vy[0];
    sum = fadd(sum, fsub(fmul(cx, ny), fmul(cy, nx)));
  }
  const float area = fmul(0.5f, fabsf(sum));
  out[i] = count > 2 ? area : 0.f;
}

}  // namespace

// corners1, corners2: (n, 4, 2) float32; areas: (n,) float32.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int imvx_rect_clip(const void* corners1, const void* corners2,
                              void* areas, long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  rect_clip_kernel<<<(unsigned)blocks, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(corners1), static_cast<const float*>(corners2),
      static_cast<float*>(areas), n);
  return (int)cudaGetLastError();
}
