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
// Bound on an H100: bytes.  The output is (P * B, C) values written once
// (658 MB for a KITTI batch of 8 in bfloat16) against a few flops per value;
// the feature table (3.9 MB per KITTI view in bfloat16) is re-read from L2.
// What a bytes-bound gather needs is wide accesses and many of them in
// flight, so that the memory system and not the latency of one dependent
// load sets the pace.
//
// Design (backproject_vec_kernel, for rows that are a whole number of
// 16-byte chunks): a group of G = 8, 16 or 32 lanes owns an output row and
// every lane moves 16 bytes of it, so a warp covers 32/G rows per access and
// the projection is computed once per group lane rather than by all 32 lanes
// of a warp.  Every group walks two rows at once: the two gathers of a
// view are issued before either is added, so they are in flight together,
// and at 60 registers a thread four blocks of 256 threads fit an SM (on the
// card two rows with 32 warps an SM beat four rows with 16, and one row with
// 48).  A warp's groups take consecutive rows, so each store instruction
// writes 512 contiguous bytes, with the streaming hint: the output is
// written once and must not push the feature table out of L2.  The
// projection matrices and valid extents of the whole batch sit in shared
// memory; the row index is 32 bits where P * B allows.  A voxel no view sees
// writes its zeros without a gather.  The view loop stays inside the thread
// with the sum in registers: no atomics, each output row is written once.
//
// Rows that are not a multiple of 16 bytes (C = 130) take
// backproject_row_kernel: one warp per row, two channels per lane.
//
// Numerics: the projection is the explicit expression p0*x + p1*y + p2*z + p3
// with every multiply and add rounded on its own (__fmul_rn / __fadd_rn, and
// the file is built with -fmad=false), rounded half-to-even with rintf, so the
// kernel picks the same pixel as the plain PyTorch version
// (ops/backproject.py:_view_indices), which evaluates the same expression;
// the views are summed in order in float32, as there.
//
// Backward (backproject_grad_kernel, entry imvx_backproject_grad): the
// gradient of the sums with respect to the features, a scatter-add
//   grad_feats[b, v, pix(b, v, p)] += grad_acc[p, b]   for every valid (p, v).
// The JAX package differentiates its XLA gather (ops/backproject.py:
// backproject_batch), whose transpose is XLA's scatter-add; Pallas has no
// backward kernel to port.  The pixel is recomputed with the forward's own
// pixel_of (same file, same flags), so the gradient lands on the pixel the
// forward read; nothing of the forward is saved.  One thread owns two
// channels of one (p, b) row, so a warp covers a 64-channel row and its
// atomics hit consecutive addresses of one feature row.  The sums are float32
// atomicAdds into a zeroed float32 table (bfloat16 atomics would lose the
// sum); the wrapper casts the table to the features' type.  Bound: bytes --
// grad_acc is read once (329 MB at a KITTI training batch of 4 in bfloat16)
// and the table (37 MB) stays in L2, where the atomics resolve.  The order in
// which the atomics land changes from run to run, so the result is not
// deterministic: it equals the plain version within float32 rounding of a sum
// of ~12 terms, not bit for bit.

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

// The pixel of point (x, y, z) in the view with matrix m, or -1 where the
// view does not see it.
__device__ __forceinline__ int pixel_of(const float* m, float x, float y,
                                        float z, float vh, float vw, int Hf,
                                        int Wf) {
  const float u = dot4(m, x, y, z);
  const float vv = dot4(m + 4, x, y, z);
  const float w = dot4(m + 8, x, y, z);
  const float w_safe = (w != 0.f) ? w : 1.f;
  const float xf = rintf(__fdiv_rn(u, w_safe));
  const float yf = rintf(__fdiv_rn(vv, w_safe));
  const bool valid =
      (xf >= 0.f) && (yf >= 0.f) && (xf < vw) && (yf < vh) && (w > 0.f);
  if (!valid) return -1;
  const int xi = min((int)xf, Wf - 1);
  const int yi = min((int)yf, Hf - 1);
  return yi * Wf + xi;
}

// 16 bytes of a row as float32 values.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void add(float (&s)[4], const uint4& r) {
    s[0] = __fadd_rn(s[0], __uint_as_float(r.x));
    s[1] = __fadd_rn(s[1], __uint_as_float(r.y));
    s[2] = __fadd_rn(s[2], __uint_as_float(r.z));
    s[3] = __fadd_rn(s[3], __uint_as_float(r.w));
  }
  static __device__ __forceinline__ uint4 pack(const float (&s)[4]) {
    return make_uint4(__float_as_uint(s[0]), __float_as_uint(s[1]),
                      __float_as_uint(s[2]), __float_as_uint(s[3]));
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  // a bfloat16 is the high half of the float32 of the same value
  static __device__ __forceinline__ void add(float (&s)[8], const uint4& r) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[2 * i] = __fadd_rn(s[2 * i], __uint_as_float(w[i] << 16));
      s[2 * i + 1] =
          __fadd_rn(s[2 * i + 1], __uint_as_float(w[i] & 0xFFFF0000u));
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&s)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 v = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&v);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

constexpr int kThreads = 256;
constexpr int kRows = 2;        // rows a lane group walks at once
constexpr int kMinBlocks = 4;   // blocks per SM: 60 registers a thread
constexpr int kGridPerSM = 16;

template <typename T, int G, typename Idx>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
backproject_vec_kernel(const T* __restrict__ feats,
                       const float* __restrict__ points,
                       const float* __restrict__ proj,
                       const int* __restrict__ valid_hw, T* __restrict__ acc,
                       T* __restrict__ cnt, int B, int V, int Hf, int Wf,
                       int C, long long P, int stage_proj) {
  extern __shared__ float s_proj[];
  const float* pj = proj;
  const int* vhw = valid_hw;
  if (stage_proj) {
    const int n_pj = B * V * 12;
    for (int i = threadIdx.x; i < n_pj; i += kThreads) s_proj[i] = proj[i];
    int* s_hw = reinterpret_cast<int*>(s_proj + n_pj);
    for (int i = threadIdx.x; i < 2 * B; i += kThreads) s_hw[i] = valid_hw[i];
    __syncthreads();
    pj = s_proj;
    vhw = s_hw;
  }

  constexpr int N = Chunk<T>::N;
  constexpr int kGroups = 32 / G;            // rows per warp access
  constexpr int kWarpRows = kGroups * kRows;
  const int lane = threadIdx.x & 31;
  const int g = lane % G, grp = lane / G;
  const int n_chunks = C / N;
  const Idx n_rows = (Idx)(P * B);
  const Idx warp = (Idx)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const Idx step = (Idx)gridDim.x * (kThreads / 32) * kWarpRows;
  const long long hw = (long long)Hf * Wf;

  for (Idx base = warp * kWarpRows; base < n_rows; base += step) {
    Idx row[kRows];
    bool live[kRows];
    int bb[kRows];
    float x[kRows], y[kRows], z[kRows], vh[kRows], vw[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      row[r] = base + r * kGroups + grp;
      live[r] = row[r] < n_rows;
      const Idx p = live[r] ? row[r] / B : 0;
      bb[r] = live[r] ? (int)(row[r] - p * B) : 0;
      const float* pt = points + ((long long)bb[r] * P + p) * 3;
      x[r] = pt[0]; y[r] = pt[1]; z[r] = pt[2];
      vh[r] = (float)vhw[2 * bb[r]];
      vw[r] = (float)vhw[2 * bb[r] + 1];
    }
    for (int c0 = 0; c0 < n_chunks; c0 += G) {
      const int c = c0 + g;
      const bool has = c < n_chunks;
      float s[kRows][N];
      int n_seen[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        n_seen[r] = 0;
#pragma unroll
        for (int i = 0; i < N; ++i) s[r][i] = 0.f;
      }
      for (int v = 0; v < V; ++v) {
        uint4 raw[kRows];
        bool hit[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int pix = pixel_of(pj + (bb[r] * V + v) * 12, x[r], y[r], z[r],
                                   vh[r], vw[r], Hf, Wf);
          hit[r] = live[r] && pix >= 0;
          if (hit[r]) {
            ++n_seen[r];
            if (has)
              raw[r] = __ldg(reinterpret_cast<const uint4*>(
                  feats + (((long long)bb[r] * V + v) * hw + pix) * C +
                  c * N));
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (hit[r] && has) Chunk<T>::add(s[r], raw[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (!live[r]) continue;
        if (has) {
          uint4* dst =
              reinterpret_cast<uint4*>(acc + (size_t)row[r] * C + c * N);
          __stcs(dst, Chunk<T>::pack(s[r]));   // written once, never re-read
        }
        if (c == 0) store1(cnt + row[r], (float)n_seen[r]);
      }
    }
  }
}

// One warp per output row, two channels per lane: any even C.
template <typename T>
__global__ void backproject_row_kernel(const T* __restrict__ feats,
                                       const float* __restrict__ points,
                                       const float* __restrict__ proj,
                                       const int* __restrict__ valid_hw,
                                       T* __restrict__ acc,
                                       T* __restrict__ cnt, int B, int V,
                                       int Hf, int Wf, int C, long long P) {
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
        const int pix = pixel_of(proj + ((long long)b * V + v) * 12, x, y, z,
                                 vh, vw, Hf, Wf);
        if (pix < 0) continue;
        ++n_seen;
        if (c < C) {
          const float2 f =
              load2(feats + (((long long)b * V + v) * hw + pix) * C + c);
          s0 = __fadd_rn(s0, f.x);
          s1 = __fadd_rn(s1, f.y);
        }
      }
      if (c < C) store2(out + c, s0, s1);
      if (c0 == 0 && lane == 0) store1(cnt + row, (float)n_seen);
    }
  }
}

template <typename T, int G, typename Idx>
int launch_vec(const T* feats, const float* points, const float* proj,
               const int* valid_hw, T* acc, T* cnt, int B, int V, int Hf,
               int Wf, int C, long long P, cudaStream_t stream) {
  const long long rows = P * B;
  const long long block_rows = (long long)(kThreads / 32) * (32 / G) * kRows;
  long long blocks = (rows + block_rows - 1) / block_rows;
  if (blocks > 132LL * kGridPerSM) blocks = 132LL * kGridPerSM;
  const size_t staged = ((size_t)B * V * 12 + 2 * (size_t)B) * 4;
  const int stage_proj = staged <= 32768;
  backproject_vec_kernel<T, G, Idx>
      <<<(unsigned)blocks, kThreads, stage_proj ? staged : 0, stream>>>(
          feats, points, proj, valid_hw, acc, cnt, B, V, Hf, Wf, C, P,
          stage_proj);
  return (int)cudaGetLastError();
}

template <typename T, int G>
int launch_vec_idx(const T* feats, const float* points, const float* proj,
                   const int* valid_hw, T* acc, T* cnt, int B, int V, int Hf,
                   int Wf, int C, long long P, cudaStream_t stream) {
  // 32-bit rows, with room for the stride of the last step
  if (P * B < (1LL << 30))
    return launch_vec<T, G, int>(feats, points, proj, valid_hw, acc, cnt, B,
                                 V, Hf, Wf, C, P, stream);
  return launch_vec<T, G, long long>(feats, points, proj, valid_hw, acc, cnt,
                                     B, V, Hf, Wf, C, P, stream);
}

template <typename T>
int launch(const void* feats_v, const void* points_v, const void* proj_v,
           const void* valid_hw_v, void* acc_v, void* cnt_v, int B, int V,
           int Hf, int Wf, int C, long long P, cudaStream_t stream) {
  const T* feats = static_cast<const T*>(feats_v);
  const float* points = static_cast<const float*>(points_v);
  const float* proj = static_cast<const float*>(proj_v);
  const int* valid_hw = static_cast<const int*>(valid_hw_v);
  T* acc = static_cast<T*>(acc_v);
  T* cnt = static_cast<T*>(cnt_v);
  if (P * B < 1) return 0;
  const size_t row_bytes = (size_t)C * sizeof(T);
  const bool vec = row_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(acc) % 16 == 0;
  if (vec) {
    const size_t chunks = row_bytes / 16;
    if (chunks <= 8)
      return launch_vec_idx<T, 8>(feats, points, proj, valid_hw, acc, cnt, B,
                                  V, Hf, Wf, C, P, stream);
    if (chunks <= 16)
      return launch_vec_idx<T, 16>(feats, points, proj, valid_hw, acc, cnt, B,
                                   V, Hf, Wf, C, P, stream);
    return launch_vec_idx<T, 32>(feats, points, proj, valid_hw, acc, cnt, B,
                                 V, Hf, Wf, C, P, stream);
  }
  const int threads = 256;
  const long long rows = P * B;
  long long blocks = (rows + (threads / 32) - 1) / (threads / 32);
  if (blocks > 132LL * 2048) blocks = 132LL * 2048;
  backproject_row_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      feats, points, proj, valid_hw, acc, cnt, B, V, Hf, Wf, C, P);
  return (int)cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
backproject_grad_kernel(const T* __restrict__ grad_acc,
                        const float* __restrict__ points,
                        const float* __restrict__ proj,
                        const int* __restrict__ valid_hw,
                        float* __restrict__ grad_feats, int B, int V, int Hf,
                        int Wf, int C, long long P, int stage_proj) {
  extern __shared__ float s_proj[];
  const float* pj = proj;
  const int* vhw = valid_hw;
  if (stage_proj) {
    const int n_pj = B * V * 12;
    for (int i = threadIdx.x; i < n_pj; i += kThreads) s_proj[i] = proj[i];
    int* s_hw = reinterpret_cast<int*>(s_proj + n_pj);
    for (int i = threadIdx.x; i < 2 * B; i += kThreads) s_hw[i] = valid_hw[i];
    __syncthreads();
    pj = s_proj;
    vhw = s_hw;
  }
  const int half = C / 2;
  const long long n = P * B * half;
  const long long hw = (long long)Hf * Wf;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < n;
       t += (long long)gridDim.x * kThreads) {
    const long long row = t / half;
    const int c = 2 * (int)(t - row * half);
    const long long p = row / B;
    const int b = (int)(row - p * B);
    const float* pt = points + ((long long)b * P + p) * 3;
    const float x = pt[0], y = pt[1], z = pt[2];
    const float vh = (float)vhw[2 * b], vw = (float)vhw[2 * b + 1];
    const float2 g = load2(grad_acc + row * C + c);
    for (int v = 0; v < V; ++v) {
      const int pix =
          pixel_of(pj + (b * V + v) * 12, x, y, z, vh, vw, Hf, Wf);
      if (pix < 0) continue;
      float* dst = grad_feats + (((long long)b * V + v) * hw + pix) * C + c;
      atomicAdd(dst, g.x);
      atomicAdd(dst + 1, g.y);
    }
  }
}

template <typename T>
int launch_grad(const void* grad_acc, const void* points, const void* proj,
                const void* valid_hw, void* grad_feats, int B, int V, int Hf,
                int Wf, int C, long long P, cudaStream_t stream) {
  const long long n = P * B * (C / 2);
  if (n < 1) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * kGridPerSM) blocks = 132LL * kGridPerSM;
  const size_t staged = ((size_t)B * V * 12 + 2 * (size_t)B) * 4;
  const int stage_proj = staged <= 32768;
  backproject_grad_kernel<T>
      <<<(unsigned)blocks, kThreads, stage_proj ? staged : 0, stream>>>(
          static_cast<const T*>(grad_acc), static_cast<const float*>(points),
          static_cast<const float*>(proj), static_cast<const int*>(valid_hw),
          static_cast<float*>(grad_feats), B, V, Hf, Wf, C, P, stage_proj);
  return (int)cudaGetLastError();
}

}  // namespace

// grad_acc (P, B, C) float32 or bfloat16, C even; points (B, P, 3) float32;
// proj (B, V, 3, 4) float32; valid_hw (B, 2) int32; grad_feats
// (B, V, Hf, Wf, C) float32, zeroed by the caller, receives the sums.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int imvx_backproject_grad(const void* grad_acc, int grad_bf16,
                                     const void* points, const void* proj,
                                     const void* valid_hw, void* grad_feats,
                                     int B, int V, int Hf, int Wf, int C,
                                     long long P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grad_bf16)
    return launch_grad<__nv_bfloat16>(grad_acc, points, proj, valid_hw,
                                      grad_feats, B, V, Hf, Wf, C, P, s);
  return launch_grad<float>(grad_acc, points, proj, valid_hw, grad_feats, B,
                            V, Hf, Wf, C, P, s);
}

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
