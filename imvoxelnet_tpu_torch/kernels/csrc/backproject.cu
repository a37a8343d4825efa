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
// Backward (entry imvx_backproject_grad): the gradient of the sums with
// respect to the features,
//   grad_feats[b, v, pix] = sum over the voxels p with pix(b, v, p) = pix of
//                           grad_acc[p, b].
// The JAX package differentiates its XLA gather (ops/backproject.py:
// backproject_batch), whose transpose is XLA's scatter-add; Pallas has no
// backward kernel to port.  Bound: bytes -- grad_acc is read once (329 MB at
// a KITTI training batch of 4 in bfloat16), the output written once.
//
// Design: a pixel-major gather with no floating-point atomics, so every
// output row is one float32 sum in a fixed order and the result repeats bit
// for bit.  Four passes and one memset:
//   1. grad_count_kernel, one thread per (b, p): the pixel of every view with
//      the forward's own pixel_of (same file, same flags, so the pixel the
//      forward read; nothing of the forward is saved), and a slot in the
//      pixel's segment from an integer atomic on its count -- one atomic for
//      all lanes of a warp that hit the same pixel (__match_any_sync).
//   2. grad_scan_kernel: an exclusive scan of the B*V*Hf*Wf counts gives each
//      pixel's segment; one pass, a block a tile, each tile adding the totals
//      its predecessors publish.
//   3. grad_fill_kernel: every seen (b, v, p) writes p into its slot.
//   4. grad_sum_kernel, a group of lanes per output row: it brings its
//      segment into shared memory and puts it in ascending voxel order --
//      the slots follow the order in which the atomics landed -- by ranking
//      every entry (rank = the number of smaller entries; the entries of a
//      segment are distinct).  It then reads each grad_acc row with
//      16-byte loads (two channels a lane where a row is not whole 16-byte
//      chunks), four rows a lane in flight, adds in float32 registers from
//      zero and writes the row once, rounded to nearest even; a row no voxel
//      sees is written as zeros.  The groups of a warp take the B*V rows of
//      one pixel, which read neighbouring grad_acc rows.
// No zero-fill of the output, no cast pass, and integer counts are exact in
// any order.  Adding in ascending voxel order from zero is what the plain
// version (ops/backproject.py:backproject_batch_grad_plain, index_add_ on the
// CPU) does, so the kernel equals it bit for bit on the same inputs.
// What bounds it on the card: the sum pass's random 128-byte row reads (the
// rows a pixel reads lie along its ray, all over grad_acc), then the count
// and fill passes' integer traffic (PERF.md has each pass's time).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
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

// ---------------------------------------------------------------------------
// Backward: a deterministic pixel-major gather (see the header).
// ---------------------------------------------------------------------------

constexpr int kScanThreads = 512;
constexpr int kScanItems = 8;
constexpr int kScanTile = kScanThreads * kScanItems;

// Pass 1, one thread per (b, p): the pixel of every view (-1 where the view
// does not see the voxel) and a slot in its pixel's segment.  Lanes of a
// warp that hit the same pixel claim their slots with one integer atomic.
__global__ void __launch_bounds__(kThreads)
grad_count_kernel(const float* __restrict__ points,
                  const float* __restrict__ proj,
                  const int* __restrict__ valid_hw,
                  int2* __restrict__ pix_slot, int* __restrict__ counts,
                  int B, int V, int Hf, int Wf, int P, int stage_proj) {
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
  const int lane = threadIdx.x & 31;
  // B * V * P < 2^31 (the wrapper checks)
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const bool live = t < B * P;
  const int b = live ? t / P : 0;
  const int p = t - b * P;
  float x = 0.f, y = 0.f, z = 0.f, vh = 0.f, vw = 0.f;
  if (live) {
    const float* pt = points + 3LL * t;
    x = pt[0]; y = pt[1]; z = pt[2];
    vh = (float)vhw[2 * b];
    vw = (float)vhw[2 * b + 1];
  }
  const int hw = Hf * Wf;
  for (int v = 0; v < V; ++v) {     // every lane runs every view
    const int bv = b * V + v;
    const int pix =
        live ? pixel_of(pj + bv * 12, x, y, z, vh, vw, Hf, Wf) : -1;
    const int key = pix >= 0 ? bv * hw + pix : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (key >= 0 && lane == leader)
      base = atomicAdd(counts + key, __popc(peers));
    base = __shfl_sync(0xffffffffu, base, leader);
    const unsigned before = peers & ((1u << lane) - 1u);
    if (live) pix_slot[bv * P + p] = make_int2(pix, base + __popc(before));
  }
}

// Pass 2: exclusive scan of the K + 1 counts in place (the last count is 0,
// so it becomes the total).  One tile of 4096 counts a block; a block takes
// the next tile from a counter, publishes its tile's total with a flag in
// one 64-bit word and adds the totals of the tiles before it, which were
// taken by blocks already running.
__global__ void __launch_bounds__(kScanThreads)
grad_scan_kernel(int* __restrict__ counts, long long n,
                 unsigned long long* __restrict__ tile_state,
                 int* __restrict__ tile_counter) {
  __shared__ int s_tile;
  __shared__ int s_warp[kScanThreads / 32];
  __shared__ int s_prefix;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(tile_counter, 1);
  __syncthreads();
  const int tile = s_tile;
  const long long base =
      (long long)tile * kScanTile + threadIdx.x * kScanItems;
  int vals[kScanItems];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    vals[i] = base + i < n ? counts[base + i] : 0;
    sum += vals[i];
  }
  // block-wide exclusive scan of the per-thread sums
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kScanThreads / 32 ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += o;
    }
    if (lane < kScanThreads / 32) s_warp[lane] = w;   // inclusive
  }
  __syncthreads();
  const int tile_total = s_warp[kScanThreads / 32 - 1];
  int excl = incl - sum + (warp > 0 ? s_warp[warp - 1] : 0);
  if (threadIdx.x == 0)
    atomicExch(tile_state + tile, (1ull << 32) | (unsigned)tile_total);
  // the totals of the tiles before this one
  int before = 0;
  for (int i = threadIdx.x; i < tile; i += kScanThreads) {
    unsigned long long s;
    do {
      s = *reinterpret_cast<volatile unsigned long long*>(tile_state + i);
    } while ((s >> 32) == 0);
    before += (int)(unsigned)(s & 0xFFFFFFFFull);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    before += __shfl_down_sync(0xffffffffu, before, d);
  __syncthreads();                  // s_warp is read above; reuse it
  if (lane == 0) s_warp[warp] = before;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kScanThreads / 32; ++w) total += s_warp[w];
    s_prefix = total;
  }
  __syncthreads();
  excl += s_prefix;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (base + i < n) counts[base + i] = excl;
    excl += vals[i];
  }
}

// Pass 3, one thread per (b, v, p): write the voxel index into its slot of
// its pixel's segment.
__global__ void __launch_bounds__(kThreads)
grad_fill_kernel(const int2* __restrict__ pix_slot,
                 const int* __restrict__ offsets, int* __restrict__ entries,
                 int n, int P, int hw) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const int2 ps = pix_slot[t];
  if (ps.x < 0) return;
  const int bv = t / P;
  entries[offsets[bv * hw + ps.x] + ps.y] = t - bv * P;
}

// A lane's share of a row: 16 bytes (rows that are whole 16-byte chunks) or
// two channels (any even C).
template <typename T>
struct Vec16 {
  static constexpr int N = Chunk<T>::N;
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const T* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));   // read once
  }
  static __device__ __forceinline__ void add(float (&s)[N], const Raw& r) {
    Chunk<T>::add(s, r);
  }
  static __device__ __forceinline__ void store(T* p, const float (&s)[N]) {
    *reinterpret_cast<uint4*>(p) = Chunk<T>::pack(s);
  }
};
template <typename T>
struct Pair {
  static constexpr int N = 2;
  using Raw = float2;
  static __device__ __forceinline__ Raw load(const T* p) { return load2(p); }
  static __device__ __forceinline__ void add(float (&s)[2], const Raw& r) {
    s[0] = __fadd_rn(s[0], r.x);
    s[1] = __fadd_rn(s[1], r.y);
  }
  static __device__ __forceinline__ void store(T* p, const float (&s)[2]) {
    store2(p, s[0], s[1]);
  }
};

constexpr int kSumUnroll = 4;   // rows a lane has in flight
constexpr int kSegSmem = 160;   // longest segment ordered in shared memory
// a group's two lists (as found, as ordered), padded so that the groups of a
// warp read other banks
constexpr int kSegStride = 2 * kSegSmem + 8;

// Pass 4: a group of G lanes per output row (b, v, pixel); the groups of a
// warp take the B * V rows of one pixel and then the next pixel, so that
// they read neighbouring grad_acc rows.  The group puts its segment in
// ascending voxel order, then walks it kSumUnroll rows at a time, all their
// loads issued before the first add, adding in float32 registers; it writes
// the row once.
template <typename T, typename L, int G>
__global__ void __launch_bounds__(kThreads, 4)
grad_sum_kernel(const T* __restrict__ grad_acc,
                const int* __restrict__ offsets,
                const int* __restrict__ entries, int* __restrict__ sorted,
                T* __restrict__ out, int B, int V, int hw, int C) {
  constexpr int N = L::N;
  __shared__ __align__(16) int s_seg[kThreads / G * kSegStride];
  const int lane = threadIdx.x & 31;
  const int g = lane % G, grp = lane / G;
  const unsigned gmask =
      G == 32 ? 0xffffffffu : (((1u << G) - 1u) << (grp * G));
  const int bvs = B * V;
  const long long w =
      ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) *
          (32 / G) + grp;
  if (w >= (long long)bvs * hw) return;   // the whole group leaves together
  const int pix = (int)w / bvs;
  const int bv = (int)w - pix * bvs;
  const int b = bv / V;
  const int key = bv * hw + pix;
  const int s = offsets[key];
  const int n = offsets[key + 1] - s;

  // The segment's entries came in the order in which the count pass's
  // atomics landed: the group ranks each entry (rank = the number of smaller
  // entries) into ascending order.  A segment of up to kSegSmem entries is
  // ranked in shared memory; a longer one with shuffles into `sorted`.
  const int* seg = entries + s;
  if (n > 1 && n <= kSegSmem) {
    int* s_in = s_seg + threadIdx.x / G * kSegStride;
    int* s_out = s_in + kSegSmem;
    const int n4 = (n + 3) & ~3;
    for (int i = g; i < n4; i += G) s_in[i] = i < n ? seg[i] : INT_MAX;
    __syncwarp(gmask);
    for (int i = g; i < n; i += G) {
      const int mine = s_in[i];
      int rank = 0;
      for (int j = 0; j < n4; j += 4) {
        const int4 e = *reinterpret_cast<const int4*>(s_in + j);
        rank += (e.x < mine) + (e.y < mine) + (e.z < mine) + (e.w < mine);
      }
      s_out[rank] = mine;
    }
    __syncwarp(gmask);
    seg = s_out;
  } else if (n > kSegSmem) {
    for (int i = 0; i < n; i += G) {
      const int mine = i + g < n ? seg[i + g] : INT_MAX;
      int rank = 0;
      for (int j = 0; j < n; j += G) {
        const int e = j + g < n ? seg[j + g] : INT_MAX;
        const int m = min(G, n - j);
        for (int k = 0; k < m; ++k)
          rank += __shfl_sync(gmask, e, k, G) < mine;
      }
      if (i + g < n) sorted[s + rank] = mine;
    }
    __syncwarp(gmask);
    seg = sorted + s;
  }

  const int n_chunks = C / N;
  const long long row_stride = (long long)B * C;
  T* dst_row = out + (long long)key * C;
  for (int c0 = 0; c0 < n_chunks; c0 += G) {
    const int c = c0 + g;
    const bool has = c < n_chunks;
    const T* src = grad_acc + (long long)b * C + c * N;
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    for (int i = 0; i < n; i += kSumUnroll) {
      typename L::Raw raw[kSumUnroll];
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u)
        if (has && i + u < n) raw[u] = L::load(src + seg[i + u] * row_stride);
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u)
        if (has && i + u < n) L::add(acc, raw[u]);
    }
    if (has) L::store(dst_row + c * N, acc);
  }
}

// The scratch of the backward, laid out as: pix_slot (B*V*P int2, later
// the ordered segments), entries (B*V*P int), counts (K + 1 int, K =
// B*V*Hf*Wf), the scan's tile counter (int, padded to 8 bytes) and its tile
// words (one uint64 a tile).  Byte offsets of each part, and the end.
struct GradLayout {
  size_t entries, counts, counter, state, end;
};

GradLayout grad_layout(int B, int V, int Hf, int Wf, long long P) {
  const size_t bvp = (size_t)B * V * P;
  const size_t k1 = (size_t)B * V * Hf * Wf + 1;
  const size_t tiles = (k1 + kScanTile - 1) / kScanTile;
  GradLayout l;
  l.entries = bvp * sizeof(int2);
  l.counts = l.entries + (bvp + 1) / 2 * 2 * sizeof(int);
  l.counter = l.counts + (k1 + 1) / 2 * 2 * sizeof(int);
  l.state = l.counter + 2 * sizeof(int);
  l.end = l.state + tiles * sizeof(unsigned long long);
  return l;
}

struct GradScratch {
  int2* pix_slot;
  int* entries;
  int* counts;
  int* tile_counter;
  unsigned long long* tile_state;
  size_t zeroed_bytes;      // counts .. tile words, zeroed before pass 1
};

GradScratch grad_scratch(void* base, int B, int V, int Hf, int Wf,
                         long long P) {
  const GradLayout l = grad_layout(B, V, Hf, Wf, P);
  char* c = static_cast<char*>(base);
  GradScratch g;
  g.pix_slot = reinterpret_cast<int2*>(c);
  g.entries = reinterpret_cast<int*>(c + l.entries);
  g.counts = reinterpret_cast<int*>(c + l.counts);
  g.tile_counter = reinterpret_cast<int*>(c + l.counter);
  g.tile_state = reinterpret_cast<unsigned long long*>(c + l.state);
  g.zeroed_bytes = l.end - l.counts;
  return g;
}

template <typename T, typename L, int G>
int launch_grad_sum(const T* grad_acc, const GradScratch& sc, T* out, int B,
                    int V, int hw, int C, cudaStream_t stream) {
  const long long groups = (long long)B * V * hw;
  const long long per_block = (kThreads / 32) * (32 / G);
  grad_sum_kernel<T, L, G>
      <<<(unsigned)((groups + per_block - 1) / per_block), kThreads, 0,
         stream>>>(grad_acc, sc.counts, sc.entries,
                   reinterpret_cast<int*>(sc.pix_slot), out, B, V, hw, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_grad(const void* grad_acc_v, const void* points, const void* proj,
                const void* valid_hw, void* out_v, void* scratch, int B,
                int V, int Hf, int Wf, int C, long long P,
                cudaStream_t stream) {
  const T* grad_acc = static_cast<const T*>(grad_acc_v);
  T* out = static_cast<T*>(out_v);
  const GradScratch sc = grad_scratch(scratch, B, V, Hf, Wf, P);
  const int hw = Hf * Wf;
  const long long k1 = (long long)B * V * hw + 1;
  int err = (int)cudaMemsetAsync(sc.counts, 0, sc.zeroed_bytes, stream);
  if (err) return err;

  // 1. pixels, counts and slots
  if (P * B > 0) {
    const size_t staged = ((size_t)B * V * 12 + 2 * (size_t)B) * 4;
    const int stage_proj = staged <= 32768;
    grad_count_kernel<<<(int)((P * B + kThreads - 1) / kThreads), kThreads,
                        stage_proj ? staged : 0, stream>>>(
        static_cast<const float*>(points), static_cast<const float*>(proj),
        static_cast<const int*>(valid_hw), sc.pix_slot, sc.counts, B, V, Hf,
        Wf, (int)P, stage_proj);
    if ((err = (int)cudaGetLastError())) return err;
  }
  // 2. segment offsets
  grad_scan_kernel<<<(unsigned)((k1 + kScanTile - 1) / kScanTile),
                     kScanThreads, 0, stream>>>(sc.counts, k1, sc.tile_state,
                                                sc.tile_counter);
  if ((err = (int)cudaGetLastError())) return err;
  // 3. segments
  const int n = B * V * (int)P;
  if (n > 0) {
    grad_fill_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        sc.pix_slot, sc.counts, sc.entries, n, (int)P, hw);
    if ((err = (int)cudaGetLastError())) return err;
  }
  // 4. ordered sums, every output row written once
  const size_t row_bytes = (size_t)C * sizeof(T);
  const bool vec = row_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(grad_acc) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    const size_t chunks = row_bytes / 16;
    if (chunks <= 8)
      return launch_grad_sum<T, Vec16<T>, 8>(grad_acc, sc, out, B, V, hw, C,
                                             stream);
    if (chunks <= 16)
      return launch_grad_sum<T, Vec16<T>, 16>(grad_acc, sc, out, B, V, hw, C,
                                              stream);
    return launch_grad_sum<T, Vec16<T>, 32>(grad_acc, sc, out, B, V, hw, C,
                                            stream);
  }
  return launch_grad_sum<T, Pair<T>, 32>(grad_acc, sc, out, B, V, hw, C,
                                         stream);
}

}  // namespace

// Bytes of scratch imvx_backproject_grad needs for these sizes.
extern "C" long long imvx_backproject_grad_scratch(int B, int V, int Hf,
                                                   int Wf, long long P) {
  return (long long)grad_layout(B, V, Hf, Wf, P).end;
}

// grad_acc (P, B, C) float32 or bfloat16, C even; points (B, P, 3) float32;
// proj (B, V, 3, 4) float32; valid_hw (B, 2) int32; grad_feats
// (B, V, Hf, Wf, C) in grad_acc's type receives the sums (every element is
// written); scratch holds imvx_backproject_grad_scratch(...) bytes, 16-byte
// aligned.  B * V * P and B * V * Hf * Wf must be below 2^31.  Returns the
// first CUDA error code of the memset and launches (0 on success).
extern "C" int imvx_backproject_grad(const void* grad_acc, int grad_bf16,
                                     const void* points, const void* proj,
                                     const void* valid_hw, void* grad_feats,
                                     void* scratch, int B, int V, int Hf,
                                     int Wf, int C, long long P,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grad_bf16)
    return launch_grad<__nv_bfloat16>(grad_acc, points, proj, valid_hw,
                                      grad_feats, scratch, B, V, Hf, Wf, C,
                                      P, s);
  return launch_grad<float>(grad_acc, points, proj, valid_hw, grad_feats,
                            scratch, B, V, Hf, Wf, C, P, s);
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
