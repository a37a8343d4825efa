// Rotated-rectangle intersection area by a sort-free Sutherland-Hodgman clip,
// the NMS dominance mask built on it, and the greedy scan over that mask.
//
// Replaces the TPU kernel imvoxelnet_tpu/ops/iou_pallas.py
// (_clip_kernel / _pallas_area_flat / rect_intersection_area_pallas): clip
// rect1 against the four edges of rect2, keeping the polygon in 8 slots and
// compacting the emitted vertices after every edge, then take the area by
// the shoelace formula.
//
// One __device__ clip (clip_area) serves four entry points:
//   imvx_rect_clip           paired:   (n,4,2) x (n,4,2)     -> (n,)
//   imvx_rect_clip_pairwise  pairwise: (G,N,4,2) x (G,M,4,2) -> (G,N,M)
//   imvx_nms_mask            pairwise on one box set, with the IoU, the
//                            threshold and i < j fused, one bit per pair
//   imvx_nms_over            pairwise on one box set, the IoU and the
//                            threshold fused, one bit per ordered pair, the
//                            pairs that cannot overlap not clipped
// imvx_rect_clip_grad is the paired entry's backward (the vector-Jacobian
// product of the clip, for the IoU-3D training loss) in two passes: a light
// one over every pair that writes zeros and lists the pairs with an area
// gradient, then the clip and its reverse sweep over those alone.
// imvx_nms_rank gathers imvx_nms_over's bits into each group's rank order
// (the exact NMS: one box set a sample serves every class).
// imvx_nms_scan walks a mask in rank order (the greedy NMS itself; the JAX package runs
// that step as a lax.while_loop fixpoint, not as a kernel).
//
// Design of the clip: the polygon lives in registers.  Every loop over
// slots and edges is fully unrolled, so every array below is indexed by
// compile-time constants only; inactive slots are predicated, not skipped,
// so the lanes of a warp run one instruction stream.  Compaction is an
// unrolled select: the running position of each of the 16 candidates (8
// vertices, 8 edge crossings, in emission order) is compared with each
// packed slot it can reach.  ptxas must report 0 bytes of stack frame and 0
// bytes of spills for every kernel of this file.
//
// Design of the pairwise kernels: a block of 4 warps owns a tile of 4 rows
// (rect1, one per warp) by 32 columns (rect2, one per lane).  It stages the
// tile's 36 boxes (32 bytes each) in shared memory once; a thread reads its
// own column, prepares the four clip edges, and clips its warp's row against
// them.  Device memory is read 32 bytes per box instead of 64 bytes per pair,
// and the output, 4 bytes per pair or 1 bit per pair, is the only per-pair
// traffic.  The mask kernel packs 32 columns into a word by a warp ballot
// and skips words that lie wholly on or below the diagonal.
//
// Bound on an H100: operations.  A pair costs some 2,400 instructions
// (about half of them the selects of the compaction) against 36 bytes per
// 128 pairs; at the KITTI NMS size (8 x 100 x 100 pairs) the launch is most
// of the time.
//
// Numerics: the areas are bit-identical to the plain PyTorch version
// (ops/iou.py:rect_intersection_area_plain) and to the JAX reference
// (imvoxelnet_tpu/ops/iou.py:_rect_intersection_area_jnp).  Every operation
// is rounded on its own (explicit __f*_rn intrinsics, -fmad=false), in the
// same order: the rect2 center is ((c0 + c1) + c2) + c3) * 0.25 and the
// shoelace sum runs over the slots in order.  The plain version packs by a
// masked sum, which turns -0.0 into +0.0 where the select keeps the sign; a
// zero's sign never reaches the area, whose last step is an absolute value.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kSlots = 8;
constexpr int kWarps = 4;            // rows of a pairwise tile, one per warp
constexpr int kCols = 32;            // columns of a pairwise tile, one per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }

// The four edges of rect2: start point, direction, and the sign that puts
// rect2's center on the non-negative side whatever the winding order.
struct Edges {
  float ax[4], ay[4], abx[4], aby[4], sign[4];
};

__device__ __forceinline__ void make_edges(const float (&bx)[4],
                                           const float (&by)[4], Edges& ed) {
  const float cx2 = fmul(fadd(fadd(fadd(bx[0], bx[1]), bx[2]), bx[3]), 0.25f);
  const float cy2 = fmul(fadd(fadd(fadd(by[0], by[1]), by[2]), by[3]), 0.25f);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ed.ax[e] = bx[e];
    ed.ay[e] = by[e];
    ed.abx[e] = fsub(bx[(e + 1) % 4], bx[e]);
    ed.aby[e] = fsub(by[(e + 1) % 4], by[e]);
    const float ref = fsub(fmul(ed.abx[e], fsub(cy2, by[e])),
                           fmul(ed.aby[e], fsub(cx2, bx[e])));
    ed.sign[e] = ref >= 0.f ? 1.f : -1.f;
  }
}

// Append (x, y) at packed position `pos` if `valid`.  `last` is the highest
// slot this candidate can reach (its index in emission order); positions
// beyond the 8th slot are dropped while `pos` goes on counting, as the
// reference's fixed 8 rows do.
__device__ __forceinline__ void put(float (&ox)[kSlots], float (&oy)[kSlots],
                                    int& pos, int last, bool valid, float x,
                                    float y) {
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (j <= last) {
      const bool here = valid && pos == j;
      ox[j] = here ? x : ox[j];
      oy[j] = here ? y : oy[j];
    }
  }
  pos += valid ? 1 : 0;
}

// One step of the clip: the polygon (vx, vy, count) against the edge from
// (ax, ay) along (abx, aby), `sign` putting rect2 on its non-negative side.
__device__ __forceinline__ void clip_stage(float (&vx)[kSlots],
                                           float (&vy)[kSlots], int& count,
                                           float ax, float ay, float abx,
                                           float aby, float sign) {
  float s[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    s[k] = fmul(fsub(fmul(abx, fsub(vy[k], ay)), fmul(aby, fsub(vx[k], ax))),
                sign);
  float ox[kSlots], oy[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) ox[j] = oy[j] = 0.f;
  int pos = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int nk = (k + 1) % kSlots;
    const bool active = k < count;
    // the vertex after the last active one is vertex 0
    const bool take_next = k + 1 < count;
    const float nvx = take_next ? vx[nk] : vx[0];
    const float nvy = take_next ? vy[nk] : vy[0];
    const float s_nxt = take_next ? s[nk] : s[0];
    const bool in_cur = s[k] >= 0.f;
    const bool in_nxt = s_nxt >= 0.f;
    const bool emit_int = active && (in_cur != in_nxt);
    put(ox, oy, pos, 2 * k, active && in_cur, vx[k], vy[k]);
    float ix = 0.f, iy = 0.f;
    if (emit_int) {
      const float denom = fsub(s[k], s_nxt);
      const float t = __fdiv_rn(s[k], fabsf(denom) > 1e-12f ? denom : 1.f);
      ix = fadd(vx[k], fmul(t, fsub(nvx, vx[k])));
      iy = fadd(vy[k], fmul(t, fsub(nvy, vy[k])));
    }
    put(ox, oy, pos, 2 * k + 1, emit_int, ix, iy);
  }
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    vx[j] = ox[j];
    vy[j] = oy[j];
  }
  count = pos;                         // kept as emitted, also beyond 8
}

__device__ __forceinline__ void init_polygon(const float (&px)[4],
                                             const float (&py)[4],
                                             float (&vx)[kSlots],
                                             float (&vy)[kSlots], int& count) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    vx[k] = k < 4 ? px[k % 4] : 0.f;
    vy[k] = k < 4 ? py[k % 4] : 0.f;
  }
  count = 4;
}

// Twice the signed area by the shoelace formula over all 8 slots; inactive
// slots repeat the first vertex.
__device__ __forceinline__ float shoelace(const float (&vx)[kSlots],
                                          const float (&vy)[kSlots],
                                          int count) {
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
  return sum;
}

// Area of rect1 (corners px, py) clipped by the edges of rect2.
__device__ __forceinline__ float clip_area(const float (&px)[4],
                                           const float (&py)[4],
                                           const Edges& ed) {
  float vx[kSlots], vy[kSlots];
  int count;
  init_polygon(px, py, vx, vy, count);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    clip_stage(vx, vy, count, ed.ax[e], ed.ay[e], ed.abx[e], ed.aby[e],
               ed.sign[e]);
  const float area = fmul(0.5f, fabsf(shoelace(vx, vy, count)));
  return count > 2 ? area : 0.f;
}

// ---------------------------------------------------------------- paired

__global__ void __launch_bounds__(128)
rect_clip_kernel(const float* __restrict__ c1, const float* __restrict__ c2,
                 float* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float px[4], py[4], bx[4], by[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    px[k] = c1[i * 8 + 2 * k];
    py[k] = c1[i * 8 + 2 * k + 1];
    bx[k] = c2[i * 8 + 2 * k];
    by[k] = c2[i * 8 + 2 * k + 1];
  }
  Edges ed;
  make_edges(bx, by, ed);
  out[i] = clip_area(px, py, ed);
}

// --------------------------------------------------------- paired backward
//
// The vector-Jacobian product of the paired clip, as reverse-mode autodiff
// of the plain version computes it (ops/iou.py:rect_intersection_area_plain;
// the JAX package: jax.vjp of _rect_intersection_area_jnp,
// imvoxelnet_tpu/ops/iou.py:206-274).  One thread per live pair (one
// whose area gradient is not 0) runs the forward clip, keeping each edge's input polygon, then sweeps back through the
// operations that forward took: the shoelace and |.| (whose derivative at 0
// is 0), then for edges 3..0 the compaction (an emitted slot's adjoint goes
// back to its one source, a vertex or a crossing), the crossing
// ix = vx + t (nvx - vx), t = s / where(|denom| > 1e-12, denom, 1) and
// s = (abx (vy - ay) - aby (vx - ax)) sign.  rect2's corners get their
// gradient through ax, ay, abx and aby; the sign and rect2's centre carry
// none (a `where` is differentiated through its taken branch only).  A pair
// whose area gradient is 0, or whose clipped polygon has 2 vertices or
// fewer, gets exact zeros.  The branch decisions are the forward's, so the
// result differs from autograd of the plain version only in the order of
// the sums.
//
// Bound on an H100: bytes.  A pair reads its 4 B area gradient and writes
// 64 B; only a pair with a nonzero gradient reads its 64 B of corners and
// runs the clip and the sweep (and costs 8 B of the live list, written and
// read once).  In the IoU-3D loss only the positives have one (the loss
// weight is centerness x positive): in a SUN RGB-D step about 1% of the
// pairs.  So the live pairs are not left where they lie: a thread of the
// sweep holds ~200 registers (2 blocks of 128 an SM), and a grid of one
// thread a pair made every dead pair pay a dependent load and 16 scalar
// stores at the sweep's occupancy, ~28 waves at 934,400 pairs.  Instead a
// light pass at full occupancy reads the gradients coalesced, writes the
// zeros as 16 B stores and compacts the live indices (one ballot and one
// atomicAdd a warp); the sweep then runs on a fixed grid of resident blocks
// over the list, its length read on the device.

// The adjoint held by packed slot `pos` if `valid` (0 otherwise); `last` is
// the highest slot the candidate can reach, as in put().
__device__ __forceinline__ void take(const float (&gx)[kSlots],
                                     const float (&gy)[kSlots], int& pos,
                                     int last, bool valid, float& x,
                                     float& y) {
  x = 0.f;
  y = 0.f;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (j <= last) {
      const bool here = valid && pos == j;
      x = here ? gx[j] : x;
      y = here ? gy[j] : y;
    }
  }
  pos += valid ? 1 : 0;
}

// Add `g` to slot `k + 1` of `a` if `take_next`, else to slot 0 (where the
// forward read the next vertex).
__device__ __forceinline__ void add_next(float (&a)[kSlots], int k,
                                         bool take_next, float g) {
  const int nk = (k + 1) % kSlots;
  a[nk] = fadd(a[nk], take_next ? g : 0.f);
  a[0] = fadd(a[0], take_next ? 0.f : g);
}

// Reverse of clip_stage: (gx, gy) holds the adjoint of the stage's output
// slots on entry and that of its input polygon (vx, vy, count) on return;
// the edge's adjoints are added to gax, gay, gabx, gaby.
__device__ __forceinline__ void clip_stage_grad(
    const float (&vx)[kSlots], const float (&vy)[kSlots], int count,
    float ax, float ay, float abx, float aby, float sign,
    float (&gx)[kSlots], float (&gy)[kSlots], float& gax, float& gay,
    float& gabx, float& gaby) {
  float s[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    s[k] = fmul(fsub(fmul(abx, fsub(vy[k], ay)), fmul(aby, fsub(vx[k], ax))),
                sign);
  float hx[kSlots], hy[kSlots], hs[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) hx[k] = hy[k] = hs[k] = 0.f;
  int pos = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int nk = (k + 1) % kSlots;
    const bool active = k < count;
    const bool take_next = k + 1 < count;
    const float nvx = take_next ? vx[nk] : vx[0];
    const float nvy = take_next ? vy[nk] : vy[0];
    const float s_nxt = take_next ? s[nk] : s[0];
    const bool in_cur = s[k] >= 0.f;
    const bool in_nxt = s_nxt >= 0.f;
    const bool emit_int = active && (in_cur != in_nxt);
    float gcx, gcy, gix, giy;
    take(gx, gy, pos, 2 * k, active && in_cur, gcx, gcy);
    take(gx, gy, pos, 2 * k + 1, emit_int, gix, giy);
    hx[k] = fadd(hx[k], gcx);
    hy[k] = fadd(hy[k], gcy);
    if (emit_int) {
      const float denom = fsub(s[k], s_nxt);
      const bool big = fabsf(denom) > 1e-12f;
      const float q = big ? denom : 1.f;
      const float t = __fdiv_rn(s[k], q);
      // ix = vx + t * (nvx - vx)
      const float gdx = fmul(gix, t), gdy = fmul(giy, t);
      const float gt = fadd(fmul(gix, fsub(nvx, vx[k])),
                            fmul(giy, fsub(nvy, vy[k])));
      hx[k] = fsub(fadd(hx[k], gix), gdx);
      hy[k] = fsub(fadd(hy[k], giy), gdy);
      add_next(hx, k, take_next, gdx);
      add_next(hy, k, take_next, gdy);
      // t = s / q, q = denom where |denom| > 1e-12 (else the constant 1)
      const float gq = big ? -fmul(gt, __fdiv_rn(t, q)) : 0.f;
      // denom = s - s_nxt
      hs[k] = fadd(hs[k], fadd(__fdiv_rn(gt, q), gq));
      add_next(hs, k, take_next, -gq);
    }
  }
  // s = (abx (vy - ay) - aby (vx - ax)) sign
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const float gu = fmul(hs[k], sign);
    const float gvy = fmul(gu, abx), gvx = fmul(gu, aby);
    gabx = fadd(gabx, fmul(gu, fsub(vy[k], ay)));
    gaby = fsub(gaby, fmul(gu, fsub(vx[k], ax)));
    gay = fsub(gay, gvy);
    gax = fadd(gax, gvx);
    gx[k] = fsub(hx[k], gvx);
    gy[k] = fadd(hy[k], gvy);
  }
}

// Reverse of the shoelace: the adjoint (gx, gy) of the final polygon for an
// area gradient g, given count > 2 (the area is 0.5 |sum|).
__device__ __forceinline__ void shoelace_grad(const float (&vx)[kSlots],
                                              const float (&vy)[kSlots],
                                              int count, float sum, float g,
                                              float (&gx)[kSlots],
                                              float (&gy)[kSlots]) {
  const float sgn = sum > 0.f ? 1.f : (sum < 0.f ? -1.f : 0.f);
  const float gs = fmul(fmul(g, 0.5f), sgn);
  float cx[kSlots], cy[kSlots], hx[kSlots], hy[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    cx[k] = k < count ? vx[k] : vx[0];
    cy[k] = k < count ? vy[k] : vy[0];
    hx[k] = hy[k] = 0.f;
  }
  // term k = cx[k] cy[k+1] - cy[k] cx[k+1]
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int nk = (k + 1) % kSlots;
    hx[k] = fadd(hx[k], fmul(gs, cy[nk]));
    hy[nk] = fadd(hy[nk], fmul(gs, cx[k]));
    hy[k] = fsub(hy[k], fmul(gs, cx[nk]));
    hx[nk] = fsub(hx[nk], fmul(gs, cy[k]));
  }
  // inactive slots read vertex 0
#pragma unroll
  for (int k = 0; k < kSlots; ++k) gx[k] = gy[k] = 0.f;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const bool active = k < count;
    gx[k] = fadd(gx[k], active ? hx[k] : 0.f);
    gy[k] = fadd(gy[k], active ? hy[k] : 0.f);
    gx[0] = fadd(gx[0], active ? 0.f : hx[k]);
    gy[0] = fadd(gy[0], active ? 0.f : hy[k]);
  }
}

// Pair i's corners: rect1 (px, py) from c1, rect2 (bx, by) from c2.
__device__ __forceinline__ void load_corners(const float* __restrict__ c1,
                                             const float* __restrict__ c2,
                                             long long i, float (&px)[4],
                                             float (&py)[4], float (&bx)[4],
                                             float (&by)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    px[k] = c1[i * 8 + 2 * k];
    py[k] = c1[i * 8 + 2 * k + 1];
    bx[k] = c2[i * 8 + 2 * k];
    by[k] = c2[i * 8 + 2 * k + 1];
  }
}

// The gradients of a pair, (gx, gy) for rect1 (px, py) and (gbx, gby) for
// rect2 (bx, by), for its area gradient g: the forward clip keeping each
// edge's input polygon, then the shoelace's adjoint and each edge's adjoint
// from the last to the first.  The four edges' input polygons stay in
// registers from the forward (4 clip stages; ptxas on sm_90a: ~200
// registers, no stack frame, no spills).  Recomputing edge e's input from
// rect1 for each e instead (10 stages) took 128 registers and ran 27% slower
// at 934,400 pairs with 80% of them carrying a gradient on an H100, so it
// was not kept.
__device__ __forceinline__ void pair_grad(const float (&px)[4],
                                          const float (&py)[4],
                                          const float (&bx)[4],
                                          const float (&by)[4], float g,
                                          float (&gx)[kSlots],
                                          float (&gy)[kSlots], float (&gbx)[4],
                                          float (&gby)[4]) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) gx[k] = gy[k] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) gbx[k] = gby[k] = 0.f;
  Edges ed;
  make_edges(bx, by, ed);
  float kx[4][kSlots], ky[4][kSlots];
  int kc[4];
  float vx[kSlots], vy[kSlots];
  int count;
  init_polygon(px, py, vx, vy, count);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      kx[e][k] = vx[k];
      ky[e][k] = vy[k];
    }
    kc[e] = count;
    clip_stage(vx, vy, count, ed.ax[e], ed.ay[e], ed.abx[e], ed.aby[e],
               ed.sign[e]);
  }
  if (count <= 2) return;
  shoelace_grad(vx, vy, count, shoelace(vx, vy, count), g, gx, gy);
#pragma unroll
  for (int e = 3; e >= 0; --e) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      vx[k] = kx[e][k];
      vy[k] = ky[e][k];
    }
    count = kc[e];
    float gax = 0.f, gay = 0.f, gabx = 0.f, gaby = 0.f;
    clip_stage_grad(vx, vy, count, ed.ax[e], ed.ay[e], ed.abx[e], ed.aby[e],
                    ed.sign[e], gx, gy, gax, gay, gabx, gaby);
    // ax = b[e], abx = b[e + 1] - b[e]
    const int ne = (e + 1) % 4;
    gbx[e] = fsub(fadd(gbx[e], gax), gabx);
    gby[e] = fsub(fadd(gby[e], gay), gaby);
    gbx[ne] = fadd(gbx[ne], gabx);
    gby[ne] = fadd(gby[ne], gaby);
  }
}

// Pass 1 of 2, over every pair: a warp takes 32 consecutive pairs, reads
// their area gradients (128 B), appends the indices of those whose gradient
// is not 0 (NaN included) to `live` with one ballot and one atomicAdd on
// `n_live`, and writes the 32 pairs' zeros into both gradients, 16 B a lane
// (each store instruction covers 512 contiguous bytes).  Few registers, full
// occupancy, a grid-stride loop over the warps.  The order of `live`
// follows the atomics; each live pair is computed alone in pass 2, so the
// result does not depend on it.
constexpr int kZeroThreads = 256;
__global__ void __launch_bounds__(kZeroThreads)
rect_clip_grad_zero_kernel(const float* __restrict__ grad_areas,
                           float4* __restrict__ g1, float4* __restrict__ g2,
                           int* __restrict__ live, int* __restrict__ n_live,
                           long long n) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kZeroThreads;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long base = (blockIdx.x * (long long)kZeroThreads + threadIdx.x)
                        - lane;
       base < n; base += stride) {              // uniform over the warp
    const long long i = base + lane;
    const bool is_live = i < n && grad_areas[i] != 0.f;
    const unsigned ballot = __ballot_sync(kFull, is_live);
    int first = 0;
    if (lane == 0 && ballot) first = atomicAdd(n_live, __popc(ballot));
    first = __shfl_sync(kFull, first, 0);
    if (is_live)
      live[first + __popc(ballot & ((1u << lane) - 1u))] = (int)i;
    // the 32 pairs' 64 float4s of each gradient
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long f = 2 * base + 32 * h + lane;
      if (f < 2 * n) {
        g1[f] = zero;
        g2[f] = zero;
      }
    }
  }
}

// Pass 2 of 2, over the live pairs alone: a fixed grid of resident blocks
// loops up to the count that pass 1 left on the device (no host read), and
// writes each live pair's 64 B after pass 1's zeros.  Measured against it
// on an H100 (tools/compare_clip_grad.py, a training step's inputs): a
// ceil(n / 128) grid whose blocks past the count exit at once ran as fast,
// and 0.005 ms slower with no live pair; warps taking 32 list entries at a
// time from a second counter ran 5-13% slower.
constexpr int kSweepThreads = 128;
__global__ void __launch_bounds__(kSweepThreads)
rect_clip_grad_sweep_kernel(const float* __restrict__ c1,
                            const float* __restrict__ c2,
                            const float* __restrict__ grad_areas,
                            const int* __restrict__ live,
                            const int* __restrict__ n_live,
                            float4* __restrict__ g1, float4* __restrict__ g2) {
  const int count = *n_live;
  for (int j = blockIdx.x * kSweepThreads + threadIdx.x; j < count;
       j += gridDim.x * kSweepThreads) {
    const long long i = live[j];
    float px[4], py[4], bx[4], by[4], gx[kSlots], gy[kSlots], gbx[4], gby[4];
    load_corners(c1, c2, i, px, py, bx, by);
    pair_grad(px, py, bx, by, grad_areas[i], gx, gy, gbx, gby);
    g1[2 * i] = make_float4(gx[0], gy[0], gx[1], gy[1]);
    g1[2 * i + 1] = make_float4(gx[2], gy[2], gx[3], gy[3]);
    g2[2 * i] = make_float4(gbx[0], gby[0], gbx[1], gby[1]);
    g2[2 * i + 1] = make_float4(gbx[2], gby[2], gbx[3], gby[3]);
  }
}

// `blocks`: how many blocks of `kernel` at `threads` a block the current
// device holds at once, found once per device.
constexpr int kMaxDevices = 64;
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, int (&cache)[kMaxDevices],
                            int& blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, threads, 0)) != cudaSuccess)
      return err;
    if (per_sm == 0) return cudaErrorLaunchOutOfResources;
    cache[dev] = sms * per_sm;
  }
  blocks = cache[dev];
  return cudaSuccess;
}

// -------------------------------------------------------------- pairwise

// A tile's boxes in shared memory: rows as they come (a warp reads one row,
// all lanes the same word), columns component-major (lane j reads word j).
struct Tile {
  float rows[kWarps][8];
  float cols[8][kCols];
};

// Stage rows i0.. of `c1` (n1 boxes) and columns j0.. of `c2` (n2 boxes);
// boxes beyond the end are zeros, whose clip is an area of 0.
__device__ __forceinline__ void stage(Tile& t, const float* __restrict__ c1,
                                      int i0, int n1,
                                      const float* __restrict__ c2, int j0,
                                      int n2) {
  const int tid = threadIdx.y * kCols + threadIdx.x;
  for (int f = tid; f < kCols * 8; f += kWarps * kCols) {
    const int j = j0 + (f >> 3);
    t.cols[f & 7][f >> 3] = j < n2 ? c2[(long long)j0 * 8 + f] : 0.f;
  }
  if (tid < kWarps * 8) {
    const int i = i0 + (tid >> 3);
    t.rows[tid >> 3][tid & 7] = i < n1 ? c1[(long long)i0 * 8 + tid] : 0.f;
  }
  __syncthreads();
}

__device__ __forceinline__ void load_pair(const Tile& t, float (&px)[4],
                                          float (&py)[4], Edges& ed) {
  float bx[4], by[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    px[k] = t.rows[threadIdx.y][2 * k];
    py[k] = t.rows[threadIdx.y][2 * k + 1];
    bx[k] = t.cols[2 * k][threadIdx.x];
    by[k] = t.cols[2 * k + 1][threadIdx.x];
  }
  make_edges(bx, by, ed);
}

// grid (ceil(M / 32), ceil(N / 4), G), block (32, 4)
__global__ void __launch_bounds__(kWarps * kCols)
pairwise_area_kernel(const float* __restrict__ c1, const float* __restrict__ c2,
                     float* __restrict__ out, int n, int m) {
  __shared__ Tile t;
  const long long g = blockIdx.z;
  const int i0 = blockIdx.y * kWarps, j0 = blockIdx.x * kCols;
  stage(t, c1 + g * n * 8, i0, n, c2 + g * m * 8, j0, m);
  const int i = i0 + threadIdx.y, j = j0 + threadIdx.x;
  if (i >= n || j >= m) return;
  float px[4], py[4];
  Edges ed;
  load_pair(t, px, py, ed);
  out[(g * n + i) * m + j] = clip_area(px, py, ed);
}

// Bit j of word (g, i, j / 32) says that box i, if kept, suppresses box j:
// i < j and inter / max(a_i + a_j - inter, 1e-8) > thr, the divide IEEE.
// grid (ceil(N / 32), ceil(N / 4), G), block (32, 4)
__global__ void __launch_bounds__(kWarps * kCols)
nms_mask_kernel(const float* __restrict__ corners,
                const float* __restrict__ box_area, float thr,
                uint32_t* __restrict__ mask, int n) {
  __shared__ Tile t;
  const long long g = blockIdx.z;
  const int i0 = blockIdx.y * kWarps, j0 = blockIdx.x * kCols;
  if (j0 + kCols - 1 <= i0) {
    // every word of this tile lies on or below the diagonal
    const int i = i0 + threadIdx.y;
    if (threadIdx.x == 0 && i < n)
      mask[(g * n + i) * gridDim.x + blockIdx.x] = 0u;
    return;
  }
  stage(t, corners + g * n * 8, i0, n, corners + g * n * 8, j0, n);
  const int i = i0 + threadIdx.y, j = j0 + threadIdx.x;
  if (i >= n) return;                               // the whole warp
  float px[4], py[4];
  Edges ed;
  load_pair(t, px, py, ed);
  bool dominates = false;
  if (j0 + kCols - 1 > i) {                         // the whole warp
    const float inter = clip_area(px, py, ed);
    const float a1 = box_area[g * n + i];
    const float a2 = j < n ? box_area[g * n + j] : 0.f;
    const float uni = fmaxf(fsub(fadd(a1, a2), inter), 1e-8f);
    dominates = j < n && i < j && __fdiv_rn(inter, uni) > thr;
  }
  const unsigned word = __ballot_sync(kFull, dominates);
  if (threadIdx.x == 0) mask[(g * n + i) * gridDim.x + blockIdx.x] = word;
}

// ------------------------------------------------- exact NMS: over-threshold
//
// Bit b % 32 of word (s, a, b / 32) says that boxes a and b of sample s
// overlap above the threshold: inter(a, b) / max(area_a + area_b - inter,
// 1e-8) > thr, inter(a, b) being box a clipped by box b's edges, for every
// ordered pair (both triangles: the rank gather below reads either, and the
// clip is not symmetric bit for bit).  The bits equal those of
// ops/iou.py:rotated_iou_bev(bev, bev) > thr, the clamp propagating NaN as
// PyTorch's does.
//
// Bound on an H100: operations, the clip's.  The pairs whose clip cannot
// leave anything are known before clipping: where the two boxes lie apart
// by more than a margin, every vertex the clip computes lies within
// rounding of the true polygon, so the last edge emits nothing and the clip
// returns exactly 0.  Such a pair takes inter = 0 without a clip.  Apart
// means: the circles around the boxes' corners are, or the corners of one
// box project beyond the other's along the normal of its edge 0 or 1 (a
// separating axis).  The argument needs box b's edges to bound it: its
// corners must turn one way at angles of 30-150 degrees (|cross| >= |e1|
// |e2| / 2) with edges longer than the margin, and both boxes' corners must
// be finite; every other pair is clipped.  The margin, 2^-10 of the boxes'
// extent (|centre| + radius), is some 300 times the rounding error that
// the clip's 4 stages can gather (about 50 ulp of the extent).
//
// A block owns 32 rows by 128 columns (4 words a row).  It stages the rows'
// corners and the columns' edges (make_edges once per column, for 32 rows),
// each box's circle, axes and area in shared memory.  Pass 1: a warp takes
// 32 columns of one row, writes the far pairs' bits by a ballot and appends
// the near pairs to a list in shared memory.  Pass 2: all threads clip the
// listed pairs, full warps whatever the near pairs' pattern, and OR their
// bits into the tile's words.  The words go out at the end.
constexpr int kOverRows = 32;
constexpr int kOverCols = 128;
constexpr int kOverWords = kOverCols / 32;
constexpr int kOverThreads = 256;
constexpr float kFarMargin = 1.f / 1024.f;

// What pass 1 knows of a box: its circle (centre, radius, extent), the
// normals of its edges 0 and 1 with their lengths and the extent of its
// corners along each, and whether the far test may take it.
struct Facts {
  float cx, cy, r, ext;
  float ux[2], uy[2], lo[2], hi[2], len[2];
  bool ok;
};

// The same, one array per field, for the columns (lane j reads word j).
struct ColFacts {
  float cx[kOverCols], cy[kOverCols], r[kOverCols], ext[kOverCols];
  float ux[2][kOverCols], uy[2][kOverCols], lo[2][kOverCols],
      hi[2][kOverCols], len[2][kOverCols];
  bool ok[kOverCols];
};

struct OverTile {
  float rows[kOverRows][8];
  Facts row_facts[kOverRows];
  float row_area[kOverRows];
  float edge[20][kOverCols];                     // ax, ay, abx, aby, sign
  ColFacts col;
  float col_area[kOverCols];
  uint32_t bits[kOverRows][kOverWords];
  uint16_t near[kOverRows * kOverCols];          // row << 7 | column
  int n_near;
};

__device__ __forceinline__ void box_facts(const float (&x)[4],
                                          const float (&y)[4], Facts& f) {
  f.cx = fmul(fadd(fadd(fadd(x[0], x[1]), x[2]), x[3]), 0.25f);
  f.cy = fmul(fadd(fadd(fadd(y[0], y[1]), y[2]), y[3]), 0.25f);
  float r2 = 0.f;
  bool finite = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float dx = fsub(x[k], f.cx), dy = fsub(y[k], f.cy);
    r2 = fmaxf(r2, fadd(fmul(dx, dx), fmul(dy, dy)));
    finite = finite && isfinite(x[k]) && isfinite(y[k]);
  }
  f.r = sqrtf(r2);
  f.ext = fadd(fmaxf(fabsf(f.cx), fabsf(f.cy)), f.r);
  f.ok = finite;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    f.ux[e] = fsub(y[e], y[e + 1]);
    f.uy[e] = fsub(x[e + 1], x[e]);
    f.len[e] = sqrtf(fadd(fmul(f.ux[e], f.ux[e]), fmul(f.uy[e], f.uy[e])));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float p = fadd(fmul(f.ux[e], x[k]), fmul(f.uy[e], y[k]));
      f.lo[e] = k == 0 ? p : fminf(f.lo[e], p);
      f.hi[e] = k == 0 ? p : fmaxf(f.hi[e], p);
    }
  }
}

// Whether box b's edges bound it well enough for the far test (above).
__device__ __forceinline__ bool edges_bound(const Edges& ed, float extent) {
  const float lim = fmul(kFarMargin, fadd(extent, 1.f));
  bool ok = true;
  float turn = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int ne = (e + 1) % 4;
    const float l0 = fadd(fmul(ed.abx[e], ed.abx[e]),
                          fmul(ed.aby[e], ed.aby[e]));
    const float l1 = fadd(fmul(ed.abx[ne], ed.abx[ne]),
                          fmul(ed.aby[ne], ed.aby[ne]));
    const float cross = fsub(fmul(ed.abx[e], ed.aby[ne]),
                             fmul(ed.aby[e], ed.abx[ne]));
    turn = e == 0 ? cross : turn;
    ok = ok && l0 > fmul(lim, lim) && fmul(cross, turn) > 0.f &&
         fmul(cross, cross) >= fmul(0.25f, fmul(l0, l1));
  }
  return ok;
}

// Whether corners (x, y) project beyond [lo, hi] along the normal (ux, uy)
// of length len by more than marg.
__device__ __forceinline__ bool beyond(float ux, float uy, float lo, float hi,
                                       float len, const float (&x)[4],
                                       const float (&y)[4], float marg) {
  float mn = 0.f, mx = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float p = fadd(fmul(ux, x[k]), fmul(uy, y[k]));
    mn = k == 0 ? p : fminf(mn, p);
    mx = k == 0 ? p : fmaxf(mx, p);
  }
  return fmaxf(fsub(mn, hi), fsub(lo, mx)) > fmul(marg, len);
}

// inter / max(a1 + a2 - inter, 1e-8) > thr, a NaN union kept (torch.clamp)
__device__ __forceinline__ bool over_thr(float inter, float a1, float a2,
                                         float thr) {
  const float uni = fsub(fadd(a1, a2), inter);
  return __fdiv_rn(inter, uni != uni ? uni : fmaxf(uni, 1e-8f)) > thr;
}

// grid (ceil(N / 128), ceil(N / 32), S), block (256)
__global__ void __launch_bounds__(kOverThreads)
nms_over_kernel(const float* __restrict__ corners,
                const float* __restrict__ box_area, float thr,
                uint32_t* __restrict__ over, int n, int n_words) {
  __shared__ OverTile t;
  const long long s = blockIdx.z;
  const int i0 = blockIdx.y * kOverRows, j0 = blockIdx.x * kOverCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  corners += s * n * 8;
  box_area += s * n;
  if (tid < kOverCols) {
    const int j = j0 + tid;
    float bx[4], by[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      bx[k] = j < n ? corners[(long long)j * 8 + 2 * k] : 0.f;
      by[k] = j < n ? corners[(long long)j * 8 + 2 * k + 1] : 0.f;
    }
    Edges ed;
    make_edges(bx, by, ed);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      t.edge[e][tid] = ed.ax[e];
      t.edge[4 + e][tid] = ed.ay[e];
      t.edge[8 + e][tid] = ed.abx[e];
      t.edge[12 + e][tid] = ed.aby[e];
      t.edge[16 + e][tid] = ed.sign[e];
    }
    Facts f;
    box_facts(bx, by, f);
    t.col.cx[tid] = f.cx;
    t.col.cy[tid] = f.cy;
    t.col.r[tid] = f.r;
    t.col.ext[tid] = f.ext;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      t.col.ux[e][tid] = f.ux[e];
      t.col.uy[e][tid] = f.uy[e];
      t.col.lo[e][tid] = f.lo[e];
      t.col.hi[e][tid] = f.hi[e];
      t.col.len[e][tid] = f.len[e];
    }
    t.col.ok[tid] = f.ok && edges_bound(ed, f.ext);
    t.col_area[tid] = j < n ? box_area[j] : 0.f;
  } else if (tid < kOverCols + kOverRows) {
    const int r = tid - kOverCols, i = i0 + r;
    float px[4], py[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      px[k] = i < n ? corners[(long long)i * 8 + 2 * k] : 0.f;
      py[k] = i < n ? corners[(long long)i * 8 + 2 * k + 1] : 0.f;
      t.rows[r][2 * k] = px[k];
      t.rows[r][2 * k + 1] = py[k];
    }
    box_facts(px, py, t.row_facts[r]);
    t.row_area[r] = i < n ? box_area[i] : 0.f;
  }
  if (tid == 0) t.n_near = 0;
  __syncthreads();

  // pass 1: the far pairs' bits, the near pairs listed
  for (int u = warp; u < kOverRows * kOverWords; u += kOverThreads / 32) {
    const int r = u / kOverWords, q = u % kOverWords;
    const int c = q * 32 + lane;
    const bool pair = i0 + r < n && j0 + c < n;
    const Facts& a = t.row_facts[r];
    const bool ok = a.ok && t.col.ok[c];
    const float marg = fmul(kFarMargin, fadd(fadd(a.ext, t.col.ext[c]), 1.f));
    const float dx = fsub(a.cx, t.col.cx[c]), dy = fsub(a.cy, t.col.cy[c]);
    const float reach = fadd(fadd(a.r, t.col.r[c]), marg);
    bool far = ok && fadd(fmul(dx, dx), fmul(dy, dy)) > fmul(reach, reach);
    if (__any_sync(kFull, pair && ok && !far)) {
      float px[4], py[4], bx[4], by[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        px[k] = t.rows[r][2 * k];
        py[k] = t.rows[r][2 * k + 1];
        bx[k] = t.edge[k][c];
        by[k] = t.edge[4 + k][c];
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
        far = far || (ok && (beyond(a.ux[e], a.uy[e], a.lo[e], a.hi[e],
                                    a.len[e], bx, by, marg) ||
                             beyond(t.col.ux[e][c], t.col.uy[e][c],
                                    t.col.lo[e][c], t.col.hi[e][c],
                                    t.col.len[e][c], px, py, marg)));
    }
    const bool near = pair && !far;
    const unsigned word = __ballot_sync(
        kFull, pair && far && over_thr(0.f, t.row_area[r], t.col_area[c], thr));
    const unsigned listed = __ballot_sync(kFull, near);
    int first = 0;
    if (lane == 0) {
      t.bits[r][q] = word;
      if (listed) first = atomicAdd(&t.n_near, __popc(listed));
    }
    first = __shfl_sync(kFull, first, 0);
    if (near)
      t.near[first + __popc(listed & ((1u << lane) - 1u))] =
          (uint16_t)(r << 7 | c);
  }
  __syncthreads();

  // pass 2: the listed pairs clipped
  const int n_near = t.n_near;
  for (int f = tid; f < n_near; f += kOverThreads) {
    const int r = t.near[f] >> 7, c = t.near[f] & (kOverCols - 1);
    float px[4], py[4];
    Edges ed;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      px[k] = t.rows[r][2 * k];
      py[k] = t.rows[r][2 * k + 1];
      ed.ax[k] = t.edge[k][c];
      ed.ay[k] = t.edge[4 + k][c];
      ed.abx[k] = t.edge[8 + k][c];
      ed.aby[k] = t.edge[12 + k][c];
      ed.sign[k] = t.edge[16 + k][c];
    }
    if (over_thr(clip_area(px, py, ed), t.row_area[r], t.col_area[c], thr))
      atomicOr(&t.bits[r][c >> 5], 1u << (c & 31));
  }
  __syncthreads();

  if (tid < kOverRows * kOverWords) {
    const int r = tid / kOverWords, q = tid % kOverWords;
    const int i = i0 + r, w = blockIdx.x * kOverWords + q;
    if (i < n && w < n_words)
      over[(s * n + i) * n_words + w] = t.bits[r][q];
  }
}

// ------------------------------------------------- exact NMS: rank gather
//
// Bit j % 32 of word (g, i, j / 32) says that the group's candidate of rank
// i, if kept, suppresses that of rank j: i < j and bit order[j] of row
// order[i] of the group's over-threshold matrix src[g].  A block owns a
// group and 32 rows: it holds the group's order and the 32 source rows
// (W words each, read coalesced) in shared memory.  A warp takes 4 rows by
// 32 words: for each word, a lane reads its column's rank from shared
// memory once and its bit from each of the 4 rows, a ballot makes the
// word, and lane k keeps word k, so each row's 32 words go out as one
// 128-byte store.  Words wholly on or below the diagonal are 0 without a
// lookup.  Bound on an H100: bytes, 4 B a word written (the scan reads
// them) against W words a row read from L2.
constexpr int kRankRows = 32;
constexpr int kRankRowsPerWarp = 4;
constexpr int kRankThreads = 256;

// grid (ceil(N / 32), G), block (256), dynamic shared memory
// (N + 32 * W) words
__global__ void __launch_bounds__(kRankThreads)
nms_rank_kernel(const uint32_t* __restrict__ over,
                const long long* __restrict__ order,
                const long long* __restrict__ src,
                uint32_t* __restrict__ mask, int n, int n_words) {
  extern __shared__ uint32_t shared_words[];
  int* rank = reinterpret_cast<int*>(shared_words);           // (N,)
  uint32_t* rows = shared_words + n;                            // (32, W)
  const long long g = blockIdx.y;
  const int i0 = blockIdx.x * kRankRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  order += g * n;
  for (int j = tid; j < n; j += kRankThreads) rank[j] = (int)order[j];
  __syncthreads();
  over += src[g] * n * n_words;
  for (int f = tid; f < kRankRows * n_words; f += kRankThreads) {
    const int r = f / n_words, i = i0 + r;
    rows[f] = i < n ? over[(long long)rank[i] * n_words + f % n_words] : 0u;
  }
  __syncthreads();

  const int n_chunks = (n_words + 31) / 32;
  const int n_units = kRankRows / kRankRowsPerWarp * n_chunks;
  for (int u = warp; u < n_units; u += kRankThreads / 32) {
    const int r0 = u / n_chunks * kRankRowsPerWarp, w0 = u % n_chunks * 32;
    uint32_t mine[kRankRowsPerWarp] = {};
    for (int k = 0; k < 32 && w0 + k < n_words; ++k) {
      const int w = w0 + k;
      // a word wholly on or below the first row's diagonal is so for all 4
      if (w * 32 + 31 <= i0 + r0) continue;
      const int j = w * 32 + lane;
      const int o = j < n ? rank[j] : 0;
#pragma unroll
      for (int q = 0; q < kRankRowsPerWarp; ++q) {
        const int i = i0 + r0 + q;
        const bool bit = j < n && i < j &&
                         (rows[(r0 + q) * n_words + (o >> 5)] >> (o & 31)) & 1u;
        const unsigned word = __ballot_sync(kFull, bit);
        mine[q] = lane == k ? word : mine[q];
      }
    }
#pragma unroll
    for (int q = 0; q < kRankRowsPerWarp; ++q) {
      const int i = i0 + r0 + q;
      if (i < n && w0 + lane < n_words)
        mask[(g * n + i) * n_words + w0 + lane] = mine[q];
    }
  }
}

// ------------------------------------------------------------ greedy scan

// One warp per group walks the rows of its mask in rank order; a row that
// is still kept ORs its words into the removed set.  Rows come 32 at a time
// through shared memory (only the words from the diagonal on), so device
// memory latency is paid once per 32 rows.  Within such a chunk the chunk's
// own word of the removed set is a register every lane updates alike, and
// every later word has one owner lane.
// grid (G), block (32), dynamic shared memory (W + 32 * W) words
__global__ void __launch_bounds__(32)
nms_scan_kernel(const uint32_t* __restrict__ mask,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int n, int n_words) {
  extern __shared__ uint32_t shared_words[];
  uint32_t* removed = shared_words;                 // (W,)
  uint32_t* rows = shared_words + n_words;          // (32, W)
  const int lane = threadIdx.x;
  const long long g = blockIdx.x;
  mask += g * n * n_words;
  valid += g * n;
  keep += g * n;

  // entries that are not valid, and the bits beyond n, start as removed
  for (int w = 0; w < n_words; ++w) {
    const int j = w * 32 + lane;
    const unsigned ok = __ballot_sync(kFull, j < n && valid[j] != 0);
    if (lane == 0) removed[w] = ~ok;
  }
  __syncwarp();

  for (int c = 0; c < n_words; ++c) {
    const int n_rows = min(32, n - c * 32);
    const int span = n_words - c;
    for (int f = lane; f < n_rows * span; f += 32) {
      const int b = f / span, w = c + f % span;
      rows[b * n_words + w] = mask[(long long)(c * 32 + b) * n_words + w];
    }
    __syncwarp();
    uint32_t cur = removed[c];
    for (int b = 0; b < n_rows; ++b) {
      if (!((cur >> b) & 1u)) {
        cur |= rows[b * n_words + c];
        for (int w = c + 1 + lane; w < n_words; w += 32)
          removed[w] |= rows[b * n_words + w];
      }
    }
    const int j = c * 32 + lane;
    if (j < n) keep[j] = ((cur >> lane) & 1u) ? 0 : 1;
    __syncwarp();
  }
}

}  // namespace

// Every function returns the CUDA error code of its launch (0 on success)
// and launches nothing for an empty problem.

// corners1, corners2: (n, 4, 2) float32; areas: (n,) float32.
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

// corners1, corners2: (n, 4, 2) float32; grad_areas: (n,) float32;
// grad1, grad2: (n, 4, 2) float32, 16-byte aligned, the gradients of
// sum(grad_areas * areas); scratch: n + 1 int32 (the live count, then the
// live list).  n must be below 2^31.  One memset of the count, then the two
// passes; returns the first CUDA error code (0 on success).
extern "C" int imvx_rect_clip_grad(const void* corners1, const void* corners2,
                                   const void* grad_areas, void* grad1,
                                   void* grad2, void* scratch, long long n,
                                   void* stream) {
  if (n <= 0) return 0;
  if (n >= (1LL << 31) || reinterpret_cast<uintptr_t>(grad1) % 16 ||
      reinterpret_cast<uintptr_t>(grad2) % 16)
    return (int)cudaErrorInvalidValue;
  static int zero_cache[kMaxDevices], sweep_cache[kMaxDevices];
  int zero_grid = 0, sweep_grid = 0;
  int err = (int)resident_blocks(rect_clip_grad_zero_kernel, kZeroThreads,
                                 zero_cache, zero_grid);
  if (!err)
    err = (int)resident_blocks(rect_clip_grad_sweep_kernel, kSweepThreads,
                               sweep_cache, sweep_grid);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* n_live = static_cast<int*>(scratch);
  int* live = n_live + 1;
  if ((err = (int)cudaMemsetAsync(n_live, 0, sizeof(int), s))) return err;
  const long long zero_blocks = (n + kZeroThreads - 1) / kZeroThreads;
  rect_clip_grad_zero_kernel<<<(unsigned)std::min<long long>(zero_blocks,
                                                             zero_grid),
                               kZeroThreads, 0, s>>>(
      static_cast<const float*>(grad_areas), static_cast<float4*>(grad1),
      static_cast<float4*>(grad2), live, n_live, n);
  if ((err = (int)cudaGetLastError())) return err;
  const long long sweep_blocks = (n + kSweepThreads - 1) / kSweepThreads;
  rect_clip_grad_sweep_kernel<<<(unsigned)std::min<long long>(sweep_blocks,
                                                              sweep_grid),
                                kSweepThreads, 0, s>>>(
      static_cast<const float*>(corners1), static_cast<const float*>(corners2),
      static_cast<const float*>(grad_areas), live, n_live,
      static_cast<float4*>(grad1), static_cast<float4*>(grad2));
  return (int)cudaGetLastError();
}

// corners1: (G, N, 4, 2), corners2: (G, M, 4, 2) float32; areas: (G, N, M).
extern "C" int imvx_rect_clip_pairwise(const void* corners1,
                                       const void* corners2, void* areas,
                                       int g, int n, int m, void* stream) {
  if (g <= 0 || n <= 0 || m <= 0) return 0;
  const dim3 grid((m + kCols - 1) / kCols, (n + kWarps - 1) / kWarps, g);
  pairwise_area_kernel<<<grid, dim3(kCols, kWarps), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(corners1), static_cast<const float*>(corners2),
      static_cast<float*>(areas), n, m);
  return (int)cudaGetLastError();
}

// corners: (G, N, 4, 2), box_areas: (G, N) float32; mask: (G, N, ceil(N/32))
// 32-bit words.
extern "C" int imvx_nms_mask(const void* corners, const void* box_areas,
                             float thr, void* mask, int g, int n,
                             void* stream) {
  if (g <= 0 || n <= 0) return 0;
  const dim3 grid((n + kCols - 1) / kCols, (n + kWarps - 1) / kWarps, g);
  nms_mask_kernel<<<grid, dim3(kCols, kWarps), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(corners), static_cast<const float*>(box_areas),
      thr, static_cast<uint32_t*>(mask), n);
  return (int)cudaGetLastError();
}

// corners: (S, N, 4, 2), box_areas: (S, N) float32; over: (S, N, ceil(N/32))
// 32-bit words.
extern "C" int imvx_nms_over(const void* corners, const void* box_areas,
                             float thr, void* over, int s, int n,
                             void* stream) {
  if (s <= 0 || n <= 0) return 0;
  const int n_words = (n + 31) / 32;
  const dim3 grid((n + kOverCols - 1) / kOverCols,
                  (n + kOverRows - 1) / kOverRows, s);
  nms_over_kernel<<<grid, kOverThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(corners), static_cast<const float*>(box_areas),
      thr, static_cast<uint32_t*>(over), n, n_words);
  return (int)cudaGetLastError();
}

// over: (S, N, ceil(N/32)) words; order: (G, N) int64, each row a
// permutation of 0..N-1; src: (G,) int64 in 0..S-1; mask: (G, N, ceil(N/32))
// words.
extern "C" int imvx_nms_rank(const void* over, const void* order,
                             const void* src, void* mask, int g, int n,
                             void* stream) {
  if (g <= 0 || n <= 0) return 0;
  const int n_words = (n + 31) / 32;
  const size_t shared = (size_t)(n + kRankRows * n_words) * sizeof(uint32_t);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + kRankRows - 1) / kRankRows, g);
  nms_rank_kernel<<<grid, kRankThreads, shared,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(over), static_cast<const long long*>(order),
      static_cast<const long long*>(src), static_cast<uint32_t*>(mask), n,
      n_words);
  return (int)cudaGetLastError();
}

// mask: (G, N, ceil(N/32)) words; valid, keep: (G, N) bytes, in rank order.
extern "C" int imvx_nms_scan(const void* mask, const void* valid, void* keep,
                             int g, int n, void* stream) {
  if (g <= 0 || n <= 0) return 0;
  const int n_words = (n + 31) / 32;
  const size_t shared = (size_t)33 * n_words * sizeof(uint32_t);
  nms_scan_kernel<<<g, 32, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mask), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), n, n_words);
  return (int)cudaGetLastError();
}
