// 3x3x3 SAME stride-1 convolution, 64 -> 64 channels, channels-last volumes.
//
// Replaces the TPU kernel imvoxelnet_tpu/ops/conv3z_pallas.py
// (_kernel / _conv3z_pallas / conv3z_lanepack), which runs the KITTI neck's
// block0 convolutions: (B, nx, ny, nz, 64) x (3, 3, 3, 64, 64) with float32
// accumulation.  The Pallas kernel packs the three z taps into the matmul's
// output lanes to fill the TPU's 128-lane matrix unit; nothing on Hopper
// asks for that, so this kernel is an implicit GEMM with M = B*nx*ny*nz
// sites, N = 64 output channels and K = 27 taps x 64 input channels.
//
// Bound on an H100: operations.  2 * 27 * 64 * 64 flops per site (142 GFLOP
// per KITTI sample) against 256 bytes per site in bfloat16, so only the
// tensor cores reach the bound, and only if every input row is fetched from
// L2 a few times rather than 27 times.
//
// bfloat16 design (conv_wgmma_kernel):
//  * A block owns TX x TY columns of the (x, y) plane over the whole z
//    extent.  One TMA load brings the tile with a one-site halo into shared
//    memory as (TX+2)(TY+2)(nz+1) rows of 64 channels = 128 bytes, in the
//    128-byte swizzle; coordinates outside the volume (negative ones too)
//    arrive as zeros, which is the SAME padding, so the kernel has no border
//    code.  A column holds z = -1 .. nz-1; the z = nz neighbour of a column
//    is the z = -1 row of the next one, also zero.
//  * The rows are numbered linearly, and the output at row r is the sum over
//    taps of input row r + ((dx*(TY+2) + dy)*(nz+1) + dz) times that tap's
//    64 x 64 weights.  So each tap's site operand is the same buffer at a
//    row offset, handed to wgmma through a shared-memory descriptor: the
//    input is read from L2 about 1.5 times instead of 27.  Halo rows are
//    computed too and dropped at the store (1.19x the useful MMA work on
//    the KITTI volume's 2 x 18 tile).
//  * The product is computed transposed, out^T (64 channels x 256 rows) =
//    W_tap (64 x 64) x rows^T, with wgmma.m64n256k16: the sites are the
//    instruction's wide N.  At N = 64 (sites as M) every instruction reads
//    2 KB of each operand from shared memory for 32 cycles of tensor-core
//    work, which is shared memory's whole rate; at N = 256 it reads 10 KB
//    for 128 cycles.
//  * Two consumer warpgroups own 256 rows each (128 float32 sums per thread
//    in registers) and share the tap's weights, which a producer warp
//    streams by TMA through a ring of 8 KB stages guarded by mbarriers;
//    the wgmmas run asynchronously, one tap in flight while the next is
//    issued.
//  * The sums are rounded once to bfloat16, transposed back through the
//    (now free) input buffer and written 16 bytes a thread; rows of the halo
//    or outside the volume are masked.
//
// float32 runs on the same kernel and keeps float32's accuracy: x and w are
// each split into three bfloat16 parts that sum to the float32 value
// (split3_kernel for x, the wrapper for w), and the six products whose
// parts' indices sum to at most 4 are accumulated in float32, in three
// passes (x3*w1; x2*(w1, w2); x1*(w1, w2, w3)) that store, then add to, the
// float32 output.  The parts dropped are below 2^-32 of a product.  The
// tensor cores round their float32 sums toward zero, an error that grows
// with the number of additions at full magnitude, so within a pass the
// sets of weights run last to first: the small parts are added while the
// sums are small, and only the 108 steps of x1*w1 run at full size.  TF32
// (three products of high and low parts) was not taken: its 256-byte rows
// with separate high and low buffers leave room for 72-site tiles only, and
// each would stream 1.7 MB of weights.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;           // input and output channels
constexpr int kRowBytes = 128;   // one site's channels in bfloat16
constexpr int kStages = 4;       // weight ring
constexpr int kWBytes = kC * kRowBytes;   // one tap's weights
constexpr int kNWG = 2;          // consumer warpgroups
constexpr int kGroupRows = 256;  // rows (the wgmma's N) per warpgroup
constexpr int kThreadsTC = (kNWG + 1) * 128;

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major operand whose rows are 128
// bytes in the 128-byte swizzle: eight-row groups 1024 bytes apart.  The
// swizzle is a function of the address bits (the buffer is 1024-byte
// aligned), so a start address that is any whole number of rows, or of
// 32-byte K steps, into the buffer reads the rows the TMA wrote there, with
// the descriptor's base_offset field left 0.
__device__ __forceinline__ uint64_t mma_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;                    // leading offset: unused here
  d |= (uint64_t)(1024 >> 4) << 32;          // stride between 8-row groups
  d |= (uint64_t)1 << 62;                    // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 256 float32, in registers) += A (64 x 16 bf16) * B (16 x 256 bf16),
// both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"   // scale-d: add to the sums in d
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------ bfloat16 kernel

struct TileParams {
  int NX, NY, NZ;        // volume
  int TX, TY;            // columns of the (x, y) plane a block owns
  int tiles_x, tiles_y;  // blocks along x and y
  int n_groups;          // consumer warpgroups with rows to compute
  int halo_rows;         // (TX+2)(TY+2)(NZ+1): rows the TMA box writes
  int alloc_rows;        // rows of the buffer, zero beyond the box
  int n_taps;            // 27 per set of weights
};

// What the epilogue does with the sums.
enum OutMode { kStoreBf16 = 0, kStoreF32 = 1, kAddF32 = 2 };

template <int MODE>
__global__ void __launch_bounds__(kThreadsTC, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_w,
                  void* __restrict__ out_v, const TileParams p) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes of address
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int halo_bytes = p.halo_rows * kRowBytes;
  const int alloc_bytes = p.alloc_rows * kRowBytes;   // a multiple of 1024
  uint8_t* halo = smem;
  uint8_t* wring = halo + alloc_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(wring + kStages * kWBytes);
  const uint32_t bar_halo = smem_u32(bars);
  const uint32_t bar_full = smem_u32(bars + 1);            // kStages of them
  const uint32_t bar_empty = smem_u32(bars + 1 + kStages); // kStages of them

  const int tid = threadIdx.x;
  // rows past the box: read by taps of dropped rows, and the z = nz
  // neighbour of the last column, which must be zero
  for (int i = halo_bytes + tid * 16; i < alloc_bytes; i += kThreadsTC * 16)
    *reinterpret_cast<uint4*>(halo + i) = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    mbar_init(bar_halo, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kNWG * 4);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  int blk = blockIdx.x;
  const int ty_i = blk % p.tiles_y; blk /= p.tiles_y;
  const int tx_i = blk % p.tiles_x; blk /= p.tiles_x;
  const int b = blk;
  const int x0 = tx_i * p.TX, y0 = ty_i * p.TY;
  const int ZP = p.NZ + 1;
  const int cols = p.TY + 2;
  const int wg = tid >> 7;

  if (wg == kNWG) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kNWG * 128) {
      mbar_expect_tx(bar_halo, halo_bytes);
      tma_load_5d(smem_u32(halo), &tm_x, bar_halo, 0, -1, y0 - 1, x0 - 1, b);
      for (int tap = 0; tap < p.n_taps; ++tap) {
        const int s = tap % kStages;
        const uint32_t round = tap / kStages;
        mbar_wait(bar_empty + 8 * s, (round & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, kWBytes);
        // the sets of weights last to first: float32 passes add their
        // small parts while the sums are small
        const int set = p.n_taps / 27 - 1 - tap / 27;
        tma_load_2d(smem_u32(wring + s * kWBytes), &tm_w, bar_full + 8 * s, 0,
                    (set * 27 + tap % 27) * kC);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wtid = tid & 127;
    const int warp = wtid >> 5, lane = wtid & 31;
    const int r_first = (cols + 1) * ZP + 1;   // first row of the volume
    const int r_mine = r_first + wg * kGroupRows;
    const bool active = wg < p.n_groups;

    // sums of this warpgroup's 256 rows, transposed: thread (warp, lane)
    // holds output channels 16*warp + lane/4 (+8) of rows 8*j + 2*(lane%4)
    // (+1), j = 0..31
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    const uint32_t halo_addr = smem_u32(halo);
    const uint32_t wring_addr = smem_u32(wring);
    mbar_wait(bar_halo, 0);

    for (int tap = 0; tap < p.n_taps; ++tap) {
      const int s = tap % kStages;
      const uint32_t round = tap / kStages;
      const int t27 = tap % 27;   // the tap of this set of weights
      const int dx = t27 / 9 - 1, dy = (t27 / 3) % 3 - 1, dz = t27 % 3 - 1;
      const int off = (dx * cols + dy) * ZP + dz;
      mbar_wait(bar_full + 8 * s, round & 1);
      wgmma_fence();
      if (active) {
        const uint32_t rows_addr = halo_addr + (r_mine + off) * kRowBytes;
        const uint32_t w_addr = wring_addr + s * kWBytes;
#pragma unroll
        for (int k = 0; k < kC / 16; ++k)
          wgmma_m64n256k16(acc, mma_desc(w_addr + 32 * k),
                           mma_desc(rows_addr + 32 * k));
      }
      wgmma_commit();
      // the previous tap's products are done: its weight stage is free
      wgmma_wait<1>();
      if (tap > 0 && lane == 0)
        mbar_arrive(bar_empty + 8 * ((tap - 1) % kStages));
    }
    wgmma_wait<0>();

    // -------------------------------------------------------------- epilogue
    // Both warpgroups have read their last input row, so the input buffer
    // is free: each warpgroup transposes its sums back through 32 KB of it
    // (16-byte chunks XORed with the row, so that neither pass has bank
    // conflicts) and writes the rows that are sites 16 bytes a thread.
    named_barrier(1, kNWG * 128);
    if (active) {
      uint8_t* stage = halo + wg * kGroupRows * kRowBytes;
      const int xy_rows = cols * ZP;
      // rows of a pass, 16-byte chunks of an output row
      constexpr int kPassRows = MODE == kStoreBf16 ? kGroupRows : kGroupRows / 2;
      constexpr int kChunks = MODE == kStoreBf16 ? 8 : 16;
#pragma unroll
      for (int pass = 0; pass < kGroupRows / kPassRows; ++pass) {
        if (pass > 0) named_barrier(2 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < kPassRows / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = pass * (kPassRows / 8) + jj;
              const int rr = 8 * jj + 2 * (lane & 3) + e;
              const int co = 16 * warp + (lane >> 2) + 8 * h;
              const float v = acc[4 * j + 2 * h + e];
              if (MODE == kStoreBf16)
                *reinterpret_cast<__nv_bfloat16*>(
                    stage + rr * 128 + (((co >> 3) ^ (rr & 7)) << 4) +
                    (co & 7) * 2) = __float2bfloat16_rn(v);
              else
                *reinterpret_cast<float*>(
                    stage + rr * 256 + (((co >> 2) ^ (rr & 7)) << 4) +
                    (co & 3) * 4) = v;
            }
        named_barrier(2 + wg, 128);
#pragma unroll 4
        for (int i = 0; i < kPassRows * kChunks / 128; ++i) {
          const int idx = i * 128 + wtid;
          const int rr = idx / kChunks, ch = idx % kChunks;
          const int r = r_mine + pass * kPassRows + rr;
          const int xh = r / xy_rows;
          const int rem = r - xh * xy_rows;
          const int yh = rem / ZP;
          const int zh = rem - yh * ZP;
          const int gx = x0 + xh - 1, gy = y0 + yh - 1;
          if (xh >= 1 && xh <= p.TX && yh >= 1 && yh <= p.TY && zh >= 1 &&
              gx < p.NX && gy < p.NY) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                stage + rr * (16 * kChunks) + ((ch ^ (rr & 7)) << 4));
            const long long site =
                (((long long)b * p.NX + gx) * p.NY + gy) * p.NZ + (zh - 1);
            if (MODE == kStoreBf16) {
              *reinterpret_cast<uint4*>(
                  static_cast<__nv_bfloat16*>(out_v) + site * kC + ch * 8) = v;
            } else {
              float4* dst = reinterpret_cast<float4*>(
                  static_cast<float*>(out_v) + site * kC + ch * 4);
              float4 f = make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                                     __uint_as_float(v.z), __uint_as_float(v.w));
              if (MODE == kAddF32) {
                const float4 o = *dst;
                f = make_float4(o.x + f.x, o.y + f.y, o.z + f.z, o.w + f.w);
              }
              *dst = f;
            }
          }
        }
      }
    }
  }
}

// x (n float32 values, n a multiple of 4) as the sum of three bfloat16
// values: parts[0] the nearest bfloat16, parts[1] the nearest to what is
// left, parts[2] the nearest to what is left then (each difference is exact
// in float32, so the three carry 24 bits of x).
__global__ void split3_kernel(const float* __restrict__ x,
                              __nv_bfloat16* __restrict__ parts, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x * 4;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       i < n; i += stride) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    const float f[4] = {v.x, v.y, v.z, v.w};
    __nv_bfloat16 q[3][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float r = f[k];
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        q[part][k] = __float2bfloat16_rn(r);
        r = __fsub_rn(r, __bfloat162float(q[part][k]));
      }
    }
#pragma unroll
    for (int part = 0; part < 3; ++part)
      *reinterpret_cast<uint2*>(parts + part * n + i) =
          *reinterpret_cast<const uint2*>(q[part]);
  }
}

// cuTensorMapEncodeTiled, looked up in libcuda at run time so that this
// library links against the CUDA runtime only.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn) return fn;
  void* sym = nullptr;
  cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &status);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym,
                                            cudaEnableDefault, &status);
#endif
  if (err != cudaSuccess || status != cudaDriverEntryPointSuccess)
    return nullptr;
  fn = reinterpret_cast<EncodeTiledFn>(sym);
  return fn;
}

// Error codes of this file, clear of CUDA's own.
constexpr int kErrNoEncodeFn = 10001;
constexpr int kErrEncode = 10002;
constexpr int kErrTile = 10003;

// One pass of the tensor-core kernel: x (B, NX, NY, NZ, 64) bfloat16 against
// n_sets sets of packed weights (n_sets, 27, 64, 64) bfloat16, the sum over
// the sets stored or added as MODE says.
template <int MODE>
int launch_wgmma(const void* x, const void* w, int n_sets, void* out, int B,
                 int NX, int NY, int NZ, int TX, int TY,
                 cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (!encode) return kErrNoEncodeFn;

  TileParams p;
  p.NX = NX; p.NY = NY; p.NZ = NZ; p.TX = TX; p.TY = TY;
  p.tiles_x = (NX + TX - 1) / TX;
  p.tiles_y = (NY + TY - 1) / TY;
  const int ZP = NZ + 1, cols = TY + 2;
  const int n_rows = ((TX - 1) * cols + TY) * ZP - 1;
  p.n_groups = (n_rows + kGroupRows - 1) / kGroupRows;
  p.halo_rows = (TX + 2) * cols * ZP;
  const int r_first = (cols + 1) * ZP + 1;
  // the last tap of the last computed row (which also covers the
  // epilogue's staging), and the zero row after the box
  int alloc = 2 * r_first + kGroupRows * p.n_groups;
  if (alloc < p.halo_rows + 1) alloc = p.halo_rows + 1;
  p.alloc_rows = (alloc + 7) / 8 * 8;
  p.n_taps = 27 * n_sets;
  if (TX < 1 || TY < 1 || TX + 2 > 256 || cols > 256 || ZP > 256 ||
      p.n_groups > kNWG)
    return kErrTile;
  const size_t smem = 1024 + (size_t)p.alloc_rows * kRowBytes +
                      kStages * kWBytes +
                      (1 + 2 * kStages) * sizeof(uint64_t);
  if (smem > 232448) return kErrTile;

  CUtensorMap tm_x, tm_w;
  {
    const cuuint64_t dims[5] = {(cuuint64_t)kC, (cuuint64_t)NZ, (cuuint64_t)NY,
                                (cuuint64_t)NX, (cuuint64_t)B};
    const cuuint64_t strides[4] = {
        (cuuint64_t)kRowBytes, (cuuint64_t)NZ * kRowBytes,
        (cuuint64_t)NY * NZ * kRowBytes, (cuuint64_t)NX * NY * NZ * kRowBytes};
    const cuuint32_t box[5] = {(cuuint32_t)kC, (cuuint32_t)ZP,
                               (cuuint32_t)cols, (cuuint32_t)(TX + 2), 1};
    const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
    if (encode(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
               const_cast<void*>(x), dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return kErrEncode;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)kC, (cuuint64_t)27 * kC * n_sets};
    const cuuint64_t strides[1] = {(cuuint64_t)kRowBytes};
    const cuuint32_t box[2] = {(cuuint32_t)kC, (cuuint32_t)kC};
    const cuuint32_t estr[2] = {1, 1};
    if (encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
               const_cast<void*>(w), dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return kErrEncode;
  }

  cudaError_t err = cudaFuncSetAttribute(
      conv_wgmma_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * p.tiles_x * p.tiles_y;
  conv_wgmma_kernel<MODE><<<(unsigned)blocks, kThreadsTC, smem, stream>>>(
      tm_x, tm_w, out, p);
  return (int)cudaGetLastError();
}

// float32: x = x1 + x2 + x3 and w = w1 + w2 + w3 in bfloat16 parts, and the
// six products whose parts' indices sum to at most 4, smallest first.
int launch_f32(const void* x, const void* w_parts, void* out, void* x_parts,
               int B, int NX, int NY, int NZ, int TX, int TY,
               cudaStream_t stream) {
  const long long n = (long long)B * NX * NY * NZ * kC;
  long long blocks = (n / 4 + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  split3_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat16*>(x_parts), n);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x_parts);
  err = launch_wgmma<kStoreF32>(xp + 2 * n, w_parts, 1, out, B, NX, NY, NZ,
                                TX, TY, stream);
  if (err) return err;
  err = launch_wgmma<kAddF32>(xp + n, w_parts, 2, out, B, NX, NY, NZ, TX, TY,
                              stream);
  if (err) return err;
  return launch_wgmma<kAddF32>(xp, w_parts, 3, out, B, NX, NY, NZ, TX, TY,
                               stream);
}

}  // namespace

// x (B, NX, NY, NZ, 64) and out (B, NX, NY, NZ, 64) channels-last, both
// bfloat16 or both float32.  TX, TY: the block's tile of the (x, y) plane
// (the wrapper's tiling plan picks it).
//   bfloat16: w packed as (27, 64, 64) = (tap = (dx*3 + dy)*3 + dz, co, ci)
//     bfloat16; x_parts unused.
//   float32: w the three bfloat16 parts of the packed weights,
//     (3, 27, 64, 64); x_parts scratch for the three bfloat16 parts of x,
//     3 * x.numel() values.
// Returns 0, a CUDA error code, or one of the 1000x codes above.
extern "C" int imvx_conv3x3x3(const void* x, const void* w, void* out,
                              void* x_parts, int is_bf16, int B, int NX,
                              int NY, int NZ, int TX, int TY, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_wgmma<kStoreBf16>(x, w, 1, out, B, NX, NY, NZ, TX, TY, s);
  return launch_f32(x, w, out, x_parts, B, NX, NY, NZ, TX, TY, s);
}
