// lsh_hash: LSH signatures, the sign bits of a projection on fixed planes.
//
// Replaces src/repro/kernels/lsh_hash.py::lsh_hash (the Pallas _kernel,
// lsh_hash.py:17-24, called at :36).
//
// Computes: x (R, W) f32, planes (T, bits, W) f32 -> ids (R, T) int32 with
//   bit i of ids[r, t] = (sum_w x[r, w] * planes[t, i, w]) > 0,
// packed little-endian (bit i has weight 2^i). A zero row projects to
// exactly 0 and gets id 0.
//
// What bounds it on the H100: at the step's shapes (R = B·H = 32 query rows,
// R = B·J = 160 inserted rows) latency: the launch and the trips to device
// memory; at R = B·N rows (an index rebuild, 2^23 rows at the smoke widths)
// it reads R·W·4 bytes and writes R·T·4, 1.21 GB in 0.36 ms at 3.35 TB/s,
// and does 2·R·W·T·bits f32 operations, 17.2 GFLOP in 0.26 ms at 67
// TFLOP/s: the two bounds are close, so the FMAs must run while the rows
// stream in.
//
// Design: the TPU kernel is one (R, W) x (W, T·bits) MXU product. Here the
// product is the kernel's own body, in plain f32 FMAs, w ascending: no
// tensor cores and no TF32, because the result is a sign and a rounder
// product would flip the bits of projections near 0 away from the
// reference's. The planes are cut into groups of whole tables of at most
// 32 planes. A warp hashes 8 rows a pass: each half-warp 4 of them (rows
// 2j and 2j + 1 of the pass go to the two halves), and lane i of a half
// holds planes i and i + 16 of the group in registers, so one broadcast
// 16-byte shared load of a row (two addresses a warp: two cycles of the
// shared-memory pipe) feeds eight FMAs. Two warp votes (`__ballot_sync`) a
// row pair give the pass's eight 32-bit sign words, and the pass's ids go
// out in one coalesced store (at T = 4 a lane an id). Each warp streams its
// own tiles of rows through its own ring of stages in shared memory, one
// `cp.async.bulk` a tile completing on the stage's mbarrier, and refills a
// stage once its lanes are past it (__syncwarp): no barrier spans warps.
// The planes go straight into registers, in flight with the first tile.
// The launch plan (lsh_hash.py::hash_plan) has two regimes:
//   small R (the step's hashes): a one-warp block a tile of 8 rows, so
//     R = 160 spreads over 20 SMs: one dependent trip, the FMAs, the store;
//   large R (a rebuild): two persistent blocks of 8 warps an SM, each warp
//     streaming 32-row tiles through 3 stages while its FMAs run.
// Only at W = 32 with one group of planes (instantiated apart) do a lane's
// planes stay in registers across tiles; other widths and more groups load
// them again per pass, 8 float4s at a time (correct, not tuned).
// W must be a multiple of 4 and bits at most 30; T is any.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kHalfRows = 4;          // rows a half-warp takes a pass
constexpr int kPassRows = 2 * kHalfRows;
constexpr int kMaxWarps = 8;
constexpr int kMaxStages = 4;
constexpr int kChunk = 8;             // float4s of each plane held at once
constexpr int kMaxBits = 30;          // ids stay positive int32
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90
constexpr int kDefaultSmem = 49152;   // bytes a block may use unasked
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// ---- mbarriers and bulk copies ----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned),
// completing on `bar`; the rows are read once, so they leave L2 first.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar,
                                          unsigned long long pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)),
         "l"(pol) : "memory");
}

// Lane i of each half: float4s c0 .. c0+7 of planes i and i + 16 of the
// group that starts at plane g0 and has G planes; zero past G or W.
__device__ __forceinline__ void load_planes(const float4* __restrict__ pl4,
                                            int g0, int G, int i, int c0,
                                            int W4, float4 (&p0)[kChunk],
                                            float4 (&p1)[kChunk]) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const bool in = c0 + u < W4;
    p0[u] = in && i < G ? __ldg(pl4 + (long long)(g0 + i) * W4 + c0 + u) : z;
    p1[u] = in && i + 16 < G
                ? __ldg(pl4 + (long long)(g0 + i + 16) * W4 + c0 + u)
                : z;
  }
}

__device__ __forceinline__ void fma4(float4 m, float4 p, float& a) {
  a = fmaf(m.x, p.x, a);
  a = fmaf(m.y, p.y, a);
  a = fmaf(m.z, p.z, a);
  a = fmaf(m.w, p.w, a);
}

// The stages each warp's ring holds: `stages`, or fewer when no warp of
// the launch has that many tiles.
__host__ __device__ __forceinline__ int ring_stages(int R, int tile,
                                                    int stages, int nw) {
  const int tiles = (R - 1) / tile + 1, most = (tiles - 1) / nw + 1;
  return stages < most ? stages : most;
}

// kW4: float4s a row, 8 (W = 32) or 0 (read from W at run time); kHold:
// one group of planes whose words fit a lane's registers (W = 32 and
// T·bits <= 32, the smoke's), held across tiles. Warp gw of the launch's
// nw takes tiles gw, gw + nw, ... of `tile` rows, each through its own
// ring of `alloc` stages with one mbarrier a stage; rows are unpadded (a
// shared load has two addresses, the halves' rows, and takes two cycles
// whatever their banks). Dynamic shared memory: the warps' rings, then
// their mbarriers.
template <int kW4, bool kHold>
__global__ void __launch_bounds__(kMaxWarps * 32, kHold ? 2 : 1)
lsh_hash_kernel(const float* __restrict__ x, const float* __restrict__ planes,
                int R, int W, int T, int bits, int tile, int stages,
                int* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int W4 = kW4 ? kW4 : W / 4, Wf = 4 * W4;
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, half = lane >> 4, i = lane & 15;
  const int tiles = (R - 1) / tile + 1;
  const int gw = blockIdx.x * warps + warp, nw = gridDim.x * warps;
  const int mine = (tiles - gw - 1) / nw + 1;     // nw <= tiles: 1 at least
  const int alloc = ring_stages(R, tile, stages, nw);
  float* ring =
      reinterpret_cast<float*>(smem) + (size_t)warp * alloc * tile * Wf;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + (size_t)warps * alloc * tile * Wf * sizeof(float)) + warp * alloc;
  const float4* pl4 = reinterpret_cast<const float4*>(planes);
  const int per_group = 32 / bits;                 // whole tables a group
  const int groups = kHold ? 1 : (T - 1) / per_group + 1;
  const unsigned id_mask = (1u << bits) - 1u;
  const unsigned long long pol = evict_first_policy();

  // This warp's tile k into stage k % alloc, by lane 0.
  auto issue = [&](int k) {
    if (lane == 0) {
      const long long r0 = ((long long)gw + (long long)k * nw) * tile;
      const unsigned bytes =
          (unsigned)min((long long)tile, R - r0) * Wf * sizeof(float);
      uint64_t* bar = full + k % alloc;
      mbar_expect_tx(bar, bytes);
      bulk_copy(ring + (size_t)(k % alloc) * tile * Wf, x + r0 * Wf, bytes,
                bar, pol);
    }
  };

  if (lane == 0) {
    for (int s = 0; s < alloc; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  for (int k = 0; k < min(alloc, mine); ++k) issue(k);
  float4 p0[kChunk], p1[kChunk];
  if (kHold) load_planes(pl4, 0, T * bits, i, 0, W4, p0, p1);

  for (int k = 0; k < mine; ++k) {
    mbar_wait(full + k % alloc, (k / alloc) & 1);
    const long long r0 = ((long long)gw + (long long)k * nw) * tile;
    const int rows = (int)min((long long)tile, R - r0);
    const float* tp = ring + (size_t)(k % alloc) * tile * Wf;
    for (int pr = 0; pr < rows; pr += kPassRows) {     // a pass: 8 rows
      const float* rp = tp + (pr + half) * Wf;
      for (int g = 0; g < groups; ++g) {
        const int t0 = g * per_group, nt = min(per_group, T - t0);
        const int G = nt * bits;
        float a0[kHalfRows], a1[kHalfRows];
#pragma unroll
        for (int j = 0; j < kHalfRows; ++j) a0[j] = a1[j] = 0.0f;
        for (int c0 = 0; c0 < W4; c0 += kChunk) {
          if (!kHold) load_planes(pl4, t0 * bits, G, i, c0, W4, p0, p1);
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            if (kW4 == 0 && c0 + u >= W4) break;
#pragma unroll
            for (int j = 0; j < kHalfRows; ++j) {
              const float4 m = *reinterpret_cast<const float4*>(
                  rp + 2 * j * Wf + 4 * (c0 + u));
              fma4(m, p0[u], a0[j]);
              fma4(m, p1[u], a1[j]);
            }
          }
        }
        // Row 2j + h's sign bits: the low half of each vote for h = 0,
        // the high half for h = 1 (planes 0-15, then 16-31).
        unsigned signs[kPassRows];
#pragma unroll
        for (int j = 0; j < kHalfRows; ++j) {
          const unsigned v0 = __ballot_sync(kFull, i < G && a0[j] > 0.0f);
          const unsigned v1 =
              __ballot_sync(kFull, i + 16 < G && a1[j] > 0.0f);
          signs[2 * j] = (v0 & 0xffffu) | (v1 << 16);
          signs[2 * j + 1] = (v0 >> 16) | (v1 & 0xffff0000u);
        }
        // The pass's 8·nt ids, value v = (row, table) a lane: at T = 4 one
        // coalesced 128-byte store.
        for (int v = lane; v < kPassRows * nt; v += 32) {
          const int r = nt == 4 ? v >> 2 : v / nt, t = v - r * nt;
          if (pr + r >= rows) break;
          unsigned sg = signs[0];
#pragma unroll
          for (int rr = 1; rr < kPassRows; ++rr)
            sg = r == rr ? signs[rr] : sg;
          out[(r0 + pr + r) * T + t0 + t] =
              (int)((sg >> (t * bits)) & id_mask);
        }
      }
    }
    __syncwarp();                                  // every lane is past it
    if (k + alloc < mine) issue(k + alloc);
  }
}

size_t smem_bytes(int R, int W, int tile, int stages, int warps, int nw) {
  const size_t alloc = ring_stages(R, tile, stages, nw);
  return (size_t)warps * alloc * (tile * W * sizeof(float) + sizeof(uint64_t));
}

// The dynamic shared-memory limit, raised once per device and
// instantiation, and only for a plan above 48 KB.
template <int kW4, bool kHold>
cudaError_t allow_smem(size_t smem) {
  static bool allowed[kMaxDevices] = {};
  if (smem <= (size_t)kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < kMaxDevices && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(lsh_hash_kernel<kW4, kHold>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess && dev >= 0 && dev < kMaxDevices) allowed[dev] = true;
  return err;
}

template <int kW4, bool kHold>
cudaError_t launch(const float* x, const float* planes, int R, int W, int T,
                   int bits, int* out, int tile, int stages, int warps,
                   int blocks, size_t smem, cudaStream_t s) {
  cudaError_t err = allow_smem<kW4, kHold>(smem);
  if (err != cudaSuccess) return err;
  lsh_hash_kernel<kW4, kHold><<<blocks, warps * 32, smem, s>>>(
      x, planes, R, W, T, bits, tile, stages, out);
  return cudaGetLastError();
}

}  // namespace

// The plan (lsh_hash.py::hash_plan): blocks of ``warps`` warps, each warp
// taking tiles of ``tile`` rows (a multiple of 8) through a ring of up to
// ``stages`` stages.
extern "C" int lsh_hash_launch(const float* x, const float* planes, int R,
                               int W, int T, int bits, int* out, int tile,
                               int stages, int warps, int blocks,
                               void* stream) {
  if (R < 1 || W < 4 || W % 4 != 0 || T < 1 || bits < 1 || bits > kMaxBits ||
      tile < kPassRows || tile % kPassRows != 0 || stages < 1 ||
      stages > kMaxStages || warps < 1 || warps > kMaxWarps || blocks < 1 ||
      (long long)blocks * warps > (R - 1) / tile + 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(R, W, tile, stages, warps, blocks * warps);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(W == 32 && T * bits <= 32
      ? launch<8, true>(x, planes, R, W, T, bits, out, tile, stages, warps,
                        blocks, smem, s)
      : launch<0, false>(x, planes, R, W, T, bits, out, tile, stages, warps,
                         blocks, smem, s));
}
