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
// R = B·J = 160 inserted rows) launch latency; at R = B·N rows (a full
// index build, 2^23 rows at the smoke widths) it reads R·W·4 bytes and
// writes R·T·4, 1.21 GB in 0.36 ms at 3.35 TB/s, and does 2·R·W·T·bits f32
// operations, 17.2 GFLOP in 0.26 ms at 67 TFLOP/s: the two bounds are
// close.
//
// Design: the TPU kernel is one (R, W) x (W, T·bits) MXU product. Here the
// product is the kernel's own body, in plain f32 FMAs: no tensor cores and
// no TF32, because the result is a sign and a rounder product would flip
// the bits of projections near 0 away from the reference's. Each 256-thread
// block stages a 64-row tile of x and all the planes with coalesced
// 16-byte loads into shared memory (rows padded to W+4 floats, so the
// 16-byte reads of 32 different planes are free of bank conflicts). A
// warp takes 8 rows and a lane one plane: the lane holds 32 words of its
// plane in registers and reads the rows' words as broadcasts, so one
// shared-memory load feeds four FMAs of every lane. Each sum adds w in
// ascending order. A warp vote (`__ballot_sync`) gathers the 32 sign bits,
// and the lanes of the tables in this group of planes write their ids. A
// first version, one thread per row looping over every plane, took 27 µs
// per launch at the step's shapes and 2.66 ms at R = 2^23; this one 7.7
// µs and 1.34 ms, 3.7 times the byte bound there (PERF.md).
// W must be a multiple of 4 and bits at most 30.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kTileRows = kWarps * kRowsPerWarp;   // 64
constexpr int kChunk = 8;             // float4s of a plane held in registers
constexpr int kMaxBits = 30;          // ids stay positive int32
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90

size_t smem_bytes(int T, int bits, int W) {
  return sizeof(float) * ((size_t)kTileRows + (size_t)T * bits) * (W + 4);
}

// Copies n rows of W4 float4s from src (rows contiguous) to dst (rows of
// pitch P floats), 8 loads in flight per thread.
__device__ __forceinline__ void stage(const float4* __restrict__ src, int n,
                                      int W4, int P, float* dst) {
  const int t = threadIdx.x, nf = n * W4;
  for (int e0 = 0; e0 < nf; e0 += 8 * kThreads) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads + t;
      if (e < nf) v[u] = __ldg(src + e);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads + t;
      if (e < nf) {
        const int r = e / W4;
        *reinterpret_cast<float4*>(dst + r * P + 4 * (e - r * W4)) = v[u];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
lsh_hash_kernel(const float* __restrict__ x, const float* __restrict__ planes,
                int R, int W, int T, int bits, int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int P = W + 4;                             // row pitch, floats
  const int W4 = W / 4;
  float* tile = reinterpret_cast<float*>(smem4);   // kTileRows x P
  float* pl = tile + kTileRows * P;                // T*bits x P
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = (long long)blockIdx.x * kTileRows;
  const int rows = (int)min((long long)kTileRows, R - r0);

  stage(reinterpret_cast<const float4*>(planes), T * bits, W4, P, pl);
  stage(reinterpret_cast<const float4*>(x) + r0 * W4, rows, W4, P, tile);
  __syncthreads();

  // Whole tables per group of at most 32 planes, one plane per lane.
  const int per_group = 32 / bits;
  const unsigned id_mask = (1u << bits) - 1u;
  for (int t0 = 0; t0 < T; t0 += per_group) {
    const int nt = min(per_group, T - t0);
    const bool active = lane < nt * bits;
    const float4* pr4 = reinterpret_cast<const float4*>(
        pl + (t0 * bits + (active ? lane : 0)) * P);
    float acc[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) acc[rr] = 0.0f;
    for (int c = 0; c < W4; c += kChunk) {
      float4 p[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
        p[u] = c + u < W4 ? pr4[c + u] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4* xr = reinterpret_cast<const float4*>(
            tile + (warp * kRowsPerWarp + rr) * P);
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (c + u < W4) {
            const float4 m = xr[c + u];
            acc[rr] = fmaf(m.x, p[u].x, acc[rr]);
            acc[rr] = fmaf(m.y, p[u].y, acc[rr]);
            acc[rr] = fmaf(m.z, p[u].z, acc[rr]);
            acc[rr] = fmaf(m.w, p[u].w, acc[rr]);
          }
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;      // the same in every lane
      if (r >= rows) break;
      const unsigned signs = __ballot_sync(0xffffffffu,
                                           active && acc[rr] > 0.0f);
      if (lane < nt)
        out[(r0 + r) * T + t0 + lane] =
            (int)((signs >> (lane * bits)) & id_mask);
    }
  }
}

}  // namespace

extern "C" int lsh_hash_launch(const float* x, const float* planes, int R,
                               int W, int T, int bits, int* out,
                               void* stream) {
  if (R < 1 || W < 4 || W % 4 != 0 || T < 1 || bits < 1 || bits > kMaxBits)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T, bits, W);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lsh_hash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((R - 1) / kTileRows + 1);
  lsh_hash_kernel<<<blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      x, planes, R, W, T, bits, out);
  return (int)cudaGetLastError();
}
