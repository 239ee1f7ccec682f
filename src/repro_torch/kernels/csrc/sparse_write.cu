// sparse_write_update: the fused SAM write, in place, on f32, bf16 or int8
// memory rows.
//
// Replaces src/repro/kernels/sparse_write.py::sparse_write_update: the
// _kernel of sparse_write.py:68-87 (pallas_call at :221) on f32 and bf16
// rows, and the int8 _kernel_q of sparse_write.py:90-122 (pallas_call at
// :201), each called with the memory, the usage table (and the scales)
// aliased in and out.
//
// Computes, for each batch row b and each of the J = H·(K+1) write
// columns j (head j / (K+1)):
//   mem[b, lra_idx]    = 0                              (erase, eq. 6)
//   mem[b, write_idx] += write_w · a                    (eqs. 3/5)
//   la[b, row]         = max(la[b, row], step[b])  where a column with
//                                                   w_j > delta hits row
// mem (B, N+1, W) and la (B, N+1) int32 are updated in place. Per row
// dtype, with the plain versions' rounding (kernels/ref.py):
//   f32:  acc = acc + w_j·a, multiply and add rounded apart;
//   bf16: acc = bf16(acc + bf16(w_j·a)), the JAX oracle's bf16 scatter-add;
//   int8: acc = (erased ? 0 : float(q)·s), then acc = fma(w_j, a, acc) per
//         column (what _kernel_q computes as XLA compiles it), then one
//         re-quantization: s' = max|acc|·fl(1/127), q' = rint(acc / s')
//         clipped to ±127 (s' = 0 for a zero row, which writes q' = 0).
//
// What bounds it on the H100: launch latency. It touches J rows per batch
// row (J·W·2 bytes of bf16 or J·(W + 4) bytes of int8 rows and scales,
// read and written, a few KB at B = 8, J = 20, W = 32), independent of N.
//
// Design: one 32-thread block per (column u, b). Only the first column
// naming a row owns it (the TPU wrapper's first_occurrence,
// sparse_write.py:182-186); a later duplicate returns without writing, so
// the TPU kernel's parked lanes (sparse_write.py:98-100, 118-119) have no
// counterpart here. The owner starts from the row's old value, or zero
// when the row is an LRA row, and adds every matching column in j order,
// with no atomics, so the result is deterministic. The int8 owner keeps its
// f32 row in shared memory, takes max|row| with warp shuffles (a max is
// exact in any order) and writes codes and scale once. Precondition (as
// for the TPU kernel): every lra_idx row also appears in write_idx — only
// written rows are erased. Rows outside [0, N) are ignored, so row N, the
// write-scratch row, is never touched. bf16 rows are raw 16-bit patterns
// (rows.cuh).
#include <cuda_runtime.h>
#include <cstdint>

#include "rows.cuh"

namespace {

constexpr int kThreads = 32;

struct WriteF32 {
  using T = float;
  static __device__ float load(T v) { return v; }
  static __device__ float add(float acc, float w, float a) {
    return __fadd_rn(acc, __fmul_rn(w, a));
  }
  static __device__ T store(float acc) { return acc; }
};

struct WriteBF16 {
  using T = uint16_t;
  static __device__ float load(T v) { return bf16_to_f32(v); }
  static __device__ float add(float acc, float w, float a) {
    const float p = bf16_to_f32(f32_to_bf16(__fmul_rn(w, a)));
    return bf16_to_f32(f32_to_bf16(__fadd_rn(acc, p)));
  }
  static __device__ T store(float acc) { return f32_to_bf16(acc); }
};

// Whether this block owns its row (first column naming it, row in
// [0, N)); *row is the row.
__device__ __forceinline__ bool owner(const int* wi, int u, int n_rows,
                                      int* row) {
  *row = wi[u];
  if (*row < 0 || *row >= n_rows) return false;
  for (int j = 0; j < u; ++j)
    if (wi[j] == *row) return false;          // an earlier column owns it
  return true;
}

__device__ __forceinline__ bool erased(const int* lra, int b, int H,
                                       int row) {
  bool e = false;
  for (int h = 0; h < H; ++h) e |= lra[(long long)b * H + h] == row;
  return e;
}

__device__ __forceinline__ void stamp(int* la, long long la_stride,
                                      const int* wi, const float* wb, int J,
                                      int b, int row, const int* step,
                                      float delta) {
  bool touched = false;
  for (int j = 0; j < J; ++j) touched |= (wi[j] == row) && (wb[j] > delta);
  if (touched) {
    int* cell = la + (long long)b * la_stride + row;
    *cell = max(*cell, step[b]);
  }
}

template <class R>
__global__ void __launch_bounds__(kThreads)
sparse_write_kernel(typename R::T* __restrict__ mem, int* __restrict__ la,
                    const int* __restrict__ widx,
                    const float* __restrict__ ww,
                    const float* __restrict__ a,
                    const int* __restrict__ lra,
                    const int* __restrict__ step, int n_rows,
                    long long mem_stride, long long la_stride, int J, int H,
                    int kp1, int W, float delta) {
  const int u = blockIdx.x, b = blockIdx.y;
  const int* wi = widx + (long long)b * J;
  const float* wb = ww + (long long)b * J;
  int row;
  if (!owner(wi, u, n_rows, &row)) return;
  const bool erase = erased(lra, b, H, row);
  typename R::T* mrow = mem + (long long)b * mem_stride + (long long)row * W;
  const float* ab = a + (long long)b * H * W;
  for (int w = threadIdx.x; w < W; w += kThreads) {
    float acc = erase ? 0.0f : R::load(mrow[w]);
    for (int j = 0; j < J; ++j)
      if (wi[j] == row) acc = R::add(acc, wb[j], ab[(j / kp1) * W + w]);
    mrow[w] = R::store(acc);
  }
  if (threadIdx.x == 0) stamp(la, la_stride, wi, wb, J, b, row, step, delta);
}

// The int8 write; dynamic shared memory holds the owner's f32 row (W).
__global__ void __launch_bounds__(kThreads)
sparse_write_q_kernel(int8_t* __restrict__ mem, float* __restrict__ scale,
                      int* __restrict__ la, const int* __restrict__ widx,
                      const float* __restrict__ ww,
                      const float* __restrict__ a,
                      const int* __restrict__ lra,
                      const int* __restrict__ step, int n_rows,
                      long long mem_stride, long long la_stride, int J, int H,
                      int kp1, int W, float delta) {
  extern __shared__ float acc[];
  const int u = blockIdx.x, b = blockIdx.y;
  const int* wi = widx + (long long)b * J;
  const float* wb = ww + (long long)b * J;
  int row;
  if (!owner(wi, u, n_rows, &row)) return;
  const bool erase = erased(lra, b, H, row);
  int8_t* mrow = mem + (long long)b * mem_stride + (long long)row * W;
  float* srow = scale + (long long)b * la_stride + row;
  const float s_old = *srow;
  const float* ab = a + (long long)b * H * W;
  float amax = 0.0f;
  for (int w = threadIdx.x; w < W; w += kThreads) {
    float x = erase ? 0.0f : __fmul_rn((float)mrow[w], s_old);
    for (int j = 0; j < J; ++j)
      if (wi[j] == row) x = __fmaf_rn(wb[j], ab[(j / kp1) * W + w], x);
    acc[w] = x;
    amax = fmaxf(amax, fabsf(x));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s_new = __fmul_rn(amax, 1.0f / 127.0f);
  const float safe = s_new > 0.0f ? s_new : 1.0f;
  __syncwarp();                        // every thread read s_old above
  for (int w = threadIdx.x; w < W; w += kThreads) {
    const float c = fminf(fmaxf(rintf(__fdiv_rn(acc[w], safe)), -127.0f),
                          127.0f);
    mrow[w] = (int8_t)c;
  }
  if (threadIdx.x == 0) {
    *srow = s_new;
    stamp(la, la_stride, wi, wb, J, b, row, step, delta);
  }
}

bool bad_shape(int batch, int W, int J, int H) {
  return batch < 1 || batch > 65535 || H < 1 || J < 1 || J % H != 0 || W < 1;
}

}  // namespace

extern "C" {

// row_dtype: 0 = f32, 1 = bf16 (raw 16-bit patterns).
int sparse_write_launch(void* mem, int* la, const int* widx, const float* ww,
                        const float* a, const int* lra, const int* step,
                        int batch, int n_rows, int W, int J, int H,
                        float delta, int row_dtype, void* stream) {
  if (bad_shape(batch, W, J, H)) return (int)cudaErrorInvalidValue;
  const dim3 grid(J, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long mem_stride = (long long)(n_rows + 1) * W;
  if (row_dtype == 0) {
    sparse_write_kernel<WriteF32><<<grid, kThreads, 0, s>>>(
        static_cast<float*>(mem), la, widx, ww, a, lra, step, n_rows,
        mem_stride, (long long)(n_rows + 1), J, H, J / H, W, delta);
  } else if (row_dtype == 1) {
    sparse_write_kernel<WriteBF16><<<grid, kThreads, 0, s>>>(
        static_cast<uint16_t*>(mem), la, widx, ww, a, lra, step, n_rows,
        mem_stride, (long long)(n_rows + 1), J, H, J / H, W, delta);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int sparse_write_q_launch(int8_t* mem, float* scale, int* la, const int* widx,
                          const float* ww, const float* a, const int* lra,
                          const int* step, int batch, int n_rows, int W,
                          int J, int H, float delta, void* stream) {
  if (bad_shape(batch, W, J, H) || W > 12288)     // W floats of smem
    return (int)cudaErrorInvalidValue;
  sparse_write_q_kernel<<<dim3(J, batch), kThreads, W * sizeof(float),
                          static_cast<cudaStream_t>(stream)>>>(
      mem, scale, la, widx, ww, a, lra, step, n_rows,
      (long long)(n_rows + 1) * W, (long long)(n_rows + 1), J, H, J / H, W,
      delta);
  return (int)cudaGetLastError();
}

}  // extern "C"
