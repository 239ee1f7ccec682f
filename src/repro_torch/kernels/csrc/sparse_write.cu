// sparse_write_update: the fused SAM write, in place.
//
// Replaces src/repro/kernels/sparse_write.py::sparse_write_update (the f32
// _kernel, sparse_write.py:68-87, called at :221 with the memory and the
// usage table aliased in and out).
//
// Computes, for each batch row b and each of the J = H·(K+1) write
// columns j (head j / (K+1)):
//   mem[b, lra_idx]    = 0                              (erase, eq. 6)
//   mem[b, write_idx] += write_w · a                    (eqs. 3/5)
//   la[b, row]         = max(la[b, row], step[b])  where a column with
//                                                   w_j > delta hits row
// mem (B, N+1, W) f32 and la (B, N+1) int32 are updated in place.
//
// What bounds it on the H100: launch latency. It touches J rows per batch
// row (J·W·4·2 bytes of memory traffic, about 40 KB at B = 8, J = 20,
// W = 32), independent of N.
//
// Design: one 32-thread block per (column u, b). Only the first column
// naming a row owns it (the TPU wrapper's first_occurrence,
// sparse_write.py:182-186); a later duplicate returns without writing. The
// owner starts from the row's old value, or zero when the row is an LRA
// row, and adds every matching column's w_j·a in j order with separately
// rounded multiply and add. That is the TPU kernel's add order and the
// plain version's arithmetic, with no atomics, so the result is
// deterministic. Precondition (as for the TPU kernel): every lra_idx row
// also appears in write_idx — only written rows are erased. Rows outside
// [0, N) are ignored, so row N, the write-scratch row, is never touched.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
sparse_write_kernel(float* __restrict__ mem, int* __restrict__ la,
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
  const int row = wi[u];
  if (row < 0 || row >= n_rows) return;
  for (int j = 0; j < u; ++j)
    if (wi[j] == row) return;               // an earlier column owns the row
  bool erase = false;
  for (int h = 0; h < H; ++h) erase |= lra[(long long)b * H + h] == row;
  float* mrow = mem + (long long)b * mem_stride + (long long)row * W;
  const float* ab = a + (long long)b * H * W;
  for (int w = threadIdx.x; w < W; w += kThreads) {
    float acc = erase ? 0.0f : mrow[w];
    for (int j = 0; j < J; ++j)
      if (wi[j] == row)
        acc = __fadd_rn(acc, __fmul_rn(wb[j], ab[(j / kp1) * W + w]));
    mrow[w] = acc;
  }
  if (threadIdx.x == 0) {
    bool touched = false;
    for (int j = 0; j < J; ++j) touched |= (wi[j] == row) && (wb[j] > delta);
    if (touched) {
      int* cell = la + (long long)b * la_stride + row;
      *cell = max(*cell, step[b]);
    }
  }
}

}  // namespace

extern "C" int sparse_write_launch(float* mem, int* la, const int* widx,
                                   const float* ww, const float* a,
                                   const int* lra, const int* step, int batch,
                                   int n_rows, int W, int J, int H,
                                   float delta, void* stream) {
  if (batch < 1 || batch > 65535 || H < 1 || J % H != 0 || W < 1)
    return (int)cudaErrorInvalidValue;
  sparse_write_kernel<<<dim3(J, batch), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      mem, la, widx, ww, a, lra, step, n_rows,
      (long long)(n_rows + 1) * W, (long long)(n_rows + 1), J, H, J / H, W,
      delta);
  return (int)cudaGetLastError();
}
