// scatter_rows: a row scatter into a (B, R, W) f32 buffer, in place.
//
// Replaces src/repro/kernels/scatter_rows.py::scatter_rows (the Pallas
// _scatter_unique, scatter_rows.py:85-106, with _combine_duplicates,
// scatter_rows.py:46-54, folding duplicate 'add' rows beforehand).
//
// Computes, for each batch row b and each of the J columns j:
//   'add': mem[b, idx[b, j]] += rows[b, j]
//   'set': mem[b, idx[b, j]]  = rows[b, j]
// With duplicate indices, 'add' sums every matching column into the row in
// j order, starting from the row's value; 'set' keeps the last column.
// Every index must lie in [0, R): the plain version raises on one outside,
// and the kernel, which cannot raise without waiting on the device, skips
// it rather than write out of bounds. No row that no index names is
// touched (in particular not the write-scratch row N of a (B, N+1, W)
// buffer, which the TPU kernel used as a parking row for duplicates).
//
// What bounds it on the H100: launch latency. It reads B·J·W·4 bytes of
// rows (20 KB at B = 8, J = 20, W = 32) and reads and writes at most as
// many bytes of memory rows, independent of R.
//
// Design: one 32-thread block per (column j, b), the threads along W. The
// Pallas grid walked (B, J) in order, so a later grid step saw an earlier
// one's write; here the blocks run in no order, so each row gets exactly
// one owner: the first column naming it ('add') or the last ('set'), found
// by an O(J) scan of the indices. The 'add' owner adds the matching
// columns with separately rounded adds, in j order: the plain version's
// arithmetic and the fused write's, so the replay of a write gives the
// forward's floats bit for bit. No atomics, so the result is
// deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(float* __restrict__ mem, const int* __restrict__ idx,
                    const float* __restrict__ rows, int n_rows,
                    long long mem_stride, int J, int W, int add) {
  const int j = blockIdx.x, b = blockIdx.y;
  const int* ib = idx + (long long)b * J;
  const int row = ib[j];
  if (row < 0 || row >= n_rows) return;
  if (add) {
    for (int u = 0; u < j; ++u)
      if (ib[u] == row) return;             // an earlier column owns the row
  } else {
    for (int u = j + 1; u < J; ++u)
      if (ib[u] == row) return;             // a later column overwrites it
  }
  float* mrow = mem + (long long)b * mem_stride + (long long)row * W;
  const float* rb = rows + (long long)b * J * W;
  for (int w = threadIdx.x; w < W; w += kThreads) {
    if (add) {
      float acc = mrow[w];
      for (int u = j; u < J; ++u)
        if (ib[u] == row) acc = __fadd_rn(acc, rb[(long long)u * W + w]);
      mrow[w] = acc;
    } else {
      mrow[w] = rb[(long long)j * W + w];
    }
  }
}

}  // namespace

extern "C" int scatter_rows_launch(float* mem, const int* idx,
                                   const float* rows, int batch, int n_rows,
                                   int J, int W, int add, void* stream) {
  if (batch < 1 || batch > 65535 || J < 1 || W < 1 || n_rows < 1)
    return (int)cudaErrorInvalidValue;
  scatter_rows_kernel<<<dim3(J, batch), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      mem, idx, rows, n_rows, (long long)n_rows * W, J, W, add);
  return (int)cudaGetLastError();
}
