// The least-used rows of a usage table: SAM's LRA selection (the n least
// recently accessed slots) and DAM's least-used slot (the argmin).
//
// Replaces src/repro/kernels/usage_argmin.py:
// - lra_topn (_topn_kernel, usage_argmin.py:71-83, tiles merged by lexsort
//   at :109-111): last_access (B, rows) int32, swept over [0, valid_n) ->
//   (B, n) int32 indices, ascending by (value, index);
// - usage_argmin (_kernel, usage_argmin.py:26-44): usage (B, rows) f32,
//   swept over [0, valid_n) -> (B,) int32 index of the minimum, the lowest
//   index on ties, -0.0 equal to +0.0. A NaN is not handled (DAM's usage
//   is a sum of softmax weights and finite).
//
// What bounds it on the H100: bytes. It reads the table once (B·N·4 bytes:
// 33.6 MB at B = 8, N = 2^20, about 10 us at 3.35 TB/s) and does a few
// integer compares per entry.
//
// Each entry becomes one int64 key value·2^32 + index, where an int32 value
// is itself and an f32 value is mapped to an int32 of the same signed
// order (`ordered`). Values can be negative (the -arange(N) stagger of
// SAM's table), and signed int64 order of the key is exactly (value,
// index) order, so the tie rule needs no extra compare and every key is
// unique. The TPU kernels' sequential grid has no counterpart: blocks run
// in parallel and meet in a merge.
//
// Both kernels sweep a row as one launch in one wave: the body of a row
// is read as 16-byte loads; a row starts 16-byte aligned only when its
// address does (rows % 4 == 0 for a whole table), so each row takes a
// scalar head up to its first aligned entry and a scalar tail after its
// last whole vector. The loads carry an L2 evict-first policy: the table
// is read once, and its lines, not other kernels' (dirty ones cost a
// write-back), make room. A row gets about 4·SMs/B blocks, so the table
// is swept in one wave, and the last block of the row to finish (a ticket
// counter taken with acquire-release order) writes the answer, in the
// same launch.
//
// The grid plan of both (16-byte vectors a block, blocks a row) comes from
// the wrapper (`kernels/usage_argmin.py::grid_plan`).
//
// lra_topn: the kernel is instantiated for each n in 1..8, so a thread's
// list of its n smallest keys stays in registers. Each thread walks its
// share from the high end down, and a vector forms keys only if its
// smallest value is at most the value of the thread's n-th key (three min
// ops and a compare; equal values pass, since the index decides the
// tie). SAM's table is the -arange(N) stagger with a few hundred positive
// stamps, so it falls as the index rises: a thread's first vector holds
// its smallest entries and every later one fails the test (walking up,
// every entry would be the smallest yet and go through the insert
// chain). The walk order changes the time only, never the answer (keys
// are unique). A block merges its threads' lists to n keys (n rounds of
// a warp minimum, then one warp over the warps' lists in shared memory),
// writes them to its row's scratch, and takes the ticket; the row's last
// block picks the n smallest of blocks·n keys.
//
// usage_argmin (n = 1) has a sweep of its own, since a list of one is a
// running minimum: each thread keeps one (value, index) pair and replaces
// it only on a strictly smaller value (an f32 compare, in which -0.0
// equals +0.0), so among equal values it keeps the first it saw, the
// lowest index (a thread walks its entries in increasing order); the key
// is formed once, for the block's minimum. A thread takes 16 float4s a
// round (ptxas keeps about four loads in flight, in 32 registers: 64 KB
// an SM, more than the memory needs in flight) and a block has 512
// threads; a row's blocks are whole rounds (B = 8, N = 2^20: 32 blocks a
// row, 256 in all, two an SM). Each block folds its minimum into
// its row's word with a 64-bit atomicMin (keys are unique, so the order
// of the blocks does not matter) before it takes its ticket.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kMaxN = 8;
constexpr long long kNone = LLONG_MAX;

// An f32 value as an int32 whose signed order is the float order. -0.0
// becomes +0.0 first (x + 0.0 rounds -0.0 to +0.0), so the two compare
// equal and the lower index wins; then a negative float's magnitude bits
// are flipped, so that a larger magnitude orders lower.
__device__ __forceinline__ int ordered(float v) {
  const int bits = __float_as_int(__fadd_rn(v, 0.0f));
  return bits < 0 ? bits ^ 0x7fffffff : bits;
}

__device__ __forceinline__ long long make_key(int value, int index) {
  return (long long)value * 4294967296LL + (long long)index;
}

__device__ __forceinline__ long long warp_min(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long other = __shfl_xor_sync(0xffffffffu, v, o);
    v = other < v ? other : v;
  }
  return v;
}

// Minimum over the block; sh holds 33 slots.
__device__ long long block_min(long long v, long long* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_min(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? sh[lane] : kNone;
    v = warp_min(v);
    if (lane == 0) sh[32] = v;
  }
  __syncthreads();
  const long long r = sh[32];
  __syncthreads();
  return r;
}

// 16 bytes of a table read once: through to L2 (no L1 line) under an
// evict-first policy there.
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ float4 load_once(const float4* p,
                                            unsigned long long pol) {
  float4 r;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 "
      "{%0,%1,%2,%3}, [%4], %5;\n"
      : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
      : "l"(p), "l"(pol));
  return r;
}

__device__ __forceinline__ int4 load_once(const int4* p,
                                          unsigned long long pol) {
  int4 r;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.v4.s32 "
      "{%0,%1,%2,%3}, [%4], %5;\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p), "l"(pol));
  return r;
}

// A ticket of the row's counter, taken with release and acquire order:
// what this thread wrote before is visible before its ticket counts, and
// the last block sees what every other block wrote.
__device__ __forceinline__ unsigned long long take_ticket(
    unsigned long long* counter) {
  unsigned long long ticket;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], 1;\n"
               : "=l"(ticket) : "l"(counter) : "memory");
  return ticket;
}

constexpr int kTopnThreads = 256;    // lra_topn's block
constexpr int kTopnWarps = kTopnThreads / 32;
constexpr int kTopnVec = 4;          // int4 loads a thread keeps in flight

// Insert `key` into the ascending register list top[0..N).
template <int N>
__device__ __forceinline__ void insert(long long (&top)[N], long long key) {
#pragma unroll
  for (int p = N - 1; p >= 0; --p) {
    if (key < top[p]) {
      const long long prev = top[p > 0 ? p - 1 : 0];
      top[p] = (p > 0 && key < prev) ? prev : key;
    }
  }
}

// The value of the list's last key: an entry above it cannot enter
// (INT_MAX while the list is not full).
template <int N>
__device__ __forceinline__ int cut_of(const long long (&top)[N]) {
  return (int)(top[N - 1] >> 32);
}

template <int N>
__device__ __forceinline__ void offer(long long (&top)[N], int& cut, int v,
                                      int i) {
  if (v <= cut) {
    insert(top, make_key(v, i));
    cut = cut_of(top);
  }
}

// The four entries e..e+3 of a vector, highest index first, or none of
// them when their smallest value is above the cut.
template <int N>
__device__ __forceinline__ void offer_vec(long long (&top)[N], int& cut,
                                          int4 x, int e) {
  if (min(min(x.x, x.y), min(x.z, x.w)) <= cut) {
    offer(top, cut, x.w, e + 3);
    offer(top, cut, x.z, e + 2);
    offer(top, cut, x.y, e + 1);
    offer(top, cut, x.x, e);
  }
}

// The warp's N smallest keys, ascending, in res on every lane: N rounds
// in which the lane holding the warp's smallest head pops it (keys are
// unique; lanes whose head is kNone pop kNone and keep kNone).
template <int N>
__device__ __forceinline__ void warp_smallest(long long (&top)[N],
                                              long long (&res)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const long long m = warp_min(top[0]);
    if (top[0] == m) {
#pragma unroll
      for (int p = 0; p < N - 1; ++p) top[p] = top[p + 1];
      top[N - 1] = kNone;
    }
    res[r] = m;
  }
}

// The block's N smallest keys, ascending, in res on warp 0's lanes; the
// block's other warps hold no result. top is consumed.
template <int N>
__device__ __forceinline__ void block_smallest(long long (&top)[N],
                                               long long (&res)[N],
                                               long long* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_smallest(top, res);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < N; ++r) sh[warp * N + r] = res[r];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < N; ++r)
      top[r] = lane < kTopnWarps ? sh[lane * N + r] : kNone;
    warp_smallest(top, res);
  }
}

// lra_topn in one launch: block c of row b sweeps int4s
// [c·per, (c+1)·per) of the row's aligned body, block 0 also the head and
// the last block the tail; each thread takes the vectors t, t + T, ... of
// that range from the last down. keys holds gridDim.x·N keys a row;
// tickets one zero word a row, which the row's last block puts back.
template <int N>
__global__ void __launch_bounds__(kTopnThreads, 4)
topn_kernel(const int* __restrict__ table, long long row_stride, int valid_n,
            int per, long long* __restrict__ keys,
            unsigned long long* __restrict__ tickets, int* __restrict__ out) {
  __shared__ long long sh[kTopnWarps * N];
  __shared__ int last;
  const int b = blockIdx.y, c = blockIdx.x, t = threadIdx.x;
  const int blocks = gridDim.x;
  const int* row = table + (long long)b * row_stride;
  const int mis = (int)((reinterpret_cast<unsigned long long>(row) >> 2) & 3);
  const int head = min((4 - mis) & 3, valid_n);
  const int nvec = (valid_n - head) >> 2;
  const int tail0 = head + 4 * nvec;
  const int4* body = reinterpret_cast<const int4*>(row + head);
  const int start = c * per, end = min(start + per, nvec);
  const unsigned long long pol = evict_first_policy();

  long long top[N];
#pragma unroll
  for (int p = 0; p < N; ++p) top[p] = kNone;
  int cut = INT_MAX;
  if (c == blocks - 1 && tail0 + t < valid_n)
    offer(top, cut, row[tail0 + t], tail0 + t);
  // This thread's vectors are start + t + k·T for k < count.
  const int count = end - start > t
                        ? (end - start - t + kTopnThreads - 1) / kTopnThreads
                        : 0;
  for (int k = count; k > 0; k -= kTopnVec) {
    int4 x[kTopnVec];
#pragma unroll
    for (int u = 0; u < kTopnVec; ++u)
      if (k - 1 - u >= 0)
        x[u] = load_once(body + start + t + (k - 1 - u) * kTopnThreads, pol);
#pragma unroll
    for (int u = 0; u < kTopnVec; ++u)
      if (k - 1 - u >= 0)
        offer_vec(top, cut, x[u],
                 head + 4 * (start + t + (k - 1 - u) * kTopnThreads));
  }
  if (c == 0 && t < head) offer(top, cut, row[t], t);

  long long res[N];
  block_smallest(top, res, sh);
  if (t == 0) {
    long long* mine = keys + ((long long)b * blocks + c) * N;
#pragma unroll
    for (int r = 0; r < N; ++r) mine[r] = res[r];
    last = take_ticket(tickets + b) == (unsigned long long)(blocks - 1);
    if (last) tickets[b] = 0ULL;
  }
  __syncthreads();
  if (!last) return;
  // The row's last block: the N smallest of the blocks' keys.
  const long long* all = keys + (long long)b * blocks * N;
#pragma unroll
  for (int p = 0; p < N; ++p) top[p] = kNone;
  for (int i = t; i < blocks * N; i += kTopnThreads) insert(top, __ldcg(all + i));
  block_smallest(top, res, sh);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < N; ++r) out[(long long)b * N + r] = (int)(res[r] & 0xffffffffLL);
  }
}

template <int N>
cudaError_t launch_topn(const int* la, long long row_stride, int batch,
                        int valid_n, int per, int blocks, long long* scratch,
                        int* out, cudaStream_t s) {
  topn_kernel<N><<<dim3(blocks, batch), kTopnThreads, 0, s>>>(
      la, row_stride, valid_n, per, scratch + batch,
      reinterpret_cast<unsigned long long*>(scratch), out);
  return cudaGetLastError();
}

constexpr int kArgThreads = 512;     // usage_argmin's block
constexpr int kVec = 16;             // float4 loads a thread
constexpr unsigned long long kSign = 1ULL << 63;

// The running minimum of one thread: a strictly smaller value replaces it
// (f32 compare: -0.0 equals +0.0), so among equal values the first seen,
// the lowest index, stays; the first entry is always taken (a row of +inf).
__device__ __forceinline__ void take(float& best_x, int& best_i, float x,
                                     int i) {
  if (x < best_x || best_i == INT_MAX) {
    best_x = x;
    best_i = i;
  }
}

__device__ __forceinline__ void take4(float& best_x, int& best_i, float4 x,
                                      int e) {
  take(best_x, best_i, x.x, e);
  take(best_x, best_i, x.y, e + 1);
  take(best_x, best_i, x.z, e + 2);
  take(best_x, best_i, x.w, e + 3);
}

// usage_argmin in one launch: block c of row b sweeps float4s
// [c·per, (c+1)·per) of the row's aligned body, block 0 also the head and
// the last block the tail. Each block folds its smallest key into
// row_min[b] (atomicMin on the key with its sign bit flipped, so unsigned
// order is signed order), then counts itself in tickets[b]; the last
// block of the row to count reads the minimum and puts both words back
// as it found them (all ones, zero).
__global__ void __launch_bounds__(kArgThreads)
argmin_kernel(const float* __restrict__ usage, long long row_stride,
              int valid_n, int per, unsigned long long* __restrict__ row_min,
              unsigned long long* __restrict__ tickets,
              int* __restrict__ out) {
  __shared__ long long sh[33];
  const int b = blockIdx.y, c = blockIdx.x, t = threadIdx.x;
  const int blocks = gridDim.x;
  const float* row = usage + (long long)b * row_stride;
  // Entries before the first 16-byte boundary, then whole float4s.
  const int mis = (int)((reinterpret_cast<unsigned long long>(row) >> 2) & 3);
  const int head = min((4 - mis) & 3, valid_n);
  const int nvec = (valid_n - head) >> 2;
  const int tail0 = head + 4 * nvec;
  const float4* body = reinterpret_cast<const float4*>(row + head);
  const int start = c * per, end = min(start + per, nvec);

  const unsigned long long pol = evict_first_policy();
  float best_x = 0.0f;
  int best_i = INT_MAX;
  if (c == 0 && t < head) take(best_x, best_i, row[t], t);
  int i = start + t;
  for (; i + (kVec - 1) * kArgThreads < end; i += kVec * kArgThreads) {
    float4 x[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u)
      x[u] = load_once(body + i + u * kArgThreads, pol);
#pragma unroll
    for (int u = 0; u < kVec; ++u)
      take4(best_x, best_i, x[u], head + 4 * (i + u * kArgThreads));
  }
  for (; i < end; i += kArgThreads)              // the last block's rest
    take4(best_x, best_i, load_once(body + i, pol), head + 4 * i);
  if (c == blocks - 1 && tail0 + t < valid_n)
    take(best_x, best_i, row[tail0 + t], tail0 + t);
  const long long key =
      best_i == INT_MAX ? kNone : make_key(ordered(best_x), best_i);
  const long long best = block_min(key, sh);
  if (t == 0) {
    atomicMin(row_min + b, (unsigned long long)best ^ kSign);
    // This block's atomicMin is done before its ticket counts, and the
    // last block sees every other block's.
    if (take_ticket(tickets + b) == (unsigned long long)(blocks - 1)) {
      const unsigned long long m = atomicExch(row_min + b, ~0ULL);
      tickets[b] = 0ULL;
      out[b] = (int)(m & 0xffffffffULL);
    }
  }
}

}  // namespace

extern "C" {

// scratch: batch tickets (zero), which the launch leaves as it found
// them, then blocks·n int64 keys a row; two launches must not share it at
// once (one per stream). per and blocks come from the wrapper's plan and
// must cover the row's int4s.
int lra_topn_launch(const int* la, long long row_stride, int batch,
                    int valid_n, int n, int per, int blocks,
                    long long* scratch, int* out, void* stream) {
  if (n < 1 || n > kMaxN || valid_n < n || batch < 1 || batch > 65535 ||
      per < 1 || blocks < 1 || (long long)per * blocks < valid_n / 4)
    return (int)cudaErrorInvalidValue;
  static cudaError_t (*const launch[kMaxN])(const int*, long long, int, int,
                                            int, int, long long*, int*,
                                            cudaStream_t) = {
      launch_topn<1>, launch_topn<2>, launch_topn<3>, launch_topn<4>,
      launch_topn<5>, launch_topn<6>, launch_topn<7>, launch_topn<8>};
  return (int)launch[n - 1](la, row_stride, batch, valid_n, per, blocks,
                            scratch, out, static_cast<cudaStream_t>(stream));
}

// state: 2·batch words, the rows' minima (all ones) then their tickets
// (zero), which the launch leaves as it found them; two launches must not
// share them at once (one set per stream). per and blocks as for
// lra_topn_launch.
int usage_argmin_launch(const float* usage, long long row_stride, int batch,
                        int valid_n, int per, int blocks,
                        unsigned long long* state, int* out, void* stream) {
  if (valid_n < 1 || batch < 1 || batch > 65535 || per < 1 || blocks < 1 ||
      (long long)per * blocks < valid_n / 4)
    return (int)cudaErrorInvalidValue;
  argmin_kernel<<<dim3(blocks, batch), kArgThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      usage, row_stride, valid_n, per, state, state + batch, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
