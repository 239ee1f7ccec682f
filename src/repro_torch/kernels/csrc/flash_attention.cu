// Causal GQA attention, forward: o = softmax(q·kᵀ·D^-0.5, causal) · v,
// optionally within a sliding window.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (_kernel,
// flash_attention.py:27-61, pallas_call at :94): q (B, S, H, D) and k, v
// (B, S, Hkv, D), f32 or bf16, -> o (B, S, H, D) in q's dtype. Query head
// h reads kv head h / (H / Hkv) (:89-92). Scores are f32, masked to -1e30
// where pos_q < pos_k; an online softmax (running max, running sum, an f32
// accumulator rescaled by exp(m_prev - m_new)) takes the keys tile by tile,
// l is the f32 sum of the f32 p, and the row is divided by max(l, 1e-20)
// at the end. Both instantiations run one block of four warps per (b·h,
// tile of 64 query rows), the heaviest tiles (the last rows) first, walk
// the 64-key tiles 0 .. the diagonal (the causal skip of the TPU kernel's
// `pl.when`), fold the scale into exp2 (ex2.approx) and stream k and v
// with 16-byte `cp.async` copies that are in flight while the tile before
// computes. Rows and keys past S are zero-filled by cp.async's src-size
// operand and never stored; the causal mask alone hides a ragged tile's
// padded keys.
//
// The window (a launch argument, 0 for none) is `chunked_attention`'s
// (src/repro/models/attention.py:145-148), which the TPU kernel does not
// have: a key is masked where pos_q - pos_k >= window, as a causal one
// where pos_k > pos_q. A block of query rows [q0, q0 + 64) starts its key
// loop at the tile that holds key q0 - window + 1, so a launch does about
// Σ_q min(q + 1, window) of the S(S+1)/2 causal work. A row can then meet
// a tile whose keys are all masked for it: its running max stays -1e30,
// and its weights there are taken as 0 (ms = 0 below), where the plain
// softmax gives exp(0) = 1 that the next tile's correction exp(-1e30 - m)
// multiplies by 0. The sums are the same; the kernel never forms
// exp2 of the f32 residue of -1e30·scale.
//
// Head dims: D in 16, 32, 64, 128 use tiles of D columns; D = 120
// (H2O-Danube3) runs in the D = 128 tile (DP, `pad_dim`) with a zero tail:
// the chunks of a row at or past D are zero-filled by cp.async (src-size
// 0), the global row stride stays H·D, and output columns D .. 127 are
// never stored. A 120-wide row is 480 B in f32 and 240 B in bf16, so rows
// stay 16-byte aligned. The zero tail adds nothing to q·kᵀ; the f32 q·kᵀ
// stops at D, the bf16 one runs the last 16-wide k-slice half on zeros,
// and the bf16 p·v skips the output n-tile that lies wholly in the tail.
//
// What bounds it on the H100: operations. Let half = S(S+1)/2 · B·H · 2D,
// the flop of q·kᵀ over the causal half (1.03e11 at B = 4, S = 2048,
// H = 48, D = 128).
//
// bf16 inputs (`flash_bf16_kernel`): the tensor cores, FA2-style, with
// mma.sync.m16n8k16 (bf16 operands, f32 accumulators). q·kᵀ is exact
// products summed in f32. p stays f32 as the TPU kernel keeps it: it is
// split into p_hi = bf16(p) and p_lo = bf16(p - p_hi), and p·v is two bf16
// products into one f32 accumulator (v is bf16, so exact); rounding p once
// would put the output one bf16 ulp from the plain version, the bar
// itself. So the card's least time is 3·half at 989 TFLOP/s, 0.3128 ms at
// those shapes (TF32 p·v at 495 TFLOP/s gives the same), beside 0.065 ms
// of bytes. Each warp owns 16 query rows: q's A fragments are loaded once
// (ldmatrix) and kept, the scores live in the mma's C fragments, the
// online softmax runs in registers (row max by quad shuffles, each lane's
// part of the sum reduced at the end), and the C fragments of p become
// the A fragments of p·v in registers, so p never touches shared memory.
// k and v stay bf16 in shared memory, in a double-buffered ring (tile t+1
// loads while tile t computes: one barrier a tile), rows padded by 16
// bytes so ldmatrix (and ldmatrix.trans for v's B fragments) meets no bank
// conflict: 87 KB a block at D = 128, two blocks an SM. What holds it
// back: two warps an SMSP (registers: 216 a thread at D = 128) cannot hide
// the softmax between a warp's products, and mma.sync does not reach the
// tensor cores' full rate; then the 4e8 exp2 of the causal half on the
// SFUs (about 0.1 ms). wgmma with TMA and warp specialisation is the next
// design.
//
// f32 inputs (`flash_f32_kernel`): f32 FMAs on the CUDA cores, 2·half at
// 67 TFLOP/s (3.08 ms). TF32's 10-bit mantissa cannot hold the JAX suite's
// 2e-5, and this kernel has no split-operand tensor-core scheme. Thread
// (ty, tx) owns rows ty + 8i (i < 8): their scores against keys tx + 16j
// (j < 4), an 8×4 register tile that takes 128 FMAs per 12 16-byte shared
// loads, and their output columns (8 × D/16 accumulators, 256 FMAs per 16
// loads of p and v). p goes through shared memory. The tiles' 16-byte
// chunks are XOR-swizzled by row instead of padded, and k and v take
// turns in one k slot and one v slot: v of tile t loads while q·kᵀ runs,
// k of tile t+1 while p·v runs. 112 KB a block at D = 128, two blocks an
// SM. What holds it back: the FMAs share the issue slots with the shared
// loads, addresses and the softmax, with two warps an SMSP (246
// registers a thread) to hide latency.
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kThreads = 128;    // four warps
constexpr float kNeg = -1e30f;   // the TPU kernel's mask value

// The tile width of head dim D: D itself, or 128 for D = 120.
constexpr int pad_dim(int D) { return D == 120 ? 128 : D; }

__host__ __device__ constexpr bool head_dim_ok(int D) {
  return D == 16 || D == 32 || D == 64 || D == 120 || D == 128;
}

// Whether key `key` is hidden from query row `row` (both absolute):
// causal, or outside a window of `win` keys (`win` > S when there is none).
__device__ __forceinline__ bool masked(int row, int key, int win) {
  return key > row || row - key >= win;
}

// ---- cp.async, ldmatrix, mma.sync ----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zero-filled when !valid (src must still
// be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8×8 bf16 matrices from the shared address `a` (each lane gives one
// row's address): lane l gets row l/4, columns 2(l%4), +1 of each; .trans
// gives it column l/4, rows 2(l%4), +1.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a · b: a 16×16 bf16 (row), b 16×8 bf16 (col), c 16×8 f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU (ex2.approx, 2 ulp), a result below 2^-126 flushed to 0:
// exp2f without the range fix-up for subnormal results, which a softmax
// weight that small does not need.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 rounded to nearest even into one bf16x2 register: lo in the low
// half (the lower column of an mma fragment).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// p = (lo, hi) as p_hi + p_lo, each half a bf16x2 register.
__device__ __forceinline__ void split_bf16(float lo, float hi, unsigned& ph,
                                           unsigned& pl) {
  ph = pack_bf16(lo, hi);
  pl = pack_bf16(lo - __uint_as_float(ph << 16),
                 hi - __uint_as_float(ph & 0xffff0000u));
}

// f32 -> bf16 bits, round to nearest even (NaN stays a quiet NaN), as
// PyTorch's cast does.
__device__ __forceinline__ unsigned short to_bf16(float x) {
  const unsigned u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u)
    return (unsigned short)((u >> 16) | 0x40u);
  return (unsigned short)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

// Rows [0, R) of a (·, row_stride) input of D columns from `src` into a
// shared tile of DP columns by 16-byte cp.async; rows at or past `valid`
// (at least 1) and columns at or past D are zero. Chunk `ch` of row `r`
// goes to element `at(r, ch)` of `dst`. Each thread keeps one chunk column
// and walks the rows kThreads / (DP / V) apart.
template <typename T, int R, int D, int DP, typename At>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long row_stride, int valid,
                                          At at) {
  constexpr int V = 16 / sizeof(T), PER_ROW = DP / V;
  constexpr int STEP = kThreads / PER_ROW;
  static_assert(kThreads % PER_ROW == 0 && R % STEP == 0 && D % V == 0,
                "tile shape");
  const int ch = threadIdx.x % PER_ROW, r0 = threadIdx.x / PER_ROW;
  const bool col = ch * V < D;
  const T* row = src + r0 * row_stride + (col ? ch * V : 0);
#pragma unroll
  for (int p = 0; p < R / STEP; ++p) {
    const int r = r0 + p * STEP;
    const bool ok = col && r < valid;
    cp_async16(dst + at(r, ch), ok ? row : src, ok);
    row += STEP * row_stride;
  }
}

// ---- bf16: tensor cores ----

template <int D>
struct TileBF16 {
  static_assert(head_dim_ok(D), "head dim");
  static constexpr int DP = pad_dim(D);       // columns of a tile
  static constexpr int LD = DP + 8;           // bf16 elements a padded row
  static constexpr int TILE = kBQ * LD;       // one 64-row tile
  static constexpr int SMEM = 5 * TILE * 2;   // q, k ×2, v ×2
};

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bf16_kernel(const unsigned short* __restrict__ q,
                  const unsigned short* __restrict__ k,
                  const unsigned short* __restrict__ v,
                  unsigned short* __restrict__ o, int S, int H, int Hkv,
                  int win, float scale_log2) {
  using Sh = TileBF16<D>;
  constexpr int DP = Sh::DP, LD = Sh::LD, TILE = Sh::TILE;
  constexpr int KD = DP / 16;                 // k-slices of q·kᵀ
  constexpr int NO = D / 8;                   // n-tiles of the output
  extern __shared__ __align__(16) unsigned short smem_bf[];
  unsigned short* Qs = smem_bf;               // [64][LD]
  unsigned short* Ks = Qs + TILE;             // 2 × [64][LD]
  unsigned short* Vs = Ks + 2 * TILE;         // 2 × [64][LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;      // the mma fragments' row, pair
  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const long long q_stride = (long long)H * D, kv_stride = (long long)Hkv * D;
  const unsigned short* q_rows = q + ((long long)b * S * H + h) * D;
  const unsigned short* k_rows = k + ((long long)b * S * Hkv + hk) * D;
  const unsigned short* v_rows = v + ((long long)b * S * Hkv + hk) * D;
  const int q0 = iq * kBQ;
  const int kt0 = max(0, q0 - win + 1) / kBQ;  // the window's first tile

  const auto padded = [](int r, int ch) { return r * LD + ch * 8; };
  load_rows<unsigned short, kBQ, D, DP>(Qs, q_rows + q0 * q_stride, q_stride,
                                        S - q0, padded);
  load_rows<unsigned short, kBQ, D, DP>(Ks, k_rows + kt0 * kBQ * kv_stride,
                                        kv_stride, S - kt0 * kBQ, padded);
  load_rows<unsigned short, kBQ, D, DP>(Vs, v_rows + kt0 * kBQ * kv_stride,
                                        kv_stride, S - kt0 * kBQ, padded);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};   // rows g, g + 8
  unsigned qf[KD][4];
  const int row_a = warp * 16 + g, row_b = row_a + 8;   // in the tile
  // Each lane's ldmatrix row addresses (bytes): q's A fragments (rows
  // warp·16 + l%16, columns 8·(l/16)); k's B fragments (keys l%8 + 8·(l/16),
  // columns 8·(l/8 % 2)); v's, transposed (keys l%8 + 8·(l/8 % 2), columns
  // 8·(l/16)). The fragment (kk, np) or (kv, dp) adds a constant.
  const unsigned q_lane = smem_addr(Qs) +
      2 * ((warp * 16 + (lane & 15)) * LD + ((lane >> 4) << 3));
  const unsigned k_lane = smem_addr(Ks) +
      2 * (((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3));
  const unsigned v_lane = smem_addr(Vs) +
      2 * (((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + ((lane >> 4) << 3));

  for (int kt = kt0; kt <= iq; ++kt) {
    const int slot = (kt - kt0) & 1, k0 = kt * kBQ;
    cp_async_wait_all();
    __syncthreads();        // tile kt is in; every read of tile kt-1 done
    if (kt < iq) {          // tile kt+1 into the other half of the ring
      const int k1 = k0 + kBQ;
      load_rows<unsigned short, kBQ, D, DP>(Ks + (slot ^ 1) * TILE,
                                            k_rows + k1 * kv_stride,
                                            kv_stride, S - k1, padded);
      load_rows<unsigned short, kBQ, D, DP>(Vs + (slot ^ 1) * TILE,
                                            v_rows + k1 * kv_stride,
                                            kv_stride, S - k1, padded);
      cp_async_commit();
    }
    if (kt == kt0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], q_lane + 32 * kk);
    }
    const unsigned kt_lane = k_lane + slot * TILE * 2;
    const unsigned vt_lane = v_lane + slot * TILE * 2;

    // s = q·kᵀ: 8 n-tiles of 8 keys; C fragment c0,c1 = row g, keys
    // 8j + 2t, +1; c2,c3 = row g + 8.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {      // keys 16np .. 16np + 15
        unsigned bk[4];
        ldmatrix_x4(bk, kt_lane + 2 * (16 * np * LD + 16 * kk));
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }
    // The diagonal tile, and a tile the window's edge crosses.
    if (kt == iq || q0 + kBQ - 1 - k0 >= win) {
      const int ra = q0 + row_a, rb = q0 + row_b;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + 8 * j + 2 * t;
        if (masked(ra, key, win)) s[j][0] = kNeg;
        if (masked(ra, key + 1, win)) s[j][1] = kNeg;
        if (masked(rb, key, win)) s[j][2] = kNeg;
        if (masked(rb, key + 1, win)) s[j][3] = kNeg;
      }
    }

    // Online softmax in registers: a row's 64 scores lie in one quad.
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2], ms[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2_ftz((m[r] - m_new) * scale_log2);
      ms[r] = m_new == kNeg ? 0.0f : m_new * scale_log2;  // all masked: p = 0
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = exp2_ftz(fmaf(s[j][c], scale_log2, -ms[c >> 1]));
        sum[c >> 1] += s[j][c];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
      acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
    }

    // acc += p_hi·v + p_lo·v over keys 16kv .. 16kv + 15: the C fragments
    // of n-tiles 2kv and 2kv + 1 are the A fragment of that key slice. An
    // output n-tile wholly in the zero tail (D = 120: n-tile 15) is skipped.
#pragma unroll
    for (int kv = 0; kv < 4; ++kv) {
      unsigned ph[4], pl[4];
      split_bf16(s[2 * kv][0], s[2 * kv][1], ph[0], pl[0]);
      split_bf16(s[2 * kv][2], s[2 * kv][3], ph[1], pl[1]);
      split_bf16(s[2 * kv + 1][0], s[2 * kv + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kv + 1][2], s[2 * kv + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {  // columns 16dp .. 16dp + 15
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vt_lane + 2 * (16 * kv * LD + 16 * dp));
        mma_bf16(acc[2 * dp], ph, bv[0], bv[1]);
        mma_bf16(acc[2 * dp], pl, bv[0], bv[1]);
        if (2 * dp + 1 < NO) {
          mma_bf16(acc[2 * dp + 1], ph, bv[2], bv[3]);
          mma_bf16(acc[2 * dp + 1], pl, bv[2], bv[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + (r ? row_b : row_a);
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-20f);
    unsigned* dst = reinterpret_cast<unsigned*>(
        o + (((long long)b * S + row) * H + h) * D);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      dst[(8 * n + 2 * t) >> 1] =
          (unsigned)to_bf16(acc[n][2 * r] / denom) |
          ((unsigned)to_bf16(acc[n][2 * r + 1] / denom) << 16);
  }
}

// ---- f32: CUDA-core FMAs ----

// A row of D f32 in shared memory, its 16-byte chunks XOR-swizzled by the
// row (chunk c of row r sits at c ^ (r & SW)), so the loads of a warp's
// rows meet no bank conflict and a tile needs no padding.
template <int D>
struct TileF32 {
  static_assert(head_dim_ok(D), "head dim");
  static constexpr int DP = pad_dim(D);             // columns of a tile
  static constexpr int SW = DP >= 32 ? 7 : 3;       // swizzle mask
  static constexpr int CW = DP >= 64 ? 4 : DP / 16; // output columns a load
  static constexpr int NG = DP / (16 * CW);         // loads a row
  static constexpr int TILE = kBQ * DP;             // one 64-row tile
  // q, one k and one v slot, p (64 × 64, swizzled as D = 64)
  static constexpr int SMEM = (3 * TILE + kBQ * kBQ) * 4;
};

template <int D, int SW>
__device__ __forceinline__ int swz(int r, int c) {   // element (r, c)
  return r * D + ((((c >> 2) ^ (r & SW))) << 2) + (c & 3);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int Hkv, int win, float scale_log2) {
  using Sh = TileF32<D>;
  constexpr int DP = Sh::DP, SW = Sh::SW, CW = Sh::CW, NG = Sh::NG;
  constexpr int TILE = Sh::TILE;
  extern __shared__ __align__(16) float smem_f[];
  float* Qs = smem_f;                // [64][DP]
  float* Ks = Qs + TILE;             // [64][DP]: k of tile t
  float* Vs = Ks + TILE;             // [64][DP]: v of tile t
  float* Ps = Vs + TILE;             // [64][64]

  // Thread (ty, tx) owns rows ty + 8i (i < 8): their scores against keys
  // tx + 16j (j < 4), their softmax state, and their output columns
  // g·16·CW + tx·CW + c. The 16 lanes of a half warp share the rows.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = lane & 15, ty = warp * 2 + (lane >> 4);
  const int iq = gridDim.x - 1 - blockIdx.x;        // heaviest first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const long long q_stride = (long long)H * D, kv_stride = (long long)Hkv * D;
  const float* q_rows = q + ((long long)b * S * H + h) * D;
  const float* k_rows = k + ((long long)b * S * Hkv + hk) * D;
  const float* v_rows = v + ((long long)b * S * Hkv + hk) * D;
  const int q0 = iq * kBQ;
  const int kt0 = max(0, q0 - win + 1) / kBQ;  // the window's first tile

  const auto swizzled = [](int r, int ch) { return swz<DP, SW>(r, 4 * ch); };
  load_rows<float, kBQ, D, DP>(Qs, q_rows + q0 * q_stride, q_stride, S - q0,
                               swizzled);
  load_rows<float, kBQ, D, DP>(Ks, k_rows + kt0 * kBQ * kv_stride, kv_stride,
                               S - kt0 * kBQ, swizzled);
  cp_async_commit();

  float m[8], l[8], acc[8][NG][CW];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][gg][c] = 0.0f;
  }
  // Row ty + 8i has (row & SW) == (ty & SW) and key tx + 16j has
  // (key & SW) == (tx & SW): each thread's swizzle is one constant.
  const float* q_base = Qs + ty * DP;
  const float* k_base = Ks + tx * DP;
  const int qx = ty & SW, kx = tx & SW;

  for (int kt = kt0; kt <= iq; ++kt) {
    const int k0 = kt * kBQ;
    // The diagonal tile, and a tile the window's edge crosses.
    const bool edge = kt == iq || q0 + kBQ - 1 - k0 >= win;
    cp_async_wait_all();
    __syncthreads();        // k of tile kt is in; p·v of tile kt-1 done
    load_rows<float, kBQ, D, DP>(Vs, v_rows + k0 * kv_stride, kv_stride,
                                 S - k0, swizzled);
    cp_async_commit();

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int c = 0; c < D / 4; ++c) {       // the zero tail is left out
      float4 qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_base + 8 * i * DP +
                                                 ((c ^ qx) << 2));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_base + 16 * j * DP +
                                                 ((c ^ kx) << 2));
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // Online softmax of each row over this tile: the 16 lanes of a row
    // reduce its max by shuffles, each keeps its part of the row's sum
    // (summed across the lanes at the end); the scale is folded into
    // exp2. p goes to shared memory, swizzled as a 64-wide tile.
    float corr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = ty + 8 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (edge && masked(q0 + row, k0 + tx + 16 * j, win)) s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float ms = m_new == kNeg ? 0.0f : m_new * scale_log2;
      corr[i] = exp2_ftz((m[i] - m_new) * scale_log2);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2_ftz(fmaf(s[i][j], scale_log2, -ms));
        Ps[swz<kBQ, 7>(row, tx + 16 * j)] = p;
        sum += p;
      }
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
    cp_async_wait_all();
    __syncthreads();        // v of tile kt is in, p is whole, k is read
    if (kt < iq) {          // k of tile kt+1 into the k slot
      const int k1 = k0 + kBQ;
      load_rows<float, kBQ, D, DP>(Ks, k_rows + k1 * kv_stride, kv_stride,
                                   S - k1, swizzled);
      cp_async_commit();
    }

    // acc[row, col] = acc · corr + Σ_key p[row, key] · v[key, col].
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int gg = 0; gg < NG; ++gg)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][gg][c] *= corr[i];
#pragma unroll 2
    for (int j = 0; j < kBQ / 4; ++j) {   // keys 4j .. 4j + 3
      float4 pv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            Ps + (ty + 8 * i) * kBQ + ((j ^ (ty & 7)) << 2));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = 4 * j + jj;
        float vv[NG][CW];
#pragma unroll
        for (int gg = 0; gg < NG; ++gg) {
          const float* src = Vs + swz<DP, SW>(key, gg * 16 * CW + tx * CW);
          if constexpr (CW == 4) {
            const float4 x = *reinterpret_cast<const float4*>(src);
            vv[gg][0] = x.x; vv[gg][1] = x.y; vv[gg][2] = x.z; vv[gg][3] = x.w;
          } else if constexpr (CW == 2) {
            const float2 x = *reinterpret_cast<const float2*>(src);
            vv[gg][0] = x.x; vv[gg][1] = x.y;
          } else {
            vv[gg][0] = src[0];
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                        : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int gg = 0; gg < NG; ++gg)
#pragma unroll
            for (int c = 0; c < CW; ++c)
              acc[i][gg][c] = fmaf(p, vv[gg][c], acc[i][gg][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = q0 + ty + 8 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    float* dst = o + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg) {
      if (gg * 16 * CW + tx * CW >= D) continue;     // the zero tail
#pragma unroll
      for (int c = 0; c < CW; ++c)
        dst[gg * 16 * CW + tx * CW + c] = acc[i][gg][c] / denom;
    }
  }
}

// ---- launchers ----

// Both kernels ask for the whole 228 KB of an SM as shared memory, so two
// blocks fit.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hkv, int dtype, int window, float scale,
           cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  // exp(x·scale) = 2^(x·scale·log2 e)
  const float scale_log2 = scale * 1.4426950408889634f;
  // No window, or one that reaches every key: a width no row - key meets.
  const int win = window > 0 && window < S ? window : S + kBQ;
  if (dtype == 1) {
    const cudaError_t err = prepare(flash_bf16_kernel<D>, TileBF16<D>::SMEM);
    if (err != cudaSuccess) return (int)err;
    flash_bf16_kernel<D><<<grid, kThreads, TileBF16<D>::SMEM, stream>>>(
        static_cast<const unsigned short*>(q),
        static_cast<const unsigned short*>(k),
        static_cast<const unsigned short*>(v),
        static_cast<unsigned short*>(o), S, H, Hkv, win, scale_log2);
  } else {
    const cudaError_t err = prepare(flash_f32_kernel<D>, TileF32<D>::SMEM);
    if (err != cudaSuccess) return (int)err;
    flash_f32_kernel<D><<<grid, kThreads, TileF32<D>::SMEM, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, H, Hkv, win,
        scale_log2);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (B, S, H, D); k, v: (B, S, Hkv, D), all contiguous and 16-byte
// aligned, of one dtype: code 0 = f32, 1 = bf16 (`_build.ROW_CODE`).
// D is 16, 32, 64, 120 or 128, and Hkv divides H. window >= 1 hides the
// keys with pos_q - pos_k >= window; 0 means none.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int H, int Hkv, int D,
                           int dtype, int window, float scale, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || B * H > 65535 ||
      (dtype != 0 && dtype != 1) || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, S, H, Hkv, dtype, window, scale, s);
    case 32: return launch<32>(q, k, v, o, B, S, H, Hkv, dtype, window, scale, s);
    case 64: return launch<64>(q, k, v, o, B, S, H, Hkv, dtype, window, scale, s);
    case 120: return launch<120>(q, k, v, o, B, S, H, Hkv, dtype, window, scale, s);
    case 128: return launch<128>(q, k, v, o, B, S, H, Hkv, dtype, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
