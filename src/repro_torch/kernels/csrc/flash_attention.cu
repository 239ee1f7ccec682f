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
// The prefix (a launch argument P, 0 for none; PaliGemma's prefix-LM) is
// `chunked_attention(prefix_len=)`'s (attention.py:149-150): every query
// sees the keys below P, so the mask is (causal & window) | key < P and
// the rows of [0, P) attend to each other both ways. The launcher clamps
// P to S, so a key past S is never unmasked: it lies past every row and
// at or past P. With a prefix the key loop starts at tile 0 (the prefix
// lies before any window) and ends at the tile that holds key
// max(q0 + 63, P - 1), past the diagonal for the rows inside the prefix;
// a launch then does Σ_q max(q + 1, P) pairs (no config has both a window
// and a prefix; the semantics are JAX's all the same). A tile wholly
// below P needs no mask; one that P cuts, the diagonal, any tile past it
// and one the window's edge crosses are masked key by key.
//
// Head dims: D in 16, 32, 64, 128, 256 use tiles of D columns; D = 120
// (H2O-Danube3) runs in the D = 128 tile (DP, `pad_dim`) with a zero tail:
// the chunks of a row at or past D are zero-filled by cp.async (src-size
// 0), the global row stride stays H·D, and output columns D .. 127 are
// never stored. A 120-wide row is 480 B in f32 and 240 B in bf16, so rows
// stay 16-byte aligned. The zero tail adds nothing to q·kᵀ; the f32 q·kᵀ
// stops at D, the bf16 one runs the last 16-wide k-slice half on zeros,
// and the bf16 p·v skips the output n-tile that lies wholly in the tail.
// D = 256 (PaliGemma) does not fit the narrower tiles' registers; its
// changes are under each kernel below.
//
// q·k and v of different widths (DeepSeek-V2's MLA: q and k 192 wide, the
// 128 nope columns and the 64 rope ones, v 128 wide; `chunked_attention`
// takes v's width apart, src/repro/models/attention.py:452-468): the
// kernels are templates over the pair (DQK, DV), the head dims above being
// (D, D). q and k tiles are DQK wide, v tiles and the output DV wide; the
// row strides are H·DQK, Hkv·DQK and Hkv·DV, and o is (B, S, H, DV). The
// scale stays DQK^-0.5. Only (192, 128) is instantiated besides (D, D);
// its changes are under each kernel below.
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
// design. At D = 256 q's 16 k-slices (64 registers) and the 32 output
// n-tiles (128) would not fit beside the scores, so q stays in shared
// memory and each k-slice's A fragment is loaded (ldmatrix) where it is
// used, and a 64-key tile is taken as two sub-tiles of 32 keys (16
// scores a thread, each sub-tile its own online-softmax step); the five
// tiles take 165 KB, one block (four warps) an SM.
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
// registers a thread) to hide latency. At D = 256 a thread of the 128
// would hold 8 rows × 16 output columns (128 accumulators) and spill, so
// the block has 256 threads (`TileF32::NT`): thread (ty, tx), ty < 16,
// owns rows ty + 16i (i < 4), their scores against keys tx + 16j and 16
// output columns (64 accumulators). Its q, k, v and p take 208 KB, one
// block (eight warps) an SM.
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kThreads = 128;    // four warps (the f32 kernel at D = 256: 8)
constexpr float kNeg = -1e30f;   // the TPU kernel's mask value

// The tile width of head dim D: D itself, or 128 for D = 120.
constexpr int pad_dim(int D) { return D == 120 ? 128 : D; }

// The (q·k, v) head dims instantiated: (D, D), and MLA's (192, 128).
__host__ __device__ constexpr bool head_dims_ok(int DQK, int DV) {
  return (DQK == DV && (DQK == 16 || DQK == 32 || DQK == 64 || DQK == 120 ||
                        DQK == 128 || DQK == 256)) ||
         (DQK == 192 && DV == 128);
}

// Whether key `key` is hidden from query row `row` (both absolute):
// causal, or outside a window of `win` keys (`win` > S when there is
// none), and not in the prefix [0, pre).
__device__ __forceinline__ bool masked(int row, int key, int win, int pre) {
  return (key > row || row - key >= win) && key >= pre;
}

// The key tiles a block of query rows [q0, q0 + 64) (tile iq) walks, kt0
// .. kt1: from the window's first (0 with a prefix: it lies before any
// window) to the diagonal, or to the tile of the prefix's last key.
__device__ __forceinline__ void key_tiles(int q0, int iq, int win, int pre,
                                          int& kt0, int& kt1) {
  kt0 = pre > 0 ? 0 : max(0, q0 - win + 1) / kBQ;
  kt1 = pre > 0 ? max(iq, (pre - 1) / kBQ) : iq;
}

// Whether tile k0 .. k0 + 63 needs the mask for the rows [q0, q0 + 64):
// not where every key lies in the prefix; else the diagonal, a tile past
// it, and a tile the window's edge crosses.
__device__ __forceinline__ bool edge_tile(int q0, int k0, int win, int pre) {
  return k0 + kBQ > pre && (k0 >= q0 || q0 + kBQ - 1 - k0 >= win);
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
// goes to element `at(r, ch)` of `dst`. Where the block's NT threads are a
// multiple of a row's DP / V chunks, each keeps one chunk column and walks
// the rows NT / (DP / V) apart; else (DP = 192) thread i takes chunks i,
// i + NT, ... of the tile in row-major order.
template <typename T, int R, int D, int DP, int NT = kThreads, typename At>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long row_stride, int valid,
                                          At at) {
  constexpr int V = 16 / sizeof(T), PER_ROW = DP / V;
  static_assert(D % V == 0 && (R * PER_ROW) % NT == 0, "tile shape");
  if constexpr (NT % PER_ROW == 0) {
    constexpr int STEP = NT / PER_ROW;
    static_assert(R % STEP == 0, "tile shape");
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
  } else {
#pragma unroll
    for (int p = 0; p < R * PER_ROW / NT; ++p) {
      const int i = threadIdx.x + p * NT, r = i / PER_ROW, ch = i % PER_ROW;
      const bool ok = ch * V < D && r < valid;
      cp_async16(dst + at(r, ch), ok ? src + r * row_stride + ch * V : src,
                 ok);
    }
  }
}

// ---- bf16: tensor cores ----

// (192, 128): q and k tiles of 192 + 8 columns, v tiles of 128 + 8 (112 KB
// a block, two blocks an SM); q's 12 k-slices are loaded per use, as at
// D = 256, and the 16 output n-tiles fit beside a whole 64-key tile.
template <int DQK, int DV>
struct TileBF16 {
  static_assert(head_dims_ok(DQK, DV), "head dims");
  static constexpr int DPQ = pad_dim(DQK);    // columns of a q or k tile
  static constexpr int DPV = pad_dim(DV);     // columns of a v tile
  static constexpr int LDQ = DPQ + 8;         // bf16 elements a padded row
  static constexpr int LDV = DPV + 8;
  static constexpr int TQ = kBQ * LDQ;        // one 64-row q or k tile
  static constexpr int TV = kBQ * LDV;        // one 64-row v tile
  static constexpr int SMEM = (3 * TQ + 2 * TV) * 2;   // q, k ×2, v ×2
  // q's A fragments held in registers for the whole key loop (DQK <= 128),
  // or loaded from shared memory per k-slice (192, 256).
  static constexpr bool KEEP_Q = DPQ <= 128;
  static constexpr int BLOCKS = DPV <= 128 ? 2 : 1;  // an SM
  // A 64-key tile's compute in NSUB sub-tiles of SUBK keys, KN n-tiles.
  static constexpr int NSUB = DPV <= 128 ? 1 : 2;
  static constexpr int SUBK = kBQ / NSUB, KN = SUBK / 8;
};

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, TileBF16<DQK, DV>::BLOCKS)
flash_bf16_kernel(const unsigned short* __restrict__ q,
                  const unsigned short* __restrict__ k,
                  const unsigned short* __restrict__ v,
                  unsigned short* __restrict__ o, int S, int H, int Hkv,
                  int win, int pre, float scale_log2) {
  using Sh = TileBF16<DQK, DV>;
  constexpr int DPQ = Sh::DPQ, DPV = Sh::DPV, LDQ = Sh::LDQ, LDV = Sh::LDV;
  constexpr int TQ = Sh::TQ, TV = Sh::TV;
  constexpr int KD = DPQ / 16;                // k-slices of q·kᵀ
  constexpr int NO = DV / 8;                  // n-tiles of the output
  constexpr bool KEEP_Q = Sh::KEEP_Q;
  constexpr int NSUB = Sh::NSUB, SUBK = Sh::SUBK, KN = Sh::KN;
  extern __shared__ __align__(16) unsigned short smem_bf[];
  unsigned short* Qs = smem_bf;               // [64][LDQ]
  unsigned short* Ks = Qs + TQ;               // 2 × [64][LDQ]
  unsigned short* Vs = Ks + 2 * TQ;           // 2 × [64][LDV]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;      // the mma fragments' row, pair
  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const long long q_stride = (long long)H * DQK;
  const long long k_stride = (long long)Hkv * DQK, v_stride = (long long)Hkv * DV;
  const unsigned short* q_rows = q + ((long long)b * S * H + h) * DQK;
  const unsigned short* k_rows = k + ((long long)b * S * Hkv + hk) * DQK;
  const unsigned short* v_rows = v + ((long long)b * S * Hkv + hk) * DV;
  const int q0 = iq * kBQ;
  int kt0, kt1;
  key_tiles(q0, iq, win, pre, kt0, kt1);

  const auto padded_q = [](int r, int ch) { return r * LDQ + ch * 8; };
  const auto padded_v = [](int r, int ch) { return r * LDV + ch * 8; };
  load_rows<unsigned short, kBQ, DQK, DPQ>(Qs, q_rows + q0 * q_stride,
                                           q_stride, S - q0, padded_q);
  load_rows<unsigned short, kBQ, DQK, DPQ>(Ks, k_rows + kt0 * kBQ * k_stride,
                                           k_stride, S - kt0 * kBQ, padded_q);
  load_rows<unsigned short, kBQ, DV, DPV>(Vs, v_rows + kt0 * kBQ * v_stride,
                                          v_stride, S - kt0 * kBQ, padded_v);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};   // rows g, g + 8
  unsigned qf[KEEP_Q ? KD : 1][4];
  const int row_a = warp * 16 + g, row_b = row_a + 8;   // in the tile
  // Each lane's ldmatrix row addresses (bytes): q's A fragments (rows
  // warp·16 + l%16, columns 8·(l/16)); k's B fragments (keys l%8 + 8·(l/16),
  // columns 8·(l/8 % 2)); v's, transposed (keys l%8 + 8·(l/8 % 2), columns
  // 8·(l/16)). The fragment (kk, np) or (kv, dp) adds a constant.
  const unsigned q_lane = smem_addr(Qs) +
      2 * ((warp * 16 + (lane & 15)) * LDQ + ((lane >> 4) << 3));
  const unsigned k_lane = smem_addr(Ks) +
      2 * (((lane & 7) + ((lane >> 4) << 3)) * LDQ + (((lane >> 3) & 1) << 3));
  const unsigned v_lane = smem_addr(Vs) +
      2 * (((lane & 7) + (((lane >> 3) & 1) << 3)) * LDV + ((lane >> 4) << 3));

  for (int kt = kt0; kt <= kt1; ++kt) {
    const int slot = (kt - kt0) & 1, k0 = kt * kBQ;
    cp_async_wait_all();
    __syncthreads();        // tile kt is in; every read of tile kt-1 done
    if (kt < kt1) {         // tile kt+1 into the other half of the ring
      const int k1 = k0 + kBQ;
      load_rows<unsigned short, kBQ, DQK, DPQ>(Ks + (slot ^ 1) * TQ,
                                               k_rows + k1 * k_stride,
                                               k_stride, S - k1, padded_q);
      load_rows<unsigned short, kBQ, DV, DPV>(Vs + (slot ^ 1) * TV,
                                              v_rows + k1 * v_stride,
                                              v_stride, S - k1, padded_v);
      cp_async_commit();
    }
    if constexpr (KEEP_Q) {
      if (kt == kt0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], q_lane + 32 * kk);
      }
    }
    const unsigned kt_lane = k_lane + slot * TQ * 2;
    const unsigned vt_lane = v_lane + slot * TV * 2;
    const bool edge = edge_tile(q0, k0, win, pre);

    // The tile's keys in NSUB sub-tiles of SUBK, each through q·kᵀ, the
    // online softmax and p·v in turn (one at D <= 128; two of 32 keys at
    // D = 256, whose 128 accumulators leave no room for 64 scores).
#pragma unroll 1
    for (int sub = 0; sub < NSUB; ++sub) {
      const int kb = sub * SUBK;               // the sub-tile's first key
      // s = q·kᵀ: KN n-tiles of 8 keys; C fragment c0,c1 = row g, keys
      // 8j + 2t, +1; c2,c3 = row g + 8.
      float s[KN][4];
#pragma unroll
      for (int j = 0; j < KN; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned (&a)[4] = qf[KEEP_Q ? kk : 0];
        if constexpr (!KEEP_Q) ldmatrix_x4(a, q_lane + 32 * kk);
#pragma unroll
        for (int np = 0; np < KN / 2; ++np) {  // keys kb + 16np .. + 15
          unsigned bk[4];
          ldmatrix_x4(bk, kt_lane + 2 * ((kb + 16 * np) * LDQ + 16 * kk));
          mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
      if (edge) {
        const int ra = q0 + row_a, rb = q0 + row_b;
#pragma unroll
        for (int j = 0; j < KN; ++j) {
          const int key = k0 + kb + 8 * j + 2 * t;
          if (masked(ra, key, win, pre)) s[j][0] = kNeg;
          if (masked(ra, key + 1, win, pre)) s[j][1] = kNeg;
          if (masked(rb, key, win, pre)) s[j][2] = kNeg;
          if (masked(rb, key + 1, win, pre)) s[j][3] = kNeg;
        }
      }

      // Online softmax in registers: a row's scores lie in one quad.
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < KN; ++j) {
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
        ms[r] = m_new == kNeg ? 0.0f : m_new * scale_log2;  // all masked
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < KN; ++j) {
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

      // acc += p_hi·v + p_lo·v over keys kb + 16kv .. + 15: the C
      // fragments of n-tiles 2kv and 2kv + 1 are the A fragment of that
      // key slice. An output n-tile wholly in the zero tail (D = 120:
      // n-tile 15) is skipped.
#pragma unroll
      for (int kv = 0; kv < KN / 2; ++kv) {
        unsigned ph[4], pl[4];
        split_bf16(s[2 * kv][0], s[2 * kv][1], ph[0], pl[0]);
        split_bf16(s[2 * kv][2], s[2 * kv][3], ph[1], pl[1]);
        split_bf16(s[2 * kv + 1][0], s[2 * kv + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kv + 1][2], s[2 * kv + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < DPV / 16; ++dp) {  // columns 16dp .. + 15
          unsigned bv[4];
          ldmatrix_x4_trans(bv,
                            vt_lane + 2 * ((kb + 16 * kv) * LDV + 16 * dp));
          mma_bf16(acc[2 * dp], ph, bv[0], bv[1]);
          mma_bf16(acc[2 * dp], pl, bv[0], bv[1]);
          if (2 * dp + 1 < NO) {
            mma_bf16(acc[2 * dp + 1], ph, bv[2], bv[3]);
            mma_bf16(acc[2 * dp + 1], pl, bv[2], bv[3]);
          }
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
        o + (((long long)b * S + row) * H + h) * DV);
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
// (192, 128): 256 threads a block as at D = 256 (4 rows a thread, 8
// output columns), q and k tiles of 192 columns; 144 KB, one block an SM.
template <int DQK, int DV>
struct TileF32 {
  static_assert(head_dims_ok(DQK, DV), "head dims");
  static constexpr int DPQ = pad_dim(DQK);          // columns of q, k tiles
  static constexpr int DPV = pad_dim(DV);           // columns of a v tile
  static constexpr int SWQ = DPQ >= 32 ? 7 : 3;     // swizzle masks
  static constexpr int SWV = DPV >= 32 ? 7 : 3;
  static constexpr int CW = DPV >= 64 ? 4 : DPV / 16;  // output columns a load
  static constexpr int NG = DPV / (16 * CW);        // loads a row
  static constexpr int TQ = kBQ * DPQ;              // one 64-row q or k tile
  static constexpr int TV = kBQ * DPV;              // one 64-row v tile
  static constexpr int NT = DPQ > 128 || DPV > 128 ? 256 : kThreads;
  static constexpr int TY = NT / 16;                // row groups
  static constexpr int RI = kBQ / TY;               // rows a thread
  // q, one k and one v slot, p (64 × 64, swizzled as D = 64)
  static constexpr int SMEM = (2 * TQ + TV + kBQ * kBQ) * 4;
  // An SM's 228 KB hold two blocks (and their 1 KB each) up to D = 128.
  static constexpr int BLOCKS = 2 * (SMEM + 1024) <= 228 * 1024 ? 2 : 1;
};

template <int D, int SW>
__device__ __forceinline__ int swz(int r, int c) {   // element (r, c)
  return r * D + ((((c >> 2) ^ (r & SW))) << 2) + (c & 3);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(TileF32<DQK, DV>::NT,
                                  TileF32<DQK, DV>::BLOCKS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int Hkv, int win, int pre, float scale_log2) {
  using Sh = TileF32<DQK, DV>;
  constexpr int DPQ = Sh::DPQ, DPV = Sh::DPV, SWQ = Sh::SWQ, SWV = Sh::SWV;
  constexpr int CW = Sh::CW, NG = Sh::NG;
  constexpr int TQ = Sh::TQ, NT = Sh::NT, TY = Sh::TY, RI = Sh::RI;
  extern __shared__ __align__(16) float smem_f[];
  float* Qs = smem_f;                // [64][DPQ]
  float* Ks = Qs + TQ;               // [64][DPQ]: k of tile t
  float* Vs = Ks + TQ;               // [64][DPV]: v of tile t
  float* Ps = Vs + Sh::TV;           // [64][64]

  // Thread (ty, tx) owns rows ty + TY·i (i < RI): their scores against
  // keys tx + 16j (j < 4), their softmax state, and their output columns
  // g·16·CW + tx·CW + c. The 16 lanes of a half warp share the rows.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = lane & 15, ty = warp * 2 + (lane >> 4);
  const int iq = gridDim.x - 1 - blockIdx.x;        // heaviest first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const long long q_stride = (long long)H * DQK;
  const long long k_stride = (long long)Hkv * DQK, v_stride = (long long)Hkv * DV;
  const float* q_rows = q + ((long long)b * S * H + h) * DQK;
  const float* k_rows = k + ((long long)b * S * Hkv + hk) * DQK;
  const float* v_rows = v + ((long long)b * S * Hkv + hk) * DV;
  const int q0 = iq * kBQ;
  int kt0, kt1;
  key_tiles(q0, iq, win, pre, kt0, kt1);

  const auto swizzled_q = [](int r, int ch) {
    return swz<DPQ, SWQ>(r, 4 * ch);
  };
  const auto swizzled_v = [](int r, int ch) {
    return swz<DPV, SWV>(r, 4 * ch);
  };
  load_rows<float, kBQ, DQK, DPQ, NT>(Qs, q_rows + q0 * q_stride, q_stride,
                                      S - q0, swizzled_q);
  load_rows<float, kBQ, DQK, DPQ, NT>(Ks, k_rows + kt0 * kBQ * k_stride,
                                      k_stride, S - kt0 * kBQ, swizzled_q);
  cp_async_commit();

  float m[RI], l[RI], acc[RI][NG][CW];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][gg][c] = 0.0f;
  }
  // Row ty + TY·i has (row & SW) == (ty & SW) (TY is a multiple of 8) and
  // key tx + 16j has (key & SW) == (tx & SW): each thread's swizzle is one
  // constant.
  const float* q_base = Qs + ty * DPQ;
  const float* k_base = Ks + tx * DPQ;
  const int qx = ty & SWQ, kx = tx & SWQ;

  for (int kt = kt0; kt <= kt1; ++kt) {
    const int k0 = kt * kBQ;
    const bool edge = edge_tile(q0, k0, win, pre);
    cp_async_wait_all();
    __syncthreads();        // k of tile kt is in; p·v of tile kt-1 done
    load_rows<float, kBQ, DV, DPV, NT>(Vs, v_rows + k0 * v_stride, v_stride,
                                       S - k0, swizzled_v);
    cp_async_commit();

    float s[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int c = 0; c < DQK / 4; ++c) {     // the zero tail is left out
      float4 qv[RI], kv[4];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_base + TY * i * DPQ +
                                                 ((c ^ qx) << 2));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_base + 16 * j * DPQ +
                                                 ((c ^ kx) << 2));
#pragma unroll
      for (int i = 0; i < RI; ++i)
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
    float corr[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = ty + TY * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (edge && masked(q0 + row, k0 + tx + 16 * j, win, pre))
          s[i][j] = kNeg;
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
    if (kt < kt1) {         // k of tile kt+1 into the k slot
      const int k1 = k0 + kBQ;
      load_rows<float, kBQ, DQK, DPQ, NT>(Ks, k_rows + k1 * k_stride,
                                          k_stride, S - k1, swizzled_q);
      cp_async_commit();
    }

    // acc[row, col] = acc · corr + Σ_key p[row, key] · v[key, col].
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int gg = 0; gg < NG; ++gg)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][gg][c] *= corr[i];
#pragma unroll 2
    for (int j = 0; j < kBQ / 4; ++j) {   // keys 4j .. 4j + 3
      float4 pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            Ps + (ty + TY * i) * kBQ + ((j ^ (ty & 7)) << 2));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = 4 * j + jj;
        float vv[NG][CW];
#pragma unroll
        for (int gg = 0; gg < NG; ++gg) {
          const float* src = Vs + swz<DPV, SWV>(key, gg * 16 * CW + tx * CW);
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
        for (int i = 0; i < RI; ++i) {
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
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = q0 + ty + TY * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    float* dst = o + (((long long)b * S + row) * H + h) * DV;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg) {
      if (gg * 16 * CW + tx * CW >= DV) continue;    // the zero tail
#pragma unroll
      for (int c = 0; c < CW; ++c)
        dst[gg * 16 * CW + tx * CW + c] = acc[i][gg][c] / denom;
    }
  }
}

// ---- launchers ----

// Both kernels ask for the whole 228 KB of an SM as shared memory, so two
// blocks fit (one at D = 256, and the f32 one at (192, 128)).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hkv, int dtype, int window, int prefix,
           float scale, cudaStream_t stream) {
  using Bf = TileBF16<DQK, DV>;
  using F32 = TileF32<DQK, DV>;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  // exp(x·scale) = 2^(x·scale·log2 e)
  const float scale_log2 = scale * 1.4426950408889634f;
  // No window, or one that reaches every key: a width no row - key meets.
  const int win = window > 0 && window < S ? window : S + kBQ;
  // A prefix past S unmasks nothing more than S does (and no key past S).
  const int pre = prefix < S ? prefix : S;
  if (dtype == 1) {
    const cudaError_t err = prepare(flash_bf16_kernel<DQK, DV>, Bf::SMEM);
    if (err != cudaSuccess) return (int)err;
    flash_bf16_kernel<DQK, DV><<<grid, kThreads, Bf::SMEM, stream>>>(
        static_cast<const unsigned short*>(q),
        static_cast<const unsigned short*>(k),
        static_cast<const unsigned short*>(v),
        static_cast<unsigned short*>(o), S, H, Hkv, win, pre, scale_log2);
  } else {
    const cudaError_t err = prepare(flash_f32_kernel<DQK, DV>, F32::SMEM);
    if (err != cudaSuccess) return (int)err;
    flash_f32_kernel<DQK, DV><<<grid, F32::NT, F32::SMEM, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, H, Hkv, win,
        pre, scale_log2);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, S, H, DQK); k: (B, S, Hkv, DQK); v: (B, S, Hkv, DV); o: (B, S,
// H, DV); all contiguous and 16-byte aligned, of one dtype: code 0 = f32,
// 1 = bf16 (`_build.ROW_CODE`). (DQK, DV) is (D, D) with D in 16, 32, 64,
// 120, 128, 256, or (192, 128); Hkv divides H. window >= 1 hides the keys
// with pos_q - pos_k >= window; 0 means none. prefix >= 1 shows every
// query the keys below it; 0 means none.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int H, int Hkv, int DQK,
                           int DV, int dtype, int window, int prefix,
                           float scale, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || B * H > 65535 ||
      (dtype != 0 && dtype != 1) || window < 0 || prefix < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(dq, dv)                                                \
  if (DQK == dq && DV == dv)                                              \
    return launch<dq, dv>(q, k, v, o, B, S, H, Hkv, dtype, window, prefix, \
                          scale, s);
  FLASH_CASE(16, 16)
  FLASH_CASE(32, 32)
  FLASH_CASE(64, 64)
  FLASH_CASE(120, 120)
  FLASH_CASE(128, 128)
  FLASH_CASE(256, 256)
  FLASH_CASE(192, 128)
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
