// Exact attention in float32 on Hopper's tensor cores: the forward, dQ and
// dK/dV kernels for f32 inputs with head_dim a multiple of 16 up to 128
// (the wrapper's "tc32" route; other f32 head dims run flash_attention.cu).
//
//   flash_fwd_tc32_kernel  <- _fwd_kernel (launched by _fwd, the
//                             pl.pallas_call at distributed_tensorflow_tpu/
//                             ops/flash_attention.py:170)
//   flash_dq_tc32_kernel   <- _dq_kernel  (launched by _bwd,
//                             flash_attention.py:281)
//   flash_dkv_tc32_kernel  <- _dkv_kernel (launched by _bwd,
//                             flash_attention.py:299)
//
// They compute the function of flash_attention.cu's kernels.  All three:
// S = scale * Q K^T; a causal mask by absolute position and a key-validity
// mask score NEG_INF = -1e30, never -inf; a key past Lk has weight exactly
// 0.  The forward keeps an online softmax with f32 m, l and acc and writes
// O = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)) in natural-log
// units, (B, H, Lq) f32, as the backward reads it.  It stages the keys 64
// at a time and visits exactly the key tiles flash_fwd_kernel visits, so a
// row with no valid key gets the same answer: m stays NEG_INF and each
// visited key below Lk has weight 1 (the mean of V over them).  The
// backward takes P = exp(S - lse), dP = dO V^T, dS = P * (dP - Delta) *
// scale with lse and Delta = rowsum(dO * O) from the caller, and writes
// dQ = dS K, dV = P^T dO, dK = dS^T Q in f32.  Tensors stay in the model's
// (B, L, H, D) layout; ragged and cross lengths are masked here, not
// padded.  As on the TPU, the forward and dQ have one CTA per q tile
// looping over the k tiles and dK/dV one CTA per k tile looping over the q
// tiles: no atomics, so the results are bitwise repeatable.
//
// Precision.  Every product runs on the tensor cores as 3xTF32
// (mma.sync.m16n8k8 .tf32 with f32 accumulators): each f32 operand x is
// split into big = x with its 13 low mantissa bits cleared (a TF32 value)
// and small = x - big (exact in f32, of which the tensor core reads the
// TF32 part), and each product is big*big + big*small + small*big, summed
// in f32 -- about 21 bits of each product against f32's 24, the split
// CUTLASS calls OpMultiplyAddFastF32.  This is not "TF32 on": the harness
// turns TF32 off so that f32 math keeps f32 accuracy (utils/harness.py),
// and these kernels keep it; plain TF32 would keep 11 bits.
//
// What bounds them on this card: at the training slice's shape (B*H = 64,
// L = 1024, D = 64, causal) the forward does about 8.6 GFLOP of f32
// products, dQ about 12.9 and dK/dV about 17.2; three TF32 products per f32
// product at the 494.7 TFLOP/s dense TF32 peak is about 165 TFLOP/s, so
// ~0.052, ~0.078 and ~0.104 ms (the SIMT kernels of flash_attention.cu are
// bound by the 67 TFLOP/s f32 CUDA-core peak: 0.13, 0.19 and 0.26 ms).  At
// BERT-tiny's shape (B*H = 64, L = 128, key mask) they are as small as
// 0.002-0.004 ms, where the bytes and the number of CTAs bound them.
//
// What the design does about it (FlashAttention-2's structure on mma.sync,
// as flash_attention_sm90.cu's 16-bit kernels):
// - CTAs of 4 warps.  A CTA owns 64 rows (q rows of the forward and dQ,
//   keys of dK/dV), 16 per warp, or, where 64-row CTAs would make fewer
//   than two waves on the card's 132 SMs (BERT-tiny's shape: 128 CTAs), 32
//   rows with two warps on each slab of 16; the wrapper picks the rows and
//   passes them.  The other side is staged 64 rows (keys of the forward and
//   dQ, q rows of dK/dV) at a time and taken in two sub-steps of 32: both
//   by the slab's one warp, or one by each of its two, whose partial sums
//   (in the forward, softmax states (m, l, acc)) are then merged in a
//   fixed order through shared memory.  So a short kernel keeps two warps
//   on each scheduler instead of one, and stays bitwise repeatable.
// - S and dP live in the mma accumulators.  The forward's online softmax
//   (the row max and sum over the lane quad that holds a row, the rescale
//   of O) and P and dS are computed there and split into big and small in
//   registers as the A operands of O += P V, dQ += dS K, dV += P^T dO and
//   dK += dS^T Q: an accumulator holds columns 2t, 2t+1 of its rows, so the
//   reduction index t of the A fragment stands for column 2t and t + 4 for
//   2t + 1, and the B fragment reads rows 2t and 2t + 1.  Nothing goes
//   through shared memory on the way.
// - Fragments are plain 32-bit ld.shared loads (ldmatrix moves 16-bit
//   words): rows are padded by 4 floats (row stride = 4 mod 32 banks), so
//   a warp's fragment loads -- (row g, column t) and (row 2t, column g)
//   for lane (g, t) -- fall in 32 different banks.
// - The staged tiles are copied straight from the (B, L, H, D) layout with
//   16-byte cp.async.cg, zero-filled past L and D, into two stages: tile
//   j + 1 is in flight while tile j is consumed.
// - Under the causal mask, tiles wholly in the future are skipped, and the
//   CTAs with the most tiles to visit are launched first (the last q tiles
//   of the forward and dQ, the first k tiles of dK/dV).  Without a key
//   mask the forward also skips a warp's sub-step wholly in its rows'
//   future: every row has a valid key (key 0) in its CTA's first sub-step,
//   so each weight of such a sub-step would be exactly 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // matches parallel.ring_attention.NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kTiny = 1e-30f;
constexpr int kBT = 64;             // staged rows: keys of fwd and dQ, q rows
                                    // of dK/dV
constexpr int kSub = 32;            // columns of S per sub-step
constexpr int kPad = 4;             // floats of padding per shared row
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr uint32_t kTf32 = 0xffffe000u;   // sign, exponent, 10 mantissa bits

struct Dims {
  int B, H, Lq, Lk, D;
  float scale;
  int causal;
};

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !pred (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// 2^x (ex2.approx.ftz: relative error 2^-22, subnormal results flushed to
// 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x as a TF32 pair (the header's big and small); the tensor core reads
// only the top 19 bits of small
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x) & kTf32;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a (16x8, row) * b (8x8, col) in TF32, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: the two cross terms, then big x big
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma_tf32(c, ab, bs[0], bs[1]);
  mma_tf32(c, as, bb[0], bb[1]);
  mma_tf32(c, ab, bb[0], bb[1]);
}

// Fragments for lane (g = lane / 4, t = lane % 4), split.  `s` points at
// the fragment's first element in a shared tile of row stride LD.
//
// A (16 x 8, row) of a tile whose rows are the product's rows:
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&big)[4],
                                       uint32_t (&small)[4], const float* s,
                                       int g, int t) {
  split(s[g * LD + t], big[0], small[0]);
  split(s[(g + 8) * LD + t], big[1], small[1]);
  split(s[g * LD + t + 4], big[2], small[2]);
  split(s[(g + 8) * LD + t + 4], big[3], small[3]);
}

// B (8 x 8, col) of X^T for a product A X^T, from a tile of X whose rows
// are the product's columns: b0 = X[g][t], b1 = X[g][t + 4].
template <int LD>
__device__ __forceinline__ void frag_bt(uint32_t (&big)[2],
                                        uint32_t (&small)[2], const float* s,
                                        int g, int t) {
  split(s[g * LD + t], big[0], small[0]);
  split(s[g * LD + t + 4], big[1], small[1]);
}

// B (8 x 8) of Z for a product P Z whose A comes from accumulators
// (acc_a): the reduction index t stands for row 2t of Z and t + 4 for row
// 2t + 1; b0 = Z[2t][g], b1 = Z[2t + 1][g].
template <int LD>
__device__ __forceinline__ void frag_bz(uint32_t (&big)[2],
                                        uint32_t (&small)[2], const float* s,
                                        int g, int t) {
  split(s[2 * t * LD + g], big[0], small[0]);
  split(s[(2 * t + 1) * LD + g], big[1], small[1]);
}

// A (16 x 8) of an 8-column accumulator block c (rows g, g + 8; columns
// 2t, 2t + 1), in the column order frag_bz reads.
__device__ __forceinline__ void acc_a(uint32_t (&big)[4],
                                      uint32_t (&small)[4],
                                      const float (&c)[4]) {
  split(c[0], big[0], small[0]);     // (g, 2t)
  split(c[2], big[1], small[1]);     // (g + 8, 2t)
  split(c[1], big[2], small[2]);     // (g, 2t + 1)
  split(c[3], big[3], small[3]);     // (g + 8, 2t + 1)
}

// Shared-memory row stride (floats) and sizes (bytes) at head-dim tier DT
// and R row slabs of 16 per CTA; the wrapper's smem_bytes mirrors them.
template <int DT, int R>
struct Smem {
  static constexpr int LD = DT + kPad;
  static constexpr int tiles = 2 * 16 * R * LD + 4 * kBT * LD;
  // Q; 2 stages of (K, V); 2 stages of the key mask
  static constexpr int fwd = 4 * (16 * R * LD + 4 * kBT * LD + 2 * kBT);
  // Q, dO; 2 stages of (K, V); 2 stages of the key mask
  static constexpr int dq = 4 * (tiles + 2 * kBT);
  // K, V; 2 stages of (Q, dO); 2 stages of (lse, Delta)
  static constexpr int dkv = 4 * (tiles + 4 * kBT);
};

// Stage rows [r0, r0 + ROWS) of head (b, h) of a (B, L, H, D) f32 tensor
// into shared memory with row stride LD; rows past L and columns past D
// are zero-filled.  Asynchronous: the caller commits and waits.
template <int ROWS, int DT, int NT>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int b, int h, int r0, int L,
                                          const Dims& dm) {
  constexpr int LD = DT + kPad;
  constexpr int kChunks = DT / 4;               // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NT) {
    const int r = i / kChunks, c = (i - r * kChunks) * 4;
    const int row = r0 + r;
    const bool ok = row < L && c < dm.D;
    const float* gp =
        ok ? src + (((size_t)b * L + row) * dm.H + h) * dm.D + c : src;
    cp_async16(dst + r * LD + c, gp, ok);
  }
}

// Write rows g and g + 8 of a warp's 16 x DT accumulator to rows
// [r0, r0 + 16) of head (b, h), 8 bytes a lane.
template <int DB>
__device__ __forceinline__ void store_acc(float* __restrict__ dst,
                                          const float (&c)[DB][4], int b,
                                          int h, int r0, int L,
                                          const Dims& dm, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= L) continue;
    float* base = dst + (((size_t)b * L + row) * dm.H + h) * dm.D;
#pragma unroll
    for (int db = 0; db < DB; ++db) {
      const int col = db * 8 + 2 * t;
      if (col < dm.D)
        *reinterpret_cast<float2*>(base + col) =
            make_float2(c[db][2 * i], c[db][2 * i + 1]);
    }
  }
}

// Sum the S split warps' partial accumulators of each row slab into split
// 0's, in split order (a fixed order: bitwise repeatable), through `red`
// (shared memory no longer in use; (S - 1) * R * DB * 4 * 32 floats).
// Every thread of the CTA calls it.
template <int S, int R, int DB>
__device__ __forceinline__ void reduce_splits(float (&c)[DB][4], float* red,
                                              int rw, int sw, int lane) {
  if constexpr (S > 1) {
    constexpr int kSlab = DB * 4 * 32;
    __syncthreads();                   // every warp is done with `red`
    if (sw > 0) {
      float* dst = red + ((sw - 1) * R + rw) * kSlab + lane;
#pragma unroll
      for (int i = 0; i < DB; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[(i * 4 + e) * 32] = c[i][e];
    }
    __syncthreads();
    if (sw == 0) {
#pragma unroll 1
      for (int s = 1; s < S; ++s) {
        const float* src = red + ((s - 1) * R + rw) * kSlab + lane;
#pragma unroll
        for (int i = 0; i < DB; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[i][e] += src[(i * 4 + e) * 32];
      }
    }
  }
}

// Merge the S split warps' softmax states (m, l, acc) of each row slab
// into split 0's, in split order (bitwise repeatable), through `red`
// (shared memory no longer in use; (S - 1) * R * (DB + 1) * 4 * 32
// floats).  m and l are each lane's copies of its rows g and g + 8, l
// already summed over the quad.  Every thread of the CTA calls it.
template <int S, int R, int DB>
__device__ __forceinline__ void merge_softmax(float (&m)[2], float (&l)[2],
                                              float (&c)[DB][4], float* red,
                                              int rw, int sw, int lane) {
  if constexpr (S > 1) {
    constexpr int kSlab = (DB + 1) * 4 * 32;
    __syncthreads();                   // every warp is done with `red`
    if (sw > 0) {
      float* dst = red + ((sw - 1) * R + rw) * kSlab + lane;
#pragma unroll
      for (int i = 0; i < DB; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[(i * 4 + e) * 32] = c[i][e];
      dst[(DB * 4 + 0) * 32] = m[0];
      dst[(DB * 4 + 1) * 32] = m[1];
      dst[(DB * 4 + 2) * 32] = l[0];
      dst[(DB * 4 + 3) * 32] = l[1];
    }
    __syncthreads();
    if (sw == 0) {
#pragma unroll 1
      for (int s = 1; s < S; ++s) {
        const float* src = red + ((s - 1) * R + rw) * kSlab + lane;
        float a[2], o[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mo = src[(DB * 4 + r) * 32];
          const float mn = fmaxf(m[r], mo);
          a[r] = exp2_approx((m[r] - mn) * kLog2e);
          o[r] = exp2_approx((mo - mn) * kLog2e);
          l[r] = l[r] * a[r] + src[(DB * 4 + 2 + r) * 32] * o[r];
          m[r] = mn;
        }
#pragma unroll
        for (int i = 0; i < DB; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            c[i][e] = c[i][e] * a[e >> 1] + src[(i * 4 + e) * 32] * o[e >> 1];
      }
    }
  }
}

// ---------------------------------------------------------------- forward
// One CTA of 4 warps per (b*h, q tile of 16 R rows), looping over the k
// tiles up to the diagonal; warp (rw, sw) owns rows [16 rw, 16 rw + 16)
// and sub-steps sw, sw + S, ... of each k tile (S = 4 / R), with an online
// softmax of its own, merged with its slab's other warps' at the end.
template <int DT, int R>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ mask,
                      float* __restrict__ out, float* __restrict__ lse,
                      Dims dm) {
  constexpr int NT = kThreads, S = kWarps / R, ROWS = 16 * R;
  constexpr int LD = Smem<DT, R>::LD;
  constexpr int KD = DT / 8;         // k steps of 8 over the head dim
  constexpr int DB = DT / 8;         // 8-wide column blocks of O
  constexpr int NB = kSub / 8;       // 8-key column blocks per sub-step
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* kv_s = q_s + ROWS * LD;                       // [stage][K|V]
  float* m_s = kv_s + 4 * kBT * LD;                    // [stage] key mask

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp % R, sw = warp / R;
  const int g = lane / 4, t = lane % 4;
  const int bhn = dm.B * dm.H;
  const int n_qt = (dm.Lq + ROWS - 1) / ROWS;
  const int bh = blockIdx.x % bhn;
  const int q0 = (n_qt - 1 - blockIdx.x / bhn) * ROWS;   // longest first
  const int b = bh / dm.H, h = bh - b * dm.H;
  const int wq0 = q0 + rw * 16;
  // the key tiles flash_attention.cu's forward visits (64-row q tiles)
  const int q_last = min(q0 + ROWS, dm.Lq) - 1;
  const int k_end = dm.causal ? min(dm.Lk, q_last + 1) : dm.Lk;
  const int n_kt = (k_end + kBT - 1) / kBT;

  auto load_kv = [&](int j) {
    float* ks = kv_s + (j & 1) * 2 * kBT * LD;
    load_tile<kBT, DT, NT>(ks, k, b, h, j * kBT, dm.Lk, dm);
    load_tile<kBT, DT, NT>(ks + kBT * LD, v, b, h, j * kBT, dm.Lk, dm);
    if (mask != nullptr) {
      for (int c = threadIdx.x; c < kBT; c += NT) {
        const int kpos = j * kBT + c;
        cp_async4(m_s + (j & 1) * kBT + c,
                  mask + (size_t)b * dm.Lk + min(kpos, dm.Lk - 1),
                  kpos < dm.Lk);
      }
    }
  };

  load_tile<ROWS, DT, NT>(q_s, q, b, h, q0, dm.Lq, dm);
  if (n_kt > 0) load_kv(0);
  cp_async_commit();

  // per lane: rows g and g + 8 of the warp's 16: the running max, the sum
  // of this lane's weights (its columns), O's accumulators
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DB][4];
#pragma unroll
  for (int i = 0; i < DB; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const float* qw = q_s + rw * 16 * LD;
  // a causal warp with every row past key 0 may skip its future sub-steps
  const bool skip_future = dm.causal && mask == nullptr;

  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) load_kv(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* ks = kv_s + (j & 1) * 2 * kBT * LD;
    const float* vs = ks + kBT * LD;
    const float* ms = m_s + (j & 1) * kBT;
    const int k0 = j * kBT;

#pragma unroll 1
    for (int sub = sw; sub < kBT / kSub; sub += S) {
      const int c0 = sub * kSub;        // first key column of the sub-step
      const int kc0 = k0 + c0;
      if (skip_future && kc0 > wq0 + 15) continue;
      // S = Q K^T: the warp's 16 rows x 32 keys
      float s[NB][4];
#pragma unroll
      for (int i = 0; i < NB; ++i)
        s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t qb[4], qsm[4];
        frag_a<LD>(qb, qsm, qw + kd * 8, g, t);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          uint32_t kb[2], ksm[2];
          frag_bt<LD>(kb, ksm, ks + (c0 + nb * 8) * LD + kd * 8, g, t);
          mma3(s[nb], qb, qsm, kb, ksm);
        }
      }

      // scale and mask (NEG_INF; a key past Lk -inf, weight 0), row max
      const bool edge = (dm.causal && kc0 + kSub - 1 > wq0) ||
                        kc0 + kSub > dm.Lk || mask != nullptr;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float x = s[nb][e] * dm.scale;
          if (edge) {
            const int col = c0 + nb * 8 + 2 * t + (e & 1);
            const int kpos = k0 + col, qpos = wq0 + g + 8 * r;
            if (kpos >= dm.Lk)
              x = __int_as_float(0xff800000);
            else if ((dm.causal && qpos < kpos) ||
                     (mask != nullptr && !(ms[col] > 0.f)))
              x = kNegInf;
          }
          s[nb][e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
      // the quad of lanes 4g .. 4g + 3 holds a row; rescale by the new max
      // (m - max is exactly 0 on a row that has seen only masked keys, so
      // its weights are exactly 1)
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2_approx((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < DB; ++i) {
        acc[i][0] *= corr[0];
        acc[i][1] *= corr[0];
        acc[i][2] *= corr[1];
        acc[i][3] *= corr[1];
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = exp2_approx((s[nb][e] - m[r]) * kLog2e);
          s[nb][e] = p;
          l[r] += p;
        }
      }

      // O += P V over the sub-step's 32 keys
#pragma unroll
      for (int kc = 0; kc < NB; ++kc) {
        uint32_t pb[4], psm[4];
        acc_a(pb, psm, s[kc]);
        const float* vr = vs + (c0 + kc * 8) * LD;
#pragma unroll
        for (int db = 0; db < DB; ++db) {
          uint32_t vb[2], vsm[2];
          frag_bz<LD>(vb, vsm, vr + db * 8, g, t);
          mma3(acc[db], pb, psm, vb, vsm);
        }
      }
    }
    __syncthreads();                   // this stage may be refilled
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  merge_softmax<S, R, DB>(m, l, acc, kv_s, rw, sw, lane);
  if (sw == 0) {
    float l_safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_safe[r] = fmaxf(l[r], kTiny);
      const int row = wq0 + g + 8 * r;
      if (t == 0 && row < dm.Lq)
        lse[(size_t)bh * dm.Lq + row] = m[r] + logf(l_safe[r]);
    }
#pragma unroll
    for (int i = 0; i < DB; ++i) {
      acc[i][0] /= l_safe[0];
      acc[i][1] /= l_safe[0];
      acc[i][2] /= l_safe[1];
      acc[i][3] /= l_safe[1];
    }
    store_acc<DB>(out, acc, b, h, wq0, dm.Lq, dm, g, t);
  }
}

// -------------------------------------------------------------------- dQ
// One CTA of 4 warps per (b*h, q tile of 16 R rows), looping over the k
// tiles up to the diagonal; warp (rw, sw) owns rows [16 rw, 16 rw + 16)
// and sub-steps sw, sw + S, ... of each k tile (S = 4 / R).
template <int DT, int R>
__global__ void __launch_bounds__(kThreads)
flash_dq_tc32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ mask,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     Dims dm) {
  constexpr int NT = kThreads, S = kWarps / R, ROWS = 16 * R;
  constexpr int LD = Smem<DT, R>::LD;
  constexpr int KD = DT / 8;         // k steps of 8 over the head dim
  constexpr int DB = DT / 8;         // 8-wide column blocks of dQ
  constexpr int NB = kSub / 8;       // 8-key column blocks per sub-step
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + ROWS * LD;
  float* kv_s = do_s + ROWS * LD;                      // [stage][K|V]
  float* m_s = kv_s + 4 * kBT * LD;                    // [stage] key mask

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp % R, sw = warp / R;
  const int g = lane / 4, t = lane % 4;
  const int bhn = dm.B * dm.H;
  const int n_qt = (dm.Lq + ROWS - 1) / ROWS;
  const int bh = blockIdx.x % bhn;
  const int q0 = (n_qt - 1 - blockIdx.x / bhn) * ROWS;   // longest first
  const int b = bh / dm.H, h = bh - b * dm.H;
  const int wq0 = q0 + rw * 16;
  const int q_last = min(q0 + ROWS, dm.Lq) - 1;
  const int k_end = dm.causal ? min(dm.Lk, q_last + 1) : dm.Lk;
  const int n_kt = (k_end + kBT - 1) / kBT;
  const float sl2 = dm.scale * kLog2e;

  auto load_kv = [&](int j) {
    float* ks = kv_s + (j & 1) * 2 * kBT * LD;
    load_tile<kBT, DT, NT>(ks, k, b, h, j * kBT, dm.Lk, dm);
    load_tile<kBT, DT, NT>(ks + kBT * LD, v, b, h, j * kBT, dm.Lk, dm);
    if (mask != nullptr) {
      for (int c = threadIdx.x; c < kBT; c += NT) {
        const int kpos = j * kBT + c;
        cp_async4(m_s + (j & 1) * kBT + c,
                  mask + (size_t)b * dm.Lk + min(kpos, dm.Lk - 1),
                  kpos < dm.Lk);
      }
    }
  };

  load_tile<ROWS, DT, NT>(q_s, q, b, h, q0, dm.Lq, dm);
  load_tile<ROWS, DT, NT>(do_s, dout, b, h, q0, dm.Lq, dm);
  if (n_kt > 0) load_kv(0);
  cp_async_commit();

  // per lane: rows g and g + 8 of the warp's 16; lse also in log2 units
  float lse_n[2], lse2[2], dl[2];
  bool row_in[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wq0 + g + 8 * i;
    row_in[i] = row < dm.Lq;
    const size_t at = (size_t)bh * dm.Lq + min(row, dm.Lq - 1);
    lse_n[i] = lse[at];
    lse2[i] = lse_n[i] * kLog2e;
    dl[i] = delta[at];
  }

  float acc[DB][4];
#pragma unroll
  for (int i = 0; i < DB; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const float* qw = q_s + rw * 16 * LD;
  const float* ow = do_s + rw * 16 * LD;

  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) load_kv(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* ks = kv_s + (j & 1) * 2 * kBT * LD;
    const float* vs = ks + kBT * LD;
    const float* ms = m_s + (j & 1) * kBT;
    const int k0 = j * kBT;

#pragma unroll 1
    for (int sub = sw; sub < kBT / kSub; sub += S) {
      const int c0 = sub * kSub;        // first key column of the sub-step
      // S = Q K^T and dP = dO V^T: the warp's 16 rows x 32 keys
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t qb[4], qsm[4], ob[4], osm[4];
        frag_a<LD>(qb, qsm, qw + kd * 8, g, t);
        frag_a<LD>(ob, osm, ow + kd * 8, g, t);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const int off = (c0 + nb * 8) * LD + kd * 8;
          uint32_t kb[2], ksm[2], vb[2], vsm[2];
          frag_bt<LD>(kb, ksm, ks + off, g, t);
          frag_bt<LD>(vb, vsm, vs + off, g, t);
          mma3(s[nb], qb, qsm, kb, ksm);
          mma3(dp[nb], ob, osm, vb, vsm);
        }
      }

      // P = exp(S - lse), dS = P (dP - Delta) scale
      const int kc0 = k0 + c0;
      const bool edge = (dm.causal && kc0 + kSub - 1 > wq0) ||
                        kc0 + kSub > dm.Lk || wq0 + 16 > dm.Lq ||
                        mask != nullptr;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p;
          if (!edge) {
            p = exp2_approx(fmaf(s[nb][e], sl2, -lse2[r]));
          } else {
            const int col = c0 + nb * 8 + 2 * t + (e & 1);
            const int kpos = k0 + col, qpos = wq0 + g + 8 * r;
            if (!row_in[r] || kpos >= dm.Lk)
              p = 0.f;
            else if ((dm.causal && qpos < kpos) ||
                     (mask != nullptr && !(ms[col] > 0.f)))
              p = expf(kNegInf - lse_n[r]);   // 1 on a row with no
                                              // valid key
            else
              p = exp2_approx(fmaf(s[nb][e], sl2, -lse2[r]));
          }
          dp[nb][e] = p * (dp[nb][e] - dl[r]) * dm.scale;
        }
      }

      // dQ += dS K over the sub-step's 32 keys
#pragma unroll
      for (int kc = 0; kc < NB; ++kc) {
        uint32_t sb[4], ssm[4];
        acc_a(sb, ssm, dp[kc]);
        const float* kr = ks + (c0 + kc * 8) * LD;
#pragma unroll
        for (int db = 0; db < DB; ++db) {
          uint32_t kb[2], ksm[2];
          frag_bz<LD>(kb, ksm, kr + db * 8, g, t);
          mma3(acc[db], sb, ssm, kb, ksm);
        }
      }
    }
    __syncthreads();                   // this stage may be refilled
  }
  cp_async_wait<0>();
  reduce_splits<S, R, DB>(acc, kv_s, rw, sw, lane);
  if (sw == 0) store_acc<DB>(dq, acc, b, h, wq0, dm.Lq, dm, g, t);
}

// ----------------------------------------------------------------- dK/dV
// One CTA of 4 warps per (b*h, k tile of 16 R keys), looping over the q
// tiles from the diagonal; warp (rw, sw) owns keys [16 rw, 16 rw + 16)
// and sub-steps sw, sw + S, ... of each q tile (S = 4 / R).
template <int DT, int R>
__global__ void __launch_bounds__(kThreads)
flash_dkv_tc32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ mask,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      Dims dm) {
  constexpr int NT = kThreads, S = kWarps / R, ROWS = 16 * R;
  constexpr int LD = Smem<DT, R>::LD;
  constexpr int KD = DT / 8;
  constexpr int DB = DT / 8;
  constexpr int NB = kSub / 8;       // 8-wide q column blocks per sub-step
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + ROWS * LD;
  float* qd_s = v_s + ROWS * LD;                       // [stage][Q|dO]
  float* st_s = qd_s + 4 * kBT * LD;                   // [stage][lse|Delta]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp % R, sw = warp / R;
  const int g = lane / 4, t = lane % 4;
  const int bhn = dm.B * dm.H;
  const int bh = blockIdx.x % bhn;
  const int k0 = (blockIdx.x / bhn) * ROWS;               // longest first
  const int b = bh / dm.H, h = bh - b * dm.H;
  const int wk0 = k0 + rw * 16;
  // causal: the staged q tile holding row k0 is the first that sees it
  const int q_start = dm.causal ? (k0 / kBT) * kBT : 0;
  const int n_qt = q_start < dm.Lq ? (dm.Lq - q_start + kBT - 1) / kBT : 0;
  const float sl2 = dm.scale * kLog2e;

  auto load_q = [&](int i) {
    const int q0 = q_start + i * kBT;
    float* qs = qd_s + (i & 1) * 2 * kBT * LD;
    load_tile<kBT, DT, NT>(qs, q, b, h, q0, dm.Lq, dm);
    load_tile<kBT, DT, NT>(qs + kBT * LD, dout, b, h, q0, dm.Lq, dm);
    float* ss = st_s + (i & 1) * 2 * kBT;
    for (int c = threadIdx.x; c < 2 * kBT; c += NT) {
      const int row = q0 + c % kBT;
      cp_async4(ss + c,
                (c < kBT ? lse : delta) + (size_t)bh * dm.Lq +
                    min(row, dm.Lq - 1),
                row < dm.Lq);
    }
  };

  load_tile<ROWS, DT, NT>(k_s, k, b, h, k0, dm.Lk, dm);
  load_tile<ROWS, DT, NT>(v_s, v, b, h, k0, dm.Lk, dm);
  if (n_qt > 0) load_q(0);
  cp_async_commit();

  // validity of the warp's two key rows per lane (g and g + 8)
  bool key_in[2], key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = wk0 + g + 8 * i;
    key_in[i] = kpos < dm.Lk;
    key_ok[i] = key_in[i] &&
                (mask == nullptr || mask[(size_t)b * dm.Lk + kpos] > 0.f);
  }

  float dk_acc[DB][4], dv_acc[DB][4];
#pragma unroll
  for (int i = 0; i < DB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  const float* kw = k_s + rw * 16 * LD;
  const float* vw = v_s + rw * 16 * LD;

  for (int it = 0; it < n_qt; ++it) {
    if (it + 1 < n_qt) load_q(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = q_start + it * kBT;
    const float* qs = qd_s + (it & 1) * 2 * kBT * LD;
    const float* dos = qs + kBT * LD;
    const float* lse_s = st_s + (it & 1) * 2 * kBT;
    const float* dl_s = lse_s + kBT;

#pragma unroll 1
    for (int sub = sw; sub < kBT / kSub; sub += S) {
      const int c0 = sub * kSub;        // first q column of the sub-step
      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 32 q rows
      float st[NB][4], dpt[NB][4];
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t kb[4], ksm[4], vb[4], vsm[4];
        frag_a<LD>(kb, ksm, kw + kd * 8, g, t);
        frag_a<LD>(vb, vsm, vw + kd * 8, g, t);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const int off = (c0 + nb * 8) * LD + kd * 8;
          uint32_t qb[2], qsm[2], ob[2], osm[2];
          frag_bt<LD>(qb, qsm, qs + off, g, t);
          frag_bt<LD>(ob, osm, dos + off, g, t);
          mma3(st[nb], kb, ksm, qb, qsm);
          mma3(dpt[nb], vb, vsm, ob, osm);
        }
      }

      // P^T = exp(S^T - lse), dS^T = P^T (dP^T - Delta) scale
      const bool edge = (dm.causal && q0 + c0 < wk0 + 15) ||
                        q0 + c0 + kSub > dm.Lq || wk0 + 16 > dm.Lk ||
                        mask != nullptr;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + nb * 8 + 2 * t + (e & 1);
          const float l = lse_s[col];
          float p;
          if (!edge) {
            p = exp2_approx(fmaf(st[nb][e], sl2, -l * kLog2e));
          } else {
            const int r = e >> 1;
            const int qpos = q0 + col, kpos = wk0 + g + 8 * r;
            if (qpos >= dm.Lq || !key_in[r])
              p = 0.f;
            else if (!key_ok[r] || (dm.causal && qpos < kpos))
              p = expf(kNegInf - l);     // 1 on a row with no valid key
            else
              p = exp2_approx(fmaf(st[nb][e], sl2, -l * kLog2e));
          }
          st[nb][e] = p;
          dpt[nb][e] = p * (dpt[nb][e] - dl_s[col]) * dm.scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q over the sub-step's 32 q rows
#pragma unroll
      for (int kc = 0; kc < NB; ++kc) {
        uint32_t pb[4], psm[4], sb[4], ssm[4];
        acc_a(pb, psm, st[kc]);
        acc_a(sb, ssm, dpt[kc]);
        const float* orow = dos + (c0 + kc * 8) * LD;
        const float* qrow = qs + (c0 + kc * 8) * LD;
#pragma unroll
        for (int db = 0; db < DB; ++db) {
          uint32_t ob[2], osm[2], qb[2], qsm[2];
          frag_bz<LD>(ob, osm, orow + db * 8, g, t);
          frag_bz<LD>(qb, qsm, qrow + db * 8, g, t);
          mma3(dv_acc[db], pb, psm, ob, osm);
          mma3(dk_acc[db], sb, ssm, qb, qsm);
        }
      }
    }
    __syncthreads();                   // this stage may be refilled
  }
  cp_async_wait<0>();
  reduce_splits<S, R, DB>(dk_acc, qd_s, rw, sw, lane);
  reduce_splits<S, R, DB>(dv_acc, qd_s + (S - 1) * R * DB * 4 * 32, rw, sw,
                          lane);
  if (sw == 0) {
    store_acc<DB>(dk, dk_acc, b, h, wk0, dm.Lk, dm, g, t);
    store_acc<DB>(dv, dv_acc, b, h, wk0, dm.Lk, dm, g, t);
  }
}

// --------------------------------------------------------------- launchers
template <typename Kern>
cudaError_t prepare(Kern kern, int bytes) {
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return cudaSuccess;
}

struct Ptrs {
  const float *q, *k, *v, *mask, *dout, *lse, *delta;
  float *dq, *dk, *dv, *out, *lse_out;
};

template <int DT, int R>
cudaError_t run(int which, const Ptrs& p, const Dims& dm, cudaStream_t st) {
  using S = Smem<DT, R>;
  constexpr int ROWS = 16 * R;
  const int bh = dm.B * dm.H;
  cudaError_t err;
  if (which == 2) {
    auto kern = flash_fwd_tc32_kernel<DT, R>;
    if ((err = prepare(kern, S::fwd)) != cudaSuccess) return err;
    const int grid = bh * ((dm.Lq + ROWS - 1) / ROWS);
    kern<<<grid, kThreads, S::fwd, st>>>(p.q, p.k, p.v, p.mask, p.out,
                                        p.lse_out, dm);
  } else if (which == 1) {
    auto kern = flash_dkv_tc32_kernel<DT, R>;
    if ((err = prepare(kern, S::dkv)) != cudaSuccess) return err;
    const int grid = bh * ((dm.Lk + ROWS - 1) / ROWS);
    kern<<<grid, kThreads, S::dkv, st>>>(p.q, p.k, p.v, p.mask, p.dout, p.lse,
                                        p.delta, p.dk, p.dv, dm);
  } else {
    auto kern = flash_dq_tc32_kernel<DT, R>;
    if ((err = prepare(kern, S::dq)) != cudaSuccess) return err;
    const int grid = bh * ((dm.Lq + ROWS - 1) / ROWS);
    kern<<<grid, kThreads, S::dq, st>>>(p.q, p.k, p.v, p.mask, p.dout, p.lse,
                                       p.delta, p.dq, dm);
  }
  return cudaGetLastError();
}

template <int DT>
cudaError_t by_rows(int which, const Ptrs& p, const Dims& dm, int rows,
                    cudaStream_t st) {
  if (rows == 64) return run<DT, 4>(which, p, dm, st);
  return run<DT, 2>(which, p, dm, st);     // two warps per row slab
}

// Head-dim tiers DT = 64 (D <= 64) and 128, and rows = 16 W per CTA of 64
// or 32 (the wrapper's _tc32_rows); smem_bytes mirrors the sizes.
int dispatch(int which, const Ptrs& p, int B, int H, int Lq, int Lk, int D,
             float scale, int causal, int rows, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || D < 16 || D > 128 ||
      D % 16 != 0 || (rows != 32 && rows != 64))
    return (int)cudaErrorInvalidValue;
  const Dims dm{B, H, Lq, Lk, D, scale, causal ? 1 : 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return (int)by_rows<64>(which, p, dm, rows, st);
  return (int)by_rows<128>(which, p, dm, rows, st);
}

}  // namespace

extern "C" {

// q: (B, Lq, H, D), k/v: (B, Lk, H, D) f32 with D a multiple of 16 in
// [16, 128]; mask: (B, Lk) f32 key validity, or null for all keys valid;
// lse/delta: (B, H, Lq) f32; rows: 64 or 32 rows per CTA.  All contiguous,
// 16-byte aligned and on the current device.  Each launches on `stream`
// and returns the launch's cudaError_t (0 = launched); none synchronizes.

// out: (B, Lq, H, D) f32; lse: (B, H, Lq) f32 (written).
int flash_fwd_tc32_launch(const void* q, const void* k, const void* v,
                          const void* mask, void* out, void* lse, int B,
                          int H, int Lq, int Lk, int D, float scale,
                          int causal, int rows, void* stream) {
  auto f = [](const void* x) { return static_cast<const float*>(x); };
  Ptrs p{f(q), f(k), f(v), f(mask), nullptr, nullptr, nullptr, nullptr,
         nullptr, nullptr, static_cast<float*>(out), static_cast<float*>(lse)};
  return dispatch(2, p, B, H, Lq, Lk, D, scale, causal, rows, stream);
}

// dq: (B, Lq, H, D) f32.
int flash_dq_tc32_launch(const void* q, const void* k, const void* v,
                         const void* mask, const void* dout, const void* lse,
                         const void* delta, void* dq, int B, int H, int Lq,
                         int Lk, int D, float scale, int causal, int rows,
                         void* stream) {
  auto f = [](const void* x) { return static_cast<const float*>(x); };
  Ptrs p{f(q), f(k), f(v), f(mask), f(dout), f(lse), f(delta),
         static_cast<float*>(dq), nullptr, nullptr, nullptr, nullptr};
  return dispatch(0, p, B, H, Lq, Lk, D, scale, causal, rows, stream);
}

// dk/dv: (B, Lk, H, D) f32.
int flash_dkv_tc32_launch(const void* q, const void* k, const void* v,
                          const void* mask, const void* dout,
                          const void* lse, const void* delta, void* dk,
                          void* dv, int B, int H, int Lq, int Lk, int D,
                          float scale, int causal, int rows, void* stream) {
  auto f = [](const void* x) { return static_cast<const float*>(x); };
  Ptrs p{f(q), f(k), f(v), f(mask), f(dout), f(lse), f(delta), nullptr,
         static_cast<float*>(dk), static_cast<float*>(dv), nullptr, nullptr};
  return dispatch(1, p, B, H, Lq, Lk, D, scale, causal, rows, stream);
}

}  // extern "C"
