// Exact attention on Hopper's tensor cores: the forward, dQ and dK/dV
// kernels for bf16 inputs with head_dim a multiple of 16 up to 128.
//
//   flash_fwd_tc_kernel  <- _fwd_kernel (launched by _fwd, the pl.pallas_call
//                           at distributed_tensorflow_tpu/ops/
//                           flash_attention.py:170)
//   flash_dq_tc_kernel   <- _dq_kernel (launched by _bwd,
//                           flash_attention.py:281)
//   flash_dkv_tc_kernel  <- _dkv_kernel (launched by _bwd,
//                           flash_attention.py:299)
//
// They compute the function of flash_attention.cu's flash_fwd_kernel,
// flash_dq_kernel and flash_dkv_kernel (which stay the route for f32
// inputs, and so for flash_bwd_block, and for other head dims):
// S = scale * Q K^T; a causal mask by absolute position and a
// key-validity mask score NEG_INF = -1e30, never -inf, so a row with no
// valid key gets the mean of V over the keys it visits; a key past Lk
// scores -inf (weight exactly 0); a row past Lq writes nothing and adds
// nothing to dK/dV.  Ragged and cross lengths are masked here, not padded.
// Tensors stay in the model's (B, L, H, D) layout; lse and Delta are
// (B, H, Lq) f32; O, dQ, dK and dV are written in bf16.
//
// What bounds them on this card: at the training slice's shape (B*H = 64,
// L = 1024, D = 64, causal) the forward moves about 34 MB and does about
// 8.6 GFLOP, so its bound is the ~10 us of memory traffic at 3.35 TB/s;
// dQ does about 13 GFLOP and dK/dV about 17 GFLOP, ~13 and ~17 us at
// 989 TFLOP/s of bf16 tensor cores.
// All are far from the 67 TFLOP/s f32 CUDA-core peak that bounds the
// SIMT kernels; here every product runs on the tensor cores, and what is
// left is feeding them and the softmax's exponentials.
//
// What the design does about it (FlashAttention-2's structure on mma.sync;
// wgmma with TMA staging is not used here):
// - CTAs of 4 warps; in the forward and dQ a CTA owns 64 query rows and
//   each warp 16 of them, in dK/dV a CTA owns 64 keys and each warp 16 of
//   them.
// - Products are mma.sync.m16n8k16 with bf16 operands and f32 accumulators.
//   Fragments come from shared memory with ldmatrix (.trans for the
//   operands whose reduction runs along rows: V in P V, dO and Q in
//   P^T dO and dS^T Q, K in dS K).  Rows are padded by 8 bf16 (16 bytes),
//   so the 8 row addresses of one ldmatrix fall in 8 different bank
//   groups.  Each warp's Q fragments (forward) and, at head_dim <= 64, its
//   Q and dO fragments (dQ) and its K and V fragments (dK/dV) are read
//   once and kept in registers.
// - Tiles are copied straight from the (B, L, H, D) layout with 16-byte
//   cp.async.cg, zero-filled past Lq, Lk and D, into two shared-memory
//   stages: tile j+1 is in flight while tile j is consumed.
// - The forward keeps the online softmax's max and sum in registers (the
//   4 lanes of a quad share a row; max reduced with __shfl_xor_sync, the
//   sum once at the end), works in log2 units with ex2.approx, and rounds
//   P to bf16 in registers, where it is already laid out as the A fragment
//   of P V: P never goes through shared memory.  lse is written in natural
//   log units.  dK/dV recomputes P^T = exp(S^T - lse) and
//   dS^T = P^T * (dP^T - Delta) * scale in registers and rounds both to
//   bf16 as the A fragments of dV += P^T dO and dK += dS^T Q.  dQ is the
//   forward's loop with the online softmax replaced by the known lse:
//   P = exp(S - lse), dP = dO V^T and dS = P (dP - Delta) scale in
//   registers, dS rounded to bf16 as the A fragment of dQ += dS K, over
//   32-key sub-steps of each key tile (registers).
// - Occupancy over registers at head_dim <= 64: the forward is held to 128
//   registers (4 CTAs per SM), dQ to 128 (4 CTAs per SM) and dK/dV to
//   168 (3 CTAs per SM), at the
//   cost of a few spilled bytes (ptxas -v; PERF.md has the figures): with
//   fewer resident warps the ldmatrix and mma latencies are not hidden.
// - Under the causal mask, tiles wholly in the future are skipped and only
//   tiles crossing the diagonal take the per-element mask; the CTAs with
//   the most tiles to visit are launched first (the last q tiles in the
//   forward and dQ, the first k tiles in dK/dV), so the last wave is short.
// P and dS rounded to bf16 are one rounding more than the SIMT kernels'
// f32 P; the tests state the tolerance that needs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;   // matches parallel.ring_attention.NEG_INF
constexpr float kTiny = 1e-30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;           // q rows and keys per tile
constexpr int kPad = 8;             // bf16 of padding per shared-memory row
constexpr int kSub = 32;            // q (dK/dV) or key (dQ) columns per
                                    // sub-step

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16, `lo` in the low half (lower column)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16 x 16 product whose k axis is the n axis of two
// neighbouring 16 x 8 accumulators (P -> P V, P^T -> P^T dO).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// 2^x (ex2.approx.ftz: relative error 2^-22, subnormal results flushed to
// 0 -- far below the bf16 rounding the products apply after it)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Shared-memory row stride (bf16) and sizes (bytes) of each kernel.
template <int DT>
struct Smem {
  static constexpr int LD = DT + kPad;
  static constexpr int tile = kTile * LD * 2;
  // Q; 2 stages of (K, V); 2 stages of the key mask
  static constexpr int fwd = tile + 4 * tile + 2 * kTile * 4;
  // K, V; 2 stages of (Q, dO); 2 stages of (lse, Delta)
  static constexpr int dkv = 2 * tile + 4 * tile + 4 * kTile * 4;
  // Q, dO; 2 stages of (K, V); 2 stages of the key mask
  static constexpr int dq = 2 * tile + 4 * tile + 2 * kTile * 4;
};

// Stage rows [r0, r0 + kTile) of head (b, h) of a (B, L, H, D) bf16 tensor
// into shared memory with row stride LD; rows past L and columns past D
// are zero-filled.  Asynchronous: the caller commits and waits.
template <int DT>
__device__ __forceinline__ void load_tile(bf16* dst,
                                          const bf16* __restrict__ src, int b,
                                          int h, int r0, int L,
                                          const Dims& dm) {
  constexpr int LD = Smem<DT>::LD;
  constexpr int kChunks = DT / 8;               // 16-byte chunks per row
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    const int row = r0 + r;
    const bool ok = row < L && c < dm.D;
    const bf16* g =
        ok ? src + (((size_t)b * L + row) * dm.H + h) * dm.D + c : src;
    cp_async16(dst + r * LD + c, g, ok);
  }
}

// Write a warp's 16 rows of a tile, already in shared memory at `s` (row
// stride LD), to rows [r0, r0 + 16) of head (b, h) in 16-byte stores.
template <int DT>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const bf16* s, int b, int h, int r0,
                                           int L, const Dims& dm, int lane) {
  constexpr int LD = Smem<DT>::LD;
  constexpr int kChunks = DT / 8;
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    const int row = r0 + r;
    if (row < L && c < dm.D)
      *reinterpret_cast<uint4*>(dst + (((size_t)b * L + row) * dm.H + h) *
                                          dm.D + c) =
          *reinterpret_cast<const uint4*>(s + r * LD + c);
  }
}

// ---------------------------------------------------------------- forward
// One CTA per (b*h, q tile of 64 rows), looping over the k tiles.
template <int DT>
__global__ void __launch_bounds__(kThreads, DT == 64 ? 4 : 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ mask,
                    bf16* __restrict__ out, float* __restrict__ lse, Dims dm) {
  constexpr int LD = Smem<DT>::LD;
  constexpr int KD = DT / 16;        // k steps over the head dim
  constexpr int NB = kTile / 8;      // 8-key column blocks of S
  constexpr int DB = DT / 8;         // 8-wide column blocks of O
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = q_s + kTile * LD;                         // [stage][K|V]
  float* m_s = reinterpret_cast<float*>(kv_s + 4 * kTile * LD);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bhn = dm.B * dm.H;
  const int n_qt = (dm.Lq + kTile - 1) / kTile;
  const int bh = blockIdx.x % bhn;
  const int q0 = (n_qt - 1 - blockIdx.x / bhn) * kTile;   // longest first
  const int b = bh / dm.H, h = bh - b * dm.H;
  const int wq0 = q0 + warp * 16;
  const int q_last = min(q0 + kTile, dm.Lq) - 1;
  const int k_end = dm.causal ? min(dm.Lk, q_last + 1) : dm.Lk;
  const int n_kt = (k_end + kTile - 1) / kTile;
  const float sl2 = dm.scale * kLog2e;

  auto load_kv = [&](int j) {
    bf16* ks = kv_s + (j & 1) * 2 * kTile * LD;
    load_tile<DT>(ks, k, b, h, j * kTile, dm.Lk, dm);
    load_tile<DT>(ks + kTile * LD, v, b, h, j * kTile, dm.Lk, dm);
    if (mask != nullptr && threadIdx.x < kTile) {
      const int kpos = j * kTile + threadIdx.x;
      cp_async4(m_s + (j & 1) * kTile + threadIdx.x,
                mask + (size_t)b * dm.Lk + min(kpos, dm.Lk - 1),
                kpos < dm.Lk);
    }
  };

  load_tile<DT>(q_s, q, b, h, q0, dm.Lq, dm);
  load_kv(0);
  cp_async_commit();

  // per lane: rows g and g + 8 of the warp's 16
  uint32_t qf[KD][4];
  float o[DB][4];
#pragma unroll
  for (int i = 0; i < DB; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) load_kv(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldsm_x4(qf[kd], q_s + (warp * 16 + lane % 16) * LD + kd * 16 +
                            (lane / 16) * 8);
    }
    const bf16* ks = kv_s + (j & 1) * 2 * kTile * LD;
    const bf16* vs = ks + kTile * LD;
    const float* ms = m_s + (j & 1) * kTile;
    const int k0 = j * kTile;

    // S = Q K^T for the warp's 16 rows x 64 keys
    float s[NB][4];
#pragma unroll
    for (int i = 0; i < NB; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, ks + (nb * 8 + lane % 8 + (lane / 16) * 8) * LD +
                        kd * 16 + ((lane / 8) % 2) * 8);
        mma(s[nb], qf[kd], bk[0], bk[1]);
        mma(s[nb + 1], qf[kd], bk[2], bk[3]);
      }
    }

    // scores in log2 units; masks only where this warp's tile needs them
    const bool edge = (dm.causal && k0 + kTile - 1 > wq0) ||
                      k0 + kTile > dm.Lk || mask != nullptr;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * sl2;
        if (edge) {
          const int col = nb * 8 + 2 * t + (e & 1);
          const int kpos = k0 + col, qpos = wq0 + g + (e >> 1) * 8;
          if (kpos >= dm.Lk)
            x = __int_as_float(0xff800000);      // -inf: no weight at all
          else if ((dm.causal && qpos < kpos) ||
                   (mask != nullptr && !(ms[col] > 0.f)))
            x = kNegInf;
        }
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      corr[i] = exp2_approx(m_r[i] - mx[i]);
      m_r[i] = mx[i];
      l_r[i] *= corr[i];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(s[nb][e] - m_r[e >> 1]);
        s[nb][e] = p;
        l_r[e >> 1] += p;              // this lane's part; quad sum at the end
      }
    }
#pragma unroll
    for (int i = 0; i < DB; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[0];
      o[i][2] *= corr[1];
      o[i][3] *= corr[1];
    }

    // O += P V, P rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int db = 0; db < DB; db += 2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                          db * 8 + (lane / 16) * 8);
        mma(o[db], pa, bv[0], bv[1]);
        mma(o[db + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();                   // this stage may be refilled
  }

  // O / l through the warp's own rows of q_s, then 16-byte stores
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] = fmaxf(quad_sum(l_r[i]), kTiny);
    inv[i] = 1.f / l_r[i];
  }
  bf16* os = q_s + warp * 16 * LD;
#pragma unroll
  for (int db = 0; db < DB; ++db) {
    const int c = db * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(os + g * LD + c) =
        __floats2bfloat162_rn(o[db][0] * inv[0], o[db][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * LD + c) =
        __floats2bfloat162_rn(o[db][2] * inv[1], o[db][3] * inv[1]);
  }
  __syncwarp();
  store_rows<DT>(out, os, b, h, wq0, dm.Lq, dm, lane);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wq0 + g + 8 * i;
      // a row whose every visited key is masked keeps m = NEG_INF exactly
      const float m_nat = m_r[i] == kNegInf ? kNegInf : m_r[i] * kLn2;
      if (row < dm.Lq) lse[(size_t)bh * dm.Lq + row] = m_nat + logf(l_r[i]);
    }
  }
}

// ----------------------------------------------------------------- dK/dV
// One CTA per (b*h, k tile of 64 keys), looping over the q tiles.  With
// KREG the warp's K and V fragments are read from shared memory once and
// kept in registers; without, they are read again for every sub-step.
template <int DT, bool KREG>
__global__ void __launch_bounds__(kThreads, DT == 64 ? 3 : 1)
flash_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ mask,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, Dims dm) {
  constexpr int LD = Smem<DT>::LD;
  constexpr int KD = DT / 16;
  constexpr int DB = DT / 8;
  constexpr int NB = kSub / 8;       // 8-wide q column blocks per sub-step
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kTile * LD;
  bf16* qd_s = v_s + kTile * LD;                          // [stage][Q|dO]
  // [stage][lse|Delta]
  float* st_s = reinterpret_cast<float*>(qd_s + 4 * kTile * LD);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bhn = dm.B * dm.H;
  const int bh = blockIdx.x % bhn;
  const int k0 = (blockIdx.x / bhn) * kTile;              // longest first
  const int b = bh / dm.H, h = bh - b * dm.H;
  const int wk0 = k0 + warp * 16;
  // causal: the q tile holding row k0 is the first that sees this k tile
  const int q_start = dm.causal ? (k0 / kTile) * kTile : 0;
  const int n_qt = q_start < dm.Lq ? (dm.Lq - q_start + kTile - 1) / kTile : 0;
  const float sl2 = dm.scale * kLog2e;

  auto load_q = [&](int i) {
    const int q0 = q_start + i * kTile;
    bf16* qs = qd_s + (i & 1) * 2 * kTile * LD;
    load_tile<DT>(qs, q, b, h, q0, dm.Lq, dm);
    load_tile<DT>(qs + kTile * LD, dout, b, h, q0, dm.Lq, dm);
    float* ss = st_s + (i & 1) * 2 * kTile;
    const int r = threadIdx.x % kTile, row = q0 + r;
    const float* src = threadIdx.x < kTile ? lse : delta;
    cp_async4(ss + (threadIdx.x < kTile ? 0 : kTile) + r,
              src + (size_t)bh * dm.Lq + min(row, dm.Lq - 1), row < dm.Lq);
  };

  load_tile<DT>(k_s, k, b, h, k0, dm.Lk, dm);
  load_tile<DT>(v_s, v, b, h, k0, dm.Lk, dm);
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

  const bf16* kw = k_s + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  const bf16* vw = v_s + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  uint32_t kf[KREG ? KD : 1][4], vf[KREG ? KD : 1][4];

  for (int it = 0; it < n_qt; ++it) {
    if (it + 1 < n_qt) load_q(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = q_start + it * kTile;
    const bf16* qs = qd_s + (it & 1) * 2 * kTile * LD;
    const bf16* dos = qs + kTile * LD;
    const float* lse_s = st_s + (it & 1) * 2 * kTile;
    const float* dl_s = lse_s + kTile;
    if constexpr (KREG) {
      if (it == 0) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          ldsm_x4(kf[kd], kw + kd * 16);
          ldsm_x4(vf[kd], vw + kd * 16);
        }
      }
    }

#pragma unroll
    for (int sub = 0; sub < kTile / kSub; ++sub) {
      const int c0 = sub * kSub;        // first q column of the sub-step
      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 32 q rows
      float st[NB][4], dpt[NB][4];
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t ka[4], va[4];
        if constexpr (KREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ka[i] = kf[kd][i];
            va[i] = vf[kd][i];
          }
        } else {
          ldsm_x4(ka, kw + kd * 16);
          ldsm_x4(va, vw + kd * 16);
        }
#pragma unroll
        for (int nb = 0; nb < NB; nb += 2) {
          const int off = (c0 + nb * 8 + lane % 8 + (lane / 16) * 8) * LD +
                          kd * 16 + ((lane / 8) % 2) * 8;
          uint32_t bq[4], bo[4];
          ldsm_x4(bq, qs + off);
          ldsm_x4(bo, dos + off);
          mma(st[nb], ka, bq[0], bq[1]);
          mma(st[nb + 1], ka, bq[2], bq[3]);
          mma(dpt[nb], va, bo[0], bo[1]);
          mma(dpt[nb + 1], va, bo[2], bo[3]);
        }
      }

      // P^T = exp(S^T - lse), dS^T = P^T (dP^T - Delta) scale
      const bool edge = (dm.causal && q0 + c0 < wk0 + 15) ||
                        q0 + c0 + kSub > dm.Lq || k0 + kTile > dm.Lk ||
                        mask != nullptr;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + nb * 8 + 2 * t + (e & 1);
          const float l = lse_s[col];
          float p;
          if (!edge) {
            p = exp2_approx(st[nb][e] * sl2 - l * kLog2e);
          } else {
            const int r = e >> 1;
            const int qpos = q0 + col, kpos = wk0 + g + 8 * r;
            if (qpos >= dm.Lq || !key_in[r])
              p = 0.f;
            else if (!key_ok[r] || (dm.causal && qpos < kpos))
              p = expf(kNegInf - l);     // 1 on a row with no valid key
            else
              p = exp2_approx(st[nb][e] * sl2 - l * kLog2e);
          }
          st[nb][e] = p;
          dpt[nb][e] = p * (dpt[nb][e] - dl_s[col]) * dm.scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q over the sub-step's 32 q rows
#pragma unroll
      for (int kc = 0; kc < kSub / 16; ++kc) {
        uint32_t pa[4], da[4];
        acc_to_a(pa, st[2 * kc], st[2 * kc + 1]);
        acc_to_a(da, dpt[2 * kc], dpt[2 * kc + 1]);
        const int row = c0 + kc * 16 + lane % 8 + ((lane / 8) % 2) * 8;
#pragma unroll
        for (int db = 0; db < DB; db += 2) {
          const int off = row * LD + db * 8 + (lane / 16) * 8;
          uint32_t bo[4], bq[4];
          ldsm_x4_t(bo, dos + off);
          ldsm_x4_t(bq, qs + off);
          mma(dv_acc[db], pa, bo[0], bo[1]);
          mma(dv_acc[db + 1], pa, bo[2], bo[3]);
          mma(dk_acc[db], da, bq[0], bq[1]);
          mma(dk_acc[db + 1], da, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();                   // this stage may be refilled
  }

  // dK and dV through the warp's own rows of k_s / v_s, then 16-byte stores
  cp_async_wait<0>();
  __syncthreads();
  bf16* ks = k_s + warp * 16 * LD;
  bf16* vs = v_s + warp * 16 * LD;
#pragma unroll
  for (int db = 0; db < DB; ++db) {
    const int c = db * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(ks + g * LD + c) =
        __floats2bfloat162_rn(dk_acc[db][0], dk_acc[db][1]);
    *reinterpret_cast<__nv_bfloat162*>(ks + (g + 8) * LD + c) =
        __floats2bfloat162_rn(dk_acc[db][2], dk_acc[db][3]);
    *reinterpret_cast<__nv_bfloat162*>(vs + g * LD + c) =
        __floats2bfloat162_rn(dv_acc[db][0], dv_acc[db][1]);
    *reinterpret_cast<__nv_bfloat162*>(vs + (g + 8) * LD + c) =
        __floats2bfloat162_rn(dv_acc[db][2], dv_acc[db][3]);
  }
  __syncwarp();
  store_rows<DT>(dk, ks, b, h, wk0, dm.Lk, dm, lane);
  store_rows<DT>(dv, vs, b, h, wk0, dm.Lk, dm, lane);
}

// -------------------------------------------------------------------- dQ
// One CTA per (b*h, q tile of 64 rows), looping over the k tiles up to the
// diagonal.  With QREG the warp's Q and dO fragments are read from shared
// memory once and kept in registers; without, they are read again for
// every sub-step.
template <int DT, bool QREG>
__global__ void __launch_bounds__(kThreads, DT == 64 ? 4 : 1)
flash_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ mask,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   Dims dm) {
  constexpr int LD = Smem<DT>::LD;
  constexpr int KD = DT / 16;
  constexpr int DB = DT / 8;
  constexpr int NB = kSub / 8;       // 8-key column blocks per sub-step
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kTile * LD;
  bf16* kv_s = do_s + kTile * LD;                         // [stage][K|V]
  float* m_s = reinterpret_cast<float*>(kv_s + 4 * kTile * LD);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bhn = dm.B * dm.H;
  const int n_qt = (dm.Lq + kTile - 1) / kTile;
  const int bh = blockIdx.x % bhn;
  const int q0 = (n_qt - 1 - blockIdx.x / bhn) * kTile;   // longest first
  const int b = bh / dm.H, h = bh - b * dm.H;
  const int wq0 = q0 + warp * 16;
  const int q_last = min(q0 + kTile, dm.Lq) - 1;
  const int k_end = dm.causal ? min(dm.Lk, q_last + 1) : dm.Lk;
  const int n_kt = (k_end + kTile - 1) / kTile;
  const float sl2 = dm.scale * kLog2e;

  auto load_kv = [&](int j) {
    bf16* ks = kv_s + (j & 1) * 2 * kTile * LD;
    load_tile<DT>(ks, k, b, h, j * kTile, dm.Lk, dm);
    load_tile<DT>(ks + kTile * LD, v, b, h, j * kTile, dm.Lk, dm);
    if (mask != nullptr && threadIdx.x < kTile) {
      const int kpos = j * kTile + threadIdx.x;
      cp_async4(m_s + (j & 1) * kTile + threadIdx.x,
                mask + (size_t)b * dm.Lk + min(kpos, dm.Lk - 1),
                kpos < dm.Lk);
    }
  };

  load_tile<DT>(q_s, q, b, h, q0, dm.Lq, dm);
  load_tile<DT>(do_s, dout, b, h, q0, dm.Lq, dm);
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

  float dq_acc[DB][4];
#pragma unroll
  for (int i = 0; i < DB; ++i)
    dq_acc[i][0] = dq_acc[i][1] = dq_acc[i][2] = dq_acc[i][3] = 0.f;

  const bf16* qw = q_s + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  const bf16* ow = do_s + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  uint32_t qf[QREG ? KD : 1][4], of[QREG ? KD : 1][4];

  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) load_kv(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (QREG) {
      if (j == 0) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          ldsm_x4(qf[kd], qw + kd * 16);
          ldsm_x4(of[kd], ow + kd * 16);
        }
      }
    }
    const bf16* ks = kv_s + (j & 1) * 2 * kTile * LD;
    const bf16* vs = ks + kTile * LD;
    const float* ms = m_s + (j & 1) * kTile;
    const int k0 = j * kTile;

#pragma unroll
    for (int sub = 0; sub < kTile / kSub; ++sub) {
      const int c0 = sub * kSub;        // first key column of the sub-step
      // S = Q K^T and dP = dO V^T: the warp's 16 rows x 32 keys
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t qa[4], oa[4];
        if constexpr (QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            qa[i] = qf[kd][i];
            oa[i] = of[kd][i];
          }
        } else {
          ldsm_x4(qa, qw + kd * 16);
          ldsm_x4(oa, ow + kd * 16);
        }
#pragma unroll
        for (int nb = 0; nb < NB; nb += 2) {
          const int off = (c0 + nb * 8 + lane % 8 + (lane / 16) * 8) * LD +
                          kd * 16 + ((lane / 8) % 2) * 8;
          uint32_t bk[4], bv[4];
          ldsm_x4(bk, ks + off);
          ldsm_x4(bv, vs + off);
          mma(s[nb], qa, bk[0], bk[1]);
          mma(s[nb + 1], qa, bk[2], bk[3]);
          mma(dp[nb], oa, bv[0], bv[1]);
          mma(dp[nb + 1], oa, bv[2], bv[3]);
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
            p = exp2_approx(s[nb][e] * sl2 - lse2[r]);
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
              p = exp2_approx(s[nb][e] * sl2 - lse2[r]);
          }
          dp[nb][e] = p * (dp[nb][e] - dl[r]) * dm.scale;
        }
      }

      // dQ += dS K over the sub-step's 32 keys
#pragma unroll
      for (int kc = 0; kc < kSub / 16; ++kc) {
        uint32_t da[4];
        acc_to_a(da, dp[2 * kc], dp[2 * kc + 1]);
        const int row = c0 + kc * 16 + lane % 8 + ((lane / 8) % 2) * 8;
#pragma unroll
        for (int db = 0; db < DB; db += 2) {
          uint32_t bk[4];
          ldsm_x4_t(bk, ks + row * LD + db * 8 + (lane / 16) * 8);
          mma(dq_acc[db], da, bk[0], bk[1]);
          mma(dq_acc[db + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();                   // this stage may be refilled
  }

  // dQ through the warp's own rows of q_s, then 16-byte stores
  cp_async_wait<0>();
  __syncthreads();
  bf16* qs = q_s + warp * 16 * LD;
#pragma unroll
  for (int db = 0; db < DB; ++db) {
    const int c = db * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(qs + g * LD + c) =
        __floats2bfloat162_rn(dq_acc[db][0], dq_acc[db][1]);
    *reinterpret_cast<__nv_bfloat162*>(qs + (g + 8) * LD + c) =
        __floats2bfloat162_rn(dq_acc[db][2], dq_acc[db][3]);
  }
  __syncwarp();
  store_rows<DT>(dq, qs, b, h, wq0, dm.Lq, dm, lane);
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
  const bf16 *q, *k, *v;
  const float* mask;
  const bf16* dout;
  const float *lse_in, *delta;
  bf16 *out, *dk, *dv;
  float* lse_out;
  bf16* dq;
};

template <int DT>
cudaError_t run(int which, const Ptrs& p, const Dims& dm, cudaStream_t st) {
  using S = Smem<DT>;
  const int bh = dm.B * dm.H;
  cudaError_t err;
  if (which == 0) {
    auto kern = flash_fwd_tc_kernel<DT>;
    if ((err = prepare(kern, S::fwd)) != cudaSuccess) return err;
    const int grid = bh * ((dm.Lq + kTile - 1) / kTile);
    kern<<<grid, kThreads, S::fwd, st>>>(p.q, p.k, p.v, p.mask, p.out,
                                          p.lse_out, dm);
  } else if (which == 1) {
    // at DT = 128 the dK and dV accumulators leave no registers for K, V
    auto kern = flash_dkv_tc_kernel<DT, DT == 64>;
    if ((err = prepare(kern, S::dkv)) != cudaSuccess) return err;
    const int grid = bh * ((dm.Lk + kTile - 1) / kTile);
    kern<<<grid, kThreads, S::dkv, st>>>(p.q, p.k, p.v, p.mask, p.dout,
                                          p.lse_in, p.delta, p.dk, p.dv, dm);
  } else {
    // at DT = 128 the dQ accumulators leave no registers for Q, dO
    auto kern = flash_dq_tc_kernel<DT, DT == 64>;
    if ((err = prepare(kern, S::dq)) != cudaSuccess) return err;
    const int grid = bh * ((dm.Lq + kTile - 1) / kTile);
    kern<<<grid, kThreads, S::dq, st>>>(p.q, p.k, p.v, p.mask, p.dout,
                                         p.lse_in, p.delta, p.dq, dm);
  }
  return cudaGetLastError();
}

// Head-dim tiers DT = 64 (D <= 64) and 128; the wrapper's _tiles and
// smem_bytes mirror this choice.
int dispatch(int which, const Ptrs& p, int B, int H, int Lq, int Lk, int D,
             float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || D < 16 || D > 128 ||
      D % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Dims dm{B, H, Lq, Lk, D, scale, causal ? 1 : 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return (int)run<64>(which, p, dm, st);
  return (int)run<128>(which, p, dm, st);
}

}  // namespace

extern "C" {

// q: (B, Lq, H, D), k/v: (B, Lk, H, D), bf16 with D a multiple of 16 in
// [16, 128]; mask: (B, Lk) f32 key validity, or null for all keys valid;
// lse/delta: (B, H, Lq) f32.  All contiguous, 16-byte aligned and on the
// current device.  Each launches on `stream` and returns the launch's
// cudaError_t (0 = launched); none synchronizes.

// out: (B, Lq, H, D) bf16; lse: (B, H, Lq) f32.
int flash_fwd_tc_launch(const void* q, const void* k, const void* v,
                        const void* mask, void* out, void* lse, int B, int H,
                        int Lq, int Lk, int D, float scale, int causal,
                        void* stream) {
  Ptrs p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
         static_cast<const bf16*>(v), static_cast<const float*>(mask),
         nullptr, nullptr, nullptr, static_cast<bf16*>(out), nullptr,
         nullptr, static_cast<float*>(lse), nullptr};
  return dispatch(0, p, B, H, Lq, Lk, D, scale, causal, stream);
}

// dk/dv: (B, Lk, H, D) bf16.
int flash_dkv_tc_launch(const void* q, const void* k, const void* v,
                        const void* mask, const void* dout, const void* lse,
                        const void* delta, void* dk, void* dv, int B, int H,
                        int Lq, int Lk, int D, float scale, int causal,
                        void* stream) {
  Ptrs p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
         static_cast<const bf16*>(v), static_cast<const float*>(mask),
         static_cast<const bf16*>(dout), static_cast<const float*>(lse),
         static_cast<const float*>(delta), nullptr, static_cast<bf16*>(dk),
         static_cast<bf16*>(dv), nullptr, nullptr};
  return dispatch(1, p, B, H, Lq, Lk, D, scale, causal, stream);
}

// dq: (B, Lq, H, D) bf16.
int flash_dq_tc_launch(const void* q, const void* k, const void* v,
                       const void* mask, const void* dout, const void* lse,
                       const void* delta, void* dq, int B, int H, int Lq,
                       int Lk, int D, float scale, int causal, void* stream) {
  Ptrs p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
         static_cast<const bf16*>(v), static_cast<const float*>(mask),
         static_cast<const bf16*>(dout), static_cast<const float*>(lse),
         static_cast<const float*>(delta), nullptr, nullptr, nullptr,
         nullptr, static_cast<bf16*>(dq)};
  return dispatch(2, p, B, H, Lq, Lk, D, scale, causal, stream);
}

}  // extern "C"
