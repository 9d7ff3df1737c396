// Exact attention, forward and backward, for Hopper (sm_90a).
//
// Three kernels, each the port of one Pallas TPU kernel of
// distributed_tensorflow_tpu/ops/flash_attention.py:
//
//   flash_fwd_kernel  <- _fwd_kernel (launched by _fwd, the pl.pallas_call
//                        at flash_attention.py:170)
//   flash_dq_kernel   <- _dq_kernel  (launched by _bwd, flash_attention.py:281)
//   flash_dkv_kernel  <- _dkv_kernel (launched by _bwd, flash_attention.py:299)
//
// Same function as the TPU kernels: S = scale * Q K^T, a causal mask by
// absolute position (qpos >= kpos) and a key-validity mask (mask > 0), both
// writing NEG_INF = -1e30 (never -inf); the forward keeps an online softmax
// with f32 m, l and acc and writes O = acc / max(l, 1e-30) in q's dtype and
// lse = m + log(max(l, 1e-30)) in f32.  The backward recovers
// P = exp(S - lse), dP = dO V^T, dS = P * (dP - Delta) * scale with
// Delta = rowsum(dO * O) computed by the caller, and accumulates
// dQ = sum_k dS K (one CTA per q tile) and dV = sum_q P^T dO,
// dK = sum_q dS^T Q (one CTA per k tile), as the TPU splits them, so no
// atomics are needed.  Gradients are written in the input dtype.
//
// What differs from the TPU kernels: the TPU grid runs its last axis in
// order and carries the accumulators across it in VMEM scratch; Hopper
// blocks run in no order, so that axis is a loop inside each CTA and the
// accumulators live in registers.  Tiles wholly in the causal future are
// never visited (the TPU's _causal_skip).  The wrapper does not pad: rows
// past Lq and keys past Lk are masked here -- a key past Lk gets no weight
// at all (-inf, so exp gives 0), which is what the TPU kernel computes when
// its lengths need no padding.  Tensors stay in the model's (B, L, H, D)
// layout (lse and Delta are (B, H, Lq)), so the wrapper makes no transposed
// copies.
//
// What bounds it: at the training slice's shape (B*H = 64, L = 1024,
// D = 64, bf16, causal) the forward moves about 34 MB (q, k, v read once,
// O written once, lse) and does about 8.6 GFLOP over the causal pairs, so
// its bound is about 10 us of memory traffic at 3.35 TB/s; the two backward
// kernels do about 30 GFLOP, about 30 us at the 989 TFLOP/s of the bf16
// tensor cores.  This first design is deliberately simple and stays on f32
// CUDA cores: 256 threads as a 16 x 16 grid, each owning a strided
// (rows x cols) micro-tile of the score tile and of the output
// accumulators; q/k/v/dO tiles staged in shared memory as f32 with a padded
// row stride (conflict-free column reads); P kept in f32 for P V and
// P^T dO as on the TPU.  It will sit far above the bound (the f32 CUDA-core
// peak is 67 TFLOP/s and shared-memory reads feed the FMAs); tensor-core
// products (mma.sync / wgmma), TMA staging and a fused Delta pre-pass are
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // matches parallel.ring_attention.NEG_INF
constexpr float kTiny = 1e-30f;
constexpr int kSide = 16;           // threads per side of the 16 x 16 grid
constexpr int kThreads = kSide * kSide;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float x, __half* dst) {
  *dst = __float2half_rn(x);
}

// A score row's 16 column owners are the 16 lanes of one half warp.
__device__ __forceinline__ float row_max(float v) {
  for (int o = kSide / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = kSide / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Dims {
  int B, H, Lq, Lk, D;
  float scale;
  int causal;
};

// Stage rows [r0, r0 + ROWS) of head (b, h) of a (B, L, H, D) tensor into
// shared memory as f32 with row stride `ld`; rows past L and columns past D
// read as zero.
template <typename T, int ROWS, int DT>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          float* dst, int ld, int b, int h,
                                          int r0, int L, const Dims& dm) {
  for (int i = threadIdx.x; i < ROWS * DT; i += kThreads) {
    const int r = i / DT, c = i - r * DT;
    const int row = r0 + r;
    float x = 0.f;
    if (row < L && c < dm.D)
      x = to_f32(src[(((size_t)b * L + row) * dm.H + h) * dm.D + c]);
    dst[r * ld + c] = x;
  }
}

// Key-validity flags of keys [k0, k0 + BK): 1 without a mask.
template <int BK>
__device__ __forceinline__ void load_mask(const float* __restrict__ mask,
                                          float* dst, int b, int k0,
                                          const Dims& dm) {
  for (int c = threadIdx.x; c < BK; c += kThreads) {
    const int kpos = k0 + c;
    dst[c] = (mask == nullptr) ? 1.f
             : (kpos < dm.Lk ? mask[(size_t)b * dm.Lk + kpos] : 0.f);
  }
}

// The TPU kernel's _tile_mask, plus the ragged edge: a key past Lk carries
// no weight at all.
__device__ __forceinline__ float masked_score(float dot, int qpos, int kpos,
                                              float valid, const Dims& dm) {
  if (kpos >= dm.Lk) return __int_as_float(0xff800000);   // -inf
  float s = dot * dm.scale;
  if (dm.causal && qpos < kpos) s = kNegInf;
  if (!(valid > 0.f)) s = kNegInf;
  return s;
}

// Shared-memory layout sizes, in floats.  LD = DT + 1 and LDP = BK + 1 pad
// the row strides so 16 threads reading one column hit 16 banks.
template <int BQ, int BK, int DT>
struct Smem {
  static constexpr int LD = DT + 1;
  static constexpr int LDP = BK + 1;
  // q, k, v, p, key mask
  static constexpr size_t fwd = (size_t)BQ * LD + 2 * (size_t)BK * LD +
                                (size_t)BQ * LDP + BK;
  // q, dO, k, v, dS, key mask
  static constexpr size_t dq = 2 * (size_t)BQ * LD + 2 * (size_t)BK * LD +
                               (size_t)BQ * LDP + BK;
  // k, v, q, dO, p, dS, key mask, lse, delta
  static constexpr size_t dkv = 2 * (size_t)BK * LD + 2 * (size_t)BQ * LD +
                                2 * (size_t)BQ * LDP + BK + 2 * BQ;
};

// ---------------------------------------------------------------- forward
// One CTA per (b*h, q tile), looping over the k tiles.
template <typename T, int BQ, int BK, int DT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse, Dims dm) {
  constexpr int MI = BQ / kSide, NJ = BK / kSide, DJ = DT / kSide;
  using S = Smem<BQ, BK, DT>;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * S::LD;
  float* v_s = k_s + BK * S::LD;
  float* p_s = v_s + BK * S::LD;
  float* m_s = p_s + BQ * S::LDP;

  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int n_tiles = (dm.Lq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x - bh * n_tiles) * BQ;
  const int b = bh / dm.H, h = bh - b * dm.H;

  load_rows<T, BQ, DT>(q, q_s, S::LD, b, h, q0, dm.Lq, dm);

  float m[MI], l[MI], acc[MI][DJ];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, dm.Lq) - 1;
  const int k_end = dm.causal ? min(dm.Lk, q_last + 1) : dm.Lk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                 // previous tile fully consumed
    load_rows<T, BK, DT>(k, k_s, S::LD, b, h, k0, dm.Lk, dm);
    load_rows<T, BK, DT>(v, v_s, S::LD, b, h, k0, dm.Lk, dm);
    load_mask<BK>(mask, m_s, b, k0, dm);
    __syncthreads();

    float s[MI][NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dm.D; ++d) {
      float qv[MI], kv[NJ];
#pragma unroll
      for (int i = 0; i < MI; ++i) qv[i] = q_s[(ty + kSide * i) * S::LD + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = k_s[(tx + kSide * j) * S::LD + d];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = ty + kSide * i;
      float mx = __int_as_float(0xff800000);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + kSide * j;
        s[i][j] = masked_score(s[i][j], q0 + r, k0 + c, m_s[c], dm);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[r * S::LDP + tx + kSide * j] = p;
        sum += p;
      }
      sum = row_sum(sum);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();                 // P visible

    for (int kk = 0; kk < BK; ++kk) {
      float pv[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i) pv[i] = p_s[(ty + kSide * i) * S::LDP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = v_s[kk * S::LD + tx + kSide * j];
#pragma unroll
        for (int i = 0; i < MI; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int row = q0 + ty + kSide * i;
    if (row >= dm.Lq) continue;
    const float l_safe = fmaxf(l[i], kTiny);
    const size_t base = (((size_t)b * dm.Lq + row) * dm.H + h) * dm.D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + kSide * j;
      if (c < dm.D) store(acc[i][j] / l_safe, &out[base + c]);
    }
    if (tx == 0) lse[(size_t)bh * dm.Lq + row] = m[i] + logf(l_safe);
  }
}

// ------------------------------------------------------------------- dQ
// One CTA per (b*h, q tile), looping over the k tiles.
template <typename T, int BQ, int BK, int DT>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ mask,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, Dims dm) {
  constexpr int MI = BQ / kSide, NJ = BK / kSide, DJ = DT / kSide;
  using S = Smem<BQ, BK, DT>;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * S::LD;
  float* k_s = do_s + BQ * S::LD;
  float* v_s = k_s + BK * S::LD;
  float* ds_s = v_s + BK * S::LD;
  float* m_s = ds_s + BQ * S::LDP;

  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int n_tiles = (dm.Lq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x - bh * n_tiles) * BQ;
  const int b = bh / dm.H, h = bh - b * dm.H;

  load_rows<T, BQ, DT>(q, q_s, S::LD, b, h, q0, dm.Lq, dm);
  load_rows<T, BQ, DT>(dout, do_s, S::LD, b, h, q0, dm.Lq, dm);

  float lse_r[MI], delta_r[MI], acc[MI][DJ];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int row = q0 + ty + kSide * i;
    const bool live = row < dm.Lq;
    lse_r[i] = live ? lse[(size_t)bh * dm.Lq + row] : 0.f;
    delta_r[i] = live ? delta[(size_t)bh * dm.Lq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, dm.Lq) - 1;
  const int k_end = dm.causal ? min(dm.Lk, q_last + 1) : dm.Lk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_rows<T, BK, DT>(k, k_s, S::LD, b, h, k0, dm.Lk, dm);
    load_rows<T, BK, DT>(v, v_s, S::LD, b, h, k0, dm.Lk, dm);
    load_mask<BK>(mask, m_s, b, k0, dm);
    __syncthreads();

    float s[MI][NJ], dp[MI][NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < dm.D; ++d) {
      float qv[MI], dov[MI], kv[NJ], vv[NJ];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        qv[i] = q_s[(ty + kSide * i) * S::LD + d];
        dov[i] = do_s[(ty + kSide * i) * S::LD + d];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        kv[j] = k_s[(tx + kSide * j) * S::LD + d];
        vv[j] = v_s[(tx + kSide * j) * S::LD + d];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += dov[i] * vv[j];
        }
    }

#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = ty + kSide * i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + kSide * j;
        const float p =
            expf(masked_score(s[i][j], q0 + r, k0 + c, m_s[c], dm) - lse_r[i]);
        ds_s[r * S::LDP + c] = p * (dp[i][j] - delta_r[i]) * dm.scale;
      }
    }
    __syncthreads();                 // dS visible

    for (int kk = 0; kk < BK; ++kk) {
      float dsv[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        dsv[i] = ds_s[(ty + kSide * i) * S::LDP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kx = k_s[kk * S::LD + tx + kSide * j];
#pragma unroll
        for (int i = 0; i < MI; ++i) acc[i][j] += dsv[i] * kx;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int row = q0 + ty + kSide * i;
    if (row >= dm.Lq) continue;
    const size_t base = (((size_t)b * dm.Lq + row) * dm.H + h) * dm.D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + kSide * j;
      if (c < dm.D) store(acc[i][j], &dq[base + c]);
    }
  }
}

// ----------------------------------------------------------------- dK/dV
// One CTA per (b*h, k tile), looping over the q tiles.
template <typename T, int BQ, int BK, int DT>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, Dims dm) {
  constexpr int MI = BQ / kSide, NJ = BK / kSide, KI = BK / kSide,
                DJ = DT / kSide;
  using S = Smem<BQ, BK, DT>;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BK * S::LD;
  float* q_s = v_s + BK * S::LD;
  float* do_s = q_s + BQ * S::LD;
  float* p_s = do_s + BQ * S::LD;
  float* ds_s = p_s + BQ * S::LDP;
  float* m_s = ds_s + BQ * S::LDP;
  float* lse_s = m_s + BK;
  float* delta_s = lse_s + BQ;

  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int n_tiles = (dm.Lk + BK - 1) / BK;
  const int bh = blockIdx.x / n_tiles;
  const int k0 = (blockIdx.x - bh * n_tiles) * BK;
  const int b = bh / dm.H, h = bh - b * dm.H;

  load_rows<T, BK, DT>(k, k_s, S::LD, b, h, k0, dm.Lk, dm);
  load_rows<T, BK, DT>(v, v_s, S::LD, b, h, k0, dm.Lk, dm);
  load_mask<BK>(mask, m_s, b, k0, dm);

  float dk_acc[KI][DJ], dv_acc[KI][DJ];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: the first q tile whose last row reaches this k tile
  const int q_start = dm.causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_start; q0 < dm.Lq; q0 += BQ) {
    __syncthreads();
    load_rows<T, BQ, DT>(q, q_s, S::LD, b, h, q0, dm.Lq, dm);
    load_rows<T, BQ, DT>(dout, do_s, S::LD, b, h, q0, dm.Lq, dm);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const int row = q0 + r;
      const bool live = row < dm.Lq;
      lse_s[r] = live ? lse[(size_t)bh * dm.Lq + row] : 0.f;
      delta_s[r] = live ? delta[(size_t)bh * dm.Lq + row] : 0.f;
    }
    __syncthreads();

    float s[MI][NJ], dp[MI][NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < dm.D; ++d) {
      float qv[MI], dov[MI], kv[NJ], vv[NJ];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        qv[i] = q_s[(ty + kSide * i) * S::LD + d];
        dov[i] = do_s[(ty + kSide * i) * S::LD + d];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        kv[j] = k_s[(tx + kSide * j) * S::LD + d];
        vv[j] = v_s[(tx + kSide * j) * S::LD + d];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += dov[i] * vv[j];
        }
    }

#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = ty + kSide * i;
      const bool live = q0 + r < dm.Lq;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + kSide * j;
        const float p =
            live ? expf(masked_score(s[i][j], q0 + r, k0 + c, m_s[c], dm) -
                        lse_s[r])
                 : 0.f;
        p_s[r * S::LDP + c] = p;
        ds_s[r * S::LDP + c] = p * (dp[i][j] - delta_s[r]) * dm.scale;
      }
    }
    __syncthreads();                 // P and dS visible

    for (int qq = 0; qq < BQ; ++qq) {
      float pv[KI], dsv[KI];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        pv[i] = p_s[qq * S::LDP + ty + kSide * i];
        dsv[i] = ds_s[qq * S::LDP + ty + kSide * i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float dox = do_s[qq * S::LD + tx + kSide * j];
        const float qx = q_s[qq * S::LD + tx + kSide * j];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          dv_acc[i][j] += pv[i] * dox;
          dk_acc[i][j] += dsv[i] * qx;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int row = k0 + ty + kSide * i;
    if (row >= dm.Lk) continue;
    const size_t base = (((size_t)b * dm.Lk + row) * dm.H + h) * dm.D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + kSide * j;
      if (c < dm.D) {
        store(dk_acc[i][j], &dk[base + c]);
        store(dv_acc[i][j], &dv[base + c]);
      }
    }
  }
}

// --------------------------------------------------------------- launchers
template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem_floats) {
  const size_t bytes = smem_floats * sizeof(float);
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  return cudaSuccess;
}

struct Ptrs {
  const void *q, *k, *v;
  const float* mask;
  const void* dout;
  const float *lse_in, *delta;
  void *out, *dk, *dv;
  float* lse_out;
};

template <typename T, int BQ, int BK, int DT>
cudaError_t run(int which, const Ptrs& p, const Dims& dm, cudaStream_t st) {
  using S = Smem<BQ, BK, DT>;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const int bh = dm.B * dm.H;
  cudaError_t err;
  if (which == 0) {
    auto kern = flash_fwd_kernel<T, BQ, BK, DT>;
    if ((err = prepare(kern, S::fwd)) != cudaSuccess) return err;
    const int grid = bh * ((dm.Lq + BQ - 1) / BQ);
    kern<<<grid, kThreads, S::fwd * sizeof(float), st>>>(
        q, k, v, p.mask, static_cast<T*>(p.out), p.lse_out, dm);
  } else if (which == 1) {
    auto kern = flash_dq_kernel<T, BQ, BK, DT>;
    if ((err = prepare(kern, S::dq)) != cudaSuccess) return err;
    const int grid = bh * ((dm.Lq + BQ - 1) / BQ);
    kern<<<grid, kThreads, S::dq * sizeof(float), st>>>(
        q, k, v, p.mask, dout, p.lse_in, p.delta, static_cast<T*>(p.out), dm);
  } else {
    auto kern = flash_dkv_kernel<T, BQ, BK, DT>;
    if ((err = prepare(kern, S::dkv)) != cudaSuccess) return err;
    const int grid = bh * ((dm.Lk + BK - 1) / BK);
    kern<<<grid, kThreads, S::dkv * sizeof(float), st>>>(
        q, k, v, p.mask, dout, p.lse_in, p.delta, static_cast<T*>(p.dk),
        static_cast<T*>(p.dv), dm);
  }
  return cudaGetLastError();
}

// Head-dim tiers: (BQ, BK, DT) = (64, 64, 64), (64, 64, 128), (32, 32, 256);
// the wrapper's _tiles mirrors this choice.
template <typename T>
cudaError_t by_head_dim(int which, const Ptrs& p, const Dims& dm,
                        cudaStream_t st) {
  if (dm.D <= 64) return run<T, 64, 64, 64>(which, p, dm, st);
  if (dm.D <= 128) return run<T, 64, 64, 128>(which, p, dm, st);
  return run<T, 32, 32, 256>(which, p, dm, st);
}

int dispatch(int which, const Ptrs& p, int B, int H, int Lq, int Lk, int D,
             float scale, int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || D <= 0 || D > 256)
    return (int)cudaErrorInvalidValue;
  const Dims dm{B, H, Lq, Lk, D, scale, causal ? 1 : 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)by_head_dim<float>(which, p, dm, st);
  if (dtype == 1) return (int)by_head_dim<__nv_bfloat16>(which, p, dm, st);
  if (dtype == 2) return (int)by_head_dim<__half>(which, p, dm, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q: (B, Lq, H, D), k/v: (B, Lk, H, D), all of `dtype` (0 f32, 1 bf16,
// 2 fp16);
// mask: (B, Lk) f32 key validity, or null for all keys valid; lse/delta:
// (B, H, Lq) f32.  All contiguous and on the current device.  Each launches
// on `stream` and returns the launch's cudaError_t (0 = launched); none
// synchronizes.

// out: (B, Lq, H, D) of dtype; lse: (B, H, Lq) f32.
int flash_fwd_launch(const void* q, const void* k, const void* v,
                     const void* mask, void* out, void* lse, int B, int H,
                     int Lq, int Lk, int D, float scale, int causal,
                     int dtype, void* stream) {
  Ptrs p{q, k, v, static_cast<const float*>(mask), nullptr, nullptr,
         nullptr, out, nullptr, nullptr, static_cast<float*>(lse)};
  return dispatch(0, p, B, H, Lq, Lk, D, scale, causal, dtype, stream);
}

// dq: (B, Lq, H, D) of dtype.
int flash_dq_launch(const void* q, const void* k, const void* v,
                    const void* mask, const void* dout, const void* lse,
                    const void* delta, void* dq, int B, int H, int Lq,
                    int Lk, int D, float scale, int causal, int dtype,
                    void* stream) {
  Ptrs p{q, k, v, static_cast<const float*>(mask), dout,
         static_cast<const float*>(lse), static_cast<const float*>(delta),
         dq, nullptr, nullptr, nullptr};
  return dispatch(1, p, B, H, Lq, Lk, D, scale, causal, dtype, stream);
}

// dk/dv: (B, Lk, H, D) of dtype.
int flash_dkv_launch(const void* q, const void* k, const void* v,
                     const void* mask, const void* dout, const void* lse,
                     const void* delta, void* dk, void* dv, int B, int H,
                     int Lq, int Lk, int D, float scale, int causal,
                     int dtype, void* stream) {
  Ptrs p{q, k, v, static_cast<const float*>(mask), dout,
         static_cast<const float*>(lse), static_cast<const float*>(delta),
         nullptr, dk, dv, nullptr};
  return dispatch(2, p, B, H, Lq, Lk, D, scale, causal, dtype, stream);
}

}  // extern "C"
