// Paged decode/verify attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel distributed_tensorflow_tpu/ops/
// paged_attention.py::_kernel (launched by paged_attention, the
// pl.pallas_call at paged_attention.py:257).  Same function: for each
// (slot, kv_head) walk the slot's int32 block-table row, score the folded
// query rows (GQA group x l_q) against each live pool block under the
// staircase mask t <= pos[s] + (row mod l_q), keep an online softmax with
// f32 m, l and acc, and write acc / max(l, 1e-30) in q's dtype.  int8
// pools are dequantized per block from their (N, blk, KVH) f32 scales.
//
// What differs from the TPU kernel: the TPU grid (slot, kv_head, block)
// runs its block axis in order and carries m/l/acc in VMEM scratch; here
// the block axis is a loop inside one CTA per (slot, kv_head), and the
// CTA loads the block ids itself (the TPU got them by scalar prefetch).
// Blocks past pos + l_q - 1 are never loaded (the TPU kernel skipped their
// compute).  GQA folding and unfolding happen in the index math, so the
// wrapper passes q and out in the model's (S, l_q, H, D) layout.
//
// What bounds it: by its roofline the read is memory-bound (each live K/V
// element is read once and used for GL = group x l_q rows, a few flops per
// byte).  At the serving shapes (8 slots x 8 kv heads, up to 18 blocks of
// 8 tokens) the grid is only 64 CTAs on 132 SMs and the whole call moves
// about 1.5 MB, a bound well under a microsecond, so the call is bound by
// fixed costs instead: the launch (one per layer per decode step) and,
// larger, the serial chain of the per-block loop -- each block's global
// loads wait behind the previous block's barriers, with nothing in flight
// ahead.  This first design is deliberately simple: K/V blocks staged in
// shared memory as f32, one warp per (row, key) dot product, one warp per
// row for the softmax update.  Splitting the key axis over warps and CTAs
// (flash-decoding), cp.async/TMA prefetch of the next blocks and wgmma are
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // matches parallel.ring_attention.NEG_INF
constexpr float kTiny = 1e-30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// grid (S, KVH); block kThreads.  Shared memory (f32): q rows [GL*D],
// K block [BLK*D], V block [BLK*D], scores/probabilities [GL*BLK],
// m [GL], l [GL], acc [GL*D].
template <typename QT, typename KT, bool QUANT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                       const KT* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int32_t* __restrict__ bt,
                       const int32_t* __restrict__ pos,
                       QT* __restrict__ out, int LQ, int H, int KVH, int D,
                       int BLK, int MB, float scale) {
  extern __shared__ float smem[];
  const int s = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KVH;
  const int GL = G * LQ;
  float* q_s = smem;
  float* k_s = q_s + GL * D;
  float* v_s = k_s + BLK * D;
  float* p_s = v_s + BLK * D;
  float* m_s = p_s + GL * BLK;
  float* l_s = m_s + GL;
  float* acc_s = l_s + GL;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = kThreads / 32;

  // folded row r = g * LQ + li reads q[s, li, kvh * G + g, :]
  for (int i = tid; i < GL * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int g = r / LQ, li = r - g * LQ;
    q_s[i] = to_f32(q[((size_t)(s * LQ + li) * H + kvh * G + g) * D + c]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < GL; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int p0 = pos[s];
  const int last = p0 + LQ - 1;            // last key any row may see
  int n_live = last / BLK + 1;
  if (n_live > MB) n_live = MB;

  for (int j = 0; j < n_live; ++j) {
    const int bid = bt[(size_t)s * MB + j];
    __syncthreads();                        // previous block fully consumed
    for (int i = tid; i < BLK * D; i += kThreads) {
      const int t = i / D, c = i - t * D;
      const size_t row = (size_t)bid * BLK + t;
      const size_t src = (row * KVH + kvh) * D + c;
      float kx = to_f32(kp[src]);
      float vx = to_f32(vp[src]);
      if (QUANT) {
        kx *= ks[row * KVH + kvh];
        vx *= vs[row * KVH + kvh];
      }
      k_s[i] = kx;
      v_s[i] = vx;
    }
    __syncthreads();

    // scores: one warp per (row, key), lanes over head_dim
    for (int pr = warp; pr < GL * BLK; pr += n_warps) {
      const int r = pr / BLK, t = pr - r * BLK;
      float dot = 0.f;
      for (int c = lane; c < D; c += 32) dot += q_s[r * D + c] * k_s[t * D + c];
      dot = warp_sum(dot) * scale;
      const int tpos = j * BLK + t;
      if (lane == 0) p_s[pr] = (tpos <= p0 + (r % LQ)) ? dot : kNegInf;
    }
    __syncthreads();

    // online softmax update: one warp per row
    for (int r = warp; r < GL; r += n_warps) {
      float mx = kNegInf;
      for (int t = lane; t < BLK; t += 32) mx = fmaxf(mx, p_s[r * BLK + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < BLK; t += 32) {
        const float p = expf(p_s[r * BLK + t] - m_new);
        p_s[r * BLK + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      const float corr = expf(m_prev - m_new);
      __syncwarp();                         // row's probabilities visible
      for (int c = lane; c < D; c += 32) {
        float a = acc_s[r * D + c] * corr;
        for (int t = 0; t < BLK; ++t) a += p_s[r * BLK + t] * v_s[t * D + c];
        acc_s[r * D + c] = a;
      }
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < GL * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int g = r / LQ, li = r - g * LQ;
    const float o = acc_s[i] / fmaxf(l_s[r], kTiny);
    from_f32(o, &out[((size_t)(s * LQ + li) * H + kvh * G + g) * D + c]);
  }
}

template <typename QT, typename KT, bool QUANT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int32_t* bt,
                   const int32_t* pos, void* out, int S, int LQ, int H,
                   int KVH, int D, int BLK, int MB, float scale,
                   size_t smem, cudaStream_t stream) {
  auto kern = paged_attention_kernel<QT, KT, QUANT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(S, KVH);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), ks, vs, bt, pos, static_cast<QT*>(out), LQ,
      H, KVH, D, BLK, MB, scale);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* k,
                        const void* v, const float* ks, const float* vs,
                        const int32_t* bt, const int32_t* pos, void* out,
                        int S, int LQ, int H, int KVH, int D, int BLK, int MB,
                        float scale, size_t smem, cudaStream_t st) {
  switch (kv_dtype) {
    case 0:
      return launch<QT, float, false>(q, k, v, ks, vs, bt, pos, out, S, LQ, H,
                                      KVH, D, BLK, MB, scale, smem, st);
    case 1:
      return launch<QT, __nv_bfloat16, false>(q, k, v, ks, vs, bt, pos, out,
                                              S, LQ, H, KVH, D, BLK, MB,
                                              scale, smem, st);
    case 2:
      return launch<QT, int8_t, true>(q, k, v, ks, vs, bt, pos, out, S, LQ, H,
                                      KVH, D, BLK, MB, scale, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory the kernel needs, in bytes (the wrapper's
// smem_bytes mirrors it to reject shapes before launching).
size_t smem_bytes(int GL, int D, int BLK) {
  return sizeof(float) *
         ((size_t)2 * GL * D + (size_t)2 * BLK * D + (size_t)GL * BLK +
          (size_t)2 * GL);
}

}  // namespace

extern "C" {

// q/out: (S, LQ, H, D) of q_dtype (0 f32, 1 bf16); k/v pools: (N, BLK, KVH,
// D) of kv_dtype (0 f32, 1 bf16, 2 int8 with ks/vs (N, BLK, KVH) f32
// scales); bt: (S, MB) int32; pos: (S,) int32.  All contiguous, all on the
// current device.  Launches on `stream` and returns the launch's
// cudaError_t (0 = launched); it never synchronizes.
int paged_attention_launch(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs, const void* bt,
                           const void* pos, void* out, int S, int LQ, int H,
                           int KVH, int D, int BLK, int MB, float scale,
                           int q_dtype, int kv_dtype, void* stream) {
  if (S <= 0 || LQ <= 0 || KVH <= 0 || H % KVH != 0 || D <= 0 || BLK <= 0 ||
      MB <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes((H / KVH) * LQ, D, BLK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int32_t* btp = static_cast<const int32_t*>(bt);
  const int32_t* posp = static_cast<const int32_t*>(pos);
  cudaError_t err;
  if (q_dtype == 0)
    err = dispatch_kv<float>(kv_dtype, q, k, v, ksf, vsf, btp, posp, out, S,
                             LQ, H, KVH, D, BLK, MB, scale, smem, st);
  else if (q_dtype == 1)
    err = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k, v, ksf, vsf, btp, posp,
                                     out, S, LQ, H, KVH, D, BLK, MB, scale,
                                     smem, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
