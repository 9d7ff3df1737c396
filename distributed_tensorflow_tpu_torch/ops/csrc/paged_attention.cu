// Paged decode/verify attention for Hopper (sm_90a), as split-key
// flash-decoding.
//
// Replaces the Pallas TPU kernel distributed_tensorflow_tpu/ops/
// paged_attention.py::_kernel (launched by paged_attention, the
// pl.pallas_call at paged_attention.py:257).  Same function: for each
// (slot, kv_head) read the slot's int32 block-table row, score the folded
// query rows (GQA group x l_q) against each live pool block under the
// staircase mask t <= pos[s] + (row mod l_q), keep f32 m, l and acc, and
// write acc / max(l, 1e-30) in q's dtype.  int8 pools are dequantized from
// their (N, blk, KVH) f32 scales.  Blocks past pos + l_q - 1 are never read.
// GQA folding and unfolding happen in the index math, so the wrapper passes
// q and out in the model's (S, l_q, H, D) layout.
//
// What bounds it: the bytes.  Each live K/V element is read once and used
// for GL = group x l_q rows, a few flops per byte, so the least time is the
// live K/V rows over 3.35 TB/s: under a microsecond at the serving decode
// shape (8 slots x 8 kv heads, up to 18 blocks of 8 tokens), ~20 us at a
// 4096-token context.  At such sizes what costs time is latency: a block's
// loads waiting behind another block's compute, too few CTAs for 132 SMs,
// serial reductions.  The design:
// - Splits the key axis: one CTA per (slot, kv_head, split).  Split i of a
//   slot with n live table entries owns entries [i C, (i + 1) C), C =
//   ceil(n / splits), clipped to n; an empty range writes l = 0, which
//   weighs nothing in the combine.  The wrapper picks the split count
//   (_splits) from the shapes alone.
// - Issues the loads of all its blocks (up to a chunk that fits the
//   shared-memory budget) as cp.async copies of the (token, kv_head) rows
//   before any arithmetic, and waits once; a range longer than one chunk
//   streams through two chunk stages, chunk c + 1 in flight while chunk c
//   is consumed.  So no block's load waits behind another block's compute.
// - Spreads the work over all 128 threads: scores one thread per key, its
//   K row read 16 bytes at a time from rows padded to an odd number of
//   16-byte chunks (no bank conflicts); the softmax update one warp per
//   row; P V one thread per (row, column), and where a CTA has fewer
//   (row, column) pairs than threads, 2-4 threads per pair over alternate
//   keys, each with four independent sums.  K and V stay in their storage
//   type in shared memory and are widened (int8: scaled) as they are read.
//   (A warp per key with lanes over the head dim would spend its time in
//   the shuffle reduction of every score.)
// - With more than one split, each CTA writes its f32 partial (m, l, acc)
//   to a scratch tensor the wrapper allocates, and a second small kernel
//   combines a row's partials with weights exp(m_i - m), reading every
//   split's m and l at once into shared memory; with one split the CTA
//   writes the output itself.
// A split in which a row sees no valid key ends with m = -1e30 and carries
// weight exp(-1e30 - m) = 0 in the combine, as a masked key does in one
// pass; every row sees key 0, so some split always has a valid key.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // matches parallel.ring_attention.NEG_INF
constexpr float kTiny = 1e-30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 256;
constexpr int kSmemLimit = 232448;  // bytes of shared memory one CTA may use

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` (4, 8 or 16) global -> shared, asynchronously
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(smem_u32(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;             // int8 scales, or null
  const int32_t *bt, *pos;
  void* out;
  float* part;                      // (S, KVH, NS, GL, D + 2) partials
  int S, LQ, H, KVH, D, BLK, MB, NS, KC;
  float scale;
  int vec;                          // bytes per async copy; 0 = plain loads
};

// Row stride (bytes) of K and V rows in shared memory: a row of whole
// 16-byte chunks is padded to an odd number of chunks, so the 8 rows that
// one quarter-warp reads 16 bytes of at a time fall in 8 bank groups.
__host__ __device__ __forceinline__ int row_stride(int row_bytes) {
  return row_bytes % 16 == 0 && (row_bytes / 16) % 2 == 0 ? row_bytes + 16
                                                          : row_bytes;
}

// Byte offsets of the shared-memory regions (the wrapper's smem_bytes
// mirrors `total`): q rows and acc [GL x D] f32; m, l, corr [GL] f32; the
// range's block ids [ceil(MB / NS)]; scores [GL x KC*BLK] f32; P V partial
// sums [kThreads] f32; per stage the K and V rows of a chunk [KC*BLK rows
// of row_stride bytes] in the pool's type (and, int8, their scales
// [KC*BLK] f32).  One stage when a chunk holds every range.
struct Layout {
  size_t q, acc, ml, ids, p, red, kv, kvbuf, scbuf, total;
  int keys, rs;
};

__host__ __device__ __forceinline__ Layout layout(int GL, int D, int BLK,
                                                  int MB, int NS, int KC,
                                                  int esize, bool quant) {
  Layout L;
  const int cmax = (MB + NS - 1) / NS;
  const int stages = KC >= cmax ? 1 : 2;
  L.keys = KC * BLK;
  L.rs = row_stride(D * esize);
  L.q = 0;
  L.acc = L.q + align16((size_t)4 * GL * D);
  L.ml = L.acc + align16((size_t)4 * GL * D);
  L.ids = L.ml + align16((size_t)4 * 3 * GL);
  L.p = L.ids + align16((size_t)4 * cmax);
  L.red = L.p + align16((size_t)4 * GL * L.keys);
  L.kv = L.red + align16((size_t)4 * kThreads);
  L.kvbuf = align16((size_t)L.keys * L.rs);
  L.scbuf = quant ? align16((size_t)4 * L.keys) : 0;
  L.total = L.kv + (size_t)stages * 2 * (L.kvbuf + L.scbuf);
  return L;
}

// q . k over one 16-byte chunk of a K row (4 f32, 8 bf16 or 16 int8
// values) against the matching f32 q values (16-byte aligned).
__device__ __forceinline__ float chunk_dot(uint4 w, const float* q, float) {
  const float4 a = *reinterpret_cast<const float4*>(q);
  return __uint_as_float(w.x) * a.x + __uint_as_float(w.y) * a.y +
         __uint_as_float(w.z) * a.z + __uint_as_float(w.w) * a.w;
}
__device__ __forceinline__ float chunk_dot(uint4 w, const float* q,
                                           __nv_bfloat16) {
  // a bf16 is the high half of the f32 with the same value
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < 4; i += 2) {
    const float4 a = *reinterpret_cast<const float4*>(q + 2 * i);
    dot += __uint_as_float(u[i] << 16) * a.x +
           __uint_as_float(u[i] & 0xffff0000u) * a.y +
           __uint_as_float(u[i + 1] << 16) * a.z +
           __uint_as_float(u[i + 1] & 0xffff0000u) * a.w;
  }
  return dot;
}
__device__ __forceinline__ float chunk_dot(uint4 w, const float* q, int8_t) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 a = *reinterpret_cast<const float4*>(q + 4 * i);
    dot += static_cast<float>(static_cast<int8_t>(u[i])) * a.x +
           static_cast<float>(static_cast<int8_t>(u[i] >> 8)) * a.y +
           static_cast<float>(static_cast<int8_t>(u[i] >> 16)) * a.z +
           static_cast<float>(static_cast<int8_t>(u[i] >> 24)) * a.w;
  }
  return dot;
}

// grid (S, KVH, NS); block kThreads.
template <typename QT, typename KT, bool QUANT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int G = a.H / a.KVH, GL = G * a.LQ, D = a.D, BLK = a.BLK;
  const Layout L = layout(GL, D, BLK, a.MB, a.NS, a.KC, sizeof(KT), QUANT);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);
  float* m_s = reinterpret_cast<float*>(smem + L.ml);
  float* l_s = m_s + GL;
  float* corr_s = l_s + GL;
  int* ids = reinterpret_cast<int*>(smem + L.ids);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  float* red_s = reinterpret_cast<float*>(smem + L.red);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int p0 = a.pos[s];
  const int n_live = min((p0 + a.LQ - 1) / BLK + 1, a.MB);
  const int per = (n_live + a.NS - 1) / a.NS;
  const int j0 = min(split * per, n_live);
  const int nb = min(j0 + per, n_live) - j0;     // blocks of this split
  for (int i = tid; i < nb; i += kThreads)
    ids[i] = a.bt[(size_t)s * a.MB + j0 + i];

  // folded row r = g * LQ + li reads q[s, li, kvh * G + g, :], pre-scaled
  const QT* q = static_cast<const QT*>(a.q);
  for (int i = tid; i < GL * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int g = r / a.LQ, li = r - g * a.LQ;
    q_s[i] = to_f32(q[((size_t)(s * a.LQ + li) * a.H + kvh * G + g) * D + c])
             * a.scale;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < GL; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();                           // ids visible

  const int rb = D * static_cast<int>(sizeof(KT));   // bytes of a K/V row
  const unsigned char* kg = static_cast<const unsigned char*>(a.k);
  const unsigned char* vg = static_cast<const unsigned char*>(a.v);
  // Stage the K and V rows (and scales) of chunk c: blocks [c KC, ...).
  auto issue = [&](int c) {
    unsigned char* kd = smem + L.kv + (c & 1) * 2 * (L.kvbuf + L.scbuf);
    unsigned char* vd = kd + L.kvbuf;
    const int b0 = c * a.KC;
    const int keys = min(a.KC, nb - b0) * BLK;
    if (a.vec > 0) {
      const int upr = rb / a.vec;                     // copies per row
      for (int i = tid; i < 2 * keys * upr; i += kThreads) {
        const int which = i >= keys * upr;
        const int rem = i - which * keys * upr;
        const int key = rem / upr, part = rem - key * upr;
        const int bi = key / BLK;
        const size_t row = (size_t)ids[b0 + bi] * BLK + (key - bi * BLK);
        const size_t off = (row * a.KVH + kvh) * rb + (size_t)part * a.vec;
        cp_async((which ? vd : kd) + key * L.rs + part * a.vec,
                 (which ? vg : kg) + off, a.vec);
      }
    } else {
      const KT* kt = static_cast<const KT*>(a.k);
      const KT* vt = static_cast<const KT*>(a.v);
      for (int i = tid; i < 2 * keys * D; i += kThreads) {
        const int which = i >= keys * D;
        const int rem = i - which * keys * D;
        const int key = rem / D, c2 = rem - key * D;
        const int bi = key / BLK;
        const size_t row = (size_t)ids[b0 + bi] * BLK + (key - bi * BLK);
        reinterpret_cast<KT*>((which ? vd : kd) + key * L.rs)[c2] =
            (which ? vt : kt)[(row * a.KVH + kvh) * D + c2];
      }
    }
    if (QUANT) {
      float* sd = reinterpret_cast<float*>(kd + 2 * L.kvbuf);
      for (int i = tid; i < 2 * keys; i += kThreads) {
        const int which = i >= keys;
        const int key = i - which * keys;
        const int bi = key / BLK;
        const size_t row = (size_t)ids[b0 + bi] * BLK + (key - bi * BLK);
        cp_async(sd + which * (L.scbuf / 4) + key,
                 (which ? a.vs : a.ks) + row * a.KVH + kvh, 4);
      }
    }
  };

  const int n_rc = GL * D;
  // P V: `parts` threads share a (row, column), each over every parts-th key
  const int parts = n_rc >= kThreads ? 1 : min(4, kThreads / n_rc);
  const int n_chunks = (nb + a.KC - 1) / a.KC;
  if (n_chunks > 0) issue(0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) issue(c + 1);       // two stages: n_chunks > 1
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const unsigned char* kd = smem + L.kv + (c & 1) * 2 * (L.kvbuf + L.scbuf);
    const unsigned char* vd = kd + L.kvbuf;
    const float* ksc = reinterpret_cast<const float*>(kd + 2 * L.kvbuf);
    const float* vsc = ksc + L.scbuf / 4;
    const int keys = min(a.KC, nb - c * a.KC) * BLK;
    const int t0 = (j0 + c * a.KC) * BLK;     // position of the chunk's key 0

    // scores: one thread per key, 16-byte chunks of its K row
    for (int key = tid; key < keys; key += kThreads) {
      const unsigned char* krow = kd + key * L.rs;
      const float kscale = QUANT ? ksc[key] : 1.f;
      const int tpos = t0 + key;
      for (int r = 0; r < GL; ++r) {
        const float* qr = q_s + r * D;
        float dot = 0.f;
        if (rb % 16 == 0) {
          constexpr int per16 = 16 / sizeof(KT);
          for (int col = 0; col < D; col += per16)
            dot += chunk_dot(*reinterpret_cast<const uint4*>(
                                 krow + col * sizeof(KT)),
                             qr + col, KT());
        } else {
          for (int col = 0; col < D; ++col)
            dot += qr[col] * to_f32(reinterpret_cast<const KT*>(krow)[col]);
        }
        p_s[r * L.keys + key] =
            tpos <= p0 + r % a.LQ ? dot * kscale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax update: one warp per row
    for (int r = warp; r < GL; r += kWarps) {
      float* pr = p_s + r * L.keys;
      float mx = kNegInf;
      for (int t = lane; t < keys; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < keys; t += 32) {
        const float p = expf(pr[t] - m_new);
        pr[t] = QUANT ? p * vsc[t] : p;       // V's scale rides on P
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[r] = corr;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: one thread per (row, column, part), four
    // independent sums per thread
    for (int i = tid; i < n_rc * parts; i += kThreads) {
      const int part = i / n_rc, rc = i - part * n_rc;
      const int r = rc / D, col = rc - r * D;
      const float* pr = p_s + r * L.keys;
      const unsigned char* vc = vd + col * sizeof(KT);
      auto pv = [&](int t) {
        return pr[t] * to_f32(*reinterpret_cast<const KT*>(vc + t * L.rs));
      };
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      int t = part;
      for (; t + 3 * parts < keys; t += 4 * parts) {
        s0 += pv(t);
        s1 += pv(t + parts);
        s2 += pv(t + 2 * parts);
        s3 += pv(t + 3 * parts);
      }
      for (; t < keys; t += parts) s0 += pv(t);
      const float sum = (s0 + s1) + (s2 + s3);
      if (parts == 1)
        acc_s[rc] = acc_s[rc] * corr_s[r] + sum;
      else
        red_s[i] = sum;
    }
    if (parts > 1) {
      __syncthreads();
      for (int rc = tid; rc < n_rc; rc += kThreads) {
        float sum = 0.f;
        for (int pt = 0; pt < parts; ++pt) sum += red_s[pt * n_rc + rc];
        acc_s[rc] = acc_s[rc] * corr_s[rc / D] + sum;
      }
    }
    __syncthreads();                          // the stage may be refilled
  }

  if (a.NS == 1) {
    QT* out = static_cast<QT*>(a.out);
    for (int i = tid; i < GL * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      const int g = r / a.LQ, li = r - g * a.LQ;
      from_f32(acc_s[i] / fmaxf(l_s[r], kTiny),
               &out[((size_t)(s * a.LQ + li) * a.H + kvh * G + g) * D + c]);
    }
    return;
  }
  // this split's partial: acc [GL x D], then m [GL], then l [GL]
  const size_t stride = (size_t)GL * (D + 2);
  float* part = a.part + (((size_t)s * a.KVH + kvh) * a.NS + split) * stride;
  for (int i = tid; i < GL * D; i += kThreads) part[i] = acc_s[i];
  for (int r = tid; r < GL; r += kThreads) {
    part[GL * D + r] = m_s[r];
    part[GL * D + GL + r] = l_s[r];
  }
}

// Dynamic shared memory of the combine kernel: each split's weight and l
// per row, and each row's merged l.
__host__ __device__ __forceinline__ size_t combine_smem(int GL, int NS) {
  return (size_t)4 * (2 * NS * GL + GL);
}

// grid (S, KVH); block kThreads.  Merges the NS partials of each row: the
// splits' m and l are read once into shared memory (all loads in flight
// together), then each (row, column) sums its NS acc values.
template <typename QT>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(Args a) {
  extern __shared__ float cs[];
  const int s = blockIdx.x, kvh = blockIdx.y;
  const int G = a.H / a.KVH, GL = G * a.LQ, D = a.D, NS = a.NS;
  const size_t stride = (size_t)GL * (D + 2);
  const float* part = a.part + ((size_t)s * a.KVH + kvh) * NS * stride;
  float* w_s = cs;                 // [NS][GL]: m, then the weight
  float* lp_s = w_s + NS * GL;     // [NS][GL]: l
  float* l_s = lp_s + NS * GL;     // [GL]: merged l
  for (int i = threadIdx.x; i < NS * GL; i += kThreads) {
    const int sp = i / GL, r = i - sp * GL;
    w_s[i] = part[sp * stride + GL * D + r];
    lp_s[i] = part[sp * stride + GL * D + GL + r];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < GL; r += kThreads) {
    float m = kNegInf;
    for (int sp = 0; sp < NS; ++sp) m = fmaxf(m, w_s[sp * GL + r]);
    float l = 0.f;
    for (int sp = 0; sp < NS; ++sp) {
      const float w = expf(w_s[sp * GL + r] - m);
      w_s[sp * GL + r] = w;
      l += w * lp_s[sp * GL + r];
    }
    l_s[r] = l;
  }
  __syncthreads();
  QT* out = static_cast<QT*>(a.out);
  for (int i = threadIdx.x; i < GL * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    int sp = 0;
    for (; sp + 3 < NS; sp += 4) {
      s0 += w_s[sp * GL + r] * part[sp * stride + i];
      s1 += w_s[(sp + 1) * GL + r] * part[(sp + 1) * stride + i];
      s2 += w_s[(sp + 2) * GL + r] * part[(sp + 2) * stride + i];
      s3 += w_s[(sp + 3) * GL + r] * part[(sp + 3) * stride + i];
    }
    for (; sp < NS; ++sp) s0 += w_s[sp * GL + r] * part[sp * stride + i];
    const int g = r / a.LQ, li = r - g * a.LQ;
    from_f32(((s0 + s1) + (s2 + s3)) / fmaxf(l_s[r], kTiny),
             &out[((size_t)(s * a.LQ + li) * a.H + kvh * G + g) * D + c]);
  }
}

template <typename QT, typename KT, bool QUANT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const Layout L = layout((a.H / a.KVH) * a.LQ, a.D, a.BLK, a.MB, a.NS, a.KC,
                          sizeof(KT), QUANT);
  if (L.total > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  auto kern = paged_attention_kernel<QT, KT, QUANT>;
  if (L.total > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3(a.S, a.KVH, a.NS), kThreads, L.total, stream>>>(a);
  if (a.NS > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t cb = combine_smem((a.H / a.KVH) * a.LQ, a.NS);
    if (cb > (size_t)kSmemLimit) return cudaErrorInvalidValue;
    auto comb = paged_combine_kernel<QT>;
    if (cb > 48 * 1024) {
      err = cudaFuncSetAttribute(
          comb, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cb);
      if (err != cudaSuccess) return err;
    }
    comb<<<dim3(a.S, a.KVH), kThreads, cb, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const Args& a, cudaStream_t st) {
  switch (kv_dtype) {
    case 0:
      return launch<QT, float, false>(a, st);
    case 1:
      return launch<QT, __nv_bfloat16, false>(a, st);
    case 2:
      return launch<QT, int8_t, true>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The widest async copy (16, 8 or 4 bytes) that divides a K/V row and the
// pools' alignment; 0 = plain loads.
int copy_bytes(const void* k, const void* v, size_t row_bytes) {
  for (int w = 16; w >= 4; w /= 2)
    if (row_bytes % w == 0 && reinterpret_cast<uintptr_t>(k) % w == 0 &&
        reinterpret_cast<uintptr_t>(v) % w == 0)
      return w;
  return 0;
}

}  // namespace

extern "C" {

// q/out: (S, LQ, H, D) of q_dtype (0 f32, 1 bf16); k/v pools: (N, BLK, KVH,
// D) of kv_dtype (0 f32, 1 bf16, 2 int8 with ks/vs (N, BLK, KVH) f32
// scales); bt: (S, MB) int32; pos: (S,) int32; part: f32 scratch of
// S * KVH * NS * GL * (D + 2) values (GL = H / KVH * LQ), unused when
// NS == 1.  NS is the number of key splits, KC the table entries one chunk
// of a split stages at a time.  All contiguous, all on the current device.
// Launches on `stream` (the split kernel, and the combine kernel when
// NS > 1) and returns the launches' cudaError_t (0 = launched); it never
// synchronizes.
int paged_attention_launch(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs, const void* bt,
                           const void* pos, void* out, void* part, int S,
                           int LQ, int H, int KVH, int D, int BLK, int MB,
                           int NS, int KC, float scale, int q_dtype,
                           int kv_dtype, void* stream) {
  if (S <= 0 || LQ <= 0 || KVH <= 0 || H % KVH != 0 || D <= 0 ||
      D > kMaxD || BLK <= 0 || MB <= 0 || NS <= 0 || KC <= 0 ||
      (NS > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  static const int esize[] = {4, 2, 1};
  if (kv_dtype < 0 || kv_dtype > 2) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, static_cast<const float*>(ks),
         static_cast<const float*>(vs), static_cast<const int32_t*>(bt),
         static_cast<const int32_t*>(pos), out, static_cast<float*>(part),
         S, LQ, H, KVH, D, BLK, MB, NS, KC, scale,
         copy_bytes(k, v, (size_t)D * esize[kv_dtype])};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0)
    err = dispatch_kv<float>(kv_dtype, a, st);
  else if (q_dtype == 1)
    err = dispatch_kv<__nv_bfloat16>(kv_dtype, a, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
