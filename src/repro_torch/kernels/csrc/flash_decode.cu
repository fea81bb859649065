// Flash-decode attention for Hopper (sm_90a): one new query token per
// request against its KV context, grouped-query (GQA) heads.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_decode.py:
//   flash_decode        (_kernel)        -> repro_flash_decode
//       contiguous caches k/v (B, S, Hkv, D)
//   paged_flash_decode  (_paged_kernel)  -> repro_paged_flash_decode
//       page pools (P+1, page, Hkv, D) read through a block table
//       tables (B, nblk); page P is a scratch page
//
// Function (exactly the Pallas kernels'): scale 1/sqrt(D); float32
// scores, running max, running sum and accumulator; positions
// >= lengths[b] contribute nothing; the output is acc / max(l, 1e-20),
// so a 0-length lane gives 0; written in q's dtype (float32 or bf16).
//
// Bound on the H100: decode attention does 4 * Hq * D flops per context
// position and reads 2 * Hkv * D elements of K/V for it, about G = Hq/Hkv
// flops per byte in bf16 -- far below the ~295 flop/byte ridge.  So the
// least time is the bytes of K/V of the valid context, read once, over
// 3.35 TB/s.  What the design does about it:
//   * one block per (request, kv head) covers all G query heads of the
//     group, so each K/V row is read from device memory once per group
//     (the Pallas (G, D) q block does the same);
//   * the paged kernel reads the page id from tables[b, blk] itself (the
//     counterpart of the scalar-prefetched index_map) and addresses the
//     pool in its native (P+1, page, Hkv, D) layout, so no copy of the
//     pool is ever made; it stops at lengths[b] instead of walking all
//     nblk table entries, since masked pages add nothing;
//   * each warp streams its own positions with 16-byte-or-smaller vector
//     loads (a row is D contiguous elements, one slice per lane), keeps
//     a private online softmax in registers, and kUnroll rows in flight;
//     the warps' (m, l, acc) are combined once at the end in shared
//     memory, so the main loop has no barrier.
// Known limit (speed is later work): the grid is only B * Hkv blocks,
// 16 at B=4 on 132 SMs; splitting the context across blocks with the
// (acc, l, m) combine of layers.decode_attention_core would fill the card.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;       // K/V rows in flight per warp
constexpr int kMaxGroup = 8;     // query heads per kv head (G)
constexpr float kNeg = -1e30f;   // the Pallas kernels' masked score

template <typename R, int N>
struct alignas(sizeof(R) * N) Vec {
  R v[N];
};

// N consecutive elements in one vector load (the wrapper checks that
// every row start is aligned to sizeof(raw) * N).
template <typename Tr, int N>
__device__ __forceinline__ void load_vec(const typename Tr::raw* p,
                                         float (&out)[N]) {
  using raw = typename Tr::raw;
  const Vec<raw, N> x = *reinterpret_cast<const Vec<raw, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = Tr::load(x.v[i]);
}

struct Args {
  const void* q;        // (B, Hq, D), strides q_sb, q_sh, 1
  const void* k;        // dense (B, S, Hkv, D) / paged (P+1, page, Hkv, D)
  const void* v;        // same shape and strides as k
  void* out;            // (B, Hq, D) contiguous
  const int* tables;    // paged: (B, nblk), row stride t_sb; else null
  const int* lengths;   // (B,)
  long long q_sb, q_sh;
  long long kv_s0;      // dense: batch stride; paged: page stride
  long long kv_s1;      // dense: position stride; paged: row stride
  long long kv_sh;      // head stride
  long long t_sb;
  int hq, group, cap, page;   // cap: S (dense) or nblk * page (paged)
  float scale;
};

// grid (B, Hkv), kThreads threads; EPL = D / 32 elements per lane.
template <typename Tr, int EPL, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Args a) {
  using raw = typename Tr::raw;
  constexpr int D = 32 * EPL;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int G = a.group;
  int len = a.lengths[b];
  len = len < 0 ? 0 : (len > a.cap ? a.cap : len);

  // this group's G query heads, pre-scaled, one D/32 slice per lane
  const raw* qp = static_cast<const raw*>(a.q) + b * a.q_sb +
                  static_cast<long long>(h) * G * a.q_sh + lane * EPL;
  float qr[kMaxGroup][EPL];
  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][EPL];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < G) {
      load_vec<Tr, EPL>(qp + g * a.q_sh, qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < EPL; ++i) qr[g][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      qr[g][i] *= a.scale;
      acc[g][i] = 0.f;
    }
    m[g] = kNeg;
    l[g] = 0.f;
  }

  const raw* kb = static_cast<const raw*>(a.k);
  const raw* vb = static_cast<const raw*>(a.v);
  const long long head_off = static_cast<long long>(h) * a.kv_sh + lane * EPL;
  const int* trow = PAGED ? a.tables + b * a.t_sb : nullptr;

  // warp w takes positions w, w + kWarps, ...; kUnroll of them per pass
  for (int base = warp; base < len; base += kWarps * kUnroll) {
    float kf[kUnroll][EPL], vf[kUnroll][EPL];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u * kWarps;
      ok[u] = pos < len;
      if (ok[u]) {
        long long off;
        if (PAGED) {
          const int blk = pos / a.page;
          off = static_cast<long long>(trow[blk]) * a.kv_s0 +
                static_cast<long long>(pos - blk * a.page) * a.kv_s1;
        } else {
          off = b * a.kv_s0 + static_cast<long long>(pos) * a.kv_s1;
        }
        load_vec<Tr, EPL>(kb + off + head_off, kf[u]);
        load_vec<Tr, EPL>(vb + off + head_off, vf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < EPL; ++i) kf[u][i] = vf[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= G) continue;
      float s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) part = fmaf(qr[g][i], kf[u][i], part);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        s[u] = part;
      }
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u]);
      const float corr = expf(m[g] - mx);
      float p[kUnroll];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = ok[u] ? expf(s[u] - mx) : 0.f;
        psum += p[u];
      }
      l[g] = l[g] * corr + psum;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        float x = acc[g][i] * corr;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) x = fmaf(p[u], vf[u][i], x);
        acc[g][i] = x;
      }
      m[g] = mx;
    }
  }

  // combine the warps' partial softmaxes: out = sum_w c_w acc_w /
  // max(sum_w c_w l_w, 1e-20) with c_w = exp(m_w - max_w m_w)
  __shared__ float sm_m[kWarps][kMaxGroup];
  __shared__ float sm_l[kWarps][kMaxGroup];
  __shared__ float sm_acc[kWarps][kMaxGroup][D];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= G) continue;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) sm_acc[warp][g][lane * EPL + i] = acc[g][i];
  }
  __syncthreads();
  raw* out = static_cast<raw*>(a.out) +
             (static_cast<long long>(b) * a.hq + static_cast<long long>(h) * G) * D;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx - g * D;
    float mmax = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mmax = fmaxf(mmax, sm_m[w][g]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mmax);
      lsum = fmaf(sm_l[w][g], c, lsum);
      asum = fmaf(sm_acc[w][g][d], c, asum);
    }
    out[idx] = Tr::store(asum / fmaxf(lsum, 1e-20f));
  }
}

template <typename Tr, bool PAGED>
int launch(const Args& a, int batch, int hkv, int d, cudaStream_t stream) {
  const dim3 grid(batch, hkv);
  switch (d) {
    case 32:
      decode_attention_kernel<Tr, 1, PAGED><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 64:
      decode_attention_kernel<Tr, 2, PAGED><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 128:
      decode_attention_kernel<Tr, 4, PAGED><<<grid, kThreads, 0, stream>>>(a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED>
int dispatch(const Args& a, int dtype, int batch, int hkv, int d,
             void* stream) {
  if (a.group < 1 || a.group > kMaxGroup || batch < 1 || hkv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<F32, PAGED>(a, batch, hkv, d, s);
  if (dtype == 1) return launch<BF16, PAGED>(a, batch, hkv, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the Pallas kernels' scale, 1 / sqrt(D) rounded once to float32
float inv_sqrt(int d) { return static_cast<float>(1.0 / sqrt(static_cast<double>(d))); }

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  Strides are in elements.  Returns the
// cudaError_t of the launch (0 on success).
int repro_flash_decode(const void* q, const void* k, const void* v,
                       void* out, const int* lengths, int dtype, int batch,
                       int hq, int hkv, int d, int seq, long long q_sb,
                       long long q_sh, long long k_sb, long long k_ss,
                       long long k_sh, void* stream) {
  Args a{q, k, v, out, nullptr, lengths, q_sb, q_sh, k_sb, k_ss, k_sh, 0,
         hq, hkv > 0 ? hq / hkv : 0, seq, 0, inv_sqrt(d)};
  return dispatch<false>(a, dtype, batch, hkv, d, stream);
}

int repro_paged_flash_decode(const void* q, const void* k_pool,
                             const void* v_pool, void* out,
                             const int* tables, const int* lengths,
                             int dtype, int batch, int hq, int hkv, int d,
                             int page, int nblk, long long q_sb,
                             long long q_sh, long long p_sp, long long p_sr,
                             long long p_sh, long long t_sb, void* stream) {
  Args a{q, k_pool, v_pool, out, tables, lengths, q_sb, q_sh, p_sp, p_sr,
         p_sh, t_sb, hq, hkv > 0 ? hq / hkv : 0, nblk * page, page,
         inv_sqrt(d)};
  return dispatch<true>(a, dtype, batch, hkv, d, stream);
}

}  // extern "C"
