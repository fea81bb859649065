// WKV6 recurrence for Hopper (sm_90a): the RWKV6 time-mix core.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/wkv6.py (wkv6,
// _kernel) -> repro_wkv6.  Per (batch b, head h), with head size hs and
// an hs x hs float32 state S (row i, column j):
//     y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// r/k/v/w: (B, T, H, hs) read in place through their strides (no
// transposed copies); u: (H, hs); state in and out: (B, H, hs, hs)
// float32; y: (B, T, H, hs) contiguous in the inputs' dtype (float32 or
// bfloat16).
//
// Bound on the H100: each (b, h, t) reads 4 hs inputs and writes hs
// outputs, and the function needs ~5 hs^2 flops: y_t[j] = sum_i r_t[i]
// S[i][j] + v_t[j] * sum_i r_t[i] u[i] k_t[i] is 2 hs^2 (plus O(hs)), the
// update a multiply and an FMA per entry, 3 hs^2.  So a long sweep is
// bound by float32 operations (67 TFLOP/s), a T=1 decode step by the
// state's bytes (read and written once); the sweep over T is serial, a
// third limit.  The loop below spends 7 flops per entry (it forms
// u[i] k_t[i] v_t[j] for every (i, j)), 2/7 over the need.  What the
// design does:
//   * one block per (b, h); column j of the state is held in registers
//     for the whole sweep by kSplit threads, each owning hs / kSplit of
//     its rows, so the state crosses device memory once in and once out
//     (the Pallas kernel keeps it in VMEM), the serial chain per step is
//     hs / kSplit FMAs long, and a block has kSplit * hs threads;
//   * column j needs only r, k, w (shared by all columns) and its own
//     v_t[j]: the block stages kChunk steps of r, k, w, v in shared memory,
//     one barrier per chunk, and each thread sweeps them alone, reading
//     r/k/w/u four at a time as broadcast float4 loads (each thread's row
//     segment padded by 4 floats, so the kSplit segments a warp reads
//     fall in distinct banks); y_t[j] is summed over the kSplit threads
//     with two shuffles;
//   * the state in and out may be the same buffer: each thread reads its
//     part of a column before it writes it, and no other thread touches
//     it.
// Known limit (speed is later work): the sweep over T stays serial; a
// chunk-parallel form would turn long prefills into matrix products.
#include "common.cuh"

namespace {

constexpr int kChunk = 16;   // time steps staged per barrier
constexpr int kSplit = 4;    // threads sharing one state column
constexpr int kPad = 4;      // floats after each thread's row segment

template <typename Tr, int HS>
__global__ void __launch_bounds__(HS * kSplit)
wkv6_kernel(const typename Tr::raw* __restrict__ r,
            const typename Tr::raw* __restrict__ k,
            const typename Tr::raw* __restrict__ v,
            const typename Tr::raw* __restrict__ w,
            const typename Tr::raw* __restrict__ u, const float* s0,
            typename Tr::raw* __restrict__ y, float* sT, int H, int T,
            long long sb, long long st, long long sh) {
  constexpr int RP = HS / kSplit;            // rows per thread
  constexpr int ROW = HS + kSplit * kPad;    // padded staged row
  constexpr int NT = HS * kSplit;
  __shared__ __align__(16) float sr[kChunk][ROW];
  __shared__ __align__(16) float sk[kChunk][ROW];
  __shared__ __align__(16) float sw[kChunk][ROW];
  __shared__ __align__(16) float su[ROW];
  __shared__ float sv[kChunk][HS];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j = threadIdx.x / kSplit;        // state column
  const int p = threadIdx.x % kSplit;        // its row segment
  const int i0 = p * RP;

  const long long state_off =
      static_cast<long long>(bh) * HS * HS + static_cast<long long>(i0) * HS + j;
  float S[RP];
#pragma unroll
  for (int e = 0; e < RP; ++e) S[e] = s0[state_off + e * HS];
  for (int i = threadIdx.x; i < HS; i += NT)
    su[i + (i / RP) * kPad] = Tr::load(u[h * HS + i]);

  const long long in_off = b * sb + h * sh;
  // y is (B, T, H, HS) contiguous
  const long long y_off = (static_cast<long long>(b) * T * H + h) * HS + j;
  const long long y_st = static_cast<long long>(H) * HS;
  const int seg = i0 + p * kPad;             // this thread's padded segment

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int n = T - t0 < kChunk ? T - t0 : kChunk;
    __syncthreads();   // the previous chunk is consumed
    for (int idx = threadIdx.x; idx < n * HS; idx += NT) {
      const int c = idx / HS;
      const int i = idx - c * HS;
      const int pi = i + (i / RP) * kPad;
      const long long off = in_off + (t0 + c) * st + i;
      sr[c][pi] = Tr::load(r[off]);
      sk[c][pi] = Tr::load(k[off]);
      sw[c][pi] = Tr::load(w[off]);
      sv[c][i] = Tr::load(v[off]);
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = sv[c][j];
      float y4[4] = {0.f, 0.f, 0.f, 0.f};
      const float4* r4 = reinterpret_cast<const float4*>(sr[c] + seg);
      const float4* k4 = reinterpret_cast<const float4*>(sk[c] + seg);
      const float4* w4 = reinterpret_cast<const float4*>(sw[c] + seg);
      const float4* u4 = reinterpret_cast<const float4*>(su + seg);
#pragma unroll
      for (int q = 0; q < RP / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q], uu = u4[q];
        const float rq[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kq[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wq[4] = {ww.x, ww.y, ww.z, ww.w};
        const float uq[4] = {uu.x, uu.y, uu.z, uu.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          const float kv = kq[e] * vj;
          y4[e] = fmaf(rq[e], fmaf(uq[e], kv, S[i]), y4[e]);
          S[i] = fmaf(wq[e], S[i], kv);
        }
      }
      float yj = (y4[0] + y4[1]) + (y4[2] + y4[3]);
#pragma unroll
      for (int o = 1; o < kSplit; o <<= 1)
        yj += __shfl_xor_sync(0xffffffffu, yj, o);
      if (p == 0) y[y_off + (t0 + c) * y_st] = Tr::store(yj);
    }
  }
#pragma unroll
  for (int e = 0; e < RP; ++e) sT[state_off + e * HS] = S[e];
}

template <typename Tr>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const float* s0, void* y, float* sT, int B, int T,
           int H, int hs, long long sb, long long st, long long sh,
           cudaStream_t stream) {
  using raw = typename Tr::raw;
  const auto* rp = static_cast<const raw*>(r);
  const auto* kp = static_cast<const raw*>(k);
  const auto* vp = static_cast<const raw*>(v);
  const auto* wp = static_cast<const raw*>(w);
  const auto* up = static_cast<const raw*>(u);
  auto* yp = static_cast<raw*>(y);
  const dim3 grid(B * H);
  switch (hs) {
    case 32:
      wkv6_kernel<Tr, 32><<<grid, 32 * kSplit, 0, stream>>>(
          rp, kp, vp, wp, up, s0, yp, sT, H, T, sb, st, sh);
      break;
    case 64:
      wkv6_kernel<Tr, 64><<<grid, 64 * kSplit, 0, stream>>>(
          rp, kp, vp, wp, up, s0, yp, sT, H, T, sb, st, sh);
      break;
    case 128:
      wkv6_kernel<Tr, 128><<<grid, 128 * kSplit, 0, stream>>>(
          rp, kp, vp, wp, up, s0, yp, sT, H, T, sb, st, sh);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (r, k, v, w, u and y); state float32.
// sb/st/sh: the element strides of r/k/v/w over B, T and H (the last dim
// is contiguous).  s0 and sT may alias (the model advances its state in
// place).  Returns the launch's
// cudaError_t (0 on success).
int repro_wkv6(const void* r, const void* k, const void* v, const void* w,
               const void* u, const float* s0, void* y, float* sT, int dtype,
               int B, int T, int H, int hs, long long sb, long long st,
               long long sh, void* stream) {
  if (B < 1 || H < 1 || T < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<F32>(r, k, v, w, u, s0, y, sT, B, T, H, hs, sb, st, sh, s);
  if (dtype == 1)
    return launch<BF16>(r, k, v, w, u, s0, y, sT, B, T, H, hs, sb, st, sh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
