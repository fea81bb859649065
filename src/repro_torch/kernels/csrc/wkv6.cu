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
// bfloat16).  The state in and out may be the same buffer (the model
// advances its state in place).
//
// Bound on the H100: each (b, h, t) reads 4 hs inputs and writes hs
// outputs, and the function needs 5 hs^2 flops: y_t[j] = sum_i r_t[i]
// S[i][j] + v_t[j] * sum_i r_t[i] u[i] k_t[i] is 2 hs^2 (plus O(hs)), the
// update a multiply and an FMA per entry, 3 hs^2.  A T=1 decode step is
// bound by the state's bytes (read and written once), a long prefill by
// float32 operations (67 TFLOP/s).  Two designs, picked by the wrapper
// from shapes alone (kernels/wkv6.py, chunk_plan):
//
// Serial (short T, decode): one block per (b, h); column j of the state
// is held in registers for the whole sweep by kSplit threads, each owning
// hs / kSplit of its rows, so the state crosses device memory once in and
// once out.  The block stages kChunk steps of r, k, w, v in shared memory
// per barrier, summing r_t[i] u[i] k_t[i] over i once per step as it
// stages; each thread then spends the function's 5 flops per state entry
// and step.
// The sweep over T is a dependent chain, so time grows with T whatever
// the card's width.
//
// Chunked (long T, prefill): T is cut into chunks of C steps.  Within a
// chunk entering with state S_in (products over empty ranges are 1):
//     rhat_t = r_t * prod_{tau < t} w_tau
//     ktil_s = k_s * prod_{s < tau < n} w_tau
//     A[t][s] = sum_i r_t[i] k_s[i] prod_{s < tau < t} w_tau[i]  (s < t)
//     A[t][t] = sum_i r_t[i] u[i] k_t[i]
//     y_t     = rhat_t S_in + sum_{s <= t} A[t][s] v_s
//     S_out   = diag(prod_tau w_tau) S_in + sum_s ktil_s v_s^T
// so the work of a chunk is dense products and only the walk across
// chunks is serial.  Three launches on the stream, nothing read back:
//   1. chunk states: one block per (b, h, chunk) forms dS_c = sum_s
//      ktil_s v_s^T and W_c = prod_s w_s into float32 scratch;
//   2. scan: one thread per state entry walks the chunks, S <- W_c S +
//      dS_c, writing the state entering each chunk to scratch and the
//      last state out (it reads its entry of state0 first, so
//      state_out may alias state0);
//   3. chunk outputs: one block per (b, h, chunk) forms A and y from
//      the state entering its chunk.
// Launches 1 and 3 have B * H * ceil(T / C) blocks (2,048 at rwkv6-7b's
// prefill, B=1, H=64, T=1024, C=32): the card fills, where one block per
// (b, h, column tile) walking the chunks in order (the first chunked
// design) left ~2 blocks an SM latency-bound at ~5 us a chunk.  What
// bounds it now is device memory: r/k/w/v are read twice (launches 1 and
// 3) and the chunk states cross it four times (dS written and read, the
// entering states written and read), ~4 ceil(T / C) hs^2 floats per (b,
// h).  The decay products are cut at sub-blocks of 16 steps, so no chain
// of running products is longer than 16 and A's sub-blocks below the
// diagonal are plain products.
// Rows are staged by 16-byte cp.async (element copies where a row is
// not 16-byte aligned).  The decay factors are never divided: each is a
// product of w over a contiguous range, at most 1, formed by running
// products.  So nothing overflows, a decay of exactly 0 gives exact
// zeros (no log, no NaN), and a product that underflows is one whose
// true value is below float32's smallest normal.  All products are
// float32 FMAs (no TF32).
#include "common.cuh"

namespace {

constexpr int kMaxSmem = 232448;   // a block's shared memory on sm_90

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// Serial design
// ---------------------------------------------------------------------------
constexpr int kChunk = 16;   // time steps staged per barrier
constexpr int kSplit = 4;    // threads sharing one state column
constexpr int kPad = 4;      // floats after each thread's row segment

template <typename Tr, int HS>
__global__ void __launch_bounds__(HS * kSplit)
wkv6_serial(const typename Tr::raw* __restrict__ r,
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
  // sum_i r_t[i] u[i] k_t[i], in parts of 32 rows (one per staging warp)
  __shared__ float sruk[kChunk][HS / 32];

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
    // a warp stages 32 consecutive rows of one step (HS and NT are
    // multiples of 32), so it sums its part of r u k as it goes
    for (int idx = threadIdx.x; idx < n * HS; idx += NT) {
      const int c = idx / HS;
      const int i = idx - c * HS;
      const int pi = i + (i / RP) * kPad;
      const long long off = in_off + (t0 + c) * st + i;
      const float rv = Tr::load(r[off]), kv = Tr::load(k[off]);
      sr[c][pi] = rv;
      sk[c][pi] = kv;
      sw[c][pi] = Tr::load(w[off]);
      sv[c][i] = Tr::load(v[off]);
      const float part = warp_sum(rv * su[pi] * kv);
      if (i % 32 == 0) sruk[c][i / 32] = part;
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = sv[c][j];
      float y4[4] = {0.f, 0.f, 0.f, 0.f};
      const float4* r4 = reinterpret_cast<const float4*>(sr[c] + seg);
      const float4* k4 = reinterpret_cast<const float4*>(sk[c] + seg);
      const float4* w4 = reinterpret_cast<const float4*>(sw[c] + seg);
#pragma unroll
      for (int q = 0; q < RP / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q];
        const float rq[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kq[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wq[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {   // 5 flops: FMA, multiply, FMA
          const int i = 4 * q + e;
          y4[e] = fmaf(rq[e], S[i], y4[e]);
          S[i] = fmaf(wq[e], S[i], kq[e] * vj);
        }
      }
      float yj = (y4[0] + y4[1]) + (y4[2] + y4[3]);
#pragma unroll
      for (int o = 1; o < kSplit; o <<= 1)
        yj += __shfl_xor_sync(0xffffffffu, yj, o);
      float ruk = 0.f;
#pragma unroll
      for (int e = 0; e < HS / 32; ++e) ruk += sruk[c][e];
      if (p == 0) y[y_off + (t0 + c) * y_st] = Tr::store(fmaf(vj, ruk, yj));
    }
  }
#pragma unroll
  for (int e = 0; e < RP; ++e) sT[state_off + e * HS] = S[e];
}

// ---------------------------------------------------------------------------
// Chunked design: three launches (chunk states, scan, chunk outputs)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// 4 (2) consecutive stored elements as float4 (float2); p aligned to them
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const uint16_t* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  return make_float4(BF16::load(x.x & 0xffffu), BF16::load(x.x >> 16),
                     BF16::load(x.y & 0xffffu), BF16::load(x.y >> 16));
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}
__device__ __forceinline__ void fma2x4(float (&acc)[2][4], float2 a,
                                       float4 b) {
  const float av[2] = {a.x, a.y};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    acc[e][0] = fmaf(av[e], b.x, acc[e][0]);
    acc[e][1] = fmaf(av[e], b.y, acc[e][1]);
    acc[e][2] = fmaf(av[e], b.z, acc[e][2]);
    acc[e][3] = fmaf(av[e], b.w, acc[e][3]);
  }
}

struct ChunkArgs {
  const void *r, *k, *v, *w, *u;
  const float* s0;
  void* y;
  float* sT;
  float* dS;    // (B*H, n_chunks, HS, HS): each chunk's state contribution
  float* Sin;   // (B*H, n_chunks, HS, HS): the state entering each chunk
  float* W;     // (B*H, n_chunks, HS): each chunk's decay
  int H, T, n_chunks;
  long long sb, st, sh;
  int vec;   // 16-byte aligned rows: cp.async; else element copies
};

// A staged row, padded by 16 bytes so that the same 16 bytes of 8
// consecutive rows fall in distinct banks.
template <typename Tr, int HS>
__host__ __device__ constexpr int row_len() {
  return HS + 16 / static_cast<int>(sizeof(typename Tr::raw));
}

// Rows [t0, t0 + n) of ``n_in`` of the inputs ``src`` into consecutive
// [C][row_len] arrays of ``dst``.
template <typename Tr, int HS, int C, int NT>
__device__ __forceinline__ void stage_rows(typename Tr::raw* dst,
                                           const ChunkArgs& a,
                                           const void* const (&src)[4],
                                           int n_in, long long in_off,
                                           int t0, int n) {
  using raw = typename Tr::raw;
  constexpr int kPiece = 16 / static_cast<int>(sizeof(raw));  // elements
  constexpr int kRowPieces = HS / kPiece;
  const int total = n_in * C * kRowPieces;
  for (int idx = threadIdx.x; idx < total; idx += NT) {
    const int which = idx / (C * kRowPieces);      // constant divisors
    const int rem = idx - which * (C * kRowPieces);
    const int row = rem / kRowPieces;
    const int pc = rem - row * kRowPieces;
    if (row >= n) continue;
    const raw* s = static_cast<const raw*>(src[which]) + in_off +
                   (t0 + row) * a.st + pc * kPiece;
    raw* d = dst + (which * C + row) * row_len<Tr, HS>() + pc * kPiece;
    if (a.vec) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < kPiece; ++e) d[e] = s[e];
    }
  }
}

// Decay products are cut at sub-blocks of kSub steps: each thread owns
// one (row i, sub-block q), so a chain of running products is at most
// kSub long, and a product over a longer range is the sub-block's part
// times whole sub-blocks' totals (each factor at most 1).
constexpr int kSub = 16;

// Launch 1, one block per (b, h, chunk): the chunk's contribution to the
// state, dS = sum_s ktil_s v_s^T with ktil_s = k_s prod_{s < tau} w_tau,
// and its decay W = prod_s w_s.
template <int HS> struct StateTile {
  static constexpr int TI = HS < 64 ? 2 : HS / 16;   // rows per thread
  static constexpr int NT = (HS / TI) * (HS / 4);    // 4 columns each
};

template <typename Tr, int HS, int C>
__global__ void __launch_bounds__(StateTile<HS>::NT)
wkv6_chunk_state(ChunkArgs a) {
  using raw = typename Tr::raw;
  constexpr int TI = StateTile<HS>::TI;
  constexpr int NT = StateTile<HS>::NT;
  constexpr int NSB = C / kSub;
  constexpr int RS = row_len<Tr, HS>();
  extern __shared__ __align__(16) unsigned char smem[];
  raw* sk = reinterpret_cast<raw*>(smem);            // k, w, v: [C][RS]
  const raw* sw = sk + C * RS;
  const raw* sv = sk + 2 * C * RS;
  float* ktil = reinterpret_cast<float*>(smem + 3 * C * RS * sizeof(raw));
  float* wsub = ktil + C * HS;                       // [NSB][HS]

  const int bh = blockIdx.x / a.n_chunks;
  const int c = blockIdx.x - bh * a.n_chunks;
  const int b = bh / a.H, h = bh - b * a.H;
  const int t0 = c * C;
  const int n = a.T - t0 < C ? a.T - t0 : C;
  const void* const src[4] = {a.k, a.w, a.v, a.v};
  stage_rows<Tr, HS, C, NT>(sk, a, src, 3, b * a.sb + h * a.sh, t0, n);
  cp_async_wait_all();
  __syncthreads();

  // suffix products inside each sub-block, then times the later
  // sub-blocks' totals
  for (int idx = threadIdx.x; idx < NSB * HS; idx += NT) {
    const int q = idx / HS, i = idx - q * HS;
    const int e = n < (q + 1) * kSub ? n : (q + 1) * kSub;
    float p = 1.f;
    for (int s = e - 1; s >= q * kSub; --s) {
      ktil[s * HS + i] = Tr::load(sk[s * RS + i]) * p;
      p *= Tr::load(sw[s * RS + i]);
    }
    wsub[q * HS + i] = p;
  }
  __syncthreads();
  const long long cs = static_cast<long long>(bh) * a.n_chunks + c;
  for (int idx = threadIdx.x; idx < NSB * HS; idx += NT) {
    const int q = idx / HS, i = idx - q * HS;
    const int e = n < (q + 1) * kSub ? n : (q + 1) * kSub;
    float later = 1.f;
    for (int q2 = q + 1; q2 < NSB; ++q2) later *= wsub[q2 * HS + i];
    for (int s = q * kSub; s < e; ++s) ktil[s * HS + i] *= later;
    if (q == 0) a.W[cs * HS + i] = later * wsub[i];
  }
  __syncthreads();

  const int j0 = (threadIdx.x % (HS / 4)) * 4;
  const int i0 = (threadIdx.x / (HS / 4)) * TI;
  float acc[TI][4];
#pragma unroll
  for (int e = 0; e < TI; ++e) acc[e][0] = acc[e][1] = acc[e][2] = acc[e][3] = 0.f;
  for (int s = 0; s < n; ++s) {
    const float4 vv = load4(sv + s * RS + j0);
#pragma unroll
    for (int e2 = 0; e2 < TI; e2 += 2) {
      const float2 kk =
          *reinterpret_cast<const float2*>(ktil + s * HS + i0 + e2);
      acc[e2][0] = fmaf(kk.x, vv.x, acc[e2][0]);
      acc[e2][1] = fmaf(kk.x, vv.y, acc[e2][1]);
      acc[e2][2] = fmaf(kk.x, vv.z, acc[e2][2]);
      acc[e2][3] = fmaf(kk.x, vv.w, acc[e2][3]);
      acc[e2 + 1][0] = fmaf(kk.y, vv.x, acc[e2 + 1][0]);
      acc[e2 + 1][1] = fmaf(kk.y, vv.y, acc[e2 + 1][1]);
      acc[e2 + 1][2] = fmaf(kk.y, vv.z, acc[e2 + 1][2]);
      acc[e2 + 1][3] = fmaf(kk.y, vv.w, acc[e2 + 1][3]);
    }
  }
  float* out = a.dS + cs * HS * HS + static_cast<long long>(i0) * HS + j0;
#pragma unroll
  for (int e = 0; e < TI; ++e)
    *reinterpret_cast<float4*>(out + e * HS) =
        make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
}

// Launch 2, one thread per state entry of a (b, h): walk the chunks in
// order, S <- W_c[i] S + dS_c, writing the state that enters chunk c to
// Sin_c and the last one out.  Reads s0 before it writes sT (same entry,
// same thread), so they may alias.
constexpr int kScanThreads = 256;

template <int HS>
__global__ void __launch_bounds__(kScanThreads) wkv6_chunk_scan(ChunkArgs a) {
  const int bh = blockIdx.x;
  const int e = blockIdx.y * kScanThreads + threadIdx.x;
  const int i = e / HS;
  const long long base = static_cast<long long>(bh) * HS * HS + e;
  float S = a.s0[base];
  constexpr long long kStride = static_cast<long long>(HS) * HS;
  const long long off = static_cast<long long>(bh) * a.n_chunks * kStride + e;
  const float* __restrict__ d = a.dS + off;
  float* __restrict__ entering = a.Sin + off;
  const float* __restrict__ wc =
      a.W + static_cast<long long>(bh) * a.n_chunks * HS + i;
#pragma unroll 8
  for (int c = 0; c < a.n_chunks; ++c) {
    entering[c * kStride] = S;
    S = fmaf(wc[c * HS], S, d[c * kStride]);
  }
  a.sT[base] = S;
}

// Launch 3, one block per (b, h, chunk): the chunk's outputs from the
// state entering it,
//   y = rhat S_in + A v,  rhat_t = r_t prod_{tau < t} w_tau,
//   A[t][s] = sum_i r_t[i] k_s[i] prod_{s < tau < t} w_tau[i] (s < t),
//   A[t][t] = sum_i r_t[i] u[i] k_t[i].
// With t in sub-block p and s in sub-block q, A[t][s] is, for q = p, a
// walk down from t-1 with running products (at most kSub - 1 steps), and
// for q < p a plain product of rtil_t = r_t prod_{16p <= tau < t} w_tau
// with khat_s = k_s prod_{s < tau < 16p} w_tau (both factors at most 1).
// Each thread owns a 2 x 4 tile of y.
template <typename Tr, int HS, int C>
struct OutLayout {
  using raw = typename Tr::raw;
  static constexpr int NSB = C / kSub;
  static constexpr int NPAIR = NSB * (NSB - 1) / 2;  // sub-blocks q < p
  static constexpr int NT = C * HS / 8;              // 2 x 4 tiles of y
  static constexpr int kTP = C + 4;                  // padded t rows
  static constexpr int RS = row_len<Tr, HS>();       // padded raw rows
  static constexpr int FS = HS + 4;                  // padded float rows
  static constexpr int kRaw = 4 * C * RS * static_cast<int>(sizeof(raw));
  static constexpr int kS = 0;                       // float offsets
  static constexpr int kRtil = kS + HS * HS;         // [C][FS]
  static constexpr int kRhatT = kRtil + C * FS;      // [HS][kTP]
  static constexpr int kKhat = kRhatT + HS * kTP;    // [NPAIR][kSub][FS]
  static constexpr int kWsub = kKhat + NPAIR * kSub * FS;
  static constexpr int kAT = kWsub + NSB * HS;       // [C][kTP]
  static constexpr int kU = kAT + C * kTP;
  static constexpr int kBytes = kRaw + (kU + HS) * 4;
};

template <typename Tr, int HS, int C>
__global__ void __launch_bounds__(OutLayout<Tr, HS, C>::NT)
wkv6_chunk_out(ChunkArgs a) {
  using raw = typename Tr::raw;
  using L = OutLayout<Tr, HS, C>;
  constexpr int NT = L::NT;
  constexpr int NSB = L::NSB;
  constexpr int kTP = L::kTP;
  constexpr int RS = L::RS;
  constexpr int FS = L::FS;
  static_assert(NT == 2 * NSB * HS && NT % 32 == 0, "tile shapes");
  extern __shared__ __align__(16) unsigned char smem[];
  raw* sr = reinterpret_cast<raw*>(smem);            // r, k, w, v: [C][RS]
  const raw* sk = sr + C * RS;
  const raw* sw = sr + 2 * C * RS;
  const raw* sv = sr + 3 * C * RS;
  float* f = reinterpret_cast<float*>(smem + L::kRaw);
  float* sS = f + L::kS;
  float* rtil = f + L::kRtil;
  float* rhatT = f + L::kRhatT;
  float* khat = f + L::kKhat;
  float* wsub = f + L::kWsub;
  float* AT = f + L::kAT;
  float* sU = f + L::kU;

  const int bh = blockIdx.x / a.n_chunks;
  const int c = blockIdx.x - bh * a.n_chunks;
  const int b = bh / a.H, h = bh - b * a.H;
  const int t0 = c * C;
  const int n = a.T - t0 < C ? a.T - t0 : C;
  const int tid = threadIdx.x;
  const void* const src[4] = {a.r, a.k, a.w, a.v};
  stage_rows<Tr, HS, C, NT>(sr, a, src, 4, b * a.sb + h * a.sh, t0, n);
  const float* s_in =
      a.Sin + (static_cast<long long>(bh) * a.n_chunks + c) * HS * HS;
  for (int idx = tid; idx < HS * HS / 4; idx += NT)
    cp_async16(sS + 4 * idx, s_in + 4 * idx);
  for (int i = tid; i < HS; i += NT)
    sU[i] = Tr::load(static_cast<const raw*>(a.u)[h * HS + i]);
  cp_async_wait_all();
  __syncthreads();

  // thread (i, q): prefix products inside sub-block q
  const int iq = tid % HS, q = tid / HS;
  const int q0 = q * kSub;
  const int qe = n < q0 + kSub ? n : q0 + kSub;
  if (q < NSB) {
    float p = 1.f;
    for (int t = q0; t < qe; ++t) {
      rtil[t * FS + iq] = Tr::load(sr[t * RS + iq]) * p;
      p *= Tr::load(sw[t * RS + iq]);
    }
    wsub[q * HS + iq] = p;
  }
  __syncthreads();
  // rhat = rtil times the earlier sub-blocks' totals; khat for every
  // later sub-block p: suffix products inside q times the totals of the
  // sub-blocks between q and p
  if (q < NSB) {
    float before = 1.f;
    for (int q2 = 0; q2 < q; ++q2) before *= wsub[q2 * HS + iq];
    for (int t = q0; t < qe; ++t)
      rhatT[iq * kTP + t] = rtil[t * FS + iq] * before;
    float p = 1.f;
    for (int s = qe - 1; s >= q0; --s) {
      const float ks = Tr::load(sk[s * RS + iq]) * p;
      float between = 1.f;
      for (int p2 = q + 1; p2 < NSB; ++p2) {
        khat[((p2 * (p2 - 1) / 2 + q) * kSub + s - q0) * FS + iq] =
            ks * between;
        between *= wsub[p2 * HS + iq];
      }
      p *= Tr::load(sw[s * RS + iq]);
    }
  }
  __syncthreads();

  // A, diagonal sub-blocks: the 8 lanes (t, g) sum rows i = 4 g + 32 m ..
  // + 3 of A[t][s], walking s down from t-1 to t's sub-block start with
  // x = r_t * prod_{s < tau < t} w_tau; acc[j] holds A[t][t-1-j]
  for (int t = tid / 8; t < C; t += NT / 8) {
    const int g = tid % 8;
    const int tq = t - t % kSub;
    float acc[kSub - 1];
#pragma unroll
    for (int j = 0; j < kSub - 1; ++j) acc[j] = 0.f;
    float diag = 0.f;
    if (t < n) {
#pragma unroll
      for (int i0 = 4 * g; i0 < HS; i0 += 32) {
        float4 x = load4(sr + t * RS + i0);
        diag = dot4(make_float4(x.x * sU[i0], x.y * sU[i0 + 1],
                                x.z * sU[i0 + 2], x.w * sU[i0 + 3]),
                    load4(sk + t * RS + i0), diag);
#pragma unroll
        for (int j = 0; j < kSub - 1; ++j) {
          const int s = t - 1 - j;
          if (s >= tq) {
            acc[j] = dot4(x, load4(sk + s * RS + i0), acc[j]);
            const float4 ws = load4(sw + s * RS + i0);
            x = make_float4(x.x * ws.x, x.y * ws.y, x.z * ws.z, x.w * ws.w);
          }
        }
      }
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
#pragma unroll
      for (int j = 0; j < kSub - 1; ++j)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
      diag += __shfl_xor_sync(0xffffffffu, diag, o);
    }
    if (g == 0) {                        // A[t][s] over t's sub-block
      AT[t * kTP + t] = diag;
#pragma unroll
      for (int j = 0; j < kSub - 1; ++j) {
        if (t - 1 - j >= tq) AT[(t - 1 - j) * kTP + t] = acc[j];
        if (t + 1 + j < tq + kSub) AT[(t + 1 + j) * kTP + t] = 0.f;
      }
    }
  }
  // A, sub-blocks q < p: 2 x 2 tiles of rtil_p . khat_(q,p)
  for (int tile = tid; tile < L::NPAIR * (kSub / 2) * (kSub / 2);
       tile += NT) {
    const int pr = tile / ((kSub / 2) * (kSub / 2));
    const int rem = tile - pr * ((kSub / 2) * (kSub / 2));
    int p = 1;
    while ((p + 1) * p / 2 <= pr) ++p;             // pair pr = (q, p)
    const int qq = pr - p * (p - 1) / 2;
    // rows t = ta, ta + 8 and s = sa, sa + 8: the 8 lanes of a phase
    // share ta and read 8 consecutive khat rows (distinct banks)
    const int ta = p * kSub + rem / 8;
    const int sa = rem % 8;                        // row within khat
    const float* r0 = rtil + ta * FS;
    const float* k0 = khat + (pr * kSub + sa) * FS;
    float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
#pragma unroll 4
    for (int i = 0; i < HS; i += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(r0 + i);
      const float4 x1 = *reinterpret_cast<const float4*>(r0 + 8 * FS + i);
      const float4 y0 = *reinterpret_cast<const float4*>(k0 + i);
      const float4 y1 = *reinterpret_cast<const float4*>(k0 + 8 * FS + i);
      a00 = dot4(x0, y0, a00);
      a01 = dot4(x0, y1, a01);
      a10 = dot4(x1, y0, a10);
      a11 = dot4(x1, y1, a11);
    }
    const int s = qq * kSub + sa;
    AT[s * kTP + ta] = a00;
    AT[(s + 8) * kTP + ta] = a01;
    AT[s * kTP + ta + 8] = a10;
    AT[(s + 8) * kTP + ta + 8] = a11;
  }
  __syncthreads();

  // y tile: steps tt, tt+1, columns j0 .. j0+3
  const int j0 = (tid % (HS / 4)) * 4;
  const int tt = (tid / (HS / 4)) * 2;
  float acc[2][4];
#pragma unroll
  for (int e = 0; e < 2; ++e) acc[e][0] = acc[e][1] = acc[e][2] = acc[e][3] = 0.f;
#pragma unroll 4
  for (int i = 0; i < HS; ++i)
    fma2x4(acc, *reinterpret_cast<const float2*>(rhatT + i * kTP + tt),
           *reinterpret_cast<const float4*>(sS + i * HS + j0));
  const int s_end = n < tt + 2 ? n : tt + 2;        // A[t][s] = 0 past t
  for (int s = 0; s < s_end; ++s)
    fma2x4(acc, *reinterpret_cast<const float2*>(AT + s * kTP + tt),
           load4(sv + s * RS + j0));
  raw* y = static_cast<raw*>(a.y);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (tt + e < n) {
      raw* out = y + ((static_cast<long long>(b) * a.T + t0 + tt + e) * a.H +
                      h) * HS + j0;
#pragma unroll
      for (int x = 0; x < 4; ++x) out[x] = Tr::store(acc[e][x]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------
template <typename Tr, int HS>
int launch_serial(const ChunkArgs& a, int B, cudaStream_t stream) {
  using raw = typename Tr::raw;
  wkv6_serial<Tr, HS><<<B * a.H, HS * kSplit, 0, stream>>>(
      static_cast<const raw*>(a.r), static_cast<const raw*>(a.k),
      static_cast<const raw*>(a.v), static_cast<const raw*>(a.w),
      static_cast<const raw*>(a.u), a.s0, static_cast<raw*>(a.y), a.sT, a.H,
      a.T, a.sb, a.st, a.sh);
  return static_cast<int>(cudaGetLastError());
}

// above 48 KB a block's dynamic shared memory needs the opt-in, once
template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename Tr, int HS, int C>
int launch_chunked(const ChunkArgs& a, int B, cudaStream_t stream) {
  using L = OutLayout<Tr, HS, C>;
  constexpr int kStateBytes =
      3 * C * row_len<Tr, HS>() * static_cast<int>(sizeof(typename Tr::raw)) +
      (C + C / kSub) * HS * 4;
  if constexpr (L::kBytes > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    static const cudaError_t ok_state =
        opt_in(wkv6_chunk_state<Tr, HS, C>, kStateBytes);
    static const cudaError_t ok_out =
        opt_in(wkv6_chunk_out<Tr, HS, C>, L::kBytes);
    if (ok_state != cudaSuccess) return static_cast<int>(ok_state);
    if (ok_out != cudaSuccess) return static_cast<int>(ok_out);
    const int blocks = B * a.H * a.n_chunks;
    if (blocks > 0) {
      wkv6_chunk_state<Tr, HS, C>
          <<<blocks, StateTile<HS>::NT, kStateBytes, stream>>>(a);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    wkv6_chunk_scan<HS>
        <<<dim3(B * a.H, HS * HS / kScanThreads), kScanThreads, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || blocks == 0) return static_cast<int>(err);
    wkv6_chunk_out<Tr, HS, C><<<blocks, L::NT, L::kBytes, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename Tr, int HS>
int launch_hs(const ChunkArgs& a, int B, int chunk, cudaStream_t s) {
  switch (chunk) {
    case 0: return launch_serial<Tr, HS>(a, B, s);
    case 16: return launch_chunked<Tr, HS, 16>(a, B, s);
    case 32: return launch_chunked<Tr, HS, 32>(a, B, s);
    case 64: return launch_chunked<Tr, HS, 64>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Tr>
int launch(const ChunkArgs& a, int B, int hs, int chunk, cudaStream_t s) {
  switch (hs) {
    case 32: return launch_hs<Tr, 32>(a, B, chunk, s);
    case 64: return launch_hs<Tr, 64>(a, B, chunk, s);
    case 128: return launch_hs<Tr, 128>(a, B, chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (r, k, v, w, u and y); state float32.
// sb/st/sh: the element strides of r/k/v/w over B, T and H (the last dim
// is contiguous).  s0 and sT may alias (the model advances its state in
// place).  chunk: 0 the serial design, else the chunked design with C =
// chunk (16, 32 or 64), which needs ``scratch``: B*H*ceil(T/C)*(2*hs*hs
// + hs) floats, 16-byte aligned.  Returns the first failed launch's
// cudaError_t (0 on success).
int repro_wkv6(const void* r, const void* k, const void* v, const void* w,
               const void* u, const float* s0, void* y, float* sT, int dtype,
               int B, int T, int H, int hs, long long sb, long long st,
               long long sh, int chunk, float* scratch, void* stream) {
  if (B < 1 || H < 1 || T < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long es = dtype == 0 ? 4 : 2;
  const bool vec = aligned16(r) && aligned16(k) && aligned16(v) &&
                   aligned16(w) && (sb * es) % 16 == 0 &&
                   (st * es) % 16 == 0 && (sh * es) % 16 == 0;
  const int n_chunks = chunk > 0 ? (T + chunk - 1) / chunk : 0;
  const long long states = static_cast<long long>(B) * H * n_chunks * hs * hs;
  float* Sin = scratch ? scratch + states : nullptr;
  float* W = scratch ? scratch + 2 * states : nullptr;
  const ChunkArgs a{r, k, v, w, u, s0, y, sT, scratch, Sin, W, H, T,
                    n_chunks, sb, st, sh, vec ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<F32>(a, B, hs, chunk, s);
  if (dtype == 1) return launch<BF16>(a, B, hs, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
