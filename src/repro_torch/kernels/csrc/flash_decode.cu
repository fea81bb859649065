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
// Built for D in {32, 64, 80, 112, 128, 256} and G = Hq / Hkv in 1..16.
// The group's heads take a capacity of 8 (G <= 8) or 16 (8 < G <= 16)
// rows of shared memory, a template parameter, so a call at G <= 8 runs
// the layout it always had.
//
// Function (exactly the Pallas kernels'): scale 1/sqrt(D); float32
// scores, max, sum and accumulator; positions >= lengths[b] (clamped to
// the cap) contribute nothing; the output is acc / max(l, 1e-20), so a
// 0-length lane gives 0; written in q's dtype (float32 or bf16).
//
// Bound on the H100: decode attention does 4 * Hq * D flops per context
// position and reads 2 * Hkv * D elements of K/V for it, about G = Hq/Hkv
// flops per byte in bf16 -- far below the ~295 flop/byte ridge.  So the
// least time is the bytes of the valid K/V, read once, over 3.35 TB/s.
// What the design does about it:
//   * split the context: the grid is (B, Hkv, n_split) and each block
//     owns one chunk of C positions of one (request, kv head), so a batch
//     of 4 short contexts still gives hundreds of blocks on 132 SMs (the
//     IS-S split of layers.decode_attention_core).  The wrapper picks C
//     and n_split = ceil(cap / C) from shapes alone; a block whose chunk
//     starts at or past lengths[b] writes an empty partial (l = 0) and
//     exits, so the call reads nothing back to the host and stays
//     capturable in a CUDA graph;
//   * one block covers all G query heads of its group, so each K/V row
//     is read from device memory once per group;
//   * the chunk's K and V rows are staged in shared memory with 16-byte
//     cp.async, K and V in two commit groups, so V is in flight while the
//     scores are computed; rows are padded by 16 bytes so that threads on
//     neighbouring rows hit different banks;
//   * the paged kernel reads the page ids of its chunk (C/page table
//     entries) itself, all at once into shared memory, and addresses the
//     pool in its native (P+1, page, Hkv, D) layout: no copy of the pool
//     is made;
//   * bf16 runs on the tensor cores (mma.sync m16n8k16, f32 accumulate):
//     scores S^T[pos, g] = K[pos, :] . Q^T[:, g] with the chunk's
//     positions as M, D as K and the group's heads as N = 8 (yi-6b has
//     G = 8; fewer heads are zero-padded; G = 9..16 takes two n8 tiles,
//     recurrentgemma-9b's MQA has G = 16), then O^T[d, g] = V^T[d, pos] .
//     P^T[pos, g] with V^T read through ldmatrix.trans and P rounded to
//     bf16 (l sums the rounded P, so the weights stay consistent);
//   * float32 keeps CUDA cores, for parity at 2e-5 (TF32 would not hold
//     it): a thread owns whole (position, head) pairs, each a D-long dot
//     product out of shared memory (no shuffle chain per score), and
//     (head, 16-byte slice of d) outputs for P.V;
//   * the chunk's max and sum come from one reduction per head (a warp
//     per head);
//   * each block writes its (acc[G][D], l[G], m[G]) in f32 to a scratch
//     buffer; a second small kernel combines the ceil(len/C) partials of
//     each (request, head) in one pass: out = sum_i e_i acc_i /
//     max(sum_i e_i l_i, 1e-20), e_i = exp(m_i - max_i m_i).
// Left on the table (the call is still ~5-8x its bound on the H100, see
// PERF.md): two launches per call, and the combine is a few us of
// dependent L2 reads (a "last block combines" design would make it one
// launch); the partials' round trip through L2; empty blocks are still
// launched up to the cap and hold their shared memory while they read
// lengths[b]; no TMA / wgmma (the serve's 32-position chunks do not fill
// their 64-row tiles).
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;      // query heads per kv head (G)
constexpr int kMaxChunk = 256;     // positions per block
constexpr int kMaxSmem = 232448;   // H100: opt-in shared memory per block
constexpr float kNeg = -1e30f;     // the Pallas kernels' masked score

template <typename R, int N>
struct alignas(sizeof(R) * N) Vec {
  R v[N];
};

// N consecutive elements in one vector load (p aligned to the vector).
template <typename Tr, int N>
__device__ __forceinline__ void load_vec(const typename Tr::raw* p,
                                         float (&out)[N]) {
  using raw = typename Tr::raw;
  const Vec<raw, N> x = *reinterpret_cast<const Vec<raw, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = Tr::load(x.v[i]);
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid
// (then nothing is read from src).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void* q;        // (B, Hq, D), strides q_sb, q_sh, 1
  const void* k;        // dense (B, S, Hkv, D) / paged (P+1, page, Hkv, D)
  const void* v;        // same shape and strides as k
  void* out;            // (B, Hq, D) contiguous
  float* acc;           // partials (B, Hkv, n_split, G, D)
  float* m;             // (B, Hkv, n_split, G)
  float* l;             // (B, Hkv, n_split, G)
  const int* tables;    // paged: (B, nblk), row stride t_sb; else null
  const int* lengths;   // (B,)
  long long q_sb, q_sh;
  long long kv_s0;      // dense: batch stride; paged: page stride
  long long kv_s1;      // dense: position stride; paged: row stride
  long long kv_sh;      // head stride
  long long t_sb;
  int hq, group, cap, page;   // cap: S (dense) or nblk * page (paged)
  int chunk, n_split;         // C positions per block, ceil(cap / C)
  float scale;
};

// Shared memory of one block: K and V rows of the chunk (each padded by
// 16 bytes), the group's pre-scaled q rows and the chunk's scores (GC
// rows each, GC the group capacity) and (paged) the chunk's page ids.
template <typename Tr, int D, int GC>
struct Smem {
  static constexpr int kRow = D * static_cast<int>(sizeof(typename Tr::raw))
                              + 16;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(typename Tr::raw));
  static constexpr int kPieces = D / kVec;   // 16-byte pieces per row
  static __host__ __device__ int score_stride(int chunk) { return chunk + 4; }
  static __host__ __device__ int page_ids(int chunk) {
    return 2 * chunk * kRow + GC * D * 4 + GC * score_stride(chunk) * 4;
  }
  static __host__ __device__ int bytes(int chunk) {
    return page_ids(chunk) + (chunk + 1) * 4;
  }
};

__device__ __forceinline__ int clamp_len(const Args& a, int b) {
  const int n = a.lengths[b];
  return n < 0 ? 0 : (n > a.cap ? a.cap : n);
}

// Paged: the page ids of the chunk's rows [start, start + nvalid), all
// read at once into pages[0..], so no row's copy waits on its own table
// read.  Ends in a barrier.
template <bool PAGED>
__device__ __forceinline__ void load_page_ids(const Args& a, int b,
                                              int start, int nvalid,
                                              int* pages) {
  if (!PAGED) return;
  const int first = start / a.page;
  const int n = (start + nvalid - 1) / a.page - first + 1;
  const int* trow = a.tables + b * a.t_sb + first;
  for (int i = threadIdx.x; i < n; i += kThreads) pages[i] = trow[i];
  __syncthreads();
}

// Lanes given to one row's 16-byte pieces: the next power of two at or
// above the piece count, so every row has the same lanes (D = 80 and 112
// leave 6 of 16 and 2 of 16 bf16 lanes, or 12 of 32 and 4 of 32 f32
// lanes, without a piece).
__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// Copy rows [start, start + nvalid) of head h into dst (chunk rows,
// padded); rows past nvalid are zero-filled.  A thread keeps one 16-byte
// piece of every kStep-th row, so a paged row's (page, offset) is carried
// from one of its rows to the next instead of divided out each time.
template <typename Tr, int D, bool PAGED>
__device__ __forceinline__ void stage_rows(const Args& a, const void* base,
                                           const int* pages,
                                           unsigned char* dst, int b, int h,
                                           int start, int nvalid) {
  using raw = typename Tr::raw;
  constexpr int kPieces = D * static_cast<int>(sizeof(raw)) / 16;
  constexpr int kVec = 16 / static_cast<int>(sizeof(raw));
  constexpr int kRow = D * static_cast<int>(sizeof(raw)) + 16;
  constexpr int kLanes = pow2_at_least(kPieces);
  constexpr int kStep = kThreads / kLanes;
  static_assert(kThreads % kLanes == 0, "whole rows per pass");
  const int c = threadIdx.x % kLanes;
  if (c >= kPieces) return;          // a lane past the row's pieces
  int r = threadIdx.x / kLanes;
  const raw* src0 = static_cast<const raw*>(base) + h * a.kv_sh + c * kVec;
  int blk = 0, off = 0;   // the row's entry in pages[] and offset in it
  long long page_base = 0;
  if (PAGED) {
    blk = (start + r) / a.page - start / a.page;
    off = (start + r) % a.page;
    if (r < nvalid) page_base = pages[blk] * a.kv_s0;
  }
  for (; r < a.chunk; r += kStep) {
    const bool ok = r < nvalid;
    const raw* src = src0;
    if (ok) {
      src += PAGED ? page_base + static_cast<long long>(off) * a.kv_s1
                   : b * a.kv_s0 + static_cast<long long>(start + r) * a.kv_s1;
    }
    cp_async16(dst + r * kRow + c * 16, src, ok);
    if (PAGED && (off += kStep) >= a.page) {
      do {
        off -= a.page;
        ++blk;
      } while (off >= a.page);
      if (r + kStep < nvalid) page_base = pages[blk] * a.kv_s0;
    }
  }
}

// grid (B, Hkv, n_split), kThreads threads, Smem::bytes(chunk) dynamic
// shared memory: the partial (acc, l, m) of one chunk of one group of at
// most GC heads.
template <typename Tr, int D, int GC, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const Args a) {
  using raw = typename Tr::raw;
  using S = Smem<Tr, D, GC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int G = a.group;
  const int C = a.chunk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long part =
      (static_cast<long long>(b) * gridDim.y + h) * a.n_split + split;
  const int len = clamp_len(a, b);
  const int start = split * C;
  if (start >= len) {                  // empty chunk: l = 0
    if (threadIdx.x < G) {
      a.m[part * G + threadIdx.x] = kNeg;
      a.l[part * G + threadIdx.x] = 0.f;
    }
    return;
  }
  const int nvalid = min(C, len - start);

  unsigned char* sk = smem;
  unsigned char* sv = sk + C * S::kRow;
  float* sq = reinterpret_cast<float*>(sv + C * S::kRow);
  float* ss = sq + GC * D;
  int* pages = reinterpret_cast<int*>(smem + S::page_ids(C));
  const int sst = S::score_stride(C);

  load_page_ids<PAGED>(a, b, start, nvalid, pages);
  stage_rows<Tr, D, PAGED>(a, a.k, pages, sk, b, h, start, nvalid);
  cp_async_commit();
  stage_rows<Tr, D, PAGED>(a, a.v, pages, sv, b, h, start, nvalid);
  cp_async_commit();

  // the group's G query rows, pre-scaled, while K and V are in flight
  const raw* qp = static_cast<const raw*>(a.q) + b * a.q_sb +
                  static_cast<long long>(h) * G * a.q_sh;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    sq[i] = Tr::load(qp[g * a.q_sh + (i - g * D)]) * a.scale;
  }
  cp_async_wait<1>();
  __syncthreads();

  // scores: thread owns (position, head) pairs; a warp's lanes take
  // neighbouring positions of one head (q reads are broadcasts)
  for (int i = threadIdx.x; i < G * C; i += kThreads) {
    const int g = i / C;
    const int p = i - g * C;
    if (p >= nvalid) continue;
    const raw* kr = reinterpret_cast<const raw*>(sk + p * S::kRow);
    const float* qr = sq + g * D;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < S::kPieces; ++c) {
      float kf[S::kVec];
      load_vec<Tr, S::kVec>(kr + c * S::kVec, kf);
#pragma unroll
      for (int j = 0; j < S::kVec; ++j)
        s = fmaf(qr[c * S::kVec + j], kf[j], s);
    }
    ss[g * sst + p] = s;
  }
  __syncthreads();

  // the chunk's max and sum per head, one warp per head; p = exp(s - m)
  for (int g = warp; g < G; g += kWarps) {
    float* row = ss + g * sst;
    float mx = kNeg;
    for (int p = lane; p < nvalid; p += 32) mx = fmaxf(mx, row[p]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int p = lane; p < nvalid; p += 32) {
      const float e = expf(row[p] - mx);
      row[p] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      a.m[part * G + g] = mx;
      a.l[part * G + g] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // P.V: thread owns (head, 16-byte slice of d) outputs
  for (int i = threadIdx.x; i < G * S::kPieces; i += kThreads) {
    const int g = i / S::kPieces;
    const int c = i - g * S::kPieces;
    const float* pr = ss + g * sst;
    const raw* vc = reinterpret_cast<const raw*>(sv) + c * S::kVec;
    float o[S::kVec];
#pragma unroll
    for (int j = 0; j < S::kVec; ++j) o[j] = 0.f;
    for (int p = 0; p < nvalid; ++p) {
      float vf[S::kVec];
      load_vec<Tr, S::kVec>(vc + p * (S::kRow / sizeof(raw)), vf);
      const float w = pr[p];
#pragma unroll
      for (int j = 0; j < S::kVec; ++j) o[j] = fmaf(w, vf[j], o[j]);
    }
    float4* dst = reinterpret_cast<float4*>(a.acc + (part * G + g) * D +
                                            c * S::kVec);
#pragma unroll
    for (int j = 0; j < S::kVec / 4; ++j)
      dst[j] = make_float4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
  }
}

// ---- bf16 on the tensor cores (mma.sync m16n8k16, f32 accumulate) ----

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of the bf16 tensor-core block: K and V rows (padded by
// 16 bytes), the group's q rows in bf16 (GC rows, zero past G), the
// chunk's f32 scores and its probabilities in bf16 (GC rows each), and
// (paged) the chunk's page ids.  GC, the group capacity, is 8 or 16.
template <int D, int GC>
struct MmaSmem {
  static constexpr int kRow = 2 * D + 16;
  static constexpr int kPieces = D / 8;
  static __host__ __device__ int score_stride(int chunk) { return chunk + 4; }
  static __host__ __device__ int p_row(int chunk) { return 2 * chunk + 16; }
  static __host__ __device__ int page_ids(int chunk) {
    return (2 * chunk + GC) * kRow +
           GC * (score_stride(chunk) * 4 + p_row(chunk));
  }
  static __host__ __device__ int bytes(int chunk) {
    return page_ids(chunk) + (chunk + 1) * 4;
  }
};

// grid (B, Hkv, n_split), kThreads threads, MmaSmem::bytes(chunk)
// dynamic shared memory: the partial of one chunk of one group, bf16.
// Scores S^T[pos, g] = K[pos, :] . Q^T[:, g] (M = positions, N = the
// group's heads padded to GC, one n8 tile per 8 heads, K = D);
// O^T[d, g] = V^T[d, pos] . P^T[pos, g] (M = D, N = heads, K = positions;
// V^T through ldmatrix.trans, each V tile used by every head tile).
template <int D, int GC, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_partial_mma_kernel(const Args a) {
  using S = MmaSmem<D, GC>;
  constexpr int kNT = GC / 8;          // n8 tiles of heads
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int G = a.group;
  const int C = a.chunk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long part =
      (static_cast<long long>(b) * gridDim.y + h) * a.n_split + split;
  const int len = clamp_len(a, b);
  const int start = split * C;
  if (start >= len) {                  // empty chunk: l = 0
    if (threadIdx.x < G) {
      a.m[part * G + threadIdx.x] = kNeg;
      a.l[part * G + threadIdx.x] = 0.f;
    }
    return;
  }
  const int nvalid = min(C, len - start);
  const int ntile = (nvalid + 15) / 16;   // 16-position tiles holding data

  unsigned char* sk = smem;
  unsigned char* sv = sk + C * S::kRow;
  unsigned char* sq = sv + C * S::kRow;
  float* ss = reinterpret_cast<float*>(sq + GC * S::kRow);
  unsigned char* sp = reinterpret_cast<unsigned char*>(
      ss + GC * S::score_stride(C));
  int* pages = reinterpret_cast<int*>(smem + S::page_ids(C));
  const int sst = S::score_stride(C);
  const int spr = S::p_row(C);

  // q rows (zero past G) join K's commit group; V is the second group
  const uint16_t* qp = static_cast<const uint16_t*>(a.q) + b * a.q_sb +
                       static_cast<long long>(h) * G * a.q_sh;
  for (int i = threadIdx.x; i < GC * S::kPieces; i += kThreads) {
    const int g = i / S::kPieces;
    const int c = i - g * S::kPieces;
    cp_async16(sq + g * S::kRow + c * 16,
               g < G ? qp + g * a.q_sh + c * 8 : qp, g < G);
  }
  load_page_ids<PAGED>(a, b, start, nvalid, pages);
  stage_rows<BF16, D, PAGED>(a, a.k, pages, sk, b, h, start, nvalid);
  cp_async_commit();
  stage_rows<BF16, D, PAGED>(a, a.v, pages, sv, b, h, start, nvalid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // scores: warp w takes the 16-position tiles w, w + kWarps, ...
  {
    unsigned qf[kNT][D / 16][2];       // B fragments of all of D
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 32) {
        unsigned r[4];
        ldmatrix_x4(r, sq + (nt * 8 + (lane & 7)) * S::kRow +
                           (k0 + (lane >> 3) * 8) * 2);
        qf[nt][k0 / 16][0] = r[0];
        qf[nt][k0 / 16][1] = r[1];
        if (k0 + 16 < D) {
          qf[nt][k0 / 16 + 1][0] = r[2];
          qf[nt][k0 / 16 + 1][1] = r[3];
        }
      }
    }
    for (int mt = warp; mt < ntile; mt += kWarps) {
      float c[kNT][4] = {};
      const unsigned char* arow = sk + (mt * 16 + (lane & 15)) * S::kRow +
                                  (lane >> 4) * 16;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        unsigned af[4];
        ldmatrix_x4(af, arow + ks * 32);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_bf16(c[nt], af, qf[nt][ks][0], qf[nt][ks][1]);
      }
      const int p = mt * 16 + (lane >> 2);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int g = nt * 8 + (lane & 3) * 2;
        ss[g * sst + p] = c[nt][0] * a.scale;
        ss[(g + 1) * sst + p] = c[nt][1] * a.scale;
        ss[g * sst + p + 8] = c[nt][2] * a.scale;
        ss[(g + 1) * sst + p + 8] = c[nt][3] * a.scale;
      }
    }
  }
  __syncthreads();

  // the chunk's max and sum per head, one warp per head; P in bf16, zero
  // past nvalid and for the padding heads, so the P.V tiles add nothing
  for (int g = warp; g < GC; g += kWarps) {
    const float* row = ss + g * sst;
    uint16_t* prow = reinterpret_cast<uint16_t*>(sp + g * spr);
    if (g >= G) {
      for (int p = lane; p < ntile * 16; p += 32) prow[p] = 0;
      continue;
    }
    float mx = kNeg;
    for (int p = lane; p < nvalid; p += 32) mx = fmaxf(mx, row[p]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int p = lane; p < ntile * 16; p += 32) {
      uint16_t e = 0;
      if (p < nvalid) {
        e = BF16::store(expf(row[p] - mx));
        sum += BF16::load(e);          // l of the rounded P that P.V uses
      }
      prow[p] = e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      a.m[part * G + g] = mx;
      a.l[part * G + g] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // P.V: warp w takes the 16-wide slices of d w, w + kWarps, ...
  for (int dt = warp; dt < D / 16; dt += kWarps) {
    float c[kNT][4] = {};
    const unsigned char* vrow = sv + ((lane & 7) + (lane >> 4) * 8) * S::kRow +
                                (dt * 16 + ((lane >> 3) & 1) * 8) * 2;
    const unsigned char* prow = sp + (lane & 7) * spr +
                                ((lane >> 3) & 1) * 16;
    for (int k0 = 0; k0 < ntile * 16; k0 += 16) {
      unsigned vf[4];
      ldmatrix_x4_trans(vf, vrow + k0 * S::kRow);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        unsigned pf[2];
        ldmatrix_x2(pf, prow + nt * 8 * spr + k0 * 2);
        mma_bf16(c[nt], vf, pf[0], pf[1]);
      }
    }
    const int d = dt * 16 + (lane >> 2);
    float* dst = a.acc + part * G * D;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int g = nt * 8 + (lane & 3) * 2;
      if (g < G) {
        dst[g * D + d] = c[nt][0];
        dst[g * D + d + 8] = c[nt][2];
      }
      if (g + 1 < G) {
        dst[(g + 1) * D + d] = c[nt][1];
        dst[(g + 1) * D + d + 8] = c[nt][3];
      }
    }
  }
}

// grid (B, Hq), kCombineWays * D threads: out[b, hq, d] from the
// ceil(len / C) partials of (b, hq / G).  Thread (j, d) walks the
// partials i = j mod kCombineWays in one pass with its own running max
// (every load of the pass is independent of the others), and the
// kCombineWays running (max, l, acc) are merged once in shared memory:
// out = sum_j e_j acc_j / max(sum_j e_j l_j, 1e-20), e_j = exp(m_j - max m).
constexpr int kCombineWays = 4;

template <typename Tr, int D>
__global__ void __launch_bounds__(kCombineWays * D)
decode_combine_kernel(const Args a) {
  __shared__ float sm[kCombineWays], sl[kCombineWays];
  __shared__ float sacc[kCombineWays][D];
  const int b = blockIdx.x;
  const int hq = blockIdx.y;
  const int j = threadIdx.x / D;
  const int d = threadIdx.x - j * D;
  const int G = a.group;
  const int h = hq / G;
  const int n = (clamp_len(a, b) + a.chunk - 1) / a.chunk;
  // (m, l) of partial i of this head at [i * G]; its acc at [i * G * D]
  const long long base =
      (static_cast<long long>(b) * (a.hq / G) + h) * a.n_split * G + hq -
      h * G;
  const float* m = a.m + base;
  const float* l = a.l + base;
  const float* acc = a.acc + base * D + d;
  float mx = kNeg, ls = 0.f, as = 0.f;
#pragma unroll 4
  for (int i = j; i < n; i += kCombineWays) {
    const float mi = m[i * G];
    const float li = l[i * G];
    const float ai = acc[static_cast<long long>(i) * G * D];
    const float mn = fmaxf(mx, mi);
    const float c = expf(mx - mn);
    const float e = expf(mi - mn);
    ls = fmaf(ls, c, li * e);
    as = fmaf(as, c, ai * e);
    mx = mn;
  }
  sacc[j][d] = as;
  if (d == 0) {
    sm[j] = mx;
    sl[j] = ls;
  }
  __syncthreads();
  if (j) return;
  float mmax = sm[0];
#pragma unroll
  for (int w = 1; w < kCombineWays; ++w) mmax = fmaxf(mmax, sm[w]);
  float lsum = 0.f, asum = 0.f;
#pragma unroll
  for (int w = 0; w < kCombineWays; ++w) {
    const float e = expf(sm[w] - mmax);
    lsum = fmaf(sl[w], e, lsum);
    asum = fmaf(sacc[w][d], e, asum);
  }
  static_cast<typename Tr::raw*>(a.out)[(static_cast<long long>(b) * a.hq +
                                         hq) * D + d] =
      Tr::store(asum / fmaxf(lsum, 1e-20f));
}

// bf16 runs the tensor-core partial kernel, f32 the CUDA-core one
template <typename Tr, int D, int GC, bool PAGED>
constexpr auto partial_kernel() {
  if constexpr (std::is_same_v<Tr, BF16>)
    return decode_partial_mma_kernel<D, GC, PAGED>;
  else
    return decode_partial_kernel<Tr, D, GC, PAGED>;
}

template <typename Tr, int D, int GC>
int partial_smem(int chunk) {
  if constexpr (std::is_same_v<Tr, BF16>) return MmaSmem<D, GC>::bytes(chunk);
  else return Smem<Tr, D, GC>::bytes(chunk);
}

template <typename Tr, int D, int GC, bool PAGED>
int launch(const Args& a, int batch, int hkv, cudaStream_t stream) {
  const int smem = partial_smem<Tr, D, GC>(a.chunk);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = partial_kernel<Tr, D, GC, PAGED>();
  // above 48 KB a block's dynamic shared memory needs the opt-in, once
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  kernel<<<dim3(batch, hkv, a.n_split), kThreads, smem, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // D = 256 gives 1024 threads, the most a block may have
  decode_combine_kernel<Tr, D>
      <<<dim3(batch, a.hq), kCombineWays * D, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the group capacity: 8 rows of heads up to G = 8 (every layout the
// kernels had before G = 16), 16 above
template <typename Tr, int D, bool PAGED>
int launch_g(const Args& a, int batch, int hkv, cudaStream_t s) {
  if (a.group <= 8) return launch<Tr, D, 8, PAGED>(a, batch, hkv, s);
  return launch<Tr, D, 16, PAGED>(a, batch, hkv, s);
}

template <typename Tr, bool PAGED>
int launch_d(const Args& a, int batch, int hkv, int d, cudaStream_t s) {
  switch (d) {
    case 32: return launch_g<Tr, 32, PAGED>(a, batch, hkv, s);
    case 64: return launch_g<Tr, 64, PAGED>(a, batch, hkv, s);
    case 80: return launch_g<Tr, 80, PAGED>(a, batch, hkv, s);
    case 112: return launch_g<Tr, 112, PAGED>(a, batch, hkv, s);
    case 128: return launch_g<Tr, 128, PAGED>(a, batch, hkv, s);
    case 256: return launch_g<Tr, 256, PAGED>(a, batch, hkv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool PAGED>
int dispatch(const Args& a, int dtype, int batch, int hkv, int d,
             void* stream) {
  if (a.group < 1 || a.group > kMaxGroup || batch < 1 || hkv < 1 ||
      a.chunk < 16 || a.chunk > kMaxChunk || a.chunk % 16 ||
      a.n_split < 1 || a.n_split > 65535 ||
      static_cast<long long>(a.n_split) * a.chunk < a.cap)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<F32, PAGED>(a, batch, hkv, d, s);
  if (dtype == 1) return launch_d<BF16, PAGED>(a, batch, hkv, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the Pallas kernels' scale, 1 / sqrt(D) rounded once to float32
float inv_sqrt(int d) { return static_cast<float>(1.0 / sqrt(static_cast<double>(d))); }

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  Strides are in elements.  acc/m/l are
// f32 scratch of (B, Hkv, n_split, G, D) / (B, Hkv, n_split, G) each.
// Two launches (partials, combine) on `stream`; returns the cudaError_t
// of the launches (0 on success).
int repro_flash_decode(const void* q, const void* k, const void* v,
                       void* out, const int* lengths, float* acc, float* m,
                       float* l, int dtype, int batch, int hq, int hkv,
                       int d, int seq, int chunk, int n_split,
                       long long q_sb, long long q_sh, long long k_sb,
                       long long k_ss, long long k_sh, void* stream) {
  Args a{q, k, v, out, acc, m, l, nullptr, lengths, q_sb, q_sh, k_sb, k_ss,
         k_sh, 0, hq, hkv > 0 ? hq / hkv : 0, seq, 0, chunk, n_split,
         inv_sqrt(d)};
  return dispatch<false>(a, dtype, batch, hkv, d, stream);
}

int repro_paged_flash_decode(const void* q, const void* k_pool,
                             const void* v_pool, void* out,
                             const int* tables, const int* lengths,
                             float* acc, float* m, float* l, int dtype,
                             int batch, int hq, int hkv, int d, int page,
                             int nblk, int chunk, int n_split,
                             long long q_sb, long long q_sh, long long p_sp,
                             long long p_sr, long long p_sh, long long t_sb,
                             void* stream) {
  Args a{q, k_pool, v_pool, out, acc, m, l, tables, lengths, q_sb, q_sh,
         p_sp, p_sr, p_sh, t_sb, hq, hkv > 0 ? hq / hkv : 0, nblk * page,
         page, chunk, n_split, inv_sqrt(d)};
  return dispatch<true>(a, dtype, batch, hkv, d, stream);
}

}  // extern "C"
