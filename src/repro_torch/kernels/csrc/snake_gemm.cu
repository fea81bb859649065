// SNAKE decode GEMM for Hopper (sm_90a): out (M, N) = a (M, K) @ b (K, N)
// for small M (decode batches), float32 accumulation, out in a's dtype.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/snake_gemm.py
// (snake_decode_gemm: _is_kernel, _os_kernel) -> repro_snake_gemm, with
// the two dataflows the mapping (kernels/snake_gemm.py::choose_mapping)
// picks per shape, as two instantiations of one kernel:
//   IS (input-stationary): the block's rows of A for its whole K chunk are
//       loaded into shared memory once, before the sweep, while B streams;
//   OS (output-stationary): A is staged beside B in every ring stage while
//       the float32 accumulator stays in registers.
//
// Bound on the H100: at decode M the product does 2 M flops per element
// of B it reads, far below the ~295 flop/byte ridge, so the least time is
// the bytes of B over 3.35 TB/s.  What the design does about it:
//   * split K across blocks: the grid is (ceil(N / 128), ceil(M / rows),
//     n_split) and each block owns a 128-column output tile of one K chunk
//     of bk rows (a multiple of 16).  The wrapper picks bk from shapes
//     alone (snake_gemm.py::split_k_plan: 2 blocks per SM, and no more
//     than one wave of resident blocks), so a call reads nothing back and
//     is capturable in a CUDA graph;
//   * one launch, deterministic: with n_split > 1 each block writes its
//     float32 partial tile to a workspace (n_split, M, N), then
//     __threadfence and an atomicAdd on the tile's counter; the block that
//     arrives last sums the tile's partials in split order, writes out and
//     sets the counter back to 0 for the next call or graph replay.  The
//     wrapper allocates the workspace and the counters;
//   * B (and A for OS) are staged with 16-byte cp.async into a ring of
//     kStages stages of 16 KB of B each, so about 48 KB of B per block is
//     in flight while one stage is computed; rows are padded by 16 bytes so
//     ldmatrix reads hit distinct banks.  Rows past M, columns past N and K
//     past the chunk are zero-filled through cp.async's source size, so a
//     ragged shape takes the same path.  Only when a row of A or B does not
//     start on 16 bytes (a contiguous B with N % 8 != 0, say) are the
//     pieces read element by element instead (VEC = false; same staging
//     layout, same compute);
//   * bf16 on the tensor cores: mma.sync m16n8k16 with 16 columns of N on
//     the mma's M and the batch rows on its N, so a decode batch of 4 pads
//     to 8, not 16 (a 16-row tile is two n8 tiles and the second is
//     skipped when it holds no row).  The B tile is read through
//     ldmatrix.trans, the rows of A through ldmatrix; each of the 8 warps
//     owns 16 columns, so no partial sums meet across warps;
//   * float32 stays on CUDA-core FMA (no TF32, for parity): a thread owns 4
//     columns x 8 rows, the warps split each stage's K rows, and the
//     warps' sums meet once in shared memory at the end of the chunk.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 128;        // output columns per block
constexpr int kStages = 4;          // cp.async ring depth
constexpr int kStageBytes = 16384;  // bytes of B per ring stage
constexpr int kMaxSmem = 232448;    // shared memory one H100 block can use

struct Args {
  const void* a;     // (M, K), row stride lda, last dim contiguous
  const void* b;     // (K, N), row stride ldb, last dim contiguous
  void* out;         // (M, N) contiguous
  float* ws;         // (n_split, M, N) float32 partials (n_split > 1)
  int* counters;     // one per output tile, 0 between calls
  int M, N, K, bk, n_split;
  long long lda, ldb;
};

// Shared memory of one block: kStages ring slots, each a stage of B
// (kStageK rows of kBlockN, padded) and, for OS, the stage's rows of A;
// for IS the chunk's rows of A after the ring.
template <typename Tr, bool IS>
struct Tile {
  using raw = typename Tr::raw;
  static constexpr int kEsize = sizeof(raw);
  static constexpr int kRows = kEsize == 4 ? 8 : 16;     // row tile
  static constexpr int kVec = 16 / kEsize;               // elements / piece
  static constexpr int kStageK = kStageBytes / (kBlockN * kEsize);
  static constexpr int kBRow = kBlockN * kEsize + 16;
  static constexpr int kAStageRow = kStageK * kEsize + 16;
  static constexpr int kBStage = kStageK * kBRow;
  static constexpr int kSlot = kBStage + (IS ? 0 : kRows * kAStageRow);
  static constexpr int kRing = kStages * kSlot;
  // bytes of one IS row of A holding a chunk of bk
  static __host__ __device__ int a_row(int bk) {
    return (bk + kStageK - 1) / kStageK * kStageK * kEsize + 16;
  }
  static __host__ __device__ size_t bytes(int bk) {
    return kRing + (IS ? static_cast<size_t>(kRows) * a_row(bk) : 0);
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, bypassing L1; only the first `bytes` are
// read (0 reads nothing) and the rest of the 16 are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 16-byte piece: the first n (0..kVec) elements of src, zeros after.
template <typename Tr, bool VEC>
__device__ __forceinline__ void stage_piece(unsigned char* dst,
                                            const typename Tr::raw* src,
                                            int n) {
  using raw = typename Tr::raw;
  constexpr int V = 16 / sizeof(raw);
  if (VEC) {
    cp_async16(dst, src, n * static_cast<int>(sizeof(raw)));
  } else {
    union {
      uint4 u;
      raw e[V];
    } x;
#pragma unroll
    for (int c = 0; c < V; ++c) x.e[c] = c < n ? src[c] : static_cast<raw>(0);
    *reinterpret_cast<uint4*>(dst) = x.u;
  }
}

__device__ __forceinline__ int clamp_to(int x, int hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

// B rows [kb, kb + kStageK) of the block's columns into a ring slot; rows
// at or past kend and columns past N are zero.
template <typename Tr, bool IS, bool VEC>
__device__ __forceinline__ void stage_b(const Args& g, unsigned char* dst,
                                        int kb, int kend, int n0) {
  using T = Tile<Tr, IS>;
  using raw = typename Tr::raw;
  constexpr int kPieces = kBlockN / T::kVec;
  const raw* b = static_cast<const raw*>(g.b);
  for (int i = threadIdx.x; i < T::kStageK * kPieces; i += kThreads) {
    const int r = i / kPieces;
    const int p = i - r * kPieces;
    const int k = kb + r;
    const int col = n0 + p * T::kVec;
    const int n = k < kend ? clamp_to(g.N - col, T::kVec) : 0;
    stage_piece<Tr, VEC>(dst + r * T::kBRow + p * 16,
                         n ? b + k * g.ldb + col : b, n);
  }
}

// A rows [m0, m0 + kRows) x K [kb, kb + kk) into dst (row stride
// row_bytes); rows past M and K at or past kend are zero.
template <typename Tr, bool IS, bool VEC>
__device__ __forceinline__ void stage_a(const Args& g, unsigned char* dst,
                                        int row_bytes, int m0, int kb,
                                        int kk, int kend) {
  using T = Tile<Tr, IS>;
  using raw = typename Tr::raw;
  const raw* a = static_cast<const raw*>(g.a);
  const int pieces = kk / T::kVec;
  for (int i = threadIdx.x; i < T::kRows * pieces; i += kThreads) {
    const int m = i / pieces;
    const int p = i - m * pieces;
    const int k = kb + p * T::kVec;
    const int row = m0 + m;
    const int n = row < g.M ? clamp_to(kend - k, T::kVec) : 0;
    stage_piece<Tr, VEC>(dst + m * row_bytes + p * 16,
                         n ? a + row * g.lda + k : a, n);
  }
}

// The block's value v of out[row, col]: straight to out when K is not
// split, else to the workspace row of its split.
template <typename Tr>
__device__ __forceinline__ void emit(const Args& g, int row, int col,
                                     float v) {
  if (row >= g.M || col >= g.N) return;
  const long long i = static_cast<long long>(row) * g.N + col;
  if (g.n_split == 1)
    static_cast<typename Tr::raw*>(g.out)[i] = Tr::store(v);
  else
    g.ws[static_cast<long long>(blockIdx.z) * g.M * g.N + i] = v;
}

// grid (ceil(N / kBlockN), ceil(M / kRows), n_split), kThreads threads,
// Tile::bytes(bk) dynamic shared memory.
// Registers for kRegBlocks blocks per SM (snake_gemm.py REG_BLOCKS, which
// the split plan counts on): at most 64 a thread for bf16, 85 for f32.
template <typename Tr>
constexpr int kRegBlocks = sizeof(typename Tr::raw) == 2 ? 4 : 3;

template <typename Tr, bool IS, bool VEC>
__global__ void __launch_bounds__(kThreads, kRegBlocks<Tr>)
snake_gemm_kernel(const Args g) {
  using T = Tile<Tr, IS>;
  constexpr bool kMma = sizeof(typename Tr::raw) == 2;
  constexpr int SK = T::kStageK;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * kBlockN;
  const int m0 = blockIdx.y * T::kRows;
  const int kbeg = blockIdx.z * g.bk;
  const int kend = min(g.K, kbeg + g.bk);
  const int nst = (kend - kbeg + SK - 1) / SK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* a_is = smem + T::kRing;
  const int a_is_row = T::a_row(g.bk);

  auto stage = [&](int s) {
    unsigned char* slot = smem + (s % kStages) * T::kSlot;
    stage_b<Tr, IS, VEC>(g, slot, kbeg + s * SK, kend, n0);
    if (!IS)
      stage_a<Tr, IS, VEC>(g, slot + T::kBStage, T::kAStageRow, m0,
                           kbeg + s * SK, SK, kend);
  };
  if (IS)   // the chunk's rows of A join the first stage's group
    stage_a<Tr, IS, VEC>(g, a_is, a_is_row, m0, kbeg, nst * SK, kend);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) stage(s);
    cp_async_commit();
  }

  // bf16: warp w owns columns [16 w, 16 w + 16) and both n8 row tiles;
  // f32: thread (warp, lane) owns columns [4 lane, 4 lane + 4) of all 8
  // rows over the stage rows warp, warp + kWarps, ...
  static_assert(!kMma || kBlockN == 16 * kWarps, "a column tile per warp");
  static_assert(kMma || kBlockN == 4 * 32, "4 columns per lane");
  constexpr int kAcc = kMma ? 2 : T::kRows;
  float acc[kAcc][4];
#pragma unroll
  for (int i = 0; i < kAcc; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const bool two = m0 + 8 < g.M;   // the second n8 tile holds a row

  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < nst) stage(s + kStages - 1);
    cp_async_commit();
    const unsigned char* slot = smem + (s % kStages) * T::kSlot;
    const unsigned char* as = IS ? a_is + s * SK * T::kEsize : slot + T::kBStage;
    const int arow = IS ? a_is_row : T::kAStageRow;
    if constexpr (kMma) {
      const unsigned char* bp = slot +
          ((lane & 7) + (lane >> 4) * 8) * T::kBRow +
          (warp * 16 + ((lane >> 3) & 1) * 8) * 2;
      const unsigned char* ap = as + (lane & 7) * arow + ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int ks = 0; ks < SK / 16; ++ks) {
        unsigned bf[4], af[2];
        ldmatrix_x4_trans(bf, bp + ks * 16 * T::kBRow);
        ldmatrix_x2(af, ap + ks * 32);
        mma_bf16(acc[0], bf, af);
        if (two) {
          ldmatrix_x2(af, ap + 8 * arow + ks * 32);
          mma_bf16(acc[1], bf, af);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < SK / kWarps; ++j) {
        const int kk = warp + j * kWarps;
        const float4 bv =
            *reinterpret_cast<const float4*>(slot + kk * T::kBRow + lane * 16);
#pragma unroll
        for (int m = 0; m < T::kRows; ++m) {
          const float am = *reinterpret_cast<const float*>(as + m * arow + kk * 4);
          acc[m][0] = fmaf(am, bv.x, acc[m][0]);
          acc[m][1] = fmaf(am, bv.y, acc[m][1]);
          acc[m][2] = fmaf(am, bv.z, acc[m][2]);
          acc[m][3] = fmaf(am, bv.w, acc[m][3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free from here on

  if constexpr (kMma) {
    // c[0] (col i, row j), c[1] (i, j + 1), c[2] (i + 8, j), c[3] (i + 8,
    // j + 1), with i = lane / 4 and j = 2 (lane % 4) in the n8 tile
    const int col = n0 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int row = m0 + t * 8 + (lane & 3) * 2;
      emit<Tr>(g, row, col, acc[t][0]);
      emit<Tr>(g, row + 1, col, acc[t][1]);
      emit<Tr>(g, row, col + 8, acc[t][2]);
      emit<Tr>(g, row + 1, col + 8, acc[t][3]);
    }
  } else {
    // the warps' sums over their K rows meet once, in warp order
    static_assert(kWarps * T::kRows * kBlockN * 4 <= T::kRing,
                  "the cross-warp sums fit the ring");
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int m = 0; m < T::kRows; ++m)
      *reinterpret_cast<float4*>(red + (warp * T::kRows + m) * kBlockN +
                                 lane * 4) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    __syncthreads();
    for (int i = threadIdx.x; i < T::kRows * kBlockN; i += kThreads) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w * T::kRows * kBlockN + i];
      emit<Tr>(g, m0 + i / kBlockN, n0 + i % kBlockN, v);
    }
  }
  if (g.n_split == 1) return;

  // the last block of this output tile to arrive sums its partials; its
  // flag lives at the end of the ring, past the f32 cross-warp sums
  static_assert(kMma || kWarps * T::kRows * kBlockN * 4 + 16 <= T::kRing,
                "the flag clears the cross-warp sums");
  int& last = *reinterpret_cast<int*>(smem + T::kRing - 16);
  __threadfence();
  __syncthreads();
  int* counter = g.counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == g.n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int rows = min(T::kRows, g.M - m0);
  const long long plane = static_cast<long long>(g.M) * g.N;
  for (int i = threadIdx.x; i < rows * kBlockN; i += kThreads) {
    const int row = m0 + i / kBlockN;
    const int col = n0 + i % kBlockN;
    if (col >= g.N) continue;
    const long long o = static_cast<long long>(row) * g.N + col;
    const float* p = g.ws + o;
    float v = 0.f;
#pragma unroll 8
    for (int s = 0; s < g.n_split; ++s) v += __ldcg(p + s * plane);
    static_cast<typename Tr::raw*>(g.out)[o] = Tr::store(v);
  }
  if (threadIdx.x == 0) *counter = 0;
}

template <typename Tr, bool IS, bool VEC>
int launch(const Args& g, cudaStream_t stream) {
  using T = Tile<Tr, IS>;
  const size_t smem = T::bytes(g.bk);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = snake_gemm_kernel<Tr, IS, VEC>;
  // once per instantiation, so no launch after the first (one inside a
  // CUDA graph capture, say) makes another runtime call
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid((g.N + kBlockN - 1) / kBlockN,
                  (g.M + T::kRows - 1) / T::kRows, g.n_split);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, kThreads, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tr>
int dispatch(const Args& g, int is, int vec, cudaStream_t s) {
  if (is) return vec ? launch<Tr, true, true>(g, s) : launch<Tr, true, false>(g, s);
  return vec ? launch<Tr, false, true>(g, s) : launch<Tr, false, false>(g, s);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (a, b and out).  is: 1 input-stationary,
// 0 output-stationary.  bk: K rows per block, a multiple of 16, with
// n_split = ceil(K / bk) (at most 65535).  ws: (n_split, M, N) float32
// (unused when n_split == 1); counters: ceil(N / 128) * ceil(M / rows)
// ints, 0 before the call and 0 again after it.  vec: 1 when every row
// of a and b starts on 16 bytes.  lda/ldb are row strides in elements.
// Returns the launch's cudaError_t.
int repro_snake_gemm(const void* a, const void* b, void* out, float* ws,
                     int* counters, int dtype, int is, int vec, int M, int N,
                     int K, int bk, int n_split, long long lda,
                     long long ldb, void* stream) {
  if (M < 1 || N < 1 || K < 1 || bk < 16 || bk % 16 ||
      n_split != (K + bk - 1) / bk || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args g{a, b, out, ws, counters, M, N, K, bk, n_split, lda, ldb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<F32>(g, is, vec, s);
  if (dtype == 1) return dispatch<BF16>(g, is, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
