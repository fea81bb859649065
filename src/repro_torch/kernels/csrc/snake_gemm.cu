// SNAKE decode GEMM for Hopper (sm_90a): out (M, N) = a (M, K) @ b (K, N)
// for small M (decode batches), float32 accumulation.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/snake_gemm.py
// (snake_decode_gemm: _is_kernel, _os_kernel) -> repro_snake_gemm, with
// the two dataflows the mapping (kernels/snake_gemm.py::choose_mapping)
// picks per shape:
//   IS (input-stationary): the block's rows of A (kRows x K) stay resident
//       in shared memory for the whole K sweep while B streams through;
//   OS (output-stationary): A is staged one (kRows x bk) K block at a time
//       while the float32 accumulator stays in registers.
// In both, each block owns a (kRows x kBlockN) output tile and its
// accumulator lives in registers; B is read straight from device memory
// once, in its (K, N) row-major layout, never padded or copied.
//
// Bound on the H100: at decode M the product does 2 M flops per element
// of B it reads, far below the ~295 flop/byte ridge, so the least time is
// the bytes of B over 3.35 TB/s.  What the design does about it:
//   * kRows is the M granularity of the mapping (8 float32 / 16 bfloat16
//     rows): a decode batch is padded only to it, in shared memory (rows
//     past M are zero there and are never stored);
//   * each thread owns 16 bytes of one B row (4 float32 / 8 bfloat16
//     columns) and the threads of a block split K between them, so every
//     load is a 16-byte vector load, kUnroll of them in flight per thread;
//     a row of A for the same k is one broadcast read of shared memory;
//   * float32 inputs use float32 FMA (no TF32), bfloat16 inputs are
//     widened to float32 before the FMA;
//   * the threads' partial sums over K meet once at the end: shuffles
//     within a warp, then one pass through shared memory across warps.
// Shapes whose B rows are not 16-byte aligned (a ragged N) take the same
// path with element loads.  Known limit (speed is later work): the grid is
// ceil(N / 64) x (M / kRows) blocks, 64 at N = 4096, under one wave of the
// card's 132 SMs; bfloat16 pads a batch of 4 to 16 rows of FMAs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 64;     // output columns per block
constexpr int kUnroll = 4;      // B rows in flight per thread
constexpr int kMaxSmem = 232448;  // shared memory one H100 block can use

struct Args {
  const void* a;     // (M, K), row stride lda, last dim contiguous
  const void* b;     // (K, N), row stride ldb, last dim contiguous
  void* out;         // (M, N) contiguous
  int M, N, K, bk;   // bk: K block staged per pass (OS); K (IS)
  long long lda, ldb;
};

template <typename Tr>
struct Tile {
  using raw = typename Tr::raw;
  static constexpr int kRows = sizeof(raw) == 4 ? 8 : 16;
  static constexpr int kVec = 16 / sizeof(raw);      // columns per thread
  static constexpr int kPerRow = kBlockN / kVec;     // threads per B row
  static constexpr int kGroups = kThreads / kPerRow;  // K groups
};

// kVec columns of one B row starting at column col, as floats; columns
// past N read as 0 (element path only: the vector path has N % kVec == 0).
template <typename Tr, bool VEC>
__device__ __forceinline__ void load_b(const typename Tr::raw* row, int col,
                                       int N, float (&out)[Tile<Tr>::kVec]) {
  using raw = typename Tr::raw;
  constexpr int V = Tile<Tr>::kVec;
  if (VEC) {
    if (col < N) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(row + col));
      const raw* e = reinterpret_cast<const raw*>(&x);
#pragma unroll
      for (int c = 0; c < V; ++c) out[c] = Tr::load(e[c]);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) out[c] = 0.f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c)
      out[c] = col + c < N ? Tr::load(row[col + c]) : 0.f;
  }
}

// grid (ceil(N / kBlockN), M_padded / kRows), kThreads threads; dynamic
// shared memory: A (ak x kRows raw, k-major) then kWarps x kRows x kBlockN
// floats for the cross-warp sum.
template <typename Tr, bool IS, bool VEC>
__global__ void __launch_bounds__(kThreads) snake_gemm_kernel(const Args g) {
  using raw = typename Tr::raw;
  using T = Tile<Tr>;
  constexpr int R = T::kRows;
  constexpr int V = T::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ak = IS ? g.K : g.bk;
  raw* As = reinterpret_cast<raw*>(smem);
  float* red = reinterpret_cast<float*>(
      smem + ((static_cast<size_t>(ak) * R * sizeof(raw) + 15) / 16) * 16);

  const raw* a = static_cast<const raw*>(g.a);
  const raw* b = static_cast<const raw*>(g.b);
  const int n0 = blockIdx.x * kBlockN;
  const int m0 = blockIdx.y * R;
  const int tid = threadIdx.x;
  const int ct = tid % T::kPerRow;
  const int kg = tid / T::kPerRow;
  const int col = n0 + ct * V;

  float acc[R][V];
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int c = 0; c < V; ++c) acc[m][c] = 0.f;

  for (int kb = 0; kb < g.K; kb += ak) {
    const int kn = g.K - kb < ak ? g.K - kb : ak;
    // stage A[m0 : m0 + R, kb : kb + kn] as As[kk][m]; rows >= M are 0
    __syncthreads();
    for (int idx = tid; idx < R * kn; idx += kThreads) {
      const int m = idx / kn;
      const int kk = idx - m * kn;
      const int row = m0 + m;
      As[kk * R + m] = row < g.M ? a[row * g.lda + kb + kk] : static_cast<raw>(0);
    }
    __syncthreads();
    for (int kk0 = kg; kk0 < kn; kk0 += T::kGroups * kUnroll) {
      float bv[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = kk0 + u * T::kGroups;
        if (kk < kn) {
          load_b<Tr, VEC>(b + (kb + kk) * g.ldb, col, g.N, bv[u]);
        } else {
#pragma unroll
          for (int c = 0; c < V; ++c) bv[u][c] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = kk0 + u * T::kGroups;
        if (kk >= kn) break;
        // R raw values = 32 bytes: two broadcast 16-byte reads
        const uint4* ap = reinterpret_cast<const uint4*>(As + kk * R);
        const uint4 a01[2] = {ap[0], ap[1]};
        const raw* ae = reinterpret_cast<const raw*>(a01);
#pragma unroll
        for (int m = 0; m < R; ++m) {
          const float am = Tr::load(ae[m]);
#pragma unroll
          for (int c = 0; c < V; ++c) acc[m][c] = fmaf(am, bv[u][c], acc[m][c]);
        }
      }
    }
  }

  // lanes of a warp that share ct hold partial sums over other k
#pragma unroll
  for (int off = T::kPerRow; off < 32; off <<= 1)
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int c = 0; c < V; ++c)
        acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], off);
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (lane < T::kPerRow) {
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int c = 0; c < V; ++c)
        red[(warp * R + m) * kBlockN + ct * V + c] = acc[m][c];
  }
  __syncthreads();
  raw* out = static_cast<raw*>(g.out);
  for (int idx = tid; idx < R * kBlockN; idx += kThreads) {
    const int m = idx / kBlockN;
    const int c = idx - m * kBlockN;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * R + m) * kBlockN + c];
    const int row = m0 + m;
    const int n = n0 + c;
    if (row < g.M && n < g.N)
      out[static_cast<long long>(row) * g.N + n] = Tr::store(s);
  }
}

template <typename Tr, bool IS, bool VEC>
int launch(const Args& g, cudaStream_t stream) {
  using T = Tile<Tr>;
  const int ak = IS ? g.K : g.bk;
  const size_t a_bytes =
      ((static_cast<size_t>(ak) * T::kRows * sizeof(typename Tr::raw) + 15) / 16) * 16;
  const size_t smem = a_bytes + sizeof(float) * kWarps * T::kRows * kBlockN;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = snake_gemm_kernel<Tr, IS, VEC>;
  // once per instantiation, so no launch after the first (one inside a
  // CUDA graph capture, say) makes another runtime call
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid((g.N + kBlockN - 1) / kBlockN, (g.M + T::kRows - 1) / T::kRows);
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
// 0 output-stationary with K blocks of bk.  vec: 1 when every B row start
// is 16-byte aligned and N is a multiple of 16 / element size.  lda/ldb
// are row strides in elements.  Returns the launch's cudaError_t.
int repro_snake_gemm(const void* a, const void* b, void* out, int dtype,
                     int is, int vec, int M, int N, int K, int bk,
                     long long lda, long long ldb, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (!is && bk < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args g{a, b, out, M, N, K, bk, lda, ldb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<F32>(g, is, vec, s);
  if (dtype == 1) return dispatch<BF16>(g, is, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
