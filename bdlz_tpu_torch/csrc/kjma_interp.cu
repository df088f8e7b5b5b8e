// KJMA interpolate-and-reduce kernels for NVIDIA Hopper (sm_90a).
//
// What they compute.  For every point p and y-node j of the sweep's
// trapezoid quadrature, the 4-tap cubic Lagrange interpolation of the
// KJMA shape-function table F at fractional index i1 + sfrac, times the
// integrand prefactor the host prepared:
//
//   unfused:  v[p,j] = g[p,j] * F(i1, sfrac)                 (g = ghat)
//   fused:    v[p,j] = g[p,j] * exp(a[p,j]) * F(i1, sfrac)   (g = g2,
//                                                a = A - A_max <= 0)
//
// The reduce variants write one sum over j per point, (P,); the stream
// variants write the whole integrand, (P, n_y).  The trapezoid weights
// are already folded into g, so the host's finish is
// Y_B = KK * e^{A_max} * gscale * sum (bdlz_tpu_torch/ops/kjma_kernel.py).
//
// Which TPU kernel each entry point replaces (bdlz_tpu/ops/kjma_pallas.py):
//   kjma_interp_reduce        <- _kernel_reduce        (:403), default tier
//   kjma_interp_stream        <- _kernel               (:365), streaming tier
//   kjma_interp_fused_reduce  <- _kernel_fused_reduce  (:422), --fuse-exp
//   kjma_interp_fused_stream  <- _kernel_fused         (:369), --fuse-exp, streaming
//
// What was dropped from the TPU design, and why.  The TPU has no gather
// and Mosaic has no f64, so the Pallas kernels select table rows with a
// one-hot MXU matmul against a stencil-shifted (512, 128) f32 table
// (optionally a bf16x3 split of it), carry f32 streams in (ncol, 128)
// tiles, Kahan-sum in VMEM scratch across a sequential grid axis, and
// evaluate exp with a Cody-Waite f32 polynomial.  Hopper has native f64
// and indexed loads from shared memory, so here:
//   * the streams are f64 (g, a, sfrac) and int32 (i1), shaped (P, n_y);
//   * the f64 table (16384 x 8 B = 128 KiB) is staged once per block in
//     dynamic shared memory and the four taps are read by direct index;
//   * fused variants use the native f64 exp();
//   * each point is summed in f64 by a block reduction in a fixed order
//     (per-thread strided sums, warp shuffles, one warp over the warp
//     sums) — no atomics, so sums are bitwise reproducible run to run.
// The port's error against the f64 tabulated path therefore drops from
// the TPU's ~1e-7 to the f64 rounding level (<= 1e-12).
//
// Bound on this card: bytes.  At P = 8192 and n_y = 8000 the reduce
// kernel reads 20 B/node (g 8, i1 4, sfrac 8): 1.31 GB, ~0.39 ms at
// 3.35 TB/s on an H100 SXM.  The fused reduce kernel reads 28 B/node
// (adds a); the stream kernels also write 8 B/node.  The f64 arithmetic,
// ~25 flop/node (plus one exp in the fused kernels), is far below the
// FP64 peak.  One block per SM walks the points grid-stride, so the table
// is loaded 132 times rather than P times; 1024 threads per block stride
// over the nodes with coalesced loads.  That bound counts only the
// streams, and the streams exist only because the TPU's design splits the
// function in two: the host-side stream prep in PyTorch (~20 f64 (P, n_y)
// passes) costs ~20x this kernel.  The reduce tiers therefore no longer
// come here: csrc/kjma_point.cu computes the prep in registers from
// per-point scalars (ops/kjma_kernel.point_reduce).  kjma_interp_reduce
// and kjma_interp_fused_reduce stay as the stream-input forms of K1 and
// K3, held against their plain versions; the sweep's stream tiers
// (reduce=False) run the two stream kernels here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ double cubic_interp(const double* __restrict__ F,
                                               int i, double s, int n) {
  // The host clips i1 to [1, n-3]; clipping again keeps a bad index from
  // reading outside the table (a no-op for valid input, as in the plain
  // version).
  i = min(max(i, 1), n - 3);
  const double sm1 = s + 1.0;
  const double s0 = s;
  const double s1 = s - 1.0;
  const double s2 = s - 2.0;
  const double w_m1 = -(s0 * s1 * s2) / 6.0;
  const double w_0 = (sm1 * s1 * s2) / 2.0;
  const double w_1 = -(sm1 * s0 * s2) / 2.0;
  const double w_2 = (sm1 * s0 * s1) / 6.0;
  return w_m1 * F[i - 1] + w_0 * F[i] + w_1 * F[i + 1] + w_2 * F[i + 2];
}

template <bool FUSED, bool REDUCE>
__global__ void __launch_bounds__(kThreads)
kjma_interp_kernel(const double* __restrict__ g, const double* __restrict__ a,
                   const int32_t* __restrict__ i1,
                   const double* __restrict__ sfrac,
                   const double* __restrict__ table, int n_table, int n_points,
                   int n_y, double* __restrict__ out) {
  extern __shared__ double smem[];
  double* F = smem;                   // n_table table values
  double* warp_sums = smem + n_table;  // kWarps partial sums
  for (int k = threadIdx.x; k < n_table; k += kThreads) F[k] = table[k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int p = blockIdx.x; p < n_points; p += gridDim.x) {
    const int64_t row = static_cast<int64_t>(p) * n_y;
    double acc = 0.0;
    for (int j = threadIdx.x; j < n_y; j += kThreads) {
      const int64_t k = row + j;
      double v = g[k];
      if (FUSED) v *= exp(a[k]);
      v *= cubic_interp(F, i1[k], sfrac[k], n_table);
      if (REDUCE) {
        acc += v;
      } else {
        out[k] = v;
      }
    }
    if (REDUCE) {
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) warp_sums[warp] = acc;
      __syncthreads();
      if (warp == 0) {
        acc = warp_sums[lane];  // kWarps == 32: one sum per lane
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_down_sync(0xffffffffu, acc, off);
        if (lane == 0) out[p] = acc;
      }
      __syncthreads();  // warp_sums is reused by the next point
    }
  }
}

template <bool FUSED, bool REDUCE>
int launch(const double* g, const double* a, const int32_t* i1,
           const double* sfrac, const double* table, int n_table,
           int n_points, int n_y, double* out, int n_blocks, void* stream) {
  static_assert(kWarps == 32, "the second reduction stage assumes 32 warps");
  const size_t smem = static_cast<size_t>(n_table + kWarps) * sizeof(double);
  // Above 48 KB, dynamic shared memory is refused at launch unless the
  // kernel opts in first.
  cudaError_t err = cudaFuncSetAttribute(
      kjma_interp_kernel<FUSED, REDUCE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it; the caller raises on the code
    return static_cast<int>(err);
  }
  kjma_interp_kernel<FUSED, REDUCE>
      <<<n_blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          g, a, i1, sfrac, table, n_table, n_points, n_y, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, does not synchronise, and
// returns the launch's cudaError_t (0 = launched).

int kjma_interp_reduce(const double* g, const int32_t* i1, const double* sfrac,
                       const double* table, int n_table, int n_points,
                       int n_y, double* out, int n_blocks, void* stream) {
  return launch<false, true>(g, nullptr, i1, sfrac, table, n_table, n_points,
                             n_y, out, n_blocks, stream);
}

int kjma_interp_stream(const double* g, const int32_t* i1, const double* sfrac,
                       const double* table, int n_table, int n_points,
                       int n_y, double* out, int n_blocks, void* stream) {
  return launch<false, false>(g, nullptr, i1, sfrac, table, n_table, n_points,
                              n_y, out, n_blocks, stream);
}

int kjma_interp_fused_reduce(const double* g, const double* a,
                             const int32_t* i1, const double* sfrac,
                             const double* table, int n_table, int n_points,
                             int n_y, double* out, int n_blocks,
                             void* stream) {
  return launch<true, true>(g, a, i1, sfrac, table, n_table, n_points, n_y,
                            out, n_blocks, stream);
}

int kjma_interp_fused_stream(const double* g, const double* a,
                             const int32_t* i1, const double* sfrac,
                             const double* table, int n_table, int n_points,
                             int n_y, double* out, int n_blocks,
                             void* stream) {
  return launch<true, false>(g, a, i1, sfrac, table, n_table, n_points, n_y,
                             out, n_blocks, stream);
}

const char* kjma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
