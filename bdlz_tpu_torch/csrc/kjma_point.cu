// KJMA point kernels for NVIDIA Hopper (sm_90a): the sweep's trapezoid
// Y_B sum per point, from per-point scalars, with the integrand built in
// registers.
//
// What they compute.  For every point p of a batch, given its row of the
// (P, K) f64 block of scalars that ops/kjma_kernel.point_scalars prepares
// (columns in the enum below), the sum over the n_y nodes of the uniform
// y-grid on [y_lo, y_hi] of
//
//   unfused:  (e^{A - A_max} * bf * w) * F(y)
//   fused:    ((bf * w) * e^{A - A_max}) * F(y)
//
// with, at node j (y = j*dy + y_lo, dy = (y_hi - y_lo)/(n_y - 1), the
// last node y_hi exactly):
//   d    = max(1 + 2y/B, 1e-12)                   T = T_p / sqrt(d)
//   aw   = clamp(y, ±50) - y^2 / (2σ^2)           A/V e^y and the window
//   rel  = 3 T_p > m sqrt(d)                      the T > m/3 branch
//   A    = aw - (rel ? 0 : (m/T_p) sqrt(d))       Maxwell–Boltzmann exponent
//   bf   = rel ? 1 : bf_ratio sqrt(d)
//   w    = dy (½ dy at both ends)                 trapezoid weight
//   F(y) = 4-tap cubic Lagrange interpolation of the KJMA table at
//          t = (clamp(y, ±50) - y0) * inv_dy, i1 = clamp(floor t, 1, n-3)
// and the node's value set to 0 (a select, never a multiply by 0) where
// y > 50, the hard A/V = 0 cut.  An empty window (y_hi <= y_lo) writes 0
// and computes nothing.  The host finishes Y_B = KK * e^{A_max} * sum.
// Every operation is the one ops/kjma_kernel.prepare_streams does on
// (P, n_y) tensors, in its order (true divisions where it divides); the
// file is built with -fmad=false so that no a*b+c contracts into one
// rounding and the seam predicate and floor(t) see the plain version's
// bits.
//
// Which TPU function it replaces: bdlz_tpu/ops/kjma_pallas.py:563
// (integrate_YB_pallas) with its reduce tiers —
//   kjma_point_reduce        <- _kernel_reduce        (:403), default tier
//   kjma_point_fused_reduce  <- _kernel_fused_reduce  (:422), --fuse-exp
// whole: the per-node f64 prep (:597-692) and the kernel.  The TPU splits
// the function in two because Mosaic has no f64 (the prep runs outside the
// kernel, fused by XLA, and the kernel reads f32 streams with a per-point
// peak normalisation that keeps the f32 cast safe).  Hopper has native
// f64, so nothing is cast, nothing is normalised (A - A_max <= 0 already
// bounds the exponent) and no (P, n_y) stream exists: per point, K
// scalars come in and one f64 sum goes out.  The stream-input kernels of
// csrc/kjma_interp.cu stay for the stream tiers.
//
// Bound on this card: operations.  A node costs 49 f64 adds, multiplies,
// compares and conversions, 4 divisions, a square root and an exp (~113
// f64 instructions with the divisions' and exp's sequences, as
// chip_smoke.py counts them), and 4 table reads from shared memory; the
// bytes are K scalars and one sum per point plus the 128 KiB table.  At
// P = 8192, n_y = 8000 that is ~65.5 M nodes, ~0.44 ms at the H100's FP64
// instruction rate (one per FP64 lane and clock, 17e12 a second).  The design: the table (16384 x 8 B =
// 128 KiB) is staged once per block in dynamic shared memory, so one
// block fits an SM; the blocks walk the points grid-stride (the table is
// loaded 132 times, not P times); the threads of a block stride over one
// point's nodes, whose taps are neighbours in the table, and sum in f64;
// a fixed-order block reduction (warp shuffles, then one warp over the
// warp sums, no atomics) makes the sums bitwise reproducible run to run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Threads per block: the most a block may have.  One block fits an SM
// (the table), so these are all the SM's warps there are to hide the f64
// latencies; the kernel fits the 64 registers a thread this leaves, with
// no spills (chip_smoke.py's build phase prints ptxas's counts).  The
// wrapper's shared-memory check (ops/kjma_kernel._SCRATCH_BYTES) counts
// kWarps doubles beside the table.
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr double kYClamp = 50.0;
static_assert(kThreads % 32 == 0 && kWarps <= 32, "one warp reduces the warp sums");

// Columns of a point's row: ops/kjma_kernel.POINT_COLUMNS, in this order.
enum Column {
  kYLo, kYHi, kBSafe, kTwoSig2, kThreeTp, kM, kMOverTp, kBfRatio, kAMax,
  kKK, kColumns
};

// torch's clamp_min / clamp, NaN-propagating like them.
__device__ __forceinline__ double clamp_min(double x, double lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ double clamp(double x, double lo, double hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ double cubic_interp(const double* F, int i,
                                               double s) {
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

template <bool FUSED>
__global__ void __launch_bounds__(kThreads, 1)
kjma_point_kernel(const double* __restrict__ scalars, int n_cols,
                  const double* __restrict__ table, int n_table, double y0,
                  double inv_dy, int n_points, int n_y,
                  double* __restrict__ out) {
  extern __shared__ double smem[];
  double* F = smem;                    // n_table table values
  double* warp_sums = smem + n_table;  // kWarps partial sums
  for (int k = threadIdx.x; k < n_table; k += kThreads) F[k] = table[k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int last = n_y - 1;
  for (int p = blockIdx.x; p < n_points; p += gridDim.x) {
    const double* row = scalars + static_cast<int64_t>(p) * n_cols;
    const double y_lo = row[kYLo];
    const double y_hi = row[kYHi];
    if (!(y_hi > y_lo)) {  // empty window: Y_B = 0 (uniform over the block)
      if (threadIdx.x == 0) out[p] = 0.0;
      continue;
    }
    const double dy = (y_hi - y_lo) / static_cast<double>(n_y - 1);
    const double b_safe = row[kBSafe];
    const double two_sig2 = row[kTwoSig2];
    const double three_tp = row[kThreeTp];
    const double m = row[kM];
    const double m_over_tp = row[kMOverTp];
    const double bf_ratio = row[kBfRatio];
    const double a_max = row[kAMax];
    double acc = 0.0;
    for (int j = threadIdx.x; j < n_y; j += kThreads) {
      const double y = j == last ? y_hi : static_cast<double>(j) * dy + y_lo;
      const double d = clamp_min(1.0 + (2.0 * y) / b_safe, 1e-12);
      const double sqrt_d = sqrt(d);
      const double yc = clamp(y, -kYClamp, kYClamp);
      const double aw = yc - (y * y) / two_sig2;
      const bool rel = three_tp > m * sqrt_d;
      const double a = aw - (rel ? 0.0 : m_over_tp * sqrt_d);
      const double bf = rel ? 1.0 : bf_ratio * sqrt_d;
      const double w = (j == 0 || j == last) ? 0.5 * dy : dy;
      const double g = FUSED ? (bf * w) * exp(a - a_max)
                             : (exp(a - a_max) * bf) * w;
      const double t = (yc - y0) * inv_dy;
      const int i1 = min(max(static_cast<int>(floor(t)), 1), n_table - 3);
      const double v = g * cubic_interp(F, i1, t - static_cast<double>(i1));
      acc += y > kYClamp ? 0.0 : v;
    }
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (warp == 0) {
      acc = lane < kWarps ? warp_sums[lane] : 0.0;
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) out[p] = acc;
    }
    __syncthreads();  // warp_sums is reused by the next point
  }
}

template <bool FUSED>
int launch(const double* scalars, int n_cols, const double* table,
           int n_table, double y0, double inv_dy, int n_points, int n_y,
           double* out, int n_blocks, void* stream) {
  if (n_cols < kColumns || n_table < 4 || n_y < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(n_table + kWarps) * sizeof(double);
  // Above 48 KB, dynamic shared memory is refused at launch unless the
  // kernel opts in first.
  cudaError_t err = cudaFuncSetAttribute(
      kjma_point_kernel<FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it; the caller raises on the code
    return static_cast<int>(err);
  }
  kjma_point_kernel<FUSED>
      <<<n_blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          scalars, n_cols, table, n_table, y0, inv_dy, n_points, n_y, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, does not synchronise, and
// returns the launch's cudaError_t (0 = launched).

int kjma_point_reduce(const double* scalars, int n_cols, const double* table,
                      int n_table, double y0, double inv_dy, int n_points,
                      int n_y, double* out, int n_blocks, void* stream) {
  return launch<false>(scalars, n_cols, table, n_table, y0, inv_dy, n_points,
                       n_y, out, n_blocks, stream);
}

int kjma_point_fused_reduce(const double* scalars, int n_cols,
                            const double* table, int n_table, double y0,
                            double inv_dy, int n_points, int n_y, double* out,
                            int n_blocks, void* stream) {
  return launch<true>(scalars, n_cols, table, n_table, y0, inv_dy, n_points,
                      n_y, out, n_blocks, stream);
}

const char* kjma_point_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
