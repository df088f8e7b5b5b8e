// Dephased Landau–Zener transport for NVIDIA Hopper (sm_90a): the final Bloch
// vector of each speed through a sampled wall profile, in one kernel.
//
// What it computes.  A χ/B two-level system crosses S segments; segment k
// carries the midpoint Hamiltonian H_k = a_k σ_z + b_k σ_x and is crossed in
// τ = dξ_k / v.  Its propagator exp(−i H_k τ) is the unit quaternion
// (cos θ, (b/ω) sin θ, 0, (a/ω) sin θ), θ = ω τ, ω = sqrt(a² + b²), whose
// SO(3) adjoint R_k rotates the Bloch vector; the coherences then decay,
// D_k = diag(e^(−Γτ), e^(−Γτ), 1).  From r₀ = ẑ the kernel returns
// r = D_S R_S ··· D_1 R_1 ẑ per speed, segment 1 first and each later
// segment on the left: what lz/kernel.propagate_bloch_plain returns (its
// plain version, a pairwise tree of 3×3 products).  A segment with
// a = b = 0 is the identity rotation: a/ω and b/ω are stored as 0 there.
// Speeds are clamped at 1e-12 (a NaN speed stays NaN), as the plain
// version's torch.clamp_min does; the wrapper clamps Γ < 0 to 0.
//
// Which TPU program it replaces: none.  bdlz_tpu/lz/kernel.py:192
// (propagate_bloch) is plain XLA with the same pairwise tree, no
// pallas_call.  On the card that tree staged (B, 1024, 3, 3) f64 leaves in
// device memory every pass and cuBLAS ran its ten levels of batched 3×3
// products as tensor-core DGEMM tiles; this kernel keeps every map in
// registers and reads only the segments and the speeds.
//
// Bound on this card: f64 operations.  The benchmark's frozen count
// (benchmark/harness/dephase_work.py) is 79 f64 instructions a
// lane-segment (lane = one speed at one rate): 1/v and Γ/v hoisted per
// speed, ω dξ, a/ω, b/ω hoisted per segment, each rotation applied to the
// vector.  A pass of the benchmark's cell is 1024 speeds × 800 segments:
// 819,200 lane-segments, 64.7 M instructions, 3.8 µs at the H100's
// 17e12 f64 instructions a second; its bytes (the segments once, each
// speed's v and r) are ~31 KB.
//
// Design.  1024 speeds, one thread each, would fill 32 warps of the 132
// SMs and wait on one chain of 800 dependent segments each.  So each
// speed's segments are cut into kSlices = 64 contiguous slices, one
// thread per slice (kWarpsPerSpeed = 2 warps a speed): a thread composes
// its slice's maps into one 3×3 map in registers (27 FMA a segment
// besides the rotation, more than the count's 11 for a vector, but
// 64-fold parallel), the slices' maps are combined in order, later
// slices on the left, by __shfl_down_sync over log₂32 levels inside a
// warp and through shared memory across the two warps, and the speed's
// first thread applies the result to its vector.  kSpeedsPerBlock speeds
// share a block, which stages the hoisted per-segment values (ω dξ, a/ω,
// b/ω, dξ) in shared memory once for all of them, kTile segments at a
// time: a profile of any length is walked tile by tile, the vector
// carried across tiles.  At 1024 speeds that is 128 blocks of 512
// threads, one block and 16 warps on each SM, 12–13 segments a thread:
// 11.3 µs a pass on an H100 (PERF.md §6), where one warp a speed (8
// warps an SM, 25 segments a thread) took 12.9 µs.
//
// Numbers.  The kernel composes in another order than the tree and
// evaluates θ as (ω dξ)(1/v) where the tree forms ω (dξ / v), so the two
// agree to rounding: ~1e-15 at the benchmark's speeds and rates.  Where
// θ reaches 1e4 rad (v ≲ 1e-5 with Γ = 0) one rounding of θ moves r by
// ~1e-12 a segment, and any two evaluations differ by that much.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerSpeed = 2;
constexpr int kSlices = kWarp * kWarpsPerSpeed;
constexpr int kSpeedsPerBlock = 8;
constexpr int kThreads = kSlices * kSpeedsPerBlock;
constexpr int kTile = 1024;  // segments staged per round: 4 × 8 KB of shared memory
constexpr unsigned kFullMask = 0xffffffffu;

// C = A·B for row-major 3×3 matrices in registers.
__device__ __forceinline__ void mul3(const double* A, const double* B, double* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bloch_transport_kernel(const double* __restrict__ a, const double* __restrict__ b,
                       const double* __restrict__ dxi, const double* __restrict__ v,
                       int n_seg, int n_speeds, double gamma, double* __restrict__ r_out) {
  __shared__ double s_phase[kTile];  // ω dξ
  __shared__ double s_z[kTile];      // a / ω (0 where ω = 0)
  __shared__ double s_x[kTile];      // b / ω (0 where ω = 0)
  __shared__ double s_dxi[kTile];    // dξ
  __shared__ double s_later[kSpeedsPerBlock * 9];  // each speed's second warp's map

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int local = warp / kWarpsPerSpeed;  // this speed's index in the block
  const int part = warp % kWarpsPerSpeed;   // the speed's first (0) or second warp
  const int slice = part * kWarp + lane;
  const int speed = blockIdx.x * kSpeedsPerBlock + local;
  const bool live = speed < n_speeds;  // the same for a whole warp

  double inv_v = 0.0, rate = 0.0;
  if (live) {
    const double vs = v[speed];
    inv_v = 1.0 / (vs < 1e-12 ? 1e-12 : vs);
    rate = gamma * inv_v;
  }
  double r0 = 0.0, r1 = 0.0, r2 = 1.0;  // the speed's first thread: r, from ẑ

  for (int t0 = 0; t0 < n_seg; t0 += kTile) {
    const int n = min(kTile, n_seg - t0);
    __syncthreads();  // the previous tile has been read
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const double ak = a[t0 + k], bk = b[t0 + k], dk = dxi[t0 + k];
      const double w = sqrt(ak * ak + bk * bk);
      const bool turns = w > 0.0;
      s_phase[k] = w * dk;
      s_z[k] = turns ? ak / w : 0.0;
      s_x[k] = turns ? bk / w : 0.0;
      s_dxi[k] = dk;
    }
    __syncthreads();

    double M[9] = {1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0};
    if (live) {
      const int per = (n + kSlices - 1) / kSlices;
      const int lo = min(slice * per, n);
      const int hi = min(lo + per, n);
      for (int k = lo; k < hi; ++k) {
        double s, c;
        sincos(s_phase[k] * inv_v, &s, &c);
        const double x2 = 2.0 * s_x[k] * s;
        const double z2 = 2.0 * s_z[k] * s;
        const double d = exp(-rate * s_dxi[k]);
        const double xx = 0.5 * x2 * x2, zz = 0.5 * z2 * z2, xz = 0.5 * x2 * z2;
        const double cx = c * x2, cz = c * z2;
        // D·R for the quaternion (c, x, 0, z)
        const double DR[9] = {d * (1.0 - zz), -d * cz, d * xz,
                              d * cz, d * (1.0 - xx - zz), -d * cx,
                              xz, cx, 1.0 - xx};
        double T[9];
        mul3(DR, M, T);
#pragma unroll
        for (int i = 0; i < 9; ++i) M[i] = T[i];
      }
      // the warp's 32 slices, later on the left: lane j takes lane j+off's map
#pragma unroll
      for (int off = 1; off < kWarp; off <<= 1) {
        double L[9], T[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) L[i] = __shfl_down_sync(kFullMask, M[i], off);
        mul3(L, M, T);
#pragma unroll
        for (int i = 0; i < 9; ++i) M[i] = T[i];
      }
    }
    // the second warp's map (the later slices) goes on the left of the first's
    if (live && part == 1 && lane == 0) {
#pragma unroll
      for (int i = 0; i < 9; ++i) s_later[local * 9 + i] = M[i];
    }
    __syncthreads();
    if (live && part == 0 && lane == 0) {
      double T[9];
      mul3(&s_later[local * 9], M, T);
      const double q0 = T[0] * r0 + T[1] * r1 + T[2] * r2;
      const double q1 = T[3] * r0 + T[4] * r1 + T[5] * r2;
      const double q2 = T[6] * r0 + T[7] * r1 + T[8] * r2;
      r0 = q0;
      r1 = q1;
      r2 = q2;
    }
  }
  if (live && part == 0 && lane == 0) {
    r_out[3 * speed] = r0;
    r_out[3 * speed + 1] = r1;
    r_out[3 * speed + 2] = r2;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, and returns the launch's
// cudaError_t (0 = launched).  a, b, dxi: (n_seg,) f64; v: (n_speeds,) f64;
// r: (n_speeds, 3) f64; gamma >= 0.
int bloch_transport(const double* a, const double* b, const double* dxi, const double* v,
                    int n_seg, int n_speeds, double gamma, double* r, void* stream) {
  if (n_speeds <= 0) return 0;
  const int blocks = (n_speeds + kSpeedsPerBlock - 1) / kSpeedsPerBlock;
  bloch_transport_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, dxi, v, n_seg, n_speeds, gamma, r);
  return static_cast<int>(cudaGetLastError());
}

const char* bloch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
