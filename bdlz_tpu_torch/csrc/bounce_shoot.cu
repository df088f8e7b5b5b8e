// O(4) bounce shoot for NVIDIA Hopper (sm_90a): one thread per lane.
//
// What it computes.  For each lane's potential V(φ) = (λ₄/8)(φ²−v²)² −
// (ε/2)(φ/v+1), given params (λ₄, v, ε, φ_false, φ_top, φ_true), the
// release point φ₀ of the radial bubble ODE
//     φ'' + (3/ρ) φ' = V'(φ),   φ'(0) = 0,   φ(∞) = φ_false
// by overshoot/undershoot bisection, then a fixed-grid RK4 pass from φ₀
// that writes φ and φ' on the dense grid, accumulates the Euclidean action
// S₄ = 2π² ∫ ρ³ [½φ'² + V − V(φ_false)] dρ in order, and locates the wall
// radius (φ = φ_mid, linear interpolation).
//
//   classify(φ₀): from the series initial condition at ρ₀, run up to
//     n_segments segments of width h_seg, each an adaptive SDIRK4(3) solve
//     (Hairer–Wanner γ = 1/4 tableau, Hairer–Wanner starting step, I
//     controller, 6 Newton iterations with the closed-form Jacobian
//     [[0, 1], [V''(φ), −3/ρ]] and a 1e-300 determinant floor, rtol 1e-8,
//     atol 1e-16, at most 10000 attempted steps); stop at the first
//     overshoot (φ < φ_false − 1e-6 Δφ) or undershoot (φ' > 1e-14); an
//     unresolved lane is an undershoot.
//   bisection: n_bisect halvings of [φ_top, φ_true − 1e-13 Δφ].
//
// Which TPU program it replaces: bdlz_tpu/bounce/shooting.py:105
// (_bounce_program), one XLA program per lane width — no pallas_call.  The
// plain PyTorch version is bdlz_tpu_torch/bounce/shooting.py, which drives
// the port's eager ESDIRK solver; this kernel repeats its arithmetic
// operation by operation, in the same order.  It is built with
// -fmad=false (no contraction of a*b+c into one rounding), and torch's
// NaN-propagating min/max/clamp are written out, so on the card the kernel
// and the plain version on CUDA tensors agree to the last bit wherever
// CUDA's libm (pow) is shared.
//
// Bound on this card: latency.  A lane is one sequential chain of about
// 45,000 attempted steps (the reference shoot: 2,152 segment solves); each
// step is 5 implicit stages of 6 dependent Newton iterations, so nothing
// in a lane can run in parallel and the card's throughput is idle.  The
// least time is steps x dependent f64 operations per step x the latency
// of one dependent f64 operation (the count is derived in PERF.md).  The
// design keeps every value of a lane in registers; lanes are independent
// threads, so a batch costs the slowest lane.  A block per lane that
// evaluates a depth-k bisection tree in parallel is later work.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 32;

// solver knobs of bdlz_tpu_torch/bounce/shooting.py and solvers/sdirk.py
constexpr double kOvershootFrac = 1e-6;
constexpr double kUndershootVTol = 1e-14;
constexpr double kSettleFrac = 1e-4;
constexpr double kHiOffsetFrac = 1e-13;
constexpr double kRtol = 1e-8;
constexpr double kAtol = 1e-16;
constexpr int kNewtonIters = 6;
constexpr int64_t kMaxSteps = 10000;
constexpr double kOrder = 4.0;

// Hairer–Wanner SDIRK4(3), γ = 1/4 (solvers/sdirk.py _tableau_sdirk4); the
// stage loops are unrolled, so every coefficient is an immediate
constexpr double kG = 0.25;
__device__ constexpr double kC[5] = {0.25, 0.75, 11.0 / 20.0, 0.5, 1.0};
__device__ constexpr double kA[5][5] = {
    {kG, 0.0, 0.0, 0.0, 0.0},
    {0.5, kG, 0.0, 0.0, 0.0},
    {17.0 / 50.0, -1.0 / 25.0, kG, 0.0, 0.0},
    {371.0 / 1360.0, -137.0 / 2720.0, 15.0 / 544.0, kG, 0.0},
    {25.0 / 24.0, -49.0 / 48.0, 125.0 / 16.0, -85.0 / 12.0, kG},
};
__device__ constexpr double kB[5] = {25.0 / 24.0, -49.0 / 48.0, 125.0 / 16.0, -85.0 / 12.0, kG};
__device__ constexpr double kBEmb[5] = {59.0 / 48.0, -17.0 / 96.0, 225.0 / 32.0, -85.0 / 12.0, 0.0};

// torch.minimum / torch.maximum / torch.clamp: NaN in, NaN out
__device__ __forceinline__ double tmin(double a, double b) {
  return isnan(a) ? a : (isnan(b) ? b : (b < a ? b : a));
}
__device__ __forceinline__ double tmax(double a, double b) {
  return isnan(a) ? a : (isnan(b) ? b : (b > a ? b : a));
}
__device__ __forceinline__ double tclamp(double x, double lo, double hi) {
  return tmin(tmax(x, lo), hi);
}

struct Pot {
  double lam4, vev, eps;
};

// bounce/potential.py, expression for expression
__device__ __forceinline__ double pot_V(double phi, const Pot& p) {
  const double q = phi * phi - p.vev * p.vev;
  return 0.125 * p.lam4 * q * q - 0.5 * p.eps * (phi / p.vev + 1.0);
}
__device__ __forceinline__ double pot_dV(double phi, const Pot& p) {
  return 0.5 * p.lam4 * phi * (phi * phi - p.vev * p.vev) - 0.5 * p.eps / p.vev;
}
__device__ __forceinline__ double pot_d2V(double phi, const Pot& p) {
  return 0.5 * p.lam4 * (3.0 * phi * phi - p.vev * p.vev);
}

// f(ρ, y) = (φ', V'(φ) − 3φ'/ρ)
__device__ __forceinline__ void rhs(const Pot& p, double rho, double y0, double y1,
                                    double& f0, double& f1) {
  f0 = y1;
  f1 = pot_dV(y0, p) - 3.0 * y1 / rho;
}

// sqrt(mean((u, v)²)) as torch evaluates it for a (P, 2) row
__device__ __forceinline__ double rms2(double u, double v) {
  return sqrt((u * u + v * v) * 0.5);
}

// Y = rhs_const + hγ·f(x_s, Y) by fixed-iteration Newton (sdirk._Stepper._newton)
__device__ __forceinline__ void newton(const Pot& p, double rho, double c0, double c1,
                                       double& Y0, double& Y1, double hg) {
  const double j00 = 0.0, j01 = 1.0;
  const double j11 = -3.0 / rho;
  for (int it = 0; it < kNewtonIters; ++it) {
    double f0, f1;
    rhs(p, rho, Y0, Y1, f0, f1);
    const double F0 = Y0 - hg * f0 - c0;
    const double F1 = Y1 - hg * f1 - c1;
    const double j10 = pot_d2V(Y0, p);
    const double a = 1.0 - hg * j00;
    const double b = 0.0 - hg * j01;
    const double c = 0.0 - hg * j10;
    const double d = 1.0 - hg * j11;
    double det = a * d - b * c;
    det = fabs(det) > 1e-300 ? det : 1e-300;
    const double d0 = (F0 * d - F1 * b) / det;
    const double d1 = (F1 * a - F0 * c) / det;
    Y0 = Y0 - d0;
    Y1 = Y1 - d1;
  }
}

struct Segment {
  double y0, y1;
  bool success;
  int64_t n;
};

// One adaptive SDIRK4(3) solve over [x0, x1] (sdirk.esdirk_solve with
// auto_h0=True, the I controller, no step cap beyond the span).
__device__ Segment esdirk_segment(const Pot& p, double x0, double x1, double yy0,
                                  double yy1) {
  const double span = x1 - x0;
  const double abs_span = fabs(span);
  const double h_cap = abs_span;

  // esdirk_init, Hairer–Wanner starting step
  double f0, f1;
  rhs(p, x0, yy0, yy1, f0, f1);
  const double sc0 = kAtol + kRtol * fabs(yy0);
  const double sc1 = kAtol + kRtol * fabs(yy1);
  const double d0 = rms2(yy0 / sc0, yy1 / sc1);
  const double d1 = rms2(f0 / sc0, f1 / sc1);
  double h_a = (d0 < 1e-5 || d1 < 1e-5) ? 1e-6 * abs_span : 0.01 * d0 / tmax(d1, 1e-300);
  h_a = tmin(h_a, h_cap);
  double g0, g1;
  rhs(p, x0 + h_a, yy0 + h_a * f0, yy1 + h_a * f1, g0, g1);
  const double d2 = rms2((g0 - f0) / sc0, (g1 - f1) / sc1) / tmax(h_a, 1e-300);
  const double dm = tmax(d1, d2);
  const double h_b = dm <= 1e-15 ? tmax(1e-6 * abs_span, h_a * 1e-3)
                                 : pow(0.01 / dm, 1.0 / (kOrder + 1.0));
  double h = tmin(100.0 * h_a, h_b);
  h = tclamp(h, abs_span * 1e-12, h_cap);

  double x = x0, y0 = yy0, y1 = yy1;
  double fl0 = f0, fl1 = f1;
  int64_t n = 0;
  bool done = false;
  while (!done && n < kMaxSteps) {
    const double h_eff = tmin(tmin(h, h_cap), x1 - x);
    // attempt_step: every stage implicit, predicted from the previous slope
    double k0[5], k1[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const double x_s = x + kC[i] * h_eff;
      double acc0 = y0, acc1 = y1;
#pragma unroll
      for (int j = 0; j < i; ++j) {
        acc0 = acc0 + h_eff * kA[i][j] * k0[j];
        acc1 = acc1 + h_eff * kA[i][j] * k1[j];
      }
      const double kp0 = i ? k0[i - 1] : fl0;
      const double kp1 = i ? k1[i - 1] : fl1;
      const double hg = h_eff * kG;
      double Y0 = acc0 + hg * kp0;
      double Y1 = acc1 + hg * kp1;
      newton(p, x_s, acc0, acc1, Y0, Y1, hg);
      rhs(p, x_s, Y0, Y1, k0[i], k1[i]);
    }
    double yn0 = y0, yn1 = y1, ye0 = y0, ye1 = y1;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      yn0 = yn0 + h_eff * kB[j] * k0[j];
      yn1 = yn1 + h_eff * kB[j] * k1[j];
      ye0 = ye0 + h_eff * kBEmb[j] * k0[j];
      ye1 = ye1 + h_eff * kBEmb[j] * k1[j];
    }
    const double s0 = kAtol + kRtol * tmax(fabs(y0), fabs(yn0));
    const double s1 = kAtol + kRtol * tmax(fabs(y1), fabs(yn1));
    double err = rms2((yn0 - ye0) / s0, (yn1 - ye1) / s1);

    // the I controller
    err = isfinite(err) ? err : INFINITY;
    const bool accept = err <= 1.0;
    const double e = err > 0.0 ? err : 1e-10;
    double factor = 0.9 * pow(e, -1.0 / kOrder);
    factor = tclamp(factor, 0.2, 5.0);
    const double h_next = tclamp(h_eff * factor, abs_span * 1e-12, h_cap);
    if (accept) {
      x = x + h_eff;
      y0 = yn0;
      y1 = yn1;
      fl0 = k0[4];
      fl1 = k1[4];
    }
    h = h_next;
    ++n;
    done = x >= x1 - abs_span * 1e-14;
  }
  Segment s;
  s.y0 = y0;
  s.y1 = y1;
  s.success = done && isfinite(y0) && isfinite(y1);
  s.n = n;
  return s;
}

struct Lane {
  Pot p;
  double phi_false, phi_top, phi_true, delta_phi, phi_mid;
};

__device__ __forceinline__ Lane load_lane(const double* params, int i) {
  Lane L;
  const double* r = params + 6 * static_cast<int64_t>(i);
  L.p.lam4 = r[0];
  L.p.vev = r[1];
  L.p.eps = r[2];
  L.phi_false = r[3];
  L.phi_top = r[4];
  L.phi_true = r[5];
  L.delta_phi = L.phi_true - L.phi_false;
  L.phi_mid = 0.5 * (L.phi_true + L.phi_false);
  return L;
}

// φ(ρ₀) = φ₀ + V'(φ₀)ρ₀²/8, φ'(ρ₀) = V'(φ₀)ρ₀/4
__device__ __forceinline__ void series_ic(const Pot& p, double phi0, double rho0,
                                          double& y0, double& y1) {
  const double dv0 = pot_dV(phi0, p);
  y0 = phi0 + 0.125 * dv0 * rho0 * rho0;
  y1 = 0.25 * dv0 * rho0;
}

struct Verdict {
  int64_t verdict, segments, steps;
  bool ok;
  double first0, first1, end0, end1;
};

__device__ Verdict classify(const Lane& L, double phi0, double rho0, double h_seg,
                            int n_segments) {
  Verdict v;
  double y0, y1;
  series_ic(L.p, phi0, rho0, y0, y1);
  v.verdict = 0;
  v.segments = 0;
  v.steps = 0;
  v.ok = true;
  v.first0 = y0;
  v.first1 = y1;
  const double floor_phi = L.phi_false - kOvershootFrac * L.delta_phi;
  for (int k = 0; k < n_segments && v.verdict == 0; ++k) {
    const double a = rho0 + h_seg * static_cast<double>(k);
    const Segment s = esdirk_segment(L.p, a, a + h_seg, y0, y1);
    y0 = s.y0;
    y1 = s.y1;
    v.verdict = y0 < floor_phi ? 1 : (y1 > kUndershootVTol ? -1 : 0);
    v.ok = v.ok && s.success;
    v.segments += 1;
    v.steps += s.n;
    if (k == 0) {
      v.first0 = y0;
      v.first1 = y1;
    }
  }
  if (v.verdict == 0) v.verdict = -1;  // friction won by ρ_max: undershoot
  v.end0 = y0;
  v.end1 = y1;
  return v;
}

__device__ __forceinline__ double integrand(const Pot& p, double rho, double y0, double y1,
                                            double v_false) {
  return rho * (rho * rho) * (0.5 * y1 * y1 + pot_V(y0, p) - v_false);
}

__global__ void __launch_bounds__(kThreads)
bounce_shoot_kernel(const double* __restrict__ params, int n_lanes, double rho0,
                    double h_seg, int n_segments, int n_bisect, double h_dense,
                    int n_dense, double two_pi_sq, double* __restrict__ phi0_out,
                    double* __restrict__ r_wall_out, double* __restrict__ action_out,
                    uint8_t* __restrict__ converged_out, double* __restrict__ phi_out,
                    double* __restrict__ dphi_out, int64_t* __restrict__ steps_out,
                    int64_t* __restrict__ segments_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_lanes) return;
  const Lane L = load_lane(params, i);

  // bisection on the release point
  double lo = L.phi_top;
  double hi = L.phi_true - kHiOffsetFrac * L.delta_phi;
  bool ok = true;
  int64_t steps = 0, segments = 0;
  for (int it = 0; it < n_bisect; ++it) {
    const double mid = 0.5 * (lo + hi);
    const Verdict v = classify(L, mid, rho0, h_seg, n_segments);
    if (v.verdict < 0) {
      lo = mid;
    } else {
      hi = mid;
    }
    ok = ok && v.ok;
    steps += v.steps;
    segments += v.segments;
  }
  const double phi0 = lo;

  // dense pass: fixed-grid RK4 with the settle freeze, action in order
  const double v_false = pot_V(L.phi_false, L.p);
  const double settle = L.phi_false + kSettleFrac * L.delta_phi;
  const double half_h = 0.5 * h_dense;
  const double sixth_h = h_dense / 6.0;
  const int64_t row = static_cast<int64_t>(i) * (n_dense + 1);
  double y0, y1;
  series_ic(L.p, phi0, rho0, y0, y1);
  double f_prev = integrand(L.p, rho0, y0, y1, v_false);
  double s_acc = 0.0;
  phi_out[row] = y0;
  dphi_out[row] = y1;
  bool finite = isfinite(y0);
  // wall radius: the first grid point at or below φ_mid
  int idx = (y0 <= L.phi_mid) ? 0 : -1;
  double p_prev = y0, p_at = y0;
  for (int k = 0; k < n_dense; ++k) {
    const double rho = rho0 + h_dense * static_cast<double>(k);
    double a0, a1, b0, b1, c0, c1, d0, d1;
    rhs(L.p, rho, y0, y1, a0, a1);
    rhs(L.p, rho + half_h, y0 + half_h * a0, y1 + half_h * a1, b0, b1);
    rhs(L.p, rho + half_h, y0 + half_h * b0, y1 + half_h * b1, c0, c1);
    rhs(L.p, rho + h_dense, y0 + h_dense * c0, y1 + h_dense * c1, d0, d1);
    double n0 = y0 + sixth_h * (a0 + 2.0 * b0 + 2.0 * c0 + d0);
    double n1 = y1 + sixth_h * (a1 + 2.0 * b1 + 2.0 * c1 + d1);
    if (n0 < settle) {
      n0 = L.phi_false;
      n1 = 0.0 * L.phi_false;
    }
    const double f_new = integrand(L.p, rho + h_dense, n0, n1, v_false);
    s_acc = s_acc + 0.5 * (f_prev + f_new) * h_dense;
    f_prev = f_new;
    if (idx < 0 && n0 <= L.phi_mid) {
      idx = k + 1;
      p_prev = y0;
      p_at = n0;
    }
    y0 = n0;
    y1 = n1;
    phi_out[row + k + 1] = y0;
    dphi_out[row + k + 1] = y1;
    finite = finite && isfinite(y0);
  }
  const double action = two_pi_sq * s_acc;
  const bool crossed = idx > 0;
  double r_wall = NAN;
  if (crossed) {
    const double denom = p_at == p_prev ? 1.0 : p_at - p_prev;
    const double frac = (L.phi_mid - p_prev) / denom;
    r_wall = (rho0 + h_dense * static_cast<double>(idx - 1)) + frac * h_dense;
  }
  phi0_out[i] = phi0;
  r_wall_out[i] = r_wall;
  action_out[i] = action;
  converged_out[i] = ok && crossed && isfinite(action) && finite;
  steps_out[i] = steps;
  segments_out[i] = segments;
}

__global__ void __launch_bounds__(kThreads)
bounce_classify_kernel(const double* __restrict__ params, const double* __restrict__ phi0,
                       int n_lanes, double rho0, double h_seg, int n_segments,
                       int64_t* __restrict__ verdict_out, double* __restrict__ first_out,
                       double* __restrict__ end_out, int64_t* __restrict__ segments_out,
                       int64_t* __restrict__ steps_out, uint8_t* __restrict__ ok_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_lanes) return;
  const Lane L = load_lane(params, i);
  const Verdict v = classify(L, phi0[i], rho0, h_seg, n_segments);
  verdict_out[i] = v.verdict;
  first_out[2 * i] = v.first0;
  first_out[2 * i + 1] = v.first1;
  end_out[2 * i] = v.end0;
  end_out[2 * i + 1] = v.end1;
  segments_out[i] = v.segments;
  steps_out[i] = v.steps;
  ok_out[i] = v.ok;
}

int blocks_for(int n_lanes) { return (n_lanes + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// Each entry point launches on `stream`, does not synchronise, and returns
// the launch's cudaError_t (0 = launched).

int bounce_shoot(const double* params, int n_lanes, double rho0, double h_seg,
                 int n_segments, int n_bisect, double h_dense, int n_dense,
                 double two_pi_sq, double* phi0, double* r_wall, double* action,
                 uint8_t* converged, double* phi, double* dphi, int64_t* steps,
                 int64_t* segments, void* stream) {
  bounce_shoot_kernel<<<blocks_for(n_lanes), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      params, n_lanes, rho0, h_seg, n_segments, n_bisect, h_dense, n_dense, two_pi_sq,
      phi0, r_wall, action, converged, phi, dphi, steps, segments);
  return static_cast<int>(cudaGetLastError());
}

int bounce_classify(const double* params, const double* phi0, int n_lanes, double rho0,
                    double h_seg, int n_segments, int64_t* verdict, double* first,
                    double* end, int64_t* segments, int64_t* steps, uint8_t* ok,
                    void* stream) {
  bounce_classify_kernel<<<blocks_for(n_lanes), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      params, phi0, n_lanes, rho0, h_seg, n_segments, verdict, first, end, segments,
      steps, ok);
  return static_cast<int>(cudaGetLastError());
}

const char* bounce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
