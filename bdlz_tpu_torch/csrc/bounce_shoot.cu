// O(4) bounce shoot for NVIDIA Hopper (sm_90a): a depth-k bisection tree per lane.
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
// the port's eager ESDIRK solver; this file repeats its arithmetic
// operation by operation, in the same order.  It is built with
// -fmad=false (no contraction of a*b+c into one rounding), and torch's
// NaN-propagating min/max/clamp are written out, so on the card the kernels
// and the plain version on CUDA tensors agree to the last bit wherever
// CUDA's libm (pow) is shared.
//
// Kernels (all share one classify arithmetic: seg_start / seg_attempt):
//   bounce_tree_kernel — the main path (entry bounce_shoot).  One block per
//     lane.  Bisection's brackets depend only on the verdicts, so a round
//     of depth d = min(k, halvings left) classifies the 2^d − 1 midpoints
//     of the depth-d subtree of the current bracket at once, one thread per
//     node (heap order: node t has children 2t+1, taken after an overshoot,
//     and 2t+2, after an undershoot).  Each node's midpoint is 0.5*(lo+hi) of
//     its own sub-bracket; thread 0 then walks from the root with the
//     verdicts (verdict < 0: lo = mid, else hi = mid).  Every node on the
//     chosen path saw the bracket the serial halving sees and ran the same
//     classify, so φ₀ and every output equal the serial bisection's bit for
//     bit, for every k: THE OUTPUTS DO NOT DEPEND ON k.  ok, attempted
//     steps and segment solves are taken over the chosen path's nodes
//     only, as bdlz_tpu/bounce/shooting.py:177 (bisect_body) takes them;
//     an off-path node that fails marks nothing.  Thread 0 runs the dense
//     pass after the last round.  k is derived on the host
//     (bounce_tree_plan) from W, the SM count and the kernel's registers
//     as the occupancy calculator reports them: the fewest (waves × rounds)
//     with every depth up to 9 (511 nodes in 512 threads, 128 registers a
//     thread), the shallower tree on a tie.  It is no knob of the solver.
//   bounce_shoot_serial_kernel — the one-thread-per-lane shoot: one thread
//     runs the n_bisect classifications in turn (entry
//     bounce_shoot_serial).  The witness the tree is held against.
//   bounce_classify_kernel — one release point's verdict per lane, check only.
//   bounce_latency_probe_kernel — one thread times dependent f64 chains
//     (add, multiply, division, sqrt, pow) with clock64().
//
// Warp divergence.  The nodes of a warp classify different release points.
// Nested as segments around attempted steps, a warp would pay Σ over
// segments of its slowest thread's steps; the tree's classify
// (classify_flat) is one loop over attempted steps in which a segment's end
// and the next segment's Hairer–Wanner start are state transitions, so a
// warp pays its slowest thread's total.  The serial kernel keeps the
// nested form; both call the same seg_start / seg_attempt.
//
// Bound on this card: latency.  A classification is one chain of dependent
// attempted steps; each step is 5 implicit stages of 6 dependent Newton
// iterations, so nothing inside a step runs in parallel.  The least time of
// a tree shoot is Σ over rounds of the round's slowest node's attempted
// steps (the critical path, which the kernel reports) × the dependent f64
// chain of one step × the latency of each operation, plus the dense pass's
// chain; chip_smoke.py counts the chain and measures the latencies with the
// probe kernel.  A lane's values live in registers; lanes are independent
// blocks, so a batch costs its slowest lane when it fits one wave.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kSerialThreads = 32;
constexpr int kMaxDepth = 9;
constexpr int kTreeThreads = 512;  // 2^kMaxDepth − 1 nodes in whole warps

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

// One adaptive SDIRK4(3) solve over [x0, x1] (sdirk.esdirk_solve with
// auto_h0=True, the I controller, no step cap beyond the span), as a state
// that seg_start opens and seg_attempt advances by one attempted step.
struct SegState {
  double x, x1, y0, y1, fl0, fl1, h, abs_span;
  int64_t n;
  bool done;
};

// esdirk_init, Hairer–Wanner starting step
__device__ __forceinline__ void seg_start(const Pot& p, double x0, double x1, double yy0,
                                          double yy1, SegState& s) {
  const double span = x1 - x0;
  const double abs_span = fabs(span);
  const double h_cap = abs_span;
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
  s.x = x0;
  s.x1 = x1;
  s.y0 = yy0;
  s.y1 = yy1;
  s.fl0 = f0;
  s.fl1 = f1;
  s.h = h;
  s.abs_span = abs_span;
  s.n = 0;
  s.done = false;
}

__device__ __forceinline__ bool seg_running(const SegState& s) {
  return !s.done && s.n < kMaxSteps;
}

__device__ __forceinline__ bool seg_success(const SegState& s) {
  return s.done && isfinite(s.y0) && isfinite(s.y1);
}

// one attempted step: every stage implicit, predicted from the previous
// slope, then the embedded error and the I controller
__device__ __forceinline__ void seg_attempt(const Pot& p, SegState& s) {
  const double h_cap = s.abs_span;
  const double h_eff = tmin(tmin(s.h, h_cap), s.x1 - s.x);
  double k0[5], k1[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const double x_s = s.x + kC[i] * h_eff;
    double acc0 = s.y0, acc1 = s.y1;
#pragma unroll
    for (int j = 0; j < i; ++j) {
      acc0 = acc0 + h_eff * kA[i][j] * k0[j];
      acc1 = acc1 + h_eff * kA[i][j] * k1[j];
    }
    const double kp0 = i ? k0[i - 1] : s.fl0;
    const double kp1 = i ? k1[i - 1] : s.fl1;
    const double hg = h_eff * kG;
    double Y0 = acc0 + hg * kp0;
    double Y1 = acc1 + hg * kp1;
    newton(p, x_s, acc0, acc1, Y0, Y1, hg);
    rhs(p, x_s, Y0, Y1, k0[i], k1[i]);
  }
  double yn0 = s.y0, yn1 = s.y1, ye0 = s.y0, ye1 = s.y1;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    yn0 = yn0 + h_eff * kB[j] * k0[j];
    yn1 = yn1 + h_eff * kB[j] * k1[j];
    ye0 = ye0 + h_eff * kBEmb[j] * k0[j];
    ye1 = ye1 + h_eff * kBEmb[j] * k1[j];
  }
  const double s0 = kAtol + kRtol * tmax(fabs(s.y0), fabs(yn0));
  const double s1 = kAtol + kRtol * tmax(fabs(s.y1), fabs(yn1));
  double err = rms2((yn0 - ye0) / s0, (yn1 - ye1) / s1);

  // the I controller
  err = isfinite(err) ? err : INFINITY;
  const bool accept = err <= 1.0;
  const double e = err > 0.0 ? err : 1e-10;
  double factor = 0.9 * pow(e, -1.0 / kOrder);
  factor = tclamp(factor, 0.2, 5.0);
  const double h_next = tclamp(h_eff * factor, s.abs_span * 1e-12, h_cap);
  if (accept) {
    s.x = s.x + h_eff;
    s.y0 = yn0;
    s.y1 = yn1;
    s.fl0 = k0[4];
    s.fl1 = k1[4];
  }
  s.h = h_next;
  ++s.n;
  s.done = s.x >= s.x1 - s.abs_span * 1e-14;
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

__device__ __forceinline__ Verdict verdict_start(const Lane& L, double phi0, double rho0,
                                                 double& y0, double& y1) {
  Verdict v;
  series_ic(L.p, phi0, rho0, y0, y1);
  v.verdict = 0;
  v.segments = 0;
  v.steps = 0;
  v.ok = true;
  v.first0 = y0;
  v.first1 = y1;
  return v;
}

// a finished segment's end state and counts, folded into the verdict
__device__ __forceinline__ void verdict_segment(const Lane& L, const SegState& s, int k,
                                                Verdict& v, double& y0, double& y1) {
  const double floor_phi = L.phi_false - kOvershootFrac * L.delta_phi;
  y0 = s.y0;
  y1 = s.y1;
  v.verdict = y0 < floor_phi ? 1 : (y1 > kUndershootVTol ? -1 : 0);
  v.ok = v.ok && seg_success(s);
  v.segments += 1;
  v.steps += s.n;
  if (k == 0) {
    v.first0 = y0;
    v.first1 = y1;
  }
}

__device__ __forceinline__ void verdict_end(Verdict& v, double y0, double y1) {
  if (v.verdict == 0) v.verdict = -1;  // friction won by ρ_max: undershoot
  v.end0 = y0;
  v.end1 = y1;
}

// the nested form: segments around attempted steps
__device__ Verdict classify(const Lane& L, double phi0, double rho0, double h_seg,
                            int n_segments) {
  double y0, y1;
  Verdict v = verdict_start(L, phi0, rho0, y0, y1);
  for (int k = 0; k < n_segments && v.verdict == 0; ++k) {
    const double a = rho0 + h_seg * static_cast<double>(k);
    SegState s;
    seg_start(L.p, a, a + h_seg, y0, y1, s);
    while (seg_running(s)) seg_attempt(L.p, s);
    verdict_segment(L, s, k, v, y0, y1);
  }
  verdict_end(v, y0, y1);
  return v;
}

// the flattened form: one loop over attempted steps; a segment opens at the
// top of an iteration and closes when its solve stops
__device__ Verdict classify_flat(const Lane& L, double phi0, double rho0, double h_seg,
                                 int n_segments) {
  double y0, y1;
  Verdict v = verdict_start(L, phi0, rho0, y0, y1);
  SegState s;
  int k = 0;
  bool open = false;
  while (v.verdict == 0 && k < n_segments) {
    if (!open) {
      const double a = rho0 + h_seg * static_cast<double>(k);
      seg_start(L.p, a, a + h_seg, y0, y1, s);
      open = true;
    }
    seg_attempt(L.p, s);
    if (!seg_running(s)) {
      verdict_segment(L, s, k, v, y0, y1);
      ++k;
      open = false;
    }
  }
  verdict_end(v, y0, y1);
  return v;
}

__device__ __forceinline__ double integrand(const Pot& p, double rho, double y0, double y1,
                                            double v_false) {
  return rho * (rho * rho) * (0.5 * y1 * y1 + pot_V(y0, p) - v_false);
}

struct Outputs {
  double *phi0, *r_wall, *action;
  uint8_t* converged;
  double *phi, *dphi;
  int64_t *steps, *segments;
};

// dense pass: fixed-grid RK4 with the settle freeze, action in order; then
// lane i's outputs
__device__ void dense_pass(const Lane& L, int i, double phi0, bool ok, int64_t steps,
                           int64_t segments, double rho0, double h_dense, int n_dense,
                           double two_pi_sq, const Outputs& out) {
  const double v_false = pot_V(L.phi_false, L.p);
  const double settle = L.phi_false + kSettleFrac * L.delta_phi;
  const double half_h = 0.5 * h_dense;
  const double sixth_h = h_dense / 6.0;
  const int64_t row = static_cast<int64_t>(i) * (n_dense + 1);
  double y0, y1;
  series_ic(L.p, phi0, rho0, y0, y1);
  double f_prev = integrand(L.p, rho0, y0, y1, v_false);
  double s_acc = 0.0;
  out.phi[row] = y0;
  out.dphi[row] = y1;
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
    out.phi[row + k + 1] = y0;
    out.dphi[row + k + 1] = y1;
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
  out.phi0[i] = phi0;
  out.r_wall[i] = r_wall;
  out.action[i] = action;
  out.converged[i] = ok && crossed && isfinite(action) && finite;
  out.steps[i] = steps;
  out.segments[i] = segments;
}

__global__ void __launch_bounds__(kSerialThreads)
bounce_shoot_serial_kernel(const double* __restrict__ params, int n_lanes, double rho0,
                           double h_seg, int n_segments, int n_bisect, double h_dense,
                           int n_dense, double two_pi_sq, Outputs out) {
  const int i = blockIdx.x * kSerialThreads + threadIdx.x;
  if (i >= n_lanes) return;
  const Lane L = load_lane(params, i);
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
  dense_pass(L, i, lo, ok, steps, segments, rho0, h_dense, n_dense, two_pi_sq, out);
}

// one tree node's classification, as thread 0's walk reads it
struct Node {
  int64_t steps;
  int32_t segments;
  int8_t verdict;
  uint8_t ok;
};

int tree_threads(int depth) { return (((1 << depth) - 1) + 31) / 32 * 32; }
size_t tree_smem(int depth) { return static_cast<size_t>((1 << depth) - 1) * sizeof(Node); }

// stats, per lane: critical-path steps (Σ over rounds of the slowest node's
// attempted steps), every node's steps, the depth k, the rounds
constexpr int kStats = 4;

__global__ void __launch_bounds__(kTreeThreads, 1)
bounce_tree_kernel(const double* __restrict__ params, double rho0, double h_seg,
                   int n_segments, int n_bisect, int depth, double h_dense, int n_dense,
                   double two_pi_sq, Outputs out, int64_t* __restrict__ stats) {
  extern __shared__ Node node[];
  __shared__ double s_lo, s_hi;
  const int i = blockIdx.x;
  const int t = threadIdx.x;
  const Lane L = load_lane(params, i);
  if (t == 0) {
    s_lo = L.phi_top;
    s_hi = L.phi_true - kHiOffsetFrac * L.delta_phi;
  }
  __syncthreads();
  // thread 0's walk: the chosen path's sums, and the round statistics
  bool ok = true;
  int64_t steps = 0, segments = 0, critical = 0, total = 0;
  int rounds = 0;
  for (int left = n_bisect; left > 0; ++rounds) {
    const int d = left < depth ? left : depth;
    const int nodes = (1 << d) - 1;
    if (t < nodes) {
      // the bracket of node t: its position's bits, root first
      const int level = 31 - __clz(t + 1);
      const int pos = t + 1 - (1 << level);
      double lo = s_lo, hi = s_hi;
      for (int b = level - 1; b >= 0; --b) {
        const double mid = 0.5 * (lo + hi);
        if ((pos >> b) & 1) {
          lo = mid;
        } else {
          hi = mid;
        }
      }
      const Verdict v = classify_flat(L, 0.5 * (lo + hi), rho0, h_seg, n_segments);
      node[t].steps = v.steps;
      node[t].segments = static_cast<int32_t>(v.segments);
      node[t].verdict = static_cast<int8_t>(v.verdict);
      node[t].ok = v.ok;
    }
    __syncthreads();
    if (t == 0) {
      double lo = s_lo, hi = s_hi;
      int at = 0;
      for (int l = 0; l < d; ++l) {
        const double mid = 0.5 * (lo + hi);
        const Node& n = node[at];
        if (n.verdict < 0) {
          lo = mid;
          at = 2 * at + 2;
        } else {
          hi = mid;
          at = 2 * at + 1;
        }
        ok = ok && n.ok;
        steps += n.steps;
        segments += n.segments;
      }
      int64_t slowest = 0;
      for (int j = 0; j < nodes; ++j) {
        total += node[j].steps;
        slowest = node[j].steps > slowest ? node[j].steps : slowest;
      }
      critical += slowest;
      s_lo = lo;
      s_hi = hi;
    }
    left -= d;
    __syncthreads();
  }
  if (t != 0) return;
  dense_pass(L, i, s_lo, ok, steps, segments, rho0, h_dense, n_dense, two_pi_sq, out);
  if (stats != nullptr) {
    int64_t* s = stats + kStats * static_cast<int64_t>(i);
    s[0] = critical;
    s[1] = total;
    s[2] = depth;
    s[3] = rounds;
  }
}

__global__ void __launch_bounds__(kSerialThreads)
bounce_classify_kernel(const double* __restrict__ params, const double* __restrict__ phi0,
                       int n_lanes, double rho0, double h_seg, int n_segments,
                       int64_t* __restrict__ verdict_out, double* __restrict__ first_out,
                       double* __restrict__ end_out, int64_t* __restrict__ segments_out,
                       int64_t* __restrict__ steps_out, uint8_t* __restrict__ ok_out) {
  const int i = blockIdx.x * kSerialThreads + threadIdx.x;
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

// Dependent chains of 16·reps f64 operations each, timed with clock64():
// cycles[0..4] = add, multiply, division, sqrt, pow.  Every operand comes
// from the arguments, so nothing folds; the results land in sink.
constexpr int kProbeUnroll = 16;

template <int Op>
__device__ __forceinline__ double probe_op(double x, double a, double b, double c) {
  if (Op == 0) return x + c;            // c = 1e-3
  if (Op == 1) return x * b;            // b = 1 + 1e-7
  if (Op == 2) return a / x;            // alternates between a and 1
  if (Op == 3) return sqrt(x);          // from 1e300·a down to 1
  return pow(0.5 * b, x);               // settles near 0.64
}

template <int Op>
__device__ __forceinline__ void probe_chain(double x, double a, double b, double c, int reps,
                                            long long* cycles, double* sink) {
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int u = 0; u < kProbeUnroll; ++u) x = probe_op<Op>(x, a, b, c);
  }
  const long long t1 = clock64();
  sink[Op] = x;
  cycles[Op] = t1 - t0;
}

__global__ void bounce_latency_probe_kernel(double a, double b, double c, int reps,
                                            long long* cycles, double* sink) {
  probe_chain<0>(a, a, b, c, reps, cycles, sink);
  probe_chain<1>(a, a, b, c, reps, cycles, sink);
  probe_chain<2>(a, a, b, c, reps, cycles, sink);
  probe_chain<3>(1e300 * a, a, b, c, reps, cycles, sink);
  probe_chain<4>(a, a, b, c, reps, cycles, sink);
}

int blocks_for(int n_lanes) { return (n_lanes + kSerialThreads - 1) / kSerialThreads; }

Outputs outputs(double* phi0, double* r_wall, double* action, uint8_t* converged,
                double* phi, double* dphi, int64_t* steps, int64_t* segments) {
  Outputs o;
  o.phi0 = phi0;
  o.r_wall = r_wall;
  o.action = action;
  o.converged = converged;
  o.phi = phi;
  o.dphi = dphi;
  o.steps = steps;
  o.segments = segments;
  return o;
}

}  // namespace

extern "C" {

// Each launching entry point launches on `stream`, does not synchronise,
// and returns the launch's cudaError_t (0 = launched).

// The tree's depth for W lanes and n_bisect halvings on the current device:
// the fewest (waves × rounds) over depths 1..min(9, n_bisect), where a wave
// is the lanes the occupancy calculator fits on every SM at once; the
// shallower tree on a tie.  Also reports the kernel's registers per thread,
// its blocks per SM at that depth, and the SM count.
int bounce_tree_plan(int n_lanes, int n_bisect, int* depth, int* registers,
                     int* blocks_per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, bounce_tree_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  *depth = 1;
  *blocks_per_sm = 0;
  long long best = LLONG_MAX;
  const int lanes = n_lanes > 0 ? n_lanes : 1;
  const int kmax = n_bisect < kMaxDepth ? (n_bisect > 1 ? n_bisect : 1) : kMaxDepth;
  for (int k = 1; k <= kmax; ++k) {
    const int threads = tree_threads(k);
    if (threads > attr.maxThreadsPerBlock) break;
    int nb = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, bounce_tree_kernel, threads,
                                                        tree_smem(k));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (nb < 1) break;
    const long long per_wave = static_cast<long long>(nb) * (*sms);
    const long long waves = (lanes + per_wave - 1) / per_wave;
    const long long rounds = n_bisect > 0 ? (n_bisect + k - 1) / k : 0;
    if (waves * rounds < best) {
      best = waves * rounds;
      *depth = k;
      *blocks_per_sm = nb;
    }
  }
  return 0;
}

// The main path: the tree kernel at `depth` (0 = bounce_tree_plan's).
// `stats` is null or (n_lanes, 4) int64: critical-path steps, total steps,
// depth, rounds.
int bounce_shoot(const double* params, int n_lanes, double rho0, double h_seg,
                 int n_segments, int n_bisect, double h_dense, int n_dense,
                 double two_pi_sq, int depth, double* phi0, double* r_wall, double* action,
                 uint8_t* converged, double* phi, double* dphi, int64_t* steps,
                 int64_t* segments, int64_t* stats, void* stream) {
  if (depth <= 0) {
    int regs, nb, sms;
    const int err = bounce_tree_plan(n_lanes, n_bisect, &depth, &regs, &nb, &sms);
    if (err != 0) return err;
  }
  if (depth > kMaxDepth) return static_cast<int>(cudaErrorInvalidValue);
  bounce_tree_kernel<<<n_lanes, tree_threads(depth), tree_smem(depth),
                       static_cast<cudaStream_t>(stream)>>>(
      params, rho0, h_seg, n_segments, n_bisect, depth, h_dense, n_dense, two_pi_sq,
      outputs(phi0, r_wall, action, converged, phi, dphi, steps, segments), stats);
  return static_cast<int>(cudaGetLastError());
}

// The one-thread-per-lane shoot, the witness the tree is held against.
int bounce_shoot_serial(const double* params, int n_lanes, double rho0, double h_seg,
                        int n_segments, int n_bisect, double h_dense, int n_dense,
                        double two_pi_sq, double* phi0, double* r_wall, double* action,
                        uint8_t* converged, double* phi, double* dphi, int64_t* steps,
                        int64_t* segments, void* stream) {
  bounce_shoot_serial_kernel<<<blocks_for(n_lanes), kSerialThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      params, n_lanes, rho0, h_seg, n_segments, n_bisect, h_dense, n_dense, two_pi_sq,
      outputs(phi0, r_wall, action, converged, phi, dphi, steps, segments));
  return static_cast<int>(cudaGetLastError());
}

int bounce_classify(const double* params, const double* phi0, int n_lanes, double rho0,
                    double h_seg, int n_segments, int64_t* verdict, double* first,
                    double* end, int64_t* segments, int64_t* steps, uint8_t* ok,
                    void* stream) {
  bounce_classify_kernel<<<blocks_for(n_lanes), kSerialThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      params, phi0, n_lanes, rho0, h_seg, n_segments, verdict, first, end, segments,
      steps, ok);
  return static_cast<int>(cudaGetLastError());
}

// `cycles` (5,) int64 and `sink` (5,) f64 on the device: 16·reps dependent
// add, multiply, division, sqrt and pow, in that order.
int bounce_latency_probe(int reps, long long* cycles, double* sink, void* stream) {
  bounce_latency_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      1.3, 1.0 + 1e-7, 1e-3, reps, cycles, sink);
  return static_cast<int>(cudaGetLastError());
}

int bounce_probe_unroll() { return kProbeUnroll; }

const char* bounce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
