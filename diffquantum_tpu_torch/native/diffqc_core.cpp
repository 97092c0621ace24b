// diffqc_core — the native CPU engine of diffquantum_tpu_torch.
//
// The port's own copy of the JAX package's CPU engine (the same C ABI,
// the same arithmetic), so the port builds and loads it without the JAX
// package: native/bindings.py compiles it with the host's c++ into
// build/libdiffqc_core_<hash>.so. It is host code, not a kernel: it runs
// the reference's C++ backend semantics (diffqc.cc: set_H / trotter with
// the carrier-modulated two-quadrature channel pulse model) on the CPU.
//
//  * instance-based contexts behind an integer handle (the reference keeps
//    ONE system in mutable module globals, diffqc.cc:21-25);
//  * no Eigen / no C++17 std::legendre dependency: self-contained complex
//    dense kernels + Legendre via the Bonnet recurrence;
//  * the propagator applies exp(-i dt H) directly to the state with a
//    scaling-and-squaring truncated-Taylor *matvec* chain — O(d^2 * order)
//    per step instead of the reference's dense-expm O(d^3) (diffqc.cc:198);
//  * plain C ABI (extern "C") for ctypes binding — no pybind11.
//
// Semantics matched to the reference (cited in the Python wrapper):
//  * n_steps = (int)(per_step * (|T-T0| + 1)), left-endpoint time grid;
//  * channel model: A/B quadratures, N = sqrt(A^2+B^2),
//    omega * (2*expit(N)-1)/N * (cos(w t) A + sin(w t) B), N < 1e-6 -> 0,
//    expit clamped to exactly 0/1 beyond |x| = 32;
//  * basis: func_type 0 = Legendre P_j(2t/T-1), 1 = quadratic B-spline bump
//    on t/T with tau = 1/(n_basis-2), center tau*(b-1.5), support +-1.5 tau.


#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <vector>

using cplx = std::complex<double>;

namespace {

struct Channel {
  int control;   // which H_k this channel drives
  double omega;  // drive strength
  double w;      // carrier angular frequency
  int idx;       // coefficient row in vv[2][n_idx][n_basis]
};

struct System {
  int dim = 0;
  std::vector<cplx> H0;               // dim*dim row-major
  std::vector<std::vector<cplx>> Hs;  // n_controls x (dim*dim)
  std::vector<Channel> channels;
  double duration = 1.0;
  int func_type = 0;  // 0: legendre, 1: bspline
};

std::map<int, System> g_systems;
int g_next_handle = 1;
std::mutex g_mu;

double clamped_expit(double x) {
  if (x > 32.0) return 1.0;
  if (x < -32.0) return 0.0;
  return 1.0 / (1.0 + std::exp(-x));
}

// P_j(x) for j = 0..n-1 (Bonnet recurrence).
void legendre_row(double x, int n, double* out) {
  if (n > 0) out[0] = 1.0;
  if (n > 1) out[1] = x;
  for (int j = 2; j < n; ++j)
    out[j] = ((2 * j - 1) * x * out[j - 1] - (j - 1) * out[j - 2]) / j;
}

// Cardinal quadratic bump on normalized time tn in [0, 1].
double bspline_bump(int b, int n_basis, double tn) {
  const double tau = 1.0 / (n_basis - 2.0);
  const double center = tau * (b - 1.5);
  const double l = center - 1.5 * tau;
  const double r = center + 1.5 * tau;
  if (tn <= l || tn >= r) return 0.0;
  return (tn - l) * (tn - r) / (-(1.5 * tau) * (1.5 * tau));
}

void basis_row(const System& sys, int n_basis, double t, double* out) {
  if (sys.func_type == 0) {
    legendre_row(2.0 * t / sys.duration - 1.0, n_basis, out);
  } else {
    for (int j = 0; j < n_basis; ++j)
      out[j] = bspline_bump(j, n_basis, t / sys.duration);
  }
}

// Carrier-modulated channel envelope for control h at time t.
// vv layout: [2][n_idx][n_basis] row-major.
double channel_amplitude(const System& sys, int h, double t, const double* vv,
                         int n_idx, int n_basis,
                         const std::vector<double>& phi) {
  double ans = 0.0;
  for (const Channel& c : sys.channels) {
    if (c.control != h) continue;
    const double* va = vv + (size_t)c.idx * n_basis;             // quad A
    const double* vb = vv + ((size_t)n_idx + c.idx) * n_basis;   // quad B
    double A = 0.0, B = 0.0;
    for (int j = 0; j < n_basis; ++j) {
      A += va[j] * phi[j];
      B += vb[j] * phi[j];
    }
    const double N = std::sqrt(A * A + B * B);
    if (N < 1e-6) continue;
    ans += c.omega * (2.0 * clamped_expit(N) - 1.0) / N *
           (std::cos(c.w * t) * A + std::sin(c.w * t) * B);
  }
  return ans;
}

// y = M x (dense complex matvec, row-major).
void matvec(const std::vector<cplx>& M, const std::vector<cplx>& x,
            std::vector<cplx>& y, int d) {
  for (int i = 0; i < d; ++i) {
    cplx acc(0.0, 0.0);
    const cplx* row = M.data() + (size_t)i * d;
    for (int j = 0; j < d; ++j) acc += row[j] * x[j];
    y[i] = acc;
  }
}

// infinity norm of a dense complex matrix (cheap expm scaling bound).
double inf_norm(const std::vector<cplx>& M, int d) {
  double best = 0.0;
  for (int i = 0; i < d; ++i) {
    double s = 0.0;
    for (int j = 0; j < d; ++j) s += std::abs(M[(size_t)i * d + j]);
    if (s > best) best = s;
  }
  return best;
}

// psi <- exp(z H) psi via sub-stepped truncated Taylor (matvecs only).
void expm_apply(const std::vector<cplx>& H, std::vector<cplx>& psi, cplx z,
                int d, std::vector<cplx>& term, std::vector<cplx>& tmp) {
  const double scaled = std::abs(z) * inf_norm(H, d);
  int r = 1;
  while (scaled / r > 1.0 && r < (1 << 20)) r <<= 1;
  const int order = 18;  // theta <= 1 -> truncation ~ 1/19! ~ 8e-18
  const cplx zr = z / (double)r;
  for (int sub = 0; sub < r; ++sub) {
    term = psi;
    for (int k = 1; k <= order; ++k) {
      matvec(H, term, tmp, d);
      const cplx f = zr / (double)k;
      for (int i = 0; i < d; ++i) {
        term[i] = f * tmp[i];
        psi[i] += term[i];
      }
    }
  }
}

}  // namespace

extern "C" {

int dqc_create() {
  std::lock_guard<std::mutex> lk(g_mu);
  int h = g_next_handle++;
  g_systems[h] = System();
  return h;
}

void dqc_destroy(int handle) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_systems.erase(handle);
}

// H0/Hs as separate re/im planes (row-major), channels flattened
// [n_chan][4] = {control, omega, w, idx}.
int dqc_set_system(int handle, const double* h0_re, const double* h0_im,
                   int dim, const double* hs_re, const double* hs_im,
                   int n_hs, const double* channels, int n_chan,
                   double duration, int func_type) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_systems.find(handle);
  if (it == g_systems.end()) return -1;
  System& s = it->second;
  s.dim = dim;
  const size_t dd = (size_t)dim * dim;
  s.H0.resize(dd);
  for (size_t i = 0; i < dd; ++i) s.H0[i] = cplx(h0_re[i], h0_im[i]);
  s.Hs.assign(n_hs, std::vector<cplx>(dd));
  for (int k = 0; k < n_hs; ++k)
    for (size_t i = 0; i < dd; ++i)
      s.Hs[k][i] = cplx(hs_re[k * dd + i], hs_im[k * dd + i]);
  s.channels.clear();
  for (int c = 0; c < n_chan; ++c) {
    Channel ch;
    ch.control = (int)std::lround(channels[c * 4 + 0]);
    ch.omega = channels[c * 4 + 1];
    ch.w = channels[c * 4 + 2];
    ch.idx = (int)std::lround(channels[c * 4 + 3]);
    s.channels.push_back(ch);
  }
  s.duration = duration;
  s.func_type = func_type;
  return 0;
}

// Time-ordered evolution with the channel pulse model.
// vv: [2][n_idx][n_basis] row-major. psi in/out as re/im planes.
int dqc_trotter(int handle, const double* psi_re, const double* psi_im,
                int dim, double T0, double T, int per_step, const double* vv,
                int n_idx, int n_basis, double* out_re, double* out_im) {
  System sys;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_systems.find(handle);
    if (it == g_systems.end()) return -1;
    if (it->second.dim != dim) return -2;
    sys = it->second;  // copy so the lock is not held during compute
  }
  const int d = dim;
  const size_t dd = (size_t)d * d;
  const int n_steps = (int)(per_step * (std::fabs(T - T0) + 1.0));
  const double dt = (T - T0) / n_steps;

  std::vector<cplx> psi(d), Ht(dd), term(d), tmp(d);
  for (int i = 0; i < d; ++i) psi[i] = cplx(psi_re[i], psi_im[i]);
  std::vector<double> phi(n_basis);

  double t = T0;
  for (int step = 0; step < n_steps; ++step) {
    basis_row(sys, n_basis, t, phi.data());
    Ht = sys.H0;
    for (size_t h = 0; h < sys.Hs.size(); ++h) {
      const double u = channel_amplitude(sys, (int)h, t, vv, n_idx, n_basis,
                                         phi);
      if (u != 0.0) {
        const auto& Hk = sys.Hs[h];
        for (size_t i = 0; i < dd; ++i) Ht[i] += u * Hk[i];
      }
    }
    expm_apply(Ht, psi, cplx(0.0, -dt), d, term, tmp);
    t += dt;
  }
  for (int i = 0; i < d; ++i) {
    out_re[i] = psi[i].real();
    out_im[i] = psi[i].imag();
  }
  return 0;
}

// Simple-envelope variant (the Python pulse model, sim_plain.py:73-99):
// u_k(t) = (2 sigmoid(sum_j c_kj phi_j(t)) - 1) * omega_k.
// coeff: [n_hs][n_basis]; omegas: [n_hs]. basis_kind: 0 poly, 1 legendre,
// 2 fourier, 3 bspline.
int dqc_trotter_simple(int handle, const double* psi_re, const double* psi_im,
                       int dim, double T0, double T, int per_step,
                       const double* coeff, const double* omegas, int n_hs,
                       int n_basis, int basis_kind, double* out_re,
                       double* out_im) {
  System sys;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_systems.find(handle);
    if (it == g_systems.end()) return -1;
    if (it->second.dim != dim) return -2;
    sys = it->second;
  }
  const int d = dim;
  const size_t dd = (size_t)d * d;
  const int n_steps = (int)(per_step * (std::fabs(T - T0) + 1.0));
  const double dt = (T - T0) / n_steps;

  std::vector<cplx> psi(d), Ht(dd), term(d), tmp(d);
  for (int i = 0; i < d; ++i) psi[i] = cplx(psi_re[i], psi_im[i]);
  std::vector<double> phi(n_basis);

  double t = T0;
  for (int step = 0; step < n_steps; ++step) {
    // basis row for the simple model
    if (basis_kind == 0) {
      double p = 1.0;
      for (int j = 0; j < n_basis; ++j) { phi[j] = p; p *= (t - 0.5); }
    } else if (basis_kind == 1) {
      legendre_row(2.0 * t / sys.duration - 1.0, n_basis, phi.data());
    } else if (basis_kind == 2) {
      const int n = n_basis / 2;
      for (int j = 0; j < n_basis; ++j) phi[j] = 0.0;
      for (int j = 0; j < n; ++j) {
        phi[j] = std::cos(2.0 * M_PI * j * t);
        phi[j + n] = std::sin(2.0 * M_PI * j * t);
      }
    } else {
      for (int j = 0; j < n_basis; ++j)
        phi[j] = bspline_bump(j, n_basis, t / sys.duration);
    }
    Ht = sys.H0;
    for (int h = 0; h < n_hs && h < (int)sys.Hs.size(); ++h) {
      double a = 0.0;
      for (int j = 0; j < n_basis; ++j) a += coeff[h * n_basis + j] * phi[j];
      const double u = (2.0 * clamped_expit(a) - 1.0) * omegas[h];
      const auto& Hk = sys.Hs[h];
      for (size_t i = 0; i < dd; ++i) Ht[i] += u * Hk[i];
    }
    expm_apply(Ht, psi, cplx(0.0, -dt), d, term, tmp);
    t += dt;
  }
  for (int i = 0; i < d; ++i) {
    out_re[i] = psi[i].real();
    out_im[i] = psi[i].imag();
  }
  return 0;
}

// Smoke tests mirroring the reference's binding checks (diffqc.cc:27-38).
void dqc_print_test() { std::puts("hello"); }

int dqc_complex_test(const double* in_re, const double* in_im, int n,
                     double* out_re, double* out_im) {
  std::memcpy(out_re, in_re, sizeof(double) * n);
  std::memcpy(out_im, in_im, sizeof(double) * n);
  return 0;
}

const char* dqc_version() { return "0.1.0"; }

}  // extern "C"
