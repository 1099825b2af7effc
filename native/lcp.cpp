// Native LCP solvers: dense Lemke + principal pivoting.
//
// An independent C++ implementation of the same algorithms the JAX solver
// cascade uses (solvers/lcp.py), exposed over a C ABI for ctypes. Serves as
//  (a) a cross-validation oracle for the batched JAX solver in tests, and
//  (b) a fast host-side fallback for tiny one-off solves where device
//      dispatch latency dominates.
//
// Solves: find z >= 0 with w = M z + q >= 0, z'w = 0.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <limits>
#include <vector>

namespace {

// Dense LU solve with partial pivoting; returns false when singular.
bool lu_solve(std::vector<double> A, int n, double* b) {
  std::vector<int> piv(n);
  for (int i = 0; i < n; ++i) piv[i] = i;
  for (int k = 0; k < n; ++k) {
    int p = k;
    double amax = std::fabs(A[k * n + k]);
    for (int i = k + 1; i < n; ++i) {
      double v = std::fabs(A[i * n + k]);
      if (v > amax) { amax = v; p = i; }
    }
    if (amax < 1e-300) return false;
    if (p != k) {
      for (int j = 0; j < n; ++j) std::swap(A[k * n + j], A[p * n + j]);
      std::swap(b[k], b[p]);
    }
    for (int i = k + 1; i < n; ++i) {
      double f = A[i * n + k] / A[k * n + k];
      A[i * n + k] = f;
      for (int j = k + 1; j < n; ++j) A[i * n + j] -= f * A[k * n + j];
      b[i] -= f * b[k];
    }
  }
  for (int i = n - 1; i >= 0; --i) {
    for (int j = i + 1; j < n; ++j) b[i] -= A[i * n + j] * b[j];
    b[i] /= A[i * n + i];
  }
  return true;
}

double norm_inf(const double* M, int n) {
  double best = 0.0;
  for (int i = 0; i < n; ++i) {
    double s = 0.0;
    for (int j = 0; j < n; ++j) s += std::fabs(M[i * n + j]);
    best = std::max(best, s);
  }
  return best;
}

}  // namespace

extern "C" {

// Principal pivoting method. Returns 1 on success.
int moby_lcp_ppm(const double* M, const double* q, int n, double* z,
                 double zero_tol) {
  if (n == 0) return 1;
  if (zero_tol < 0)
    zero_tol = n * norm_inf(M, n) * std::numeric_limits<double>::epsilon();

  std::vector<int> nonbas;  // indices with z potentially > 0
  // cold start: most negative q enters
  int minw = int(std::min_element(q, q + n) - q);
  if (q[minw] > -zero_tol) {
    std::memset(z, 0, sizeof(double) * n);
    return 1;
  }
  nonbas.push_back(minw);

  const int max_piv = 2 * n + 10;
  std::vector<double> zsub, wbas;
  for (int piv = 0; piv < max_piv; ++piv) {
    int m = int(nonbas.size());
    // solve M[nb, nb] zsub = -q[nb]
    std::vector<double> A(m * m);
    zsub.assign(m, 0.0);
    for (int i = 0; i < m; ++i) {
      zsub[i] = -q[nonbas[i]];
      for (int j = 0; j < m; ++j)
        A[i * m + j] = M[nonbas[i] * n + nonbas[j]];
    }
    if (m && !lu_solve(A, m, zsub.data())) return 0;

    // w on basic indices
    std::vector<int> bas;
    for (int i = 0, k = 0; i < n; ++i) {
      if (k < m && nonbas[k] == i) { ++k; continue; }
      bas.push_back(i);
    }
    int nb = int(bas.size());
    wbas.assign(nb, 0.0);
    for (int i = 0; i < nb; ++i) {
      double s = q[bas[i]];
      for (int j = 0; j < m; ++j) s += M[bas[i] * n + nonbas[j]] * zsub[j];
      wbas[i] = s;
    }

    int iw = nb ? int(std::min_element(wbas.begin(), wbas.end()) - wbas.begin())
                : -1;
    int iz = m ? int(std::min_element(zsub.begin(), zsub.end()) - zsub.begin())
               : -1;
    bool w_ok = (iw < 0) || wbas[iw] > -zero_tol;
    bool z_neg = (iz >= 0) && zsub[iz] < -zero_tol;

    if (w_ok && !z_neg) {
      std::memset(z, 0, sizeof(double) * n);
      for (int j = 0; j < m; ++j) z[nonbas[j]] = zsub[j];
      return 1;
    }
    if (!w_ok) {
      // most-negative w enters the nonbasic (z) set; if some z is negative,
      // that index leaves it (capture its value before mutating nonbas)
      int enter_idx = bas[iw];
      int leave_val = z_neg ? nonbas[iz] : -1;
      nonbas.insert(
          std::lower_bound(nonbas.begin(), nonbas.end(), enter_idx), enter_idx);
      if (leave_val >= 0)
        nonbas.erase(std::find(nonbas.begin(), nonbas.end(), leave_val));
    } else {
      // w >= 0 but some z < 0: drop that index from the nonbasic set
      nonbas.erase(nonbas.begin() + iz);
    }
  }
  return 0;
}

// Lemke's algorithm with covering vector on negative components.
int moby_lcp_lemke(const double* M, const double* q, int n, double* z,
                   double piv_tol, double zero_tol) {
  if (n == 0) return 1;
  double ni = norm_inf(M, n);
  if (zero_tol <= 0)
    zero_tol = std::numeric_limits<double>::epsilon() * ni * n;
  if (piv_tol <= 0)
    piv_tol = std::numeric_limits<double>::epsilon() * n * std::max(1.0, ni);

  if (*std::min_element(q, q + n) > -zero_tol) {
    std::memset(z, 0, sizeof(double) * n);
    return 1;
  }

  const int t_var = 2 * n;
  std::vector<int> basvar(n);
  for (int i = 0; i < n; ++i) basvar[i] = n + i;  // w vars basic
  std::vector<double> Bl(n * n, 0.0);
  for (int i = 0; i < n; ++i) Bl[i * n + i] = -1.0;
  std::vector<double> x(q, q + n);

  // artificial pivot
  int lv = int(std::min_element(x.begin(), x.end()) - x.begin());
  double tval = -x[lv];
  std::vector<double> u(n);
  for (int i = 0; i < n; ++i) u[i] = x[i] < 0 ? 1.0 : 0.0;
  std::vector<double> Be(n);
  for (int i = 0; i < n; ++i) {
    double s = 0;
    for (int j = 0; j < n; ++j) s += Bl[i * n + j] * u[j];
    Be[i] = -s;
  }
  for (int i = 0; i < n; ++i) x[i] += u[i] * tval;
  x[lv] = tval;
  for (int i = 0; i < n; ++i) Bl[i * n + lv] = Be[i];
  int leaving = basvar[lv];
  basvar[lv] = t_var;

  const int maxiter = std::min(1000, 50 * n);
  std::vector<double> d(n);
  for (int iter = 0; iter < maxiter; ++iter) {
    int entering;
    if (leaving == t_var) {
      std::memset(z, 0, sizeof(double) * n);
      for (int i = 0; i < n; ++i)
        if (basvar[i] < n) z[basvar[i]] = x[i];
      return 1;
    } else if (leaving < n) {
      entering = n + leaving;
      std::fill(Be.begin(), Be.end(), 0.0);
      Be[leaving] = -1.0;
    } else {
      entering = leaving - n;
      for (int i = 0; i < n; ++i) Be[i] = M[i * n + entering];
    }
    d = Be;
    if (!lu_solve(Bl, n, d.data())) return 0;

    double theta = std::numeric_limits<double>::infinity();
    for (int i = 0; i < n; ++i)
      if (d[i] > piv_tol) theta = std::min(theta, (x[i] + zero_tol) / d[i]);
    if (!std::isfinite(theta)) return 0;  // ray termination

    int pick = -1;
    for (int i = 0; i < n; ++i)
      if (d[i] > piv_tol && x[i] / d[i] <= theta) {
        if (basvar[i] == t_var) { pick = i; break; }
        if (pick < 0) pick = i;
      }
    if (pick < 0) return 0;

    double ratio = x[pick] / d[pick];
    for (int i = 0; i < n; ++i) x[i] -= d[i] * ratio;
    x[pick] = ratio;
    for (int i = 0; i < n; ++i) Bl[i * n + pick] = Be[i];
    leaving = basvar[pick];
    basvar[pick] = entering;
  }
  return 0;
}

// Regularized cascade: PPM then Lemke with Tikhonov sweeps.
int moby_lcp_solve(const double* M, const double* q, int n, double* z) {
  if (moby_lcp_ppm(M, q, n, z, -1.0)) {
    // verify
    bool ok = true;
    for (int i = 0; i < n && ok; ++i) {
      double w = q[i];
      for (int j = 0; j < n; ++j) w += M[i * n + j] * z[j];
      double tol = 1e-8 * std::max(1.0, norm_inf(M, n));
      if (z[i] < -tol || w < -tol || std::fabs(z[i] * w) > tol * 10) ok = false;
    }
    if (ok) return 1;
  }
  std::vector<double> Mreg(M, M + size_t(n) * n);
  for (int e = 0; e <= 21; ++e) {
    double lam = e == 0 ? 0.0 : std::pow(10.0, -20.0 + (e - 1));
    std::copy(M, M + size_t(n) * n, Mreg.begin());
    for (int i = 0; i < n; ++i) Mreg[i * n + i] += lam;
    if (moby_lcp_lemke(Mreg.data(), q, n, z, -1.0, -1.0)) return 1;
  }
  return 0;
}

// L-inf comparison of two trajectory arrays (rows x cols).
double moby_traj_linf(const double* a, const double* b, int rows, int cols) {
  double best = 0.0;
  for (long i = 0; i < long(rows) * cols; ++i)
    best = std::max(best, std::fabs(a[i] - b[i]));
  return best;
}

}  // extern "C"
