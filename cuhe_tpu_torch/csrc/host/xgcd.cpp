// Batched polynomial inverse modulo (m(x), p_i), for keygen's f^-1.
//
// Host code, built with g++ by cuhe_tpu_torch/hostlib.py and loaded through
// ctypes.  The port's own copy of the JAX package's optional C++ host
// routine `poly_inv_batch` (the same algorithm, the same C interface): the
// reference inverts f in NTL's ZZ_pE (examples/DHS/DHS.cu:377-393); q0 is a
// product of CRT primes, so f is inverted modulo each prime by the extended
// Euclidean algorithm over Z_p[x], OpenMP across the primes, and combined by
// the CRT in Python (dhs.py).  The plain version is
// hostmath.poly_xgcd_mod_p (numpy), which the tests hold this against.
//
// All primes are < 2^31, so every residue product fits in int64.

#include <cstdint>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

int64_t mod_inverse(int64_t a, int64_t p) {
  // extended Euclid over the integers
  int64_t r0 = p, r1 = ((a % p) + p) % p;
  int64_t t0 = 0, t1 = 1;
  while (r1 != 0) {
    int64_t q = r0 / r1;
    int64_t r2 = r0 - q * r1;
    r0 = r1;
    r1 = r2;
    int64_t t2 = t0 - q * t1;
    t0 = t1;
    t1 = t2;
  }
  if (r0 != 1) return -1;  // not invertible (p should be prime)
  return ((t0 % p) + p) % p;
}

// inverse of f modulo (m(x), p); n = deg(m).  f has n coefficients (deg < n),
// m has n+1.  out receives n coefficients.  Returns 0 on success.
int inv_one(const int64_t* f, const int64_t* m, int64_t p, int n,
            int64_t* out) {
  std::vector<int64_t> r0(m, m + n + 1);
  std::vector<int64_t> r1(n + 1, 0);
  std::vector<int64_t> s0(n + 1, 0);
  std::vector<int64_t> s1(n + 1, 0);
  for (int i = 0; i <= n; i++) r0[i] = ((r0[i] % p) + p) % p;
  for (int i = 0; i < n; i++) r1[i] = ((f[i] % p) + p) % p;
  s1[0] = 1;
  int d0 = n, d1 = n;
  while (d0 >= 0 && r0[d0] == 0) d0--;
  while (d1 >= 0 && r1[d1] == 0) d1--;
  if (d0 < 0) return -1;
  while (d1 > 0) {
    int64_t inv_lc1 = mod_inverse(r1[d1], p);
    if (inv_lc1 < 0) return -1;
    while (d0 >= d1) {
      int64_t lc0 = r0[d0];
      if (lc0 != 0) {
        int64_t c = lc0 * inv_lc1 % p;  // < 2^62 before mod: p < 2^31
        int k = d0 - d1;
        int64_t* r0k = r0.data() + k;
        const int64_t* r1d = r1.data();
        for (int i = 0; i <= d1; i++) {
          int64_t v = (r0k[i] - c * r1d[i]) % p;
          r0k[i] = v < 0 ? v + p : v;
        }
        int64_t* s0k = s0.data() + k;
        const int64_t* s1d = s1.data();
        int lim = n - k;
        for (int i = 0; i <= lim; i++) {
          int64_t v = (s0k[i] - c * s1d[i]) % p;
          s0k[i] = v < 0 ? v + p : v;
        }
      }
      d0--;
    }
    r0.swap(r1);
    s0.swap(s1);
    std::swap(d0, d1);
    while (d1 >= 0 && r1[d1] == 0) d1--;
    if (d1 < 0) return -1;
  }
  if (d1 < 0 || r1[0] == 0) return -1;
  int64_t cinv = mod_inverse(r1[0], p);
  if (cinv < 0) return -1;
  for (int i = 0; i < n; i++) out[i] = s1[i] * cinv % p;
  return 0;
}

}  // namespace

extern "C" {

// fs: [np][n] residues of f mod p_i; ms: [np][n+1] residues of m(x);
// ps: [np]; out: [np][n]; ok: [np] (0 = success per prime).
void poly_inv_batch(const int64_t* fs, const int64_t* ms, const int64_t* ps,
                    int np, int n, int64_t* out, int32_t* ok) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int i = 0; i < np; i++) {
    ok[i] = inv_one(fs + (int64_t)i * n, ms + (int64_t)i * (n + 1), ps[i], n,
                    out + (int64_t)i * n);
  }
}

}  // extern "C"
