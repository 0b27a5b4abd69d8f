// Batched polynomial inverse modulo (m(x), p_i), for keygen's f^-1.
//
// Host code, built with g++ by cuhe_tpu_torch/hostlib.py and loaded through
// ctypes.  The port's own version of the JAX package's optional C++ host
// routine `poly_inv_batch` (the same algorithm, the same C interface): the
// reference inverts f in NTL's ZZ_pE (examples/DHS/DHS.cu:377-393); q0 is a
// product of CRT primes, so f is inverted modulo each prime by the extended
// Euclidean algorithm over Z_p[x], OpenMP across the primes, and combined by
// the CRT in Python (dhs.py).  The plain version is
// hostmath.poly_xgcd_mod_p (numpy), which the tests hold this against.
//
// All primes are < 2^31, so residues are held in 32 bits.  Every step of a
// division subtracts c times the divisor for one c: its products are taken
// with Shoup's precomputed quotient floor(c 2^32 / p), two multiplies and no
// division a coefficient.  The Bezout coefficient's loop runs over its
// degree, not over the whole length.  The inverse is unique, so the result
// is the one any exact algorithm gives.

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

// dst[i] = (dst[i] - c src[i]) mod p for i < len; cs = floor(c 2^32 / p).
// c src - floor(cs src / 2^32) p lies in [0, 2p) (Shoup), so one
// conditional subtract makes it canonical.  Built for several instruction
// sets; the loader takes the widest that the machine has.
__attribute__((target_clones("avx512f", "avx2", "default")))
void sub_mul(uint32_t* dst, const uint32_t* src, int len, uint32_t c,
                    uint32_t cs, uint32_t p) {
  for (int i = 0; i < len; i++) {
    uint32_t x = src[i];
    uint32_t q = (uint32_t)(((uint64_t)cs * x) >> 32);
    uint32_t t = c * x - q * p;  // exact mod 2^32: the true value is < 2p
    t = t >= p ? t - p : t;
    uint32_t d = dst[i];
    dst[i] = d >= t ? d - t : d + p - t;
  }
}

// inverse of f modulo (m(x), p); n = deg(m).  f has n coefficients (deg < n),
// m has n+1.  out receives n coefficients.  Returns 0 on success.
int inv_one(const int64_t* f, const int64_t* m, int64_t p, int n,
            int64_t* out) {
  const uint32_t p32 = (uint32_t)p;
  std::vector<uint32_t> r0(n + 1), r1(n + 1, 0), s0(n + 1, 0), s1(n + 1, 0);
  for (int i = 0; i <= n; i++) r0[i] = (uint32_t)(((m[i] % p) + p) % p);
  for (int i = 0; i < n; i++) r1[i] = (uint32_t)(((f[i] % p) + p) % p);
  s1[0] = 1;
  int d0 = n, d1 = n;
  int e0 = -1, e1 = 0;  // degree bounds of s0 and s1 (-1: zero)
  while (d0 >= 0 && r0[d0] == 0) d0--;
  while (d1 >= 0 && r1[d1] == 0) d1--;
  if (d0 < 0) return -1;
  while (d1 > 0) {
    int64_t inv_lc1 = mod_inverse(r1[d1], p);
    if (inv_lc1 < 0) return -1;
    while (d0 >= d1) {
      uint32_t lc0 = r0[d0];
      if (lc0 != 0) {
        uint32_t c = (uint32_t)((uint64_t)lc0 * (uint64_t)inv_lc1 % p);
        uint32_t cs = (uint32_t)(((uint64_t)c << 32) / p);
        int k = d0 - d1;
        sub_mul(r0.data() + k, r1.data(), d1 + 1, c, cs, p32);
        int len = e1 + 1 < n + 1 - k ? e1 + 1 : n + 1 - k;
        if (len > 0) {
          sub_mul(s0.data() + k, s1.data(), len, c, cs, p32);
          if (len - 1 + k > e0) e0 = len - 1 + k;
        }
      }
      d0--;
    }
    r0.swap(r1);
    s0.swap(s1);
    std::swap(d0, d1);
    std::swap(e0, e1);
    while (d1 >= 0 && r1[d1] == 0) d1--;
    if (d1 < 0) return -1;
  }
  if (d1 < 0 || r1[0] == 0) return -1;
  int64_t cinv = mod_inverse(r1[0], p);
  if (cinv < 0) return -1;
  for (int i = 0; i < n; i++) out[i] = (int64_t)s1[i] * cinv % p;
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
