"""The port's native XGCD (cuhe_tpu_torch/hostlib.py, csrc/host/xgcd.cpp),
which keygen uses on every device, on the CPU:

  * its inverses equal the numpy XGCD's (hostmath.poly_xgcd_mod_p, the plain
    version) on random invertible f, at a small ring (Phi_127, several
    primes) and at one prime of the simple_DHS ring (Phi_8191);
  * they equal the JAX package's native poly_inv_batch_native where that
    library loads;
  * a non-invertible f sets the prime's failure flag, as the JAX package's
    does, where the numpy XGCD returns None;
  * two processes building at once both load one complete library, and a
    failed build raises, in keygen too: there is no fallback.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cuhe_tpu import hostmath as jhm
from cuhe_tpu_torch import entry, hostlib
from cuhe_tpu_torch import hostmath as hm
from cuhe_tpu_torch.dhs import CuDHS
from cuhe_tpu_torch.params import make_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
SMALL_M = 127
# 2287 = 18 * 127 + 1: Phi_127 splits into linear factors mod 2287
SMALL_PRIMES = [2287, 33554393, 1073741789]


def _batch(f, m, primes):
    fs = np.stack([np.asarray(f, dtype=np.int64) % p for p in primes])
    ms = np.stack([np.asarray(m, dtype=np.int64) % p for p in primes])
    return fs, ms, np.array(primes, dtype=np.int64)


def _numpy_inverse(f, m, p, n):
    inv = hm.poly_xgcd_mod_p(np.array(f, dtype=object) % p,
                             np.array(m, dtype=object) % p, p)
    if inv is None:
        return None
    out = np.zeros(n, dtype=np.int64)
    out[: min(n, len(inv))] = inv[:n]
    assert not np.any(inv[n:])
    return out


def _random_f(rng, n):
    """f = 1 + 2 t, t in {-1, 0, 1}^n: keygen's form of the secret key."""
    f = 2 * rng.integers(-1, 2, n)
    f[0] += 1
    return f


def _check_inverses(f, m, primes):
    n = len(m) - 1
    out, ok = hostlib.poly_inv_batch(*_batch(f, m, primes))
    assert out.shape == (len(primes), n) and out.dtype == np.int64
    for i, p in enumerate(primes):
        want = _numpy_inverse(f, m, p, n)
        assert want is not None and ok[i] == 0, p
        np.testing.assert_array_equal(out[i], want)
    return out, ok


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_small_ring_equals_numpy_xgcd(seed):
    m = hm.gen_poly_mod(SMALL_M)
    f = _random_f(np.random.default_rng(seed), len(m) - 1)
    _check_inverses(f, m, SMALL_PRIMES)


def test_simple_dhs_prime_equals_numpy_xgcd():
    pr = make_params(*entry.SIMPLE_DHS_PARAMS)
    m = list(pr.poly_mod)
    assert len(m) - 1 == pr.mod_len == 8190
    f = _random_f(np.random.default_rng(7), pr.mod_len)
    _check_inverses(f, m, [pr.crt_primes[0]])


@pytest.mark.skipif(not jhm.native_available(),
                    reason="the JAX package's native library is not built")
def test_equals_jax_native():
    m = hm.gen_poly_mod(SMALL_M)
    rng = np.random.default_rng(11)
    for _ in range(3):
        args = _batch(_random_f(rng, len(m) - 1), m, SMALL_PRIMES)
        out, ok = hostlib.poly_inv_batch(*args)
        jout, jok = jhm.poly_inv_batch_native(*args)
        np.testing.assert_array_equal(out, jout)
        np.testing.assert_array_equal(ok, jok)


def _root_of_unity(order, p):
    """An element of multiplicative order `order` (a prime) mod p."""
    for g in range(2, p):
        r = pow(g, (p - 1) // order, p)
        if r != 1:
            return r
    raise ValueError("none")


def test_non_invertible_sets_the_flag():
    m = hm.gen_poly_mod(SMALL_M)
    n = len(m) - 1
    p = SMALL_PRIMES[0]
    r = _root_of_unity(SMALL_M, p)
    assert sum(c * pow(r, i, p) for i, c in enumerate(m)) % p == 0
    f = np.zeros(n, dtype=np.int64)
    f[0], f[1] = -r, 1  # x - r divides Phi_127 mod p
    out, ok = hostlib.poly_inv_batch(*_batch(f, m, SMALL_PRIMES))
    assert _numpy_inverse(f, m, p, n) is None
    assert ok[0] != 0 and ok[1] == 0 and ok[2] == 0
    if jhm.native_available():
        _, jok = jhm.poly_inv_batch_native(*_batch(f, m, SMALL_PRIMES))
        np.testing.assert_array_equal(ok != 0, jok != 0)
    # the zero polynomial is invertible modulo no prime
    _, ok = hostlib.poly_inv_batch(*_batch(np.zeros(n, dtype=np.int64), m,
                                           SMALL_PRIMES))
    assert (ok != 0).all()


def test_bad_arguments_raise():
    m = hm.gen_poly_mod(SMALL_M)
    fs, ms, ps = _batch(np.ones(len(m) - 1, dtype=np.int64), m, [7, 11])
    with pytest.raises(ValueError, match="shapes"):
        hostlib.poly_inv_batch(fs, ms[:, :-1], ps)
    with pytest.raises(ValueError, match="primes"):
        hostlib.poly_inv_batch(fs, ms, np.array([7, 1 << 31]))


def test_two_processes_building_at_once_load_one_library(tmp_path):
    code = ("import sys\nfrom pathlib import Path\n"
            "import numpy as np\n"
            "from cuhe_tpu_torch import hostlib\n"
            "hostlib.BUILD_DIR = Path(sys.argv[1])\n"
            "out, ok = hostlib.poly_inv_batch(np.array([[3, 0]]), "
            "np.array([[1, 0, 1]]), np.array([7]))\n"
            "assert ok.tolist() == [0] and out.tolist() == [[5, 0]], out\n"
            "print(hostlib.library_path())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    built = sorted(tmp_path.iterdir())
    assert [str(b) for b in built] == list(paths)  # no temporary left


def test_failed_build_raises_and_keygen_has_no_fallback(monkeypatch,
                                                        tmp_path):
    bad = tmp_path / "xgcd.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(hostlib, "SOURCE", bad)
    monkeypatch.setattr(hostlib, "BUILD_DIR", tmp_path / "build")
    hostlib.lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="xgcd.cpp"):
            hostlib.build()
        with pytest.raises(RuntimeError, match="xgcd.cpp"):
            CuDHS(3, 2, 16, 50, 25, 8191, seed=7, device="cpu")
        monkeypatch.setattr(hostlib.shutil, "which", lambda name: None)
        with pytest.raises(RuntimeError, match="compiler"):
            hostlib.build()
    finally:
        hostlib.lib.cache_clear()
    assert not list((tmp_path / "build").glob("*.so"))
