"""relin_roofline: the byte bound of the eval-key multiply-accumulate over
the device time of csrc/relin.cu's kernels in a step: knum digit transforms
of the batch and knum key planes of pn primes read once, the pn-plane
result written once, u64 words at 3.35 TB/s, whatever kernel does it."""

from benchmark.core.readers import device_s_per_call, roofline_pct

RELIN_KERNELS = r"relin"


def mulacc_bytes(batch, pn, n, knum):
    return (knum * batch + knum * pn + batch * pn) * n * 8


def read(run):
    t = device_s_per_call(run, RELIN_KERNELS)
    if not t:
        return None
    s = run.shapes
    return roofline_pct(mulacc_bytes(s["batch"], s["pn"], s["n"], s["knum"]),
                        t)
