"""ntt_roofline: the byte bound of the gate step's NTTs over their device
time: B1 (forward, 4 a step), B2 (inverse with mod p, 6) and B6 (the
relinearization digits' forward NTTs, 1), each input read once and each
output written once at 3.35 TB/s."""

from benchmark.core.readers import device_s_per_call, roofline_pct

NTT_KERNELS = r"\b(fwd_cols|inv_cols|ntt_rows)\b"


def fwd_bytes(batch, pn, n):
    """B1: u32 coefficients [batch, pn, n/2] in, a u64 pair [.., n] out."""
    return batch * pn * (n // 2 * 4 + n * 8)


def inv_bytes(batch, pn, n):
    """B2: a u64 pair [batch, pn, n] in, u32 residues [.., n] out."""
    return batch * pn * n * 12


def digits_bytes(batch, n, words, knum, w):
    """B6: the RAW words the digits span in, knum u64 transforms out."""
    span = min(words, (w * knum - 1) // 32 + 2)
    return batch * span * (n // 2) * 4 + knum * batch * n * 8


def step_bytes(s):
    return (4 * fwd_bytes(s["batch"], s["pn"], s["n"])
            + 6 * inv_bytes(s["batch"], s["pn"], s["n"])
            + digits_bytes(s["batch"], s["n"], s["words"], s["knum"],
                           s["w"]))


def read(run):
    t = device_s_per_call(run, NTT_KERNELS)
    return roofline_pct(step_bytes(run.shapes), t) if t else None
