"""Ciphertext / key-bundle checkpointing.

Counterpart of ``cuhe_tpu/utils/checkpoint.py``, in the same ``.npz`` format,
so a checkpoint written by either package loads in the other.  The
reference can only serialize keys (Picklable strings, DHS.cu:57-189); here
any Ctxt (or batched device state) checkpoints to an .npz with its level and
domain, so long circuit evaluations can resume across restarts.

NTT-domain data is stored in mat-linear order, whose meaning depends on the
NTT factorization (``ops/ntt.py::FACTORS``).  Every .npz records the format
version and the factorization of each NTT-domain array, and load refuses a
mismatch instead of decrypting to garbage.
"""

from __future__ import annotations

import numpy as np
import torch

from ..context import resolve_device
from ..ops import ntt
from ..poly import NTT, ZZX, Ctxt

FORMAT_VERSION = 2


def _fact_tag(n: int) -> np.ndarray:
    """This build's (n1, n2) factorization for NTT length n, as int64."""
    return np.asarray(ntt.factors(n), dtype=np.int64)


def _check_fact(z, path: str, n: int) -> None:
    if "format_version" not in z.files:
        raise ValueError(
            f"{path}: unversioned checkpoint holding NTT-domain data; the "
            f"mat-linear layout it was written with is unknown.")
    if "ntt_factorization" not in z.files:
        raise ValueError(
            f"{path}: checkpoint was saved without an NTT factorization tag "
            f"(save_state without ntt_len?) but is being loaded as "
            f"NTT-domain data for n={n}; re-save it with ntt_len set.")
    stored = tuple(int(v) for v in z["ntt_factorization"])
    cur = tuple(int(v) for v in _fact_tag(n))
    if stored != cur:
        raise ValueError(
            f"{path}: checkpoint uses NTT factorization {stored} for "
            f"n={n} but this build uses {cur}; loading would scramble "
            f"the mat-linear layout.")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dev(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def save_ctxt(path: str, ct: Ctxt) -> None:
    if ct.domain == ZZX:
        raise ValueError("host-domain ciphertexts: use the key-bundle text format")
    if ct.domain == NTT:
        lo = _host(ct.data[0])
        np.savez_compressed(path, level=ct.level, domain=ct.domain,
                            is_prod=ct.is_prod,
                            format_version=FORMAT_VERSION,
                            ntt_factorization=_fact_tag(lo.shape[-1]),
                            lo=lo, hi=_host(ct.data[1]))
    else:
        np.savez_compressed(path, level=ct.level, domain=ct.domain,
                            is_prod=ct.is_prod,
                            format_version=FORMAT_VERSION,
                            data=_host(ct.data))


def load_ctxt(path: str, device="cuda") -> Ctxt:
    """The ciphertext at `path`, its data on `device`."""
    dev = resolve_device(device)
    z = np.load(path)
    domain = str(z["domain"])
    if domain == NTT:
        _check_fact(z, path, int(z["lo"].shape[-1]))
        data = (_dev(z["lo"], dev), _dev(z["hi"], dev))
    else:
        data = _dev(z["data"], dev)
    return Ctxt(level=int(z["level"]), domain=domain, data=data,
                is_prod=bool(z["is_prod"]))


def save_state(path: str, state, level: int, *, ntt_len: int | None = None,
               **extra) -> None:
    """Checkpoint a batched device state (e.g. PRINCE's [64, pnum, n]).

    Pass ntt_len when `state` holds NTT-domain (mat-linear) data so the
    factorization is recorded and validated on load.
    """
    tags = {}
    if ntt_len is not None:
        tags["ntt_factorization"] = _fact_tag(ntt_len)
    np.savez_compressed(path, state=_host(state), level=level,
                        format_version=FORMAT_VERSION, **tags, **extra)


def load_state(path: str, *, ntt_len: int | None = None, device="cuda"):
    """(state on `device`, level) of the checkpoint at `path`."""
    dev = resolve_device(device)
    z = np.load(path)
    if ntt_len is not None:
        _check_fact(z, path, ntt_len)
    return _dev(z["state"], dev), int(z["level"])
