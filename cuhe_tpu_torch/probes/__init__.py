"""Measurement probes of the card: the port's counterpart of the TPU probes
``scripts/tpu_probe_calib.py`` (P1, P2), ``scripts/tpu_probe_inv_ablate.py``
(P3) and ``scripts/tpu_probe_fwd32_ablate.py`` (P4).

    python3 -m cuhe_tpu_torch.probes

runs them all on the card (``suite.py``) and prints one line per
measurement with the card's name and power limit; it raises without a card.
``calib.py`` holds the rate probes (tensor-core dots, 32-bit add / xor /
shift, integer multiplies, the SM clock), ``ablate.py`` the NTT kernels pass
by pass, ``timing.py`` the timer and the bound model.  The kernel front ends
run their plain versions for CPU tensors, as the tests use them; every
measurement needs the card.
"""
