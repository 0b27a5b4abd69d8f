"""Homomorphic PRINCE known-answer run (the reference's
examples/Prince/test_Prince.cu), on the port.

    python3 -m cuhe_tpu_torch.run_prince [--rounds N] [--seed S]
        [--check-rounds] [--checkpoint-dir DIR] [--resume FILE.npz]
        [--device cuda|cpu]

Message A = all zeros, key0 = all ones, key1 = all zeros; the decrypted
64-bit ciphertext must equal the published trace (Prince.cu:96), and the
states after S-box layers 1-4 the per-round vectors (Prince.cu:108-147).
--rounds N stops after N S-box layers.  --checkpoint-dir saves the state
after every S-box layer (``utils/checkpoint.py``, the JAX package's .npz
format); --resume continues from such a file, with the keys of the same
seed.  The counterpart of ``examples/run_prince.py``, with the same flags
and --device; it runs on the card unless asked for the CPU, and exits
non-zero on a mismatch.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .context import resolve_device
from .models.prince import Prince
from .utils import checkpoint as ckpt
from .utils.timer import OTimer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m cuhe_tpu_torch.run_prince")
    ap.add_argument("--rounds", type=int, default=None,
                    help="stop after N S-box layers (default: full 12)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--check-rounds", action="store_true",
                    help="decrypt and print the state after every S-box layer")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save the state after every S-box layer to DIR")
    ap.add_argument("--resume", default=None,
                    help="resume from a layer checkpoint .npz (see "
                         "--checkpoint-dir); fast-forwards the circuit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    # the driver opts in to the library's per-layer timing, as the JAX
    # package's does
    os.environ.setdefault("CUHE_PRINCE_TIMING", "1")

    dev = resolve_device(args.device)

    print("---------- Precomputation ----------", flush=True)
    t = OTimer(dev)
    t.start()
    p = Prince(seed=args.seed, device=dev)
    t.stop()
    t.show("heSetup")

    bad = []

    def check(rd, state, lvl):
        exp = Prince.EXPECTED_ROUNDS.get(rd)
        if not (args.check_rounds or exp is not None):
            print(f"Round {rd} done (level {lvl})", flush=True)
            return
        s = "".join(str(b) for b in p.decrypt_state(state, lvl))
        print(f"Round {rd}: {s}", flush=True)
        if exp is not None:
            print("   expected:", exp, "OK" if s == exp else "MISMATCH",
                  flush=True)
            if s != exp:
                bad.append(rd)

    on_layer = None
    if args.checkpoint_dir:
        os.makedirs(args.checkpoint_dir, exist_ok=True)

        def on_layer(done, state, lvl):
            path = os.path.join(args.checkpoint_dir, f"layer{done:02d}.npz")
            ckpt.save_state(path, state, lvl, done=done)
            print(f"checkpointed layer {done} (level {lvl}) -> {path}",
                  flush=True)

    resume = None
    if args.resume:
        state0, lvl0 = ckpt.load_state(args.resume, device=dev)
        done0 = int(np.load(args.resume)["done"])
        resume = (state0, lvl0, done0)
        print(f"resuming after S-box layer {done0} (level {lvl0})",
              flush=True)

    print("---------- PRINCE ENC ----------", flush=True)
    t = OTimer(dev)
    t.start()
    state = p.encrypt_blocks([0] * 64, [1] * 64, [0] * 64,
                             max_rounds=args.rounds, check=check,
                             resume=resume, on_layer=on_layer)
    t.stop()
    t.show("Prince Encryption")

    if args.rounds is None:
        print("---------- PRINCE DEC ----------", flush=True)
        s = "".join(str(b) for b in p.decrypt_state(state, p.level))
        print(s)
        print(Prince.EXPECTED_FINAL)
        ok = s == Prince.EXPECTED_FINAL
        print("FINAL:", "OK" if ok else "MISMATCH", flush=True)
        if not ok:
            bad.append("final")
    if bad:
        print(f"known-answer mismatch at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
