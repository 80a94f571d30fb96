"""The control and the planted faults, each a context manager that breaks the
timed path underneath a run; `correct` has to come out false under each.

    python3 -m pokerbench.faults --workload <cell> --seed <n> --seconds <s> --fault <name>

runs one cell on the card with the fault in place and prints the result
line. The benchmark's own runs never import this module.

Shuffle cells (`device_api`):
- `control`: the prover is handed a wrong witness, remask factor 0 of every
  deck off by one, so that it proves a shuffle the output deck is not (the
  configuration's guarantee that such a shuffle is rejected);
- `half_batch`: the prover proves the first half of the batch and returns
  those proofs again for the second half;
- `altered`: one response of every proof (the multi-exponentiation's tau)
  altered where it is produced.

Game cells (`sigma_device`):
- `control`: each Chaum-Pedersen response made with the witness off by one
  (the guarantee that every proof verifies);
- `half_batch`: the verifier checks the first half of each batch and
  reports the second half as verified;
- `altered`: the first response of every proof batch altered where it is
  produced.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch


def _bump(limbs: torch.Tensor) -> torch.Tensor:
    """Canonical limbs with the lowest bit flipped (k +- 1)."""
    out = limbs.clone()
    out[..., 0] ^= 1
    return out


@contextlib.contextmanager
def _patch(module, name, wrap):
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _half(t: torch.Tensor) -> torch.Tensor:
    h = -(-t.shape[0] // 2)
    return torch.cat([t[:h], t[: t.shape[0] - h]])


def shuffle_fault(name: str):
    from mental_poker_tpu_torch.arguments import device_api
    from mental_poker_tpu_torch.arguments.device import tree_map

    if name == "control":
        def wrap(prove):
            def bad(cv, m, n, keys, deck_in, deck_out, pi, rho_c, rand):
                rho = rho_c.clone()
                rho[:, 0] = _bump(rho[:, 0])
                return prove(cv, m, n, keys, deck_in, deck_out, pi, rho, rand)
            return bad
    elif name == "half_batch":
        def wrap(prove):
            def bad(cv, m, n, keys, deck_in, deck_out, pi, rho_c, rand):
                return tree_map(_half, prove(cv, m, n, keys, deck_in, deck_out, pi, rho_c, rand))
            return bad
    elif name == "altered":
        def wrap(prove):
            def bad(*args):
                p = prove(*args)
                return p._replace(multi_exp=p.multi_exp._replace(tau=_bump(p.multi_exp.tau)))
            return bad
    else:
        raise ValueError(name)
    return _patch(device_api, "prove_shuffle", wrap)


def game_fault(name: str):
    from mental_poker_tpu_torch.crypto import sigma_device as sdev

    if name == "control":
        def wrap(prove):
            def bad(cv, st, g, h, a, b, w_c, k_c):
                return prove(cv, st, g, h, a, b, _bump(w_c), k_c)
            return bad
        return _patch(sdev, "cp_prove_dev", wrap)
    if name == "half_batch":
        def wrap(verify):
            def bad(*args):
                ok = verify(*args).clone()
                h = ok.shape[0] // 2
                if h:
                    ok[-h:] = True
                return ok
            return bad
        return _patch(sdev, "cp_verify_dev", wrap)
    if name == "altered":
        def wrap(prove):
            def bad(cv, st, g, h, a, b, w_c, k_c):
                p = prove(cv, st, g, h, a, b, w_c, k_c)
                s = p.s.clone()
                s[0] = _bump(s[0])
                return p._replace(s=s)
            return bad
        return _patch(sdev, "cp_prove_dev", wrap)
    raise ValueError(name)


FAULTS = ("control", "half_batch", "altered")


def planted(driver: str, name: str):
    return shuffle_fault(name) if driver == "shuffle" else game_fault(name)


def main(argv=None) -> int:
    from . import run as run_mod

    ap = argparse.ArgumentParser(description="one run of a cell with a planted fault")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", required=True, choices=FAULTS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pokerbench.faults: no CUDA card", file=sys.stderr)
        return 2
    _, _, traffic = run_mod.cell(run_mod.manifest(), args.workload)
    with planted(traffic["driver"], args.fault):
        out = run_mod.run_cell(args.workload, args.seed, args.seconds, False)
    print(json.dumps({"fault": args.fault, "correct": out["correct"], "checks": out["checks"],
                      "metrics": out["metrics"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
