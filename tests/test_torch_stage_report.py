"""The port's stage report (`arguments/staged.py`: `STAGE_TIMES`,
`stage_report`, the `_stage` wrapper under `MPTPU_STAGE_TIMING`) against the
JAX package's, on the CPU.

- `stage_report()` on synthetic `STAGE_TIMES` gives the JAX package's
  rows in the JAX package's order (the JAX module's dict set for the call
  and restored after; nothing is traced): one dict with keys of every
  shape the flow records, and an empty one, single calls, equal totals and
  a first call that dominates.
- `_timed` keeps [total, calls, first] and opens a "stage <name>" range.
- A (2, 4), B = 1 prove+verify of `test_torch_shuffle.py`'s statement with
  `stage_timing` on records the JAX package's program keys with its call
  counts (`JAX_STAGE_CALLS`, pinned; `chip_smoke.py::stage_calls` gives the
  same at n = 4), and its proof equals the pinned JAX leaves.
- With `stage_timing` off no stage runs its timing wrapper, nothing is
  recorded, and all twenty stage methods carry the wrapper.

The `slow` test recomputes `JAX_STAGE_CALLS` through the JAX package in a
subprocess with `MPTPU_STAGE_TIMING=1` (the JAX package reads the flag when
it first builds a stage program and caches the program, so a process that
built its programs untimed would record nothing).
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

from mental_poker_tpu.arguments import staged as jstaged
from mental_poker_tpu_torch import config
from mental_poker_tpu_torch.arguments import device_api, staged
from mental_poker_tpu_torch.arguments.staged import StagedShuffle

from _torch_bridge import leaves, one_torch_thread  # noqa: F401
from test_torch_shuffle import M, N_COLS, PROOF_SHA256, _port_statement, _rand3, _at, sha256

import chip_smoke  # the card script (the tests' conftest puts the repository on the path)

REPO = str(pathlib.Path(__file__).resolve().parents[1])

# The JAX package's STAGE_TIMES keys and calls after one (2, 4), B = 1
# prove_shuffle + verify_shuffle with MPTPU_STAGE_TIMING=1 (the `slow` test).
JAX_STAGE_CALLS = {
    ("abs_const", "stark", 2, 4, b"hadamard:no-mid", 2): 2, ("abs_me", "stark", 2, 4): 2,
    ("abs_pts", "stark", 2, 4, 1, 0): 2, ("abs_pts", "stark", 2, 4, 2, 1): 2, ("abs_pts", "stark", 2, 4, 2, 2): 2,
    ("abs_pts", "stark", 2, 4, 3, 1): 2, ("abs_pts", "stark", 2, 4, 7, 1): 2, ("coeffs", "stark", 2, 4): 1,
    ("combo", "stark", 2, 4, 2, 1): 1, ("combo", "stark", 2, 4, 2, 4): 2, ("combo", "stark", 2, 4, 4, 8): 1,
    ("combo", "stark", 2, 4, 7, 8): 1, ("commit", "stark", 4, 1): 1, ("commit", "stark", 4, 2): 2,
    ("commit", "stark", 4, 3): 1, ("commit", "stark", 4, 5): 1, ("commit", "stark", 4, 7): 1,
    ("commit", "stark", 4, 9): 1, ("flags", "stark", 2, 4, False): 1, ("had_mids", "stark", 2, 4): 1,
    ("had_prep", "stark", 2, 4): 1, ("make_a", "stark", 2, 4): 1, ("make_b", "stark", 2, 4): 1,
    ("me_open", "stark", 2, 4): 1, ("me_prep", "stark", 2, 4): 1, ("prod_prep", "stark", 2, 4): 1,
    ("stmt", "stark", 2, 4): 2, ("svp_open", "stark", 2, 4): 1, ("svp_prep", "stark", 2, 4): 1,
    ("ver_prep", "stark", 2, 4): 1, ("zero_open", "stark", 2, 4): 1, ("zero_prep", "stark", 2, 4): 1,
}


@pytest.fixture(scope="module")
def statement():
    """`test_torch_shuffle.py`'s statement: (curve, keys, deck, shuffled, pi, rho)."""
    cv, _, _, keys, (deck, shuffled, pi, rho) = _port_statement()
    return cv, keys, deck, shuffled, pi, rho


@pytest.fixture
def clean_stage_times():
    staged.STAGE_TIMES.clear()
    yield staged.STAGE_TIMES
    staged.STAGE_TIMES.clear()


# Synthetic STAGE_TIMES ({key: [total_s, calls, first_s]}) and the stage
# names of the report's rows in order.
REPORT_CASES = {
    "every_key_shape": (
        {("stmt", "stark", 2, 4): [0.9, 3, 0.5], ("commit", "stark", 4, 2): [0.31, 2, 0.3],
         ("abs_const", "stark", 2, 4, b"hadamard:no-mid", 2): [0.4, 5, 0.2],
         ("combo", "stark", 2, 4, 4, 8): [0.25, 1, 0.25], ("flags", "stark", 2, 4, False): [0.05, 2, 0.04],
         ("make_a", "stark", 2, 4): [0.0, 1, 0.0]},
        ["stmt", "combo", "abs_const", "commit", "flags", "make_a"],
    ),
    "empty": ({}, []),
    "single_calls": ({("make_a", "stark", 2, 4): [0.2, 1, 0.2], ("make_b", "stark", 2, 4): [0.7, 1, 0.7]},
                     ["make_b", "make_a"]),
    "equal_totals_keep_order": (
        {("me_prep", "stark", 2, 4): [1.5, 3, 0.5], ("me_open", "stark", 2, 4): [1.0, 2, 0.5],
         ("coeffs", "stark", 2, 4): [0.5, 1, 0.5]},
        ["me_prep", "me_open", "coeffs"],
    ),
    "first_call_dominates": (
        {("commit", "stark", 4, 9): [30.0, 4, 29.7], ("combo", "stark", 2, 4, 2, 4): [0.9, 3, 0.1]},
        ["combo", "commit"],
    ),
}


@pytest.mark.parametrize("times,order", list(REPORT_CASES.values()), ids=list(REPORT_CASES))
def test_stage_report_cases_equal_jax(monkeypatch, clean_stage_times, times, order):
    """The JAX package's rows, values exact, in its order: one call (steady
    = first), ties in steady x calls kept in insertion order, keys of every
    shape the flow records."""
    clean_stage_times.update({k: list(v) for k, v in times.items()})
    monkeypatch.setattr(jstaged, "STAGE_TIMES", {k: list(v) for k, v in times.items()})
    assert staged.stage_report() == jstaged.stage_report()
    assert [r[0][0] for r in staged.stage_report()] == order


def test_timed_records_total_calls_first(clean_stage_times):
    """`_timed` keeps [total_s, calls, first_s] under the key and runs the
    call inside a "stage <name>" `record_function` range."""
    from torch.profiler import ProfilerActivity, profile

    class Stage:
        def run(self, x):
            return x + 1

    key = ("abs_me", "stark", 2, 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = [staged._timed(key, Stage.run, Stage(), (i,)) for i in range(3)]
    assert outs == [1, 2, 3]
    total, calls, first = clean_stage_times[key]
    assert calls == 3 and 0 < first <= total
    assert [e.name for e in prof.events() if e.name.startswith("stage ")] == ["stage abs_me"] * 3


def test_stage_calls_of_the_card_script_are_jax():
    assert chip_smoke.stage_calls("stark", 4) == JAX_STAGE_CALLS
    assert sorted({k[0] for k in JAX_STAGE_CALLS}) == sorted(chip_smoke.STAGE_NAMES)


def test_timed_flow_has_jax_keys_and_proof(statement, clean_stage_times):
    cv, keys, deck, shuffled, pi, rho = statement
    rand = _at(_rand3(cv.host.order, cv.fr.L), 0)
    with config.override(stage_timing=True):
        proof = device_api.prove_shuffle(cv, M, N_COLS, keys, deck, shuffled, pi, rho, rand)
        checks = device_api.verify_shuffle(cv, M, N_COLS, keys, deck, shuffled, proof)
    assert all(bool(c.all()) for c in checks)
    assert sha256(leaves(proof)) == PROOF_SHA256[0]
    assert {k: calls for k, (_, calls, _) in clean_stage_times.items()} == JAX_STAGE_CALLS
    rows = staged.stage_report()
    assert len(rows) == len(JAX_STAGE_CALLS) and all(ms >= 0 and first >= 0 for _, ms, _, first in rows)


def test_timing_off_runs_no_wrapper(monkeypatch, statement, clean_stage_times):
    """Off, each stage calls its method alone: `_timed` (the clock and the
    synchronize) is never reached and nothing is recorded."""
    names = sorted(chip_smoke.STAGE_NAMES)
    assert all(hasattr(getattr(StagedShuffle, name), "__wrapped__") for name in names)

    def refuse(*args):
        raise AssertionError("a stage was timed with stage_timing off")

    monkeypatch.setattr(staged, "_timed", refuse)
    cv, keys, deck, shuffled, pi, _ = statement
    rand = _at(_rand3(cv.host.order, cv.fr.L), 0)
    ss = StagedShuffle(cv, M, N_COLS)
    with config.override(stage_timing=False):
        st = ss.stmt(keys, deck, shuffled)
        ss.abs_const(st, b"test", 1)
        ss.commit(keys, ss.make_a(pi), rand.r)
    assert clean_stage_times == {}
    with config.override(stage_timing=True), pytest.raises(AssertionError, match="timed"):
        ss.make_a(pi)


_JAX_KEYS = r'''
import os, sys
sys.path.insert(0, os.environ["REPO"])
sys.path.insert(0, os.path.join(os.environ["REPO"], "tests"))
import conftest  # the tests' JAX set-up: CPU platform, XLA flags, compile cache
import numpy as np
from mental_poker_tpu.arguments import device_api, staged
from mental_poker_tpu.crypto import elgamal
from mental_poker_tpu.crypto.elgamal import Ciphertexts
from mental_poker_tpu.ops.curve import PointP
from mental_poker_tpu.protocol.dl_cards import DLCards
from mental_poker_tpu.utils.rand import GameRng, ints_to_limbs
m, n = 2, 4
N = m * n
proto = DLCards()
rng = GameRng(1234)
pp = proto.setup(rng, m, n)
pk, sk = proto.player_keygen(rng, pp)
agg = proto.compute_aggregate_key(pp, [(pk, proto.prove_key_ownership(rng, pp, pk, sk, b"s"), b"s")])
cv, q = proto.cv, proto.cv.host.order
flat = elgamal.rand_ciphertexts(cv, rng, N)
deck = Ciphertexts(*(PointP(*(c.reshape(1, N, -1) for c in P)) for P in flat))
pi = rng.permutation(N).astype(np.int32)[None]
rho = ints_to_limbs([[rng.scalar(q) for _ in range(N)]], cv.fr.L)
permuted = Ciphertexts(*(PointP(*(np.asarray(c)[:, pi[0]] for c in P)) for P in deck))
out = elgamal.cipher_add(cv, permuted, elgamal.encrypt_zero(pp.enc, agg.table, rho))
rand = device_api.sample_shuffle_rand(rng, m, n, cv.fr.L, q, batch=1)
keys = device_api.make_keys(pp, agg)
staged.STAGE_TIMES.clear()
proof = device_api.prove_shuffle(cv, m, n, keys, deck, out, pi, rho, rand)
checks = device_api.verify_shuffle(cv, m, n, keys, deck, out, proof)
assert all(bool(np.asarray(c).all()) for c in checks)
print(repr({k: calls for k, (_, calls, _) in staged.STAGE_TIMES.items()}))
'''


@pytest.mark.slow
def test_jax_stage_calls_recomputed():
    """The JAX package's (2, 4), B = 1 prove+verify with MPTPU_STAGE_TIMING=1
    in a fresh process (about ten minutes: it traces the B = 1 programs)."""
    env = dict(os.environ, REPO=REPO, MPTPU_STAGE_TIMING="1", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _JAX_KEYS], env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=3000, check=True)
    assert ast.literal_eval(out.stdout.strip().splitlines()[-1]) == JAX_STAGE_CALLS
