"""Game parameters carried into the port: the counterpart of weights.

The shuffle argument needs five kinds of fixed bases (ElGamal generator,
aggregate public key, the n Pedersen generators and blinding generator, the
extra shuffle generator G'). They are host points; the port turns them into
its own window tables (`device_api.keys_from_points`).

- `keys_from_jax` reads those host values from the JAX package's
  `Parameters` / `AggregateKey` objects (Python ints only, no JAX call), so
  both packages prove against the same statement; `protocol_from_jax` builds
  the port's own `Parameters` / `AggregateKey` from the same host points, so
  both packages run the protocol against the same keys.
- `setup` draws them from a port `GameRng` in the order of
  `mental_poker_tpu/protocol/dl_cards.py::DLCards.setup` (ElGamal
  generator, n + 1 Pedersen points, shuffle generator), then one player's
  key; the aggregate key is the host sum of the players' keys. Key-ownership
  proofs belong to the protocol layer and are not drawn here.
"""

from __future__ import annotations

from typing import NamedTuple

from .arguments.device import ShuffleKeys
from .arguments.device_api import keys_from_points
from .crypto.elgamal import ElGamalParams
from .crypto.pedersen import CommitKey
from .ops import curve as curve_mod
from .ops.curve import Curve
from .ops.msm import FixedBaseTable
from .protocol.dl_cards import AggregateKey, Parameters
from .utils.rand import GameRng

_CURVES = {"stark": curve_mod.stark_curve, "bls12_377_g1": curve_mod.bls12_377_g1}


class GameSetup(NamedTuple):
    cv: Curve
    m: int
    n: int
    generator: tuple
    commit_g: list
    commit_h: tuple
    shuffle_generator: tuple
    sk: int
    pk: tuple
    agg: tuple
    keys: ShuffleKeys
    enc: ElGamalParams  # generator table, shared with `keys.gen`
    agg_table: FixedBaseTable  # aggregate-key table, shared with `keys.pk`


def keys_from_jax(pp, agg, c: int = 4, device="cuda") -> ShuffleKeys:
    """The port's window tables for a JAX `Parameters` and `AggregateKey`
    (duck-typed: only their host points are read)."""
    cv = _CURVES[pp.cv.host.name]()
    return keys_from_points(
        cv,
        pp.enc.generator,
        agg.host,
        list(pp.commit_key.g_hosts),
        pp.commit_key.h_host,
        pp.shuffle_generator,
        c,
        device,
    )


def protocol_from_jax(pp, agg, c: int = 4, device="cuda"):
    """The port's (`Parameters`, `AggregateKey`) with the host points of a
    JAX `Parameters` and `AggregateKey` (duck-typed: only their host points
    are read), with c-bit tables on `device`."""
    cv = _CURVES[pp.cv.host.name]()
    enc = ElGamalParams(cv, pp.enc.generator, c, device)
    ck = CommitKey(cv, list(pp.commit_key.g_hosts), pp.commit_key.h_host, c, device)
    params = Parameters(cv, pp.m, pp.n, enc, ck, pp.shuffle_generator, c, device)
    return params, AggregateKey(agg.host, FixedBaseTable(cv, agg.host, c, device))


def setup(rng: GameRng, m: int, n: int, c: int = 4, device="cuda") -> GameSetup:
    """Parameters on the Stark curve, one player's key pair and the
    aggregate key, drawn from `rng`, with their window tables (c-bit
    fixed-base windows) on `device`."""
    cv = curve_mod.stark_curve()
    host = cv.host
    generator = host.rand_point(rng.rng)
    ck = [host.rand_point(rng.rng) for _ in range(n + 1)]
    shuffle_generator = host.rand_point(rng.rng)
    sk = rng.scalar(host.order)
    pk = host.mul(sk, generator)
    agg = host.add(host.identity, pk)
    keys = keys_from_points(cv, generator, agg, ck[:-1], ck[-1], shuffle_generator, c, device)
    enc = ElGamalParams(cv, generator, c, device, table=keys.gen)
    agg_table = FixedBaseTable(cv, agg, c, device, table=keys.pk)
    return GameSetup(cv, m, n, generator, ck[:-1], ck[-1], shuffle_generator, sk, pk, agg, keys, enc, agg_table)
