"""Full game round (L5): the reference's `examples/round.rs` flow, batch-first
(counterpart of `mental_poker_tpu/models/round.py`; the same seed plays the
same game in both packages).

    python -m mental_poker_tpu_torch.models.round              # on the card
    python -m mental_poker_tpu_torch.models.round --device cpu

Reproduces the canonical end-to-end integration flow (SURVEY §3.5,
`examples/round.rs:228-436`): setup -> encode 52 cards -> 4 players keygen with
Schnorr ownership proofs -> aggregate key -> mask the open deck (fixed r = 1,
as `round.rs:253-256`) -> 4 sequential shuffle+verify rounds -> deal -> private
peeks via reveal tokens -> full public reveal.

Where the reference loops card-by-card and player-by-player
(`round.rs:360-428`), this layer issues *batched* calls: the whole deck is
masked in one call, each player's reveal tokens for all in-play cards are one
batched Chaum-Pedersen prove, and `unmask` verifies all players' token proofs
as batched sigma checks.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..crypto.elgamal import Ciphertexts
from ..crypto.group import host_points
from ..crypto.sigma import ChaumPedersenProof
from ..ops.curve import PointP, map_point
from ..protocol.dl_cards import DLCards, Parameters
from ..utils.rand import GameRng

SUITES = ["Club", "Diamond", "Heart", "Spade"]
VALUES = [
    "Two", "Three", "Four", "Five", "Six", "Seven", "Eight", "Nine", "Ten",
    "Jack", "Queen", "King", "Ace",
]
_SUITE_SYM = {"Club": "♣", "Diamond": "♦", "Heart": "♥", "Spade": "♠"}
_VALUE_SYM = {
    "Two": "2", "Three": "3", "Four": "4", "Five": "5", "Six": "6",
    "Seven": "7", "Eight": "8", "Nine": "9", "Ten": "10", "Jack": "J",
    "Queen": "Q", "King": "K", "Ace": "A",
}


@dataclasses.dataclass(frozen=True)
class ClassicPlayingCard:
    """`ClassicPlayingCard` (`round.rs:88-127`)."""

    value: str
    suite: str

    def __repr__(self) -> str:
        return f"{_VALUE_SYM[self.value]}{_SUITE_SYM[self.suite]}"


class CardNotFound(Exception):
    """`GameErrors::CardNotFound` (`round.rs:34-36`)."""


class InvalidCard(Exception):
    """`GameErrors::InvalidCard` (`round.rs:37-39`)."""


# ----------------------------------------------------------------- helpers
def point_take(P: PointP, idx) -> PointP:
    """Select entries `idx` (int or list) of a batched point, as a [k] batch;
    the index is a `torch.long` tensor on the point's device."""
    ix = torch.as_tensor(np.atleast_1d(np.asarray(idx, dtype=np.int64)), device=P.x.device)
    return map_point(lambda q: q[ix], P)


def cipher_take(cts: Ciphertexts, idx) -> Ciphertexts:
    """Select cards `idx` (int or list) from a batched deck."""
    return Ciphertexts(point_take(cts.c0, idx), point_take(cts.c1, idx))


def encode_cards(proto: DLCards, rng: GameRng, num_of_cards: int) -> dict:
    """Random plaintexts -> card map (`round.rs:210-226`); value-major order.

    Keys are host point triples (x, y, inf) — canonical and hashable, the
    role of `Card: Hash + Eq` in the reference (`lib.rs:56-58`).
    """
    pts = [proto.cv.host.rand_point(rng.rng) for _ in range(num_of_cards)]
    mapping = {}
    i = 0
    for value in VALUES:
        for suite in SUITES:
            if i >= num_of_cards:
                return mapping
            mapping[pts[i]] = ClassicPlayingCard(value, suite)
            i += 1
    return mapping


def open_card(proto: DLCards, pp: Parameters, reveal_tokens, card_mapping, card: Ciphertexts):
    """`open_card` (`round.rs:197-208`): unmask with all tokens, look up."""
    plain = proto.unmask(pp, reveal_tokens, card)
    key = proto.cv.to_host_points(plain)[0]
    try:
        return card_mapping[key]
    except KeyError:
        raise InvalidCard()


class Player:
    """`Player` (`round.rs:130-194`)."""

    def __init__(self, proto: DLCards, rng: GameRng, pp: Parameters, name: bytes):
        self.proto = proto
        self.name = bytes(name)
        pk, sk = proto.player_keygen(rng, pp)
        self.pk = pk
        self.sk = sk
        self.proof_key = proto.prove_key_ownership(rng, pp, pk, sk, self.name)
        self.cards: list[tuple] = []  # host-keyed masked cards (c0, c1 host pts)
        self.card_ciphers: list[Ciphertexts] = []
        self.opened_cards: list = []

    def key_proof_info(self):
        return (self.pk, self.proof_key, self.name)

    def receive_card(self, card: Ciphertexts, card_key) -> None:
        self.cards.append(card_key)
        self.card_ciphers.append(card)
        self.opened_cards.append(None)

    def compute_reveal_token(self, rng: GameRng, pp: Parameters, cards: Ciphertexts):
        """Batched over however many cards are passed (`round.rs:183-194`)."""
        token, proof = self.proto.compute_reveal_token(rng, pp, self.sk, self.pk, cards)
        return (token, proof, self.pk)

    def peek_at_card(self, rng, pp, reveal_tokens, card_mapping, card: Ciphertexts, card_key):
        """`round.rs:159-181`: add own token, unmask, record the value."""
        try:
            i = self.cards.index(card_key)
        except ValueError:
            raise CardNotFound()
        own = self.compute_reveal_token(rng, pp, card)
        tokens = list(reveal_tokens) + [own]
        opened = open_card(self.proto, pp, tokens, card_mapping, card)
        self.opened_cards[i] = opened
        return opened


def cipher_keys(proto: DLCards, deck: Ciphertexts) -> list:
    """Host-canonical hashable keys for each masked card in a deck."""
    return list(zip(*host_points(proto.cv, deck.c0, deck.c1)))


def play_round(
    seed: int = 0,
    m: int = 2,
    n: int = 26,
    player_names=(b"Andrija", b"Kobi", b"Nico", b"Tom"),
    num_shuffles: int | None = None,
    curve=None,
    verbose: bool = False,
    device="cuda",
) -> dict:
    """The complete `round.rs` main flow (`round.rs:228-436`) on `device`.

    Returns {player_name: ClassicPlayingCard} of the publicly opened cards,
    raising if a private peek disagrees with the public open.
    """
    proto = DLCards(curve, device=device)
    rng = GameRng(seed)
    num_cards = m * n
    pp = proto.setup(rng, m, n)
    card_mapping = encode_cards(proto, rng, num_cards)
    plain_keys = list(card_mapping.keys())

    players = [Player(proto, rng, pp, name) for name in player_names]
    joint_pk = proto.compute_aggregate_key(pp, [p.key_proof_info() for p in players])

    # Mask the open deck with fixed r = 1, as the reference does
    # (`round.rs:253-256`), in ONE batched call.
    cards_dev = proto.cv.from_host_points(plain_keys, proto.device)
    deck, mask_proof = proto.mask(rng, pp, joint_pk, cards_dev, [1] * num_cards)
    proto.verify_mask(pp, joint_pk, cards_dev, deck, mask_proof)

    # Sequential shuffles, each verified by "everyone" (`round.rs:263-350`).
    shufflers = players if num_shuffles is None else players[:num_shuffles]
    for p in shufflers:
        pi = rng.permutation(num_cards)
        rho = [rng.scalar(proto.cv.host.order) for _ in range(num_cards)]
        new_deck, proof = proto.shuffle_and_remask(rng, pp, joint_pk, deck, rho, pi)
        proto.verify_shuffle(pp, joint_pk, deck, new_deck, proof)
        deck = new_deck
        if verbose:
            print(f"{p.name.decode()} shuffled; proof verified by all")

    # Deal card i to player i (`round.rs:355-358`).
    np_players = len(players)
    keys = cipher_keys(proto, cipher_take(deck, list(range(np_players))))
    for i, p in enumerate(players):
        p.receive_card(cipher_take(deck, i), keys[i])

    # Private peeks: every OTHER player sends a batched token for card i
    # (`round.rs:360-385`), then player i adds their own and unmasks.
    for i, p in enumerate(players):
        card = cipher_take(deck, i)
        tokens = [
            q.compute_reveal_token(rng, pp, card) for q in players if q is not p
        ]
        p.peek_at_card(rng, pp, tokens, card_mapping, card, keys[i])

    # Public reveal: all players issue tokens for ALL dealt cards in one
    # batched call each (`round.rs:396-428`).
    dealt = cipher_take(deck, list(range(np_players)))
    all_tokens = [p.compute_reveal_token(rng, pp, dealt) for p in players]
    opened = {}
    for i, p in enumerate(players):
        per_card = [
            (point_take(tok, i), _proof_take(proof, i), pk)
            for tok, proof, pk in all_tokens
        ]
        card = open_card(proto, pp, per_card, card_mapping, cipher_take(deck, i))
        if card != p.opened_cards[0]:
            raise AssertionError("public open disagrees with private peek")
        opened[p.name.decode()] = card
        if verbose:
            print(f"{p.name.decode()}: {card!r}")
    return opened


def _proof_take(proof, i: int):
    """Select statement i from a batched Chaum-Pedersen proof."""
    return ChaumPedersenProof([proof.t_g[i]], [proof.t_h[i]], [proof.response[i]], (1,))


def main() -> None:
    ap = argparse.ArgumentParser(description="Play one round of the reference's round.rs flow.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    play_round(seed=args.seed, verbose=True, device=args.device)


if __name__ == "__main__":
    main()
