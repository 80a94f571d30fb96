"""Discrete-log Barnett-Smart card protocol, batch-first (counterpart of
`mental_poker_tpu/protocol/dl_cards.py`).

Implements the reference's `BarnettSmartProtocol` trait surface, all 14
methods of `src/lib.rs:41-198` as instantiated by
`src/discrete_log_cards/mod.rs:86-444`, over batched tensors on one device:

  setup, player_keygen, prove/verify_key_ownership, compute_aggregate_key,
  mask, verify_mask, remask, verify_remask, compute_reveal_token,
  verify_reveal, unmask, shuffle_and_remask, verify_shuffle.

Type mapping (reference `mod.rs:63-103`):
  Card        = ElGamal plaintext  -> PointP batch
  MaskedCard  = ElGamal ciphertext -> Ciphertexts batch
  RevealToken = ElGamal plaintext  -> PointP batch
  ZKProofKeyOwnership = Schnorr;  Masking/Remasking/Reveal = Chaum-Pedersen;
  Shuffle = Bayer-Groth shuffle argument (the staged device prover, with a
  host `ShuffleProof` at the API by default).

Every method is batched: the reference's single-card call is the batch-1
case. Transcript seeds match `mod.rs:80-84`, and every random draw comes from
the caller's `GameRng` in the JAX package's order, so one seed gives the same
game in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..arguments import device_api
from ..arguments.device import ShuffleProofDev
from ..config import window_bits
from ..crypto import elgamal, sigma
from ..crypto.elgamal import Ciphertexts
from ..crypto.errors import CardProtocolError, CryptoError
from ..crypto.group import scalars_to_limbs
from ..crypto.transcript import (
    KEY_OWN_RNG_SEED,
    MASKING_RNG_SEED,
    REMASKING_RNG_SEED,
    REVEAL_RNG_SEED,
    TranscriptBatch,
)
from ..ops import curve as curve_mod
from ..ops.curve import PointP, cat_points, map_point
from ..ops.msm import FixedBaseTable
from ..utils.rand import GameRng
from . import api


@dataclasses.dataclass
class AggregateKey:
    """Aggregate ElGamal public key with its fixed-base table."""

    host: tuple
    table: FixedBaseTable


class Parameters:
    """Protocol parameters (`mod.rs:37-61`): the (m, n) deck split, ElGamal
    parameters, Pedersen commit key and the extra shuffle generator G', with
    c-bit window tables on `device` (G''s built at first use)."""

    def __init__(self, cv, m, n, enc, commit_key, shuffle_generator, c: int = 4, device="cuda"):
        self.cv = cv
        self.m = m
        self.n = n
        self.enc = enc
        self.commit_key = commit_key
        self.shuffle_generator = shuffle_generator
        self.c = c
        self.device = torch.device(device)
        self._shuffle_table = None

    @property
    def num_cards(self):
        return self.m * self.n

    @property
    def shuffle_table(self) -> FixedBaseTable:
        if self._shuffle_table is None:
            self._shuffle_table = FixedBaseTable(self.cv, self.shuffle_generator, self.c, self.device)
        return self._shuffle_table


def _num(shape) -> int:
    return int(np.prod(shape)) if shape else 1


class DLCards(api.BarnettSmartProtocol, api.Mask, api.Remask, api.Reveal):
    """The discrete-log instantiation (`DLCards<C>`, `mod.rs:33-35`) of the
    abstract `BarnettSmartProtocol` trait (protocol/api.py).

    Associated-type bindings (`mod.rs:87-103`): Enc = ElGamalScheme,
    Comm = PedersenScheme. `c` is the fixed-base window width of every
    table (None: `config.get_config().fixed_window_bits`, as the JAX
    package's `default_fixed_window`); every tensor lives on `device`."""

    def __init__(self, cv=None, enc_scheme=None, comm_scheme=None, c: int | None = None, device="cuda"):
        self.cv = cv or curve_mod.stark_curve()
        self.c = c = window_bits(c)
        self.device = torch.device(device)
        self.enc_scheme = enc_scheme or api.ElGamalScheme(c, self.device)
        self.comm_scheme = comm_scheme or api.PedersenScheme(c, self.device)

    def _limbs(self, vals, shape) -> torch.Tensor:
        return scalars_to_limbs(vals, self.cv.fr.L, self.device, shape)

    # ------------------------------------------------------------- ceremony
    def setup(self, rng: GameRng, m: int, n: int) -> Parameters:
        """`mod.rs:105-121`: ElGamal setup, Pedersen setup(n), then G'."""
        cv = self.cv
        enc = self.enc_scheme.setup(cv, rng)
        commit_key = self.comm_scheme.setup(cv, rng, n)
        shuffle_generator = cv.host.rand_point(rng.rng)
        return Parameters(cv, m, n, enc, commit_key, shuffle_generator, self.c, self.device)

    def player_keygen(self, rng: GameRng, pp: Parameters):
        """-> (pk host point, sk int) (`mod.rs:123-130`)."""
        return self.enc_scheme.keygen(pp.enc, rng)

    def prove_key_ownership(self, rng, pp, pk, sk, player_public_info: bytes):
        """Schnorr proof bound to the player's public info (`mod.rs:132-149`)."""
        ts = TranscriptBatch([KEY_OWN_RNG_SEED + bytes(player_public_info)])
        return sigma.schnorr_prove(pp.cv, pp.enc.gen_table, [pk], [sk], ts, rng)

    def verify_key_ownership(self, pp, pk, player_public_info: bytes, proof):
        ts = TranscriptBatch([KEY_OWN_RNG_SEED + bytes(player_public_info)])
        sigma.schnorr_verify(pp.cv, pp.enc.gen_table, [pk], proof, ts)

    def compute_aggregate_key(self, pp, player_keys_proof_info) -> AggregateKey:
        """Verify every key-ownership proof (one batched Schnorr check), then
        sum the keys (`mod.rs:167-180`)."""
        cv = pp.cv
        pks = [pk for pk, _, _ in player_keys_proof_info]
        seeds = [KEY_OWN_RNG_SEED + bytes(info) for _, _, info in player_keys_proof_info]
        proof = sigma.SchnorrProof(
            [p.commit[0] for _, p, _ in player_keys_proof_info],
            [p.response[0] for _, p, _ in player_keys_proof_info],
        )
        try:
            sigma.schnorr_verify(cv, pp.enc.gen_table, pks, proof, TranscriptBatch(seeds))
        except CryptoError as e:
            raise CardProtocolError(e) from e
        acc = cv.host.identity
        for pk in pks:
            acc = cv.host.add(acc, pk)
        return AggregateKey(acc, FixedBaseTable(cv, acc, self.c, self.device))

    # ------------------------------------------------------------- masking
    def mask(self, rng, pp, shared_key: AggregateKey, cards: PointP, alphas):
        """Mask a batch of cards; returns (masked, proof) (`mod.rs:182-212`).

        cards: PointP [...]; alphas: flat list of ints (C-order over the
        batch). Chaum-Pedersen statement (c0, c1 - card) over bases
        (g, aggregate key)."""
        cv = pp.cv
        shape = tuple(cards.x.shape[:-1])
        masked = self.enc_scheme.encrypt(pp.enc, shared_key.table, cards, self._limbs(alphas, shape))
        stmt_b = cv.add(masked.c1, cv.neg(cards))
        ts = TranscriptBatch.fixed(MASKING_RNG_SEED, _num(shape))
        proof = sigma.cp_prove(cv, pp.enc.gen_table, shared_key.table, masked.c0, stmt_b, list(alphas), ts, rng)
        return masked, proof

    def verify_mask(self, pp, shared_key: AggregateKey, cards: PointP, masked: Ciphertexts, proof):
        """`mod.rs:214-239`; raises ProofVerificationError("Chaum-Pedersen")."""
        cv = pp.cv
        shape = tuple(cards.x.shape[:-1])
        stmt_b = cv.add(masked.c1, cv.neg(cards))
        ts = TranscriptBatch.fixed(MASKING_RNG_SEED, _num(shape))
        sigma.cp_verify(cv, pp.enc.gen_table, shared_key.table, masked.c0, stmt_b, proof, ts)

    # ------------------------------------------------------------ remasking
    def remask(self, rng, pp, shared_key: AggregateKey, original: Ciphertexts, alphas):
        """Remask = add an encryption of zero (`remasking.rs:15-21`,
        `mod.rs:241-271`). Statement: remasked - original over (g, pk)."""
        cv = pp.cv
        shape = tuple(original.c0.x.shape[:-1])
        zero_enc = self.enc_scheme.encrypt_zero(pp.enc, shared_key.table, self._limbs(alphas, shape))
        remasked = self.enc_scheme.add(cv, original, zero_enc)
        stmt = self.enc_scheme.sub(cv, remasked, original)
        ts = TranscriptBatch.fixed(REMASKING_RNG_SEED, _num(shape))
        proof = sigma.cp_prove(cv, pp.enc.gen_table, shared_key.table, stmt.c0, stmt.c1, list(alphas), ts, rng)
        return remasked, proof

    def verify_remask(self, pp, shared_key, original: Ciphertexts, remasked: Ciphertexts, proof):
        cv = pp.cv
        shape = tuple(original.c0.x.shape[:-1])
        stmt = self.enc_scheme.sub(cv, remasked, original)
        ts = TranscriptBatch.fixed(REMASKING_RNG_SEED, _num(shape))
        sigma.cp_verify(cv, pp.enc.gen_table, shared_key.table, stmt.c0, stmt.c1, proof, ts)

    # -------------------------------------------------------------- reveal
    def compute_reveal_token(self, rng, pp, sk: int, pk, masked: Ciphertexts):
        """token = sk * c0 with a Chaum-Pedersen proof over bases (c0, g) and
        statement (token, pk) (`mod.rs:300-329`), batched over cards.

        The token and the proof's commitment k * c0 are one `scalar_mul`
        over both scalars (the nonces are drawn first, as `cp_prove` would
        draw them: the token draws nothing)."""
        cv = pp.cv
        shape = tuple(masked.c0.x.shape[:-1])
        B = _num(shape)
        ks = sigma.cp_nonces(cv, shape, rng)
        k_limbs = self._limbs(ks, shape)
        token, t_g = sigma.batch_muls(cv, [(self._limbs([sk] * B, shape), masked.c0), (k_limbs, masked.c0)])
        pk_dev = self._broadcast_host_point(pk, shape)
        ts = TranscriptBatch.fixed(REVEAL_RNG_SEED, B)
        proof = sigma.cp_respond(
            cv, masked.c0, pp.enc.gen_table, token, pk_dev, t_g, pp.enc.gen_table.mul(k_limbs), ks, [sk] * B, ts
        )
        return token, proof

    def verify_reveal(self, pp, pk, token: PointP, masked: Ciphertexts, proof):
        """`mod.rs:331-354`."""
        cv = pp.cv
        shape = tuple(masked.c0.x.shape[:-1])
        pk_dev = self._broadcast_host_point(pk, shape)
        ts = TranscriptBatch.fixed(REVEAL_RNG_SEED, _num(shape))
        sigma.cp_verify(cv, masked.c0, pp.enc.gen_table, token, pk_dev, proof, ts)

    def unmask(self, pp, decryption_key, masked: Ciphertexts) -> PointP:
        """Verify every player's token proof, aggregate the tokens, decrypt
        (`mod.rs:356-378`, `reveal.rs:14-18`): card = -sum(tokens) + c1.

        All players' proofs are checked as one batched Chaum-Pedersen
        verification over [players, ...] statements (each statement keeps its
        own transcript, so this accepts and rejects exactly what one check
        per player does)."""
        cv = pp.cv
        shape = tuple(masked.c0.x.shape[:-1])
        P = len(decryption_key)
        tokens = [token for token, _, _ in decryption_key]
        stack = lambda pts: cat_points([map_point(lambda q: q.expand(shape + q.shape[-1:])[None], p) for p in pts])
        proofs = [proof for _, proof, _ in decryption_key]
        joint = sigma.ChaumPedersenProof(
            [t for p in proofs for t in p.t_g],
            [t for p in proofs for t in p.t_h],
            [s for p in proofs for s in p.response],
            (P,) + shape,
        )
        try:
            sigma.cp_verify(
                cv,
                stack([masked.c0] * P),
                pp.enc.gen_table,
                stack(tokens),
                stack([self._broadcast_host_point(pk, shape) for _, _, pk in decryption_key]),
                joint,
                TranscriptBatch.fixed(REVEAL_RNG_SEED, P * _num(shape)),
            )
        except CryptoError as e:
            raise CardProtocolError(e) from e
        agg = tokens[0]
        for token in tokens[1:]:
            agg = cv.add(agg, token)
        return self.reveal_cards(agg, masked)

    # ------------------------------------------------------------- shuffle
    def shuffle_and_remask(
        self, rng, pp, shared_key, deck: Ciphertexts, masking_factors, permutation,
        device_proof: bool = False,
    ):
        """Permute and remask the deck and prove it with the Bayer-Groth
        shuffle argument (`mod.rs:380-418`). `permutation`: pi with
        output[i] = deck[pi[i]], [N] or [B, N]; `masking_factors`: N (or B*N)
        ints.

        The staged device prover makes the proof; it converts to the host
        dataclass `ShuffleProof` (single decks only) unless `device_proof`,
        which keeps the device proof that `verify_shuffle` consumes as is."""
        cv = pp.cv
        N = pp.num_cards
        dev = self.device
        pi = torch.as_tensor(np.asarray(permutation), dtype=torch.long, device=dev)
        batched = pi.dim() == 2
        B = pi.shape[0] if batched else 1
        pi_b = pi if batched else pi[None]
        deck_b = deck if batched else _batch1(deck)
        permuted = Ciphertexts(
            *(map_point(lambda t: torch.gather(t, 1, pi_b[..., None].expand(t.shape)), c) for c in deck_b)
        )
        rho = self._limbs(list(np.asarray(masking_factors, dtype=object).reshape(-1)), (B, N))
        shuffled = elgamal.cipher_add(cv, permuted, elgamal.encrypt_zero(pp.enc, shared_key.table, rho))
        keys = device_api.make_keys(pp, shared_key)
        rand = device_api.sample_shuffle_rand(rng, pp.m, pp.n, cv.fr.L, cv.host.order, batch=B, device=dev)
        dev_proof = device_api.prove_shuffle(cv, pp.m, pp.n, keys, deck_b, shuffled, pi_b, rho, rand)
        if not batched:
            shuffled = Ciphertexts(*(map_point(lambda t: t[0], c) for c in shuffled))
        if device_proof:
            return shuffled, dev_proof
        if B != 1:
            raise ValueError("host-dataclass proofs are single-statement; use device_proof=True for batches")
        return shuffled, device_api.dev_proof_to_host(cv, dev_proof)

    def verify_shuffle(self, pp, shared_key, original: Ciphertexts, shuffled: Ciphertexts, proof):
        """`mod.rs:420-443`; raises the reference-ordered
        ProofVerificationError ("Hadamard Product (5.1)" first).

        Takes single decks ([N] ciphertexts with a host or device proof) or
        batches ([B, N] ciphertexts with a batched device proof)."""
        cv = pp.cv
        keys = device_api.make_keys(pp, shared_key)
        if isinstance(proof, ShuffleProofDev):
            dev_proof = proof if proof.c_a.x.dim() == 3 else device_api.expand_proof(proof)
        else:
            dev_proof = device_api.host_proof_to_dev(cv, proof, self.device)
        batched = original.c0.x.dim() == 3  # [B, N, L] coordinates
        bat = (lambda c: c) if batched else _batch1
        checks = device_api.verify_shuffle(cv, pp.m, pp.n, keys, bat(original), bat(shuffled), dev_proof)
        device_api.raise_by_flags(checks)

    # ---------------------------------------------- Mask/Remask/Reveal traits
    def mask_cards(self, pp, shared_key, cards: PointP, r) -> Ciphertexts:
        """`Card::mask` = ElGamal encrypt (`masking.rs:10-20`), proof-free."""
        shape = tuple(cards.x.shape[:-1])
        return self.enc_scheme.encrypt(pp.enc, shared_key.table, cards, self._limbs(r, shape))

    def remask_cards(self, pp, shared_key, masked: Ciphertexts, r) -> Ciphertexts:
        """`MaskedCard::remask` = add an encryption of zero
        (`remasking.rs:15-21`), proof-free."""
        shape = tuple(masked.c0.x.shape[:-1])
        zero_enc = self.enc_scheme.encrypt_zero(pp.enc, shared_key.table, self._limbs(r, shape))
        return self.enc_scheme.add(pp.cv, masked, zero_enc)

    def reveal_cards(self, aggregate_token: PointP, masked: Ciphertexts) -> PointP:
        """`RevealToken::reveal` = -token + c1 (`reveal.rs:14-18`)."""
        cv = self.cv
        return cv.add(cv.neg(aggregate_token), masked.c1)

    # ------------------------------------------------------------- helpers
    def _broadcast_host_point(self, hp, shape) -> PointP:
        P = self.cv.from_host_points([hp], self.device)
        return map_point(lambda q: q[0].expand(tuple(shape) + q.shape[-1:]), P)


def _batch1(cts: Ciphertexts) -> Ciphertexts:
    """[N] ciphertexts -> [1, N]."""
    return Ciphertexts(*(map_point(lambda t: t[None], c) for c in cts))
