"""Abstract protocol + scheme interfaces (the reference's L4 trait layer;
counterpart of `mental_poker_tpu/protocol/api.py`).

Mirrors the swappable-interface design of the reference:

- `BarnettSmartProtocol` — the 14-method protocol trait (`src/lib.rs:41-198`);
  `DLCards` (protocol/dl_cards.py) is the concrete discrete-log backend, just
  as `DLCards<C>` is the reference's only `impl` (`mod.rs:86-444`).
- `Mask` / `Remask` / `Reveal` — the per-card-type traits (`lib.rs:16-36`).
  In this batch-first framework cards are arrays, not objects, so the traits
  become operations carried by the encryption scheme rather than methods on
  card values; the signatures are otherwise one-to-one.
- `HomomorphicEncryptionScheme` — `proof_essentials::homomorphic_encryption::
  HomomorphicEncryptionScheme` (use-sites `lib.rs:7,19-22`, `mod.rs:110-112`);
  `ElGamalScheme` is the concrete instance over crypto/elgamal.py. The
  concrete schemes carry the fixed-base window width and the device their
  tables live on.
- `HomomorphicCommitmentScheme` — `proof_essentials::vector_commitment::
  HomomorphicCommitmentScheme` (`mod.rs:18-19,111`); `PedersenScheme` over
  crypto/pedersen.py.
- `ArgumentOfKnowledge` — `proof_essentials::zkp::ArgumentOfKnowledge`
  (`mod.rs:20-24`, call shape at `mod.rs:142-148,203-209,409-415`):
  `prove(params, statement, witness, transcript, rng) -> proof` /
  `verify(params, statement, proof, transcript)`. `SchnorrIdentification`,
  `DLEquality`, and `ShuffleArgument` adapt the module-level provers.

A new backend (different encryption scheme, commitment, or shuffle argument)
plugs in by implementing these ABCs; `DLCards` consumes only this surface
plus the batched array types.
"""

from __future__ import annotations

import abc
from typing import Any, Sequence

from ..arguments import shuffle as shuffle_arg
from ..config import window_bits
from ..crypto import elgamal, pedersen, sigma
from ..crypto.elgamal import Ciphertexts
from ..crypto.transcript import TranscriptBatch
from ..ops.curve import Curve, PointP
from ..utils.rand import GameRng

# ---------------------------------------------------------------------------
# Encryption / commitment scheme traits (proof-essentials E2 / E4)
# ---------------------------------------------------------------------------


class HomomorphicEncryptionScheme(abc.ABC):
    """`HomomorphicEncryptionScheme<Scalar>` (`lib.rs:7`): setup/generator/
    keygen/encrypt plus the homomorphic ops the protocol layer needs.

    All plaintexts/ciphertexts are batched device arrays (`PointP` /
    `Ciphertexts` with arbitrary leading batch shape)."""

    @abc.abstractmethod
    def setup(self, cv: Curve, rng: GameRng) -> Any:
        """Sample scheme parameters (the ElGamal generator, `mod.rs:110`)."""

    @abc.abstractmethod
    def keygen(self, pp: Any, rng: GameRng) -> tuple:
        """-> (public key, secret key) (`mod.rs:127`)."""

    @abc.abstractmethod
    def encrypt(self, pp: Any, pk: Any, msgs: PointP, r_limbs) -> Ciphertexts:
        """Encrypt a batch of plaintexts under randomness r (`masking.rs:17`)."""

    @abc.abstractmethod
    def encrypt_zero(self, pp: Any, pk: Any, r_limbs) -> Ciphertexts:
        """Encryption of the identity — the remask delta (`remasking.rs:16`)."""

    @abc.abstractmethod
    def add(self, cv: Curve, a: Ciphertexts, b: Ciphertexts) -> Ciphertexts:
        """Homomorphic addition (`remasking.rs:18`)."""

    @abc.abstractmethod
    def sub(self, cv: Curve, a: Ciphertexts, b: Ciphertexts) -> Ciphertexts:
        """a + (-b) — the proof-statement delta (`mod.rs:255-257`)."""


class ElGamalScheme(HomomorphicEncryptionScheme):
    """ElGamal over a short-Weierstrass curve (E3, crypto/elgamal.py), with
    c-bit generator tables on `device`."""

    def __init__(self, c: int | None = None, device="cuda"):
        self.c = window_bits(c)
        self.device = device

    def setup(self, cv: Curve, rng: GameRng):
        return elgamal.setup(cv, rng, self.c, self.device)

    def keygen(self, pp, rng: GameRng):
        return elgamal.keygen(pp, rng)

    def encrypt(self, pp, pk, msgs: PointP, r_limbs) -> Ciphertexts:
        return elgamal.encrypt(pp, pk, msgs, r_limbs)

    def encrypt_zero(self, pp, pk, r_limbs) -> Ciphertexts:
        return elgamal.encrypt_zero(pp, pk, r_limbs)

    def add(self, cv: Curve, a: Ciphertexts, b: Ciphertexts) -> Ciphertexts:
        return elgamal.cipher_add(cv, a, b)

    def sub(self, cv: Curve, a: Ciphertexts, b: Ciphertexts) -> Ciphertexts:
        return elgamal.cipher_sub(cv, a, b)


class HomomorphicCommitmentScheme(abc.ABC):
    """`HomomorphicCommitmentScheme` (`lib.rs:9`, `mod.rs:111`)."""

    @abc.abstractmethod
    def setup(self, cv: Curve, rng: GameRng, n: int) -> Any:
        """Sample a commit key for n-vectors (n+1 generators, `mod.rs:111`)."""

    @abc.abstractmethod
    def commit(self, key: Any, vec_limbs, r_limbs) -> PointP:
        """Commit to a batch of n-vectors with blinding r."""


class PedersenScheme(HomomorphicCommitmentScheme):
    """Vector Pedersen commitments (E4, crypto/pedersen.py), with c-bit key
    tables on `device`."""

    def __init__(self, c: int | None = None, device="cuda"):
        self.c = window_bits(c)
        self.device = device

    def setup(self, cv: Curve, rng: GameRng, n: int):
        return pedersen.setup(cv, rng, n, self.c, self.device)

    def commit(self, key, vec_limbs, r_limbs) -> PointP:
        return key.commit(vec_limbs, r_limbs)


# ---------------------------------------------------------------------------
# ArgumentOfKnowledge trait (proof-essentials E5)
# ---------------------------------------------------------------------------


class ArgumentOfKnowledge(abc.ABC):
    """`proof_essentials::zkp::ArgumentOfKnowledge` (`mod.rs:20-24`).

    prove(params, statement, witness, transcript, rng) -> proof
    verify(params, statement, proof, transcript) -> None | raises
    `ProofVerificationError` (exact reference strings, crypto/errors.py)."""

    @abc.abstractmethod
    def prove(self, params, statement, witness, ts: TranscriptBatch, rng: GameRng):
        ...

    @abc.abstractmethod
    def verify(self, params, statement, proof, ts: TranscriptBatch) -> None:
        ...


class SchnorrIdentification(ArgumentOfKnowledge):
    """E6 (`mod.rs:142-148,159-164`): params = (cv, generator base);
    statement = [B] public keys; witness = [B] secret scalars."""

    def prove(self, params, statement, witness, ts, rng):
        cv, gen = params
        return sigma.schnorr_prove(cv, gen, statement, witness, ts, rng)

    def verify(self, params, statement, proof, ts):
        cv, gen = params
        sigma.schnorr_verify(cv, gen, statement, proof, ts)


class DLEquality(ArgumentOfKnowledge):
    """E7 (`mod.rs:193-209,...`): params = (cv, base_g, base_h); statement =
    (a, b) batched points; witness = [B] scalars."""

    def prove(self, params, statement, witness, ts, rng):
        cv, g, h = params
        a, b = statement
        return sigma.cp_prove(cv, g, h, a, b, witness, ts, rng)

    def verify(self, params, statement, proof, ts):
        cv, g, h = params
        a, b = statement
        sigma.cp_verify(cv, g, h, a, b, proof, ts)


class ShuffleArgument(ArgumentOfKnowledge):
    """E8 (`mod.rs:397-415,427-442`): params = shuffle context (pp,
    shared_key); statement = (input deck, output deck); witness =
    (permutation, masking factors). Delegates to the host Bayer-Groth stack
    (arguments/shuffle.py); the staged device path is reached through
    `DLCards.shuffle_and_remask` (the hot path)."""

    def prove(self, params, statement, witness, ts, rng):
        pp, shared_key = params
        deck_in, deck_out = statement
        permutation, masking_factors = witness
        return shuffle_arg.prove(
            rng, pp, shared_key, deck_in, deck_out, permutation, masking_factors, ts
        )

    def verify(self, params, statement, proof, ts):
        pp, shared_key = params
        deck_in, deck_out = statement
        shuffle_arg.verify(pp, shared_key, deck_in, deck_out, proof, ts)


# ---------------------------------------------------------------------------
# Card-operation traits (lib.rs:16-36) and the protocol trait (lib.rs:41-198)
# ---------------------------------------------------------------------------


class Mask(abc.ABC):
    """`Mask<Scalar, Enc>` (`lib.rs:16-23`): mask(pp, shared_key, r)."""

    @abc.abstractmethod
    def mask_cards(self, pp, shared_key, cards: PointP, r) -> Ciphertexts:
        ...


class Remask(abc.ABC):
    """`Remask<Scalar, Enc>` (`lib.rs:25-32`)."""

    @abc.abstractmethod
    def remask_cards(self, pp, shared_key, masked: Ciphertexts, r) -> Ciphertexts:
        ...


class Reveal(abc.ABC):
    """`Reveal<F, Enc>` (`lib.rs:34-36`): reveal(tokens, cipher) -> plaintext."""

    @abc.abstractmethod
    def reveal_cards(self, aggregate_token: PointP, masked: Ciphertexts) -> PointP:
        ...


class BarnettSmartProtocol(abc.ABC):
    """The 14-method protocol trait (`src/lib.rs:41-198`).

    Method names, argument order, and error behavior follow the reference
    one-to-one; every operation is batched (the reference's single-card call
    is the batch shape () / [1] special case). Concrete backends bind the
    associated types through their constructor (curve, schemes, arguments) —
    `DLCards` is the discrete-log instantiation."""

    # ceremony (lib.rs:74-107)
    @abc.abstractmethod
    def setup(self, rng: GameRng, m: int, n: int):
        ...

    @abc.abstractmethod
    def player_keygen(self, rng: GameRng, pp):
        ...

    @abc.abstractmethod
    def prove_key_ownership(self, rng, pp, pk, sk, player_public_info: bytes):
        ...

    @abc.abstractmethod
    def verify_key_ownership(self, pp, pk, player_public_info: bytes, proof):
        ...

    @abc.abstractmethod
    def compute_aggregate_key(self, pp, player_keys_proof_info: Sequence):
        ...

    # masking (lib.rs:111-126)
    @abc.abstractmethod
    def mask(self, rng, pp, shared_key, cards: PointP, alphas):
        ...

    @abc.abstractmethod
    def verify_mask(self, pp, shared_key, cards, masked, proof):
        ...

    # remasking (lib.rs:130-145)
    @abc.abstractmethod
    def remask(self, rng, pp, shared_key, original, alphas):
        ...

    @abc.abstractmethod
    def verify_remask(self, pp, shared_key, original, remasked, proof):
        ...

    # reveal (lib.rs:150-177)
    @abc.abstractmethod
    def compute_reveal_token(self, rng, pp, sk, pk, masked):
        ...

    @abc.abstractmethod
    def verify_reveal(self, pp, pk, token, masked, proof):
        ...

    @abc.abstractmethod
    def unmask(self, pp, decryption_key, masked):
        ...

    # shuffle (lib.rs:181-197)
    @abc.abstractmethod
    def shuffle_and_remask(self, rng, pp, shared_key, deck, masking_factors, permutation):
        ...

    @abc.abstractmethod
    def verify_shuffle(self, pp, shared_key, original, shuffled, proof):
        ...
