"""The benchmark's plain reference: the Stark curve, the Fiat-Shamir
transcript, the Bayer-Groth verifier and the card protocol in Python
integers. It imports nothing of the program under test."""
