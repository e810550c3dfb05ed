"""Fiat-Shamir transcript (host-side, sequential).

Mirrors the reference's `BasicTranscript` (transcript/src/basic.rs:8):
a Poseidon2 duplex challenger observing base-field elements; challenges
are extension-field samples. The prover's bulk math lives on-device; the
transcript is the tiny sequential state machine between device round
kernels (SURVEY.md §7 host/device split).

Extension elements are represented host-side as python-int pairs
(a0, a1) with a0 + a1·X, X² = 7.
"""

from __future__ import annotations

import numpy as np

from ..fields.host import P
from .challenger import DuplexChallenger

__all__ = ["BasicTranscript", "DuplexChallenger"]


def _bytes_to_field_elements(msg: bytes) -> list[int]:
    """Little-endian 8-byte chunks → canonical u64 (ff_ext/src/lib.rs:262)."""
    out = []
    for i in range(0, len(msg), 8):
        chunk = msg[i : i + 8]
        v = int.from_bytes(chunk + b"\x00" * (8 - len(chunk)), "little")
        assert v < P
        out.append(v)
    return out


class BasicTranscript:
    """Poseidon2-duplex Fiat-Shamir transcript (transcript/src/basic.rs:8)."""

    def __init__(self, label: bytes = b"m2vec", _challenger: DuplexChallenger | None = None):
        if _challenger is not None:
            self.challenger = _challenger
            return
        self.challenger = DuplexChallenger()
        for e in _bytes_to_field_elements(label):
            self.challenger.observe(e)

    def clone(self) -> "BasicTranscript":
        return BasicTranscript(_challenger=self.challenger.clone())

    # -- absorb ------------------------------------------------------------
    def append_field_element(self, element: int):
        self.challenger.observe(int(element))

    def append_field_elements(self, elements):
        self.challenger.observe_slice(np.asarray(elements, dtype=np.uint64))

    def append_field_element_ext(self, element):
        a0, a1 = element
        self.challenger.observe(int(a0))
        self.challenger.observe(int(a1))

    def append_field_element_exts(self, elements):
        for e in elements:
            self.append_field_element_ext(e)

    def append_message(self, msg: bytes):
        for e in _bytes_to_field_elements(msg):
            self.challenger.observe(e)

    # -- squeeze -----------------------------------------------------------
    def read_challenge(self) -> tuple[int, int]:
        return self.challenger.sample_ext()

    def get_and_append_challenge(self, label: bytes) -> tuple[int, int]:
        self.append_message(label)
        return self.read_challenge()


def default_transcript() -> BasicTranscript:
    """The zkml pipeline's transcript: label b"m2vec"."""
    return BasicTranscript(b"m2vec")
