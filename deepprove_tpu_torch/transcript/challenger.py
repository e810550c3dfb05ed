"""Duplex challenger over the Poseidon2 permutation (host-side).

Exact mirror of plonky3's `DuplexChallenger<F, P, 8, 4>` as used by the
reference (poseidon/src/challenger.rs:13-31 `DefaultChallenger`):

  * observe(v): clear output buffer, push v; duplex when 4 inputs queued.
  * duplexing: overwrite state[0..len(inputs)], permute, output = state[0..4].
  * sample(): duplex if inputs pending or outputs empty; POP from the END
    of the output buffer (p3 `Vec::pop` semantics — order matters for
    bit-compatible transcripts).

All values are canonical Goldilocks uint64 python ints / numpy scalars.
The permutation is the native C one (`native/poseidon2.c`).
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..fields.host import P
from ..hashing.constants import RATE, WIDTH


class DuplexChallenger:
    def __init__(self):
        self.state = np.zeros(WIDTH, dtype=np.uint64)
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    def clone(self) -> "DuplexChallenger":
        c = DuplexChallenger.__new__(DuplexChallenger)
        c.state = self.state.copy()
        c.input_buffer = list(self.input_buffer)
        c.output_buffer = list(self.output_buffer)
        return c

    def _duplexing(self):
        assert len(self.input_buffer) <= RATE
        for i, v in enumerate(self.input_buffer):
            self.state[i] = v
        self.input_buffer.clear()
        native.permute_inplace(self.state)
        self.output_buffer = self.state[:RATE].tolist()

    def observe(self, value):
        value = int(value)
        assert 0 <= value < P
        self.output_buffer.clear()
        self.input_buffer.append(value)
        if len(self.input_buffer) == RATE:
            self._duplexing()

    def observe_slice(self, values):
        for v in np.ravel(np.asarray(values, dtype=np.uint64)):
            self.observe(int(v))

    def sample(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return self.output_buffer.pop()

    def sample_ext(self) -> tuple[int, int]:
        """Sample a GoldilocksExt2 element (a0 + a1 X); a0 sampled first."""
        a0 = self.sample()
        a1 = self.sample()
        return (a0, a1)
