"""Fiat-Shamir transcript session for the device-resident prover.

The JAX package keeps the duplex sponge on the device (`transcript/device.py`,
`session.py`) so that a prove never waits on a round trip to a remote TPU.
Here the sponge stays on the host, in the same `DuplexChallenger` the
verifier runs, and the session absorbs device values by copying them down
(one device-to-host read per absorbed array) and hands challenges back as
device tensors. In eager torch one width-8 permutation on the device would
be thousands of tiny launches, while the native host permutation costs
about a microsecond; the challenges are identical either way. `pulls` and
`pushes` count the copies, so that their cost can be measured.

The API parallels the JAX `DeviceTranscript`: absorbs take device
`GF`/`GF2` arrays or host constants; squeezes return device `GF2` arrays.
"""

from __future__ import annotations

import torch

from ..fields import gf
from ..fields.host import P
from . import _bytes_to_field_elements


class DeviceTranscript:
    def __init__(self, challenger, device):
        self.challenger = challenger
        self.device = torch.device(device)
        self.pulls = 0
        self.pushes = 0

    @staticmethod
    def from_host(transcript, device) -> "DeviceTranscript":
        """A session sharing `transcript`'s challenger (no copy)."""
        return DeviceTranscript(transcript.challenger, device)

    def sync_to_host(self, transcript) -> None:
        """Bring `transcript` to this session's state."""
        if transcript.challenger is not self.challenger:
            transcript.challenger = self.challenger.clone()

    # -- absorb ------------------------------------------------------------
    def append_message(self, msg: bytes):
        for e in _bytes_to_field_elements(msg):
            self.challenger.observe(e)

    def append_constants(self, values) -> None:
        for v in values:
            self.challenger.observe(int(v) % P)

    def append_base(self, arr: torch.Tensor):
        self.pulls += 1
        for v in gf.to_u64(arr.reshape(-1)).tolist():
            self.challenger.observe(v)

    def append_exts(self, arr: gf.GF2):
        self.pulls += 1
        for a0, a1 in gf.ext_to_pairs(arr):
            self.challenger.observe(a0)
            self.challenger.observe(a1)

    # -- squeeze -----------------------------------------------------------
    def challenge_pairs(self, k: int, label: bytes | None = None) -> list:
        """k host challenges; with `label`, absorbed before each one."""
        out = []
        for _ in range(k):
            if label is not None:
                self.append_message(label)
            out.append(self.challenger.sample_ext())
        return out

    def push(self, pairs) -> gf.GF2:
        """Host ext pairs (challenges or values computed from them) as one
        device GF2 (k,) array, counted as one copy."""
        self.pushes += 1
        return gf.ext_from_pairs(pairs, self.device)

    def read_challenge(self) -> gf.GF2:
        return self.push(self.challenge_pairs(1)).reshape(())

    def read_challenges(self, k: int) -> gf.GF2:
        """k challenges as ONE device GF2 (k,) array."""
        return self.push(self.challenge_pairs(k))

    def get_and_append_challenge(self, label: bytes) -> gf.GF2:
        return self.push(self.challenge_pairs(1, label)).reshape(())

    def get_and_append_challenges(self, label: bytes, k: int):
        """k x (label, squeeze); returns GF2 (k,) (None if k == 0)."""
        if k == 0:
            return None
        return self.push(self.challenge_pairs(k, label))
