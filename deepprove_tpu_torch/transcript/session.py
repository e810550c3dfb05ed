"""Fiat-Shamir transcript session for the device-resident prover.

As the JAX package's `DeviceTranscript` (`transcript/session.py`): the duplex
sponge's state lives on the session's device for the whole prove, one int64
tensor of 18 words (`transcript/device.py`). Absorbs take device `GF`/`GF2`
arrays, host constants or labels; squeezes return device `GF2` arrays. Each
call is one launch of the sponge kernel (`csrc/transcript.cu`) on a CUDA
state, which neither waits for the device nor reads it; on a CPU state the
plain version runs the same duplex with the native host permutation. The
sumcheck kernels (`sumcheck/fused.py`) run the same sponge inside their own
launches, on the same state.

The host reads the state only where it truly needs a value: the Basefold
query indices (`challenges_to_host`, one read an opening) and the end of a
prove (`materialize`, which lowers the proof and the state in one read).
`pulls` counts those reads. The challenges equal the host
`BasicTranscript`'s bit for bit.
"""

from __future__ import annotations

import torch

from .. import glue
from ..fields import gf
from ..fields.gf import GF2
from ..fields.host import P
from . import _bytes_to_field_elements
from . import device as devt


def label_chunks(msg: bytes) -> list[int]:
    """A byte label as the canonical field elements that absorb it."""
    return _bytes_to_field_elements(msg)


class DeviceTranscript:
    def __init__(self, state: torch.Tensor):
        self.state = state
        self.pulls = 0

    @property
    def device(self) -> torch.device:
        return self.state.device

    @staticmethod
    def from_host(transcript, device) -> "DeviceTranscript":
        """A session starting from `transcript`'s state (a copy on `device`)."""
        return DeviceTranscript(devt.export_state(transcript.challenger, torch.device(device)))

    def sync_to_host(self, transcript) -> None:
        """Bring `transcript` to this session's state (one read)."""
        self.pulls += 1
        devt.import_state(transcript.challenger, self.state)

    def materialize(self, root, transcript):
        """Lower `root` with glue.materialize and bring `transcript` to this
        session's state, in ONE read; returns the host root."""
        self.pulls += 1
        root, state = glue.materialize([root, glue.NpGF(self.state)])
        devt.import_state(transcript.challenger, state)
        return root

    # -- one sponge call -----------------------------------------------------
    def step(self, pre=(), arr=None, labels=(), k: int = 0) -> GF2:
        """Absorb the constants `pre`, then `arr` (a base tensor or GF2 on
        this device), then squeeze k challenges, the label chunks of
        `labels` absorbed before each one (one label for all, or one each).
        Returns GF2 (k,)."""
        return devt.sponge(self.state, pre, arr, labels, k)

    # -- absorb ------------------------------------------------------------
    def append_message(self, msg: bytes):
        self.append_constants(label_chunks(msg))

    def append_constants(self, values) -> None:
        vals = [int(v) % P for v in values]
        for i in range(0, len(vals), devt.MAX_PRE):
            self.step(pre=vals[i : i + devt.MAX_PRE])

    def append_base(self, arr: torch.Tensor):
        self.step(arr=arr)

    def append_exts(self, arr: GF2):
        self.step(arr=arr)

    # -- squeeze -----------------------------------------------------------
    def read_challenges(self, k: int) -> GF2:
        """k challenges as ONE device GF2 (k,) array."""
        return self.step(k=k)

    def get_and_append_challenge(self, label: bytes) -> GF2:
        return self.step(labels=(label_chunks(label),), k=1).reshape(())

    def get_and_append_challenges(self, label: bytes, k: int):
        """k x (label, squeeze); returns GF2 (k,) (None if k == 0)."""
        if k == 0:
            return None
        return self.step(labels=(label_chunks(label),), k=k)

    def challenges_to_host(self, label: bytes, k: int) -> list:
        """k x (label, squeeze) as host pairs: one read."""
        self.pulls += 1
        return gf.ext_to_pairs(self.get_and_append_challenges(label, k))
