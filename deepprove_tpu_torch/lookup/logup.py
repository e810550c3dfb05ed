"""Lookup arguments. This slice of the port holds only the host `Claim`
that the Dense layer, the commitment accumulator and the verifier share;
logup-GKR arrives with the Requant/ReLU slice."""

from __future__ import annotations

import dataclasses

ExtPair = tuple[int, int]


@dataclasses.dataclass
class Claim:
    """Claim{point, eval} with host ext pairs."""

    point: list[ExtPair]
    eval: ExtPair
