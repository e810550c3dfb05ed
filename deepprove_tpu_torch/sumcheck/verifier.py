"""Sumcheck verifier (host-side, python-int extension arithmetic).

Mirrors `IOPVerifierState::verify` (sumcheck/src/verifier.rs:12): absorb
n and max_degree, then per round absorb the message, check
p(0) + p(1) = expected, squeeze the b"Internal round" challenge and
interpolate the next expectation. Returns the subclaim
(point, expected_evaluation) for the caller to check against the final
polynomial evaluation — exactly the reference's `SumCheckSubClaim`.
"""

from __future__ import annotations

import dataclasses
import functools

from ..fields import host
from ..transcript import BasicTranscript

ExtPair = tuple[int, int]


@dataclasses.dataclass
class SubClaim:
    point: list[ExtPair]
    expected_evaluation: ExtPair


def interpolate_uni_poly(evals: list[ExtPair], at: ExtPair) -> ExtPair:
    """Evaluate the degree-(len-1) poly with values `evals` at points
    0..len-1, at ext point `at` (sumcheck/src/util.rs:148).

    Lagrange with factorial-based denominators — O(d) field inversions
    avoided by batching into python pow (host-side, d ≤ 5 so trivial).
    """
    n = len(evals)
    # prefix[i] = Π_{j<i} (at - j); suffix[i] = Π_{j>i} (at - j)
    prefix = [(1, 0)] * (n + 1)
    for i in range(n):
        prefix[i + 1] = host.ext_mul(prefix[i], host.ext_sub(at, (i % host.P, 0)))
    suffix = [(1, 0)] * (n + 1)
    for i in range(n - 1, -1, -1):
        suffix[i] = host.ext_mul(suffix[i + 1], host.ext_sub(at, (i % host.P, 0)))
    out = (0, 0)
    den_invs = _den_invs(n)
    for i in range(n):
        num = host.ext_mul(prefix[i], suffix[i + 1])
        term = host.ext_mul(evals[i], host.ext_mul(num, (den_invs[i], 0)))
        out = host.ext_add(out, term)
    return out


@functools.lru_cache(maxsize=None)
def _den_invs(n: int) -> tuple:
    """Inverted Lagrange denominators 1/(i!·(n−1−i)!·(−1)^(n−1−i)) for
    the node set {0..n−1} — constants per arity, computed once."""
    fact = [1] * n
    for i in range(1, n):
        fact[i] = fact[i - 1] * i % host.P
    out = []
    for i in range(n):
        den = fact[i] * fact[n - 1 - i] % host.P
        if (n - 1 - i) % 2 == 1:
            den = (-den) % host.P
        out.append(pow(den, host.P - 2, host.P))
    return tuple(out)


def verify(
    claimed_sum: ExtPair,
    round_messages: list[list[ExtPair]],
    num_vars: int,
    max_degree: int,
    transcript: BasicTranscript,
) -> SubClaim:
    transcript.append_message(int(num_vars).to_bytes(8, "little"))
    transcript.append_message(int(max_degree).to_bytes(8, "little"))
    expected = claimed_sum
    point: list[ExtPair] = []
    assert len(round_messages) == num_vars, "wrong number of sumcheck rounds"
    for evals in round_messages:
        assert len(evals) == max_degree + 1, "wrong round message arity"
        transcript.append_field_element_exts(evals)
        got = host.ext_add(evals[0], evals[1])
        if got != expected:
            raise AssertionError(
                f"sumcheck round check failed: p(0)+p(1)={got} != {expected}"
            )
        r = transcript.get_and_append_challenge(b"Internal round")
        point.append(r)
        expected = interpolate_uni_poly(evals, r)
    return SubClaim(point=point, expected_evaluation=expected)
