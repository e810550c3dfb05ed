"""The transcript session over a CPU state (`transcript/device.py`,
`transcript/session.py`) against the port's host `BasicTranscript` and the
JAX package's host `BasicTranscript` (numpy, no XLA), as
tests/test_device_transcript.py holds the JAX session. Exact."""

import numpy as np
import pytest
import torch

from deepprove_tpu.transcript import BasicTranscript as JaxBasicTranscript
from deepprove_tpu_torch.fields import gf
from deepprove_tpu_torch.transcript import BasicTranscript, DuplexChallenger
from deepprove_tpu_torch.transcript import device as devt
from deepprove_tpu_torch.transcript.session import DeviceTranscript, label_chunks

P = gf.P
LONG_LABEL = b"a label far longer than the rate of the sponge, and than one call's sixteen chunks" * 2


def _pairs(rng, k):
    return [tuple(int(v) for v in rng.integers(0, P, size=2, dtype=np.uint64)) for _ in range(k)]


@pytest.mark.parametrize("k", [1, 2, 3, 5, 7, 16, 33])
def test_read_challenges_match_both_host_transcripts(k):
    port, jax_t = BasicTranscript(b"m2vec"), JaxBasicTranscript(b"m2vec")
    for t in (port, jax_t):
        t.append_message(b"seed")
    dt = DeviceTranscript.from_host(port.clone(), "cpu")
    got = gf.ext_to_pairs(dt.read_challenges(k))
    assert got == [port.read_challenge() for _ in range(k)]
    assert got == [tuple(int(v) for v in jax_t.read_challenge()) for _ in range(k)]
    # the state advanced alike: the next labelled challenge agrees too
    after = gf.ext_to_pairs(dt.get_and_append_challenge(b"after").reshape(1))
    assert after == [port.get_and_append_challenge(b"after")]
    assert dt.pulls == 0


# the last four reach and cross the 32-word batches in which the sponge
# kernel reads an array, whose plain reference this is
@pytest.mark.parametrize("n_base, n_ext", [(1, 0), (3, 1), (5, 3), (7, 9), (13, 5), (32, 16), (33, 17), (1, 33), (64, 0)])
def test_absorbs_of_odd_lengths_match_host(n_base, n_ext):
    rng = np.random.default_rng(n_base * 31 + n_ext)
    base = rng.integers(0, P, size=n_base, dtype=np.uint64)
    ext = _pairs(rng, n_ext)
    port, jax_t = BasicTranscript(b"m2vec"), JaxBasicTranscript(b"m2vec")
    for t in (port, jax_t):
        t.append_field_elements(base)
        t.append_field_element_exts(ext)
    dt = DeviceTranscript.from_host(BasicTranscript(b"m2vec"), "cpu")
    dt.append_base(gf.from_u64(base))
    if n_ext:
        dt.append_exts(gf.ext_from_pairs(ext, "cpu"))
    got = gf.ext_to_pairs(dt.get_and_append_challenges(b"lbl", 3))
    assert got == [port.get_and_append_challenge(b"lbl") for _ in range(3)]
    assert got == [tuple(int(v) for v in jax_t.get_and_append_challenge(b"lbl")) for _ in range(3)]


def test_label_runs_longer_than_the_rate_match_host():
    port, jax_t = BasicTranscript(b"m2vec"), JaxBasicTranscript(b"m2vec")
    dt = DeviceTranscript.from_host(port.clone(), "cpu")
    dt.append_message(LONG_LABEL)  # more chunks than one sponge call takes
    dt.append_constants(list(range(1, 40)))
    for t in (port, jax_t):
        t.append_message(LONG_LABEL)
        for v in range(1, 40):
            t.append_field_element(v)
    labels = (b"initial_batching", b"initial_alpha", b"initial_lambda")
    got = gf.ext_to_pairs(dt.step(labels=tuple(label_chunks(lbl) for lbl in labels), k=len(labels)))
    assert got == [port.get_and_append_challenge(lbl) for lbl in labels]
    assert got == [tuple(int(v) for v in jax_t.get_and_append_challenge(lbl)) for lbl in labels]
    got = dt.challenges_to_host(b"query indices", 5)
    assert got == [port.get_and_append_challenge(b"query indices") for _ in range(5)]
    assert dt.pulls == 1


@pytest.mark.parametrize("absorbed", [0, 1, 3, 4, 6])
def test_export_import_round_trip(absorbed):
    t = BasicTranscript(b"m2vec")
    for v in range(absorbed):
        t.append_field_element(v + 11)
    if absorbed == 6:
        t.read_challenge()  # a half-used output buffer
    state = devt.export_state(t.challenger, "cpu")
    assert state.shape == (devt.STATE_WORDS,) and state.dtype == torch.int64
    ch = DuplexChallenger()
    devt.import_state(ch, state)
    assert np.array_equal(ch.state, t.challenger.state)
    assert ch.input_buffer == t.challenger.input_buffer
    assert ch.output_buffer == t.challenger.output_buffer
    # a session continues exactly where the host stood, and hands its state back
    dt = DeviceTranscript(state)
    got = gf.ext_to_pairs(dt.read_challenges(3))
    host = BasicTranscript(b"x")
    dt.sync_to_host(host)
    assert got == [t.read_challenge() for _ in range(3)]
    assert host.read_challenge() == t.read_challenge()


def test_plain_sponge_refuses_a_device_state_and_the_kernel_a_cpu_one():
    state = torch.zeros(devt.STATE_WORDS, dtype=torch.int64)
    with pytest.raises(ValueError):
        devt.sponge_cuda(state, k=1)
    with pytest.raises(ValueError):
        devt.sponge_plain(torch.zeros(devt.STATE_WORDS, dtype=torch.int64, device="meta"), k=1)

