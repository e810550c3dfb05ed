"""Freeze the JAX package's outputs that the PyTorch port is held against.

Proving with the JAX package on the CPU takes minutes per call (XLA
compiles every shape), far beyond what the `tests/test_torch_*` files may
spend. So this script computes them once, on the seeded numpy inputs of
`torch_reference.py`, and writes `torch_reference.json`; the tests and
`chip_smoke.py` compare the port's outputs with it field for field.
`tests/test_torch_reference.py` recomputes the whole file with the JAX
package and checks that it is unchanged (`-m jax_reference`), and the
sumcheck, the cheapest part, is recomputed live by
`test_torch_sumcheck.py`. Regenerate after any change to those inputs:

    JAX_PLATFORMS=cpu python tests/make_torch_reference.py
"""

from __future__ import annotations

import json
import os
import sys

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import torch_reference as R  # noqa: E402
from deepprove_tpu.fields import gf, host  # noqa: E402
from deepprove_tpu.pcs import basefold  # noqa: E402
from deepprove_tpu.sumcheck import VirtualPolynomial, prove  # noqa: E402
from deepprove_tpu.transcript import BasicTranscript  # noqa: E402
from deepprove_tpu.zkml.iop import Context, Prover, verify  # noqa: E402
from deepprove_tpu.zkml.iop.verifier import IO  # noqa: E402
from deepprove_tpu.zkml.layers.dense import Dense  # noqa: E402
from deepprove_tpu.zkml.model import Model  # noqa: E402
from deepprove_tpu.zkml.tensor import Tensor  # noqa: E402


def sumcheck_reference() -> dict:
    a, b, (c0, c1) = R.sumcheck_inputs()
    vp = VirtualPolynomial.new(R.SUMCHECK_NUM_VARS)
    vp.add_mle(gf.from_u64(a))
    vp.add_mle(gf.from_u64(b))
    vp.add_mle(gf.ext_from_u64(c0, c1))
    for coeff, factors in R.SUMCHECK_PRODUCTS:
        vp.add_product(coeff, factors)
    o = prove(vp, BasicTranscript(R.SUMCHECK_LABEL))
    return R.plain({"proof": o.proof, "final_evals": o.final_evals})


def basefold_reference(name: str) -> dict:
    """Commit and open one of the two polys of `R.basefold_inputs` ("rs", "trivial")."""
    big, big_pt, small, small_pt = R.basefold_inputs()
    evals, pt = (big, big_pt) if name == "rs" else (small, small_pt)
    params = basefold.setup(R.BASEFOLD_MAX_LOG, **R.BASEFOLD_KW)
    comm = basefold.commit(params, gf.from_u64(evals))
    proof = basefold.open(params, comm, pt, BasicTranscript(R.BASEFOLD_LABEL))
    basefold.verify(
        params, comm.commitment, pt, host.mle_eval_v(evals, pt), proof,
        BasicTranscript(R.BASEFOLD_LABEL),
    )
    return {"root": R.plain(comm.commitment.root), "proof": R.plain(proof)}


def dense_reference() -> dict:
    layers, x_np = R.dense_inputs()
    model = Model()
    for w, bias in layers:
        model.add_chain(Dense(matrix=w, bias=bias))
    x = Tensor(x_np)
    trace = model.run([x])
    ctx = Context.generate(model, **R.DENSE_KW)
    proof = Prover(ctx, BasicTranscript(b"m2vec")).prove(trace)
    verify(ctx, proof, IO([x], trace.outputs), BasicTranscript(b"m2vec"))
    assert not proof.table_proofs and not proof.merges and not proof.shared_logup
    return {
        "output": R.plain(trace.outputs[0].data),
        "proof": {"steps": R.plain(proof.steps), "commit": R.plain(proof.commit)},
    }


def generate() -> dict:
    return {
        "sumcheck": sumcheck_reference(),
        "basefold": {name: basefold_reference(name) for name in ("rs", "trivial")},
        "dense": dense_reference(),
    }


if __name__ == "__main__":
    ref = generate()
    with open(R.REFERENCE_PATH, "w") as f:
        json.dump(ref, f, separators=(",", ":"))
    print(f"wrote {R.REFERENCE_PATH} ({os.path.getsize(R.REFERENCE_PATH)} bytes)")
