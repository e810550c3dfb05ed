"""The frozen JAX outputs in torch_reference.json against the JAX package
itself: each part is recomputed by `make_torch_reference` from the same
seeded inputs and must equal the file. Many minutes on a CPU in all (XLA
compiles every shape of every JAX prove), so the tests run only when
selected:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_reference.py -m jax_reference
"""

import json

import pytest

import torch_reference as R

pytestmark = pytest.mark.jax_reference


def _recompute(part):
    import make_torch_reference as M

    if part.startswith("basefold_"):
        return M.basefold_reference(part.split("_")[1])
    if part.startswith("logup_"):
        return M.logup_reference(part.split("_", 1)[1])
    if part.startswith("cnn_"):
        return M.cnn_reference(part.split("_", 1)[1])
    if part.startswith("residual_"):
        return M.graph_reference(part.split("_", 1)[1], R.RESIDUAL_KW)
    if part.startswith("transformer_"):
        return M.graph_reference(part.split("_", 1)[1], R.TRANSFORMER_KW)
    if part.startswith("attention_"):
        return M.graph_reference(part.split("_", 1)[1], R.ATTENTION_KW)
    return M.PARTS[part]()


def _frozen(part):
    ref = R.load()
    if part.startswith("basefold_"):
        return ref["basefold"][part.split("_")[1]]
    if part.startswith("logup_"):
        return ref["logup"][part.split("_", 1)[1]]
    for group in ("cnn", "residual", "transformer", "attention"):
        if part.startswith(group + "_"):
            return ref[group][part.split("_", 1)[1]]
    return ref[part]


PARTS = ["sumcheck", "basefold_rs", "basefold_trivial", "basefold_batch", "dense"]
PARTS += [f"logup_{name}" for name in R.LOGUP_CASES] + ["mlp"]
PARTS += [f"cnn_{name}" for name in R.CNN_CASES]
PARTS += [f"residual_{name}" for name in R.RESIDUAL_CASES] + [f"transformer_{name}" for name in R.TRANSFORMER_CASES]
PARTS += [f"attention_{name}" for name in R.ATTENTION_FROZEN]


@pytest.mark.parametrize("part", PARTS)
def test_frozen_reference_equals_jax_package(request, part):
    if "jax_reference" not in (request.config.option.markexpr or ""):
        pytest.skip("recomputes the JAX package's proofs (minutes); select with -m jax_reference")
    # through JSON, as the file was written: tuples become lists
    assert json.loads(json.dumps(_recompute(part))) == _frozen(part)
