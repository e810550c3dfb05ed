"""The port stands alone: `deepprove_tpu_torch` and `chip_smoke.py` import
neither jax nor the JAX package, and the entry points run on the card
unless the caller asks for the CPU."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "deepprove_tpu_torch")

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|deepprove_tpu)(?:[.\s]|$)", re.M)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import deepprove_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'deepprove_tpu' or m.startswith('deepprove_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('deepprove_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 20


@pytest.mark.parametrize(
    "module", ["deepprove_tpu_torch.kernels", "deepprove_tpu_torch.transcript.device",
               "deepprove_tpu_torch.sumcheck.fused", "deepprove_tpu_torch.zkml.layers.add",
               "deepprove_tpu_torch.zkml.layers.pad", "deepprove_tpu_torch.zkml.layers.matmul",
               "deepprove_tpu_torch.zkml.layers.layernorm", "deepprove_tpu_torch.zkml.layers.embeddings",
               "deepprove_tpu_torch.zkml.llm", "deepprove_tpu_torch.zkml.layers.qkv",
               "deepprove_tpu_torch.zkml.layers.concat_matmul", "deepprove_tpu_torch.zkml.layers.softmax",
               "deepprove_tpu_torch.zkml.layers.logits"],
)
def test_the_walk_reaches_the_device_transcript_and_fused_sumcheck(module):
    """The module walk above covers the kernel modules of the device-resident
    transcript and the fused sumcheck, and the residual, transformer and
    attention layers."""
    import pkgutil

    import deepprove_tpu_torch as p

    assert module in {m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")}


def test_sources_do_not_import_jax_or_the_jax_package():
    # chip_smoke.py also imports tests/torch_reference.py (the frozen JAX proofs)
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tests", "torch_reference.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if _IMPORT.search(open(f).read())]
    assert not offenders


def _entry_points():
    from deepprove_tpu_torch.transcript import BasicTranscript
    from deepprove_tpu_torch.api import prove_model, prove_onnx
    from deepprove_tpu_torch.zkml import llm
    from deepprove_tpu_torch.zkml.convert import (dense_chain_from_arrays, mlp_chain_from_arrays, model_from_graph,
                                                  model_from_layers)
    from deepprove_tpu_torch.zkml.layers.layernorm import LayerNorm
    from deepprove_tpu_torch.zkml.float_model import FDense, FloatModel, quantize
    from deepprove_tpu_torch.zkml.iop import IO, Context, Prover, verify
    from deepprove_tpu_torch.zkml.tensor import Tensor

    layers = [(np.ones((2, 2), dtype=np.int64), np.zeros(2, dtype=np.int64))]
    model = dense_chain_from_arrays(layers, device="cpu")
    ctx = Context.generate(model, device="cpu", num_queries=2, basecode_msg_size_log=1)
    x = Tensor(torch.ones(2, dtype=torch.int64))
    fm = FloatModel(input_shape=(2,)).add(FDense(weight=np.ones((2, 2)), bias=np.zeros(2)))
    return {
        "convert": lambda: dense_chain_from_arrays(layers),
        "convert_mlp": lambda: mlp_chain_from_arrays(layers),
        "Model.run": lambda: model.run([x]),
        "Context.generate": lambda: Context.generate(model),
        "Prover": lambda: Prover(ctx, BasicTranscript(b"m2vec")),
        "verify": lambda: verify(ctx, None, IO([x], [x]), BasicTranscript(b"m2vec")),
        "convert_layers": lambda: model_from_layers([("relu", {})]),
        "quantize": lambda: quantize(fm),
        "api.prove_model": lambda: prove_model(model, [x]),
        "api.prove_onnx": lambda: prove_onnx("model.onnx", [np.zeros(2)]),
        "convert_graph": lambda: model_from_graph([("add", {}, [(None, 0), (None, 0)])]),
        "LayerNorm.from_float": lambda: LayerNorm.from_float(np.ones(2), np.zeros(2), 1e-5, 0.1),
        "GPT2Builder": lambda: llm.GPT2Builder(
            llm.GPT2Weights.synthetic(llm.LLMConfig(vocab=4, emb=2, heads=1, blocks=1, context=2)), 2),
    }


@pytest.mark.parametrize(
    "name",
    ["convert", "convert_mlp", "Model.run", "Context.generate", "Prover", "verify", "convert_layers",
     "quantize", "api.prove_model", "api.prove_onnx", "convert_graph", "LayerNorm.from_float", "GPT2Builder"],
)
def test_entry_point_without_a_card_raises(monkeypatch, name):
    call = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_chip_smoke_without_a_card_exits_nonzero_and_prints_no_result():
    code = (
        "import torch, runpy, sys\n"
        "torch.cuda.is_available = lambda: False\n"
        "sys.argv = ['chip_smoke.py']\n"
        "runpy.run_path('chip_smoke.py', run_name='__main__')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
