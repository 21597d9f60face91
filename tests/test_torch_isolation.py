"""mxnet_tpu_torch never loads JAX, the JAX package or ``ml_dtypes``.

The port shares a name prefix with ``mxnet_tpu``, so module names are
matched exactly (``mxnet_tpu`` or ``mxnet_tpu.*``), never by prefix.  The
port reads the JAX package's bfloat16 arrays by their dtype's name, so it
needs no ``ml_dtypes`` (the card's machine does not have it).
"""
import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "mxnet_tpu_torch")


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "mxnet_tpu", "ml_dtypes")


def _imports(path):
    """Every module name a Python file imports (absolute imports only)."""
    tree = ast.parse(open(path).read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def _package_files():
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_forbidden_matches_exact_package_not_prefix():
    assert _forbidden("mxnet_tpu") and _forbidden("mxnet_tpu.ops")
    assert _forbidden("jax.numpy") and _forbidden("ml_dtypes")
    assert not _forbidden("mxnet_tpu_torch.ops")


def test_chip_smoke_imports_no_jax():
    found = [m for m in _imports(os.path.join(REPO, "chip_smoke.py"))
             if _forbidden(m)]
    assert found == []


def test_package_source_imports_no_jax():
    files = list(_package_files())
    assert len(files) >= 15
    found = {f: [m for m in _imports(f) if _forbidden(m)] for f in files}
    assert {f: m for f, m in found.items() if m} == {}


def test_nd_without_cuda_or_a_cpu_scope_raises(monkeypatch):
    """Without ``ctx`` an NDArray is made on ``cuda:0``: with CUDA hidden
    it raises, and only ``ctx=mx.cpu()`` or ``with mx.cpu():`` gives the
    CPU."""
    import torch

    import mxnet_tpu_torch as mx

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: mx.nd.ones((2, 2)), lambda: mx.nd.array([1.0]),
                 lambda: mx.nd.zeros(3, ctx=mx.gpu(0))):
        try:
            make()
        except mx.MXNetError as e:
            assert "no CUDA device" in str(e)
        else:
            raise AssertionError("made an NDArray without CUDA")
    assert mx.nd.ones((2, 2), ctx=mx.cpu()).context == torch.device("cpu")
    with mx.cpu():
        assert mx.nd.ones((2, 2)).context == torch.device("cpu")


def test_import_build_and_serve_load_no_jax_module():
    code = r"""
import sys
import numpy as np
import torch
import mxnet_tpu_torch
from mxnet_tpu_torch import initializer, serving
from mxnet_tpu_torch.models import TransformerLM
net = TransformerLM(16, dim=32, heads=2, depth=1, max_len=16, device="cpu")
mxnet_tpu_torch.random.seed(0)
net.initialize(initializer.Xavier())
zeros = torch.zeros((1, 8), dtype=torch.int32)
net(zeros, zeros)
server = serving.ModelServer()
server.load_model("lm", net, input_shapes=[((8,), (8,))],
                  dtype=("int32", "int32"), max_batch=2, device="cpu")
res = server.predict("lm", (np.zeros(8, np.int32), np.arange(8, dtype=np.int32)),
                     timeout_ms=10000)
server.stop()
assert res.status == "OK", res
# the saved-model path: the graph over both inputs, its files, served
import tempfile
with tempfile.TemporaryDirectory() as tmp:
    sym = mxnet_tpu_torch.sym
    net(sym.var("data"), sym.var("pos_idx")).save(tmp + "/lm-symbol.json")
    net.collect_params().save(tmp + "/lm-0000.params")
    server = serving.ModelServer()
    server.load_exported("lm", tmp + "/lm", input_names=("data", "pos_idx"),
                         input_shapes=[((8,), (8,))],
                         dtype=("int32", "int32"), max_batch=2,
                         device="cpu")
    exported = server.predict("lm", (np.zeros(8, np.int32),
                                     np.arange(8, dtype=np.int32)),
                              timeout_ms=10000)
    server.stop()
assert exported.status == "OK", exported
assert np.array_equal(exported.output, res.output)
# bf16: cast, a multi-precision step and a state file
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.models import image_classification
net.cast("bfloat16")
trainer = gluon.Trainer(net.named_parameters(), "adam",
                        {"multi_precision": True})
trainer.step(1)
trainer._updater.set_states(trainer._updater.get_states())
# the imperative API: an op, recorded, and its backward
from mxnet_tpu_torch import nd, autograd
x = nd.array(np.ones((2, 3), np.float32), ctx=mxnet_tpu_torch.cpu())
x.attach_grad()
with autograd.record():
    y = nd.FullyConnected(x, nd.ones((4, 3), ctx="cpu"), no_bias=True).sum()
y.backward()
assert x.grad.asnumpy().tolist() == [[4.0] * 3] * 2
# the decode engine, with the runtime modules it loads
from mxnet_tpu_torch import faults, memory_accounting, profiler
from mxnet_tpu_torch.serving.decode import DecodeEngine, TinyCausalLM
engine = DecodeEngine(TinyCausalLM(vocab_size=16, hidden=16, num_layers=1,
                                   max_len=32, device="cpu"),
                      max_slots=2, block_size=4, max_prompt_len=4,
                      max_new_tokens=4, warmup=False)
assert engine.generate([1, 2], max_new_tokens=3).status == "OK"
engine.stop()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu", "ml_dtypes"))
print("FORBIDDEN", bad)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout, out.stdout
