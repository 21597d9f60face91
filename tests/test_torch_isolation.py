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


def test_import_build_and_serve_load_no_jax_module():
    code = r"""
import sys
import numpy as np
import torch
import mxnet_tpu_torch
from mxnet_tpu_torch import initializer, serving
from mxnet_tpu_torch.models import TransformerLM
net = TransformerLM(16, dim=32, heads=2, depth=1, max_len=16, device="cpu")
initializer.initialize(net, generator=torch.Generator().manual_seed(0))
server = serving.ModelServer()
server.load_model("lm", net, input_shapes=[((8,), (8,))],
                  dtype=("int32", "int32"), max_batch=2, device="cpu")
res = server.predict("lm", (np.zeros(8, np.int32), np.arange(8, dtype=np.int32)),
                     timeout_ms=10000)
server.stop()
assert res.status == "OK", res
# bf16: cast, a multi-precision step and a state file
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.models import image_classification
net.cast("bfloat16")
trainer = gluon.Trainer(net.named_parameters(), "adam",
                        {"multi_precision": True})
trainer.step(1)
trainer._updater.set_states(trainer._updater.get_states())
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu", "ml_dtypes"))
print("FORBIDDEN", bad)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout, out.stdout
