"""mxnet_tpu_torch flash attention against the JAX package's kernel.

The port's ``flash_attention`` runs its plain version on CPU tensors; here
it is held to the JAX Pallas kernel run in interpret mode (as
tests/test_pallas.py runs it) and to the JAX dense reference, on the same
seeded numpy inputs, at the bounds test_pallas.py pins (2e-5 in fp32).
The CUDA kernel itself runs only on the card (chip_smoke.py).
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas_ops import (_attention_reference as jax_reference,
                                      _flash_attention_pallas)
from mxnet_tpu_torch import MXNetError, context
from mxnet_tpu_torch.ops import cuda_ops
from mxnet_tpu_torch.ops.cuda_ops import flash_attention

BOUND = 2e-5   # tests/test_pallas.py: fp32 kernel vs dense reference


def _qkv(seed, B, H, T, Tk, D):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1, (B, H, T, D)).astype(np.float32),
            rng.normal(0, 1, (B, H, Tk, D)).astype(np.float32),
            rng.normal(0, 1, (B, H, Tk, D)).astype(np.float32))


def _port(q, k, v, causal):
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal)
    return out.numpy()


def _jax(q, k, v, causal, pallas):
    scale = 1.0 / np.sqrt(q.shape[-1])
    args = [jnp.asarray(a) for a in (q, k, v)]
    if pallas:
        return np.asarray(_flash_attention_pallas(*args, causal, scale,
                                                  interpret=True))
    return np.asarray(jax_reference(*args, causal, scale))


@pytest.mark.parametrize("causal", [False, True])
def test_matches_jax_kernel_and_reference(causal):
    q, k, v = _qkv(0, 2, 2, 256, 256, 64)
    out = _port(q, k, v, causal)
    assert out.shape == (2, 2, 256, 64)
    assert np.abs(out - _jax(q, k, v, causal, pallas=True)).max() < BOUND
    assert np.abs(out - _jax(q, k, v, causal, pallas=False)).max() < BOUND


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,Tk", [(200, 200), (130, 130), (100, 100),
                                  (160, 224)])
def test_ragged_lengths_match_jax_kernel(causal, T, Tk):
    if causal and T != Tk:
        causal = "bottom"   # bare True is ambiguous for mismatched lengths
    q, k, v = _qkv(3, 1, 2, T, Tk, 32)
    out = _port(q, k, v, causal)
    assert out.shape == (1, 2, T, 32)
    assert np.abs(out - _jax(q, k, v, causal, pallas=True)).max() < BOUND


@pytest.mark.parametrize("align", ["top", "bottom"])
def test_causal_alignment_matches_jax(align):
    q, k, v = _qkv(4, 1, 2, 96, 224, 32)
    out = _port(q, k, v, align)
    assert np.abs(out - _jax(q, k, v, align, pallas=False)).max() < BOUND


def test_decode_bottom_equals_non_causal():
    """T=1 against a long key set: 'bottom' sees every key."""
    q, k, v = _qkv(5, 1, 2, 1, 200, 32)
    out = _port(q, k, v, "bottom")
    assert out.shape == (1, 2, 1, 32)
    assert np.abs(out - _port(q, k, v, False)).max() < BOUND
    assert np.abs(out - _jax(q, k, v, "bottom", pallas=True)).max() < BOUND


@pytest.mark.parametrize("D", [16, 32])
def test_small_head_dims_match_jax_kernel(D):
    q, k, v = _qkv(6, 1, 2, 128, 128, D)
    out = _port(q, k, v, True)
    assert np.abs(out - _jax(q, k, v, True, pallas=True)).max() < BOUND


def test_explicit_scale_matches_jax():
    q, k, v = _qkv(7, 1, 1, 64, 64, 16)
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True, scale=0.5).numpy()
    ref = np.asarray(jax_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                   True, 0.5))
    assert np.abs(out - ref).max() < BOUND


@pytest.mark.parametrize("causal,T,Tk,match", [
    (1, 16, 16, "causal must be"),
    ("left", 16, 16, "causal must be"),
    (True, 16, 32, "ambiguous"),
    ("bottom", 32, 16, "q length <= k length"),
])
def test_same_value_errors_as_jax_entry(causal, T, Tk, match):
    q = torch.zeros(1, 1, T, 16)
    k = torch.zeros(1, 1, Tk, 16)
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, k, causal=causal)


def test_cpu_tensor_takes_plain_version_without_launching():
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 1, 2, 40, 40, 16))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True)
    ref = cuda_ops._attention_reference(q, k, v, True, 0.25)
    assert torch.equal(out, ref)
    assert flash_attention.launches == before


def test_no_cuda_without_explicit_cpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="device='cpu'"):
        context.current_context()
    with pytest.raises(MXNetError, match="no CUDA device"):
        context.resolve_device(None)
    with pytest.raises(MXNetError, match="no CUDA device"):
        context.resolve_device("cuda:0")
    assert context.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(MXNetError, match="NVIDIA"):
        context.tpu()
    assert context.gpu(1) == torch.device("cuda", 1)


def test_other_devices_raise_instead_of_falling_back():
    q = torch.zeros(1, 1, 16, 16, device="meta")
    with pytest.raises(MXNetError, match="CUDA or CPU"):
        flash_attention(q, q, q, causal=True)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from mxnet_tpu_torch import _kernels
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_kernels, "_DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(MXNetError, match="nvcc not found"):
        _kernels._nvcc()
    assert _kernels._source("flash_attention").is_file()


def test_kernel_build_keeps_compiler_output(monkeypatch, tmp_path):
    """The build returns nvcc's output (ptxas -v) and keeps it beside the
    library, where build_log reads it."""
    from mxnet_tpu_torch import _kernels
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!%s\nimport sys\nargs = sys.argv\n"
        "open(args[args.index('-o') + 1], 'w').write('lib')\n"
        "print(\"ptxas info    : Used 42 registers\", ' '.join(args[1:]))\n"
        % sys.executable)
    fake.chmod(0o755)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_kernels, "_DEFAULT_NVCC", fake)
    monkeypatch.setattr(_kernels, "_BUILD_DIR", tmp_path / "build")
    lib = _kernels.library_path()
    out = _kernels._build(lib, "flash_attention")
    assert "Used 42 registers" in out and "-Xptxas -v" in out
    assert lib.read_text() == "lib"
    assert lib.with_suffix(".log").read_text() == out
    assert not [p for p in os.listdir(lib.parent) if ".tmp-" in p]


def test_each_source_builds_into_its_own_library(monkeypatch, tmp_path):
    """Each csrc/*.cu has its own library path, named by a hash of that
    source and the flags: editing one source moves its path alone, and
    changing the flags moves every path.  No build runs here."""
    import shutil

    from mxnet_tpu_torch import _kernels
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels._CSRC, csrc)
    monkeypatch.setattr(_kernels, "_CSRC", csrc)
    names = sorted(_kernels.SOURCES)
    assert names == ["flash_attention", "greedy_nms"]
    assert sorted(p.stem for p in csrc.glob("*.cu")) == names
    before = {n: _kernels.library_path(n) for n in names}
    assert len(set(before.values())) == len(names)
    for n in names:
        assert before[n].name.startswith("lib%s-" % n)
    with open(csrc / "greedy_nms.cu", "a") as f:
        f.write("// edited\n")
    after = {n: _kernels.library_path(n) for n in names}
    assert after["greedy_nms"] != before["greedy_nms"]
    assert after["flash_attention"] == before["flash_attention"]
    monkeypatch.setattr(_kernels, "_NVCC_FLAGS",
                        _kernels._NVCC_FLAGS + ["-lineinfo"])
    flagged = {n: _kernels.library_path(n) for n in names}
    assert all(flagged[n] != after[n] for n in names)
    with pytest.raises(MXNetError, match="no CUDA source"):
        _kernels.library_path("nope")
