"""The numerical scheme of the port's CUDA flash-attention kernel, on the CPU.

``mxnet_tpu_torch/csrc/flash_attention.cu`` computes its products on the
tensor cores in TF32 (10-bit mantissa), three passes per product from a
(big, small) split of each fp32 operand (big rounded to TF32 to nearest;
small = x - big, of which the tensor core reads the top 19 bits), with an
fp32 online softmax over 64-key tiles and the keys of each 8-key step
permuted in P V so that P's ``m16n8k8`` A fragment is the S accumulator as
it lies.  The kernel runs only
on the card; here its arithmetic is emulated in plain PyTorch and held to
the JAX package's dense reference and to the port's plain version on the
same seeded numpy inputs, at the fp32 bound (2e-5) the kernel is held to.
A single TF32 pass is shown to miss that bound, which is why three are
needed.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas_ops import _attention_reference as jax_reference
from mxnet_tpu_torch.ops.cuda_ops import (_attention_reference,
                                          _causal_offset)

BOUND = 2e-5    # the kernel's fp32 bound (tests/test_pallas.py)
BK = 64         # keys per tile
MASKED = -1e30  # the TPU kernel's mask value
LOG2E = 1.4426950408889634


def rna_tf32(x):
    """fp32 -> TF32 by round to nearest, ties away from zero (PTX
    ``cvt.rna.tf32.f32``): add half of the 13 dropped mantissa bits to the
    magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def trunc_tf32(x):
    """What the tensor core reads of an fp32 register given as TF32: the
    top 19 bits, the 13 low mantissa bits dropped (toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x):
    """x = big + small as the kernel splits it: big = rna_tf32(x), and
    small = x - big (exact in fp32) as the tensor core reads it."""
    big = rna_tf32(x)
    return big, trunc_tf32(x - big)


def mma3(a, b):
    """a @ b at fp32 accuracy from TF32 halves, one k8 step at a time:
    big*big + big*small + small*big, small*small dropped, each pass added
    to an fp32 accumulator (products of two TF32 values are exact in
    fp32)."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        ab, as_ = split(a[..., k0:k0 + 8])
        bb, bs = split(b[..., k0:k0 + 8, :])
        acc = acc + as_ @ bb
        acc = acc + ab @ bs
        acc = acc + ab @ bb
    return acc


def mma1(a, b):
    """a @ b from a single TF32 pass."""
    return rna_tf32(a) @ rna_tf32(b)


def key_permutation():
    """The k-index -> key order of one 8-key step of P V, derived from the
    m16n8k8 fragment layouts (g = lane / 4, t = lane % 4).  The S
    accumulator leaves lane (g, t) holding c0 = P[g][2t], c1 = P[g][2t+1],
    c2 = P[g+8][2t], c3 = P[g+8][2t+1]; the kernel passes them as the A
    fragment a0 = c0, a1 = c2, a2 = c1, a3 = c3, where A's registers sit at
    a0 = (g, t), a1 = (g+8, t), a2 = (g, t+4), a3 = (g+8, t+4)."""
    perm = [None] * 8
    for lane in range(32):
        g, t = lane // 4, lane % 4
        c_key = {0: 2 * t, 1: 2 * t + 1, 2: 2 * t, 3: 2 * t + 1}
        c_row = {0: g, 1: g, 2: g + 8, 3: g + 8}
        for a_reg, c_reg, (row, kidx) in ((0, 0, (g, t)), (1, 2, (g + 8, t)),
                                          (2, 1, (g, t + 4)),
                                          (3, 3, (g + 8, t + 4))):
            assert c_row[c_reg] == row, (lane, a_reg)
            assert perm[kidx] in (None, c_key[c_reg])
            perm[kidx] = c_key[c_reg]
    return perm


def emulate_kernel(q, k, v, causal, scale, product=mma3):
    """The kernel's arithmetic: q pre-scaled, S per 64-key tile, masked
    scores set to -1e30, online softmax in fp32 with exp2, P V per 8-key
    step with the keys permuted, division by the row sum at the end."""
    B, H, T, D = q.shape
    Tk = k.shape[2]
    off = _causal_offset(causal, T, Tk)
    qs = q * scale
    perm = key_permutation()
    m = torch.full((B, H, T, 1), MASKED)
    l = torch.zeros((B, H, T, 1))
    acc = torch.zeros((B, H, T, D))
    rows = torch.arange(T)[:, None]
    for k0 in range(0, Tk, BK):
        kt = torch.zeros((B, H, BK, D))
        vt = torch.zeros((B, H, BK, D))
        n = min(BK, Tk - k0)
        kt[:, :, :n], vt[:, :, :n] = k[:, :, k0:k0 + n], v[:, :, k0:k0 + n]
        s = product(qs, kt.transpose(-1, -2))
        keys = k0 + torch.arange(BK)[None, :]
        keep = keys < Tk
        if causal:
            keep = keep & (keys <= rows + off)
        s = torch.where(keep, s, torch.tensor(MASKED))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2((s - m_new) * LOG2E)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        for j0 in range(0, BK, 8):
            idx = [j0 + kk for kk in perm]
            acc = acc + product(p[..., idx], vt[:, :, idx])
        m = m_new
    return acc / l


def _qkv(seed, B, H, T, Tk, D):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1, (B, H, T, D)).astype(np.float32),
            rng.normal(0, 1, (B, H, Tk, D)).astype(np.float32),
            rng.normal(0, 1, (B, H, Tk, D)).astype(np.float32))


CASES = [((1, 2, 256, 256, 64), False), ((1, 2, 256, 256, 64), True),
         ((1, 2, 100, 200, 64), "bottom")]


def test_key_permutation_is_the_in_step_interleave():
    assert key_permutation() == [0, 2, 4, 6, 1, 3, 5, 7]


def test_rna_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -11 - 2 ** -23,
                      -(1.0 + 3 * 2 ** -11), 3.0])
    assert rna_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0,
                                    -(1.0 + 2 * 2 ** -10), 3.0]
    # big + small keeps 21 of the 24 bits: relative error below 2^-21
    x = np.float32(np.pi)
    big, small = split(torch.tensor([x]))
    assert abs(float(big + small) - x) < 2 ** -21 * x


@pytest.mark.parametrize("shape,causal", CASES)
def test_three_tf32_passes_match_both_references(shape, causal):
    q, k, v = _qkv(11, *shape)
    scale = 1.0 / np.sqrt(shape[-1])
    out = emulate_kernel(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                         scale).numpy()
    ref_jax = np.asarray(jax_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                       causal, scale))
    ref_port = _attention_reference(*(torch.from_numpy(a)
                                      for a in (q, k, v)),
                                    causal, scale).numpy()
    assert out.shape == ref_jax.shape == ref_port.shape
    assert np.abs(out - ref_jax).max() < BOUND
    assert np.abs(out - ref_port).max() < BOUND


def test_one_tf32_pass_misses_the_bound():
    shape, causal = CASES[1]
    q, k, v = _qkv(11, *shape)
    scale = 1.0 / np.sqrt(shape[-1])
    out = emulate_kernel(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                         scale, product=mma1).numpy()
    ref = np.asarray(jax_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                   causal, scale))
    assert np.abs(out - ref).max() > 10 * BOUND
