"""Linear-algebra ops, the ``mx.nd.linalg`` namespace (counterpart of
``mxnet_tpu/ops/linalg_ops.py``): ``gemm``/``gemm2``, ``potrf``/``potri``
(Cholesky), ``trsm``/``trmm``, ``syrk``, ``gelqf`` (LQ), ``syevd``,
``sumlogdiag``, ``extractdiag``, ``makediag``, ``extracttrian``,
``inverse``, ``det`` and ``slogdet``, each registered as ``_linalg_<name>``
and batched over leading dims, in ``torch.linalg``.

``gelqf``'s factors and ``syevd``'s eigenvectors are unique only up to
the sign of each row: LAPACK (the CPU in both packages) and cuSOLVER (the
card) may choose differently.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = []


def _t(x):
    return x.transpose(-1, -2)


def _ab(attrs, A, B):
    return (_t(A) if attrs.get("transpose_a", False) else A,
            _t(B) if attrs.get("transpose_b", False) else B)


@register("_linalg_gemm")
def _linalg_gemm(attrs, A, B, C):
    """alpha op(A) op(B) + beta C."""
    a, b = _ab(attrs, A, B)
    return float(attrs.get("alpha", 1.0)) * torch.matmul(a, b) \
        + float(attrs.get("beta", 1.0)) * C


@register("_linalg_gemm2")
def _linalg_gemm2(attrs, A, B):
    a, b = _ab(attrs, A, B)
    return float(attrs.get("alpha", 1.0)) * torch.matmul(a, b)


@register("_linalg_potrf")
def _linalg_potrf(attrs, A):
    return torch.linalg.cholesky(A)


@register("_linalg_potri")
def _linalg_potri(attrs, A):
    """(L L^T)^-1 from the Cholesky factor L."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(
        A.shape)
    linv = torch.linalg.solve_triangular(A, eye, upper=False)
    return torch.matmul(_t(linv), linv)


@register("_linalg_trsm")
def _linalg_trsm(attrs, A, B):
    """X with op(A) X = alpha B, or X op(A) = alpha B (``rightside``),
    A triangular (``lower``), op transposing it (``transpose``)."""
    transpose = bool(attrs.get("transpose", False))
    lower = bool(attrs.get("lower", True))
    alpha = float(attrs.get("alpha", 1.0))
    if bool(attrs.get("rightside", False)):
        # X A = alpha B  <=>  A^T X^T = alpha B^T
        A, B, lower = _t(A), _t(B), not lower
        X = _solve(A, B * alpha, lower, transpose)
        return _t(X)
    return _solve(A, B * alpha, lower, transpose)


def _solve(A, B, lower, transpose):
    if transpose:
        A, lower = _t(A), not lower
    return torch.linalg.solve_triangular(A, B, upper=not lower)


@register("_linalg_trmm")
def _linalg_trmm(attrs, A, B):
    lower = bool(attrs.get("lower", True))
    tri = torch.tril(A) if lower else torch.triu(A)
    if bool(attrs.get("transpose", False)):
        tri = _t(tri)
    alpha = float(attrs.get("alpha", 1.0))
    if bool(attrs.get("rightside", False)):
        return alpha * torch.matmul(B, tri)
    return alpha * torch.matmul(tri, B)


@register("_linalg_syrk")
def _linalg_syrk(attrs, A):
    alpha = float(attrs.get("alpha", 1.0))
    if bool(attrs.get("transpose", False)):
        return alpha * torch.matmul(_t(A), A)
    return alpha * torch.matmul(A, _t(A))


@register("_linalg_gelqf", num_outputs=2)
def _linalg_gelqf(attrs, A):
    """A = L Q, from the QR factorization of A^T: L = R^T, Q = Q^T."""
    q, r = torch.linalg.qr(_t(A))
    return _t(r), _t(q)


@register("_linalg_syevd", num_outputs=2)
def _linalg_syevd(attrs, A):
    """(U, w): the eigenvectors as the rows of U, eigenvalues ascending."""
    w, v = torch.linalg.eigh(A)
    return _t(v), w


@register("_linalg_sumlogdiag")
def _linalg_sumlogdiag(attrs, A):
    return torch.sum(torch.log(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)


@register("_linalg_extractdiag")
def _linalg_extractdiag(attrs, A):
    return torch.diagonal(A, dim1=-2, dim2=-1)


@register("_linalg_makediag")
def _linalg_makediag(attrs, d):
    return torch.diag_embed(d)


@register("_linalg_extracttrian")
def _linalg_extracttrian(attrs, A):
    """The lower (``lower``) or upper triangle from diagonal ``offset``,
    row by row, as a vector."""
    lower = bool(attrs.get("lower", True))
    offset = int(attrs.get("offset", 0))
    n = A.shape[-1]
    pairs = [(i, j) for i in range(n) for j in range(n)
             if (j <= i + offset if lower else j >= i + offset)]
    rows = torch.tensor([i for i, _ in pairs], dtype=torch.long,
                        device=A.device)
    cols = torch.tensor([j for _, j in pairs], dtype=torch.long,
                        device=A.device)
    return A[..., rows, cols]


@register("_linalg_inverse")
def _linalg_inverse(attrs, A):
    return torch.linalg.inv(A)


@register("_linalg_det")
def _linalg_det(attrs, A):
    return torch.linalg.det(A)


@register("_linalg_slogdet", num_outputs=2)
def _linalg_slogdet(attrs, A):
    sign, logdet = torch.linalg.slogdet(A)
    return sign, logdet
