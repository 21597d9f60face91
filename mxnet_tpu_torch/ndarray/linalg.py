"""``mx.nd.linalg``: the ``_linalg_*`` ops under their short names
(counterpart of ``mxnet_tpu/ndarray/linalg.py``)."""
from __future__ import annotations

from .ndarray import invoke

__all__ = ["gemm", "gemm2", "potrf", "potri", "trsm", "trmm", "syrk", "gelqf",
           "syevd", "sumlogdiag", "extractdiag", "makediag", "inverse", "det",
           "slogdet"]


def gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0, beta=1.0, **kw):
    return invoke("_linalg_gemm", [A, B, C],
                  {"transpose_a": transpose_a, "transpose_b": transpose_b,
                   "alpha": alpha, "beta": beta})


def gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0, **kw):
    return invoke("_linalg_gemm2", [A, B],
                  {"transpose_a": transpose_a, "transpose_b": transpose_b,
                   "alpha": alpha})


def potrf(A, **kw):
    return invoke("_linalg_potrf", [A], {})


def potri(A, **kw):
    return invoke("_linalg_potri", [A], {})


def trsm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0, **kw):
    return invoke("_linalg_trsm", [A, B],
                  {"transpose": transpose, "rightside": rightside,
                   "lower": lower, "alpha": alpha})


def trmm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0, **kw):
    return invoke("_linalg_trmm", [A, B],
                  {"transpose": transpose, "rightside": rightside,
                   "lower": lower, "alpha": alpha})


def syrk(A, transpose=False, alpha=1.0, **kw):
    return invoke("_linalg_syrk", [A], {"transpose": transpose, "alpha": alpha})


def gelqf(A, **kw):
    return invoke("_linalg_gelqf", [A], {})


def syevd(A, **kw):
    return invoke("_linalg_syevd", [A], {})


def sumlogdiag(A, **kw):
    return invoke("_linalg_sumlogdiag", [A], {})


def extractdiag(A, **kw):
    return invoke("_linalg_extractdiag", [A], {})


def makediag(d, **kw):
    return invoke("_linalg_makediag", [d], {})


def inverse(A, **kw):
    return invoke("_linalg_inverse", [A], {})


def det(A, **kw):
    return invoke("_linalg_det", [A], {})


def slogdet(A, **kw):
    return invoke("_linalg_slogdet", [A], {})
