"""``paddle.linalg`` (the port of ``paddle_tpu/ops/linalg.py``) over
``torch.linalg`` (cuBLAS and cuSOLVER on the card).

``lu`` returns 0-based pivots, the reference's ``lu_factor`` convention,
which ``lu_unpack`` and ``lu_solve`` take (LAPACK's are 1-based).
Factorisations whose signs or pivots are not unique (``qr``, ``svd``,
``eigh``, ``eig``, ``lu``) agree with the reference up to those choices;
what they reconstruct agrees."""
from __future__ import annotations

import torch

from ..framework import random as prandom
from ._util import as_tensor, promote

__all__ = [
    "norm", "vector_norm", "matrix_norm", "dist", "inv", "pinv", "det",
    "slogdet", "cholesky", "cholesky_solve", "qr", "svd", "eig", "eigh",
    "eigvals", "eigvalsh", "matrix_power", "matrix_rank", "solve",
    "triangular_solve", "lstsq", "lu", "multi_dot", "cond", "cov",
    "corrcoef", "householder_product", "pca_lowrank", "matrix_exp", "ormqr",
    "lu_unpack", "matrix_transpose", "cholesky_inverse", "lu_solve",
    "vecdot", "svd_lowrank"]


def norm(x, p=None, axis=None, keepdim=False):
    """The 2-norm of the flattened tensor for ``axis=None``; the vector
    p-norm along an int ``axis``; the matrix norm (``"fro"`` by default)
    over a pair of axes."""
    x = as_tensor(x)
    if p is None:
        p = "fro" if axis is None or isinstance(axis, (list, tuple)) else 2
    if axis is None:
        return torch.linalg.vector_norm(x.reshape(-1),
                                        2 if p == "fro" else p)
    if isinstance(axis, (list, tuple)):
        return torch.linalg.matrix_norm(x, p, dim=tuple(axis),
                                        keepdim=keepdim)
    return torch.linalg.vector_norm(x, p, dim=axis, keepdim=keepdim)


vector_norm = norm


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False):
    return torch.linalg.matrix_norm(as_tensor(x), p, dim=tuple(axis),
                                    keepdim=keepdim)


def dist(x, y, p=2.0):
    x, y = promote(as_tensor(x), as_tensor(y))
    return torch.linalg.vector_norm((x - y).reshape(-1), p)


def inv(x):
    return torch.linalg.inv(as_tensor(x))


def pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(as_tensor(x), rtol=rcond, hermitian=hermitian)


def det(x):
    return torch.linalg.det(as_tensor(x))


def slogdet(x):
    """``[sign, log|det|]`` stacked, as the reference returns them."""
    s, logabs = torch.linalg.slogdet(as_tensor(x))
    return torch.stack([s, logabs])


def cholesky(x, upper=False):
    return torch.linalg.cholesky(as_tensor(x), upper=upper)


def cholesky_solve(x, y, upper=False):
    """Solve ``A z = x`` given ``y``, the Cholesky factor of A."""
    return torch.cholesky_solve(as_tensor(x), as_tensor(y), upper=upper)


def qr(x, mode="reduced"):
    """(Q, R); R alone for ``mode="r"``."""
    q, r = torch.linalg.qr(as_tensor(x), mode=mode)
    return r if mode == "r" else (q, r)


def svd(x, full_matrices=False):
    """(U, S, Vh)."""
    return tuple(torch.linalg.svd(as_tensor(x), full_matrices=full_matrices))


def eig(x):
    return tuple(torch.linalg.eig(as_tensor(x)))


def eigh(x, UPLO="L"):
    return tuple(torch.linalg.eigh(as_tensor(x), UPLO=UPLO))


def eigvals(x):
    return torch.linalg.eigvals(as_tensor(x))


def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(as_tensor(x), UPLO=UPLO)


def matrix_power(x, n):
    return torch.linalg.matrix_power(as_tensor(x), int(n))


def matrix_rank(x, tol=None, hermitian=False):
    """The rank, with ``tol`` relative to the largest singular value, as
    the reference reads it."""
    return torch.linalg.matrix_rank(as_tensor(x), rtol=tol,
                                    hermitian=hermitian)


def solve(x, y):
    return torch.linalg.solve(*promote(as_tensor(x), as_tensor(y)))


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    """Solve ``x z = y`` (``x^T z = y`` with ``transpose``) for a
    triangular ``x``."""
    a, b = promote(as_tensor(x), as_tensor(y))
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, b, upper=upper,
                                         unitriangular=unitriangular)


def lstsq(x, y, rcond=None, driver=None):
    """The least-squares solution, alone in a tuple (as the reference)."""
    a, b = promote(as_tensor(x), as_tensor(y))
    return (torch.linalg.lstsq(a, b, rcond=rcond, driver=driver).solution,)


def lu(x, pivot=True):
    """(packed LU, 0-based int32 pivots): row i was swapped with row
    pivots[i]."""
    lu_, piv = torch.linalg.lu_factor(as_tensor(x), pivot=pivot)
    return lu_, (piv - 1).to(torch.int32)


def multi_dot(tensors):
    return torch.linalg.multi_dot(list(promote(*tensors)))


def cond(x, p=None):
    return torch.linalg.cond(as_tensor(x), p)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    x = as_tensor(x)
    return torch.cov(x if rowvar else x.transpose(0, 1),
                     correction=1 if ddof else 0,
                     fweights=None if fweights is None else as_tensor(
                         fweights, x),
                     aweights=None if aweights is None else as_tensor(
                         aweights, x))


def corrcoef(x, rowvar=True):
    x = as_tensor(x)
    return torch.corrcoef(x if rowvar else x.transpose(0, 1))


def householder_product(x, tau):
    """The first n columns of H_0 ... H_{n-1} (LAPACK's orgqr)."""
    return torch.linalg.householder_product(*promote(as_tensor(x),
                                                     as_tensor(tau)))


def pca_lowrank(x, q=None, center=True, niter=2):
    """(U, S, V) of the centred ``x``'s first ``q`` (None: min(6, m, n))
    singular triplets, from a full SVD, as the reference computes them."""
    x = as_tensor(x)
    if center:
        x = x - x.mean(dim=-2, keepdim=True)
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    k = q or min(6, *x.shape[-2:])
    return u[..., :k], s[..., :k], vh.transpose(-1, -2)[..., :k]


def matrix_exp(x):
    return torch.linalg.matrix_exp(as_tensor(x))


def ormqr(x, tau, y, left=True, transpose=False):
    """Q (held in geqrf's reflectors ``x`` and ``tau``) applied to ``y``
    without forming it."""
    x, tau, y = promote(as_tensor(x), as_tensor(tau), as_tensor(y))
    return torch.ormqr(x, tau, y, left=left, transpose=transpose)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True):
    """(P, L, U) with ``A = P @ L @ U`` from :func:`lu`'s output (0-based
    pivots)."""
    return tuple(torch.lu_unpack(as_tensor(x), as_tensor(y).to(torch.int32)
                                 + 1, unpack_data=True,
                                 unpack_pivots=True))


def matrix_transpose(x, name=None):
    return as_tensor(x).transpose(-1, -2)


def cholesky_inverse(x, upper=False, name=None):
    return torch.cholesky_inverse(as_tensor(x), upper=upper)


def lu_solve(b, lu_data, lu_pivots, trans="N", name=None):
    """Solve ``A x = b`` (``A^T x = b`` for ``"T"``, ``A^H x = b`` for
    ``"C"``) from :func:`lu`'s factor and 0-based pivots."""
    if trans not in ("N", "T", "C"):
        raise ValueError(f"lu_solve: trans must be 'N', 'T' or 'C', "
                         f"got {trans!r}")
    lu_ = as_tensor(lu_data)
    if trans == "T" and lu_.is_complex():
        raise NotImplementedError("lu_solve: trans='T' of a complex factor")
    return torch.linalg.lu_solve(lu_, as_tensor(lu_pivots).to(torch.int32)
                                 + 1, as_tensor(b), adjoint=trans != "N")


def vecdot(x, y, axis=-1, name=None):
    """sum(conj(x) * y) along ``axis``, broadcasting the rest."""
    x, y = promote(as_tensor(x), as_tensor(y))
    return (torch.conj_physical(x) * y).sum(dim=axis)


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """A randomized rank-``q`` SVD by ``niter`` subspace iterations (Halko
    et al.), the reference's algorithm, the test matrix drawn from the
    device's generator: (U [m, q], S [q], V [n, q])."""
    a = as_tensor(x)
    b = a - as_tensor(M, a) if M is not None else a
    m, n = b.shape[-2], b.shape[-1]
    k = min(int(q), m, n)
    bt = b.transpose(-1, -2)
    omega = torch.randn(*b.shape[:-2], n, k, dtype=b.dtype, device=b.device,
                        generator=prandom.generator(b.device))
    y = b @ omega
    for _ in range(int(niter)):
        q_i, _ = torch.linalg.qr(y)
        y = b @ (bt @ q_i)
    qm, _ = torch.linalg.qr(y)
    ub, s, vt = torch.linalg.svd(qm.transpose(-1, -2) @ b,
                                 full_matrices=False)
    return qm @ ub, s, vt.transpose(-1, -2)
