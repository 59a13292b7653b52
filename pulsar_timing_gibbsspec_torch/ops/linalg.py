"""Batched small-matrix linear algebra of the b-draw.

Port of ``pulsar_timing_gibbsspec_tpu/ops/linalg.py`` (main-path
subset), with the same recursion order: the blocked Cholesky with its
explicit inverse halves the matrix until 1x1/2x2 closed forms and
combines with batched matrix products, and every solve is then a
matrix-vector product with the inverse factor.  The block-grid Cholesky
factors the correlated-ORF joint draw's Schur complement block by
block.  All functions broadcast
over leading batch dimensions.  Float32 products are IEEE float32 (TF32
is off in the port, see ``config.resolve_device``).
"""

from __future__ import annotations

import torch


def _mm(a, b):
    """Batched matrix product."""
    return torch.matmul(a, b)


def _t(a):
    return a.transpose(-1, -2)


def _mv(a, v):
    """``einsum("...ij,...j->...i", a, v)``."""
    return torch.matmul(a, v.unsqueeze(-1)).squeeze(-1)


def _cholinv_rec(A):
    """Recursive batched ``(L, L^-1)`` of SPD ``A``.

    ``chol([[A11, .], [A21, A22]]) = [[L11, 0], [A21 L11^-T, chol(S)]]``
    with ``S = A22 - L21 L21^T``; the inverse combines as
    ``Linv21 = -L22inv L21 L11inv``.
    """
    n = A.shape[-1]
    if n == 1:
        L = torch.sqrt(A)
        return L, 1.0 / L
    if n == 2:
        a = torch.sqrt(A[..., 0, 0])
        b = A[..., 1, 0] / a
        c = torch.sqrt(A[..., 1, 1] - b * b)
        z = torch.zeros_like(a)
        L = torch.stack([torch.stack([a, z], -1),
                         torch.stack([b, c], -1)], -2)
        ia = 1.0 / a
        ic = 1.0 / c
        Li = torch.stack([torch.stack([ia, z], -1),
                          torch.stack([-b * ia * ic, ic], -1)], -2)
        return L, Li
    h = n // 2
    L11, I11 = _cholinv_rec(A[..., :h, :h])
    L21 = _mm(A[..., h:, :h], _t(I11))
    L22, I22 = _cholinv_rec(A[..., h:, h:] - _mm(L21, _t(L21)))
    I21 = -_mm(I22, _mm(L21, I11))
    zer = A.new_zeros(A.shape[:-2] + (h, n - h))
    L = torch.cat([torch.cat([L11, zer], -1),
                   torch.cat([L21, L22], -1)], -2)
    Li = torch.cat([torch.cat([I11, zer], -1),
                    torch.cat([I21, I22], -1)], -2)
    return L, Li


def blocked_chol_inv(A):
    """Batched lower Cholesky ``L`` of SPD ``A`` and ``L^-1``."""
    return _cholinv_rec(A)


def tf_mm(a, b, transpose_b=False):
    """Two-float (hi/lo float32 split) batched product of float64
    operands: the three significant float32 products recombined in
    float64; relative error ~sqrt(k)*eps_f32."""
    f32 = torch.float32
    dt = a.dtype
    ah = a.to(f32)
    al = (a - ah.to(dt)).to(f32)
    bh = b.to(f32)
    bl = (b - bh.to(dt)).to(f32)

    def mm32(u, v):
        return _mm(u, _t(v) if transpose_b else v)

    hh = mm32(ah, bh)
    cross = mm32(ah, bl) + mm32(al, bh)
    return hh.to(dt) + cross.to(dt)


def tf_chol_factor(A, ridge=4e-6):
    """Near-float64 factor of SPD unit-diagonal ``A`` from float32
    factorizations: ``L0 = chol_f32(A32 + ridge I)``, then the float32
    factor of the well-conditioned residual congruence
    ``R = Li0 A Li0^T`` (two-float products) corrects the ridge:
    ``Li = Lr^-1 Li0``, ``L = L0 Lr``.  Returns ``(L, Li)``."""
    f32 = torch.float32
    dt = A.dtype
    n = A.shape[-1]
    eye32 = torch.eye(n, dtype=f32, device=A.device)
    A32 = A.to(f32)
    L0, Li0 = _cholinv_rec(A32 + ridge * eye32)
    R = tf_mm(tf_mm(Li0.to(dt), A), Li0.to(dt), transpose_b=True)
    Lr, Lir = _cholinv_rec(R.to(f32))
    Li = tf_mm(Lir.to(dt), Li0.to(dt))
    L = tf_mm(L0.to(dt), Lr.to(dt))
    return L, Li


def _precondition(Sig, ridge):
    diag = torch.diagonal(Sig, dim1=-2, dim2=-1)
    dj = 1.0 / torch.sqrt(diag)
    A = Sig * dj[..., :, None] * dj[..., None, :]
    if ridge:
        A = A + ridge * torch.eye(A.shape[-1], dtype=A.dtype,
                                  device=A.device)
    return dj, A


def jacobi_factor_mean(Sig, d, factor=None, ridge=0.0):
    """``dj = 1/sqrt(diag Sig)``, ``(L, Li) = factor(D Sig D [+ ridge
    I])``, ``mean = Sig^-1 d = dj * Li^T (Li (dj d))``.  Returns
    ``(L, Li, dj, mean)``."""
    if factor is None:
        factor = blocked_chol_inv
    dj, A = _precondition(Sig, ridge)
    L, Li = factor(A)
    w = _mv(Li, dj * d)
    mean = dj * _mv(_t(Li), w)
    return L, Li, dj, mean


def jacobi_factor_mean_prop(Sig, d, z, factor=None, ridge=0.0):
    """:func:`jacobi_factor_mean` fused with the proposal draw: the mean
    and sample matvecs share ``Li^T`` as one 2-column product.  Returns
    ``(L, Li, dj, mean, bp)`` with ``bp = mean + dj * Li^T z``."""
    if factor is None:
        factor = blocked_chol_inv
    dj, A = _precondition(Sig, ridge)
    L, Li = factor(A)
    w = _mv(Li, dj * d)
    wz = torch.stack([w, z.to(w.dtype)], dim=-1)
    mz = _mm(_t(Li), wz)
    mean = dj * mz[..., 0]
    bp = mean + dj * mz[..., 1]
    return L, Li, dj, mean, bp


def _batched_diag(v):
    """diag embedding that broadcasts over leading batch dimensions."""
    return v[..., :, None] * torch.eye(v.shape[-1], dtype=v.dtype,
                                       device=v.device)


def mvn_conditional_draw(TNT, phiinv, d, z):
    """Mean ``Sigma^-1 d`` and a sample ``mean + Sigma^-1/2 z`` for
    ``Sigma = TNT + diag(phiinv)``.  Returns ``(b, mean)``."""
    Sigma = TNT + _batched_diag(phiinv)
    _, Li, dj, mean = jacobi_factor_mean(Sigma, d)
    samp = mean + dj * _mv(_t(Li), z)
    return samp, mean


# ---------------------------------------------------------------------------
# block-grid Cholesky: an SPD matrix as an m x m grid of P x P blocks
# ---------------------------------------------------------------------------
#
# The correlated-ORF joint b-draw's Schur complement on the common
# process's coordinates is a (2K, 2K) grid of (P, P) blocks.  Factoring it
# blockwise keeps every operation at the block size: m unrolled stages,
# each one diagonal-block factor and batched (P, P) products for the
# trailing update.  It is the Cholesky of the flattened matrix in the
# same coordinate order (block_grid_to_dense), so a sample drawn through
# either factor is the same up to rounding.

def _mm_t(a, b, transpose_b=False):
    """Batched product with :func:`tf_mm`'s calling convention, so the
    grid factor runs in float64 (this) or in two-float (``tf_mm``)."""
    return _mm(a, _t(b) if transpose_b else b)


def block_grid_cholinv(S, factor=None, mm=None):
    """Right-looking Cholesky of an SPD matrix laid out as an ``(..., m,
    m, P, P)`` grid of blocks (``S[..., i, j]`` block row ``i``, block
    column ``j``; ``S[i, j] == S[j, i]^T``).  Returns ``(Ld, Ldi, Loff)``:
    the lower diagonal blocks of the factor (..., m, P, P), their
    inverses, and the strictly lower off-diagonal blocks (..., m, m, P, P)
    (zeros elsewhere).  ``factor`` is the diagonal block's ``(L, L^-1)``
    (:func:`blocked_chol_inv`, or :func:`tf_chol_factor` in two-float),
    ``mm`` the matching product (:func:`_mm_t` / :func:`tf_mm`)."""
    if factor is None:
        factor = _cholinv_rec
    if mm is None:
        mm = _mm_t
    m = S.shape[-4]
    Ld, Ldi = [], []
    Loff = torch.zeros_like(S)
    T = S
    for g in range(m):
        Lg, Lgi = factor(T[..., 0, 0, :, :])
        Ld.append(Lg)
        Ldi.append(Lgi)
        if g == m - 1:
            break
        # column panel L[j, g] = T[j, 0] Lg^-T for every trailing j
        Lcol = mm(T[..., 1:, 0, :, :], Lgi[..., None, :, :],
                  transpose_b=True)
        Loff[..., g + 1:, g, :, :] = Lcol
        # trailing update, every (j, l) pair in one batched product
        upd = mm(Lcol[..., :, None, :, :], Lcol[..., None, :, :, :],
                 transpose_b=True)
        T = T[..., 1:, 1:, :, :] - upd
    return torch.stack(Ld, dim=-3), torch.stack(Ldi, dim=-3), Loff


def block_grid_solve_lower(Ldi, Loff, r):
    """``L v = r`` with the grid factor of :func:`block_grid_cholinv`;
    ``r`` (..., m, P) block-major.  Forward substitution by block stage,
    each stage's earlier blocks subtracted in one contraction."""
    m = r.shape[-2]
    vs = []
    for g in range(m):
        acc = r[..., g, :]
        if g:
            acc = acc - torch.einsum("...jik,...jk->...i",
                                     Loff[..., g, :g, :, :],
                                     torch.stack(vs, dim=-2))
        vs.append(_mv(Ldi[..., g, :, :], acc))
    return torch.stack(vs, dim=-2)


def block_grid_solve_upper(Ldi, Loff, r):
    """``L^T w = r`` with the grid factor (backward substitution)."""
    m = r.shape[-2]
    ws = [None] * m
    for g in reversed(range(m)):
        acc = r[..., g, :]
        if g < m - 1:
            acc = acc - torch.einsum("...jki,...jk->...i",
                                     Loff[..., g + 1:, g, :, :],
                                     torch.stack(ws[g + 1:], dim=-2))
        ws[g] = _mv(_t(Ldi[..., g, :, :]), acc)
    return torch.stack(ws, dim=-2)


def block_grid_to_dense(S):
    """``(..., m, m, P, P)`` grid -> ``(..., mP, mP)`` dense matrix in
    block-major order (``dense[g P + p, h P + q] = S[g, h, p, q]``)."""
    m, P = S.shape[-4], S.shape[-1]
    return S.movedim(-2, -3).reshape(S.shape[:-4] + (m * P, m * P))
