"""Solvers of the Jaderberg scheme-1 and scheme-2 problems (port of
``convnet_approximater_tpu/core/low_rank_solvers.py``).

``min_{A, B} sum_i ||w_i - (A B)_i||_2 + lmda * sum_m ||B_m||_nuc`` over the
stacked filters W (N*C, d*d), weights A (N*C, M) and bases B (M, d*d), by a
proximal-IRLS alternation:

* B-step: IRLS-weighted least squares (weights ``1 / max(||r_i||, delta)``),
  then singular-value soft-thresholding of each (d, d) basis;
* A-step: the ridge-stabilised per-row least squares ``W B^T (B B^T + eps I)^-1``.

Scheme 2, ``W[n, c, u, v] ~= sum_m V[m, c, u] H[n, m, v]``, is a truncated SVD
of the stacked kernel (:func:`scheme2_factorize`), refined on calibration data
by an alternating ridge least squares (:func:`scheme2_data_driven`).

Everything runs in ``torch.linalg`` on the weights' device; the iterations
are a Python loop that returns the objective (or error) after each one.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def svd_init(W: torch.Tensor, num_bases: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """SVD initialisation: weights (R, M) = U sqrt(S), bases (M, D) = sqrt(S) Vh,
    zero-padded when M exceeds the spectrum."""
    u, s, vh = torch.linalg.svd(W, full_matrices=False)
    sq = s.sqrt()
    upb = min(num_bases, s.shape[-1])
    R, D = W.shape
    weights = W.new_zeros(R, num_bases)
    bases = W.new_zeros(num_bases, D)
    weights[:, :upb] = u[:, :upb] * sq[None, :upb]
    bases[:upb] = vh[:upb] * sq[:upb, None]
    return weights, bases


def standard_init(W: torch.Tensor, num_bases: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's 'standard' init: the first M columns of W on unit bases."""
    R, D = W.shape
    upb = min(num_bases, D)
    weights = W.new_zeros(R, num_bases)
    weights[:, :upb] = W[:, :upb]
    bases = W.new_zeros(num_bases, D)
    bases[torch.arange(upb), torch.arange(upb)] = 1.0
    return weights, bases


def random_init(generator: torch.Generator, W: torch.Tensor,
                num_bases: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform [0, 1) weights and bases drawn from ``generator`` (on the CPU)."""
    R, D = W.shape
    weights = torch.rand(R, num_bases, generator=generator, dtype=W.dtype)
    bases = torch.rand(num_bases, D, generator=generator, dtype=W.dtype)
    return weights.to(W.device), bases.to(W.device)


def l21_objective(W, A, B, lmda: float, d: int) -> torch.Tensor:
    """sum_i ||w_i - (A B)_i||_2 + lmda * sum_m ||B_m||_nuc."""
    data = torch.linalg.norm(W - A @ B, dim=1).sum()
    return data + lmda * torch.linalg.svdvals(B.reshape(-1, d, d)).sum()


def _svt(B, d: int, tau):
    """Singular-value soft-thresholding of each (d, d) basis (nuclear-norm prox)."""
    u, s, vh = torch.linalg.svd(B.reshape(-1, d, d), full_matrices=False)
    s = torch.clamp(s - tau, min=0.0)
    return (u * s[..., None, :] @ vh).reshape(B.shape)


def als_l21_nuclear(W, A0, B0, lmda: float, d: int, num_iters: int, ridge: float = 1e-6,
                    irls_delta: float = 1e-6):
    """Alternating proximal-IRLS minimisation of the scheme-1 objective.

    Returns ``(A, B, objectives)``, the objective after each of the
    ``num_iters`` alternations.
    """
    A, B = A0, B0
    M = A.shape[1]
    eye = torch.eye(M, dtype=W.dtype, device=W.device)
    objs = []
    for _ in range(num_iters):
        # B-step: IRLS-weighted least squares, then the nuclear prox
        r = torch.linalg.norm(W - A @ B, dim=1)
        wts = 1.0 / torch.clamp(r, min=irls_delta)
        Aw = A * wts[:, None]
        B_ls = torch.linalg.solve(Aw.T @ A + ridge * eye, Aw.T @ W)
        # the IRLS quadratic has row curvature ~ mean(wts) * R; dividing lmda by
        # it keeps the shrinkage on the un-weighted objective's scale
        tau = lmda / torch.clamp(wts.mean() * W.shape[0], min=1e-12)
        B = _svt(B_ls, d, tau) if lmda > 0 else B_ls
        # A-step: exact per-row least squares
        A = torch.linalg.solve(B @ B.T + ridge * eye, B @ W.T).T
        objs.append(l21_objective(W, A, B, lmda, d))
    return A, B, torch.stack(objs) if objs else W.new_zeros(0)


def pc_energy(bases: torch.Tensor, d: int) -> torch.Tensor:
    """Mean fraction of spectral energy in the top singular value of each
    non-zero basis (the reference's "PC Energy" log)."""
    lbd = torch.linalg.svdvals(bases.reshape(-1, d, d)) ** 2
    tot = lbd.sum(dim=1)
    nz = tot > 0
    frac = torch.where(nz, lbd[:, 0] / torch.where(nz, tot, torch.ones_like(tot)),
                       torch.zeros_like(tot))
    return frac.sum() / torch.clamp(nz.sum(), min=1)


def lmda_schedule(lmda_length: int, min_lmda: float, max_lmda: float,
                  inc_rate: float = 1.5) -> np.ndarray:
    """Log-spaced lambda continuation schedule."""
    lst = np.logspace(0, inc_rate, lmda_length + 1)[1:] - 1
    return lst / lst[-1] * (max_lmda - min_lmda) + min_lmda


def _stack2(W: torch.Tensor) -> torch.Tensor:
    """``T[(c, u), (n, v)] = W[n, c, u, v]``: (C*kh, N*kw)."""
    N, C, kh, kw = W.shape
    return W.permute(1, 2, 0, 3).reshape(C * kh, N * kw)


def scheme2_factorize(W: torch.Tensor, num_bases: int):
    """Closed-form scheme-2 reconstruction of an OIHW kernel W (N, C, kh, kw):
    the truncated SVD of the stacked kernel (Eckart-Young).  Returns ``(V, H,
    energy)``: V (M, C, kh), H (N, M, kw) and the retained spectral-energy
    fraction; bases past the spectrum are zeros."""
    N, C, kh, kw = W.shape
    u, s, vh = torch.linalg.svd(_stack2(W), full_matrices=False)
    M = min(num_bases, s.shape[0])
    sq = s[:M].sqrt()
    V = (u[:, :M] * sq[None, :]).T.reshape(M, C, kh)
    H = (vh[:M] * sq[:, None]).reshape(M, N, kw).permute(1, 0, 2)
    energy = (s[:M] ** 2).sum() / torch.clamp((s ** 2).sum(), min=1e-12)
    if num_bases > M:
        V = torch.cat([V, V.new_zeros(num_bases - M, C, kh)], dim=0)
        H = torch.cat([H, H.new_zeros(N, num_bases - M, kw)], dim=1)
    return V.contiguous(), H.contiguous(), energy


def scheme2_data_driven(W: torch.Tensor, V0: torch.Tensor, H0: torch.Tensor,
                        xcov: torch.Tensor, num_iters: int, ridge: float = 1e-8):
    """Refine the scheme-2 factors under the input metric ``xcov``, the (C*kh,
    C*kh) second moment of the vertical input strips: alternate the V-step
    ``min ||T - Vm Hm||_F`` and the metric-weighted H-step ``min (T - Vm Hm)^T
    xcov (T - Vm Hm)`` by ridge least squares, on ``T`` of :func:`scheme2_factorize`.
    With ``xcov = I`` this is plain ALS.  Returns ``(V, H, errors)``, the
    Frobenius error ``||T - Vm Hm||`` after each iteration."""
    N, C, kh, kw = W.shape
    M = V0.shape[0]
    T = _stack2(W)
    Vm = V0.reshape(M, C * kh).T  # (C*kh, M)
    Hm = H0.permute(1, 0, 2).reshape(M, N * kw)  # (M, N*kw)
    eye = torch.eye(M, dtype=T.dtype, device=T.device)
    errs = []
    for _ in range(num_iters):
        Vm = torch.linalg.solve(Hm @ Hm.T + ridge * eye, Hm @ T.T).T
        Vx = Vm.T @ xcov
        Hm = torch.linalg.solve(Vx @ Vm + ridge * eye, Vx @ T)
        errs.append(torch.linalg.norm(T - Vm @ Hm))
    V = Vm.T.reshape(M, C, kh)
    H = Hm.reshape(M, N, kw).permute(1, 0, 2)
    return V.contiguous(), H.contiguous(), torch.stack(errs) if errs else W.new_zeros(0)
