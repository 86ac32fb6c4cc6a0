"""Refinement costs (batched torch, differentiable by autograd).

Counterpart of the JAX package's ``refine/costs.py``: the Gaussian
reprojection log-likelihood with a precomputed covariance inverse, the
second-difference smoothness and the scale-invariant body-length cost.

NaN observations (missing joints) give NaN terms that `nan_mean` leaves
out, but every such term is computed through a sanitised branch: autograd,
like ``jax.grad``, sends 0·NaN = NaN back through the branch a
`torch.where` did not take.  The square roots are clamped for the same
reason (their gradient at 0 is infinite).
"""

from __future__ import annotations

import math

import torch

from ..ops.geometry import project_cameras, rodrigues_matrix

__all__ = [
    "nan_mean",
    "gaussian_log_likelihood",
    "precompute_cov_inverse",
    "likelihood_cost",
    "smoothness_cost",
    "body_length_cost",
]


def _inv2x2(cov: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 2x2 inverse."""
    a, b = cov[..., 0, 0], cov[..., 0, 1]
    c, d = cov[..., 1, 0], cov[..., 1, 1]
    inv_det = 1.0 / (a * d - b * c)
    return torch.stack([torch.stack([d * inv_det, -b * inv_det], dim=-1),
                        torch.stack([-c * inv_det, a * inv_det], dim=-1)], dim=-2)


def _det2x2(cov: torch.Tensor) -> torch.Tensor:
    return cov[..., 0, 0] * cov[..., 1, 1] - cov[..., 0, 1] * cov[..., 1, 0]


def _eye2(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(2, dtype=like.dtype, device=like.device)


def nan_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the finite elements (0 if there are none)."""
    ok = torch.isfinite(x)
    total = torch.where(ok, x, torch.zeros_like(x)).sum()
    return total / torch.clamp(ok.sum(), min=1)


def _quad(diff: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """diffᵀ·ci·diff over the last axes: (..., 2), (..., 2, 2) -> (...)."""
    return (diff[..., :, None] * ci * diff[..., None, :]).sum((-2, -1))


def gaussian_log_likelihood(x: torch.Tensor, mean: torch.Tensor, cov: torch.Tensor | None = None,
                            cov_inv: torch.Tensor | None = None, eps: float = 1e-6,
                            huber_delta: float | None = None,
                            temperature: float = 1.0) -> torch.Tensor:
    """Batched 2-D Gaussian log-likelihood of ``x`` (..., 2) -> (...).

    With ``cov_inv`` only the quadratic term −m²/2 (m² = diffᵀΣ⁻¹diff),
    Huberised on m when ``huber_delta`` is given (−δ(m − δ/2) beyond δ) and
    divided by ``temperature``; with ``cov`` (eps·I added) the full
    log-density with its log-det normalisation.  NaN where ``x − mean`` is
    not finite.
    """
    diff = x - mean
    ok = torch.isfinite(diff).all(-1)
    diff = torch.where(ok[..., None], diff, torch.zeros_like(diff))
    nan = torch.full_like(diff[..., 0], float("nan"))
    if cov_inv is not None:
        m2 = _quad(diff, cov_inv)
        if huber_delta is not None:
            m = torch.sqrt(torch.clamp(m2, min=1e-12))
            d = float(huber_delta)
            quad = -torch.where(m <= d, 0.5 * m2, d * (m - 0.5 * d))
        else:
            quad = -0.5 * m2
        if temperature != 1.0:
            quad = quad / temperature
        return torch.where(ok, quad, nan)
    cov = cov + eps * _eye2(cov)
    cov = torch.where(ok[..., None, None], cov, _eye2(cov))
    quad = -0.5 * _quad(diff, _inv2x2(cov))
    norm = 0.5 * torch.log((2.0 * math.pi) ** 2 * _det2x2(cov) + eps)
    return torch.where(ok, quad - norm, nan)


def precompute_cov_inverse(gaussians: torch.Tensor, eps: float = 1e-6,
                           camera0_gaussians_compat: bool = False) -> torch.Tensor:
    """(T, C, J, 6) Gaussians -> (T, C, J, 2, 2) inverses of cov + eps·I;
    non-finite covariances become the identity.  ``camera0_gaussians_compat``
    gives every camera camera 0's covariance (the reference's indexing)."""
    g = gaussians
    if camera0_gaussians_compat:
        g = g[:, :1].expand(g.shape)
    cov = g[..., 2:].reshape(g.shape[:-1] + (2, 2)) + eps * _eye2(g)
    ok = torch.isfinite(cov).all(-1).all(-1)[..., None, None]
    return _inv2x2(torch.where(ok, cov, _eye2(cov)))


def _camera_ll(points, means, cov_inv, Ks, Rs, Ts, dists, ignore_distortions,
               huber_delta=None, temperature=1.0):
    """Per-camera log-likelihood of ``points`` (B, J[, N], 3): every camera
    c projects them (``Rs`` (C, 3) axis-angle or (C, 3, 3)) and scores them
    under ``means`` (B, C, J[, N], 2) / ``cov_inv`` (B, C, J[, N], 2, 2).
    Returns (C, B, J[, N])."""
    if Rs.dim() == 2:
        Rs = rodrigues_matrix(Rs)
    cam = (slice(None),) + (None,) * (points.dim() - 1)  # (C, 1, ..., 1)
    proj = project_cameras(points[None], Ks[cam], Rs[cam], Ts[cam], dists[cam],
                           ignore_distortions)  # (C, B, J[, N], 2)
    return gaussian_log_likelihood(proj, means.movedim(1, 0), cov_inv=cov_inv.movedim(1, 0),
                                   huber_delta=huber_delta, temperature=temperature)


def likelihood_cost(trajectory, means, cov_inv, Ks, Rs, Ts, dists,
                    ignore_distortions: bool = False, huber_delta: float | None = None,
                    temperature: float = 1.0) -> torch.Tensor:
    """Negative mean reprojection log-likelihood over all cameras and joints.

    ``trajectory`` (B, J, 3), ``means`` (B, C, J, 2), ``cov_inv`` (B, C, J,
    2, 2), ``Ks`` (C, 3, 3), ``Rs`` (C, 3) axis-angle or (C, 3, 3), ``Ts``
    (C, 3), ``dists`` (C, 5).  NaN terms drop out (`nan_mean`).
    """
    ll = _camera_ll(trajectory, means, cov_inv, Ks, Rs, Ts, dists, ignore_distortions,
                    huber_delta, temperature)
    return -nan_mean(ll)


def smoothness_cost(trajectory: torch.Tensor) -> torch.Tensor:
    """Mean over the window (B, J, 3) of the squared Frobenius norm of the
    second difference x_t − 2x_{t−1} + x_{t−2}; NaN terms drop out."""
    d2 = trajectory[2:] - 2.0 * trajectory[1:-1] + trajectory[:-2]
    return nan_mean((d2 * d2).sum((-2, -1)))


def body_length_cost(trajectory: torch.Tensor, edge_start, edge_end,
                     target_lengths: torch.Tensor) -> torch.Tensor:
    """Scale-invariant body-segment length error ||a − μb||² / ||a||².

    b: the segments' lengths in the window (B, J, 3), edge-major; a: the
    targets repeated per frame; μ = <a, b>/<b, b>, the best global scale.
    """
    vec = trajectory[:, edge_end, :] - trajectory[:, edge_start, :]  # (B, E, 3)
    lengths = torch.sqrt(torch.clamp((vec * vec).sum(-1), min=1e-12))  # (B, E)
    b = lengths.T.reshape(-1)
    a = torch.repeat_interleave(target_lengths, trajectory.shape[0])
    mu = torch.dot(a, b) / torch.dot(b, b)
    diff = a - mu * b
    return torch.dot(diff, diff) / torch.dot(a, a)
