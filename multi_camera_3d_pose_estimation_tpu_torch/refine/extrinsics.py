"""Standalone extrinsic refinement of one camera from two calibrated views.

Counterpart of the JAX package's ``refine/extrinsics.py``: N 2-D points per
joint and frame are sampled from the two ground-truth cameras' Gaussians
and triangulated; plain Adam (optax's ``adam``: ``mu_hat / (sqrt(nu_hat) +
1e-8)·(−lr)``, no clipping) then moves the third camera's (R, T) so that
the reprojected samples are likely under its own Gaussians.  After every
step R is re-projected onto the orthogonal matrices as U·Vᵀ of its SVD,
with no determinant fix, as in the JAX package.  The best (R, T) by the
cost evaluated before each step is kept, and the loop stops after
``patience`` steps without improvement or after step ``max_iter``.

The samples come from a CPU ``torch.Generator`` seeded with ``seed``: the
same distribution as the JAX package's ``jax.random`` draws, not the same
numbers (``ExtrinsicRefiner._optimize`` is the loop on given draws).
``minimize_likelihood_compat`` reproduces the reference's sign (it
minimised the log-likelihood).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.geometry import project_cameras
from ..ops.triangulation import triangulate_points
from .costs import gaussian_log_likelihood
from .optimizer import TorchDraws, _sample_gaussians

__all__ = ["ExtrinsicRefiner"]


class ExtrinsicRefiner:
    """Refine one camera's (R, T) from two calibrated views' Gaussians.

    - ``gaussians``: (T, 3, J, 6) Gaussian moments of exactly 3 cameras.
    - ``cam_params``: {camera_index: [K, R, T, dist]} with at least the two
      GT cameras.
    - ``GT_camera_indices``: the two trusted views; ``estimation_camera_index``
      the view whose extrinsics are learned.
    """

    def __init__(self, gaussians, cam_params: dict, R_initial=None, T_initial=None,
                 N_sample_points: int = 100, GT_camera_indices=(0, 1),
                 estimation_camera_index: int = 2, dtype=torch.float32, device="cuda"):
        gaussians = np.asarray(gaussians, np.float64)
        if gaussians.shape[1] != 3:
            raise ValueError("ExtrinsicRefiner expects exactly 3 cameras")
        if len(GT_camera_indices) != 2:
            raise ValueError("need exactly 2 GT camera indices")
        self.gaussians = gaussians
        self.cam_params = cam_params
        self.GT_camera_indices = list(GT_camera_indices)
        self.estimation_camera_index = estimation_camera_index
        self.N_sample_points = N_sample_points
        self.dtype = dtype
        self.device = torch.device(device)
        if R_initial is None and estimation_camera_index in cam_params:
            R_initial = cam_params[estimation_camera_index][1]
        if T_initial is None and estimation_camera_index in cam_params:
            T_initial = cam_params[estimation_camera_index][2]
        self.R = np.eye(3) if R_initial is None else np.asarray(R_initial, np.float64).reshape(3, 3)
        self.T = np.zeros(3) if T_initial is None else np.asarray(T_initial, np.float64).reshape(3)

    def optimize(self, learning_rate: float = 0.001, max_iter: int = 10000, patience: int = 10,
                 seed: int = 0, minimize_likelihood_compat: bool = False,
                 print_frequency: int | None = None):
        """Run Adam; returns the best ``(R (3, 3), T (3,))`` as float64 numpy."""
        Tn, _, J, _ = self.gaussians.shape
        z = TorchDraws(seed).normal((Tn, 2, J, self.N_sample_points, 2))
        return self._optimize(z, learning_rate, max_iter, patience, minimize_likelihood_compat,
                              print_frequency)

    def _optimize(self, z, learning_rate, max_iter, patience, minimize_likelihood_compat,
                  print_frequency):
        """`optimize` on given standard normal draws ``z`` (T, 2, J, N, 2)."""
        def t(a):
            return torch.as_tensor(np.array(a), dtype=self.dtype, device=self.device)

        g = t(self.gaussians)
        Tn, _, J, _ = g.shape
        N = self.N_sample_points
        samples = _sample_gaussians(torch.as_tensor(z).to(self.device, self.dtype),
                                    g[:, self.GT_camera_indices])
        c1, c2 = (self.cam_params[i] for i in self.GT_camera_indices)
        samples_3d = triangulate_points(samples, c1[0], c1[3], c1[1], c1[2],
                                        c2[0], c2[3], c2[1], c2[2]).to(self.dtype)

        est = self.estimation_camera_index if self.estimation_camera_index < 3 else 2
        means = g[:, est, :, None, :2]  # (T, J, 1, 2)
        covs = g[:, est, :, 2:].reshape(Tn, J, 1, 2, 2).expand(Tn, J, N, 2, 2)
        K = t(self.cam_params[self.estimation_camera_index][0])
        d = self.cam_params[self.estimation_camera_index][3]
        dist = torch.zeros(5, dtype=self.dtype, device=self.device) if d is None else \
            t(np.asarray(d).reshape(-1)[:5])
        sign = 1.0 if minimize_likelihood_compat else -1.0

        def loss(R, T):
            proj = project_cameras(samples_3d, K, R, T, dist)
            ll = gaussian_log_likelihood(proj, means, cov=covs)
            ok = torch.isfinite(ll)
            mean_ll = torch.where(ok, ll, torch.zeros_like(ll)).sum() / torch.clamp(ok.sum(), min=1)
            return sign * mean_ll

        params = [t(self.R), t(self.T)]
        mu = [torch.zeros_like(p) for p in params]
        nu = [torch.zeros_like(p) for p in params]
        best = list(params)
        best_cost = torch.tensor(float("inf"), dtype=self.dtype, device=self.device)
        no_imp = torch.tensor(0, device=self.device)
        b1, b2 = 0.9, 0.999
        it = 0
        while it <= max_iter and int(no_imp) < patience:
            leaves = [p.detach().requires_grad_(True) for p in params]
            with torch.enable_grad():
                cost = loss(*leaves)
                grads = torch.autograd.grad(cost, leaves)
            count = it + 1
            bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
            new = []
            for i, (p, g_) in enumerate(zip(leaves, grads)):
                mu[i] = (1.0 - b1) * g_ + b1 * mu[i]
                nu[i] = (1.0 - b2) * (g_ * g_) + b2 * nu[i]
                new.append(p.detach() + (-learning_rate) * ((mu[i] / bc1)
                                                            / (torch.sqrt(nu[i] / bc2) + 1e-8)))
            U, _, Vh = torch.linalg.svd(new[0])
            params = [U @ Vh, new[1]]
            cost = cost.detach()
            improved = cost < best_cost
            best = [torch.where(improved, n, b) for n, b in zip(params, best)]
            best_cost = torch.where(improved, cost, best_cost)
            no_imp = torch.where(improved, torch.zeros_like(no_imp), no_imp + 1)
            it += 1
        self.R = best[0].detach().cpu().double().numpy()
        self.T = best[1].detach().cpu().double().numpy()
        self.n_iter = it
        self.best_cost = float(best_cost)
        if print_frequency:
            print(f"Extrinsic refinement: {self.n_iter} iterations, "
                  f"best cost = {self.best_cost:.2e}")
        return self.R, self.T
