"""Levenberg-Marquardt for small dense calibration problems (torch).

Counterpart of the JAX package's ``calib/lm.py``: a fixed number of steps,
each one dense normal-equation solve with the Jacobian from forward-mode
differentiation (`torch.func.jacfwd`) and the classic adaptive damping; a
rejected step keeps the iterate, λ and the cost.

The steps never wait on the device: the accept test, λ and the cost stay
tensors selected with `torch.where`, and the solve is `torch.linalg.solve_ex`
(no error check, which would read the card's ``info`` every step).  A
singular system gives a non-finite or worse step, which is rejected, as in
JAX.

Batched problems: ``x0`` of shape (B, n) holds B independent problems, each
with its own λ, accept decisions and cost history (what ``jax.vmap`` of the
JAX solver gives).  ``residual_fn`` then maps (B, n) to (B, m) with row b
reading only ``x[b]``; the Jacobian is taken with respect to one shared
perturbation of every row, which for independent rows is each row's own
Jacobian.  ``residual_fn`` must be `torch.func`-safe: no ``.item()``, no
in-place writes, no Python branch on a tensor's value.
"""

from __future__ import annotations

import torch

__all__ = ["levenberg_marquardt"]


def _with_value(y):
    return y, y


def levenberg_marquardt(residual_fn, x0: torch.Tensor, n_iter: int = 50, lam0: float = 1e-3):
    """Minimize ||residual_fn(x)||² from ``x0`` on ``x0``'s device and dtype.

    ``x0`` (n,): returns ``(x (n,), final_cost (), cost_history (n_iter,))``.
    ``x0`` (B, n): B independent problems (see the module's docstring);
    returns ``(x (B, n), final_cost (B,), cost_history (B, n_iter))``.
    """
    batched = x0.dim() == 2
    x = x0 if batched else x0[None]
    fn = residual_fn if batched else (lambda z: residual_fn(z[0])[None])
    n = x.shape[1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    zero = torch.zeros(n, dtype=x.dtype, device=x.device)

    def cost(z):
        r = fn(z)
        return (r * r).sum(-1)

    lam = torch.full((x.shape[0],), lam0, dtype=x.dtype, device=x.device)
    prev = cost(x)
    hist = []
    for _ in range(n_iter):
        # J (B, m, n) and, as the primal of the same pass, r = fn(x).
        J, r = torch.func.jacfwd(lambda v, x=x: _with_value(fn(x + v)), has_aux=True)(zero)
        Jt = J.transpose(1, 2)
        A = Jt @ J
        g = (Jt @ r[..., None])[..., 0]
        damp = lam[:, None, None] * torch.diag_embed(A.diagonal(dim1=1, dim2=2)) + 1e-12 * eye
        dx, _info = torch.linalg.solve_ex(A + damp, -g)
        x_new = x + dx
        new = cost(x_new)
        ok = (new < prev) & torch.isfinite(x_new).all(-1)
        x = torch.where(ok[:, None], x_new, x)
        lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-12), torch.clamp(lam * 5.0, max=1e8))
        prev = torch.where(ok, new, prev)
        hist.append(prev)
    hist = torch.stack(hist, dim=-1) if hist else prev.new_zeros((x.shape[0], 0))
    if batched:
        return x, prev, hist
    return x[0], prev[0], hist[0]
