"""Trajectory + extrinsics refinement: Adam on the reprojection likelihood.

Counterpart of the JAX package's ``refine/optimizer.py``.  `run_refinement`
is the epoch loop (the JAX package's ``_run_refinement``) as a plain
function over tensors: for each epoch, every overlapping half-stride window
takes one step of autograd → global-norm clipping → Adam, written out in
optax's order (clip ``where(‖g‖ < c, g, g/‖g‖·c)`` with no epsilon;
``mu_hat / (sqrt(nu_hat) + 1e-8)``, then ``·(−lr)``), so that float64 runs
follow the JAX package's epoch for epoch.

- The whole parameter tensors step at every window.  A slice's gradient is
  zero outside its window, but Adam's moments cover the whole trajectory,
  so rows outside the window still move by their momentum (as
  ``torch.optim.Adam`` and optax over the full tensor do).
- The loop runs epochs 0..max_iter (``max_iter + 1`` of them); a new best
  needs ``total < best − tolerance``; it stops once ``patience`` epochs
  passed without one.  The host reads that count once per epoch.
- Random draws (the zero-jitter of learnable extrinsics, ``randomize_params``,
  the MLP's initial weights, the samples of the extrinsics-from-samples
  cost) come from a CPU ``torch.Generator`` seeded with ``seed``: the same
  distributions as the JAX package's ``jax.random`` draws, not the same
  numbers.  The card and the CPU draw the same numbers.

Checkpoints (``checkpoint_dir``) are the JAX package's ``refine_state.npz``:
flat leaves ``c0..cN`` in ``jax.tree.flatten`` order of its carry, so a
refinement checkpointed by either package resumes in the other
(`load_jax_refine_state`).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.geometry import project_cameras, rodrigues_matrix, rodrigues_vector
from ..ops.triangulation import triangulate_points
from ..utils.skeleton import body_length_edges
from .costs import (_camera_ll, _quad, body_length_cost, likelihood_cost, nan_mean,
                    precompute_cov_inverse)

__all__ = ["RefineConfig", "RefineResult", "RefineState", "RefineData", "PoseRefiner",
           "run_refinement", "mlp_params_from_jax", "load_jax_refine_state"]

MLP_WIDTHS = (256, 128, 64, 32, 16, 3)


@dataclass(frozen=True)
class RefineConfig:
    """Refinement hyperparameters; names and defaults as the JAX package's
    (and the reference's ``sgd_optimize``), so the same YAML files work.

    ``huber_delta`` / ``likelihood_temperature``: `gaussian_log_likelihood`.
    ``auto_gate``: a window whose initial trajectory already reprojects
    below the 2-D noise floor the Gaussians claim (median squared
    Mahalanobis radius < ``gate_threshold``) gets zero objective and keeps
    its initial trajectory.
    """

    optimize_trajectory: bool = True
    lr: float = 0.001
    betas: tuple[float, float] = (0.9, 0.999)
    lambda_smooth: float = 1.0
    lambda_body_length: float = 1.0
    patience: int = 100
    tolerance: float = 1e-5
    max_iter: int = 1000
    batch_size: int | None = None
    N_sample_points: int = 100
    ignore_distortions: bool = False
    randomize_params: bool = False
    reset_camera_params: bool = False
    use_NN: bool = False
    grad_clip: float = 1.0
    camera0_gaussians_compat: bool = False
    print_frequency: int = 100
    verbose: bool = False
    checkpoint_every: int | None = None
    huber_delta: float | None = None
    likelihood_temperature: float = 1.0
    auto_gate: bool = True
    gate_threshold: float = 2.0


@dataclass
class RefineResult:
    """Best-cost snapshot plus per-epoch cost curves."""

    trajectory: np.ndarray  # (Tw, J, 3) refined window (best epoch)
    cam_params: dict  # camera_ID -> [K, R (3, 3), T (3,), dist]
    cost_history: dict  # name -> per-epoch means, length n_iter
    n_iter: int
    best_total_cost: float
    gate_weights: np.ndarray | None = None  # per window: 1 refined, 0 skipped


@dataclass
class RefineState:
    """The epoch loop's carry: parameters {"nn" (optional: [(W, b), ...]),
    "rvecs" (C, 3), "trajectory" (Tw, J, 3), "tvecs" (C, 3)}, Adam's step
    count and moments (one per leaf, `_leaves` order), the best snapshot,
    its total, epochs without improvement, the next epoch and the cost
    history (max_iter + 2, n_costs)."""

    params: dict
    count: int
    mu: list
    nu: list
    best_params: dict
    best_total: torch.Tensor
    no_improve: torch.Tensor
    epoch: int
    history: torch.Tensor


@dataclass
class RefineData:
    """What the epoch loop reads: window starts (numpy) and gate weights,
    the Gaussians' means (Tw, C, J, 2), covariance inverses (Tw, C, J, 2, 2)
    and raw moments (Tw, C, J, 6), triangulated samples (Tw, J, N, 3), the
    cameras' K (C, 3, 3) and dist (C, 5), which cameras learn extrinsics
    (C,), and the body-length edges."""

    starts: np.ndarray
    gate_w: torch.Tensor
    means: torch.Tensor
    cov_inv: torch.Tensor
    gaussians: torch.Tensor
    samples_3d: torch.Tensor
    Ks: torch.Tensor
    dists: torch.Tensor
    learn_mask: torch.Tensor
    e_start: torch.Tensor
    e_end: torch.Tensor
    e_target: torch.Tensor


class TorchDraws:
    """Random draws in float64 from a CPU ``torch.Generator`` seeded with
    ``seed``, in the order the refiner asks for them."""

    def __init__(self, seed: int):
        self.gen = torch.Generator().manual_seed(int(seed))

    def uniform(self, shape, low: float = 0.0, high: float = 1.0) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.gen, dtype=torch.float64)
        return u * (high - low) + low

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.gen, dtype=torch.float64)


# ---------------------------------------------------------------- parameters


def _leaves(params: dict) -> list:
    """The parameters in ``jax.tree.flatten`` order: sorted keys, the MLP's
    layers as W, b pairs."""
    out = []
    for key in sorted(params):
        if key == "nn":
            for W, b in params["nn"]:
                out += [W, b]
        else:
            out.append(params[key])
    return out


def _unflatten(template: dict, leaves) -> dict:
    leaves = list(leaves)
    out = {}
    for key in sorted(template):
        if key == "nn":
            out["nn"] = [(leaves.pop(0), leaves.pop(0)) for _ in template["nn"]]
        else:
            out[key] = leaves.pop(0)
    return out


def _leaf_keys(params: dict) -> list:
    """The key of each of `_leaves`' entries ("nn" for every MLP tensor)."""
    return [k for k in sorted(params) for _ in range(2 * len(params[k]) if k == "nn" else 1)]


def mlp_init(draws, in_dim: int, dtype, device) -> list:
    """He-uniform init of the 18 → 256 → 128 → 64 → 32 → 16 → 3 MLP (input
    C·6): W (in, out) and b (out,) uniform in ±sqrt(1/in), drawn from
    ``draws`` and moved to ``device`` as ``dtype``."""
    dims = (in_dim,) + MLP_WIDTHS
    layers = []
    for i in range(len(dims) - 1):
        bound = float(np.sqrt(1.0 / dims[i]))
        W = draws.uniform((dims[i], dims[i + 1]), -bound, bound)
        b = draws.uniform((dims[i + 1],), -bound, bound)
        layers.append((W.to(device, dtype), b.to(device, dtype)))
    return layers


def mlp_params_from_jax(params, dtype=torch.float64, device="cuda") -> list:
    """The JAX package's ``_mlp_init`` tuple of (W (in, out), b) arrays as
    the port's MLP state: a list of (W, b) tensors on ``device``."""
    return [(torch.as_tensor(np.array(W), dtype=dtype, device=device),
             torch.as_tensor(np.array(b), dtype=dtype, device=device)) for W, b in params]


def _mlp_apply(layers, x):
    """ReLU MLP over the last axis, no activation after the last layer."""
    for i, (W, b) in enumerate(layers):
        x = x @ W + b
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------- epoch loop


def _cost_names(cfg: RefineConfig, use_bl: bool, from_samples: bool) -> list:
    names = ["total_cost"]
    if cfg.optimize_trajectory:
        names.append("likelihood_cost")
    if cfg.lambda_smooth > 0:
        names.append("smoothness_cost")
    if use_bl:
        names.append("body_length_cost")
    if from_samples:
        names.append("extrinsic_param_sample_cost")
    return names


def _sample_cost(samples_3d, means_w, cov_inv_w, Ks, rvecs, tvecs, dists, learn_mask,
                 ignore_dist):
    """−E[log N(project(sample); camera Gaussian)] over the learnable
    cameras: every camera's term is computed, the others masked out."""
    ll = _camera_ll(samples_3d, means_w[:, :, :, None, :], cov_inv_w[:, :, :, None],
                    Ks, rvecs, tvecs, dists, ignore_dist)  # (C, B, J, N)
    ok = torch.isfinite(ll)
    tot = torch.where(ok, ll, torch.zeros_like(ll)).sum((1, 2, 3))
    cnt = ok.sum((1, 2, 3)).to(tot.dtype)
    m = learn_mask.to(tot.dtype)
    return -(tot * m).sum() / torch.clamp((cnt * m).sum(), min=1)


def _window_costs(cfg, use_bl, from_samples, B, p, start, gate, data):
    """The gated costs of the window at ``start`` and its trajectory."""
    J = data.means.shape[2]
    if cfg.use_NN:
        feats = data.gaussians[start:start + B].movedim(1, 2).reshape(B, J, -1)
        traj_w = _mlp_apply(p["nn"], feats)
    else:
        traj_w = p["trajectory"][start:start + B]
    means_w = data.means[start:start + B]
    ci_w = data.cov_inv[start:start + B]
    costs = {}
    if cfg.optimize_trajectory:
        costs["likelihood_cost"] = likelihood_cost(
            traj_w, means_w, ci_w, data.Ks, p["rvecs"], p["tvecs"], data.dists,
            ignore_distortions=cfg.ignore_distortions, huber_delta=cfg.huber_delta,
            temperature=cfg.likelihood_temperature)
    if cfg.lambda_smooth > 0:
        d2 = traj_w[2:] - 2.0 * traj_w[1:-1] + traj_w[:-2]
        costs["smoothness_cost"] = cfg.lambda_smooth * nan_mean((d2 * d2).sum((-2, -1)))
    if use_bl:
        costs["body_length_cost"] = cfg.lambda_body_length * body_length_cost(
            traj_w, data.e_start, data.e_end, data.e_target)
    if from_samples:
        costs["extrinsic_param_sample_cost"] = _sample_cost(
            data.samples_3d[start:start + B], means_w, ci_w, data.Ks, p["rvecs"], p["tvecs"],
            data.dists, data.learn_mask, cfg.ignore_distortions)
    # A gated window (gate 0) has zero objective, likelihood and priors alike.
    costs = {k: gate * v for k, v in costs.items()}
    costs["total_cost"] = sum(costs.values())
    return costs, traj_w


def _masked_grads(cfg, keys, grads, leaves, learn_mask):
    """Zero for what does not learn: unlearned cameras' extrinsics (as a
    product with the mask), the trajectory under ``use_NN`` or without
    ``optimize_trajectory``, the MLP without ``optimize_trajectory``."""
    m = learn_mask[:, None].to(leaves[0].dtype)
    out = []
    for key, g, leaf in zip(keys, grads, leaves):
        g = torch.zeros_like(leaf) if g is None else g
        if key in ("rvecs", "tvecs"):
            g = g * m
        elif key == "trajectory" and (not cfg.optimize_trajectory or cfg.use_NN):
            g = torch.zeros_like(leaf)
        elif key == "nn" and not cfg.optimize_trajectory:
            g = torch.zeros_like(leaf)
        out.append(g)
    return out


def _clip_adam_step(cfg, leaves, grads, mu, nu, count):
    """clip_by_global_norm → scale_by_adam → scale(−lr), in optax's order.
    Returns (new leaves, new mu, new nu)."""
    sq = None
    for g in grads:
        s = (g * g).sum()
        sq = s if sq is None else sq + s
    g_norm = torch.sqrt(sq)
    clip = cfg.grad_clip
    grads = [torch.where(g_norm < clip, g, (g / g_norm) * clip) for g in grads]
    b1, b2 = cfg.betas
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    new_p, new_mu, new_nu = [], [], []
    for p, g, m, v in zip(leaves, grads, mu, nu):
        m = (1.0 - b1) * g + b1 * m
        v = (1.0 - b2) * (g * g) + b2 * v
        upd = (-cfg.lr) * ((m / bc1) / (torch.sqrt(v / bc2) + 1e-8))
        new_p.append(p + upd)
        new_mu.append(m)
        new_nu.append(v)
    return new_p, new_mu, new_nu


def run_refinement(cfg: RefineConfig, cost_names, use_bl: bool, from_samples: bool,
                   batch_size: int, state: RefineState, block_end: int,
                   data: RefineData) -> RefineState:
    """Epochs from ``state.epoch`` while epoch ≤ max_iter, epoch <
    ``block_end`` and fewer than ``patience`` epochs passed without a new
    best.  Returns the new state (the given one is not changed)."""
    B = batch_size
    params = state.params
    keys = _leaf_keys(params)
    mu, nu, count = list(state.mu), list(state.nu), state.count
    best, best_total, no_imp = state.best_params, state.best_total, state.no_improve
    hist = state.history.clone()
    epoch = state.epoch
    gates = list(data.gate_w.unbind(0))
    while epoch <= cfg.max_iter and epoch < block_end and int(no_imp) < cfg.patience:
        cvecs = []
        for start, gate in zip(data.starts.tolist(), gates):
            leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
            p = _unflatten(params, leaves)
            with torch.enable_grad():
                costs, traj_w = _window_costs(cfg, use_bl, from_samples, B, p, start, gate, data)
                grads = torch.autograd.grad(costs["total_cost"], leaves, allow_unused=True)
            grads = _masked_grads(cfg, keys, grads, leaves, data.learn_mask)
            count += 1
            new, mu, nu = _clip_adam_step(cfg, [t.detach() for t in leaves], grads, mu, nu,
                                          count)
            params = _unflatten(params, new)
            if cfg.use_NN:
                # The MLP's window output goes into the trajectory, value only.
                traj = params["trajectory"].clone()
                traj[start:start + B] = traj_w.detach()
                params["trajectory"] = traj
            cvecs.append(torch.stack([costs[n].detach() for n in cost_names]))
        epoch_costs = torch.stack(cvecs).mean(0)
        hist[epoch] = epoch_costs
        total = epoch_costs[0]
        improved = total < best_total - cfg.tolerance
        best = _unflatten(best, [torch.where(improved, n, b)
                                 for b, n in zip(_leaves(best), _leaves(params))])
        best_total = torch.where(improved, total, best_total)
        no_imp = torch.where(improved, torch.zeros_like(no_imp), no_imp + 1)
        epoch += 1
    return RefineState(params, count, mu, nu, best, best_total, no_imp, epoch, hist)


# ---------------------------------------------------------------- checkpoints


def _state_leaves(state: RefineState) -> list:
    """The JAX carry's leaves: params, Adam (count, mu, nu), best params,
    best total, no-improve count, epoch, history."""
    def i32(v):
        return np.asarray(int(v), np.int32)

    def arr(t):
        return t.detach().cpu().numpy()

    return ([arr(t) for t in _leaves(state.params)] + [i32(state.count)]
            + [arr(t) for t in state.mu] + [arr(t) for t in state.nu]
            + [arr(t) for t in _leaves(state.best_params)]
            + [arr(state.best_total), i32(state.no_improve), i32(state.epoch),
               arr(state.history)])


def _save_state(path: str, state: RefineState) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{f"c{i}": v for i, v in enumerate(_state_leaves(state))})
    os.replace(tmp, path)


def load_jax_refine_state(path: str, template: RefineState) -> RefineState:
    """A ``refine_state.npz`` written by the JAX package's refiner (or by
    this one) as a `RefineState` shaped, typed and placed like
    ``template``.  The history may be shorter than the template's (a resume
    with a larger max_iter): its rows fill the template's prefix."""
    with np.load(path) as flat:
        stored = [flat[f"c{i}"] for i in range(len(flat.files))]
    like = _state_leaves(template)
    if len(stored) != len(like):
        raise ValueError(f"checkpoint has {len(stored)} leaves, expected {len(like)} — "
                         "config/data changed since checkpoint")
    dev = template.best_total.device
    vals = []
    for i, (a, want) in enumerate(zip(stored, like)):
        if a.shape != want.shape:
            if a.ndim == want.ndim and a.shape[1:] == want.shape[1:] and a.shape[0] < want.shape[0]:
                grown = want.copy()
                grown[: a.shape[0]] = a
                a = grown
            else:
                raise ValueError(f"checkpoint leaf {i} shape {a.shape} != expected {want.shape} "
                                 "— config/data changed since checkpoint")
        vals.append(a.astype(want.dtype))
    n = len(_leaves(template.params))

    def t(a):
        return torch.as_tensor(a, device=dev)

    params = _unflatten(template.params, [t(a) for a in vals[:n]])
    count = int(vals[n])
    mu = [t(a) for a in vals[n + 1:2 * n + 1]]
    nu = [t(a) for a in vals[2 * n + 1:3 * n + 1]]
    best = _unflatten(template.params, [t(a) for a in vals[3 * n + 1:4 * n + 1]])
    best_total, no_imp, epoch, hist = vals[4 * n + 1:]
    return RefineState(params, count, mu, nu, best, t(best_total),
                       t(np.int64(no_imp)), int(epoch), t(hist))


# ---------------------------------------------------------------- the refiner


def _gate_weights(traj0, means, cov_inv, Ks, Rs, Ts, ds, starts, B, threshold: float,
                  ignore_dist: bool) -> np.ndarray:
    """Per-window gate from the INITIAL trajectory: 0 where the window's
    median (``np.nanmedian``, which averages the middle pair) squared
    Mahalanobis radius of the reprojections is below ``threshold``."""
    cam = (slice(None), None, None)
    proj = project_cameras(traj0[None], Ks[cam], Rs[cam], Ts[cam], ds[cam],
                           ignore_dist)  # (C, Tw, J, 2)
    diff = proj - means.movedim(1, 0)
    ok = torch.isfinite(diff).all(-1)
    diff = torch.where(ok[..., None], diff, torch.zeros_like(diff))
    m2 = torch.where(ok, _quad(diff, cov_inv.movedim(1, 0)),
                     torch.full_like(diff[..., 0], float("nan"))).cpu().numpy()
    out = np.ones(len(starts), np.float32)
    for i, s in enumerate(starts):
        w = m2[:, s:s + B]
        med = np.nanmedian(w) if np.isfinite(w).any() else np.nan
        if np.isfinite(med) and med < threshold:
            out[i] = 0.0
    return out


def _sample_gaussians(z: torch.Tensor, gauss_gt: torch.Tensor) -> torch.Tensor:
    """Samples of the two GT cameras' Gaussians (Tw, 2, J, 6) from standard
    normal draws ``z`` (Tw, 2, J, N, 2): mean + L·z with L the Cholesky
    factor of cov + 1e-6·I.  Returns (Tw, J, N, 2 views, 2)."""
    mean = gauss_gt[..., :2]
    cov = gauss_gt[..., 2:].reshape(gauss_gt.shape[:-1] + (2, 2))
    L = torch.linalg.cholesky(cov + 1e-6 * torch.eye(2, dtype=cov.dtype, device=cov.device))
    pts = mean[..., None, :] + torch.einsum("tcjab,tcjnb->tcjna", L, z)
    return pts.permute(0, 2, 3, 1, 4)


def _randomize(draws, params, cfg, learn_mask, learn_extr):
    """0.1·N(0, 1) init of the learnable parameters, in the JAX package's
    order of draws: trajectory, MLP layers (W, b), rvecs, tvecs."""
    new = dict(params)

    def normal_like(t):
        return 0.1 * draws.normal(t.shape).to(t.device, t.dtype)

    if cfg.optimize_trajectory and not cfg.use_NN:
        new["trajectory"] = normal_like(params["trajectory"])
    if cfg.use_NN:
        new["nn"] = [(normal_like(W), normal_like(b)) for W, b in params["nn"]]
    if learn_extr and not cfg.reset_camera_params:
        m = learn_mask[:, None]
        new["rvecs"] = torch.where(m, normal_like(params["rvecs"]), params["rvecs"])
        new["tvecs"] = torch.where(m, normal_like(params["tvecs"]), params["tvecs"])
    return new


class PoseRefiner:
    """Joint trajectory + camera-extrinsics MLE refiner.

    - ``gaussians``: (T, C, J, 6) per-view Gaussian moments [mean_x,
      mean_y, var_x, cov_xy, cov_xy, var_y].
    - ``initial_trajectory``: (T, J, 3) world-space start.
    - ``cam_params``: {camera_ID: [K, R | None, T | None, dist | None]}.
    - ``body_lengths``: {"left_shoulder_left_elbow": cm, ...} or None.
    - ``dtype``/``device``: of the refinement (float32 on the card by
      default).
    """

    def __init__(self, gaussians, initial_trajectory, cam_params: dict, body_lengths=None,
                 camera_ids=None, dtype=torch.float32, device="cuda"):
        self.dtype = dtype
        self.device = torch.device(device)
        self.gaussians = np.asarray(gaussians, np.float64)
        self.initial_trajectory = np.asarray(initial_trajectory, np.float64)
        self.camera_ids = list(cam_params.keys()) if camera_ids is None else list(camera_ids)
        self.n_cams = self.gaussians.shape[1]
        self.n_joints = self.gaussians.shape[2]
        self.body_lengths = body_lengths
        self._initial_cam = {}
        for cid, (K, R, T, dist) in cam_params.items():
            R = np.eye(3) if R is None else np.asarray(R, np.float64).reshape(3, 3)
            T = np.zeros(3) if T is None else np.asarray(T, np.float64).reshape(3)
            d = np.zeros(5) if dist is None else np.asarray(dist, np.float64).reshape(-1)[:5]
            self._initial_cam[cid] = [np.asarray(K, np.float64), R, T, np.pad(d, (0, 5 - d.size))]
        self.cam_params = {k: [p.copy() for p in v] for k, v in self._initial_cam.items()}

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.array(a), dtype=dtype or self.dtype, device=self.device)

    def sgd_optimize(self, extrinsic_optimization_IDs=(), GT_camera_IDs=None,
                     time_interval=(0, -1), seed: int = 0, checkpoint_dir: str | None = None,
                     resume: bool = False, **kwargs) -> RefineResult:
        """Run the refinement; returns the best-cost snapshot.  ``kwargs``
        are `RefineConfig` fields (others are ignored, as in the JAX
        package).  Random draws come from ``torch.Generator`` seed ``seed``."""
        if isinstance(kwargs.get("betas"), list):
            kwargs["betas"] = tuple(kwargs["betas"])
        known = {f.name for f in dataclasses.fields(RefineConfig)}
        cfg = RefineConfig(**{k: v for k, v in kwargs.items() if k in known})
        return self._optimize(cfg, extrinsic_optimization_IDs, GT_camera_IDs, time_interval,
                              TorchDraws(seed), checkpoint_dir, resume)

    def _setup(self, cfg: RefineConfig, extrinsic_optimization_IDs, GT_camera_IDs,
               time_interval, draws):
        """Everything the epoch loop needs: (statics, initial state, data,
        gate weights or None).  ``draws`` supplies the random numbers."""
        if cfg.reset_camera_params:
            self.cam_params = {k: [p.copy() for p in v] for k, v in self._initial_cam.items()}
        t0, t1 = time_interval
        t1 = self.gaussians.shape[0] if t1 in (-1, None) else t1
        gauss = self.gaussians[t0:t1]
        traj0 = self.initial_trajectory[t0:t1]
        Tw = gauss.shape[0]
        B = Tw if cfg.batch_size is None else int(cfg.batch_size)
        Tw = (Tw // B) * B  # whole windows only
        if Tw == 0:
            raise ValueError(f"time window ({gauss.shape[0]}) shorter than batch_size ({B})")
        gauss, traj0 = gauss[:Tw], traj0[:Tw]
        starts = np.arange(0, Tw - B + 1, max(B // 2, 1))

        learn_extr = len(extrinsic_optimization_IDs) > 0
        from_samples = learn_extr and not cfg.optimize_trajectory
        ids = self.camera_ids
        learn_mask = np.array([cid in extrinsic_optimization_IDs for cid in ids], bool)
        extr_idx = [ids.index(cid) for cid in extrinsic_optimization_IDs]
        Ks, Rs, Ts, ds = (np.stack([self.cam_params[i][k] for i in ids]) for k in range(4))
        rvecs = rodrigues_vector(torch.as_tensor(Rs)).numpy()
        tvecs = Ts.copy()
        if learn_extr:
            # Learnable exact zeros get a 1e-6 jitter so that they move.
            jitter = draws.uniform(rvecs.shape + (2,)).numpy() * 1e-6
            for c in extr_idx:
                rvecs[c] = np.where(rvecs[c] == 0, jitter[c, :, 0], rvecs[c])
                tvecs[c] = np.where(tvecs[c] == 0, jitter[c, :, 1], tvecs[c])

        g = self._t(gauss)
        means = g[..., :2]
        if cfg.camera0_gaussians_compat:
            means = means[:, :1].expand(means.shape)
        cov_inv = precompute_cov_inverse(g, camera0_gaussians_compat=cfg.camera0_gaussians_compat)
        Ks_t, ds_t = self._t(Ks), self._t(ds)

        gate_w = np.ones(len(starts), np.float32)
        gate_applied = (cfg.auto_gate and cfg.optimize_trajectory and not cfg.use_NN
                        and not from_samples)
        if gate_applied:
            gate_w = _gate_weights(self._t(traj0), means, cov_inv, Ks_t, self._t(Rs),
                                   self._t(Ts), ds_t, starts, B, cfg.gate_threshold,
                                   cfg.ignore_distortions)
            if cfg.verbose and not gate_w.all():
                print(f"auto-gate: {int((gate_w == 0).sum())}/{len(gate_w)} "
                      f"windows below the 2D noise floor — skipped")

        use_bl = self.body_lengths is not None and cfg.lambda_body_length > 0
        if use_bl:
            e_start, e_end, e_target = body_length_edges(self.body_lengths)
        else:
            e_start = e_end = np.zeros(1, np.int32)
            e_target = np.ones(1)

        samples_3d = torch.zeros((Tw, self.n_joints, 1, 3), dtype=self.dtype, device=self.device)
        if from_samples:
            if GT_camera_IDs is None or len(GT_camera_IDs) != 2:
                raise ValueError("learning extrinsics from samples needs 2 GT_camera_IDs")
            if len(extrinsic_optimization_IDs) != 1:
                raise ValueError("exactly one extrinsic_optimization_ID supported")
            gt = [ids.index(cid) for cid in GT_camera_IDs]
            z = draws.normal((Tw, 2, self.n_joints, cfg.N_sample_points, 2))
            samples = _sample_gaussians(z.to(self.device, self.dtype), g[:, gt])
            c1, c2 = (self.cam_params[cid] for cid in GT_camera_IDs)
            samples_3d = triangulate_points(samples, c1[0], c1[3], c1[1], c1[2],
                                            c2[0], c2[3], c2[1], c2[2]).to(self.dtype)

        params = {"trajectory": self._t(traj0), "rvecs": self._t(rvecs), "tvecs": self._t(tvecs)}
        if cfg.use_NN:
            params["nn"] = mlp_init(draws, self.n_cams * 6, self.dtype, self.device)
        mask_t = torch.as_tensor(learn_mask, device=self.device)
        if cfg.randomize_params:
            params = _randomize(draws, params, cfg, mask_t, learn_extr)

        cost_names = _cost_names(cfg, use_bl, from_samples)
        data = RefineData(
            starts=starts, gate_w=self._t(gate_w), means=means, cov_inv=cov_inv, gaussians=g,
            samples_3d=samples_3d, Ks=Ks_t, dists=ds_t, learn_mask=mask_t,
            e_start=torch.as_tensor(e_start, dtype=torch.long, device=self.device),
            e_end=torch.as_tensor(e_end, dtype=torch.long, device=self.device),
            e_target=self._t(e_target))
        zeros = [torch.zeros_like(t) for t in _leaves(params)]
        state = RefineState(
            params=params, count=0, mu=zeros, nu=[z.clone() for z in zeros], best_params=params,
            best_total=torch.tensor(float("inf"), dtype=self.dtype, device=self.device),
            no_improve=torch.tensor(0, device=self.device), epoch=0,
            history=torch.zeros((cfg.max_iter + 2, len(cost_names)), dtype=self.dtype,
                                device=self.device))
        statics = (cfg, tuple(cost_names), bool(use_bl), bool(from_samples), int(B))
        return statics, state, data, (gate_w if gate_applied else None), learn_mask

    def _optimize(self, cfg, extrinsic_optimization_IDs, GT_camera_IDs, time_interval, draws,
                  checkpoint_dir=None, resume=False) -> RefineResult:
        statics, state, data, gate_w, learn_mask = self._setup(
            cfg, extrinsic_optimization_IDs, GT_camera_IDs, time_interval, draws)
        cost_names = statics[1]
        ckpt = os.path.join(checkpoint_dir, "refine_state.npz") if checkpoint_dir else None
        if resume and ckpt and os.path.exists(ckpt):
            state = load_jax_refine_state(ckpt, state)
            print(f"resumed refinement at epoch {state.epoch} from {ckpt}")

        # Blocks of epochs between progress lines and checkpoints; one block
        # when neither is asked for.
        block = cfg.max_iter + 2
        if cfg.verbose:
            block = min(block, max(cfg.print_frequency, 1))
        if cfg.checkpoint_every:
            block = min(block, cfg.checkpoint_every)
        while True:
            state = run_refinement(*statics, state, min(state.epoch + block, cfg.max_iter + 1),
                                   data)
            it, no_imp = state.epoch, int(state.no_improve)
            if cfg.verbose and it > 0:
                vals = state.history[it - 1].tolist()
                print(f"Iteration {it - 1}: " + ", ".join(
                    f"{n}: {v:.2e}" for n, v in zip(cost_names, vals)))
            if ckpt:
                _save_state(ckpt, state)
            if no_imp >= cfg.patience:
                if cfg.verbose:
                    print(f"Early stopping at iteration {it - 1}.")
                break
            if it > cfg.max_iter:
                break

        best = state.best_params
        best_rv = best["rvecs"].detach().to("cpu", torch.float64)
        for c, cid in enumerate(self.camera_ids):
            if learn_mask[c]:
                self.cam_params[cid][1] = rodrigues_matrix(best_rv[c]).numpy()
                self.cam_params[cid][2] = best["tvecs"][c].detach().cpu().double().numpy()
        hist = state.history[:state.epoch].detach().cpu().double().numpy()
        return RefineResult(
            trajectory=best["trajectory"].detach().cpu().double().numpy(),
            cam_params={k: [np.asarray(p) for p in v] for k, v in self.cam_params.items()},
            cost_history={n: hist[:, i].copy() for i, n in enumerate(cost_names)},
            n_iter=state.epoch, best_total_cost=float(state.best_total),
            gate_weights=gate_w)
