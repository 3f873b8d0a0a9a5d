"""Bundle adjustment over a keyframe window with a dense Schur complement.

Port of `vslam_tpu/ops/ba.py`: Huber reprojection cost, LM damping, the
Schur reduction S = Hpp - Hpm Hmm^-1 Hpm^T, pose solve and point
back-substitution, the first pose fixed, soft pose and point priors and
odometry (relative-pose) edges between consecutive poses. Observations
live in a dense (W, P) grid with a validity mask:

  Hpp: (W, 6, 6) block-diagonal     Hmm: (P, 3, 3) block-diagonal
  Hpm: (W, P, 6, 3) dense blocks    S: (6W, 6W) dense solve

Jacobians are analytic except the odometry edges' (`torch.func.jacrev`).
The LM loop's accept/reject damping stays on the device; with a
convergence tolerance the loop reads its exit flag back once per
iteration (`core.tracking._cond`). The solvers use the `_ex` forms of
`torch.linalg`, which do not wait for the card to check for errors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vslam_tpu_torch.ops import se3


class BAProblem(NamedTuple):
    # Poses: camera-to-world (window of keyframes)
    R: torch.Tensor  # (W, 3, 3)
    t: torch.Tensor  # (W, 3)
    pose_valid: torch.Tensor  # (W,)
    # Points
    X: torch.Tensor  # (P, 3)
    point_valid: torch.Tensor  # (P,)
    # Dense observation grid
    uv: torch.Tensor  # (W, P, 2)
    obs_valid: torch.Tensor  # (W, P)
    # Intrinsics
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor


def _world_to_cam(R, t):
    R_cw = R.transpose(-1, -2)
    return R_cw, -(R_cw @ t[..., None])[..., 0]


def _odo_residual(xi_i, xi_j, Rcw_i, tcw_i, Rcw_j, tcw_j, mR, mt, sqinfo):
    """Weighted relative-pose residual between two world->camera poses
    under BA's delta convention (xi[:3] rotation, xi[3:] translation)."""
    dRi = se3.exp_so3(xi_i[:3])
    Ri2 = dRi @ Rcw_i
    ti2 = (dRi @ tcw_i[..., None])[..., 0] + xi_i[3:]
    dRj = se3.exp_so3(xi_j[:3])
    Rj2 = dRj @ Rcw_j
    tj2 = (dRj @ tcw_j[..., None])[..., 0] + xi_j[3:]
    R_rel, t_rel = se3.compose(Rj2, tj2, *se3.inverse(Ri2, ti2))
    R_err, t_err = se3.compose(*se3.inverse(mR, mt), R_rel, t_rel)
    return se3.log_se3(R_err, t_err) * sqinfo


_odo_residuals = torch.func.vmap(_odo_residual)
_odo_jacobians = torch.func.vmap(torch.func.jacrev(_odo_residual, argnums=(0, 1)))


def _odo_args(R, t, mR, mt, sqinfo):
    Rcw, tcw = _world_to_cam(R, t)
    zeros6 = torch.zeros((R.shape[0] - 1, 6), dtype=t.dtype, device=t.device)
    sq = sqinfo.expand(R.shape[0] - 1, 6)
    return (zeros6, zeros6, Rcw[:-1], tcw[:-1], Rcw[1:], tcw[1:], mR, mt, sq)


def _odo_chi2(R, t, mR, mt, edge_w, sqinfo):
    """Weighted odometry-edge chi^2 at (R, t)."""
    r_o = _odo_residuals(*_odo_args(R, t, mR, mt, sqinfo))
    return torch.sum(r_o**2 * edge_w[:, None])


def _odo_system(R, t, mR, mt, edge_w, sqinfo):
    """The odometry edges linearized at (R, t): dense (W, W, 6, 6) Hessian
    and (W, 6) gradient contributions, and their chi^2."""
    Wn, dtype, dev = R.shape[0], t.dtype, t.device
    args = _odo_args(R, t, mR, mt, sqinfo)
    r_o = _odo_residuals(*args)
    Ji, Jj = _odo_jacobians(*args)
    Jiw, Jjw = Ji * edge_w[:, None, None], Jj * edge_w[:, None, None]
    H_ii = torch.einsum("eri,erj->eij", Jiw, Ji)
    H_jj = torch.einsum("eri,erj->eij", Jjw, Jj)
    H_ij = torch.einsum("eri,erj->eij", Jiw, Jj)
    g_i = torch.einsum("eri,er->ei", Jiw, r_o)
    g_j = torch.einsum("eri,er->ei", Jjw, r_o)
    idx = torch.arange(Wn - 1, device=dev)
    H = torch.zeros((Wn, Wn, 6, 6), dtype=dtype, device=dev)
    H.index_put_((idx, idx), H_ii, accumulate=True)
    H.index_put_((idx + 1, idx + 1), H_jj, accumulate=True)
    H.index_put_((idx, idx + 1), H_ij, accumulate=True)
    H.index_put_((idx + 1, idx), H_ij.transpose(-1, -2), accumulate=True)
    zero = torch.zeros((1, 6), dtype=dtype, device=dev)
    g = torch.cat([g_i, zero]) + torch.cat([zero, g_j])
    return H, g, torch.sum(r_o**2 * edge_w[:, None])


def _project_residuals(R, t, X, prob: BAProblem):
    """Residuals r (W, P, 2), camera-frame points p (W, P, 3) and the
    in-front mask. A point behind the camera keeps a (large, z-clamped)
    residual, so that costs compare over the same observation set."""
    R_cw, t_cw = _world_to_cam(R, t)
    p = torch.einsum("wij,pj->wpi", R_cw, X) + t_cw[:, None, :]
    z = torch.clamp(p[..., 2], min=1e-2)
    u = prob.fx * p[..., 0] / z + prob.cx
    v = prob.fy * p[..., 1] / z + prob.cy
    r = torch.stack([u - prob.uv[..., 0], v - prob.uv[..., 1]], dim=-1)
    return r, p, p[..., 2] > 1e-2


def _huber_weights(r, obs_mask, delta):
    rn = se3.norm(r)
    w = torch.where(rn <= delta, 1.0, delta / torch.clamp(rn, min=1e-9))
    return w * obs_mask


def _cost(r, w):
    return torch.sum(w * torch.sum(r * r, dim=-1))


def _build_jacobians(p, prob: BAProblem, R):
    """Analytic Jacobians on the dense grid: J_pose (W, P, 2, 6) for a
    left perturbation of the world->camera transform (p' = exp(w) p + dt),
    J_point (W, P, 2, 3) = J_proj R_cw."""
    z = torch.clamp(p[..., 2], min=1e-6)
    zi = 1.0 / z
    fx, fy = prob.fx, prob.fy
    zeros = torch.zeros_like(zi)
    J_proj = torch.stack(
        [
            torch.stack([fx * zi, zeros, -fx * p[..., 0] * zi * zi], -1),
            torch.stack([zeros, fy * zi, -fy * p[..., 1] * zi * zi], -1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(*p.shape[:-1], 3, 3)
    Jp = torch.cat([-se3.hat(p), eye], dim=-1)
    J_pose = J_proj @ Jp
    J_point = torch.einsum("wpij,wjk->wpik", J_proj, R.transpose(-1, -2))
    return J_pose, J_point


def _schur_solve(J_pose, J_point, r, w, pose_valid, point_valid, lam, fix_first_n=1,
                 prior_w=0.0, prior_xi=None, prior_w_pt=0.0, prior_dx=None,
                 H_odo=None, g_odo=None):
    """One damped Schur-complement solve. The first `fix_first_n` poses
    and the invalid ones are held fixed. Returns (delta_pose (W, 6),
    delta_point (P, 3))."""
    W_, P_ = w.shape
    dtype, dev = r.dtype, r.device
    ar = torch.arange(W_, device=dev)
    pose_mask = (pose_valid & (ar >= fix_first_n)).to(dtype)
    point_mask = point_valid.to(dtype)
    Jp = J_pose * pose_mask[:, None, None, None]
    Jx = J_point * point_mask[None, :, None, None]
    Jpw = Jp * w[..., None, None]
    Jxw = Jx * w[..., None, None]

    Hpp = torch.einsum("wpri,wprj->wij", Jpw, Jp)
    Hmm = torch.einsum("wpri,wprj->pij", Jxw, Jx)
    Hpm = torch.einsum("wpri,wprj->wpij", Jpw, Jx)
    g_pose = torch.einsum("wpri,wpr->wi", Jpw, r)
    g_point = torch.einsum("wpri,wpr->pi", Jxw, r)

    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    if prior_xi is not None:
        Hpp = Hpp + prior_w * eye6[None]
        g_pose = g_pose + prior_w * prior_xi
    if prior_dx is not None:
        Hmm = Hmm + prior_w_pt * eye3[None]
        g_point = g_point + prior_w_pt * prior_dx

    Hpp = Hpp + lam * eye6[None]
    Hmm_d = Hmm + lam * eye3[None]
    # Unobserved points get an identity block, so the inverse is safe.
    seen = torch.sum(w, dim=0) > 1e-9
    Hmm_d = torch.where(seen[:, None, None], Hmm_d, eye3[None])
    Hmm_inv = torch.where(seen[:, None, None], torch.linalg.inv_ex(Hmm_d)[0], 0.0)

    # S (W, W, 6, 6) = diag(Hpp) - sum_p Hpm Hmm^-1 Hpm^T, the sum as one
    # (6W, 3P) x (3P, 6W) product.
    HpmHinv = torch.einsum("wpij,pjk->wpik", Hpm, Hmm_inv)
    lhs = HpmHinv.permute(0, 2, 1, 3).reshape(W_ * 6, P_ * 3)
    rhs_m = Hpm.permute(0, 2, 1, 3).reshape(W_ * 6, P_ * 3)
    S = -(lhs @ rhs_m.T).view(W_, 6, W_, 6).permute(0, 2, 1, 3)
    S = S.index_put((ar, ar), Hpp, accumulate=True)
    rhs = g_pose - torch.einsum("wpik,pk->wi", HpmHinv, g_point)
    if H_odo is not None:
        S = S + H_odo
        rhs = rhs + g_odo

    Sd = S.permute(0, 2, 1, 3).reshape(W_ * 6, W_ * 6)
    rd = rhs.reshape(W_ * 6)
    mask6 = pose_mask.repeat_interleave(6)
    Sd = Sd * mask6[:, None] * mask6[None, :] + torch.diag(1.0 - mask6)
    rd = rd * mask6
    delta_pose = -torch.linalg.solve_ex(Sd, rd)[0].reshape(W_, 6)

    rhs_pt = g_point + torch.einsum("wpij,wi->pj", Hpm, delta_pose)
    delta_point = -torch.einsum("pij,pj->pi", Hmm_inv, rhs_pt)
    return delta_pose, delta_point * point_mask[:, None]


def bundle_adjust(prob: BAProblem, iterations: int = 10, huber_px: float = 5.0,
                  init_lambda: float = 1e-3, fix_first_n=1,
                  pose_prior_weight: float = 30.0,
                  point_prior_weight: float = 0.0,
                  odo_trans_sigma=None, odo_rot_sigma=None,
                  rtol: float = 0.0):
    """LM with accept/reject damping. `rtol > 0` stops after two
    consecutive iterations that improve the cost by less than a relative
    `rtol` (one read back per iteration); `rtol == 0` runs exactly
    `iterations`. Returns (R, t, X, final_cost)."""
    from vslam_tpu_torch.core import tracking

    dtype, dev = prob.R.dtype, prob.R.device

    def apply_delta(R, t, X, dp, dx):
        dR = se3.exp_so3(dp[:, :3])
        R_cw, t_cw = _world_to_cam(R, t)
        R_cw2 = dR @ R_cw
        t_cw2 = (dR @ t_cw[..., None])[..., 0] + dp[:, 3:]
        R2 = R_cw2.transpose(-1, -2)
        t2 = -(R2 @ t_cw2[..., None])[..., 0]
        return se3.orthonormalize(R2), t2, X + dx

    # The observation mask stays fixed across iterations, so that accept
    # and reject compare like with like.
    static_mask = (prob.obs_valid & prob.pose_valid[:, None]
                   & prob.point_valid[None, :]).to(dtype)
    R_cw0, t_cw0 = _world_to_cam(prob.R, prob.t)
    use_odo = odo_trans_sigma is not None and odo_rot_sigma is not None
    if use_odo:
        odo_mR, odo_mt = se3.compose(R_cw0[1:], t_cw0[1:], *se3.inverse(R_cw0[:-1], t_cw0[:-1]))
        odo_w = (prob.pose_valid[1:] & prob.pose_valid[:-1]).to(dtype)
        odo_sq = torch.cat([torch.full((3,), 1.0 / odo_trans_sigma, dtype=dtype, device=dev),
                            torch.full((3,), 1.0 / odo_rot_sigma, dtype=dtype, device=dev)])

    def prior_residual(R, t):
        """xi with exp(xi) T_init = T_cur, in the (w, dt) layout."""
        R_cw, t_cw = _world_to_cam(R, t)
        dRm = R_cw @ R_cw0.transpose(-1, -2)
        return torch.cat([se3.log_so3(dRm), t_cw - (dRm @ t_cw0[..., None])[..., 0]], dim=-1)

    def eval_cost(R, t, X):
        r, p, front = _project_residuals(R, t, X, prob)
        w = _huber_weights(r, static_mask, huber_px)
        c = _cost(r, w) + pose_prior_weight * torch.sum(
            prior_residual(R, t) ** 2 * prob.pose_valid[:, None]
        ) + point_prior_weight * torch.sum((X - prob.X) ** 2 * prob.point_valid[:, None])
        if use_odo:
            c = c + _odo_chi2(R, t, odo_mR, odo_mt, odo_w, odo_sq)
        return r, w, c, p, front

    def body(R, t, X, lam, cost):
        r, w, _, p, front = eval_cost(R, t, X)
        w_lin = w * front
        J_pose, J_point = _build_jacobians(p, prob, R)
        H_odo = g_odo = None
        if use_odo:
            H_odo, g_odo, _ = _odo_system(R, t, odo_mR, odo_mt, odo_w, odo_sq)
        dp, dx = _schur_solve(
            J_pose, J_point, r, w_lin, prob.pose_valid, prob.point_valid, lam,
            fix_first_n=fix_first_n, prior_w=pose_prior_weight, prior_xi=prior_residual(R, t),
            prior_w_pt=point_prior_weight, prior_dx=X - prob.X, H_odo=H_odo, g_odo=g_odo,
        )
        R2, t2, X2 = apply_delta(R, t, X, dp, dx)
        cost2 = eval_cost(R2, t2, X2)[2]
        accept = cost2 < cost
        lam_next = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                               torch.clamp(lam * 4.0, max=1e3))
        return (torch.where(accept, R2, R), torch.where(accept, t2, t),
                torch.where(accept, X2, X), lam_next, torch.where(accept, cost2, cost))

    cost0 = eval_cost(prob.R, prob.t, prob.X)[2]
    state = (prob.R, prob.t, prob.X, torch.full((), init_lambda, dtype=dtype, device=dev), cost0)
    if rtol == 0.0:
        for _ in range(iterations):
            state = body(*state)
    else:
        stall = torch.zeros((), dtype=torch.int32, device=dev)
        i = 0
        # The stall count can reach 2 only after two iterations.
        while i < iterations and (i < 2 or tracking._cond(stall < 2)):
            cost_prev = state[4]
            state = body(*state)
            stall = torch.where(state[4] < cost_prev * (1.0 - rtol), 0, stall + 1)
            i += 1
    R, t, X, _, cost = state
    return R, t, X, cost


def window_cost(prob: BAProblem, R, t, X, huber_px: float = 5.0):
    """Huber reprojection chi^2 of (R, t, X) over the problem's full
    observation set (pose, point and observation validity)."""
    mask = (prob.obs_valid & prob.pose_valid[:, None] & prob.point_valid[None, :]).to(R.dtype)
    r = _project_residuals(R, t, X, prob)[0]
    return _cost(r, _huber_weights(r, mask, huber_px))


def ba_significant(prob: BAProblem, huber_px: float = 5.0, min_cost_per_obs: float = 4.0):
    """Is the window's initial Huber cost above `min_cost_per_obs` px^2
    per observation (the first condition of `ba_accept_window`, checked
    before the solve so that a solve the gate would reject is skipped)?
    Returns a () bool tensor."""
    c0 = window_cost(prob, prob.R, prob.t, prob.X, huber_px=huber_px)
    n_obs = torch.clamp(
        torch.sum(prob.obs_valid & prob.pose_valid[:, None] & prob.point_valid[None, :]), min=1)
    return c0 > min_cost_per_obs * n_obs


def ba_accept_window(prob: BAProblem, R_opt, t_opt, X_opt, huber_px: float = 5.0,
                     min_cost_per_obs: float = 4.0):
    """Whole-window gain gate of a BA solution: significant initial cost,
    a lower joint cost, and a lower cost of the new poses against the
    original points. Returns a () bool tensor."""
    c0 = window_cost(prob, prob.R, prob.t, prob.X, huber_px=huber_px)
    c_joint = window_cost(prob, R_opt, t_opt, X_opt, huber_px=huber_px)
    c_pose = window_cost(prob, R_opt, t_opt, prob.X, huber_px=huber_px)
    significant = ba_significant(prob, huber_px=huber_px, min_cost_per_obs=min_cost_per_obs)
    return significant & (c_joint < c0 * (1.0 - 1e-5)) & (c_pose < c0)


def bundle_adjust_robust(prob: BAProblem, iterations: int = 10, huber_px: float = 5.0,
                         gate_px: float = 15.0, fix_first_n=1,
                         point_prior_weight: float = 0.0,
                         odo_trans_sigma=None, odo_rot_sigma=None,
                         gate2_px=None, rtol: float = 0.0):
    """Outlier-gated BA: drop observations whose initial residual exceeds
    `gate_px`, optimize, re-gate at that optimum with `gate2_px` (default
    `gate_px`) and polish with max(iterations // 2, 2) more iterations."""
    if gate2_px is None:
        gate2_px = gate_px
    r0, _, front0 = _project_residuals(prob.R, prob.t, prob.X, prob)
    p1 = prob._replace(obs_valid=prob.obs_valid & (se3.norm(r0) < gate_px) & front0)
    kw = dict(huber_px=huber_px, fix_first_n=fix_first_n, point_prior_weight=point_prior_weight,
              odo_trans_sigma=odo_trans_sigma, odo_rot_sigma=odo_rot_sigma, rtol=rtol)
    R, t, X, _ = bundle_adjust(p1, iterations=iterations, **kw)
    r1, _, front1 = _project_residuals(R, t, X, prob)
    p2 = prob._replace(R=R, t=t, X=X, obs_valid=prob.obs_valid & (se3.norm(r1) < gate2_px) & front1)
    return bundle_adjust(p2, iterations=max(iterations // 2, 2), **kw)
