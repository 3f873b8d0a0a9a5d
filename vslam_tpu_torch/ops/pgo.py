"""SE(3) pose-graph optimization over the keyframes.

Port of `vslam_tpu/ops/pgo.py`: one SE(3) vertex per keyframe (the first
fixed), odometry edges between consecutive keyframes, loop-closure edges
with frozen consensus-DCS weights, and the unary gravity-height prior.
Dense damped Gauss-Newton: per-edge (6, 2x6) Jacobians from
`torch.func.vmap(torch.func.jacrev(...))`, scatter-added block by block
into the (6V x 6V) normal system, one Cholesky per iteration. Every
iteration runs on the device with no read back to the host.

Also the trajectory and map-point corrections: frames move by
time-interpolated keyframe translation deltas, map points rigidly with
their owning keyframe.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vslam_tpu_torch.ops import device, se3


class PGOProblem(NamedTuple):
    # Vertices
    R: torch.Tensor  # (V, 3, 3) initial keyframe rotations (cam-to-world)
    t: torch.Tensor  # (V, 3)
    v_valid: torch.Tensor  # (V,)
    # Binary edges: measurement T_ij (pose of j in i's frame)
    e_i: torch.Tensor  # (E,) int
    e_j: torch.Tensor  # (E,) int
    e_R: torch.Tensor  # (E, 3, 3)
    e_t: torch.Tensor  # (E, 3)
    e_info: torch.Tensor  # (E, 6) diagonal information (trans x3, rot x3)
    e_valid: torch.Tensor  # (E,)
    # Height prior
    gravity: torch.Tensor  # (3,)
    height: torch.Tensor  # ()
    height_info: torch.Tensor  # ()
    height_on: torch.Tensor  # () bool
    # Where True, the edge gets a frozen consensus-scaled robust weight
    # (`robust_weights`); None = every edge trusted.
    e_robust: torch.Tensor = None  # (E,) bool or None
    dcs_phi: float = 16.0


def build_odometry_edges(R, t, valid, frame_id, trans_sigma, rot_sigma):
    """Edges between consecutive keyframes by frame id (the ring's slot
    order is not temporal once it wraps), measured at the current poses.
    Returns (i, j, R_rel, t_rel, info, e_valid) over V - 1 edges."""
    V = R.shape[0]
    big = torch.iinfo(torch.int32).max
    order = torch.argsort(torch.where(valid, frame_id, big), stable=True)
    i, j = order[:-1], order[1:]
    R_rel, t_rel = se3.relative(R[i], t[i], R[j], t[j])
    row = torch.cat([torch.full((3,), 1.0 / trans_sigma**2, dtype=R.dtype, device=R.device),
                     torch.full((3,), 1.0 / rot_sigma**2, dtype=R.dtype, device=R.device)])
    info = row[None].expand(V - 1, 6).clone()
    return i, j, R_rel, t_rel, info, valid[i] & valid[j]


def _edge_residual(xi_i, xi_j, Ri, ti, Rj, tj, eR, et, sqinfo):
    """One edge's weighted residual (6,) under left perturbations of its
    two endpoint vertices."""
    dRi, dti = se3.exp_se3(xi_i)
    dRj, dtj = se3.exp_se3(xi_j)
    Ri2 = dRi @ Ri
    ti2 = (dRi @ ti[..., None])[..., 0] + dti
    Rj2 = dRj @ Rj
    tj2 = (dRj @ tj[..., None])[..., 0] + dtj
    R_ij, t_ij = se3.relative(Ri2, ti2, Rj2, tj2)
    R_err, t_err = se3.compose(*se3.inverse(eR, et), R_ij, t_ij)
    return se3.log_se3(R_err, t_err) * sqinfo


def _height_residual(xi, t, gravity, height, sqinfo):
    """One vertex's weighted gravity-height residual () under its own left
    perturbation."""
    dR, dt = se3.exp_se3(xi)
    t2 = (dR @ t[..., None])[..., 0] + dt
    return (torch.sum(t2 * gravity, dim=-1) - height) * sqinfo


_edge_residuals = torch.func.vmap(_edge_residual)
_height_residuals = torch.func.vmap(_height_residual)
_edge_jacobians = torch.func.vmap(torch.func.jacrev(_edge_residual, argnums=(0, 1)))
_height_jacobians = torch.func.vmap(torch.func.jacrev(_height_residual, argnums=0))


def _edge_sqinfo(prob: PGOProblem):
    return device.sqrt(prob.e_info) * prob.e_valid[:, None]


def _height_sqinfo(prob: PGOProblem):
    return device.sqrt(prob.height_info) * prob.height_on * prob.v_valid.to(prob.R.dtype)


def _edge_args(prob: PGOProblem, R, t):
    ei, ej = prob.e_i.long(), prob.e_j.long()
    xi0 = torch.zeros((ei.shape[0], 6), dtype=R.dtype, device=R.device)
    return (xi0, xi0, R[ei], t[ei], R[ej], t[ej], prob.e_R, prob.e_t, _edge_sqinfo(prob))


def _height_args(prob: PGOProblem, t):
    V = t.shape[0]
    xi0 = torch.zeros((V, 6), dtype=t.dtype, device=t.device)
    return (xi0, t, prob.gravity.to(t.dtype).expand(V, 3),
            torch.as_tensor(prob.height, dtype=t.dtype, device=t.device).expand(V),
            _height_sqinfo(prob))


def robust_weights(prob: PGOProblem):
    """Frozen consensus-DCS weights of the robust (loop) edges, decided
    once at the problem's initial poses: phi_eff = dcs_phi + 2 * median
    of the robust edges' chi^2, weight min(1, (phi_eff / chi2)^2), 1 for
    trusted edges. None when the problem has no robust edges."""
    if prob.e_robust is None:
        return None
    r_e = _edge_residuals(*_edge_args(prob, prob.R, prob.t))
    chi2 = torch.sum(r_e * r_e, dim=-1)
    mask = prob.e_robust & prob.e_valid
    vals = torch.sort(torch.where(mask, chi2, 1e30)).values
    cnt = torch.sum(mask)
    mid = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), min=0)
    med = torch.where(cnt > 0, vals.index_select(0, mid.reshape(1))[0], 0.0)
    phi_eff = prob.dcs_phi + 2.0 * med
    s = torch.clamp((phi_eff / torch.clamp(chi2, min=1e-12)) ** 2, max=1.0)
    return torch.where(prob.e_robust, s, 1.0)


def total_chi2(prob: PGOProblem, R, t):
    """Total weighted constraint chi^2 (edges, with the frozen robust
    weights, plus the height prior) of the pose estimate (R, t): the gain
    gate's metric."""
    r_e = _edge_residuals(*_edge_args(prob, R, t))
    r_h = _height_residuals(*_height_args(prob, t))
    chi2_e = torch.sum(r_e * r_e, dim=-1)
    if prob.e_robust is not None:
        chi2_e = chi2_e * robust_weights(prob)
    return torch.sum(chi2_e) + torch.sum(r_h * r_h)


def optimize(prob: PGOProblem, iterations: int = 20, damping: float = 1e-6):
    """Damped Gauss-Newton over all vertices, vertex 0 and invalid vertices
    fixed, `iterations` rounds. Returns (R, t)."""
    R_cur, t_cur = prob.R, prob.t
    V, dtype, dev = R_cur.shape[0], R_cur.dtype, R_cur.device
    ei, ej = prob.e_i.long(), prob.e_j.long()
    vidx = torch.arange(V, device=dev)
    mask = torch.where(vidx == 0, 0.0, prob.v_valid.to(dtype)).repeat_interleave(6)
    w_rob = robust_weights(prob)
    sq_rob = None if w_rob is None else device.sqrt(w_rob)
    eye = torch.eye(V * 6, dtype=dtype, device=dev)
    reg = (damping + 1e-8) * eye + torch.diag(1.0 - mask)
    for _ in range(iterations):
        args = _edge_args(prob, R_cur, t_cur)
        r_e = _edge_residuals(*args)
        Ji, Jj = _edge_jacobians(*args)
        if sq_rob is not None:
            r_e = r_e * sq_rob[:, None]
            Ji = Ji * sq_rob[:, None, None]
            Jj = Jj * sq_rob[:, None, None]
        hargs = _height_args(prob, t_cur)
        r_h = _height_residuals(*hargs)
        Jh = _height_jacobians(*hargs)
        Hii = torch.einsum("eab,eac->ebc", Ji, Ji)
        Hjj = torch.einsum("eab,eac->ebc", Jj, Jj)
        Hij = torch.einsum("eab,eac->ebc", Ji, Jj)
        # H as (V*V, 6, 6) blocks, block (a, b) at a*V + b; duplicate
        # edges accumulate.
        Hb = torch.zeros((V * V, 6, 6), dtype=dtype, device=dev)
        Hb.index_add_(0, ei * V + ei, Hii)
        Hb.index_add_(0, ej * V + ej, Hjj)
        Hb.index_add_(0, ei * V + ej, Hij)
        Hb.index_add_(0, ej * V + ei, Hij.transpose(-1, -2))
        Hb.index_add_(0, vidx * V + vidx, Jh[:, :, None] * Jh[:, None, :])
        H = Hb.view(V, V, 6, 6).permute(0, 2, 1, 3).reshape(V * 6, V * 6)
        g = torch.zeros((V, 6), dtype=dtype, device=dev)
        g.index_add_(0, ei, torch.einsum("eab,ea->eb", Ji, r_e))
        g.index_add_(0, ej, torch.einsum("eab,ea->eb", Jj, r_e))
        g = (g + Jh * r_h[:, None]).reshape(V * 6) * mask
        H = H * mask[:, None] * mask[None, :] + reg
        L = torch.linalg.cholesky_ex(H)[0]
        delta = -torch.cholesky_solve(g[:, None], L)[:, 0]
        dR, dt = se3.exp_se3((delta * mask).reshape(V, 6))
        R_next = dR @ R_cur
        t_cur = (dR @ t_cur[..., None])[..., 0] + dt
        R_cur = se3.orthonormalize(R_next)
    return R_cur, t_cur


def correct_trajectory(frame_ids, frame_R, frame_t, kf_frame_ids, kf_valid,
                       kf_R_old, kf_t_old, kf_R_new, kf_t_new):
    """Frames move by the keyframe translation deltas, interpolated by
    frame id between the keyframes around them (a frame before the first
    or after the last keyframe takes that keyframe's delta). Returns
    (frame_R, corrected frame_t)."""
    d_t = kf_t_new - kf_t_old
    big = torch.iinfo(torch.int32).max
    kf_ids = torch.where(kf_valid, kf_frame_ids, big)
    order = torch.argsort(kf_ids, stable=True)
    kf_ids_s = kf_ids[order]
    d_t_s = d_t[order]
    n_kf = torch.sum(kf_valid)
    # The JAX package compares f32 frame ids with int32 keyframe ids in f32.
    ids_f = kf_ids_s.to(torch.float32)
    frame_ids = frame_ids.to(torch.float32)
    idx = torch.searchsorted(ids_f, frame_ids, right=True) - 1
    lo = torch.minimum(torch.clamp(idx, min=0), n_kf - 1)
    hi = torch.minimum(torch.clamp(idx + 1, min=0), n_kf - 1)
    id_lo = kf_ids_s[lo]
    id_hi = kf_ids_s[hi]
    denom = torch.clamp(id_hi - id_lo, min=1).to(torch.float32)
    alpha = torch.clamp((frame_ids - id_lo.to(torch.float32)) / denom, 0.0, 1.0)
    delta = d_t_s[lo] * (1.0 - alpha[:, None]) + d_t_s[hi] * alpha[:, None]
    return frame_R, frame_t + delta


def correct_map_points(points, point_kf, kf_valid, kf_R_old, kf_t_old, kf_R_new, kf_t_new):
    """Map points move rigidly with their owning keyframe:
    X' = T_new o T_old^-1 o X."""
    Ro_inv, to_inv = se3.inverse(kf_R_old, kf_t_old)
    Rd, td = se3.compose(kf_R_new, kf_t_new, Ro_inv, to_inv)
    k = torch.clamp(point_kf.long(), 0, kf_R_old.shape[0] - 1)
    moved = (Rd[k] @ points[..., None])[..., 0] + td[k]
    return torch.where(kf_valid[k][:, None], moved, points)
