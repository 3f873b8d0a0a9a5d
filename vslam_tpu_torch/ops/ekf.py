"""6-state (position + velocity) EKF.

Port of the filter in `vslam_tpu/ops/ekf.py:41-180`: `initialize`,
`predict`, `update_visual_gated`, `update_height`, `clamp_step`, with the
same broadcast-arithmetic products and analytic small inverses, and the
RTS backward smoother over the per-frame snapshots (`ops/ekf.py:181-296`)
in both forms: sequential with `pinv` gains, and the default affine-map
form whose suffix composition is a log-depth doubling scan. State
layout: x = [px, py, pz, vx, vy, vz], P (6, 6).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vslam_tpu_torch.ops import device, se3


class EKFState(NamedTuple):
    x: torch.Tensor  # (6,)
    P: torch.Tensor  # (6, 6)
    initialized: torch.Tensor  # () bool
    last_time: torch.Tensor  # () f32


class EKFSnapshot(NamedTuple):
    """Per-frame snapshots for the RTS smoother, stacked (N, ...)."""

    x_pred: torch.Tensor  # (N, 6)
    P_pred: torch.Tensor  # (N, 6, 6)
    x_filt: torch.Tensor  # (N, 6)
    P_filt: torch.Tensor  # (N, 6, 6)
    dt: torch.Tensor  # (N,)
    frame_id: torch.Tensor  # (N,) int32


def initialize(pos, timestamp):
    """P = diag(1e-3 x3, 1e-2 x3), velocity zero."""
    dt, dev = pos.dtype, pos.device
    x = torch.cat([pos, torch.zeros(3, dtype=dt, device=dev)])
    P = torch.diag(device.constant((1e-3,) * 3 + (1e-2,) * 3, dt, dev))
    ts = torch.as_tensor(timestamp, dtype=dt, device=dev).reshape(())
    return EKFState(x, P, torch.ones((), dtype=torch.bool, device=dev), ts)


def _bmm(a, b):
    """Small-matrix product as broadcast arithmetic."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def _mv(a, v):
    return torch.sum(a * v[..., None, :], dim=-1)


def _inv_small(S):
    """Analytic inverse of the (1,1)/(3,3) innovation covariances."""
    if S.shape[-1] == 1:
        return 1.0 / S
    a, b, c = S[0, 0], S[0, 1], S[0, 2]
    d, e, f = S[1, 0], S[1, 1], S[1, 2]
    g, h, i = S[2, 0], S[2, 1], S[2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    adj = torch.stack([torch.stack([A, B, C]), torch.stack([D, E, F]), torch.stack([G, H, I])])
    return adj / det


def predict(state: EKFState, dt, sigma_a=1.0, decay=0.95):
    """Constant-velocity predict with velocity decay; identity when
    dt <= 0, dt >= 1 or the filter is not initialized."""
    x = state.x
    do = (dt > 0.0) & (dt < 1.0) & state.initialized
    dts = torch.where(do, dt, 0.0).to(x.dtype)
    dec = torch.where(do, decay, 1.0).to(x.dtype)
    I3 = torch.eye(3, dtype=x.dtype, device=x.device)
    Z3 = torch.zeros_like(I3)
    F = torch.cat([torch.cat([I3, I3 * dts], 1), torch.cat([Z3, I3 * dec], 1)], 0)
    x_new = _mv(F, x)
    q11 = 0.25 * dts**4 * sigma_a**2
    q12 = 0.5 * dts**3 * sigma_a**2
    q22 = dts**2 * sigma_a**2
    Q = torch.cat([torch.cat([q11 * I3, q12 * I3], 1), torch.cat([q12 * I3, q22 * I3], 1)], 0)
    P_new = _bmm(_bmm(F, state.P), F.T) + Q
    return state._replace(x=x_new, P=P_new)


def _joseph_update(x, P, y, H, Rm):
    S = _bmm(_bmm(H, P), H.T) + Rm
    K = _bmm(_bmm(P, H.T), _inv_small(S))
    x_new = x + _mv(K, y)
    IKH = torch.eye(6, dtype=x.dtype, device=x.device) - _bmm(K, H)
    P_new = _bmm(_bmm(IKH, P), IKH.T) + _bmm(_bmm(K, Rm), K.T)
    return x_new, P_new


def update_visual(state: EKFState, z_pos, sigma_vis, enabled=True):
    """3D position measurement update with scalar sigma."""
    x = state.x
    H = torch.cat([torch.eye(3, dtype=x.dtype, device=x.device),
                   torch.zeros(3, 3, dtype=x.dtype, device=x.device)], 1)
    Rm = torch.eye(3, dtype=x.dtype, device=x.device) * (sigma_vis**2)
    x_new, P_new = _joseph_update(x, state.P, z_pos - x[:3], H, Rm)
    on = enabled & state.initialized
    return state._replace(x=torch.where(on, x_new, x), P=torch.where(on, P_new, state.P))


def update_visual_gated(state: EKFState, z_pos, sigma_vis, gate=0.3, enabled=True):
    """Innovation gating: past the gate, sigma = innovation * 0.5."""
    innovation = se3.norm(z_pos - state.x[:3])
    sigma = torch.where(innovation < gate, sigma_vis, innovation * 0.5)
    return update_visual(state, z_pos, sigma, enabled=enabled)


def update_height(state: EKFState, gravity_world, h_target, sigma_h, enabled=True):
    """Scalar height update along gravity."""
    x = state.x
    H = torch.cat([gravity_world, torch.zeros(3, dtype=x.dtype, device=x.device)])[None]
    Rm = torch.full((1, 1), sigma_h**2, dtype=x.dtype, device=x.device)
    h_pred = torch.sum(gravity_world * x[:3])
    y = h_target.reshape(1).to(x.dtype) - h_pred
    x_new, P_new = _joseph_update(x, state.P, y, H, Rm)
    on = enabled & state.initialized
    return state._replace(x=torch.where(on, x_new, x), P=torch.where(on, P_new, state.P))


def clamp_step(state: EKFState, prev_pos, dt, max_step=0.10):
    """Per-frame position step clamp + velocity rewrite.
    Returns (state, clamped_pos)."""
    delta = state.x[:3] - prev_pos
    step = se3.norm(delta)
    clamp = (step > max_step) & (step > 1e-6)
    scale = torch.where(clamp, max_step / torch.clamp(step, min=1e-9), 1.0)
    delta_c = delta * scale
    pos_c = prev_pos + delta_c
    vel_c = delta_c / torch.clamp(dt, min=0.01)
    x_new = torch.where(clamp, torch.cat([pos_c, vel_c]), state.x)
    return state._replace(x=x_new), x_new[:3]


def _transitions(dt, decay):
    """Constant-velocity transitions F (N, 6, 6) for the steps dt (N,)."""
    n = dt.shape[0]
    I3 = torch.eye(3, dtype=dt.dtype, device=dt.device).expand(n, 3, 3)
    top = torch.cat([I3, I3 * dt[:, None, None]], -1)
    bottom = torch.cat([torch.zeros_like(I3), I3 * decay], -1)
    return torch.cat([top, bottom], -2)


def _smoother_gains_pinv(snapshots: EKFSnapshot, decay):
    """C_k = P_filt[k] F_{k+1}^T pinv(P_pred[k+1]), k = 0..N-2, with
    the JAX package's default pinv cutoff (10 * 6 * eps)."""
    N = snapshots.dt.shape[0]
    F = _transitions(snapshots.dt[1:], decay)
    rtol = 10.0 * 6 * torch.finfo(snapshots.P_pred.dtype).eps
    P_inv = torch.linalg.pinv(snapshots.P_pred[1:], rtol=rtol)
    return snapshots.P_filt[: N - 1] @ F.transpose(-1, -2) @ P_inv


def rts_smooth(snapshots: EKFSnapshot, valid, decay=0.95):
    """Rauch-Tung-Striebel backward smoother, sequential form with `pinv`
    gains (`Slam.cpp:1761-1810`). The smoothed mean never reads the
    smoothed covariance, so only the mean is carried: x_s[k] = x_filt[k]
    + C_k (x_s[k+1] - x_pred[k+1]) where valid[k], else x_filt[k].
    Returns smoothed positions (N, 3)."""
    N = snapshots.dt.shape[0]
    C = _smoother_gains_pinv(snapshots, decay)
    xs = [snapshots.x_filt[N - 1]]
    for k in range(N - 2, -1, -1):
        x_s = snapshots.x_filt[k] + C[k] @ (xs[-1] - snapshots.x_pred[k + 1])
        xs.append(torch.where(valid[k], x_s, snapshots.x_filt[k]))
    return torch.stack(xs[::-1])[:, :3]


def suffix_compose(A, a):
    """Inclusive suffix scan of affine maps x -> a_k + A_k x (A (n, m, m),
    a (n, m)): entry k of the result is map_k o map_{k+1} o ... o map_{n-1}.
    Log-depth doubling (Hillis-Steele): in round d, entry k takes its own
    map composed with entry k + d's, for every k with k + d < n at once."""
    n = A.shape[0]
    d = 1
    while d < n:
        A_lo, a_lo = A[: n - d], a[: n - d]
        A = torch.cat([A_lo @ A[d:], A[n - d:]])
        a = torch.cat([a_lo + (A_lo @ a[d:, :, None])[..., 0], a[n - d:]])
        d *= 2
    return A, a


def rts_smooth_assoc(snapshots: EKFSnapshot, valid, decay=0.95):
    """The RTS smoother as a composition of affine maps (the default form,
    `EKFConfig.rts_parallel`): with gain C_k = P_filt[k] F_{k+1}^T
    P_pred[k+1]^-1 (unrolled Cholesky inverse with a 1e-7 trace-relative
    shift, entries clamped to +-8), x_s[k] = a_k + A_k x_s[k+1] where
    A_k = valid[k] ? C_k : 0 and a_k = x_filt[k] - A_k x_pred[k+1]. The
    backward recursion is then one suffix composition (`suffix_compose`),
    log-depth in N; it matches `rts_smooth` to float round-off.
    Returns smoothed positions (N, 3)."""
    from vslam_tpu_torch.ops.linalg import inv_spd_small

    N = snapshots.dt.shape[0]
    if N == 1:
        return snapshots.x_filt[:, :3]
    F = _transitions(snapshots.dt[1:], decay)
    P_pred_inv = inv_spd_small(snapshots.P_pred[1:], shift_rel=1e-7)
    C = torch.clamp(snapshots.P_filt[: N - 1] @ F.transpose(-1, -2) @ P_pred_inv, -8.0, 8.0)
    A = torch.where(valid[: N - 1, None, None], C, 0.0)
    a = snapshots.x_filt[: N - 1] - (A @ snapshots.x_pred[1:, :, None])[..., 0]
    A_cum, a_cum = suffix_compose(A, a)
    xs = a_cum + (A_cum @ snapshots.x_filt[N - 1][:, None])[..., 0]
    return torch.cat([xs, snapshots.x_filt[N - 1:]])[:, :3]
