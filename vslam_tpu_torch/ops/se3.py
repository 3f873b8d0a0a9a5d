"""SO(3)/SE(3) utilities: hat/vee, exp/log, composition.

Port of `vslam_tpu/ops/se3.py`: the same closed forms, batched over
leading axes. Poses `(R, t)` are camera-to-world (`x_w = R @ x_c + t`).
"""

from __future__ import annotations

import torch


def cross(a, b):
    """Cross product over the last axis (broadcasting)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def norm(x, dim=-1, keepdim=False):
    """Euclidean norm as sqrt(sum(x^2)), the form `jnp.linalg.norm` takes."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def eye3(like, batch=()):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(*batch, 3, 3)


def hat(w):
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W):
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def exp_so3(w):
    """Rodrigues formula with the series window of the reference port."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-3
    safe2 = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(safe2)
    W = hat(w)
    W2 = W @ W
    a = torch.where(small, 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0,
                    torch.sin(theta) / theta)
    sh = torch.sin(theta * 0.5)
    b = torch.where(
        small, 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
        2.0 * sh * sh / safe2,
    )
    return eye3(w, W.shape[:-2]) + a[..., None, None] * W + b[..., None, None] * W2


def log_so3(R):
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3); atan2 form with
    the near-pi branch of `vslam_tpu.ops.se3.log_so3`."""
    a = vee(R - R.transpose(-1, -2)) * 0.5
    s2 = torch.sum(a * a, dim=-1)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    s_safe = torch.sqrt(torch.where(s2 < 1e-3, 1.0, s2))
    sin_t = torch.where(s2 < 1e-3, torch.sqrt(torch.clamp(s2, min=0.0) + 1e-20), s_safe)
    theta = torch.atan2(sin_t, cos_t)
    small = (s2 < 1e-3) & (cos_t > 0.0)
    factor = torch.where(small, 1.0 + s2 / 6.0 + 0.075 * s2 * s2, theta / s_safe)
    w_generic = a * factor[..., None]
    B = (R + eye3(R, R.shape[:-2])) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp(diag, min=1e-12))
    k = torch.argmax(axis, dim=-1)

    def sgn(x):
        s = torch.sign(x)
        return torch.where(s == 0, 1.0, s)

    s01, s02, s12 = sgn(B[..., 0, 1]), sgn(B[..., 0, 2]), sgn(B[..., 1, 2])
    a0, a1, a2 = axis[..., 0], axis[..., 1], axis[..., 2]
    branches = torch.stack(
        [
            torch.stack([a0, s01 * a1, s02 * a2], dim=-1),
            torch.stack([s01 * a0, a1, s12 * a2], dim=-1),
            torch.stack([s02 * a0, s12 * a1, a2], dim=-1),
        ],
        dim=-2,
    )
    axis_fixed = torch.gather(
        branches, -2, k[..., None, None].expand(*k.shape, 1, 3)
    )[..., 0, :]
    w_pi = axis_fixed * theta[..., None]
    near_pi = theta > torch.pi - 1e-3
    return torch.where(small[..., None], a,
                       torch.where(near_pi[..., None], w_pi, w_generic))


_EPS = 1e-8


def quat_from_matrix(R):
    """(..., 3, 3) -> quaternion (..., 4) as (qx, qy, qz, qw), qw >= 0:
    Shepperd's method, the best-conditioned of four constructions picked
    per matrix (first on ties), as the JAX package computes it."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def half_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 0.5

    qw0 = half_sqrt(1.0 + tr)
    q0 = torch.stack([m21 - m12, m02 - m20, m10 - m01, 4.0 * qw0 * qw0], -1) / (
        4.0 * qw0[..., None])
    qx1 = half_sqrt(1.0 + m00 - m11 - m22)
    q1 = torch.stack([4.0 * qx1 * qx1, m01 + m10, m02 + m20, m21 - m12], -1) / (
        4.0 * qx1[..., None])
    qy2 = half_sqrt(1.0 - m00 + m11 - m22)
    q2 = torch.stack([m01 + m10, 4.0 * qy2 * qy2, m12 + m21, m02 - m20], -1) / (
        4.0 * qy2[..., None])
    qz3 = half_sqrt(1.0 - m00 - m11 + m22)
    q3 = torch.stack([m02 + m20, m12 + m21, 4.0 * qz3 * qz3, m10 - m01], -1) / (
        4.0 * qz3[..., None])
    cand = torch.stack([q0, q1, q2, q3], dim=-2)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], -1)
    idx = torch.argmax(scores, dim=-1)
    q = torch.take_along_dim(cand, idx[..., None, None], dim=-2)[..., 0, :]
    q = q / norm(q, keepdim=True)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def matrix_from_quat(q):
    """Quaternion (qx, qy, qz, qw) -> rotation matrix (..., 3, 3)."""
    q = q / norm(q, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], dim=-2)


def compose(Ra, ta, Rb, tb):
    """(Ra, ta) o (Rb, tb): apply b then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def inverse(R, t):
    """Inverse rigid transform."""
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def rotate_rows(R, pts):
    """R applied to each row of pts (..., N, 3) as broadcast arithmetic."""
    return (
        pts[..., 0:1] * R[..., None, :, 0]
        + pts[..., 1:2] * R[..., None, :, 1]
        + pts[..., 2:3] * R[..., None, :, 2]
    )


def transform_points(R, t, pts):
    """Apply (R, t) to points (..., N, 3)."""
    return rotate_rows(R, pts) + t[..., None, :]


def relative(Ra, ta, Rb, tb):
    """T_a^{-1} o T_b : pose of b expressed in a's frame."""
    Rai, tai = inverse(Ra, ta)
    return compose(Rai, tai, Rb, tb)


def exp_se3(xi):
    """se(3) exp: (..., 6) [rho, phi] -> (R, t), left-Jacobian closed form.
    Branch-free (double-where on the sqrt), so it runs under
    `torch.func.jacrev` / `vmap` and its gradient is finite at 0."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = exp_so3(phi)
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < 1e-3
    safe2 = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(safe2)
    W = hat(phi)
    W2 = W @ W
    sh = torch.sin(theta * 0.5)
    b = torch.where(small, 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0, 2.0 * sh * sh / safe2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / torch.where(small, 1.0, theta2 * theta))
    V = eye3(xi, W.shape[:-2]) + b[..., None, None] * W + c[..., None, None] * W2
    return R, (V @ rho[..., None])[..., 0]


def log_se3(R, t):
    """(R, t) -> se(3) vector (..., 6) [rho, phi]; the series
    1/12 + theta^2/720 below theta^2 = 1e-3, where (1 - a/(2b)) cancels."""
    phi = log_so3(R)
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < 1e-3
    safe2 = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(safe2)
    W = hat(phi)
    W2 = W @ W
    a = torch.sin(theta) / theta
    sh = torch.sin(theta * 0.5)
    b = torch.where(small, 0.5, 2.0 * sh * sh / safe2)
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - a / (2.0 * b)) / safe2)
    Vinv = eye3(R, R.shape[:-2]) - 0.5 * W + coef[..., None, None] * W2
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def orthonormalize(R):
    """Project onto SO(3) via the SVD-based polar decomposition."""
    from vslam_tpu_torch.ops import linalg

    return linalg.polar3x3(R)


def renormalize_rotation(R):
    """Two Newton polar iterations for near-orthogonal rotations."""
    from vslam_tpu_torch.ops import linalg

    return linalg.polar_newton3x3(R)


def identity_pose(dtype=torch.float32, batch=(), device="cpu"):
    """(R, t): identity rotations (*batch, 3, 3) and zero translations."""
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch, 3, 3).contiguous()
    return R, torch.zeros((*batch, 3), dtype=dtype, device=device)
