"""SE(3)/SO(3) Lie group ops in the quaternion representation.

Port of kbslam/geom/se3.py. Tangent convention as there (and Sophus):
``xi = [upsilon(3), omega(3)]``. All ops broadcast over leading batch
dimensions; small-angle branches are selected with ``torch.where``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-8


class SE3(NamedTuple):
    """Rigid transform as unit quaternion (wxyz) + translation.

    ``q``: [..., 4] (w, x, y, z), ``t``: [..., 3]; acts as ``R(q) x + t``.
    """

    q: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "SE3":
        # built from ones/zeros: writing the scalar 1 into a CUDA tensor
        # is a copy from the host, which waits for the device
        shape = tuple(batch_shape)
        q = torch.cat([torch.ones(shape + (1,), dtype=dtype, device=device),
                       torch.zeros(shape + (3,), dtype=dtype, device=device)],
                      dim=-1)
        t = torch.zeros(shape + (3,), dtype=dtype, device=device)
        return SE3(q, t)

    def compose(self, other: "SE3") -> "SE3":
        """self * other (apply ``other`` first, then ``self``)."""
        return SE3(quat_mul(self.q, other.q),
                   quat_rotate(self.q, other.t) + self.t)

    def __matmul__(self, other: "SE3") -> "SE3":
        return self.compose(other)

    def inverse(self) -> "SE3":
        q_inv = quat_conj(self.q)
        return SE3(q_inv, -quat_rotate(q_inv, self.t))

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Transform points [..., 3]."""
        return quat_rotate(self.q, points) + self.t

    def rotation_matrix(self) -> torch.Tensor:
        return quat_to_matrix(self.q)

    def matrix(self) -> torch.Tensor:
        """[..., 4, 4] homogeneous matrix."""
        R = quat_to_matrix(self.q)
        top = torch.cat([R, self.t[..., :, None]], dim=-1)
        bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype,
                             device=top.device)
        bottom[..., 3] = 1.0
        return torch.cat([top, bottom], dim=-2)

    @staticmethod
    def from_matrix(M: torch.Tensor) -> "SE3":
        return SE3(matrix_to_quat(M[..., :3, :3]), M[..., :3, 3])

    @staticmethod
    def from_rotation_translation(R: torch.Tensor, t: torch.Tensor) -> "SE3":
        return SE3(matrix_to_quat(R), t)

    def normalize(self) -> "SE3":
        q = self.q / torch.linalg.vector_norm(self.q, dim=-1, keepdim=True)
        # canonical sign (w >= 0) so storage is unique
        sign = torch.where(q[..., :1] < 0, -1.0, 1.0)
        return SE3(q * sign, self.t)

    @staticmethod
    def exp(xi: torch.Tensor) -> "SE3":
        """Exponential map from tangent [..., 6] = [upsilon, omega]."""
        upsilon = xi[..., :3]
        omega = xi[..., 3:]
        theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
        theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))

        q = quat_exp(omega)
        # V = I + (1-cos th)/th^2 [w]x + (th - sin th)/th^3 [w]x^2
        small = theta2 < _EPS
        A = torch.where(small, 0.5 - theta2 / 24.0,
                        (1.0 - torch.cos(theta)) / theta2)
        B = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                        (theta - torch.sin(theta)) / (theta2 * theta))
        wx = cross_matrix(omega)
        V = (torch.eye(3, dtype=xi.dtype, device=xi.device)
             + A[..., None] * wx + B[..., None] * (wx @ wx))
        t = torch.einsum("...ij,...j->...i", V, upsilon)
        return SE3(q, t)

    def log(self) -> torch.Tensor:
        """Logarithm map to tangent [..., 6] = [upsilon, omega]."""
        omega = quat_log(self.q)
        theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
        theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
        half = 0.5 * theta
        small = theta2 < _EPS
        # V^-1 = I - 1/2 [w]x + C [w]x^2, C = (1 - th/2 cot(th/2)) / th^2
        C = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                        (1.0 - half * torch.cos(half) / torch.sin(half))
                        / theta2)
        wx = cross_matrix(omega)
        V_inv = (torch.eye(3, dtype=self.t.dtype, device=self.t.device)
                 - 0.5 * wx + C[..., None] * (wx @ wx))
        upsilon = torch.einsum("...ij,...j->...i", V_inv, self.t)
        return torch.cat([upsilon, omega], dim=-1)

    def translation_norm(self) -> torch.Tensor:
        return torch.linalg.vector_norm(self.t, dim=-1)

    def rotation_angle(self) -> torch.Tensor:
        """|log(R)| in radians."""
        return torch.linalg.vector_norm(quat_log(self.q), dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4]."""
    qv = q[..., 1:]
    qw = q[..., :1]
    uv = _cross(qv, v)
    uuv = _cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def quat_exp(omega: torch.Tensor) -> torch.Tensor:
    """so(3) -> unit quaternion."""
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    half = 0.5 * theta
    small = theta2 < _EPS
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    s = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    return torch.cat([w, s * omega], dim=-1)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> so(3) rotation vector."""
    sign = torch.where(q[..., :1] < 0, -1.0, 1.0)
    q = q * sign
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    vn2 = torch.sum(q[..., 1:] * q[..., 1:], dim=-1, keepdim=True)
    vn = torch.sqrt(torch.clamp(vn2, min=_EPS * _EPS))
    theta = 2.0 * torch.atan2(vn, w)
    small = vn2 < _EPS
    scale = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), theta / vn)
    return scale * q[..., 1:]


def cross_matrix(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ], dim=-2)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion (wxyz), branch-free:
    the four-candidate construction, keeping the candidate with the
    largest denominator (kbslam/geom/se3.py:227-289)."""
    m = R
    t = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]

    def _cand(r_arg, comps):
        r = torch.sqrt(torch.clamp(r_arg, min=_EPS))
        s = 0.5 / r
        return torch.stack([0.5 * r if c is None else c * s for c in comps],
                           dim=-1)

    c_w = _cand(1.0 + t, [None,
                          m[..., 2, 1] - m[..., 1, 2],
                          m[..., 0, 2] - m[..., 2, 0],
                          m[..., 1, 0] - m[..., 0, 1]])
    c_x = _cand(1.0 + m00 - m11 - m22, [m[..., 2, 1] - m[..., 1, 2],
                                        None,
                                        m[..., 0, 1] + m[..., 1, 0],
                                        m[..., 0, 2] + m[..., 2, 0]])
    c_y = _cand(1.0 - m00 + m11 - m22, [m[..., 0, 2] - m[..., 2, 0],
                                        m[..., 0, 1] + m[..., 1, 0],
                                        None,
                                        m[..., 1, 2] + m[..., 2, 1]])
    c_z = _cand(1.0 - m00 - m11 + m22, [m[..., 1, 0] - m[..., 0, 1],
                                        m[..., 0, 2] + m[..., 2, 0],
                                        m[..., 1, 2] + m[..., 2, 1],
                                        None])
    scores = torch.stack([t, m00, m11, m22], dim=-1)
    best = torch.argmax(scores, dim=-1)
    cands = torch.stack([c_w, c_x, c_y, c_z], dim=-2)
    q = torch.gather(cands, -2,
                     best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    sign = torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q * sign
