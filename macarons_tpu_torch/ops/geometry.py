"""Camera and coordinate geometry (port of macarons_tpu/ops/geometry.py).

PyTorch3D conventions, as in the JAX package: row vectors, +X left, +Y up,
+Z into the screen, ``X_view = X_world @ R + T``. All functions are batched
over leading dimensions. Matmuls here run in full float32 (TF32 is off, see
utils.device.resolve_device).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch


def get_cartesian_coords(r, elev, azim, in_degrees: bool = False):
    """x = cos(elev) sin(azim), y = sin(elev), z = cos(elev) cos(azim).

    r, elev, azim broadcastable tensors shaped (..., 1) or (...). Returns
    (..., 3)."""
    factor = math.pi / 180.0 if in_degrees else 1.0
    e = elev * factor
    a = azim * factor
    X = torch.stack((torch.cos(e) * torch.sin(a), torch.sin(e),
                     torch.cos(e) * torch.cos(a)), dim=-1)
    r = torch.as_tensor(r, dtype=X.dtype, device=X.device)
    if r.ndim == X.ndim - 1:
        r = r[..., None]
    return r * X


def get_spherical_coords(X):
    """(r, elev, azim) of cartesian points (..., 3), clamped like the JAX
    package: elev = asin(y/r), azim = acos(z/(r cos elev)) signed by x."""
    r = torch.linalg.norm(X, dim=-1)
    safe_r = torch.clamp(r, min=1e-20)
    sin_elev = torch.clamp(X[..., 1] / safe_r, -1.0, 1.0)
    elev = torch.asin(sin_elev)
    denom = torch.clamp(safe_r * torch.cos(elev), min=1e-20)
    cos_azim = torch.clamp(X[..., 2] / denom, -1.0, 1.0)
    azim = torch.acos(cos_azim)
    azim = torch.where(X[..., 0] < 0, -azim, azim)
    return r, elev, azim


def sample_cameras_on_sphere(n_X: int, radius: float, device=None,
                             dtype=torch.float32):
    """Deterministic sphere lattice of camera positions: n_X (a square)
    points, elevations and azimuths each over 0.9 of their range.
    Returns (n_X, 3)."""
    delta_theta = 0.9 * math.pi
    delta_phi = 0.9 * 2 * math.pi
    n_dim = int(math.sqrt(n_X))
    d_theta = 2 * delta_theta / (n_dim - 1)
    d_phi = 2 * delta_phi / (n_dim - 1)
    inc = torch.linspace(0, n_dim - 1, n_dim, dtype=dtype, device=device)
    thetas = (-delta_theta + inc * d_theta)[:, None].expand(n_dim, n_dim)
    phis = (-delta_phi + inc * d_phi)[None, :].expand(n_dim, n_dim)
    X = torch.stack((torch.cos(thetas) * torch.sin(phis), torch.sin(thetas),
                     torch.cos(thetas) * torch.cos(phis)), dim=2)
    return radius * X.reshape(-1, 3)


def dot_prod(a, b, keepdim: bool = False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def normalize(v, eps: float = 1e-5):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def look_at_rotation(camera_position, at, up=None):
    """Rotation whose columns are the camera x/y/z axes in world coords
    (PyTorch3D look_at_rotation, degenerate up handled the same way)."""
    if up is None:
        up = torch.zeros_like(camera_position)
        up[..., 1] = 1.0
    z_axis = normalize(at - camera_position)
    x_axis = normalize(torch.linalg.cross(up, z_axis, dim=-1))
    y_axis = normalize(torch.linalg.cross(z_axis, x_axis, dim=-1))
    is_close = torch.all(torch.abs(x_axis) < 5e-3, dim=-1, keepdim=True)
    replacement = normalize(torch.linalg.cross(y_axis, z_axis, dim=-1))
    x_axis = torch.where(is_close, replacement, x_axis)
    R = torch.stack((x_axis, y_axis, z_axis), dim=-2)
    return R.transpose(-1, -2)


def look_at_view_transform(eye, at):
    """(R, T) of cameras at ``eye`` (n, 3) looking at ``at`` (n, 3);
    ``T = -eye @ R``."""
    R = look_at_rotation(eye, at)
    T = -torch.einsum("...i,...ij->...j", eye, R)
    return R, T


def camera_center_from_RT(R, T):
    """C = -T @ R^T."""
    return -torch.einsum("...j,...ij->...i", T, R)


@dataclass
class FoVCamera:
    """Batched FoV-perspective camera. R (..., 3, 3), T (..., 3); fov in
    degrees, znear, zfar, aspect_ratio shaped like the batch (...)."""

    R: torch.Tensor
    T: torch.Tensor
    fov: torch.Tensor
    znear: torch.Tensor
    zfar: torch.Tensor
    aspect_ratio: torch.Tensor

    @classmethod
    def create(cls, R, T, fov=60.0, znear=0.5, zfar=100.0, aspect_ratio=1.0):
        batch = R.shape[:-2]

        def b(v):
            return torch.as_tensor(v, dtype=R.dtype, device=R.device).expand(
                batch).clone()

        return cls(R, T.to(R.dtype), b(fov), b(znear), b(zfar),
                   b(aspect_ratio))

    def __getitem__(self, idx) -> "FoVCamera":
        return FoVCamera(self.R[idx], self.T[idx], self.fov[idx],
                         self.znear[idx], self.zfar[idx],
                         self.aspect_ratio[idx])

    def world_to_view(self, pts):
        """(..., N, 3) world points -> view coords."""
        return torch.matmul(pts, self.R) + self.T[..., None, :]

    def view_to_world(self, pts_view):
        return torch.matmul(pts_view - self.T[..., None, :],
                            self.R.transpose(-1, -2))

    def camera_center(self):
        return camera_center_from_RT(self.R, self.T)

    def project_view(self, pts_view):
        """View-space points -> (x_ndc, y_ndc, z_ndc)."""
        tan_half = torch.tan(torch.deg2rad(self.fov) / 2.0)[..., None]
        z = pts_view[..., 2]
        safe_z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
        x_ndc = pts_view[..., 0] / (safe_z * tan_half
                                    * self.aspect_ratio[..., None])
        y_ndc = pts_view[..., 1] / (safe_z * tan_half)
        zf = self.zfar[..., None]
        zn = self.znear[..., None]
        z_ndc = zf / (zf - zn) - (zf * zn) / ((zf - zn) * safe_z)
        return torch.stack((x_ndc, y_ndc, z_ndc), dim=-1)

    def transform_points(self, pts):
        return self.project_view(self.world_to_view(pts))

    def unproject_ndc_depth(self, ndc_points):
        """(x_ndc, y_ndc, view depth) -> world points."""
        tan_half = torch.tan(torch.deg2rad(self.fov) / 2.0)[..., None]
        depth = ndc_points[..., 2]
        x_view = ndc_points[..., 0] * depth * tan_half \
            * self.aspect_ratio[..., None]
        y_view = ndc_points[..., 1] * depth * tan_half
        return self.view_to_world(torch.stack((x_view, y_view, depth), dim=-1))


@dataclass
class OrthoCamera:
    """Batched orthographic camera (PyTorch3D FoVOrthographicCameras
    defaults: NDC box [-1, 1]^2, scale 1), as the GT generators use it.
    R (..., 3, 3), T (..., 3); znear, zfar shaped like the batch."""

    R: torch.Tensor
    T: torch.Tensor
    znear: torch.Tensor
    zfar: torch.Tensor

    @classmethod
    def create(cls, R, T, znear=0.5, zfar=100.0):
        batch = R.shape[:-2]

        def b(v):
            return torch.as_tensor(v, dtype=R.dtype, device=R.device).expand(
                batch).clone()

        return cls(R, T.to(R.dtype), b(znear), b(zfar))

    def world_to_view(self, pts):
        return torch.matmul(pts, self.R) + self.T[..., None, :]

    def view_to_world(self, pts_view):
        return torch.matmul(pts_view - self.T[..., None, :],
                            self.R.transpose(-1, -2))

    def camera_center(self):
        return camera_center_from_RT(self.R, self.T)

    def project_view(self, pts_view):
        """View-space points -> (x, y, (z - znear) / (zfar - znear))."""
        zf = self.zfar[..., None]
        zn = self.znear[..., None]
        z_ndc = (pts_view[..., 2] - zn) / (zf - zn)
        return torch.stack((pts_view[..., 0], pts_view[..., 1], z_ndc), dim=-1)

    def transform_points(self, pts):
        return self.project_view(self.world_to_view(pts))

    def unproject_ndc_depth(self, ndc_points):
        """(x, y, view depth) -> world points."""
        return self.view_to_world(ndc_points[..., :3])


def ndc_pixel_grid(height: int, width: int, device=None,
                   dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel NDC coords: x = W/s - 2j/(s-1), y = H/s - 2i/(s-1) with
    s = min(H, W). Returns (ndc_x, ndc_y), each (H, W)."""
    s = min(height, width)
    j = torch.arange(width, dtype=dtype, device=device)[None, :]
    i = torch.arange(height, dtype=dtype, device=device)[:, None]
    ndc_x = (width / s - 2.0 * j / (s - 1)).expand(height, width)
    ndc_y = (height / s - 2.0 * i / (s - 1)).expand(height, width)
    return ndc_x, ndc_y


def ndc_bounds(height: int, width: int) -> Tuple[float, float, float, float]:
    """(min_x, max_x, min_y, max_y) of the NDC pixel grid."""
    s = min(height, width)
    max_x = width / s
    min_x = width / s - 2.0 * (width - 1) / (s - 1)
    max_y = height / s
    min_y = height / s - 2.0 * (height - 1) / (s - 1)
    return float(min_x), float(max_x), float(min_y), float(max_y)


# ---------------------------------------------------------------------------
# Rotation algebra (pose composition in the depth module)
# ---------------------------------------------------------------------------


def quaternion_from_matrix(R):
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) (w, x, y, z).

    Branch-free like the JAX package: of Shepperd's four candidates, the one
    whose diagonal term is largest is kept, unnormalised, then normalised."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    q0 = torch.stack((1 + tr, m21 - m12, m02 - m20, m10 - m01), dim=-1)
    q1 = torch.stack((m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20),
                     dim=-1)
    q2 = torch.stack((m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21),
                     dim=-1)
    q3 = torch.stack((m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22),
                     dim=-1)
    case = torch.argmax(torch.stack((tr, m00, m11, m22), dim=-1),
                        dim=-1)[..., None]
    q = torch.where(case == 0, q0, torch.where(
        case == 1, q1, torch.where(case == 2, q2, q3)))
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=1e-12)


def matrix_from_quaternion(q):
    """Unit quaternion (w, x, y, z) -> rotation matrix (..., 3, 3)."""
    q = normalize(q, eps=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack((1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                        2 * (x * z + w * y)), dim=-1)
    row1 = torch.stack((2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - w * x)), dim=-1)
    row2 = torch.stack((2 * (x * z - w * y), 2 * (y * z + w * x),
                        1 - 2 * (x * x + y * y)), dim=-1)
    return torch.stack((row0, row1, row2), dim=-2)


def axis_angle_from_matrix(R):
    """Rotation matrix -> axis-angle vector (..., 3), through the quaternion:
    angle 2 arccos(w); below 1e-6 the first-order 2 (x, y, z)."""
    q = quaternion_from_matrix(R)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    angle = 2.0 * torch.arccos(w)
    s = torch.sqrt(torch.clamp(1.0 - w * w, min=1e-12))
    axis = q[..., 1:] / s[..., None]
    small = (angle < 1e-6)[..., None]
    return torch.where(small, q[..., 1:] * 2.0, axis * angle[..., None])


def matrix_from_axis_angle(aa):
    """Axis-angle vector (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues,
    through the quaternion; below 1e-8 the first-order quaternion)."""
    angle = torch.linalg.norm(aa, dim=-1, keepdim=True)
    small = angle < 1e-8
    axis = aa / torch.where(small, torch.ones_like(angle), angle)
    half = angle[..., 0] / 2.0
    w = torch.where(small[..., 0], torch.ones_like(half), torch.cos(half))
    xyz = torch.where(small, aa / 2.0, axis * torch.sin(half)[..., None])
    return matrix_from_quaternion(torch.cat((w[..., None], xyz), dim=-1))


def relative_pose(R_a, T_a, R_b, T_b):
    """The row-vector pose taking view A to view B: X_b = X_a @ R_rel + T_rel
    with R_rel = R_a^T R_b and T_rel = T_b - T_a @ R_rel."""
    R_rel = torch.einsum("...ji,...jk->...ik", R_a, R_b)
    T_rel = T_b - torch.einsum("...j,...jk->...k", T_a, R_rel)
    return R_rel, T_rel


def compose_pose(R_ab, T_ab, R_bc, T_bc):
    """Compose row-vector poses: X_c = (X_a @ R_ab + T_ab) @ R_bc + T_bc."""
    R_ac = torch.einsum("...ij,...jk->...ik", R_ab, R_bc)
    T_ac = torch.einsum("...j,...jk->...k", T_ab, R_bc) + T_bc
    return R_ac, T_ac
