"""Affine SE(3) transforms for the host-side task layer, on numpy and scipy:
this package's own copy of tcnerf/tasks/transform.py (the port imports
nothing of the JAX package).

Constructors from translation + quaternion (xyzw) / euler-xyz / matrix,
bounded random sampling (`random` draws from `rng` in the JAX package's
order, so seeded guesses are the same bits), polar (look-at) camera poses,
composition, accessors, inversion, twist and slerp interpolation.
"""

from __future__ import annotations

import numpy as np
from scipy import interpolate
from scipy.spatial.transform import Rotation, Slerp


class Affine:
    """4x4 affine transform. Quaternions are (x, y, z, w)."""

    def __init__(self, translation=(0, 0, 0), rotation=(0, 0, 0, 1)):
        self.matrix = np.eye(4)
        self.matrix[:3, 3] = np.asarray(translation, dtype=np.float64)
        rotation = np.asarray(rotation, dtype=np.float64)
        if rotation.shape == (3, 3):
            rot_matrix = rotation
        elif rotation.shape == (4,):
            rot_matrix = Rotation.from_quat(rotation).as_matrix()
        elif rotation.shape == (3,):
            rot_matrix = Rotation.from_euler("xyz", rotation).as_matrix()
        else:
            raise ValueError(
                "Expected rotation of shape (4,), (3,) or (3, 3), got "
                + str(rotation.shape))
        self.matrix[:3, :3] = rot_matrix

    # ------------------------------------------------------------ constructors

    @classmethod
    def from_matrix(cls, matrix):
        # without the default constructor: its identity rotation would go
        # through scipy only to be replaced
        affine = cls.__new__(cls)
        affine.matrix = np.asarray(matrix, dtype=np.float64)
        return affine

    @classmethod
    def random(cls,
               t_bounds=((0, 1), (0, 1), (0, 1)),
               r_bounds=((0, 2 * np.pi), (0, 2 * np.pi), (0, 2 * np.pi)),
               allow_zero_translation=True,
               allow_zero_rotation=True,
               rng=None):
        rng = np.random.default_rng() if rng is None else (
            np.random.default_rng(rng) if not isinstance(rng, np.random.Generator)
            else rng)
        t_b = np.asarray(t_bounds, dtype=np.float64)
        translation = rng.uniform(t_b[:, 0], t_b[:, 1])
        if not allow_zero_translation:
            while np.linalg.norm(translation) < 1e-4:
                translation = rng.uniform(t_b[:, 0], t_b[:, 1])
        r_b = np.asarray(r_bounds, dtype=np.float64)
        rpy = rng.uniform(r_b[:, 0], r_b[:, 1])
        if not allow_zero_rotation:
            while (np.abs(rpy) < 1e-4).all():
                rpy = rng.uniform(r_b[:, 0], r_b[:, 1])
        rotation = Rotation.from_euler("xyz", rpy).as_quat()
        return cls(translation=translation, rotation=rotation)

    @classmethod
    def polar(cls, azimuth, polar, radius, t_center):
        """Look-at camera pose on a sphere around `t_center` (transform.py:57-75)."""
        t = np.array([
            radius * np.sin(polar) * np.cos(azimuth),
            radius * np.sin(polar) * np.sin(azimuth),
            radius * np.cos(polar),
        ]) + np.asarray(t_center, dtype=np.float64)
        z_axis = np.asarray(t_center, dtype=np.float64) - t
        z_axis /= np.linalg.norm(z_axis)
        x_axis = np.cross(z_axis, np.array([0.0, 0.0, 1.0]))
        if np.linalg.norm(x_axis) == 0:
            x_axis = np.array([np.cos(azimuth), np.sin(azimuth), 0.0])
        else:
            x_axis /= np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        y_axis /= np.linalg.norm(y_axis)
        r = np.stack([x_axis, y_axis, z_axis], axis=1)
        return cls(translation=t, rotation=r)

    # -------------------------------------------------------------- operators

    def __repr__(self):
        return str(self.translation) + " " + str(self.quat)

    __str__ = __repr__

    def __mul__(self, other):
        return Affine.from_matrix(self.matrix @ other.matrix)

    def __matmul__(self, other):
        return self * other

    def __truediv__(self, other):
        return other.invert() * self

    # -------------------------------------------------------------- properties

    @property
    def rotation(self):
        return self.matrix[:3, :3]

    @property
    def translation(self):
        return self.matrix[:3, 3]

    @property
    def quat(self):
        return Rotation.from_matrix(self.matrix[:3, :3]).as_quat()

    @property
    def rpy(self):
        return Rotation.from_matrix(self.matrix[:3, :3]).as_euler("xyz")

    @property
    def axis_angle(self):
        return Rotation.from_matrix(self.matrix[:3, :3]).as_rotvec()

    # ------------------------------------------------------------------ methods

    def invert(self):
        return Affine.from_matrix(np.linalg.inv(self.matrix))

    def to_twist(self):
        r = self.matrix[:3, :3]
        t = self.matrix[:3, 3]
        theta = np.arccos(np.clip((np.trace(r) - 1) / 2, -1.0, 1.0))
        if theta != 0:
            omega_hat = 1 / (2 * np.sin(theta)) * (r - r.T)
            omega = np.array([omega_hat[2, 1], omega_hat[0, 2], omega_hat[1, 0]])
            omega = omega * theta
            v_inv_theta = (np.eye(3) / theta - 0.5 * omega_hat
                           + (1 / theta - 1 / (2 * np.tan(theta / 2)))
                           * omega_hat @ omega_hat)
            v = v_inv_theta @ t.reshape(3, 1)
        else:
            omega = np.zeros(3)
            v = t
        return np.concatenate([omega, v.reshape(3)], axis=0)

    def interpolate_to(self, transform, lin_step_size):
        """Linear position + slerp orientation interpolation (transform.py:152-167)."""
        t_start = self.matrix[:3, 3]
        t_goal = transform.matrix[:3, 3]
        dist = np.linalg.norm(t_goal - t_start)
        if dist < 2 * lin_step_size:
            return [self, transform]
        n_steps = int(dist / lin_step_size)
        key_steps = np.arange(n_steps)
        interp = interpolate.interp1d([0, n_steps - 1], [t_start, t_goal], axis=0)
        t_steps = interp(key_steps)
        rotations = Rotation.from_matrix(
            [self.matrix[:3, :3], transform.matrix[:3, :3]])
        slerp = Slerp([0, n_steps - 1], rotations)
        r_steps = slerp(key_steps)
        return [Affine(t, r.as_quat()) for t, r in zip(t_steps, r_steps)]
