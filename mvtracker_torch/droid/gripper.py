"""Robotiq 2F-85 gripper kinematics + contact-surface track generation,
counterpart of `mvtracker_tpu/droid/gripper.py`.

Re-design of the reference's `ContactSurfaceTracker`
(`conversions/droid/utils/tracking.py:13-120,348-408`): sample points on
the inner-finger rubber contact pad and forward-kinematic them to world
space per frame through the finger linkage chain.

Mesh handling: the reference samples the pad from the Robotiq STL
(`inner_finger_fine.STL`, faces with y < -0.0095). This module can parse a
binary STL directly (no trimesh dependency); when no mesh is available it
synthesizes an equivalent flat rectangular pad at the same pose
(y = -0.011 plane of the inner-finger link frame), which preserves the
kinematic behavior of the tracks exactly — only the in-pad point layout
differs.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

from mvtracker_torch.droid.transforms import rotvec_to_matrix, euler_xyz_to_matrix


def load_binary_stl(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse a binary STL into (vertices [V, 3], faces [F, 3])."""
    with open(path, "rb") as f:
        f.read(80)
        (n_tri,) = struct.unpack("<I", f.read(4))
        data = np.frombuffer(f.read(n_tri * 50), dtype=np.uint8).reshape(n_tri, 50)
    tri = data[:, 12:48].copy().view("<f4").reshape(n_tri, 3, 3)
    verts = tri.reshape(-1, 3).astype(np.float64)
    uniq, inv = np.unique(verts.round(9), axis=0, return_inverse=True)
    faces = inv.reshape(n_tri, 3)
    return uniq, faces


def extract_contact_pad_vertices(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Vertices of faces whose minimum y < -0.0095 (the inner flat pad,
    reference `tracking.py:13-30`)."""
    face_verts = verts[faces]  # [F, 3, 3]
    keep = face_verts[:, :, 1].min(axis=1) < -0.0095
    if not keep.any():
        raise ValueError("no contact-pad faces found in mesh")
    return verts[np.unique(faces[keep])]


def synthetic_contact_pad(num_points: int) -> np.ndarray:
    """Procedural flat contact pad in the inner-finger link frame.

    The Robotiq inner-finger rubber pad is an (approx.) 22 x 14 mm
    rectangle in the finger's local xz-plane at y = -0.011. When the STL is
    unavailable, a uniform grid on that rectangle is kinematically
    equivalent for track generation.
    """
    side = int(np.ceil(np.sqrt(num_points)))
    xs = np.linspace(-0.007, 0.007, side)
    zs = np.linspace(-0.011, 0.011, side)
    gx, gz = np.meshgrid(xs, zs)
    pts = np.stack([gx.ravel(), np.full(gx.size, -0.011), gz.ravel()], axis=1)
    return pts[:num_points]


def compute_finger_transforms(t_base_ee: np.ndarray, gripper_pos) -> tuple[np.ndarray, np.ndarray]:
    """World transforms of the left/right inner fingers.

    Mirrors reference `tracking.py:45-71` exactly: the knuckle rotates by
    -theta about y (theta = 0.8 * gripper command), the finger counters by
    +theta; the right chain is the left chain yawed by pi.
    """
    val = np.asarray(gripper_pos).reshape(-1)[0]
    theta = float(val) * 0.8

    t_lik = np.eye(4)
    t_lik[:3, 3] = [0.0127, 0, 0.0693]
    t_lik[:3, :3] = rotvec_to_matrix(np.array([0, -theta, 0]))

    t_lif = np.eye(4)
    t_lif[:3, 3] = [0.03458531, 0, 0.04549702]
    t_lif[:3, :3] = rotvec_to_matrix(np.array([0, theta, 0]))
    t_left = t_base_ee @ t_lik @ t_lif

    t_rik = np.eye(4)
    t_rik[:3, 3] = [-0.0127, 0, 0.0693]
    rot_z_pi = euler_xyz_to_matrix(np.array([0.0, 0.0, np.pi]))
    t_rik[:3, :3] = rot_z_pi @ rotvec_to_matrix(np.array([0, -theta, 0]))

    t_rif = np.eye(4)
    t_rif[:3, 3] = [0.03410605, 0, 0.04585739]
    t_rif[:3, :3] = rotvec_to_matrix(np.array([0, theta, 0]))
    t_right = t_base_ee @ t_rik @ t_rif

    return t_left, t_right


class ContactSurfaceTracker:
    """Samples contact-pad points once, then FKs them per frame."""

    def __init__(self, num_track_points: int = 24, mesh_path: Optional[str] = None):
        self.num_track_points = num_track_points
        if mesh_path and os.path.exists(mesh_path):
            verts, faces = load_binary_stl(mesh_path)
            pad = extract_contact_pad_vertices(verts, faces)
            if num_track_points <= len(pad):
                # Spread the subset over the whole pad (the reference FKs
                # surface-covering samples): np.unique's lexicographic order
                # would cluster pad[:N] in one corner.
                from mvtracker_torch.utils.misc import farthest_point_sampling

                sel = farthest_point_sampling(pad, num_track_points)
                self.contact_points_local = pad[sel].copy()
            else:
                self.contact_points_local = pad
        else:
            self.contact_points_local = synthetic_contact_pad(num_track_points)

    def contact_points_world(self, t_base_ee: np.ndarray, gripper_pos):
        """[N, 3] left + [N, 3] right contact points in world frame."""
        pts_h = np.concatenate(
            [self.contact_points_local, np.ones((len(self.contact_points_local), 1))],
            axis=1,
        )
        t_left, t_right = compute_finger_transforms(t_base_ee, gripper_pos)
        left = (t_left @ pts_h.T).T[:, :3]
        right = (t_right @ pts_h.T).T[:, :3]
        return left, right

    def contact_points_and_frames(self, t_base_ee: np.ndarray, gripper_pos):
        """Points + centroid + EE-oriented contact frames (reference
        `tracking.py:73-120,380-408`)."""
        left, right = self.contact_points_world(t_base_ee, gripper_pos)
        t_l, t_r = compute_finger_transforms(t_base_ee, gripper_pos)

        centroid = np.vstack([left, right]).mean(axis=0)
        frame = np.eye(4)
        frame[:3, :3] = t_base_ee[:3, :3]
        frame[:3, 3] = centroid

        lf = np.eye(4)
        lf[:3, :3] = t_l[:3, :3]
        lf[:3, 3] = left.mean(axis=0)
        rf = np.eye(4)
        rf[:3, :3] = t_r[:3, :3]
        rf[:3, 3] = right.mean(axis=0)
        return left, right, centroid, frame, lf, rf
