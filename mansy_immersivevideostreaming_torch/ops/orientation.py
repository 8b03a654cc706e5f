"""Head-orientation math: quaternion -> equirectangular coordinates.

Port of the JAX package's ``ops/orientation.py`` (reference
``dataset_preprocess/head_orientation_lib.py``): quaternion rotation of a
reference view vector (``:19-30``), 3-D direction -> (theta, phi) viewing
angles (``:64-75``), angles -> equirect pixel (``:78-84``), the inverse
direction (``:33-43``), the per-dataset pixel flips (``:88-111``) and the
angular distance (``:50-53``).  Whole traces at once, in float64 torch ops
on the device of the input (numpy arrays and lists go to the CPU, or to
``device``), with the JAX package's arithmetic: ``torch.linalg.cross``,
``acos`` of the clipped dot product, degrees and radians as numpy's
``x * (180 / pi)`` and ``x * (pi / 180)``.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64
TO_DEG = 180.0 / math.pi   # numpy's rad2deg constant
TO_RAD = math.pi / 180.0   # and deg2rad's


def _f64(x, device=None) -> torch.Tensor:
    """``x`` as a float64 tensor, on ``device`` if given, else where it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=F64)
    return torch.as_tensor(x, dtype=F64, device=device)


def quat_rotate(q, v) -> torch.Tensor:
    """Rotate vector(s) ``v`` [3] by unit-normalized quaternion(s) ``q``
    [..., 4] in (w, x, y, z) order."""
    q = _f64(q)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, xyz = q[..., :1], q[..., 1:]
    v = _f64(v, q.device).broadcast_to(xyz.shape)
    t = 2.0 * torch.linalg.cross(xyz, v, dim=-1)
    return v + w * t + torch.linalg.cross(xyz, t, dim=-1)


def extract_direction_dataset1(q_xyzw, device=None) -> torch.Tensor:
    """Rotate [1, 0, 0] by Quaternion([q4, q3, q2, q1]) given (q1..q4) =
    (x, y, z, w) (reference ``:19-23``)."""
    q_xyzw = torch.as_tensor(q_xyzw, device=device)
    q = torch.stack([q_xyzw[..., 3], q_xyzw[..., 2], q_xyzw[..., 1], q_xyzw[..., 0]], dim=-1)
    return quat_rotate(q, [1.0, 0.0, 0.0])


def extract_direction_dataset2(q_xyzw, device=None) -> torch.Tensor:
    """Rotate [0, 0, 1] by Quaternion([q4, -q3, q2, -q1]) (reference
    ``:26-30``)."""
    q_xyzw = torch.as_tensor(q_xyzw, device=device)
    q = torch.stack([q_xyzw[..., 3], -q_xyzw[..., 2], q_xyzw[..., 1], -q_xyzw[..., 0]],
                    dim=-1)
    return quat_rotate(q, [0.0, 0.0, 1.0])


def degree_distance(v1, v2) -> torch.Tensor:
    """Angular distance in degrees (reference ``:50-53``), batched over the
    leading axes of ``v1``.  At the poles (``vector_to_ang`` passes the zero
    projection when the viewer looks exactly along [0, 1, 0]) the 0 / 0
    normalisation gives nan, as in the reference and the JAX package."""
    v1 = _f64(v1)
    v2 = _f64(v2, v1.device)
    v1 = v1 / torch.linalg.norm(v1, dim=-1, keepdim=True)
    v2 = v2 / torch.linalg.norm(v2, dim=-1, keepdim=True)
    return torch.acos(torch.clamp(torch.sum(v1 * v2, dim=-1), -1.0, 1.0)) * TO_DEG


def vector_to_ang(v):
    """Direction vector(s) [..., 3] -> (theta, phi) in degrees (reference
    ``:64-75``)."""
    v = _f64(v)
    alpha = degree_distance(v, [0.0, 1.0, 0.0])
    phi = 90.0 - alpha
    proj1 = torch.zeros_like(v)
    proj1[..., 1] = torch.cos(alpha * TO_RAD)
    theta = degree_distance(v - proj1, [1.0, 0.0, 0.0])
    sign = torch.where(degree_distance(v, [0.0, 0.0, -1.0]) > 90.0, -1.0, 1.0)
    return sign * theta, phi


def ang_to_geoxy(theta, phi, h: float, w: float):
    """(theta, phi) degrees -> (x = height-axis, y = width-axis) pixels
    (reference ``:78-84``)."""
    theta, phi = _f64(theta), _f64(phi)
    x = h / 2.0 - (h / 2.0) * torch.sin(phi * TO_RAD)
    temp = 360.0 - torch.where(theta < 0, 360.0 + theta, theta)
    return x, temp / 360.0 * w


def geoy_to_phi(geoy, height: float) -> torch.Tensor:
    """Equirect height-axis pixel -> phi degrees (reference ``:40-43``)."""
    d = (height / 2.0 - _f64(geoy)) / (height / 2.0)
    return torch.sign(d) * (torch.asin(torch.abs(d)) * TO_DEG)


def pixel_to_ang(x, y, geo_h: float, geo_w: float):
    """Equirect pixel -> (theta, phi) degrees; the inverse of
    :func:`ang_to_geoxy` (reference ``:33-37``)."""
    phi = geoy_to_phi(x, geo_h)
    theta = -(_f64(y, phi.device) / geo_w) * 360.0
    return torch.where(theta < -180.0, 360.0 + theta, theta), phi


def adjust_pixel_dataset1(hi, wi, h: float, w: float):
    """Height-axis flip with wrap (reference ``:95-99``)."""
    hi = h - torch.as_tensor(hi)
    return torch.where(hi < 0, hi + h, hi), torch.as_tensor(wi)


def adjust_pixel_dataset2(hi, wi, h: float, w: float):
    """Width-axis flip with wrap (reference ``:88-92``)."""
    wi = w - torch.as_tensor(wi)
    return torch.as_tensor(hi), torch.where(wi < 0, wi + w, wi)


def adjust_pixellist_dataset(dataset: int, pixel_list, h: float, w: float):
    """The per-dataset pixel flip over an (hi, wi) list (reference
    ``:102-111``).  Returns an iterator of (hi, wi) pairs, as the reference
    does."""
    if len(pixel_list):
        hi, wi = _f64(pixel_list).T
    else:
        hi = wi = torch.zeros(0, dtype=F64)
    if dataset == 1:
        hi, wi = adjust_pixel_dataset1(hi, wi, h, w)
    elif dataset == 2:
        hi, wi = adjust_pixel_dataset2(hi, wi, h, w)
    return zip(hi.tolist(), wi.tolist())
