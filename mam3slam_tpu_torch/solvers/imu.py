"""IMU preintegration on the manifold (Forster et al., ORB-SLAM3's
IMU::Preintegrated).

Port of ``mam3slam_tpu.solvers.imu``: the rotation, velocity and position
deltas between two frames, their 15x15 covariance (phi, v, p, bg, ba),
the five bias jacobians of the first-order bias correction, the
bias-corrected getters, the 9-dim inertial residual (``EdgeInertial``)
and the navigation-state prediction of inertial tracking.

``preintegrate`` takes windows batched over any leading axes: the
per-sample quantities (bias-corrected rates, the sample rotations and
their right jacobians, the skew matrices) are computed for every sample
of every window at once, and one Python loop over the N samples carries
the recursion for all windows together.  Padded samples (``valid`` false)
leave every accumulator as it was.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mam3slam_tpu_torch.geometry import lie

GRAVITY = 9.81


class ImuCalib(NamedTuple):
    """Continuous-time noise densities (the reference's IMU::Calib)."""

    sigma_g: torch.Tensor   # rad/s/sqrt(Hz)
    sigma_a: torch.Tensor   # m/s^2/sqrt(Hz)
    walk_g: torch.Tensor
    walk_a: torch.Tensor


class Preintegrated(NamedTuple):
    """Accumulated deltas between two frames; fields carry the windows'
    leading axes."""

    dt: torch.Tensor       # [...] total time
    dR: torch.Tensor       # [..., 3, 3]
    dV: torch.Tensor       # [..., 3]
    dP: torch.Tensor       # [..., 3]
    cov: torch.Tensor      # [..., 15, 15]  (phi, v, p, bg, ba)
    JRg: torch.Tensor      # [..., 3, 3] d(dR)/d(bias_gyro)
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    bias_g: torch.Tensor   # [..., 3] bias used during integration
    bias_a: torch.Tensor


def _right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) right jacobian Jr(phi), ``[..., 3] -> [..., 3, 3]``."""
    theta_sq = torch.sum(phi * phi, dim=-1)[..., None, None]
    small = theta_sq < 1e-8
    safe_sq = torch.where(small, 1.0, theta_sq)
    theta = torch.sqrt(safe_sq)
    K = lie.hat(phi)
    K2 = K @ K
    a = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / safe_sq)
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (safe_sq * theta))
    return lie._eye3_like(K) - a * K + b * K2


def calib_squares(calib: ImuCalib, like: torch.Tensor) -> tuple:
    """The four squared densities as f32 tensors on ``like``'s device
    (the fields may be floats or tensors anywhere)."""
    return tuple(torch.as_tensor(x, dtype=like.dtype, device=like.device)
                 ** 2 for x in calib)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product ``M [..., m, n] @ v [..., n]``."""
    return (M @ v[..., None])[..., 0]


def preintegrate(gyro: torch.Tensor, acc: torch.Tensor, dts: torch.Tensor,
                 valid: torch.Tensor, bias_g: torch.Tensor,
                 bias_a: torch.Tensor, calib: ImuCalib) -> Preintegrated:
    """Integrate windows of measurements: gyro / acc ``[..., N, 3]``,
    dts / valid ``[..., N]``, biases ``[..., 3]`` (broadcast).  As the
    reference's IntegrateNewMeasurement: position and velocity move with
    the old dR, then the rotation; the covariance propagates through the
    (A, B) system; the bias jacobians accumulate."""
    dev, f32 = gyro.device, gyro.dtype
    lead = gyro.shape[:-2]
    N = gyro.shape[-2]
    bias_g = torch.as_tensor(bias_g, dtype=f32, device=dev).expand(lead + (3,))
    bias_a = torch.as_tensor(bias_a, dtype=f32, device=dev).expand(lead + (3,))
    Ng2, Na2, Wg2, Wa2 = calib_squares(calib, gyro)

    # every sample at once: everything that does not depend on the state
    ok = valid.to(torch.bool)
    dt_all = torch.where(ok, dts, 0.0)                     # [..., N]
    wb_all = gyro - bias_g[..., None, :]
    ab_all = acc - bias_a[..., None, :]
    phi_all = wb_all * dt_all[..., None]
    dRi_all = lie.so3_exp(phi_all)                         # [..., N, 3, 3]
    dRiT_all = dRi_all.transpose(-1, -2)
    Jr_all = _right_jacobian(phi_all)
    hab_all = lie.hat(ab_all)
    safe = torch.clamp(dt_all, min=1e-9)[..., None]
    Nmeas_all = torch.diag_embed(torch.cat(
        [(Ng2 / safe).expand(safe.shape[:-1] + (3,)),
         (Na2 / safe).expand(safe.shape[:-1] + (3,))], -1))  # [..., N, 6, 6]

    eye3 = torch.eye(3, dtype=f32, device=dev).expand(lead + (3, 3))
    z33 = torch.zeros(lead + (3, 3), dtype=f32, device=dev)
    dR, JRg, JVg, JVa, JPg, JPa = eye3, z33, z33, z33, z33, z33
    dV = dP = torch.zeros(lead + (3,), dtype=f32, device=dev)
    cov9 = torch.zeros(lead + (9, 9), dtype=f32, device=dev)
    bias_var = torch.zeros(lead + (6,), dtype=f32, device=dev)
    T = torch.zeros(lead, dtype=f32, device=dev)
    for n in range(N):
        okn = ok[..., n]
        o3 = okn[..., None]
        o33 = okn[..., None, None]
        dt = dt_all[..., n]
        dtv = dt[..., None]
        dtm = dt[..., None, None]
        dt2m = dtm * dtm
        ab, hab = ab_all[..., n, :], hab_all[..., n, :, :]
        dRi, Jr = dRi_all[..., n, :, :], Jr_all[..., n, :, :]

        acc_w = _mv(dR, ab)
        dRhab = dR @ hab
        dRhabJ = dRhab @ JRg
        nJPa = JPa + JVa * dtm - 0.5 * dR * dt2m
        nJPg = JPg + JVg * dtm - 0.5 * dRhabJ * dt2m
        nJVa = JVa - dR * dtm
        nJVg = JVg - dRhabJ * dtm
        nP = dP + dV * dtv + 0.5 * acc_w * (dtv * dtv)
        nV = dV + acc_w * dtv
        nR = dR @ dRi

        # covariance: the 9x9 navigation block; the bias random walk
        A = torch.cat([
            torch.cat([dRiT_all[..., n, :, :], z33, z33], -1),
            torch.cat([-dRhab * dtm, eye3, z33], -1),
            torch.cat([-0.5 * dRhab * dt2m, eye3 * dtm, eye3], -1)], -2)
        B = torch.cat([
            torch.cat([Jr * dtm, z33], -1),
            torch.cat([z33, dR * dtm], -1),
            torch.cat([z33, 0.5 * dR * dt2m], -1)], -2)
        ncov9 = (A @ cov9 @ A.transpose(-1, -2)
                 + B @ Nmeas_all[..., n, :, :] @ B.transpose(-1, -2))
        cov9 = torch.where(o33, ncov9, cov9)
        bias_var = bias_var + torch.where(o3, torch.cat(
            [(Wg2 * dtv).expand(lead + (3,)),
             (Wa2 * dtv).expand(lead + (3,))], -1), 0.0)

        nJRg = dRiT_all[..., n, :, :] @ JRg - Jr * dtm
        dR = torch.where(o33, nR, dR)
        dV = torch.where(o3, nV, dV)
        dP = torch.where(o3, nP, dP)
        JRg = torch.where(o33, nJRg, JRg)
        JVg = torch.where(o33, nJVg, JVg)
        JVa = torch.where(o33, nJVa, JVa)
        JPg = torch.where(o33, nJPg, JPg)
        JPa = torch.where(o33, nJPa, JPa)
        T = T + dt
    cov = torch.zeros(lead + (15, 15), dtype=f32, device=dev)
    cov[..., :9, :9] = cov9
    cov[..., 9:, 9:] = torch.diag_embed(bias_var)
    return Preintegrated(dt=T, dR=dR, dV=dV, dP=dP, cov=cov, JRg=JRg,
                         JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
                         bias_g=bias_g, bias_a=bias_a)


# bias-corrected getters (the reference's GetDeltaRotation / Velocity /
# Position)

def delta_rotation(p: Preintegrated, bias_g):
    return p.dR @ lie.so3_exp(_mv(p.JRg, bias_g - p.bias_g))


def delta_velocity(p: Preintegrated, bias_g, bias_a):
    return (p.dV + _mv(p.JVg, bias_g - p.bias_g)
            + _mv(p.JVa, bias_a - p.bias_a))


def delta_position(p: Preintegrated, bias_g, bias_a):
    return (p.dP + _mv(p.JPg, bias_g - p.bias_g)
            + _mv(p.JPa, bias_a - p.bias_a))


def _gravity(gravity, like: torch.Tensor) -> torch.Tensor:
    if gravity is None:
        return torch.tensor([0.0, 0.0, -GRAVITY], dtype=like.dtype,
                            device=like.device)
    return gravity


def inertial_residual(p: Preintegrated, R_i, v_i, p_i, R_j, v_j, p_j,
                      bias_g, bias_a, gravity=None):
    """9-dim preintegration residual (rotation, velocity, position)
    between world-frame nav states i and j (R_wb, v, p), the reference's
    EdgeInertial error; differentiable."""
    g = _gravity(gravity, p.dV)
    dt = p.dt[..., None]
    dR = delta_rotation(p, bias_g)
    dV = delta_velocity(p, bias_g, bias_a)
    dP = delta_position(p, bias_g, bias_a)
    RiT = R_i.transpose(-1, -2)
    er = lie.so3_log(dR.transpose(-1, -2) @ (RiT @ R_j))
    ev = _mv(RiT, v_j - v_i - g * dt) - dV
    ep = _mv(RiT, p_j - p_i - v_i * dt - 0.5 * g * dt * dt) - dP
    return torch.cat([er, ev, ep], -1)


def predict_state(p: Preintegrated, R_wb, v_w, p_w, bias_g, bias_a,
                  gravity=None):
    """A world-frame IMU state propagated through the preintegrated
    window: (R_wb, v, p) at its end."""
    g = _gravity(gravity, p.dV)
    dt = p.dt[..., None]
    dR = delta_rotation(p, bias_g)
    dV = delta_velocity(p, bias_g, bias_a)
    dP = delta_position(p, bias_g, bias_a)
    R2 = R_wb @ dR
    v2 = v_w + g * dt + _mv(R_wb, dV)
    p2 = p_w + v_w * dt + 0.5 * g * dt * dt + _mv(R_wb, dP)
    return R2, v2, p2
