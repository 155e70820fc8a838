"""Two-way EM <-> thermal coupling: temperature-dependent dielectrics.

Counterpart of ``fdtd_tpu/coupled.py``.  As the load heats, its
permittivity and effective conductivity change, which moves the field
pattern and the power deposition, which changes where it heats next.  The
cook time splits into ``intervals`` quasi-static intervals: each re-derives
the load's cell-centered eps_r/sigma from the current temperature field
(single-term Debye water, :func:`water_debye`), runs the EM solve from a
zero field with the power accumulated (:func:`fdtd_tpu_torch.runner.
run_simulation`, on any backend, shard and CPML composition it takes),
time-averages the deposited power into a heat source Q, and advances the
heat equation (:func:`fdtd_tpu_torch.thermal.run_thermal`) for the
interval.

Water's fits (the Malmberg-Maryott static permittivity, the Kaatze tau(T)
table and eps_inf) live once in the port, in
:mod:`fdtd_tpu_torch.ops.dispersive`, which builds the Debye load from the
same fits.  The host parts are numpy in fp64, the same values as the JAX
package's; the interval checkpoint has its schema (``coupled_ckpt.npz``:
the fp64 rise, ``intervals_done`` int64 and the summaries as JSON bytes),
so a cook resumes across the two packages.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable

import numpy as np
import torch

from .constants import EPSILON
from .ops.dispersive import _TAU_PS, _TAU_T_C, EPS_INF, water_eps_static
from .params import Mode, Params
from .runner import run_simulation
from .state import Materials, block_mask
from .thermal import ThermalMaterials, run_thermal, stable_dt, thermal_from_mask
from .turntable import geometry_mask, rotate_field


def water_debye(T, frequency: float = 2.45e9, sigma_ion25: float = 0.0):
    """(eps_r, sigma_eff) of water at ``frequency``, elementwise over T (C).

    ``sigma_ion25``: ionic (salt) conductivity at 25 C in S/m, scaled by
    the +2 %/K electrolyte coefficient; 0 = pure water.  Clamps T to the
    0-100 C liquid range the fits cover.
    """
    T = np.clip(np.asarray(T, np.float64), 0.0, 100.0)
    eps_s = water_eps_static(T)
    tau = np.interp(T, _TAU_T_C, _TAU_PS) * 1e-12
    w = 2.0 * np.pi * float(frequency)
    wt = w * tau
    denom = 1.0 + wt * wt
    eps_p = EPS_INF + (eps_s - EPS_INF) / denom
    eps_pp = (eps_s - EPS_INF) * wt / denom
    sigma = w * EPSILON * eps_pp + sigma_ion25 * (1.0 + 0.02 * (T - 25.0))
    return eps_p, sigma


def materials_at_temperature(p: Params, T, mask: np.ndarray, frequency: float = 2.45e9,
                             sigma_ion25: float = 0.0) -> Materials:
    """EM material maps for a water load at temperature field ``T``:
    Debye-evaluated eps_r/sigma inside ``mask``, vacuum outside."""
    eps_p, sigma = water_debye(T, frequency, sigma_ion25)
    return Materials(eps_r=np.where(mask, eps_p, 1.0), sigma=np.where(mask, sigma, 0.0))


def normalize_power(p: Params, q: np.ndarray, watts: float) -> np.ndarray:
    """Rescale a volumetric power-density map so its volume integral is
    ``watts``: the deposition pattern comes from the fields, the level from
    the oven's rated power."""
    dv = p.spatial_step**3
    total = float(q.sum()) * dv
    if total <= 0.0:
        raise ValueError(
            "cannot normalize a zero power map (did the EM run deposit "
            "any power? check --sar and the lossy load)"
        )
    return q * (watts / total)


@dataclasses.dataclass
class CoupledResult:
    temperature: np.ndarray  # final absolute T (C), fp64, (maxk, maxj, maxi)
    rise: np.ndarray  # final rise above ambient (K), fp64
    intervals: list[dict]  # per-interval summaries (JSON-friendly)
    # end-of-cook turntable angle (radians; 0.0 without rotation);
    # ``temperature``/``rise`` live in the load's co-rotating material
    # frame (turntable.rotate_field by final_theta gives the lab frame)
    final_theta: float = 0.0


def _coupled_ckpt_path(out_dir: str) -> str:
    return os.path.join(out_dir, "coupled_ckpt.npz")


def _save_coupled_ckpt(out_dir: str, R: np.ndarray, it_done: int, summaries: list) -> None:
    """Atomic interval-level checkpoint: the fp64 rise map is the cook's
    whole state (each EM interval restarts from a zero field, and the
    turntable angle is a function of the interval index), so a resumed
    cook reproduces the uninterrupted one bit for bit."""
    os.makedirs(out_dir, exist_ok=True)
    path = _coupled_ckpt_path(out_dir)
    tmp = path[:-len(".npz")] + "_tmp.npz"
    np.savez(tmp, rise=R, intervals_done=np.int64(it_done),
             summaries=np.frombuffer(json.dumps(summaries).encode(), dtype=np.uint8))
    os.replace(tmp, path)


def _load_coupled_ckpt(out_dir: str):
    """(rise, intervals_done, summaries) or None."""
    path = _coupled_ckpt_path(out_dir)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        R = np.asarray(z["rise"], np.float64)
        done = int(z["intervals_done"])
        summaries = json.loads(bytes(z["summaries"].tobytes()).decode())
    return R, done, summaries


def run_coupled(
    p: Params,
    cook_time: float,
    intervals: int,
    mask: np.ndarray | None = None,
    frequency: float = 2.45e9,
    sigma_ion25: float = 0.0,
    power_watts: float | None = None,
    ambient: float = 20.0,
    thermal_materials: ThermalMaterials | None = None,
    backend: str = "auto",
    shard: str | None = None,
    pml=None,
    out_dir: str = "r",
    log: Callable[[str], None] = print,
    on_interval: Callable | None = None,
    dft=None,
    on_interval_dft: Callable | None = None,
    geometry=None,
    rpm: float = 0.0,
    axis_center: tuple[float, float] = (0.5, 0.5),
    checkpoint: bool = False,
    resume: bool = False,
    device="cuda",
) -> CoupledResult:
    """Alternate EM (SAR) and thermal solves for ``cook_time`` seconds on
    ``device``, as ``fdtd_tpu.coupled.run_coupled`` does.

    Each of the ``intervals`` intervals re-derives the load's eps_r/sigma
    from the current temperature (:func:`water_debye`), runs
    ``run_simulation`` with ``backend``, ``shard``, ``pml`` and ``dft``,
    the power accumulated and no snapshots, and advances the heat equation
    by ``cook_time / intervals`` from the current temperature field.  The
    fp32 power map comes to the host as fp64 before it is divided by the
    EM run's time.

    ``power_watts``: rescale each interval's heat source to this total
    absorbed power (a magnetron's rating).  ``checkpoint``/``resume``:
    interval-level checkpoints in ``{out_dir}/coupled_ckpt.npz``, bit for
    bit resumable.  ``on_interval(i, T, theta)``: after each interval, with
    the fp64 temperature (in the load's co-rotating material frame under
    rotation) and the interval's turntable angle.  ``dft`` (a
    :class:`~fdtd_tpu_torch.dft.DftConfig`): per-interval phasors; each
    summary gains ``cw_absorbed_w`` (sum of 1/2 sigma |E_hat|^2 dx^3 per
    frequency), and ``on_interval_dft(it, dft_result, sigma_cells, theta)``
    is called after each EM solve.  ``geometry``
    (:class:`~fdtd_tpu_torch.turntable.LoadGeometry`), ``rpm`` and
    ``axis_center``: the turntable: each interval rasterizes the load at
    its mid-interval angle, rotates the temperature into the lab frame for
    the dielectrics and the power map back into the material frame.
    """
    if intervals < 1:
        raise ValueError("coupled run needs at least 1 interval")
    if p.mode != Mode.COMPUTATION:
        raise ValueError("coupled heating needs computation mode (a driven source)")
    rotating = rpm != 0.0
    if rotating and geometry is None:
        raise ValueError(
            "turntable rotation (rpm != 0) needs a LoadGeometry — a bare "
            "mask array cannot be re-rasterized at other angles"
        )
    if geometry is not None:
        if mask is not None:
            raise ValueError("pass either mask or geometry, not both")
        mask = geometry_mask(p, geometry, 0.0, axis_center)
    if mask is None:
        mask = block_mask(p)
    if not mask.any():
        raise ValueError("the load mask is empty — nothing to heat")
    # thermal properties follow the same mask as the EM load
    tm = thermal_materials if thermal_materials is not None else thermal_from_mask(p, mask)
    dt_th = stable_dt(p, tm)  # every interval's thermal step (a function of tm alone)

    # the cook's state is the rise above ambient: (ambient + rise) - ambient
    # would cancel catastrophically for rises far below ambient's ulp
    R = np.zeros((p.maxk, p.maxj, p.maxi), np.float64)
    t_int = cook_time / intervals
    omega_tt = 2.0 * np.pi * rpm / 60.0  # turntable angular rate (rad/s)
    summaries: list[dict] = []
    start_it = 0
    if resume:
        ck = _load_coupled_ckpt(out_dir)
        if ck is not None:
            R_ck, start_it, summaries = ck
            if R_ck.shape != R.shape:
                raise ValueError(f"coupled checkpoint grid {R_ck.shape} does not match this run's {R.shape}")
            if start_it > intervals:
                raise ValueError(f"coupled checkpoint has {start_it} intervals done, more than this run's "
                                 f"{intervals}")
            R = R_ck
            log(f"Resuming coupled cook after interval {start_it}")
        else:
            log("No coupled checkpoint found; starting from interval 0")
    T = R + float(ambient)
    for it in range(start_it, intervals):
        # mid-interval angle: the rpm -> 0 limit is the static cook
        theta = omega_tt * (it + 0.5) * t_int if rotating else 0.0
        if rotating:
            lab_mask = geometry_mask(p, geometry, theta, axis_center)
            # T rides the material frame; the dielectrics live in the lab
            T_lab = rotate_field(p, T, theta, axis_center, fill=ambient)
            mats = materials_at_temperature(p, T_lab, lab_mask, frequency, sigma_ion25)
        else:
            lab_mask = mask
            mats = materials_at_temperature(p, T, mask, frequency, sigma_ion25)
        res = run_simulation(p, device, out_dir=out_dir, materials=mats, backend=backend, write_snapshots=False,
                             accumulate_power=True, shard=shard, pml=pml, dft=dft, log=log)
        t_em = res.iterations * p.time_step
        q = res.power_j.to(device="cpu", dtype=torch.float64).numpy() / t_em
        dft_res = res.dft
        del res  # the interval's fields and map leave the device before the thermal solve
        if rotating:
            # Q home to the material frame: clip the resample's smeared
            # edge to the canonical mask and restore the lab-frame total
            total_lab = float(q.sum())
            q = np.where(mask, rotate_field(p, q, -theta, axis_center, fill=0.0), 0.0)
            total_mat = float(q.sum())
            if total_lab > 0.0 and total_mat > 0.0:
                q = q * (total_lab / total_mat)
        # the raw (pre-normalization) absorbed power shows the angle and
        # temperature dependence that --thermal-power normalizes away
        raw_absorbed_w = float(q.sum()) * p.spatial_step**3
        if power_watts is not None:
            q = normalize_power(p, q, power_watts)
        # the rise form: ambient 0 shifts the whole problem exactly
        tr = run_thermal(p, tm, q, t_int, ambient=0.0, dt=dt_th, t0=R, device=device)
        R = tr.rise.to(device="cpu", dtype=torch.float64).numpy()
        T = R + float(ambient)
        in_load = T[mask]
        lab_load = mats.eps_r[lab_mask]
        summaries.append(
            {
                "interval": it,
                "theta_deg": float(np.degrees(theta)),
                "eps_r_range": [float(lab_load.min()), float(lab_load.max())],
                "sigma_range": [float(mats.sigma[lab_mask].min()), float(mats.sigma[lab_mask].max())],
                "absorbed_w": float(q.sum()) * p.spatial_step**3,
                "raw_absorbed_w": raw_absorbed_w,
                "peak_t_c": float(in_load.max()),
                "mean_t_c": float(in_load.mean()),
                "thermal_steps": tr.steps,
            }
        )
        if dft is not None and dft_res is not None:
            # the CW power this interval's phasors predict, beside the SAR rate
            summaries[-1]["cw_absorbed_w"] = [float(dft_res.cw_power(mats.sigma, fi).sum()) * p.spatial_step**3
                                              for fi in range(len(dft.frequencies))]
            if on_interval_dft is not None:
                on_interval_dft(it, dft_res, mats.sigma, theta)
        if checkpoint:
            _save_coupled_ckpt(out_dir, R, it + 1, summaries)
        if on_interval is not None:
            on_interval(it, T, theta)
        log(
            f"coupled interval {it + 1}/{intervals}: load T "
            f"{in_load.mean():.2f} C mean / {in_load.max():.2f} C peak, "
            f"eps_r {summaries[-1]['eps_r_range'][0]:.1f}-"
            f"{summaries[-1]['eps_r_range'][1]:.1f}, sigma "
            f"{summaries[-1]['sigma_range'][0]:.3f}-"
            f"{summaries[-1]['sigma_range'][1]:.3f} S/m"
        )
    return CoupledResult(temperature=T, rise=R, intervals=summaries,
                         final_theta=omega_tt * cook_time if rotating else 0.0)
