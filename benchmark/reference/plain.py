"""The plain reference: the oven's Yee leapfrog as straightforward torch
slice arithmetic, independent of the program under test.

It follows the upstream C loop (main.c:765-779): the source hard-set,
update_H, the source hard-set again, update_E, in fp32 on the padded
(maxk+1, maxj+1, maxi+1) layout, E updated only inside the PEC walls.
A Debye load (a single-pole medium eps_inf + d_eps / (1 + i w tau) with
an ionic sigma) takes the auxiliary-differential-equation E update and
carries its polarization P on the E edges (:func:`debye_coefs`,
:meth:`Reference.update_e`).  Beside the update it keeps what a run's
traffic asks for, each step on the state that ends it: the SAR map
(sigma |E|^2 dt at cell centres in a lossy load, the cell means of the
update's own work densities times dt in a Debye load, fp32), the E
phasor sums at each DFT frequency (fp32 (re, im) pairs of
the cell-centred means), the probe rows (the six cell-centred
components at each probe cell) and, every ``output_every`` steps and at
step 0, the cavity's electric and magnetic energy (in fp64).

Storage.  At ``float32`` (every configuration before bfloat16) the state
is fp32 throughout.  At ``bfloat16`` field storage it mirrors what the
program states of its bf16 path, holding the state as fp32 tensors whose
values are bf16 and computing every step in fp32 in the same operation
order:

- the six fields are rounded to bf16 (round to nearest even) at the
  program's stores and nowhere else (:class:`Scene`'s ``round_every``):
  once a sweep of s steps on ``stream``, after its SAR increments
  (``fdtd_tpu_torch/csrc/yee_stream.cu:257-263``, "bf16 storage loads to
  fp32, keeps every level in fp32 and rounds once per sweep, at the
  store"; ``ops/stream.py::plain_sweep`` :157, "rounded once to the
  storage dtype"), and after each pass on ``twopass`` and ``torch``, so
  that the E pass reads the stored H and the SAR map the stored E
  (``ops/curl.py`` :19-20, "rounded back to bf16 once per update");
- the lossy ``ca``, ``cb`` and the SAR map's ``sigma`` are rounded to
  bf16 from their fp64 values by torch's fp64 -> bf16 conversion, the
  one ``state.update_coefs`` makes (``torch.tensor(..., dtype=bf16)``,
  ``state.py:266-267``), then widened to fp32 for the arithmetic;
- the source rows are formed in fp64 and rounded once to bf16
  (``source.apply_source`` :126-127, ``source.sweep_drive_rows`` :162);
- each step's SAR increment reads that step's E as the program holds
  it, in fp32 (``diagnostics.accumulate_power``);
- the energies (fp64) are those of the stored bf16 values at each
  record.

Everything it needs it works out again from the run's inputs: the
source patch and its drive, the lossy coefficients from the eps_r and
sigma maps, the Debye coefficients from the eps_inf, sigma, d_eps and
tau maps, the DFT weights from the time counters.  It imports
neither jax nor the JAX package nor the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the upstream code's constants (main.c:22-25)
MU = 1.25663706143591729538505735331180115367886775975e-6
EPSILON = 8.854e-12
PI = 3.14159265358979323846264338327950288419716939937510582097494
CELERITY = 299792458.0

F32 = torch.float32
# the storage dtypes a configuration may state
STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
COMPONENTS = ("ex", "ey", "ez", "hx", "hy", "hz")
# E component -> the two cell axes its edge is averaged over
COMP_AXES = {"x": (0, 1), "y": (0, 2), "z": (1, 2)}


def f32(x: float) -> float:
    """``x`` rounded to fp32, as a Python float."""
    return float(np.float32(x))


class Scene:
    """The inputs of a run, as plain numbers and arrays.

    ``grid`` (maxk, maxj, maxi); ``box`` (length, width, height) in m as
    C floats; ``dx``, ``dt``; ``source_hz`` and the port's ``patch``
    (a', b') in m; ``maps`` None, the (eps_r, sigma) fp64 cell maps of a
    lossy load or the (eps_inf, sigma, d_eps, tau) ones of a Debye load;
    ``sar``; ``dft_hz``; ``probes`` (k, j, i) cells; ``output_every``;
    ``dtype``, the field storage (a key of ``STORAGE``); ``round_every``,
    at ``bfloat16`` the steps between the program's stores of all six
    fields: s, a sweep's depth on ``stream``, or 1, the two-pass step, each
    of whose passes stores its own fields (no sweep is one step deep).  A
    bf16 scene takes vacuum and lossy loads with or without the SAR map;
    its records fall on stores.
    """

    def __init__(self, grid, box, dx, dt, source_hz, patch, maps=None, sar=False, dft_hz=(), probes=(),
                 output_every=1000, dtype="float32", round_every=1):
        self.grid = tuple(int(n) for n in grid)
        self.box = tuple(float(v) for v in box)
        self.dx, self.dt = float(dx), float(dt)
        self.source_hz = float(source_hz)
        self.patch = tuple(float(v) for v in patch)
        self.maps = maps
        self.sar = bool(sar)
        self.dft_hz = tuple(float(f) for f in dft_hz)
        self.probes = tuple(tuple(int(c) for c in p) for p in probes)
        self.output_every = int(output_every)
        if dtype not in STORAGE:
            raise ValueError(f"unknown field storage {dtype!r}: the reference stores {sorted(STORAGE)}")
        self.dtype = dtype
        self.round_every = int(round_every)
        if self.round_every < 1:
            raise ValueError(f"round_every {round_every!r}: a store comes every 1 or more steps")
        if self.bf16:
            missing = [what for what, on in (("a Debye load", self.debye), ("the DFT sums", self.dft_hz),
                                             ("probe rows", self.probes)) if on]
            if missing:
                raise ValueError(f"the reference has no bfloat16 form of {', '.join(missing)}")
            if self.output_every % self.round_every:
                raise ValueError(f"records every {self.output_every} steps fall between the stores every "
                                 f"{self.round_every} steps")

    @property
    def bf16(self) -> bool:
        return self.dtype == "bfloat16"

    @property
    def debye(self) -> bool:
        return self.maps is not None and len(self.maps) == 4

    @property
    def padded(self) -> tuple[int, int, int]:
        K, J, I = self.grid
        return (K + 1, J + 1, I + 1)


def source_patch(sc: Scene):
    """(j0, j1, i0, i1, 1/Z_te, profile): the TE10 port's k = 0 patch
    with the upstream's one-cell slop, its wave impedance and the
    sin(pi x / a') profile along i, fp64 (main.c:712-753)."""
    length, width, _ = sc.box
    aprime, bprime = sc.patch
    dx = sc.dx
    min_y = width / 2.0 - aprime / 2.0
    max_y = min_y + aprime
    min_x = length / 2.0 - bprime / 2.0
    max_x = min_x + bprime
    j0, j1 = int(min_y / dx) - 1, int(max_y / dx) + 1
    i0, i1 = int(min_x / dx) - 1, int(max_x / dx) + 1
    f_mnl = 0.5 * CELERITY * math.sqrt((PI / width) ** 2 + (PI / length) ** 2) / PI
    omega = 2.0 * PI * f_mnl
    z_te = (omega * MU) / math.sqrt(omega ** 2 * MU * EPSILON - (PI / width) ** 2)
    profile = np.array([math.sin(PI * (s * dx) / aprime) for s in range(i1 - i0)], np.float64)
    return j0, j1, i0, i1, 1.0 / z_te, profile


def time_counters(dt: float, steps: int) -> np.ndarray:
    """The loop's fp64 time counters, ``t += dt`` from 0."""
    ts = np.empty(steps, np.float64)
    t = 0.0
    for n in range(steps):
        ts[n] = t
        t += dt
    return ts


def edge_mean(cells: torch.Tensor, axes) -> torch.Tensor:
    """Cell values at the edges along the third axis: the mean over the
    cells around each edge, the wall edges taking the wall cells' values."""
    out = cells
    for ax in axes:
        n = out.shape[ax]
        out = torch.cat([out.narrow(ax, 0, 1), out, out.narrow(ax, n - 1, 1)], dim=ax)
    for ax in axes:
        n = out.shape[ax]
        out = 0.5 * (out.narrow(ax, 0, n - 1) + out.narrow(ax, 1, n - 1))
    return out


def stored(values: torch.Tensor, sc: Scene) -> torch.Tensor:
    """``values`` (fp64) rounded once to the scene's storage dtype by
    torch's conversion, as an fp32 tensor."""
    return values.to(STORAGE[sc.dtype]).to(F32)


def lossy_coefs(sc: Scene, device):
    """{'x','y','z': (ca, cb)} padded fp32 tensors of the lossy E update
    E <- ca E + cb curl H, with ca = (1 - s) / (1 + s), cb = dt / (eps dx)
    / (1 + s), s = sigma dt / (2 eps), eps and sigma averaged onto each
    edge in fp64, rounded once to the storage dtype; ca 1 and cb 0 outside
    each component's extent."""
    eps_r, sigma = (torch.as_tensor(a, dtype=torch.float64, device=device) for a in sc.maps)
    dt, dx = sc.dt, sc.dx
    out = {}
    for comp, axes in COMP_AXES.items():
        eps_e = edge_mean(eps_r, axes) * EPSILON
        sig_e = edge_mean(sigma, axes)
        s = sig_e * dt / (2.0 * eps_e)
        ca = torch.ones(sc.padded, dtype=torch.float64, device=device)
        cb = torch.zeros(sc.padded, dtype=torch.float64, device=device)
        ek, ej, ei = eps_e.shape
        ca[:ek, :ej, :ei] = (1.0 - s) / (1.0 + s)
        cb[:ek, :ej, :ei] = (dt / (eps_e * dx)) / (1.0 + s)
        out[comp] = (stored(ca, sc), stored(cb, sc))
    return out


def debye_coefs(sc: Scene, device):
    """{'x','y','z': {'ca','cb','cp','k1','k2','sig'}} padded fp32 tensors of
    the Debye ADE update

        E' = ca E + cb curl H + cp P,     P' = k1 P + k2 (E' + E),
        k1 = (2 tau - dt) / (2 tau + dt), k2 = eps0 d_eps dt / (2 tau + dt),
        D = eps + k2 + sigma dt / 2,      ca = (eps - k2 - sigma dt / 2) / D,
        cb = (dt / dx) / D,               cp = (1 - k1) / D,

    with eps = eps0 eps_inf, each of the four cell maps averaged onto the
    edge first, all in fp64, rounded once to fp32; ``sig`` is the edge
    sigma of the work densities.  Outside each component's extent (ca, cb,
    cp, k1, k2, sig) = (1, 0, 0, 1, 0, 0)."""
    eps_inf, sigma, d_eps, tau = (torch.as_tensor(a, dtype=torch.float64, device=device) for a in sc.maps)
    dt, dx = sc.dt, sc.dx
    out = {}
    for comp, axes in COMP_AXES.items():
        eps_e = edge_mean(eps_inf, axes) * EPSILON
        sig_e = edge_mean(sigma, axes)
        de_e = edge_mean(d_eps, axes)
        tau_e = edge_mean(tau, axes)
        two_tau = 2.0 * tau_e + dt
        k1 = (2.0 * tau_e - dt) / two_tau
        k2 = EPSILON * de_e * dt / two_tau
        D = eps_e + k2 + 0.5 * sig_e * dt
        maps = {"ca": ((eps_e - k2 - 0.5 * sig_e * dt) / D, 1.0), "cb": ((dt / dx) / D, 0.0),
                "cp": ((1.0 - k1) / D, 0.0), "k1": (k1, 1.0), "k2": (k2, 0.0), "sig": (sig_e, 0.0)}
        ek, ej, ei = eps_e.shape
        out[comp] = {}
        for name, (edge, fill) in maps.items():
            t = torch.full(sc.padded, fill, dtype=torch.float64, device=device)
            t[:ek, :ej, :ei] = edge
            out[comp][name] = t.to(F32)
    return out


def e_means(f: dict, K: int, J: int, I: int):
    """Cell-centred means of the four E edges around each cell
    (main.c:602-634), fp32."""
    ex, ey, ez = f["ex"], f["ey"], f["ez"]
    mx = 0.25 * (ex[:K, :J, :I] + ex[1:K + 1, :J, :I] + ex[:K, 1:J + 1, :I] + ex[1:K + 1, 1:J + 1, :I])
    my = 0.25 * (ey[:K, :J, :I] + ey[:K, :J, 1:I + 1] + ey[1:K + 1, :J, :I] + ey[1:K + 1, :J, 1:I + 1])
    mz = 0.25 * (ez[:K, :J, :I] + ez[:K, 1:J + 1, :I] + ez[:K, :J, 1:I + 1] + ez[:K, 1:J + 1, 1:I + 1])
    return mx, my, mz


def h_means(f: dict, K: int, J: int, I: int):
    """Cell-centred means of the two H faces of each cell (main.c:636-668)."""
    hx, hy, hz = f["hx"], f["hy"], f["hz"]
    return (0.5 * (hx[:K, :J, :I] + hx[:K, :J, 1:I + 1]),
            0.5 * (hy[:K, :J, :I] + hy[:K, 1:J + 1, :I]),
            0.5 * (hz[:K, :J, :I] + hz[1:K + 1, :J, :I]))


def energies(f: dict, sc: Scene) -> tuple[float, float]:
    """(electric, magnetic) energy of the cavity in fp64, from the cell
    means (main.c:602-668)."""
    K, J, I = sc.grid
    dv = sc.dx ** 3
    d = {n: t.to(torch.float64) for n, t in f.items()}
    e = sum(float((m * m).sum()) for m in e_means(d, K, J, I))
    h = sum(float((m * m).sum()) for m in h_means(d, K, J, I))
    return e * dv * (EPSILON / 2.0), h * dv * (MU / 2.0)


class Reference:
    """The reference run of one scene from a given state, on ``device``."""

    def __init__(self, sc: Scene, device):
        self.sc = sc
        self.device = device
        self.j0, self.j1, self.i0, self.i1, self.inv_z_te, self.profile = source_patch(sc)
        self.hf = f32(sc.dt / (MU * sc.dx))  # main.c:441
        self.cb0 = f32(sc.dt / (EPSILON * sc.dx))  # main.c:479
        self.coefs = lossy_coefs(sc, device) if sc.maps is not None and not sc.debye else None
        self.ade = debye_coefs(sc, device) if sc.debye else None
        self.sigma = (stored(torch.as_tensor(sc.maps[1], dtype=torch.float64, device=device), sc)
                      if self.coefs is not None and sc.sar else None)
        # the work densities' divisor, dt in fp32, as a 0-d tensor on the device
        self.dt_t = torch.tensor(f32(sc.dt), dtype=F32, device=device)

    def drive_rows(self, ts: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """Each step's Ez and Hx rows of the patch: sin(2 pi f t) times the
        profile in fp64, rounded once to the storage dtype, as fp32."""
        amp = np.sin((2.0 * PI * self.sc.source_hz) * ts)
        row = amp[:, None] * self.profile[None, :]
        hx = (-self.inv_z_te) * row
        return (stored(torch.as_tensor(row, device=self.device), self.sc),
                stored(torch.as_tensor(hx, device=self.device), self.sc))

    def store(self, f: dict, names=COMPONENTS) -> None:
        """Round the fields ``names`` to the storage dtype in place (a
        bf16 scene's store; nothing at fp32)."""
        if self.sc.bf16:
            for n in names:
                f[n].copy_(f[n].to(torch.bfloat16))

    def source(self, f: dict, ez_row: torch.Tensor, hx_row: torch.Tensor) -> None:
        sl = (0, slice(self.j0, self.j1), slice(self.i0, self.i1))
        f["ez"][sl] = ez_row
        f["ex"][sl] = 0.0
        f["hz"][sl] = 0.0
        f["hx"][sl] = hx_row

    def update_h(self, f: dict) -> None:
        """H <- H + dt/(mu dx) curl E (main.c:431-462)."""
        K, J, I = self.sc.grid
        ex, ey, ez, fh = f["ex"], f["ey"], f["ez"], self.hf
        f["hx"][:K, :J, :] = f["hx"][:K, :J, :] + fh * (
            (ey[1:K + 1, :J, :] - ey[:K, :J, :]) - (ez[:K, 1:J + 1, :] - ez[:K, :J, :]))
        f["hy"][:K, :, :I] = f["hy"][:K, :, :I] + fh * (
            (ez[:K, :, 1:I + 1] - ez[:K, :, :I]) - (ex[1:K + 1, :, :I] - ex[:K, :, :I]))
        f["hz"][:, :J, :I] = f["hz"][:, :J, :I] + fh * (
            (ex[:, 1:J + 1, :I] - ex[:, :J, :I]) - (ey[:, :J, 1:I + 1] - ey[:, :J, :I]))

    def update_e(self, f: dict, pol: dict | None = None, work: dict | None = None) -> None:
        """E <- ca E + cb curl H inside the walls (main.c:469-500); in a
        Debye load E <- ca E + cb curl H + cp P and P <- k1 P + k2 (E' + E)
        on ``pol`` ({'x','y','z'}), and with ``work`` ({'ex','ey','ez'})
        each updated edge's work density E_mid ((P' - P) / dt + sigma
        E_mid), E_mid = (E' + E) / 2."""
        K, J, I = self.sc.grid
        hx, hy, hz = f["hx"], f["hy"], f["hz"]
        sx = (slice(1, K), slice(1, J), slice(0, I))
        sy = (slice(1, K), slice(0, J), slice(1, I))
        sz = (slice(0, K), slice(1, J), slice(1, I))
        curl_x = (hz[1:K, 1:J, :I] - hz[1:K, 0:J - 1, :I]) - (hy[1:K, 1:J, :I] - hy[0:K - 1, 1:J, :I])
        curl_y = (hx[1:K, :J, 1:I] - hx[0:K - 1, :J, 1:I]) - (hz[1:K, :J, 1:I] - hz[1:K, :J, 0:I - 1])
        curl_z = (hy[:K, 1:J, 1:I] - hy[:K, 1:J, 0:I - 1]) - (hx[:K, 1:J, 1:I] - hx[:K, 0:J - 1, 1:I])
        for name, sl, curl, c in (("ex", sx, curl_x, "x"), ("ey", sy, curl_y, "y"), ("ez", sz, curl_z, "z")):
            if self.ade is not None:
                m = self.ade[c]
                e_old, p_old = f[name][sl], pol[c][sl]
                e_new = m["ca"][sl] * e_old + m["cb"][sl] * curl + m["cp"][sl] * p_old
                p_new = m["k1"][sl] * p_old + m["k2"][sl] * (e_new + e_old)
                if work is not None:
                    e_mid = 0.5 * (e_new + e_old)
                    work[name][sl] = e_mid * ((p_new - p_old) / self.dt_t + m["sig"][sl] * e_mid)
                f[name][sl] = e_new
                pol[c][sl] = p_new
            elif self.coefs is None:
                f[name][sl] = f[name][sl] + self.cb0 * curl
            else:
                ca, cb = self.coefs[c]
                f[name][sl] = ca[sl] * f[name][sl] + cb[sl] * curl

    def deposit(self, f: dict, power: torch.Tensor) -> None:
        """power += (sigma |E|^2) dt at the cell centres, fp32."""
        K, J, I = self.sc.grid
        mx, my, mz = e_means(f, K, J, I)
        esq = mx * mx + my * my + mz * mz
        power.add_(self.sigma * esq * f32(self.sc.dt))

    def deposit_work(self, work: dict, power: torch.Tensor) -> None:
        """power += (the cell means of the three work densities, summed) dt,
        fp32."""
        K, J, I = self.sc.grid
        mx, my, mz = e_means(work, K, J, I)
        power.add_((mx + my + mz) * f32(self.sc.dt))

    def dft_add(self, f: dict, re: torch.Tensor, im: torch.Tensor, cw: torch.Tensor, sw: torch.Tensor) -> None:
        """re += cos(w t) E, im -= sin(w t) E for each frequency, on the
        cell means; ``cw``/``sw`` this step's fp32 weights."""
        K, J, I = self.sc.grid
        means = torch.stack(e_means(f, K, J, I))
        for q in range(re.shape[0]):
            re[q] += cw[q] * means
            im[q] -= sw[q] * means

    def probe_rows(self, f: dict) -> torch.Tensor:
        """(n_probes, 6) fp32: the six cell-centred components at each
        probe cell."""
        rows = []
        for k, j, i in self.sc.probes:
            cell = {n: t[k:k + 2, j:j + 2, i:i + 2] for n, t in f.items()}
            means = e_means(cell, 1, 1, 1) + h_means(cell, 1, 1, 1)
            rows.append(torch.stack([m[0, 0, 0] for m in means]))
        return torch.stack(rows)

    def follow(self, fields: dict, steps: int, pol: dict | None = None) -> dict:
        """Run ``steps`` steps from ``fields`` ({name: fp32 host array}) and,
        in a Debye load, the polarization ``pol`` ({'x','y','z'}: fp32
        arrays of the padded shape); returns {'state', 'pol', 'power', 'dft'
        (re, im), 'probes', 'energy' {iteration: (E, H)}}.  A bf16 scene
        loads ``fields`` into its storage and ends on a store."""
        sc, dev = self.sc, self.device
        K, J, I = sc.grid
        if sc.bf16 and steps % sc.round_every:
            raise ValueError(f"{steps} steps end between the stores every {sc.round_every} steps")
        per_pass = sc.bf16 and sc.round_every == 1  # the two-pass step: each pass stores its fields
        f = {n: torch.as_tensor(a, dtype=F32, device=dev).clone() for n, a in fields.items()}
        self.store(f)
        P = work = None
        if sc.debye:
            if pol is None:
                raise ValueError("a Debye load needs its initial polarization")
            P = {c: torch.as_tensor(a, dtype=F32, device=dev).clone() for c, a in pol.items()}
            if sc.sar:  # written on the updated edges only, zero elsewhere throughout
                work = {n: torch.zeros(sc.padded, dtype=F32, device=dev) for n in ("ex", "ey", "ez")}
        ts = time_counters(sc.dt, steps)
        ez_rows, hx_rows = self.drive_rows(ts)
        power = torch.zeros((K, J, I), dtype=F32, device=dev) if sc.sar else None
        dft = None
        if sc.dft_hz:
            ph = 2.0 * np.pi * np.asarray(sc.dft_hz, np.float64)[None, :] * ts[:, None]
            cw = torch.as_tensor(np.cos(ph).astype(np.float32), device=dev)
            sw = torch.as_tensor(np.sin(ph).astype(np.float32), device=dev)
            shape = (len(sc.dft_hz), 3, K, J, I)
            dft = (torch.zeros(shape, dtype=F32, device=dev), torch.zeros(shape, dtype=F32, device=dev))
        rows = []
        energy = {0: energies(f, sc)}
        for n in range(steps):
            self.source(f, ez_rows[n], hx_rows[n])
            self.update_h(f)
            if per_pass:
                self.store(f, ("hx", "hy", "hz"))
            self.source(f, ez_rows[n], hx_rows[n])
            self.update_e(f, P, work)
            if per_pass:
                self.store(f, ("ex", "ey", "ez"))
            if work is not None:
                self.deposit_work(work, power)
            elif power is not None:
                self.deposit(f, power)
            if dft is not None:
                self.dft_add(f, dft[0], dft[1], cw[n], sw[n])
            if sc.probes:
                rows.append(self.probe_rows(f))
            if sc.bf16 and not per_pass and (n + 1) % sc.round_every == 0:
                self.store(f)  # a sweep's store, after its SAR increments
            if (n + 1) % sc.output_every == 0:
                energy[n + 1] = energies(f, sc)
        probes = torch.stack(rows) if rows else None
        return {"state": f, "pol": P, "power": power, "dft": dft, "probes": probes, "energy": energy}
