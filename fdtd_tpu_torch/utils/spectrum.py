"""Resonance spectra from probe time series: the cavity mode finder.

The workflow the reference's validation mode hand-derives for one mode
(TE101 closed form, main.c:670-710), productized for *any* cavity: ring
the box with a broadband Gaussian burst (``--source-envelope
gaussian``), record a point probe (``--probe``), and read the resonant
mode frequencies off the probe spectrum.  No volumetric storage — the
probe series is 6 floats per step.

The spectrum uses a Hann window against leakage and quadratic
(log-amplitude parabolic) interpolation of each local maximum, so peak
frequencies resolve well below the 1/T bin width.
"""

from __future__ import annotations

import numpy as np


def amplitude_spectrum(times, series, window: str = "hann"):
    """(freqs, amp): windowed rFFT amplitude spectrum of one real series.

    ``times`` must be uniformly spaced (FDTD steps are).
    """
    t = np.asarray(times, np.float64)
    x = np.asarray(series, np.float64)
    if t.shape != x.shape or t.ndim != 1:
        raise ValueError("times and series must be equal-length 1-D")
    if len(t) < 4:
        raise ValueError("need at least 4 samples for a spectrum")
    dt = float(t[1] - t[0])
    if window == "hann":
        w = np.hanning(len(x))
    elif window in (None, "none", "rect"):
        w = np.ones(len(x))
    else:
        raise ValueError(f"unknown window {window!r}: use hann or none")
    # strip the mean: a static offset (e.g. the CPML alpha=0 residual)
    # carries no oscillation physics, and its windowed leakage into the
    # first bins would otherwise swamp the peak threshold
    x = x - x.mean()
    spec = np.abs(np.fft.rfft(x * w))
    freqs = np.fft.rfftfreq(len(x), dt)
    return freqs, spec


def find_peaks(freqs, amp, n_peaks: int = 5, min_rel: float = 0.05):
    """Strongest local maxima with parabolic refinement.

    Returns a list of (frequency, amplitude) sorted by amplitude,
    keeping peaks above ``min_rel`` of the global maximum.  The refined
    frequency interpolates the log-amplitude parabola through the peak
    bin and its neighbors — an order of magnitude better than the bin
    width for isolated resonances.
    """
    f = np.asarray(freqs)
    a = np.asarray(amp, np.float64)
    if len(f) < 3:
        return []
    interior = (a[1:-1] > a[:-2]) & (a[1:-1] >= a[2:])
    idx = np.nonzero(interior)[0] + 1
    # threshold against the spectrum EXCLUDING the DC bin: index 0 can
    # never be a peak, so a static offset (e.g. the CPML alpha=0
    # residual) must not suppress real resonances
    idx = idx[a[idx] >= min_rel * a[1:].max()]
    idx = idx[np.argsort(a[idx])[::-1][:n_peaks]]
    out = []
    df = f[1] - f[0]
    for i in idx:
        ya, yb, yc = a[i - 1], a[i], a[i + 1]
        if ya > 0 and yc > 0 and yb > 0:
            la, lb, lc = np.log(ya), np.log(yb), np.log(yc)
            denom = la - 2 * lb + lc
            delta = 0.5 * (la - lc) / denom if denom != 0 else 0.0
            delta = float(np.clip(delta, -0.5, 0.5))
        else:
            delta = 0.0
        out.append((float(f[i] + delta * df), float(yb)))
    return out


def ring_down_q(times, series, frequency: float | None = None,
                skip_transient: float = 0.0):
    """(Q, decay_rate, frequency) from a ring-down probe series.

    Fits the amplitude envelope A(t) ~ exp(-gamma t) by log-linear least
    squares through the rectified-peak sequence (DC residual subtracted
    — CPML alpha=0 leaves a static offset), and returns the quality
    factor Q = omega / (2 gamma) (amplitude decay at gamma means energy
    decays at 2 gamma).  ``frequency`` defaults to the spectrum's
    dominant peak.  A non-decaying (closed-cavity) series yields a huge
    or negative-gamma Q — check ``decay_rate`` before trusting Q.
    """
    t = np.asarray(times, np.float64)
    x = np.asarray(series, np.float64)
    n0 = int(len(x) * skip_transient)
    t, x = t[n0:], x[n0:]
    if len(x) < 16:
        raise ValueError("need at least 16 samples for a ring-down fit")
    x = x - x[-max(len(x) // 8, 1):].mean()  # strip the static residual
    if frequency is None:
        freqs, amp = amplitude_spectrum(t, x)
        peaks = find_peaks(freqs, amp, n_peaks=1)
        if not peaks:
            raise ValueError("no spectral peak to anchor the frequency")
        frequency = peaks[0][0]
    ax = np.abs(x)
    pk = np.nonzero((ax[1:-1] > ax[:-2]) & (ax[1:-1] >= ax[2:]))[0] + 1
    pk = pk[ax[pk] > 1e-3 * ax.max()]  # log() needs headroom
    if len(pk) < 4:
        raise ValueError("too few envelope peaks for a decay fit")
    gamma, _b = np.polyfit(t[pk], np.log(ax[pk]), 1)
    gamma = -float(gamma)
    omega = 2.0 * np.pi * float(frequency)
    q = omega / (2.0 * gamma) if gamma != 0 else float("inf")
    return float(q), gamma, float(frequency)


def probe_mode_spectrum(result, probe: int = 0, component: str = "ey",
                        n_peaks: int = 5, skip_transient: float = 0.0):
    """(freqs, amp, peaks) from a :class:`RunResult` with probes.

    ``skip_transient``: fraction (0-1) of the series to drop from the
    front — for pulsed runs, analyzing only the post-burst ring-down
    sharpens the resonances (the drive spectrum is broad).
    """
    pr = result.probes
    if pr is None:
        raise ValueError("run_simulation was not given probes")
    x = pr.series(probe, component)
    t = pr.times
    n0 = int(len(x) * skip_transient)
    if len(x) - n0 < 4:
        raise ValueError("too few samples after skip_transient")
    freqs, amp = amplitude_spectrum(t[n0:], x[n0:])
    return freqs, amp, find_peaks(freqs, amp, n_peaks=n_peaks)
