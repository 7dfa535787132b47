"""Small numeric utilities replacing the reference's private ``pybaseutils``.

The reference package imports ``interp``, ``trapz_var``, ``sliding_window_1d``
and ``reshapech`` from a private helper package (reference
``fft_analysis.py:22-24``, ``filters.py:13``, ``ccf.py:15``).  These are
re-created here from their call-site semantics, as pure JAX functions.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def interp(xi, yi, ei=None, xo=None):
    """Linear interpolation with optional uncertainty propagation.

    Parameters mirror the reference call sites (e.g. ``filters.py:29``:
    ``_ut.interp(tt, u_t, ei=None, xo=ti)``).

    - ``xi, yi``: sample grid and values (interpolation along axis 0 of yi).
    - ``ei``: optional 1-sigma uncertainty on ``yi``; if given, the linearly
      propagated uncertainty is returned as a second output.
    - ``xo``: query points.
    """
    xi = jnp.asarray(xi)
    yi = jnp.asarray(yi)
    if xo is None:
        xo = xi
    xo = jnp.asarray(xo)

    idx = jnp.clip(jnp.searchsorted(xi, xo, side="right") - 1, 0, xi.shape[0] - 2)
    x0 = xi[idx]
    x1 = xi[idx + 1]
    frac = (xo - x0) / (x1 - x0)

    def _lin(y):
        y0 = jnp.take(y, idx, axis=0)
        y1 = jnp.take(y, idx + 1, axis=0)
        f = frac.reshape(frac.shape + (1,) * (y.ndim - 1))
        return y0 + f * (y1 - y0)

    yo = _lin(yi)
    if ei is None:
        return yo
    ei = jnp.asarray(ei)
    e0 = jnp.take(ei, idx, axis=0)
    e1 = jnp.take(ei, idx + 1, axis=0)
    f = frac.reshape(frac.shape + (1,) * (ei.ndim - 1))
    eo = jnp.sqrt(((1 - f) * e0) ** 2 + (f * e1) ** 2)
    return yo, eo


def trapz_var(x, y, ey=None, vary=None, dim=0):
    """Trapezoidal integration with variance propagation.

    Matches the reference call convention (``fft_analysis.py:891-902``):
    ``[I, varI, _, _] = trapz_var(x, y, None, vary, dim=0)``.

    The trapezoid rule is a linear functional ``I = sum_i w_i y_i`` with
    ``w_i = (dx_{i-1} + dx_i)/2`` (half-weights at the ends), so the variance
    propagates as ``varI = sum_i w_i^2 var_i``.
    """
    import jax
    # host inputs stay numpy: integratespectra feeds complex128 spectra,
    # which would lose precision on a device without x64
    traced = any(isinstance(a, jax.core.Tracer) for a in (x, y, vary))
    xp = jnp if traced else np
    x = xp.asarray(x)
    y = xp.moveaxis(xp.asarray(y), dim, 0)
    n = y.shape[0]
    dx = xp.diff(x)
    # trapezoid as a linear functional: half-weights at the ends
    w = 0.5 * xp.concatenate([dx[:1], dx[1:] + dx[:-1], dx[-1:]])
    wb = w.reshape((n,) + (1,) * (y.ndim - 1))
    integral = xp.sum(wb * y, axis=0)
    if vary is None:
        var = xp.zeros_like(integral)
    else:
        vary = xp.moveaxis(xp.asarray(vary), dim, 0)
        var = xp.sum((wb ** 2) * vary, axis=0)
    return integral, var, None, None


def sliding_window_1d(t, x, win, ss=None, ind_only=False):
    """Split a 1-D series into (overlapping) windows.

    Reference call sites: ``Doppler.py:69`` (``ind_only=1`` returning start/stop
    index pairs) and ``Doppler.py:84`` / ``ccf.py:92-93`` returning
    ``(t_windows, x_windows, t_centers)`` with ``x_windows`` of shape
    ``(nwindows, win)``.

    ``ss`` is the window step (defaults to ``win`` -> non-overlapping).
    """
    t = jnp.asarray(t)
    x = jnp.asarray(x)
    if ss is None or ss == 0:
        ss = win
    ss = int(ss)
    win = int(win)
    n = x.shape[0]
    nwin = 1 + (n - win) // ss if n >= win else 0
    starts = jnp.arange(nwin) * ss
    if ind_only:
        return jnp.stack([starts, starts + win], axis=-1)
    idx = starts[:, None] + jnp.arange(win)[None, :]
    xw = x[idx]
    tw = t[idx]
    tc = jnp.mean(tw, axis=-1)
    return tw, xw, tc


def reshapech(x):
    """Reshape a spectrum (or stack of spectra) to ``(nfreq, nch)``.

    Mirrors the reference helper used by ``integratespectra``
    (``fft_analysis.py:883-888``): 1-D inputs become a single column.

    Shape-only — never converts the input: pushing host complex arrays
    through ``jnp.asarray`` would land them on the default accelerator
    for nothing.
    """
    if not hasattr(x, "ndim"):
        x = np.asarray(x)
    if x.ndim == 1:
        return x[:, None]
    if x.shape[0] == 1:
        return x.T
    return x


def rect(x):
    """Unit rectangle function (reference ``fft_deriv`` test oracle)."""
    x = jnp.asarray(x)
    ax = jnp.abs(x)
    return jnp.where(ax < 0.5, 1.0, jnp.where(ax == 0.5, 0.5, 0.0))


def delta(x):
    """Discrete impulse: 1 where ``x == 0`` (reference test oracle)."""
    x = jnp.asarray(x)
    return jnp.where(x == 0.0, 1.0, 0.0)
