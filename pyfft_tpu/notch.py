"""Second-order IIR notch / peak filter design (Orfanidis).

Role of the reference ``notch_filter.py`` (``iirnotch`` :19, ``iirpeak`` :97,
``_design_notch_peak_filter`` :175-241): the textbook second-order designs
from S. J. Orfanidis, *Introduction to Signal Processing*, Prentice-Hall,
1996 — formulas 11.3.4/11.3.7 (notch) and 11.3.19/11.3.21 (peak).

Design is host-side NumPy; application goes through the framework's IIR
scan (:func:`pyfft_tpu.filters.filtfilt`) or, for streaming, the
FIR overlap-save path via :func:`pyfft_tpu.filters.iir_to_fir`.
"""
from __future__ import annotations

import numpy as np

__all__ = ["iirnotch", "iirpeak", "notch_filter", "peak_filter"]


def _design_notch_peak(w0, Q, ftype):
    w0 = float(w0)
    Q = float(Q)
    if w0 > 1.0 or w0 < 0.0:
        raise ValueError("w0 should be such that 0 < w0 < 1")

    bw = (w0 / Q) * np.pi
    w0 = w0 * np.pi
    gb = 1.0 / np.sqrt(2.0)                    # -3 dB point

    if ftype == "notch":
        beta = (np.sqrt(1.0 - gb ** 2.0) / gb) * np.tan(bw / 2.0)
    elif ftype == "peak":
        beta = (gb / np.sqrt(1.0 - gb ** 2.0)) * np.tan(bw / 2.0)
    else:
        raise ValueError("Unknown ftype.")

    gain = 1.0 / (1.0 + beta)

    if ftype == "notch":
        b = gain * np.array([1.0, -2.0 * np.cos(w0), 1.0])
    else:
        b = (1.0 - gain) * np.array([1.0, 0.0, -1.0])
    a = np.array([1.0, -2.0 * gain * np.cos(w0), (2.0 * gain - 1.0)])
    return b, a


# reference-parity alias (reference ``notch_filter.py:175``)
_design_notch_peak_filter = _design_notch_peak


def iirnotch(w0, Q):
    """Second-order notch: rejects a narrow band around ``w0`` (normalized
    to Nyquist).  ``Q = w0 / bw`` at the -3 dB width.  Returns ``(b, a)``."""
    return _design_notch_peak(w0, Q, "notch")


def iirpeak(w0, Q):
    """Second-order peak (resonator): passes only a narrow band around
    ``w0`` (normalized to Nyquist).  Returns ``(b, a)``."""
    return _design_notch_peak(w0, Q, "peak")


def notch_filter(x, w0, Q, zero_phase=True, axis=-1):
    """Apply a notch at ``w0`` to a signal (zero-phase by default)."""
    from .filters import filtfilt, lfilter
    b, a = iirnotch(w0, Q)
    return filtfilt(b, a, x, axis=axis) if zero_phase else lfilter(b, a, x, axis=axis)


def peak_filter(x, w0, Q, zero_phase=True, axis=-1):
    """Apply a resonator at ``w0`` to a signal (zero-phase by default)."""
    from .filters import filtfilt, lfilter
    b, a = iirpeak(w0, Q)
    return filtfilt(b, a, x, axis=axis) if zero_phase else lfilter(b, a, x, axis=axis)
