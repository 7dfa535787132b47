"""Window functions and the recommended-overlap (ROV) registry.

Design note
-----------
Window generation is *configuration-time* work: a window is a small 1-D
constant that is computed once on the host and then closed over by the
jit-compiled spectral kernels (where the multiply is fused into the framing /
FFT pipeline).  Generating it with NumPy keeps jit traces free of redundant
window recomputation and keeps exact float64 parity with the reference
regardless of the accelerator compute dtype.  Everything here is pure NumPy;
the compute path (``pyfft_tpu.spectral``) converts to device arrays.

Parity notes
------------
* ``windows(name, ...)`` reproduces the reference dispatcher's behavior
  (reference ``windows.py:57-297``): substring name matching, per-window
  recommended-overlap metadata, and the *periodic* convention
  ``func(nwins + 1)[:-1]`` (reference ``windows.py:278-279``).
* The cosine-sum coefficient tables and ROV values are the published data
  from G. Heinzel et al., "Spectrum and spectral density estimation by the
  DFT ..." (the report vendored by the reference as
  ``fft_analysis_reference.pdf``).
* The general window suite mirrors the ``scipy.signal.windows`` API that the
  reference vendors (reference ``windows.py:301-2425``), implemented from the
  standard definitions.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "windows", "window_registry", "get_window",
    "general_cosine", "boxcar", "triang", "parzen", "bohman", "blackman",
    "nuttall", "blackmanharris", "flattop", "bartlett", "hann", "hanning",
    "tukey", "barthann", "general_hamming", "hamming", "kaiser", "gaussian",
    "general_gaussian", "cosine", "exponential", "chebwin", "slepian", "dpss",
]


# --------------------------------------------------------------------------- #
# Low-level builders
# --------------------------------------------------------------------------- #

def _len_guards(M):
    if int(M) != M or M < 0:
        raise ValueError("Window length M must be a non-negative integer")
    return M <= 1


def _extend(M, sym):
    if not sym:
        return M + 1, True
    return M, False


def _truncate(w, needed):
    return w[:-1] if needed else w


def _cosine_sum_periodic(M, coeffs):
    """Signed cosine-sum window on the periodic grid ``z = 2*pi*j/M``.

    This is the evaluation convention of the reference's Nuttall/flat-top
    family (reference ``windows.py:222-233``): ``w_j = sum_i c_i cos(i z_j)``
    with *signed* coefficients ``c_i``.
    """
    z = 2.0 * np.pi * np.arange(M) / M
    w = np.zeros(M, dtype=np.float64)
    for i, c in enumerate(coeffs):
        w += c * np.cos(i * z)
    return w


# --------------------------------------------------------------------------- #
# ROV registry (data from the Heinzel GH_FFT report; reference windows.py:57-271)
# --------------------------------------------------------------------------- #

def _np_hanning(M):
    return np.hanning(M)


def _np_hamming(M):
    return np.hamming(M)


def _np_bartlett(M):
    return np.bartlett(M)


def _welch_parabola(M):
    z = 2.0 * np.arange(M) / M
    return 1.0 - (z - 1.0) * (z - 1.0)


def _rect(M):
    return np.ones(M, dtype=np.float64)


# name -> (title, info-string, generator(M)->w, recommended_overlap)
_COS_SUM = {
    "blackmanharris4": (0.35875, -0.48829, 0.14128, -0.01168),
    "sft3f": (0.26526, -0.5, 0.23474),
    "sft4f": (0.21706, -0.42103, 0.28294, -0.07897),
    "sft5f": (0.1881, -0.36923, 0.28702, -0.13077, 0.02488),
    "sft3m": (0.28235, -0.52105, 0.19659),
    "sft4m": (0.241906, -0.460841, 0.255381, -0.041872),
    "sft5m": (0.209671, -0.407331, 0.281225, -0.092669, 0.0091036),
    "nuttall3": (0.375, -0.5, 0.125),
    "nuttall3a": (0.40897, -0.5, 0.09103),
    "nuttall3b": (0.4243801, -0.4973406, 0.0782793),
    "nuttall4": (0.3125, -0.46875, 0.1875, -0.03125),
    "nuttall4a": (0.338946, -0.481973, 0.161054, -0.018027),
    "nuttall4b": (0.355768, -0.487396, 0.144232, -0.012604),
    "nuttall4c": (0.3635819, -0.4891775, 0.1365995, -0.0106411),
}


def _cos_sum_fn(key):
    coeffs = _COS_SUM[key]
    return lambda M: _cosine_sum_periodic(M, coeffs)


_REGISTRY = {
    "hanning": ("Hanning",
                "(SLDR~f**-3, PSLL=-31.5dB, ROV=50.0%, AF=1.000, PF=0.707, OC=0.167)",
                _np_hanning, 0.50),
    "hamming": ("Hamming",
                "(SLDR~f**-1, PSLL=-42.7dB, ROV=50.0%, AF=1.000, PF=0.761, OC=0.234)",
                _np_hamming, 0.50),
    "blackmanharris": ("Blackman-Harris type",
                       "(SLDR~f**-1, PSLL=-92dB, ROV=66.1%, AF=0.926, PF=0.718, OC=0.235)",
                       _cos_sum_fn("blackmanharris4"), 0.661),
    "sft3f": ("Fast-decaying Flattop",
              "(SLDR~f**-3, PSLL=-31.7dB, ROV=66.7%, AF=0.998, PF=0.558, OC=-0.029)",
              _cos_sum_fn("sft3f"), 0.667),
    "sft4f": ("Fast-decaying Flattop",
              "(SLDR~f**-5, PSLL=-44.7dB, ROV=75.0%, AF=1.000, PF=0.647, OC=0.039)",
              _cos_sum_fn("sft4f"), 0.75),
    "sft5f": ("Fast-decaying Flattop",
              "(SLDR~f**-7, PSLL=-57.3dB, ROV=78.5%, AF=0.969, PF=0.648, OC=0.052)",
              _cos_sum_fn("sft5f"), 0.785),
    "sft3m": ("Minimum sidelobe Flattop",
              "(SLDR~f**-1, PSLL=-44.2dB, ROV=65.5%, AF=0.949, PF=0.584, OC=-0.005)",
              _cos_sum_fn("sft3m"), 0.655),
    "sft4m": ("Minimum sidelobe Flattop",
              "(SLDR~f**-1, PSLL=-66.5dB, ROV=72.1%, AF=0.964, PF=0.641, OC=0.044)",
              _cos_sum_fn("sft4m"), 0.721),
    "sft5m": ("Minimum sidelobe Flattop",
              "(SLDR~f**-1, PSLL=-89.9dB, ROV=76.0%, AF=0.953, PF=0.645, OC=0.053)",
              _cos_sum_fn("sft5m"), 0.760),
    "nuttall3": ("3-term Blackman-Harris type",
                 "(SLDR~f**-5, PSLL=-46.7dB, ROV=64.7%, AF=0.969, PF=0.738, OC=0.228)",
                 _cos_sum_fn("nuttall3"), 0.647),
    "nuttall3a": ("3-term Blackman-Harris type",
                  "(SLDR~f**-3, PSLL=-64.2dB, ROV=61.2%, AF=0.943, PF=0.723, OC=0.227)",
                  _cos_sum_fn("nuttall3a"), 0.612),
    "nuttall3b": ("3-term Blackman-Harris type",
                  "(SLDR~f**-1, PSLL=-71.5dB, ROV=59.8%, AF=0.939, PF=0.721, OC=0.229)",
                  _cos_sum_fn("nuttall3b"), 0.598),
    "nuttall4": ("4-term Blackman-Harris type",
                 "(SLDR~f**-7, PSLL=-60.9dB, ROV=70.5%, AF=0.937, PF=0.723, OC=0.233)",
                 _cos_sum_fn("nuttall4"), 0.705),
    "nuttall4a": ("4-term Blackman-Harris type",
                  "(SLDR~f**-5, PSLL=-82.6dB, ROV=68.0%, AF=0.931, PF=0.721, OC=0.234)",
                  _cos_sum_fn("nuttall4a"), 0.68),
    "nuttall4b": ("4-term Blackman-Harris type",
                  "(SLDR~f**-3, PSLL=-93.3dB, ROV=66.3%, AF=0.924, PF=0.715, OC=0.233)",
                  _cos_sum_fn("nuttall4b"), 0.663),
    "nuttall4c": ("4-term Blackman-Harris type",
                  "(SLDR~f**-1, PSLL=-98.1dB, ROV=65.6%, AF=0.923, PF=0.716, OC=0.235)",
                  _cos_sum_fn("nuttall4c"), 0.656),
    "welch": ("Welch",
              "(SLDR~f**-2, PSLL=-21.3dB, ROV=29.3%, AF=0.828, PF=0.707, OC=0.091)",
              _welch_parabola, 0.293),
    "bartlett": ("Bartlett",
                 "(SLDR~f**-2, PSLL=-26.5dB, ROV=50.0%, AF=1.000, PF=0.707, OC=0.250)",
                 _np_bartlett, 0.50),
    "rect": ("Rectangular",
             "(SLDR~f**-1, PSLL=-13.3dB, ROV=0.0%, AF=0, PF=1, OC=0)",
             _rect, 0.0),
}

# Ordered substring dispatch, reproducing the reference's if/elif precedence
# (reference windows.py:63-272).  The SFT/Nuttall family sub-dispatch order
# matters ('3' must come after '3f'/'3m'/'3a'/'3b', etc.).
_SFT_FAMILY_ORDER = [
    ("3f", "sft3f"), ("4f", "sft4f"), ("5f", "sft5f"),
    ("3m", "sft3m"), ("4m", "sft4m"), ("5m", "sft5m"),
    ("3a", "nuttall3a"), ("3b", "nuttall3b"), ("3", "nuttall3"),
    ("4a", "nuttall4a"), ("4b", "nuttall4b"), ("4c", "nuttall4c"),
    ("4", "nuttall4"),
]


def _resolve_name(windowfunction, beta=None):
    """Resolve a window-name string to a registry key (reference dispatch)."""
    name = windowfunction.lower()
    if "hann" in name:
        return "hanning", None
    if "hamm" in name:
        return "hamming", None
    if "black" in name:
        return "blackmanharris", None
    if ("nut" in name) or ("flat" in name) or ("sft" in name):
        for sub, key in _SFT_FAMILY_ORDER:
            if sub in name:
                return key, None
        # family name without a variant defaults to nuttall4 (last branch of
        # the reference's chain would not match; pick the maximally smooth one)
        return "nuttall4", None
    if "kaiser" in name:
        return "kaiser", beta
    if "welch" in name:
        return "welch", None
    if "bart" in name:
        return "bartlett", None
    return "rect", None


def window_registry():
    """Return a copy of the ROV registry: name -> (title, info, ROV)."""
    return {k: (v[0], v[1], v[3]) for k, v in _REGISTRY.items()}


def windows(windowfunction, **kwargs):
    """Window dispatcher with recommended-overlap metadata.

    Behavior-parity reimplementation of the reference dispatcher
    (reference ``windows.py:57-297``):

    - Without ``nwins``: returns the window's recommended fractional overlap.
    - With ``nwins``: returns the window samples; ``periodic=True`` (default)
      evaluates ``func(nwins+1)[:-1]``.
    - ``msgout=True`` additionally returns ``(title, info)`` strings.
    - ``'kaiser'`` requires ``beta=...``; its ROV is the reference's fixed 2/3.
    """
    verbose = kwargs.setdefault("verbose", True)
    periodic = kwargs.setdefault("periodic", True)
    msgout = kwargs.setdefault("msgout", False)
    beta = kwargs.get("beta", None)

    key, beta = _resolve_name(windowfunction, beta)

    if key == "kaiser":
        # beta is only needed to *build* the window; the bare ROV lookup
        # (the reference's fft_analysis.py:104-111 defaulting call) works
        # without it, exactly as the reference dispatcher does
        if beta is None and "nwins" in kwargs:
            raise ValueError("kaiser window requires a 'beta' keyword")
        str1 = "Kaiser type"
        str2 = ("(parameters dependent on input shaping parameter %4.3f)"
                % (beta,) if beta is not None else "(beta pending)")
        func = lambda M: np.kaiser(M, beta)  # noqa: E731
        ROV = 2.0 / 3.0  # reference fixes this; true value varies with beta
    else:
        str1, str2, func, ROV = _REGISTRY[key]

    if "nwins" in kwargs:
        nwins = int(kwargs["nwins"])
        if periodic:
            str3 = "periodic"
            win = func(nwins + 1)[:-1]
        else:
            str3 = "aperiodic"
            win = func(nwins)
        val = win
        msg = "Using a %s %s window function\n%s" % (str3, str1, str2)
    else:
        val = ROV
        msg = "Getting recommended overlap for a %s window function" % (str1,)

    if verbose:
        print(msg)
    if msgout:
        return val, (str1, str2)
    return val


# --------------------------------------------------------------------------- #
# General window suite (scipy.signal.windows-compatible API)
# --------------------------------------------------------------------------- #

def general_cosine(M, a, sym=True):
    """Weighted cosine-series window ``w = sum_k a_k cos(k z)``, ``z`` on
    ``[-pi, pi]`` (unsigned-coefficient convention)."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    fac = np.linspace(-np.pi, np.pi, M)
    w = np.zeros(M)
    for k, ak in enumerate(a):
        w += ak * np.cos(k * fac)
    return _truncate(w, needs_trunc)


def boxcar(M, sym=True):
    """Rectangular window."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    return _truncate(np.ones(M, float), needs_trunc)


def triang(M, sym=True):
    """Triangular window (non-zero endpoints)."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(1, (M + 1) // 2 + 1)
    if M % 2 == 0:
        w = (2 * n - 1.0) / M
        w = np.r_[w, w[::-1]]
    else:
        w = 2 * n / (M + 1.0)
        w = np.r_[w, w[-2::-1]]
    return _truncate(w, needs_trunc)


def parzen(M, sym=True):
    """Parzen (de la Vallee Poussin) window."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(-(M - 1) / 2.0, (M - 1) / 2.0 + 0.5, 1.0)
    na = np.extract(n < -(M - 1) / 4.0, n)
    nb = np.extract(abs(n) <= (M - 1) / 4.0, n)
    wa = 2 * (1 - np.abs(na) / (M / 2.0)) ** 3.0
    wb = (1 - 6 * (np.abs(nb) / (M / 2.0)) ** 2.0
          + 6 * (np.abs(nb) / (M / 2.0)) ** 3.0)
    w = np.r_[wa, wb, wa[::-1]]
    return _truncate(w, needs_trunc)


def bohman(M, sym=True):
    """Bohman window."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    fac = np.abs(np.linspace(-1, 1, M)[1:-1])
    w = (1 - fac) * np.cos(np.pi * fac) + 1.0 / np.pi * np.sin(np.pi * fac)
    w = np.r_[0, w, 0]
    return _truncate(w, needs_trunc)


def blackman(M, sym=True):
    """Blackman window."""
    return general_cosine(M, [0.42, 0.50, 0.08], sym)


def nuttall(M, sym=True):
    """Nuttall 4-term minimum-sidelobe window."""
    return general_cosine(M, [0.3635819, 0.4891775, 0.1365995, 0.0106411], sym)


def blackmanharris(M, sym=True):
    """4-term Blackman-Harris window."""
    return general_cosine(M, [0.35875, 0.48829, 0.14128, 0.01168], sym)


def flattop(M, sym=True):
    """Flat-top window (SRS FT coefficients, as in scipy)."""
    a = [0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368]
    return general_cosine(M, a, sym)


def bartlett(M, sym=True):
    """Bartlett window (zero endpoints)."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(M)
    w = np.where(n <= (M - 1) / 2.0,
                 2.0 * n / (M - 1), 2.0 - 2.0 * n / (M - 1))
    return _truncate(w, needs_trunc)


def hann(M, sym=True):
    """Hann window."""
    return general_cosine(M, [0.5, 0.5], sym)


hanning = hann


def tukey(M, alpha=0.5, sym=True):
    """Tukey (tapered-cosine) window."""
    if _len_guards(M):
        return np.ones(M)
    if alpha <= 0:
        return np.ones(M, float)
    if alpha >= 1.0:
        return hann(M, sym=sym)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(M)
    width = int(np.floor(alpha * (M - 1) / 2.0))
    n1 = n[0:width + 1]
    n2 = n[width + 1:M - width - 1]
    n3 = n[M - width - 1:]
    w1 = 0.5 * (1 + np.cos(np.pi * (-1 + 2.0 * n1 / alpha / (M - 1))))
    w2 = np.ones(n2.shape[0])
    w3 = 0.5 * (1 + np.cos(np.pi * (-2.0 / alpha + 1 + 2.0 * n3 / alpha / (M - 1))))
    w = np.concatenate((w1, w2, w3))
    return _truncate(w, needs_trunc)


def barthann(M, sym=True):
    """Modified Bartlett-Hann window."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(M)
    fac = np.abs(n / (M - 1.0) - 0.5)
    w = 0.62 - 0.48 * fac + 0.38 * np.cos(2 * np.pi * fac)
    return _truncate(w, needs_trunc)


def general_hamming(M, alpha, sym=True):
    """Generalized Hamming window ``alpha - (1-alpha) cos``."""
    return general_cosine(M, [alpha, 1.0 - alpha], sym)


def hamming(M, sym=True):
    """Hamming window."""
    return general_hamming(M, 0.54, sym)


def kaiser(M, beta, sym=True):
    """Kaiser window (I0 Bessel taper)."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(M)
    alpha = (M - 1) / 2.0
    w = (np.i0(beta * np.sqrt(1 - ((n - alpha) / alpha) ** 2.0))
         / np.i0(beta))
    return _truncate(w, needs_trunc)


def gaussian(M, std, sym=True):
    """Gaussian window with standard deviation ``std`` samples."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(M) - (M - 1.0) / 2.0
    w = np.exp(-(n ** 2) / (2 * std * std))
    return _truncate(w, needs_trunc)


def general_gaussian(M, p, sig, sym=True):
    """Generalized Gaussian window ``exp(-0.5 |n/sig|^{2p})``."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    n = np.arange(M) - (M - 1.0) / 2.0
    w = np.exp(-0.5 * np.abs(n / sig) ** (2 * p))
    return _truncate(w, needs_trunc)


def cosine(M, sym=True):
    """Half-cycle sine window."""
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    w = np.sin(np.pi / M * (np.arange(0, M) + 0.5))
    return _truncate(w, needs_trunc)


def exponential(M, center=None, tau=1.0, sym=True):
    """Exponential (Poisson) window."""
    if sym and center is not None:
        raise ValueError("If sym==True, center must be None.")
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)
    if center is None:
        center = (M - 1) / 2.0
    n = np.arange(0, M)
    w = np.exp(-np.abs(n - center) / tau)
    return _truncate(w, needs_trunc)


def _cheb_T(n, x):
    """Chebyshev polynomial ``T_n`` on the whole real line: the cosine form
    inside [-1, 1], the hyperbolic continuation outside (with the parity
    relation ``T_n(-x) = (-1)^n T_n(x)`` for ``x < -1``)."""
    out = np.empty_like(np.asarray(x, dtype=float))
    inside = np.abs(x) <= 1
    out[inside] = np.cos(n * np.arccos(x[inside]))
    hi = x > 1
    out[hi] = np.cosh(n * np.arccosh(x[hi]))
    lo = x < -1
    out[lo] = (-1.0) ** (n % 2) * np.cosh(n * np.arccosh(-x[lo]))
    return out


def chebwin(M, at, sym=True):
    """Dolph-Chebyshev window with ``at`` dB sidelobe attenuation.

    Textbook frequency-sampling construction (Lyons, *Understanding DSP*
    §5; Antoniou 2005): the window's DFT magnitude is the order-(M-1)
    Chebyshev polynomial evaluated on the grid ``beta*cos(pi k / M)`` with
    ``beta`` chosen so sidelobes sit ``at`` dB down; an inverse transform
    (with the half-sample phase shift for even lengths, so the result is
    symmetric about ``(M-1)/2``) and unit-peak scaling give the taps.
    """
    if _len_guards(M):
        return np.ones(M)
    M, needs_trunc = _extend(M, sym)

    order = M - 1.0
    beta = np.cosh(np.arccosh(10.0 ** (np.abs(at) / 20.0)) / order)
    k = np.arange(M, dtype=float)
    spec = _cheb_T(order, beta * np.cos(np.pi * k / M))

    if M % 2:
        half = np.fft.fft(spec).real[:(M + 1) // 2]
        w = np.concatenate((half[:0:-1], half))
    else:
        # even length: shift the sampling grid by half a bin so the
        # time-domain taps land symmetric about the inter-sample midpoint
        half = np.fft.fft(spec * np.exp(1j * np.pi * k / M)).real[:M // 2 + 1]
        w = np.concatenate((half[:0:-1], half[1:]))
    return _truncate(w / w.max(), needs_trunc)


def slepian(M, width, sym=True):
    """First DPSS (Slepian) sequence with half-bandwidth ``width``.

    Provided for API parity with the reference's vendored suite
    (reference ``windows.py:1897``); computed as the leading ``dpss`` taper.
    """
    w = dpss(M, width * M / 2.0, Kmax=None, sym=sym, norm=2)
    return w / w.max()


def _midpoint_value(w):
    """Band-limited interpolant of ``w`` at the inter-sample point
    ``t = (M-1)/2`` — the true peak of an even-length symmetric taper —
    evaluated through the DFT shift theorem:

        w(t0) = (1/M) [ W_0 + 2 sum_{k>=1} Re( W_k e^{2 pi i k t0 / M} ) ]

    with ``e^{2 pi i k t0 / M} = (-1)^k e^{-i pi k / M}`` at ``t0=(M-1)/2``.
    """
    M = len(w)
    spec = np.fft.rfft(w)
    k = np.arange(1, M // 2 + 1)
    phase = np.exp(1j * np.pi * k * (M - 1.0) / M)
    return (spec[0].real + 2.0 * (spec[1:] * phase).real.sum()) / M


def dpss(M, NW, Kmax=None, sym=True, norm=None, return_ratios=False):
    """Discrete prolate spheroidal (Slepian) sequences.

    Derivation (Percival & Walden 1993, §8.4; Slepian 1978): rather than
    diagonalizing the dense time-bandwidth concentration operator, use the
    tridiagonal operator that commutes with it —

        T[i, i]   = ((M - 1 - 2 i) / 2)^2 * cos(2 pi W),   W = NW / M
        T[i, i+1] = (i + 1)(M - i - 1) / 2

    whose eigenvectors (taken at the top of the spectrum, in descending
    eigenvalue order) are the DPSS tapers.  Sign and unit-peak
    normalization conventions ('approximate' / 'subsample' even-length
    corrections) match ``scipy.signal.windows.dpss`` (BSD-3-Clause) so the
    tapers are drop-in interchangeable with the suite the reference vendors
    (reference ``windows.py:1986-2245``); the implementation here is
    vectorized and re-derived per the citations above.
    """
    from scipy.linalg import eigh_tridiagonal

    if _len_guards(M):
        return np.ones(M)
    single = Kmax is None
    if norm is None:
        norm = "approximate" if single else 2
    K = 1 if single else int(Kmax)
    if not 0 < K <= M:
        raise ValueError("Kmax must be greater than 0 and less than M")
    if not 0 < NW < M / 2.0:
        raise ValueError("NW must be positive and less than M/2.")
    M, needs_trunc = _extend(M, sym)

    W = float(NW) / M
    i = np.arange(M)
    diag = ((M - 1 - 2.0 * i) / 2.0) ** 2 * np.cos(2 * np.pi * W)
    offdiag = i[1:] * (M - i[1:]) / 2.0
    _, vecs = eigh_tridiagonal(diag, offdiag, select="i",
                               select_range=(M - K, M - 1))
    tapers = vecs[:, ::-1].T                 # (K, M), best-concentrated first

    # sign convention, vectorized: symmetric (even-order) tapers average
    # positive; antisymmetric (odd-order) tapers rise from a positive first
    # significant sample
    sgn = np.ones(K)
    even = np.arange(0, K, 2)
    sgn[even] = np.where(tapers[even].sum(axis=1) < 0, -1.0, 1.0)
    odd = np.arange(1, K, 2)
    if odd.size:
        thresh = max(1e-7, 1.0 / M)
        first = np.argmax(tapers[odd] ** 2 > thresh, axis=1)
        sgn[odd] = np.where(tapers[odd, first] < 0, -1.0, 1.0)
    tapers = tapers * sgn[:, None]

    if return_ratios:
        # concentration lambda_k: the energy fraction of each taper inside
        # [-W, W], via its autocorrelation against the bandlimited kernel
        # 2W sinc(2W l)  (P&W eq. 8.4)
        kern = 4.0 * W * np.sinc(2.0 * W * i)
        kern[0] = 2.0 * W
        ratios = _autocorr_fft(tapers) @ kern
        if single:
            ratios = ratios[0]

    if norm != 2:
        # unit-peak normalization; even-length symmetric tapers peak midway
        # between the two central samples, so rescale by the interpolated
        # (or approximated) midpoint value
        tapers = tapers / tapers.max()
        if M % 2 == 0:
            if norm == "approximate":
                tapers *= M ** 2 / float(M ** 2 + NW)
            else:
                tapers *= 1.0 / _midpoint_value(tapers[0])
    tapers = _truncate(tapers.T, needs_trunc).T
    if single:
        tapers = tapers[0]
    return (tapers, ratios) if return_ratios else tapers


def _autocorr_fft(x):
    """Row-wise linear autocorrelation ``r[l] = sum_t x[t] x[t+l]`` via
    zero-padded real FFTs."""
    N = x.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(2 * N - 1)))
    X = np.fft.rfft(x, nfft, axis=-1)
    return np.fft.irfft(X.real ** 2 + X.imag ** 2, n=nfft, axis=-1)[..., :N]


_WIN_EQUIV = {
    "barthann": barthann, "brthan": barthann, "bth": barthann,
    "bartlett": bartlett, "bart": bartlett, "brt": bartlett,
    "blackman": blackman, "black": blackman, "blk": blackman,
    "blackmanharris": blackmanharris, "blackharr": blackmanharris, "bkh": blackmanharris,
    "bohman": bohman, "bman": bohman, "bmn": bohman,
    "boxcar": boxcar, "box": boxcar, "ones": boxcar,
    "rect": boxcar, "rectangular": boxcar,
    "chebwin": chebwin, "cheb": chebwin,
    "cosine": cosine, "halfcosine": cosine,
    "exponential": exponential, "poisson": exponential,
    "flattop": flattop, "flat": flattop, "flt": flattop,
    "gaussian": gaussian, "gauss": gaussian, "gss": gaussian,
    "general gaussian": general_gaussian, "general_gaussian": general_gaussian,
    "general gauss": general_gaussian, "ggs": general_gaussian,
    "hamming": hamming, "hamm": hamming, "ham": hamming,
    "hanning": hann, "hann": hann, "han": hann,
    "kaiser": kaiser, "ksr": kaiser,
    "nuttall": nuttall, "nutl": nuttall, "nut": nuttall,
    "parzen": parzen, "parz": parzen, "par": parzen,
    "slepian": slepian, "slep": slepian, "optimal": slepian,
    "dpss": dpss,
    "triangle": triang, "triang": triang, "tri": triang,
    "tukey": tukey, "tuk": tukey,
    "general hamming": general_hamming, "general_hamming": general_hamming,
}

_NEEDS_PARAM = {chebwin, exponential, gaussian, general_gaussian,
                general_hamming, kaiser, slepian, dpss, tukey}


def get_window(window, Nx, fftbins=True):
    """Return a window of length ``Nx`` by name / (name, args) tuple / scalar.

    Mirrors ``scipy.signal.get_window`` semantics (reference
    ``windows.py:2325``): ``fftbins=True`` returns a periodic window; a float
    ``window`` means a Kaiser beta.
    """
    sym = not fftbins
    args = ()
    if isinstance(window, (list, tuple)):
        winstr = window[0]
        if len(window) > 1:
            args = window[1:]
    elif isinstance(window, str):
        if window in _NEEDS_PARAM and window not in ("tukey",):
            raise ValueError("The '" + window + "' window needs one or more parameters -- pass a tuple.")
        winstr = window
    elif isinstance(window, (int, float)):
        winstr = "kaiser"
        args = (float(window),)
    else:
        raise ValueError("%s as window type is not supported." % str(type(window)))

    try:
        winfunc = _WIN_EQUIV[winstr]
    except KeyError:
        raise ValueError("Unknown window type.")

    if winfunc in _NEEDS_PARAM and len(args) == 0:
        raise ValueError("The '" + winstr + "' window needs one or more parameters -- pass a tuple.")
    return winfunc(Nx, *args, sym=sym)


# --------------------------------------------------------------------------- #
# Callable-module shim: the package re-exports a `windows` FUNCTION at
# `pyfft_tpu.windows` for reference parity (the reference's own
# `import windows` / `windows.windows` py2 idiom collapsed to a bare
# callable in its public API).  That attribute used to shadow THIS
# submodule for `import pyfft_tpu.windows as w` users.  Making the module
# itself callable serves both: `pyfft_tpu.windows('hanning')` dispatches,
# and `pyfft_tpu.windows.hanning` / `import pyfft_tpu.windows` expose the
# full window library.  (`pyfft_tpu.windows_mod` remains as an alias.)
def _make_module_callable():
    import sys
    import types

    class _CallableWindowsModule(types.ModuleType):
        __call__ = staticmethod(windows)

    sys.modules[__name__].__class__ = _CallableWindowsModule


_make_module_callable()
