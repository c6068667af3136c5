"""Orthogonal wavelet filter banks, generated from first principles.

The reference pipeline obtains its filters from ``pywt.Wavelet(name)``
(reference: src/audiofakedetect/wavelet_math.py:239) and supports the
``haar``/``dbN``/``symN``/``coifN`` families (reference: scripts/start_exps.sh
sweeps db2-10/sym2-10/coif2-10; bundled checkpoints use sym5 and coif4).

pywt ships precomputed coefficient tables.  This module *generates* the same
filter banks numerically:

* ``dbN``   — Daubechies extremal-phase filters via spectral factorization of
              the half-band polynomial, selecting the minimum-phase roots.
* ``symN``  — Daubechies least-asymmetric filters ("symlets"): same spectral
              factorization, but the root subset is chosen to minimise the
              nonlinear part of the filter phase.
* ``coifN`` — Coiflets: scaling filter of length 6N with 2N vanishing wavelet
              moments and 2N-1 vanishing scaling-function moments, found by
              damped Gauss-Newton on the defining equations.
* ``haar``  — alias of db1 (exact).

Filter-bank conventions follow pywt exactly:

    rec_lo = h                    (the scaling filter)
    dec_lo = reverse(h)
    rec_hi = qmf(h)               (qmf(h)[k] = (-1)**k * h[N-1-k])
    dec_hi = reverse(rec_hi)

All coefficients are float64 numpy arrays; transforms cast as needed.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
from scipy.special import comb


@dataclass(frozen=True)
class Wavelet:
    """An orthogonal wavelet filter bank (pywt-compatible conventions)."""

    name: str
    rec_lo: np.ndarray = field(repr=False)

    @property
    def dec_len(self) -> int:
        return len(self.rec_lo)

    @property
    def dec_lo(self) -> np.ndarray:
        return self.rec_lo[::-1].copy()

    @property
    def rec_hi(self) -> np.ndarray:
        return qmf(self.rec_lo)

    @property
    def dec_hi(self) -> np.ndarray:
        return qmf(self.rec_lo)[::-1].copy()

    def filter_bank(self):
        """Return (dec_lo, dec_hi, rec_lo, rec_hi) like pywt.Wavelet."""
        return self.dec_lo, self.dec_hi, self.rec_lo.copy(), self.rec_hi


def qmf(h: np.ndarray) -> np.ndarray:
    """Quadrature mirror filter: qmf(h)[k] = (-1)**k * h[N-1-k]."""
    h = np.asarray(h, dtype=np.float64)
    g = h[::-1].copy()
    g[1::2] *= -1.0
    return g


# ---------------------------------------------------------------------------
# Daubechies / symlet spectral factorization
# ---------------------------------------------------------------------------


def _binomial_halfband_roots(order: int) -> np.ndarray:
    """Roots (in z) of P(y(z)) where P(y)=sum_k C(N-1+k,k) y^k, y=(2-z-1/z)/4.

    Returns the roots of the degree 2(order-1) polynomial z^(order-1)*P(y(z)).
    Roots come in reciprocal pairs (r, 1/r); complex ones additionally in
    conjugate pairs.
    """
    n = order
    # Build P(y) coefficients (ascending powers of y).
    p_y = np.array([comb(n - 1 + k, k, exact=True) for k in range(n)], dtype=np.float64)
    # Substitute y = (2 - z - 1/z)/4; multiply by z^(n-1) to clear denominators.
    # y(z) * z = (2z - z^2 - 1)/4   -> represent polynomials in z (ascending).
    y_z = np.array([-0.25, 0.5, -0.25])  # (-1 + 2z - z^2)/4, ascending in z
    total = np.zeros(2 * (n - 1) + 1)
    for k in range(n):
        # term: p_y[k] * (y(z))^k * z^(n-1)  = p_y[k] * (y_z)^k * z^(n-1-k)
        term = np.array([1.0])
        for _ in range(k):
            term = np.convolve(term, y_z)
        shifted = np.zeros(2 * (n - 1) + 1)
        shifted[n - 1 - k : n - 1 - k + len(term)] = term
        total += p_y[k] * shifted
    # np.roots expects descending coefficients; polish with Newton steps
    # (the companion-matrix roots degrade for high orders).
    coeffs = total[::-1]
    roots = np.roots(coeffs)
    dcoeffs = np.polyder(coeffs)
    for _ in range(6):
        f = np.polyval(coeffs, roots)
        df = np.polyval(dcoeffs, roots)
        step = np.where(np.abs(df) > 1e-30, f / np.where(df == 0, 1, df), 0)
        roots = roots - step
    return roots


def _group_reciprocal_roots(roots: np.ndarray):
    """Group roots into reciprocal sets.

    Returns a list of groups; each group is a tuple (inside, outside) where
    ``inside`` are the roots with |r|<1 of the set and ``outside`` their
    reciprocals.  Complex-conjugate pairs are kept together so any selection
    yields real filter coefficients.
    """
    remaining = list(roots)
    groups = []
    tol = 1e-7

    def pop_close(val):
        for i, r in enumerate(remaining):
            if abs(r - val) < tol * max(1.0, abs(val)):
                return remaining.pop(i)
        return None

    while remaining:
        r = remaining.pop(0)
        # synthesize missing partners (root finding may miss matches at
        # high orders); reciprocals/conjugates are exact by construction
        recip = pop_close(1.0 / r)
        if recip is None:
            recip = 1.0 / r
        if abs(r.imag) < 1e-10:
            inside = [r] if abs(r) < 1 else [recip]
            outside = [recip] if abs(r) < 1 else [r]
        else:
            conj = pop_close(np.conj(r))
            if conj is None:
                conj = np.conj(r)
            conj_recip = pop_close(1.0 / np.conj(r))
            if conj_recip is None:
                conj_recip = 1.0 / np.conj(r)
            quad = [r, recip, conj, conj_recip]
            inside = [x for x in quad if abs(x) < 1]
            outside = [x for x in quad if abs(x) >= 1]
        groups.append((inside, outside))
    return groups


def _scaling_from_roots(order: int, chosen_roots) -> np.ndarray:
    """Assemble the scaling filter h from (1+z)^order and chosen q-roots."""
    h = np.array([1.0])
    for _ in range(order):
        h = np.convolve(h, [0.5, 0.5])
    q = np.array([1.0 + 0.0j])
    for r in chosen_roots:
        q = np.convolve(q, [1.0, -r])
    q = np.real(q)
    h = np.convolve(h, q)
    h *= np.sqrt(2.0) / np.sum(h)
    return h


def _phase_nonlinearity(h: np.ndarray) -> float:
    """Sup-norm of the nonlinear phase component of H(w) over (0, pi)."""
    n = len(h)
    w = np.linspace(0.05, np.pi - 0.05, 256)
    hw = np.exp(-1j * np.outer(w, np.arange(n))) @ h
    tau = (n - 1) / 2.0
    phase = np.unwrap(np.angle(hw * np.exp(1j * w * tau)))
    # remove remaining constant/linear fit
    a, b = np.polyfit(w, phase, 1)
    return float(np.max(np.abs(phase - (a * w + b))))


@functools.lru_cache(maxsize=None)
def _daubechies(order: int) -> np.ndarray:
    """Minimum-phase Daubechies scaling filter of given order (dbN)."""
    if order == 1:
        return np.array([1.0, 1.0]) / np.sqrt(2.0)
    roots = _binomial_halfband_roots(order)
    chosen = [r for r in roots if abs(r) < 1.0]
    h = _scaling_from_roots(order, chosen)
    # pywt dbN is the extremal-phase factor with the *peak towards the front*
    # (e.g. db2 rec_lo = [0.483, 0.837, 0.224, -0.129]).  Orient accordingly.
    if np.argmax(np.abs(h)) > (len(h) - 1) / 2.0:
        h = h[::-1].copy()
    return h


@functools.lru_cache(maxsize=None)
def _symlet(order: int) -> np.ndarray:
    """Least-asymmetric Daubechies scaling filter (symN)."""
    if order in (1, 2, 3):
        # sym1/2/3 coincide with db1/2/3 (too few root groups to improve).
        return _daubechies(order)
    roots = _binomial_halfband_roots(order)
    groups = _group_reciprocal_roots(roots)
    best = None
    best_val = np.inf
    for mask in range(1 << len(groups)):
        chosen = []
        for gi, (inside, outside) in enumerate(groups):
            chosen.extend(outside if (mask >> gi) & 1 else inside)
        h = _scaling_from_roots(order, chosen)
        val = _phase_nonlinearity(h)
        if val < best_val - 1e-12:
            best_val = val
            best = h
    assert best is not None
    # Resolve the reflection ambiguity the same way pywt's tables do: the
    # symlet tables put the larger of the two end coefficients at the end
    # of rec_lo (e.g. sym4 rec_lo starts 0.0322... ends -0.0758; sym5 starts
    # 0.0195... ends 0.0273 with |h[-1]| > |h[0]|).
    if abs(best[0]) > abs(best[-1]):
        best = best[::-1].copy()
    return best


# ---------------------------------------------------------------------------
# Coiflets
# ---------------------------------------------------------------------------

# Coiflets are built with the construction from Daubechies, "Ten Lectures on
# Wavelets", §8.2: in centred coordinates (moment centre M = 4K-1, matching
# the pywt tables: coif1 peak 0.8526 at index 3, coif2 peak 0.8127 at 7),
#
#     m0~(w) = c^K P_K(s) + s^K c^K G(w),      c = cos^2(w/2), s = sin^2(w/2)
#
# where P_K(s) = sum_{k<K} C(K-1+k,k) s^k (the Bezout half-band part, which
# guarantees 2K vanishing scaling moments for *any* G via c^K P_K(s) =
# 1 - s^K P_K(c)) and the c^K factor on the correction guarantees 2K
# vanishing wavelet moments.  G(w) = sum_{n=-(2K-1)}^{0} g_n e^{-inw} has only
# 2K free coefficients; they are fixed by the orthonormality identity
# |m0(w)|^2 + |m0(w+pi)|^2 = 1, solved by Gauss-Newton from g = 0.


def _trig_mul(a: dict, b: dict) -> dict:
    out: dict = {}
    for na, va in a.items():
        for nb, vb in b.items():
            out[na + nb] = out.get(na + nb, 0.0) + va * vb
    return out


def _trig_pow(a: dict, k: int) -> dict:
    out = {0: 1.0}
    for _ in range(k):
        out = _trig_mul(out, a)
    return out


_C = {0: 0.5, 1: 0.25, -1: 0.25}  # cos^2(w/2) in the e^{-inw} basis
_S = {0: 0.5, 1: -0.25, -1: -0.25}  # sin^2(w/2)


def _coiflet_m0_centered(g: np.ndarray, order: int) -> dict:
    """Centred m0~ coefficients for correction coefficients g (length 2K)."""
    k = order
    p = {0: 0.0}
    s_pow = {0: 1.0}
    for j in range(k):
        cj = float(comb(k - 1 + j, j, exact=True))
        for n, v in s_pow.items():
            p[n] = p.get(n, 0.0) + cj * v
        s_pow = _trig_mul(s_pow, _S)
    m = _trig_mul(_trig_pow(_C, k), p)
    gdict = {(-n): g[n] for n in range(2 * k)}  # exponents 0 .. -(2K-1)
    corr = _trig_mul(_trig_mul(_trig_pow(_S, k), _trig_pow(_C, k)), gdict)
    for n, v in corr.items():
        m[n] = m.get(n, 0.0) + v
    return m


def _coiflet_orth_residual(g: np.ndarray, order: int) -> np.ndarray:
    m = _coiflet_m0_centered(g, order)
    # |m0|^2 coefficients: conv(m, reverse(m)); keep even exponents >= 0.
    sq: dict = {}
    for na, va in m.items():
        for nb, vb in m.items():
            sq[na - nb] = sq.get(na - nb, 0.0) + va * vb
    res = []
    max_e = max(abs(n) for n in sq)
    for e in range(0, max_e + 1, 2):
        target = 0.5 if e == 0 else 0.0
        res.append(sq.get(e, 0.0) - target)
    return np.asarray(res)


@functools.lru_cache(maxsize=None)
def _coiflet(order: int) -> np.ndarray:
    """Coiflet scaling filter of length 6*order (pywt ``coifN``)."""
    from scipy.optimize import least_squares

    k = order
    # Analytic seed: with Q = P_K(s) + s^K G, orthonormality asks
    # |Q|^2 ~ P_2K(s), whose leading correction gives
    # G(0) = ([s^K] P_2K - [s^K] P_K^2) / 2.  Seed g[0] with that value
    # (exact for the converged solutions at small K), refine with LM, and
    # fall back to seeded random restarts around it.
    p_k = np.zeros(k + 1)
    p_k[:k] = [comb(k - 1 + j, j, exact=True) for j in range(k)]
    p_sq = np.convolve(p_k, p_k)
    g0 = (comb(3 * k - 1, k, exact=True) - p_sq[k]) / 2.0
    rng = np.random.RandomState(0)
    best = None
    for attempt in range(64):
        x0 = np.zeros(2 * k)
        x0[0] = g0
        if attempt > 0:
            x0 += rng.normal(0.0, 0.05 * g0 * min(attempt, 8), 2 * k)
        sol = least_squares(
            _coiflet_orth_residual,
            x0,
            args=(order,),
            xtol=1e-15,
            ftol=1e-15,
            gtol=1e-15,
            method="lm",
            max_nfev=50000,
        )
        if np.max(np.abs(_coiflet_orth_residual(sol.x, order))) < 1e-12:
            best = sol.x
            break
    if best is None:
        raise RuntimeError(f"coif{order} solve did not converge")
    m = _coiflet_m0_centered(best, order)
    h = np.zeros(6 * k)
    centre = 4 * k - 1
    for n, v in m.items():
        h[n + centre] = np.sqrt(2.0) * v
    return h


# ---------------------------------------------------------------------------
# Public factory
# ---------------------------------------------------------------------------


def _validate(name: str, h: np.ndarray, tol: float = 1e-5) -> np.ndarray:
    """Fail loudly if numerical generation degraded (high orders)."""
    worst = 0.0
    for m in range(len(h) // 2):
        ip = float(np.dot(h[: len(h) - 2 * m], h[2 * m :]))
        worst = max(worst, abs(ip - (1.0 if m == 0 else 0.0)))
    if not np.isfinite(h).all() or worst > tol:
        raise ValueError(
            f"Filter generation for {name!r} lost orthogonality "
            f"(error {worst:.2e}); supported ranges: db1-20, sym2-16, "
            "coif1-10."
        )
    return h


@functools.lru_cache(maxsize=None)
def get_wavelet(name: str) -> Wavelet:
    """Build a wavelet filter bank by pywt-style name (haar, dbN, symN, coifN)."""
    name = name.lower().strip()
    if name == "haar":
        return Wavelet("haar", _daubechies(1))
    if name.startswith("db"):
        return Wavelet(name, _validate(name, _daubechies(int(name[2:]))))
    if name.startswith("sym"):
        return Wavelet(name, _validate(name, _symlet(int(name[3:]))))
    if name.startswith("coif"):
        return Wavelet(name, _validate(name, _coiflet(int(name[4:]))))
    raise ValueError(f"Unknown or unsupported wavelet: {name!r}")
