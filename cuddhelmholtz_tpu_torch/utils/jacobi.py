"""Jacobi polynomial evaluation (host-side, float64 NumPy).

Counterpart of ``cuddhelmholtz_tpu/utils/jacobi.py``: used by the quadrature
builder for Newton refinement of Gauss nodes and for closed-form weights.
"""

from __future__ import annotations

import math

import numpy as np


def jacobi_p(n: int, alpha: float, beta: float, x: np.ndarray) -> np.ndarray:
    """Evaluate the Jacobi polynomial P_n^{(alpha,beta)} at points ``x``
    (three-term recurrence; the result has the shape of ``x``)."""
    x = np.asarray(x, dtype=np.float64)
    p_prev = np.ones_like(x)
    if n == 0:
        return p_prev
    p = (alpha + 1.0) + 0.5 * (alpha + beta + 2.0) * (x - 1.0)
    a, b = alpha, beta
    for m in range(2, n + 1):
        c1 = 2.0 * m * (m + a + b) * (2.0 * m + a + b - 2.0)
        c2 = (2.0 * m + a + b - 1.0) * (a * a - b * b)
        c3 = (2.0 * m + a + b - 1.0) * (2.0 * m + a + b) * (2.0 * m + a + b - 2.0)
        c4 = 2.0 * (m + a - 1.0) * (m + b - 1.0) * (2.0 * m + a + b)
        p_next = ((c2 + c3 * x) * p - c4 * p_prev) / c1
        p_prev, p = p, p_next
    return p


def jacobi_p_derivative(k: int, n: int, alpha: float, beta: float, x: np.ndarray) -> np.ndarray:
    """k-th derivative of P_n^{(alpha,beta)} at ``x``:
    Gamma(n+a+b+1+k) / (2^k Gamma(n+a+b+1)) P_{n-k}^{(a+k,b+k)}."""
    if k > n:
        return np.zeros_like(np.asarray(x, dtype=np.float64))
    scale = math.exp(
        math.lgamma(n + alpha + beta + 1 + k)
        - math.lgamma(n + alpha + beta + 1)
        - k * math.log(2.0)
    )
    return scale * jacobi_p(n - k, alpha + k, beta + k, x)
