"""Portfolio-optimization helpers (reference ``applications/finance/portfolio.py``).

Markowitz mean-variance portfolio selection as a QUBO for QAOA: minimize
``q x^T Σ x − μ^T x + t (1^T x − B)^2`` over binary x.  Expanding the budget
penalty and dropping the constant ``t B^2`` gives the Q matrix below.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

Tensor = Any

__all__ = ["QUBO_from_portfolio", "StockData"]

_TRADING_DAYS = 252


def QUBO_from_portfolio(cov: Tensor, mean: Tensor, q: float, B: int, t: float) -> Tensor:
    """Q matrix for the budgeted mean-variance problem.

    :param cov: (n, n) covariance of asset returns
    :param mean: (n,) expected returns
    :param q: risk aversion
    :param B: budget (number of assets to pick)
    :param t: penalty strength for the budget constraint
    """
    cov = np.asarray(cov, dtype=float)
    mean = np.asarray(mean, dtype=float)
    n = cov.shape[0]
    # (1^T x - B)^2 = x^T (J - 2B I) x + B^2  for binary x (x_i^2 = x_i)
    penalty = np.ones((n, n)) - 2.0 * B * np.eye(n)
    return q * cov - np.diag(mean) + t * penalty


class StockData:
    """Annualized return / covariance from daily price series.

    :param data: list of equal-length price series, one per asset.
    """

    def __init__(self, data: Sequence[Sequence[float]]):
        lengths = {len(series) for series in data}
        if len(lengths) != 1:
            raise ValueError("all price series must cover the same time span")
        self.data = [np.asarray(series, dtype=float) for series in data]
        self.n_stocks = len(self.data)
        self.n_days = len(self.data[0])
        self.daily_change = np.stack(
            [series[1:] / series[:-1] - 1.0 for series in self.data]
        )

    def get_return(self, decimals: int = 5) -> np.ndarray:
        """Annualized (geometric) return per asset."""
        growth = np.prod(1.0 + self.daily_change, axis=1)
        annual = growth ** (_TRADING_DAYS / self.n_days)
        return np.round(annual, decimals)

    def get_covariance(self, decimals: int = 5) -> np.ndarray:
        """Annualized covariance of daily changes."""
        centered = self.daily_change - self.daily_change.mean(axis=1, keepdims=True)
        cov = (centered @ centered.T) * (_TRADING_DAYS / self.n_days)
        return np.round(cov, decimals)
