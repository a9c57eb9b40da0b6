"""Adaptive threshold tuning (paper Algorithm 1, §3.4.3.2 and §3.6.1).

    if phi_S - phi_H >= tau and eps > eps_u:   tau <- increase(tau)
    elif phi_S - phi_H < tau and eps < eps_l:  tau <- phi_S - phi_H  (start now)
    else:                                      tau unchanged

High state-migration time correction (§3.6.1): start mitigation early at
    tau' = tau - (f_hat_S - f_hat_H) * t * M
so the migration *ends* when the gap reaches tau.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TauAdjuster:
    eps_l: float
    eps_u: float
    tau: float
    increase_by: float = 50.0
    min_tau: float = 1.0

    def adjust(self, phi_s: float, phi_h: float, eps: float) -> float:
        gap = phi_s - phi_h
        if gap >= self.tau and eps > self.eps_u:
            # sample too small for a good estimate -> wait longer next time
            self.tau = self.tau + self.increase_by
        elif gap < self.tau and eps < self.eps_l:
            # estimate already good -> don't wait, mitigate at current gap
            self.tau = max(self.min_tau, gap)
        return self.tau


def tau_prime(tau_n: float, f_hat_s: float, f_hat_h: float,
              tuples_per_sec: float, migration_secs: float) -> float:
    """§3.6.1: detection threshold corrected for state-migration time M."""
    return tau_n - (f_hat_s - f_hat_h) * tuples_per_sec * migration_secs
