"""The general traffic generator. A mix is a data file
(`mixes/<name>.json`) of parameters; this module turns one, a problem size
and a seed into the inputs of a closed loop with one caller.

Keys of a mix:

  request       the request's kind, `requests/<request>.py`: "cycle"
                (update_values, factorize, solve) or "solve" (solves
                against the factor made in set-up).
  shift         the values of input k are those of A_k = A + (1 / tau_k) I,
                tau_k log-uniform on [tau_min, tau_max]
                ({"tau_min", "tau_max"}); null: A itself.
  columns       right-hand sides per request (a vector for 1, else an
                [n, columns] block).
  pool          distinct inputs drawn from the seed; request k takes input
                k mod pool. The shifts are stratified: one from each of
                `pool` equal slices of [log tau_min, log tau_max], in an
                order drawn from the seed, so that every seed poses the same
                spread of conditioning.
  check_every   every check_every-th answer (from an offset drawn from the
                seed), and the last, is compared with the reference.
  factor_check_every
                optional: after every factor_check_every-th request (from
                an offset drawn from the seed), outside its timed span, the
                factor it left is applied once unrefined for the factor
                check; choose it coprime to `pool` so that the checks visit
                every input. The window's last factor is checked in any
                case.

The inputs are made before the window opens, in NumPy, from
`numpy.random.default_rng(seed)`; the same seed gives the same inputs.
"""

from __future__ import annotations

import json
import os

import numpy as np


def load_mix(root, name):
    with open(os.path.join(root, "mixes", name + ".json")) as f:
        return json.load(f)


class Inputs:
    """A pool of inputs: per slot a shift (0 where the mix has none) and a
    right-hand side; a warm-up slot apart, which the window never uses."""

    def __init__(self, mix, n, seed):
        rng = np.random.default_rng(int(seed))
        self.pool = int(mix["pool"])
        cols = int(mix.get("columns", 1))
        shift = mix.get("shift")
        if shift:
            lo = np.log(float(shift["tau_min"]))
            hi = np.log(float(shift["tau_max"]))
            strata = (np.arange(self.pool + 1)
                      + rng.random(self.pool + 1)) / (self.pool + 1)
            tau = np.exp(lo + (hi - lo) * strata)[rng.permutation(
                self.pool + 1)]
            self.shifts = list(1.0 / tau)
        else:
            self.shifts = [0.0] * (self.pool + 1)
        shape = (n,) if cols == 1 else (n, cols)
        self.rhs = [rng.standard_normal(shape) for _ in range(self.pool + 1)]
        every = int(mix.get("check_every", 1))
        self.check_every = every
        self.check_offset = int(rng.integers(every))
        fevery = int(mix.get("factor_check_every", 0))
        self.factor_check_every = fevery
        self.factor_check_offset = int(rng.integers(fevery)) if fevery else 0
        # the last slot is the warm-up's
        self.warm = self.pool

    def slot(self, k):
        return k % self.pool

    def checked(self, k):
        return k % self.check_every == self.check_offset

    def factor_checked(self, k):
        return (self.factor_check_every > 0 and k % self.factor_check_every
                == self.factor_check_offset)


def shifted(vals, diag, shift):
    """The values of A + shift I, `diag` marking A's diagonal entries."""
    v = vals.copy()
    v[diag] += shift
    return v
