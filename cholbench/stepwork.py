"""The fixed work of each step of a multifrontal Cholesky of a
configuration's ordering: per front with p pivots and m boundary rows (the
fronts of `yardstick.front_sizes`), summed over the fronts. Plain NumPy,
independent of the solver under test.

  pivot   the partial factorization: the pivot Cholesky and the boundary
          strip's triangular solve, p^3 / 3 + m p^2 flops; the front's
          factor entries p (p + 1) / 2 + m p read and written once
  schur   the symmetric Schur update of the boundary block, m^2 p flops;
          the strip (m p) read and the update (m^2) written once
  extadd  the extend-add: each child's update (m_c^2) read, and the
          parent's entries it lands on read and written

Bytes at `yardstick.VALUE_BYTES` a value (float32).

    python cholbench/stepwork.py cholbench/configs/<config>.json

prints the configuration's step counts (the `step_work` entry of its file)
as one JSON line.
"""

from __future__ import annotations

import json
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from cholbench import yardstick  # noqa: E402


def step_work(pivots, boundary):
    """{pivot,schur}_{flops,bytes} and extadd_bytes of fronts with
    `pivots` p and `boundary` m. Every front but the root (m = 0) is a
    child, so the extend-add sums over all fronts."""
    p = pivots.astype(np.float64)
    m = boundary.astype(np.float64)
    vb = yardstick.VALUE_BYTES
    return {"pivot_flops": float(np.sum(p ** 3 / 3.0 + m * p * p)),
            "pivot_bytes": int(2 * vb * np.sum(pivots * (pivots + 1) // 2
                                               + boundary * pivots)),
            "schur_flops": float(np.sum(m * m * p)),
            "schur_bytes": int(vb * np.sum(boundary * pivots
                                           + boundary * boundary)),
            "extadd_bytes": int(3 * vb * np.sum(boundary * boundary))}


def count_step_work(cfg, root=yardstick.HERE):
    """The step counts of one factorization of a configuration."""
    op = yardstick.operator(cfg, root)
    n, rows, cols, _ = op.coo(cfg)
    return step_work(*yardstick.front_sizes(n, rows, cols,
                                            op.separators(cfg)))


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        print(json.dumps(count_step_work(json.load(f))))
