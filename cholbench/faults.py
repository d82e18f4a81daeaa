"""Faults planted under a run to show that the comparison which decides
`correct` catches them (`control.py --fault`, and the CPU tests). Each is a
`prepare(solver, cfg)` hook: `harness.run` applies it to the solver before
set-up warms it. The benchmark's own runs never plant one."""


def stale_factor(solver, cfg):
    """A refactorization that keeps the factor it already has: after the
    first factorization, `update_values` replaces the values (and what the
    solve derives from them) but not the factor, and `factorize` leaves it
    as it is."""
    update, factorize = solver.update_values, solver.factorize

    def update_values(vals, rows=None, cols=None):
        kept = (solver.panels, solver.factored, solver._inv)
        update(vals, rows, cols)
        if kept[1]:
            solver.panels, solver.factored, solver._inv = kept

    def stale(*args, **kwargs):
        return solver.panels if solver.factored else factorize(*args,
                                                               **kwargs)

    solver.update_values, solver.factorize = update_values, stale


FAULTS = {"stale_factor": stale_factor}
