"""A refactor cycle: update_values(A_k) -> factorize() -> solve(b_k) to the
configuration's tolerance. Spans: update, factor, solve."""


def warm(ctx):
    """Set-up on this traffic's shapes: one cycle on the warm-up slot, and
    one unrefined application of its factor (the factor check's path)."""
    s, w = ctx.solver, ctx.inputs.warm
    s.update_values(ctx.values[w])
    s.factorize()
    s.solve(ctx.inputs.rhs[w], tol=ctx.tol)
    s.solve(ctx.inputs.rhs[w], refine="never")


def serve(ctx, slot, spans):
    s = ctx.solver
    with spans.span("update"):
        s.update_values(ctx.values[slot])
    with spans.span("factor"):
        s.factorize()
    with spans.span("solve"):
        return s.solve(ctx.inputs.rhs[slot], tol=ctx.tol)
