"""A solve against the factor made in set-up, to the configuration's
tolerance. Span: solve."""


def warm(ctx):
    """Set-up on this traffic's shapes: the factorization every request
    solves against, and one solve on the warm-up slot."""
    s, w = ctx.solver, ctx.inputs.warm
    s.factorize()
    s.solve(ctx.inputs.rhs[w], tol=ctx.tol)


def serve(ctx, slot, spans):
    with spans.span("solve"):
        return ctx.solver.solve(ctx.inputs.rhs[slot], tol=ctx.tol)
