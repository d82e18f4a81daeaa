"""launches.solve: kernels launched in the traced window per solve, from
the profiler. Moves solve_ms."""


def read(rec):
    p = rec.profile
    if p is None or rec.mix["request"] != "solve" or not p["kernels"]:
        return None
    return p["kernels"] / p["requests"]
