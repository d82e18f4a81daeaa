"""setup_s: from process start to the window's first timed operation (s):
imports, inputs, planning, the first factorization and solve, warm-up,
and in a fresh checkout the kernels' build."""


def read(rec):
    return rec.setup_s
