"""slab_roofline_pct.cycle: the least time of the partial factorizations
that the slab kernels ran in the traced window, over the device time of
the kernels named in KERNELS (%). Each factorization of the window runs
every kernel-routed level once; a level's [B, F, W] (from the solver's plan,
`harness.routed_slabs`) is bounded by `yardstick.slab_bound_seconds` at the
configuration's rung. Moves cycle_ms."""

from cholbench import yardstick

# the kernels behind the solver's factor_slab: per 128-wide panel the
# diagonal tile's update (or its plain copy), chol_inv, the panel's pass
KERNELS = ("slab_diag_kernel", "slab_diag_copy_kernel", "chol_inv_kernel",
           "slab_panel_kernel")


def read(rec):
    p = rec.profile
    factorizations = sum("factor" in r["spans"] for r in rec.requests)
    if p is None or not rec.slab_levels or not factorizations:
        return None
    device_s = sum(s for name, s in p["kernel_s_by_name"].items()
                   if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    bound = factorizations * sum(
        yardstick.slab_bound_seconds(B, F, W, rec.rung)
        for B, F, W in rec.slab_levels)
    return 100.0 * bound / device_s
