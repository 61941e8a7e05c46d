"""Share of the traced stretch in which the device ran nothing while the
host was inside a bulk job (``iris.job``) but in neither its frontend nor a
collect: encoding, stage A, the read of stage A's totals, stage B's
launches and the glue between them."""

from perfbench import progtrace


def read(ctx):
    return progtrace.idle_pct(ctx, "dispatch")
