"""Share of the traced stretch in which the device ran nothing while the
host was in the program's text → ids sweep (``iris.frontend``)."""

from perfbench import progtrace


def read(ctx):
    return progtrace.idle_pct(ctx, "frontend")
