"""Share of the traced stretch in which the device ran nothing while the
host was in a collect (``iris.collect``: the copy to the host and the
trim)."""

from perfbench import progtrace


def read(ctx):
    return progtrace.idle_pct(ctx, "collect")
