"""Host time in the pipeline instance's text → ids calls over the whole
window, per utterance (the harness wraps ``_text_to_ids_cached`` on that
instance only)."""


def read(ctx):
    spans = ctx.record["spans"]
    if spans is None or not spans.calls.get("frontend"):
        return None
    return 1e3 * spans.host_s["frontend"] / ctx.record["attempted"]
