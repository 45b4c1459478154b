"""Share of the traced window in which the card was idle while the host
was inside a request's ``collect`` span, in percent (as
card.idle_in_dispatch_share, for the ``collect`` roots)."""

from benchmark import spans


def read(ctx):
    return spans.idle_share_in(ctx, "collect")
