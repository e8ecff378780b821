"""feed_stall_ms: the time the trainer blocked in the device feed's
`next()` (`MeteredFeed.counters()` `stall_s`) over the window, ms a
step."""


def read(ctx):
    feed = getattr(ctx, "feed", None)
    if not feed or feed["steps"] <= 0:
        return None
    return feed["stall_s"] / feed["steps"] * 1e3
