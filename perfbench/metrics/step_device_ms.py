"""step_device_ms: the union of every kernel, copy and fill's device
intervals in the traced stretch, ms a step."""


def read(ctx):
    st = getattr(ctx, "stretch", None)
    if st is None or st.steps <= 0 or st.busy_s <= 0:
        return None
    return st.busy_s / st.steps * 1e3
