"""device_idle_frac: the share of the traced stretch with no kernel,
copy or fill on the device."""


def read(ctx):
    st = getattr(ctx, "stretch", None)
    if st is None or st.window_s <= 0:
        return None
    return 1.0 - st.busy_s / st.window_s
