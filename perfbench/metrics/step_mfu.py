"""step_mfu: the model FLOPs of the traced steps (the MLPs' products
and the interaction's dots, x3 for a train step) over the stretch's
wall time and the peak of the math mode the step's products run in
(989 TFLOP/s bf16, 67 f32 with TF32 off, 495 with it on), %."""


def read(ctx):
    st = getattr(ctx, "stretch", None)
    if st is None or st.window_s <= 0 or st.steps <= 0:
        return None
    return 100.0 * ctx.step_flops * st.steps / (st.window_s * ctx.peak_flops)
