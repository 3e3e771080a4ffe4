"""mfu.train: the train steps' model FLOPs (``counts.train_step_flops``)
over the traced slice's wall time, as a share (%) of the card's dense
bf16 peak."""


def read(r):
    t = r.get("trace")
    if t is None or not r.get("slice_steps"):
        return None
    flops = r["step_flops"] * r["slice_steps"]
    return 100.0 * flops / (t.window_s * r["peak_flops_per_s"])
