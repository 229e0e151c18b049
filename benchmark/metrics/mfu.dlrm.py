"""mfu.dlrm: the matrix-product FLOPs of the window's DLRM steps
(``costs.dlrm_example_flops``), over the window's wall time, as a share
of the card's peak in the precision the step's products ran in: float32
(67 TFLOP/s on an H100), or TF32 (495) where it was enabled; in
percent."""

from benchmark.reference import costs


def read(rec):
    peak = costs.peaks(rec["device_kind"])
    if rec["driver"] != "dlrm" or peak is None:
        return None
    rate = rec["examples"] * rec["example_flops"] / rec["window_s"]
    return 100.0 * rate / peak["tf32" if rec["tf32"] else "f32"]
