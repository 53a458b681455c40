"""Device ms a batch of the kernels launched inside generate_batch's device
program (AutomaticMaskGenerator._amg_full: encode, full-resolution decode,
filters, NMS, cut)."""


def read(t):
    v = t.span_device_s.get("amg_program", 0.0)
    return 1e3 * v / t.units if t.units > 0 and v > 0 and t.span_calls.get("amg_program") else None
