"""Share of the roofline bound (counts/attention.py) in the device time of the
kernels launched inside the calls into the three attention entries, in %:
the sum of every call's bound over that time."""


def read(t):
    device_s = t.span_device_s.get("attention", 0.0)
    return 100.0 * t.attention_bound_s / device_s if device_s > 0 and t.attention_bound_s > 0 else None
