"""Host wall ms a batch inside ops.nms.nms as models/sam/amg.py calls it (its
loop runs once per valid candidate)."""


def read(t):
    v = t.span_host_s.get("nms", 0.0)
    return 1e3 * v / t.units if t.units > 0 and v > 0 and t.span_calls.get("nms") else None
