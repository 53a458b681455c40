"""Host wall ms a batch from the end of generate_batch's device program
(_amg_full's return) to generate_batch's return: the download and each
image's small-region cleanup."""


def read(t):
    v = t.span_end_gap_s.get(("generate_batch", "amg_program"), 0.0)
    return 1e3 * v / t.units if t.units > 0 and v > 0 and t.span_calls.get("generate_batch") else None
