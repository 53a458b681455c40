"""tools/ablate_kernels.py against the kernels it ablates, on the CPU.

Each variant of the tool is a copy of a shipped source (csrc/
attention_short.cu, attention_long.cu, attention_f32.cu) with text edits
that remove or replace one step. The tool builds them on the card and stops
there when an edit's text is not in its source exactly once; this test holds
every edit to that here, so that a change to a kernel that moves an edit's
text fails where the change is made. It needs neither a card nor triton."""

import pytest

from pope_tpu_torch.tools.ablate_kernels import SOURCES, VARIANTS, takes_plan, variant_source

CASES = [(kernel, name) for kernel, variants in VARIANTS.items() for name in variants]


@pytest.mark.parametrize("kernel,variant", CASES, ids=[f"{kernel}-{name}" for kernel, name in CASES])
def test_every_edit_is_in_its_source_once(kernel, variant):
    src = SOURCES[kernel].read_text()
    edits = VARIANTS[kernel][variant]
    for old, new in edits:
        assert src.count(old) == 1, f"{kernel}/{variant}: {src.count(old)} copies of {old[:70]!r}"
        assert old != new
    text = variant_source(kernel, variant)
    assert (text == src) == (not edits)


def test_gathered_variants_route_to_the_per_logit_gather():
    """"gathered" puts every biased grid but wk = 64 back on the per-logit
    gather with (kh, kw) divided out a logit, as the body was before key
    rows were padded to 64 slots; "gather_bias" gathers every biased grid,
    walking (kh, kw)."""
    gathered = variant_source("long", "gathered")
    assert "  if (a.wk != 64) return launch_long_bias<GATHER>" in gathered
    assert "int kh = key / wk, kw = key - kh * wk" in gathered
    assert "dkh = 8 / wk" not in gathered and "kh += dkh" not in gathered
    walked = variant_source("long", "gather_bias")
    assert "  if (true) return launch_long_bias<GATHER>" in walked and "kh += dkh, kw += dkw;" in walked


@pytest.mark.parametrize("kernel", sorted(SOURCES))
def test_takes_plan_tells_the_shipped_entries_from_earlier_ones(kernel):
    """The shipped short and long kernels' C entries take the last wave's
    plan (split0, pieces) after the scale, and the tool passes it to them;
    an earlier source (--against) without it gets the old arguments, and the
    f32 kernel never takes one."""
    src = SOURCES[kernel].read_text()
    assert takes_plan(kernel, src) == (kernel != "f32")
    earlier = src.replace("float scale, int split0, int pieces,", "float scale,")
    assert not takes_plan(kernel, earlier)
