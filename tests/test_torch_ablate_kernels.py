"""tools/ablate_kernels.py against the kernels it ablates, on the CPU.

Each variant of the tool is a copy of a shipped source (csrc/
attention_short.cu, attention_long.cu, attention_f32.cu) with text edits
that remove or replace one step. The tool builds them on the card and stops
there when an edit's text is not in its source exactly once; this test holds
every edit to that here, so that a change to a kernel that moves an edit's
text fails where the change is made. It needs neither a card nor triton."""

import pytest

from pope_tpu_torch.tools.ablate_kernels import SOURCES, VARIANTS, variant_source

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
