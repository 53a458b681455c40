"""Released-checkpoint key/shape manifests + strict state-dict validation (a
copy of pope_tpu/utils/state_manifest.py, which the port does not import;
the manifests are the port's own copies under pope_tpu_torch/models/).

The three released checkpoints the reference pipeline consumes are
  - sam_vit_{b,l,h}_*.pth        (build_sam.py:102-105, plain state dict)
  - dinov2_vits14_pretrain.pth   (dinov2/utils/utils.py:21, flat vit keys
                                  after 'module.'/'backbone.' stripping)
  - matcher.pth                  (pope_model_api.py:177-180: PL ckpt
                                  'state_dict' with 'matcher.'-prefixed keys)

A silent key/shape mismatch gives garbage accuracy, so the manifests pin the
EXACT key->shape inventory of each file (generated from the reference torch
module definitions); `check_state_dict` fails loudly, naming every missing
key, unknown key, and shape mismatch, BEFORE conversion runs.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Sequence, Tuple

_MODELS_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "models")

MANIFESTS = {
    "sam_vit_b": os.path.join(_MODELS_DIR, "sam", "manifest_vit_b.json"),
    "sam_vit_l": os.path.join(_MODELS_DIR, "sam", "manifest_vit_l.json"),
    "sam_vit_h": os.path.join(_MODELS_DIR, "sam", "manifest_vit_h.json"),
    "dinov2_vits14": os.path.join(_MODELS_DIR, "dinov2", "manifest_vits14.json"),
    "matcher": os.path.join(_MODELS_DIR, "matcher", "manifest_matcher.json"),
}

# keys that may legitimately appear in a real file beyond the module's
# state_dict (the reference loads the matcher with strict=False, so the
# OT-variant dustbin param rides along in indoor_ot-derived checkpoints)
KNOWN_OPTIONAL = {
    "matcher": ("matcher.coarse_matching.bin_score",),
    "dinov2_vits14": (),
    "sam_vit_b": (),
    "sam_vit_l": (),
    "sam_vit_h": (),
}


def load_state_manifest(name: str) -> Dict[str, Tuple[int, ...]]:
    with open(MANIFESTS[name]) as f:
        return {k: tuple(v) for k, v in json.load(f).items()}


class StateDictMismatch(RuntimeError):
    pass


def check_state_dict(
    sd: Mapping,
    name: str,
    extra_optional: Sequence[str] = (),
    max_report: int = 12,
) -> None:
    """Validate `sd` (a {key: array} dict in the RAW released-file layout,
    before any prefix normalization) against the stored manifest.

    Raises StateDictMismatch listing missing keys, unknown keys, and shape
    mismatches; returns None when the inventory matches exactly (modulo
    KNOWN_OPTIONAL extras).
    """
    manifest = load_state_manifest(name)
    # optional keys may be absent (stripped eval checkpoints) or extra
    # (strict=False riders) without failing the inventory
    optional = set(KNOWN_OPTIONAL.get(name, ())) | set(extra_optional)
    missing = sorted(k for k in manifest if k not in sd and k not in optional)
    unknown = sorted(k for k in sd if k not in manifest and k not in optional)
    bad_shape = sorted(
        f"{k}: file {tuple(getattr(sd[k], 'shape', ()))} != expected {manifest[k]}"
        for k in manifest
        if k in sd and tuple(getattr(sd[k], "shape", ())) != manifest[k]
    )
    if not (missing or unknown or bad_shape):
        return

    def _fmt(label, items):
        if not items:
            return ""
        shown = ", ".join(items[:max_report])
        more = f" (+{len(items) - max_report} more)" if len(items) > max_report else ""
        return f"\n  {label} ({len(items)}): {shown}{more}"

    raise StateDictMismatch(
        f"checkpoint does not match the released '{name}' layout:"
        + _fmt("missing keys", missing)
        + _fmt("unknown keys", unknown)
        + _fmt("shape mismatches", bad_shape)
    )


def synthesize_state_dict(name: str) -> Dict:
    """Zero-filled state dict with exactly the manifest's inventory (lazily
    mapped pages - cheap even at vit_h scale). Test/validation helper."""
    import numpy as np

    return {
        k: np.zeros(shape, np.float32)
        for k, shape in load_state_manifest(name).items()
    }
