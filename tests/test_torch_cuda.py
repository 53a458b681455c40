"""The port on the card: the CUDA kernels against their plain versions, and a
small SAM, a small DINOv2, a small matcher, the solver, SSL train steps and
a NeRF on the card against the same modules on the CPU. Needs an NVIDIA
GPU (marked `cuda`; skipped without one). Imports neither JAX nor pope_tpu,
so it also runs where only the port's dependencies are installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import copy

import numpy as np
import pytest
import torch

from pope_tpu_torch.config import (
    BackboneConfig,
    CoarseMatchConfig,
    DinoV2Config,
    LoFTRStageConfig,
    MatcherConfig,
    SamConfig,
    SamEncoderConfig,
)
from pope_tpu_torch.models.dinov2 import DinoVisionTransformer
from pope_tpu_torch.models.matcher import Matcher
from pope_tpu_torch.models.sam import Sam
from pope_tpu_torch.ops.cuda_kernels import attention_design, launch_attention, launch_attention_relpos
from pope_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
    flash_attention_relpos,
    flash_attention_relpos_plain,
)
from pope_tpu_torch.ops.window_attention import (
    windowed_attention_relpos,
    windowed_attention_relpos_plain,
)
from pope_tpu_torch.pipeline.api import init_dinov2_weights, init_matcher_weights, init_sam_weights
from pope_tpu_torch.solver import draw_gumbel, estimate_pose_ransac
from pope_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.cuda

# f32: the same math in another summation order (max abs error; outputs are
# softmax averages of v ~ N(0, 1), max |out| about 1 at these shapes). bf16,
# scaled to the output: the max error within a few bf16 ulps of the largest
# output (the windowed kernel rounds its softmax weights before normalising,
# the plain version after), the rms error within 1% of the rms output
TOL_F32 = 2e-5
TOL_BF16_MAX_REL, TOL_BF16_RMS_REL = 2.5e-2, 1e-2


def assert_matches_plain(out, ref):
    diff = out.float() - ref.float()
    if out.dtype == torch.float32:
        assert diff.abs().max().item() < TOL_F32
        return
    ref = ref.float()
    assert diff.abs().max().item() <= TOL_BF16_MAX_REL * ref.abs().max().item()
    assert diff.square().mean().sqrt().item() <= TOL_BF16_RMS_REL * ref.square().mean().sqrt().item()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return resolve_device("cuda")  # also turns TF32 off, as the entry points do


_RELPOS_CASES = [  # (BW, nh, d, hk, wk), both dtypes; then float32 alone
    *((dt, *shape) for shape in [(3, 4, 80, 14, 14), (2, 2, 80, 12, 16), (2, 3, 32, 5, 7)]
      for dt in (torch.float32, torch.bfloat16)),
    (torch.float32, 1, 2, 80, 48, 64),  # SAM ViT-H's global grid
    (torch.float32, 2, 3, 20, 5, 7),  # head dims the f32 kernel pads
    (torch.float32, 2, 2, 48, 14, 14),
    (torch.float32, 2, 3, 30, 5, 7),  # rows not in whole 16-byte chunks: 4-byte loads
    (torch.float32, 2, 2, 78, 14, 14),
    (torch.float32, 2, 1, 126, 5, 7),
    (torch.float32, 1, 1, 80, 33, 37),  # 128-query blocks, a ragged last one
    (torch.float32, 1, 1, 128, 1, 473),  # the widest grid the f32 kernel stages at its widest head dim
]


@pytest.mark.parametrize(
    "dtype,BW,nh,d,hk,wk", _RELPOS_CASES,
    ids=[f"{BW}-{nh}-{d}-{hk}-{wk}-{'f32' if dt == torch.float32 else 'bf16'}"
         for dt, BW, nh, d, hk, wk in _RELPOS_CASES],
)
def test_kernels_match_plain(card, dtype, BW, nh, d, hk, wk):
    """Both rel-pos wrappers, one launch each through the design the shape
    picks: float32 always through tf32x3 (csrc/attention_f32.cu)."""
    g = torch.Generator(device=card).manual_seed(0)
    N = hk * wk
    qkv = torch.randn(BW, N, 3 * nh * d, device=card, generator=g).to(dtype)
    rel_h = (0.5 * torch.randn(BW, nh, N, hk, device=card, generator=g)).to(dtype)
    rel_w = (0.5 * torch.randn(BW, nh, N, wk, device=card, generator=g)).to(dtype)
    design = attention_design(dtype, N, d, hk, wk)
    assert design == "tf32x3" or dtype == torch.bfloat16
    before = dict(windowed_attention_relpos.launches_by_design)
    out = windowed_attention_relpos(qkv, rel_h, rel_w, nh, d, hk, wk)
    assert_matches_plain(out, windowed_attention_relpos_plain(qkv, rel_h, rel_w, nh, d, hk, wk))
    assert_one_launch_of(windowed_attention_relpos, before, design)
    q, k, v = qkv.view(BW, N, 3, nh, d).unbind(2)
    before = dict(flash_attention_relpos.launches_by_design)
    out = flash_attention_relpos(q, k, v, rel_h, rel_w, hk, wk)
    assert_matches_plain(out, flash_attention_relpos_plain(q, k, v, rel_h, rel_w, hk, wk))
    assert_one_launch_of(flash_attention_relpos, before, design)


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    before = windowed_attention_relpos.launches
    qkv = torch.zeros(2, 16, 3 * 2 * 8, device=card, dtype=torch.float16)
    rel = torch.zeros(2, 2, 16, 4, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        windowed_attention_relpos(qkv, rel, rel, 2, 8, 4, 4)
    # the bf16 tensor-core body takes the head dims it is instantiated for
    with pytest.raises(ValueError, match="head dim must be one of"):
        windowed_attention_relpos(qkv.bfloat16(), rel.bfloat16(), rel.bfloat16(), 2, 8, 4, 4)
    assert windowed_attention_relpos.launches == before


def test_small_sam_on_card_matches_cpu(card):
    cfg = SamConfig(
        encoder=SamEncoderConfig(
            img_size=128, embed_dim=64, depth=2, num_heads=2, window_size=5,
            global_attn_indexes=(1,), out_chans=32, dtype="float32", gelu="erf",
        ),
        prompt_embed_dim=32, image_embedding_size=8, decoder_num_heads=2,
        decoder_mlp_dim=64, iou_head_hidden_dim=32, decoder_dtype="float32",
    )
    cpu = Sam(cfg)
    init_sam_weights(cpu, torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(card)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(-2, 2, (2, 96, 128, 3)).astype(np.float32))
    pts = torch.from_numpy(rng.uniform(0, 128, (8, 2, 2)).astype(np.float32))
    labels = torch.tensor([[1, -1]]).expand(8, 2)
    with torch.no_grad():
        emb = cpu.encode_image(x)
        torch.testing.assert_close(gpu.encode_image(x.to(card)).cpu(), emb, atol=1e-4, rtol=0)
        for sub in (1, 4):
            masks, iou = cpu.decode(emb[:1], pts, labels, subsample=sub)
            m, i = gpu.decode(emb[:1].to(card), pts.to(card), labels.to(card), subsample=sub)
            torch.testing.assert_close(m.cpu(), masks, atol=1e-4, rtol=0)
            torch.testing.assert_close(i.cpu(), iou, atol=1e-4, rtol=0)


@pytest.mark.parametrize(
    "dtype,B,N,nh,d",
    [(torch.bfloat16, 260, 197, 6, 64), (torch.float32, 4, 197, 6, 64), (torch.bfloat16, 3, 50, 2, 32),
     (torch.float32, 16, 257, 6, 64), (torch.float32, 64, 50, 6, 64), (torch.float32, 2, 37, 3, 20),
     (torch.float32, 2, 70, 2, 48), (torch.float32, 2, 37, 3, 30), (torch.float32, 2, 37, 2, 78),
     (torch.float32, 2, 37, 2, 126), (torch.float32, 1, 1100, 2, 80)],
    ids=["bf16-retrieval", "f32", "bf16-small", "f32-ssl-global", "f32-ssl-local", "f32-d20", "f32-d48",
         "f32-d30", "f32-d78", "f32-d126", "f32-n1100-d80"],
)
def test_flash_attention_matches_plain(card, dtype, B, N, nh, d):
    """Bias-free attention on (B, N, nh, d) views of a (B, N, 3, nh, d) qkv
    tensor, as DINOv2 hands them over; first row: the retrieval forward's
    shape (4 pairs x 65 crops, 197 tokens, 6 heads of 64); the SSL step's
    two f32 shapes (16 global crops of 257 tokens, 64 local ones of 50).
    float32 runs the tf32x3 kernel (csrc/attention_f32.cu): head dims not
    in whole 16-byte chunks through its 4-byte loads (d 30, 78, 126), 1100
    tokens at d 80 through its 128-query blocks."""
    g = torch.Generator(device=card).manual_seed(1)
    qkv = torch.randn(B, N, 3, nh, d, device=card, generator=g).to(dtype)
    q, k, v = qkv.unbind(2)
    design = attention_design(dtype, N, d)
    assert design == "tf32x3" or dtype == torch.bfloat16
    before = dict(flash_attention.launches_by_design)
    out = flash_attention(q, k, v)
    assert out.shape == (B, N, nh * d) and out.dtype == dtype
    assert_matches_plain(out, flash_attention_plain(q, k, v))
    assert_one_launch_of(flash_attention, before, design)


def test_tf32x3_kernel_raises_on_what_it_does_not_take(card):
    """Asked for the tf32x3 kernel, bf16 operands and f32 head dims past 128
    raise. Nothing launches, nothing falls back to the streaming kernel or
    the plain version."""
    counters = (flash_attention, flash_attention_relpos, windowed_attention_relpos)
    before = [dict(f.launches_by_design) for f in counters]
    qkv = torch.randn(2, 50, 3, 2, 64, device=card)
    q, k, v = qkv.unbind(2)
    with pytest.raises(ValueError, match="tf32x3 kernel does not take"):
        launch_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), "tf32x3")
    wide = torch.randn(2, 50, 3, 2, 160, device=card)
    with pytest.raises(ValueError, match="head dim 160 > 128"):
        launch_attention(*wide.unbind(2), "tf32x3")
    with pytest.raises(ValueError, match="head dim 160 > 128"):
        flash_attention(*wide.unbind(2))
    assert [dict(f.launches_by_design) for f in counters] == before


def test_tf32x3_reads_rows_not_on_16_bytes(card):
    """float32 views whose rows do not start on 16 bytes (one element into a
    buffer; rows of 776 bytes) go through the tf32x3 kernel's 4-byte loads,
    one launch each, and match the plain versions."""
    g = torch.Generator(device=card).manual_seed(3)
    flat = torch.randn(2 * 49 * 3 * 2 * 64 + 1, device=card, generator=g)
    q, k, v = flat[1:].view(2, 49, 3, 2, 64).unbind(2)  # 4 bytes past 16
    before = dict(flash_attention.launches_by_design)
    assert_matches_plain(flash_attention(q, k, v), flash_attention_plain(q, k, v))
    assert_one_launch_of(flash_attention, before, "tf32x3")
    rel_h, rel_w = (0.5 * torch.randn(2, 2, 49, 7, device=card, generator=g) for _ in range(2))
    before = dict(flash_attention_relpos.launches_by_design)
    out = flash_attention_relpos(q, k, v, rel_h, rel_w, 7, 7)
    assert_matches_plain(out, flash_attention_relpos_plain(q, k, v, rel_h, rel_w, 7, 7))
    assert_one_launch_of(flash_attention_relpos, before, "tf32x3")
    qkv = flat[1:].view(2, 49, 3 * 2 * 64)
    before = dict(windowed_attention_relpos.launches_by_design)
    out = windowed_attention_relpos(qkv, rel_h, rel_w, 2, 64, 7, 7)
    assert_matches_plain(out, windowed_attention_relpos_plain(qkv, rel_h, rel_w, 2, 64, 7, 7))
    assert_one_launch_of(windowed_attention_relpos, before, "tf32x3")
    wide = torch.randn(2, 16, 3 * 2 * 32 + 2, device=card, generator=g)  # every other row off 16 bytes
    q, k, v = (wide.as_strided((2, 16, 2, 32), wide.stride()[:2] + (32, 1), i * 64) for i in range(3))
    before = dict(flash_attention.launches_by_design)
    assert_matches_plain(flash_attention(q, k, v), flash_attention_plain(q, k, v))
    assert_one_launch_of(flash_attention, before, "tf32x3")


def test_f32_max_grid_is_the_launchers_fit(card):
    """F32_MAX_GRID is what csrc/attention_f32.cu's launcher stages at its
    widest head dim (128): a 1 x 473 grid launches tf32x3 there and matches
    the plain version, and the launcher itself takes hk + wk = 474 and
    refuses 475 (cudaErrorInvalidValue), so routing and launcher cannot
    drift apart. Past it (at d 64) the streaming kernel runs, one launch, a
    match."""
    from pope_tpu_torch.ops.cuda_kernels import F32_MAX_GRID, _views, library

    g = torch.Generator(device=card).manual_seed(4)
    for d, wk, design in ((128, F32_MAX_GRID - 1, "tf32x3"), (64, F32_MAX_GRID, "stream")):
        q, k, v = torch.randn(1, wk, 3, 1, d, device=card, generator=g).unbind(2)
        rel_h, rel_w = (0.5 * torch.randn(1, 1, wk, n, device=card, generator=g) for n in (1, wk))
        assert attention_design(torch.float32, wk, d, 1, wk) == design
        before = dict(flash_attention_relpos.launches_by_design)
        out = flash_attention_relpos(q, k, v, rel_h, rel_w, 1, wk)
        assert_matches_plain(out, flash_attention_relpos_plain(q, k, v, rel_h, rel_w, 1, wk))
        assert_one_launch_of(flash_attention_relpos, before, design)
    q, k, v = torch.randn(1, F32_MAX_GRID, 3, 1, 128, device=card, generator=g).unbind(2)
    out = torch.empty(1, F32_MAX_GRID, 128, device=card)
    ptrs, strides = _views(q, k, v)
    stream = torch.cuda.current_stream(card).cuda_stream
    for wk, want in ((F32_MAX_GRID - 1, 0), (F32_MAX_GRID, 1)):  # cudaSuccess, cudaErrorInvalidValue
        rel_h, rel_w = torch.zeros(1, 1, wk, 1, device=card), torch.zeros(1, 1, wk, wk, device=card)
        err = library().pope_attention_f32_relpos(*ptrs, rel_h.data_ptr(), rel_w.data_ptr(), out.data_ptr(),
                                                  *strides, 1, wk, 1, 128, 1, wk, 128 ** -0.5, stream)
        torch.cuda.synchronize()
        assert err == want


# (N, hk, wk): one key below, at and one above a K / V tile of 64 keys
# (d_pad 32 and 64; 32 at d_pad 80) and of two, the last query tile of 64
# holding one row at 65 and 129
_TILE_EDGES = [(63, 7, 9), (64, 8, 8), (65, 5, 13), (127, 1, 127), (128, 8, 16), (129, 3, 43)]


@pytest.mark.parametrize("d", [64, 80, 32, 30, 78, 126])
@pytest.mark.parametrize("N,hk,wk", _TILE_EDGES, ids=[str(n) for n, _, _ in _TILE_EDGES])
def test_tf32x3_at_key_tile_edges(card, N, hk, wk, d):
    """The tf32x3 kernel at the edges of its key tiles (64 keys; 32 at d 80
    in 64-query blocks), without the bias and on an hk x wk grid, on the
    16-byte path and (d 30, 78, 126: rows not in whole 16-byte chunks) the
    4-byte one: one launch each, a match."""
    g = torch.Generator(device=card).manual_seed(N + d)
    q, k, v = torch.randn(2, N, 3, 2, d, device=card, generator=g).unbind(2)
    before = dict(flash_attention.launches_by_design)
    assert_matches_plain(flash_attention(q, k, v), flash_attention_plain(q, k, v))
    assert_one_launch_of(flash_attention, before, "tf32x3")
    rel_h, rel_w = (0.5 * torch.randn(2, 2, N, n, device=card, generator=g) for n in (hk, wk))
    before = dict(flash_attention_relpos.launches_by_design)
    out = flash_attention_relpos(q, k, v, rel_h, rel_w, hk, wk)
    assert_matches_plain(out, flash_attention_relpos_plain(q, k, v, rel_h, rel_w, hk, wk))
    assert_one_launch_of(flash_attention_relpos, before, "tf32x3")


@pytest.mark.parametrize("N,d", [(64, 64), (96, 80), (200, 32), (100, 128)])
def test_tf32x3_far_from_symmetric_weights(card, N, d):
    """Query n attends to key (5 n + 3) mod N almost alone (q_n a multiple of
    that key), a map with no symmetry, and v's rows are far apart: a
    fragment that put a logit in another key's or row's slot of P, or a
    key of V^T in another slot, moves the output by O(1)."""
    g = torch.Generator(device=card).manual_seed(7)
    k = torch.randn(1, N, 1, d, device=card, generator=g)
    target = (5 * torch.arange(N, device=card) + 3) % N
    q = 12.0 * k[:, target] * d ** -0.5 + 0.1 * torch.randn(1, N, 1, d, device=card, generator=g)
    v = torch.randn(1, N, 1, d, device=card, generator=g)
    before = dict(flash_attention.launches_by_design)
    out = flash_attention(q, k, v)
    assert_one_launch_of(flash_attention, before, "tf32x3")
    ref = flash_attention_plain(q, k, v)
    assert (ref - v[:, target].reshape(1, N, d)).abs().amax(-1).median() < 0.1  # the weights are concentrated
    assert_matches_plain(out, ref)


def test_flash_attention_wrapper_rejects_what_the_kernel_does_not_take(card):
    before = flash_attention.launches
    qkv = torch.zeros(2, 20, 3, 2, 64, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(*qkv.unbind(2))
    # a head dim the bf16 body has no instantiation for
    odd = torch.zeros(2, 20, 3, 2, 48, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim must be one of"):
        flash_attention(*odd.unbind(2))
    # rows that do not start on 16 bytes (a view one element in)
    flat = torch.zeros(2 * 20 * 3 * 2 * 64 + 1, device=card, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 20, 3, 2, 64)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention(*shifted.unbind(2))
    assert flash_attention.launches == before


def assert_one_launch_of(wrapper, before, design):
    """`wrapper` launched once since `before` (its launches_by_design), through `design`."""
    after = wrapper.launches_by_design
    assert {k: after[k] - before[k] for k in after} == {k: int(k == design) for k in after}


@pytest.mark.parametrize("d", [32, 64, 80])
@pytest.mark.parametrize("N", [1, 15, 16, 17, 64, 65, 196, 197, 200, 256, 257])
@pytest.mark.parametrize("B,nh", [(2, 3), (70, 3)], ids=["6-heads", "210-heads"])
def test_flash_attention_designs_by_shape(card, B, nh, N, d):
    """Bias-free bf16 attention on views of a (B, N, 3, nh, d) qkv tensor
    across the short kernel's limits (one pass up to N = 200, two to 256) and
    its ragged tails, with fewer and more heads than the card has SMs (the
    persistent loop): the short kernel up to N = 256, the long one above."""
    g = torch.Generator(device=card).manual_seed(N * 100 + d)
    qkv = torch.randn(B, N, 3, nh, d, device=card, generator=g).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    before = dict(flash_attention.launches_by_design)
    out = flash_attention(q, k, v)
    assert_matches_plain(out, flash_attention_plain(q, k, v))
    assert_one_launch_of(flash_attention, before, "short" if N <= 256 else "long")


@pytest.mark.parametrize("d", [32, 64, 80])
@pytest.mark.parametrize("hk,wk", [(14, 14), (5, 7), (12, 16), (16, 16), (8, 40)])
@pytest.mark.parametrize("BW,nh", [(2, 3), (50, 4)], ids=["6-heads", "200-heads"])
def test_relpos_designs_by_shape(card, BW, nh, hk, wk, d):
    """The rel-pos wrappers in bf16 on windows of hk x wk: the windowed one
    on its qkv layout, the global one on views of it. Grids of N <= 256 with
    hk + wk <= 32 take the short kernel (16x16 in two passes); 8x40 (N =
    320) the long one."""
    g = torch.Generator(device=card).manual_seed(hk * 1000 + wk * 10 + d)
    N = hk * wk
    qkv = torch.randn(BW, N, 3 * nh * d, device=card, generator=g).to(torch.bfloat16)
    rel_h = (0.5 * torch.randn(BW, nh, N, hk, device=card, generator=g)).to(torch.bfloat16)
    rel_w = (0.5 * torch.randn(BW, nh, N, wk, device=card, generator=g)).to(torch.bfloat16)
    design = "short" if N <= 256 else "long"
    before = dict(windowed_attention_relpos.launches_by_design)
    out = windowed_attention_relpos(qkv, rel_h, rel_w, nh, d, hk, wk)
    assert_matches_plain(out, windowed_attention_relpos_plain(qkv, rel_h, rel_w, nh, d, hk, wk))
    assert_one_launch_of(windowed_attention_relpos, before, design)
    q, k, v = qkv.view(BW, N, 3, nh, d).unbind(2)
    before = dict(flash_attention_relpos.launches_by_design)
    out = flash_attention_relpos(q, k, v, rel_h, rel_w, hk, wk)
    assert_matches_plain(out, flash_attention_relpos_plain(q, k, v, rel_h, rel_w, hk, wk))
    assert_one_launch_of(flash_attention_relpos, before, design)


def test_short_kernel_raises_on_what_it_does_not_take(card):
    """Asked for the short kernel, a shape it does not take raises: nothing
    falls back to the streaming kernel or the plain version."""
    qkv = torch.zeros(2, 257, 3, 2, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="short kernel does not take"):
        launch_attention(*qkv.unbind(2), "short")
    with pytest.raises(ValueError, match="short kernel does not take"):
        launch_attention(*qkv[:, :196].float().unbind(2), "short")


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("d", [32, 64, 80])
@pytest.mark.parametrize(
    "hk,wk",
    [(1, 100), (1, 257), (100, 5), (40, 32), (9, 35), (7, 52), (8, 40), (3, 64), (8, 64), (20, 50), (25, 41),
     (20, 55), (40, 33), (45, 64), (48, 64), (64, 48), (63, 48), (64, 36), (64, 52)],
    ids=["100-1x100", "257", "500-100x5", "1280-40x32", "315-9x35", "364-7x52", "320-8x40", "192-3x64",
         "512-8x64", "1000-ragged", "1025-25x41", "1100-20x55", "1320-40x33", "2880-45x64", "3072-48x64",
         "3072-64x48", "3024-63x48", "2304-64x36", "3328-64x52"],
)
@pytest.mark.parametrize("B,nh", [(1, 1), (1, 3), (2, 70)], ids=["1-head", "3-heads", "140-heads"])
def test_long_kernel_matches_plain(card, B, nh, hk, wk, d, bias):
    """The long kernel (csrc/attention_long.cu) on views of a (B, N, 3, nh, d)
    qkv tensor, on grids the short kernel does not take: with the rel-pos
    bias on the grid (32 < wk <= 64: two whole key rows a K/V tile, each
    padded to a multiple of 8 slots (40, 48, 56 or 64), the bias from
    per-thread words; other grids
    gathered, 1 x 257 staged by plain copies, its rows not 16-byte
    multiples, 100 x 5 walking more than a key row a column block) and
    without it; ragged key and query tails at 100, 192, 257, 315, 320,
    364, 1000, 1025, 1100, 1320, 2880 and 3024 (an odd number of key rows
    at 192, 315, 364, 1025, 2880 and 3024: the last tile's second key row
    masked); fewer and more heads than the card has
    SMs, and one; portrait frames' 64 x 48 and 64 x 36 grids and a sweep
    crop's 64 x 52 (SAM's grids of wk < 64). The kernel's clusters pair two
    128-query items of a head and share their K/V tiles: 100 tokens are one
    item (its pair's second block has no queries), 257, 1025 and 1100 an odd
    number of items a head (3, 9, 9), so the last pair of every head has an
    empty half. Every launch goes through the long design and matches the
    plain version; without the bias, N <= 256 is asked of the long design,
    since the wrapper takes the short one there."""
    g = torch.Generator(device=card).manual_seed(hk * 1000 + wk * 10 + d)
    N = hk * wk
    qkv = torch.randn(B, N, 3, nh, d, device=card, generator=g).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    if bias:
        rel_h = (0.5 * torch.randn(B, nh, N, hk, device=card, generator=g)).to(torch.bfloat16)
        rel_w = (0.5 * torch.randn(B, nh, N, wk, device=card, generator=g)).to(torch.bfloat16)
        before = dict(flash_attention_relpos.launches_by_design)
        out = flash_attention_relpos(q, k, v, rel_h, rel_w, hk, wk)
        assert_matches_plain(out, flash_attention_relpos_plain(q, k, v, rel_h, rel_w, hk, wk))
        assert_one_launch_of(flash_attention_relpos, before, "long")
    elif N <= 256:
        assert_matches_plain(launch_attention(q, k, v, "long"), flash_attention_plain(q, k, v))
    else:
        before = dict(flash_attention.launches_by_design)
        out = flash_attention(q, k, v)
        assert_matches_plain(out, flash_attention_plain(q, k, v))
        assert_one_launch_of(flash_attention, before, "long")


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("hk,wk", [(1, 100), (25, 41), (48, 64), (64, 48)],
                         ids=["100-1x100", "1025-25x41", "3072-48x64", "3072-64x48"])
def test_long_kernel_on_head_major_views(card, hk, wk, d, bias):
    """The long kernel on q/k/v strided off the qkv layout: (B, N, nh, d)
    views of (3, B, nh, N, d), each head's rows one contiguous run (the TMA
    maps' token stride d, head stride N d), a single item, an odd number of
    items a head and SAM's landscape and portrait grids, with the bias and
    without it."""
    g = torch.Generator(device=card).manual_seed(hk * 7 + wk + d)
    B, nh, N = 2, 3, hk * wk
    q, k, v = torch.randn(3, B, nh, N, d, device=card, generator=g).to(torch.bfloat16).transpose(2, 3).unbind(0)
    assert q.stride() == (nh * N * d, d, N * d, 1)
    if bias:
        rel_h = (0.5 * torch.randn(B, nh, N, hk, device=card, generator=g)).to(torch.bfloat16)
        rel_w = (0.5 * torch.randn(B, nh, N, wk, device=card, generator=g)).to(torch.bfloat16)
        out = launch_attention_relpos(q, k, v, rel_h, rel_w, hk, wk, "long")
        assert_matches_plain(out, flash_attention_relpos_plain(q, k, v, rel_h, rel_w, hk, wk))
    else:
        assert_matches_plain(launch_attention(q, k, v, "long"), flash_attention_plain(q, k, v))


def test_long_bias_layout_by_grid(card):
    """Which bias layout attention_long.cu's launcher takes (long_layout asks
    the launcher's own rule): whole key rows, each padded to a multiple of 8
    slots, for every grid of 32 < wk <= 64 (SAM's landscape, square and crop
    grids at wk = 64, portrait frames' 48 and 36, their crops' 52; each of
    the four row widths 40, 48, 56 and 64, with even and odd hk), the
    per-logit gather below and
    above (1 x 100, 1 x 257, wk <= 32), none without the bias; at every
    head dim, so that routing and launcher cannot drift apart."""
    from pope_tpu_torch.ops.cuda_kernels import long_layout

    rows = {(48, 64): 64, (64, 64): 64, (52, 64): 64, (3, 64): 64, (64, 48): 48, (64, 52): 56, (64, 36): 40,
            (63, 48): 48, (40, 33): 40, (20, 55): 56, (25, 41): 48, (8, 40): 40, (9, 57): 64, (9, 35): 40}
    gather = [(1, 100), (1, 257), (40, 32), (100, 5), (2, 65)]
    for d in (32, 64, 80):
        assert long_layout(d)["bias"] is None
        for (hk, wk), slots in rows.items():
            layout = long_layout(d, hk, wk)
            assert (layout["bias"], layout["row_slots"]) == ("rows", slots), (d, hk, wk, layout)
        for hk, wk in gather:
            layout = long_layout(d, hk, wk)
            assert (layout["bias"], layout["row_slots"]) == ("gather", 0), (d, hk, wk, layout)
    assert [wk for wk in range(1, 101) if long_layout(80, 4, wk)["bias"] == "rows"] == list(range(33, 65))


def test_long_max_grid_is_the_launchers_fit(card):
    """LONG_MAX_GRID is what csrc/attention_long.cu's launcher stages at its
    widest head dim (80): a 1 x (LONG_MAX_GRID - 1) grid launches the long
    design there and matches the plain version, and the launcher itself
    takes hk + wk = LONG_MAX_GRID and refuses one more
    (cudaErrorInvalidValue, and long_layout raises), so routing and launcher
    cannot drift apart. Past it the streaming kernel runs, one launch, a
    match."""
    from pope_tpu_torch.ops.cuda_kernels import LONG_MAX_GRID, _views, library, long_layout

    g = torch.Generator(device=card).manual_seed(5)
    bf16 = torch.bfloat16
    for wk, design in ((LONG_MAX_GRID - 1, "long"), (LONG_MAX_GRID, "stream")):
        q, k, v = torch.randn(1, wk, 3, 1, 80, device=card, generator=g).to(bf16).unbind(2)
        rel_h, rel_w = ((0.5 * torch.randn(1, 1, wk, n, device=card, generator=g)).to(bf16) for n in (1, wk))
        assert attention_design(bf16, wk, 80, 1, wk) == design
        before = dict(flash_attention_relpos.launches_by_design)
        out = flash_attention_relpos(q, k, v, rel_h, rel_w, 1, wk)
        assert_matches_plain(out, flash_attention_relpos_plain(q, k, v, rel_h, rel_w, 1, wk))
        assert_one_launch_of(flash_attention_relpos, before, design)
    assert long_layout(80, 1, LONG_MAX_GRID - 1)["q_stages"] >= 1
    with pytest.raises(RuntimeError, match="pope_attention_long_layout"):
        long_layout(80, 1, LONG_MAX_GRID)
    stream = torch.cuda.current_stream(card).cuda_stream
    for wk, want in ((LONG_MAX_GRID - 1, 0), (LONG_MAX_GRID, 1)):  # cudaSuccess, cudaErrorInvalidValue
        q, k, v = torch.randn(1, wk, 3, 1, 80, device=card, generator=g).to(bf16).unbind(2)
        out = torch.empty(1, wk, 80, device=card, dtype=bf16)
        rel_h = torch.zeros(1, 1, wk, 1, device=card, dtype=bf16)
        rel_w = torch.zeros(1, 1, wk, wk, device=card, dtype=bf16)
        ptrs, strides = _views(q, k, v)
        err = library().pope_attention_long_relpos(*ptrs, rel_h.data_ptr(), rel_w.data_ptr(), out.data_ptr(),
                                                   *strides, 1, wk, 1, 80, 1, wk, 80 ** -0.5, 1, 1, None, None,
                                                   stream)
        torch.cuda.synchronize()
        assert err == want


def test_long_kernel_raises_on_what_it_does_not_take(card):
    """Asked for the long kernel, a shape it does not take raises: nothing
    falls back to the streaming kernel or the plain version."""
    qkv = torch.zeros(1, 600, 3, 2, 64, device=card, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    with pytest.raises(ValueError, match="long kernel does not take"):
        launch_attention(q.float(), k.float(), v.float(), "long")
    rel_h = torch.zeros(1, 2, 600, 1, device=card, dtype=torch.bfloat16)
    rel_w = torch.zeros(1, 2, 600, 600, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="long kernel does not take"):  # rel rows past its stages
        launch_attention_relpos(q, k, v, rel_h, rel_w, 1, 600, "long")
    odd = torch.zeros(1, 600, 3, 2, 48, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim must be one of"):
        launch_attention(*odd.unbind(2), "long")


def test_small_dinov2_and_matcher_on_card_match_cpu(card):
    """ViT-S width at 2 blocks and a 2-layer matcher, f32: the card's kernels
    and cuDNN against the CPU's plain versions."""
    cpu = DinoVisionTransformer(DinoV2Config(depth=2)).eval()
    init_dinov2_weights(cpu, torch.Generator().manual_seed(2))
    gpu = copy.deepcopy(cpu).to(card)
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (3, 196, 196, 3)).astype(np.float32))
    n = flash_attention.launches
    with torch.no_grad():
        ref, out = cpu(x), gpu(x.to(card))
    assert flash_attention.launches == n + 2
    for key in ref:
        torch.testing.assert_close(out[key].cpu(), ref[key], atol=1e-4, rtol=0)

    cfg = MatcherConfig(
        backbone=BackboneConfig(initial_dim=32, block_dims=(32, 48, 64)),
        coarse=LoFTRStageConfig(d_model=64, d_ffn=64, nhead=4, layer_names=("self", "cross")),
        fine=LoFTRStageConfig(d_model=32, d_ffn=32, nhead=4, layer_names=("self", "cross")),
        match_coarse=CoarseMatchConfig(match_capacity=128, thr=0.0, border_rm=0),
    )
    cpu_m = Matcher(cfg).eval()
    init_matcher_weights(cpu_m, torch.Generator().manual_seed(4))
    gpu_m = copy.deepcopy(cpu_m).to(card)
    rng = np.random.default_rng(5)
    img0 = torch.from_numpy(rng.uniform(0, 1, (1, 96, 128, 1)).astype(np.float32))
    img1 = img0[:, 16:80, 24:88].repeat(3, 1, 1, 1).contiguous()
    with torch.no_grad():
        ref, out = cpu_m(img0, img1, return_aux=True), gpu_m(img0.to(card), img1.to(card), return_aux=True)
    torch.testing.assert_close(out.conf_matrix.cpu(), ref.conf_matrix, atol=1e-5, rtol=1e-4)
    same = (out.i_ids.cpu() == ref.i_ids) & (out.j_ids.cpu() == ref.j_ids) & (out.valid.cpu() == ref.valid)
    assert same.float().mean() >= 0.99  # a near-tie may flip a slot
    both = same & ref.valid
    torch.testing.assert_close(out.mkpts1.cpu()[both], ref.mkpts1[both], atol=1e-3, rtol=0)


def test_solver_on_card_matches_cpu(card):
    """The same correspondences and Gumbel noise (drawn once on the CPU) on
    the card and on the CPU: the same pose and inliers."""
    rng = np.random.default_rng(6)
    n = 256
    X = rng.uniform(-1, 1, (n, 3)) + np.array([0, 0, 5.0])
    ang = np.deg2rad(20.0)
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    t = np.array([0.6, 0.1, 0.2]) / np.linalg.norm([0.6, 0.1, 0.2])
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    proj = lambda P: (P @ K.T)[:, :2] / (P @ K.T)[:, 2:]
    p0 = proj(X) + rng.normal(0, 0.5, (n, 2))
    p1 = proj(X @ R.T + t) + rng.normal(0, 0.5, (n, 2))
    p1[: n // 4] = rng.uniform([0, 0], [640, 480], (n // 4, 2))
    args = [torch.from_numpy(a.astype(np.float32)) for a in (p0, p1, K, K)] + [torch.ones(n, dtype=torch.bool)]
    noise = draw_gumbel((3, 2048, n), torch.Generator().manual_seed(7))
    ref = estimate_pose_ransac(*args, noise)
    out = estimate_pose_ransac(*(a.to(card) for a in args), noise.to(card))
    assert bool(ref.ok) and bool(out.ok)
    torch.testing.assert_close(out.R.cpu(), ref.R, atol=1e-3, rtol=0)
    torch.testing.assert_close(out.t.cpu(), ref.t, atol=1e-3, rtol=0)
    assert (out.inliers.cpu() != ref.inliers).sum() <= 2  # points on the threshold may flip


@torch.no_grad()
def _structure_decoder(sam):
    """tests/test_amg_oracle.py's decoder surgery on the port's module:
    identity upscaling, one-hot hypernetworks and a -0.5 bias, so the mask
    logits have O(0.3) structure and their binarization is not sign noise."""
    md = sam.mask_decoder
    for up in (md.up_conv1, md.up_conv2):
        n = min(up.kernel.shape[2:])
        up.kernel.zero_()
        up.kernel[:, :, torch.arange(n), torch.arange(n)] = 1.0
        up.bias.zero_()
    md.up_conv2.bias.fill_(-0.5)
    md.up_ln.weight.fill_(1.0)
    md.up_ln.bias.zero_()
    i = 0
    while hasattr(md, f"hyper_{i}"):
        lin = getattr(md, f"hyper_{i}").lin2
        lin.weight.zero_()
        lin.bias.zero_()
        lin.bias[(7 * i) % lin.bias.shape[0]] = 1.0
        i += 1


def _eval_dataset(root, n_pairs=4, h=96, w=128):
    """LINEMOD layout: each prompt a window of a blob-and-rectangle scene,
    its target a shifted, brightened window of the same scene."""
    import json
    import os

    import cv2

    from pope_tpu_torch.data.image_io import write_rgb

    rng = np.random.default_rng(0)
    base = os.path.join(root, "LM_dataset", "obj", "seq")
    for sub in ("color", "color_full", "intrin", "intrin_ba", "poses_ba"):
        os.makedirs(os.path.join(base, sub))
    yy, xx = np.mgrid[0 : h + 24, 0 : w + 24].astype(np.float32)
    pairs = []
    for i in range(n_pairs):
        img = np.full(yy.shape + (3,), 90.0, np.float32)
        for _ in range(40):
            cy, cx, s = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, 9)
            img += rng.uniform(-70, 70, 3) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))[..., None]
        for _ in range(4):
            y0, x0 = rng.integers(0, h - 40), rng.integers(0, w - 50)
            img[y0 : y0 + rng.integers(20, 40), x0 : x0 + rng.integers(25, 50)] += rng.uniform(-60, 60, 3)
        dy, dx = rng.integers(0, 24, 2)
        write_rgb(os.path.join(base, "color", f"{i}.png"), np.clip(img[:h, :w], 0, 255).astype(np.uint8))
        write_rgb(os.path.join(base, "color_full", f"{100 + i}.png"),
                  np.clip(img[dy : dy + h, dx : dx + w] * 1.1, 0, 255).astype(np.uint8))
        K = np.array([[100.0, 0, w / 2], [0, 100, h / 2], [0, 0, 1]])
        np.savetxt(os.path.join(base, "intrin_ba", f"{i}.txt"), K)
        np.savetxt(os.path.join(base, "intrin", f"{100 + i}.txt"), K)
        np.savetxt(os.path.join(base, "poses_ba", f"{i}.txt"), np.hstack([np.eye(3), [[0], [0], [0.6]]]))
        R1, _ = cv2.Rodrigues(rng.uniform(-0.2, 0.2, 3))
        np.savetxt(os.path.join(base, "poses_ba", f"{100 + i}.txt"), np.hstack([R1, [[0.03], [-0.01], [0.62]]]))
        pairs.append(f"obj/seq/color/{i}.png-{100 + i}.png")
    os.makedirs(os.path.join(root, "pairs"))
    with open(os.path.join(root, "pairs", "LINEMOD-test.json"), "w") as f:
        json.dump([{"0": pairs}], f)
    return root, os.path.join(root, "pairs")


def _small_eval_bundle(dev):
    """The eval tests' small f32 bundle on `dev`, from seeded weights: SAM at
    2 blocks with a structured decoder, DINOv2 at 2 blocks, the small
    matcher, a 4 px RANSAC band."""
    from pope_tpu_torch.config import AMGConfig, PipelineConfig
    from pope_tpu_torch.models.sam import AutomaticMaskGenerator
    from pope_tpu_torch.pipeline import PopeModels

    sam_cfg = SamConfig(
        encoder=SamEncoderConfig(img_size=128, embed_dim=64, depth=2, num_heads=2, window_size=5,
                                 global_attn_indexes=(1,), out_chans=32, dtype="float32", gelu="erf"),
        prompt_embed_dim=32, image_embedding_size=8, decoder_num_heads=2, decoder_mlp_dim=64,
        iou_head_hidden_dim=32, decoder_dtype="float32",
    )
    cfg = PipelineConfig(
        sam=sam_cfg, dinov2=DinoV2Config(embed_dim=64, depth=2, num_heads=2),
        matcher=MatcherConfig(
            backbone=BackboneConfig(initial_dim=32, block_dims=(32, 48, 64)),
            coarse=LoFTRStageConfig(d_model=64, d_ffn=64, nhead=4, layer_names=("self", "cross")),
            fine=LoFTRStageConfig(d_model=32, d_ffn=32, nhead=4, layer_names=("self", "cross")),
            match_coarse=CoarseMatchConfig(match_capacity=128, thr=0.0, border_rm=0),
        ),
        amg=AMGConfig(points_per_side=8, pred_iou_thresh=-0.25, stability_score_thresh=0.0, mask_capacity=8),
        ransac_thresh_px=4.0,
    )
    sam = Sam(sam_cfg)
    init_sam_weights(sam, torch.Generator().manual_seed(0))
    _structure_decoder(sam)
    dino = DinoVisionTransformer(cfg.dinov2).eval()
    init_dinov2_weights(dino, torch.Generator().manual_seed(1))
    matcher = Matcher(cfg.matcher).eval()
    init_matcher_weights(matcher, torch.Generator().manual_seed(2))
    return PopeModels(sam=sam, amg=AutomaticMaskGenerator(sam, cfg.amg, device=dev), dinov2=dino.to(dev),
                      matcher=matcher.to(dev), config=cfg, device=torch.device(dev))


def _eval_records(models, data_root, pairs_dir, batch_size, mesh=None):
    """evaluate_dataset's records (crop 64, each pair's solver noise drawn on
    the CPU), as finish_pairs returns them."""
    import dataclasses

    import pope_tpu_torch.eval.manifest as manifest
    from pope_tpu_torch.eval import evaluate_dataset
    from pope_tpu_torch.pipeline import runner

    got = []
    with pytest.MonkeyPatch.context() as mp:
        draw, finish = runner.pair_noise, runner.finish_pairs
        mp.setattr(runner, "pair_noise", lambda paths, n, r, device: draw(paths, n, r, "cpu").to(device))
        mp.setitem(manifest.DATASETS, "linemod", dataclasses.replace(manifest.DATASETS["linemod"], crop_size=64))
        mp.setattr(runner, "finish_pairs", lambda p: got.append(finish(p)) or got[-1])
        evaluate_dataset(models, "linemod", data_root, pairs_dir, batch_size=batch_size, progress=False, mesh=mesh)
    return [r for batch in got for r in batch]


def _dp_eval_rank(mesh, data_root, pairs_dir, out):
    """A rank of the dp = 2 eval on the card (parallel.spawn)."""
    recs = _eval_records(_small_eval_bundle("cuda"), data_root, pairs_dir, 4, mesh)
    if mesh.get_rank() == 0:
        torch.save(recs, out)


def test_eval_dp2_on_one_card_gives_the_dp1_records(card, tmp_path):
    """cli eval --dp 2's path on the one card (two ranks, gloo): batches of
    4, each rank its 2 pairs; rank 0 holds every record in pair order, the
    same discrete fields as the single process at batch size 2 (what each
    rank computes) and R, t within 1e-3 where solved."""
    from pope_tpu_torch.parallel import spawn

    data_root, pairs_dir = _eval_dataset(str(tmp_path / "data"))
    out = str(tmp_path / "dp2.pt")
    spawn(_dp_eval_rank, 2, argv=(data_root, pairs_dir, out), tp=1, device="cuda", timeout=600)
    dp2 = torch.load(out, weights_only=False)
    dp1 = _eval_records(_small_eval_bundle(card), data_root, pairs_dir, 2)
    assert len(dp2) == len(dp1) == 4 and any(r["ok"] for r in dp1)
    discrete = ("identifier", "ok", "pre_bbox", "gt_bbox", "n_strong", "n_dropped_masks", "n_dropped_matches")
    for a, b in zip(dp2, dp1):
        assert {k: a[k] for k in discrete} == {k: b[k] for k in discrete}
        if a["ok"]:
            np.testing.assert_allclose(a["R"], b["R"], atol=1e-3, rtol=0)
            np.testing.assert_allclose(a["t"], b["t"], atol=1e-3, rtol=0)


def test_eval_driver_on_card_matches_cpu(card, tmp_path, monkeypatch):
    """evaluate_dataset on a small f32 bundle (SAM at 2 blocks with a
    structured decoder, DINOv2 at 2 blocks, the small matcher, a 4 px RANSAC
    band) over 4 pairs of 96x128 frames on disk: on the card at depth 1 and
    depth 2 the same records; run_pair and the CPU the same discrete fields
    (ok, boxes, counts, match-set sizes) and R, t within 1e-3 (the solver's
    card-vs-CPU limit above) where solved. The solver noise is drawn on the
    CPU for both devices."""
    import dataclasses

    import pope_tpu_torch.eval.manifest as manifest
    from pope_tpu_torch.eval import evaluate_dataset, iter_pairs, load_manifest
    from pope_tpu_torch.models.sam import AutomaticMaskGenerator
    from pope_tpu_torch.pipeline import PopeModels, runner

    small = _small_eval_bundle("cpu")
    sam, dino, matcher, cfg = small.sam, small.dinov2, small.matcher, small.config

    def bundle(dev):
        s = copy.deepcopy(sam)
        return PopeModels(sam=s, amg=AutomaticMaskGenerator(s, cfg.amg, device=dev),
                          dinov2=copy.deepcopy(dino).to(dev), matcher=copy.deepcopy(matcher).to(dev),
                          config=cfg, device=torch.device(dev))

    cpu, gpu = bundle("cpu"), bundle(card)
    draw = runner.pair_noise
    monkeypatch.setattr(runner, "pair_noise", lambda paths, n, r, device: draw(paths, n, r, "cpu").to(device))
    monkeypatch.setitem(manifest.DATASETS, "linemod", dataclasses.replace(manifest.DATASETS["linemod"], crop_size=64))
    data_root, pairs_dir = _eval_dataset(str(tmp_path))
    got = []
    finish = runner.finish_pairs
    monkeypatch.setattr(runner, "finish_pairs", lambda p: got.append(finish(p)) or got[-1])

    def records(models, depth):
        monkeypatch.setenv("POPE_PIPELINE_DEPTH", str(depth))
        got.clear()
        evaluate_dataset(models, "linemod", data_root, pairs_dir, batch_size=2, progress=False)
        return [r for batch in got for r in batch]

    ref, card2, card1 = records(cpu, 2), records(gpu, 2), records(gpu, 1)
    spec = manifest.DATASETS["linemod"]
    serial = [runner.run_pair(gpu, p, spec) for p in iter_pairs(data_root, spec, load_manifest(pairs_dir, spec))]
    assert len(ref) == 4 and any(r["ok"] for r in ref)
    for a, b in zip(card1, card2):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{a['identifier']}/{k}")
    discrete = ("identifier", "ok", "pre_bbox", "gt_bbox", "n_strong", "n_dropped_masks", "n_dropped_matches")
    for other in (ref, serial):
        for a, b in zip(card2, other):
            assert {k: a[k] for k in discrete} == {k: b[k] for k in discrete}
            assert a["epi_errs"].shape == b["epi_errs"].shape
            if a["ok"]:
                np.testing.assert_allclose(a["R"], b["R"], atol=1e-3, rtol=0)
                np.testing.assert_allclose(a["t"], b["t"], atol=1e-3, rtol=0)


def _small_sam_cfg():
    return SamConfig(
        encoder=SamEncoderConfig(img_size=128, embed_dim=64, depth=2, num_heads=2, window_size=5,
                                 global_attn_indexes=(1,), out_chans=32, dtype="float32", gelu="erf"),
        prompt_embed_dim=32, image_embedding_size=8, decoder_num_heads=2, decoder_mlp_dim=64,
        iou_head_hidden_dim=32, decoder_dtype="float32",
    )


def _frame(seed, h=96, w=128):
    """Blobs under rectangles, uint8 RGB."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w, 3), 90.0, np.float32)
    for _ in range(30):
        cy, cx, s = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, 9)
        img += rng.uniform(-70, 70, 3) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))[..., None]
    for _ in range(3):
        y0, x0 = rng.integers(0, h - 40), rng.integers(0, w - 50)
        img[y0 : y0 + 30, x0 : x0 + 40] += rng.uniform(-60, 60, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_predictor_on_card_matches_cpu(card, rect):
    """SamPredictor of a small f32 SAM (structured decoder) on the card and on
    the CPU: the embedding, points / box / batched predictions (low-res
    logits and iou within 1e-4, binary masks on 0.99 of the pixels)."""
    from pope_tpu_torch.models.sam.predictor import SamPredictor

    sam = Sam(_small_sam_cfg())
    init_sam_weights(sam, torch.Generator().manual_seed(0))
    _structure_decoder(sam)
    cpu, gpu = SamPredictor(sam, rect, device="cpu"), SamPredictor(copy.deepcopy(sam), rect, device=card)
    img = _frame(1)
    cpu.set_image(img)
    gpu.set_image(img)
    assert gpu.features.device.type == card.type
    torch.testing.assert_close(gpu.features.cpu(), cpu.features, atol=1e-4, rtol=0)
    boxes = np.array([[10.0, 8.0, 90.0, 70.0], [40.0, 20.0, 120.0, 90.0]])
    calls = [("predict", dict(point_coords=np.array([[60.0, 40.0]]), point_labels=np.array([1]))),
             ("predict", dict(box=boxes[0], multimask_output=False)),
             ("predict_batched", dict(boxes=boxes))]
    for fn, kw in calls:
        (m_c, i_c, l_c), (m_g, i_g, l_g) = getattr(cpu, fn)(**kw), getattr(gpu, fn)(**kw)
        np.testing.assert_allclose(l_g, l_c, atol=1e-4, rtol=0)
        np.testing.assert_allclose(i_g, i_c, atol=1e-4, rtol=0)
        assert m_g.shape == m_c.shape and (m_g == m_c).mean() >= 0.99


def test_pose_service_on_card_equals_run_pairs(card):
    """The pose service at B=2 on the card: each result equals runner.run_pairs
    on the card on the same frames and names (a full batch and a padded
    one), with the small bundle of the eval-driver test above."""
    from typing import NamedTuple

    from pope_tpu_torch.config import AMGConfig, PipelineConfig
    from pope_tpu_torch.models.sam import AutomaticMaskGenerator
    from pope_tpu_torch.pipeline import PopeModels, runner
    from pope_tpu_torch.serve import PoseService

    cfg = PipelineConfig(
        sam=_small_sam_cfg(), dinov2=DinoV2Config(embed_dim=64, depth=2, num_heads=2),
        matcher=MatcherConfig(
            backbone=BackboneConfig(initial_dim=32, block_dims=(32, 48, 64)),
            coarse=LoFTRStageConfig(d_model=64, d_ffn=64, nhead=4, layer_names=("self", "cross")),
            fine=LoFTRStageConfig(d_model=32, d_ffn=32, nhead=4, layer_names=("self", "cross")),
            match_coarse=CoarseMatchConfig(match_capacity=128, thr=0.0, border_rm=0),
        ),
        amg=AMGConfig(points_per_side=8, pred_iou_thresh=-0.25, stability_score_thresh=0.0, mask_capacity=8),
        ransac_thresh_px=4.0,
    )
    sam = Sam(cfg.sam)
    init_sam_weights(sam, torch.Generator().manual_seed(0))
    _structure_decoder(sam)
    dino = DinoVisionTransformer(cfg.dinov2).eval()
    init_dinov2_weights(dino, torch.Generator().manual_seed(1))
    matcher = Matcher(cfg.matcher).eval()
    init_matcher_weights(matcher, torch.Generator().manual_seed(2))
    sam, dino, matcher = sam.to(card), dino.to(card), matcher.to(card)
    models = PopeModels(sam=sam, amg=AutomaticMaskGenerator(sam, cfg.amg, device=card), dinov2=dino,
                        matcher=matcher, config=cfg, device=card)

    class Pair(NamedTuple):
        pair_name: str
        object_label: str = "obj"
        box3d: str = ""

    class Spec(NamedTuple):
        crop_size: int

    K = np.array([[100.0, 0, 64], [0, 100, 48], [0, 0, 1]], np.float32)
    frames = [(_frame(10 + i), _frame(20 + i)) for i in range(3)]
    svc = PoseService(models, crop_size=64, batch_size=2, max_wait_ms=300.0)
    try:
        futs = [svc.submit(f0, f1, K, K, name=f"pair-{i}") for i, (f0, f1) in enumerate(frames)]
        results = [f.result(timeout=600) for f in futs]
        stats = svc.stats()
    finally:
        svc.shutdown(drain=False)
    assert stats["requests"] == 3 and stats["batches"] == 2 and stats["padded_slots"] == 1
    eye = np.eye(4, dtype=np.float32)

    def run_pairs(idx):
        dev = runner.upload_frames(np.stack([frames[i][0] for i in idx]), np.stack([frames[i][1] for i in idx]),
                                   np.stack([K] * len(idx)), np.stack([K] * len(idx)), card)
        return runner.run_pairs(models, [Pair(f"pair-{i}") for i in idx], Spec(64),
                                hosts=[(*frames[i], K, K, eye, eye) for i in idx], dev=dev)

    recs = run_pairs([0, 1]) + run_pairs([2, 2])[:1]
    for res, rec in zip(results, recs):
        assert res["name"] == rec["identifier"] and res["ok"] == rec["ok"]
        assert res["pre_bbox"].tolist() == rec["pre_bbox"]
        np.testing.assert_array_equal(res["R"], rec["R"])
        np.testing.assert_array_equal(res["t"], rec["t"])
        assert res["n_strong"] == rec["n_strong"] and res["mkpts0"].shape[0] == rec["epi_errs"].size
    assert any(r["mkpts0"].shape[0] for r in results)


@pytest.mark.parametrize("crop_n_layers", [0, 1])
def test_records_path_on_card_matches_cpu(card, crop_n_layers):
    """The records path of a small f32 SAM (structured decoder, filters open)
    on the card and on the CPU: generate's valid candidates and boxes, and
    generate_records' records (the same count, crop boxes and points; boxes
    within 1e-3 px; masks by IoU >= 0.99, the RLE decoding to each)."""
    from pope_tpu_torch import native
    from pope_tpu_torch.config import AMGConfig
    from pope_tpu_torch.models.sam import AutomaticMaskGenerator

    sam = Sam(_small_sam_cfg())
    init_sam_weights(sam, torch.Generator().manual_seed(0))
    with torch.no_grad():
        _structure_decoder(sam)
    cfg = AMGConfig(points_per_side=8, pred_iou_thresh=-1e9, stability_score_thresh=0.0,
                    crop_n_layers=crop_n_layers, min_mask_region_area=100)
    cpu = AutomaticMaskGenerator(sam, cfg, device="cpu")
    gpu = AutomaticMaskGenerator(copy.deepcopy(sam), cfg, device=card)
    img = _frame(2, 192, 256)
    if crop_n_layers == 0:
        a, b = cpu.generate(img), gpu.generate(img)
        np.testing.assert_array_equal(b.valid, a.valid)
        np.testing.assert_array_equal(b.point_idx[a.valid], a.point_idx[a.valid])
        np.testing.assert_allclose(b.boxes[a.valid], a.boxes[a.valid], atol=1e-3, rtol=0)
    ref, out = cpu.generate_records(img), gpu.generate_records(img)
    assert len(out) == len(ref) > 0
    for r, q in zip(out, ref):
        assert r["crop_box"] == q["crop_box"] and r["point_coords"] == q["point_coords"]
        np.testing.assert_allclose(r["bbox"], q["bbox"], atol=1e-3, rtol=0)
        seg, ref_seg = r["segmentation"], q["segmentation"]
        assert (seg & ref_seg).sum() >= 0.99 * (seg | ref_seg).sum()
        assert np.array_equal(native.rle_decode(r["rle"]), seg)


def test_native_library_builds_here(card):
    """The host library compiles on the card's machine (g++ from
    native/pope_native.cpp) and round-trips an RLE."""
    from pope_tpu_torch import native
    from pope_tpu_torch.ops.masks import mask_to_rle

    mask = np.random.default_rng(0).random((31, 45)) < 0.3
    assert native.available()
    assert native.rle_encode(mask) == mask_to_rle(mask)
    assert np.array_equal(native.rle_decode(native.rle_encode(mask)), mask)


def test_train_steps_on_card_match_cpu(card):
    """Two train steps of a small matcher on the card against the CPU from
    the same weights and batch (chip_smoke.py's check and tolerances: the
    losses, the first step's gradients, the weights and the BatchNorm
    statistics after both)."""
    import chip_smoke

    errs = chip_smoke.train_card_vs_cpu()
    assert errs["grad_rel_norm"] < chip_smoke.TOL_TRAIN_GRAD


def test_device_prefetcher_uploads_in_order(card):
    from pope_tpu_torch.data import DevicePrefetcher

    batches = [{"a": np.full((4, 5), i, np.float32), "n": np.arange(3) + i} for i in range(5)]
    out = [{k: v.cpu() for k, v in b.items()} for b in DevicePrefetcher(iter(batches), card)]
    assert [int(b["a"][0, 0]) for b in out] == list(range(5))
    assert all(torch.equal(b["n"], torch.arange(3) + i) for i, b in enumerate(out))


def test_exported_dinov2_launches_kernel_3_and_equals_eager(card, tmp_path):
    """A small DINOv2 (ViT-S width, 2 blocks, bf16) exported on the card,
    saved and loaded: one `pope::flash_attention` node and one kernel-3
    launch per block a call, and the eager model's cls token."""
    from pope_tpu_torch.export import export_dinov2, load_exported

    dino = DinoVisionTransformer(DinoV2Config(depth=2, dtype="bfloat16", gelu="tanh"))
    init_dinov2_weights(dino, torch.Generator().manual_seed(0))
    dino = dino.to(card).eval()
    path = tmp_path / "dinov2.pt2"
    export_dinov2(dino, img_size=196, path=str(path))
    program = load_exported(str(path))
    nodes = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert nodes.count("pope.flash_attention.default") == 2
    x = torch.randn(1, 196, 196, 3, device=card)
    with torch.no_grad():
        want = dino(x)["x_norm_clstoken"]
        before = flash_attention.launches
        got = program.module()(x)
    assert flash_attention.launches == before + 2
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_regressor_train_step_on_card_matches_cpu(card):
    """One train step of a small 'mkpts+vim' regressor on the card against
    the CPU from the same weights, batch and dropout masks (chip_smoke.py's
    check and tolerances)."""
    import chip_smoke

    row = chip_smoke.reg_card_vs_cpu()
    assert row["grad_rel"] <= chip_smoke.TOL_REG_GRAD_REL


def test_ssl_step_on_card_matches_cpu(card):
    """Two SSL steps of a small config (ViT-S width, 2 blocks, f32 heads,
    drop path 0.2) on the card against the CPU from the same state, batch
    and drop-path draws (chip_smoke.py's check and tolerances: the losses,
    the centers, the first step's moments, the weights after the second)."""
    import chip_smoke

    errs = chip_smoke.ssl_card_vs_cpu()
    assert errs["moments_rel"] < chip_smoke.TOL_SSL_MOMENTS


def test_ssl_step_launches_kernel_3_36_times(card):
    """One SSL step of ViT-S/14 (12 blocks, f32): kernel 3 launches 36 times,
    12 each for the teacher's global crops, the student's global crops (17
    tokens) and the student's local crops (5 tokens), all through the f32
    tf32x3 design."""
    import chip_smoke
    from pope_tpu_torch.train.ssl import SSLConfig, SSLMetaArch

    cfg = SSLConfig(global_crop_size=56, local_crop_size=28, n_local_crops=2, dino_out_dim=256, ibot_out_dim=256,
                    head_hidden_dim=128, head_bottleneck_dim=64)
    arch = SSLMetaArch(cfg, DinoV2Config(drop_path_rate=0.3))
    state = arch.init_state(0, card)
    batch = chip_smoke.ssl_batch(cfg, 2, card, seed=0)
    before, tf32x3 = flash_attention.launches, flash_attention.launches_by_design["tf32x3"]
    by_tokens = dict(flash_attention.launches_by_tokens)
    state, metrics = arch.train_step(state, batch)
    torch.cuda.synchronize()
    assert flash_attention.launches - before == 36
    assert flash_attention.launches_by_design["tf32x3"] - tf32x3 == 36
    grown = {n: c - by_tokens.get(n, 0) for n, c in flash_attention.launches_by_tokens.items()}
    assert {n: c for n, c in grown.items() if c} == {17: 24, 5: 12}
    assert torch.isfinite(metrics["total_loss"])


def test_nerf_on_card_matches_cpu(card):
    """A small f32 NeRF on the card against the CPU with the same weights and
    draws: render_rays, one train step, render_image (chip_smoke.py's check
    and tolerances)."""
    import chip_smoke

    errs = chip_smoke.nerf_card_vs_cpu()
    assert errs["rgb_coarse"] <= chip_smoke.TOL_NVS_COARSE


def _ordered_bf16(t):
    i = t.contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_dense_w8a8_on_card_equals_cpu(card, x_dtype):
    """x8, the scales and the int32 product bit for bit; the output within
    one step of its dtype (bf16 and f32 outputs)."""
    from pope_tpu_torch.ops.quant import dense_w8a8, int8_matmul, quantize_rows, quantize_weight_cols, rescale_int32

    g = torch.Generator().manual_seed(0)
    x = torch.randn(100, 256, generator=g).to(x_dtype)
    w = torch.randn(192, 256, generator=g) / 16
    b = 0.1 * torch.randn(192, generator=g)
    (x8, xs), (w8, ws) = quantize_rows(x), quantize_weight_cols(w)
    (x8_g, xs_g), (w8_g, ws_g) = quantize_rows(x.to(card)), quantize_weight_cols(w.to(card))
    for got, want in ((x8_g, x8), (xs_g, xs), (w8_g, w8), (ws_g, ws)):
        assert torch.equal(got.cpu(), want)
    y, y_g = int8_matmul(x8, w8), int8_matmul(x8_g, w8_g)
    assert torch.equal(y_g.cpu(), y) and torch.equal(y.long(), x8.long() @ w8.long().t())
    out_bf16 = rescale_int32(y, xs, ws, b, torch.bfloat16)
    got_bf16 = dense_w8a8(x.to(card), w8_g, ws_g, b.to(card), torch.bfloat16).cpu()
    assert (_ordered_bf16(got_bf16) - _ordered_bf16(out_bf16)).abs().max() <= 1
    out_f32 = rescale_int32(y, xs, ws, b, torch.float32).numpy()
    got_f32 = dense_w8a8(x.to(card), w8_g, ws_g, b.to(card), torch.float32).cpu().numpy()
    assert (np.abs(got_f32 - out_f32) <= np.spacing(np.abs(out_f32))).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_encoder_on_card_matches_cpu(card, dtype):
    """A depth-2 int8 encoder (16 heads of d 80 at width 1280 would be
    ViT-H; here 2 heads of 80) on the card against the CPU, within
    tests/test_torch_quant.py's whole-encoder limits (relative L2)."""
    from pope_tpu_torch.ops.quant import dense_w8a8

    cfg = SamConfig(
        encoder=SamEncoderConfig(img_size=256, embed_dim=160, num_heads=2, depth=2, global_attn_indexes=(1,),
                                 dtype=dtype, quantize="int8", gelu="erf" if dtype == "float32" else "tanh"),
        image_embedding_size=16)
    cpu = Sam(cfg)
    init_sam_weights(cpu, torch.Generator().manual_seed(1))
    gpu = copy.deepcopy(cpu).to(card)
    x = torch.from_numpy(np.random.default_rng(2).uniform(-2, 2, (2, 192, 256, 3)).astype(np.float32))
    before = dense_w8a8.launches
    with torch.no_grad():
        ref, out = cpu.encode_image(x), gpu.encode_image(x.to(card)).cpu()
    assert dense_w8a8.launches - before == 16
    rel = ((out - ref).norm() / ref.norm()).item()
    assert rel <= {"float32": 1.2e-2, "bfloat16": 3e-2}[dtype], rel


@pytest.mark.parametrize("B,N,design", [(80, 196, "short"), (1, 3072, "long")])
def test_kernel_3_at_sam_widths_matches_plain(card, B, N, design):
    """The bias-free encoder's kernel-3 shapes at 16 heads of d 80."""
    q, k, v = torch.randn(3, B, N, 16, 80, device=card).to(torch.bfloat16).unbind(0)
    before = flash_attention.launches_by_design[design]
    assert_matches_plain(flash_attention(q, k, v), flash_attention_plain(q, k, v))
    assert flash_attention.launches_by_design[design] == before + 1


# ---- the last wave's plans (cuda_kernels.tail_plan): every plan a kernel
# takes, forced through its C entry, against the plain version

_LONG_PLAN_CASES = [  # (B, nh, N, d, hk, wk): no bias where hk = 0
    (1, 6, 1025, 64, 0, 0),  # demo-dinov2: 9 key tiles, a masked key tail, 5 units a head
    (2, 3, 1000, 64, 0, 0),  # 8 key tiles, a ragged last one
    (2, 2, 257, 64, 0, 0),  # 3 key tiles, the last with one key
    (1, 2, 3328, 80, 52, 64),  # a sweep crop's grid: 26 tiles of two key rows
    (1, 2, 3328, 80, 64, 52),  # a portrait crop's: 32 tiles of two 56-slot rows
    (2, 2, 1025, 80, 25, 41),  # odd hk: the last tile's second key row masked
]


def _long_inputs(card, B, nh, N, d, hk, wk, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    q, k, v = torch.randn(B, N, 3, nh, d, device=card, generator=g).to(torch.bfloat16).unbind(2)
    if not hk:
        return (q, k, v), {}, flash_attention_plain(q, k, v)
    rel_h = (0.5 * torch.randn(B, nh, N, hk, device=card, generator=g)).to(torch.bfloat16)
    rel_w = (0.5 * torch.randn(B, nh, N, wk, device=card, generator=g)).to(torch.bfloat16)
    rel = {"rel_h": rel_h, "rel_w": rel_w, "hk": hk, "wk": wk}
    return (q, k, v), rel, flash_attention_relpos_plain(q, k, v, rel_h, rel_w, hk, wk)


@pytest.mark.parametrize("B,nh,N,d,hk,wk", _LONG_PLAN_CASES,
                         ids=[f"{N}-d{d}" + (f"-{hk}x{wk}" if hk else "") for _, _, N, d, hk, wk in _LONG_PLAN_CASES])
def test_long_kernel_under_every_plan(card, B, nh, N, d, hk, wk):
    """The long kernel (csrc/attention_long.cu) with its units split into s
    = 1 .. min(key tiles, 8) key chunks, from the first unit (split0 = 0)
    and from the middle one on (the others whole), each chunk's partial
    merged in the same launch: every plan matches the plain version, and
    three launches in a row give the same bits (the arrival counters reset,
    the merge runs in chunk order)."""
    from pope_tpu_torch.ops.cuda_kernels import LONG_MAX_PIECES, launch_with_plan, long_key_tiles, long_units

    (q, k, v), rel, ref = _long_inputs(card, B, nh, N, d, hk, wk, N + hk)
    units, tiles = long_units(B, N, nh), long_key_tiles(N, hk, wk)
    for s in range(1, min(tiles, LONG_MAX_PIECES) + 1):
        for split0 in (0, units // 2):
            outs = [launch_with_plan((split0, s), q, k, v, design="long", **rel) for _ in range(3)]
            torch.cuda.synchronize()
            assert_matches_plain(outs[0], ref)
            assert all(torch.equal(o, outs[0]) for o in outs[1:]), (s, split0)


def test_long_kernel_refuses_a_plan_it_cannot_run(card):
    """More key chunks than K/V tiles, or a split0 past the units: the
    launcher refuses (cudaErrorInvalidValue), and the wrapper raises."""
    from pope_tpu_torch.ops.cuda_kernels import launch_with_plan

    (q, k, v), _, _ = _long_inputs(card, 1, 2, 257, 64, 0, 0, 1)  # 3 key tiles, 2 units a head
    for plan in ((0, 4), (4, 2), (-1, 2)):
        with pytest.raises(RuntimeError, match="pope_attention_long failed"):
            launch_with_plan(plan, q, k, v, design="long")
    with pytest.raises(ValueError, match="takes no plan"):
        launch_with_plan((0, 2), q.float(), k.float(), v.float())


_SHORT_PLAN_CASES = [  # (B, nh, N, d, ws): windows of ws x ws with the bias; ws = 0 none
    (25, 16, 196, 80, 14),  # the square frame's 25 windows: 400 heads
    (20, 16, 196, 80, 14),  # one 640x480 frame's 20: 320
    (3, 6, 197, 64, 0),  # DINOv2's N = 197
    (2, 3, 256, 64, 0),  # two passes of 128 keys
]


@pytest.mark.parametrize("B,nh,N,d,ws", _SHORT_PLAN_CASES,
                         ids=[f"{B}x{nh}-{N}-d{d}" + ("-bias" if ws else "") for B, nh, N, d, ws in _SHORT_PLAN_CASES])
def test_short_kernel_under_every_plan(card, B, nh, N, d, ws):
    """The short kernel (csrc/attention_short.cu) with its heads split into
    s = 1 .. 4 runs of their 64-query tiles, from the first head and from
    the rule's split0 on: every plan matches the plain version and gives the
    same bits three times in a row."""
    from pope_tpu_torch.ops.cuda_kernels import launch_with_plan, short_plan

    g = torch.Generator(device=card).manual_seed(B * N + d)
    q, k, v = torch.randn(B, N, 3, nh, d, device=card, generator=g).to(torch.bfloat16).unbind(2)
    rel = {}
    if ws:
        rel_h, rel_w = ((0.5 * torch.randn(B, nh, N, ws, device=card, generator=g)).to(torch.bfloat16) for _ in "hw")
        rel = {"rel_h": rel_h, "rel_w": rel_w, "hk": ws, "wk": ws}
        ref = flash_attention_relpos_plain(q, k, v, rel_h, rel_w, ws, ws)
    else:
        ref = flash_attention_plain(q, k, v)
    rule = short_plan(B, N, nh)
    for s in range(1, 5):
        for split0 in (0, rule["split0"] if rule["split0"] < rule["units"] else rule["units"] // 2):
            outs = [launch_with_plan((split0, s), q, k, v, design="short", **rel) for _ in range(3)]
            torch.cuda.synchronize()
            assert_matches_plain(outs[0], ref)
            assert all(torch.equal(o, outs[0]) for o in outs[1:]), (s, split0)
    with pytest.raises(RuntimeError, match="pope_attention_short"):
        launch_with_plan((0, 5), q, k, v, design="short", **rel)  # more pieces than query tiles


def test_wrappers_pick_the_expected_plans(card):
    """On this card the wrappers' rule gives chip_smoke.py's plans (split at
    N = 1025, the crop and portrait crop, kernel 1's square and one-frame
    rows; whole at every eval-path row); the long kernel's "rows" layout,
    whose tiles the plan counts, is the launcher's; and a split row through
    the public wrapper matches the plain version and the unsplit plan's
    output to its tolerance."""
    import chip_smoke
    from pope_tpu_torch.ops.cuda_kernels import launch_with_plan, long_layout, long_plan, short_plan

    for key, (design, B, N, nh, d, hk, wk, s) in chip_smoke.TAIL_ROWS.items():
        assert attention_design(torch.bfloat16, N, d, hk, wk) == design, key
        plan = short_plan(B, N, nh) if design == "short" else long_plan(B, N, nh, d, hk, wk)
        assert plan["s"] == s, (key, plan)
        if design == "long" and hk:
            assert long_layout(d, hk, wk)["bias"] == "rows"
    (q, k, v), _, ref = _long_inputs(card, 1, 6, 1025, 64, 0, 0, 3)
    before = dict(flash_attention.launches_by_design)
    out = flash_attention(q, k, v)
    assert_one_launch_of(flash_attention, before, "long")
    assert_matches_plain(out, ref)
    assert_matches_plain(launch_with_plan((30, 1), q, k, v, design="long"), ref)
