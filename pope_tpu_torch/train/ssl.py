"""DINOv2 self-supervised pretraining: DINO + iBOT + KoLeo (port of
pope_tpu/train/ssl.py).

A teacher (the EMA of the student) sees the two global crops and gives
targets: softmax-centered (or sinkhorn-balanced) prototype distributions for
each crop's cls token, with the crop pairing reversed, and for every patch
token of the global crops. The student sees the global crops with iBOT's
block masks and the local crops, and is trained by
- DINO's cross-entropy of each local and global cls token against the
  teacher's other global crops;
- iBOT's masked-patch cross-entropy, dense: every (crop, patch) term is
  weighted mask / n_masked(crop), so the head runs over all patch tokens
  with static shapes;
- KoLeo's nearest-neighbour entropy of each global crop's cls tokens.
The step's optimizer is AdamW written out as the JAX package writes it
(per-parameter lr and weight-decay multipliers: layer-wise lr decay, the
patch embed's lr multiplier, no decay on 1-d and token parameters, and a
frozen last layer for the first iterations), not torch.optim; the teacher
then moves to the student by the scheduled momentum.

Parameters live in modules: `SSLState.student` and `.teacher` are
ModuleDicts of {"backbone", "dino_head"[, "ibot_head"]}, the Adam moments
are dicts keyed by the student's parameter names. The step updates the
state in place and returns it. DINOv2's attention runs through
ops/flash_attention.py::flash_attention (a CUDA tensor launches the kernel,
whose backward is the plain version's); the JAX package computes it as an
einsum and an f32 softmax.

The stochastic-depth draws of step s come from a CPU generator seeded with
(1717, s), so a resumed run repeats them and the card and the CPU draw the
same masks; the JAX package folds s into PRNGKey(1717). All of a step's
masks reach the card in one copy (DinoVisionTransformer.draw_drop_keep).

`make_sharded_ssl_step` runs the step over a dp mesh, each rank on its
B / dp images (both global crops, their local crops and masks:
`shard_ssl_batch`), equal to the step on the global batch: the centers,
sinkhorn's sums and KoLeo's neighbours are the global batch's, the drop
path masks are the global draw's rows, and the gradients are averaged over
dp. `shard_ssl_state` cuts the large leaves of the parameters and moments
over dp (FSDP); the step gathers them for the forwards and updates the
shards.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pope_tpu_torch.config import DinoV2Config
from pope_tpu_torch.models.dinov2.model import DinoVisionTransformer, LayerScale
from pope_tpu_torch.models.sam.encoder import dense

DROP_PATH_SEED = 1717


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SSLConfig:
    # crops
    global_crop_size: int = 224
    local_crop_size: int = 98
    n_local_crops: int = 8
    # dino
    dino_out_dim: int = 65536  # head_n_prototypes
    head_hidden_dim: int = 2048
    head_bottleneck_dim: int = 256
    head_nlayers: int = 3
    dino_loss_weight: float = 1.0
    koleo_loss_weight: float = 0.1
    # ibot
    head_dtype: str = "bfloat16"
    ibot_loss_weight: float = 1.0
    ibot_separate_head: bool = False
    ibot_out_dim: int = 65536
    mask_ratio_min: float = 0.1
    mask_ratio_max: float = 0.5
    mask_sample_probability: float = 0.5
    # temps / centering
    student_temp: float = 0.1
    warmup_teacher_temp: float = 0.04
    teacher_temp: float = 0.07
    warmup_teacher_temp_iters: int = 37500
    center_momentum: float = 0.9
    centering: str = "centering"  # | 'sinkhorn_knopp'
    sinkhorn_iterations: int = 3
    # optim
    lr: float = 4e-3
    min_lr: float = 1e-6
    warmup_iters: int = 12500
    total_iters: int = 125000
    weight_decay: float = 0.04
    weight_decay_end: float = 0.4
    adamw_beta1: float = 0.9
    adamw_beta2: float = 0.999
    layerwise_decay: float = 0.9
    patch_embed_lr_mult: float = 0.2
    freeze_last_layer_iters: int = 1250
    # teacher EMA
    momentum_teacher: float = 0.992
    final_momentum_teacher: float = 1.0


# ---------------------------------------------------------------------------
# DINO head
# ---------------------------------------------------------------------------


class DINOHead(nn.Module):
    """MLP (in `dtype`) -> L2-normalize -> weight-normed prototypes in f32.
    The last layer keeps the direction `last_v` (bottleneck, out) and the
    per-prototype gain `last_g` as parameters, as the JAX package does."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int = 2048, bottleneck_dim: int = 256,
                 nlayers: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        n = max(nlayers, 1)
        dims = [in_dim] + [hidden_dim] * (n - 1) + [bottleneck_dim]
        self.n_mlp = n
        for i in range(n):
            self.add_module(f"mlp_{i}", nn.Linear(dims[i], dims[i + 1]))
        self.last_v = nn.Parameter(torch.zeros(bottleneck_dim, out_dim))
        self.last_g = nn.Parameter(torch.ones(out_dim))

    def forward(self, x):
        for i in range(self.n_mlp):
            x = dense(getattr(self, f"mlp_{i}"), x, self.dtype)
            if i < self.n_mlp - 1:
                x = F.gelu(x)
        x = x.float()
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)
        v = self.last_v
        w = v / torch.linalg.vector_norm(v, dim=0, keepdim=True).clamp(min=1e-12) * self.last_g[None, :]
        return x @ w


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def softmax_center_teacher(logits, center, teacher_temp):
    return torch.softmax((logits - center) / teacher_temp, dim=-1)


def update_center(center, teacher_logits, momentum: float = 0.9):
    """EMA of the center toward the mean over every axis but the last."""
    batch_center = teacher_logits.mean(dim=tuple(range(teacher_logits.ndim - 1)))
    return center * momentum + batch_center * (1.0 - momentum)


def _gsum(x, group):
    """x summed over a dp group (no gradient; the teacher's side has none)."""
    if group is None:
        return x
    from pope_tpu_torch.parallel.collectives import all_reduce

    return all_reduce(x, group)


def sinkhorn_knopp_teacher(logits, teacher_temp, n_iterations: int = 3, sample_weight=None, group=None):
    """Batch-prototype balanced assignment. `sample_weight` (rows) marks real
    samples (1) against padding (0). A row or column sum that is exactly 0
    divides by 1 instead (it stays 0); tiny non-zero sums still divide.
    group: the rows are this rank's part of a dp batch, and the sums over
    samples are the global batch's."""
    Q = torch.exp(logits.float() / teacher_temp).T  # (K, B)
    K, B = Q.shape
    if sample_weight is not None:
        Q = Q * sample_weight[None, :]
        n_samples = _gsum(sample_weight.sum(), group)
    else:
        n_samples = _gsum(torch.full((), float(B), device=Q.device), group)

    def safe(x):
        return torch.where(x == 0.0, torch.ones_like(x), x)

    Q = Q / safe(_gsum(Q.sum(), group))
    for _ in range(n_iterations):
        Q = Q / safe(_gsum(Q.sum(dim=1, keepdim=True), group) * K)
        Q = Q / safe(Q.sum(dim=0, keepdim=True) * n_samples)
    return (Q * n_samples).T


def dino_cross_entropy(student_logits, teacher_probs, student_temp: float = 0.1):
    """-sum(t * log_softmax(s / temp)), meaned over the batch."""
    lsm = torch.log_softmax(student_logits.float() / student_temp, dim=-1)
    return -(teacher_probs * lsm).sum(dim=-1).mean()


def ibot_patch_loss_dense(student_patch_logits, teacher_patch_probs, masks, student_temp: float = 0.1):
    """Masked patch cross-entropy, dense: each (b, patch) term weighted
    mask / n_masked(b), the sum divided by B. masks: (B, N) bool."""
    lsm = torch.log_softmax(student_patch_logits.float() / student_temp, dim=-1)
    per_tok = (teacher_patch_probs * lsm).sum(dim=-1)  # (B, N)
    w = masks.float()
    w = w / w.sum(dim=-1, keepdim=True).clamp(min=1.0)
    return -(per_tok * w).sum() / masks.shape[0]


def koleo_loss(x, eps: float = 1e-8, group=None):
    """-mean log distance of each L2-normalized row to its nearest
    neighbour (the first index among equally near ones). group: the rows
    are this rank's contiguous part of a dp batch; the neighbours are
    searched over the whole batch (a differentiable gather), and the mean
    is over this rank's rows."""
    x = x.float()
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=eps)
    n = x.shape[0]
    every, first = x, 0
    if group is not None:
        from pope_tpu_torch.parallel.collectives import gather_parts, group_rank

        every, first = gather_parts(x, group), group_rank(group) * n
    dots = x @ every.T
    own = torch.arange(n, device=x.device)[:, None] + first == torch.arange(every.shape[0], device=x.device)[None]
    dots = torch.where(own, torch.full_like(dots, -1.0), dots)
    nn_idx = dots.argmax(dim=1)
    d = torch.linalg.vector_norm(x - every[nn_idx], dim=-1)
    return -torch.log(d + eps).mean()


# ---------------------------------------------------------------------------
# schedules, in f32 as the JAX package computes them
# ---------------------------------------------------------------------------

_F32 = torch.float32


def cosine_schedule(step, base, final, total, warmup: int = 0, start: float = 0.0) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=_F32)
    warm = start + (base - start) * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = final + 0.5 * (base - final) * (1.0 + torch.cos(torch.tensor(math.pi, dtype=_F32) * t))
    return torch.where(step < warmup, warm, cos)


def ssl_schedules(cfg: SSLConfig, step) -> Dict[str, float]:
    """lr / wd / teacher momentum / teacher temp / last-layer lr at `step`,
    each an f32 value as a Python float."""
    lr = cosine_schedule(step, cfg.lr, cfg.min_lr, cfg.total_iters, cfg.warmup_iters)
    wd = cosine_schedule(step, cfg.weight_decay, cfg.weight_decay_end, cfg.total_iters)
    mom = cosine_schedule(step, cfg.momentum_teacher, cfg.final_momentum_teacher, cfg.total_iters)
    s = torch.as_tensor(step, dtype=_F32)
    temp = torch.where(
        s < cfg.warmup_teacher_temp_iters,
        cfg.warmup_teacher_temp
        + (cfg.teacher_temp - cfg.warmup_teacher_temp) * s / max(cfg.warmup_teacher_temp_iters, 1),
        torch.tensor(cfg.teacher_temp, dtype=_F32),
    )
    last_lr = torch.where(torch.as_tensor(step) < cfg.freeze_last_layer_iters, torch.zeros((), dtype=_F32), lr)
    return {"lr": lr.item(), "wd": wd.item(), "momentum": mom.item(), "teacher_temp": temp.item(),
            "last_layer_lr": last_lr.item()}


# ---------------------------------------------------------------------------
# parameter groups: per-parameter multipliers keyed by the student's names
# ---------------------------------------------------------------------------


def _block_index(name: str, depth: int) -> int:
    """Layer ids: patch embed, cls / pos / mask tokens 0, block i i + 1,
    everything else (final norm, heads) depth + 1."""
    for part in name.split("."):
        if part.startswith("block_"):
            return int(part.split("_")[1]) + 1
    if any(k in name for k in ("patch_embed", "cls_token", "pos_embed", "mask_token")):
        return 0
    return depth + 1


def build_group_multipliers(named_params, cfg: SSLConfig, depth: int):
    """{name: lr_mult}, {name: wd_mult}, {name: is_last_layer} over the
    student's (name, parameter) pairs, names as `backbone.block_0.attn.qkv.weight`."""
    lr_mults, wd_mults, last_flags = {}, {}, {}
    for name, p in named_params:
        in_backbone = name.split(".")[0] == "backbone"
        layer_id = _block_index(name, depth) if in_backbone else depth + 1
        lr_m = cfg.layerwise_decay ** (depth + 1 - layer_id) if in_backbone else 1.0
        if "patch_embed" in name:
            lr_m *= cfg.patch_embed_lr_mult
        # no weight decay on 1-d parameters (norms, biases, gains) and tokens
        wd_mults[name] = 0.0 if (p.ndim <= 1 or "token" in name or "pos_embed" in name) else 1.0
        lr_mults[name] = lr_m
        last_flags[name] = 1.0 if ("last_v" in name or "last_g" in name) else 0.0
    return lr_mults, wd_mults, last_flags


# ---------------------------------------------------------------------------
# state and meta-architecture
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SSLState:
    step: int
    student: nn.ModuleDict  # {'backbone', 'dino_head'[, 'ibot_head']}
    teacher: nn.ModuleDict  # the same structure, no gradients
    mu: Dict[str, torch.Tensor]  # Adam first moments, by student parameter name
    nu: Dict[str, torch.Tensor]  # Adam second moments
    dino_center: torch.Tensor  # (K,)
    ibot_center: torch.Tensor  # (K,)
    fsdp: Optional["FSDPLayout"] = None  # shard_ssl_state's cut, None when whole

    def state_dict(self) -> dict:
        return {"step": self.step, "student": self.student.state_dict(), "teacher": self.teacher.state_dict(),
                "mu": dict(self.mu), "nu": dict(self.nu), "dino_center": self.dino_center,
                "ibot_center": self.ibot_center}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> "SSLState":
        self.step = int(sd["step"])
        self.student.load_state_dict(sd["student"])
        self.teacher.load_state_dict(sd["teacher"])
        for mine, theirs in ((self.mu, sd["mu"]), (self.nu, sd["nu"])):
            if mine.keys() != theirs.keys():
                raise KeyError(f"moments differ in keys: {sorted(mine.keys() ^ theirs.keys())[:8]}")
            for k, v in theirs.items():
                mine[k].copy_(v)
        self.dino_center.copy_(sd["dino_center"])
        self.ibot_center.copy_(sd["ibot_center"])
        return self


def _trunc_normal_(t, std: float, g: torch.Generator):
    """flax's truncated_normal(std): N(0, 1) cut at +-2, rescaled to std."""
    s = std / 0.87962566103423978  # the std of N(0, 1) cut at +-2
    nn.init.trunc_normal_(t, std=s, a=-2.0 * s, b=2.0 * s, generator=g)


@torch.no_grad()
def init_ssl_student(student: nn.ModuleDict, generator: torch.Generator) -> None:
    """A fresh student as the JAX package's init draws it, from a CPU
    generator: lecun-normal backbone kernels, zero biases, unit LayerNorms,
    LayerScale at init_values, cls token N(0, 1e-6), pos embed N(0, 0.02),
    zero mask token; the heads' kernels and `last_v` truncated N(0, 0.02),
    `last_g` 1."""
    g = generator
    backbone = student["backbone"]
    for mod in backbone.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            _trunc_normal_(mod.weight, 1.0 / math.sqrt(fan_in), g)
            mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, LayerScale):
            mod.gamma.fill_(backbone.config.init_values)
    backbone.cls_token.copy_(torch.randn(backbone.cls_token.shape, generator=g) * 1e-6)
    backbone.pos_embed.copy_(torch.randn(backbone.pos_embed.shape, generator=g) * 0.02)
    backbone.mask_token.zero_()
    for key in ("dino_head", "ibot_head"):
        if key not in student:
            continue
        head = student[key]
        for mod in head.modules():
            if isinstance(mod, nn.Linear):
                _trunc_normal_(mod.weight, 0.02, g)
                mod.bias.zero_()
        _trunc_normal_(head.last_v, 0.02, g)
        head.last_g.fill_(1.0)


class SSLMetaArch:
    """The SSL configuration and its step; the parameters live in SSLState."""

    def __init__(self, cfg: SSLConfig = SSLConfig(), backbone_cfg: DinoV2Config = DinoV2Config()):
        self.cfg = cfg
        self.backbone_cfg = backbone_cfg

    def _build(self) -> nn.ModuleDict:
        cfg, bcfg = self.cfg, self.backbone_cfg

        def head(out):
            return DINOHead(bcfg.embed_dim, out, cfg.head_hidden_dim, cfg.head_bottleneck_dim,
                            cfg.head_nlayers, getattr(torch, cfg.head_dtype))

        mods = {"backbone": DinoVisionTransformer(bcfg), "dino_head": head(cfg.dino_out_dim)}
        if cfg.ibot_separate_head:
            mods["ibot_head"] = head(cfg.ibot_out_dim)
        return nn.ModuleDict(mods)

    def init_state(self, seed: int = 0, device=None) -> SSLState:
        """A fresh state on `device` (default CUDA; the entry points resolve
        it), drawn from a CPU generator seeded with `seed`."""
        device = torch.device("cuda" if device is None else device)
        student = self._build()
        init_ssl_student(student, torch.Generator().manual_seed(seed))
        return self.state_from_student(student.to(device))

    def state_from_student(self, student: nn.ModuleDict) -> SSLState:
        """Step 0 around `student`: the teacher a copy, zero moments and
        centers."""
        cfg = self.cfg
        teacher = copy.deepcopy(student).requires_grad_(False)
        dev = next(student.parameters()).device
        mu = {n: torch.zeros_like(p) for n, p in student.named_parameters()}
        nu = {n: torch.zeros_like(p) for n, p in student.named_parameters()}
        k_ibot = cfg.ibot_out_dim if cfg.ibot_separate_head else cfg.dino_out_dim
        return SSLState(0, student, teacher, mu, nu, torch.zeros(cfg.dino_out_dim, device=dev),
                        torch.zeros(k_ibot, device=dev))

    def multipliers(self, state: SSLState):
        return build_group_multipliers(state.student.named_parameters(), self.cfg, self.backbone_cfg.depth)

    # -- forward pieces -----------------------------------------------------

    @torch.no_grad()
    def _teacher_targets(self, teacher, global_crops, masks, centers, temp, group=None):
        """Teacher global forward -> (DINO probs with the crop pairing
        reversed, iBOT patch probs, new centers). group: the crops are this
        rank's part of a dp batch; the centers and sinkhorn's sums are the
        global batch's."""
        cfg = self.cfg
        out = teacher["backbone"](global_crops)
        cls, patches = out["x_norm_clstoken"], out["x_norm_patchtokens"]
        B = cls.shape[0] // 2
        # crop A's target comes from crop B and the other way round
        dino_logits = teacher["dino_head"](torch.cat([cls[B:], cls[:B]], dim=0))
        ibot_head = teacher["ibot_head"] if "ibot_head" in teacher else teacher["dino_head"]
        ibot_logits = ibot_head(patches)
        dino_center, ibot_center = centers
        if cfg.centering == "sinkhorn_knopp":
            dino_probs = sinkhorn_knopp_teacher(dino_logits, temp, cfg.sinkhorn_iterations, group=group)
            flat = ibot_logits.reshape(-1, ibot_logits.shape[-1])
            ibot_probs = sinkhorn_knopp_teacher(flat, temp, cfg.sinkhorn_iterations,
                                                sample_weight=masks.reshape(-1).float(),
                                                group=group).reshape(ibot_logits.shape)
            return dino_probs, ibot_probs, (dino_center, ibot_center)
        dino_probs = softmax_center_teacher(dino_logits, dino_center, temp)
        ibot_probs = softmax_center_teacher(ibot_logits, ibot_center, temp)
        # the iBOT center moves toward the mean over masked tokens only
        w = masks.float()[..., None]
        sums = _gsum(torch.cat([dino_logits.sum(dim=0), (ibot_logits * w).sum(dim=(0, 1)), w.sum()[None],
                                torch.full((1,), float(dino_logits.shape[0]), device=w.device)]), group)
        K = dino_logits.shape[-1]
        dino_mean = sums[:K] / sums[-1]
        masked_mean = sums[K:-2] / sums[-2].clamp(min=1.0)
        m = cfg.center_momentum
        new_centers = (dino_center * m + dino_mean * (1 - m),
                       ibot_center * m + masked_mean * (1 - m))
        return dino_probs, ibot_probs, new_centers

    def _student_losses(self, student, batch, dino_probs, ibot_probs, masks, generator=None, dp=None):
        """(total loss, {name: loss}). With a generator (and drop_path_rate >
        0) the backbone runs with stochastic depth, the global forward's
        draws first, both forwards' drawn at once. dp (_DataParallel): the
        batch is this rank's part; the draws are the global batch's rows
        and KoLeo searches the global batch; the losses are this rank's
        means."""
        cfg = self.cfg
        n_local = cfg.n_local_crops
        n_terms = 2 + max(n_local * 2, 1)
        backbone, dino_head = student["backbone"], student["dino_head"]
        g_dp, l_dp = {}, {}
        if generator is not None:
            sizes = [batch["global_crops"].shape[0]] + ([batch["local_crops"].shape[0]] if n_local > 0 else [])
            if dp is None:
                keeps = backbone.draw_drop_keep(sizes, generator, masks.device)
            else:
                keeps = dp.rows_of(backbone.draw_drop_keep([s * dp.size for s in sizes], generator, masks.device))
            g_dp = {"train": True, "drop_keep": keeps[0]}
            if n_local > 0:
                l_dp = {"train": True, "drop_keep": keeps[1]}
        g_out = backbone(batch["global_crops"], masks=masks, **g_dp)
        losses = {}
        total = 0.0
        if n_local > 0:
            l_out = backbone(batch["local_crops"], **l_dp)
            local_logits = dino_head(l_out["x_norm_clstoken"])  # (n_local * B, K)
            B = dino_probs.shape[0] // 2
            # each local crop against both teacher crops, in the flat
            # crop-major layout: sum_i CE(chunk_i, t_j) = n_local * CE(all, tile(t_j))
            t_chunks = dino_probs.reshape(2, B, -1)
            local_loss = 0.0
            for j in range(2):
                t_rep = torch.cat([t_chunks[j]] * n_local, dim=0)
                local_loss = local_loss + n_local * dino_cross_entropy(local_logits, t_rep, cfg.student_temp)
            local_loss = local_loss / n_terms
            losses["dino_local_crops_loss"] = local_loss
            total = total + cfg.dino_loss_weight * local_loss

        g_cls = g_out["x_norm_clstoken"]  # (2B, C)
        g_logits = dino_head(g_cls)
        # the teacher's probs are already reversed: direct alignment is the
        # cross-crop term, x2 for the two global crops
        global_loss = dino_cross_entropy(g_logits, dino_probs, cfg.student_temp) * 2.0 / n_terms
        losses["dino_global_crops_loss"] = global_loss
        total = total + cfg.dino_loss_weight * global_loss

        if cfg.koleo_loss_weight > 0:
            B = g_cls.shape[0] // 2
            group = None if dp is None else dp.group
            kl = cfg.koleo_loss_weight * (koleo_loss(g_cls[:B], group=group) + koleo_loss(g_cls[B:], group=group))
            losses["koleo_loss"] = kl / 2.0
            total = total + kl

        if cfg.ibot_loss_weight > 0:
            head = student["ibot_head"] if "ibot_head" in student else dino_head
            patch_logits = head(g_out["x_norm_patchtokens"])
            ibot = ibot_patch_loss_dense(patch_logits, ibot_probs, masks, cfg.student_temp)
            losses["ibot_loss"] = ibot / 2.0
            total = total + cfg.ibot_loss_weight * ibot
        return total, losses

    @torch.no_grad()
    def _apply_update(self, state: SSLState, sched, mults) -> None:
        """AdamW with per-parameter lr / wd multipliers and the frozen last
        layer, then the teacher's EMA toward the new student, in place: one
        foreach op per arithmetic step over all parameters, each step the JAX
        package's, in its order (so the same f32 roundings)."""
        cfg = self.cfg
        lr_m, wd_m, last_f = mults
        b1, b2, eps = cfg.adamw_beta1, cfg.adamw_beta2, 1e-8
        t = torch.tensor(state.step + 1.0, dtype=_F32)
        bc1 = (1.0 - torch.tensor(b1, dtype=_F32) ** t).item()
        bc2 = (1.0 - torch.tensor(b2, dtype=_F32) ** t).item()
        names, params = zip(*state.student.named_parameters())
        f32 = np.float32
        lf, lm, wm = (np.array([m[n] for n in names], f32) for m in (last_f, lr_m, wd_m))
        # per parameter: (last_lr * lf + lr * (1 - lf)) * lr_mult and wd * wd_mult, in f32
        step_lr = ((f32(sched["last_layer_lr"]) * lf + f32(sched["lr"]) * (f32(1.0) - lf)) * lm).tolist()
        wdm = (f32(sched["wd"]) * wm).tolist()
        grads = [p.grad.float() if p.grad is not None else torch.zeros_like(p) for p in params]
        mus, nus = [state.mu[n] for n in names], [state.nu[n] for n in names]
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))  # b1 mu + (1 - b1) g
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, 1 - b2), grads))  # + (1 - b2) g g
        del grads
        den = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        adam = torch._foreach_div(mus, bc1)
        torch._foreach_div_(adam, den)  # (mu / bc1) / (sqrt(nu / bc2) + eps)
        del den
        torch._foreach_add_(adam, torch._foreach_mul(list(params), wdm))
        torch._foreach_mul_(adam, step_lr)
        torch._foreach_sub_(list(params), adam)  # p - step_lr (adam + wd p)
        del adam
        m = sched["momentum"]
        teacher = list(state.teacher.parameters())
        torch._foreach_mul_(teacher, m)
        torch._foreach_add_(teacher, torch._foreach_mul(list(params), 1.0 - m))  # tp m + sp (1 - m)

    # -- the step -----------------------------------------------------------

    def train_step(self, state: SSLState, batch: Dict[str, torch.Tensor], mults=None,
                   generator: Optional[torch.Generator] = None,
                   dp: Optional["_DataParallel"] = None) -> Tuple[SSLState, Dict[str, torch.Tensor]]:
        """One SSL step, in place on `state`.

        batch: global_crops (2B, S, S, 3) [crop 0 of every image, then crop
        1], local_crops (n_local * B, s, s, 3), masks (2B, N) bool, all on
        the state's device. With drop_path_rate > 0 the stochastic depth
        draws come from `generator`, by default a CPU generator seeded with
        (1717, step). Returns (state, metrics as 0-dim device tensors).
        dp: make_sharded_ssl_step's; the batch is this rank's images and the
        metrics are the global batch's.
        """
        cfg = self.cfg
        sched = ssl_schedules(cfg, state.step)
        masks = batch["masks"]
        if dp is not None:
            dp.gather_params(state)
        dino_probs, ibot_probs, new_centers = self._teacher_targets(
            state.teacher, batch["global_crops"], masks, (state.dino_center, state.ibot_center),
            sched["teacher_temp"], group=None if dp is None else dp.group,
        )
        if self.backbone_cfg.drop_path_rate > 0 and generator is None:
            generator = torch.Generator().manual_seed((DROP_PATH_SEED << 32) | state.step)
        elif self.backbone_cfg.drop_path_rate == 0:
            generator = None
        state.student.zero_grad(set_to_none=True)
        total, losses = self._student_losses(state.student, batch, dino_probs, ibot_probs, masks, generator, dp)
        total.backward()
        if dp is not None:
            dp.reduce_grads(state)
            losses = {k: dp.mean(v) for k, v in losses.items()}
            total = dp.mean(total)
        if mults is None:
            mults = self.multipliers(state)
        self._apply_update(state, sched, mults)
        state.student.zero_grad(set_to_none=True)
        state.dino_center, state.ibot_center = new_centers
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics["lr"] = torch.tensor(sched["lr"])
        metrics["teacher_momentum"] = torch.tensor(sched["momentum"])
        return state, metrics


# ---------------------------------------------------------------------------
# data parallel: the sharded step and the FSDP state layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FSDPLayout:
    """shard_ssl_state's cut: the student / teacher parameter names (and
    their moments) whose leading axis this rank holds 1 / size of."""

    group: object
    rank: int
    size: int
    names: frozenset


def _sharded_params(state: SSLState):
    """(student parameter, teacher parameter, name) of every FSDP-cut leaf."""
    if state.fsdp is None:
        return []
    teacher = dict(state.teacher.named_parameters())
    return [(p, teacher[n], n) for n, p in state.student.named_parameters() if n in state.fsdp.names]


def _rows(x: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    n = x.shape[0] // size
    return x[rank * n:(rank + 1) * n]


class _DataParallel:
    """make_sharded_ssl_step's view of its dp axis; `images` is this rank's
    image count of the current batch."""

    def __init__(self, mesh):
        from pope_tpu_torch.parallel.mesh import axis_rank, axis_size

        self.group = mesh.get_group("dp")
        self.size = axis_size(mesh, "dp")
        self.rank = axis_rank(mesh, "dp")
        self.images = 0

    def rows_of(self, keeps):
        """Each forward's DropPath masks drawn for the global batch ->
        this rank's rows: crop c of local image i is global row c * B + r
        b + i (the crop-major layout)."""
        b, B = self.images, self.images * self.size
        out = []
        for keep in keeps:
            n = next((a.shape[0] for a, _ in keep if a is not None), 0)
            rows = torch.cat([torch.arange(c * B + self.rank * b, c * B + (self.rank + 1) * b)
                              for c in range(n // B)]) if n else None
            out.append([(None if a is None else a[rows.to(a.device)], None if f is None else f[rows.to(f.device)])
                        for a, f in keep])
        return out

    def mean(self, v: torch.Tensor) -> torch.Tensor:
        from pope_tpu_torch.parallel.collectives import all_reduce

        return all_reduce(v.detach(), self.group) / self.size

    @torch.no_grad()
    def gather_params(self, state: SSLState) -> None:
        """The whole of every FSDP-cut parameter, for the forwards."""
        from pope_tpu_torch.parallel.collectives import all_gather

        for s, t, _ in _sharded_params(state):
            s.data = all_gather(s.data, self.group)
            t.data = all_gather(t.data, self.group)

    @torch.no_grad()
    def reduce_grads(self, state: SSLState) -> None:
        """Average the student's gradients over dp (one flat all-reduce),
        then keep this rank's shard of each FSDP-cut parameter, its gradient
        and the teacher's."""
        from pope_tpu_torch.parallel.collectives import all_reduce_grads_

        all_reduce_grads_(state.student.parameters(), self.group, average=True)
        for s, t, _ in _sharded_params(state):
            s.data = _rows(s.data, self.rank, self.size).clone()
            t.data = _rows(t.data, self.rank, self.size).clone()
            if s.grad is not None:
                s.grad = _rows(s.grad, self.rank, self.size).clone()


def make_sharded_ssl_step(arch: SSLMetaArch, mesh, mults=None):
    """The SSL step over a dp mesh (parallel.make_mesh(n, tp=1)):
    step(state, batch) with `batch` this rank's images (shard_ssl_batch,
    or a process's own stream) and `state` whole or cut by
    shard_ssl_state. It equals train_step on the global batch (the
    concatenation of the ranks' images); the metrics are the global
    batch's."""
    dp = _DataParallel(mesh)

    def step(state: SSLState, batch: Dict[str, torch.Tensor]):
        dp.images = batch["global_crops"].shape[0] // 2
        return arch.train_step(state, batch, mults=mults, dp=dp)

    return step


def shard_ssl_batch(mesh, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's B / dp images of a global multi-crop batch, in the same
    crop-major layout: both global crops and their masks, and every local
    crop of those images (a plain slice of the 2B axis would hand rank 0
    crop 0 of every image)."""
    from pope_tpu_torch.parallel.mesh import axis_rank, axis_size

    n, r = axis_size(mesh, "dp"), axis_rank(mesh, "dp")
    B = batch["global_crops"].shape[0] // 2
    if B % n:
        raise ValueError(f"batch of {B} images does not divide over dp={n}")
    b = B // n

    def cut(x):
        if x.shape[0] == 0:
            return x
        crops = x.reshape(x.shape[0] // B, B, *x.shape[1:])
        return crops[:, r * b:(r + 1) * b].reshape(-1, *x.shape[1:])

    return {k: cut(v) for k, v in batch.items()}


@torch.no_grad()
def shard_ssl_state(state: SSLState, mesh, min_size: int = 2**15) -> SSLState:
    """FSDP-style cut, in place: every parameter (student and teacher) and
    moment of at least 2 dims, at least min_size elements and a leading
    axis that divides by dp keeps this rank's rows of that axis; the rest
    (and the centers) replicate. Leaves below min_size replicate, as FSDP's
    min_num_params: cutting them saves little and costs gather traffic."""
    from pope_tpu_torch.parallel.mesh import axis_rank, axis_size

    n, r = axis_size(mesh, "dp"), axis_rank(mesh, "dp")
    names = frozenset(name for name, p in state.student.named_parameters()
                      if p.ndim >= 2 and p.shape[0] % n == 0 and p.numel() >= min_size)
    state.fsdp = FSDPLayout(mesh.get_group("dp"), r, n, names)
    for s, t, name in _sharded_params(state):
        s.data = _rows(s.data, r, n).clone()
        t.data = _rows(t.data, r, n).clone()
        for moments in (state.mu, state.nu):
            moments[name] = _rows(moments[name], r, n).clone()
    return state


def ssl_state_bytes(state: SSLState) -> int:
    """Bytes this rank holds of the state: parameters, moments, centers."""
    tensors = (list(state.student.parameters()) + list(state.teacher.parameters()) + list(state.mu.values())
               + list(state.nu.values()) + [state.dino_center, state.ibot_center])
    return sum(t.numel() * t.element_size() for t in tensors)


@contextlib.contextmanager
def fsdp_gathered(state: SSLState):
    """Inside the block the state is whole on every rank (a checkpoint's
    view; every rank enters it); the shards come back on exit."""
    from pope_tpu_torch.parallel.collectives import all_gather

    saved = []
    with torch.no_grad():
        for s, t, name in _sharded_params(state):
            saved.append((s, t, name, s.data, t.data, state.mu[name], state.nu[name]))
            g = state.fsdp.group
            s.data, t.data = all_gather(s.data, g), all_gather(t.data, g)
            state.mu[name], state.nu[name] = all_gather(state.mu[name], g), all_gather(state.nu[name], g)
    try:
        yield state
    finally:
        for s, t, name, sd, td, mu, nu in saved:
            s.data, t.data, state.mu[name], state.nu[name] = sd, td, mu, nu
