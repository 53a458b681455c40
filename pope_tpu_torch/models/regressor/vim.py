"""Vision Mamba (Vim) image encoder (port of pope_tpu/models/regressor/vim.py):
a DeiT-style patch embedding with the cls token inserted in the middle of the
sequence, bidirectional Mamba blocks with RMSNorm (the backward direction
reads the flipped in_proj output), a pooled cls feature or a head. MoCoPE's
frozen image branch.

The selective scan is the linear recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t,    y_t = C_t . h_t + D u_t

which the JAX package runs as `jax.lax.associative_scan` (XLA, no Pallas
kernel). Here it runs in chunks of `chunk` steps, all chunks at once: within
a chunk the cumulative sums S_t of dt_t A are the exact logs of the products
of the decays, so every factor exp(S_t - S_s), s <= t, is at most 1 and
nothing overflows; the chunks' end states are then carried across the
chunks in a short loop, and each position adds exp(S_t) times the state its
chunk starts from. A loop over the 197 steps would be thousands of small
launches a forward.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class VimConfig:
    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 384  # vim_small; vim_tiny = 192
    depth: int = 24
    d_state: int = 16
    expand: int = 2
    d_conv: int = 4
    num_classes: int = 1000
    bidirectional: bool = True
    cls_position: str = "middle"
    dtype: str = "float32"


SCAN_CHUNK = 16  # steps per chunk: a (B, L, chunk, Din, N) f32 intermediate


def selective_scan(u, delta, A, B, C, D, chunk: int = SCAN_CHUNK):
    """The selective scan over a batch: u, delta (Bt, L, Din); A (Din, N);
    B, C (Bt, L, N); D (Din,). Returns y (Bt, L, Din), f32."""
    Bt, L, Din = u.shape
    N = A.shape[1]
    T = min(chunk, L)
    nC = -(-L // T)
    pad = nC * T - L
    u, delta, B, C = (x.float() for x in (u, delta, B, C))
    log_a = delta[..., None] * A.float()  # (Bt, L, Din, N), <= 0
    dbu = (delta * u)[..., None] * B[:, :, None, :]
    if pad:  # trailing steps that decay by 1 and add 0: earlier states are untouched
        log_a = F.pad(log_a, (0, 0, 0, 0, 0, pad))
        dbu = F.pad(dbu, (0, 0, 0, 0, 0, pad))
    log_a = log_a.view(Bt, nC, T, Din, N)
    dbu = dbu.view(Bt, nC, T, Din, N)
    S = torch.cumsum(log_a, dim=2)
    causal = torch.ones(T, T, dtype=torch.bool, device=u.device).tril()
    # decay from step s to step t of one chunk, exp(S_t - S_s) for s <= t
    decay = torch.exp((S[:, :, :, None] - S[:, :, None, :]).masked_fill(~causal[:, :, None, None], float("-inf")))
    h = (decay * dbu[:, :, None]).sum(3)  # each chunk from a zero state
    # carry the states across the chunks: the state entering chunk c
    a_end = torch.exp(S[:, :, -1])  # (Bt, nC, Din, N)
    h_in = [torch.zeros_like(a_end[:, 0])]
    for c in range(nC - 1):
        h_in.append(a_end[:, c] * h_in[-1] + h[:, c, -1])
    h = h + torch.exp(S) * torch.stack(h_in, dim=1)[:, :, None]
    y = torch.einsum("bctdn,bctn->bctd", h, F.pad(C, (0, 0, 0, pad)).view(Bt, nC, T, N))
    return y.reshape(Bt, nC * T, Din)[:, :L] + u * D.float()


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        return (self.weight * xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)).to(x.dtype)


class MambaMixer(nn.Module):
    """One selective-SSM mixer: in_proj -> causal depthwise conv1d + SiLU ->
    (dt, B, C) projections -> selective scan -> SiLU-gated out_proj; the
    backward direction (suffix _b) on the flipped in_proj output."""

    def __init__(self, d_model: int, d_state: int = 16, expand: int = 2, d_conv: int = 4,
                 bidirectional: bool = True):
        super().__init__()
        d_inner = expand * d_model
        self.d_inner, self.d_state, self.d_conv = d_inner, d_state, d_conv
        self.dt_rank = max(d_model // 16, 1)
        self.bidirectional = bidirectional
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        for s in ("", "_b") if bidirectional else ("",):
            self.add_module(f"conv1d{s}", nn.Conv1d(d_inner, d_inner, d_conv, groups=d_inner, padding=d_conv - 1))
            self.add_module(f"x_proj{s}", nn.Linear(d_inner, self.dt_rank + 2 * d_state, bias=False))
            self.add_module(f"dt_proj{s}", nn.Linear(self.dt_rank, d_inner))
            a_log = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32)).expand(d_inner, d_state).clone()
            self.register_parameter(f"A_log{s}", nn.Parameter(a_log))
            self.register_parameter(f"D{s}", nn.Parameter(torch.ones(d_inner)))
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)

    def _direction(self, xs, s: str):
        L = xs.shape[1]
        h = F.silu(getattr(self, f"conv1d{s}")(xs.transpose(1, 2))[..., :L].transpose(1, 2))
        dt, Bc, Cc = torch.split(getattr(self, f"x_proj{s}")(h), [self.dt_rank, self.d_state, self.d_state], dim=-1)
        dt = F.softplus(getattr(self, f"dt_proj{s}")(dt))
        A = -torch.exp(getattr(self, f"A_log{s}"))
        return selective_scan(h, dt, A, Bc, Cc, getattr(self, f"D{s}")).to(xs.dtype)

    def forward(self, x):
        xs, z = self.in_proj(x).chunk(2, dim=-1)
        y = self._direction(xs, "")
        if self.bidirectional:
            y = y + self._direction(xs.flip(1), "_b").flip(1)
        return self.out_proj(y * F.silu(z))


class VimBlock(nn.Module):
    def __init__(self, d_model: int, d_state: int, expand: int, d_conv: int, bidirectional: bool):
        super().__init__()
        self.norm = RMSNorm(d_model)
        self.mixer = MambaMixer(d_model, d_state, expand, d_conv, bidirectional)

    def forward(self, x):
        return x + self.mixer(self.norm(x))


class VisionMamba(nn.Module):
    """(B, H, W, 3) images -> the cls token's features (num_classes=0) or
    logits."""

    def __init__(self, config: VimConfig = VimConfig()):
        super().__init__()
        cfg = self.config = config
        if cfg.dtype != "float32":
            raise NotImplementedError(f"Vim in {cfg.dtype}: the port runs it in float32, as the regressor does")
        D, p = cfg.embed_dim, cfg.patch_size
        n = (cfg.img_size // p) ** 2 + 1
        self.patch_embed = nn.Conv2d(3, D, p, stride=p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, n, D))
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", VimBlock(D, cfg.d_state, cfg.expand, cfg.d_conv, cfg.bidirectional))
        self.norm_f = RMSNorm(D)
        self.head = nn.Linear(D, cfg.num_classes) if cfg.num_classes else None
        nn.init.normal_(self.cls_token, std=0.02)
        nn.init.normal_(self.pos_embed, std=0.02)

    def forward(self, x):
        cfg = self.config
        B = x.shape[0]
        x = self.patch_embed(x.float().permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        mid = x.shape[1] // 2
        x = torch.cat([x[:, :mid], self.cls_token.to(x.dtype).expand(B, 1, -1), x[:, mid:]], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        for i in range(cfg.depth):
            x = getattr(self, f"block_{i}")(x)
        feat = self.norm_f(x)[:, mid]
        return self.head(feat) if self.head is not None else feat
