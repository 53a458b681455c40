"""Novel-view synthesis: a per-scene NeRF (port of pope_tpu/nvs/nerf.py).

Train a radiance field on a sequence's posed source views, then
volume-render the target views: a coarse stratified pass and a fine
importance pass through the same field (inverse-CDF resampling with fixed
sample counts), the MLP's products in the config's dtype (bf16 by default)
and the integration in f32.

Randomness comes from explicit torch.Generators or from draws passed in:
`render_rays` takes the coarse jitter `u_coarse` (R, n_coarse) and the fine
pass's `u_fine` (R, n_fine), uniforms in [0, 1), and `train_nerf` each
step's ray indices with them. The JAX package draws them from threefry
keys, which torch cannot reproduce, so the parity tests pass JAX's draws.
Its `render_image` is not deterministic either: the fine pass draws `u`
from PRNGKey(0) for every chunk, so the port's takes that one (chunk,
n_fine) draw as `u_fine`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.optim.adam import adam as adam_update

from pope_tpu_torch.models.sam.encoder import dense
from pope_tpu_torch.utils.logging import get_logger


@dataclasses.dataclass(frozen=True)
class NerfConfig:
    n_freq_xyz: int = 10
    n_freq_dir: int = 4
    hidden: int = 128
    depth: int = 6
    skip_at: int = 3
    n_coarse: int = 64
    n_fine: int = 64
    lr: float = 5e-4
    ray_batch: int = 2048
    white_bkgd: bool = False
    dtype: str = "bfloat16"


def positional_encoding(x, n_freq: int):
    """[x, sin(2^k x), cos(2^k x)] for k < n_freq."""
    freqs = 2.0 ** torch.arange(n_freq, dtype=torch.float32, device=x.device)
    ang = x[..., None, :] * freqs[:, None]  # (..., n_freq, D)
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)


class NerfMLP(nn.Module):
    """(xyz (..., 3), unit viewdir (..., 3)) -> (raw sigma (..., 1), rgb
    (..., 3) in [0, 1]). Hidden layers in cfg.dtype; sigma and rgb heads in
    f32, as the JAX package's Dense(dtype=float32) heads are."""

    def __init__(self, cfg: NerfConfig = NerfConfig()):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        d_xyz = 3 + 6 * cfg.n_freq_xyz
        d_dir = 3 + 6 * cfg.n_freq_dir
        for i in range(cfg.depth):
            fan_in = d_xyz if i == 0 else cfg.hidden
            if i == cfg.skip_at:
                fan_in += d_xyz
            self.add_module(f"lin{i}", nn.Linear(fan_in, cfg.hidden))
        self.sigma = nn.Linear(cfg.hidden, 1)
        self.feat = nn.Linear(cfg.hidden, cfg.hidden)
        self.rgb_hidden = nn.Linear(cfg.hidden + d_dir, cfg.hidden // 2)
        self.rgb = nn.Linear(cfg.hidden // 2, 3)

    def forward(self, xyz, viewdir):
        cfg, dt = self.cfg, self.dtype
        h = positional_encoding(xyz, cfg.n_freq_xyz).to(dt)
        inp = h
        for i in range(cfg.depth):
            if i == cfg.skip_at:
                h = torch.cat([h, inp], dim=-1)
            h = torch.relu(dense(getattr(self, f"lin{i}"), h, dt))
        sigma = dense(self.sigma, h, torch.float32)
        feat = dense(self.feat, h, dt)
        d = positional_encoding(viewdir, cfg.n_freq_dir).to(dt)
        h = torch.relu(dense(self.rgb_hidden, torch.cat([feat, d], dim=-1), dt))
        return sigma, torch.sigmoid(dense(self.rgb, h, torch.float32))


def make_rays(K: np.ndarray, pose_w2c: np.ndarray, hw: Tuple[int, int]):
    """Pixel-center rays in world coordinates from a 3x3 K and a 3x4 / 4x4
    world->camera [R|t]. Returns origins (H, W, 3) and unit dirs (H, W, 3),
    f32 numpy."""
    H, W = hw
    R = np.asarray(pose_w2c)[:3, :3]
    t = np.asarray(pose_w2c)[:3, 3]
    cam_center = -R.T @ t
    xs, ys = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    pix = np.stack([xs, ys, np.ones_like(xs)], -1)  # (H, W, 3)
    d_cam = pix @ np.linalg.inv(np.asarray(K)).T
    d_world = d_cam @ R  # R^T d for each pixel
    d_world = d_world / np.linalg.norm(d_world, axis=-1, keepdims=True)
    origins = np.broadcast_to(cam_center, d_world.shape)
    return origins.astype(np.float32), d_world.astype(np.float32)


def _volume_render(sigma, rgb, ts, dirs_norm, white_bkgd: bool):
    """sigma (R, S, 1) raw, rgb (R, S, 3), ts (R, S) sorted depths; alpha_i =
    1 - exp(-relu(sigma) delta_i). Returns (rgb (R, 3), weights (R, S),
    depth (R,))."""
    delta = torch.diff(ts, dim=-1)
    delta = torch.cat([delta, torch.full_like(delta[..., :1], 1e10)], -1)
    delta = delta * dirs_norm[..., None]
    a = 1.0 - torch.exp(-torch.relu(sigma[..., 0]) * delta)  # (R, S)
    trans = torch.cumprod(1.0 - a + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    w = a * trans
    out = (w[..., None] * rgb).sum(dim=-2)
    acc = w.sum(dim=-1)
    depth = (w * ts).sum(dim=-1)
    if white_bkgd:
        out = out + (1.0 - acc[..., None])
    return out, w, depth


def _sample_pdf(u_draw, ts_mid, weights, n_fine: int):
    """n_fine depths importance-sampled from the coarse weights' histogram:
    bin centres jittered by `u_draw` (R, n_fine) uniforms, through the
    inverse CDF."""
    w = weights[..., 1:-1] + 1e-5  # (R, S - 2)
    pdf = w / w.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, -1)], -1)
    u = (torch.arange(n_fine, dtype=torch.float32, device=cdf.device) + 0.5) / n_fine
    u = u[None, :] + (u_draw - 0.5) / n_fine
    u = torch.clamp(u, 0.0, 1.0)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(idx - 1, 0, cdf.shape[-1] - 1)
    above = torch.clamp(idx, 0, cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(ts_mid, -1, torch.clamp(below, 0, ts_mid.shape[-1] - 1))
    bins_a = torch.gather(ts_mid, -1, torch.clamp(above, 0, ts_mid.shape[-1] - 1))
    denom = torch.where(cdf_a - cdf_b < 1e-5, torch.ones_like(cdf_a), cdf_a - cdf_b)
    frac = (u - cdf_b) / denom
    return bins_b + frac * (bins_a - bins_b)


def _uniform(shape, generator, device):
    if generator is None:
        raise ValueError("render_rays needs its uniform draws or a torch.Generator")
    return torch.rand(shape, generator=generator, device=generator.device).to(device)


def render_rays(model: NerfMLP, origins, dirs, near, far, u_coarse=None, u_fine=None,
                generator: Optional[torch.Generator] = None, deterministic: bool = False) -> Dict[str, torch.Tensor]:
    """origins / dirs (R, 3), near / far (R,) -> {"rgb" (R, 3), "rgb_coarse",
    "depth" (R,)}. A coarse stratified pass (bin midpoints when
    `deterministic`, else jittered by `u_coarse`) and a fine importance pass
    (jittered by `u_fine`) through the same field; draws not given come
    from `generator`."""
    cfg = model.cfg
    R = origins.shape[0]
    dev = origins.device
    edges = torch.linspace(0.0, 1.0, cfg.n_coarse + 1, device=dev)
    lo, hi = edges[:-1], edges[1:]
    if deterministic:
        ts = near[..., None] + (far - near)[..., None] * ((lo + hi) / 2.0)[None, :]
    else:
        u = u_coarse if u_coarse is not None else _uniform((R, cfg.n_coarse), generator, dev)
        ts = near[..., None] + (far - near)[..., None] * (lo[None] + u * (hi - lo)[None])
    dn = torch.linalg.vector_norm(dirs, dim=-1)
    dhat = dirs / dn[..., None]

    def field(ts_):
        pts = origins[:, None, :] + dirs[:, None, :] * ts_[..., None]
        return model(pts, dhat[:, None, :].expand(pts.shape))

    sigma, rgb = field(ts)
    out_c, w, _ = _volume_render(sigma, rgb, ts, dn, cfg.white_bkgd)
    if cfg.n_fine > 0:
        ts_mid = 0.5 * (ts[..., 1:] + ts[..., :-1])
        uf = u_fine if u_fine is not None else _uniform((R, cfg.n_fine), generator, dev)
        ts_f = _sample_pdf(uf, ts_mid, w.detach(), cfg.n_fine)
        ts_all = torch.sort(torch.cat([ts, ts_f], -1), dim=-1).values
        sigma, rgb = field(ts_all)
        out_f, _, depth = _volume_render(sigma, rgb, ts_all, dn, cfg.white_bkgd)
        return {"rgb": out_f, "rgb_coarse": out_c, "depth": depth}
    return {"rgb": out_c, "rgb_coarse": out_c, "depth": (w * ts).sum(-1)}


@dataclasses.dataclass
class NerfState:
    """optax.adam's state beside the model's parameters: the update count
    and the moments, keyed by parameter name."""

    step: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@torch.no_grad()
def init_nerf(cfg: NerfConfig, seed: int = 0, device=None) -> Tuple[NerfMLP, NerfState]:
    """A fresh field on `device` (default CUDA) as flax initialises one, from
    a CPU generator seeded with `seed`: lecun-normal kernels (N(0, 1) cut at
    +-2, scaled to variance 1 / fan_in), zero biases."""
    g = torch.Generator().manual_seed(seed)
    model = NerfMLP(cfg)
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            s = 1.0 / math.sqrt(mod.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(mod.weight, std=s, a=-2.0 * s, b=2.0 * s, generator=g)
            mod.bias.zero_()
    model = model.to(torch.device("cuda" if device is None else device))
    zeros = lambda: {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    return model, NerfState(0, zeros(), zeros())


def _adam_(model: NerfMLP, state: NerfState, lr: float, b1: float = 0.9, b2: float = 0.999,
           eps: float = 1e-8) -> None:
    """optax.adam(lr)'s update of the model's parameters, in place: torch.optim's
    Adam (its functional form, on the state's moments), equal to optax's to
    rounding."""
    names, params = zip(*model.named_parameters())
    steps = [torch.tensor(float(state.step)) for _ in names]  # torch.optim's CPU step counts: no device sync
    adam_update(list(params), [p.grad for p in params], [state.mu[n] for n in names],
                [state.nu[n] for n in names], [], steps, amsgrad=False, beta1=b1, beta2=b2, lr=lr,
                weight_decay=0.0, eps=eps, maximize=False)
    state.step += 1


def nerf_train_step(model: NerfMLP, state: NerfState, rays_o, rays_d, rgbs, near: float, far: float,
                    idx, u_coarse, u_fine) -> torch.Tensor:
    """One Adam step on the rays `idx` (ray_batch,) with the given draws;
    returns the loss (coarse + fine MSE) as a 0-dim tensor."""
    n = idx.shape[0]
    near_t = torch.full((n,), near, device=rays_o.device)
    far_t = torch.full((n,), far, device=rays_o.device)
    out = render_rays(model, rays_o[idx], rays_d[idx], near_t, far_t, u_coarse, u_fine)
    tgt = rgbs[idx]
    loss = ((out["rgb"] - tgt) ** 2).mean() + ((out["rgb_coarse"] - tgt) ** 2).mean()
    model.zero_grad(set_to_none=True)
    loss.backward()
    with torch.no_grad():
        _adam_(model, state, model.cfg.lr)
    model.zero_grad(set_to_none=True)
    return loss.detach()


def train_nerf(model: NerfMLP, state: NerfState, rays_o, rays_d, rgbs, near: float, far: float, n_steps: int,
               generator: Optional[torch.Generator] = None, draws: Optional[dict] = None,
               log_every: int = 0) -> NerfState:
    """Fit the field on flattened source-view rays (N, 3) / (N, 3) / (N, 3)
    on the model's device. Each step's ray indices and uniforms come from
    `draws` ({"idx": (n_steps, ray_batch), "u_coarse": (n_steps, ray_batch,
    n_coarse), "u_fine": (n_steps, ray_batch, n_fine)}) or, when None, from
    `generator` (one on the model's device draws there, with no copy a
    step). Updates the model in place; returns the state."""
    cfg = model.cfg
    dev = rays_o.device
    N = rays_o.shape[0]
    rb = cfg.ray_batch
    if draws is not None:  # on the device in one copy each, not one a step
        draws = {k: torch.as_tensor(np.asarray(draws[k])).to(dev) for k in ("idx", "u_coarse", "u_fine")}
    for i in range(n_steps):
        if draws is not None:
            idx, uc, uf = draws["idx"][i], draws["u_coarse"][i], draws["u_fine"][i]
        else:
            if generator is None:
                raise ValueError("train_nerf needs its draws or a torch.Generator")
            idx = torch.randint(0, N, (rb,), generator=generator, device=generator.device).to(dev)
            uc = _uniform((rb, cfg.n_coarse), generator, dev)
            uf = _uniform((rb, cfg.n_fine), generator, dev)
        loss = nerf_train_step(model, state, rays_o, rays_d, rgbs, near, far, idx.long(), uc, uf)
        if log_every and (i + 1) % log_every == 0:
            mse = float(loss)
            get_logger("pope_tpu_torch.nvs").info(
                "nerf step %d/%d mse=%.5f psnr=%.2f", i + 1, n_steps, mse, -10 * np.log10(max(mse / 2, 1e-10)))
    return state


@torch.no_grad()
def render_image(model: NerfMLP, K, pose_w2c, hw, near: float, far: float, chunk: int = 4096,
                 u_fine=None) -> np.ndarray:
    """A full (H, W, 3) view in [0, 1] as numpy: bin-midpoint coarse
    samples; the fine pass jittered by `u_fine` (chunk, n_fine), the same
    draw for every chunk, by default from a CPU generator seeded with 0."""
    H, W = hw
    dev = next(model.parameters()).device
    o, d = make_rays(K, pose_w2c, hw)
    o = torch.from_numpy(o.reshape(-1, 3)).to(dev)
    d = torch.from_numpy(d.reshape(-1, 3)).to(dev)
    n = o.shape[0]
    pad = (-n) % chunk
    o = torch.cat([o, torch.zeros(pad, 3, device=dev)])
    d = torch.cat([d, torch.ones(pad, 3, device=dev)])
    if u_fine is None:
        u_fine = torch.rand(chunk, model.cfg.n_fine, generator=torch.Generator().manual_seed(0))
    u_fine = torch.as_tensor(np.asarray(u_fine)).to(dev)
    near_t = torch.full((chunk,), near, device=dev)
    far_t = torch.full((chunk,), far, device=dev)
    outs = [render_rays(model, o[i:i + chunk], d[i:i + chunk], near_t, far_t, u_fine=u_fine, deterministic=True)["rgb"]
            for i in range(0, n + pad, chunk)]
    img = torch.cat(outs, 0)[:n].reshape(H, W, 3)
    return img.clamp(0.0, 1.0).cpu().numpy()
