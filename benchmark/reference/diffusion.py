"""The plain reference of the DDPM process, the DDIM chain and the
amortized training step, in fp32 PyTorch and float64 NumPy.

Written from "Denoising Diffusion Probabilistic Models" (arXiv:2006.11239),
"Denoising Diffusion Implicit Models" (arXiv:2010.02502), encoder reuse
from "Faster Diffusion" (arXiv:2312.09608) and the reference project's
amortized condition-dropout objective, with Adam (arXiv:1412.6980) after
clipping to a global norm and an exponential moving average of the
parameters.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def vp_alphas_cumprod(num_steps: int) -> np.ndarray:
    """alpha-bar of the discretised VP-SDE: beta_i = (0.1 + 19.9 t_i) / N on
    t_i = linspace(1e-5, 1, N), in float64."""
    ts = np.linspace(1e-5, 1.0, num_steps, dtype=np.float64)
    return np.cumprod(1.0 - (0.1 + 19.9 * ts) / num_steps)


def ddim_rows(num_steps: int, ddim_steps: int) -> np.ndarray:
    """Deterministic DDIM on the strided grid, in the chain's order (high
    noise first): rows [i, c_x0, c_dir, sqrt(abar), sr, srm1] as float32,
    with x0 = sr x - srm1 eps and x' = c_x0 x0 + c_dir (x - sqrt(abar) x0).
    """
    steps = np.arange(ddim_steps) * (num_steps // ddim_steps)
    abar = vp_alphas_cumprod(num_steps)[steps]
    prev = np.concatenate([[1.0], abar[:-1]])
    rows = np.stack([steps.astype(np.float64), np.sqrt(prev),
                     np.sqrt(1 - prev) / np.sqrt(1 - abar), np.sqrt(abar),
                     np.sqrt(1 / abar), np.sqrt(1 / abar - 1)], axis=-1)
    return rows[::-1].astype(np.float32)


def reuse_groups(n: int, k: int) -> list:
    """Steps 0..n-1 in groups of k sharing one encoder pass; a remainder
    runs first, as a shorter group."""
    rem = n % k
    return ([list(range(rem))] if rem else []) + [
        list(range(s, s + k)) for s in range(rem, n, k)]


@torch.no_grad()
def ddim_chain(model, xT: torch.Tensor, num_steps: int, ddim_steps: int,
               reuse: int) -> torch.Tensor:
    """x0 of the DDIM chain from xT (NHWC), the encoder run on the first
    step of each group of `reuse` steps and the decoder on every step; the
    model is called with t = i / num_steps."""
    rows = ddim_rows(num_steps, ddim_steps)
    x = xT.float()
    b = x.shape[0]
    for group in reuse_groups(ddim_steps, reuse):
        cache = None
        for j, k in enumerate(group):
            i, cx0, cdir, sab, sr, srm1 = (float(v) for v in rows[k])
            t = torch.full((b,), i, dtype=torch.float32,
                           device=x.device) / num_steps
            if reuse == 1:
                eps = model(x, t)
            else:
                if j == 0:
                    cache = model(x, t, mode="encode")
                eps = model(x, t, mode="decode", cache=cache)
            x0 = torch.clamp(sr * x - srm1 * eps, -1.0, 1.0)
            x = cx0 * x0 + cdir * (x - sab * x0)
    return torch.clamp(x, -1.0, 1.0)


def amortized_draws(gen: torch.Generator, batch: int, side: int,
                    channels: int, tr: dict) -> dict:
    """The draws of one amortized step, in the order the objective makes
    them: the patch origins (rows, then columns), whether the condition is
    kept (one draw per batch), the steps, the noise.

    The reference follows the system's own use of its generator: one
    stream, these five draws in this order, each of these shapes. A change
    of the system that draws the same distributions another way (in
    another order, in one batched call) changes every step's inputs, so
    the training cell reads `correct` false until this function is changed
    with it."""
    lo, hi = tr["mask_margin"], side - tr["patch_size"] - tr["mask_margin"]
    dev = gen.device
    h0 = torch.randint(lo, hi, (batch,), generator=gen, device=dev)
    w0 = torch.randint(lo, hi, (batch,), generator=gen, device=dev)
    keep = torch.rand((), generator=gen, device=dev) < tr["p_cond"]
    i = torch.randint(0, tr["diffusion_steps"], (batch,), generator=gen,
                      device=dev)
    noise = torch.randn((batch, side, side, channels), generator=gen,
                        device=dev)
    return dict(h0=h0, w0=w0, keep=keep, i=i, noise=noise)


def amortized_loss(model, x: torch.Tensor, d: dict, tr: dict,
                   abar: torch.Tensor) -> torch.Tensor:
    """mean((eps_hat - eps)^2), eps_hat of [x_i, condition] on the channel
    axis: the image with a patch set to the pad value, or (when the draw
    drops it) the pad value everywhere."""
    b, side = x.shape[0], x.shape[1]
    rows = torch.arange(side, device=x.device)
    p = tr["patch_size"]
    in_h = (rows[None] >= d["h0"][:, None]) & (rows[None] < d["h0"][:, None]
                                               + p)
    in_w = (rows[None] >= d["w0"][:, None]) & (rows[None] < d["w0"][:, None]
                                               + p)
    mask = (in_h[:, :, None] & in_w[:, None, :])[..., None]
    pad = tr["pad_value"]
    cond = torch.where(mask, torch.full_like(x, pad), x)
    cond = torch.where(d["keep"], cond, torch.full_like(x, pad))
    a = abar[d["i"]].view(b, 1, 1, 1)
    xi = a.sqrt() * x + (1 - a).sqrt() * d["noise"]
    eps = model(torch.cat([xi, cond], dim=-1),
                d["i"].float() / tr["diffusion_steps"])
    return torch.mean((eps - d["noise"]) ** 2)


def learning_rate(update: int, tr: dict) -> float:
    """Linear warm-up from 0 over `warmup` updates, then half a cosine to 0
    at `num_steps`; `update` counts from 0."""
    lr, warm = tr["learning_rate"], tr["warmup"]
    if update < warm:
        return lr * update / warm
    decay = max(tr["num_steps"], warm + 1) - warm
    return lr * 0.5 * (1 + math.cos(math.pi * min(update - warm, decay)
                                    / decay))


def ema_decay(count: int, tr: dict) -> float:
    """The EMA's blend weight d after update `count` (from 1): a blend
    e <- d e + (1 - d) p on every `ema_update_every`-th update, with d
    ramped as min(decay, (1 + count) / (10 + count)) where `ema_warmup`
    holds, and d = 1 (the EMA kept) on the others."""
    if count % tr["ema_update_every"]:
        return 1.0
    d = tr["ema_decay"]
    if tr["ema_warmup"]:
        d = min(d, (1.0 + count) / (10.0 + count))
    return d


def train(model, batches: list, gen: torch.Generator, tr: dict,
          loss_fn=amortized_loss) -> dict:
    """len(batches) steps of the amortized objective with clipping, Adam
    (b1 0.9, b2 0.999, eps 1e-8) and the EMA of the parameters (started at
    the initial ones): each step's loss, and by parameter name the first
    step's gradient after clipping (and its norm), the change of the
    parameters over all the steps and that of their EMA."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    ema = [p.detach().clone() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    abar = torch.from_numpy(vp_alphas_cumprod(tr["diffusion_steps"]).astype(
        np.float32)).to(params[0].device)
    losses, first = [], None
    for n, x in enumerate(batches):
        d = amortized_draws(gen, x.shape[0], x.shape[1], x.shape[3], tr)
        for p in params:
            p.grad = None
        loss = loss_fn(model, x, d, tr, abar)
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            grads = [p.grad for p in params]
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = tr["grad_clip"] / torch.clamp(norm, min=tr["grad_clip"])
            grads = [g * scale for g in grads]
            if first is None:
                first = dict(zip(names, (g.clone() for g in grads)))
            lr = learning_rate(n, tr)
            for p, g, mi, vi in zip(params, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = mi / (1 - b1 ** (n + 1))
                vh = vi / (1 - b2 ** (n + 1))
                p.sub_(lr * mh / (vh.sqrt() + eps))
            keep = ema_decay(n + 1, tr)
            for e, p in zip(ema, params):
                e.mul_(keep).add_(p, alpha=1 - keep)
    change = {n: p.detach() - s for n, p, s in zip(names, params, start)}
    ema_change = {n: e - s for n, e, s in zip(names, ema, start)}
    return dict(losses=losses, grads=first,
                grad_norms={n: float(g.norm()) for n, g in first.items()},
                change=change, ema_change=ema_change)
