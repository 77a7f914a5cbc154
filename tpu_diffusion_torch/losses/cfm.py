"""Conditional flow matching probability paths and minibatch couplings, in
PyTorch.

Counterpart of `tpu_diffusion/losses/cfm.py` (the `torchcfm` API the
reference trains with, `cifar10/train_cifar10.py:126-137`):

  * `icfm`  — independent-coupling CFM (Tong et al.),
  * `otcfm` — exact minibatch-OT coupling,
  * `fm`    — Lipman et al. target flow matching,
  * `si`    — variance-preserving stochastic interpolant,
  * `sbcfm` — Schrödinger-bridge CFM (entropic-OT coupling, Brownian-bridge
              path).

All matchers expose
    sample_location_and_conditional_flow(generator, x0, x1, t=None,
                                         eps=None) -> (t, x_t, u_t)
on batched tensors of any rank. Randomness comes from the explicit
`torch.Generator`; `t` and the path noise `eps` may be passed instead of
drawn (the tests replay the JAX package's draws that way).

Exact OT is a host combinatorial solve (`scipy.optimize.
linear_sum_assignment`: for uniform minibatch marginals the exact plan is a
permutation). `host_ot_pairs` pairs (noise, data) on the host between
steps, on a prefetch thread; `exact_ot_permutation` solves inside a step
(one device-to-host copy of the cost matrix); `sinkhorn_assignment` is
entropic OT on the device. `sample_location_and_conditional_flow_with_eps`
also returns the path noise (the SF2M score head's target),
`guided_sample_location_and_conditional_flow` carries class labels along
with x1 (reordered with it by a coupling), and the SB matcher's
`compute_lambda` weighs the score loss (`cli/train_conditional_mnist.py`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def _pad_t(t: Tensor, ndim: int) -> Tensor:
    return t.reshape(t.shape + (1,) * (ndim - t.ndim))


@dataclass(frozen=True)
class ConditionalFlowMatcher:
    """I-CFM: straight path between independently coupled (x0, x1).

    mu_t = t x1 + (1-t) x0,  sigma_t = sigma,  u_t = x1 - x0.
    """

    sigma: float = 0.0

    def sample_t(self, generator: Optional[torch.Generator], batch: int,
                 device) -> Tensor:
        return torch.rand(batch, generator=generator, device=device)

    def compute_mu_t(self, x0: Tensor, x1: Tensor, t: Tensor) -> Tensor:
        t = _pad_t(t, x0.ndim)
        return t * x1 + (1 - t) * x0

    def compute_sigma_t(self, t: Tensor) -> Tensor:
        return torch.full_like(t, self.sigma)

    def compute_conditional_flow(self, x0: Tensor, x1: Tensor, t: Tensor,
                                 xt: Tensor) -> Tensor:
        del t, xt
        return x1 - x0

    def sample_xt(self, generator: Optional[torch.Generator], x0: Tensor,
                  x1: Tensor, t: Tensor, eps: Optional[Tensor] = None
                  ) -> Tensor:
        mu = self.compute_mu_t(x0, x1, t)
        sig = _pad_t(self.compute_sigma_t(t), x0.ndim)
        if eps is None:
            eps = torch.randn(x0.shape, generator=generator,
                              device=x0.device, dtype=x0.dtype)
        return mu + sig * eps

    def sample_location_and_conditional_flow(
            self, generator: Optional[torch.Generator], x0: Tensor,
            x1: Tensor, t: Optional[Tensor] = None,
            eps: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
        if t is None:
            t = self.sample_t(generator, x0.shape[0], x0.device)
        xt = self.sample_xt(generator, x0, x1, t, eps)
        ut = self.compute_conditional_flow(x0, x1, t, xt)
        return t, xt, ut

    def sample_location_and_conditional_flow_with_eps(
            self, generator: Optional[torch.Generator], x0: Tensor,
            x1: Tensor, t: Optional[Tensor] = None,
            eps: Optional[Tensor] = None
    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """(t, x_t, u_t, eps): also the path noise, the target of the SF2M
        score head (conditional_mnist.ipynb cells 9-11)."""
        if t is None:
            t = self.sample_t(generator, x0.shape[0], x0.device)
        if eps is None:
            eps = torch.randn(x0.shape, generator=generator,
                              device=x0.device, dtype=x0.dtype)
        t, xt, ut = ConditionalFlowMatcher.sample_location_and_conditional_flow(
            self, generator, x0, x1, t, eps)
        return t, xt, ut, eps

    def guided_sample_location_and_conditional_flow(
            self, generator: Optional[torch.Generator], x0: Tensor,
            x1: Tensor, y1: Tensor, t: Optional[Tensor] = None,
            eps: Optional[Tensor] = None
    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """(t, x_t, u_t, y1): class labels ride along with x1 (torchcfm's
        guided_* of conditional_mnist.ipynb); a coupling that reorders x1
        reorders y1 identically."""
        t, xt, ut = self.sample_location_and_conditional_flow(
            generator, x0, x1, t, eps)
        return t, xt, ut, y1


@dataclass(frozen=True)
class TargetConditionalFlowMatcher(ConditionalFlowMatcher):
    """Lipman et al. flow matching toward a standard-normal source.

    mu_t = t x1,  sigma_t = 1 - (1 - sigma) t,
    u_t = (x1 - (1 - sigma) x_t) / (1 - (1 - sigma) t).
    """

    def compute_mu_t(self, x0: Tensor, x1: Tensor, t: Tensor) -> Tensor:
        del x0
        return _pad_t(t, x1.ndim) * x1

    def compute_sigma_t(self, t: Tensor) -> Tensor:
        return 1.0 - (1.0 - self.sigma) * t

    def compute_conditional_flow(self, x0: Tensor, x1: Tensor, t: Tensor,
                                 xt: Tensor) -> Tensor:
        del x0
        t = _pad_t(t, x1.ndim)
        return (x1 - (1.0 - self.sigma) * xt) / (1.0 - (1.0 - self.sigma) * t)


@dataclass(frozen=True)
class VariancePreservingConditionalFlowMatcher(ConditionalFlowMatcher):
    """Trig stochastic interpolant (Albergo & Vanden-Eijnden).

    mu_t = cos(pi t / 2) x0 + sin(pi t / 2) x1,
    u_t = pi/2 (cos(pi t / 2) x1 - sin(pi t / 2) x0).
    """

    def compute_mu_t(self, x0: Tensor, x1: Tensor, t: Tensor) -> Tensor:
        a = math.pi / 2 * _pad_t(t, x0.ndim)
        return torch.cos(a) * x0 + torch.sin(a) * x1

    def compute_conditional_flow(self, x0: Tensor, x1: Tensor, t: Tensor,
                                 xt: Tensor) -> Tensor:
        del xt
        a = math.pi / 2 * _pad_t(t, x0.ndim)
        return math.pi / 2 * (torch.cos(a) * x1 - torch.sin(a) * x0)


# ---------------------------------------------------------------------------
# Minibatch couplings
# ---------------------------------------------------------------------------


def _lsa_permutation(cost: np.ndarray) -> np.ndarray:
    from scipy.optimize import linear_sum_assignment
    _, col = linear_sum_assignment(cost)
    return col.astype(np.int32)


def _cost(x0: Tensor, x1: Tensor) -> Tensor:
    """Squared distances between the flattened rows, fp32."""
    b = x0.shape[0]
    f0 = x0.reshape(b, -1).float()
    f1 = x1.reshape(b, -1).float()
    return ((f0 ** 2).sum(-1)[:, None] + (f1 ** 2).sum(-1)[None, :]
            - 2.0 * f0 @ f1.T)


def exact_ot_permutation(x0: Tensor, x1: Tensor) -> Tensor:
    """The permutation `p` minimizing sum_i ||x0[i] - x1[p[i]]||^2 (exact
    OT between uniform minibatches): the cost on the tensors' device, the
    assignment on the host (a synchronisation)."""
    perm = _lsa_permutation(_cost(x0, x1).cpu().numpy())
    return torch.from_numpy(perm).long().to(x0.device)


def numpy_ot_permutation(x0: np.ndarray, x1: np.ndarray) -> np.ndarray:
    """Exact OT assignment computed entirely on the host (numpy + scipy);
    used by `host_ot_pairs` to pair batches outside the train step."""
    b = x0.shape[0]
    f0 = np.asarray(x0, np.float32).reshape(b, -1)
    f1 = np.asarray(x1, np.float32).reshape(b, -1)
    cost = ((f0**2).sum(1)[:, None] + (f1**2).sum(1)[None, :]
            - 2.0 * f0 @ f1.T)
    return _lsa_permutation(cost)


def host_ot_pairs(batches, seed: int = 0, prefetch: int = 2):
    """Wrap a data-batch iterator with host-side exact-OT noise pairing.

    Yields numpy (x0, x1[perm]) tuples where x0 ~ N(0, I) and perm is the
    exact minibatch-OT assignment. Feed the pairs to a loss built with
    `make_cfm_loss_fn(..., paired=True)` over an I-CFM matcher: after
    pairing, OT-CFM *is* I-CFM on the paired batch.

    `prefetch` > 0 computes that many paired batches ahead on a background
    thread, overlapping the assignment solve (cost matmul + LSA) with the
    device step; `prefetch=0` pairs synchronously in the caller's thread.
    """

    def paired():
        rng = np.random.default_rng(seed)
        for x1 in batches:
            x1 = np.asarray(x1)
            x0 = rng.standard_normal(x1.shape).astype(np.float32)
            perm = numpy_ot_permutation(x0, x1)
            yield x0, x1[perm]

    if prefetch <= 0:
        yield from paired()
        return

    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put_or_stop(msg) -> bool:
        # bounded put with a stop check: when the consumer abandons the
        # generator (trainer done, early break) the worker must exit
        # instead of blocking on a full queue forever, pinning the source
        # iterator and computing solves for nobody. Applies to the
        # terminal ("end"/"err") puts too.
        while not stop.is_set():
            try:
                q.put(msg, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in paired():
                if not put_or_stop(("data", item)):
                    return
            put_or_stop(("end", None))
        except BaseException as e:  # surface worker failures in the consumer
            put_or_stop(("err", e))

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            tag, item = q.get()
            if tag == "err":
                raise item
            if tag == "end":
                return
            yield item
    finally:
        stop.set()  # GeneratorExit / normal return: shut the worker down


def sinkhorn_assignment(x0: Tensor, x1: Tensor, reg: float = 0.05,
                        num_iters: int = 50,
                        generator: Optional[torch.Generator] = None
                        ) -> Tensor:
    """Entropic OT on the tensors' device: per row, a column sampled from
    the plan with `generator` (its argmax without one). The cost matrix is
    normalized by its max for scale-free regularization."""
    b = x0.shape[0]
    cost = _cost(x0, x1)
    cost = cost / (cost.abs().max() + 1e-8)
    logk = -cost / reg
    logu = torch.zeros(b, device=x0.device)
    logv = torch.zeros(b, device=x0.device)
    log_marg = -math.log(b)
    for _ in range(num_iters):
        logu = log_marg - torch.logsumexp(logk + logv[None, :], dim=1)
        logv = log_marg - torch.logsumexp(logk + logu[:, None], dim=0)
    logp = logk + logu[:, None] + logv[None, :]
    if generator is None:
        return torch.argmax(logp, dim=1)
    return torch.multinomial(torch.softmax(logp, dim=1), 1,
                             generator=generator)[:, 0]


@dataclass(frozen=True)
class ExactOptimalTransportConditionalFlowMatcher(ConditionalFlowMatcher):
    """OT-CFM: reorder the minibatch by the OT plan, then I-CFM.

    `method="exact"`: the assignment on the host inside the step;
    `method="sinkhorn"`: entropic OT on the device.
    """

    method: str = "exact"
    reg: float = 0.05

    def plan(self, generator: Optional[torch.Generator], x0: Tensor,
             x1: Tensor) -> Tensor:
        """The permutation of x1 that pairs it with x0."""
        if self.method == "exact":
            return exact_ot_permutation(x0, x1)
        return sinkhorn_assignment(x0, x1, reg=self.reg, generator=generator)

    def pair(self, generator: Optional[torch.Generator], x0: Tensor,
             x1: Tensor) -> Tuple[Tensor, Tensor]:
        return x0, x1[self.plan(generator, x0, x1)]

    def sample_location_and_conditional_flow(
            self, generator, x0, x1, t=None, eps=None):
        x0, x1 = self.pair(generator, x0, x1)
        return super().sample_location_and_conditional_flow(
            generator, x0, x1, t, eps)

    def guided_sample_location_and_conditional_flow(
            self, generator, x0, x1, y1, t=None, eps=None):
        perm = self.plan(generator, x0, x1)
        t, xt, ut = ConditionalFlowMatcher.sample_location_and_conditional_flow(
            self, generator, x0, x1[perm], t, eps)
        return t, xt, ut, y1[perm]


@dataclass(frozen=True)
class SchrodingerBridgeConditionalFlowMatcher(ConditionalFlowMatcher):
    """SB-CFM (entropic-OT coupling + Brownian-bridge path).

    sigma_t = sigma sqrt(t (1 - t));
    u_t = (1 - 2t) / (2 t (1-t)) (x_t - mu_t) + x1 - x0;
    the coupling is sinkhorn with reg = 2 sigma^2.
    """

    sigma: float = 1.0

    def compute_sigma_t(self, t: Tensor) -> Tensor:
        return self.sigma * torch.sqrt(t * (1.0 - t))

    def compute_conditional_flow(self, x0: Tensor, x1: Tensor, t: Tensor,
                                 xt: Tensor) -> Tensor:
        tb = _pad_t(t, x0.ndim)
        mu = self.compute_mu_t(x0, x1, t)
        bridge = (1.0 - 2.0 * tb) / (2.0 * tb * (1.0 - tb) + 1e-8) * (xt - mu)
        return bridge + x1 - x0

    def compute_lambda(self, t: Tensor) -> Tensor:
        """The SF2M score loss's weight 2 sigma_t / sigma^2."""
        return 2.0 * self.compute_sigma_t(t) / (self.sigma**2 + 1e-8)

    def _couple(self, generator, x0: Tensor, x1: Tensor) -> Tensor:
        return x1[sinkhorn_assignment(x0, x1, reg=2 * self.sigma**2,
                                      generator=generator)]

    def sample_location_and_conditional_flow(
            self, generator, x0, x1, t=None, eps=None):
        return super().sample_location_and_conditional_flow(
            generator, x0, self._couple(generator, x0, x1), t, eps)

    def sample_location_and_conditional_flow_with_eps(
            self, generator, x0, x1, t=None, eps=None):
        return super().sample_location_and_conditional_flow_with_eps(
            generator, x0, self._couple(generator, x0, x1), t, eps)


MATCHERS = {
    "icfm": ConditionalFlowMatcher,
    "otcfm": ExactOptimalTransportConditionalFlowMatcher,
    "fm": TargetConditionalFlowMatcher,
    "si": VariancePreservingConditionalFlowMatcher,
    "sbcfm": SchrodingerBridgeConditionalFlowMatcher,
}


def get_matcher(name: str, sigma: float = 0.0, **kw) -> ConditionalFlowMatcher:
    """Factory matching the reference's selection block
    (cifar10/train_cifar10.py:126-137)."""
    if name not in MATCHERS:
        raise NotImplementedError(
            f"Unknown matcher {name!r}; expected one of {sorted(MATCHERS)}")
    if name == "sbcfm" and sigma <= 0:
        # the Schrödinger-bridge coupling's sinkhorn regularization is
        # 2*sigma^2: sigma=0 divides the cost matrix by zero and silently
        # corrupts every pairing
        raise ValueError(
            f"sbcfm requires sigma > 0 (got {sigma}); the entropic OT "
            f"coupling uses reg = 2*sigma^2")
    return MATCHERS[name](sigma=sigma, **kw)


def host_read(matcher: ConditionalFlowMatcher) -> Optional[str]:
    """Why a training step over `matcher` cannot be captured as a CUDA
    graph (`train/graph.py`): the reason where its coupling reads the host
    inside the step, else None. The loss factories set it as the loss's
    `eager_reason`, which keeps the Trainer on the eager loop."""
    if (isinstance(matcher, ExactOptimalTransportConditionalFlowMatcher)
            and matcher.method == "exact"):
        return ("exact OT inside the step: the assignment is solved on the "
                "host (losses/cfm.py:exact_ot_permutation)")
    return None


def cfm_loss(vt: Tensor, ut: Tensor) -> Tensor:
    """The CFM regression objective mean((v - u)^2)
    (cifar10/train_cifar10.py:148-149)."""
    return torch.mean((vt - ut) ** 2)
