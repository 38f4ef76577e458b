"""The plain reference's shared math: preprocessing, log-densities, the
exemplar prior over a whole bank (blocks of rows, each a full logsumexp),
AdamNormGrad, and the three-step training follow and the IWAE that every
family runs. A frozen copy of tools/torch_twin.py's math, moved onto a
device and into blocks; it imports nothing of the port or the JAX
package."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30
LOGISTIC_EPS = 1e-7
BERNOULLI_EPS = 1e-5
PRIOR_LOG_VAR_RANGE = (-8.0, 8.0)
P_LOGVAR_RANGE = (-4.5, 0.0)


def preprocess(x_raw, input_type: str, u=None):
    """Training preprocessing with the uniforms ``u`` (a Bernoulli sample
    of the gray levels; uint8 dequantized by (x + u) / 256), or the
    evaluation one without (gray levels as they are; (x + 0.5) / 256)."""
    if x_raw.dtype == torch.uint8:
        return (x_raw.float() + (0.5 if u is None else u)) / 256.0
    x = x_raw.float()
    if input_type == "binary" and u is not None:
        return (u < x).float()
    return x


def log_normal(z, mean, logvar):
    return torch.sum(-0.5 * (logvar + (z - mean) ** 2 * torch.exp(-logvar)),
                     dim=-1)


def log_bernoulli(x, probs):
    pc = probs.clamp(BERNOULLI_EPS, 1.0 - BERNOULLI_EPS)
    return torch.sum(x * pc.log() + (1.0 - x) * (1.0 - pc).log(), dim=-1)


def log_logistic_256(x, mean, logvar):
    bin_size = 1.0 / 256.0
    scale = torch.exp(logvar)
    xs = (torch.floor(x / bin_size) * bin_size - mean) / scale
    cdf_plus = torch.sigmoid(xs + bin_size / scale)
    cdf_minus = torch.sigmoid(xs)
    return torch.sum(torch.log(cdf_plus - cdf_minus + LOGISTIC_EPS), dim=-1)


def exemplar_logits(z, means, log_var):
    """(B, N) log N(z_b; mu_n, sigma^2 I) without the 2 pi constant."""
    sq = torch.clamp(torch.sum(z * z, dim=-1, keepdim=True)
                     + torch.sum(means * means, dim=-1)[None, :]
                     - 2.0 * (z @ means.T), min=0.0)
    return -0.5 * (z.shape[-1] * log_var + sq * torch.exp(-log_var))


def exact_log_prior(z, means, log_var, log_denom, *, data_idx=None,
                    bank_idx=None, block: int = 0):
    """log p(z | whole bank): logsumexp over all N exemplars, the
    leave-one-out mask where ``data_idx`` is given, minus ``log_denom``;
    ``block`` rows of z at a time (0: all)."""
    b = z.shape[0]
    step = block or b
    out = []
    for s in range(0, b, step):
        logits = exemplar_logits(z[s:s + step], means, log_var)
        if data_idx is not None:
            logits = logits.masked_fill(
                data_idx[s:s + step, None] == bank_idx[None, :], NEG_INF)
        out.append(torch.logsumexp(logits, dim=-1))
    return torch.cat(out) - log_denom


def rows_log_prior(z, means_bk, log_var, log_denom, loo_mask):
    """log p(z_b | its K selected exemplars), the full-set denominator;
    ``loo_mask`` (B, K) True where the exemplar is the point itself."""
    sq = torch.sum((z[:, None, :] - means_bk) ** 2, dim=-1)
    logits = -0.5 * (z.shape[-1] * log_var + sq * torch.exp(-log_var))
    logits = logits.masked_fill(loo_mask, NEG_INF)
    return torch.logsumexp(logits, dim=-1) - log_denom


class AdamNormGrad:
    """The reference optimizer: each leaf's gradient L2-normalized, then
    the old-torch Adam form (denominator sqrt(v) + eps, the step scaled by
    sqrt(1 - b2^t) / (1 - b1^t))."""

    def __init__(self, params: dict, lr: float, b1=0.9, b2=0.999, eps=1e-8,
                 norm_eps=1e-7):
        self.p, self.lr, self.b1, self.b2 = params, lr, b1, b2
        self.eps, self.norm_eps, self.t = eps, norm_eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self):
        self.t += 1
        size = (self.lr * (1 - self.b2 ** self.t) ** 0.5
                / (1 - self.b1 ** self.t))
        for k, t in self.p.items():
            if t.grad is None:
                continue
            g = t.grad / (t.grad.norm() + self.norm_eps)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            t.sub_(size * self.m[k] / (self.v[k].sqrt() + self.eps))


class Family:
    """A model family's reference over a flat dict of flax-named leaves.
    Subclasses give ``param_spec``, ``batch_loss`` (the mean training
    loss of a batch) and ``iwae_log_weights`` (one round's log importance
    weights of the encode-once IWAE)."""

    def __init__(self, cfg: dict, params: dict):
        self.cfg = cfg
        self.p = params
        self.opt = AdamNormGrad(params, cfg["lr"])
        self.cache = None

    # --- shared pieces over the flax layout (y = x @ W + b) ---
    def dense(self, x, name):
        return x @ self.p[f"{name}/kernel"] + self.p[f"{name}/bias"]

    def gated(self, x, name):
        h = x @ self.p[f"{name}/h_kernel"] + self.p[f"{name}/h_bias"]
        g = x @ self.p[f"{name}/g_kernel"] + self.p[f"{name}/g_bias"]
        return h * torch.sigmoid(g)

    def q_logvar(self, h, name):
        return torch.clamp(self.dense(h, name), self.cfg["q_logvar_min"], 2.0)

    def prior_log_var(self):
        return torch.clamp(self.p["prior_log_var"], *PRIOR_LOG_VAR_RANGE)

    def bank_means(self, images, block: int):
        """The bank's posterior means in blocks, no gradient (the eval bank
        and the approximate prior's cache)."""
        with torch.no_grad():
            return torch.cat([self.encode_mean(preprocess(
                images[s:s + block], self.cfg["input_type"]))
                for s in range(0, images.shape[0], block)])

    # --- training ---
    def train_steps(self, batches, bank: dict, beta: float, rows=None):
        """Follow the program's first steps: ``batches`` is a list of
        (x_raw, u, eps, data_idx). Returns (losses, the first step's
        gradient per leaf). ``rows`` (a slice) keeps only those rows of
        every batch: the half-batch fault."""
        losses, first = [], None
        for x_raw, u, eps, data_idx in batches:
            if rows is not None:
                x_raw, u, data_idx = x_raw[rows], u[rows], data_idx[rows]
                eps = tuple(e[rows] for e in eps)
            for t in self.p.values():
                t.grad = None
            loss = self.batch_loss(x_raw, u, eps, data_idx, bank, beta)
            loss.backward()
            if first is None:
                first = {k: t.grad.detach().clone() for k, t in self.p.items()
                         if t.grad is not None}
            self.opt.step()
            losses.append(float(loss.detach()))
        return losses, first

    def exemplar_denominator(self, bank: dict, train: bool) -> float:
        n = float(bank["n"])
        return math.log(n - 1.0) if train else math.log(n)

    # --- evaluation ---
    @torch.no_grad()
    def iwae_nll(self, x_raw, eps, bank_means, n_bank: int, block: int):
        """(t,) per-point NLLs of one request: ``eps`` a tuple of
        (rounds, t*r, width) noise tensors, the rows point-major (each
        point's r samples together); an online logsumexp over rounds."""
        x = preprocess(x_raw, self.cfg["input_type"])
        t = x.shape[0]
        rounds, tr = eps[0].shape[:2]
        r = tr // t
        enc = self.encode_once(x.reshape(t, -1))
        m = torch.full((t,), NEG_INF, device=x.device)
        s = torch.zeros((t,), device=x.device)
        log_denom = math.log(float(n_bank))
        for i in range(rounds):
            a = torch.cat([self.iwae_log_weights(
                x.reshape(t, -1), enc, tuple(e[i, lo:lo + block] for e in eps),
                lo, r, bank_means, log_denom, block)
                for lo in range(0, tr, block)]).reshape(t, r)
            m_new = torch.maximum(m, a.max(dim=1).values)
            s = s * torch.exp(m - m_new) + torch.exp(a - m_new[:, None]).sum(1)
            m = m_new
        return -(m + torch.log(s) - math.log(rounds * r))


def rows_of(tensor, lo: int, n: int, r: int):
    """Rows lo .. lo + n of ``tensor`` repeated r times each (point-major),
    without building the whole repeat."""
    first, last = lo // r, (lo + n - 1) // r
    rep = torch.repeat_interleave(tensor[first:last + 1], r, dim=0)
    off = lo - first * r
    return rep[off:off + n]
