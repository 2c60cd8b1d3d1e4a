"""AdamW as the configuration's recipe states it (``optax.adamw``'s
update ``u = -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, the moments
kept in the leaf's own type and used as stored, the update added to the
leaf in float32 and the sum stored once in the leaf's type)."""

from __future__ import annotations

import torch


class AdamW:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.wd = eps, weight_decay
        self.t = 0
        self.mu: dict = {}
        self.nu: dict = {}

    def begin_step(self) -> None:
        self.t += 1

    @torch.no_grad()
    def update(self, key, p: torch.Tensor, g: torch.Tensor) -> None:
        """Step leaf ``p`` (a slice of a stacked leaf is a leaf of its
        own here: the update is elementwise) in place by float32 ``g``."""
        if key not in self.mu:
            self.mu[key] = torch.zeros_like(p)
            self.nu[key] = torch.zeros_like(p)
        mu_, nu_ = self.mu[key], self.nu[key]
        mu_.copy_(mu_.float() * self.b1 + (1 - self.b1) * g)
        nu_.copy_(nu_.float() * self.b2 + (1 - self.b2) * g * g)
        mu_hat = mu_.float() / (1 - self.b1 ** self.t)
        nu_hat = nu_.float() / (1 - self.b2 ** self.t)
        u = mu_hat / (nu_hat.sqrt() + self.eps) + self.wd * p.float()
        p.copy_(p.float() - self.lr * u)
