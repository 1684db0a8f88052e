"""Optimizers of the port's training engine.

The JAX engine builds optax transformations (``deepspeed_tpu/runtime/
engine.py:555-632``); XLA runs them, no Pallas kernel. The port writes the
same update math as plain ``torch._foreach_*`` ops over the fp32 master
tensors, in place. Adam (either ``adam_w_mode``) and AdamW are
``optax.adamw`` — the JAX package's Adam without ``adam_w_mode`` chains
``scale_by_adam``, ``add_decayed_weights`` and ``scale_by_learning_rate``,
the same update:

    mu = b1 mu + (1 - b1) g            nu = b2 nu + (1 - b2) g^2
    mu_hat = mu / (1 - b1^(n+1))       nu_hat = nu / (1 - b2^(n+1))
    p -= lr(n) * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)

with ``n`` the count of updates applied before this one. The other
optimizer types raise ``NotImplementedError`` naming their ROADMAP item.
"""

import torch

from .constants import (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER, CPU_ADAM_OPTIMIZER,
                        ADAGRAD_OPTIMIZER, LAMB_OPTIMIZER, SGD_OPTIMIZER, LION_OPTIMIZER,
                        ONEBIT_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER, ZERO_ONE_ADAM_OPTIMIZER)

_UNPORTED = {
    ADAGRAD_OPTIMIZER: "ROADMAP Queue 1 #4, optimizers",
    LAMB_OPTIMIZER: "ROADMAP Queue 1 #4, optimizers",
    SGD_OPTIMIZER: "ROADMAP Queue 1 #4, optimizers",
    LION_OPTIMIZER: "ROADMAP Queue 1 #4, optimizers",
    ONEBIT_ADAM_OPTIMIZER: "ROADMAP Queue 1 #10, ops/adam/onebit_adam.py",
    ONEBIT_LAMB_OPTIMIZER: "ROADMAP Queue 1 #10, ops/adam/onebit_adam.py",
    ZERO_ONE_ADAM_OPTIMIZER: "ROADMAP Queue 1 #10, ops/adam/onebit_adam.py",
}


class AdamW:
    """``optax.adamw`` over a list of fp32 tensors, updated in place. The
    moments are fp32 tensors beside the parameters; ``count`` is the number
    of updates applied."""

    def __init__(self, params, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
        self.b1, self.b2, self.eps, self.weight_decay = float(b1), float(b2), float(eps), float(weight_decay)
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads, lr):
        """One update of ``params`` (in place) from ``grads`` at learning
        rate ``lr`` (a Python float)."""
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        n = self.count + 1
        denom = torch._foreach_div(self.nu, 1.0 - b2**n)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(self.mu, 1.0 - b1**n)
        torch._foreach_div_(update, denom)
        del denom
        if self.weight_decay:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_add_(params, update, alpha=-lr)
        self.count = n


def build_optimizer(opt_config, params):
    """The optimizer of the ``optimizer`` config section (default AdamW)
    over ``params``, a list of fp32 master tensors."""
    name = (opt_config.type or ADAMW_OPTIMIZER).lower()
    p = dict(opt_config.params)
    if name in _UNPORTED:
        raise NotImplementedError(f"deepspeed_tpu_torch does not support the {opt_config.type} "
                                  f"optimizer yet ({_UNPORTED[name]})")
    if name not in (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER, CPU_ADAM_OPTIMIZER):
        raise ValueError(f"Unknown optimizer type {opt_config.type}")
    betas = p.get("betas", (0.9, 0.999))
    return AdamW(params, b1=betas[0], b2=betas[1], eps=p.get("eps", 1e-8),
                 weight_decay=p.get("weight_decay", 0.0))
