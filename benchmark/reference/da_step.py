"""The adversarial v1 step (Tsai et al., CVPR 2018, single level), as the
reference RTSDS code trains it, in plain PyTorch with a written-out Adam.

Generator phase: the cross entropy of the generator's heads on the source
(void ignored), each divided by ``iterations``, backward; then the target's
main logits through the discriminator, whose parameters take no gradient:
``lambda * BCE(D(softmax), 1) / iterations``, backward; Adam.
Discriminator phase, on the detached softmax of both main logits: source
1, target 0, each BCE divided by ``iterations``; Adam with its weight
decay added to the gradient.  Frozen parameters (DeepLab's batch-norm
affines) get a zero gradient.  Both networks run in train mode.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass
class Adam:
    """``torch.optim.Adam``'s arithmetic (L2 decay added to the gradient,
    betas 0.9 and 0.999, eps 1e-8), with the learning rate passed per
    step."""
    params: dict
    weight_decay: float = 0.0
    frozen: frozenset = frozenset()
    t: int = 0

    def __post_init__(self):
        self.m = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in self.params.items()}

    def gradients(self) -> dict:
        """The gradient each parameter's update starts from: its
        gradient, zero for a frozen one."""
        return {k: torch.zeros_like(p) if k in self.frozen or p.grad is None
                else p.grad for k, p in self.params.items()}

    @torch.no_grad()
    def step(self, lr: float) -> dict:
        """One update; returns ``gradients()`` as they were before it."""
        grads = self.gradients()
        self.t += 1
        bc1 = 1 - 0.9 ** self.t
        bc2 = 1 - 0.999 ** self.t
        for k, p in self.params.items():
            g = grads[k] + self.weight_decay * p if self.weight_decay \
                else grads[k]
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            denom = (self.v[k].sqrt() / bc2 ** 0.5).add_(1e-8)
            p.addcdiv_(self.m[k], denom, value=-lr / bc1)
            p.grad = None
        return grads


def cross_entropy(logits, labels, ignore):
    total = F.cross_entropy(logits.float(), labels.long(),
                            ignore_index=ignore, reduction="sum")
    return total / (labels != ignore).sum().clamp(min=1)


def bce(logits, target: float):
    x = logits.float()
    return (x.clamp(min=0) - x * target
            + torch.log1p(torch.exp(-x.abs()))).mean()


def v1_step(gen: nn.Module, dis: nn.Module, gen_opt: Adam, dis_opt: Adam,
            src: torch.Tensor, labels: torch.Tensor, tgt: torch.Tensor,
            lam: float, iterations: int, gen_lr: float, dis_lr: float,
            ignore: int = 19, half_batch: bool = False) -> dict:
    """One step on NHWC normalized ``src`` and ``tgt`` and (N, H, W)
    ``labels``.  Returns the four losses and the gradients each Adam
    took.  ``half_batch`` is a planted fault: the step sees the first half
    of each batch only."""
    if half_batch:
        n = src.shape[0] // 2
        src, labels, tgt = src[:n], labels[:n], tgt[:n]
    gen.train()
    dis.train()
    src = src.permute(0, 3, 1, 2)
    tgt = tgt.permute(0, 3, 1, 2)
    heads = [h for h in gen(src) if h is not None]
    seg = sum(cross_entropy(h, labels, ignore) for h in heads) / iterations
    seg.backward()
    src_main = heads[0].detach()
    del heads
    for p in dis.parameters():
        p.requires_grad_(False)
    tgt_main = gen(tgt)[0]
    adv = lam * bce(dis(F.softmax(tgt_main, dim=1)), 1.0) / iterations
    adv.backward()
    for p in dis.parameters():
        p.requires_grad_(True)
    gen_grads = gen_opt.step(gen_lr)
    tgt_main = tgt_main.detach()
    d_src = bce(dis(F.softmax(src_main, dim=1)), 1.0) / iterations
    d_tgt = bce(dis(F.softmax(tgt_main, dim=1)), 0.0) / iterations
    (d_src + d_tgt).backward()
    dis_grads = dis_opt.step(dis_lr)
    return {"losses": {"loss_gen_source": float(seg.detach()),
                       "loss_adversarial": float(adv.detach()),
                       "loss_disc_source": float(d_src.detach()),
                       "loss_disc_target": float(d_tgt.detach())},
            "gen_grads": gen_grads, "dis_grads": dis_grads}
