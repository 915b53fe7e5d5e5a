"""BatchNorm with flax's training-mode statistics.

`forward(x, training=False)`: the mode is the call's flag, as in flax
(`use_running_average=not training`), not the module's `.train()` state.

  * eval: the running statistics, through the same `F.batch_norm` call as
    `nn.BatchNorm{1,2}d` in eval mode (the serving path is unchanged);
  * training: the batch's statistics normalize (biased variance, gradients
    through mean and variance), and the running statistics move by flax's
    rule, `running = m * running + (1 - m) * batch` with m = 1 - momentum
    and the BIASED batch variance.  `nn.BatchNorm` in train mode would
    update `running_var` with the unbiased variance (x n / (n - 1)).

`BatchNorm2d` (the network's, on large maps) normalizes with the fused
`F.batch_norm` and takes the running update from a float32 two-pass
variance.  `BatchNorm1d` (the bit mapper's, over N tiles) copies flax's
arithmetic literally, var = max(0, E[x^2] - E[x]^2) and
(x - mean) * (rsqrt(var + eps) * scale) + bias: the mapper's continuous bits
feed the loss, so it is held to the reference more closely.  Subclasses of
the torch modules, so `models/weights_io.py` maps them like any BatchNorm.

`data_group` (set by `parallel.mesh.reduced_over`; None = one rank): the
training statistics are the global batch's over the ranks of the group,
as the JAX program's are under `jit` (sync-BN): one collective of the
per-channel sums and the count gives the global mean, a second one the
global centered sum of squares (BatchNorm2d) or of the squares
(BatchNorm1d, flax's arithmetic), both differentiable, so the gradient
flows through the global mean and variance.  The running update is the
same rule on the global statistics, identical on every rank.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .parallel.mesh import all_sum


class _FlaxStatsMixin:
    data_group = None  # the process group of the data-parallel batch

    def _group_sums(self, *parts):
        """Each 1-D part summed over the group, in one differentiable
        collective."""
        total = all_sum(torch.cat(parts), self.data_group)
        return total.split([p.shape[0] for p in parts])

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        if not training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, self.momentum, self.eps)
        y, mean, var = self._train_forward(x)
        with torch.no_grad():
            keep = 1.0 - self.momentum  # flax's momentum
            self.running_mean.copy_(keep * self.running_mean + (1.0 - keep) * mean)
            self.running_var.copy_(keep * self.running_var + (1.0 - keep) * var)
        return y


class BatchNorm1d(_FlaxStatsMixin, nn.BatchNorm1d):
    """(N, C) BatchNorm; flax momentum m is `momentum=1 - m` here."""

    def _train_forward(self, x):
        xf = x.to(torch.float32)
        if self.data_group is None:
            mean = xf.mean(dim=0)
            mean2 = (xf * xf).mean(dim=0)
        else:
            s1, s2, n = self._group_sums(xf.sum(dim=0), (xf * xf).sum(dim=0),
                                         xf.new_full((1,), float(xf.shape[0])))
            mean, mean2 = s1 / n, s2 / n
        var = torch.maximum(mean2 - mean * mean, xf.new_zeros(()))
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y, mean.detach(), var.detach()


class BatchNorm2d(_FlaxStatsMixin, nn.BatchNorm2d):
    """(N, C, H, W) BatchNorm; flax momentum m is `momentum=1 - m` here."""

    def _train_forward(self, x):
        if self.data_group is None:
            with torch.no_grad():
                var, mean = torch.var_mean(x.to(torch.float32), dim=(0, 2, 3), correction=0)
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
            return y, mean, var
        xf = x.to(torch.float32)
        s1, n = self._group_sums(xf.sum(dim=(0, 2, 3)),
                                 xf.new_full((1,), float(xf[:, 0].numel())))
        mean = s1 / n
        d = xf - mean[None, :, None, None]
        (ss,) = self._group_sums((d * d).sum(dim=(0, 2, 3)))
        var = ss / n
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = d * inv[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(x.dtype), mean.detach(), var.detach()
