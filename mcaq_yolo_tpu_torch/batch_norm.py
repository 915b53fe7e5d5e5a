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
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class _FlaxStatsMixin:
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
        mean = xf.mean(dim=0)
        var = torch.maximum((xf * xf).mean(dim=0) - mean * mean, xf.new_zeros(()))
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y, mean.detach(), var.detach()


class BatchNorm2d(_FlaxStatsMixin, nn.BatchNorm2d):
    """(N, C, H, W) BatchNorm; flax momentum m is `momentum=1 - m` here."""

    def _train_forward(self, x):
        with torch.no_grad():
            var, mean = torch.var_mean(x.to(torch.float32), dim=(0, 2, 3), correction=0)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return y, mean, var
