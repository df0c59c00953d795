"""ResNet-20 (CIFAR-10 variant, He et al. '16) with GroupNorm(8) — the
paper's test model.  Port of ``src/repro/models/resnet.py``.

The public functions keep the reference's layouts so the tests compare
like with like: images are NHWC, conv weights are HWIO, and params are a
flat dict whose names are the reference's key paths (``"s1b0.conv1"``,
``"s1b0.gn1.scale"``, ``"head.w"``).  :class:`ResNet20` registers exactly
those names; :func:`resnet20_apply` runs it with
``torch.func.functional_call`` on a parameter-free template, so the same
function serves a single worker and, under ``torch.func.vmap``, K stacked
workers.

Convolutions reproduce XLA's "SAME" padding: for a stride-2 3×3 conv on an
even input that is (0, 1) per spatial dim, not PyTorch's symmetric 1, so
those convs pad explicitly.  GroupNorm uses contiguous channel groups,
biased variance and eps 1e-5, which is ``F.group_norm`` on NCHW.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.tree import leaf_order

__all__ = ["ResNet20", "resnet20_init", "resnet20_apply", "resnet20_loss"]

_GROUPS = 8


def _conv(x, w_hwio, stride: int = 1):
    """NCHW conv with an HWIO weight and XLA "SAME" padding."""
    k = w_hwio.shape[0]
    pads = []
    for size in x.shape[-2:]:
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads.append((total // 2, total - total // 2))
    (top, bottom), (left, right) = pads
    w = w_hwio.permute(3, 2, 0, 1)
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def _conv_param(k: int, cin: int, cout: int, device) -> nn.Parameter:
    return nn.Parameter(torch.empty((k, k, cin, cout), device=device))


class _GroupNorm(nn.Module):
    def __init__(self, c: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty((c,), device=device))
        self.bias = nn.Parameter(torch.empty((c,), device=device))

    def forward(self, x):
        return F.group_norm(x, min(_GROUPS, x.shape[1]), self.scale,
                            self.bias, eps=1e-5)


class _Block(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, device=None):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv_param(3, cin, cout, device)
        self.gn1 = _GroupNorm(cout, device)
        self.conv2 = _conv_param(3, cout, cout, device)
        self.gn2 = _GroupNorm(cout, device)
        if cin != cout:
            self.proj = _conv_param(1, cin, cout, device)

    def forward(self, x):
        h = F.relu(self.gn1(_conv(x, self.conv1, self.stride)))
        h = self.gn2(_conv(h, self.conv2))
        sc = _conv(x, self.proj, self.stride) if hasattr(self, "proj") else x
        return F.relu(h + sc)


class _Head(nn.Module):
    def __init__(self, cin: int, num_classes: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty((cin, num_classes), device=device))
        self.b = nn.Parameter(torch.empty((num_classes,), device=device))

    def forward(self, h):
        return h @ self.w + self.b


class ResNet20(nn.Module):
    """ResNet-20 on NHWC images; parameters named as the reference's."""

    def __init__(self, width: int = 16, num_classes: int = 10, device=None):
        super().__init__()
        self.stem = _conv_param(3, 3, width, device)
        self.gn0 = _GroupNorm(width, device)
        widths = [width, 2 * width, 4 * width]
        for si, wo in enumerate(widths):
            cin = width if si == 0 else widths[si - 1]
            for bi in range(3):
                stride = 2 if (si > 0 and bi == 0) else 1
                self.add_module(f"s{si}b{bi}", _Block(
                    cin if bi == 0 else wo, wo, stride, device))
        self.head = _Head(4 * width, num_classes, device)

    def forward(self, x_nhwc):
        """x: (n, 32, 32, 3) -> logits (n, classes)."""
        h = x_nhwc.permute(0, 3, 1, 2)
        h = F.relu(self.gn0(_conv(h, self.stem)))
        for si in range(3):
            for bi in range(3):
                h = getattr(self, f"s{si}b{bi}")(h)
        return self.head(h.mean(dim=(2, 3)))


@functools.lru_cache(maxsize=None)
def _template(width: int, num_classes: int) -> ResNet20:
    """A parameter-free (meta-device) module for ``functional_call``."""
    return ResNet20(width, num_classes, device="meta")


def resnet20_init(generator: torch.Generator, num_classes: int = 10,
                  width: int = 16, device="cuda") -> dict:
    """Fresh params, drawn from ``generator`` on its own device in leaf
    order and moved to ``device``: convs He-normal (std √(2/fan_in)), the
    head normal with std (4·width)^-½, GroupNorm scale 1 and bias 0."""
    device = resolve_device(device)
    shapes = dict(_template(width, num_classes).named_parameters())
    params = {}
    for name in leaf_order(shapes):
        shape = tuple(shapes[name].shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            t = torch.ones(shape)
        elif leaf in ("bias", "b"):
            t = torch.zeros(shape)
        else:
            t = torch.randn(shape, generator=generator,
                            device=generator.device)
            if name == "head.w":
                t = t * shape[0] ** -0.5
            else:                              # HWIO conv: fan_in = k·k·cin
                t = t * (2.0 / (shape[0] * shape[1] * shape[2])) ** 0.5
        params[name] = t.to(device=device, dtype=torch.float32)
    return params


def resnet20_apply(params: dict, x):
    """x: (n, 32, 32, 3) NHWC -> logits (n, classes)."""
    width = params["stem"].shape[-1]
    num_classes = params["head.b"].shape[-1]
    return torch.func.functional_call(_template(width, num_classes), params,
                                      (x,))


def resnet20_loss(params: dict, batch: dict):
    """Mean cross-entropy and ``{"acc": accuracy}`` of one worker's batch."""
    logits = resnet20_apply(params, batch["images"])
    labels = batch["labels"].long()
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return nll.mean(), {"acc": acc}
