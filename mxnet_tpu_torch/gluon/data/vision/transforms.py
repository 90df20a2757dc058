"""Vision transforms (the port's copy of
``mxnet_tpu/gluon/data/vision/transforms.py``; parity:
gluon/data/vision/transforms.py).

Transforms are blocks over HWC images (uint8 in, float out after
``ToTensor``), as in the reference.  Each one's ``forward`` is torch on
the image's tensor; called with an NDArray, a block returns an NDArray
on the image's context (``gluon.block``).  The random transforms draw
their parameters from numpy's global generator, as the JAX package's
do, so a seeded run draws the same crops, flips and jitters.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ....ops.tensor import to_torch_dtype
from ...block import Block, HybridBlock
from ...nn import Sequential, HybridSequential


class Compose(Sequential):
    """Sequentially compose transforms (parity: transforms.py Compose:40)."""

    def __init__(self, transforms):
        super().__init__()
        transforms.append(None)
        hybrid = []
        for i in transforms:
            if isinstance(i, HybridBlock):
                hybrid.append(i)
                continue
            if len(hybrid) == 1:
                self.add(hybrid[0])
                hybrid = []
            elif len(hybrid) > 1:
                hblock = HybridSequential()
                for j in hybrid:
                    hblock.add(j)
                hblock.hybridize()
                self.add(hblock)
                hybrid = []
            if i is not None:
                self.add(i)


class Cast(HybridBlock):
    def __init__(self, dtype='float32'):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return x.to(to_torch_dtype(self._dtype))


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (transforms.py ToTensor:91)."""

    def forward(self, x):
        x = x.float() / 255.0
        if x.dim() == 3:
            return x.permute(2, 0, 1)
        return x.permute(0, 3, 1, 2)


class Normalize(HybridBlock):
    """(x - mean) / std per channel, CHW input (transforms.py:130)."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, dtype=np.float32).reshape(-1, 1, 1)
        self._std = np.asarray(std, dtype=np.float32).reshape(-1, 1, 1)

    def forward(self, x):
        mean = torch.as_tensor(self._mean, dtype=x.dtype, device=x.device)
        std = torch.as_tensor(self._std, dtype=x.dtype, device=x.device)
        return (x - mean) / std


def _resize_hwc(x, w, h):
    """Nearest-neighbour resize of an HWC image to (w, h)."""
    ih, iw = x.shape[:2]
    yy = np.clip((np.arange(h) * ih / float(h)).astype(int), 0, ih - 1)
    xx = np.clip((np.arange(w) * iw / float(w)).astype(int), 0, iw - 1)
    return x[torch.from_numpy(yy).to(x.device)][
        :, torch.from_numpy(xx).to(x.device)]


class Resize(Block):
    """Resize to (w, h); nearest interpolation (transforms.py Resize:303)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio

    def forward(self, x):
        if isinstance(self._size, int):
            if self._keep:
                h, w = x.shape[:2]
                if h < w:
                    size = (int(self._size * w / h), self._size)
                else:
                    size = (self._size, int(self._size * h / w))
            else:
                size = (self._size, self._size)
        else:
            size = self._size
        return _resize_hwc(x, size[0], size[1])


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        w, h = self._size
        ih, iw = x.shape[:2]
        if ih < h or iw < w:
            x = _resize_hwc(x, max(w, iw), max(h, ih))
            ih, iw = x.shape[:2]
        y0, x0 = (ih - h) // 2, (iw - w) // 2
        return x[y0:y0 + h, x0:x0 + w].clone()


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3/4, 4/3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        ih, iw = x.shape[:2]
        area = ih * iw
        for _ in range(10):
            target = area * np.random.uniform(*self._scale)
            aspect = np.random.uniform(*self._ratio)
            w = int(round(np.sqrt(target * aspect)))
            h = int(round(np.sqrt(target / aspect)))
            if w <= iw and h <= ih:
                x0 = np.random.randint(0, iw - w + 1)
                y0 = np.random.randint(0, ih - h + 1)
                crop = x[y0:y0 + h, x0:x0 + w]
                return _resize_hwc(crop, self._size[0], self._size[1])
        return CenterCrop(self._size).forward(x)


class RandomCrop(Block):
    def __init__(self, size, pad=None, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._pad = pad

    def forward(self, x):
        if self._pad:
            x = F.pad(x, (0, 0, self._pad, self._pad, self._pad, self._pad))
        w, h = self._size
        ih, iw = x.shape[:2]
        y0 = np.random.randint(0, max(1, ih - h + 1))
        x0 = np.random.randint(0, max(1, iw - w + 1))
        return x[y0:y0 + h, x0:x0 + w].clone()


class RandomFlipLeftRight(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if np.random.rand() < self._p:
            return torch.flip(x, dims=(1,))
        return x


class RandomFlipTopBottom(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if np.random.rand() < self._p:
            return torch.flip(x, dims=(0,))
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        alpha = 1.0 + np.random.uniform(-self._b, self._b)
        return torch.clamp(x.float() * alpha, 0., 255.)


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        alpha = 1.0 + np.random.uniform(-self._c, self._c)
        xf = x.float()
        gray = xf.mean()
        return torch.clamp(xf * alpha + gray * (1 - alpha), 0., 255.)


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        alpha = 1.0 + np.random.uniform(-self._s, self._s)
        xf = x.float()
        coef = torch.tensor([[[0.299, 0.587, 0.114]]], device=x.device)
        gray = (xf * coef).sum(dim=2, keepdim=True)
        return torch.clamp(xf * alpha + gray * (1 - alpha), 0., 255.)


class RandomHue(Block):
    def __init__(self, hue):
        super().__init__()
        self._h = hue

    def forward(self, x):
        alpha = np.random.uniform(-self._h, self._h)
        xf = x.float().cpu().numpy()
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0],
                       [0.0, u, -w],
                       [0.0, w, u]], dtype=np.float32)
        tyiq = np.array([[0.299, 0.587, 0.114],
                         [0.596, -0.274, -0.321],
                         [0.211, -0.523, 0.311]], dtype=np.float32)
        ityiq = np.array([[1.0, 0.956, 0.621],
                          [1.0, -0.272, -0.647],
                          [1.0, -1.107, 1.705]], dtype=np.float32)
        t = ityiq @ bt @ tyiq
        out = np.clip(xf @ t.T, 0., 255.)
        return torch.from_numpy(np.ascontiguousarray(out)).to(x.device)


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._transforms = []
        if brightness:
            self._transforms.append(RandomBrightness(brightness))
        if contrast:
            self._transforms.append(RandomContrast(contrast))
        if saturation:
            self._transforms.append(RandomSaturation(saturation))
        if hue:
            self._transforms.append(RandomHue(hue))

    def forward(self, x):
        order = np.random.permutation(len(self._transforms))
        for i in order:
            x = self._transforms[i].forward(x)
        return x


class RandomLighting(Block):
    """AlexNet-style PCA noise (transforms.py RandomLighting)."""

    _eigval = np.array([55.46, 4.794, 1.148], dtype=np.float32)
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], dtype=np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        alpha = np.random.normal(0, self._alpha, size=(3,)).astype(
            np.float32)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return x.float() + torch.from_numpy(rgb.reshape(1, 1, 3)).to(
            x.device)
