"""Vision datasets + transforms (parity: gluon/data/vision/)."""
from .datasets import (  # noqa: F401
    MNIST, FashionMNIST, CIFAR10, CIFAR100,
    ImageRecordDataset, ImageFolderDataset,
)
from . import transforms  # noqa: F401
