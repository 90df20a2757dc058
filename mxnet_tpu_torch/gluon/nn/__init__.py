"""Neural-network layers of the port (parity: gluon.nn)."""
from .activations import (ELU, GELU, SELU, Activation,  # noqa: F401
                          LeakyReLU, PReLU, Swish)
from .basic_layers import (BatchNorm, Concurrent, Dense,  # noqa: F401
                           Dropout, Embedding, Flatten, GroupNorm,
                           HybridConcurrent, HybridLambda, HybridSequential,
                           Identity, InstanceNorm, Lambda, LayerNorm,
                           Sequential)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D,  # noqa: F401
                          Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose,
                          Conv3D, Conv3DTranspose, GlobalAvgPool1D,
                          GlobalAvgPool2D, GlobalAvgPool3D, GlobalMaxPool1D,
                          GlobalMaxPool2D, GlobalMaxPool3D, MaxPool1D,
                          MaxPool2D, MaxPool3D, ReflectionPad2D)
