"""Neural-network layers (counterpart of ``mxnet_tpu/gluon/nn``)."""
from .basic_layers import (Activation, BatchNorm, Dense, Dropout,
                           Embedding, Flatten, HybridLambda,
                           HybridSequential, InstanceNorm, Lambda,
                           LayerNorm, LeakyReLU, Sequential)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D, Conv1D,
                          Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                          Conv3DTranspose, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
                          ReflectionPad2D)
